"""The port's CUDA kernels against their plain versions at odd shapes.  They
need an NVIDIA card with nvcc (marker ``cuda``) and skip elsewhere; on such
a machine run ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``."""
from pathlib import Path

import pytest
import torch

from difusion_tpu_torch.ops import _build
from difusion_tpu_torch.ops import decoder_fused as fused
from difusion_tpu_torch.ops import stencil

pytestmark = pytest.mark.cuda
HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def packed(dev):
    from difusion_tpu_torch.models.weights import load_prior
    dec, _, _ = load_prior(HYPER, 300, device=dev)
    return fused.pack_fused_decoder(dec)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 777,
                               8192, 8193])
def test_decode_grad_kernel_matches_plain(dev, packed, n):
    """sdf/std atol 1e-5; grad atol 1e-4 + rtol 1e-4, a row at a relu kink
    on either side of it (``grad_rows_off``) (3xTF32 products and another
    summation order of the 128-wide dots), at the edges of the 16-row warp
    tile and the 64-row block; one counted launch per call."""
    gen = torch.Generator(device=dev).manual_seed(n)
    lat = torch.randn(n, 29, generator=gen, device=dev) * 0.3
    rel = torch.rand(n, 3, generator=gen, device=dev) - 0.5
    before = _build.launch_counts().get("decode_grad_fused", 0)
    got = fused.decode_grad_fused(packed, lat, rel)
    ref = fused.decode_grad_plain(packed, lat, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts()["decode_grad_fused"] == before + 1
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=0)
    off = fused.grad_rows_off(got[2], packed, lat, rel)
    assert not bool(off.any()), f"{int(off.sum())} rows off in grad"


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 31, 32, 33, 63, 65, 95, 96, 97,
                               127, 128, 129, 4097, (1 << 20) + 3])
def test_decode_fused_kernel_matches_plain(dev, packed, n):
    """Kernel 3 against its plain version, sdf/std atol 1e-5, over the
    mesher's lattice range, at the edges of the 16-row m-tile, the 32-row
    warp tile and the 96-row block; one counted launch per call, none for
    N = 0."""
    gen = torch.Generator(device=dev).manual_seed(n)
    lat = torch.randn(n, 29, generator=gen, device=dev) * 0.3
    rel = torch.rand(n, 3, generator=gen, device=dev) * 1.75 - 1.0
    before = _build.launch_counts().get("decode_fused", 0)
    got = fused.decode_fused(packed, lat, rel)
    ref = fused.decode_fused_plain(packed, lat, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts().get("decode_fused", 0) == before + (n > 0)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,window", [((37, 53), 2), ((8, 32), 6), ((240, 320), 6)])
def test_window_stats_kernel_matches_plain(dev, shape, window):
    """Counts exactly; the sums too, since the kernel rounds every product
    and sum as the plain version does, in the same tap order."""
    gen = torch.Generator(device=dev).manual_seed(window)
    pc = torch.randn(*shape, 3, generator=gen, device=dev) * 0.1
    ok = torch.rand(*shape, generator=gen, device=dev) > 0.2
    maps = [torch.where(ok, pc[..., c], 0.0).contiguous() for c in range(3)]
    args = (*maps, ok.float(), window, 0.01, 0.04)
    got = stencil.window_stat_sums(*args)
    ref = stencil.window_stat_sums_plain(*args)
    torch.cuda.synchronize()
    for k, (g, r) in enumerate(zip(got, ref)):
        if k < 2:
            assert torch.equal(g, r), k
        else:
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-5)


def test_wrappers_reject_bad_inputs(dev, packed):
    lat = torch.zeros(8, 29, device=dev)
    with pytest.raises(ValueError):
        fused.decode_grad_fused(packed, lat.double(), torch.zeros(8, 3, device=dev))
    with pytest.raises(ValueError):
        fused.decode_grad_fused(packed, lat, torch.zeros(8, 3, device=dev).T.contiguous().T)
    with pytest.raises(ValueError):   # a broadcast latent is not contiguous
        fused.decode_fused(packed, torch.zeros(1, 29, device=dev).expand(8, 29),
                           torch.zeros(8, 3, device=dev))
    m = torch.zeros(4, 5, device=dev)
    with pytest.raises(ValueError):
        stencil.window_stat_sums(m, m, m, torch.zeros(4, 6, device=dev), 2, 0.1, 0.1)
