"""The port's CUDA kernels against their plain versions at odd shapes.  They
need an NVIDIA card with nvcc (marker ``cuda``) and skip elsewhere; on such
a machine run ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``."""
from pathlib import Path

import numpy as np
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


@pytest.fixture(scope="module")
def packed_bf16(dev):
    from difusion_tpu_torch.models.weights import load_prior
    dec, _, _ = load_prior(HYPER, 300, device=dev)
    return fused.pack_fused_decoder(dec, torch.bfloat16)


# kernel 1's bf16 mode: a 64-row tile a block; 132 x 64 rows fill an H100
@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 64, 65, 777, 8192, 8193,
                               132 * 64 - 1, 132 * 64 + 1])
def test_decode_grad_bf16_kernel_matches_plain(dev, packed_bf16, n):
    """Kernel 1's bf16 mode against its plain bf16 version: sdf/std atol
    2e-3 (chip_smoke.py's BF16_ATOL: an activation whose f32 sum ran in
    another order may round to the neighbouring bf16 value); gradient rows
    within 1e-3 + 1e-3 |ref| but for at most max(2, N / 1000) rows, all
    within atol 0.15 + rtol 0.05; one launch counted as decode_grad_bf16.
    At the edges of the 16-row warp slice, the 64-row tile and one block a
    streaming multiprocessor."""
    gen = torch.Generator(device=dev).manual_seed(n)
    lat = torch.randn(n, 29, generator=gen, device=dev) * 0.3
    rel = torch.rand(n, 3, generator=gen, device=dev) - 0.5
    before = _build.launch_counts().get("decode_grad_bf16", 0)
    got = fused.decode_grad_fused(packed_bf16, lat, rel)
    ref = fused.decode_grad_plain(packed_bf16, lat, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts()["decode_grad_bf16"] == before + 1
    torch.testing.assert_close(got[0], ref[0], atol=2e-3, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=2e-3, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=0.15, rtol=0.05)
    beyond = ((got[2] - ref[2]).abs() > 1e-3 + 1e-3 * ref[2].abs()).any(dim=1)
    assert int(beyond.sum()) <= max(2, n // 1000)


# kernel 3's bf16 mode: persistent, 3 warpgroups of 64-row tiles a block and
# one block an SM, so its tiles wrap at 132 x 3 x 64 rows on an H100
K3_WAVE = 132 * 3 * 64


@pytest.mark.parametrize("n", [0, 1, 17, 63, 64, 65, 96, 97, 4097, K3_WAVE - 1, K3_WAVE + 1,
                               2 * K3_WAVE + 5, (1 << 20) + 3])
def test_decode_fwd_bf16_kernel_matches_plain(dev, packed_bf16, n):
    """Kernel 3's bf16 mode against its plain bf16 version over the
    mesher's lattice range: sdf/std atol 2e-3; one launch counted as
    decode_fwd_bf16, none for N = 0.  At the edges of the 64-row tile and
    of the persistent grid's first and second pass over the tiles."""
    gen = torch.Generator(device=dev).manual_seed(n)
    lat = torch.randn(n, 29, generator=gen, device=dev) * 0.3
    rel = torch.rand(n, 3, generator=gen, device=dev) * 1.75 - 1.0
    before = _build.launch_counts().get("decode_fwd_bf16", 0)
    got = fused.decode_fused(packed_bf16, lat, rel)
    ref = fused.decode_fused_plain(packed_bf16, lat, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts().get("decode_fwd_bf16", 0) == before + (n > 0)
    torch.testing.assert_close(got[0], ref[0], atol=2e-3, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=2e-3, rtol=0)


# ---------------------------------------------------------------------------
# The wide instances (csrc/decoder_wide.cu) at DeepSDF's published widths
# ---------------------------------------------------------------------------

DEEPSDF = Path(__file__).resolve().parents[1] / "benchmark/configs/lrkt-deepsdf.json"
# the wide kernels' tolerances: both sides f32 (3xTF32 keeps ~22 bits of
# each product) summing 512-wide dots in another order through 9 layers
WIDE_ATOL = 2e-5           # sdf and std
WIDE_GRAD_TOL = 1e-4       # gradient, atol and rtol, a row at a relu kink either side


@pytest.fixture(scope="module")
def wide(dev):
    """DeepSDF's decoder, the in-repo prior, and its wide pack."""
    import json
    from difusion_tpu_torch.models.weights import load_prior
    cfg = json.loads(DEEPSDF.read_text())
    dec, _, spec = load_prior(DEEPSDF.parents[2] / cfg["training_hypers"],
                              int(cfg["using_epoch"]), device=dev)
    assert fused.wide_layout(spec) == (256, 512, 8, 4)
    return dec, fused.pack_fused_decoder(dec)


def _wide_inputs(dev, n, seed, spread):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lat = torch.randn(n, 256, generator=gen, device=dev) * 0.3
    return lat, torch.rand(n, 3, generator=gen, device=dev) * spread - spread / 2


@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 777, 8192, 8193])
def test_decode_grad_wide_kernel_matches_plain(dev, wide, n):
    """Kernel 1's wide instance against its plain version at the tracker's
    8192 points and at the edges of the 32-row warp tile and the 64-row
    block: sdf/std within WIDE_ATOL, the gradient within WIDE_GRAD_TOL
    (``grad_rows_off``); one launch counted as decode_grad_wide."""
    _, packed = wide
    lat, rel = _wide_inputs(dev, n, n, 1.0)
    before = _build.launch_counts().get("decode_grad_wide", 0)
    got = fused.decode_grad_fused(packed, lat, rel)
    ref = fused.decode_grad_plain(packed, lat, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts()["decode_grad_wide"] == before + 1
    torch.testing.assert_close(got[0], ref[0], atol=WIDE_ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=WIDE_ATOL, rtol=0)
    off = fused.grad_rows_off(got[2], packed, lat, rel, atol=WIDE_GRAD_TOL, rtol=WIDE_GRAD_TOL)
    assert not bool(off.any()), f"{int(off.sum())} rows off in grad"


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4097, 1 << 20])
def test_decode_fwd_wide_kernel_matches_plain(dev, wide, n):
    """Kernel 3's wide instance against its plain version over the
    mesher's lattice range, up to one export dispatch (2^20 sites):
    sdf/std within WIDE_ATOL; one launch counted as decode_fwd_wide, none
    for N = 0."""
    _, packed = wide
    lat, rel = _wide_inputs(dev, n, n, 1.75)
    before = _build.launch_counts().get("decode_fwd_wide", 0)
    got = fused.decode_fused(packed, lat, rel)
    ref = fused.decode_fused_plain(packed, lat, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts().get("decode_fwd_wide", 0) == before + (n > 0)
    torch.testing.assert_close(got[0], ref[0], atol=WIDE_ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=WIDE_ATOL, rtol=0)


def test_wide_tolerances_refuse_the_tf32_reference(dev, wide):
    """The control: the same plain versions with the products in TF32 (the
    precision just below the configuration's f32) fail the tolerances the
    kernels pass, at 8192 points and at one 2^20-site dispatch."""
    _, packed = wide
    lat, rel = _wide_inputs(dev, 8192, 8192, 1.0)
    lat3, rel3 = _wide_inputs(dev, 1 << 20, 1 << 20, 1.75)
    ref = fused.decode_grad_plain(packed, lat, rel)
    ref3 = fused.decode_fused_plain(packed, lat3, rel3)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = fused.decode_grad_plain(packed, lat, rel)
        low3 = fused.decode_fused_plain(packed, lat3, rel3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    assert float((low[0] - ref[0]).abs().max()) > WIDE_ATOL
    assert float((low3[0] - ref3[0]).abs().max()) > WIDE_ATOL
    off = fused.grad_rows_off(low[2], packed, lat, rel, atol=WIDE_GRAD_TOL, rtol=WIDE_GRAD_TOL)
    assert bool(off.any())


def test_deepsdf_system_takes_the_wide_route(dev, wide):
    """SLAMSystem.from_config on the DeepSDF configuration with its own
    tracking block (sdf_fused "on"): the tracker and the mesher hold wide
    packs, and their decodes launch only the wide instances."""
    import json
    from benchmark import drive
    cfg = json.loads(DEEPSDF.read_text())
    system, _ = drive.build_system(cfg, dev, meshing=False)
    dec, _ = wide
    assert system.tracker.sdf_fused
    lay = fused._wide_of(system.tracker.packed, 256)
    assert lay == (256, 512, 8, 4)
    from difusion_tpu_torch.core.meshing import MeshExtractor
    mesher = MeshExtractor(system.map_cfg, system.decoder, voxel_resolution=8)
    assert fused._wide_of(mesher.packed, 256) == lay
    lat, rel = _wide_inputs(dev, 8192, 3, 1.0)
    _build.reset_launch_counts()
    fused.decode_grad_fused(system.tracker.packed, lat, rel)
    fused.decode_fused(mesher.packed, lat, rel)
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    assert counts == {"decode_grad_wide": 1, "decode_fwd_wide": 1}


# onet_cbn's kernels (csrc/decoder_cbn.cu) at Occupancy Networks' widths
# ---------------------------------------------------------------------------

ONET = Path(__file__).resolve().parents[1] / "benchmark/configs/lrkt-onet.json"
# both sides f32 (3xTF32 keeps ~22 bits of each product) summing 256-wide
# dots in another order: the conditioning, then 11 CBNs and 10 layers
CBN_COND_TOL = 1e-5        # atol and rtol
CBN_ATOL = 2e-5            # sdf and std
CBN_GRAD_TOL = 1e-4        # gradient, atol and rtol, a row at a relu kink either side


@pytest.fixture(scope="module")
def cbn(dev):
    """A random onet_cbn decoder at the published widths (every weight
    drawn; gamma's bias about 1 and running statistics away from (0, 1),
    so the blocks carry signal) and its pack."""
    from difusion_tpu_torch.models import decoder as D
    from test_torch_onet import random_params
    spec = D.CbnSpec(256, 256, 5)
    dec = D.CbnDecoder(spec, random_params(spec, 11, gamma=1.0)).to(dev)
    return dec, fused.pack_fused_decoder(dec)


def _cbn_inputs(dev, n, m, seed, spread, per_code=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randn(m, 256, generator=gen, device=dev) * 0.3
    idx = (torch.randint(0, m, (n,), generator=gen, device=dev) if per_code is None
           else torch.arange(n, device=dev) // per_code).to(torch.int32)
    rel = torch.rand(n, 3, generator=gen, device=dev) * spread - spread / 2
    return codes, idx, rel


@pytest.mark.parametrize("m", [1, 63, 64, 65, 4700])
def test_cbn_cond_kernel_matches_plain(dev, cbn, m):
    """The conditioning kernel against its plain version at an export's
    live blocks and the 64-row tile's edges; one launch counted as
    cbn_cond."""
    _, pack = cbn
    codes, _, _ = _cbn_inputs(dev, 1, m, m, 1.0)
    before = _build.launch_counts().get("cbn_cond", 0)
    got = fused.cbn_condition(pack, codes)
    ref = fused.cbn_condition_plain(pack, codes)
    torch.cuda.synchronize()
    assert _build.launch_counts()["cbn_cond"] == before + 1
    torch.testing.assert_close(got, ref, atol=CBN_COND_TOL, rtol=CBN_COND_TOL)


@pytest.mark.parametrize("count", [0, 1, 65, 700])
def test_cbn_cond_kernel_by_row_list_and_device_count(dev, cbn, count):
    """Rows from a list, as many as a count on the card says: the listed
    rows conditioned, every other row of the table untouched."""
    _, pack = cbn
    codes, _, _ = _cbn_inputs(dev, 1, 4000, 3, 1.0)
    gen = torch.Generator(device=dev).manual_seed(count)
    rows = torch.randperm(4000, generator=gen, device=dev)[:1000].to(torch.int32)
    table = torch.full((4000, 11, 2, 256), 7.0, device=dev)
    fused.cbn_condition(pack, codes, rows, torch.tensor(count, dtype=torch.int32, device=dev),
                        out=table)
    want = torch.full_like(table, 7.0)
    sel = rows[:count].long()
    want[sel] = fused.cbn_condition_plain(pack, codes[sel])
    torch.testing.assert_close(table, want, atol=CBN_COND_TOL, rtol=CBN_COND_TOL)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 777, 8192, 8193])
def test_decode_grad_cbn_kernel_matches_plain(dev, cbn, n):
    """Kernel 1's onet_cbn instance against its plain version at the
    tracker's 8192 points, each point's row drawn from 600 codes:
    sdf/std within CBN_ATOL, the gradient within CBN_GRAD_TOL
    (``cbn_grad_rows_off``); one launch counted as decode_grad_cbn."""
    _, pack = cbn
    codes, idx, rel = _cbn_inputs(dev, n, 600, n, 1.0)
    cond = fused.cbn_condition(pack, codes)
    before = _build.launch_counts().get("decode_grad_cbn", 0)
    got = fused.decode_grad_cbn(pack, cond, idx, rel)
    ref = fused.decode_grad_cbn_plain(pack, cond, idx, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts()["decode_grad_cbn"] == before + 1
    torch.testing.assert_close(got[0], ref[0], atol=CBN_ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=CBN_ATOL, rtol=0)
    off = fused.cbn_grad_rows_off(got[2], pack, cond, idx, rel, atol=CBN_GRAD_TOL,
                                  rtol=CBN_GRAD_TOL)
    assert not bool(off.any()), f"{int(off.sum())} rows off in grad"


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4097, 1 << 20])
def test_decode_fwd_cbn_kernel_matches_plain(dev, cbn, n):
    """Kernel 3's onet_cbn instance against its plain version over the
    mesher's lattice range (4,096 sites a block's row), up to one export
    dispatch; one launch counted as decode_fwd_cbn, none for N = 0."""
    _, pack = cbn
    codes, idx, rel = _cbn_inputs(dev, n, 256, n, 1.75, per_code=4096)
    cond = fused.cbn_condition(pack, codes)
    before = _build.launch_counts().get("decode_fwd_cbn", 0)
    got = fused.decode_fwd_cbn(pack, cond, idx, rel)
    ref = fused.decode_fwd_cbn_plain(pack, cond, idx, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts().get("decode_fwd_cbn", 0) == before + (n > 0)
    torch.testing.assert_close(got[0], ref[0], atol=CBN_ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=CBN_ATOL, rtol=0)


def test_cbn_tolerances_refuse_the_tf32_reference(dev, cbn):
    """The control: the plain versions with their products in TF32 fail
    the tolerances the kernels pass."""
    _, pack = cbn
    codes, idx, rel = _cbn_inputs(dev, 8192, 600, 5, 1.0)
    cond = fused.cbn_condition_plain(pack, codes)
    ref = fused.decode_grad_cbn_plain(pack, cond, idx, rel)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low_cond = fused.cbn_condition_plain(pack, codes)
        low = fused.decode_grad_cbn_plain(pack, low_cond, idx, rel)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    assert bool(((low_cond - cond).abs() > CBN_COND_TOL + CBN_COND_TOL * cond.abs()).any())
    assert float((low[0] - ref[0]).abs().max()) > CBN_ATOL
    assert bool(fused.cbn_grad_rows_off(low[2], pack, cond, idx, rel, atol=CBN_GRAD_TOL,
                                        rtol=CBN_GRAD_TOL).any())


def test_onet_system_takes_the_cbn_route(dev):
    """SLAMSystem.from_config on the lrkt-onet configuration: the tracker
    holds an onet_cbn pack and a conditioning table, the mesher the same
    pack; their decodes launch only onet_cbn's kernels, and a fusion
    conditions the slots it wrote in one launch."""
    import json
    from benchmark import drive
    from difusion_tpu_torch.core.meshing import MeshExtractor
    cfg = json.loads(ONET.read_text())
    system, _ = drive.build_system(cfg, dev, meshing=False)
    assert system.tracker.sdf_fused and isinstance(system.tracker.packed, fused.CondPack)
    table = system.tracker.cond
    assert table.table.shape == (cfg["assumed"]["capacity"], 11, 2, 256)
    mesher = MeshExtractor(system.map_cfg, system.decoder, voxel_resolution=8)
    assert isinstance(mesher.packed, fused.CondPack)
    codes, idx, rel = _cbn_inputs(dev, 8192, 600, 3, 1.0)
    _build.reset_launch_counts()
    lat = system.state.latents.clone()
    lat[:5] = codes[:5]
    table.refresh(lat)
    torch.testing.assert_close(table.table[:5], fused.cbn_condition_plain(
        system.tracker.packed, codes[:5]), atol=CBN_COND_TOL, rtol=CBN_COND_TOL)
    assert table.cond_rows() == 5
    fused.decode_grad_cbn(system.tracker.packed, table.table, idx, rel)
    fused.decode_fwd_cbn(mesher.packed, table.table, idx, rel)
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    assert counts == {"cbn_cond": 1, "decode_grad_cbn": 1, "decode_fwd_cbn": 1}


# ---------------------------------------------------------------------------
# pigan_film's kernels (csrc/decoder_film.cu) at pi-GAN's widths
# ---------------------------------------------------------------------------

PIGAN = Path(__file__).resolve().parents[1] / "benchmark/configs/lrkt-pigan.json"
# both sides f32 (3xTF32 keeps ~22 bits of each product) summing 256-wide
# dots in another order: the mapping's four layers, then eight sine layers
# whose frequencies (gamma ~30) amplify a preactivation's error ~1.7x each
# the mapping's rows sum to gamma = 15 f + 30, so an error is absolute at
# gamma's scale (~30): 1.5e-5 read at random and trained weights alike,
# also where 15 f cancels 30 to a small gamma
FILM_MAP_ATOL, FILM_MAP_RTOL = 6e-5, 1e-5
FILM_ATOL = 2e-5           # sdf and std
FILM_GRAD_ATOL = 3e-4      # gradient (up to ~5 a unit)


@pytest.fixture(scope="module")
def film(dev):
    """A pigan_film decoder at the published widths with pi-GAN's own
    initialisation from a seed, and its pack."""
    from difusion_tpu_torch.models import decoder as D
    spec = D.FilmSpec()
    dec = D.FilmDecoder(spec, D.init_film_params(spec, torch.Generator().manual_seed(11)))
    return dec.to(dev), fused.pack_fused_decoder(dec.to(dev))


def _film_inputs(dev, n, m, seed, per_code=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randn(m, 256, generator=gen, device=dev) * 0.5
    idx = (torch.randint(0, m, (n,), generator=gen, device=dev) if per_code is None
           else torch.arange(n, device=dev) // per_code).to(torch.int32)
    rel = torch.rand(n, 3, generator=gen, device=dev) - 0.5
    return codes, idx, rel


@pytest.mark.parametrize("m", [1, 63, 64, 65, 4700])
def test_film_map_kernel_matches_plain(dev, film, m):
    """The mapping kernel against its plain version at an export's live
    blocks and the 64-row tile's edges; one launch counted as film_map."""
    _, pack = film
    codes, _, _ = _film_inputs(dev, 1, m, m)
    before = _build.launch_counts().get("film_map", 0)
    got = fused.film_map(pack, codes)
    ref = fused.film_map_plain(pack, codes)
    torch.cuda.synchronize()
    assert _build.launch_counts()["film_map"] == before + 1
    torch.testing.assert_close(got, ref, atol=FILM_MAP_ATOL, rtol=FILM_MAP_RTOL)


@pytest.mark.parametrize("count", [0, 1, 65, 700])
def test_film_map_kernel_by_row_list_and_device_count(dev, film, count):
    """Rows from a list, as many as a count on the card says: the listed
    rows mapped, every other row of the table untouched."""
    _, pack = film
    codes, _, _ = _film_inputs(dev, 1, 4000, 3)
    gen = torch.Generator(device=dev).manual_seed(count)
    rows = torch.randperm(4000, generator=gen, device=dev)[:1000].to(torch.int32)
    table = torch.full((4000, 8, 2, 256), 7.0, device=dev)
    fused.condition(pack, codes, rows, torch.tensor(count, dtype=torch.int32, device=dev),
                    out=table)
    want = torch.full_like(table, 7.0)
    sel = rows[:count].long()
    want[sel] = fused.film_map_plain(pack, codes[sel])
    torch.testing.assert_close(table, want, atol=FILM_MAP_ATOL, rtol=FILM_MAP_RTOL)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 63, 64, 65, 777, 8192, 8193])
def test_decode_grad_film_kernel_matches_plain(dev, film, n):
    """Kernel 1's pigan_film instance (16 points a block, four rows each)
    against its plain version and the autograd gradient of the inference
    form at the tracker's 8192 points, each point's row drawn from 600
    codes; one launch counted as decode_grad_film."""
    dec, pack = film
    codes, idx, rel = _film_inputs(dev, n, 600, n)
    mod = fused.film_map(pack, codes)
    before = _build.launch_counts().get("decode_grad_film", 0)
    got = fused.decode_grad_film(pack, mod, idx, rel)
    ref = fused.decode_grad_film_plain(pack, mod, idx, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts()["decode_grad_film"] == before + 1
    torch.testing.assert_close(got[0], ref[0], atol=FILM_ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=FILM_ATOL, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=FILM_GRAD_ATOL, rtol=0)
    x = rel.clone().requires_grad_(True)
    with torch.enable_grad():
        sdf, _ = dec.trunk(x, mod[idx.long()])
        g, = torch.autograd.grad(sdf.sum(), x)
    torch.testing.assert_close(got[2], g, atol=FILM_GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4097, 1 << 20])
def test_decode_fwd_film_kernel_matches_plain(dev, film, n):
    """Kernel 3's pigan_film instance against its plain version over the
    mesher's lattice range (4,096 sites a block's row), up to one export
    dispatch; one launch counted as decode_fwd_film, none for N = 0."""
    _, pack = film
    codes, idx, rel = _film_inputs(dev, n, 256, n, per_code=4096)
    mod = fused.film_map(pack, codes)
    before = _build.launch_counts().get("decode_fwd_film", 0)
    got = fused.decode_fwd_film(pack, mod, idx, rel)
    ref = fused.decode_fwd_film_plain(pack, mod, idx, rel)
    torch.cuda.synchronize()
    assert _build.launch_counts().get("decode_fwd_film", 0) == before + (n > 0)
    torch.testing.assert_close(got[0], ref[0], atol=FILM_ATOL, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=FILM_ATOL, rtol=0)


def test_film_tolerances_refuse_the_tf32_reference(dev, film):
    """The control: the plain versions with their products in TF32 fail
    the tolerances the kernels pass."""
    _, pack = film
    codes, idx, rel = _film_inputs(dev, 8192, 600, 5)
    mod = fused.film_map_plain(pack, codes)
    ref = fused.decode_grad_film_plain(pack, mod, idx, rel)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low_mod = fused.film_map_plain(pack, codes)
        low = fused.decode_grad_film_plain(pack, low_mod, idx, rel)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.synchronize()
    assert bool(((low_mod - mod).abs() > FILM_MAP_ATOL + FILM_MAP_RTOL * mod.abs()).any())
    assert float((low[0] - ref[0]).abs().max()) > FILM_ATOL
    assert float((low[2] - ref[2]).abs().max()) > FILM_GRAD_ATOL


def test_pigan_system_takes_the_film_route(dev):
    """SLAMSystem.from_config on the lrkt-pigan configuration: the tracker
    holds a pigan_film pack and a modulation table, the mesher the same
    pack; their decodes launch only pigan_film's kernels, and a fusion maps
    the slots it wrote in one launch."""
    import json
    from benchmark import drive
    from difusion_tpu_torch.core.meshing import MeshExtractor
    cfg = json.loads(PIGAN.read_text())
    system, _ = drive.build_system(cfg, dev, meshing=False)
    assert system.tracker.sdf_fused and isinstance(system.tracker.packed, fused.CondPack)
    table = system.tracker.cond
    assert table.table.shape == (cfg["assumed"]["capacity"], 8, 2, 256)
    mesher = MeshExtractor(system.map_cfg, system.decoder, voxel_resolution=8)
    assert isinstance(mesher.packed, fused.CondPack)
    codes, idx, rel = _film_inputs(dev, 8192, 600, 3)
    _build.reset_launch_counts()
    lat = system.state.latents.clone()
    lat[:5] = codes[:5]
    table.refresh(lat)
    torch.testing.assert_close(table.table[:5], fused.film_map_plain(
        system.tracker.packed, codes[:5]), atol=FILM_MAP_ATOL, rtol=FILM_MAP_RTOL)
    assert table.cond_rows() == 5
    fused.decode_grad_cond(system.tracker.packed, table.table, idx, rel)
    fused.decode_fwd_cond(mesher.packed, table.table, idx, rel)
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    assert counts == {"film_map": 1, "decode_grad_film": 1, "decode_fwd_film": 1}


def _stencil_inputs(dev, shape, seed):
    """A (H, W, 3) point map with negative coordinates too, its bool validity
    map, and the four masked planes of the other entry."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pc = torch.randn(*shape, 3, generator=gen, device=dev) * 0.1
    ok = torch.rand(*shape, generator=gen, device=dev) > 0.2
    planes = [torch.where(ok, pc[..., c], 0.0).contiguous() for c in range(3)]
    return pc, ok, (*planes, ok.float())


@pytest.mark.parametrize("shape,window", [
    ((37, 53), 2), ((8, 32), 6), ((240, 320), 6),
    # the 32 x 4R tile's edges: whole tiles of R = 1 and one of R = 5, a
    # pixel more or less either way, ragged tiles of R = 5 where the plan
    # picks it (237 x 315), one row, one column, one pixel, smaller than the
    # window
    ((12, 32), 6), ((13, 33), 6), ((20, 32), 6), ((21, 31), 6), ((237, 315), 6), ((1, 40), 6),
    ((40, 1), 6), ((1, 1), 6), ((5, 7), 6), ((61, 97), 6),
    # other windows: the run-time body, down to the 1 x 1 window, and a tile
    # above 48 KB of shared memory (w = 20)
    ((37, 53), 0), ((37, 53), 1), ((37, 53), 3), ((50, 70), 7), ((45, 64), 20)])
def test_window_stats_kernel_matches_plain(dev, shape, window):
    """All 11 planes bit-equal (torch.equal): the kernel rounds every product
    and sum as the plain version does, in the same tap order, and a skipped
    add is an add of zero.  One counted launch per call."""
    _, _, planes = _stencil_inputs(dev, shape, window + shape[0])
    before = _build.launch_counts().get("window_stat_sums", 0)
    got = stencil.window_stat_sums(*planes, window, 0.01, 0.04)
    ref = stencil.window_stat_sums_plain(*planes, window, 0.01, 0.04)
    torch.cuda.synchronize()
    assert _build.launch_counts()["window_stat_sums"] == before + 1
    assert len(got) == 11
    for k, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), (k, int((g != r).sum()))


@pytest.mark.parametrize("rows,window", [(r, w) for w in (6, 3, 1, 0) for r in stencil.ROWS
                                         if r <= 2 * w + 1])
def test_window_stats_kernel_every_rows_value(dev, rows, window):
    """Each rows-per-thread instantiation the window admits (R <= 2w + 1),
    through the templated w = 6 body and the run-time body and through both
    entries, at a shape that is a multiple of no tile: bit-equal to the plain
    version.  The public entries take the plan's value; the launcher behind
    them takes any."""
    pc, ok, planes = _stencil_inputs(dev, (50, 70), 10 * rows + window)
    ref = torch.stack(stencil.window_stat_sums_plain(*planes, window, 0.01, 0.04))
    for entry, inputs in (("window_stats_launch", planes),
                          ("window_stats_map_launch", (pc, ok))):
        got = stencil._launch_cuda(entry, inputs, 50, 70, window, 0.01, 0.04, rows=rows)
        torch.cuda.synchronize()
        for k in range(11):
            assert torch.equal(got[k], ref[k]), (entry, k, int((got[k] != ref[k]).sum()))


@pytest.mark.parametrize("shape,window", [((240, 320), 6), ((37, 53), 6), ((1, 1), 6),
                                          ((37, 53), 2), ((40, 1), 1)])
def test_window_stats_map_entry_equals_planes_entry(dev, shape, window):
    """The point-map entry (the kernel masks as it loads) against the
    four-plane entry on the masked planes: torch.equal, one counted launch."""
    pc, ok, planes = _stencil_inputs(dev, shape, window)
    ref = torch.stack(stencil.window_stat_sums(*planes, window, 0.01, 0.04))
    before = _build.launch_counts()["window_stat_sums"]
    got = stencil.window_stat_sums_map(pc, ok, window, 0.01, 0.04)
    torch.cuda.synchronize()
    assert _build.launch_counts()["window_stat_sums"] == before + 1
    assert got.shape == (11, *shape) and torch.equal(got, ref)


def test_window_stats_on_a_threshold_grid(dev):
    """Neighbour distances exactly at the thresholds are kept (`<=`): on a
    0.25 m lattice with r2 = (0.0625, 0.125) an interior pixel counts 5 and
    weights 9."""
    v, u = torch.meshgrid(torch.arange(30.0, device=dev), torch.arange(45.0, device=dev),
                          indexing="ij")
    pc = torch.stack([0.25 * u, -0.25 * v, torch.zeros_like(u)], dim=-1).contiguous()
    ok = torch.ones(30, 45, dtype=torch.bool, device=dev)
    got = stencil.window_stat_sums_map(pc, ok, 6, 0.0625, 0.125)
    assert bool((got[0][6:-6, 6:-6] == 5.0).all()) and bool((got[1][6:-6, 6:-6] == 9.0).all())


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
    ok = torch.ones(4, 5, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):   # the validity map must be bool
        stencil.window_stat_sums_map(torch.zeros(4, 5, 3, device=dev), m, 2, 0.1, 0.1)
    with pytest.raises(ValueError):   # a strided point map
        stencil.window_stat_sums_map(torch.zeros(4, 5, 4, device=dev)[..., :3], ok, 2, 0.1, 0.1)
    with pytest.raises(ValueError):
        stencil.window_stat_sums_map(torch.zeros(4, 5, 3, device=dev), ok, -1, 0.1, 0.1)
    pc = torch.zeros(4, 5, 3, device=dev)
    with pytest.raises(ValueError):   # a rows value the library was not built with
        stencil._launch_cuda("window_stats_map_launch", (pc, ok), 4, 5, 2, 0.1, 0.1, rows=3)
    with pytest.raises(ValueError):   # a strip longer than the window
        stencil._launch_cuda("window_stats_map_launch", (pc, ok), 4, 5, 1, 0.1, 0.1, rows=5)


# ---------------------------------------------------------------------------
# Sparse marching cubes: csrc/marching_cubes.cu against the plain version
# ---------------------------------------------------------------------------

MC_COUNTS = ("mc_classify", "mc_scan", "mc_emit")


def _mc_world(dev, r, n_xyz=(6, 5, 7), seed=0, n_pad=7):
    """A dense grid whose every cell is a block but ~1/7 free (indexer -1),
    ~1/9 of the allocated slots unevaluated (slot_to_batch -1), the live
    blocks in a shuffled order and then ``n_pad`` padding rows (-1), and
    per-cell (2r)^3 lattices of a sphere that cuts all six faces of the
    grid, with a varying std."""
    import numpy as np
    from difusion_tpu_torch.ops import sampling as S
    rng = np.random.default_rng(seed)
    n_cells = int(np.prod(n_xyz))
    indexer = np.arange(n_cells, dtype=np.int32)
    indexer[rng.uniform(size=n_cells) < 1 / 7] = -1
    s2b = np.concatenate([np.arange(n_cells), [-1]]).astype(np.int64)
    s2b[:-1][rng.uniform(size=n_cells) < 1 / 9] = -1
    live = np.nonzero(indexer >= 0)[0].astype(np.int32)
    rng.shuffle(live)
    blocks = np.concatenate([live, np.full(n_pad, -1, np.int32)])
    cell = np.stack(np.meshgrid(*[np.arange(k) for k in n_xyz], indexing="ij"), -1)
    cell = cell.reshape(-1, 3)
    pos = (cell[:, None, :] + 0.5 + S.block_lattice(r)[None]) / np.asarray(n_xyz)
    sdf = np.linalg.norm(pos - [0.5, 0.45, 0.55], axis=-1) - 0.52
    std = 0.1 + 0.04 * np.sin(20.0 * pos[..., 0]) * np.cos(15.0 * pos[..., 1])
    side = 2 * r
    return [torch.from_numpy(a).to(dev) for a in (
        indexer, s2b, blocks, sdf.reshape(-1, side, side, side).astype(np.float32),
        std.reshape(-1, side, side, side).astype(np.float32))]


def _mc_both(args, n_xyz, r, budget, **kw):
    """The kernels and the plain version on the same card inputs: their
    results and the kernels' launches by name."""
    from difusion_tpu_torch.ops import marching_cubes as MC
    before = _build.launch_counts()
    got = MC.marching_cubes_sparse(*args, n_xyz, r, budget, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    ref = MC.marching_cubes_sparse_plain(*args, n_xyz, r, budget, **kw)
    return got, ref, {k: after.get(k, 0) - before.get(k, 0) for k in MC_COUNTS}


def _assert_mc_equal(got, ref):
    assert int(got.count) == int(ref.count)
    assert torch.equal(got.triangles, ref.triangles)
    assert torch.equal(got.tri_std, ref.tri_std)
    assert torch.equal(got.tri_block, ref.tri_block)
    assert torch.equal(got.packed.view(torch.int32), ref.packed.view(torch.int32))


@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("r", [2, 3, 4, 8, 9])
def test_marching_cubes_kernels_equal_plain(dev, r, interpolate):
    """Triangles, stds, block ids and count torch.equal to the plain version
    (r 9: two passes of 512 subcells and of corners a block), over a grid
    with free cells, unevaluated slots, shuffled blocks and padding rows,
    with triangles in blocks on all six faces of the grid; one launch of
    each kernel a call."""
    n_xyz = (6, 5, 7)
    args = _mc_world(dev, r, n_xyz, seed=r)
    got, ref, launches = _mc_both(args, n_xyz, r, 1 << 16, interpolate=interpolate)
    _assert_mc_equal(got, ref)
    assert launches == dict.fromkeys(MC_COUNTS, 1)
    count = int(got.count)
    assert 100 < count < 1 << 16
    blk = got.tri_block[:count].long()
    coords = torch.stack([blk // (n_xyz[1] * n_xyz[2]), (blk // n_xyz[2]) % n_xyz[1],
                          blk % n_xyz[2]])
    for a in range(3):
        assert int(coords[a].min()) == 0 and int(coords[a].max()) == n_xyz[a] - 1


@pytest.mark.parametrize("max_std,budget", [(0.12, 1 << 14), (2000.0, 100), (0.12, 300),
                                            (2000.0, 0)])
def test_marching_cubes_kernels_prune_and_truncate(dev, max_std, budget):
    """Pruning by vertex std and a budget below the survivors: the same
    true count, the same truncated buffer (zeros and block -1 past it)."""
    args = _mc_world(dev, 4, seed=11)
    got, ref, _ = _mc_both(args, (6, 5, 7), 4, budget, max_std=max_std)
    _assert_mc_equal(got, ref)
    full = int(_mc_both(args, (6, 5, 7), 4, 1 << 14)[1].count)
    if max_std < 1.0:
        assert 0 < int(got.count) < full
    else:
        assert int(got.count) == full > budget


def test_marching_cubes_kernels_without_blocks(dev):
    """A chunk of no blocks: count 0 and a buffer of zeros and block -1."""
    indexer, s2b, blocks, sdf, std = _mc_world(dev, 3)
    got, ref, launches = _mc_both((indexer, s2b, blocks[:0], sdf, std), (6, 5, 7), 3, 64)
    _assert_mc_equal(got, ref)
    assert int(got.count) == 0 and launches == dict.fromkeys(MC_COUNTS, 1)


def test_marching_cubes_kernels_at_the_export_chunk(dev):
    """One chunk at the offline export's size: 512 blocks at r = 8 against
    the lattices of every evaluated block of the grid, budget 2^20."""
    n_xyz = (10, 9, 8)
    indexer, s2b, blocks, sdf, std = _mc_world(dev, 8, n_xyz, seed=3, n_pad=0)
    assert blocks.shape[0] >= 512
    got, ref, _ = _mc_both((indexer, s2b, blocks[:512].contiguous(), sdf, std), n_xyz, 8,
                           1 << 20)
    _assert_mc_equal(got, ref)
    assert int(got.count) > 10000


def test_marching_cubes_wrapper_rejects_bad_inputs(dev):
    from difusion_tpu_torch.ops import marching_cubes as MC
    indexer, s2b, blocks, sdf, std = _mc_world(dev, 2)
    good = (indexer, s2b, blocks, sdf, std)
    for i, bad in ((0, indexer.long()), (1, s2b.int()), (2, blocks.cpu()),
                   (3, sdf.transpose(1, 2)), (4, std[:-1]), (3, sdf.double())):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            MC.marching_cubes_sparse(*args, (6, 5, 7), 2, 1024)
    with pytest.raises(ValueError):       # the indexer is not the grid's
        MC.marching_cubes_sparse(*good, (6, 5, 6), 2, 1024)


def _splice_both(dev, case, scale=1):
    """The splice kernel and its plain version on one card input (the CPU
    tests' synthetic chunks of ``case``, their counts times ``scale``):
    both results and the kernel's launches."""
    from difusion_tpu_torch.ops import marching_cubes as MC
    from test_torch_mc_splice import SPLICE_CASES, _chunks
    counts, budget, max_triangles, n_xyz, origin, world_origin = SPLICE_CASES[case]
    counts = [c * scale for c in counts]
    budget, max_triangles = budget * scale, max_triangles * scale
    packed, counts, lin_local, slots = _chunks(len(case), counts, budget, n_xyz)
    table = torch.full((int(np.prod(n_xyz)),), -1, dtype=torch.int64, device=dev)
    table[torch.from_numpy(lin_local).long().to(dev)] = torch.from_numpy(slots).to(dev)
    args = (torch.from_numpy(packed).to(dev), torch.from_numpy(counts).to(dev), table,
            np.asarray(origin, np.int64), 0.1, np.asarray(world_origin, np.float32),
            max_triangles)
    before = _build.launch_counts().get("mc_splice", 0)
    got = MC.mc_splice(*args)
    torch.cuda.synchronize()
    launches = _build.launch_counts().get("mc_splice", 0) - before
    return got, MC.mc_splice_plain(*args), launches


@pytest.mark.parametrize("case,scale", [
    ("chunks", 1), ("chunk_over_budget", 1), ("over_max_triangles", 1), ("hash_origin", 1),
    ("empty_chunk", 1), ("all_empty", 1), ("chunks", 64)])
def test_splice_kernel_equals_plain(dev, case, scale):
    """The splice kernel's vertices, stds, slots and totals torch.equal to
    the plain version's (which the CPU tests hold to the numpy splice): several
    chunks, a chunk over its budget, a total over ``max_triangles``, a hash
    grid's origin, empty chunks; at scale 64 ~105 k rows in chunks of
    65,536.  One launch a call."""
    got, ref, launches = _splice_both(dev, case, scale)
    emitted, rows = got.totals.tolist()
    assert [emitted, rows] == ref.totals.tolist() and launches == 1
    assert rows == ref.triangles.shape[0] <= got.triangles.shape[0]
    for a, b in zip(got[:3], ref[:3]):
        assert a[:rows].is_contiguous() and a.dtype == b.dtype
        assert torch.equal(a[:rows].view(torch.int32 if a.is_floating_point() else a.dtype),
                           b.view(torch.int32 if b.is_floating_point() else b.dtype))
    if case != "all_empty":
        assert rows > 0 and bool((got.tri_slot[:rows] >= 0).all())


def test_splice_at_the_export_size(dev):
    """Ten chunks of the r = 8 export's budget (2^20 rows), ~45.5 k
    triangles each: the kernel equals the plain version."""
    from difusion_tpu_torch.ops import marching_cubes as MC
    gen = torch.Generator(device=dev).manual_seed(26)
    K, budget, n_cells = 10, 1 << 20, 80 * 40 * 80
    counts = torch.randint(40000, 51000, (K,), generator=gen, device=dev)
    packed = torch.rand(K, budget, MC.ROW, generator=gen, device=dev) * 80.0
    blocks = torch.randint(0, n_cells, (K, budget), generator=gen, device=dev)
    packed.view(torch.int32)[:, :, 12] = blocks.to(torch.int32)
    table = torch.randint(-1, 1 << 16, (n_cells,), generator=gen, device=dev)
    args = (packed, counts, table, np.zeros(3, np.int64), 0.1,
            np.asarray((-3.5, -0.5, -2.7), np.float32), 1 << 20)
    got, ref = MC.mc_splice(*args), MC.mc_splice_plain(*args)
    rows = got.totals.tolist()[1]
    assert rows == int(counts.sum()) == ref.triangles.shape[0] > 400000
    assert torch.equal(got.triangles[:rows], ref.triangles)
    assert torch.equal(got.tri_std[:rows], ref.tri_std)
    assert torch.equal(got.tri_slot[:rows], ref.tri_slot)


def test_splice_wrapper_rejects_bad_inputs(dev):
    from difusion_tpu_torch.ops import marching_cubes as MC
    packed = torch.zeros(3, 64, MC.ROW, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    table = torch.full((512,), -1, dtype=torch.int64, device=dev)
    rest = (np.zeros(3, np.int64), 0.1, np.zeros(3, np.float32), 1024)
    for i, bad in ((0, packed.double()), (0, packed[:, :, :12]), (0, packed[0]),
                   (0, packed[:0]), (0, packed.transpose(0, 1)), (1, counts.int()),
                   (1, counts.cpu()), (1, counts[:2]), (2, table.int()), (2, table[:0]),
                   (2, table.view(2, 256)), (2, table.cpu())):
        args = [packed, counts, table]
        args[i] = bad
        with pytest.raises(ValueError):
            MC.mc_splice(*args, *rest)
    with pytest.raises(ValueError):
        MC.mc_splice(packed, counts, table, *rest[:3], -1)


@pytest.fixture(scope="module")
def fused_systems(dev):
    """A dense and a hash-map system that fused small frames at their
    ground-truth poses, meshing at r = 4 on each fusion frame, built twice:
    with the kernels and with the plain version in the mesher's place."""
    from difusion_tpu_torch.core import hash_map as HM
    from difusion_tpu_torch.core import map as M
    from difusion_tpu_torch.core import meshing
    from difusion_tpu_torch.core import tracker as T
    from difusion_tpu_torch.data.production import SyntheticSequence
    from difusion_tpu_torch.models.weights import load_prior
    from difusion_tpu_torch.ops import marching_cubes as MC
    from difusion_tpu_torch.ops.imgproc import Intrinsic
    from difusion_tpu_torch.slam import SLAMSystem
    calib = Intrinsic(300.0, 300.0, 79.5, 59.5, 5000.0)
    dec, enc, _ = load_prior(HYPER, 300, device=dev)
    cfgs = {"dense": M.MapConfig(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40),
                                 voxel_size=0.1, latent_dim=29, capacity=1 << 14,
                                 prune_min_vox_obs=4, ignore_count_th=1.0,
                                 encoder_count_th=600.0),
            "hash": HM.HashMapConfig(voxel_size=0.1, capacity=1 << 14, table_size=1 << 16,
                                     prune_min_vox_obs=4, ignore_count_th=1.0)}
    frames = list(SyntheticSequence(n_frames=5, h=120, w=160, calib=calib,
                                    corrugation=0.1, motion_scale=0.6))
    out = {}
    for kind, cfg in cfgs.items():
        for route in ("kernels", "plain"):
            system = SLAMSystem(cfg, T.TrackerConfig(point_budget=4096), dec, enc, calib,
                                integrate_interval=2, device=dev)
            system.use_gt_poses = True
            original = meshing.marching_cubes_sparse, meshing.mc_splice
            if route == "plain":
                meshing.marching_cubes_sparse = MC.marching_cubes_sparse_plain
                meshing.mc_splice = MC.mc_splice_plain
            try:
                _build.reset_launch_counts()
                for frame in frames:
                    system.process_frame(frame)
                torch.cuda.synchronize()
            finally:
                meshing.marching_cubes_sparse, meshing.mc_splice = original
            out[kind, route] = (system, _build.launch_counts())
    return out, dec


@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_incremental_extracts_through_the_kernels_equal_plain(fused_systems, kind):
    """Three incremental r = 4 extracts on the fusion frames: the same
    triangle soup and slots (the cache splicing each extract's new
    triangles beside the ones it keeps) through the kernels as through the
    plain versions, the marching-cubes kernels launched once each a chunk
    and the splice once an extract, with one host read (none on the plain
    route)."""
    systems, _ = fused_systems
    (ks, kc), (ps, pc) = systems[kind, "kernels"], systems[kind, "plain"]
    kt, kstd = ks.mesher.triangles()
    pt, pstd = ps.mesher.triangles()
    assert len(kt) > 100
    assert np.array_equal(kt, pt) and np.array_equal(kstd, pstd)
    assert np.array_equal(ks.mesher._slot, ps.mesher._slot)
    for got, want in ((kt, pt), (kstd, pstd), (ks.mesher._slot, ps.mesher._slot)):
        assert got.dtype == want.dtype and got.flags.c_contiguous
    assert all(kc.get(k, 0) >= 3 for k in MC_COUNTS)
    assert kc["mc_classify"] == kc["mc_scan"] == kc["mc_emit"]
    assert kc["mc_splice"] >= 3 and ks.mesher.last_stats["host_reads"] == 1
    assert not any(pc.get(k, 0) for k in MC_COUNTS + ("mc_splice",))


@pytest.mark.parametrize("kind,r", [("dense", 4), ("dense", 8), ("hash", 8)])
def test_full_extract_through_the_kernels_equals_plain(fused_systems, kind, r):
    """A no_cache extract of the fused map: the kernels' soup equals the
    plain version's; each kernel launched once a chunk (several chunks at r
    = 8, where max_eval_points is cut to make them); and the same soup from
    a side stream, as the run_async worker extracts."""
    from difusion_tpu_torch.core import meshing
    from difusion_tpu_torch.ops import marching_cubes as MC
    systems, dec = fused_systems
    system = systems[kind, "kernels"][0]
    cls = meshing.HashMeshExtractor if kind == "hash" else meshing.MeshExtractor

    def extract(plain=False, stream=None):
        ex = cls(system.map_cfg, dec, voxel_resolution=r, max_eval_points=1 << 14)
        original = meshing.marching_cubes_sparse, meshing.mc_splice
        if plain:
            meshing.marching_cubes_sparse = MC.marching_cubes_sparse_plain
            meshing.mc_splice = MC.mc_splice_plain
        try:
            _build.reset_launch_counts()
            if stream is None:
                ex.extract(system.state, max_std=0.15, no_cache=True)
            else:
                stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(stream):
                    ex.extract(system.state, max_std=0.15, no_cache=True)
                stream.synchronize()
        finally:
            meshing.marching_cubes_sparse, meshing.mc_splice = original
        return (*ex.triangles(), ex._slot), ex.last_stats, _build.launch_counts()
    kernels, stats, counts = extract()
    plain, _, plain_counts = extract(plain=True)
    side, side_stats, side_counts = extract(stream=torch.cuda.Stream(dev))
    assert len(kernels[0]) > 100
    for got, want, side_got in zip(kernels, plain, side):
        assert got.dtype == want.dtype and got.flags.c_contiguous
        assert np.array_equal(got, want) and np.array_equal(side_got, got)
    assert {k: counts.get(k, 0) for k in MC_COUNTS} == dict.fromkeys(MC_COUNTS,
                                                                     stats["mc_chunks"])
    assert counts["mc_splice"] == side_counts["mc_splice"] == 1
    assert stats["host_reads"] == side_stats["host_reads"] == 1
    assert not any(plain_counts.get(k, 0) for k in MC_COUNTS + ("mc_splice",))
    if r == 8:
        assert stats["mc_chunks"] >= 2


@pytest.mark.parametrize("r,n", [(4, 1234), (8, 173)])
@pytest.mark.parametrize("instance", ["decode_fused", "decode_fwd_wide"])
def test_decode_of_live_blocks_equals_bucket_rows(dev, packed, wide, instance, r, n):
    """Kernel 3 (the 128-wide instance and the wide one) decodes a block's
    lattice bit for bit alike whatever else the dispatch holds: the mesher's
    decode of the first n slots equals the first n rows of its decode of the
    slot list padded with slot 0 to the power-of-two bucket (one 2^20-site
    dispatch)."""
    from difusion_tpu_torch.core import meshing
    dec, pk = wide if instance == "decode_fwd_wide" else (None, packed)
    width = 256 if instance == "decode_fwd_wide" else 29
    assert fused.instance_name(pk, width, dev) == instance
    gen = torch.Generator(device=dev).manual_seed(n)
    table = torch.randn(4 * n, width, generator=gen, device=dev) * 0.3
    B = meshing._next_bucket(n)
    assert B * (2 * r) ** 3 == 1 << 20
    slot_pad = torch.zeros(B, dtype=torch.int64, device=dev)
    slot_pad[:n] = torch.randperm(4 * n, generator=gen, device=dev)[:n]
    full = meshing._eval_and_negate(dec, pk, table, slot_pad, r)
    live = meshing._eval_and_negate(dec, pk, table, slot_pad[:n], r)
    torch.cuda.synchronize()
    for a, b in zip(live, full):
        assert a.shape[0] == n and torch.equal(a, b[:n])


def test_export_equals_bucket_padded_decode(fused_systems, monkeypatch):
    """An r = 8 no_cache extract of the fused dense map, which decodes only
    its live blocks (the last dispatch ragged), emits the triangles and stds
    of the same extract whose every dispatch decodes the slot list padded
    with slot 0 to a whole dispatch and keeps the live rows: the padding
    changed nothing the mesh reads."""
    from difusion_tpu_torch.core import meshing
    systems, dec = fused_systems
    system = systems["dense", "kernels"][0]

    def extract():
        ex = meshing.MeshExtractor(system.map_cfg, dec, voxel_resolution=8)
        ex.extract(system.state, max_std=0.15, no_cache=True)
        torch.cuda.synchronize()
        return ex.triangles(), ex.last_stats
    (lt, lstd), stats = extract()
    C = stats["sites_per_dispatch"] // 16 ** 3
    n = stats["blocks"]
    assert stats["decoded_blocks"] == n and n % C
    original, padded_rows = meshing._eval_and_negate, []

    def padded(decoder, packed, table, chunk, r):
        slot_pad = torch.zeros(C, dtype=chunk.dtype, device=chunk.device)
        slot_pad[:chunk.shape[0]] = chunk
        padded_rows.append(C - chunk.shape[0])
        return tuple(v[:chunk.shape[0]] for v in original(decoder, packed, table, slot_pad, r))
    monkeypatch.setattr(meshing, "_eval_and_negate", padded)
    (pt, pstd), _ = extract()
    assert padded_rows[-1] > 0 and sum(padded_rows) == C * stats["decode_dispatches"] - n
    assert len(lt) > 100
    assert np.array_equal(lt, pt) and np.array_equal(lstd, pstd)


# ---------------------------------------------------------------------------
# Frame packing: csrc/frame_pack.cu against its plain version
# ---------------------------------------------------------------------------


def _camera_frames(k, h, w, seed):
    """K random uint8 RGB and uint16 depth frames, the depth's edge values
    (0, 255, 256, 65535) at its first pixels and every r + g + b sum early on."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (k, h, w, 3), dtype=np.uint8)
    depth = rng.integers(0, 1 << 16, (k, h, w), dtype=np.uint16)
    edges = np.array([0, 255, 256, 65535], np.uint16)
    depth.reshape(-1)[:min(4, depth.size)] = edges[:min(4, depth.size)]
    s = np.arange(min(766, k * h * w))
    flat = rgb.reshape(-1, 3)
    flat[:len(s)] = np.stack([np.minimum(s, 255), np.clip(s - 255, 0, 255),
                              np.clip(s - 510, 0, 255)], -1)
    return rgb, depth


@pytest.mark.parametrize("k,h,w", [(1, 480, 640), (12, 480, 640), (3, 7, 5), (2, 4, 12),
                                   (1, 1, 1), (2, 3, 20), (5, 33, 48)])
def test_frame_pack_kernel_equals_pack_frame(dev, k, h, w):
    """K frames staged in one pinned buffer, uploaded and packed by the
    kernel: the (K, h, 3w) planes equal the plain version's on the CPU
    byte for byte (which the CPU tests hold to the JAX package's
    ``pack_frame``, edge values included), at 480x640 for K = 1 and 12 (16
    pixels a thread) and at widths that are no multiple of 16 (1 pixel a
    thread); one counted launch a call."""
    from difusion_tpu_torch.ops import frame_pack as FP
    rgb, depth = _camera_frames(k, h, w, seed=k * h * w)
    staged = FP.RawFrames(k, h, w, pin=True)
    for i in range(k):
        staged.put(i, rgb[i], depth[i])
    before = _build.launch_counts().get("frame_pack", 0)
    got = staged.pack(dev)
    torch.cuda.synchronize()
    assert _build.launch_counts()["frame_pack"] == before + 1
    ref = FP.frame_pack_plain(torch.from_numpy(rgb), torch.from_numpy(depth.view(np.int16)))
    assert got.is_cuda and torch.equal(got.cpu(), ref)
    assert torch.equal(staged.pack(dev, 1).cpu(), ref[:1])


def test_frame_pack_kernel_on_unaligned_views(dev):
    """RGB one byte into its buffer, at a width of 32, takes the kernel's
    byte-wise path: the same planes as the plain version; a wrong dtype or
    shape raises."""
    from difusion_tpu_torch.ops import frame_pack as FP
    k, h, w = 2, 8, 32
    n = k * h * w
    rgb_np, depth_np = _camera_frames(k, h, w, seed=7)
    buf = torch.zeros(1 + 3 * n, dtype=torch.uint8, device=dev)
    buf[1:].copy_(torch.from_numpy(rgb_np.reshape(-1)))
    rgb = buf[1:].view(k, h, w, 3)
    depth = torch.from_numpy(depth_np.view(np.int16)).to(dev)
    assert rgb.data_ptr() % 4 == 1
    got = FP.frame_pack(rgb, depth)
    ref = FP.frame_pack_plain(rgb.cpu(), depth.cpu())
    assert torch.equal(got.cpu(), ref)
    with pytest.raises(ValueError):
        FP.frame_pack(rgb, depth.to(torch.int32))
    with pytest.raises(ValueError):
        FP.frame_pack(rgb[:, :, :-1], depth)


@pytest.fixture(scope="module")
def small_slam(dev):
    """A factory of small systems on the card (fusion every 2, meshing off)
    and 16 synthetic 120x160 frames."""
    from difusion_tpu_torch.core import map as M
    from difusion_tpu_torch.core import tracker as T
    from difusion_tpu_torch.data.production import SyntheticSequence
    from difusion_tpu_torch.models.weights import load_prior
    from difusion_tpu_torch.ops.imgproc import Intrinsic
    from difusion_tpu_torch.slam import SLAMSystem
    calib = Intrinsic(300.0, 300.0, 79.5, 59.5, 5000.0)
    dec, enc, _ = load_prior(HYPER, 300, device=dev)
    cfg = M.MapConfig(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
                      latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
                      ignore_count_th=1.0, encoder_count_th=600.0)

    class Frames(list):
        first_iso = None
        gt_trajectory = None
    frames = Frames(SyntheticSequence(n_frames=16, h=120, w=160, calib=calib,
                                      corrugation=0.1, motion_scale=0.6))

    def make(lossless=False):
        return SLAMSystem(cfg, T.TrackerConfig(point_budget=4096, lossless_packing=lossless),
                          dec, enc, calib, integrate_interval=2, meshing=False, device=dev)
    return make, frames


@pytest.mark.parametrize("path", ["chunk12", "per_frame", "process_frame"])
def test_slam_loop_packs_on_the_card_as_numpy_did(small_slam, monkeypatch, path):
    """16 frames through ``run_sequence(chunk=12)`` (frame 0 alone, then
    chunks of 12 and 3), ``run_sequence()`` or ``process_frame`` one by one:
    one ``frame_pack`` launch an upload (3, 16, 16), and poses and latents
    ``torch.equal`` to the numpy route's (``pack_frame`` on the host, the
    packed frames uploaded), which launches none."""
    from difusion_tpu_torch.ops import frame_pack as FP
    make, frames = small_slam

    def run():
        system = make()
        _build.reset_launch_counts()
        if path == "process_frame":
            for frame in frames:
                system.process_frame(frame)
        else:
            system.run_sequence(frames, chunk=12 if path == "chunk12" else 0)
        torch.cuda.synchronize()
        return system, _build.launch_counts().get("frame_pack", 0)
    card, n_card = run()
    monkeypatch.setattr(FP, "takes", lambda *a, **k: False)
    host, n_host = run()
    assert (n_card, n_host) == ({"chunk12": 3}.get(path, 16), 0)
    for a, b in zip(card.tracker.pose_history(), host.tracker.pose_history()):
        assert torch.equal(a, b), (a - b).abs().max()
    assert torch.equal(card.state.latents, host.state.latents)


@pytest.mark.parametrize("route", ["float", "lossless"])
def test_float_frames_and_lossless_packing_launch_no_frame_pack(small_slam, route):
    """Float frames, or ``lossless_packing``, pack in numpy: no
    ``frame_pack`` launch on the chunked path or per frame."""
    from difusion_tpu_torch.data.production import FrameData
    make, frames = small_slam
    if route == "float":
        frames = type(frames)(FrameData(f.rgb.astype(np.float32) / 255,
                                        f.depth.astype(np.float32) / 5000.0, f.depth_ok,
                                        f.calib, f.gt_pose, f.frame_id) for f in frames)
    system = make(lossless=route == "lossless")
    _build.reset_launch_counts()
    system.run_sequence(type(frames)(frames[:8]), chunk=3)
    for frame in frames[8:]:
        system.process_frame(frame)
    torch.cuda.synchronize()
    assert _build.launch_counts().get("frame_pack", 0) == 0
    assert len(system.tracker.pose_history()[0]) == len(frames)


# ---------------------------------------------------------------------------
# The graph program: the tracker's frame as one launch with device-side loops
# ---------------------------------------------------------------------------


def test_graph_program_loops_on_the_device(dev):
    """A WHILE segment runs until its flag is set, at least once, and the
    device counts its passes; plain segments before and after run once."""
    from difusion_tpu_torch.utils.cudagraph import GraphProgram
    x = torch.zeros((), device=dev)
    y = torch.zeros((), device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    limit = torch.full((), 5.0, device=dev)

    def init():
        x.zero_()
        done.fill_(False)

    def body():
        x.copy_(torch.where(done, x, x + 1))
        done.copy_(done | (x >= limit))

    prog = GraphProgram(dev)
    prog.add(init)
    prog.add(body, done=done)
    prog.add(lambda: y.copy_(x * 2))
    prog.build(keep=[limit])
    for want in (5.0, 1.0, 7.0):
        limit.fill_(want)
        prog.run()
        torch.cuda.synchronize()
        assert x.item() == max(want, 1.0) and y.item() == 2 * x.item() and done.item()
    assert prog.loop_passes() == [0, 13, 0] and prog.n_replays == 3
    assert prog.n_flag_reads == 0


@pytest.fixture(scope="module")
def tracked(dev):
    """A small system on the card after frame 0, and the next frames packed."""
    from difusion_tpu_torch.core import map as M
    from difusion_tpu_torch.core import tracker as T
    from difusion_tpu_torch.data.production import SyntheticSequence
    from difusion_tpu_torch.models.weights import load_prior
    from difusion_tpu_torch.ops.imgproc import Intrinsic
    from difusion_tpu_torch.slam import SLAMSystem
    calib = Intrinsic(300.0, 300.0, 79.5, 59.5, 5000.0)
    dec, enc, _ = load_prior(HYPER, 300, device=dev)
    cfg = M.MapConfig(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
                      latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
                      ignore_count_th=1.0, encoder_count_th=600.0)
    frames = list(SyntheticSequence(n_frames=4, h=120, w=160, calib=calib,
                                    corrugation=0.1, motion_scale=0.6))

    def make():
        system = SLAMSystem(cfg, T.TrackerConfig(point_budget=4096), dec, enc, calib,
                            integrate_interval=2, meshing=False, device=dev)
        system.process_frame(frames[0])
        return system
    packed = torch.stack([torch.from_numpy(T.pack_frame(f.rgb, f.depth, 5000.0))
                          for f in frames[1:]]).to(dev)
    return make, frames, packed


def test_graph_replay_of_gn_step_equals_eager(tracked):
    """The chunked path (graph replays, the loops on the card) gives the
    poses and map of the per-frame path's ``driver="host"`` (the same
    program uncaptured) bit for bit, reads no exit flag, and launches
    kernels 1 and 2 from inside the captured graphs."""
    make, frames, packed = tracked
    eager, graphed = make(), make()
    for frame in frames[1:]:
        eager.process_frame(frame, driver="host")
    _build.reset_launch_counts()
    graphed.process_chunk(packed, 160)
    counts = _build.launch_counts()
    for a, b in zip(graphed.tracker.pose_history(), eager.tracker.pose_history()):
        assert torch.equal(a, b), (a - b).abs().max()
    assert torch.equal(graphed.state.latents, eager.state.latents)
    assert graphed.tracker.n_host_syncs == 0 < eager.tracker.n_host_syncs
    assert not next(iter(eager.tracker.programs.values())).program.captured
    prog = next(iter(graphed.tracker.programs.values()))
    assert prog.program.captured
    from difusion_tpu_torch.utils.cudagraph import WARM_UP_PASSES
    assert prog.program.n_replays == 3
    assert counts["window_stat_sums"] == 3 + WARM_UP_PASSES
    passes = prog.program.loop_passes()
    assert counts["decode_grad_fused"] == passes[4] + passes[6] + 2 * WARM_UP_PASSES


def test_stamped_track_program_times_its_segments(tracked):
    """Built with the span recorder on, the tracker's program has a stamp
    before its first segment and after each one; every segment's device
    time is positive, their sum over the launches is no more than the
    launches' time on CUDA events, and the poses and map are those of the
    program built with the recorder off, which has one node a segment."""
    from difusion_tpu_torch.utils import tracing
    make, _, packed = tracked
    plain = make()
    plain.process_chunk(packed, 160)
    tracing.enable()
    try:
        stamped = make()
        stamped.process_chunk(packed, 160)            # builds the program
        prog = next(iter(stamped.tracker.programs.values())).program
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        before = prog.segment_ns()
        start.record()
        for _ in range(4):
            prog.run()
        stop.record()
        torch.cuda.synchronize()
        after = prog.segment_ns()
    finally:
        tracing.disable()
        tracing.reset()
    for a, b in zip(stamped.tracker.pose_history(), plain.tracker.pose_history()):
        assert torch.equal(a, b), (a - b).abs().max()
    assert torch.equal(stamped.state.latents, plain.state.latents)
    names = prog.names
    assert list(after) == names and names[0] == "pre" and names[-1] == "finish"
    spent = {k: after[k] - before[k] for k in names}
    assert all(v > 0 for v in spent.values()), spent
    wall_ns = start.elapsed_time(stop) * 1e6
    assert sum(spent.values()) <= wall_ns, (sum(spent.values()), wall_ns)
    assert prog.n_nodes == 2 * len(names) + 1
    plain_prog = next(iter(plain.tracker.programs.values())).program
    assert plain_prog.n_nodes == len(names) and plain_prog.segment_ns() == {}


def test_globaltimer_steps_are_fine():
    """The global timer that the stamps read moves in steps a kernel can
    see; their least is the stamps' resolution (PERF.md gives it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from difusion_tpu_torch.utils.cudagraph import globaltimer_steps
    steps = globaltimer_steps("cuda", 4096)
    assert min(steps) > 0 and sorted(steps)[len(steps) // 2] < 10_000, steps[:16]


def test_replay_after_done_leaves_the_carry(tracked):
    """One more eager ``gn_step`` on the carry the graph left (done) returns
    every field ``torch.equal``: a step past ``done`` is a no-op."""
    from difusion_tpu_torch.core import tracker as T
    make, _, packed = tracked
    system = make()
    prog = system.tracker.program(packed.shape[1:], 160)
    prog.load_state(system.state)
    prog.preprocess_and_track(packed[0])
    torch.cuda.synchronize()
    assert bool(prog.carry.done)
    n, terms = system.tracker.tcfg.iter_config[-1]
    before = [t.clone() for t in prog.carry]
    again = T.gn_step(prog._problem, n, terms, prog.carry)
    for a, b in zip(again, before):
        assert torch.equal(a, b)


def test_kernels_launch_inside_a_captured_graph(dev, packed):
    """Kernels 1 and 2, captured into a CUDA graph through their wrappers and
    replayed on new inputs, match their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(5)
    lat = torch.randn(4096, 29, generator=gen, device=dev) * 0.3
    rel = torch.rand(4096, 3, generator=gen, device=dev) - 0.5
    pc = torch.randn(60, 80, 3, generator=gen, device=dev) * 0.1
    ok = torch.rand(60, 80, generator=gen, device=dev) > 0.2
    fused.decode_grad_fused(packed, lat, rel)             # loads outside the capture
    stencil.window_stat_sums_map(pc, ok, 6, 0.01, 0.04)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fused.decode_grad_fused(packed, lat, rel)
        sums = stencil.window_stat_sums_map(pc, ok, 6, 0.01, 0.04)
    lat.copy_(torch.randn(4096, 29, generator=gen, device=dev) * 0.3)
    pc.copy_(torch.randn(60, 80, 3, generator=gen, device=dev) * 0.1)
    graph.replay()
    torch.cuda.synchronize()
    ref = fused.decode_grad_plain(packed, lat, rel)
    assert torch.allclose(got[0], ref[0], atol=1e-5) and torch.allclose(got[1], ref[1], atol=1e-5)
    assert not bool(fused.grad_rows_off(got[2], packed, lat, rel).any())
    zero = torch.zeros((), device=dev)
    planes = (*(torch.where(ok, pc[..., c], zero).contiguous() for c in range(3)), ok.float())
    plain = torch.stack(stencil.window_stat_sums_plain(*planes, 6, 0.01, 0.04))
    assert torch.equal(sums, plain)


def test_segment_sum_on_the_card_is_reproducible(dev):
    """The card's segment sum (a sort, then a segmented reduction: fusion's
    and the latent optimizer's accumulation) against an f64 ``index_add_``
    to 1e-4 (rtol 1e-5), with a segment of 40,000 rows, and bit-equal on a
    second call.  Against f64, not the CPU's f32 ``index_add_``: a
    sequential f32 sum of 40,000 terms is off by ~1e-3 itself."""
    from difusion_tpu_torch.core import map as M
    gen = torch.Generator().manual_seed(0)
    seg = torch.randint(0, 2048, (65536,), generator=gen)
    seg[:40000] = 2048
    values = torch.randn(65536, 29, generator=gen)
    ref = torch.zeros(2049, 29, dtype=torch.float64).index_add_(0, seg, values.double())
    a = M._segment_sum(2049, seg.to(dev), values.to(dev))
    b = M._segment_sum(2049, seg.to(dev), values.to(dev))
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu().double(), ref, rtol=1e-5, atol=1e-4)


def test_worker_launches_beside_a_capture(dev, packed):
    """A thread launching kernel 3 on a stream of its own while the main
    thread captures kernel 1 into a graph (as the mesh worker runs beside
    the tracker's first capture): both results right, and the capture's
    recording holds only its own launch."""
    import threading
    gen = torch.Generator(device=dev).manual_seed(5)
    lat = torch.randn(1 << 18, 29, generator=gen, device=dev) * 0.3
    rel = torch.rand(1 << 18, 3, generator=gen, device=dev) - 0.5
    small_lat, small_rel = lat[:4096].clone(), rel[:4096].clone()
    fused.decode_grad_fused(packed, small_lat, small_rel)
    torch.cuda.synchronize()
    out, stop = [0, None], threading.Event()             # launches, the last result
    stream = torch.cuda.Stream()

    def worker():
        with torch.cuda.stream(stream):
            while not stop.is_set():
                out[1] = fused.decode_fused(packed, lat, rel)
                out[0] += 1
        stream.synchronize()
    t = threading.Thread(target=worker)
    _build.reset_launch_counts()
    t.start()
    graph = torch.cuda.CUDAGraph()
    with _build.recording() as rec, torch.cuda.graph(graph, capture_error_mode="thread_local"):
        got = fused.decode_grad_fused(packed, small_lat, small_rel)
    graph.replay()
    stop.set()
    t.join()
    torch.cuda.synchronize()
    assert rec == {"decode_grad_fused": 1} and out[0] >= 1
    assert _build.launch_counts().get("decode_fused", 0) == out[0]
    ref = fused.decode_fused_plain(packed, lat, rel)
    assert torch.allclose(out[1][0], ref[0], atol=1e-5)
    ref_g = fused.decode_grad_plain(packed, small_lat, small_rel)
    assert torch.allclose(got[0], ref_g[0], atol=1e-5)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One train step of the full-width networks (decoder 128x4, encoder
    6-32-64-256) on the card against the same step on the CPU, with the same
    dropout masks: every gradient leaf within 1e-4 x its largest |g|; after
    the step every entry within 2 lr, the entries of large gradient within
    1e-6, the BatchNorm buffers within 1e-6."""
    import numpy as np

    from difusion_tpu_torch.models.decoder import DecoderSpec
    from difusion_tpu_torch.models.encoder import EncoderSpec
    from difusion_tpu_torch.train import trainer as TR
    from difusion_tpu_torch.train.losses import LossConfig
    spec_d, spec_e, cfg = DecoderSpec(), EncoderSpec(), LossConfig()
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (8, 512, 3)).astype(np.float32)
    sdf = np.concatenate([xyz, np.linalg.norm(xyz, axis=-1, keepdims=True) - 0.6], -1)
    surf = rng.normal(size=(8, 128, 6)).astype(np.float32)
    _, outs = spec_d.layer_dims()
    masks = {i: torch.from_numpy(rng.random((8 * 512, outs[i])) < 0.8)
             for i in spec_d.dropout if i < len(outs) - 1}
    states = {d: TR.create_train_state(spec_d, spec_e, 0, d) for d in ("cpu", dev)}
    grads = {}
    for d, st in states.items():
        probe = TR.state_from_params(spec_d, spec_e, st.dec.to_params(), st.enc.to_params(), d)
        _, grads[d] = TR.loss_and_grads(cfg, probe, torch.from_numpy(sdf).to(d),
                                        torch.from_numpy(surf).to(d), 3,
                                        masks={i: m.to(d) for i, m in masks.items()})
    for name, g_cpu in grads["cpu"].items():
        err = (grads[dev][name].cpu() - g_cpu).abs().max()
        assert err <= 1e-4 * g_cpu.abs().max() + 1e-12, name
    lr = 1e-3
    for d, st in states.items():
        states[d], _ = TR.train_step(cfg, st, torch.from_numpy(sdf).to(d),
                                     torch.from_numpy(surf).to(d), lr, lr, 3,
                                     masks={i: m.to(d) for i, m in masks.items()})
    cpu_p = dict(states["cpu"].dec.named_parameters(prefix="dec"))
    cpu_p.update(states["cpu"].enc.named_parameters(prefix="enc"))
    card = dict(states[dev].dec.named_parameters(prefix="dec"))
    card.update(states[dev].enc.named_parameters(prefix="enc"))
    for name, p in cpu_p.items():
        q = card[name].detach().cpu()
        assert (q - p.detach()).abs().max() <= 2 * lr, name
        g = grads["cpu"][name]
        big = g.abs() > 1e-3 * g.abs().max()
        assert (q[big] - p.detach()[big]).abs().max() <= 1e-6, name
    for a, b in zip(states["cpu"].enc.buffers(), states[dev].enc.buffers()):
        torch.testing.assert_close(b.cpu(), a, atol=1e-6, rtol=0)


def test_compute_sdf_on_the_card_matches_the_cpu(dev):
    """compute_sdf on the card (f32 distances, TF32 off, over two reference
    tiles) against the CPU: the same NaN set on every query whose 11th and
    12th squared distances are more than 1e-6 apart, and there the values
    within 1e-5 where the 1st and 2nd are too.  The value is the nearest
    neighbour's distance or projection, so where the two nearest are closer
    than the distances' rounding (cuBLAS and the CPU sum the 3-term dot in
    another order) either may be taken, as either package may: those
    queries are counted, and only they may differ."""
    import numpy as np

    from difusion_tpu_torch.device import resolve_device
    from difusion_tpu_torch.sampler import mesh_io
    from difusion_tpu_torch.sampler import sampler as SM
    from difusion_tpu_torch.utils.motion import Isometry
    resolve_device(dev)
    mesh = mesh_io.make_sphere(0.5, 40)
    rng = np.random.default_rng(1)
    cams = [Isometry.look_at(p * 1.5, np.zeros(3)) for p in SM.equidist_points_on_sphere(40)]
    xyz, nrm = SM.visible_surface_samples(mesh, cams, 0.8, 60000, rng, res=200, device=dev)
    assert len(xyz) > SM.REF_TILE
    base, _ = SM.sample_on_triangles(mesh, 8000, rng)
    q = np.concatenate([base + rng.standard_normal((8000, 3)).astype(np.float32) * 0.07,
                        rng.uniform(-0.6, 0.6, (4000, 3)).astype(np.float32)])
    on_card = SM.compute_sdf(q, xyz, nrm, np.sqrt(0.005), device=dev)
    on_cpu = SM.compute_sdf(q, xyz, nrm, np.sqrt(0.005), device="cpu")
    ref = torch.from_numpy(xyz).to(dev, torch.float64)
    gap_last, gap_first = [], []
    for s in range(0, len(q), 1024):
        d2 = torch.cdist(torch.from_numpy(q[s:s + 1024]).to(dev, torch.float64), ref) ** 2
        part = torch.topk(d2, 12, dim=1, largest=False).values
        gap_last.append((part[:, 11] - part[:, 10]).cpu().numpy())
        gap_first.append((part[:, 1] - part[:, 0]).cpu().numpy())
    ok = np.concatenate(gap_last) > 1e-6
    assert ok.mean() > 0.95
    np.testing.assert_array_equal(np.isnan(on_card)[ok], np.isnan(on_cpu)[ok])
    fin = ok & ~np.isnan(on_cpu)
    nearest_apart = np.concatenate(gap_first) > 1e-6
    np.testing.assert_allclose(on_card[fin & nearest_apart], on_cpu[fin & nearest_apart],
                               atol=1e-5)
    off = fin & (np.abs(on_card - on_cpu) > 1e-5)
    assert off.sum() <= (fin & ~nearest_apart).sum() and off.mean() < 1e-3


# ---------------------------------------------------------------------------
# A card that is not the current one (two cards or more; the current card
# stays cuda:0 throughout)
# ---------------------------------------------------------------------------


def test_resolve_device_names_the_card(dev):
    """``"cuda"`` resolves to the current card by its index, so that the
    caches keyed by device stay on that card when the current one changes;
    an index stays as given."""
    from difusion_tpu_torch.device import resolve_device
    assert resolve_device("cuda") == torch.device("cuda", torch.cuda.current_device())
    assert resolve_device("cuda:0").index == 0


@pytest.fixture(scope="module")
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("window,rows", [(15, 5), (20, 1), (20, 5)])
def test_window_stats_wide_tile_on_each_card(two_cards, window, rows):
    """A tile above 48 KB of shared memory (((32 + 2w)(4R + 2w) + 1) * 16
    bytes: 49,616 at w = 15, R = 5; 50,704 and 69,136 at w = 20) on cuda:0
    and then on cuda:1 from one process, both entries: bit-equal to the plain
    version on each card.  The attribute that grants it belongs to each
    card's context: a grant kept once a process launches on the second card
    without it, and the launch fails."""
    for card in two_cards:
        pc, ok, planes = _stencil_inputs(card, (45, 64), window + rows)
        ref = torch.stack(stencil.window_stat_sums_plain(*planes, window, 0.01, 0.04))
        for entry, inputs in (("window_stats_launch", planes),
                              ("window_stats_map_launch", (pc, ok))):
            got = stencil._launch_cuda(entry, inputs, 45, 64, window, 0.01, 0.04, rows=rows)
            torch.cuda.synchronize(card)
            assert got.device == card and torch.cuda.current_device() == 0
            assert torch.equal(got, ref), (str(card), entry)


def test_decoder_kernels_on_the_second_card(two_cards, packed):
    """Kernels 1 and 3 on cuda:1 while cuda:0 is current: against their plain
    versions on cuda:1 (the tolerances of the tests above), and equal to the
    same launches on cuda:0."""
    outs = {}
    for card in two_cards:
        gen = torch.Generator(device=card).manual_seed(3)
        lat = torch.randn(8193, 29, generator=gen, device=card) * 0.3
        rel = torch.rand(8193, 3, generator=gen, device=card) - 0.5
        pk = packed.to(card)
        grad = fused.decode_grad_fused(pk, lat, rel)
        fwd = fused.decode_fused(pk, lat, rel)
        ref_g = fused.decode_grad_plain(pk, lat, rel)
        ref_f = fused.decode_fused_plain(pk, lat, rel)
        torch.cuda.synchronize(card)
        assert torch.cuda.current_device() == 0
        for got, ref in ((grad[0], ref_g[0]), (grad[1], ref_g[1]), (fwd[0], ref_f[0]),
                         (fwd[1], ref_f[1])):
            assert got.device == card
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
        assert not bool(fused.grad_rows_off(grad[2], pk, lat, rel).any())
        outs[card.index] = [t.cpu() for t in (*grad, *fwd)]
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


def test_bf16_decoder_kernels_on_the_second_card(two_cards, packed_bf16):
    """Kernels 1 and 3 in bf16 on cuda:1 while cuda:0 is current (each sets
    its shared-memory attribute and reads its block count on that card):
    against their plain versions there (the bf16 tolerances above), and
    equal to the same launches on cuda:0."""
    outs = {}
    for card in two_cards:
        gen = torch.Generator(device=card).manual_seed(4)
        lat = torch.randn(K3_WAVE + 1, 29, generator=gen, device=card) * 0.3
        rel = torch.rand(K3_WAVE + 1, 3, generator=gen, device=card) - 0.5
        pk = packed_bf16.to(card)
        grad = fused.decode_grad_fused(pk, lat[:8449], rel[:8449])
        fwd = fused.decode_fused(pk, lat, rel)
        ref_g = fused.decode_grad_plain(pk, lat[:8449], rel[:8449])
        ref_f = fused.decode_fused_plain(pk, lat, rel)
        torch.cuda.synchronize(card)
        assert torch.cuda.current_device() == 0
        for got, ref in ((grad[0], ref_g[0]), (grad[1], ref_g[1]), (fwd[0], ref_f[0]),
                         (fwd[1], ref_f[1])):
            assert got.device == card
            torch.testing.assert_close(got, ref, atol=2e-3, rtol=0)
        torch.testing.assert_close(grad[2], ref_g[2], atol=0.15, rtol=0.05)
        outs[card.index] = [t.cpu() for t in (*grad, *fwd)]
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


def test_graph_program_on_the_second_card(two_cards):
    """A GraphProgram for tensors on cuda:1, built and run while cuda:0 is
    current: its loop runs on cuda:1's device, as on the current card."""
    from difusion_tpu_torch.utils.cudagraph import GraphProgram
    card = two_cards[1]
    x = torch.zeros((), device=card)
    done = torch.zeros((), dtype=torch.bool, device=card)
    limit = torch.full((), 5.0, device=card)

    def init():
        x.zero_()
        done.fill_(False)

    def body():
        x.copy_(torch.where(done, x, x + 1))
        done.copy_(done | (x >= limit))

    prog = GraphProgram("cuda:1")
    prog.add(init)
    prog.add(body, done=done)
    prog.build(keep=[limit])
    for want in (5.0, 2.0):
        limit.fill_(want)
        prog.run()
        torch.cuda.synchronize(card)
        assert x.item() == want and done.item()
    assert prog.loop_passes() == [0, 7] and torch.cuda.current_device() == 0


def test_track_program_on_the_second_card(two_cards):
    """The chunked path (TrackProgram: a graph launch a frame, the loops on
    the card) of a system on cuda:1 while cuda:0 is current: poses and
    latents torch.equal to the same system's on cuda:0, no exit flag read,
    kernels 1 and 2 launched on it."""
    from difusion_tpu_torch.core import map as M
    from difusion_tpu_torch.core import tracker as T
    from difusion_tpu_torch.data.production import SyntheticSequence
    from difusion_tpu_torch.models.weights import load_prior
    from difusion_tpu_torch.ops.imgproc import Intrinsic
    from difusion_tpu_torch.slam import SLAMSystem
    from difusion_tpu_torch.utils.cudagraph import WARM_UP_PASSES
    calib = Intrinsic(300.0, 300.0, 79.5, 59.5, 5000.0)
    cfg = M.MapConfig(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
                      latent_dim=29, capacity=1 << 14, prune_min_vox_obs=4,
                      ignore_count_th=1.0, encoder_count_th=600.0)
    frames = list(SyntheticSequence(n_frames=4, h=120, w=160, calib=calib,
                                    corrugation=0.1, motion_scale=0.6))
    runs = {}
    for card in reversed(two_cards):
        dec, enc, _ = load_prior(HYPER, 300, device=card)
        system = SLAMSystem(cfg, T.TrackerConfig(point_budget=4096), dec, enc, calib,
                            integrate_interval=2, meshing=False, device=card)
        system.process_frame(frames[0])
        packed = torch.stack([torch.from_numpy(T.pack_frame(f.rgb, f.depth, 5000.0))
                              for f in frames[1:]]).to(card)
        _build.reset_launch_counts()
        system.process_chunk(packed, 160)
        counts = _build.launch_counts()
        assert torch.cuda.current_device() == 0
        assert system.tracker.n_host_syncs == 0
        assert counts["window_stat_sums"] == 3 + WARM_UP_PASSES
        assert counts["decode_grad_fused"] >= 2 * 3
        assert system.state.latents.device == card
        runs[card.index] = ([p.cpu() for p in system.tracker.pose_history()],
                            system.state.latents.cpu())
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b), (a - b).abs().max()
    assert torch.equal(runs[0][1], runs[1][1])
