"""The precision route of the decoder kernels, on the CPU.

Kernels 1 and 3 (difusion_tpu_torch/csrc/decoder_grad.cu) multiply on the
tensor cores in 3xTF32: each f32 operand x is split as hi = tf32(x),
lo = tf32(x - hi) (round to nearest, ties away from zero, to 10 mantissa
bits, as ``cvt.rna.tf32.f32``), a product is lo.hi + hi.lo + hi.hi, every
two k-tiles (16 deep) of products are summed from zero and the partial joins
an f32 running sum.  This file emulates that arithmetic in plain PyTorch (TF32
rounding by bit masking, products of TF32 values exact in f32) and runs
kernel 1's and kernel 3's functions through it on the study_mixed prior, at
chip_smoke.py's input distributions.  The emulation stays within the
tolerances the kernels are held to on the card; a single TF32 pass does
not, which is why the kernels pay for three.  The tensor cores' truncating
accumulation inside a 16-deep partial is not modelled here; the card's own
checks (tests/test_torch_cuda_kernels.py, chip_smoke.py) cover it.

The kernels read their weights from the packed buffer's fragment segment;
the first test reads it back by the kernels' own indexing and holds it to
the split of the f32 weights.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from difusion_tpu_torch.models.weights import load_prior
from difusion_tpu_torch.ops import decoder_fused as fused

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
N = 4096
FLUSH = 16           # depth summed from zero before joining the f32 sum
SDF_ATOL = 1e-5      # the card's tolerances (chip_smoke.py)
GRAD_ATOL = GRAD_RTOL = 1e-4
INPUTS = {"kernel1": (-0.5, 0.5), "kernel3": (-1.0, 0.75)}   # rel ranges


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 by bit masking: add half of the 13 dropped bits'
    range to the magnitude, then truncate (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


@pytest.fixture(scope="module")
def packed():
    dec, _, _ = load_prior(HYPER, 300, device="cpu")
    return fused.pack_fused_decoder(dec)


def _segment_offsets():
    out, off = {}, 0
    for name in fused.TC_LAYERS:
        k, n = dict(fused._SEGMENTS)[name]
        out[name] = (off, k, n)
        off += 2 * k * n
    return out


def unfrag(tc: torch.Tensor, name: str):
    """(hi, lo) (K, N) weights of one layer as the kernels read them: lane
    4g + t of (k-tile kt, n-tile nt) multiplies its A columns 8kt + 2t and
    8kt + 2t + 1 by its float4 (hi, hi, lo, lo)."""
    off, k, n = _segment_offsets()[name]
    frag = tc[off:off + 2 * k * n].view(k // 8, n // 8, 32, 4)
    hi, lo = torch.empty(k, n), torch.empty(k, n)
    kt, nt = torch.arange(k // 8)[:, None], torch.arange(n // 8)[None, :]
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(2):
            rows, cols = 8 * kt + 2 * t + e, 8 * nt + g
            hi[rows, cols] = frag[:, :, lane, e]
            lo[rows, cols] = frag[:, :, lane, 2 + e]
    return hi, lo


def mm_3xtf32(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    a_hi, a_lo = split(a)
    out = torch.zeros(a.shape[0], w_hi.shape[1])
    for k0 in range(0, a.shape[1], FLUSH):
        s = slice(k0, k0 + FLUSH)
        out = out + (a_lo[:, s] @ w_hi[s] + a_hi[:, s] @ w_lo[s] + a_hi[:, s] @ w_hi[s])
    return out


def decode_emulated(packed: torch.Tensor, latent, rel, passes: int):
    """Kernel 1's function (sdf, std, d sdf / d xyz) with every matrix
    product in 3xTF32 (passes=3) or one TF32 pass (passes=1); biases, relu,
    heads and the xyz row-dots in f32, as the kernels do them."""
    p = fused.unpack(packed)
    tc = p["tc"]
    if passes == 3:
        ws = {name: unfrag(tc, name) for name in fused.TC_LAYERS}

        def mm(a, name):
            return mm_3xtf32(a, *ws[name])
    else:
        def mm(a, name):
            return tf32(a) @ tf32(p[name])
    x = torch.cat([latent, rel], dim=1)
    z0 = mm(x, "f0") + p["b0"]
    z1 = mm(torch.relu(z0), "f1") + p["b1"]
    z2 = mm(torch.relu(z1), "f2") + p["b2"]
    z3 = mm(torch.cat([torch.relu(z2), x], dim=1), "f3") + p["b3"]
    h3 = torch.relu(z3)
    sdf = torch.tanh(h3 @ p["w_sdf"] + p["b_head"][0])
    std = 0.05 + 0.5 * torch.nn.functional.softplus(h3 @ p["w_std"] + p["b_head"][1])
    zero = torch.zeros(())
    dz3 = torch.where(z3 > 0, (1.0 - sdf * sdf)[:, None] * p["w_sdf"], zero)
    dz2 = torch.where(z2 > 0, mm(dz3, "g3"), zero)
    dz1 = torch.where(z1 > 0, mm(dz2, "g2"), zero)
    dz0 = torch.where(z0 > 0, mm(dz1, "g1"), zero)
    return sdf, std, dz3 @ p["w3_xyz"] + dz0 @ p["w0_xyz"]


def _inputs(kernel: str, seed: int):
    rng = np.random.default_rng(seed)
    lo, hi = INPUTS[kernel]
    lat = torch.from_numpy(rng.normal(0, 0.3, (N, 29)).astype(np.float32))
    rel = torch.from_numpy(rng.uniform(lo, hi, (N, 3)).astype(np.float32))
    return lat, rel


def _errors(kernel: str, packed, passes: int):
    lat, rel = _inputs(kernel, seed=len(kernel) + passes)
    sdf, std, grad = decode_emulated(packed, lat, rel, passes)
    ref = fused.decode_grad_plain(packed, lat, rel)
    sdf_err = max((sdf - ref[0]).abs().max().item(), (std - ref[1]).abs().max().item())
    grad_off = int(fused.grad_rows_off(grad, packed, lat, rel, GRAD_ATOL, GRAD_RTOL).sum())
    return sdf_err, grad_off


@pytest.mark.parametrize("name", fused.TC_LAYERS)
def test_fragment_segment_is_the_split_weights(packed, name):
    """Read back by the kernels' fragment indexing, the packed hi/lo segment
    is exactly the TF32 split of the layer's f32 weights."""
    p = fused.unpack(packed)
    hi, lo = unfrag(p["tc"], name)
    want_hi, want_lo = split(p[name])
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert (hi + lo - p[name]).abs().max() <= 2.0 ** -20 * p[name].abs().max()


@pytest.mark.parametrize("kernel", sorted(INPUTS))
def test_3xtf32_stays_within_card_tolerance(packed, kernel):
    """3xTF32: sdf/std within atol 1e-5 of the f32 plain version, every
    gradient row within atol 1e-4 + rtol 1e-4 (on either side of a relu
    kink).  Kernel 3 computes only sdf/std; its rows are checked all the
    same, at its lattice input range."""
    sdf_err, grad_off = _errors(kernel, packed, passes=3)
    assert sdf_err <= SDF_ATOL, sdf_err
    assert sdf_err <= 2e-6, sdf_err          # f32-level, with a wide margin
    if kernel == "kernel1":
        assert grad_off == 0, grad_off


@pytest.mark.parametrize("kernel", sorted(INPUTS))
def test_single_tf32_pass_misses_card_tolerance(packed, kernel):
    """One TF32 pass is off by far more than the card's tolerances: in sdf
    and std by ~6e-4, and in the gradient (by up to ~0.2) on ~9% of rows."""
    sdf_err, grad_off = _errors(kernel, packed, passes=1)
    assert sdf_err > 10 * SDF_ATOL, sdf_err
    if kernel == "kernel1":
        assert grad_off > N // 100, grad_off
