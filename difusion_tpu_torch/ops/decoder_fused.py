"""Fused decoder kernels: kernel 1 (forward + d(sdf)/d(xyz)) and kernel 3
(forward only).

* :func:`decode_grad_fused` is the counterpart of
  difusion_tpu/ops/decoder_fused.py:189-296 (``_mlp_grad_kernel`` /
  ``decode_grad_fused``), which the GN SDF term calls on every iteration.
* :func:`decode_fused` is the counterpart of :105-181 (``_mlp_kernel`` /
  ``decode_fused``), the mesher's lattice decode.

Each wrapper launches its hand-written CUDA kernel (``csrc/decoder_grad.cu``
in f32, ``csrc/decoder_bf16.cu`` in bf16) on CUDA tensors and runs its plain
version
(:func:`decode_grad_plain`, :func:`decode_fused_plain`) on CPU tensors.
There is no other route: a CUDA tensor never reaches a plain version
through a wrapper.

Weights are packed once per decoder by :func:`pack_fused_decoder` into one
flat f32 buffer: each weight in both orientations (``W^T`` for the forward,
``W`` for the backward) and the xyz columns of the two input-side weights,
which the plain versions read, then the biases and heads, which the kernels
read too, and last the kernels' own copy of the seven weight matrices, split
into TF32 hi/lo parts and laid out in mma fragment order (:func:`_tc_frag`).

Both kernels have a second mode, the JAX package's bf16 ``w_stack``
(difusion_tpu/ops/decoder_fused.py:99, :139-140, :254-255):
``pack_fused_decoder(decoder, torch.bfloat16)`` rounds the folded weights to
bf16 (biases stay f32) and stores the kernels' copy in bf16 as the tiles
``wgmma`` reads from shared memory (:func:`_wgmma_tiles`), so the pack is
shorter (``PACKED_SIZE_BF16``).  The
wrappers select the mode by the pack's size, as the JAX package selects it
by ``w_stack.dtype``: the inputs and every hidden activation are rounded to
bf16, each backward ``dz`` after its relu mask too, and every product sums
in f32.  The bf16 instances count their launches as ``decode_grad_bf16``
and ``decode_fwd_bf16``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..models.decoder import Decoder, DecoderSpec, bf16_round
from . import _build

LAT, DIN, HID, H2 = 29, 32, 128, 96
_SEGMENTS = (("f0", (DIN, HID)), ("f1", (HID, HID)), ("f2", (HID, H2)),
             ("f3", (HID, HID)), ("g3", (HID, H2)), ("g2", (H2, HID)),
             ("g1", (HID, HID)), ("w3_xyz", (HID, 3)), ("w0_xyz", (HID, 3)),
             ("b0", (HID,)), ("b1", (HID,)), ("b2", (H2,)), ("b3", (HID,)),
             ("w_sdf", (HID,)), ("w_std", (HID,)), ("b_head", (4,)))
# the kernels' weight stream, in the order they multiply: forward, backward
TC_LAYERS = ("f0", "f1", "f2", "f3", "g3", "g2", "g1")
_SEGMENTS += (("tc", (2 * sum(int(torch.Size(s).numel()) for name, s in _SEGMENTS
                              if name in TC_LAYERS),)),)
PACKED_SIZE = sum(int(torch.Size(s).numel()) for _, s in _SEGMENTS)
_TC_SIZE = int(dict(_SEGMENTS)["tc"][0])
# the bf16 pack: the same segments, the last one bf16 fragments two to a float
PACKED_SIZE_BF16 = PACKED_SIZE - _TC_SIZE + _TC_SIZE // 4

# multiply-adds per point: forward 32*128 + 128*128 + 128*96 + 128*128 +
# 2*128 (heads); backward 128*96 + 96*128 + 128*128 + 2*128*3 (xyz rows)
FWD_MACS = DIN * HID + HID * HID + HID * H2 + HID * HID + 2 * HID
BWD_MACS = HID * H2 + H2 * HID + HID * HID + 2 * HID * 3


def supports_spec(spec: DecoderSpec) -> bool:
    return (tuple(spec.dims) == (HID,) * 4 and tuple(spec.latent_in) == (3,)
            and spec.latent_size == LAT)


def _tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo): hi = x rounded to TF32 (10 mantissa bits, nearest,
    ties away from zero, as ``cvt.rna.tf32.f32``), lo = x - hi rounded the
    same way.  Both are f32 tensors whose low 13 bits are zero."""
    def rna(v):
        bits = (v.contiguous().view(torch.int32) + 0x1000) & -0x2000
        return bits.view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def _tc_frag(b: torch.Tensor) -> torch.Tensor:
    """A (K, N) right-hand matrix of ``act @ b`` -> its m16n8k8 B fragments,
    (K/8, N/8, 32, 4): lane 4g + t of (k-tile kt, n-tile nt) holds (hi, hi,
    lo, lo) of b[8kt + 2t, 8nt + g] and b[8kt + 2t + 1, 8nt + g].  Rows 2t
    and 2t + 1 (not t and t + 4): the lane's A values for k-positions t and
    t + 4 are then one float2 of columns 2t, 2t + 1, the pair an output
    fragment stores (csrc/mlp_tc.cuh)."""
    k, n = b.shape
    v = b.reshape(k // 8, 4, 2, n // 8, 8).permute(0, 3, 4, 1, 2)  # kt nt g t e
    hi, lo = _tf32_split(v)
    return torch.cat([hi, lo], dim=-1).reshape(k // 8, n // 8, 32, 4)


def _wgmma_tiles(b: torch.Tensor) -> torch.Tensor:
    """A (K, N) right-hand matrix of ``act @ b`` -> bf16 (K/16, N/8, 2, 8, 8),
    wgmma's K-major B operand without swizzle (csrc/decoder_bf16.cu): for
    each 16-deep k-step s and 8-column group c, two 8 x 8 core matrices (k
    values 16s .. 16s + 7, then 16s + 8 ..), each column's 8 k values one
    16-byte row: [s, c, h, j, i] = b[16s + 8h + i, 8c + j]."""
    k, n = b.shape
    v = b.reshape(k // 16, 2, 8, n // 8, 8).permute(0, 3, 1, 4, 2)  # s c h j i
    return v.to(torch.bfloat16)


def is_bf16(packed: torch.Tensor) -> bool:
    """Whether a pack is the bf16 mode's (by its size)."""
    return packed.numel() == PACKED_SIZE_BF16


def pack_fused_decoder(decoder: Decoder, dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Folded decoder -> the kernels' flat f32 weight buffer, on the
    decoder's device: (PACKED_SIZE,) for ``dtype`` float32 (3xTF32 products
    at f32 accuracy), (PACKED_SIZE_BF16,) for bfloat16 (the weights rounded
    to bf16 after the fold, biases f32)."""
    if not supports_spec(decoder.spec):
        raise ValueError(f"fused decoder kernel does not support {decoder.spec}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused decoder kernels compute in float32 or bfloat16, not {dtype}")
    bf16 = dtype == torch.bfloat16
    rw = bf16_round if bf16 else (lambda t: t)
    w = [rw(lin.weight.detach().float()) for lin in decoder.layers]   # (out, in)
    b = [lin.bias.detach().float() for lin in decoder.layers]
    u_w = rw(decoder.uncertainty.weight.detach().float()[0])
    u_b = decoder.uncertainty.bias.detach().float()
    parts = {
        "f0": w[0].t(), "f1": w[1].t(), "f2": w[2].t(), "f3": w[3].t(),
        "g3": w[3][:, :H2], "g2": w[2], "g1": w[1],
        "w3_xyz": w[3][:, H2 + LAT:], "w0_xyz": w[0][:, LAT:],
        "b0": b[0], "b1": b[1], "b2": b[2], "b3": b[3],
        "w_sdf": w[4][0], "w_std": u_w,
        "b_head": torch.cat([b[4], u_b, torch.zeros(2, device=u_b.device)]),
    }
    if bf16:
        tc = torch.cat([_wgmma_tiles(parts[name]).reshape(-1) for name in TC_LAYERS])
        parts["tc"] = tc.view(torch.float32)
    else:
        parts["tc"] = torch.cat([_tc_frag(parts[name]).reshape(-1) for name in TC_LAYERS])
    flat = torch.cat([parts[name].contiguous().reshape(-1)
                      for name, _ in _SEGMENTS])
    assert flat.numel() == (PACKED_SIZE_BF16 if bf16 else PACKED_SIZE)
    return flat


def unpack(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Views of the packed buffer's segments by name (``tc``: the kernels'
    fragments, as f32 words)."""
    out, off = {}, 0
    for name, shape in _SEGMENTS:
        size = int(torch.Size(shape).numel())
        if name == "tc" and is_bf16(packed):
            size //= 4
            shape = (size,)
        out[name] = packed[off:off + size].view(shape)
        off += size
    return out


def _forward(p: Dict[str, torch.Tensor], latent: torch.Tensor,
             rel: torch.Tensor, bf16: bool = False):
    """The written-out forward over the packed segments: (x, the hidden
    preactivations z0..z3, the activations h0..h3, sdf, std).  ``bf16``:
    the input and each activation rounded to bf16, as the bf16 kernels do
    (products of bf16 values are exact in f32; only the order of the f32
    sums differs)."""
    r = bf16_round if bf16 else (lambda t: t)
    x = r(torch.cat([latent, rel], dim=1))
    z0 = x @ p["f0"] + p["b0"]
    h0 = r(torch.relu(z0))
    z1 = h0 @ p["f1"] + p["b1"]
    h1 = r(torch.relu(z1))
    z2 = h1 @ p["f2"] + p["b2"]
    h2 = r(torch.relu(z2))
    z3 = torch.cat([h2, x], dim=1) @ p["f3"] + p["b3"]
    h3 = r(torch.relu(z3))
    sdf = torch.tanh(h3 @ p["w_sdf"] + p["b_head"][0])
    std = 0.05 + 0.5 * F.softplus(h3 @ p["w_std"] + p["b_head"][1])
    return x, (z0, z1, z2, z3), (h0, h1, h2, h3), sdf, std


def _grad(p: Dict[str, torch.Tensor], masks, sdf: torch.Tensor,
          bf16: bool = False) -> torch.Tensor:
    """The explicit sdf-only backward recurrence (decoder_fused.py:198-202)
    under the relu masks [h0 > 0] .. [h3 > 0]; ``bf16``: each dz rounded to
    bf16 after its mask (decoder_fused.py:232-238)."""
    r = bf16_round if bf16 else (lambda t: t)
    zero = torch.zeros((), dtype=sdf.dtype, device=sdf.device)
    dz3 = r(torch.where(masks[3], (1.0 - sdf * sdf)[:, None] * p["w_sdf"], zero))
    dz2 = r(torch.where(masks[2], dz3 @ p["g3"], zero))
    dz1 = r(torch.where(masks[1], dz2 @ p["g2"], zero))
    dz0 = r(torch.where(masks[0], dz1 @ p["g1"], zero))
    return dz3 @ p["w3_xyz"] + dz0 @ p["w0_xyz"]


def decode_fused_plain(packed: torch.Tensor, latent: torch.Tensor,
                       rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 3 (either mode, by the pack): the
    written-out forward."""
    *_, sdf, std = _forward(unpack(packed), latent, rel, is_bf16(packed))
    return sdf, std


def decode_grad_plain(packed: torch.Tensor, latent: torch.Tensor,
                      rel: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1 (either mode, by the pack): the
    written-out forward and the explicit sdf-only backward recurrence."""
    p, bf16 = unpack(packed), is_bf16(packed)
    _, _, hs, sdf, std = _forward(p, latent, rel, bf16)
    return sdf, std, _grad(p, [h > 0 for h in hs], sdf, bf16)


def grad_rows_off(got: torch.Tensor, packed: torch.Tensor, latent: torch.Tensor,
                  rel: torch.Tensor, atol: float = 1e-4, rtol: float = 1e-4,
                  kink: float = 1e-5) -> torch.Tensor:
    """For checking kernel 1: the rows where a gradient ``got`` (N, 3) is off
    the plain version's by more than atol + rtol |ref|.

    relu' jumps at 0, so where a hidden preactivation lies within rounding of
    0, two evaluations that are both accurate to f32 may take either side and
    return gradients that differ by a whole unit's contribution (up to ~0.05
    on the study_mixed prior).  A row whose nearest preactivation is within
    ``kink`` of 0 therefore also passes if it matches, at the same tolerance,
    the other one-sided derivative: the plain gradient with that unit's relu
    mask flipped."""
    p, bf16 = unpack(packed), is_bf16(packed)
    _, zs, hs, sdf, _ = _forward(p, latent, rel, bf16)
    ref = _grad(p, [h > 0 for h in hs], sdf, bf16)
    off = ((got - ref).abs() > atol + rtol * ref.abs()).any(dim=1)
    if bool(off.any()):
        z = torch.cat(zs, dim=1)
        dist, nearest = z.abs().min(dim=1)
        flip = torch.zeros_like(z, dtype=torch.bool)
        flip[torch.arange(z.shape[0], device=z.device), nearest] = True
        flips = flip.split([zl.shape[1] for zl in zs], dim=1)
        alt = _grad(p, [(h > 0) ^ f for h, f in zip(hs, flips)], sdf, bf16)
        other_side = ((got - alt).abs() <= atol + rtol * alt.abs()).all(dim=1)
        off &= ~(other_side & (dist < kink))
    return off


def _check_inputs(what, packed, latent, rel):
    n = latent.shape[0]
    size = PACKED_SIZE_BF16 if is_bf16(packed) else PACKED_SIZE
    for name, t, shape in (("latent", latent, (n, LAT)), ("rel", rel, (n, 3)),
                           ("packed", packed, (size,))):
        if t.device != latent.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"float32 {shape} tensor on {latent.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{what}: packed must start on a 16-byte boundary (TMA copies it)")


_libs: Dict[str, ctypes.CDLL] = {}
# library -> its entry points, each with its number of outputs
_ENTRIES = {"decoder_grad": (("decode_grad_launch", 3), ("decode_fwd_launch", 2)),
            "decoder_bf16": (("decode_grad_bf16_launch", 3), ("decode_fwd_bf16_launch", 2))}


def _load(name: str):
    """csrc/<name>.cu's library, its layout checked and its entry points
    typed once per process."""
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        got, want = ((lib.decode_grad_packed_size(), PACKED_SIZE) if name == "decoder_grad"
                     else (lib.decode_bf16_packed_size(), PACKED_SIZE_BF16))
        if got != want:
            raise RuntimeError(f"{name}.cu packed layout disagrees with ops/decoder_fused.py")
        for entry, n_out in _ENTRIES[name]:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * (3 + n_out) + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _launch(name, lib, entry, packed, latent, rel, outs):
    """Launch ``entry`` of csrc/<lib>.cu on (latent, rel, packed) -> ``outs``
    on the current stream, check it and count it as ``name``."""
    fn = getattr(_load(lib), entry)
    err = _build.launch_on(latent.device.index, fn, latent.data_ptr(), rel.data_ptr(),
                           packed.data_ptr(), *(o.data_ptr() for o in outs), latent.shape[0])
    _build.check(err, name)
    _build.count_launch(name)


def decode_grad_fused(packed: torch.Tensor, latent: torch.Tensor,
                      rel: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 29) latents, (N, 3) voxel-local xyz -> sdf (N,), std (N,),
    d sdf / d xyz (N, 3).  CUDA tensors launch kernel 1 in the pack's mode
    (or raise); CPU tensors run :func:`decode_grad_plain`."""
    if not latent.is_cuda:
        return decode_grad_plain(packed, latent, rel)
    _check_inputs("decode_grad_fused", packed, latent, rel)
    n = latent.shape[0]
    outs = (torch.empty(n, device=latent.device),
            torch.empty(n, device=latent.device),
            torch.empty(n, 3, device=latent.device))
    if n:
        if is_bf16(packed):
            _launch("decode_grad_bf16", "decoder_bf16", "decode_grad_bf16_launch", packed,
                    latent, rel, outs)
        else:
            _launch("decode_grad_fused", "decoder_grad", "decode_grad_launch", packed,
                    latent, rel, outs)
    return outs


def decode_fused(packed: torch.Tensor, latent: torch.Tensor,
                 rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 29) latents, (N, 3) voxel-local xyz -> sdf (N,), std (N,).  CUDA
    tensors launch kernel 3 in the pack's mode (or raise); CPU tensors run
    :func:`decode_fused_plain`.  N = 0 launches nothing."""
    if not latent.is_cuda:
        return decode_fused_plain(packed, latent, rel)
    _check_inputs("decode_fused", packed, latent, rel)
    n = latent.shape[0]
    outs = (torch.empty(n, device=latent.device),
            torch.empty(n, device=latent.device))
    if n:
        if is_bf16(packed):
            _launch("decode_fwd_bf16", "decoder_bf16", "decode_fwd_bf16_launch", packed,
                    latent, rel, outs)
        else:
            _launch("decode_fused", "decoder_grad", "decode_fwd_launch", packed, latent, rel,
                    outs)
    return outs

