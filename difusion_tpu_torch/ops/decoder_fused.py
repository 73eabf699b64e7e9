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

Decoders too wide for shared memory take the wide instances
(``csrc/decoder_wide.cu``): any di_decoder whose hidden layers share one
width H, a multiple of 64 up to 512, with the input fed again at one layer
(:func:`wide_layout`), DeepSDF's 8 x 512 at code 256 among them.  Their
pack (:class:`WideLayout`) holds each layer's ``W^T`` zero-padded to tile
multiples, the biases, heads and xyz columns, then the kernels' f32
fragments of every forward and backward matrix (:func:`_wide_frag`), after
a head ``meta`` = (L, H, D, J).  The wrappers tell it from the 128-wide
packs by that head on the CPU and by its size on the card (each compiled
instance's is known), launch the instance ``WIDE_INSTANCES`` names and
count it as ``decode_grad_wide`` / ``decode_fwd_wide``.  f32 only
(3xTF32).

An ``onet_cbn`` decoder (Occupancy Networks' conditional batch norm) takes
three kernels of its own (``csrc/decoder_cbn.cu``, the section at the end):
the conditioning of codes once each (:func:`cbn_condition`, counted as
``cbn_cond``), and kernels 1 and 3 over sites that carry a row index into
that conditioning (:func:`decode_grad_cbn`, :func:`decode_fwd_cbn`, counted
as ``decode_grad_cbn`` / ``decode_fwd_cbn``).  A ``pigan_film`` decoder
(pi-GAN's FiLM-SIREN) takes three more (``csrc/decoder_film.cu``): its
mapping network once a code (:func:`film_map`, ``film_map``) and kernels 1
and 3 reading each site's frequencies and phases (:func:`decode_grad_film`,
:func:`decode_fwd_film`, ``decode_grad_film`` / ``decode_fwd_film``).  Both
families' packs are a :class:`CondPack`, reached through
:func:`condition`, :func:`decode_grad_cond` and :func:`decode_fwd_cond`.
f32 only (3xTF32).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.decoder import (FILM_LRELU, Decoder, DecoderSpec, FilmSpec, bf16_round,
                              is_conditioned)
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


def _is_narrow(spec: DecoderSpec) -> bool:
    """The 128-wide kernels' decoder (``csrc/decoder_grad.cu``)."""
    return (tuple(spec.dims) == (HID,) * 4 and tuple(spec.latent_in) == (3,)
            and spec.latent_size == LAT)


def supports_spec(spec, device=None) -> bool:
    """Whether the fused kernels take the decoder: the 128-wide one, one of
    the wide family (:func:`wide_layout`), or a conditioned family's
    (:func:`cond_layout`).  With a CUDA ``device``, a wide or conditioned
    decoder also needs its compiled instance (``WIDE_INSTANCES``,
    ``CBN_INSTANCES``, ``FILM_INSTANCES``); their plain versions run any
    member on the CPU."""
    on_card = device is not None and torch.device(device).type == "cuda"
    if is_conditioned(spec):
        lay = cond_layout(spec)
        return not on_card or tuple(lay) in _instances(lay)
    if _is_narrow(spec):
        return True
    lay = wide_layout(spec)
    if lay is None:
        return False
    return not on_card or tuple(lay) in WIDE_INSTANCES


# ---------------------------------------------------------------------------
# The wide instances (csrc/decoder_wide.cu)
# ---------------------------------------------------------------------------

# (code length L, hidden width H, hidden layers D, latent_in layer J) of every
# instance csrc/decoder_wide.cu compiles: DeepSDF's decoder
WIDE_INSTANCES = ((256, 512, 8, 4),)


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


class WideLayout(NamedTuple):
    """A wide decoder's padded widths and its pack's segments, as
    ``csrc/decoder_wide.cu``'s ``Wide`` lays them out: layer l takes K(l)
    inputs to N(l) outputs, the input x = [latent | xyz] padded to K0, layer
    J-1's output to NJ (a multiple of 64), layer J's input [h_{J-1} | x]."""
    L: int
    H: int
    D: int
    J: int

    @property
    def IN(self) -> int:
        return self.L + 3

    @property
    def K0(self) -> int:
        return _rup(self.IN, 8)

    @property
    def NJ(self) -> int:
        return _rup(self.H - self.IN, 64)

    def K(self, l: int) -> int:
        return self.K0 if l == 0 else (self.NJ + self.K0 if l == self.J else self.H)

    def N(self, l: int) -> int:
        return self.NJ if l == self.J - 1 else self.H

    def HK(self, l: int) -> int:
        """The hidden part of layer l's input (l >= 1): the backward's width."""
        return self.NJ if l == self.J else self.H

    @property
    def key(self) -> str:
        return "_" + "_".join(str(v) for v in self)

    @property
    def segments(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        """(name, shape): ``meta`` (L, H, D, J), W_l^T padded, biases, heads,
        the xyz columns of layers 0 and J, a pad to 16 bytes, and the
        kernels' fragments (the forward's W_l^T, l = 0 .. D-1, then the
        backward's W_l[:, hidden], l = D-1 .. 1)."""
        D, H = self.D, self.H
        segs = [("meta", (4,))]
        segs += [(f"f{l}", (self.K(l), self.N(l))) for l in range(D)]
        segs += [(f"b{l}", (self.N(l),)) for l in range(D)]
        segs += [("w_sdf", (H,)), ("w_std", (H,)), ("b_head", (4,)),
                 ("w0_xyz", (self.N(0), 3)), ("wJ_xyz", (H, 3))]
        head = sum(int(torch.Size(s).numel()) for _, s in segs)
        frag = (sum(self.K(l) * self.N(l) for l in range(D))
                + sum(self.N(l) * self.HK(l) for l in range(1, D)))
        return tuple(segs) + (("pad", (-head % 4,)), ("frag", (frag,)))

    @property
    def size(self) -> int:
        return sum(int(torch.Size(s).numel()) for _, s in self.segments)


def wide_layout(spec: DecoderSpec) -> Optional[WideLayout]:
    """The wide family: hidden layers of one width H, a multiple of 64 up to
    512, the input fed again at one layer 1 <= J < D, and L + 3 < H (so the
    layer before J has outputs).  None for any other spec."""
    dims, lin = tuple(spec.dims), tuple(spec.latent_in)
    if not dims or len(set(dims)) != 1 or len(lin) != 1:
        return None
    H, D, J, L = dims[0], len(dims), lin[0], spec.latent_size
    if H % 64 or H > 512 or not 1 <= J < D or L + 3 >= H:
        return None
    return WideLayout(L, H, D, J)


# a compiled instance's pack size -> its layout: how a wrapper tells a wide
# pack on the card, with no read of it
_WIDE_BY_SIZE = {WideLayout(*i).size: WideLayout(*i) for i in WIDE_INSTANCES}


def _wide_of(packed: torch.Tensor, L: int) -> Optional[WideLayout]:
    """A wide pack's layout for latents of width L; None for the 128-wide
    packs and for any other.  On the CPU it is read from the pack's
    ``meta``; on the card only a compiled instance's size names one."""
    n = packed.numel()
    if n in (PACKED_SIZE, PACKED_SIZE_BF16):
        return None
    if packed.is_cuda:
        lay = _WIDE_BY_SIZE.get(n)
    else:
        meta = packed[:4].tolist()
        if len(meta) < 4 or not all(math.isfinite(v) and v == int(v) for v in meta):
            return None
        _, H, D, J = (int(v) for v in meta)
        if int(meta[0]) != L or not 0 < D * H * H <= n:
            return None
        lay = wide_layout(DecoderSpec(L, (H,) * D, latent_in=(J,)))
    if lay is None or lay.size != n or lay.L != L:
        return None
    return lay


def _wide_frag(b: torch.Tensor) -> torch.Tensor:
    """A (K, N) right-hand matrix of ``act @ b`` -> the wide kernels' f32 B
    fragments, (K/8, N/8, 32, 2): lane 4g + t of (k-tile kt, n-tile nt)
    holds b[8kt + 2t, 8nt + g] and b[8kt + 2t + 1, 8nt + g], the rows of
    :func:`_tc_frag` unsplit (the kernels split them in registers)."""
    k, n = b.shape
    v = b.reshape(k // 8, 4, 2, n // 8, 8).permute(0, 3, 4, 1, 2)  # kt nt g t e
    return v.reshape(k // 8, n // 8, 32, 2)


def _pack_wide(decoder: Decoder, lay: WideLayout) -> torch.Tensor:
    L, H, D, J, IN, NJ = lay.L, lay.H, lay.D, lay.J, lay.IN, lay.NJ
    w = [lin.weight.detach().float() for lin in decoder.layers]   # (out, in)
    b = [lin.bias.detach().float() for lin in decoder.layers]
    dev = w[0].device
    parts = {}
    for l in range(D):
        f = torch.zeros(lay.K(l), lay.N(l), device=dev)
        out = w[l].shape[0]
        if l == J:   # rows: the hidden inputs, then x after the padded NJ
            f[:H - IN, :out] = w[l][:, :H - IN].T
            f[NJ:NJ + IN, :out] = w[l][:, H - IN:].T
        else:
            f[:w[l].shape[1], :out] = w[l].T
        bias = torch.zeros(lay.N(l), device=dev)
        bias[:out] = b[l]
        parts[f"f{l}"], parts[f"b{l}"] = f, bias
    u = decoder.uncertainty
    parts["w_sdf"] = w[D][0]
    parts["w_std"] = u.weight.detach().float()[0]
    parts["b_head"] = torch.cat([b[D], u.bias.detach().float(), torch.zeros(2, device=dev)])
    parts["w0_xyz"] = parts["f0"][L:L + 3].T
    parts["wJ_xyz"] = parts[f"f{J}"][NJ + L:NJ + L + 3].T
    parts["meta"] = torch.tensor([L, H, D, J], dtype=torch.float32, device=dev)
    parts["pad"] = torch.zeros(dict(lay.segments)["pad"], device=dev)
    parts["frag"] = torch.cat(
        [_wide_frag(parts[f"f{l}"]).reshape(-1) for l in range(D)]
        + [_wide_frag(parts[f"f{l}"][:lay.HK(l)].T.contiguous()).reshape(-1)
           for l in range(D - 1, 0, -1)])
    flat = torch.cat([parts[name].contiguous().reshape(-1) for name, _ in lay.segments])
    assert flat.numel() == lay.size
    return flat


def unpack_wide(packed: torch.Tensor, lay: WideLayout) -> Dict[str, torch.Tensor]:
    """Views of a wide pack's segments by name."""
    out, off = {}, 0
    for name, shape in lay.segments:
        size = int(torch.Size(shape).numel())
        out[name] = packed[off:off + size].view(shape)
        off += size
    return out


def _wide_forward(p: Dict[str, torch.Tensor], lay: WideLayout, latent: torch.Tensor,
                  rel: torch.Tensor):
    """The wide kernels' forward written out over the padded segments: (x,
    the preactivations z_l, the activations h_l, sdf, std)."""
    x = F.pad(torch.cat([latent, rel], dim=1), (0, lay.K0 - lay.IN))
    h, zs, hs = x, [], []
    for l in range(lay.D):
        inp = torch.cat([h, x], dim=1) if l == lay.J else h
        z = inp @ p[f"f{l}"] + p[f"b{l}"]
        h = torch.relu(z)
        zs.append(z)
        hs.append(h)
    sdf = torch.tanh(h @ p["w_sdf"] + p["b_head"][0])
    std = 0.05 + 0.5 * F.softplus(h @ p["w_std"] + p["b_head"][1])
    return x, zs, hs, sdf, std


def _wide_grad(p: Dict[str, torch.Tensor], lay: WideLayout, masks,
               sdf: torch.Tensor) -> torch.Tensor:
    """The sdf-only backward under the relu masks [h_l > 0]: dz_{D-1} =
    (1 - sdf^2) w_sdf, each dz_{l-1} = dz_l W_l[:, hidden] masked; d sdf /
    d xyz = dz_J W_J[:, xyz] + dz_0 W_0[:, xyz]."""
    zero = torch.zeros((), dtype=sdf.dtype, device=sdf.device)
    dz = torch.where(masks[-1], (1.0 - sdf * sdf)[:, None] * p["w_sdf"], zero)
    g_j = None
    for l in range(lay.D - 1, 0, -1):
        if l == lay.J:
            g_j = dz @ p["wJ_xyz"]
        dz = torch.where(masks[l - 1], dz @ p[f"f{l}"][:lay.HK(l)].T, zero)
    return g_j + dz @ p["w0_xyz"]


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


def pack_fused_decoder(decoder, dtype: torch.dtype = torch.float32):
    """Folded decoder -> the kernels' flat f32 weight buffer, on the
    decoder's device: (PACKED_SIZE,) for ``dtype`` float32 (3xTF32 products
    at f32 accuracy), (PACKED_SIZE_BF16,) for bfloat16 (the weights rounded
    to bf16 after the fold, biases f32).  A wide decoder: its
    (:attr:`WideLayout.size`,) f32 pack, f32 only.  A conditioned family's
    decoder: its :class:`CondPack`, f32 only."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused decoder kernels compute in float32 or bfloat16, not {dtype}")
    if is_conditioned(decoder.spec):
        if dtype != torch.float32:
            raise ValueError(f"the {decoder.spec.NAME} kernels compute in float32 (3xTF32) "
                             "only: its bf16 mode is not written")
        return _pack_film(decoder) if isinstance(decoder.spec, FilmSpec) else _pack_cbn(decoder)
    if not _is_narrow(decoder.spec):
        lay = wide_layout(decoder.spec)
        if lay is None:
            raise ValueError(f"fused decoder kernel does not support {decoder.spec}")
        if dtype != torch.float32:
            raise ValueError("the wide kernels compute in float32 (3xTF32) only")
        return _pack_wide(decoder, lay)
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
    """Plain PyTorch version of kernel 3 (either mode, by the pack; a wide
    pack by its layout): the written-out forward."""
    lay = _wide_of(packed, latent.shape[1])
    if lay is not None:
        *_, sdf, std = _wide_forward(unpack_wide(packed, lay), lay, latent, rel)
        return sdf, std
    *_, sdf, std = _forward(unpack(packed), latent, rel, is_bf16(packed))
    return sdf, std


def decode_grad_plain(packed: torch.Tensor, latent: torch.Tensor,
                      rel: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1 (either mode, by the pack): the
    written-out forward and the explicit sdf-only backward recurrence (a
    wide pack by its layout)."""
    lay = _wide_of(packed, latent.shape[1])
    if lay is not None:
        p = unpack_wide(packed, lay)
        _, _, hs, sdf, std = _wide_forward(p, lay, latent, rel)
        return sdf, std, _wide_grad(p, lay, [h > 0 for h in hs], sdf)
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
    mask flipped.  A wide pack's padding units (preactivation exactly 0,
    no weight out) are never the nearest."""
    lay = _wide_of(packed, latent.shape[1])
    pads = None
    if lay is not None:
        p = unpack_wide(packed, lay)
        _, zs, hs, sdf, _ = _wide_forward(p, lay, latent, rel)
        pads = [torch.arange(lay.N(l), device=latent.device) >= (lay.H - lay.IN if l == lay.J - 1
                                                                 else lay.H)
                for l in range(lay.D)]

        def grad(masks):
            return _wide_grad(p, lay, masks, sdf)
    else:
        p, bf16 = unpack(packed), is_bf16(packed)
        _, zs, hs, sdf, _ = _forward(p, latent, rel, bf16)

        def grad(masks):
            return _grad(p, masks, sdf, bf16)
    return _rows_off(got, zs, [h > 0 for h in hs], grad, atol, rtol, kink, pads)


def _rows_off(got, zs, masks, grad, atol, rtol, kink, pads=None) -> torch.Tensor:
    """The rows of ``got`` off ``grad(masks)`` unless, their nearest
    preactivation (of ``zs``, none of the ``pads``) within ``kink`` of 0,
    they match the gradient with that unit's mask flipped."""
    ref = grad(masks)
    off = ((got - ref).abs() > atol + rtol * ref.abs()).any(dim=1)
    if bool(off.any()):
        z = torch.cat(zs, dim=1)
        far = z.abs() if pads is None else torch.where(torch.cat(pads), float("inf"), z.abs())
        dist, nearest = far.min(dim=1)
        flip = torch.zeros_like(z, dtype=torch.bool)
        flip[torch.arange(z.shape[0], device=z.device), nearest] = True
        flips = flip.split([zl.shape[1] for zl in zs], dim=1)
        alt = grad([m ^ f for m, f in zip(masks, flips)])
        other_side = ((got - alt).abs() <= atol + rtol * alt.abs()).all(dim=1)
        off &= ~(other_side & (dist < kink))
    return off


def instance_name(packed, latent_width: int, device) -> str:
    """The counter kernel 3 counts its launches under on ``device`` for this
    pack (``decode_fused``, ``decode_fwd_bf16``, ``decode_fwd_wide``,
    ``decode_fwd_cbn``, ``decode_fwd_film``), or ``plain`` where nothing
    launches (the CPU, or no pack: ``Decoder.decode``)."""
    if packed is None or torch.device(device).type != "cuda":
        return "plain"
    if isinstance(packed, CondPack):
        return "decode_fwd_film" if _is_film(packed) else "decode_fwd_cbn"
    if _wide_of(packed, latent_width) is not None:
        return "decode_fwd_wide"
    return "decode_fwd_bf16" if is_bf16(packed) else "decode_fused"


def _check_inputs(what, packed, latent, rel) -> Optional["WideLayout"]:
    """Raise on inputs the kernels do not take; return a wide pack's layout
    (None for the 128-wide packs)."""
    n = latent.shape[0]
    lay = _wide_of(packed, latent.shape[1]) if latent.dim() == 2 else None
    if lay is not None:
        lat_w, size = lay.L, lay.size
    else:
        lat_w, size = LAT, PACKED_SIZE_BF16 if is_bf16(packed) else PACKED_SIZE
    for name, t, shape in (("latent", latent, (n, lat_w)), ("rel", rel, (n, 3)),
                           ("packed", packed, (size,))):
        if t.device != latent.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"float32 {shape} tensor on {latent.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{what}: packed must start on a 16-byte boundary (TMA copies it)")
    if lay is not None and tuple(lay) not in WIDE_INSTANCES:
        raise ValueError(f"{what}: no compiled wide instance for {lay}; add it to "
                         "csrc/decoder_wide.cu and WIDE_INSTANCES")
    return lay


_libs: Dict[str, ctypes.CDLL] = {}
# library -> its entry points, each with its number of outputs
_ENTRIES = {"decoder_grad": (("decode_grad_launch", 3), ("decode_fwd_launch", 2)),
            "decoder_bf16": (("decode_grad_bf16_launch", 3), ("decode_fwd_bf16_launch", 2)),
            "decoder_wide": tuple(e for inst in WIDE_INSTANCES for e in (
                (f"decode_grad_wide_launch{WideLayout(*inst).key}", 3),
                (f"decode_fwd_wide_launch{WideLayout(*inst).key}", 2)))}


def _load(name: str):
    """csrc/<name>.cu's library, its layout checked and its entry points
    typed once per process."""
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        if name in ("decoder_cbn", "decoder_film"):
            _type_cond(lib, name)
            _libs[name] = lib
            return lib
        if name == "decoder_wide":
            pairs = [(getattr(lib, f"decode_wide_packed_size{WideLayout(*i).key}")(),
                      WideLayout(*i).size) for i in WIDE_INSTANCES]
        else:
            pairs = [(lib.decode_grad_packed_size(), PACKED_SIZE) if name == "decoder_grad"
                     else (lib.decode_bf16_packed_size(), PACKED_SIZE_BF16)]
        if any(got != want for got, want in pairs):
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
    """(N, L) latents, (N, 3) voxel-local xyz -> sdf (N,), std (N,),
    d sdf / d xyz (N, 3).  CUDA tensors launch kernel 1 in the pack's mode
    or wide instance (or raise); CPU tensors run :func:`decode_grad_plain`."""
    if not latent.is_cuda:
        return decode_grad_plain(packed, latent, rel)
    lay = _check_inputs("decode_grad_fused", packed, latent, rel)
    n = latent.shape[0]
    outs = (torch.empty(n, device=latent.device),
            torch.empty(n, device=latent.device),
            torch.empty(n, 3, device=latent.device))
    if n:
        if lay is not None:
            _launch("decode_grad_wide", "decoder_wide", f"decode_grad_wide_launch{lay.key}",
                    packed, latent, rel, outs)
        elif is_bf16(packed):
            _launch("decode_grad_bf16", "decoder_bf16", "decode_grad_bf16_launch", packed,
                    latent, rel, outs)
        else:
            _launch("decode_grad_fused", "decoder_grad", "decode_grad_launch", packed,
                    latent, rel, outs)
    return outs


def decode_fused(packed: torch.Tensor, latent: torch.Tensor,
                 rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, L) latents, (N, 3) voxel-local xyz -> sdf (N,), std (N,).  CUDA
    tensors launch kernel 3 in the pack's mode or wide instance (or raise);
    CPU tensors run :func:`decode_fused_plain`.  N = 0 launches nothing."""
    if not latent.is_cuda:
        return decode_fused_plain(packed, latent, rel)
    lay = _check_inputs("decode_fused", packed, latent, rel)
    n = latent.shape[0]
    outs = (torch.empty(n, device=latent.device),
            torch.empty(n, device=latent.device))
    if n:
        if lay is not None:
            _launch("decode_fwd_wide", "decoder_wide", f"decode_fwd_wide_launch{lay.key}",
                    packed, latent, rel, outs)
        elif is_bf16(packed):
            _launch("decode_fwd_bf16", "decoder_bf16", "decode_fwd_bf16_launch", packed,
                    latent, rel, outs)
        else:
            _launch("decode_fused", "decoder_grad", "decode_fwd_launch", packed, latent, rel,
                    outs)
    return outs


# ---------------------------------------------------------------------------
# Families conditioned once a code (csrc/decoder_cbn.cu, csrc/decoder_film.cu)
# ---------------------------------------------------------------------------
#
# onet_cbn and pigan_film condition on each code once: a conditioning kernel
# turns codes into table rows (onet_cbn's folded CBN (gamma', beta'),
# pigan_film's FiLM (gamma, beta) from its mapping network), and kernels 1
# and 3 take sites with a row index into such a table.  Both families' packs
# are a :class:`CondPack`, a flat buffer and its family's layout, and the
# tracker and the mesher reach them through :func:`condition`,
# :func:`decode_grad_cond` and :func:`decode_fwd_cond` alone.

# (code L, hidden H, residual blocks NB) of every instance
# csrc/decoder_cbn.cu compiles: Occupancy Networks' published widths
CBN_INSTANCES = ((256, 256, 5),)
# (code L, hidden H, FiLM layers NL, mapping hidden MH) of every instance
# csrc/decoder_film.cu compiles: pi-GAN's published widths
FILM_INSTANCES = ((256, 256, 8, 256),)


class CbnLayout(NamedTuple):
    """An onet_cbn pack's widths and segments, as ``csrc/decoder_cbn.cu``'s
    ``Cbn`` lays them out: the plain weights the plain versions read, then
    the kernels' f32 fragments: the trunk's forward W0_i^T, W1_i^T (i = 0 ..
    NB-1), its backward W1_i, W0_i (i = NB-1 .. 0), and each CBN's stacked
    (gamma | beta) map, its columns interleaved eight by eight
    (:func:`_cond_interleave`) so that a lane holds a column's gamma and
    beta side by side for the BN fold."""
    L: int
    H: int
    NB: int

    @property
    def NC(self) -> int:
        return 2 * self.NB + 1

    @property
    def row_shape(self) -> Tuple[int, int, int]:
        """One code's conditioning: (NC, 2, H)."""
        return (self.NC, 2, self.H)

    @property
    def key(self) -> str:
        return "_" + "_".join(str(v) for v in self)

    @property
    def segments(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        L, H, NB, NC = self.L, self.H, self.NB, self.NC
        segs = [("meta", (4,)), ("wp", (H, 4)), ("w0", (NB, H, H)), ("b0", (NB, H)),
                ("w1", (NB, H, H)), ("b1", (NB, H)), ("w_sdf", (H,)), ("w_std", (H,)),
                ("b_head", (4,)), ("cw", (NC, 2, H, L)), ("cb", (NC, 2, H)),
                ("bn_s", (NC, H)), ("bn_t", (NC, H))]
        head = sum(int(torch.Size(s).numel()) for _, s in segs)
        return tuple(segs) + (("pad", (-head % 4,)), ("frag", (4 * NB * H * H,)),
                              ("cfrag", (NC * L * 2 * H,)))

    @property
    def size(self) -> int:
        return sum(int(torch.Size(s).numel()) for _, s in self.segments)


class FilmLayout(NamedTuple):
    """A pigan_film pack's widths and segments, as ``csrc/decoder_film.cu``'s
    ``Film`` lays them out: ``wp`` (H, 4) is 2 W_0 (the box warp folded)
    beside b_0; ``m3`` / ``mb3`` the mapping's last layer with the frequency
    affine folded in, by (layer, gamma | beta); ``frag`` the trunk's W_i^T
    (i = 1 .. NL-1, the forward's) then its W_i (i = NL-1 .. 1, kernel 1's
    reverse pass), and ``mfrag`` the mapping's W0^T, W1^T, W2^T and its last
    layer's 2 NL column blocks, as f32 fragments (:func:`_wide_frag`)."""
    L: int
    H: int
    NL: int
    MH: int

    @property
    def row_shape(self) -> Tuple[int, int, int]:
        """One code's modulation: (NL, 2, H)."""
        return (self.NL, 2, self.H)

    @property
    def key(self) -> str:
        return "_" + "_".join(str(v) for v in self)

    @property
    def segments(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        L, H, NL, MH = self
        segs = [("meta", (4,)), ("wp", (H, 4)), ("wf", (NL - 1, H, H)), ("bf", (NL - 1, H)),
                ("w_sdf", (H,)), ("w_std", (H,)), ("b_head", (4,)),
                ("m0", (MH, L)), ("mb0", (MH,)), ("m1", (MH, MH)), ("mb1", (MH,)),
                ("m2", (MH, MH)), ("mb2", (MH,)), ("m3", (NL, 2, H, MH)), ("mb3", (NL, 2, H))]
        head = sum(int(torch.Size(s).numel()) for _, s in segs)
        return tuple(segs) + (("pad", (-head % 4,)), ("frag", (2 * (NL - 1) * H * H,)),
                              ("mfrag", (L * MH + 2 * MH * MH + MH * NL * 2 * H,)))

    @property
    def size(self) -> int:
        return sum(int(torch.Size(s).numel()) for _, s in self.segments)


def cond_layout(spec):
    """The layout of a conditioned family's spec: :class:`CbnLayout` or
    :class:`FilmLayout`."""
    if isinstance(spec, FilmSpec):
        return FilmLayout(spec.latent_size, spec.hidden, spec.layers, spec.map_hidden)
    return CbnLayout(spec.latent_size, spec.hidden, spec.blocks)


def _instances(lay) -> Tuple[tuple, ...]:
    return FILM_INSTANCES if isinstance(lay, FilmLayout) else CBN_INSTANCES


class CondPack(NamedTuple):
    """A conditioned family's packed weights: the flat f32 buffer
    (``layout.size``) on the decoder's device, and its layout
    (:class:`CbnLayout` or :class:`FilmLayout`)."""
    flat: torch.Tensor
    layout: object

    def to(self, device) -> "CondPack":
        return CondPack(self.flat.to(device), self.layout)


def unpack_cond(pack: CondPack) -> Dict[str, torch.Tensor]:
    """Views of a conditioned pack's segments by name."""
    out, off = {}, 0
    for name, shape in pack.layout.segments:
        size = int(torch.Size(shape).numel())
        out[name] = pack.flat[off:off + size].view(shape)
        off += size
    return out


def _cond_interleave(m: torch.Tensor) -> torch.Tensor:
    """One CBN's (2, H, L) maps (gamma's, beta's; rows by output) -> the
    (L, 2H) right-hand matrix of ``codes @ b`` whose n-tile 2q holds gamma's
    columns 8q .. 8q + 7 and n-tile 2q + 1 beta's."""
    _, H, L = m.shape
    return m.reshape(2, H // 8, 8, L).permute(3, 1, 0, 2).reshape(L, 2 * H)


def _pack_cbn(decoder) -> CondPack:
    lay = CbnLayout(*cond_layout(decoder.spec))
    dev = decoder.fc_p.weight.device

    def w(lin):
        return lin.weight.detach().float()

    def b(lin):
        return lin.bias.detach().float()
    parts = {
        "meta": torch.tensor([lay.L, lay.H, lay.NB, lay.NC], dtype=torch.float32, device=dev),
        "wp": torch.cat([w(decoder.fc_p), b(decoder.fc_p)[:, None]], dim=1),
        "w0": torch.stack([w(x) for x in decoder.fc_0]),
        "b0": torch.stack([b(x) for x in decoder.fc_0]),
        "w1": torch.stack([w(x) for x in decoder.fc_1]),
        "b1": torch.stack([b(x) for x in decoder.fc_1]),
        "w_sdf": w(decoder.fc_out)[0], "w_std": w(decoder.uncertainty)[0],
        "b_head": torch.cat([b(decoder.fc_out), b(decoder.uncertainty),
                             torch.zeros(2, device=dev)]),
        "cw": decoder.cond_w.detach().float(), "cb": decoder.cond_b.detach().float(),
        "bn_s": decoder.bn_s.detach().float(), "bn_t": decoder.bn_t.detach().float(),
    }
    parts["pad"] = torch.zeros(dict(lay.segments)["pad"], device=dev)
    parts["frag"] = torch.cat(
        [_wide_frag(m.T.contiguous()).reshape(-1) for i in range(lay.NB)
         for m in (parts["w0"][i], parts["w1"][i])]
        + [_wide_frag(m.contiguous()).reshape(-1) for i in range(lay.NB - 1, -1, -1)
           for m in (parts["w1"][i], parts["w0"][i])])
    parts["cfrag"] = torch.cat([_wide_frag(_cond_interleave(parts["cw"][j])).reshape(-1)
                                for j in range(lay.NC)])
    flat = torch.cat([parts[name].contiguous().reshape(-1) for name, _ in lay.segments])
    assert flat.numel() == lay.size
    return CondPack(flat, lay)


def cbn_condition_plain(pack: CondPack, codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the conditioning kernel: (M, L) codes ->
    (M, NC, 2, H), gamma' = (W_g c + b_g) s, beta' = (W_g c + b_g) t +
    (W_b c + b_b)."""
    p, lay = unpack_cond(pack), pack.layout
    raw = (codes @ p["cw"].reshape(-1, lay.L).T).view(-1, lay.NC, 2, lay.H) + p["cb"]
    g, b = raw[:, :, 0], raw[:, :, 1]
    return torch.stack([g * p["bn_s"], g * p["bn_t"] + b], dim=2)


def _cbn_forward(p: Dict[str, torch.Tensor], lay: CbnLayout, cond: torch.Tensor,
                 idx: torch.Tensor, rel: torch.Tensor):
    """The trunk and heads written out: (the preactivations v_j = G_j x +
    B_j of the NC relus, each row's (G_j, B_j) getter, sdf, std)."""
    rows = idx.long()

    def gb(j):
        r = cond[rows, j]                              # (N, 2, H)
        return r[:, 0], r[:, 1]
    net = rel @ p["wp"][:, :3].T + p["wp"][:, 3]
    vs = []
    for i in range(lay.NB):
        G, B = gb(2 * i)
        vs.append(G * net + B)
        a = torch.relu(vs[-1]) @ p["w0"][i].T + p["b0"][i]
        G, B = gb(2 * i + 1)
        vs.append(G * a + B)
        net = net + (torch.relu(vs[-1]) @ p["w1"][i].T + p["b1"][i])
    G, B = gb(2 * lay.NB)
    vs.append(G * net + B)
    h = torch.relu(vs[-1])
    sdf = torch.tanh(h @ p["w_sdf"] + p["b_head"][0])
    std = 0.05 + 0.5 * F.softplus(h @ p["w_std"] + p["b_head"][1])
    return vs, gb, sdf, std


def _cbn_grad(p: Dict[str, torch.Tensor], lay: CbnLayout, gb, masks,
              sdf: torch.Tensor) -> torch.Tensor:
    """The sdf-only backward under the relu masks [v_j > 0]: dn = (1 -
    sdf^2) w_sdf [v_NC-1 > 0] G_NC-1; for each block from the last, d =
    (dn W1_i) [v_2i+1 > 0] G_2i+1, dn += (d W0_i) [v_2i > 0] G_2i; d sdf /
    d xyz = dn . fc_p's xyz columns."""
    zero = torch.zeros((), dtype=sdf.dtype, device=sdf.device)

    def through(j, d):
        return torch.where(masks[j], d * gb(j)[0], zero)
    dn = through(lay.NC - 1, (1.0 - sdf * sdf)[:, None] * p["w_sdf"])
    for i in range(lay.NB - 1, -1, -1):
        d = through(2 * i + 1, dn @ p["w1"][i])
        dn = dn + through(2 * i, d @ p["w0"][i])
    return dn @ p["wp"][:, :3]


def decode_fwd_cbn_plain(pack: CondPack, cond: torch.Tensor, idx: torch.Tensor,
                         rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 3's onet_cbn instance."""
    *_, sdf, std = _cbn_forward(unpack_cond(pack), pack.layout, cond, idx, rel)
    return sdf, std


def decode_grad_cbn_plain(pack: CondPack, cond: torch.Tensor, idx: torch.Tensor,
                          rel: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1's onet_cbn instance."""
    p, lay = unpack_cond(pack), pack.layout
    vs, gb, sdf, std = _cbn_forward(p, lay, cond, idx, rel)
    return sdf, std, _cbn_grad(p, lay, gb, [v > 0 for v in vs], sdf)


def cbn_grad_rows_off(got: torch.Tensor, pack: CondPack, cond: torch.Tensor,
                      idx: torch.Tensor, rel: torch.Tensor, atol: float = 1e-4,
                      rtol: float = 1e-4, kink: float = 1e-5) -> torch.Tensor:
    """:func:`grad_rows_off` for kernel 1's onet_cbn instance: the rows where
    ``got`` is off the plain gradient, but for a row whose nearest relu
    preactivation lies within ``kink`` of 0 and that matches the other
    one-sided derivative (that unit's mask flipped)."""
    p, lay = unpack_cond(pack), pack.layout
    vs, gb, sdf, _ = _cbn_forward(p, lay, cond, idx, rel)
    return _rows_off(got, vs, [v > 0 for v in vs],
                     lambda masks: _cbn_grad(p, lay, gb, masks, sdf), atol, rtol, kink)


def _pack_film(decoder) -> CondPack:
    lay = cond_layout(decoder.spec)
    dev = decoder.fc_out.weight.device

    def w(lin):
        return lin.weight.detach().float()

    def b(lin):
        return lin.bias.detach().float()
    film, mp = decoder.film, decoder.mapping
    parts = {
        "meta": torch.tensor(list(lay), dtype=torch.float32, device=dev),
        # the box warp's 2 is exact in f32: folded into W_0
        "wp": torch.cat([2.0 * w(film[0]), b(film[0])[:, None]], dim=1),
        "wf": torch.stack([w(x) for x in film[1:]]),
        "bf": torch.stack([b(x) for x in film[1:]]),
        "w_sdf": w(decoder.fc_out)[0], "w_std": w(decoder.uncertainty)[0],
        "b_head": torch.cat([b(decoder.fc_out), b(decoder.uncertainty),
                             torch.zeros(2, device=dev)]),
        "m0": w(mp[0]), "mb0": b(mp[0]), "m1": w(mp[1]), "mb1": b(mp[1]),
        "m2": w(mp[2]), "mb2": b(mp[2]),
        "m3": decoder.map_w.detach().float(), "mb3": decoder.map_b.detach().float(),
    }
    parts["pad"] = torch.zeros(dict(lay.segments)["pad"], device=dev)
    parts["frag"] = torch.cat(
        [_wide_frag(m.T.contiguous()).reshape(-1) for m in parts["wf"]]
        + [_wide_frag(m.contiguous()).reshape(-1) for m in parts["wf"].flip(0)])
    parts["mfrag"] = torch.cat(
        [_wide_frag(parts[k].T.contiguous()).reshape(-1) for k in ("m0", "m1", "m2")]
        + [_wide_frag(parts["m3"][i, c].T.contiguous()).reshape(-1)
           for i in range(lay.NL) for c in range(2)])
    flat = torch.cat([parts[name].contiguous().reshape(-1) for name, _ in lay.segments])
    assert flat.numel() == lay.size
    return CondPack(flat, lay)


def film_map_plain(pack: CondPack, codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the mapping kernel: (M, L) codes -> (M, NL,
    2, H), each layer's gamma (the frequency affine folded) and beta."""
    p, lay = unpack_cond(pack), pack.layout
    a = codes
    for k in range(3):
        a = F.leaky_relu(a @ p[f"m{k}"].T + p[f"mb{k}"], FILM_LRELU)
    return (a @ p["m3"].reshape(-1, lay.MH).T).view(-1, *lay.row_shape) + p["mb3"]


def _film_layers(p: Dict[str, torch.Tensor], lay: FilmLayout, mod: torch.Tensor,
                 idx: torch.Tensor, rel: torch.Tensor, stage: bool):
    """The trunk written out as the kernels compute it: (h_NL, and with
    ``stage`` each layer's gamma cos(a), which kernel 1 stages for its
    reverse pass)."""
    rows = idx.long()
    z = rel @ p["wp"][:, :3].T + p["wp"][:, 3]
    staged = []
    for i in range(lay.NL):
        if i:
            z = h @ p["wf"][i - 1].T + p["bf"][i - 1]
        gamma = mod[rows, i, 0]
        a = gamma * z + mod[rows, i, 1]
        h = torch.sin(a)
        if stage:
            staged.append(gamma * torch.cos(a))
    return h, staged


def _film_heads(p, h):
    sdf = torch.tanh(h @ p["w_sdf"] + p["b_head"][0])
    std = 0.05 + 0.5 * F.softplus(h @ p["w_std"] + p["b_head"][1])
    return sdf, std


def decode_fwd_film_plain(pack: CondPack, mod: torch.Tensor, idx: torch.Tensor,
                          rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 3's pigan_film instance."""
    p = unpack_cond(pack)
    h, _ = _film_layers(p, pack.layout, mod, idx, rel, False)
    return _film_heads(p, h)


def decode_grad_film_plain(pack: CondPack, mod: torch.Tensor, idx: torch.Tensor,
                           rel: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1's pigan_film instance: the forward
    with each layer's gamma cos(a) kept, then the reverse pass dh_NL = (1 -
    sdf^2) w_sdf, dh_i = (dh_{i+1} gamma_i cos(a_i)) W_i, d sdf / d xyz =
    (dh_1 gamma_0 cos(a_0)) W0'."""
    p = unpack_cond(pack)
    h, staged = _film_layers(p, pack.layout, mod, idx, rel, True)
    sdf, std = _film_heads(p, h)
    dh = (1.0 - sdf * sdf)[:, None] * p["w_sdf"]
    for i in range(pack.layout.NL - 1, 0, -1):
        dh = (dh * staged[i]) @ p["wf"][i - 1]
    return sdf, std, (dh * staged[0]) @ p["wp"][:, :3]


def _type_cond(lib, name: str) -> None:
    """Check each compiled instance's pack size and type its entry points."""
    fam, entries, size_fn, lay_of = (
        ("film", (("film_map_launch", 5), ("decode_grad_film_launch", 8),
                  ("decode_fwd_film_launch", 6)), "film_packed_size", FilmLayout)
        if name == "decoder_film" else
        ("cbn", (("cbn_cond_launch", 5), ("decode_grad_cbn_launch", 7),
                 ("decode_fwd_cbn_launch", 6)), "cbn_packed_size", CbnLayout))
    for inst in (FILM_INSTANCES if fam == "film" else CBN_INSTANCES):
        lay = lay_of(*inst)
        if getattr(lib, f"{size_fn}{lay.key}")() != lay.size:
            raise RuntimeError(f"{name}.cu packed layout disagrees with ops/decoder_fused.py")
        for entry, n_ptr in entries:
            fn = getattr(lib, f"{entry}{lay.key}")
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int


def _cond_entry(pack: CondPack, entry: str, what: str):
    lay = pack.layout
    lib = "decoder_film" if isinstance(lay, FilmLayout) else "decoder_cbn"
    if tuple(lay) not in _instances(lay):
        raise ValueError(f"{what}: no compiled instance for {lay}; add it to "
                         f"csrc/{lib}.cu and its instances")
    return getattr(_load(lib), f"{entry}{lay.key}")


def _check_cuda(what: str, dev, named) -> None:
    """Raise unless each (name, tensor, dtype, shape) is contiguous, of
    that dtype and shape, on ``dev``."""
    for name, t, dtype, shape in named:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} {tuple(shape)} "
                             f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _condition(counter: str, entry: str, plain, pack: CondPack, codes: torch.Tensor,
               rows: Optional[torch.Tensor], count: Optional[torch.Tensor],
               out: Optional[torch.Tensor]) -> torch.Tensor:
    lay = pack.layout
    M = codes.shape[0]
    if out is None:
        out = torch.empty(M, *lay.row_shape, device=codes.device)
    if not codes.is_cuda:
        sel = torch.arange(M, device=codes.device) if rows is None else rows.long()
        if count is not None:
            sel = sel[:int(count)]
        out[sel] = plain(pack, codes[sel])
        return out
    n = M if rows is None else rows.shape[0]
    _check_cuda(counter, codes.device, [("codes", codes, torch.float32, (M, lay.L)),
                                        ("packed", pack.flat, torch.float32, (lay.size,)),
                                        ("out", out, torch.float32,
                                         (out.shape[0],) + lay.row_shape)]
                + ([("rows", rows, torch.int32, (n,))] if rows is not None else [])
                + ([("count", count, torch.int32, ())] if count is not None else []))
    if n:
        fn = _cond_entry(pack, entry, counter)
        err = _build.launch_on(codes.device.index, fn, codes.data_ptr(),
                               None if rows is None else rows.data_ptr(),
                               None if count is None else count.data_ptr(),
                               pack.flat.data_ptr(), out.data_ptr(), n)
        _build.check(err, counter)
        _build.count_launch(counter)
    return out


def cbn_condition(pack: CondPack, codes: torch.Tensor, rows: Optional[torch.Tensor] = None,
                  count: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conditioning of codes (M, L) into ``out`` (M', NC, 2, H) (a new
    (M, NC, 2, H) tensor by default): row r = ``rows[i]`` of both for i <
    ``count`` (a 0-d int32 device tensor; the whole list without it), or
    every row without ``rows``.  CUDA tensors launch ``cbn_cond_kernel``
    (no host read of ``count``); CPU tensors run
    :func:`cbn_condition_plain`."""
    return _condition("cbn_cond", "cbn_cond_launch", cbn_condition_plain, pack, codes, rows,
                      count, out)


def film_map(pack: CondPack, codes: torch.Tensor, rows: Optional[torch.Tensor] = None,
             count: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`cbn_condition` for pigan_film: the mapping network of codes (M,
    L) into rows of (NL, 2, H).  CUDA tensors launch ``film_map_kernel``
    (counted as ``film_map``); CPU tensors run :func:`film_map_plain`."""
    return _condition("film_map", "film_map_launch", film_map_plain, pack, codes, rows, count,
                      out)


def _cond_decode(entry: str, name: str, n_out: int, pack: CondPack, cond: torch.Tensor,
                 idx: torch.Tensor, rel: torch.Tensor, scratch_floats: int = 0):
    lay = pack.layout
    n = idx.shape[0]
    _check_cuda(name, rel.device, [("cond", cond, torch.float32,
                                    (cond.shape[0],) + lay.row_shape),
                                   ("idx", idx, torch.int32, (n,)),
                                   ("rel", rel, torch.float32, (n, 3)),
                                   ("packed", pack.flat, torch.float32, (lay.size,))])
    if pack.flat.data_ptr() % 16:
        raise ValueError(f"{name}: packed must start on a 16-byte boundary (TMA copies it)")
    if cond.numel() >= 1 << 31:
        raise ValueError(f"{name}: the kernels address the conditioning with 32-bit offsets "
                         f"({cond.shape[0]} rows are too many)")
    outs = (torch.empty(n, device=rel.device), torch.empty(n, device=rel.device),
            torch.empty(n, 3, device=rel.device))[:n_out]
    if n:
        fn = _cond_entry(pack, entry, name)
        scratch = ((torch.empty(scratch_floats, device=rel.device).data_ptr(),)
                   if scratch_floats else ())
        err = _build.launch_on(rel.device.index, fn, cond.data_ptr(), idx.data_ptr(),
                               rel.data_ptr(), pack.flat.data_ptr(), *scratch,
                               *(o.data_ptr() for o in outs), n)
        _build.check(err, name)
        _build.count_launch(name)
    return outs


def decode_grad_cbn(pack: CondPack, cond: torch.Tensor, idx: torch.Tensor,
                    rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sites (N,) with a row ``idx`` (int32) of the conditioning ``cond``
    (M, NC, 2, H) and voxel-local xyz (N, 3) -> sdf (N,), std (N,), d sdf /
    d xyz (N, 3).  CUDA tensors launch ``decode_grad_kernel_cbn`` (counted as
    ``decode_grad_cbn``); CPU tensors run :func:`decode_grad_cbn_plain`."""
    if not rel.is_cuda:
        return decode_grad_cbn_plain(pack, cond, idx, rel)
    return _cond_decode("decode_grad_cbn_launch", "decode_grad_cbn", 3, pack, cond, idx, rel)


def decode_fwd_cbn(pack: CondPack, cond: torch.Tensor, idx: torch.Tensor,
                   rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_grad_cbn` without the gradient: ``decode_fwd_kernel_cbn``
    (counted as ``decode_fwd_cbn``) or :func:`decode_fwd_cbn_plain`."""
    if not rel.is_cuda:
        return decode_fwd_cbn_plain(pack, cond, idx, rel)
    return _cond_decode("decode_fwd_cbn_launch", "decode_fwd_cbn", 2, pack, cond, idx, rel)


def decode_grad_film(pack: CondPack, mod: torch.Tensor, idx: torch.Tensor,
                     rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decode_grad_cbn` for pigan_film, ``mod`` (M, NL, 2, H) the
    modulation rows: ``decode_grad_kernel_film`` (counted as
    ``decode_grad_film``; its scratch, each 64-point block's gamma cos(a) of
    every layer, ceil(N / 64) NL H 64 floats, allocated here) or
    :func:`decode_grad_film_plain`."""
    if not rel.is_cuda:
        return decode_grad_film_plain(pack, mod, idx, rel)
    lay = pack.layout
    return _cond_decode("decode_grad_film_launch", "decode_grad_film", 3, pack, mod, idx, rel,
                        scratch_floats=-(-idx.shape[0] // 64) * lay.NL * lay.H * 64)


def decode_fwd_film(pack: CondPack, mod: torch.Tensor, idx: torch.Tensor,
                    rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_grad_film` without the gradient: ``decode_fwd_kernel_film``
    (counted as ``decode_fwd_film``) or :func:`decode_fwd_film_plain`."""
    if not rel.is_cuda:
        return decode_fwd_film_plain(pack, mod, idx, rel)
    return _cond_decode("decode_fwd_film_launch", "decode_fwd_film", 2, pack, mod, idx, rel)


def _is_film(pack: CondPack) -> bool:
    return isinstance(pack.layout, FilmLayout)


def condition(pack: CondPack, codes: torch.Tensor, rows: Optional[torch.Tensor] = None,
              count: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A conditioned family's table rows of codes: :func:`cbn_condition` or
    :func:`film_map` (the same arguments)."""
    return (film_map if _is_film(pack) else cbn_condition)(pack, codes, rows, count, out)


def decode_grad_cond(pack: CondPack, cond: torch.Tensor, idx: torch.Tensor,
                     rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 1 of a conditioned family: :func:`decode_grad_cbn` or
    :func:`decode_grad_film`."""
    return (decode_grad_film if _is_film(pack) else decode_grad_cbn)(pack, cond, idx, rel)


def decode_fwd_cond(pack: CondPack, cond: torch.Tensor, idx: torch.Tensor,
                    rel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3 of a conditioned family: :func:`decode_fwd_cbn` or
    :func:`decode_fwd_film`."""
    return (decode_fwd_film if _is_film(pack) else decode_fwd_cbn)(pack, cond, idx, rel)
