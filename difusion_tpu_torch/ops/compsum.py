"""Order-robust (compensated) reductions for the Gauss-Newton normal
equations (counterpart of difusion_tpu/ops/compsum.py:38-139).

A plain f32 sum depends on the order in which the device adds; over a long
sequence that order noise compounds into the trajectory.  The pairwise
TwoSum cascade of :func:`pairwise_compensated_sum` carries every addition's
rounding error exactly beside the sum, so its result is ~1 ulp of the exact
sum of its inputs in any order.  :func:`gram_blocked` takes per-block
partial Grams from one batched product and cascades only across blocks.

TwoSum must survive compilation: each of its steps is a separate tensor op
(no ``torch.compile``, no fused kernel), so no FMA contraction or
reassociation can cancel the error term.  On the card the batched product
of :func:`gram_blocked` is cuBLAS's (TF32 off, ``device.resolve_device``),
whose order inside a block is not the TPU's: "blocked" agrees with the JAX
package to f32 tolerance, not bit for bit.
"""
from __future__ import annotations

import torch


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth TwoSum: s = fl(a+b) and e exact with a + b = s + e."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def pairwise_compensated_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Compensated sum of ``x`` along ``dim``: contiguous halves combine by
    TwoSum, their errors in a parallel accumulator; the input is zero-padded
    to a power of two once (TwoSum with 0 is exact)."""
    if dim != 0:
        x = torch.movedim(x, dim, 0)
    n = x.shape[0]
    pow2 = 1 << max(n - 1, 1).bit_length()
    if pow2 != n:
        x = torch.cat([x, x.new_zeros((pow2 - n, *x.shape[1:]))])
    err = torch.zeros_like(x)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s, e = _two_sum(x[:h], x[h:])
        # the error accumulator's own rounding is second order
        err = err[:h] + err[h:] + e
        x = s
    return (x + err)[0]


def gram_compensated(rows: torch.Tensor, w: torch.Tensor, scale) -> torch.Tensor:
    """``M[a, b] = scale * sum_n w[n] rows[n, a] rows[n, b]`` (R x R,
    symmetric) from the explicit upper-triangle product stack (each product
    rounded alone), reduced by the TwoSum cascade."""
    R = rows.shape[1]
    iu, ju = torch.triu_indices(R, R, device=rows.device)
    prod = (rows * w[:, None])[:, iu] * rows[:, ju]          # (N, P)
    tri = pairwise_compensated_sum(prod) * scale
    M = rows.new_zeros(R, R)
    M[iu, ju] = tri
    M[ju, iu] = tri
    return M


def gram_blocked(rows: torch.Tensor, w: torch.Tensor, scale,
                 block: int = 512) -> torch.Tensor:
    """Weighted Gram from per-block partials (one batched product over
    blocks of ``block`` rows) combined by the compensated cascade."""
    N, R = rows.shape
    nb = -(-N // block)
    pad = nb * block - N
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad, R)])
        w = torch.cat([w, w.new_zeros(pad)])
    rw = (rows * w[:, None]).reshape(nb, block, R)
    rr = rows.reshape(nb, block, R)
    partials = torch.bmm(rw.transpose(1, 2), rr)              # (nb, R, R)
    M = pairwise_compensated_sum(partials.reshape(nb, R * R))
    return (M * scale).reshape(R, R)


def gram(rows: torch.Tensor, w: torch.Tensor, scale, mode: str) -> torch.Tensor:
    """Dispatch on the tracker's ``solve_dtype``."""
    if mode == "compensated":
        return gram_compensated(rows, w, scale)
    if mode != "blocked":
        raise ValueError(f"gram mode {mode!r}")
    return gram_blocked(rows, w, scale)
