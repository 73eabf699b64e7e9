"""A camera frame's preprocessing, plainly: what the tracker and the fusion
read of a frame.

From uint8 RGB and uint16 depth: the grey intensity the sensor's three
channels average to (rounded, as a byte) and the metric depth cut to the
configured range; the level-0 image the photometric term warps; and the SDF
term's point cloud: every second pixel unprojected, kept where at least 16
neighbours of its 13x13 window lie within 5 cm and 6 within 10 cm, with the
normal of the 10 cm neighbourhood facing the camera, then averaged in 2 cm
boxes and cut to the point budget by a scrambled order of the boxes
(Knuth's multiplicative hash of the box's index in the frustum's grid).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

KNUTH = 2654435761
MASK32 = 0xFFFFFFFF
WINDOW = 6
OUTLIER_R, OUTLIER_NB = 0.05, 16
NORMAL_R, NORMAL_NB = 0.1, 6
BOX = 0.02


def f32_recip(c: float) -> float:
    """The float32 reciprocal of a constant (dividing by a constant as a
    multiply by it, the form the tracker's thresholds are defined in)."""
    return float(np.float32(1.0) / np.float32(c))


class Frame(NamedTuple):
    intensity: torch.Tensor    # (H, W) f32 in [0, 1]
    depth: torch.Tensor        # (H, W) f32 metres, 0 outside the cut
    depth_ok: torch.Tensor     # (H, W) bool
    pts: torch.Tensor          # (B, 3) camera-space box means
    nrm: torch.Tensor          # (B, 3)
    mask: torch.Tensor         # (B,) bool


def sensor(rgb: np.ndarray, depth_u16: np.ndarray, scale: float, device):
    """Grey intensity and metric depth of a sensor frame."""
    rgb = torch.as_tensor(np.ascontiguousarray(rgb), device=device).to(torch.int32)
    grey = ((rgb.sum(dim=-1) + 1) // 3).to(torch.float32) * (1.0 / 255.0)
    d = torch.as_tensor(np.ascontiguousarray(depth_u16).view(np.int16),
                        device=device).to(torch.int32) & 0xFFFF
    return grey, d.to(torch.float32) * (1.0 / scale)


def _window_sums(pc: torch.Tensor, ok: torch.Tensor):
    """Per pixel over its zero-padded 13x13 window: the count within 5 cm,
    and within 10 cm the count, the sums of x, y, z and of their products."""
    h, w = ok.shape
    vf = ok.to(pc.dtype)
    p = torch.where(ok[..., None], pc, torch.zeros((), device=pc.device))
    pad = F.pad(p.permute(2, 0, 1), (WINDOW,) * 4)
    vpad = F.pad(vf, (WINDOW,) * 4)
    px, py, pz = p.unbind(-1)
    n_out = torch.zeros_like(vf)
    n = torch.zeros_like(vf)
    s1 = torch.zeros(3, h, w, device=pc.device)
    s2 = torch.zeros(3, 3, h, w, device=pc.device)
    for dv in range(2 * WINDOW + 1):
        for du in range(2 * WINDOW + 1):
            q = pad[:, dv:dv + h, du:du + w]
            qok = vpad[dv:dv + h, du:du + w]
            dx, dy, dz = q[0] - px, q[1] - py, q[2] - pz
            d2 = dx * dx + dy * dy + dz * dz
            n_out = n_out + torch.where(d2 <= OUTLIER_R ** 2, qok, 0.0)
            wgt = torch.where(d2 <= NORMAL_R ** 2, qok, 0.0)
            n = n + wgt
            s1 = s1 + wgt * q
            s2 = s2 + wgt * q[:, None] * q[None, :]
    return n_out, n, s1, s2


def smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric 3x3 matrices
    (..., 3, 3), float64: the eigenvalue by the trigonometric solution of
    the characteristic cubic, the vector as the widest cross product of two
    rows of A - lambda I."""
    a11, a22, a33 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a12, a13, a23 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a11 + a22 + a33) / 3.0
    p1 = a12 ** 2 + a13 ** 2 + a23 ** 2
    p = torch.sqrt(((a11 - q) ** 2 + (a22 - q) ** 2 + (a33 - q) ** 2 + 2.0 * p1)
                   .clamp(min=1e-300) / 6.0)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[..., None, None] * eye) / p[..., None, None]
    r = (torch.linalg.det(B) / 2.0).clamp(-1.0, 1.0)
    lam = q + 2.0 * p * torch.cos(torch.acos(r) / 3.0 + 2.0 * math.pi / 3.0)
    M = A - lam[..., None, None] * eye
    c = torch.stack([torch.linalg.cross(M[..., 0, :], M[..., 1, :]),
                     torch.linalg.cross(M[..., 0, :], M[..., 2, :]),
                     torch.linalg.cross(M[..., 1, :], M[..., 2, :])], dim=-2)
    n2 = (c * c).sum(-1)
    best = n2.argmax(-1)
    v = torch.gather(c, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    return v / torch.sqrt(n2.amax(-1).clamp(min=1e-300))[..., None]


def point_cloud(depth: torch.Tensor, ok: torch.Tensor, intr, cut, budget: int):
    """The SDF term's box-filtered camera-space cloud of one frame."""
    fx, fy, cx, cy = intr
    sc = 0.5
    d = depth[::2, ::2]
    v_ok = ok[::2, ::2]
    hs, ws = d.shape
    u = torch.arange(ws, dtype=torch.float32, device=d.device)[None, :]
    v = torch.arange(hs, dtype=torch.float32, device=d.device)[:, None]
    dz = torch.where(v_ok, d, torch.zeros((), device=d.device))
    pc = torch.stack([(u - cx * sc) * f32_recip(fx * sc) * dz,
                      (v - cy * sc) * f32_recip(fy * sc) * dz, dz], dim=-1)
    n_out, n, s1, s2 = _window_sums(pc, v_ok)
    keep = v_ok & (n_out >= OUTLIER_NB) & (n >= NORMAL_NB)
    # covariance of the 10 cm neighbourhood, its smallest eigenvector
    nn = torch.clamp(n, min=1.0).double()
    mean = s1.double() / nn
    cov = (s2.double() / nn - mean[:, None] * mean[None, :]).permute(2, 3, 0, 1)
    normal = smallest_eigvec(cov).to(torch.float32)
    facing = (normal * pc).sum(-1) > 0
    normal = torch.where(facing[..., None], -normal, normal)

    # 2 cm boxes in the frustum's grid, a scrambled order, the first `budget`
    ax = [(0.0 - cx * sc) / (fx * sc), (ws - 1 - cx * sc) / (fx * sc)]
    ay = [(0.0 - cy * sc) / (fy * sc), (hs - 1 - cy * sc) / (fy * sc)]
    xs = [a * z for a in ax for z in cut]
    ys = [a * z for a in ay for z in cut]
    lo = [math.floor(c / BOX) - 1 for c in (min(xs), min(ys), cut[0])]
    hi = [math.floor(c / BOX) + 1 for c in (max(xs), max(ys), cut[1])]
    dims = [b - a + 1 for a, b in zip(lo, hi)]
    pts = pc.reshape(-1, 3)
    nrm = normal.reshape(-1, 3)
    keep = keep.reshape(-1)
    box = torch.floor(pts * f32_recip(BOX)).to(torch.int64)
    ix = box - torch.tensor(lo, device=box.device)
    inside = keep & torch.all((ix >= 0) & (ix < torch.tensor(dims, device=box.device)), 1)
    key = ((ix[:, 0] * dims[1] + ix[:, 1]) * dims[2] + ix[:, 2]) * KNUTH & MASK32
    key, pts, nrm = key[inside], pts[inside], nrm[inside]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    m = uniq.shape[0]
    cnt = torch.zeros(m, device=pts.device).index_add_(0, inv, torch.ones_like(key, dtype=torch.float32))
    mp = torch.zeros(m, 3, device=pts.device, dtype=torch.float64).index_add_(0, inv, pts.double())
    mn = torch.zeros(m, 3, device=pts.device, dtype=torch.float64).index_add_(0, inv, nrm.double())
    mp = (mp / cnt[:, None].double()).float()
    mn = (mn / cnt[:, None].double()).float()
    out_p = torch.zeros(budget, 3, device=pts.device)
    out_n = torch.zeros(budget, 3, device=pts.device)
    mask = torch.zeros(budget, dtype=torch.bool, device=pts.device)
    k = min(m, budget)
    out_p[:k], out_n[:k], mask[:k] = mp[:k], mn[:k], True
    return out_p, out_n, mask


def preprocess(rgb: np.ndarray, depth_u16: np.ndarray, cfg: Dict, device) -> Frame:
    """A frame of the configuration's sensor, preprocessed."""
    fr = cfg["frames"]
    cut = (float(cfg["depth_cut_min"]), float(cfg["depth_cut_max"]))
    grey, d = sensor(rgb, depth_u16, float(fr["depth_scale"]), device)
    ok = (d >= cut[0]) & (d <= cut[1])
    d = torch.where(ok, d, torch.zeros((), device=device))
    pts, nrm, mask = point_cloud(d, ok, fr["intrinsics"], cut,
                                 int(cfg["assumed"]["point_budget"]))
    return Frame(grey, d, ok, pts, nrm, mask)
