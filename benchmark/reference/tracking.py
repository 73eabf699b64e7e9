"""The tracker's objective, plainly, at a given pose: what a tracked frame's
pose and energy are judged by.

The last group of DI-Fusion's Gauss-Newton schedule minimises, over the
camera motion ``delta`` from the previous frame's pose ``P`` to this
frame's, ``E = E_sdf + E_rgb``:

* ``E_sdf``: the mean over the frame's valid points y (camera space, moved
  by ``delta``, then placed by ``P``) of ``w r^2``, ``r = sdf / std`` decoded
  from the map at the point, ``w`` the Huber weight (k = 5); a point counts
  where its cell is observed more than ``ignore_count_th`` times.
* ``E_rgb``: ``rgb_weight`` times the mean of ``f^2`` over the pixels that
  warp into the previous frame: ``f`` the current grey value less the
  previous frame's, read bilinearly where the pixel lands; a pixel counts
  inside the previous image, off the 1-pixel border, with valid depth here
  and at the nearest previous texel, the two within ``max_depth_delta``.

``gn_excess`` takes one Gauss-Newton step of that objective from the pose
(the tracker's Jacobians: the SDF gradient through the decoder with std
held, the photometric one at the nearest texel) and returns how much of
the energy it removes: at a converged pose, next to nothing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .frames import Frame


def _cam(cfg: Dict, device):
    fx, fy, cx, cy = cfg["frames"]["intrinsics"]
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], device=device)
    Kinv = torch.tensor([[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy],
                         [0.0, 0.0, 1.0]], device=device)
    return K, Kinv, (fx, fy, cx, cy)


def relative(Rp, tp, Rc, tc) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta with P_cur = P_prev o delta (float64 in, float32 out)."""
    R = Rp.T @ Rc
    t = Rp.T @ (tc - tp)
    return R.float(), t.float()


def _sdf(y, mask, Rp, tp, vmap, prior):
    x = y @ Rp.T + tp
    lat, rel, valid = vmap.gather(x)
    sdf, std = prior.decode(lat, rel)
    return sdf, std, mask & valid


def sdf_energy(frame: Frame, R, t, Rp, tp, vmap, prior, k: float = 5.0):
    y = frame.pts @ R.T + t
    sdf, std, ok = _sdf(y, frame.mask, Rp, tp, vmap, prior)
    r = torch.where(ok, sdf / std, torch.zeros((), device=y.device))
    w = torch.where(r.abs() > k, k / r.abs().clamp(min=1e-12), torch.ones_like(r))
    n = ok.sum().clamp(min=1)
    return (w * r * r * ok).sum() / n


def sdf_energy_interval(frame: Frame, R, t, Rp, tp, vmap, prior, k: float = 5.0,
                        eps: float = 1e-4) -> Tuple[float, float]:
    """The SDF energy over every choice of cell for the points within
    ``eps`` voxels of a cell face: a position computed in another order
    (the served pose composed from the previous one, a box mean summed
    otherwise) moves a point by micrometres, which is enough to cross a
    face, and a point that crosses takes the neighbour's latent and moves
    the mean by ~1/N.  Returns (lowest, highest): the sums and counts of
    the two choices of each such point bound every combination."""
    x = (frame.pts @ R.T + t) @ Rp.T + tp
    pn = vmap.normalized(x)
    cell = torch.ceil(pn) - 1
    frac = pn - cell
    lower = frac < eps
    upper = frac > 1.0 - eps
    amb = frame.mask & (lower | upper).any(-1)
    alt = cell - lower.to(cell.dtype) + upper.to(cell.dtype)

    def terms(c):
        idx, inside = vmap._index(c.to(torch.int64))
        valid = frame.mask & inside & vmap.alloc[idx] & (vmap.count[idx] > vmap.ignore)
        lat = torch.where(valid[:, None], vmap.latent[idx], torch.zeros((), device=x.device))
        sdf, std = prior.decode(lat, pn - c - 0.5)
        r = torch.where(valid, sdf / std, torch.zeros((), device=x.device))
        w = torch.where(r.abs() > k, k / r.abs().clamp(min=1e-12), torch.ones_like(r))
        return (w * r * r * valid).double(), valid.double()
    s0, n0 = terms(cell)
    s1, n1 = terms(alt)
    fixed = ~amb
    S, N = s0[fixed].sum(), n0[fixed].sum()
    s_lo, s_hi = torch.minimum(s0, s1)[amb].sum(), torch.maximum(s0, s1)[amb].sum()
    n_lo, n_hi = torch.minimum(n0, n1)[amb].sum(), torch.maximum(n0, n1)[amb].sum()
    lo = float((S + s_lo) / (N + n_hi).clamp(min=1))
    hi = float((S + s_hi) / (N + n_lo).clamp(min=1))
    return lo, hi


def _warp(cur: Frame, prev: Frame, R, t, cfg):
    """Per current pixel: the photometric residual, its Jacobian and mask."""
    K, Kinv, (fx, fy, cx, cy) = _cam(cfg, R.device)
    h, w = cur.intensity.shape
    A = K @ R @ Kinv
    b = K @ t
    u = torch.arange(w, dtype=torch.float32, device=R.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=R.device)[:, None]
    d1 = torch.where(cur.depth_ok, cur.depth, torch.zeros((), device=R.device))
    wz = d1 * (A[2, 0] * u + A[2, 1] * v + A[2, 2]) + b[2]
    wz_s = torch.where(wz.abs() > 1e-12, wz, torch.ones_like(wz))
    uf = (d1 * (A[0, 0] * u + A[0, 1] * v + A[0, 2]) + b[0]) / wz_s
    vf = (d1 * (A[1, 0] * u + A[1, 1] * v + A[1, 2]) + b[1]) / wz_s
    ur, vr = torch.round(uf), torch.round(vf)
    inside = (ur >= 0) & (ur < w) & (vr >= 0) & (vr < h)
    ua, va = uf.clamp(0, w - 1), vf.clamp(0, h - 1)
    u0, v0 = torch.floor(ua), torch.floor(va)
    au, av = ua - u0, va - v0
    u0i, v0i = u0.long(), v0.long()
    u1i, v1i = (u0i + 1).clamp(max=w - 1), (v0i + 1).clamp(max=h - 1)
    I = prev.intensity
    val = ((1 - av) * ((1 - au) * I[v0i, u0i] + au * I[v0i, u1i])
           + av * ((1 - au) * I[v1i, u0i] + au * I[v1i, u1i]))
    D = prev.depth
    d0 = D[torch.where(av >= 0.5, v1i, v0i), torch.where(au >= 0.5, u1i, u0i)]
    border = torch.zeros_like(cur.depth_ok)
    border[1:-1, 1:-1] = True
    ok = border & cur.depth_ok & inside & ((wz - d0).abs() <= cfg["tracking"]["rgb"]["max_depth_delta"]) & (d0 > 0)
    f = torch.where(ok, cur.intensity - val, torch.zeros((), device=R.device))
    # the tracker's Jacobian: the current image's Sobel gradient (/8) at the
    # pixel, the geometry of the nearest previous texel
    Ip = torch.nn.functional.pad(cur.intensity[None, None], (1, 1, 1, 1))[0, 0]
    gx = ((Ip[:-2, 2:] - Ip[:-2, :-2]) + 2 * (Ip[1:-1, 2:] - Ip[1:-1, :-2])
          + (Ip[2:, 2:] - Ip[2:, :-2])) / 8.0
    gy = ((Ip[2:, :-2] - Ip[:-2, :-2]) + 2 * (Ip[2:, 1:-1] - Ip[:-2, 1:-1])
          + (Ip[2:, 2:] - Ip[:-2, 2:])) / 8.0
    uc, vc = ur.clamp(0, w - 1), vr.clamp(0, h - 1)
    gz = torch.where(d0 > 1e-12, d0, torch.ones_like(d0))
    X, Y = d0 * (uc - cx) / fx, d0 * (vc - cy) / fy
    p0, p1 = gx * fx / gz, gy * fy / gz
    p2 = -(p0 * X + p1 * Y) / gz
    J = -torch.stack([p0, p1, p2, -gz * p1 + Y * p2, gz * p0 - X * p2, -Y * p0 + X * p1], -1)
    return f, torch.where(ok[..., None], J, torch.zeros((), device=R.device)), ok


def rgb_energy(cur: Frame, prev: Frame, R, t, cfg):
    f, _, ok = _warp(cur, prev, R, t, cfg)
    return float(cfg["tracking"]["rgb"]["weight"]) * (f * f).sum() / ok.sum().clamp(min=1)


def energy(cur: Frame, prev: Frame, R, t, Rp, tp, vmap, prior, cfg) -> torch.Tensor:
    """E at the motion (R, t) from the previous pose (Rp, tp), float32."""
    return (sdf_energy(cur, R, t, Rp, tp, vmap, prior)
            + rgb_energy(cur, prev, R, t, cfg))


def energy_interval(cur: Frame, prev: Frame, R, t, Rp, tp, vmap, prior, cfg
                    ) -> Tuple[float, float]:
    """The range of E over the cell choices of the points on a cell face
    (:func:`sdf_energy_interval`)."""
    lo, hi = sdf_energy_interval(cur, R, t, Rp, tp, vmap, prior)
    rgb = float(rgb_energy(cur, prev, R, t, cfg))
    return lo + rgb, hi + rgb


def _exp(xi: torch.Tensor):
    rho, phi = xi[:3], xi[3:]
    a = torch.linalg.norm(phi)
    W = torch.zeros(3, 3, dtype=xi.dtype, device=xi.device)
    W[0, 1], W[0, 2], W[1, 0], W[1, 2], W[2, 0], W[2, 1] = -phi[2], phi[1], phi[2], -phi[0], -phi[1], phi[0]
    if float(a) < 1e-9:
        return torch.eye(3, dtype=xi.dtype, device=xi.device) + W, rho
    s, c = torch.sin(a), torch.cos(a)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    Rx = I + s / a * W + (1 - c) / a ** 2 * W @ W
    V = I + (1 - c) / a ** 2 * W + (a - s) / a ** 3 * W @ W
    return Rx, V @ rho


def gn_excess(cur: Frame, prev: Frame, R, t, Rp, tp, vmap, prior, cfg) -> float:
    """The share of E that one Gauss-Newton step from (R, t) removes."""
    y = (cur.pts @ R.T + t).detach().requires_grad_(True)
    with torch.enable_grad():
        sdf, std, ok = _sdf(y, cur.mask, Rp, tp, vmap, prior)
        r = sdf / std.detach()
        G, = torch.autograd.grad(torch.where(ok, r, torch.zeros_like(r)).sum(), y)
    r = torch.where(ok, r.detach(), torch.zeros_like(r))
    k = 5.0
    w = torch.where(r.abs() > k, k / r.abs().clamp(min=1e-12), torch.ones_like(r)) * ok
    Js = torch.cat([G, torch.cross(y.detach(), G, dim=-1)], -1).double()
    n_s = ok.sum().clamp(min=1).double()
    H = (Js * w.double()[:, None]).T @ Js / n_s
    g = (Js * (w * r).double()[:, None]).sum(0) / n_s
    f, Jr, okr = _warp(cur, prev, R, t, cfg)
    Jr, f = Jr.reshape(-1, 6).double(), f.reshape(-1).double()
    sc = float(cfg["tracking"]["rgb"]["weight"]) / okr.sum().clamp(min=1).double()
    H = H + Jr.T @ Jr * sc
    g = g + (Jr * f[:, None]).sum(0) * sc
    d = torch.sqrt(torch.diagonal(H).abs() + 1e-12)
    xi = torch.linalg.solve(H / (d[:, None] * d[None, :]), -g / d) / d
    Rx, tx = _exp(xi)
    R2 = (Rx @ R.double()).float()
    t2 = (Rx @ t.double() + tx).float()
    E0 = energy(cur, prev, R, t, Rp, tp, vmap, prior, cfg)
    E1 = energy(cur, prev, R2, t2, Rp, tp, vmap, prior, cfg)
    return max(0.0, float((E0 - E1) / E0))
