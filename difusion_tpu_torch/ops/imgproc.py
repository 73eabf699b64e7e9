"""Depth/intensity image ops on tensors (counterpart of
difusion_tpu/ops/imgproc.py; its ``_space_to_depth_filter`` one-hot
convolution is :func:`_patches`' strided slices here).

Layouts follow the JAX package: (H, W) images, (H, W, 3) point maps,
(H, W, C) textures.  Invalidity is carried as explicit boolean masks.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


class Intrinsic(NamedTuple):
    """Pinhole intrinsics."""
    fx: float
    fy: float
    cx: float
    cy: float
    dcam_scale: float = 1000.0

    def to_K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]])

    def scaled(self, s: float) -> "Intrinsic":
        return Intrinsic(self.fx * s, self.fy * s, self.cx * s, self.cy * s,
                         self.dcam_scale)


def recip(c: float) -> float:
    """The f32 reciprocal of a constant divisor.  The JAX reference runs
    under ``jit``, where XLA rewrites ``x / c`` for a constant ``c`` into
    ``x * (1 / c)``; the port multiplies by the same f32 reciprocal where a
    floor, a ceil or a threshold test follows, so cell keys and counts agree
    with the reference bit for bit."""
    return float(np.float32(1.0) / np.float32(c))


def unproject_depth(depth: torch.Tensor, valid: torch.Tensor,
                    fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-space point map; invalid -> 0."""
    h, w = depth.shape
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    d = torch.where(valid, depth, torch.zeros((), dtype=depth.dtype,
                                              device=depth.device))
    return torch.stack([(u - cx) * recip(fx) * d, (v - cy) * recip(fy) * d, d],
                       dim=-1)


_MEAN_SIGMA_L = 1.2232


def filter_depth(depth: torch.Tensor, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """5x5 depth-adaptive bilateral filter: spatial weight
    exp(-.5 (|i|+|j|) sigma_L^2), range weight exp(-.5 dz^2 sigma_z^2) with
    the sensor-noise model sigma_z(z).  Border (2 px) and invalid pixels
    pass through unchanged.  No path of either package calls it."""
    zero = torch.zeros((), dtype=depth.dtype, device=depth.device)
    z = torch.where(valid, depth, zero)
    sigma_z = 1.0 / (0.0012 + 0.0019 * (z - 0.4) ** 2
                     + 0.0001 / torch.sqrt(torch.clamp(z, min=1e-12)) * 0.25)
    w_sum = torch.zeros_like(z)
    d_sum = torch.zeros_like(z)
    for i in range(-2, 3):
        for j in range(-2, 3):
            nn_z = torch.roll(z, (-i, -j), dims=(0, 1))
            nn_ok = torch.roll(valid, (-i, -j), dims=(0, 1))
            dz2 = (nn_z - z) ** 2
            w = torch.exp(-0.5 * ((abs(i) + abs(j)) * _MEAN_SIGMA_L ** 2
                                  + dz2 * sigma_z ** 2))
            w = torch.where(nn_ok, w, zero)
            w_sum = w_sum + w
            d_sum = d_sum + w * nn_z
    out = d_sum / torch.clamp(w_sum, min=1e-12)
    h, w = depth.shape
    u = torch.arange(w, device=depth.device)[None, :]
    v = torch.arange(h, device=depth.device)[:, None]
    interior = (v >= 2) & (v < h - 2) & (u >= 2) & (u < w - 2)
    ok = valid & interior & (w_sum > 0)
    return torch.where(ok, out, depth), valid


def _sensor_weight(z: torch.Tensor, normal_z: torch.Tensor) -> torch.Tensor:
    """Sensor-noise weight: 1/w, where w grows with depth and with the
    grazing angle theta = acos(n_z) (the reference's imgproc.cu:133-135)."""
    theta = torch.arccos(torch.clamp(normal_z, -1.0, 1.0))
    theta_diff = theta / (0.5 * 3.14159 - theta)
    w = (0.0012 + 0.0019 * (z - 0.4) ** 2
         + 0.0001 / torch.sqrt(torch.clamp(z, min=1e-12)) * theta_diff ** 2)
    return 1.0 / w


def compute_normal_weight(pc_map: torch.Tensor, valid: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Central-difference cross-product normals of an (H, W, 3) point map
    and their sensor weight (the reference's compute_normal_weight,
    imgproc.cu:98-137).  Returns (normal (H, W, 3), weight (H, W), -1 where
    not ok, ok (H, W)); border pixels are not ok."""
    h, w, _ = pc_map.shape

    def shift(a, dv, du):           # a[v + dv, u + du], wrapping at the border
        return torch.roll(a, (-dv, -du), dims=(0, 1))

    nb_ok = (shift(valid, 0, 1) & shift(valid, 0, -1)
             & shift(valid, 1, 0) & shift(valid, -1, 0))
    diff_x = shift(pc_map, 0, 1) - shift(pc_map, 0, -1)
    diff_y = shift(pc_map, 1, 0) - shift(pc_map, -1, 0)
    normal = torch.linalg.cross(diff_y, diff_x, dim=-1)
    norm = torch.linalg.norm(normal, dim=-1)
    normal = normal / torch.clamp(norm, min=1e-12)[..., None]
    u = torch.arange(w, device=pc_map.device)[None, :]
    v = torch.arange(h, device=pc_map.device)[:, None]
    interior = (v >= 1) & (v < h - 1) & (u >= 1) & (u < w - 1)
    ok = valid & nb_ok & interior & (norm >= 1e-6) & (pc_map[..., 2] > 1e-6)
    weight = _sensor_weight(pc_map[..., 2], normal[..., 2])
    return normal, torch.where(ok, weight, torch.full_like(weight, -1.0)), ok


def sym3eig_smallest_components(x11, x12, x13, x22, x23, x33):
    """Closed-form smallest eigenpair from the 6 unique components of batched
    symmetric 3x3 matrices.  Returns (vx, vy, vz, lam)."""
    p1 = x12 ** 2 + x13 ** 2 + x23 ** 2
    q = (x11 + x22 + x33) / 3.0
    p2 = (x11 - q) ** 2 + (x22 - q) ** 2 + (x33 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=1e-30) / 6.0)
    ip = 1.0 / p
    b11, b12, b13 = ip * (x11 - q), ip * x12, ip * x13
    b22, b23, b33 = ip * (x22 - q), ip * x23, ip * (x33 - q)
    r = (b11 * b22 * b33 + 2.0 * b12 * b23 * b13
         - b13 * b22 * b13 - b12 * b12 * b33 - b11 * b23 * b23) / 2.0
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    a1 = (x11 - lam, x12, x13)
    a2 = (x12, x22 - lam, x23)
    a3 = (x13, x23, x33 - lam)

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1],
                u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0])

    r12, r13, r23 = cross(a1, a2), cross(a1, a3), cross(a2, a3)
    d1 = r12[0] ** 2 + r12[1] ** 2 + r12[2] ** 2
    d2 = r13[0] ** 2 + r13[1] ** 2 + r13[2] ** 2
    d3 = r23[0] ** 2 + r23[1] ** 2 + r23[2] ** 2
    use13 = d2 >= torch.maximum(d1, d3)
    use23 = (d3 > torch.maximum(d1, d2)) & ~use13
    d_best = torch.where(use13, d2, torch.where(use23, d3, d1))
    inv = 1.0 / torch.sqrt(torch.clamp(d_best, min=1e-30))
    comps = [torch.where(use13, r13[c], torch.where(use23, r23[c], r12[c])) * inv
             for c in range(3)]
    return comps[0], comps[1], comps[2], lam


def sym3eig_smallest(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form smallest eigenpair of batched symmetric 3x3 matrices:
    cov (..., 3, 3) -> (eigvec (..., 3), eigval (...,))."""
    vx, vy, vz, lam = sym3eig_smallest_components(
        cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2])
    return torch.stack([vx, vy, vz], dim=-1), lam


def compute_normal_weight_robust(pc_map: torch.Tensor, valid: torch.Tensor,
                                 radius: int = 3, dist2_th: float = 0.01,
                                 min_count: float = 9.0
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Windowed-PCA normals (the reference's compute_normal_weight_robust,
    imgproc.cu:246-331): a two-pass mean and covariance over the
    (2 radius + 1)^2 window, restricted to points within sqrt(dist2_th) of
    the centre, its smallest eigenvector flipped towards the camera.  Not
    kernel 2, whose one-pass moments use other thresholds.  Returns
    (normal (H, W, 3), weight (H, W), -1 where not ok, ok (H, W))."""
    h, w, _ = pc_map.shape
    dev = pc_map.device
    z_ok = valid & (pc_map[..., 2] > 1e-6)
    p = torch.where(z_ok[..., None], pc_map, torch.zeros((), dtype=pc_map.dtype,
                                                         device=dev))
    window = [(dv, du) for dv in range(-radius, radius + 1)
              for du in range(-radius, radius + 1)]

    def neighbor(dv, du):
        pos = torch.roll(p, (-dv, -du), dims=(0, 1))
        ok = torch.roll(z_ok, (-dv, -du), dims=(0, 1))
        d = pos - pc_map          # x, y, z summed in this order on every device
        near = ok & (d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2 < dist2_th)
        return pos, near.to(p.dtype)

    s = torch.zeros_like(p)
    cnt = torch.zeros(p.shape[:2], dtype=p.dtype, device=dev)
    for dv, du in window:
        pos, wgt = neighbor(dv, du)
        s = s + pos * wgt[..., None]
        cnt = cnt + wgt
    mean = s / torch.clamp(cnt, min=1.0)[..., None]
    cov = torch.zeros(p.shape[:2] + (3, 3), dtype=p.dtype, device=dev)
    for dv, du in window:
        pos, wgt = neighbor(dv, du)
        d = (pos - mean) * wgt[..., None]
        cov = cov + d[..., :, None] * (pos - mean)[..., None, :]

    normal, _ = sym3eig_smallest(cov)
    flip = torch.sum(normal * pc_map, dim=-1) > 0.0
    normal = torch.where(flip[..., None], -normal, normal)
    u = torch.arange(w, device=dev)[None, :]
    v = torch.arange(h, device=dev)[:, None]
    interior = (v >= radius) & (v < h - radius) & (u >= radius) & (u < w - radius)
    ok = z_ok & interior & (cnt >= min_count)
    weight = _sensor_weight(pc_map[..., 2], normal[..., 2])
    return normal, torch.where(ok, weight, torch.full_like(weight, -1.0)), ok


def gradient_xy(intensity: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients /8 with an invalid 1-px border.
    Returns (grad (H, W, 2) [d/du, d/dv], ok (H, W))."""
    h, w = intensity.shape

    def sh(dv, du):
        return torch.roll(intensity, (-dv, -du), dims=(0, 1))

    gx = ((sh(-1, 1) - sh(-1, -1)) + 2.0 * (sh(0, 1) - sh(0, -1))
          + (sh(1, 1) - sh(1, -1))) / 8.0
    gy = ((sh(1, -1) - sh(-1, -1)) + 2.0 * (sh(1, 0) - sh(-1, 0))
          + (sh(1, 1) - sh(-1, 1))) / 8.0
    u = torch.arange(w, device=intensity.device)[None, :]
    v = torch.arange(h, device=intensity.device)[:, None]
    ok = (v >= 1) & (v < h - 1) & (u >= 1) & (u < w - 1)
    zero = torch.zeros((), dtype=intensity.dtype, device=intensity.device)
    grad = torch.stack([torch.where(ok, gx, zero), torch.where(ok, gy, zero)],
                       dim=-1)
    return grad, ok


def warp_texture(prev_intensity: torch.Tensor,
                 prev_depth: torch.Tensor) -> torch.Tensor:
    """(H, W, 8) per-pixel warp texture: the 4 bilinear intensity taps and the
    4 depth neighbours of every pixel, so the warp needs one gather per
    target pixel.  A tap that wraps at the border always carries bilinear
    weight 0 (lookups clip to w-1 / h-1)."""
    i_r = torch.roll(prev_intensity, -1, dims=1)
    i_d = torch.roll(prev_intensity, -1, dims=0)
    d_r = torch.roll(prev_depth, -1, dims=1)
    d_d = torch.roll(prev_depth, -1, dims=0)
    return torch.stack([prev_intensity, i_r, i_d, torch.roll(i_d, -1, dims=1),
                        prev_depth, d_r, d_d, torch.roll(d_d, -1, dims=1)],
                       dim=-1)


def rgb_odometry(prev_tex: torch.Tensor,
                 cur_intensity: torch.Tensor, cur_depth: torch.Tensor,
                 cur_depth_ok: torch.Tensor,
                 cur_dIdxy: torch.Tensor, grad_ok: torch.Tensor,
                 intr, krkinv: torch.Tensor, kt: torch.Tensor,
                 min_grad_scale: float, max_depth_delta: float,
                 coord_stride: int = 1, bilinear: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pixel photometric residual + analytic 6-DoF Jacobian with bilinear
    intensity lookup through :func:`warp_texture` (difusion_tpu
    ``rgb_odometry`` with ``bilinear=True`` and an invalid-zeroed previous
    depth).  Warps the current pixel into the previous frame with
    ``K R K^-1`` / ``K t``; depth gating and Jacobian geometry use the
    round-to-nearest pixel.  ``intr`` = (fx, fy, cx, cy).  Returns
    (f (H, W), J (H, W, 6), ok (H, W)); J is for ``+xi`` on the current pose.
    ``coord_stride``: the current-frame inputs are a stride-s subsample.
    ``bilinear=False``: the reference's round-to-nearest warp, intensity and
    depth read at the nearest pixel of ``prev_tex`` = the (H, W, 2) stack
    ``[intensity, depth]`` of the previous frame."""
    h, w = prev_tex.shape[:2]
    hc, wc = cur_intensity.shape
    dt, dev = cur_depth.dtype, cur_depth.device
    zero = torch.zeros((), dtype=dt, device=dev)
    u = (torch.arange(wc, dtype=dt, device=dev) * coord_stride)[None, :]
    v = (torch.arange(hc, dtype=dt, device=dev) * coord_stride)[:, None]

    dI_dx = cur_dIdxy[..., 0]
    dI_dy = cur_dIdxy[..., 1]
    m2 = dI_dx ** 2 + dI_dy ** 2
    ok = grad_ok & (m2 >= min_grad_scale) & cur_depth_ok

    d1 = torch.where(cur_depth_ok, cur_depth, zero)
    wz = d1 * (krkinv[2, 0] * u + krkinv[2, 1] * v + krkinv[2, 2]) + kt[2]
    wz_safe = torch.where(torch.abs(wz) > 1e-12, wz, torch.ones_like(wz))
    u0f = (d1 * (krkinv[0, 0] * u + krkinv[0, 1] * v + krkinv[0, 2]) + kt[0]) / wz_safe
    v0f = (d1 * (krkinv[1, 0] * u + krkinv[1, 1] * v + krkinv[1, 2]) + kt[1]) / wz_safe
    # round and bound-test in float: the int32 cast of an out-of-range float
    # is undefined, and a pixel outside the image is masked out anyway
    u0r, v0r = torch.round(u0f), torch.round(v0f)
    inside = (u0r >= 0) & (u0r < w) & (v0r >= 0) & (v0r < h)
    u0c = torch.clamp(u0r, 0, w - 1)
    v0c = torch.clamp(v0r, 0, h - 1)

    if bilinear:
        u0a = torch.clamp(u0f, 0.0, w - 1.0)
        v0a = torch.clamp(v0f, 0.0, h - 1.0)
        uf = torch.floor(u0a)
        vf = torch.floor(v0a)
        au = u0a - uf
        av = v0a - vf
        idx = (vf.long() * w + uf.long()).reshape(-1)
        taps = prev_tex.reshape(h * w, 8)[idx].reshape(hc, wc, 8)
        prev_val = ((1 - av) * ((1 - au) * taps[..., 0] + au * taps[..., 1])
                    + av * ((1 - au) * taps[..., 2] + au * taps[..., 3]))
        su = au >= 0.5
        sv = av >= 0.5
        d0 = torch.where(sv, torch.where(su, taps[..., 7], taps[..., 6]),
                         torch.where(su, taps[..., 5], taps[..., 4]))
    else:
        idx = (v0c.long() * w + u0c.long()).reshape(-1)
        tap = prev_tex.reshape(h * w, 2)[idx].reshape(hc, wc, 2)
        prev_val, d0 = tap[..., 0], tap[..., 1]
    ok = ok & inside & (torch.abs(wz - d0) <= max_depth_delta) & (d0 > 0.0)
    f = torch.where(ok, cur_intensity - prev_val, zero)

    fx, fy, cx, cy = intr
    gz = torch.where(d0 > 1e-12, d0, torch.ones_like(d0))
    gx = d0 * (u0c - cx) / fx
    gy = d0 * (v0c - cy) / fy
    p0 = dI_dx * fx / gz
    p1 = dI_dy * fy / gz
    p2 = -(p0 * gx + p1 * gy) / gz
    J = torch.stack([p0, p1, p2,
                     -gz * p1 + gy * p2,
                     gz * p0 - gx * p2,
                     -gy * p0 + gx * p1], dim=-1)
    J = torch.where(ok[..., None], -J, zero)   # tracker-side negation folded in
    return f, J, ok


def _patches(img: torch.Tensor, window: int = 5, stride: int = 2) -> torch.Tensor:
    """(H/stride, W/stride, window*window*C) patches of an (H, W, C) image:
    channel ``(r*window + c)*C + ch`` of entry (a, b) is pixel
    ``(stride*a + r, stride*b + c)`` channel ``ch``, zero past the border.
    The JAX package gathers them with a one-hot convolution, exact by
    construction; here each is a strided slice, the same copies."""
    h, w, n_ch = img.shape
    pad = torch.zeros(h + window - stride, w + window - stride, n_ch,
                      dtype=img.dtype, device=img.device)
    pad[:h, :w] = img
    taps = [pad[r:r + h:stride, c:c + w:stride] for r in range(window)
            for c in range(window)]
    return torch.stack(taps, dim=2).reshape(h // stride, w // stride, -1)


def warp_texture_tiled(prev_intensity: torch.Tensor,
                       prev_depth: torch.Tensor) -> torch.Tensor:
    """(H/2 * W/2, 50) block-tiled warp texture: row ``a * W/2 + b`` is the
    5x5x2 patch with top-left pixel ``(2a, 2b)``, channel ``(r*5 + c)*2 + ch``
    image channel ``ch`` (0 intensity, 1 depth) at pixel ``(2a+r, 2b+c)``,
    zeros past the border (difusion_tpu/ops/imgproc.py:312-339).  One row
    covers the bilinear footprints of a whole 2x2 pixel block."""
    h, w = prev_intensity.shape
    if h % 2 or w % 2:
        raise ValueError("the tiled warp texture needs even dims")
    img2 = torch.stack([prev_intensity, prev_depth], dim=-1)
    return _patches(img2).reshape((h // 2) * (w // 2), 50)


def warp_texture_tiled_quantized(prev_intensity: torch.Tensor,
                                 prev_depth: torch.Tensor,
                                 dcam_scale: float) -> torch.Tensor:
    """(H/2 * W/2, 75) bf16 block-tiled texture for sensor-grid frames:
    channel ``r*5 + c`` is round(255 * intensity), ``25 + r*5 + c`` the high
    and ``50 + r*5 + c`` the low byte of round(dcam_scale * depth) at pixel
    ``(2a+r, 2b+c)`` (difusion_tpu/ops/imgproc.py:342-381).  Integers in
    [0, 255] are exact in bf16; :func:`rgb_odometry_tiled` rebuilds each tap
    with the unpacker's arithmetic."""
    h, w = prev_intensity.shape
    if h % 2 or w % 2:
        raise ValueError("the tiled warp texture needs even dims")
    i255 = torch.round(prev_intensity * 255.0)
    d_units = torch.round(prev_depth * dcam_scale)
    d_hi = torch.floor(d_units * (1.0 / 256.0))
    d_lo = d_units - 256.0 * d_hi
    pat = _patches(torch.stack([i255, d_hi, d_lo], dim=-1).to(torch.bfloat16))
    # (r, c, plane) -> (plane, r, c): one contiguous block of 25 per plane
    pat = pat.reshape(h // 2, w // 2, 25, 3).transpose(2, 3)
    return pat.reshape((h // 2) * (w // 2), 75)


class TiledFramePlanes(NamedTuple):
    """2x2 parity-plane split of one pyramid level's current-frame inputs
    for :func:`rgb_odometry_tiled`: entry ``[P, a, b]`` of each (4, H/2, W/2)
    array is pixel ``(2a + p, 2b + q)``, P = 2p + q."""
    intensity: torch.Tensor
    depth: torch.Tensor
    depth_ok: torch.Tensor
    grad_x: torch.Tensor
    grad_y: torch.Tensor
    grad_ok: torch.Tensor


def make_tiled_frame_planes(intensity: torch.Tensor, depth: torch.Tensor,
                            depth_ok: torch.Tensor, grad: torch.Tensor,
                            grad_ok: torch.Tensor) -> TiledFramePlanes:
    """Split a level's current-frame inputs into the four parity planes
    (difusion_tpu/ops/imgproc.py:396-425; strided slices, exact copies)."""
    h, w = intensity.shape
    if h % 2 or w % 2:
        raise ValueError("the tiled parity planes need even dims")

    def planes(x):
        return torch.stack([x[p::2, q::2] for p in (0, 1) for q in (0, 1)])
    return TiledFramePlanes(intensity=planes(intensity), depth=planes(depth),
                            depth_ok=planes(depth_ok), grad_x=planes(grad[..., 0]),
                            grad_y=planes(grad[..., 1]), grad_ok=planes(grad_ok))


def rgb_odometry_tiled(planes: TiledFramePlanes, tex: torch.Tensor, intr,
                       krkinv: torch.Tensor, kt: torch.Tensor,
                       min_grad_scale: float, max_depth_delta: float,
                       dcam_scale: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-tiled :func:`rgb_odometry` (stride 1, bilinear;
    difusion_tpu/ops/imgproc.py:428-556): the previous frame is read through
    the (H2*W2, 50) f32 :func:`warp_texture_tiled` or the (H2*W2, 75) bf16
    :func:`warp_texture_tiled_quantized` texture (``dcam_scale`` required
    then), one row per 2x2 pixel block.  Returns ``f (4, H2, W2)``,
    ``J (6, 4, H2, W2)``, ``ok (4, H2, W2)`` in the planes' order.  A kept
    pixel's residual and Jacobian are the per-pixel warp's; a pixel whose
    block's four footprints do not fit one even-aligned 5x5 window is
    dropped."""
    _, H2, W2 = planes.intensity.shape
    h, w = 2 * H2, 2 * W2
    dt, dev = planes.depth.dtype, planes.depth.device
    zero = torch.zeros((), dtype=dt, device=dev)
    plane = torch.arange(4, device=dev)
    p_ = (plane // 2).to(dt)[:, None, None]
    q_ = (plane % 2).to(dt)[:, None, None]
    u = 2.0 * torch.arange(W2, dtype=dt, device=dev)[None, None, :] + q_
    v = 2.0 * torch.arange(H2, dtype=dt, device=dev)[None, :, None] + p_

    m2 = planes.grad_x ** 2 + planes.grad_y ** 2
    ok = planes.grad_ok & (m2 >= min_grad_scale) & planes.depth_ok

    d1 = torch.where(planes.depth_ok, planes.depth, zero)
    wz = d1 * (krkinv[2, 0] * u + krkinv[2, 1] * v + krkinv[2, 2]) + kt[2]
    wz_safe = torch.where(torch.abs(wz) > 1e-12, wz, torch.ones_like(wz))
    u0f = (d1 * (krkinv[0, 0] * u + krkinv[0, 1] * v + krkinv[0, 2]) + kt[0]) / wz_safe
    v0f = (d1 * (krkinv[1, 0] * u + krkinv[1, 1] * v + krkinv[1, 2]) + kt[1]) / wz_safe
    u0r, v0r = torch.round(u0f), torch.round(v0f)
    inside = (u0r >= 0) & (u0r < w) & (v0r >= 0) & (v0r < h)
    u0c = torch.clamp(u0r, 0, w - 1)
    v0c = torch.clamp(v0r, 0, h - 1)

    u0a = torch.clamp(u0f, 0.0, w - 1.0)
    v0a = torch.clamp(v0f, 0.0, h - 1.0)
    uf = torch.floor(u0a)
    vf = torch.floor(v0a)
    au = u0a - uf
    av = v0a - vf
    ui = uf.to(torch.int32)
    vi = vf.to(torch.int32)

    # the block's window base: the masked least floor coordinate, rounded
    # down to even so that it addresses a texture row
    cand = ok & inside
    big = torch.full((), 1 << 20, dtype=torch.int32, device=dev)
    s_u = torch.clamp(torch.where(cand, ui, big).amin(dim=0), 0, w - 2) & ~1
    s_v = torch.clamp(torch.where(cand, vi, big).amin(dim=0), 0, h - 2) & ~1

    quantized = tex.shape[-1] == 75
    if quantized and not dcam_scale > 0.0:
        raise ValueError("the quantized (75-channel) texture needs dcam_scale")
    row = (s_v >> 1) * W2 + (s_u >> 1)
    tile = tex[row.reshape(-1).long()].reshape(H2, W2, -1)

    ru = ui - s_u[None]
    rv = vi - s_v[None]
    fits = cand & (ru <= 3) & (rv <= 3)
    ru = torch.clamp(ru, 0, 3)
    rv = torch.clamp(rv, 0, 3)
    iu = ru + (au >= 0.5).to(torch.int32)
    iv = rv + (av >= 0.5).to(torch.int32)

    if quantized:
        inv_d = 1.0 / dcam_scale

        def tap_i(r, c):
            return tile[..., r * 5 + c].to(dt) * (1.0 / 255.0)

        def tap_d(r, c):
            return (tile[..., 50 + r * 5 + c].to(dt)
                    + 256.0 * tile[..., 25 + r * 5 + c].to(dt)) * inv_d
    else:
        def tap_i(r, c):
            return tile[..., (r * 5 + c) * 2]

        def tap_d(r, c):
            return tile[..., (r * 5 + c) * 2 + 1]

    # weights are exactly (1 - a) at the floor tap, a at the next and 0.0
    # elsewhere, so the sums are the per-pixel warp's (x + 0.0 == x)
    prev_val = torch.zeros_like(au)
    d0 = torch.zeros_like(d1)
    for r in range(5):
        wv_r = torch.where(rv == r, 1.0 - av, torch.where(rv + 1 == r, av, zero))
        inner = torch.zeros_like(au)
        for c in range(5):
            wu_c = torch.where(ru == c, 1.0 - au, torch.where(ru + 1 == c, au, zero))
            inner = inner + wu_c * tap_i(r, c)
        prev_val = prev_val + wv_r * inner
        for c in range(5):
            d0 = d0 + torch.where((iv == r) & (iu == c), tap_d(r, c), zero)

    ok = (ok & inside & fits & (torch.abs(wz - d0) <= max_depth_delta)
          & (d0 > 0.0))
    f = torch.where(ok, planes.intensity - prev_val, zero)

    fx, fy, cx, cy = intr
    gz = torch.where(d0 > 1e-12, d0, torch.ones_like(d0))
    gx = d0 * (u0c - cx) / fx
    gy = d0 * (v0c - cy) / fy
    p0 = planes.grad_x * fx / gz
    p1 = planes.grad_y * fy / gz
    p2 = -(p0 * gx + p1 * gy) / gz
    J = torch.stack([p0, p1, p2,
                     -gz * p1 + gy * p2,
                     gz * p0 - gx * p2,
                     -gy * p0 + gx * p1], dim=0)
    J = torch.where(ok[None], -J, zero)
    return f, J, ok


def half_bilinear(img: torch.Tensor) -> torch.Tensor:
    """Factor-2 bilinear downsample (torch ``interpolate`` bilinear,
    align_corners=False): 2x2 average pooling for even sizes."""
    h, w = img.shape
    img = img[:h - h % 2, :w - w % 2]
    return (img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2]
            + img[1::2, 1::2]) * 0.25


def subsample2d(img: torch.Tensor, s: int) -> torch.Tensor:
    """``img[::s, ::s]`` over the leading two dims (nearest downsample)."""
    return img if s == 1 else img[::s, ::s]


def half_nearest(img: torch.Tensor) -> torch.Tensor:
    return subsample2d(img, 2)


def masked_half_bilinear(img: torch.Tensor, ok: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor-2 average of the valid pixels of each 2x2 block (an odd last
    row or column is dropped), the block summed in row-major order.  Returns (image (H/2, W/2), ok: the block had a valid
    pixel)."""
    h, w = img.shape
    h2, w2 = 2 * (h // 2), 2 * (w // 2)
    i = torch.where(ok, img, torch.zeros((), dtype=img.dtype, device=img.device))
    o = ok.to(torch.int32)
    total = i[0:h2:2, 0:w2:2] + i[0:h2:2, 1:w2:2] + i[1:h2:2, 0:w2:2] + i[1:h2:2, 1:w2:2]
    cnt = o[0:h2:2, 0:w2:2] + o[0:h2:2, 1:w2:2] + o[1:h2:2, 0:w2:2] + o[1:h2:2, 1:w2:2]
    return total / torch.clamp(cnt, min=1), cnt > 0


class Pyramid(NamedTuple):
    """Intensity/depth/gradient pyramid, finest level first."""
    intensity: Tuple[torch.Tensor, ...]
    depth: Tuple[torch.Tensor, ...]
    depth_ok: Tuple[torch.Tensor, ...]
    grad: Tuple[torch.Tensor, ...]
    grad_ok: Tuple[torch.Tensor, ...]


def make_image_pyramid(intensity: torch.Tensor, depth: torch.Tensor,
                       depth_ok: torch.Tensor, levels: int = 3) -> Pyramid:
    ints, deps, oks, grads, goks = [intensity], [depth], [depth_ok], [], []
    for _ in range(levels - 1):
        ints.append(half_bilinear(ints[-1]))
        deps.append(half_nearest(deps[-1]).contiguous())
        oks.append(half_nearest(oks[-1]).contiguous())
    for lvl in range(levels):
        g, gok = gradient_xy(ints[lvl])
        grads.append(g)
        goks.append(gok)
    return Pyramid(tuple(ints), tuple(deps), tuple(oks), tuple(grads),
                   tuple(goks))
