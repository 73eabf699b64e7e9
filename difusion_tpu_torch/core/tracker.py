"""SDF + photometric camera tracker (counterpart of
difusion_tpu/core/tracker.py:54-266, 282-402, 404-569, 577-686, 719-821,
841-1011, 1040-1177).

Per frame: unpack the byte-plane frame, build a 3-level intensity/depth
pyramid, subsample and unproject the depth, reduce a (2w+1)^2 window per
pixel for radius-outlier counts and PCA normals (kernel 2,
``ops/stencil.py``), voxel-filter the point cloud to the point budget, then
run the grouped Gauss-Newton schedule over se(3): an SDF term (decoder
forward + d sdf/d xyz in one kernel, kernel 1, ``ops/decoder_fused.py``)
and a photometric term (per-pixel bilinear warp), a Jacobi-preconditioned
6x6 solve and energy rejection.

The GN control flow (early exit, energy rejection) runs on the host: each
iteration that may continue reads one device bool, so a tracked frame costs
one device-to-host sync per such iteration (counted in
``SDFTracker.n_host_syncs``).  The JAX package runs the same schedule as
one ``lax.while_loop`` per group.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.decoder import Decoder
from ..ops import imgproc
from ..ops.decoder_fused import decode_grad_fused, pack_fused_decoder
from ..ops.imgproc import Intrinsic, Pyramid
from ..ops.pcproc import point_box_filter
from ..ops.se3 import Pose, exp_twist
from ..ops.stencil import window_stat_sums_map
from ..utils.motion import Isometry
from . import map as M


def _stride_tuple(v, n_levels: int = 3) -> Tuple[int, ...]:
    """Broadcast an int stride to a per-pyramid-level tuple."""
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n_levels


class TrackerConfig(NamedTuple):
    """Tracker configuration: the JAX package's fields and defaults, except
    two routes the port takes by default and alone -- ``warp_tiled=False``
    (the per-pixel bilinear warp; the JAX block-tiled warp is a TPU layout
    device that is bit-exact per kept pixel, tracker.py:94-105) and
    ``sdf_fused="on"`` (the fused decoder-gradient kernel; the JAX default
    XLA forward+vjp computes the same function).  Values the port does not
    implement raise ``NotImplementedError`` in :class:`SDFTracker`."""
    iter_config: Tuple[Tuple[int, Tuple[Tuple, ...]], ...] = (
        (10, (("rgb", 2),)),
        (10, (("sdf",), ("rgb", 1))),
        (50, (("sdf",), ("rgb", 0))),
    )
    sdf_robust_kernel: str = "huber"   # "huber" | "tukey" | "" (none)
    sdf_robust_k: float = 5.0
    subsample: float = 0.5
    rgb_weight: float = 500.0
    rgb_robust_kernel: str = ""
    rgb_robust_k: float = 0.0
    min_grad_scale: float = 0.0
    max_depth_delta: float = 0.2
    point_budget: int = 1 << 14
    outlier_nb: int = 16
    outlier_radius: float = 0.05
    normal_radius: float = 0.1
    stencil_window: int = 6
    box_filter_size: float = 0.02
    pyramid_levels: int = 3
    # GN stops a group once the twist step norm falls below xi_tol or the
    # energy improves by less than energy_rel_tol relative; 0 and 0 run
    # every configured iteration
    xi_tol: float = 1e-5
    energy_rel_tol: float = 1e-4
    rgb_stride: Tuple[int, ...] = (1, 1, 1)
    warp_tiled: bool = False
    warp_texture_bf16: bool = True     # only read by the tiled warp
    depth_cut_min: float = 0.5
    depth_cut_max: float = 5.0
    sdf_compute_dtype: str = "float32"
    sdf_f32_last_group: bool = True    # no-op under float32
    motion_prior: str = "none"
    rgb_bilinear: bool = True
    # reuse the full-resolution intrinsics at every pyramid level
    rgb_fullres_K: bool = False
    # ship f32 frames (16 bytes/pixel) instead of u8 intensity + u16 depth
    lossless_packing: bool = False
    sdf_fused: str = "on"
    solve_dtype: str = "f32"
    sdf_gather_cache: bool = False
    gn_unroll: int = 1
    perturb_points: int = 0

    @classmethod
    def from_args(cls, args, point_budget: int = 1 << 14) -> "TrackerConfig":
        """Build from a reference-style tracking config namespace."""
        iter_config = tuple(
            (int(g["n"]), tuple(tuple(t) for t in g["type"]))
            for g in args.iter_config)
        sdf = args.sdf if isinstance(args.sdf, dict) else vars(args.sdf)
        rgb = args.rgb if isinstance(args.rgb, dict) else vars(args.rgb)
        d = cls._field_defaults
        return cls(
            iter_config=iter_config,
            sdf_robust_kernel=sdf.get("robust_kernel") or "",
            sdf_robust_k=float(sdf.get("robust_k", 5.0)),
            subsample=float(sdf.get("subsample", 0.5)),
            rgb_weight=float(rgb.get("weight", 500.0)),
            rgb_robust_kernel=rgb.get("robust_kernel") or "",
            rgb_robust_k=float(rgb.get("robust_k", 0.0)),
            min_grad_scale=float(rgb.get("min_grad_scale", 0.0)),
            max_depth_delta=float(rgb.get("max_depth_delta", 0.2)),
            point_budget=point_budget,
            rgb_stride=_stride_tuple(getattr(args, "rgb_stride",
                                             d["rgb_stride"])),
            xi_tol=float(getattr(args, "xi_tol", d["xi_tol"])),
            energy_rel_tol=float(getattr(args, "energy_rel_tol",
                                         d["energy_rel_tol"])),
            sdf_compute_dtype=str(getattr(args, "sdf_compute_dtype",
                                          d["sdf_compute_dtype"])),
            sdf_f32_last_group=bool(getattr(args, "sdf_f32_last_group",
                                            d["sdf_f32_last_group"])),
            motion_prior=str(getattr(args, "motion_prior", d["motion_prior"])),
            lossless_packing=bool(getattr(args, "lossless_packing",
                                          d["lossless_packing"])),
            warp_tiled=bool(getattr(args, "warp_tiled", d["warp_tiled"])),
            warp_texture_bf16=bool(getattr(args, "warp_texture_bf16",
                                           d["warp_texture_bf16"])),
            rgb_bilinear=bool(getattr(args, "rgb_bilinear",
                                      d["rgb_bilinear"])),
            rgb_fullres_K=bool(getattr(args, "rgb_fullres_K",
                                       d["rgb_fullres_K"])),
            sdf_fused=str(getattr(args, "sdf_fused", d["sdf_fused"])),
            solve_dtype=str(getattr(args, "solve_dtype", d["solve_dtype"])),
            sdf_gather_cache=bool(getattr(args, "sdf_gather_cache",
                                          d["sdf_gather_cache"])),
            gn_unroll=int(getattr(args, "gn_unroll", d["gn_unroll"])),
            perturb_points=int(getattr(args, "perturb_points",
                                       d["perturb_points"])),
        )


_SUPPORTED = {"warp_tiled": (False,), "sdf_fused": ("on",),
              "solve_dtype": ("f32",), "sdf_compute_dtype": ("float32",),
              "rgb_bilinear": (True,), "sdf_gather_cache": (False,),
              "gn_unroll": (1,), "perturb_points": (0,),
              "motion_prior": ("none",)}


def check_supported(tcfg: TrackerConfig) -> None:
    """Raise NotImplementedError on a configuration value the port lacks."""
    for field, ok in _SUPPORTED.items():
        if getattr(tcfg, field) not in ok:
            raise NotImplementedError(
                f"TrackerConfig.{field}={getattr(tcfg, field)!r} is not "
                f"implemented by the PyTorch port (supported: {ok})")


class ProcessedFrame(NamedTuple):
    """Per-frame products of :func:`preprocess_packed`."""
    pyramid: Pyramid
    pts_cam: torch.Tensor      # (M, 3) camera-space box-filtered points
    normals_cam: torch.Tensor  # (M, 3)
    pc_mask: torch.Tensor      # (M,) bool


# ---------------------------------------------------------------------------
# Frame packing and preprocessing
# ---------------------------------------------------------------------------


def pack_frame(rgb: np.ndarray, depth: np.ndarray, dcam_scale: float,
               lossless: bool = False) -> np.ndarray:
    """Pack a frame into one uint8 byte-plane buffer: (h, 3w) rows of
    ``[intensity | depth low byte | depth high byte]`` (u8 mean intensity,
    u16 sensor depth; float metric depth is quantized by ``dcam_scale``), or
    with ``lossless=True`` the raw f32 RGB + f32 metric depth as 16 byte
    planes, (h, 16w).  ``dcam_scale`` must equal the unpacking calib's."""
    if lossless:
        if rgb.dtype == np.uint8 and rgb.ndim == 3:
            rgb_f = np.asarray(rgb, np.float32) * np.float32(1.0 / 255.0)
        else:
            rgb_f = np.asarray(rgb, np.float32)
        if depth.dtype == np.uint16:
            d = depth.astype(np.float32) / np.float32(dcam_scale)
        else:
            d = np.asarray(depth, np.float32)
        rgb_u = np.ascontiguousarray(rgb_f).view(np.uint32)
        d_u = np.ascontiguousarray(d).view(np.uint32)
        planes = [((rgb_u[:, :, c] >> (8 * k)) & 0xFF).astype(np.uint8)
                  for c in range(3) for k in range(4)]
        planes += [((d_u >> (8 * k)) & 0xFF).astype(np.uint8) for k in range(4)]
        return np.concatenate(planes, axis=1)
    if rgb.dtype == np.uint8 and rgb.ndim == 3:
        intensity = ((rgb.sum(axis=-1, dtype=np.uint16) + 1) // 3).astype(np.uint8)
    else:
        intensity = np.clip(np.asarray(rgb, np.float32).mean(axis=-1) * 255.0
                            + 0.5, 0, 255).astype(np.uint8)
    if depth.dtype == np.uint16:
        dq = depth
    else:
        dq = np.clip(np.nan_to_num(np.asarray(depth, np.float32)) * dcam_scale
                     + 0.5, 0, 65535).astype(np.uint16)
    return np.concatenate([intensity, (dq & 0xFF).astype(np.uint8),
                           (dq >> 8).astype(np.uint8)], axis=1)


def unpack_frame(packed: torch.Tensor, calib: Intrinsic, w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pack_frame` buffer (uint8 tensor) -> (intensity, metric depth),
    f32 (H, W).  The layout follows from the width: 3w quantized, 16w
    lossless."""
    if packed.shape[1] == 16 * w:
        def f32_plane(k0):
            b = torch.stack([packed[:, (k0 + k) * w:(k0 + k + 1) * w]
                             for k in range(4)], dim=-1).contiguous()
            return b.view(torch.float32)[..., 0]       # little-endian bytes
        intensity = (f32_plane(0) + f32_plane(4) + f32_plane(8)) * imgproc.recip(3.0)
        return intensity, f32_plane(12)
    if packed.shape[1] != 3 * w:
        raise ValueError(f"packed frame width {packed.shape[1]} is neither "
                         f"3*{w} nor 16*{w}")
    intensity = packed[:, :w].to(torch.float32) * (1.0 / 255.0)
    lo = packed[:, w:2 * w].to(torch.float32)
    hi = packed[:, 2 * w:].to(torch.float32)
    return intensity, (lo + 256.0 * hi) * (1.0 / calib.dcam_scale)


def _window_stats(pc_map: torch.Tensor, valid: torch.Tensor, window: int,
                  outlier_r2: float, nb_points: int, normal_r2: float,
                  min_nb: float):
    """Radius-outlier count and windowed-PCA normals over the (2w+1)^2 pixel
    window of the point map, through :func:`window_stat_sums_map` (the kernel
    masks the point map by ``valid`` as it loads it).
    Returns (outlier_ok (H, W), normal (H, W, 3), normal_ok (H, W))."""
    sums = window_stat_sums_map(pc_map.contiguous(), valid.contiguous(), window,
                                outlier_r2, normal_r2)
    zero = torch.zeros((), dtype=pc_map.dtype, device=pc_map.device)
    px, py, pz = torch.where(valid[..., None], pc_map, zero).unbind(-1)
    return _finish_window_stats(sums, valid, px, py, pz, nb_points, min_nb)


def _finish_window_stats(sums, valid, px, py, pz, nb_points, min_nb):
    """Window sums -> (outlier_ok, normals, normal_ok) via the one-pass
    covariance identity and the closed-form smallest eigenvector, flipped to
    face the camera."""
    (outlier_cnt, cnt, s1x, s1y, s1z, sxx, sxy, sxz, syy, syz, szz) = sums
    outlier_ok = valid & (outlier_cnt >= nb_points)
    c = 1.0 / torch.clamp(cnt, min=1.0)
    vx, vy, vz, _ = imgproc.sym3eig_smallest_components(
        sxx - s1x * s1x * c, sxy - s1x * s1y * c, sxz - s1x * s1z * c,
        syy - s1y * s1y * c, syz - s1y * s1z * c, szz - s1z * s1z * c)
    flip = (vx * px + vy * py + vz * pz) > 0.0
    normal = torch.stack([torch.where(flip, -vx, vx), torch.where(flip, -vy, vy),
                          torch.where(flip, -vz, vz)], dim=-1)
    normal_ok = valid & (cnt >= min_nb)
    return outlier_ok, normal, normal_ok


def _preprocess_core(tcfg: TrackerConfig, calib: Intrinsic,
                     intensity: torch.Tensor, depth: torch.Tensor
                     ) -> ProcessedFrame:
    """f32 intensity + metric depth -> pyramid + box-filtered point cloud."""
    depth_ok = (depth >= tcfg.depth_cut_min) & (depth <= tcfg.depth_cut_max)
    depth = torch.where(depth_ok, depth, torch.zeros((), device=depth.device))
    pyramid = imgproc.make_image_pyramid(intensity, depth, depth_ok,
                                         tcfg.pyramid_levels)

    stride = int(round(1.0 / tcfg.subsample))
    d_sub = imgproc.subsample2d(depth, stride)
    ok_sub = imgproc.subsample2d(depth_ok, stride)
    sc = tcfg.subsample
    pc_map = imgproc.unproject_depth(d_sub, ok_sub, calib.fx * sc, calib.fy * sc,
                                     calib.cx * sc, calib.cy * sc)
    outlier_ok, normals, n_ok = _window_stats(
        pc_map, ok_sub, tcfg.stencil_window,
        outlier_r2=tcfg.outlier_radius ** 2, nb_points=tcfg.outlier_nb,
        normal_r2=tcfg.normal_radius ** 2, min_nb=6.0)
    ok_sub = outlier_ok & n_ok

    # the camera frustum at the depth cut bounds every valid point, so the
    # box filter keys cells with one exact linear key
    hs, ws = d_sub.shape
    ax = [(0.0 - calib.cx * sc) / (calib.fx * sc),
          (ws - 1 - calib.cx * sc) / (calib.fx * sc)]
    ay = [(0.0 - calib.cy * sc) / (calib.fy * sc),
          (hs - 1 - calib.cy * sc) / (calib.fy * sc)]
    zs = [tcfg.depth_cut_min, tcfg.depth_cut_max]
    xs = [a * z for a in ax for z in zs]
    ys = [a * z for a in ay for z in zs]
    aabb = ((min(xs), min(ys), zs[0]), (max(xs), max(ys), zs[1]))
    pts_f, nrm_f, mask_f = point_box_filter(
        pc_map.reshape(-1, 3), normals.reshape(-1, 3), ok_sub.reshape(-1),
        tcfg.box_filter_size, tcfg.point_budget, aabb=aabb)
    return ProcessedFrame(pyramid=pyramid, pts_cam=pts_f, normals_cam=nrm_f,
                          pc_mask=mask_f)


def preprocess_packed(tcfg: TrackerConfig, calib: Intrinsic,
                      packed: torch.Tensor, w: int) -> ProcessedFrame:
    return _preprocess_core(tcfg, calib, *unpack_frame(packed, calib, w))


# ---------------------------------------------------------------------------
# Gauss-Newton terms
# ---------------------------------------------------------------------------


def _robust_weight(x: torch.Tensor, kind: str, k: float) -> torch.Tensor:
    """IRLS weights."""
    if not kind or k <= 0:
        return torch.ones_like(x)
    ax = torch.abs(x)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    if kind == "huber":
        return torch.where(ax > k, k / torch.clamp(ax, min=1e-12), one)
    if kind == "tukey":
        return torch.where(ax <= k, (1.0 - (x / k) ** 2) ** 2, torch.zeros_like(x))
    raise NotImplementedError(f"robust kernel {kind!r}")


def _normal_equations(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                      scale) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    H = (J * w[:, None]).T @ J * scale
    g = torch.sum(J * (w * r)[:, None], dim=0) * scale
    return H, g, torch.sum(w * r * r) * scale


def _sdf_term(map_cfg: M.MapConfig, packed: torch.Tensor, state: M.MapState,
              last: Pose, delta: Pose, pts: torch.Tensor, mask: torch.Tensor,
              robust_kernel: str, robust_k: float, aug_table: torch.Tensor):
    """SDF residual r = sdf(last o delta y)/std with Jacobian [G | y x G],
    through the fused decode + position-gradient kernel.  The chain factors
    ``d rel/d x = 1/voxel_size`` and ``d x/d y = R_last`` turn the kernel's
    d sdf/d rel into dr/dy (std is held constant, as the JAX vjp route
    stop-gradients it)."""
    y = delta.apply(pts)
    x = last.apply(y)
    latent, rel, valid = M.gather_latent_rel(map_cfg, state, x, aug_table)
    sdf, std, grel = decode_grad_fused(packed, latent.contiguous(),
                                       rel.contiguous())
    zero = torch.zeros((), dtype=sdf.dtype, device=sdf.device)
    ok = mask & valid
    r = torch.where(ok, sdf / std, zero)
    G = torch.where(ok[:, None],
                    (grel / (std[:, None] * map_cfg.voxel_size)) @ last.R, zero)
    J = torch.cat([G, torch.cross(y, G, dim=-1)], dim=-1)       # (N, 6)
    w = torch.where(ok, _robust_weight(r, robust_kernel, robust_k), zero)
    scale = 1.0 / torch.clamp(ok.sum(), min=1).to(r.dtype)
    return _normal_equations(J, r, w, scale)


class LevelCamera(NamedTuple):
    K: torch.Tensor
    Kinv: torch.Tensor
    intr: Tuple[float, float, float, float]


def level_camera(tcfg: TrackerConfig, calib: Intrinsic, level: int,
                 device) -> LevelCamera:
    """Pinhole at pyramid level ``level`` (intrinsics scaled to the level
    unless ``rgb_fullres_K``)."""
    s = 1.0 if tcfg.rgb_fullres_K else 0.5 ** level
    fx, fy = calib.fx * s, calib.fy * s
    cx, cy = (calib.cx + 0.5) * s - 0.5, (calib.cy + 0.5) * s - 0.5
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=device)
    Kinv = torch.tensor([[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)
    return LevelCamera(K, Kinv, (fx, fy, cx, cy))


def _rgb_term(tcfg: TrackerConfig, cam: LevelCamera, stride: int,
              prev_tex: torch.Tensor, cur_level, delta: Pose,
              rgb_weight: float):
    """Photometric residual over one pyramid level: the current level's
    (strided) pixels warped into the previous frame's texture."""
    krkinv = cam.K @ delta.R @ cam.Kinv
    kt = cam.K @ delta.t
    c_int, c_depth, c_ok, c_grad, c_gok = cur_level
    f, J, ok = imgproc.rgb_odometry(
        prev_tex, c_int, c_depth, c_ok, c_grad, c_gok, cam.intr, krkinv, kt,
        tcfg.min_grad_scale, tcfg.max_depth_delta, coord_stride=stride)
    f, J, ok = f.reshape(-1), J.reshape(-1, 6), ok.reshape(-1)
    w = torch.where(ok, _robust_weight(f, tcfg.rgb_robust_kernel,
                                       tcfg.rgb_robust_k),
                    torch.zeros((), dtype=f.dtype, device=f.device))
    scale = rgb_weight / torch.clamp(ok.sum(), min=1).to(f.dtype)
    return _normal_equations(J, f, w, scale)


def _solve_precond(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Jacobi-preconditioned 6x6 solve in f32.  ``solve_ex`` does not check
    for singularity on the host, so it costs no sync; a singular system
    gives a non-finite step, which the caller rejects."""
    d = torch.sqrt(torch.abs(torch.diagonal(H)) + 1e-12)
    Hr = H / (d[:, None] * d[None, :]) + 1e-9 * torch.eye(6, dtype=H.dtype,
                                                          device=H.device)
    xi, _ = torch.linalg.solve_ex(Hr, -g / d)
    return xi / d


# ---------------------------------------------------------------------------
# Gauss-Newton driver
# ---------------------------------------------------------------------------


class GNResult(NamedTuple):
    delta: Pose
    final: Pose                     # last_pose o delta
    final_energy: torch.Tensor
    last_group_iters: int           # accepted updates in the final group
    n_unstable: int                 # updated divergence counter
    rgb_weight: float               # updated weight (fallback clamp applied)
    host_syncs: int                 # device-to-host reads of the loop's exit flag


def gauss_newton(tcfg: TrackerConfig, map_cfg: M.MapConfig, packed: torch.Tensor,
                 cams: Dict[int, LevelCamera], state: M.MapState, last: Pose,
                 prev: Pyramid, cur: ProcessedFrame, rgb_weight: float,
                 n_unstable: int, init: Pose) -> GNResult:
    """Grouped GN schedule: per group, up to ``n`` updates plus a final
    evaluation-only pass, rejecting any step that raises the energy, with
    the ``xi_tol`` / ``energy_rel_tol`` early exits and the divergence
    fallback that clamps the RGB weight back up."""
    dev = last.R.device
    rgb_levels = sorted({int(term[1]) for _, terms in tcfg.iter_config
                         for term in terms if term[0] == "rgb"})
    strides = {lvl: tcfg.rgb_stride[min(lvl, len(tcfg.rgb_stride) - 1)]
               for lvl in rgb_levels}
    p = cur.pyramid
    cur_levels = {lvl: tuple(imgproc.subsample2d(a[lvl], strides[lvl])
                             for a in (p.intensity, p.depth, p.depth_ok,
                                       p.grad, p.grad_ok))
                  for lvl in rgb_levels}
    prev_texs = {lvl: imgproc.warp_texture(prev.intensity[lvl], prev.depth[lvl])
                 for lvl in rgb_levels}
    aug_table = M.latent_count_table(state)

    def eval_Hg(delta: Pose, terms):
        H = torch.zeros(6, 6, device=dev)
        g = torch.zeros(6, device=dev)
        E = torch.zeros((), device=dev)
        for term in terms:
            if term[0] == "sdf":
                tH, tg, tE = _sdf_term(map_cfg, packed, state, last, delta,
                                       cur.pts_cam, cur.pc_mask,
                                       tcfg.sdf_robust_kernel, tcfg.sdf_robust_k,
                                       aug_table)
            elif term[0] == "rgb":
                lvl = int(term[1])
                tH, tg, tE = _rgb_term(tcfg, cams[lvl], strides[lvl],
                                       prev_texs[lvl], cur_levels[lvl], delta,
                                       rgb_weight)
            else:
                raise ValueError(f"unknown GN term {term!r}")
            H, g, E = H + tH, g + tg, E + tE
        return H, g, E

    delta = init
    energy = torch.full((), float("inf"), device=dev)
    n_accept_last = 0
    syncs = 0
    xi_zero = torch.zeros(6, device=dev)
    for group_idx, (n, terms) in enumerate(tcfg.iter_config):
        dR, dt = delta
        bR, bt, bE = dR, dt, torch.full((), float("inf"), device=dev)
        i = 0
        while True:
            H, g, E = eval_Hg(Pose(dR, dt), terms)
            worse = E > bE
            accept = ~worse
            stalled = (bE - E) < tcfg.energy_rel_tol * torch.abs(E)
            bR = torch.where(accept, dR, bR)
            bt = torch.where(accept, dt, bt)
            bE = torch.where(accept, E, bE)
            i += 1
            if i > n:                   # the evaluation-only final pass
                break
            xi = _solve_precond(H, g)
            xi_ok = torch.all(torch.isfinite(xi))
            upd = exp_twist(torch.where(xi_ok, xi, xi_zero))
            dR = torch.where(accept, upd.R @ dR, bR)
            dt = torch.where(accept, upd.R @ dt + upd.t, bt)
            converged = (torch.sum(xi * xi) < tcfg.xi_tol ** 2) | stalled
            syncs += 1
            if bool(worse | ~xi_ok | converged):
                break
        delta = Pose(bR, bt)
        energy = bE
        if group_idx == len(tcfg.iter_config) - 1:
            n_accept_last = max(i - 1, 0)

    n_unstable = n_unstable + int(n_accept_last >= 10)
    if n_unstable >= 3:
        rgb_weight = max(rgb_weight, 500.0)
    final = Pose(last.R @ delta.R, last.R @ delta.t + last.t)
    return GNResult(delta=delta, final=final, final_energy=energy,
                    last_group_iters=n_accept_last, n_unstable=n_unstable,
                    rgb_weight=rgb_weight, host_syncs=syncs)


# ---------------------------------------------------------------------------
# Host-side tracker (temporal state, divergence fallback)
# ---------------------------------------------------------------------------


class SDFTracker:
    """Holds the previous frame's pyramid, the pose history (on the
    device), and the ``n_unstable`` divergence fallback."""

    def __init__(self, map_cfg: M.MapConfig, tcfg: TrackerConfig,
                 decoder: Decoder, calib: Intrinsic, device: torch.device):
        check_supported(tcfg)
        self.map_cfg = map_cfg
        self.tcfg = tcfg
        self.calib = calib
        self.device = device
        self.packed = pack_fused_decoder(decoder)
        self.cams = {lvl: level_camera(tcfg, calib, lvl, device)
                     for lvl in range(tcfg.pyramid_levels)}
        self.poses: list = []
        self.last_pyramid: Optional[Pyramid] = None
        self.last_processed: Optional[ProcessedFrame] = None
        self.n_unstable = 0
        self.rgb_weight = float(tcfg.rgb_weight)
        self._identity = Pose.identity(device)
        self.n_host_syncs = 0

    @property
    def n_tracked(self) -> int:
        return len(self.poses)

    @property
    def last_pose(self) -> Optional[Pose]:
        return self.poses[-1] if self.poses else None

    @property
    def all_pd_pose(self) -> list:
        """Pose history as host Isometries (one transfer for all)."""
        if not self.poses:
            return []
        Rs = torch.stack([p.R for p in self.poses]).double().cpu().numpy()
        ts = torch.stack([p.t for p in self.poses]).double().cpu().numpy()
        return [Isometry.from_matrix(R, t, ortho=True) for R, t in zip(Rs, ts)]

    def track_camera_packed(self, state: M.MapState, packed: torch.Tensor,
                            w: int, set_pose: Optional[Isometry] = None) -> Pose:
        """Track one :func:`pack_frame` buffer (a uint8 tensor on the
        tracker's device).  ``set_pose`` fixes the pose instead (frame 0)."""
        processed = preprocess_packed(self.tcfg, self.calib, packed, w)
        if set_pose is not None:
            pose = Pose(torch.tensor(set_pose.q.rotation_matrix, dtype=torch.float32,
                                     device=self.device),
                        torch.tensor(set_pose.t, dtype=torch.float32,
                                     device=self.device))
        else:
            res = gauss_newton(self.tcfg, self.map_cfg, self.packed, self.cams,
                               state, self.last_pose, self.last_pyramid,
                               processed, self.rgb_weight, self.n_unstable,
                               self._identity)
            pose = res.final
            self.n_unstable = res.n_unstable
            self.rgb_weight = res.rgb_weight
            self.n_host_syncs += res.host_syncs
        self.last_pyramid = processed.pyramid
        self.last_processed = processed
        self.poses.append(pose)
        return pose

    def last_pc_world(self, pose: Pose
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """World-space (points, normals, mask) of the last processed frame."""
        p = self.last_processed
        return (p.pts_cam @ pose.R.T + pose.t, p.normals_cam @ pose.R.T,
                p.pc_mask)
