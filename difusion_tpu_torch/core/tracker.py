"""SDF + photometric camera tracker (counterpart of
difusion_tpu/core/tracker.py; its ``preprocess_and_track`` is
:class:`TrackProgram`).

Per frame: convert the camera's arrays (:func:`preprocess_frame`,
:meth:`SDFTracker.track_camera`) or unpack the byte-plane frame, build a
3-level intensity/depth pyramid, subsample and unproject the depth, reduce
a (2w+1)^2 window per pixel for radius-outlier counts and PCA normals
(kernel 2, ``ops/stencil.py``), voxel-filter the point cloud to the point budget, then
run the grouped Gauss-Newton schedule over se(3): an SDF term (decoder
forward + d sdf/d xyz in one kernel, kernel 1, ``ops/decoder_fused.py``, in
f32 or, under ``sdf_compute_dtype="bfloat16"``, in its bf16 mode; for an
decoder conditioned once a code (``onet_cbn``, ``pigan_film``) its
instance reading each point's voxel's row of the conditioning table
:class:`CondTable`; or with ``sdf_fused="off"``
autograd through ``Decoder.decode``) and a photometric
term (the per-pixel bilinear warp, the block-tiled warp of
``warp_tiled=True`` or the round-to-nearest warp of ``rgb_bilinear=False``),
a Jacobi-preconditioned 6x6 solve and energy rejection.  ``solve_dtype``
``compensated`` / ``blocked`` accumulate each term's normal equations as one order-robust Gram
of ``[J | r]`` (``ops/compsum.py``), and ``compensated`` adds one
iterative-refinement step to the solve; ``perturb_points`` permutes the SDF
points by a fixed permutation (a test that the sums do not depend on order).
The map is the dense one (``core/map.py``) or the hash-indexed one
(``core/hash_map.py``), chosen by the type of its configuration.

One iteration is :func:`gn_step`, a masked step on a carry of tensors: once
the carry's ``done`` is set, a further step changes nothing.  One loop runs
it: :class:`TrackProgram`, the counterpart of the JAX package's
one-dispatch ``preprocess_and_track``, runs preprocessing, every group's
loop and the commit of the result as one
:class:`~..utils.cudagraph.GraphProgram`.  Every tracked frame, on the
chunked and the per-frame path, runs as that program.  Captured (on the
card, by default) a frame is one graph launch whose loops end on the
device, and the host reads no exit flag.  Uncaptured (on the CPU, and
``driver="host"`` of :meth:`SDFTracker.track_camera_packed` on the card,
where the profiler sees every pass of the loops) the same segments run one
by one and the host reads ``done`` after every pass (each read makes the
host wait for the device; ``SDFTracker.n_host_syncs`` counts them).
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.decoder import Decoder, is_conditioned
from ..ops import compsum, imgproc
from ..ops.decoder_fused import (CondPack, condition, decode_grad_cond, decode_grad_fused,
                                 pack_fused_decoder, supports_spec)
from ..ops.imgproc import Intrinsic, Pyramid
from ..ops.pcproc import point_box_filter
from ..ops.se3 import Pose, exp_twist
from ..ops.stencil import window_stat_sums_map
from ..utils import tracing
from ..utils.cudagraph import GraphProgram
from ..utils.motion import Isometry
from . import hash_map as HM
from . import map as M


def _stride_tuple(v, n_levels: int = 3) -> Tuple[int, ...]:
    """Broadcast an int stride to a per-pyramid-level tuple."""
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n_levels


class TrackerConfig(NamedTuple):
    """Tracker configuration: the JAX package's fields and defaults, except
    two routes the port takes by default -- ``warp_tiled=False`` (the
    per-pixel bilinear warp; the JAX block-tiled warp is a TPU layout device
    that is bit-exact per kept pixel, tracker.py:94-105) and
    ``sdf_fused="on"`` (the fused decoder-gradient kernel; the JAX default
    XLA forward+vjp computes the same function).  Keeping them keeps the
    card's measurements of the earlier routes comparable; the JAX defaults
    run as well (``warp_tiled=True``, ``sdf_fused="off"`` or ``"auto"``:
    on for CUDA tensors).  ``sdf_gather_cache`` is accepted and gathers
    every step: the JAX cache reuses the last step's rows only where no
    point changed cell, so it gives the same values, and skipping the gather
    needs a branch that a captured graph does not take (a select that
    gathers anyway was slower on the card).  Values outside the JAX
    package's raise ``NotImplementedError`` in :class:`SDFTracker`."""
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


_SUPPORTED = {"warp_tiled": (False, True), "warp_texture_bf16": (False, True),
              "sdf_fused": ("on", "off", "auto"),
              "solve_dtype": ("f32", "compensated", "blocked"),
              "sdf_compute_dtype": ("float32", "bfloat16"),
              "rgb_bilinear": (True, False), "sdf_gather_cache": (False, True),
              "motion_prior": ("none", "constant_velocity")}


def check_supported(tcfg: TrackerConfig) -> None:
    """Raise NotImplementedError on a configuration value the port lacks:
    one outside the JAX package's documented values."""
    for field, ok in _SUPPORTED.items():
        if getattr(tcfg, field) not in ok:
            raise NotImplementedError(
                f"TrackerConfig.{field}={getattr(tcfg, field)!r} is not "
                f"implemented by the PyTorch port (supported: {ok})")
    if not (isinstance(tcfg.gn_unroll, int) and tcfg.gn_unroll >= 1):
        raise NotImplementedError(
            f"TrackerConfig.gn_unroll={tcfg.gn_unroll!r} is not implemented by "
            "the PyTorch port (supported: an int >= 1)")


def resolve_sdf_fused(tcfg: TrackerConfig, spec, device, hash_map: bool = False) -> bool:
    """Whether the SDF term runs the fused kernel: ``"on"`` (raises on a
    decoder the kernel does not take), ``"off"``, or ``"auto"``: on for a
    CUDA device when the kernel takes the decoder (the JAX package's rule
    for its TPU, tracker.py:162-174).  A decoder conditioned once a code
    takes it on the dense map only (``hash_map``: its slot lookup is not
    written)."""
    on_hash = hash_map and is_conditioned(spec)
    takes = supports_spec(spec, device) and not on_hash
    if tcfg.sdf_fused == "off":
        return False
    if tcfg.sdf_fused == "on":
        if not takes:
            raise ValueError(f"sdf_fused='on' but {spec} is unsupported"
                             + (f" on the hash map (its slot lookup for {spec.NAME} "
                                "is not written)" if on_hash else ""))
        return True
    return takes and torch.device(device).type == "cuda"


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


def _upload(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:         # torch.from_numpy shares the buffer
        a = a.copy()
    if a.dtype == np.uint16:
        # torch's uint16 has few kernels: carry the bits as int16, widen there
        return torch.from_numpy(a.view(np.int16)).to(device).to(torch.int32) & 0xFFFF
    return torch.from_numpy(a).to(device)


def sensor_frame(rgb, depth, dcam_scale: float, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A camera's frame -> (rgb (H, W, 3) f32 in [0, 1], metric depth (H, W)
    f32) on ``device``.  ``rgb``: uint8, or float in [0, 1]; ``depth``: an
    integer type in sensor units (uint16), or float metres; numpy arrays or
    tensors.  Integers are scaled by multiplying with 1/255 and
    1/``dcam_scale`` in f32, as the JAX package's jitted
    ``preprocess_frame`` does (XLA turns its divide into that multiply)."""
    rgb, depth = _upload(rgb, device), _upload(depth, device)
    if rgb.dtype == torch.uint8:
        rgb = rgb.to(torch.float32) * (1.0 / 255.0)
    if not depth.is_floating_point():
        depth = depth.to(torch.float32) * (1.0 / dcam_scale)
    return rgb.to(torch.float32), depth.to(torch.float32)


def pack_lossless(rgb: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """f32 rgb (H, W, 3) and depth (H, W) -> the (H, 16W) uint8 byte planes
    that ``pack_frame(..., lossless=True)`` makes of them, on their device:
    plane ``4c + k`` is byte k (little-endian) of rgb channel c, plane
    ``12 + k`` byte k of depth."""
    h, w = depth.shape
    rgb_b = rgb.contiguous().view(torch.uint8).reshape(h, w, 3, 4).permute(0, 2, 3, 1)
    d_b = depth.contiguous().view(torch.uint8).reshape(h, w, 4).permute(0, 2, 1)
    return torch.cat([rgb_b.reshape(h, 12 * w), d_b.reshape(h, 4 * w)], dim=1)


def preprocess_frame(tcfg: TrackerConfig, calib: Intrinsic, rgb, depth,
                     device="cuda") -> ProcessedFrame:
    """Pyramid and box-filtered point cloud of a camera's frame (see
    :func:`sensor_frame` for the inputs), computed on ``device`` through the
    converted arrays' lossless byte planes: what :meth:`SDFTracker.track_camera`
    tracks, and on float inputs :func:`preprocess_packed` of
    ``pack_frame(rgb, depth, lossless=True)`` bit for bit."""
    rgb, depth = sensor_frame(rgb, depth, calib.dcam_scale, resolve_device(device))
    return preprocess_packed(tcfg, calib, pack_lossless(rgb, depth), depth.shape[1])


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
                      scale, gram_mode: str = "f32"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """H, g, E of weighted residuals; under ``compensated`` / ``blocked``
    all three from one order-robust Gram of ``[J | r]``."""
    if gram_mode != "f32":
        Mm = compsum.gram(torch.cat([J, r[:, None]], dim=1), w, scale, gram_mode)
        return Mm[:6, :6], Mm[:6, 6], Mm[6, 6]
    H = (J * w[:, None]).T @ J * scale
    g = torch.sum(J * (w * r)[:, None], dim=0) * scale
    return H, g, torch.sum(w * r * r) * scale


def _sdf_term(map_cfg: M.MapConfig, packed, state: M.MapState,
              last: Pose, delta: Pose, pts: torch.Tensor, mask: torch.Tensor,
              robust_kernel: str, robust_k: float, aug_table: torch.Tensor,
              gram_mode: str = "f32", decoder: Optional[Decoder] = None,
              compute_dtype: torch.dtype = torch.float32,
              cond: Optional[torch.Tensor] = None):
    """SDF residual r = sdf(last o delta y)/std with Jacobian [G | y x G].

    With a ``packed`` decoder, through the fused decode + position-gradient
    kernel in the pack's mode (f32 or bf16): the chain factors
    ``d rel/d x = 1/voxel_size`` and ``d x/d y = R_last`` turn the kernel's
    d sdf/d rel into dr/dy (std is held constant, as the JAX vjp route
    stop-gradients it).  A conditioned family's pack (:class:`CondPack`)
    gathers each point's voxel slot, whose row of ``cond``
    (:class:`CondTable`) the kernel reads, in place of its latent.  With ``packed=None``
    (``sdf_fused`` off), the JAX
    package's vjp route (tracker.py:209-235): autograd of
    ``sdf / std.detach()`` with respect to the points through
    ``decoder.decode(..., compute_dtype)``, the latent held constant."""
    y = delta.apply(pts)
    if isinstance(packed, CondPack):
        x = last.apply(y)
        slot, rel, valid = M.gather_slot_rel(map_cfg, state, x, aug_table)
        sdf, std, grel = decode_grad_cond(packed, cond, slot, rel.contiguous())
        r = sdf / std
        G = (grel / (std[:, None] * map_cfg.voxel_size)) @ last.R
    elif packed is not None:
        x = last.apply(y)
        latent, rel, valid = HM.map_module(map_cfg).gather_latent_rel(
            map_cfg, state, x, aug_table)
        sdf, std, grel = decode_grad_fused(packed, latent.contiguous(),
                                           rel.contiguous())
        r = sdf / std
        G = (grel / (std[:, None] * map_cfg.voxel_size)) @ last.R
    else:
        with torch.enable_grad():
            yg = y.detach().requires_grad_(True)
            x = last.apply(yg)
            latent, rel, valid = HM.map_module(map_cfg).gather_latent_rel(
                map_cfg, state, x, aug_table)
            sdf, std = decoder.decode(latent.detach(), rel, compute_dtype=compute_dtype)
            r = sdf / std.detach()
            G, = torch.autograd.grad(r, yg, grad_outputs=torch.ones_like(r))
        r = r.detach()
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    ok = mask & valid
    r = torch.where(ok, r, zero)
    G = torch.where(ok[:, None], G, zero)
    J = torch.cat([G, torch.cross(y, G, dim=-1)], dim=-1)       # (N, 6)
    w = torch.where(ok, _robust_weight(r, robust_kernel, robust_k), zero)
    scale = 1.0 / torch.clamp(ok.sum(), min=1).to(r.dtype)
    return _normal_equations(J, r, w, scale, gram_mode)


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
              rgb_weight: torch.Tensor, gram_mode: str = "f32",
              kind: str = "packed", dcam_scale: float = 0.0):
    """Photometric residual over one pyramid level: the current level's
    (strided) pixels warped into the previous frame's texture.  ``kind``
    names the texture (:func:`gn_prepare`): ``"packed"`` the per-pixel
    bilinear warp, ``"nearest"`` the round-to-nearest one, ``"tiled"`` the
    block-tiled warp over ``cur_level``'s parity planes, whose normal
    equations reduce over the (7, 4, H2, W2) layout (JAX
    tracker.py:316-352: ``blocked`` one partial per image row, combined by
    :func:`~..ops.compsum.pairwise_compensated_sum`)."""
    krkinv = cam.K @ delta.R @ cam.Kinv
    kt = cam.K @ delta.t
    if kind == "tiled":
        f3, J3, ok3 = imgproc.rgb_odometry_tiled(
            cur_level, prev_tex, cam.intr, krkinv, kt, tcfg.min_grad_scale,
            tcfg.max_depth_delta, dcam_scale=dcam_scale)
        zero = torch.zeros((), dtype=f3.dtype, device=f3.device)
        w = torch.where(ok3, _robust_weight(f3, tcfg.rgb_robust_kernel,
                                            tcfg.rgb_robust_k), zero)
        scale = rgb_weight / torch.clamp(ok3.sum(), min=1).to(f3.dtype)
        r7 = torch.cat([J3, f3[None]], dim=0)                  # (7, 4, H2, W2)
        if gram_mode == "blocked":
            partials = torch.einsum("aphw,bphw->hab", r7 * w[None], r7)
            Mm = compsum.pairwise_compensated_sum(
                partials.reshape(partials.shape[0], 49), dim=0).reshape(7, 7) * scale
        elif gram_mode != "f32":
            Mm = compsum.gram(r7.reshape(7, -1).T, w.reshape(-1), scale, gram_mode)
        else:
            Mm = torch.einsum("aphw,bphw->ab", r7 * w[None], r7) * scale
        return Mm[:6, :6], Mm[:6, 6], Mm[6, 6]
    c_int, c_depth, c_ok, c_grad, c_gok = cur_level
    f, J, ok = imgproc.rgb_odometry(
        prev_tex, c_int, c_depth, c_ok, c_grad, c_gok, cam.intr, krkinv, kt,
        tcfg.min_grad_scale, tcfg.max_depth_delta, coord_stride=stride,
        bilinear=kind != "nearest")
    f, J, ok = f.reshape(-1), J.reshape(-1, 6), ok.reshape(-1)
    w = torch.where(ok, _robust_weight(f, tcfg.rgb_robust_kernel,
                                       tcfg.rgb_robust_k),
                    torch.zeros((), dtype=f.dtype, device=f.device))
    scale = rgb_weight / torch.clamp(ok.sum(), min=1).to(f.dtype)
    return _normal_equations(J, f, w, scale, gram_mode)


def _solve_precond(H: torch.Tensor, g: torch.Tensor,
                   refine: bool = False) -> torch.Tensor:
    """Jacobi-preconditioned 6x6 solve in f32.  ``solve_ex`` does not check
    for singularity on the host, so it costs no sync; a singular system
    gives a non-finite step, which the caller rejects.  ``refine`` (the
    ``compensated`` mode) adds one iterative-refinement step: the residual
    in the preconditioned frame and a second solve."""
    d = torch.sqrt(torch.abs(torch.diagonal(H)) + 1e-12)
    Hr = H / (d[:, None] * d[None, :]) + 1e-9 * torch.eye(6, dtype=H.dtype,
                                                          device=H.device)
    b = -g / d
    xi, _ = torch.linalg.solve_ex(Hr, b)
    if refine:
        xi = xi + torch.linalg.solve_ex(Hr, b - Hr @ xi)[0]
    return xi / d


# ---------------------------------------------------------------------------
# Gauss-Newton: one masked step
# ---------------------------------------------------------------------------


class GNInputs(NamedTuple):
    """What the GN loop reads and no iteration changes, made once a frame."""
    cur_levels: Dict[int, tuple]      # level -> strided (int, depth, ok, grad, gok),
    prev_texs: Dict[int, torch.Tensor]  # or a tiled level's parity planes
    aug_table: torch.Tensor
    sdf_pts: torch.Tensor             # the SDF term's points and mask, in the
    sdf_mask: torch.Tensor            # order perturb_points gives them
    tex_kinds: Optional[Dict[int, str]] = None   # level -> _rgb_term's kind
    dcam_scale: float = 0.0           # the quantized tiled texture's taps


class GNProblem(NamedTuple):
    """One frame's tracking problem.  ``packed`` is None where the SDF term
    runs autograd through ``decoder`` (``sdf_fused`` off)."""
    tcfg: TrackerConfig
    map_cfg: M.MapConfig
    packed: Optional[torch.Tensor]    # the fused decoder's packed weights
    cams: Dict[int, LevelCamera]
    state: M.MapState
    last: Pose
    cur: ProcessedFrame
    inputs: GNInputs
    rgb_weight: torch.Tensor
    packed_bf16: Optional[torch.Tensor] = None   # the bf16 mode's pack
    decoder: Optional[Decoder] = None
    cond: Optional[torch.Tensor] = None   # a conditioned pack's table (CondTable)


class GNCarry(NamedTuple):
    """The loop carry of one group (the JAX ``body``'s)."""
    i: torch.Tensor       # () int32 evaluations made
    dR: torch.Tensor      # the delta to evaluate next
    dt: torch.Tensor
    bR: torch.Tensor      # the best delta so far and its energy
    bt: torch.Tensor
    bE: torch.Tensor
    done: torch.Tensor    # () bool


def _rgb_stride(tcfg: TrackerConfig, lvl: int) -> int:
    return tcfg.rgb_stride[min(lvl, len(tcfg.rgb_stride) - 1)]


@lru_cache(maxsize=16)
def point_permutation(seed: int, n: int, device) -> torch.Tensor:
    """``perturb_points``' fixed permutation of ``n`` points, drawn from
    ``seed`` by numpy (the JAX package draws its own from ``jax.random``;
    any fixed permutation is the same test)."""
    return torch.from_numpy(np.random.default_rng(seed).permutation(n)).to(device)


def _level_tiled(tcfg: TrackerConfig, level: int, shape) -> bool:
    """Whether a pyramid level's photometric term runs the block-tiled warp:
    opted in, bilinear, stride 1 and even dims (JAX tracker.py:261-269)."""
    h, w = shape
    return (tcfg.warp_tiled and tcfg.rgb_bilinear and _rgb_stride(tcfg, level) == 1
            and h % 2 == 0 and w % 2 == 0)


def gn_prepare(tcfg: TrackerConfig, state, prev: Pyramid, cur: ProcessedFrame,
               dcam_scale: float = 0.0) -> GNInputs:
    """Per RGB level the current-frame inputs (the strided subsample, or a
    tiled level's parity planes) and the previous frame's warp texture with
    its kind (JAX ``_rgb_level_inputs`` and ``_tex``, tracker.py:272-289,
    :440-461: the bf16 sensor-grid texture only at L0 under
    ``warp_texture_bf16`` and not ``lossless_packing``, which needs the
    calibration's ``dcam_scale``), the latent + count table, and the SDF
    points (permuted by :func:`point_permutation` where ``perturb_points``
    is set)."""
    rgb_levels = sorted({int(term[1]) for _, terms in tcfg.iter_config
                         for term in terms if term[0] == "rgb"})
    p = cur.pyramid
    cur_levels, prev_texs, kinds = {}, {}, {}
    for lvl in rgb_levels:
        if _level_tiled(tcfg, lvl, p.intensity[lvl].shape):
            cur_levels[lvl] = imgproc.make_tiled_frame_planes(
                p.intensity[lvl], p.depth[lvl], p.depth_ok[lvl], p.grad[lvl],
                p.grad_ok[lvl])
            kinds[lvl] = "tiled"
            if lvl == 0 and tcfg.warp_texture_bf16 and not tcfg.lossless_packing:
                prev_texs[lvl] = imgproc.warp_texture_tiled_quantized(
                    prev.intensity[lvl], prev.depth[lvl], dcam_scale)
            else:
                prev_texs[lvl] = imgproc.warp_texture_tiled(prev.intensity[lvl],
                                                            prev.depth[lvl])
            continue
        cur_levels[lvl] = tuple(imgproc.subsample2d(a[lvl], _rgb_stride(tcfg, lvl))
                                for a in (p.intensity, p.depth, p.depth_ok,
                                          p.grad, p.grad_ok))
        if tcfg.rgb_bilinear:
            kinds[lvl] = "packed"
            prev_texs[lvl] = imgproc.warp_texture(prev.intensity[lvl], prev.depth[lvl])
        else:
            kinds[lvl] = "nearest"
            prev_texs[lvl] = torch.stack([prev.intensity[lvl], prev.depth[lvl]], dim=-1)
    pts, mask = cur.pts_cam, cur.pc_mask
    if tcfg.perturb_points:
        perm = point_permutation(tcfg.perturb_points, pts.shape[0], pts.device)
        pts, mask = pts[perm], mask[perm]
    return GNInputs(cur_levels, prev_texs, M.latent_count_table(state), pts, mask,
                    kinds, dcam_scale)


def _eval_Hg(p: GNProblem, delta: Pose, terms, is_last_group: bool = False):
    """H, g, E of a group's terms at ``delta``.  The SDF term runs in bf16
    where ``sdf_compute_dtype`` asks for it, except in the last group under
    ``sdf_f32_last_group``."""
    dev = delta.R.device
    tcfg = p.tcfg
    H = torch.zeros(6, 6, device=dev)
    g = torch.zeros(6, device=dev)
    E = torch.zeros((), device=dev)
    bf16 = (tcfg.sdf_compute_dtype == "bfloat16"
            and not (is_last_group and tcfg.sdf_f32_last_group))
    kinds = p.inputs.tex_kinds or {}
    for term in terms:
        if term[0] == "sdf":
            packed = p.packed
            if bf16 and packed is not None:
                packed = p.packed_bf16
                if packed is None:
                    raise ValueError("sdf_compute_dtype bfloat16 needs the bf16 pack")
            tH, tg, tE = _sdf_term(p.map_cfg, packed, p.state, p.last, delta,
                            p.inputs.sdf_pts, p.inputs.sdf_mask,
                            tcfg.sdf_robust_kernel, tcfg.sdf_robust_k,
                            p.inputs.aug_table, tcfg.solve_dtype, decoder=p.decoder,
                            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                            cond=p.cond)
        elif term[0] == "rgb":
            lvl = int(term[1])
            tH, tg, tE = _rgb_term(tcfg, p.cams[lvl], _rgb_stride(tcfg, lvl),
                                   p.inputs.prev_texs[lvl],
                                   p.inputs.cur_levels[lvl], delta, p.rgb_weight,
                                   tcfg.solve_dtype, kinds.get(lvl, "packed"),
                                   p.inputs.dcam_scale)
        else:
            raise ValueError(f"unknown GN term {term!r}")
        H, g, E = H + tH, g + tg, E + tE
    return H, g, E


def gn_group_init(delta: Pose) -> GNCarry:
    dev = delta.R.device
    return GNCarry(i=torch.zeros((), dtype=torch.int32, device=dev),
                   dR=delta.R, dt=delta.t, bR=delta.R, bt=delta.t,
                   bE=torch.full((), float("inf"), device=dev),
                   done=torch.zeros((), dtype=torch.bool, device=dev))


def gn_step(p: GNProblem, n: int, terms, c: GNCarry,
            is_last_group: bool = False) -> GNCarry:
    """One iteration of a group of ``n`` updates: evaluate the terms at the
    carry's delta, keep it if the energy did not rise, and step from it.  The
    (n+1)-th evaluation only judges the last step.  ``done`` is set by a
    rejected step, the last evaluation, a non-finite solve or convergence
    (``xi_tol`` / ``energy_rel_tol``); a step on a carry that is done returns
    it unchanged, so a caller may run more steps than the group needs (as
    ``gn_unroll`` does).  ``is_last_group``: the schedule's last group, which
    ``sdf_f32_last_group`` keeps in f32."""
    tcfg = p.tcfg
    H, g, E = _eval_Hg(p, Pose(c.dR, c.dt), terms, is_last_group)
    worse = E > c.bE
    accept = ~worse
    stalled = (c.bE - E) < tcfg.energy_rel_tol * torch.abs(E)
    bR = torch.where(accept, c.dR, c.bR)
    bt = torch.where(accept, c.dt, c.bt)
    bE = torch.where(accept, E, c.bE)
    xi = _solve_precond(H, g, refine=tcfg.solve_dtype != "f32")
    xi_ok = torch.all(torch.isfinite(xi))
    upd = exp_twist(torch.where(xi_ok, xi, torch.zeros_like(xi)))
    is_last = c.i == n
    step = accept & ~is_last
    dR = torch.where(step, upd.R @ c.dR, bR)
    dt = torch.where(step, upd.R @ c.dt + upd.t, bt)
    converged = (torch.sum(xi * xi) < tcfg.xi_tol ** 2) | stalled
    new = GNCarry(c.i + 1, dR, dt, bR, bt, bE,
                  worse | is_last | ~xi_ok | converged)
    return GNCarry(*(torch.where(c.done, old, nxt) for old, nxt in zip(c, new)))


# ---------------------------------------------------------------------------
# One tracked frame as one graph launch
# ---------------------------------------------------------------------------


def _tensors(nested) -> List[torch.Tensor]:
    """The tensors of nested tuples, in order."""
    if isinstance(nested, torch.Tensor):
        return [nested]
    return [t for item in nested for t in _tensors(item)]


class TrackProgram:
    """``preprocess_and_track`` for one frame shape: unpack + preprocess +
    the GN groups + the commit of the result, as one
    :class:`~..utils.cudagraph.GraphProgram` over tensors this object owns.

    Inputs, written by :meth:`load`, :meth:`load_state` and
    :meth:`preprocess_and_track`: the packed frame, what tracking reads of
    the map (its module's ``TRACKED_FIELDS``: the dense ``indexer``, or the
    hash ``keys`` and ``table_slot``; ``latents`` and ``obs_count``), the last
    pose and delta, the previous frame's pyramid, ``rgb_weight`` and
    ``n_unstable``.  Every frame advances
    the temporal ones in place.  Outputs, rewritten by every frame (copy what
    must outlive the next one): ``out`` ((13,): R row-major, t, the final
    energy), ``cur`` (the frame's :class:`ProcessedFrame`), ``world`` (its
    point cloud under the tracked pose: points, normals, mask).

    ``captured``: whether the program is captured on the card (see
    :meth:`SDFTracker.program`); uncaptured, its segments run one by one."""

    def __init__(self, tracker: "SDFTracker", packed_shape: Tuple[int, int], w: int,
                 captured: bool):
        self.tr = tracker
        self.captured = captured
        self.w = w
        dev = tracker.device
        self.packed = torch.zeros(packed_shape, dtype=torch.uint8, device=dev)
        cfg = tracker.map_cfg
        self.state = HM.map_module(cfg).create_state(cfg, dev)
        self._loaded: Tuple[torch.Tensor, ...] = ()
        self.last = Pose.identity(dev)
        self.delta = Pose.identity(dev)
        self.rgb_weight = torch.zeros((), device=dev)
        self.n_unstable = torch.zeros((), dtype=torch.int32, device=dev)
        self.prev: Optional[Pyramid] = None
        self.carry = GNCarry(*(t.clone() for t in gn_group_init(self.delta)))
        self.out = torch.zeros(13, device=dev)
        self.cur: Optional[ProcessedFrame] = None
        self.world: Optional[Tuple[torch.Tensor, ...]] = None
        self._problem: Optional[GNProblem] = None
        self.program: Optional[GraphProgram] = None

    def load_state(self, state) -> None:
        """Copy in what tracking reads of the map, unless the program holds
        these very tensors already (a fusion makes new ones; a mesh extract
        keeps them), and bring a conditioning table up to the state's
        latents."""
        if self.tr.cond is not None:
            self.tr.cond.refresh(state.latents)
        fields = HM.map_module(self.tr.map_cfg).TRACKED_FIELDS
        src = tuple(getattr(state, f) for f in fields)
        if len(src) == len(self._loaded) and all(
                a is b for a, b in zip(src, self._loaded)):
            return
        for f, t in zip(fields, src):
            getattr(self.state, f).copy_(t)
        self._loaded = src

    def load(self) -> None:
        """Copy in the tracker's temporal state."""
        tr = self.tr
        if self.prev is None:
            self.prev = Pyramid(*(tuple(torch.empty_like(t) for t in level)
                                  for level in tr.last_pyramid))
        for dst, src in zip(_tensors((self.last, self.delta, self.prev)),
                            _tensors((tr.last_pose, tr.last_delta, tr.last_pyramid))):
            dst.copy_(src)
        self.rgb_weight.copy_(tr.rgb_weight)
        self.n_unstable.copy_(tr.n_unstable)

    def preprocess_and_track(self, packed: torch.Tensor) -> None:
        """Track one :func:`pack_frame` buffer (on the device) from the
        loaded state, and advance it.  The first call builds the program
        (captured: captures it, on this frame)."""
        self.packed.copy_(packed)
        if self.program is None:
            self._build()
        reads = self.program.n_flag_reads
        self.program.run()
        self.tr.n_host_syncs += self.program.n_flag_reads - reads

    # -- the stages -----------------------------------------------------------

    def _set_carry(self, new: GNCarry) -> None:
        for dst, src in zip(self.carry, new):
            dst.copy_(src)

    def _pre(self) -> None:
        tr = self.tr
        self.cur = preprocess_packed(tr.tcfg, tr.calib, self.packed, self.w)
        self._problem = GNProblem(
            tr.tcfg, tr.map_cfg, tr.packed, tr.cams, self.state, self.last, self.cur,
            gn_prepare(tr.tcfg, self.state, self.prev, self.cur, tr.calib.dcam_scale),
            self.rgb_weight, tr.packed_bf16, tr.decoder,
            tr.cond.table if tr.cond is not None else None)
        init = (self.delta if tr.tcfg.motion_prior == "constant_velocity"
                else tr._identity)
        self._set_carry(gn_group_init(init))

    def _next_group(self) -> None:
        self._set_carry(gn_group_init(Pose(self.carry.bR, self.carry.bt)))

    def _step(self, n: int, terms, is_last_group: bool) -> None:
        """One pass of a group's loop: ``gn_unroll`` masked steps."""
        for _ in range(self.tr.tcfg.gn_unroll):
            self._set_carry(gn_step(self._problem, n, terms, self.carry, is_last_group))

    def _finish(self) -> None:
        """Commit the last group's carry: the pose (last o delta), the
        divergence fallback that clamps the RGB weight back up, and the
        temporal state."""
        c, last = self.carry, self.last
        n_accept = torch.clamp(c.i - 1, min=0)        # evaluations - 1 = updates
        n_unstable = self.n_unstable + (n_accept >= 10).to(self.n_unstable.dtype)
        rgb_weight = torch.where(n_unstable >= 3, torch.clamp(self.rgb_weight, min=500.0),
                                 self.rgb_weight)
        final = Pose(last.R @ c.bR, last.R @ c.bt + last.t)
        self.world = world_points(self.cur, final)
        self.out.copy_(torch.cat([final.R.reshape(-1), final.t, c.bE.reshape(1)]))
        for dst, src in zip(
                _tensors((self.last, self.delta, self.prev)) + [self.rgb_weight,
                                                                 self.n_unstable],
                _tensors((final, Pose(c.bR, c.bt), self.cur.pyramid)) + [rgb_weight,
                                                                         n_unstable]):
            dst.copy_(src)

    def _build(self) -> None:
        prog = GraphProgram(self.tr.device, capture=self.captured)
        prog.add(self._pre, name="pre")
        groups = self.tr.tcfg.iter_config
        for gi, (n, terms) in enumerate(groups):
            prog.add(self._next_group, name=f"group{gi}.init")
            prog.add(partial(self._step, n, terms, gi == len(groups) - 1),
                     done=self.carry.done, name=f"group{gi}.gn")
        prog.add(self._finish, name="finish")
        prog.build(keep=_tensors((self.last, self.delta, self.prev))
                   + [self.rgb_weight, self.n_unstable])
        self.program = prog


def world_points(p: ProcessedFrame, pose: Pose
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World-space (points, normals, mask) of a processed frame."""
    return p.pts_cam @ pose.R.T + pose.t, p.normals_cam @ pose.R.T, p.pc_mask


class CondTable:
    """The conditioning of every map slot's latent for a conditioned pack:
    ``table`` (capacity, *row shape), one fixed tensor that the captured
    programs read (onet_cbn's (NC, 2, H) CBN rows, pigan_film's (NL, 2, H)
    FiLM rows).  :meth:`refresh` brings it up to a state's latents: it
    conditions the slots whose latent differs from the one their row was
    made from (a fusion's touched slots, an optimizer's result, a loaded
    map), with no host read: the changed slots compact on the device and
    the family's conditioning kernel (``cbn_cond_kernel``,
    ``film_map_kernel``) reads their count there.  Its span is
    ``map.cond``; :meth:`cond_rows` counts the rows conditioned since it
    was built."""

    def __init__(self, pack: CondPack, capacity: int, device):
        lay = pack.layout
        self.pack = pack
        zero = condition(pack, torch.zeros(1, lay.L, device=device))
        self.table = zero.expand(capacity, -1, -1, -1).contiguous()
        self.latents = torch.zeros(capacity, lay.L, device=device)
        self._iota = torch.arange(capacity, dtype=torch.int32, device=device)
        self._rows = torch.zeros((), dtype=torch.int64, device=device)
        self._src: Optional[torch.Tensor] = None

    def refresh(self, latents: torch.Tensor) -> None:
        """Condition the slots whose latent changed (nothing for the
        latents tensor of the last call)."""
        if latents is self._src:
            return
        s = tracing.begin("map.cond") if tracing.ON else -1
        cap = self.latents.shape[0]
        changed = (latents != self.latents).any(dim=1)
        count = changed.sum(dtype=torch.int32)
        pos = torch.cumsum(changed, 0, dtype=torch.int32) - 1
        rows = torch.zeros(cap + 1, dtype=torch.int32, device=latents.device).scatter_(
            0, torch.where(changed, pos, cap).long(), self._iota)[:cap]
        condition(self.pack, latents.contiguous(), rows, count, out=self.table)
        self.latents.copy_(latents)
        self._rows += count
        self._src = latents
        if s >= 0:
            tracing.end(s)

    def cond_rows(self) -> int:
        """Rows conditioned since the table was built (reads the device)."""
        return int(self._rows)


# ---------------------------------------------------------------------------
# Host-side tracker (temporal state, divergence fallback)
# ---------------------------------------------------------------------------


class SDFTracker:
    """Holds the previous frame's pyramid, the pose history and the
    ``n_unstable`` divergence fallback, all on the device.  Poses are kept
    as stacked chunks ((K, 3, 3), (K, 3)), one per commit, and become
    :class:`Isometry` only on export (:attr:`all_pd_pose`, :meth:`pose_at`).

    ``n_host_syncs`` counts the exit flags of the GN loops that the host
    waited for: one a pass of an uncaptured :class:`TrackProgram`, none for
    a captured one."""

    def __init__(self, map_cfg: M.MapConfig, tcfg: TrackerConfig,
                 decoder: Decoder, calib: Intrinsic, device: torch.device):
        check_supported(tcfg)
        device = resolve_device(device)
        self.map_cfg = map_cfg
        self.tcfg = tcfg
        self.calib = calib
        self.device = device
        self.decoder = decoder
        # the SDF term's route: the fused kernel over the packed weights (in
        # bf16 too where sdf_compute_dtype asks for it), or autograd
        # through the decoder (packed None)
        self.sdf_fused = resolve_sdf_fused(tcfg, decoder.spec, device,
                                           hash_map=HM.map_module(map_cfg) is HM)
        self.packed = pack_fused_decoder(decoder) if self.sdf_fused else None
        self.packed_bf16 = (pack_fused_decoder(decoder, torch.bfloat16)
                            if self.sdf_fused and tcfg.sdf_compute_dtype == "bfloat16"
                            else None)
        # a conditioned family's kernel 1 reads each map slot's conditioning
        # from a table that follows the map's latents (refreshed where the
        # map changes)
        self.cond = (CondTable(self.packed, map_cfg.capacity, device)
                     if isinstance(self.packed, CondPack) else None)
        self.cams = {lvl: level_camera(tcfg, calib, lvl, device)
                     for lvl in range(tcfg.pyramid_levels)}
        self._pose_chunks: list = []      # device (Rs (K, 3, 3), ts (K, 3))
        self._n_poses = 0
        self.last_pose: Optional[Pose] = None
        self.last_pyramid: Optional[Pyramid] = None
        self.last_processed: Optional[ProcessedFrame] = None
        # the last tracked frame's world-space cloud (points, normals, mask),
        # its program's own; None after a set_pose frame
        self.last_world: Optional[Tuple[torch.Tensor, ...]] = None
        self.n_unstable = torch.zeros((), dtype=torch.int32, device=device)
        self.rgb_weight = torch.tensor(tcfg.rgb_weight, dtype=torch.float32,
                                       device=device)
        self._identity = Pose.identity(device)
        self.last_delta = self._identity
        self.n_host_syncs = 0
        # by frame shape and whether captured: an uncaptured run rebinds
        # tensors that a captured graph's pool owns, so the two never share
        self.programs: Dict[tuple, TrackProgram] = {}

    @property
    def n_tracked(self) -> int:
        return self._n_poses

    def append_pose(self, pose: Pose) -> None:
        self.append_pose_chunk(pose.R[None], pose.t[None])

    def append_pose_chunk(self, Rs: torch.Tensor, ts: torch.Tensor) -> None:
        """Commit a chunk of poses ((K, 3, 3), (K, 3)) in one append."""
        self._pose_chunks.append((Rs, ts))
        self._n_poses += int(Rs.shape[0])
        self.last_pose = Pose(Rs[-1], ts[-1])

    def pose_history(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every pose so far, on the device: (Rs (N, 3, 3), ts (N, 3))."""
        return (torch.cat([c[0] for c in self._pose_chunks]),
                torch.cat([c[1] for c in self._pose_chunks]))

    def _history_arrays(self):
        Rs, ts = self.pose_history()
        return Rs.double().cpu().numpy(), ts.double().cpu().numpy()

    def pose_at(self, i: int) -> Isometry:
        Rs, ts = self._history_arrays()
        return Isometry.from_matrix(Rs[i], ts[i], ortho=True)

    @property
    def all_pd_pose(self) -> list:
        """Pose history as host Isometries (two transfers for all)."""
        if not self._pose_chunks:
            return []
        return [Isometry.from_matrix(R, t, ortho=True)
                for R, t in zip(*self._history_arrays())]

    def track_camera(self, state, rgb, depth, set_pose: Optional[Isometry] = None,
                     driver: Optional[str] = None) -> Pose:
        """Track one frame as a camera gives it: ``rgb`` (H, W, 3) uint8 or
        float in [0, 1], ``depth`` (H, W) uint16 sensor units or float
        metres, numpy arrays or tensors.  They are converted on the
        tracker's device as :func:`preprocess_frame` converts them, packed
        there as ``pack_frame(..., lossless=True)`` packs the converted
        arrays, and tracked by :meth:`track_camera_packed` (``set_pose`` and
        ``driver`` as there)."""
        rgb, depth = sensor_frame(rgb, depth, self.calib.dcam_scale, self.device)
        return self.track_camera_packed(state, pack_lossless(rgb, depth),
                                        depth.shape[1], set_pose, driver)

    def track_camera_packed(self, state, packed: torch.Tensor, w: int,
                            set_pose: Optional[Isometry] = None,
                            driver: Optional[str] = None) -> Pose:
        """Track one :func:`pack_frame` buffer (a uint8 tensor on the
        tracker's device) as this shape's :class:`TrackProgram`.
        ``set_pose`` fixes the pose instead (frame 0, or a ground-truth
        pose).  ``driver``: ``"program"`` (the default) captures the program
        on the card, one graph launch a frame; ``"host"`` runs it uncaptured,
        the host reading each loop's exit flag after every pass.  On the CPU
        both run it uncaptured.  Both give the same pose."""
        if driver not in (None, "program", "host"):
            raise ValueError(f"driver {driver!r} (use 'program' or 'host')")
        if set_pose is not None:
            pose = Pose(torch.tensor(set_pose.q.rotation_matrix, dtype=torch.float32,
                                     device=self.device),
                        torch.tensor(set_pose.t, dtype=torch.float32,
                                     device=self.device))
            self.last_processed = preprocess_packed(self.tcfg, self.calib, packed, w)
            self.last_pyramid = self.last_processed.pyramid
            self.last_world = None
        else:
            prog = self.program(packed.shape, w, driver)
            prog.load_state(state)
            prog.preprocess_and_track(packed)
            pose = Pose(prog.out[:9].reshape(3, 3).clone(), prog.out[9:12].clone())
            self.last_pyramid = prog.prev
            self.last_delta = prog.delta
            self.rgb_weight, self.n_unstable = prog.rgb_weight, prog.n_unstable
            self.last_processed = prog.cur._replace(pyramid=prog.prev)
            self.last_world = prog.world
        self.append_pose(pose)
        return pose

    def program(self, packed_shape, w: int, driver: Optional[str] = None) -> TrackProgram:
        """The :class:`TrackProgram` of this frame shape and ``driver`` (see
        :meth:`track_camera_packed`; captured if and only if the device is
        CUDA and the driver is not ``"host"``), loaded with the tracker's
        temporal state (built at first use)."""
        key = (tuple(packed_shape), w, self.device.type == "cuda" and driver != "host")
        if key not in self.programs:
            self.programs[key] = TrackProgram(self, *key)
        prog = self.programs[key]
        prog.load()
        return prog

    def last_pc_world(self, pose: Pose
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """World-space (points, normals, mask) of the last frame: the
        program's own cloud of a tracked frame, and of a ``set_pose`` frame
        its points under ``pose``, its given pose."""
        if self.last_world is not None:
            return self.last_world
        return world_points(self.last_processed, pose)
