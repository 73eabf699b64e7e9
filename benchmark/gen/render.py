"""The benchmark's frames: a closed lap of RGB-D frames of an analytic
surface, rendered on the card from the seed.

The scene is the corrugated height field ``z = 2 + a (sin 5x + 0.7 cos 4y)``
with a world-x/y texture, as the port's ``SyntheticSequence.render`` draws
it (a copy of its arithmetic in PyTorch, float64, so that a lap renders on
the card in seconds instead of minutes on the host).  The texture's phase
comes from the seed.

The camera runs a closed ellipse of ``lap`` frames: frame ``j`` is at angle
``2 pi j / lap``, so frame ``lap`` is frame 0 again and any window replays a
continuous path.  A seed picks the frame the stream starts at, so every seed
renders the same set of poses in another order.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


class Lap(NamedTuple):
    """A rendered lap in pinned host memory, as a camera driver hands frames
    over: ``rgb`` (N, H, W, 3) uint8, ``depth`` (N, H, W) sensor units
    (uint16 bits, held as int16) of the N rendered frames, the poses of all
    L frames (L, 3, 3) / (L, 3) float64 camera-to-world, ``start``, the lap
    frame the stream begins with, and ``row`` (L,), each lap frame's row in
    ``rgb`` / ``depth`` (-1 where it was not rendered)."""
    rgb: torch.Tensor
    depth: torch.Tensor
    R: np.ndarray
    t: np.ndarray
    start: int
    row: np.ndarray

    def __len__(self) -> int:
        return int(self.R.shape[0])

    def index(self, k: int) -> int:
        """The lap frame of stream frame ``k``."""
        return (self.start + k) % len(self)

    def frame(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stream frame ``k`` as numpy views of the pinned buffers: rgb
        (H, W, 3) uint8, depth (H, W) uint16."""
        i = int(self.row[self.index(k)])
        if i < 0:
            raise KeyError(f"stream frame {k} (lap frame {self.index(k)}) was not rendered")
        return self.rgb[i].numpy(), self.depth[i].numpy().view(np.uint16)


def lap_poses(lap: int, center: Tuple[float, float], radii: Tuple[float, float],
              sway: Tuple[float, float] = (0.15, 0.08), height: float = 0.05
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Camera-to-world poses of the lap: an ellipse of ``radii`` about
    ``center`` in the x/y plane walked at a constant speed (equal arcs
    between frames), the camera looking along +z at the surface, a yaw and
    pitch sway of ``sway`` radians and a ``height`` bob, all periodic in the
    lap.  Returns (R (L, 3, 3), t (L, 3)) float64."""
    fine = np.linspace(0.0, 2.0 * np.pi, 1 << 16)
    arc = np.concatenate([[0.0], np.cumsum(np.hypot(
        radii[0] * np.diff(np.sin(fine)), radii[1] * np.diff(np.cos(fine))))])
    ph = 2.0 * np.pi * np.arange(lap) / lap            # the lap's phase
    th = np.interp(ph / (2.0 * np.pi) * arc[-1], arc, fine)
    t = np.stack([center[0] + radii[0] * np.sin(th),
                  center[1] - radii[1] * np.cos(th),
                  height * np.sin(3.0 * ph)], axis=1)
    yaw = sway[0] * np.sin(2.0 * ph)
    pitch = sway[1] * np.sin(ph)
    cz, sz, cx, sx = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    one, zero = np.ones_like(th), np.zeros_like(th)
    Rz = np.stack([np.stack([cz, -sz, zero], -1), np.stack([sz, cz, zero], -1),
                   np.stack([zero, zero, one], -1)], axis=-2)
    Rx = np.stack([np.stack([one, zero, zero], -1), np.stack([zero, cx, -sx], -1),
                   np.stack([zero, sx, cx], -1)], axis=-2)
    return Rz @ Rx, t


def render(R: torch.Tensor, t: torch.Tensor, intr: Tuple[float, float, float, float],
           h: int, w: int, corrugation: float, phase: Tuple[float, float] = (0.0, 0.0)
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a batch of poses (R (N, 3, 3), t (N, 3) float64, on the device
    the frames are made on).  Returns (rgb (N, H, W, 3) uint8, depth (N, H, W)
    float64 metres, 0 where the ray missed).  The arithmetic is
    ``SyntheticSequence.render``'s: 30 fixed-point steps of the ray/surface
    intersection, the texture quantized by truncation."""
    fx, fy, cx, cy = intr
    dev = R.device
    f64 = torch.float64
    vv, uu = torch.meshgrid(torch.arange(h, dtype=f64, device=dev),
                            torch.arange(w, dtype=f64, device=dev), indexing="ij")
    rays = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)], dim=-1)
    dirs = torch.einsum("hwc,ndc->nhwd", rays, R)              # rays @ R^T
    t = t[:, None, None, :]
    a = corrugation

    def relief(x, y):
        return a * (torch.sin(5.0 * x) + 0.7 * torch.cos(4.0 * y))

    s = (2.0 - t[..., 2]) / dirs[..., 2]
    for _ in range(30):
        p = t + s[..., None] * dirs
        s = (2.0 + relief(p[..., 0], p[..., 1]) - t[..., 2]) / dirs[..., 2]
    ok = s > 0.1
    depth = torch.where(ok, s, torch.zeros((), dtype=f64, device=dev))
    p = t + s[..., None] * dirs
    tex = (0.5 + 0.25 * torch.sin(p[..., 0] * 17.0 + phase[0])
           + 0.25 * torch.cos(p[..., 1] * 13.0 + phase[1]))
    grey = (torch.clamp(tex, 0.0, 1.0) * 255.0).to(torch.uint8)
    return grey[..., None].expand(*grey.shape, 3).contiguous(), depth


def sensor_depth(depth: torch.Tensor, scale: float) -> torch.Tensor:
    """Metres (float64) -> sensor units, truncated as ``astype(np.uint16)``
    truncates, returned as int16 bits (torch has few uint16 kernels)."""
    u = torch.clamp(depth.to(torch.float32) * scale, 0.0, 65535.0).to(torch.int32)
    return torch.where(u >= 32768, u - 65536, u).to(torch.int16)


def seed_draws(seed: int, lap: int) -> Tuple[int, Tuple[float, float]]:
    """The stream's first lap frame and the texture's phase, from the seed
    (any whole number; numpy's generator takes it whole)."""
    rng = np.random.default_rng(int(seed))
    start = int(rng.integers(lap))
    phase = tuple(float(x) for x in rng.uniform(0.0, 2.0 * math.pi, size=2))
    return start, phase


def render_lap(cfg: dict, seed: int, device: torch.device, batch: int = 16,
               every: int = 1) -> Lap:
    """Render the configuration's lap (``cfg["frames"]``) on ``device`` into
    pinned host memory: the stream frames ``0, every, 2 every, ...`` of the
    lap (every frame by default; a cell renders only what its traffic
    reads)."""
    fr = cfg["frames"]
    h, w, lap = fr["h"], fr["w"], fr["lap"]
    intr = tuple(fr["intrinsics"])
    start, phase = seed_draws(seed, lap)
    R, t = lap_poses(lap, tuple(fr["center"]), tuple(fr["radii"]))
    js = (start + np.arange(0, lap, every)) % lap        # the lap frames read
    row = np.full(lap, -1, dtype=np.int64)
    row[js] = np.arange(len(js))
    pin = device.type == "cuda"
    rgb = torch.empty((len(js), h, w, 3), dtype=torch.uint8, pin_memory=pin)
    depth = torch.empty((len(js), h, w), dtype=torch.int16, pin_memory=pin)
    Rd = torch.from_numpy(R[js]).to(device)
    td = torch.from_numpy(t[js]).to(device)
    for i in range(0, len(js), batch):
        c, d = render(Rd[i:i + batch], td[i:i + batch], intr, h, w,
                      fr["corrugation"], phase)
        rgb[i:i + batch].copy_(c, non_blocking=True)
        depth[i:i + batch].copy_(sensor_depth(d, fr["depth_scale"]), non_blocking=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Lap(rgb, depth, R, t, start, row)
