"""Write an ICL-NUIM-format dataset (``rgb/*.png``, ``depth/*.png`` u16 at
1/5000 m, ``groundtruth.txt`` in the TUM-freiburg convention) from the
analytic renderer, so the loader, the PNG decode, u16 depth and the GT ATE
run end to end without the real dataset.  The port's counterpart of
tools/make_synthetic_icl.py: the same arguments, the same numpy
``default_rng(seed)`` draws in the same order, the same files.

    python -m difusion_tpu_torch.data.synthetic_icl OUT_DIR [n_frames]
        [--motion-scale 0.5] [--noise-sigma 0.004] [--dropout 0.02]
        [--seed 3] [--trajectory drift|loop|out_back] [--workers 8]

``--workers`` renders frames in that many threads (numpy releases the GIL
in its array loops); the noise is drawn in frame order all the same.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..utils.motion import Isometry
from .production import ICLNUIMSequence, SyntheticSequence


def conjugate_for_freiburg(pose: Isometry) -> Isometry:
    """The inverse of the loader's parse transform (a y row + column flip,
    then a 180-degree z turn that the anchoring to the first pose cancels):
    writing D pose D parses back to pose."""
    D = np.diag([1.0, -1.0, 1.0])
    return Isometry.from_matrix(D @ pose.q.rotation_matrix @ D, D @ pose.t)


def degrade_depth(depth: np.ndarray, dcam_scale: float, rng: np.random.Generator,
                  noise_sigma: float = 0.0, dropout: float = 0.0) -> np.ndarray:
    """Sensor degradation of a u16 depth frame: noise ``sigma * z^2`` (drawn
    first), then holes where a uniform draw is below ``dropout``, then
    quantization back to u16 units."""
    if noise_sigma <= 0.0 and dropout <= 0.0:
        return depth
    z = depth.astype(np.float64) / dcam_scale
    if noise_sigma > 0.0:
        z = z + rng.normal(0.0, noise_sigma, z.shape) * z ** 2
    if dropout > 0.0:
        z = np.where(rng.random(z.shape) < dropout, 0.0, z)
    return np.clip(z * dcam_scale + 0.5, 0, 65535).astype(np.uint16)


def rendered_frames(seq: SyntheticSequence, workers: int = 1):
    """The sequence's frames in order, rendered by ``workers`` threads."""
    if workers <= 1:
        yield from seq
        return
    with ThreadPoolExecutor(workers) as pool:
        yield from pool.map(seq.frame, range(len(seq)))


def main(out_dir: str, n_frames: int = 12, motion_scale: float = 0.5,
         noise_sigma: float = 0.0, dropout: float = 0.0, seed: int = 0,
         trajectory: str = "drift", workers: int = 1) -> list:
    """Write the dataset; returns ``first_tq`` (t, then q as w, x, y, z)."""
    import cv2

    out = Path(out_dir)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)
    seq = SyntheticSequence(n_frames=n_frames, h=480, w=640,
                            calib=ICLNUIMSequence.CALIB, corrugation=0.1,
                            motion_scale=motion_scale, trajectory=trajectory)
    rng = np.random.default_rng(seed)
    rows = []
    for i, frame in enumerate(rendered_frames(seq, workers)):
        cv2.imwrite(str(out / "rgb" / f"{i}.png"), cv2.cvtColor(frame.rgb, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(out / "depth" / f"{i}.png"),
                    degrade_depth(frame.depth, seq.calib.dcam_scale, rng,
                                  noise_sigma, dropout))
        w = conjugate_for_freiburg(frame.gt_pose)
        qw, qx, qy, qz = w.q.q
        rows.append([i, w.t[0], w.t[1], w.t[2], qx, qy, qz, qw])
    np.savetxt(out / "groundtruth.txt", np.asarray(rows))
    g0 = seq.gt_trajectory[0]
    qw, qx, qy, qz = g0.q.q
    first_tq = [g0.t[0], g0.t[1], g0.t[2], qw, qx, qy, qz]
    print(f"{out}: {n_frames} frames; first_tq = {[round(v, 6) for v in first_tq]}")
    return first_tq


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("n_frames", nargs="?", type=int, default=12)
    p.add_argument("--motion-scale", type=float, default=0.5)
    p.add_argument("--noise-sigma", type=float, default=0.0,
                   help="depth noise stddev = sigma * z^2 (m)")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="fraction of depth pixels zeroed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trajectory", default="drift", choices=["drift", "loop", "out_back"])
    p.add_argument("--workers", type=int, default=1)
    a = p.parse_args()
    main(a.out_dir, a.n_frames, a.motion_scale, a.noise_sigma, a.dropout, a.seed,
         a.trajectory, a.workers)
