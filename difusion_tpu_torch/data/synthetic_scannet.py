"""Write a ScanNet-export-format dataset (``color/*.jpg`` at quality 95,
``depth/*.png`` u16 in mm, ``pose/*.txt`` camera-to-world, ``intrinsic/``)
from the analytic renderer, to drive the hash-map configuration
(configs/fusion-scannet.yaml) without the real dataset.  The port's
counterpart of tools/make_synthetic_scannet.py, writing the same files.

    python -m difusion_tpu_torch.data.synthetic_scannet OUT_DIR [n_frames] [--workers 8]
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.imgproc import Intrinsic
from .production import SyntheticSequence
from .synthetic_icl import rendered_frames

CALIB = Intrinsic(481.2, 480.0, 319.5, 239.5, 1000.0)      # mm depth


def main(out_dir: str, n_frames: int = 12, workers: int = 1) -> None:
    import cv2

    out = Path(out_dir)
    for d in ("color", "depth", "pose", "intrinsic"):
        (out / d).mkdir(parents=True, exist_ok=True)
    seq = SyntheticSequence(n_frames=n_frames, h=480, w=640, calib=CALIB,
                            corrugation=0.1, motion_scale=0.5)
    for i, frame in enumerate(rendered_frames(seq, workers)):
        cv2.imwrite(str(out / "color" / f"{i}.jpg"),
                    cv2.cvtColor(frame.rgb, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        cv2.imwrite(str(out / "depth" / f"{i}.png"), frame.depth)
        np.savetxt(out / "pose" / f"{i}.txt", frame.gt_pose.matrix)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = CALIB.fx, CALIB.fy, CALIB.cx, CALIB.cy
    np.savetxt(out / "intrinsic" / "intrinsic_depth.txt", K)
    print(f"{out}: {n_frames} ScanNet-format frames")


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("n_frames", nargs="?", type=int, default=12)
    p.add_argument("--workers", type=int, default=1)
    a = p.parse_args()
    main(a.out_dir, a.n_frames, a.workers)
