"""A cell at a size the CPU runs in seconds: 240x320 frames (the sensor's
field of view, half the pixels each way), a 60-frame lap, a 2048-point
budget, and thresholds lowered to what that many points reach."""
from __future__ import annotations

import copy

from benchmark import run


def spec(workload: str, lap: int = 60, width: int = 320, budget: int = 2048) -> dict:
    s = copy.deepcopy(run.cell_spec(run.load_manifest(), workload))
    cfg, traffic = s["cfg"], s["traffic"]
    fr = cfg["frames"]
    scale = width / 640
    h = 480 * width // 640
    fr.update(h=h, w=width, lap=lap)
    fx, fy = fr["intrinsics"][:2]
    fr["intrinsics"] = [fx * scale, fy * scale, (width - 1) / 2, (h - 1) / 2]
    cfg["assumed"]["point_budget"] = budget
    cfg["mapping"]["prune_min_vox_obs"] = 2
    cfg["mapping"]["ignore_count_th"] = 4.0
    if "warm_frames" in traffic:
        traffic["warm_frames"] = 21
    if "resolution" in traffic:
        traffic["resolution"] = 4
    traffic["samples"] = 40
    traffic["trace_seconds"] = 1.0
    return s
