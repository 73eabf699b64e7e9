"""Tracking and mapping accuracy on the synthetic datasets (the port's
counterpart of tools/accuracy_study.py's ``run_slam``, ``run_scannet_long``
and ``run_mapping_only``).

    python -m difusion_tpu_torch.accuracy [--frames 120] [--loop-frames 300]
        [--scannet 300] [--variants default,packed,parity,parity_strict,speed,compensated]
        [--only SUBSTR]
        [--loop-variants compensated]
        [--perturb-variants perturbed_comp-7,perturbed_comp-23]
        [--mapping-only 120] [--out accuracy_out] [--workers 8] [--device cuda]
        [--hyper di-checkpoints/study_mixed/hyper.json] [--epoch 300]
        [--reference ACCURACY_r05.json]

Writes each dataset once under ``--out`` (``data/synthetic_icl.py``,
``data/synthetic_scannet.py``; an existing one is reused), then runs the
SLAM CLI's system on it through the normal entry point
(``run_sequence(chunk=12)``, meshing once at frame 0, a full extract at the
end for the mesh error against the analytic surface):

* ``drift-clean`` (motion 0.5) and ``drift-noisy`` (motion 1.0, depth noise
  0.004 z^2, 2% holes, seed 3) under each of ``--variants``;
* ``loop300-clean`` / ``loop300-noisy`` (the loop trajectory, motion 1.2)
  under each of ``--loop-variants`` only: plain f32 ATE on these rows moves
  by tens of percent under any reordering of the sums, so they are compared
  under ``compensated``; ``loop300-noisy`` also under each of
  ``--perturb-variants`` (the same run with the SDF points reordered);
* with ``--scannet N``, ``scannet{N}-synth`` on the hash map with meshing at
  the integrate cadence and chunk 10: ATE, ``alloc_overflow``, each
  extract's transfer bytes and ms, and the mesh error;
* with ``--mapping-only N`` (default 120; 0 skips), ``mapping_only_ab``: N
  rendered 480x640 frames under their ground-truth poses (no tracking),
  fusion every 10 with ``encoder_count_th`` 200, once without and once with
  latent optimization (sync, 20 Adam iterations a fusion), then a no-cache
  r = 4 extract at max_std 0.25: the optimizer's effect on the mesh error.

Variants, with the meanings of tools/accuracy_study.py's: ``default``
(early exits, the block-tiled warp with the bf16 sensor-grid L0 texture:
the JAX package's defaults), ``packed`` (the same with the per-pixel warp:
the port's own tracker defaults), ``parity`` (every configured iteration,
no early exit, the per-pixel warp), ``parity_strict`` (parity with the
round-to-nearest warp and the full-resolution intrinsics at every level),
``speed`` (the shipped speed preset: RGB strides 1, 2, 2 and the SDF term in
bf16 but for the last group), ``compensated``, ``blocked``, and
``perturbed[_comp|_blk]-N`` (a fixed permutation of the SDF points drawn
from N, plain / compensated / blocked).  Every variant but ``packed``,
``parity`` and ``parity_strict`` runs the tiled warp, as the JAX package's
do.  Rows go to ``<out>/results.json`` with the card's name and power limit,
beside the JAX row of the same sequence and variant in ``--reference``
where it exists, marked by the checkpoint that row was taken with (only
``default`` and ``compensated`` have rows on this prior).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .config import dict_to_args
from .core import hash_map as HM
from .core import map as M
from .core.tracker import TrackerConfig
from .data import synthetic_icl, synthetic_scannet
from .data.production import (ICLNUIMSequence, ScanNetSequence, SyntheticSequence,
                              mesh_error_stats)
from .device import resolve_device
from .models.weights import load_prior
from .slam import SLAMSystem

ROOT = Path(__file__).resolve().parents[1]
HYPER = ROOT / "di-checkpoints/study_mixed/hyper.json"
NOISY = dict(noise_sigma=0.004, dropout=0.02, seed=3)


def tracking_args(variant: str = "default"):
    """The accuracy study's tracking block, with ``variant``'s changes."""
    targs = dict_to_args({
        "iter_config": [{"n": 10, "type": [["rgb", 2]]},
                        {"n": 10, "type": [["sdf"], ["rgb", 1]]},
                        {"n": 50, "type": [["sdf"], ["rgb", 0]]}],
        "sdf": {"robust_kernel": "huber", "robust_k": 5.0, "subsample": 0.5},
        "rgb": {"weight": 500.0, "robust_kernel": None, "robust_k": 0.01,
                "min_grad_scale": 0.0, "max_depth_delta": 0.2}})
    # the JAX package's TrackerConfig default, which the port's does not take
    targs.warp_tiled = True
    if variant in ("parity", "parity_strict"):
        targs.xi_tol = 0.0
        targs.energy_rel_tol = 0.0
        targs.warp_tiled = False
        if variant == "parity_strict":
            targs.rgb_bilinear = False
            targs.rgb_fullres_K = True
    elif variant == "packed":
        targs.warp_tiled = False
    elif variant == "speed":
        targs.rgb_stride = [1, 2, 2]
        targs.sdf_compute_dtype = "bfloat16"
    elif variant in ("compensated", "blocked"):
        targs.solve_dtype = variant
    elif variant.startswith("perturbed"):
        targs.perturb_points = int(variant.split("-")[1]) if "-" in variant else 7
        if variant.startswith("perturbed_comp"):
            targs.solve_dtype = "compensated"
        elif variant.startswith("perturbed_blk"):
            targs.solve_dtype = "blocked"
    elif variant != "default":
        raise ValueError(f"unknown variant {variant!r}")
    return targs


def dense_map_cfg() -> M.MapConfig:
    return M.MapConfig(bound_min=(-3.5, -3.5, -0.5), n_xyz=(70, 70, 40), voxel_size=0.1,
                       latent_dim=29, capacity=1 << 16, prune_min_vox_obs=16,
                       ignore_count_th=16.0, encoder_count_th=600.0)


def _finish(system: SLAMSystem, result: dict, seconds: float) -> dict:
    out = {"ate_rmse": result.get("ate_rmse", float("nan")),
           "fps": result["n_frames"] / seconds, "n_frames": result["n_frames"],
           "n_voxels": result["n_voxels"], "alloc_overflow": result["alloc_overflow"]}
    system.state = system.mesher.extract(system.state, max_std=0.25, no_cache=True)
    out.update(mesh_error_stats(system.mesher.triangles()[0]))
    return out


def run_slam(data_dir, frames: int, variant: str, prior, device, chunk: int = 12) -> dict:
    """SLAM over an ICL-format dataset on disk (dense map)."""
    dec, enc, _ = prior
    seq = ICLNUIMSequence(path=str(data_dir), first_tq=[0, 0, 0, 1, 0, 0, 0], load_gt=True)
    tcfg = TrackerConfig.from_args(tracking_args(variant), point_budget=1 << 13)
    system = SLAMSystem(dense_map_cfg(), tcfg, dec, enc, seq.calib, integrate_interval=20,
                        depth_cut=(0.5, 5.0), meshing=True, meshing_interval=10 ** 9,
                        mesh_resolution=4, device=device)
    t0 = time.perf_counter()
    result = system.run_sequence(seq, max_frames=frames, chunk=chunk)
    return _finish(system, result, time.perf_counter() - t0)


def run_scannet_long(data_dir, frames: int, prior, device, chunk: int = 10) -> dict:
    """SLAM over a ScanNet-format dataset on the hash map, meshing at the
    integrate cadence; records every extract's transfer bytes and ms."""
    dec, enc, _ = prior
    seq = ScanNetSequence(path=str(data_dir), load_gt=True)
    map_cfg = HM.HashMapConfig(voxel_size=0.1, latent_dim=29, capacity=1 << 16,
                               table_size=1 << 18, prune_min_vox_obs=16,
                               ignore_count_th=16.0, encoder_count_th=600.0)
    system = SLAMSystem(map_cfg, TrackerConfig.from_args(tracking_args(), point_budget=1 << 13),
                        dec, enc, seq.calib, integrate_interval=20, depth_cut=(0.3, 6.0),
                        meshing=True, meshing_interval=20, mesh_resolution=4, device=device)
    extracts = []
    inner = system.mesher.extract

    def recording_extract(state, **kw):
        t0 = time.perf_counter()
        out = inner(state, **kw)
        if system.device.type == "cuda":
            torch.cuda.synchronize(system.device)
        extracts.append((int(system.mesher.last_transfer_bytes),
                         (time.perf_counter() - t0) * 1e3))
        return out
    system.mesher.extract = recording_extract
    t0 = time.perf_counter()
    result = system.run_sequence(seq, max_frames=frames, chunk=chunk)
    seconds = time.perf_counter() - t0
    system.mesher.extract = inner
    nbytes = [b for b, _ in extracts]
    out = {"n_extracts": len(extracts),
           "extract_transfer_bytes_mean": float(np.mean(nbytes)) if nbytes else 0.0,
           "extract_transfer_bytes_max": int(np.max(nbytes)) if nbytes else 0,
           "extract_ms": [ms for _, ms in extracts]}
    out.update(_finish(system, result, seconds))
    return out


def run_mapping_only(frames: int, latent_optimize: bool, prior, device) -> dict:
    """One arm of the mapping-only A/B: the rendered drift sequence under its
    ground-truth poses, fusion every 10 frames, voxels converged at 200
    observations (so that the optimizer works within 120 frames), a final
    full extract."""
    dec, enc, _ = prior
    seq = SyntheticSequence(n_frames=frames, h=480, w=640, calib=ICLNUIMSequence.CALIB,
                            corrugation=0.1, motion_scale=0.5)
    system = SLAMSystem(dense_map_cfg()._replace(encoder_count_th=200.0),
                        TrackerConfig.from_args(tracking_args(), point_budget=1 << 13),
                        dec, enc, seq.calib, integrate_interval=10, depth_cut=(0.5, 5.0),
                        meshing=True, meshing_interval=10 ** 9, mesh_resolution=4,
                        latent_optimize=latent_optimize, latent_optimize_mode="sync",
                        optim_n_iters=20, device=device)
    system.use_gt_poses = True
    t0 = time.perf_counter()
    result = system.run_sequence(seq, max_frames=frames)
    out = {"latent_optimize": latent_optimize, "n_frames": result["n_frames"],
           "n_voxels": result["n_voxels"], "opt_overflow": result["opt_overflow"],
           "n_optimized": int(system.state.optimized.sum()),
           "seconds": time.perf_counter() - t0}
    system.state = system.mesher.extract(system.state, max_std=0.25, no_cache=True)
    out.update(mesh_error_stats(system.mesher.triangles()[0]))
    return out


def _card(index: int = 0) -> str:
    try:
        return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "not measured (no nvidia-smi)"


def _reference_rows(path: Path) -> dict:
    """(seq, config) -> the reference row of an ACCURACY_*.json file."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    rows = {(r["seq"].split("(")[0], r["config"]): r for r in data.get("slam", [])}
    if data.get("scannet_long"):
        r = data["scannet_long"]
        rows[(r["seq"], r["config"])] = r
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--loop-frames", type=int, default=300)
    p.add_argument("--scannet", type=int, default=0)
    p.add_argument("--mapping-only", type=int, default=120,
                   help="frames of the mapping-only A/B (0 skips it)")
    p.add_argument("--variants", default="default,packed,parity,parity_strict,speed,compensated")
    p.add_argument("--loop-variants", default="compensated")
    p.add_argument("--perturb-variants", default="perturbed_comp-7,perturbed_comp-23")
    p.add_argument("--only", default="", help="substring filter on dataset names")
    p.add_argument("--out", default="accuracy_out")
    p.add_argument("--workers", type=int, default=8, help="render threads")
    p.add_argument("--hyper", default=str(HYPER))
    p.add_argument("--epoch", type=int, default=300)
    p.add_argument("--reference", default=str(ROOT / "ACCURACY_r05.json"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    prior = load_prior(args.hyper, args.epoch, device=device)
    out = Path(args.out)
    datasets = {
        "drift-clean": (dict(n_frames=args.frames, motion_scale=0.5), args.variants),
        "drift-noisy": (dict(n_frames=args.frames, motion_scale=1.0, **NOISY), args.variants),
        "loop300-clean": (dict(n_frames=args.loop_frames, motion_scale=1.2,
                               trajectory="loop"), args.loop_variants),
        "loop300-noisy": (dict(n_frames=args.loop_frames, motion_scale=1.2,
                               trajectory="loop", **NOISY),
                          ",".join(filter(None, (args.loop_variants, args.perturb_variants)))),
    }
    ref = _reference_rows(Path(args.reference))
    rows = []
    for name, (kw, variants) in datasets.items():
        if args.only and args.only not in name:
            continue
        d = out / name
        t0 = time.perf_counter()
        if not (d / "groundtruth.txt").exists():
            synthetic_icl.main(str(d), workers=args.workers, **kw)
        write_s = time.perf_counter() - t0
        for variant in variants.split(","):
            r = run_slam(d, kw["n_frames"], variant, prior, device)
            r.update(seq=name, config=variant, write_s=write_s)
            jr = ref.get((name, f"{variant}+self-prior-mixed"))
            checkpoint = "study_mixed (this run's prior)"
            if jr is None:
                jr = ref.get((name, variant))
                checkpoint = "the reference checkpoint (not this run's prior)"
            if jr:
                r["reference"] = {k: jr[k] for k in ("config", "ate_rmse", "mesh_err_p95")
                                  if k in jr}
                r["reference"]["checkpoint"] = checkpoint
            rows.append(r)
            print(json.dumps(r), flush=True)
    if args.scannet > 0 and (not args.only or args.only in "scannet"):
        d = out / f"scannet{args.scannet}"
        t0 = time.perf_counter()
        if not (d / "intrinsic" / "intrinsic_depth.txt").exists():
            synthetic_scannet.main(str(d), args.scannet, workers=args.workers)
        r = run_scannet_long(d, args.scannet, prior, device)
        name = f"scannet{args.scannet}-synth"
        r.update(seq=name, config="default+hash", write_s=time.perf_counter() - t0)
        jr = ref.get((name, "default+hash"))
        if jr:
            r["reference"] = {k: jr[k] for k in ("ate_rmse", "alloc_overflow",
                                                 "extract_transfer_bytes_mean",
                                                 "mesh_err_p95") if k in jr}
        rows.append(r)
        print(json.dumps(r), flush=True)
    mapping_only = []
    if args.mapping_only > 0 and (not args.only or args.only in "mapping_only_ab"):
        reference = (json.loads(Path(args.reference).read_text()).get("mapping_only_ab", [])
                     if Path(args.reference).exists() else [])
        for opt in (False, True):
            r = run_mapping_only(args.mapping_only, opt, prior, device)
            jr = [x for x in reference if x.get("latent_optimize") == opt]
            if jr:
                r["reference"] = {k: jr[0][k] for k in ("mesh_err_mean", "mesh_err_p95",
                                                        "n_voxels") if k in jr[0]}
            mapping_only.append(r)
            print(json.dumps(r), flush=True)
    payload = {"card": _card(device.index) if device.type == "cuda" else "cpu",
               "torch": torch.__version__, "hyper": args.hyper, "epoch": args.epoch,
               "rows": rows, "mapping_only_ab": mapping_only}
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps(payload, indent=1))
    print("| sequence | config | ATE RMSE (m) | reference ATE (m) | mesh err p95 (m) | fps |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['seq']} | {r['config']} | {r['ate_rmse']:.4f} | "
              f"{r.get('reference', {}).get('ate_rmse', float('nan')):.4f} | "
              f"{r['mesh_err_p95']:.4f} | {r['fps']:.1f} |")
    for r in mapping_only:
        print(f"| mapping_only_ab | optimize={r['latent_optimize']} | mesh err mean "
              f"{r['mesh_err_mean']:.6f} | p95 {r['mesh_err_p95']:.6f} | voxels "
              f"{r['n_voxels']} | optimized {r['n_optimized']} |")
    print(payload["card"])
    return payload


if __name__ == "__main__":
    main()
