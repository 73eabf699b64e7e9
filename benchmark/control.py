"""Readings for the limits of ``correct``: sound runs and the control, many
seeds in one process.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 --seconds 30 \
        [--control program|tf32|bf16] [--fault <name>]

Each seed runs the cell's set-up, a window of ``--seconds`` and the check,
as ``benchmark.run`` does, and prints one JSON line of the numbers compared
(not held to their limits).  The controls: ``--control program`` runs the
port's own bf16 mode of the SDF term (``sdf_compute_dtype: bfloat16`` in
every group); ``--control tf32`` and ``--control bf16`` put the plain
reference, computed in that precision, in the port's place: the energies
reported for the drawn frames (at the served poses, over the maps the port
tracked them against), the map (fused at the served poses) and the meshes.
TF32 is the precision just below the configurations' f32 with TF32 off.
``--fault`` plants one of :mod:`.faults` in the port for the run.  The
benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import torch

from . import check, drive, faults, run
from .gen.render import render_lap
from .reference import frames as RF
from .reference import meshing as RM
from .reference import tracking as RT
from .reference.fusion import VoxelMap


def control_cfg(cfg: dict) -> dict:
    """The port's bf16 mode of the SDF term, in every Gauss-Newton group."""
    cfg = copy.deepcopy(cfg)
    cfg["tracking"]["sdf_compute_dtype"] = "bfloat16"
    cfg["tracking"]["sdf_f32_last_group"] = False
    return cfg


def _low_map(cfg: dict, lap, frames, poses, device, precision: str):
    """The plain reference's map in a lower precision: ``frames`` fused at
    ``poses`` ((R, t) float64 each)."""
    prior = check._prior(cfg, device, precision)
    vmap = VoxelMap(cfg, prior, device)
    for k, (R, t) in zip(frames, poses):
        f = RF.preprocess(*lap.frame(k), cfg, device)
        R = torch.as_tensor(R, device=device).float()
        t = torch.as_tensor(t, device=device).float()
        vmap.fuse(f.pts @ R.T + t, f.nrm @ R.T, f.mask)
    return vmap, prior


def _as_served_map(vmap) -> dict:
    live = vmap.alloc
    return {"map_cells": vmap.cells()[live].cpu(), "map_count": vmap.count[live].cpu(),
            "map_latent": vmap.latent[live].cpu(), "overflow": 0}


def export_control(cfg: dict, traffic: dict, seed: int, device,
                   precision: str = "bf16") -> dict:
    """The plain reference in a lower precision in the port's place: its map
    and its extract, served to the check as the port's would be."""
    every = int(cfg["integrate_interval"])
    lap = render_lap(cfg, seed, device, every=every)
    fused = list(range(0, len(lap), every))
    with torch.no_grad():
        vmap, prior = _low_map(cfg, lap, fused,
                               [(lap.R[lap.index(k)], lap.t[lap.index(k)]) for k in fused],
                               device, precision)
        tris, _, _ = RM.extract(vmap, prior, int(traffic["resolution"]),
                                float(traffic["max_std"]))
    return {"tris": tris.cpu().numpy(), "lap": lap, "fused": fused, **_as_served_map(vmap)}


def reference_in_place(cfg: dict, served: dict, device, precision: str) -> dict:
    """A tracking cell's served outputs with the drawn frames' energies, the
    map and the live mesher's last extract made by the plain reference in
    ``precision`` at the served poses."""
    n = served["R"].shape[0]
    frames = list(range(0, n, int(cfg["integrate_interval"])))
    with torch.no_grad():
        vmap, prior = _low_map(cfg, served["lap"], frames,
                               [(served["R"][k], served["t"][k]) for k in frames], device,
                               precision)
        out = dict(served, **_as_served_map(vmap))
        E = served["E"].copy()
        R = torch.as_tensor(served["R"], device=device)
        t = torch.as_tensor(served["t"], device=device)
        for k, snap in served["snapshots"].items():
            cur = RF.preprocess(*served["lap"].frame(k), cfg, device)
            prev = RF.preprocess(*served["lap"].frame(k - 1), cfg, device)
            Rd, td = RT.relative(R[k - 1], t[k - 1], R[k], t[k])
            pmap = check.program_map(cfg, snap, prior, device)
            E[k] = float(RT.energy(cur, prev, Rd, td, R[k - 1].float(), t[k - 1].float(),
                                   pmap, prior, cfg))
        out["E"] = E
        if served.get("last_mesh") is not None:
            near = vmap._dilate6(vmap.last_touched) & vmap.alloc & (vmap.count > vmap.ignore)
            tris, _, owner = RM.extract(vmap, prior, int(cfg["resolution"]),
                                        float(cfg["assumed"]["mesh_max_std"]), only=near)
            out["last_mesh"] = (owner.cpu(), tris.cpu())
    return out


def readings(spec: dict, seed: int, seconds: float, control: str, device,
             fault: str = "") -> dict:
    """One seed's numbers: the port as it is (``control`` and ``fault``
    empty), a control (``program``, ``tf32`` or ``bf16``), or the port with
    ``fault`` planted."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    t0 = time.perf_counter()
    if control in ("tf32", "bf16") and traffic["entry"] == "export":
        served = export_control(cfg, traffic, seed, device, control)
        window = {}
    else:
        if control == "program":
            cfg = control_cfg(cfg)
        patch = faults.Patch()
        if fault:
            faults.BY_ENTRY[traffic["entry"]][fault](patch)
        try:
            d = drive.DRIVERS[traffic["entry"]](cfg, traffic, seed, device, drive.Spans())
            window = d.window(seconds)
            served = d.served()
            d.free()
            del d
        finally:
            patch.undo()
        if control in ("tf32", "bf16"):
            served = reference_in_place(cfg, served, device, control)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    checks = check.judge(spec["cfg"], traffic, seed, served, device)
    return {"seed": seed, "control": control, "fault": fault, "window": window,
            "checks": {k: v["value"] for k, v in checks.items()},
            "readings": served.get("readings"), "run_s": t1 - t0,
            "check_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--control", choices=("", "program", "tf32", "bf16"), default="")
    p.add_argument("--fault", default="")
    a = p.parse_args(argv)
    spec = run.cell_spec(run.load_manifest(), a.workload)
    if a.fault and a.fault not in faults.BY_ENTRY[spec["traffic"]["entry"]]:
        p.error(f"fault {a.fault!r}: this cell has "
                f"{sorted(faults.BY_ENTRY[spec['traffic']['entry']])}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for s in a.seeds.split(","):
        print(json.dumps(readings(spec, int(s), a.seconds, a.control, device, a.fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
