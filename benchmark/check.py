"""Deciding ``correct``: the plain reference (:mod:`.reference`) judges what
the window produced, after the port's state is freed.

The reference reads the prior's raw weights and the benchmark's own frames,
and works out again every map and mesh the port made.  The tracker's poses
are judged frame by frame from the port's own state (a tracked pose depends
on every pose and every fusion before it, so no independent run reaches the
same trajectory): on a sample of the window's frames drawn from the seed,
the reference evaluates the tracker's objective at the served pose, from
the served previous pose, over the map the port tracked that frame against
(as a range: a point within micrometres of a cell face may fall either
side when the pose is composed in another order), and takes one
Gauss-Newton step of its own from there.  A frame's gap is the larger of
the distance of the port's reported energy from that range (relative) and
the share of the energy the reference's step still removes;
``energy_gap`` is the sample's median gap, ``energy_gap_max`` its widest,
which a fault on a few frames of every chunk or every fusion moves (the
sample holds fusion and chunk-boundary frames in a stratum of their own,
:class:`.drive.Sampler`).  The map the port fused, the stage that this
skips, is checked by itself: cell by cell against the reference's fusion of
the same frames at the served poses (``latent_gap``: the median cell's
relative latent difference; ``count_gap``: the share of cells allocated on
one side only or observed a different number of times, which a dropped
keyframe moves).  Meshes are compared edge by edge (``mesh_lonely``:
the share of edges with a vertex on one side only; the widest distance
between the two sides' vertices on one edge is reported beside it as
``mesh_gap``).  Each number is compared
with the limit in the traffic file.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .reference import frames as RF
from .reference import meshing as RM
from .reference import tracking as RT
from .reference.fusion import VoxelMap
from .reference.prior import Prior

ROOT = Path(__file__).resolve().parent.parent


def _prior(cfg: Dict, device, precision: str = "f32") -> Prior:
    return Prior(ROOT / cfg["training_hypers"], int(cfg["using_epoch"]), device, precision)


def _entry(limits: Dict, name: str, value: float) -> dict:
    return {"value": float(value), "limit": float(limits[name])}


def map_gaps(vmap: VoxelMap, served: dict) -> Dict[str, float]:
    """The port's map against the reference's, cell by cell, over every
    cell either side allocated: ``latent_gap``, the median cell's latent
    difference over that cell's reference latent (a cell one side lacks
    reads 1); ``count_gap``, the share of cells allocated on one side only
    or observed a different number of times.  The median: a point within
    rounding of a cell face falls in the neighbouring cell on one side, so a
    few cells' counts differ by one and their latents by one code's share;
    the widest or the summed gap swings with those cells from seed to seed,
    the median cell's does not.  ``cell_gap``, the widest gap among the
    cells observed alike, is reported beside."""
    dev = vmap.device
    cells = served["map_cells"].to(dev)
    idx, inside = vmap._index(cells)
    if not bool(inside.all()):
        return {"count_gap": 1.0, "latent_gap": 1.0, "cell_gap": float("inf")}
    n = vmap.alloc.shape[0]
    p_alloc = torch.zeros(n, dtype=torch.bool, device=dev)
    p_alloc[idx] = True
    p_cnt = torch.zeros(n, device=dev)
    p_cnt[idx] = served["map_count"].to(dev)
    p_lat = torch.zeros_like(vmap.latent)
    p_lat[idx] = served["map_latent"].to(dev)
    either = p_alloc | vmap.alloc
    if not bool(either.any()):
        return {"count_gap": 0.0, "latent_gap": 0.0, "cell_gap": 0.0}
    differ = (p_alloc != vmap.alloc) | (p_cnt != vmap.count)
    ref = torch.where(vmap.alloc[:, None], vmap.latent, 0.0)[either].double()
    got = torch.where(p_alloc[:, None], p_lat, 0.0)[either].double()
    rel = torch.linalg.norm(got - ref, dim=1) / torch.linalg.norm(ref, dim=1).clamp(min=1e-30)
    rel = torch.where((p_alloc != vmap.alloc)[either], 1.0, rel)
    rel = torch.where((torch.linalg.norm(ref, dim=1) == 0) & (torch.linalg.norm(got, dim=1) == 0),
                      0.0, rel)
    same = either & ~differ & (vmap.count > 0)
    cell_gap = float("inf")
    if bool(same.any()):
        r = vmap.latent[same]
        cell_gap = float((p_lat[same] - r).abs().amax()) / max(float(r.abs().amax(1).median()), 1e-30)
    return {"count_gap": float(differ[either].float().mean()), "latent_gap": float(rel.median()),
            "cell_gap": cell_gap}


def program_map(cfg: Dict, snap: Dict[str, torch.Tensor], prior, device) -> VoxelMap:
    """The map a drawn frame was tracked against, as the port held it
    (its indexer or hash entries, counts and latents), cell by cell."""
    vmap = VoxelMap(cfg, prior, device)
    lat = snap["latents"].to(device)
    cnt = snap["obs_count"].to(device)
    if "indexer" in snap:
        slot = snap["indexer"].to(device).long()
        vmap.alloc = slot >= 0
        s = slot.clamp(min=0)
        vmap.count = torch.where(vmap.alloc, cnt[s], torch.zeros((), device=device))
        vmap.latent = torch.where(vmap.alloc[:, None], lat[s], torch.zeros((), device=device))
        return vmap
    slot = snap["table_slot"].to(device).long()
    used = slot >= 0
    idx, inside = vmap._index(snap["keys"].to(device).long()[used])
    if not bool(inside.all()):
        raise ValueError("the port's map holds a cell outside the reference's grid")
    vmap.alloc[idx] = True
    vmap.count[idx] = cnt[slot[used]]
    vmap.latent[idx] = lat[slot[used]]
    return vmap


def judge_tracking(cfg, traffic, seed, served, device, prior=None) -> Dict[str, dict]:
    limits = traffic["limits"]
    prior = prior or _prior(cfg, device)
    vmap = VoxelMap(cfg, prior, device)
    lap = served["lap"]
    R, t, E = served["R"], served["t"], served["E"]
    n = R.shape[0]
    every = int(cfg["integrate_interval"])
    snaps = served["snapshots"]
    samples = sorted(snaps)
    want = set(range(0, n, every)) | set(samples) | {k - 1 for k in samples}
    pre = {}
    gaps, excess, best = [], [], []
    Rf = torch.as_tensor(R, device=device)
    tf = torch.as_tensor(t, device=device)
    for k in sorted(want):
        if k not in pre:
            pre[k] = RF.preprocess(*lap.frame(k), cfg, device)
        if k in samples:
            Rd, td = RT.relative(Rf[k - 1], tf[k - 1], Rf[k], tf[k])
            Rp, tp = Rf[k - 1].float(), tf[k - 1].float()
            pmap = program_map(cfg, snaps[k], prior, device)
            e = float(RT.energy(pre[k], pre[k - 1], Rd, td, Rp, tp, pmap, prior, cfg))
            lo, hi = RT.energy_interval(pre[k], pre[k - 1], Rd, td, Rp, tp, pmap, prior, cfg)
            x = RT.gn_excess(pre[k], pre[k - 1], Rd, td, Rp, tp, pmap, prior, cfg)
            gaps.append(abs(E[k] - e) / e)
            excess.append(x)
            # the served answer against the reference: how far the reported
            # energy lies outside what the served pose gives, or how much a
            # step from the served pose still removes, whichever is more
            best.append(max(max(lo - E[k], E[k] - hi, 0.0) / e, x))
            del pmap
        if k % every == 0:
            f = pre[k]
            Rk, tk = Rf[k].float(), tf[k].float()
            vmap.fuse(f.pts @ Rk.T + tk, f.nrm @ Rk.T, f.mask)
        for j in [j for j in pre if j < k - 1]:
            del pre[j]
    # the median: a point that lies within rounding of a voxel face takes
    # the neighbour's latent when the pose is composed in another order, so
    # the widest gap of a sample swings with such points (reported beside)
    gaps_map = map_gaps(vmap, served)
    out = {"energy_gap": _entry(limits, "energy_gap", float(np.median(best))),
           "energy_gap_max": _entry(limits, "energy_gap_max", max(best)),
           "latent_gap": _entry(limits, "latent_gap", gaps_map["latent_gap"]),
           "count_gap": _entry(limits, "count_gap", gaps_map["count_gap"]),
           "alloc_overflow": _entry(limits, "alloc_overflow", served["overflow"])}
    served["readings"] = {"energy_only_median": float(np.median(gaps)),
                          "pose_excess_max": max(excess), "pose_excess_median": float(np.median(excess)),
                          "cell_gap": gaps_map["cell_gap"], "samples": len(best)}
    if served.get("last_mesh") is not None:
        out.update(judge_last_mesh(cfg, traffic, vmap, prior, served))
    return out


def judge_last_mesh(cfg, traffic, vmap: VoxelMap, prior, served) -> Dict[str, dict]:
    """The live mesher's last extract: the blocks within one face of a cell
    the last fusion touched, meshed and blended among themselves."""
    limits = traffic["limits"]
    touched = vmap.last_touched
    near = vmap._dilate6(touched) & vmap.alloc & (vmap.count > vmap.ignore)
    r = int(cfg["resolution"])
    ref, _, _ = RM.extract(vmap, prior, r, float(cfg["assumed"]["mesh_max_std"]), only=near)
    cells, tris = served["last_mesh"]
    idx, inside = vmap._index(cells.to(vmap.device))
    keep = inside & near[idx]
    prog = tris.to(vmap.device)[keep]
    gap, lonely, _, _ = RM.compare(prog, ref, vmap.origin, vmap.vs, r)
    served.setdefault("readings", {})["mesh_gap"] = gap
    return {"mesh_lonely": _entry(limits, "mesh_lonely", lonely)}


def judge_export(cfg, traffic, seed, served, device, prior=None) -> Dict[str, dict]:
    limits = traffic["limits"]
    prior = prior or _prior(cfg, device)
    vmap = VoxelMap(cfg, prior, device)
    lap = served["lap"]
    for k in served["fused"]:
        f = RF.preprocess(*lap.frame(k), cfg, device)
        j = lap.index(k)
        Rk = torch.as_tensor(lap.R[j], device=device).float()
        tk = torch.as_tensor(lap.t[j], device=device).float()
        vmap.fuse(f.pts @ Rk.T + tk, f.nrm @ Rk.T, f.mask)
    r = int(traffic["resolution"])
    ref, _, _ = RM.extract(vmap, prior, r, float(traffic["max_std"]))
    prog = torch.as_tensor(served["tris"], device=device)
    gap, lonely, n_prog, n_ref = RM.compare(prog, ref, vmap.origin, vmap.vs, r)
    gaps_map = map_gaps(vmap, served)
    served["readings"] = {"cell_gap": gaps_map["cell_gap"], "mesh_gap": gap,
                          "vertices": n_prog, "vertices_reference": n_ref}
    return {"mesh_lonely": _entry(limits, "mesh_lonely", lonely),
            "latent_gap": _entry(limits, "latent_gap", gaps_map["latent_gap"]),
            "count_gap": _entry(limits, "count_gap", gaps_map["count_gap"])}


def judge(cfg, traffic, seed, served, device) -> Dict[str, dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        if traffic["entry"] == "export":
            return judge_export(cfg, traffic, seed, served, device)
        return judge_tracking(cfg, traffic, seed, served, device)
