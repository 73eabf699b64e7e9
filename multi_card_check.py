"""The port's several-card paths on a machine with two or more CUDA cards
(run with four):

    python3 multi_card_check.py

1. shard -- a sphere of radius 1.2 m fused into a dense map (voxel 0.1 m,
   one keyframe of 200,000 points, the in-repo study_mixed prior's encoder)
   and meshed at r = 8 through ``mesh_tool --shard`` (each decode chunk
   split over every visible card, kernel 3 on each card) and through
   ``mesh_tool``: the triangles must be ``torch.equal``, and kernel 3 must
   launch once a card for each chunk; ms of each, cold and then warm.
2. dp -- ``torchrun --standalone --nproc-per-node N -m
   difusion_tpu_torch.train.trainer`` (NCCL, one rank a card: data parallel
   over gcd(64, N) ranks) for one epoch of 3 batches on a synthetic sphere
   corpus at configs/train-study-mixed.yaml's widths (batch 64 x 4,096
   samples, decoder 128x4, BatchNorm encoder 6-32-64-256, NLL + reg, float16
   upload), against the single-process trainer: the same files (3 steps log
   no row at the command line's log_every of 10), prior_1.npz within 1e-5
   but for at most 1e-4 of the entries, each with a single-process gradient
   g so small at some step that lr * eps / (|g| + eps) > 1e-5 (Adam's step
   lr * g / (|g| + eps) moves such an entry past 1e-5 on a gradient error
   no larger than |g| + eps), and those within lr.
3. sit_out -- the same on N - 1 ranks (3 of 4: gcd(64, 3) = 1): rank 0
   trains alone, the other ranks leave at once; the files must equal the
   plain trainer's bit for bit.
4. second_card -- in this process, whose current card stays cuda:0:
   ``SLAMSystem.from_config`` on configs/fusion-synthetic.yaml (``--set
   training_hypers=`` the in-repo prior) at bench.py's configuration (a
   640x480 SyntheticSequence, a dense 70x70x40 map of 0.1 m voxels, point
   budget 8192, fusion every 20 frames, meshing off) + ``run_sequence(chunk
   =12)`` over 41 frames, on cuda:0 and then on cuda:1; then the same with
   ``stencil_window`` 20 (kernel 2's run-time window, a tile above 48 KB of
   shared memory) on cuda:0 and then cuda:1; then an r = 4 extract of each
   card's window-6 map.  Each card's poses must be ``torch.equal`` to the
   other's at each window and the triangles too; on every run kernel 2
   launches 41 + the warm-up passes' times, kernel 1 at least twice a
   tracked frame, the host reads no exit flag, ATE <= 0.05 m; kernel 3
   once a decode dispatch of each extract.  ms/frame of each run.
5. tp2, tp4 -- train_step on make_mesh(N, tp=2) and make_mesh(N, tp=4)
   (distributed.launch over NCCL, rank r on cuda:r) from the seeded state
   on one global batch of the dp part's corpus at its widths, 1 and 5
   steps, against the same steps in this process (chip_smoke.py's
   ``parallel_steps``: one step within 3e-5 under the eps rule above, the
   5-step difference reported); ms/step by CUDA events.

Each part prints one JSON line; then the card line (name and power limit
from nvidia-smi) and ``{"ok": true, "cards": N}`` last.  Exits nonzero when
a part fails or fewer than two cards are visible (the tp parts need four).
It writes under build/multi_card/.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HYPER = ROOT / "di-checkpoints/study_mixed/hyper.json"
WORK = ROOT / "build" / "multi_card"
BATCH, STEPS = 64, 3
LR = 1e-3  # train-study-mixed.yaml's at epoch 1
FRAMES = 41                # chip_smoke.py's chunk phase (chunks of its CHUNK)
WINDOWS = (6, 20)          # kernel 2's templated window and a tile above 48 KB
TP_STEPS, TP_TOL = 5, 3e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"multi_card_check: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


# ---------------------------------------------------------------------------
# shard
# ---------------------------------------------------------------------------


def shard_part(n_cards: int) -> dict:
    from difusion_tpu_torch import mesh_tool
    from difusion_tpu_torch.core import map as M
    from difusion_tpu_torch.models.weights import load_prior
    from difusion_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    _, enc, _ = load_prior(HYPER, 300, device=dev)
    cfg = M.MapConfig(bound_min=(-1.6, -1.6, -1.6), n_xyz=(32, 32, 32), voxel_size=0.1,
                      prune_min_vox_obs=4, ignore_count_th=1.0)
    rng = np.random.default_rng(0)
    nrm = rng.normal(size=(200_000, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    xyz = torch.from_numpy((1.2 * nrm).astype(np.float32)).to(dev)
    nrm = torch.from_numpy(nrm.astype(np.float32)).to(dev)
    state = M.integrate_keyframe(cfg, enc, M.create_map_state(cfg, dev), xyz, nrm,
                                 torch.ones(len(xyz), dtype=torch.bool, device=dev))
    map_path = WORK / "sphere_map.npz"
    M.save_map(map_path, cfg, state)
    args = [str(map_path), str(WORK / "sphere.ply"), "--hyper", str(HYPER), "--epoch", "300",
            "--resolution", "8", "--max-std", "0.15"]

    def run(extra):
        torch.cuda.synchronize()
        before = _build.launch_counts().get("decode_fused", 0)
        t0 = time.perf_counter()
        tool = mesh_tool.main(args + extra)
        for d in range(n_cards):
            torch.cuda.synchronize(d)
        ms = (time.perf_counter() - t0) * 1e3
        return tool, ms, _build.launch_counts().get("decode_fused", 0) - before
    # cold, then warm in turns
    plain, plain_ms, plain_launches = run([])
    shard, shard_ms, shard_launches = run(["--shard"])
    warm = {"plain": [], "shard": []}
    for _ in range(2):
        warm["plain"].append(run([])[1])
        warm["shard"].append(run(["--shard"])[1])
    equal = all(torch.equal(torch.from_numpy(x), torch.from_numpy(y))
                for x, y in zip(shard.triangles(), plain.triangles()))
    row = {"part": "shard", "cards": n_cards, "blocks": plain.last_stats["blocks"],
           "triangles": len(plain.triangles()[0]), "equal": equal,
           "decode_devices": shard.last_stats["decode_devices"],
           "decode_dispatches": shard.last_stats["decode_dispatches"],
           "kernel3_launches": {"plain": plain_launches, "shard": shard_launches},
           "mesh_tool_ms": {"plain_cold": plain_ms, "shard_cold": shard_ms, **warm}}
    emit(row)
    if not equal or len(plain.triangles()[0]) < 1000:
        fail(f"shard: triangles differ or too few: {row}")
    # a dispatch splits over the cards where they divide its block count
    n, c = plain.last_stats["blocks"], plain.last_stats["sites_per_dispatch"] // 16 ** 3
    want = sum(n_cards if min(c, n - s0) % n_cards == 0 else 1 for s0 in range(0, n, c))
    if shard.last_stats["decode_devices"] != n_cards or shard_launches != want:
        fail(f"shard: kernel 3 did not run once a card for each split dispatch: {row}")
    return row


# ---------------------------------------------------------------------------
# dp, sit_out
# ---------------------------------------------------------------------------


def sphere_corpus(path: Path, n_lifs: int) -> None:
    """Sphere-cap SDFs in the reference payload format."""
    rng = np.random.default_rng(0)
    (path / "payload").mkdir(parents=True)
    for i in range(n_lifs):
        r, c = rng.uniform(0.2, 0.4), rng.uniform(-0.15, 0.15, 3)
        xyz = rng.uniform(-0.5, 0.5, (6000, 3)).astype(np.float32)
        sdf = (np.linalg.norm(xyz - c, axis=1) - r).astype(np.float32)
        dirs = rng.normal(size=(1000, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        np.savez(path / "payload" / ("%08d.npz" % i),
                 data=np.concatenate([xyz, sdf[:, None]], 1),
                 surface=np.concatenate([c + dirs * r, dirs], 1).astype(np.float32))
    (path / "source.json").write_text(json.dumps([f"lif_{i}" for i in range(n_lifs)]))


def train_hyper(corpus: Path) -> dict:
    from difusion_tpu_torch.config import args_to_dict, load_yaml_args
    hyper = args_to_dict(load_yaml_args(str(ROOT / "configs/train-study-mixed.yaml")))
    hyper.update(num_epochs=1, snapshot_frequency=1, additional_snapshots=[],
                 train_set=[{"data_path": f"cached$local://{corpus}",
                             "augment_rotation": "Y", "num_surface_sample": 128,
                             "augment_noise": [0.025, 40.0]}])
    return hyper


def plain_run(hyper: dict, save_dir: Path) -> dict:
    """The single-process trainer in this process, each parameter's
    smallest gradient size over its steps recorded."""
    from difusion_tpu_torch.train import trainer as TR
    small = {}
    loss_and_grads = TR.loss_and_grads

    def recording(*args, **kwargs):
        losses, grads = loss_and_grads(*args, **kwargs)
        for name, g in grads.items():
            small[name] = torch.minimum(small[name], g.abs()) if name in small else g.abs()
        return losses, grads
    TR.loss_and_grads = recording
    try:
        t0 = time.perf_counter()
        # log_every as the trainer's command line has it
        state = TR.train(dict(hyper, save_dir=str(save_dir)), device="cuda")
        seconds = time.perf_counter() - t0
    finally:
        TR.loss_and_grads = loss_and_grads
    if state.step != STEPS:
        fail(f"plain trainer took {state.step} steps, not {STEPS}")
    return {"seconds": seconds, "small_grad": {n: g.cpu().numpy() for n, g in small.items()}}


def torchrun(hyper: dict, save_dir: Path, nproc: int) -> float:
    cfg = save_dir.with_suffix(".json")
    cfg.write_text(json.dumps(dict(hyper, save_dir=str(save_dir))))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(nproc), "-m",
                           "difusion_tpu_torch.train.trainer", str(cfg)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"torchrun on {nproc} ranks exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return time.perf_counter() - t0


def compare(one: Path, two: Path, small_grad: dict) -> dict:
    """``two``'s files against the plain run's in ``one`` (module docstring)."""
    from difusion_tpu_torch.utils.adam import EPS
    names = sorted(p.name for p in one.iterdir())
    rows = [[json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
            for run in (one, two)]
    loss_ok = len(rows[0]) == len(rows[1]) and all(
        np.allclose(b[k], a[k], rtol=1e-4, atol=1e-6) for a, b in zip(*rows)
        for k in ("ll", "reg", "surface_abs_sdf", "total"))
    n_all, off_names, n_off, worst, grad_off, bit_equal = 0, [], 0, 0.0, 0.0, True
    with np.load(one / "prior_1.npz") as x, np.load(two / "prior_1.npz") as y:
        for key in x.files:
            diff = np.abs(x[key] - y[key])
            bit_equal &= bool(np.array_equal(x[key], y[key]))
            n_all, worst = n_all + diff.size, max(worst, float(diff.max()))
            off = diff > 1e-5
            if off.any():
                name = (key.replace("decoder.", "dec.", 1).replace("encoder.", "enc.", 1)
                        .replace("#", "."))
                g = small_grad.get(name)
                grad_off = max(grad_off, float("inf") if g is None else float(g[off].max()))
                n_off += int(off.sum())
                off_names.append(key)
    for f in names:
        if f.endswith(".npz") and f != "prior_1.npz":
            with np.load(one / f) as x, np.load(two / f) as y:
                bit_equal &= set(x.files) == set(y.files) and all(
                    np.array_equal(x[k], y[k]) for k in x.files)
    return {"files_same": sorted(p.name for p in two.iterdir()) == names,
            "logged_rows": len(rows[0]), "losses_within_1e-4": loss_ok,
            "params_max_abs_diff": worst,
            "entries": n_all, "entries_beyond_1e-5": n_off, "leaves_beyond": off_names,
            "max_abs_grad_beyond": grad_off, "npz_bit_equal": bit_equal,
            "ok": loss_ok and worst <= 1e-3 and grad_off < LR * EPS / 1e-5 - EPS
            and n_off <= 1e-4 * n_all}


def train_parts(n_cards: int) -> list:
    corpus = WORK / "corpus"
    sphere_corpus(corpus, BATCH * STEPS)
    hyper = train_hyper(corpus)
    plain = plain_run(hyper, WORK / "plain")
    out = []
    runs = [("dp", n_cards)] + ([("sit_out", n_cards - 1)] if n_cards >= 3 else [])
    for part, nproc in runs:
        seconds = torchrun(hyper, WORK / part, nproc)
        row = {"part": part, "ranks": nproc, "mesh": math.gcd(BATCH, nproc),
               "seconds": seconds, "plain_seconds": plain["seconds"],
               **compare(WORK / "plain", WORK / part, plain["small_grad"])}
        emit(row)
        if not row["files_same"] or not row["ok"]:
            fail(f"{part}: the torchrun files differ from the plain trainer's: {row}")
        if part == "sit_out" and not row["npz_bit_equal"]:
            fail(f"sit_out: rank 0 alone differs from the plain trainer: {row}")
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# second_card
# ---------------------------------------------------------------------------


def second_card_part() -> dict:
    """The tracker on cuda:1 after cuda:0 from one process whose current
    card is cuda:0 (module docstring, part 4)."""
    from chip_smoke import CHUNK, Replay, check_mesh, run_chunked
    from difusion_tpu_torch.config import apply_override, load_yaml_args
    from difusion_tpu_torch.core.meshing import MeshExtractor
    from difusion_tpu_torch.data.production import mesh_error_stats, open_sequence
    from difusion_tpu_torch.ops import _build
    from difusion_tpu_torch.slam import SLAMSystem
    from difusion_tpu_torch.utils.cudagraph import WARM_UP_PASSES

    torch.cuda.set_device(0)
    args = load_yaml_args(str(ROOT / "configs/fusion-synthetic.yaml"))
    apply_override(args, f"training_hypers={HYPER}")
    seq = open_sequence(args.sequence_type, **dict(args.sequence_kwargs, n_frames=FRAMES))
    frames = list(seq)

    def system(device, window):
        built = SLAMSystem.from_config(args, seq.calib, seq.first_iso, capacity=1 << 16,
                                       point_budget=8192, meshing=False, device=device)
        if window == built.tracker.tcfg.stencil_window:
            return built
        # the window is no key of the fusion config (neither package reads
        # one): the same system with the tracker's window replaced
        return SLAMSystem(built.map_cfg, built.tracker.tcfg._replace(stencil_window=window),
                          built.decoder, built.encoder, seq.calib,
                          integrate_interval=built.integrate_interval,
                          depth_cut=(built.tracker.tcfg.depth_cut_min,
                                     built.tracker.tcfg.depth_cut_max),
                          meshing=False, device=device)

    row = {"part": "second_card", "frames": FRAMES, "chunk": CHUNK, "runs": []}
    kept, problems = {}, []
    for window in WINDOWS:
        for card in (0, 1):
            device = torch.device("cuda", card)
            sys_ = system(device, window)
            _build.reset_launch_counts()
            run = run_chunked(sys_, Replay(seq, frames), FRAMES)
            counts = _build.launch_counts()
            result = run["result"]
            poses = [t.cpu() for t in sys_.tracker.pose_history()]
            kept[window, card] = (sys_, poses)
            r = {"window": window, "device": str(sys_.device),
                 "current_device": torch.cuda.current_device(),
                 "ms_per_frame": run["ms_per_frame"], "run_s": run["run_s"],
                 "launches": counts, "exit_flags_read": sys_.tracker.n_host_syncs,
                 "ate_rmse_m": result["ate_rmse"], "n_occupied": result["n_voxels"]}
            row["runs"].append(r)
            want2 = FRAMES + WARM_UP_PASSES
            if counts.get("window_stat_sums", 0) != want2:
                problems.append(f"{r['device']} w={window}: kernel 2 launched "
                                f"{counts.get('window_stat_sums', 0)} times, not {want2}")
            if counts.get("decode_grad_fused", 0) < 2 * (FRAMES - 1):
                problems.append(f"{r['device']} w={window}: kernel 1 launched "
                                f"{counts.get('decode_grad_fused', 0)} times")
            if sys_.tracker.n_host_syncs or not result["ate_rmse"] <= 0.05:
                problems.append(f"{r['device']} w={window}: {r['exit_flags_read']} exit "
                                f"flags read, ATE {result['ate_rmse']}")
        equal = all(torch.equal(a, b) for a, b in zip(kept[window, 0][1], kept[window, 1][1]))
        row[f"poses_equal_w{window}"] = equal
        if not equal:
            problems.append(f"w={window}: the cards' poses differ")
    meshes = {}
    for card in (0, 1):
        sys_ = kept[WINDOWS[0], card][0]
        mesher = MeshExtractor(sys_.map_cfg, sys_.decoder, voxel_resolution=4,
                               max_triangles=int(4e6))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        mesher.extract(sys_.state, max_std=0.15)
        torch.cuda.synchronize(sys_.device)
        tris = mesher.triangles()
        merr = mesh_error_stats(tris[0])
        meshes[card] = {"device": str(sys_.device), "ms": (time.perf_counter() - t0) * 1e3,
                        "triangles": len(tris[0]),
                        "kernel3_launches": _build.launch_counts().get("decode_fused", 0),
                        "decode_dispatches": mesher.last_stats["decode_dispatches"],
                        "mesh_err_p95": merr["mesh_err_p95"], "tris": tris}
        check_mesh(f"second_card extract on {sys_.device}", tris[0], merr)
        m = meshes[card]
        if m["kernel3_launches"] < 1 or m["kernel3_launches"] != m["decode_dispatches"]:
            problems.append(f"extract on {m['device']}: kernel 3 launched "
                            f"{m['kernel3_launches']} times for {m['decode_dispatches']} "
                            "decode dispatches")
    row["triangles_equal"] = all(
        np.array_equal(a, b) for a, b in zip(meshes[0]["tris"], meshes[1]["tris"]))
    row["extracts"] = [{k: v for k, v in m.items() if k != "tris"} for m in meshes.values()]
    if not row["triangles_equal"]:
        problems.append("the cards' extracts differ")
    emit(row)
    if problems:
        fail("second_card: " + "; ".join(problems))
    return row


# ---------------------------------------------------------------------------
# tp2, tp4
# ---------------------------------------------------------------------------


def tp_parts(n_cards: int) -> dict:
    """train_step on make_mesh(N, tp) over NCCL against this process (module
    docstring, part 5)."""
    from chip_smoke import first_batch, parallel_steps

    hyper = train_hyper(WORK / "corpus")
    sdf, surf = first_batch(hyper)
    cases = tuple((f"tp{tp}", n_cards, tp, TP_STEPS, TP_TOL) for tp in (2, 4)
                  if n_cards % tp == 0)
    rows = parallel_steps(hyper, sdf, surf, torch.device("cuda", 0), cases, "tp",
                          backend="nccl")
    for label, r in rows.items():
        emit({"part": label, "batch": list(sdf.shape), **r})
    return rows


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("multi_card_check: needs two or more CUDA cards", file=sys.stderr)
        return 2
    if not HYPER.exists():
        print(f"multi_card_check: {HYPER} is missing (run from the repo)", file=sys.stderr)
        return 2
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    card = smi()
    n_cards = torch.cuda.device_count()
    shard_part(n_cards)
    second_card_part()
    train_parts(n_cards)
    tp_parts(n_cards)
    print(card)
    print(json.dumps({"ok": True, "cards": n_cards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
