#!/usr/bin/env python3
"""Time the design choices of kernel 2 (difusion_tpu_torch/csrc/window_stats.cu)
on the card.

    python3 stencil_tune.py [--shape H W] [--window W] [--baseline OLD.cu]
        [--other LABEL=SOURCE.cu ...] [--sass DIR]

from the repo root, on a machine with a CUDA card and nvcc.  For each
rows-per-thread value of ``stencil.ROWS`` that the window admits it checks all
11 planes with ``torch.equal`` against the plain version and times the
four-plane and the point-map entry by CUDA-graph replay (``_timing.graph_ms``)
on a seeded corrugated-plane point map at 2 m (at 240x320 its pixel spacing is
~8 mm, so nearly every tap passes the production radii, as on a rendered
frame), and says which value ``stencil.plan`` picks: the plan's cost model
holds where the planned value is the fastest.  ``--baseline`` times an earlier
version of the source (the 11-argument ``window_stats_launch`` without a rows
argument) in the same process, and ``--other`` another version with today's
interface, at the planned rows; ``--sass`` writes each build's disassembly
there and prints every kernel's instruction count and, per loop body, its
instructions and scheduled cycles.  One JSON line per measurement, the card's
name and power limit first, the SM clock under load last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from difusion_tpu_torch.ops import _build, stencil
from difusion_tpu_torch.ops._timing import graph_ms


def point_map(h, w, seed=0):
    """A corrugated plane at 2 m seen through a pinhole of ~90 degrees across
    the image, ~5% of the pixels invalid."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x, y = (u - w / 2) / (240.6 * w / 320), (v - h / 2) / (240.0 * w / 320)
    z = 2.0 + 0.1 * (np.sin(5 * 2 * x) + 0.7 * np.cos(4 * 2 * y)) \
        + 0.002 * rng.standard_normal((h, w))
    pc = np.stack([x * z, y * z, z], axis=-1).astype(np.float32)
    ok = rng.random((h, w)) > 0.05
    return torch.from_numpy(pc), torch.from_numpy(ok)


def sass_counts(lib: Path, out_dir: Path, label: str) -> dict:
    """Per kernel of ``lib`` (cuobjdump -sass): its SASS instructions, and for
    every loop body (a backward branch: from its target to itself) its
    instructions and the cycles ptxas scheduled for one pass of one warp (the
    sum of the stall counts in the instructions' control bits).  The text is
    kept in ``out_dir``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lines = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{label}.sass").write_text("\n".join(lines))
    kernels, name = {}, None
    for i, line in enumerate(lines):
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);\s*/\* 0x[0-9a-f]+ \*/", line)
        if name and m:
            # the instruction's upper word is on the next line; bits 41-44 of
            # it (105-108 of the instruction) are the stall count
            upper = re.search(r"/\* (0x[0-9a-f]+) \*/", lines[i + 1])
            stall = (int(upper.group(1), 16) >> 41) & 0xF if upper else 0
            kernels[name].append((int(m.group(1), 16), m.group(2), stall))
    counts = {}
    for name, ins in kernels.items():
        bodies = []
        for addr, op, _ in ins:
            bra = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if bra and int(bra.group(1), 16) <= addr:
                body = [x for x in ins if int(bra.group(1), 16) <= x[0] <= addr]
                bodies.append([len(body), sum(x[2] for x in body)])
        counts[name] = {"instructions": len(ins), "loop_bodies": bodies}
    return counts


def compile_variants(jobs: dict) -> dict:
    """One nvcc (the package's flags) for each ``label -> (source, library)``,
    all at once; per label the ptxas resource lines."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {label: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, (src, lib) in jobs.items()}
    info = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{log}")
        info[label] = {"ptxas": [ln.strip() for ln in log.splitlines()
                                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]}
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--other", action="append", default=[], metavar="LABEL=SOURCE")
    ap.add_argument("--sass", type=Path, default=None)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--shape", type=int, nargs=2, default=[240, 320], metavar=("H", "W"))
    args = ap.parse_args(argv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": smi}), flush=True)
    dev = torch.device("cuda")
    pc, ok = (t.to(dev) for t in point_map(*args.shape))
    planes = [torch.where(ok, pc[..., c], 0.0).contiguous() for c in range(3)]
    vf = ok.float()
    h, w = ok.shape
    r2 = (0.05 ** 2, 0.1 ** 2)
    ref = torch.stack(stencil.window_stat_sums_plain(*planes, vf, args.window, *r2))
    out = torch.empty_like(ref)
    # the package's own build of the source, then the variants
    info = {"current": _build.build_all().get("window_stats", {"ptxas": "built earlier"})}
    libs = {"current": _build._lib_path("window_stats")}
    variants = {}
    for spec in args.other:
        label, path = spec.split("=", 1)
        variants[label] = (Path(path), _build.BUILD_DIR / f"libwindow_stats_{label}.so")
    if args.baseline is not None:
        variants["baseline"] = (args.baseline,
                                _build.BUILD_DIR / "libwindow_stats_baseline.so")
    info.update(compile_variants(variants))
    libs.update({label: lib for label, (_, lib) in variants.items()})
    tail = [ctypes.c_int] * 3 + [ctypes.c_float] * 2
    planned = stencil.plan(h, w, args.window, stencil._n_sm(0)).rows
    all_equal = True
    for label, lib_path in libs.items():
        lib = ctypes.CDLL(str(lib_path))
        new = label != "baseline"
        entries = {"planes": (lib.window_stats_launch, (*planes, vf))}
        if new:
            entries["map"] = (lib.window_stats_map_launch, (pc, ok))
        sass = sass_counts(lib_path, args.sass, label) if args.sass else None
        print(json.dumps({"build": label, **info[label], "sass_instructions": sass}),
              flush=True)
        for entry, (fn, inputs) in entries.items():
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * (len(inputs) + 1) + tail \
                + [ctypes.c_int] * new + [ctypes.c_void_p]
            admitted = [r for r in stencil.ROWS if r <= 2 * args.window + 1]
            for rows in (admitted if label == "current" else (planned,)):
                extra = (rows,) if new else ()

                def call():
                    _build.check(fn(*(t.data_ptr() for t in inputs), out.data_ptr(), h, w,
                                    args.window, *r2, *extra,
                                    torch.cuda.current_stream().cuda_stream), label)
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                equal = torch.equal(out, ref)
                all_equal &= equal
                print(json.dumps({"build": label, "entry": entry, "shape": [h, w],
                                  "window": args.window, "rows": rows if new else None,
                                  "planned_rows": planned, "equal": equal,
                                  "ms": graph_ms(call, 50)}), flush=True)
    # the SM clock while the card runs the kernel: queue ~1 s of launches,
    # then ask nvidia-smi before they are done
    stencil.window_stat_sums(*planes, vf, args.window, *r2)
    for _ in range(60000):
        stencil.window_stat_sums_map(pc, ok, args.window, *r2)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    print(json.dumps({"under_load": clocks}), flush=True)
    return 0 if all_equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
