#!/usr/bin/env python3
"""Measure the bf16 mode of kernels 1 and 3 (difusion_tpu_torch/csrc/
decoder_bf16.cu) on the card, against an earlier tree and step by step.

    python3 decoder_tune.py [--bf16-parent DIR] [--f32-parent DIR] [--stamps]

from the repo root, on a machine with a CUDA card and nvcc.  DIR is the
``csrc`` directory of an earlier tree, e.g. from
``git archive <commit> difusion_tpu_torch/csrc | tar -x -C <dir>``; its
``decoder_grad.cu`` is built as it stands, with its own headers.

``--bf16-parent``: DIR's ``decoder_grad.cu`` still has the bf16 mode's
earlier design (entries ``decode_grad_bf16_launch`` / ``decode_fwd_bf16_launch``:
the 3xTF32 body with bf16 ``mma.sync`` fragments streamed through its weight
ring), which takes its own re-lay of the bf16 pack (:func:`ring_pack`).  Its
outputs are held to the plain bf16 versions (sdf/std within 2e-3, gradient
rows within 0.15 + 0.05 |ref|), then kernel 1 at N = 8192 and kernel 3 at
N = 2^20 are timed by CUDA-graph replay (``_timing.graph_ms``) in turns:
parent, kernel, kernel, parent, on the same inputs.

``--f32-parent``: today's f32 kernels 1 and 3 against DIR's on the same
inputs (N = 8193 and 2^20 + 3): whether each output is ``torch.equal``, and
both builds' ptxas registers.

``--stamps``: builds kernel 1 with ``clock64()`` stamps after each step of
block 0's tile and prints the cycles since the kernel's start at N = 64 and
8192; a step whose stamp was not written fails the run.

One JSON line per measurement, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from difusion_tpu_torch.models.weights import load_prior
from difusion_tpu_torch.ops import _build
from difusion_tpu_torch.ops import decoder_fused as F
from difusion_tpu_torch.ops._timing import graph_ms

HYPER = Path(__file__).resolve().parent / "di-checkpoints/study_mixed/hyper.json"
OUT = _build.BUILD_DIR.parent / "decoder_tune"
# the steps of kernel 1's tile that --stamps marks
STEP = re.compile(r"(wait\(\d\);|gemm<[^;]*;|bias_relu<[^;]*;|mask_round<[^;]*;"
                  r"|xyz_dot\([^;]*;|\[row\] = [^;]*;)")
N_STAMPS = 40


def nvcc(label: str, source: Path) -> tuple:
    """``source`` compiled into OUT/label/lib.so: (library, ptxas lines)."""
    d = OUT / label
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                           str(source)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"{label}: nvcc failed\n{log}")
    return ctypes.CDLL(str(d / "lib.so")), [ln.strip() for ln in log.splitlines()
                                            if "Used" in ln or "spill stores" in ln
                                            or "wgmma" in ln]


def entry(lib, name: str, grad: bool):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * (5 + grad) + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run(fn, packed, lat, rel, grad: bool):
    n = lat.shape[0]
    outs = [torch.empty(n, device=lat.device) for _ in range(2)]
    if grad:
        outs.append(torch.empty(n, 3, device=lat.device))
    if n:
        _build.check(fn(lat.data_ptr(), rel.data_ptr(), packed.data_ptr(),
                        *(o.data_ptr() for o in outs), n,
                        torch.cuda.current_stream().cuda_stream), "decoder_tune")
    return outs


def inputs(n: int, seed: int, grad: bool):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lat = torch.randn(n, 29, generator=gen, device="cuda") * 0.3
    rel = torch.rand(n, 3, generator=gen, device="cuda")
    return lat, (rel - 0.5 if grad else rel * 1.75 - 1.0)


def ring_pack(packed: torch.Tensor) -> torch.Tensor:
    """A bf16 pack with the kernels' segment re-laid as the earlier design's
    m16n8k16 B fragments: lane 4g + t of (k-tile kt, n-tile nt) holds
    W[16kt + 2t, +1] and W[16kt + 8 + 2t, +1] of column 8nt + g."""
    p = F.unpack(packed)
    frags = []
    for name in F.TC_LAYERS:
        k, n = p[name].shape
        v = p[name].reshape(k // 16, 2, 4, 2, n // 8, 8).permute(0, 4, 5, 2, 1, 3)
        frags.append(v.reshape(-1).to(torch.bfloat16))
    tc = torch.cat(frags)
    return torch.cat([packed[:packed.numel() - tc.numel() // 2], tc.view(torch.float32)])


def bf16_against(lib, packed) -> list:
    """DIR's bf16 kernels on :func:`ring_pack` held to the plain versions,
    then timed in turns with today's kernels."""
    if lib.decode_grad_packed_size_bf16() != F.PACKED_SIZE_BF16:
        raise RuntimeError("the parent's bf16 pack has another size")
    ring = ring_pack(packed)
    rows = []
    for grad, n, calls in ((True, 8192, 50), (False, 1 << 20, 5)):
        name = "decode_grad_bf16" if grad else "decode_fwd_bf16"
        parent = entry(lib, name + "_launch", grad)
        lat, rel = inputs(n, 1, grad)
        got = run(parent, ring, lat, rel, grad)
        ref = (F.decode_grad_plain if grad else F.decode_fused_plain)(packed, lat, rel)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got[:2], ref[:2]))
        if err > 2e-3 or (grad and bool(((got[2] - ref[2]).abs()
                                         > 0.15 + 0.05 * ref[2].abs()).any())):
            raise RuntimeError(f"the parent's {name} is off its plain version ({err:.3g})")
        ours = F.decode_grad_fused if grad else F.decode_fused
        times = {"parent": [], "kernel": []}
        for who in ("parent", "kernel", "kernel", "parent"):
            fn = ((lambda: run(parent, ring, lat, rel, grad)) if who == "parent"
                  else (lambda: ours(packed, lat, rel)))
            times[who].append(graph_ms(fn, calls))
        rows.append({"kernel": name, "n": n, "parent_max_abs_err": err, "ms_in_turns": times})
    return rows


def f32_against(lib, parent_ptxas) -> dict:
    """Today's f32 kernels 1 and 3 against DIR's on the same inputs
    (N = 8193 and 2^20 + 3): whether each output is ``torch.equal``, and
    both builds' ptxas lines."""
    dec, _, _ = load_prior(HYPER, 300, device="cuda")
    packed = F.pack_fused_decoder(dec)
    out = {"parent_ptxas": [ln for ln in parent_ptxas if "Used" in ln]}
    for name, grad, n in (("decode_grad_launch", True, 8193),
                          ("decode_fwd_launch", False, (1 << 20) + 3)):
        lat, rel = inputs(n, 5, grad)
        old = run(entry(lib, name, grad), packed, lat, rel, grad)
        new = (F.decode_grad_fused if grad else F.decode_fused)(packed, lat, rel)
        torch.cuda.synchronize()
        out[f"{name}_equal"] = all(torch.equal(a, b) for a, b in zip(old, new))
    out["ptxas"] = [ln for ln in _build.build_info.get("decoder_grad", {}).get("ptxas", [])
                    if "Used" in ln]
    return out


def stamped(text: str) -> tuple:
    """The source with a clock64() stamp after kernel 1's arming, its input
    load and each step of its tile (block 0), and the steps' labels."""
    text = text.replace("namespace {\n", f"__device__ long long g_stamps[{N_STAMPS}];\n"
                        "#define STAMP(i) if (blockIdx.x == 0) g_stamps[i] = clock64();\n"
                        "namespace {\n", 1)
    start = text.index("template <bool GRAD>\n__device__ __forceinline__ void tile(")
    end = text.index("// Kernel 1: one 64-row tile", start)
    labels = ["start", "weights armed", "inputs packed"]

    def mark(m):
        labels.append(m.group(0)[:48])
        return m.group(0) + f" STAMP({len(labels) - 1});"
    body = STEP.sub(mark, text[start:end])
    text = text[:start] + body + text[end:]
    for old, new in (("  arm_weights<NMAT, NFWD>(smem, bars, P);\n",
                      "  STAMP(0);\n  arm_weights<NMAT, NFWD>(smem, bars, P);\n  STAMP(1);\n"),
                     ("  pack_x(v, xa);\n  tile<true>",
                      "  pack_x(v, xa);\n  STAMP(2);\n  tile<true>")):
        if old not in text:
            raise RuntimeError(f"decoder_tune: the source no longer has {old!r}")
        text = text.replace(old, new, 1)
    if len(labels) > N_STAMPS:
        raise RuntimeError(f"decoder_tune: {len(labels)} steps, {N_STAMPS} stamps")
    text += ('\nextern "C" void clear_stamps() { static const long long z['
             f'{N_STAMPS}] = {{}}; cudaMemcpyToSymbol(g_stamps, z, sizeof(z)); }}\n'
             'extern "C" void read_stamps(long long* out) '
             '{ cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)); }\n')
    return text, labels


def stamps(packed) -> list:
    """Kernel 1's step cycles at N = 64 and 8192 (the fifth launch of each)."""
    text, labels = stamped((_build.CSRC / "decoder_bf16.cu").read_text())
    d = OUT / "stamps_src"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d, ignore=shutil.ignore_patterns("*.cu"))
    (d / "decoder_bf16.cu").write_text(text)
    lib, ptxas = nvcc("stamps", d / "decoder_bf16.cu")
    fn = entry(lib, "decode_grad_bf16_launch", True)
    rows = []
    for n in (64, 8192):
        lat, rel = inputs(n, 2, True)
        for _ in range(4):
            run(fn, packed, lat, rel, True)
        torch.cuda.synchronize()
        lib.clear_stamps()
        run(fn, packed, lat, rel, True)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * N_STAMPS)()
        lib.read_stamps(buf)
        missing = [lab for i, lab in enumerate(labels) if buf[i] == 0]
        if missing:
            raise RuntimeError(f"decoder_tune: no stamp written after {missing}")
        rows.append({"stamps": n, "ptxas": ptxas, "cycles_since_start":
                     [[lab, buf[i] - buf[0]] for i, lab in enumerate(labels)]})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16-parent", type=Path,
                    help="csrc of a tree whose decoder_grad.cu has the earlier bf16 mode")
    ap.add_argument("--f32-parent", type=Path, help="csrc of an earlier tree")
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"gpu": smi, "torch": torch.__version__}), flush=True)

    parents = {}
    for d in {args.bf16_parent, args.f32_parent} - {None}:
        parents[d] = nvcc(f"parent{len(parents)}", d / "decoder_grad.cu")
        print(json.dumps({"build": str(d), "ptxas": parents[d][1]}), flush=True)
    dec, _, _ = load_prior(HYPER, 300, device="cuda")
    packed = F.pack_fused_decoder(dec, torch.bfloat16)
    if args.bf16_parent:
        for row in bf16_against(parents[args.bf16_parent][0], packed):
            print(json.dumps({"bf16_against_parent": str(args.bf16_parent), **row}), flush=True)
    if args.f32_parent:
        print(json.dumps({"f32_against_parent": str(args.f32_parent),
                          **f32_against(*parents[args.f32_parent])}), flush=True)
    if args.stamps:
        for row in stamps(packed):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
