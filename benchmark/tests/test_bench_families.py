"""The prior's decoder family as a file of its own
(``benchmark/reference/decoders/<network_name>.py``): the reference and the
work counts find it by the hyper's name, ``di_decoder`` decodes and counts
as the harness always did, and a new family needs no edit of any other
file."""
import ast
import filecmp
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import flops
from benchmark.reference.prior import Prior

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PRIORS = {"study_mixed": 300, "deepsdf_mixed": 100}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _written_out(hyper_path: Path, epoch: int, precision: str):
    """The ``di_decoder`` reference as the harness wrote it before families
    were files: the weight-normed layers folded in float64, the input fed
    again at ``latent_in``, the std head on the last hidden layer, every
    product through the precision's affine map."""
    hyper = json.loads(hyper_path.read_text())
    with np.load(hyper_path.parent / f"prior_{epoch}.npz") as data:
        w = {k: data[k] for k in data.files}
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    latent_in = set(hyper["network_specs"].get("latent_in") or ())
    dec = []
    i = 0
    while f"decoder.layers#{i}.b" in w:
        b = w[f"decoder.layers#{i}.b"].astype(np.float64)
        if f"decoder.layers#{i}.g" in w:
            v = w[f"decoder.layers#{i}.v"].astype(np.float64)
            g = w[f"decoder.layers#{i}.g"].astype(np.float64)
            W = g[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
        else:
            W = w[f"decoder.layers#{i}.w"].astype(np.float64)
        dec.append((t(W), t(b)))
        i += 1
    unc = (t(w["decoder.uncertainty.w"]), t(w["decoder.uncertainty.b"]))
    r = (lambda x: x.to(torch.bfloat16).to(torch.float32)) if precision == "bf16" else (
        lambda x: x)

    def lin(x, Wb):
        W, b = Wb
        if precision == "tf32":
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return x @ W.T + b
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
        return r(r(x) @ r(W).T + r(b))

    def decode(latent, xyz):
        inp = torch.cat([latent, xyz], dim=1)
        x = inp
        std = None
        last = len(dec) - 1
        for i, Wb in enumerate(dec):
            if i in latent_in:
                x = torch.cat([x, inp], dim=1)
            if i == last:
                std = 0.05 + 0.5 * torch.nn.functional.softplus(lin(x, unc))
            x = lin(x, Wb)
            if i < last:
                x = torch.relu(x)
        return torch.tanh(x)[:, 0], std[:, 0]

    return decode


def _values_and_grads(decode, latent, xyz):
    xyz = xyz.clone().requires_grad_(True)
    sdf, std = decode(latent, xyz)
    g_sdf, = torch.autograd.grad(sdf.sum(), xyz, retain_graph=True)
    g_std, = torch.autograd.grad(std.sum(), xyz)
    return sdf.detach(), std.detach(), g_sdf, g_std


@pytest.mark.parametrize("precision", ["f32", "tf32", "bf16"])
@pytest.mark.parametrize("name", sorted(PRIORS))
def test_di_decoder_decodes_bit_for_bit_as_before(name, precision):
    hyper_path = ROOT / "di-checkpoints" / name / "hyper.json"
    ref = Prior(hyper_path, PRIORS[name], "cpu", precision)
    old = _written_out(hyper_path, PRIORS[name], precision)
    g = torch.Generator().manual_seed(24)
    L = int(ref.hyper["code_length"])
    latent = torch.randn(300, L, generator=g) * 0.3
    xyz = torch.rand(300, 3, generator=g) * 1.75 - 1.0
    got = _values_and_grads(ref.decode, latent, xyz)
    want = _values_and_grads(old, latent, xyz)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[2].abs().max()) > 0


# name: forward, forward + d sdf/d xyz, weights' bytes, code length (the
# kernel table's hand counts, PERF.md section 3 and tests/test_bench_flops.py)
COUNTS = {"study_mixed": (98_816, 182_528, 199_560, 29),
          "deepsdf_mixed": (3_672_064, 6_818_816, 7_359_484, 256)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_di_decoder_counts_as_the_hand_counts(name):
    hyper = json.loads((ROOT / "di-checkpoints" / name / "hyper.json").read_text())
    fwd, grad, params, L = COUNTS[name]
    assert flops.decoder_fwd_flops(hyper) == fwd
    assert flops.decoder_grad_flops(hyper) == grad
    assert flops.decoder_param_bytes(hyper) == params
    # a point reads its code and xyz and writes sdf, std (and the xyz
    # gradient): 4 bytes each
    assert flops.decode_grad_bytes(hyper, 8192) == 4 * 8192 * (L + 3 + 5) + params
    assert flops.decode_fwd_bytes(hyper, 1 << 20) == 4 * (1 << 20) * (L + 3 + 2) + params
    assert flops.decoder_layers(hyper)[0] == (L + 3, int(hyper["network_specs"]["dims"][0]))


TOY = '''"""toy_resnet: the code as a shift after the input layer, two residual
blocks, and a head of two outputs (sdf, std)."""
import torch


def build(w, hyper, lin, tensors):
    fc_p = tensors(w["decoder.fc_p.w"], w["decoder.fc_p.b"])
    fc_c = tensors(w["decoder.fc_c.w"], w["decoder.fc_c.b"])
    blocks = [(tensors(w[f"decoder.blocks#{i}.fc_0.w"], w[f"decoder.blocks#{i}.fc_0.b"]),
               tensors(w[f"decoder.blocks#{i}.fc_1.w"], w[f"decoder.blocks#{i}.fc_1.b"]))
              for i in range(2)]
    out = tensors(w["decoder.fc_out.w"], w["decoder.fc_out.b"])

    def decode(latent, xyz):
        net = lin(xyz, *fc_p) + lin(latent, *fc_c)
        for f0, f1 in blocks:
            net = net + lin(torch.relu(lin(torch.relu(net), *f0)), *f1)
        o = lin(torch.relu(net), *out)
        return torch.tanh(o[:, 0]), 0.05 + 0.5 * torch.nn.functional.softplus(o[:, 1])

    return decode


def fwd_flops(hyper):
    h, L = hyper["hidden"], hyper["code_length"]
    return 2 * (3 * h + L * h + 4 * h * h + 2 * h)


def grad_flops(hyper):
    h = hyper["hidden"]
    return fwd_flops(hyper) + 2 * (h + 4 * h * h + 3 * h)


def param_bytes(hyper):
    h, L = hyper["hidden"], hyper["code_length"]
    return 4 * (4 * h + (L + 1) * h + 4 * (h * h + h) + 2 * h + 2)


def fwd_point_floats(hyper):
    return hyper["code_length"] + 3 + 2


def grad_point_floats(hyper):
    return hyper["code_length"] + 3 + 5
'''

RUN_COPY = '''import json, sys
from types import SimpleNamespace
import torch
import benchmark
from benchmark import flops, run
from benchmark.reference.prior import Prior

torch.set_num_threads(1)
p = Prior(sys.argv[1], 1, "cpu")
g = torch.Generator().manual_seed(7)
lat = torch.randn(64, 4, generator=g)
xyz = torch.rand(64, 3, generator=g).requires_grad_(True)
sdf, std = p.decode(lat, xyz)
grad, = torch.autograd.grad(sdf.sum(), xyz)
code = p.encode(torch.randn(5, 6, generator=g))


class Trace:
    def kernel_time(self, part):
        return (2, 1e-3) if part == "decode_grad_kernel" else (0, 0.0)


ctx = SimpleNamespace(trace=Trace(), flops=flops, hyper=p.hyper, peaks=json.loads(sys.argv[2]),
                      cfg={"assumed": {"point_budget": 100}})
print(json.dumps({"file": benchmark.__file__, "sdf": sdf.tolist(), "std": std.tolist(),
                  "grad": grad.tolist(), "code": list(code.shape),
                  "fwd": flops.decoder_fwd_flops(p.hyper), "grad_flops": flops.decoder_grad_flops(p.hyper),
                  "params": flops.decoder_param_bytes(p.hyper),
                  "grad_bytes": flops.decode_grad_bytes(p.hyper, 100),
                  "fwd_bytes": flops.decode_fwd_bytes(p.hyper, 10),
                  "roofline": run.load_reader("decode_grad_roofline")(ctx)}))
'''


def _toy_prior(out: Path, h: int = 8, L: int = 4) -> dict:
    g = np.random.default_rng(3)
    m = lambda *s: g.standard_normal(s).astype(np.float32) * 0.5  # noqa: E731
    w = {"decoder.fc_p.w": m(h, 3), "decoder.fc_p.b": m(h), "decoder.fc_c.w": m(h, L),
         "decoder.fc_c.b": m(h), "decoder.fc_out.w": m(2, h), "decoder.fc_out.b": m(2),
         "encoder.layers#0.w": m(5, 6), "encoder.layers#0.b": m(5),
         "encoder.layers#1.w": m(L, 5), "encoder.layers#1.b": m(L)}
    for i in range(2):
        for f in ("fc_0", "fc_1"):
            w[f"decoder.blocks#{i}.{f}.w"] = m(h, h)
            w[f"decoder.blocks#{i}.{f}.b"] = m(h)
    out.mkdir()
    np.savez(out / "prior_1.npz", **w)
    hyper = {"network_name": "toy_resnet", "code_length": L, "hidden": h,
             "encoder_specs": {"per_point_feat": [6, 5]}}
    (out / "hyper.json").write_text(json.dumps(hyper))
    return w


def _toy_decode(w, lat, xyz):
    """The toy family's equations, written out in float64."""
    W = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in w.items()}
    lin = lambda x, k: x @ W[k + ".w"].T + W[k + ".b"]  # noqa: E731
    net = lin(xyz, "decoder.fc_p") + lin(lat, "decoder.fc_c")
    for i in range(2):
        net = net + lin(torch.relu(lin(torch.relu(net), f"decoder.blocks#{i}.fc_0")),
                        f"decoder.blocks#{i}.fc_1")
    o = lin(torch.relu(net), "decoder.fc_out")
    return torch.tanh(o[:, 0]), 0.05 + 0.5 * torch.nn.functional.softplus(o[:, 1])


def test_a_new_decoder_family_is_one_new_file(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "reference" / "decoders" / "toy_resnet.py").write_text(TOY)
    w = _toy_prior(tmp_path / "prior")
    peaks = {"tf32_flops_per_s": 1e12, "bytes_per_s": 1e12}
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", RUN_COPY, str(tmp_path / "prior" / "hyper.json"),
                          json.dumps(peaks)], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(got["file"]).resolve() == (copy / "__init__.py").resolve()
    # every other file of the copy as it was
    cmp = filecmp.dircmp(BENCH, copy, ignore=["__pycache__"])

    def differ(c):
        return (c.left_only + c.right_only + c.diff_files + c.funny_files
                + [x for s in c.subdirs.values() for x in differ(s)])
    assert differ(cmp) == ["toy_resnet.py"]
    g = torch.Generator().manual_seed(7)
    lat = torch.randn(64, 4, generator=g).double()
    xyz = torch.rand(64, 3, generator=g).double().requires_grad_(True)
    sdf, std = _toy_decode(w, lat, xyz)
    grad, = torch.autograd.grad(sdf.sum(), xyz)
    np.testing.assert_allclose(got["sdf"], sdf.detach().numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["std"], std.detach().numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["grad"], grad.numpy(), atol=1e-5, rtol=0)
    assert float(sdf.detach().std()) > 0.05 and float(grad.abs().max()) > 0.05
    assert got["code"] == [5, 4]
    h, L = 8, 4
    fwd = 2 * (3 * h + L * h + 4 * h * h + 2 * h)
    params = 4 * (4 * h + (L + 1) * h + 4 * (h * h + h) + 2 * h + 2)
    assert got["fwd"] == fwd and got["grad_flops"] == fwd + 2 * (h + 4 * h * h + 3 * h)
    assert got["params"] == params
    assert got["grad_bytes"] == 4 * 100 * (L + 8) + params
    assert got["fwd_bytes"] == 4 * 10 * (L + 5) + params
    # the reader, unedited, counts two launches of the toy's kernel 1 at 100
    # points: each bound by its bytes at these peaks, over 1 ms
    bound = max(100 * got["grad_flops"] / 1e12, got["grad_bytes"] / 1e12)
    assert got["roofline"] == pytest.approx(100.0 * 2 * bound / 1e-3, rel=1e-12)


@pytest.mark.parametrize("name", ["no_such_family", "../prior"])
def test_an_unknown_family_stops_with_the_file_to_add(tmp_path, name):
    hyper = json.loads((ROOT / "di-checkpoints/study_mixed/hyper.json").read_text())
    hyper["network_name"] = name
    (tmp_path / "hyper.json").write_text(json.dumps(hyper))
    shutil.copy(ROOT / "di-checkpoints/study_mixed/prior_300.npz", tmp_path / "prior_300.npz")
    want = f"benchmark/reference/decoders/{name}.py"
    with pytest.raises(SystemExit, match=want.replace(".", r"\.")):
        Prior(tmp_path / "hyper.json", 300, "cpu")
    with pytest.raises(SystemExit, match=want.replace(".", r"\.")):
        flops.decoder_grad_flops(hyper)


def test_a_hyper_without_a_name_is_di_decoder():
    hyper = json.loads((ROOT / "di-checkpoints/study_mixed/hyper.json").read_text())
    named = flops.decoder_grad_flops(hyper)
    del hyper["network_name"]
    assert flops.decoder_grad_flops(hyper) == named == 182_528


def test_the_families_import_nothing_of_the_port():
    for path in (BENCH / "reference" / "decoders").glob("*.py"):
        tree = ast.parse(path.read_text())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops.add(node.module.split(".")[0])
        assert not tops & {"difusion_tpu_torch", "difusion_tpu", "jax", "jaxlib", "flax"}, path
