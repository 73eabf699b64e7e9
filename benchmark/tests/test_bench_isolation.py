"""What the benchmark loads: no JAX, no JAX package, and a reference that
takes nothing from the port."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"difusion_tpu_torch", "difusion_tpu", "jax", "jaxlib", "flax"}, path


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & {"difusion_tpu", "jax", "jaxlib", "flax"}, path


def test_a_run_leaves_no_jax_in_sys_modules():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(4)\n"
        "from benchmark import run\n"
        "from benchmark.tests import tiny\n"
        "spec = tiny.spec('lrkt-dense.export-r8', lap=40)\n"
        "res = run.run_cell(spec, 2 ** 33 + 5, 1.0, False, torch.device('cpu'))\n"
        "assert 'difusion_tpu_torch' in sys.modules\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole_top_level_names():
    from benchmark import run
    assert run.forbidden_modules(["difusion_tpu_torch", "difusion_tpu_torch.core",
                                  "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["difusion_tpu.core.map", "jax.numpy", "torch"]) == [
        "difusion_tpu", "jax"]


def test_without_the_port_the_run_exits_nonzero_and_prints_no_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "lrkt-dense.track-chunk12", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
