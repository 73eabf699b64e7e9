"""Every decoder family of the benchmark's plain reference
(``benchmark/reference/decoders/*.py``) holds to the reference's isolation
rule: it imports nothing of the port, of the JAX package or of JAX, so that
what it computes is independent of the code it judges."""
import ast
from pathlib import Path

import pytest

DECODERS = Path(__file__).resolve().parents[1] / "benchmark" / "reference" / "decoders"
FORBIDDEN = {"difusion_tpu_torch", "difusion_tpu", "jax", "jaxlib", "flax"}


def _imports(path: Path):
    """Top-level names of every import, relative ones (``from .x``) as the
    benchmark's own package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module.split(".")[0] if node.level == 0 and node.module else "benchmark"
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(DECODERS.glob("*.py")), ids=lambda p: p.name)
def test_a_decoder_family_imports_nothing_of_the_port_or_jax(path):
    assert not set(_imports(path)) & FORBIDDEN, path


def test_every_family_file_is_scanned():
    """The three families the port runs, and the loader, are among them."""
    names = {p.stem for p in DECODERS.glob("*.py")}
    assert {"__init__", "di_decoder", "onet_cbn", "pigan_film"} <= names
