"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "difusion_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "stencil_tune.py", ROOT / "multi_card_check.py",
    ROOT / "decoder_tune.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "difusion_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_port_runs_without_loading_jax():
    """Importing the port (the prior pipeline's modules too), decoding with
    the in-repo prior, the optimizer's sort-based unique (``ops/segment.py``),
    a train step and an SDF pass leave jax out of sys.modules."""
    code = (
        "import sys, torch\n"
        "from difusion_tpu_torch.slam import SLAMSystem, load_prior\n"
        "dec, enc, spec = load_prior('di-checkpoints/study_mixed/hyper.json', 300,"
        " device='cpu')\n"
        "sdf, std = dec.decode(torch.zeros(4, 29), torch.zeros(4, 3))\n"
        "assert sdf.shape == (4,) and bool(torch.isfinite(std).all())\n"
        "from difusion_tpu_torch.ops.segment import padded_unique_inverse\n"
        "uq = padded_unique_inverse(torch.tensor([3, 1, 3, 9], dtype=torch.int32),"
        " torch.tensor([True, True, True, False]))\n"
        "assert int(uq.count) == 2 and uq.inverse.tolist() == [1, 0, 1, 2]\n"
        "from difusion_tpu_torch.train import trainer, losses, lif_dataset, lr_schedule\n"
        "from difusion_tpu_torch.sampler import generator, sampler, mesh_io\n"
        "from difusion_tpu_torch.models.decoder import DecoderSpec\n"
        "from difusion_tpu_torch.models.encoder import EncoderSpec\n"
        "from difusion_tpu_torch.utils import meters, adam\n"
        "st = trainer.create_train_state(DecoderSpec(), EncoderSpec(), device='cpu')\n"
        "st, ls = trainer.train_step(losses.LossConfig(), st, torch.rand(2, 8, 4),"
        " torch.rand(2, 16, 6), 1e-3, 1e-3, 1)\n"
        "assert st.step == 1 and bool(torch.isfinite(ls['total']))\n"
        "import numpy as np\n"
        "sdf = sampler.compute_sdf(np.zeros((3, 3), np.float32),"
        " np.random.rand(40, 3).astype(np.float32), np.ones((40, 3), np.float32),"
        " 0.07, device='cpu')\n"
        "assert sdf.shape == (3,)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'difusion_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    from difusion_tpu_torch.core import map as M
    from difusion_tpu_torch.core.tracker import TrackerConfig
    from difusion_tpu_torch.device import resolve_device
    from difusion_tpu_torch.ops.imgproc import Intrinsic
    from difusion_tpu_torch.slam import SLAMSystem, load_prior

    hyper = ROOT / "di-checkpoints/study_mixed/hyper.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        load_prior(hyper, 300)
    dec, enc, _ = load_prior(hyper, 300, device="cpu")
    cfg = M.MapConfig(bound_min=(0.0, 0.0, 0.0), n_xyz=(4, 4, 4), voxel_size=0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAMSystem(cfg, TrackerConfig(), dec, enc, Intrinsic(100.0, 100.0, 8.0, 8.0))
    from difusion_tpu_torch import mesh_tool
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_tool.main(["map.npz", "mesh.ply", "--hyper", str(hyper)])
    with pytest.raises(RuntimeError, match="CUDA"):
        M.load_map("map.npz")
    from difusion_tpu_torch.models.decoder import DecoderSpec
    from difusion_tpu_torch.models.encoder import EncoderSpec
    from difusion_tpu_torch.sampler import generator, sampler
    from difusion_tpu_torch.train import trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.create_train_state(DecoderSpec(), EncoderSpec())
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train({})
    with pytest.raises(RuntimeError, match="CUDA"):
        sampler.compute_sdf(np.zeros((1, 3), np.float32), np.zeros((20, 3), np.float32),
                            np.ones((20, 3), np.float32), 0.07)
    with pytest.raises(RuntimeError, match="CUDA"):
        generator.run_generation(None)
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")
