"""The port's ``config.py`` and ``SLAMSystem.from_config`` against the JAX
package's, on the repo's own config files (CPU)."""
from pathlib import Path

import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from difusion_tpu import config as JC
from difusion_tpu.data import open_sequence as jax_open_sequence
from difusion_tpu.slam import SLAMSystem as JSLAMSystem
from difusion_tpu_torch import config as C
from difusion_tpu_torch.data.production import open_sequence
from difusion_tpu_torch.slam import SLAMSystem

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
PRIOR = "di-checkpoints/study_mixed/hyper.json"


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_configs_parse_like_jax(path):
    """Every config file of the repo parses to the same dictionary."""
    assert C.args_to_dict(C.load_yaml_args(str(path))) == \
        JC.args_to_dict(JC.load_yaml_args(str(path)))


def test_yaml_include_inheritance(tmp_path):
    (tmp_path / "base.yaml").write_text("a: 1\nb: 2\n")
    (tmp_path / "child.yaml").write_text("include_configs: base.yaml\nb: 3\nc: 4\n")
    for mod in (C, JC):
        args = mod.parse_config_yaml(tmp_path / "child.yaml")
        assert args.a == 1 and args.b == 3 and args.c == 4


def test_lenient_json(tmp_path):
    p = tmp_path / "h.json"
    p.write_text("[{'_': 'comment', 'x': None, 'y': True}, {'z': False}]")
    args = C.parse_config_json(p)
    assert args.x is None and args.y is True and args.z is False
    assert C.args_to_dict(args) == JC.args_to_dict(JC.parse_config_json(p))


def test_parser_set_override(tmp_path):
    """The ``apply_override`` cases of tests/test_config.py: a scalar, a
    nested key through a dict level, a list."""
    p = tmp_path / "h.yaml"
    p.write_text("lr: 0.001\nmapping:\n  voxel_size: 0.1\nbounds: [0, 1]\n")
    args = C.ArgumentParserX().parse_args(
        [str(p), "--set", "lr=42", "--set", "mapping.voxel_size=0.05",
         "--set", "bounds=[2, 3]"])
    assert args.lr == 42
    assert args.mapping["voxel_size"] == 0.05
    assert args.bounds == [2, 3]
    flagged = C.ArgumentParserX().parse_args([str(p), "--lr", "0.1"])
    assert flagged.lr == 0.1


def test_parser_set_rejects_malformed(tmp_path):
    p = tmp_path / "h.yaml"
    p.write_text("lr: 0.001\n")
    with pytest.raises(ValueError):
        C.ArgumentParserX().parse_args([str(p), "--set", "lr"])


def test_dict_to_args_roundtrip():
    args = C.dict_to_args({"a": 1, "b": {"c": 2}})
    assert args.a == 1 and args.b == {"c": 2}
    assert C.args_to_dict(args) == {"a": 1, "b": {"c": 2}}


def test_from_config_matches_jax():
    """configs/fusion-synthetic.yaml with ``training_hypers`` overridden to
    the in-repo prior: both packages build the same map and tracker
    configuration (field by field; the port's two own defaults,
    ``warp_tiled`` and ``sdf_fused``, aside) and the same schedule."""
    built = []
    for mod, opener, system, kw in ((C, open_sequence, SLAMSystem, {"device": "cpu"}),
                                    (JC, jax_open_sequence, JSLAMSystem, {})):
        args = mod.load_yaml_args(str(ROOT / "configs/fusion-synthetic.yaml"))
        mod.apply_override(args, f"training_hypers={ROOT / PRIOR}")
        mod.apply_override(args, "sequence_kwargs.n_frames=2")
        seq = opener(args.sequence_type, **args.sequence_kwargs)
        built.append(system.from_config(args, seq.calib, seq.first_iso,
                                        meshing=False, **kw))
    t, j = built
    assert t.map_cfg._asdict() == j.map_cfg._asdict()
    for field, value in t.tracker.tcfg._asdict().items():
        if field not in ("warp_tiled", "sdf_fused"):
            assert value == getattr(j.tracker.tcfg, field), field
    assert t.integrate_interval == j.integrate_interval == 20
    assert t.meshing_interval == j.meshing_interval
    assert tuple(t.tracker.calib) == tuple(j.tracker.calib)


def test_from_config_rejects_the_hash_map():
    """``from_config`` on configs/fusion-scannet.yaml (``indexer: hash``)
    builds a hash-map system, as the JAX package's does: the same map
    configuration (a table of 4 x capacity), tracker, intervals and depth
    cut, and a ``HashMeshExtractor``; so does a config without bounds."""
    from difusion_tpu_torch.core import hash_map as HM
    from difusion_tpu_torch.core.meshing import HashMeshExtractor
    from difusion_tpu.ops.imgproc import Intrinsic as JIntrinsic
    from difusion_tpu_torch.data.synthetic_scannet import CALIB
    built = []
    for mod, system, calib, kw in ((C, SLAMSystem, CALIB, dict(device="cpu")),
                                   (JC, JSLAMSystem, JIntrinsic(*CALIB), {})):
        args = mod.load_yaml_args(str(ROOT / "configs/fusion-scannet.yaml"))
        mod.apply_override(args, f"training_hypers={ROOT / PRIOR}")
        built.append(system.from_config(args, calib, None, capacity=1 << 12, **kw))
    t, j = built
    assert t.is_hash and j.is_hash
    assert t.map_cfg._asdict() == j.map_cfg._asdict()
    assert t.map_cfg.table_size == 4 * t.map_cfg.capacity
    assert isinstance(t.state, HM.HashMapState) and isinstance(t.mesher, HashMeshExtractor)
    assert t.tracker.tcfg.depth_cut_min == 0.3 and t.tracker.tcfg.depth_cut_max == 6.0
    for field, value in t.tracker.tcfg._asdict().items():
        if field not in ("warp_tiled", "sdf_fused"):
            assert value == getattr(j.tracker.tcfg, field), field
    args = C.load_yaml_args(str(ROOT / "configs/fusion-synthetic.yaml"))
    C.apply_override(args, f"training_hypers={ROOT / PRIOR}")
    del args.mapping["bound_min"]
    assert SLAMSystem.from_config(args, CALIB, None, capacity=1 << 12, meshing=False,
                                  device="cpu").is_hash