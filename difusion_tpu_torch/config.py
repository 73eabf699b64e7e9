"""Configuration system (the port's own copy of difusion_tpu/config.py).

PyYAML is imported inside the functions that parse YAML, so that building a
configuration from a dictionary (:func:`dict_to_args`) needs no YAML package.

Feature-parity with the reference's ``ArgumentParserX`` (reference:
pytorch/utils/exp_util.py:12-112): a positional YAML/JSON "hyper" file whose
keys are auto-promoted to ``--flag`` overrides, YAML ``include_configs``
inheritance, lenient JSON parsing (Python-literal fixing), and nested dict
sub-configs re-wrapped as namespaces.  The reference's ``--exec`` escape
hatch (arbitrary code evaluated from the command line) is deliberately NOT
reproduced; ``--set dotted.key=value`` covers the same use cases safely.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional


def parse_config_json(json_path: Path, args: Optional[argparse.Namespace] = None) -> argparse.Namespace:
    """Parse a (possibly Python-literal-flavoured) JSON config into a namespace.

    Accepts either a dict or a list of dicts; keys named ``_`` are comments.
    """
    if args is None:
        args = argparse.Namespace()
    json_path = Path(json_path)
    text = json_path.read_text()
    try:
        raw = json.loads(text)
    except json.JSONDecodeError:
        # Lenient mode: fix Python literals that sneak into hand-written configs.
        text = (
            text.replace("'", '"')
            .replace("None", "null")
            .replace("False", "false")
            .replace("True", "true")
        )
        raw = json.loads(text)
    if isinstance(raw, dict):
        raw = [raw]
    for block in raw:
        for key, value in block.items():
            if key != "_":
                setattr(args, key, value)
    return args


def parse_config_yaml(yaml_path: Path, args: Optional[argparse.Namespace] = None,
                      override: bool = True) -> argparse.Namespace:
    """Parse a YAML config (with ``include_configs`` inheritance) into a namespace."""
    if args is None:
        args = argparse.Namespace()
    import yaml
    yaml_path = Path(yaml_path)
    with yaml_path.open() as f:
        configs = yaml.safe_load(f)
    if configs is None:
        return args
    if "include_configs" in configs:
        base_rel = configs.pop("include_configs")
        base_path = yaml_path.parent / base_rel
        with base_path.open() as f:
            base = yaml.safe_load(f) or {}
        base.update(configs)
        configs = base
    for key, value in configs.items():
        if override or key not in vars(args):
            setattr(args, key, value)
    return args


def dict_to_args(data: dict) -> argparse.Namespace:
    args = argparse.Namespace()
    for key, value in data.items():
        setattr(args, key, value)
    return args


def args_to_dict(args: argparse.Namespace) -> dict:
    out = {}
    for key, value in vars(args).items():
        out[key] = args_to_dict(value) if isinstance(value, argparse.Namespace) else value
    return out


def apply_override(args: argparse.Namespace, assignment: str) -> None:
    """Apply one ``key=value`` (or ``a.b.c=value``) override to a namespace.

    Values parse as YAML scalars/collections, so ``--set lr=1e-4``,
    ``--set mapping.voxel_size=0.05`` and ``--set bounds=[0,1]`` all work.
    Dotted paths descend through Namespace or dict levels.  This replaces the
    reference's ``--exec`` hatch (exp_util.py:103-108), which evaluated
    arbitrary code from the command line -- same ergonomics, no exec().
    """
    import yaml
    key, sep, raw = assignment.partition("=")
    if not sep:
        raise ValueError(f"override {assignment!r} is not of the form key=value")
    value = yaml.safe_load(raw)
    parts = key.strip().split(".")
    target = args
    for p in parts[:-1]:
        target = target[p] if isinstance(target, dict) else getattr(target, p)
    if isinstance(target, dict):
        target[parts[-1]] = value
    else:
        setattr(target, parts[-1], value)


class ArgumentParserX(argparse.ArgumentParser):
    """Argument parser whose flag surface is induced by the config file.

    Capability parity with the reference's config-driven CLI
    (exp_util.py:78-112): a positional ``hyper`` yaml/json file, every
    top-level scalar key auto-promoted to a ``--key`` override, plus
    repeatable ``--set dotted.key=value`` assignments for nested keys
    (the safe replacement for the reference's ``--exec``).
    """

    def __init__(self, base_config_path: Optional[str] = None,
                 add_hyper_arg: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.add_hyper_arg = add_hyper_arg
        self.base_config_path = base_config_path
        if add_hyper_arg:
            self.add_argument("hyper", type=str,
                              help="yaml/json parameter file")
        self.add_argument("--set", dest="overrides", action="append",
                          default=[], metavar="KEY=VALUE",
                          help="override a (possibly nested, dot-separated) "
                               "config key; value is parsed as YAML")

    def _load_file_config(self, argv) -> argparse.Namespace:
        cfg = argparse.Namespace()
        if self.base_config_path is not None:
            parse_config_yaml(Path(self.base_config_path), cfg)
        if self.add_hyper_arg:
            first, _ = self.parse_known_args(argv)
            path = Path(first.hyper)
            loader = (parse_config_json if path.suffix == ".json"
                      else parse_config_yaml)
            loader(path, cfg)
        return cfg

    def parse_args(self, args=None, namespace=None):
        import yaml
        cfg = self._load_file_config(args)
        # promote each file key to a --flag whose default is the file value;
        # non-scalar values stay reachable through --set
        for key, value in vars(cfg).items():
            flag_type = type(value) if isinstance(value, (int, float, str)) else None
            try:
                if flag_type is not None:
                    self.add_argument(f"--{key}", type=flag_type, default=value)
                else:
                    self.add_argument(f"--{key}", type=yaml.safe_load,
                                      default=value)
            except argparse.ArgumentError:
                pass                      # key collides with a builtin flag
        parsed = super().parse_args(args, namespace)
        for assignment in parsed.overrides:
            apply_override(parsed, assignment)
        return parsed


def load_yaml_args(path: str) -> argparse.Namespace:
    """Convenience: load a YAML config file directly into a namespace."""
    return parse_config_yaml(Path(path))
