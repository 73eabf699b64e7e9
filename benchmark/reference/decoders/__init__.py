"""The prior's decoder families, one file each: ``<network_name>.py``.

The prior's hyper names its family (``network_name``; a hyper without one is
``di_decoder``'s).  A family's file defines the decoder's mathematics and
the work it counts, beside each other:

- ``build(w, hyper, lin, tensors) -> decode``: ``w`` is the raw npz dict,
  ``lin(x, W, b)`` the affine map in the reference's precision (every
  product of the decoder goes through it, so that the controls' lower
  precisions reach every family), ``tensors(*arrays)`` puts arrays on the
  device in float32.  ``decode(latent, xyz) -> (sdf, std)``, (N, L) and
  (N, 3) in, (N,) and (N,) out, differentiable in ``xyz``.
- ``fwd_flops(hyper)``, ``grad_flops(hyper)``: one point's forward, and its
  forward plus d sdf / d xyz, counted once (:mod:`benchmark.flops`).
- ``param_bytes(hyper)``: the weights, read once.
- ``fwd_point_floats(hyper)``, ``grad_point_floats(hyper)``: the floats a
  point reads and writes in a forward call and in a gradient call.

A new family is a new file here; nothing else in the benchmark changes.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT = "di_decoder"


def load(hyper: dict):
    """The module of the family ``hyper`` names.  An unknown name stops the
    run with the file to add."""
    name = hyper.get("network_name") or DEFAULT
    path = HERE / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not path.is_file():
        raise SystemExit(
            f"the prior's decoder family {name!r} has no reference in the benchmark: "
            f"add {path.relative_to(HERE.parents[2]).as_posix()} (build, fwd_flops, "
            "grad_flops, param_bytes, fwd_point_floats, grad_point_floats)")
    spec = importlib.util.spec_from_file_location(f"benchmark_decoder_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
