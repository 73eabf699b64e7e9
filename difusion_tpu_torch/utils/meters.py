"""Streaming scalar-metric accumulation for training/runtime logging (the
port's own copy of difusion_tpu/utils/meters.py).

The reference tracks losses with a family of meter classes holding unbounded
per-key value lists (pytorch/utils/exp_util.py:115-256).  Here the same
capability -- per-key means, latest values, a printable summary, export --
is one small accumulator over Welford streaming statistics: O(1) memory per
key regardless of run length, JSON (not pickle) for export, and an optional
exponentially-weighted average in the same pass.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Optional


class LossMeter:
    """Per-key streaming count/mean/variance/EWMA/last for scalar metrics.

    ``update`` accepts any mapping of name -> number; None and NaN values are
    ignored so callers can pass loss dicts straight through.
    """

    def __init__(self, ewma_alpha: float = 0.9):
        self.ewma_alpha = ewma_alpha
        self._stats: Dict[str, Dict[str, float]] = {}

    def update(self, values: Dict[str, float]) -> None:
        for name, val in values.items():
            if val is None:
                continue
            v = float(val)
            if math.isnan(v):
                continue
            s = self._stats.get(name)
            if s is None:
                self._stats[name] = {"n": 1.0, "mean": v, "m2": 0.0,
                                     "ewma": v, "last": v}
                continue
            s["n"] += 1.0
            d = v - s["mean"]
            s["mean"] += d / s["n"]
            s["m2"] += d * (v - s["mean"])       # Welford update
            a = self.ewma_alpha
            s["ewma"] = a * s["ewma"] + (1.0 - a) * v
            s["last"] = v

    # -- views ---------------------------------------------------------------

    def mean(self) -> Dict[str, float]:
        return {k: s["mean"] for k, s in self._stats.items()}

    def ewma(self) -> Dict[str, float]:
        return {k: s["ewma"] for k, s in self._stats.items()}

    def last(self) -> Dict[str, float]:
        return {k: s["last"] for k, s in self._stats.items()}

    def count(self, name: str) -> int:
        s = self._stats.get(name)
        return int(s["n"]) if s else 0

    def std(self, name: str) -> float:
        s = self._stats.get(name)
        if not s or s["n"] < 2:
            return 0.0
        return math.sqrt(s["m2"] / (s["n"] - 1.0))

    def summary(self, digits: int = 4) -> str:
        """One-line 'name=mean' listing plus the sum of means."""
        means = self.mean()
        parts = [f"{k}={v:.{digits}f}" for k, v in means.items()]
        parts.append(f"total={sum(means.values()):.{digits}f}")
        return "  ".join(parts)

    # -- export --------------------------------------------------------------

    def to_json(self, path: Optional[str] = None) -> str:
        blob = json.dumps({"ewma_alpha": self.ewma_alpha, "stats": self._stats})
        if path is not None:
            with open(path, "w") as f:
                f.write(blob)
        return blob

    @classmethod
    def from_json(cls, blob_or_path: str) -> "LossMeter":
        if blob_or_path.lstrip().startswith("{"):
            data = json.loads(blob_or_path)
        else:
            with open(blob_or_path) as f:
                data = json.load(f)
        m = cls(ewma_alpha=data["ewma_alpha"])
        m._stats = data["stats"]
        return m
