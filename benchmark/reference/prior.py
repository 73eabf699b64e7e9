"""The prior's decoder and encoder as plain functions of its raw weights
(``prior_<epoch>.npz`` beside the hyper file), read and folded here: the
decoder by the file of the family the hyper names (:mod:`.decoders`), the
encoder (batch-normed layers) here.

``precision`` is ``"f32"`` (TF32 off: true f32 products), ``"tf32"`` (the
products' inputs rounded to TF32 by the card's matrix units, f32 sums: the
precision just below the configuration's f32) or ``"bf16"`` (the input,
every weight and bias and every activation rounded to bfloat16, f32 sums).
The two lower ones are what a control reads.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import decoders

BN_EPS = 1e-5


def _flat(npz: Path) -> Dict[str, np.ndarray]:
    with np.load(npz) as data:
        return {k: data[k] for k in data.files}


class Prior:
    """Decoder (the hyper's ``network_name``, :mod:`.decoders`) and encoder
    (``di_encoder``: per-point MLP, ReLU between layers) on ``device``."""

    def __init__(self, hyper_path, epoch: int, device, precision: str = "f32"):
        hyper_path = Path(hyper_path)
        self.hyper = json.loads(hyper_path.read_text())
        w = _flat(hyper_path.parent / f"prior_{epoch}.npz")
        self.device, self.precision = device, precision
        self.decode = decoders.load(self.hyper).build(w, self.hyper, self._lin, self._t)
        self.enc = []
        i = 0
        while f"encoder.layers#{i}.w" in w:
            W = w[f"encoder.layers#{i}.w"].astype(np.float64)
            if f"encoder.layers#{i}.bn_mean" in w:
                a = (w[f"encoder.layers#{i}.bn_scale"].astype(np.float64)
                     / np.sqrt(w[f"encoder.layers#{i}.bn_var"].astype(np.float64) + BN_EPS))
                b = (w[f"encoder.layers#{i}.bn_bias"].astype(np.float64)
                     - w[f"encoder.layers#{i}.bn_mean"].astype(np.float64) * a)
                W = W * a[:, None]
            else:
                b = w[f"encoder.layers#{i}.b"].astype(np.float64)
            self.enc.append(self._t(W, b))
            i += 1

    def _t(self, *arrays):
        return tuple(torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                     for a in arrays)

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(torch.float32) if self.precision == "bf16" else x

    def _lin(self, x, W, b):
        r = self._r
        if self.precision == "tf32":
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return x @ W.T + b
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
        return r(r(x) @ r(W).T + r(b))

    def encode(self, xyzn: torch.Tensor) -> torch.Tensor:
        """(N, 6) -> (N, L) per-point codes."""
        x = xyzn
        for i, Wb in enumerate(self.enc):
            x = self._lin(x, *Wb)
            if i < len(self.enc) - 1:
                x = torch.relu(x)
        return x
