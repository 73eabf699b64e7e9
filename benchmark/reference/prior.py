"""The prior's decoder and encoder as plain functions of its raw weights
(``prior_<epoch>.npz`` beside the hyper file: weight-normed decoder layers,
batch-normed encoder layers), read and folded here.

``precision`` is ``"f32"`` (TF32 off: true f32 products), ``"tf32"`` (the
products' inputs rounded to TF32 by the card's matrix units, f32 sums: the
precision just below the configuration's f32) or ``"bf16"`` (the input,
every weight and bias and every activation rounded to bfloat16, f32 sums).
The two lower ones are what a control reads.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

BN_EPS = 1e-5


def _flat(npz: Path) -> Dict[str, np.ndarray]:
    with np.load(npz) as data:
        return {k: data[k] for k in data.files}


class Prior:
    """Decoder (``di_decoder``: latent + xyz in, the input fed again at the
    ``latent_in`` layers, tanh sdf; std = 0.05 + 0.5 softplus of a head on
    the last hidden layer) and encoder (``di_encoder``: per-point MLP, ReLU
    between layers) on ``device``."""

    def __init__(self, hyper_path, epoch: int, device, precision: str = "f32"):
        hyper_path = Path(hyper_path)
        self.hyper = json.loads(hyper_path.read_text())
        w = _flat(hyper_path.parent / f"prior_{epoch}.npz")
        self.device, self.precision = device, precision
        self.latent_in = set(self.hyper["network_specs"].get("latent_in") or ())
        self.dec: List[Tuple[torch.Tensor, torch.Tensor]] = []
        i = 0
        while f"decoder.layers#{i}.b" in w:
            b = w[f"decoder.layers#{i}.b"].astype(np.float64)
            if f"decoder.layers#{i}.g" in w:
                v = w[f"decoder.layers#{i}.v"].astype(np.float64)
                g = w[f"decoder.layers#{i}.g"].astype(np.float64)
                W = g[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
            else:
                W = w[f"decoder.layers#{i}.w"].astype(np.float64)
            self.dec.append(self._t(W, b))
            i += 1
        self.unc = self._t(w["decoder.uncertainty.w"], w["decoder.uncertainty.b"])
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

    def _t(self, W, b):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        return f(W), f(b)

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(torch.float32) if self.precision == "bf16" else x

    def _lin(self, x, Wb):
        W, b = Wb
        r = self._r
        if self.precision == "tf32":
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return x @ W.T + b
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
        return r(r(x) @ r(W).T + r(b))

    def decode(self, latent: torch.Tensor, xyz: torch.Tensor):
        """(N, L), (N, 3) -> sdf (N,), std (N,)."""
        inp = torch.cat([latent, xyz], dim=1)
        x = inp
        std = None
        last = len(self.dec) - 1
        for i, Wb in enumerate(self.dec):
            if i in self.latent_in:
                x = torch.cat([x, inp], dim=1)
            if i == last:
                std = 0.05 + 0.5 * torch.nn.functional.softplus(self._lin(x, self.unc))
            x = self._lin(x, Wb)
            if i < last:
                x = torch.relu(x)
        return torch.tanh(x)[:, 0], std[:, 0]

    def encode(self, xyzn: torch.Tensor) -> torch.Tensor:
        """(N, 6) -> (N, L) per-point codes."""
        x = xyzn
        for i, Wb in enumerate(self.enc):
            x = self._lin(x, Wb)
            if i < len(self.enc) - 1:
                x = torch.relu(x)
        return x
