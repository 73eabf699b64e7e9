"""Point encoder (counterpart of difusion_tpu/models/encoder.py:31-94).

A PointNet-style shared MLP ``6 -> 32 -> 64 -> 256 -> L``: each hidden
conv1x1 is followed by BatchNorm + ReLU, the last is a biased linear.  Two
forms:

* the inference form: BatchNorm running statistics are folded into each
  hidden layer's weight and bias (:func:`fold_encoder_params`), and
  :meth:`Encoder.encode_points` is the per-point 'cnp' mode, (N, 6) -> (N, L);
* the train form (:class:`EncoderTrain`; calling it is the JAX package's
  ``encode_train``): 'train' mode, BatchNorm over batch x points with batch
  statistics, the running mean and the unbiased running variance moving
  with momentum 0.1, eps 1e-5 (difusion_tpu/models/encoder.py:97-123; what
  ``torch.nn.BatchNorm1d`` does on a (B, C, N) tensor, written out so that
  the order of the sums is the JAX package's), then a mean over the points.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from . import parallel as P

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


class EncoderSpec(NamedTuple):
    per_point_feat: Tuple[int, ...] = (6, 32, 64, 256)
    latent_size: int = 29

    @property
    def all_dims(self) -> Tuple[int, ...]:
        return tuple(self.per_point_feat) + (self.latent_size,)

    @classmethod
    def from_hyper(cls, hyper: dict) -> "EncoderSpec":
        spec = hyper["encoder_specs"]
        return cls(per_point_feat=tuple(spec["per_point_feat"]),
                   latent_size=spec.get("latent_size", hyper["code_length"]))


def fold_encoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold BN running stats into per-layer affine: y = x @ (W*a)^T + c
    (numpy, f32).  Layers that are already ``{w, b}`` pass through."""
    folded = {"layers": []}
    for layer in params["layers"]:
        w = np.asarray(layer["w"], np.float32)
        if "bn_mean" in layer:
            inv_std = 1.0 / np.sqrt(np.asarray(layer["bn_var"], np.float32)
                                    + np.float32(_BN_EPS))
            a = np.asarray(layer["bn_scale"], np.float32) * inv_std
            c = (np.asarray(layer["bn_bias"], np.float32)
                 - np.asarray(layer["bn_mean"], np.float32) * a)
            folded["layers"].append({"w": (w * a[:, None]).astype(np.float32),
                                     "b": c.astype(np.float32)})
        else:
            folded["layers"].append({"w": w, "b": np.asarray(layer["b"],
                                                             np.float32)})
    return folded


class Encoder(nn.Module):
    """Folded encoder: dense linears with ReLU between them."""

    def __init__(self, spec: EncoderSpec, folded: Dict[str, Any]):
        super().__init__()
        self.spec = spec
        dims = spec.all_dims
        self.layers = nn.ModuleList()
        for din, dout, layer in zip(dims[:-1], dims[1:], folded["layers"]):
            lin = nn.Linear(din, dout)
            with torch.no_grad():
                lin.weight.copy_(torch.tensor(layer["w"]))
                lin.bias.copy_(torch.tensor(layer["b"]))
            self.layers.append(lin)
        self.requires_grad_(False)

    def encode_points(self, xyzn: torch.Tensor) -> torch.Tensor:
        """'cnp' per-point mode: (N, 6) -> (N, L)."""
        x = xyzn
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x

    forward = encode_points


def init_encoder_params(spec: EncoderSpec, generator: torch.Generator) -> Dict[str, Any]:
    """Train-form parameters (numpy f32, the JAX package's tree) drawn from
    ``generator``: weights kaiming-normal (std sqrt(2 / fan_in)); hidden
    layers carry BatchNorm scale 1, bias 0, running mean 0 and variance 1;
    the last layer's bias ~ U(-k, k), k = 1/sqrt(fan_in)."""
    dims = spec.all_dims
    layers = []
    for i in range(len(dims) - 1):
        din, dout = dims[i], dims[i + 1]
        w = (torch.randn((dout, din), generator=generator) * np.sqrt(2.0 / din)).numpy()
        if i < len(dims) - 2:
            layers.append({"w": w, "bn_scale": np.ones(dout, np.float32),
                           "bn_bias": np.zeros(dout, np.float32),
                           "bn_mean": np.zeros(dout, np.float32),
                           "bn_var": np.ones(dout, np.float32)})
        else:
            k = 1.0 / np.sqrt(din)
            b = ((torch.rand((dout,), generator=generator) * 2 - 1) * k).numpy()
            layers.append({"w": w, "b": b})
    return {"layers": layers}


_BN_BUFFERS = ("bn_mean", "bn_var")


class _EncoderLayer(nn.Module):
    def __init__(self, layer: Dict[str, Any]):
        super().__init__()
        for k, v in layer.items():
            t = torch.as_tensor(np.asarray(v, np.float32)).clone()
            if k in _BN_BUFFERS:
                self.register_buffer(k, t)
            else:
                setattr(self, k, nn.Parameter(t))

    def keys(self):
        return [k for k, _ in self.named_parameters()] + [k for k, _ in self.named_buffers()]


class EncoderTrain(nn.Module):
    """Train-form encoder.  Hidden layers: parameters ``w``, ``bn_scale``,
    ``bn_bias`` and buffers ``bn_mean``, ``bn_var`` (they move with the
    forward pass, not with the optimizer); the last layer ``w``, ``b``."""

    def __init__(self, spec: EncoderSpec, params: Dict[str, Any]):
        super().__init__()
        self.spec = spec
        self.layers = nn.ModuleList(_EncoderLayer(layer) for layer in params["layers"])

    def to_params(self) -> Dict[str, Any]:
        """The JAX package's tree, numpy f32 leaves."""
        return {"layers": [{k: getattr(layer, k).detach().cpu().numpy().copy()
                            for k in layer.keys()} for layer in self.layers]}

    def forward(self, surface: torch.Tensor, update_stats: bool = True,
                mesh=None) -> torch.Tensor:
        """(B, N, 6) -> codes (B, L).  With ``update_stats`` the running
        statistics move (in place, outside autograd).  ``mesh``
        (``parallel.Mesh``) of more than one rank: ``surface`` is
        this rank's rows of the global batch; BatchNorm takes its statistics
        over the global batch x points (all-reduced over the data group,
        the same two passes), and a layer whose weight holds a slice of the
        output rows (``shard_state_tp``) computes that slice and gathers the
        full activation over the model group."""
        multi = mesh is not None and mesh.size > 1
        dims = self.spec.all_dims
        x = surface
        for i, layer in enumerate(self.layers):
            sharded = multi and layer.w.shape[0] < dims[i + 1]

            def local(t):
                # a per-output vector: this rank's slice where the layer is
                # sharded and the vector is not (rows <= 4)
                return P.slice_cols(t, mesh) if sharded and t.shape[0] == dims[i + 1] else t
            x = (P.copy_to_model(x, mesh) if sharded else x) @ layer.w.T
            if hasattr(layer, "bn_mean"):
                if multi and mesh.dp > 1:
                    n = x.shape[0] * x.shape[1] * mesh.dp
                    n_t = torch.full((), float(n), device=x.device)
                    mean = P.all_reduce_sum(x.sum(dim=(0, 1)), mesh.data_group) / n_t
                    var = P.all_reduce_sum(((x - mean) ** 2).sum(dim=(0, 1)),
                                           mesh.data_group) / n_t
                else:
                    n = x.shape[0] * x.shape[1]
                    mean = torch.mean(x, dim=(0, 1))
                    var = torch.mean((x - mean) ** 2, dim=(0, 1))
                x = ((x - mean) / torch.sqrt(var + _BN_EPS) * local(layer.bn_scale)
                     + local(layer.bn_bias))
                if update_stats:
                    with torch.no_grad():
                        unbiased = var * n / max(n - 1, 1)
                        if sharded and layer.bn_mean.shape[0] == dims[i + 1]:
                            mean, unbiased = (P.gather_cols(t, mesh) for t in (mean, unbiased))
                        layer.bn_mean.copy_((1 - _BN_MOMENTUM) * layer.bn_mean
                                            + _BN_MOMENTUM * mean)
                        layer.bn_var.copy_((1 - _BN_MOMENTUM) * layer.bn_var
                                           + _BN_MOMENTUM * unbiased)
                x = torch.relu(x)
            else:
                x = x + local(layer.b)
            if sharded:
                x = P.gather_cols(x, mesh)
        return torch.mean(x, dim=1)
