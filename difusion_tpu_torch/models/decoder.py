"""Probabilistic-SDF decoder (counterpart of difusion_tpu/models/decoder.py).

Input is ``concat(latent, xyz)`` of width ``L+3``; hidden dims ``[128]*4``;
the layer listed in ``latent_in`` re-concatenates the input; the std head
reads the last hidden activation and maps through ``0.05 + 0.5*softplus``;
the SDF output goes through ``tanh``.  Two forms:

* the inference form: weight-norm ``(g, v)`` is folded into dense ``w`` on
  the host (:func:`fold_decoder_params`), and :class:`Decoder` runs plain
  f32 linears;
* the train form (:class:`DecoderTrain`; calling it is the JAX package's
  ``decode_train``): ``g``, ``v``, ``b`` per weight-normed layer, the weight
  computed live as ``g * v / ||v||_row``, dropout after the ReLU of the
  layers in ``spec.dropout`` (difusion_tpu/models/decoder.py:111-145).  Its
  constructor takes, and :meth:`DecoderTrain.to_params` gives back, the JAX
  package's parameter tree of numpy arrays, which
  :func:`fold_decoder_params` folds for :class:`Decoder`.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import parallel as P


class DecoderSpec(NamedTuple):
    latent_size: int = 29
    dims: Tuple[int, ...] = (128, 128, 128, 128)
    dropout: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    dropout_prob: float = 0.2
    norm_layers: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    latent_in: Tuple[int, ...] = (3,)
    weight_norm: bool = True

    @property
    def input_dim(self) -> int:
        return self.latent_size + 3

    def layer_dims(self) -> Tuple[Sequence[int], Sequence[int]]:
        """Per-layer (in_dim, out_dim): the layer before a ``latent_in``
        layer shrinks so the concat stays at the nominal width."""
        dims = [self.input_dim] + list(self.dims) + [1]
        ins, outs = [], []
        for layer in range(len(dims) - 1):
            out_dim = dims[layer + 1]
            if layer + 1 in self.latent_in:
                out_dim -= dims[0]
            ins.append(dims[layer])
            outs.append(out_dim)
        return ins, outs

    @classmethod
    def from_hyper(cls, hyper: dict) -> "DecoderSpec":
        spec = hyper["network_specs"]
        return cls(
            latent_size=hyper["code_length"],
            dims=tuple(spec["dims"]),
            dropout=tuple(spec.get("dropout") or ()),
            dropout_prob=spec.get("dropout_prob", 0.0),
            norm_layers=tuple(spec.get("norm_layers") or ()),
            latent_in=tuple(spec.get("latent_in") or ()),
            weight_norm=spec.get("weight_norm", False),
        )


def fold_decoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold weight-norm ``(g, v)`` -> dense ``w`` (numpy, f32).  Layers that
    are already ``{w, b}`` pass through."""
    folded = {"layers": [],
              "uncertainty": {k: np.asarray(v, np.float32)
                              for k, v in params["uncertainty"].items()}}
    for layer in params["layers"]:
        b = np.asarray(layer["b"], np.float32)
        if "g" in layer:
            v = np.asarray(layer["v"], np.float32)
            g = np.asarray(layer["g"], np.float32)
            w = g[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
            folded["layers"].append({"w": w.astype(np.float32), "b": b})
        else:
            folded["layers"].append({"w": np.asarray(layer["w"], np.float32),
                                     "b": b})
    return folded


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to bf16 (to nearest, ties to even) and widened back: the
    JAX package's ``.astype(jnp.bfloat16)`` in an f32 tensor (differentiable:
    autograd rounds the gradient at the same cast)."""
    return x.to(torch.bfloat16).to(torch.float32)


class Decoder(nn.Module):
    """Folded decoder: ``layers[i]`` are dense linears, ``uncertainty`` the
    std head.  Weights are buffers-like parameters with gradients off."""

    def __init__(self, spec: DecoderSpec, folded: Dict[str, Any]):
        super().__init__()
        self.spec = spec
        ins, outs = spec.layer_dims()
        self.layers = nn.ModuleList()
        for din, dout, layer in zip(ins, outs, folded["layers"]):
            lin = nn.Linear(din, dout)
            with torch.no_grad():
                lin.weight.copy_(torch.tensor(layer["w"]))
                lin.bias.copy_(torch.tensor(layer["b"]))
            self.layers.append(lin)
        self.uncertainty = nn.Linear(spec.dims[-1], 1)
        with torch.no_grad():
            self.uncertainty.weight.copy_(
                torch.tensor(folded["uncertainty"]["w"]))
            self.uncertainty.bias.copy_(
                torch.tensor(folded["uncertainty"]["b"]))
        self.requires_grad_(False)

    def decode(self, latent: torch.Tensor, xyz: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, L), (N, 3) -> sdf (N,), std (N,), in f32.

        ``compute_dtype=torch.bfloat16`` follows the JAX package's ``decode``
        (difusion_tpu/models/decoder.py:118-145) cast for cast, each cast an
        f32 tensor rounded to bf16: the input, every weight and bias, each
        hidden activation after its relu; the std head ``x @ uw.T + ub``
        rounded after the product and after the bias, before the f32
        softplus; products of bf16 values are exact, so f32 matmuls give
        the JAX package's f32-accumulated ones up to the order of the sums.
        Autograd through it rounds the gradient at the same casts, as the
        JAX package's vjp does."""
        if compute_dtype == torch.float32:
            inp = torch.cat([latent, xyz], dim=1)
            x = inp
            std = None
            n_layers = len(self.layers)
            for i, lin in enumerate(self.layers):
                if i in self.spec.latent_in:
                    x = torch.cat([x, inp], dim=1)
                if i == n_layers - 1:
                    std = 0.05 + 0.5 * F.softplus(self.uncertainty(x))
                x = lin(x)
                if i < n_layers - 1:
                    x = torch.relu(x)
            return torch.tanh(x)[:, 0], std[:, 0]
        if compute_dtype != torch.bfloat16:
            raise ValueError(f"decode computes in float32 or bfloat16, not {compute_dtype}")
        r = bf16_round
        inp = r(torch.cat([latent, xyz], dim=1))
        x = inp
        std = None
        n_layers = len(self.layers)
        for i, lin in enumerate(self.layers):
            if i in self.spec.latent_in:
                x = torch.cat([x, inp], dim=1)
            if i == n_layers - 1:
                u = self.uncertainty
                std = 0.05 + 0.5 * F.softplus(r(r(x @ r(u.weight).T) + r(u.bias)))
            x = x @ r(lin.weight).T + r(lin.bias)
            if i < n_layers - 1:
                x = r(torch.relu(x))
        return torch.tanh(x)[:, 0], std[:, 0]

    forward = decode


def init_decoder_params(spec: DecoderSpec, generator: torch.Generator) -> Dict[str, Any]:
    """Train-form parameters (numpy f32, the JAX package's tree) drawn from
    ``generator`` with torch's ``Linear`` bounds: weights and biases
    ~ U(-k, k), k = 1/sqrt(fan_in); a weight-normed layer stores
    g = ||w||_row and v = w."""
    def uniform(shape, k):
        return ((torch.rand(shape, generator=generator) * 2 - 1) * k).numpy()

    ins, outs = spec.layer_dims()
    layers = []
    for i, (din, dout) in enumerate(zip(ins, outs)):
        k = 1.0 / np.sqrt(din)
        w, b = uniform((dout, din), k), uniform((dout,), k)
        if spec.weight_norm and i in spec.norm_layers:
            layers.append({"g": np.linalg.norm(w, axis=1).astype(np.float32),
                           "v": w, "b": b})
        else:
            layers.append({"w": w, "b": b})
    k = 1.0 / np.sqrt(spec.dims[-1])
    return {"layers": layers,
            "uncertainty": {"w": uniform((1, spec.dims[-1]), k), "b": uniform((1,), k)}}


def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(a, np.float32)).clone())


class DecoderTrain(nn.Module):
    """Train-form decoder: ``layers[i]`` holds ``g``, ``v``, ``b`` (weight
    norm) or ``w``, ``b``; ``uncertainty`` holds the std head's ``w``, ``b``.
    Parameter names follow the JAX tree (``layers.0.g``, ``uncertainty.w``)."""

    def __init__(self, spec: DecoderSpec, params: Dict[str, Any]):
        super().__init__()
        self.spec = spec
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: _param(v) for k, v in layer.items()})
            for layer in params["layers"])
        self.uncertainty = nn.ParameterDict(
            {k: _param(v) for k, v in params["uncertainty"].items()})

    def to_params(self) -> Dict[str, Any]:
        """The JAX package's tree, numpy f32 leaves."""
        def leaf(p):
            return p.detach().cpu().numpy().copy()
        return {"layers": [{k: leaf(p) for k, p in layer.items()} for layer in self.layers],
                "uncertainty": {k: leaf(p) for k, p in self.uncertainty.items()}}

    def forward(self, net_input: torch.Tensor,
                masks: Optional[Dict[int, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None, mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, L+3) -> sdf (N, 1), std (N, 1).  Dropout: ``masks[i]`` (N,
        out_i) bool keeps, or draws from ``generator``; neither, none.

        ``mesh`` (``parallel.Mesh``) of more than one rank: the N
        rows are this rank's slice of the global batch's ``N * dp``; dropout
        keeps are those of the global batch (``masks`` are given for it, a
        ``generator`` draws its shape on every rank alike), sliced to these
        rows, so a data-parallel step equals one process's.  A layer whose
        weight holds a slice of the output rows (``shard_state_tp``)
        computes that slice and gathers the full activation over the model
        group; weight norm's row norms are per row, so they stay local."""
        spec = self.spec
        n_layers = len(self.layers)
        x = inp = net_input
        std = None
        dropout = spec.dropout_prob > 0 and (masks is not None or generator is not None)
        keep = 1.0 - spec.dropout_prob
        inv_keep = float(np.float32(1) / np.float32(keep))
        multi = mesh is not None and mesh.size > 1
        rows = P.row_slice(mesh, x.shape[0]) if multi else slice(None)
        _, outs = spec.layer_dims()
        for i, layer in enumerate(self.layers):
            if i in spec.latent_in:
                x = torch.cat([x, inp], dim=1)
            if i == n_layers - 1:
                u = self.uncertainty
                std = 0.05 + 0.5 * F.softplus(x @ u["w"].T + u["b"])
            wkey = "v" if "g" in layer else "w"
            sharded = multi and layer[wkey].shape[0] < outs[i]

            def local(t):
                # a per-output vector: this rank's slice where the layer is
                # sharded and the vector is not (rows <= 4)
                return P.slice_cols(t, mesh) if sharded and t.shape[0] == outs[i] else t
            if "g" in layer:
                v = layer["v"]
                w = local(layer["g"])[:, None] * v / torch.linalg.vector_norm(
                    v, dim=1, keepdim=True)
            else:
                w = layer["w"]
            x = (P.copy_to_model(x, mesh) if sharded else x) @ w.T + local(layer["b"])
            if sharded:
                x = P.gather_cols(x, mesh)
            if i < n_layers - 1:
                x = torch.relu(x)
                if dropout and i in spec.dropout:
                    if masks is not None:
                        m = masks[i][rows]
                    elif multi:
                        n_global = x.shape[0] * mesh.dp
                        m = torch.rand((n_global,) + x.shape[1:], generator=generator,
                                       device=x.device)[rows] < keep
                    else:
                        m = torch.rand(x.shape, generator=generator, device=x.device) < keep
                    # XLA turns the JAX package's x / keep into x * (1 / keep)
                    x = torch.where(m, x * inv_keep, 0.0)
        return torch.tanh(x), std
