"""Probabilistic-SDF decoders: the families a prior's ``network_name``
names (:func:`spec_from_hyper`; a hyper without one is ``di_decoder``'s).

``di_decoder`` (counterpart of difusion_tpu/models/decoder.py): input is ``concat(latent, xyz)`` of width ``L+3``; hidden dims ``[128]*4``;
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

``onet_cbn`` (the JAX package has none): Occupancy Networks'
conditional-batch-norm decoder with DI-Fusion's sdf and std heads, its
inference form :class:`CbnDecoder` and train form :class:`CbnDecoderTrain`
(the section below says how).  ``pigan_film`` (none either): pi-GAN's
FiLM-SIREN decoder with the same heads, :class:`FilmDecoder` and
:class:`FilmDecoderTrain`.  Both condition on each code once
(:func:`is_conditioned`).  :func:`init_params`, :func:`train_decoder`
and :func:`inference_decoder` dispatch on the spec's family.
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


# ---------------------------------------------------------------------------
# onet_cbn: Occupancy Networks' conditional-batch-norm decoder
# ---------------------------------------------------------------------------
#
# ``DecoderCBatchNorm`` (Mescheder et al., CVPR 2019, arXiv:1812.03828;
# im2mesh/onet/models/decoder.py and im2mesh/layers.py) with z_dim 0, the
# code c the voxel's latent:
#
#   net = fc_p(xyz)                                          (3 -> H)
#   net = net + fc_1(relu(CBN_{2i+1}(fc_0(relu(CBN_{2i}(net, c))), c)))
#                                                            (i = 0 .. blocks-1)
#   h = relu(CBN_{2 blocks}(net, c))
#   sdf = tanh(fc_out(h)),  std = 0.05 + 0.5 softplus(uncertainty(h))
#
# CBN_j(x, c) = (W_g c + b_g) * BN(x) + (W_b c + b_b), BN without affine
# (batch statistics in training, running statistics at inference).  The
# sdf head and the std head on ``h`` are DI-Fusion's probabilistic output in
# place of ONet's occupancy logit.  The parameter tree: ``fc_p``,
# ``blocks[i].fc_0`` / ``.fc_1``, ``cbn[j]`` (``gamma_w``, ``gamma_b``,
# ``beta_w``, ``beta_b``, ``mean``, ``var``), ``fc_out``, ``uncertainty``;
# linears as ``{w (out, in), b}``.

ONET_CBN = "onet_cbn"
CBN_EPS = 1e-5
CBN_MOMENTUM = 0.1


class CbnSpec(NamedTuple):
    """onet_cbn's widths: the code (``c_dim``), the hidden width
    (``hidden_size``) and the number of residual blocks."""
    latent_size: int = 256
    hidden: int = 256
    blocks: int = 5

    NAME = ONET_CBN

    @property
    def n_cbn(self) -> int:
        """Two conditional batch norms a block, and the head's."""
        return 2 * self.blocks + 1

    @classmethod
    def from_hyper(cls, hyper: dict) -> "CbnSpec":
        spec = hyper.get("network_specs") or {}
        return cls(latent_size=int(hyper["code_length"]),
                   hidden=int(spec.get("hidden_size", 256)),
                   blocks=int(spec.get("n_blocks", 5)))


def spec_from_hyper(hyper: dict):
    """The decoder spec of the family the hyper's ``network_name`` names (a
    hyper without one is ``di_decoder``'s)."""
    name = hyper.get("network_name") or "di_decoder"
    if name == "di_decoder":
        return DecoderSpec.from_hyper(hyper)
    if name == ONET_CBN:
        return CbnSpec.from_hyper(hyper)
    if name == PIGAN_FILM:
        return FilmSpec.from_hyper(hyper)
    raise ValueError(f"unknown decoder family network_name={name!r} "
                     f"(the port has di_decoder, {ONET_CBN} and {PIGAN_FILM})")


def is_conditioned(spec) -> bool:
    """Whether the family conditions on each code once (a per-code table the
    trunk reads by row: onet_cbn's CBN scales and shifts, pigan_film's FiLM
    frequencies and phases), not on the code as an input."""
    return isinstance(spec, (CbnSpec, FilmSpec))


def init_cbn_params(spec: CbnSpec, generator: torch.Generator) -> Dict[str, Any]:
    """Train-form parameters (numpy f32) drawn from ``generator`` with
    torch's ``Linear`` bounds U(-k, k), k = 1/sqrt(fan_in), and ONet's own
    initialisation on top: ``fc_1`` weights zero, each CBN's gamma map 0 c
    + 1 and beta map 0 c + 0, so that every block starts as the identity.
    Running statistics start at mean 0, variance 1."""
    def uniform(shape, k):
        return ((torch.rand(shape, generator=generator) * 2 - 1) * k).numpy()

    def linear(din, dout):
        k = 1.0 / np.sqrt(din)
        return {"w": uniform((dout, din), k), "b": uniform((dout,), k)}

    H, L = spec.hidden, spec.latent_size
    fc_p = linear(3, H)
    blocks = []
    for _ in range(spec.blocks):
        fc_0, fc_1 = linear(H, H), linear(H, H)
        fc_1["w"] = np.zeros((H, H), np.float32)
        blocks.append({"fc_0": fc_0, "fc_1": fc_1})
    cbn = [{"gamma_w": np.zeros((H, L), np.float32), "gamma_b": np.ones(H, np.float32),
            "beta_w": np.zeros((H, L), np.float32), "beta_b": np.zeros(H, np.float32),
            "mean": np.zeros(H, np.float32), "var": np.ones(H, np.float32)}
           for _ in range(spec.n_cbn)]
    return {"fc_p": fc_p, "blocks": blocks, "cbn": cbn, "fc_out": linear(H, 1),
            "uncertainty": linear(H, 1)}


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).clone()


class CbnDecoder(nn.Module):
    """onet_cbn's inference form.  BN's running statistics fold into the
    conditioning: with s = 1/sqrt(var + eps) and t = -mean s, CBN_j(x, c) =
    gamma'_j(c) x + beta'_j(c), gamma' = (W_g c + b_g) s, beta' = (W_g c +
    b_g) t + (W_b c + b_b) (:meth:`condition`).  :meth:`decode` has
    :meth:`Decoder.decode`'s interface and conditions every row for itself;
    the kernels condition each code once (``ops/decoder_fused``)."""

    def __init__(self, spec: CbnSpec, params: Dict[str, Any]):
        super().__init__()
        self.spec = spec
        H, L, n = spec.hidden, spec.latent_size, spec.n_cbn

        def linear(p, din, dout):
            lin = nn.Linear(din, dout)
            with torch.no_grad():
                lin.weight.copy_(_t(p["w"]))
                lin.bias.copy_(_t(p["b"]))
            return lin
        self.fc_p = linear(params["fc_p"], 3, H)
        self.fc_0 = nn.ModuleList(linear(b["fc_0"], H, H) for b in params["blocks"])
        self.fc_1 = nn.ModuleList(linear(b["fc_1"], H, H) for b in params["blocks"])
        self.fc_out = linear(params["fc_out"], H, 1)
        self.uncertainty = linear(params["uncertainty"], H, 1)
        cbn = params["cbn"]
        # (n, 2, H, L) / (n, 2, H): each CBN's gamma map, then its beta map
        self.cond_w = nn.Parameter(torch.stack([torch.stack([_t(c["gamma_w"]), _t(c["beta_w"])])
                                                for c in cbn]))
        self.cond_b = nn.Parameter(torch.stack([torch.stack([_t(c["gamma_b"]), _t(c["beta_b"])])
                                                for c in cbn]))
        s = 1.0 / torch.sqrt(torch.stack([_t(c["var"]) for c in cbn]) + CBN_EPS)
        self.bn_s = nn.Parameter(s)                                           # (n, H)
        self.bn_t = nn.Parameter(-torch.stack([_t(c["mean"]) for c in cbn]) * s)
        assert self.cond_w.shape == (n, 2, H, L)
        self.requires_grad_(False)

    def cbn_layer(self, codes: torch.Tensor, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(M, L) codes -> CBN j's folded (gamma', beta'), each (M, H)."""
        g = codes @ self.cond_w[j, 0].T + self.cond_b[j, 0]
        b = codes @ self.cond_w[j, 1].T + self.cond_b[j, 1]
        return g * self.bn_s[j], g * self.bn_t[j] + b

    def condition(self, codes: torch.Tensor) -> torch.Tensor:
        """(M, L) codes -> (M, n_cbn, 2, H): every CBN's folded gamma' and
        beta' (the table the kernels read)."""
        return torch.stack([torch.stack(self.cbn_layer(codes, j), dim=1)
                            for j in range(self.spec.n_cbn)], dim=1)

    def trunk(self, xyz: torch.Tensor, cbn) -> Tuple[torch.Tensor, torch.Tensor]:
        """The residual trunk and heads; ``cbn(j)`` gives CBN j's (gamma',
        beta') per row."""
        net = self.fc_p(xyz)
        for i in range(self.spec.blocks):
            g, b = cbn(2 * i)
            a = self.fc_0[i](torch.relu(g * net + b))
            g, b = cbn(2 * i + 1)
            net = net + self.fc_1[i](torch.relu(g * a + b))
        g, b = cbn(2 * self.spec.blocks)
        h = torch.relu(g * net + b)
        sdf = torch.tanh(self.fc_out(h))[:, 0]
        std = 0.05 + 0.5 * F.softplus(self.uncertainty(h))[:, 0]
        return sdf, std

    def decode(self, latent: torch.Tensor, xyz: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, L), (N, 3) -> sdf (N,), std (N,) in f32, each row conditioned
        on its own latent (differentiable in both)."""
        if compute_dtype != torch.float32:
            raise ValueError(f"{ONET_CBN} computes in float32 only (its bf16 mode "
                             f"is not written), not {compute_dtype}")
        return self.trunk(xyz, lambda j: self.cbn_layer(latent, j))

    forward = decode


class CbnDecoderTrain(nn.Module):
    """onet_cbn's train form: the parameters by the tree's names
    (``fc_p.w``, ``blocks.2.fc_0.b``, ``cbn.4.gamma_w``), each CBN's running
    ``mean`` and ``var`` as buffers.  BN takes its statistics over every
    sample of the batch and moves the running ones as
    ``torch.nn.BatchNorm1d`` does (momentum 0.1, eps 1e-5, the unbiased
    variance)."""

    def __init__(self, spec: CbnSpec, params: Dict[str, Any]):
        super().__init__()
        self.spec = spec

        def pdict(p):
            return nn.ParameterDict({k: _param(v) for k, v in p.items()})
        self.fc_p = pdict(params["fc_p"])
        self.blocks = nn.ModuleList(nn.ModuleDict({k: pdict(v) for k, v in b.items()})
                                    for b in params["blocks"])
        self.cbn = nn.ModuleList()
        for c in params["cbn"]:
            m = pdict({k: v for k, v in c.items() if k not in ("mean", "var")})
            mod = nn.Module()
            mod.p = m
            mod.register_buffer("mean", _t(c["mean"]))
            mod.register_buffer("var", _t(c["var"]))
            self.cbn.append(mod)
        self.fc_out = pdict(params["fc_out"])
        self.uncertainty = pdict(params["uncertainty"])

    def to_params(self) -> Dict[str, Any]:
        def leaf(p):
            return p.detach().cpu().numpy().copy()

        def tree(pd):
            return {k: leaf(v) for k, v in pd.items()}
        return {"fc_p": tree(self.fc_p),
                "blocks": [{k: tree(v) for k, v in b.items()} for b in self.blocks],
                "cbn": [{**tree(c.p), "mean": leaf(c.mean), "var": leaf(c.var)}
                        for c in self.cbn],
                "fc_out": tree(self.fc_out), "uncertainty": tree(self.uncertainty)}

    def _cbn(self, j: int, x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """CBN j of x (B, S, H) under codes (B, L): one conditioning a code,
        broadcast over its S samples; BN over all B S samples."""
        c = self.cbn[j]
        B, S, H = x.shape
        xn = F.batch_norm(x.reshape(B * S, H), c.mean, c.var, training=True,
                          momentum=CBN_MOMENTUM, eps=CBN_EPS).reshape(B, S, H)
        gamma = codes @ c.p["gamma_w"].T + c.p["gamma_b"]
        beta = codes @ c.p["beta_w"].T + c.p["beta_b"]
        return gamma[:, None, :] * xn + beta[:, None, :]

    def forward(self, codes: torch.Tensor, xyz: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """codes (B, L), xyz (B S, 3), the S samples of code b at rows b S ..
        (b + 1) S - 1 -> sdf (B S, 1), std (B S, 1)."""
        B = codes.shape[0]
        x = xyz.reshape(B, -1, 3)

        def lin(p, v):
            return v @ p["w"].T + p["b"]
        net = lin(self.fc_p, x)
        for i, blk in enumerate(self.blocks):
            a = lin(blk["fc_0"], torch.relu(self._cbn(2 * i, net, codes)))
            net = net + lin(blk["fc_1"], torch.relu(self._cbn(2 * i + 1, a, codes)))
        h = torch.relu(self._cbn(len(self.cbn) - 1, net, codes)).reshape(-1, self.spec.hidden)
        sdf = torch.tanh(lin(self.fc_out, h))
        std = 0.05 + 0.5 * F.softplus(lin(self.uncertainty, h))
        return sdf, std


# ---------------------------------------------------------------------------
# pigan_film: pi-GAN's FiLM-SIREN decoder
# ---------------------------------------------------------------------------
#
# pi-GAN's generator (Chan et al., CVPR 2021, arXiv:2012.00926;
# github.com/marcoamonteiro/pi-GAN siren/siren.py: ``CustomMappingNetwork``,
# ``FiLMLayer``, ``TALLSIREN``) with the code z the voxel's latent:
#
#   m = W_3 lrelu(W_2 lrelu(W_1 lrelu(W_0 z + b_0) + b_1) + b_2) + b_3
#       (L -> MH -> MH -> MH -> 2 NL H, leaky slope 0.2)
#   f, phi = m[:NL H], m[NL H:];  gamma_i = 15 f_i + 30,  beta_i = phi_i
#   h_0 = 2 xyz (UniformBoxWarp over one voxel),
#   h_{i+1} = sin(gamma_i (W_i h_i + b_i) + beta_i)      (i = 0 .. NL-1)
#   sdf = tanh(fc_out(h_NL)),  std = 0.05 + 0.5 softplus(uncertainty(h_NL))
#
# The sdf and std heads are DI-Fusion's probabilistic output in place of
# pi-GAN's density; its colour branch (and the mapping's ninth slice) is
# dropped.  The parameter tree: ``mapping[k]`` (k = 0 .. 3), ``film[i]``,
# ``fc_out``, ``uncertainty``; linears as ``{w (out, in), b}``.

PIGAN_FILM = "pigan_film"
FILM_LRELU = 0.2
FILM_FREQ_SCALE, FILM_FREQ_SHIFT = 15.0, 30.0
FILM_WARP = 2.0          # UniformBoxWarp's 2 / side, the side one voxel


class FilmSpec(NamedTuple):
    """pigan_film's widths: the code (``latent_dim``), the FiLM layers' width
    (``hidden_dim``) and count, and the mapping network's hidden width."""
    latent_size: int = 256
    hidden: int = 256
    layers: int = 8
    map_hidden: int = 256

    NAME = PIGAN_FILM

    @property
    def mod_width(self) -> int:
        """Floats of one code's modulation: (gamma, beta) of every layer."""
        return 2 * self.layers * self.hidden

    @classmethod
    def from_hyper(cls, hyper: dict) -> "FilmSpec":
        spec = hyper.get("network_specs") or {}
        return cls(latent_size=int(hyper["code_length"]),
                   hidden=int(spec.get("hidden_dim", 256)),
                   layers=int(spec.get("n_layers", 8)),
                   map_hidden=int(spec.get("mapping_hidden_dim", 256)))


def init_film_params(spec: FilmSpec, generator: torch.Generator) -> Dict[str, Any]:
    """Train-form parameters (numpy f32) drawn from ``generator`` with
    pi-GAN's initialisation: the FiLM layers after the first and the heads
    ``frequency_init(25)``, U(+-sqrt(6/fan_in)/25); the first FiLM layer
    ``first_layer_film_sine_init``, U(+-1/fan_in); the mapping network
    Kaiming normal for leaky ReLU (a = 0.2, fan_in), its last layer's
    weights scaled by 0.25; every bias torch's ``Linear`` default, U(-k, k),
    k = 1/sqrt(fan_in)."""
    def uniform(shape, k):
        return ((torch.rand(shape, generator=generator) * 2 - 1) * k).numpy()

    def linear(din, dout, wk=None, wstd=None):
        w = (torch.randn((dout, din), generator=generator) * wstd).numpy() if wstd is not None \
            else uniform((dout, din), wk)
        return {"w": w.astype(np.float32), "b": uniform((dout,), 1.0 / np.sqrt(din))}

    H, L, MH = spec.hidden, spec.latent_size, spec.map_hidden
    gain = np.sqrt(2.0 / (1.0 + FILM_LRELU ** 2))
    mapping = [linear(din, dout, wstd=gain / np.sqrt(din))
               for din, dout in ((L, MH), (MH, MH), (MH, MH), (MH, spec.mod_width))]
    mapping[-1]["w"] = (mapping[-1]["w"] * 0.25).astype(np.float32)
    film = [linear(3, H, wk=1.0 / 3)]
    film += [linear(H, H, wk=np.sqrt(6.0 / H) / 25) for _ in range(spec.layers - 1)]
    return {"mapping": mapping, "film": film,
            "fc_out": linear(H, 1, wk=np.sqrt(6.0 / H) / 25),
            "uncertainty": linear(H, 1, wk=np.sqrt(6.0 / H) / 25)}


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, FILM_LRELU)


class FilmDecoder(nn.Module):
    """pigan_film's inference form.  The frequency affine folds into the
    mapping's last layer: ``map_w`` (NL, 2, H, MH) and ``map_b`` (NL, 2, H)
    give layer i's gamma (15 W_f + 15 b_f + 30) and beta rows directly
    (:meth:`modulation`).  :meth:`decode` has :meth:`Decoder.decode`'s
    interface and maps every row for itself; the kernels map each code
    once (``ops/decoder_fused``)."""

    def __init__(self, spec: FilmSpec, params: Dict[str, Any]):
        super().__init__()
        self.spec = spec
        H, NL = spec.hidden, spec.layers

        def linear(p):
            w = _t(p["w"])
            lin = nn.Linear(w.shape[1], w.shape[0])
            with torch.no_grad():
                lin.weight.copy_(w)
                lin.bias.copy_(_t(p["b"]))
            return lin
        self.mapping = nn.ModuleList(linear(p) for p in params["mapping"][:-1])
        last = params["mapping"][-1]
        w3 = _t(last["w"]).reshape(2, NL, H, -1).transpose(0, 1)       # (NL, 2, H, MH)
        b3 = _t(last["b"]).reshape(2, NL, H).transpose(0, 1)           # (NL, 2, H)
        scale = torch.tensor([FILM_FREQ_SCALE, 1.0])[None, :, None]
        shift = torch.tensor([FILM_FREQ_SHIFT, 0.0])[None, :, None]
        self.map_w = nn.Parameter((w3 * scale[..., None]).contiguous())
        self.map_b = nn.Parameter((b3 * scale + shift).contiguous())
        self.film = nn.ModuleList(linear(p) for p in params["film"])
        self.fc_out = linear(params["fc_out"])
        self.uncertainty = linear(params["uncertainty"])
        assert len(self.film) == NL and self.map_w.shape[-1] == spec.map_hidden
        self.requires_grad_(False)

    def modulation(self, codes: torch.Tensor) -> torch.Tensor:
        """(M, L) codes -> (M, NL, 2, H): every layer's gamma and beta (the
        table the kernels read)."""
        a = codes
        for lin in self.mapping:
            a = _lrelu(lin(a))
        NL, H = self.spec.layers, self.spec.hidden
        return (a @ self.map_w.reshape(NL * 2 * H, -1).T).view(-1, NL, 2, H) + self.map_b

    def trunk(self, xyz: torch.Tensor, mod: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The FiLM layers and heads; ``mod`` (N, NL, 2, H) each row's
        gamma and beta."""
        h = FILM_WARP * xyz
        for i, lin in enumerate(self.film):
            h = torch.sin(mod[:, i, 0] * lin(h) + mod[:, i, 1])
        sdf = torch.tanh(self.fc_out(h))[:, 0]
        std = 0.05 + 0.5 * F.softplus(self.uncertainty(h))[:, 0]
        return sdf, std

    def decode(self, latent: torch.Tensor, xyz: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, L), (N, 3) -> sdf (N,), std (N,) in f32, each row mapped from
        its own latent (differentiable in both)."""
        if compute_dtype != torch.float32:
            raise ValueError(f"{PIGAN_FILM} computes in float32 only (its bf16 mode "
                             f"is not written), not {compute_dtype}")
        return self.trunk(xyz, self.modulation(latent))

    forward = decode


class FilmDecoderTrain(nn.Module):
    """pigan_film's train form: the parameters by the tree's names
    (``mapping.3.w``, ``film.0.b``, ``fc_out.w``); the mapping runs once a
    code and its gamma and beta broadcast over the code's samples."""

    def __init__(self, spec: FilmSpec, params: Dict[str, Any]):
        super().__init__()
        self.spec = spec

        def pdict(p):
            return nn.ParameterDict({k: _param(v) for k, v in p.items()})
        self.mapping = nn.ModuleList(pdict(p) for p in params["mapping"])
        self.film = nn.ModuleList(pdict(p) for p in params["film"])
        self.fc_out = pdict(params["fc_out"])
        self.uncertainty = pdict(params["uncertainty"])

    def to_params(self) -> Dict[str, Any]:
        def tree(pd):
            return {k: v.detach().cpu().numpy().copy() for k, v in pd.items()}
        return {"mapping": [tree(p) for p in self.mapping], "film": [tree(p) for p in self.film],
                "fc_out": tree(self.fc_out), "uncertainty": tree(self.uncertainty)}

    def forward(self, codes: torch.Tensor, xyz: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """codes (B, L), xyz (B S, 3), the S samples of code b at rows b S ..
        (b + 1) S - 1 -> sdf (B S, 1), std (B S, 1)."""
        B = codes.shape[0]
        NL, H = self.spec.layers, self.spec.hidden

        def lin(p, v):
            return v @ p["w"].T + p["b"]
        a = codes
        for p in self.mapping[:-1]:
            a = _lrelu(lin(p, a))
        f, phi = lin(self.mapping[-1], a).view(B, 2, NL, H).unbind(1)
        gamma = FILM_FREQ_SCALE * f + FILM_FREQ_SHIFT                  # (B, NL, H)
        h = FILM_WARP * xyz.reshape(B, -1, 3)
        for i, p in enumerate(self.film):
            h = torch.sin(gamma[:, None, i] * lin(p, h) + phi[:, None, i])
        h = h.reshape(-1, H)
        sdf = torch.tanh(lin(self.fc_out, h))
        std = 0.05 + 0.5 * F.softplus(lin(self.uncertainty, h))
        return sdf, std


def init_params(spec, generator: torch.Generator) -> Dict[str, Any]:
    """A fresh train-form tree of the spec's family."""
    if isinstance(spec, CbnSpec):
        return init_cbn_params(spec, generator)
    if isinstance(spec, FilmSpec):
        return init_film_params(spec, generator)
    return init_decoder_params(spec, generator)


def train_decoder(spec, params: Dict[str, Any]) -> nn.Module:
    """The train form of the spec's family over a parameter tree."""
    if isinstance(spec, CbnSpec):
        return CbnDecoderTrain(spec, params)
    if isinstance(spec, FilmSpec):
        return FilmDecoderTrain(spec, params)
    return DecoderTrain(spec, params)


def inference_decoder(spec, params: Dict[str, Any]) -> nn.Module:
    """The inference form of the spec's family from a train-form tree
    (a ``di_decoder``'s weight norm folded; folded trees pass through)."""
    if isinstance(spec, CbnSpec):
        return CbnDecoder(spec, params)
    if isinstance(spec, FilmSpec):
        return FilmDecoder(spec, params)
    return Decoder(spec, fold_decoder_params(params))
