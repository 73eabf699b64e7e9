"""The weight carrier: JAX-layout parameter trees <-> files and the port's modules.

Counterpart of difusion_tpu/models/torch_import.py (the npz round-trip,
:107-166; the reference's ``.pth.tar`` checkpoints, read at :22-105 and
written at :169-231) and ``slam.load_prior`` (slam.py:142-162).
Parameter trees are the JAX package's: decoder ``{"layers": [{w, b} or
{g, v, b}, ...], "uncertainty": {w, b}}``; encoder ``{"layers": [{w, bn_scale,
bn_bias, bn_mean, bn_var} or {w, b}, ...]}``.  A prior on disk is
``prior_{epoch}.npz`` beside ``hyper.json``, with flattened keys such as
``decoder.layers#0.v``, ``decoder.uncertainty.w`` and ``encoder.layers#2.bn_var``;
or, in the reference's layout, ``model_{epoch}.pth.tar`` and
``encoder_{epoch}.pth.tar`` beside it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .decoder import DecoderSpec, inference_decoder, spec_from_hyper
from .encoder import Encoder, EncoderSpec, fold_encoder_params


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """``{"layers#0.w": a, "uncertainty.b": b}`` -> nested dicts/lists."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def expand(node):
        if not isinstance(node, dict):
            return node
        out: Dict[str, Any] = {}
        lists: Dict[str, Dict[int, Any]] = {}
        for k, v in node.items():
            v = expand(v)
            if "#" in k:
                name, idx = k.rsplit("#", 1)
                lists.setdefault(name, {})[int(idx)] = v
            else:
                out[k] = v
        for name, items in lists.items():
            out[name] = [items[i] for i in sorted(items)]
        return out

    return expand(root)


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}" if prefix else k, out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}#{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def save_params_npz(path, **trees: Any) -> None:
    """Trees -> one npz of flattened keys, the layout the JAX package's
    ``load_params_npz`` reads (``save_params_npz(p, decoder=d, encoder=e)``)."""
    flat: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        _flatten(tree, name, flat)
    np.savez(path, **flat)


def load_params_npz(path) -> Dict[str, Any]:
    """npz of flattened trees -> ``{"decoder": tree, "encoder": tree}``."""
    with np.load(path) as data:
        grouped: Dict[str, Dict[str, np.ndarray]] = {}
        for key in data.files:
            top, rest = key.split(".", 1)
            grouped.setdefault(top, {})[rest] = data[key]
    return {name: _unflatten(flat) for name, flat in grouped.items()}


def from_jax_params(dec_np: Dict[str, Any], enc_np: Dict[str, Any],
                    spec, enc_spec: Optional[EncoderSpec] = None,
                    device="cuda") -> Tuple[Any, Encoder]:
    """Parameter trees (numpy leaves; folded or train form) -> the port's
    inference decoder of the spec's family (``Decoder``, ``CbnDecoder`` or
    ``FilmDecoder``) and :class:`Encoder` on ``device``."""
    dev = resolve_device(device)
    enc_spec = enc_spec or EncoderSpec(latent_size=spec.latent_size)
    dec = inference_decoder(spec, dec_np).to(dev)
    enc = Encoder(enc_spec, fold_encoder_params(enc_np)).to(dev)
    return dec, enc


def load_prior(hyper_path, use_epoch: int = 300, device="cuda") -> Tuple[Any, Encoder, Any]:
    """Read ``prior_{use_epoch}.npz`` beside ``hyper_path``, or where there
    is none the reference's ``model_`` / ``encoder_{use_epoch}.pth.tar``
    (``di_decoder`` only), and build the port's modules on ``device``: the
    decoder of the family the hyper's ``network_name`` names
    (:func:`~.decoder.spec_from_hyper`), its spec and the encoder."""
    hyper_path = Path(hyper_path)
    hyper = json.loads(hyper_path.read_text())
    npz = hyper_path.parent / f"prior_{use_epoch}.npz"
    if npz.exists():
        trees = load_params_npz(npz)
        dec_t, enc_t = trees["decoder"], trees["encoder"]
    elif (hyper_path.parent / f"model_{use_epoch}.pth.tar").exists():
        dec_t, enc_t, _, _, _ = load_torch_prior(hyper_path, use_epoch)
    else:
        raise FileNotFoundError(f"neither {npz} nor model_{use_epoch}.pth.tar "
                                f"in {hyper_path.parent}")
    spec = spec_from_hyper(hyper)
    enc_spec = EncoderSpec.from_hyper(hyper)
    dec, enc = from_jax_params(dec_t, enc_t, spec, enc_spec, device=device)
    return dec, enc, spec


# ---------------------------------------------------------------------------
# The reference's torch checkpoints (state dicts in ``.pth.tar`` files)
# ---------------------------------------------------------------------------


def _to_np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _from_np(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def decoder_params_from_state_dict(state: Dict[str, Any], spec: DecoderSpec) -> Dict[str, Any]:
    """Torch state dict -> train-form decoder tree (weight norm kept)."""
    layers = []
    for i in range(len(spec.dims) + 1):
        prefix = f"lin{i}"
        if f"{prefix}.weight_g" in state:
            layers.append({"g": _to_np(state[f"{prefix}.weight_g"]).reshape(-1),
                           "v": _to_np(state[f"{prefix}.weight_v"]),
                           "b": _to_np(state[f"{prefix}.bias"])})
        else:
            layers.append({"w": _to_np(state[f"{prefix}.weight"]),
                           "b": _to_np(state[f"{prefix}.bias"])})
    return {"layers": layers,
            "uncertainty": {"w": _to_np(state["uncertainty_layer.weight"]),
                            "b": _to_np(state["uncertainty_layer.bias"])}}


def encoder_params_from_state_dict(state: Dict[str, Any], spec: EncoderSpec) -> Dict[str, Any]:
    """Torch state dict -> train-form encoder tree (BatchNorm statistics kept)."""
    layers = []
    for i in range(len(spec.all_dims) - 1):
        prefix = f"mlp.layer{i}"
        w = _to_np(state[f"{prefix}.conv.weight"])[:, :, 0]     # (out, in, 1)
        bn = f"{prefix}.normlayer.bn"
        if f"{bn}.weight" in state:
            layers.append({"w": w, "bn_scale": _to_np(state[f"{bn}.weight"]),
                           "bn_bias": _to_np(state[f"{bn}.bias"]),
                           "bn_mean": _to_np(state[f"{bn}.running_mean"]),
                           "bn_var": _to_np(state[f"{bn}.running_var"])})
        else:
            layers.append({"w": w, "b": _to_np(state[f"{prefix}.conv.bias"])})
    return {"layers": layers}


def decoder_state_dict_from_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Train-form decoder tree -> the reference's state dict:
    ``lin{i}.weight_g`` (out, 1), ``lin{i}.weight_v``, ``lin{i}.bias``,
    ``uncertainty_layer.*``."""
    state = {}
    for i, layer in enumerate(params["layers"]):
        prefix = f"lin{i}"
        if "g" in layer:
            state[f"{prefix}.weight_g"] = _from_np(np.asarray(layer["g"]).reshape(-1, 1))
            state[f"{prefix}.weight_v"] = _from_np(layer["v"])
        else:
            state[f"{prefix}.weight"] = _from_np(layer["w"])
        state[f"{prefix}.bias"] = _from_np(layer["b"])
    state["uncertainty_layer.weight"] = _from_np(params["uncertainty"]["w"])
    state["uncertainty_layer.bias"] = _from_np(params["uncertainty"]["b"])
    return state


def encoder_state_dict_from_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Train-form encoder tree -> the reference's state dict:
    ``mlp.layer{i}.conv.weight`` (out, in, 1) and
    ``mlp.layer{i}.normlayer.bn.*`` (or ``conv.bias`` on the last layer)."""
    state = {}
    for i, layer in enumerate(params["layers"]):
        prefix = f"mlp.layer{i}"
        state[f"{prefix}.conv.weight"] = _from_np(np.asarray(layer["w"])[:, :, None])
        if "bn_mean" in layer:
            bn = f"{prefix}.normlayer.bn"
            state[f"{bn}.weight"] = _from_np(layer["bn_scale"])
            state[f"{bn}.bias"] = _from_np(layer["bn_bias"])
            state[f"{bn}.running_mean"] = _from_np(layer["bn_mean"])
            state[f"{bn}.running_var"] = _from_np(layer["bn_var"])
            state[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        else:
            state[f"{prefix}.conv.bias"] = _from_np(layer["b"])
    return state


def save_torch_prior(exp_dir, epoch: int, dec_params: Dict[str, Any],
                     enc_params: Dict[str, Any], hyper: dict) -> None:
    """``model_{epoch}.pth.tar``, ``encoder_{epoch}.pth.tar`` and (if absent)
    ``hyper.json`` in the reference's layout."""
    exp_dir = Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    torch.save({"epoch": epoch, "model_state": decoder_state_dict_from_params(dec_params)},
               exp_dir / f"model_{epoch}.pth.tar")
    torch.save({"epoch": epoch, "model_state": encoder_state_dict_from_params(enc_params)},
               exp_dir / f"encoder_{epoch}.pth.tar")
    hyper_path = exp_dir / "hyper.json"
    if not hyper_path.exists():
        hyper_path.write_text(json.dumps(hyper, indent=2, default=str))


def load_torch_prior(hyper_path, use_epoch: int = -1
                     ) -> Tuple[Dict[str, Any], Dict[str, Any], DecoderSpec, EncoderSpec, dict]:
    """A reference-layout prior directory -> (decoder tree, encoder tree,
    decoder spec, encoder spec, hyper).  ``use_epoch`` -1 takes the latest
    ``model_*.pth.tar``.  The files are read with ``weights_only=True``."""
    hyper_path = Path(hyper_path)
    hyper = json.loads(hyper_path.read_text())
    spec_d, spec_e = DecoderSpec.from_hyper(hyper), EncoderSpec.from_hyper(hyper)
    exp_dir = hyper_path.parent
    models = {int(p.name.split("model_")[-1].split(".pth")[0]): p
              for p in exp_dir.glob("model_*.pth.tar")}
    if use_epoch == -1 and models:
        use_epoch = max(models)
    if use_epoch not in models:
        raise FileNotFoundError(f"epoch {use_epoch} not in {sorted(models)} ({exp_dir})")
    dec_state = torch.load(models[use_epoch], map_location="cpu",
                           weights_only=True)["model_state"]
    enc_state = torch.load(exp_dir / f"encoder_{use_epoch}.pth.tar", map_location="cpu",
                           weights_only=True)["model_state"]
    return (decoder_params_from_state_dict(dec_state, spec_d),
            encoder_params_from_state_dict(enc_state, spec_e), spec_d, spec_e, hyper)
