"""``di_decoder``: DI-Fusion's decoder (DeepSDF's MLP with a std head).

Latent + xyz in, the input fed again at the ``latent_in`` layers, ReLU
between layers, tanh sdf; std = 0.05 + 0.5 softplus of a head on the last
hidden layer.  The raw weights are weight-normed (``g``, ``v``) or plain
(``w``) linear layers ``decoder.layers#<i>`` and ``decoder.uncertainty``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

F32 = 4


def build(w, hyper: dict, lin, tensors):
    latent_in = set(hyper["network_specs"].get("latent_in") or ())
    dec = []
    i = 0
    while f"decoder.layers#{i}.b" in w:
        b = w[f"decoder.layers#{i}.b"].astype(np.float64)
        if f"decoder.layers#{i}.g" in w:
            v = w[f"decoder.layers#{i}.v"].astype(np.float64)
            g = w[f"decoder.layers#{i}.g"].astype(np.float64)
            W = g[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
        else:
            W = w[f"decoder.layers#{i}.w"].astype(np.float64)
        dec.append(tensors(W, b))
        i += 1
    unc = tensors(w["decoder.uncertainty.w"], w["decoder.uncertainty.b"])
    last = len(dec) - 1

    def decode(latent: torch.Tensor, xyz: torch.Tensor):
        """(N, L), (N, 3) -> sdf (N,), std (N,)."""
        inp = torch.cat([latent, xyz], dim=1)
        x = inp
        std = None
        for i, (W, b) in enumerate(dec):
            if i in latent_in:
                x = torch.cat([x, inp], dim=1)
            if i == last:
                std = 0.05 + 0.5 * torch.nn.functional.softplus(lin(x, *unc))
            x = lin(x, W, b)
            if i < last:
                x = torch.relu(x)
        return torch.tanh(x)[:, 0], std[:, 0]

    return decode


def layers(hyper: dict) -> List[Tuple[int, int]]:
    """(in, out) of the decoder's linear layers: ``code_length + 3``
    inputs, ``dims`` hidden layers, the layer before a ``latent_in`` layer
    narrowed so that the input fed again keeps the width, one sdf output."""
    spec = hyper["network_specs"]
    din = int(hyper["code_length"]) + 3
    dims = [din] + [int(d) for d in spec["dims"]] + [1]
    latent_in = set(spec.get("latent_in") or ())
    out = []
    for i in range(len(dims) - 1):
        o = dims[i + 1] - (din if i + 1 in latent_in else 0)
        out.append((dims[i], o))
    return out


def fwd_flops(hyper: dict) -> int:
    """One point's forward: every layer and the std head (from the last
    hidden layer's width)."""
    ls = layers(hyper)
    return 2 * sum(i * o for i, o in ls) + 2 * ls[-1][0]


def grad_flops(hyper: dict) -> int:
    """One point's forward plus d sdf / d xyz: the gradient flows back
    through every layer's full width, and into the input only along its 3
    xyz columns, at the first layer and at each layer that takes the input
    again (the std head is held constant, as the tracker does)."""
    ls = layers(hyper)
    latent_in = set(hyper["network_specs"].get("latent_in") or ())
    din = int(hyper["code_length"]) + 3
    back = 2 * 3 * ls[0][1]
    for i, (cin, cout) in enumerate(ls[1:], start=1):
        hidden_in = cin - din if i in latent_in else cin
        back += 2 * hidden_in * cout
        if i in latent_in:
            back += 2 * 3 * cout
    return fwd_flops(hyper) + back


def param_bytes(hyper: dict) -> int:
    ls = layers(hyper)
    return F32 * (sum(i * o + o for i, o in ls) + ls[-1][0] + 1)


def fwd_point_floats(hyper: dict) -> int:
    """Latents and xyz in, sdf and std out."""
    return int(hyper["code_length"]) + 3 + 2


def grad_point_floats(hyper: dict) -> int:
    """Latents and xyz in, sdf, std and the xyz gradient out."""
    return int(hyper["code_length"]) + 3 + 1 + 1 + 3
