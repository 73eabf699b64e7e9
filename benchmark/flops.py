"""The work of the model, counted from the configuration's widths.

FLOPs are those of the model's mathematics, counted once: a multiply-add
is two operations, and only matrix products are counted (activations, the
robust weights and the SE(3) algebra are a rounding error beside them).  A
route that computes the same product several times, as 3xTF32 does three
TF32 products per f32 product, does not count more: the shares of a peak
then read the same work whatever route implements it, and a change of route
shows as time, not as work.

Bytes are each input read once and each output written once, at the
precision the configuration states (f32): the least traffic the call needs,
whatever the kernel reads again.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

F32 = 4


def decoder_layers(hyper: dict) -> List[Tuple[int, int]]:
    """(in, out) of the decoder's linear layers from the prior's hyper
    (``di_decoder``): ``code_length + 3`` inputs, ``dims`` hidden layers, the
    layer before a ``latent_in`` layer narrowed so that the input fed again
    keeps the width, one sdf output."""
    spec = hyper["network_specs"]
    din = int(hyper["code_length"]) + 3
    dims = [din] + [int(d) for d in spec["dims"]] + [1]
    latent_in = set(spec.get("latent_in") or ())
    layers = []
    for i in range(len(dims) - 1):
        out = dims[i + 1] - (din if i + 1 in latent_in else 0)
        layers.append((dims[i], out))
    return layers


def decoder_fwd_flops(hyper: dict) -> int:
    """One point's forward: every layer and the std head (from the last
    hidden layer's width)."""
    layers = decoder_layers(hyper)
    return 2 * sum(i * o for i, o in layers) + 2 * layers[-1][0]


def decoder_grad_flops(hyper: dict) -> int:
    """One point's forward plus d sdf / d xyz: the gradient flows back
    through every layer's full width, and into the input only along its 3
    xyz columns, at the first layer and at each layer that takes the input
    again (the std head is held constant, as the tracker does)."""
    layers = decoder_layers(hyper)
    latent_in = set(hyper["network_specs"].get("latent_in") or ())
    din = int(hyper["code_length"]) + 3
    back = 2 * 3 * layers[0][1]
    for i, (cin, cout) in enumerate(layers[1:], start=1):
        hidden_in = cin - din if i in latent_in else cin
        back += 2 * hidden_in * cout
        if i in latent_in:
            back += 2 * 3 * cout
    return decoder_fwd_flops(hyper) + back


def encoder_flops(hyper: dict) -> int:
    """One point's ``di_encoder`` forward: ``per_point_feat`` then the code."""
    dims = list(hyper["encoder_specs"]["per_point_feat"]) + [int(hyper["code_length"])]
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def decoder_param_bytes(hyper: dict) -> int:
    layers = decoder_layers(hyper)
    return F32 * (sum(i * o + o for i, o in layers) + layers[-1][0] + 1)


def decode_grad_bytes(hyper: dict, n: int) -> int:
    """Kernel 1 at ``n`` points: latents and xyz in, sdf, std and the xyz
    gradient out, the weights once."""
    din = int(hyper["code_length"]) + 3
    return F32 * n * (din + 1 + 1 + 3) + decoder_param_bytes(hyper)


def decode_fwd_bytes(hyper: dict, n: int) -> int:
    """Kernel 3 at ``n`` sites: latents and xyz in, sdf and std out."""
    din = int(hyper["code_length"]) + 3
    return F32 * n * (din + 2) + decoder_param_bytes(hyper)


def bound_s(flops: float, nbytes: float, peaks: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the work at the
    f32-input matrix peak and the bytes at the memory bandwidth."""
    return max(flops / peaks["tf32_flops_per_s"], nbytes / peaks["bytes_per_s"])


def roofline_share(launches: Sequence[Tuple[float, float]], peaks: Dict[str, float],
                   seconds: float) -> float:
    """Percent of the roofline: the bounds of ``launches`` ((flops, bytes)
    each) over the ``seconds`` the card spent in them."""
    return 100.0 * sum(bound_s(f, b, peaks) for f, b in launches) / seconds
