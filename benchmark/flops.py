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

The decoder's counts are its family's (:mod:`.reference.decoders`), kept
beside the reference that defines its mathematics.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .reference import decoders

F32 = 4


def decoder_layers(hyper: dict) -> List[Tuple[int, int]]:
    """(in, out) of the decoder's linear layers, for a family that has them
    (``di_decoder``'s ``layers``)."""
    return decoders.load(hyper).layers(hyper)


def decoder_fwd_flops(hyper: dict) -> int:
    """One point's forward, as the prior's decoder family counts it
    (``reference/decoders/<network_name>.py``)."""
    return decoders.load(hyper).fwd_flops(hyper)


def decoder_grad_flops(hyper: dict) -> int:
    """One point's forward plus d sdf / d xyz, as the family counts it."""
    return decoders.load(hyper).grad_flops(hyper)


def encoder_flops(hyper: dict) -> int:
    """One point's ``di_encoder`` forward: ``per_point_feat`` then the code."""
    dims = list(hyper["encoder_specs"]["per_point_feat"]) + [int(hyper["code_length"])]
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def decoder_param_bytes(hyper: dict) -> int:
    return decoders.load(hyper).param_bytes(hyper)


def decode_grad_bytes(hyper: dict, n: int) -> int:
    """Kernel 1 at ``n`` points: each point's inputs and outputs (the
    family's ``grad_point_floats``), the weights once."""
    return F32 * n * decoders.load(hyper).grad_point_floats(hyper) + decoder_param_bytes(hyper)


def decode_fwd_bytes(hyper: dict, n: int) -> int:
    """Kernel 3 at ``n`` sites: each site's inputs and outputs (the family's
    ``fwd_point_floats``), the weights once."""
    return F32 * n * decoders.load(hyper).fwd_point_floats(hyper) + decoder_param_bytes(hyper)


def bound_s(flops: float, nbytes: float, peaks: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the work at the
    f32-input matrix peak and the bytes at the memory bandwidth."""
    return max(flops / peaks["tf32_flops_per_s"], nbytes / peaks["bytes_per_s"])


def roofline_share(launches: Sequence[Tuple[float, float]], peaks: Dict[str, float],
                   seconds: float) -> float:
    """Percent of the roofline: the bounds of ``launches`` ((flops, bytes)
    each) over the ``seconds`` the card spent in them."""
    return 100.0 * sum(bound_s(f, b, peaks) for f, b in launches) / seconds
