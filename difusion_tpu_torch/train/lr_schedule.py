"""Learning-rate schedules for the prior trainer (the port's own copy of
difusion_tpu/train/lr_schedule.py).

The hyper.json schema (``lr_schedule`` entries with ``Type`` = Step / Warmup
/ Constant and the per-type fields) is fixed by the reference checkpoints
(pytorch/ckpt/default/hyper.json:24-33), so the *keys* match; the
implementation is a closure factory rather than a class hierarchy -- each
schedule is just ``epoch -> lr``.
"""
from __future__ import annotations

from typing import Callable, List, Mapping

Schedule = Callable[[int], float]


def _step(spec: Mapping) -> Schedule:
    initial, interval, factor = spec["Initial"], spec["Interval"], spec["Factor"]
    return lambda epoch: initial * factor ** (epoch // interval)


def _warmup(spec: Mapping) -> Schedule:
    lo, hi, length = spec["Initial"], spec["Final"], spec["Length"]
    return lambda epoch: hi if epoch > length else lo + (hi - lo) * epoch / length


def _constant(spec: Mapping) -> Schedule:
    value = spec["Value"]
    return lambda epoch: value


_FACTORIES = {"Step": _step, "Warmup": _warmup, "Constant": _constant}


def make_schedule(spec: Mapping) -> Schedule:
    """One hyper.json lr_schedule entry -> an ``epoch -> lr`` callable."""
    try:
        factory = _FACTORIES[spec["Type"]]
    except KeyError:
        raise ValueError(f"unknown schedule type {spec.get('Type')!r}; "
                         f"expected one of {sorted(_FACTORIES)}") from None
    return factory(spec)


def get_learning_rate_schedules(specs) -> List[Schedule]:
    """Build the per-param-group schedule list from hyper["lr_schedule"]
    (group 0 = decoder, group 1 = encoder, matching the reference trainer's
    param groups)."""
    return [make_schedule(s) for s in specs]
