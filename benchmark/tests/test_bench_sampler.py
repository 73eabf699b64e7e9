"""The check's sample of drawn frames: it covers the whole window at any
speed of the port, with a bounded number of map copies."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.drive import Sampler

FIELDS = ("indexer", "latents")


def _state():
    return SimpleNamespace(indexer=torch.zeros(8, dtype=torch.int32),
                           latents=torch.zeros(4, 3))


@pytest.mark.parametrize("frames", [30, 700, 9000])
def test_each_stratum_is_the_whole_window_at_one_rate(frames):
    cap = 12
    s = Sampler(2 ** 33 + 1, cap, _state(), FIELDS)
    s.armed = True
    state = _state()
    for k in range(100, 100 + frames):
        if k % 12 == 0:
            state = _state()                          # a new map now and then
        s.keep(k, state, k % 20 in (0, 1))
    for stratum, boundary in ((0, False), (1, True)):
        members = [k for k in range(100, 100 + frames) if (k % 20 in (0, 1)) == boundary]
        want = [k for k in members if s._u(k) < s.p[stratum]]
        assert sorted(s.kept[stratum]) == want        # every frame under the rate
        assert len(want) <= cap
        if len(members) > cap:
            assert len(want) >= cap // 4              # halving keeps about cap / 2
            # the window's both halves are drawn from
            assert min(want) < 100 + frames // 2 < max(want)
    assert len(s.free) + len({id(v) for v in s.snaps.values()}) == 2 * cap


def test_frames_that_read_one_map_share_a_copy():
    s = Sampler(5, 8, _state(), FIELDS)
    s.armed = True
    state = _state()
    state.latents.fill_(3.0)
    for k in range(4):
        s.keep(k, state, False)
    snaps = s.snaps
    assert len(snaps) == 4 and len({id(v) for v in snaps.values()}) == 1
    assert torch.equal(next(iter(snaps.values()))["latents"], state.latents)


def test_nothing_is_drawn_before_the_window():
    s = Sampler(5, 8, _state(), FIELDS)
    for k in range(50):
        s.keep(k, _state(), False)
    assert s.snaps == {}
    s.armed = True
    s.keep(50, _state(), False)
    assert list(s.snaps) == ([50] if s._u(50) < 1.0 else [])


def test_the_seed_fixes_the_draw():
    a, b = (Sampler(2 ** 31 + 9, 4, _state(), FIELDS) for _ in range(2))
    c = Sampler(7, 4, _state(), FIELDS)
    assert np.array_equal(a.u, b.u) and not np.array_equal(a.u, c.u)
