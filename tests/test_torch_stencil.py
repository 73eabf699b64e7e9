"""Parity of the plain version of kernel 2 (the window-statistics stencil)
and of the port's ``_window_stats`` against the JAX package, on the CPU."""
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp
import torch

from difusion_tpu.core import tracker as JT
from difusion_tpu.ops.stencil_pallas import window_stat_sums as jax_sums
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.ops import _build
from difusion_tpu_torch.ops import stencil
from difusion_tpu_torch.ops.stencil import window_stat_sums, window_stat_sums_plain


def _maps(h, w, seed):
    rng = np.random.default_rng(seed)
    pc = rng.normal(0, 0.3, (h, w, 3)).astype(np.float32)
    ok = rng.random((h, w)) > 0.2
    comps = [np.where(ok, pc[..., c], 0.0).astype(np.float32) for c in range(3)]
    return comps + [ok.astype(np.float32)]


def _masked(pc, ok):
    return [np.where(ok, pc[..., c], 0.0).astype(np.float32) for c in range(3)] \
        + [ok.astype(np.float32)]


def _edge_case(name):
    """(maps, window, outlier_r2, normal_r2) of one named edge case: shapes
    that are no multiple of any tile of the kernel, images smaller than the
    window, degenerate validity maps, negative coordinates, and a
    binary-fraction grid whose neighbour distances equal the thresholds."""
    rng = np.random.default_rng(sum(map(ord, name)))
    shapes = {"37x53-w2": (37, 53, 2), "1x40-w1": (1, 40, 1), "40x1-w1": (40, 1, 1),
              "5x7-w6": (5, 7, 6), "24x17-w6": (24, 17, 6), "all-invalid-w2": (16, 24, 2),
              "single-valid-w6": (9, 11, 6), "negative-coords-w2": (20, 33, 2),
              "threshold-grid-w1": (12, 14, 1)}
    h, w, window = shapes[name]
    pc = rng.normal(0, 0.3, (h, w, 3)).astype(np.float32)
    ok = rng.random((h, w)) > 0.2
    r2 = (0.05, 0.3)
    if name == "all-invalid-w2":
        ok[:] = False
    elif name == "single-valid-w6":
        ok[:] = False
        ok[4, 5] = True
    elif name == "negative-coords-w2":
        pc = -np.abs(pc) - 3.0
    elif name == "threshold-grid-w1":
        # a 0.25 m lattice in the plane z = 0: |d|^2 of a 4-neighbour is
        # exactly 0.0625 and of a diagonal one exactly 0.125 in f32
        v, u = np.mgrid[:h, :w]
        pc = np.stack([0.25 * u, -0.25 * v, 0 * u], axis=-1).astype(np.float32)
        ok[:] = True
        r2 = (0.0625, 0.125)
    return _masked(pc, ok), window, r2


EDGE_CASES = ["37x53-w2", "1x40-w1", "40x1-w1", "5x7-w6", "24x17-w6", "all-invalid-w2",
              "single-valid-w6", "negative-coords-w2", "threshold-grid-w1"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_sums_match_pallas_interpret_at_edges(name):
    """window_stat_sums_plain against the Pallas kernel in interpret mode on
    the edge cases.  Tolerance: the two counts exactly equal; the nine sums
    rtol 1e-6 + atol 1e-6 (XLA on the CPU may contract a product and a sum
    into an FMA, the plain version rounds each alone)."""
    maps, window, r2 = _edge_case(name)
    ref = jax_sums(*(jnp.asarray(m) for m in maps), window, *r2, interpret=True)
    got = window_stat_sums_plain(*(torch.from_numpy(m) for m in maps), window, *r2)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == maps[0].shape
        if k < 2:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    if name == "threshold-grid-w1":
        # `<=` keeps a neighbour at exactly the threshold: an interior pixel
        # counts itself and its four 4-neighbours, and weights all nine
        assert bool((got[0][1:-1, 1:-1] == 5.0).all())
        assert bool((got[1][1:-1, 1:-1] == 9.0).all())
    if name == "all-invalid-w2":
        assert all(not bool(g.any()) for g in got)


def _sums_skipping(px, py, pz, vf, window, outlier_r2, normal_r2):
    """The kernel's arithmetic in plain PyTorch: the nine products of a tap
    are taken from the neighbour alone (ok*x, (ok*x)*x, ...), and an
    accumulator is left as it is, not added a zero, wherever its threshold
    test fails.  Bit-equal to window_stat_sums_plain on finite inputs
    (the argument is in csrc/window_stats.cu)."""
    h, w = px.shape
    pads = (window,) * 4
    ppx, ppy, ppz, pvf = (torch.nn.functional.pad(a, pads) for a in (px, py, pz, vf))
    acc = [torch.zeros_like(px) for _ in range(11)]
    for dv in range(2 * window + 1):
        for du in range(2 * window + 1):
            nx = ppx[dv:dv + h, du:du + w]
            ny = ppy[dv:dv + h, du:du + w]
            nz = ppz[dv:dv + h, du:du + w]
            nok = pvf[dv:dv + h, du:du + w]
            mx, my, mz = nok * nx, nok * ny, nok * nz
            upd = (nok, mx, my, mz, mx * nx, mx * ny, mx * nz, my * ny, my * nz, mz * nz)
            dx, dy, dz = nx - px, ny - py, nz - pz
            d2 = dx * dx + dy * dy + dz * dz
            acc[0] = torch.where(d2 <= outlier_r2, acc[0] + nok, acc[0])
            keep = d2 <= normal_r2
            acc[1:] = [torch.where(keep, a + u, a) for a, u in zip(acc[1:], upd)]
    return tuple(acc)


@pytest.mark.parametrize("name", EDGE_CASES + ["16x24-w2"])
def test_skipped_zero_weight_taps_change_no_bit(name):
    """The kernel leaves an accumulator alone where a threshold test fails and
    takes a tap's products from the neighbour alone.  That variant in plain
    PyTorch (_sums_skipping) equals the plain version bit for bit (torch.equal on all 11
    planes), negative coordinates included: a skipped add is +-0."""
    maps, window, r2 = (_maps(16, 24, 0), 2, (0.05, 0.3)) if name == "16x24-w2" \
        else _edge_case(name)
    maps = [torch.from_numpy(m) for m in maps]
    ref = window_stat_sums_plain(*maps, window, *r2)
    got = _sums_skipping(*maps, window, *r2)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), k
        assert not bool(torch.signbit(g[g == 0]).any()), k      # no -0 anywhere


@pytest.mark.parametrize("shape,window", [((13, 21), 2), ((5, 7), 6)])
def test_map_entry_on_cpu_masks_and_stacks(shape, window):
    """window_stat_sums_map(pc, valid) == the four-plane entry on
    where(valid, pc, 0) and float(valid), stacked, without a counted launch."""
    rng = np.random.default_rng(3)
    pc = torch.from_numpy(rng.normal(0, 0.3, (*shape, 3)).astype(np.float32))
    ok = torch.from_numpy(rng.random(shape) > 0.2)
    before = _build.launch_counts().get("window_stat_sums", 0)
    got = stencil.window_stat_sums_map(pc, ok, window, 0.05, 0.3)
    planes = [torch.where(ok, pc[..., c], torch.zeros(())) for c in range(3)]
    ref = torch.stack(window_stat_sums_plain(*planes, ok.float(), window, 0.05, 0.3))
    assert got.shape == (11, *shape) and torch.equal(got, ref)
    assert _build.launch_counts().get("window_stat_sums", 0) == before


@pytest.mark.parametrize("h,w,window", [(240, 320, 6), (37, 53, 6), (1, 1, 6),
                                        (37, 53, 1), (37, 53, 0), (480, 640, 6)])
def test_plan_covers_every_pixel_once(h, w, window):
    """The kernel's pixel of (block, warp, lane, k) under the host plan
    (csrc/window_stats.cu `store`): every pixel of the image exactly once."""
    p = stencil.plan(h, w, window, 132)
    assert p.rows in stencil.ROWS and p.tile_h == stencil.WARPS * p.rows
    hits = np.zeros((h, w), np.int64)
    for by in range(p.grid[1]):
        for bx in range(p.grid[0]):
            for warp in range(stencil.WARPS):
                ys = by * p.tile_h + warp * p.rows + np.arange(p.rows)
                xs = bx * stencil.TILE_W + np.arange(stencil.TILE_W)
                ys, xs = ys[ys < h], xs[xs < w]
                hits[np.ix_(ys, xs)] += 1
    assert (hits == 1).all()


def test_plan_balance_at_the_main_path_shape():
    """240x320, w = 6 on 132 SMs: 5 rows a thread, 120 blocks, one a SM and
    one warp a scheduler.  The busiest SM carries 1.10x the mean, which is
    the least any cut into whole pixels per lane allows: 76,800 pixels over
    132 x 4 x 32 lanes are 4.55 a lane, and the busiest lane has >= 5."""
    p = stencil.plan(240, 320, 6, 132)
    assert (p.rows, p.grid, p.blocks_per_sm) == (5, (10, 12), 1)
    lanes = 132 * stencil.WARPS * stencil.TILE_W
    floor = -(-240 * 320 // lanes) * lanes / (240 * 320)
    assert p.busiest_over_mean == pytest.approx(floor) and floor == pytest.approx(1.1)
    # every other rows-per-thread value loads the busiest SM more
    for r in stencil.ROWS:
        blocks = -(-320 // stencil.TILE_W) * -(-240 // (stencil.WARPS * r))
        assert -(-blocks // 132) * r >= 5


def test_plain_sums_match_pallas_interpret():
    """window_stat_sums_plain == the Pallas kernel (interpret mode) at
    16x24, w = 2: both evaluate the same f32 expressions tap by tap in the
    same order, so the counts must agree exactly and the sums to rtol 1e-6
    (atol 1e-6 for sums that cancel to ~0)."""
    maps = _maps(16, 24, 0)
    ref = jax_sums(*(jnp.asarray(m) for m in maps), 2, 0.05, 0.3, interpret=True)
    got = window_stat_sums_plain(*(torch.from_numpy(m) for m in maps), 2, 0.05, 0.3)
    assert len(got) == 11
    for k, (g, r) in enumerate(zip(got, ref)):
        if k < 2:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_runs_plain_without_counting():
    maps = [torch.from_numpy(m) for m in _maps(9, 13, 1)]
    before = _build.launch_counts().get("window_stat_sums", 0)
    a = window_stat_sums(*maps, 3, 0.1, 0.4)
    b = window_stat_sums_plain(*maps, 3, 0.1, 0.4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _build.launch_counts().get("window_stat_sums", 0) == before


@pytest.mark.parametrize("case", ["random", "plane"])
def test_window_stats_match_jax_scan(case):
    """Port _window_stats vs JAX _window_stats(backend="scan") at 48x64,
    w = 3, with the checks of tests/test_tracker.py: outlier and normal masks
    exactly equal; normals of a random cloud (near-degenerate covariances,
    ill-conditioned eigenvectors) agree in direction for > 99% of pixels,
    normals of a noisy plane everywhere to |cos| > 0.9999."""
    rng = np.random.default_rng(12)
    H, W = 48, 64
    if case == "random":
        pc = rng.normal(size=(H, W, 3)).astype(np.float32)
        ok = rng.random((H, W)) > 0.2
    else:
        z = 2.0 + 0.001 * rng.standard_normal((H, W)).astype(np.float32)
        u = np.arange(W, dtype=np.float32)[None, :] * 0.01
        v = np.arange(H, dtype=np.float32)[:, None] * 0.01
        pc = np.stack([u + 0 * z, v + 0 * z, z], axis=-1).astype(np.float32)
        ok = np.ones((H, W), bool)
    a = JT._window_stats(jnp.asarray(pc), jnp.asarray(ok), 3, 0.25, 4, 1.0, 3.0,
                         backend="scan")
    b = T._window_stats(torch.from_numpy(pc), torch.from_numpy(ok), 3, 0.25, 4,
                        1.0, 3.0)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    m = np.asarray(a[2])
    dots = np.abs(np.sum(np.asarray(a[1])[m] * b[1].numpy()[m], axis=-1))
    if case == "random":
        assert (dots > 0.9999).mean() > 0.99, ((dots > 0.9999).mean(), dots.min())
    else:
        assert dots.min() > 0.9999, dots.min()
