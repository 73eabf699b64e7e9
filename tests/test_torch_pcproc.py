"""The port's point-cloud ops (``difusion_tpu_torch/ops/pcproc.py``) against
the JAX package's (``difusion_tpu/ops/pcproc.py``, run as its own tests run
it) and against brute force, on seeded clouds with negative cell
coordinates, invalid points, capped cells and two cells whose hashes
collide: the uint32 cell hash, the sorted grid, radius neighbours, radius
outlier removal, PCA normals, compaction and the box filter's unbounded
(hash + lexsort) path."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp

from difusion_tpu.ops import pcproc as J
from difusion_tpu_torch.ops import pcproc as T

# two distinct cells with one uint32 hash (found by a birthday search over
# cells in [-4096, 4096)^3; test_hash_matches_jax checks the collision)
COLLIDING = (np.array([-1150, 3106, 99]), np.array([-609, 1486, 3504]))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Several workers run the suite at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n=1000, scale=1.2, holes=0.1):
    """Uniform in [-scale, scale)^3 (negative cells included), ``holes`` of
    the points invalid."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-1, 1, (n, 3)) * scale).astype(np.float32)
    return pts, rng.random(n) >= holes


def _both(fn, *arrays, **kw):
    """``fn`` of both packages on the same numpy inputs, as numpy."""
    ref = getattr(J, fn)(*(jnp.asarray(a) for a in arrays), **kw)
    got = getattr(T, fn)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    if isinstance(ref, tuple):
        return [np.asarray(r) for r in ref], [g.numpy() for g in got]
    return np.asarray(ref), got.numpy()


def test_hash_matches_jax():
    """uint32 wrap-around of negative and large cells, as ``astype(uint32)``
    and uint32 products give them."""
    rng = np.random.default_rng(0)
    cells = np.concatenate([rng.integers(-4096, 4096, (5000, 3)),
                            rng.integers(-2 ** 31, 2 ** 31, (5000, 3)),
                            np.stack(COLLIDING)]).astype(np.int32)
    ref = np.asarray(J._hash_cells(jnp.asarray(cells))).astype(np.int64)
    got = T._hash_cells(torch.from_numpy(cells))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[-1] == ref[-2] and (COLLIDING[0] != COLLIDING[1]).any()


@pytest.mark.parametrize("cell_cap", [8, 64])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_radius_neighbors_match_jax_and_brute_force(cell_cap, exclude_self):
    """The grid's sorted order equal; ``ok`` equal and ``idx`` equal where
    ok, at a cap that truncates runs (8) and one that does not (64); where
    no scanned run reached the cap, the neighbours are brute force's."""
    pts, valid = _cloud(1)
    radius = 0.2
    jg = J.build_grid(jnp.asarray(pts), jnp.asarray(valid), radius)
    tg = T.build_grid(torch.from_numpy(pts), torch.from_numpy(valid), radius)
    np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
    np.testing.assert_array_equal(tg.sorted_hash.numpy(),
                                  np.asarray(jg.sorted_hash).astype(np.int64))
    np.testing.assert_array_equal(tg.cell.numpy(), np.asarray(jg.cell))
    ji, jo = J.radius_neighbors(jg, jnp.asarray(pts), jnp.asarray(valid), radius,
                                cell_cap, exclude_self_index=exclude_self)
    ti, to = T.radius_neighbors(tg, torch.from_numpy(pts), torch.from_numpy(valid),
                                radius, cell_cap, exclude_self_index=exclude_self)
    ji, jo, ti, to = np.asarray(ji), np.asarray(jo), ti.numpy(), to.numpy()
    assert ti.dtype == np.int32 and ti.shape == ji.shape == (len(pts), 27 * cell_cap)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ti[to], ji[jo])

    d2 = np.sum((pts[None] - pts[:, None]) ** 2, axis=-1)
    truth = (d2 <= radius ** 2) & valid[None] & valid[:, None]
    if exclude_self:
        np.fill_diagonal(truth, False)
    # a cell's run holds at most its points, so a cell with more than the
    # cap may lose candidates: compare queries whose 27 cells all fit
    cell = np.floor(pts / radius).astype(np.int64)
    cells, per_cell = np.unique(cell[valid], axis=0, return_counts=True)
    full = {tuple(c) for c in cells[per_cell > cell_cap]}
    offs = np.array([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)])
    checked = 0
    for q in range(0, len(pts), 7):
        if any(tuple(c) in full for c in cell[q] + offs):
            continue
        checked += 1
        assert set(ti[q][to[q]].tolist()) == set(np.nonzero(truth[q])[0].tolist()), q
    assert checked > 100


def _clusters(seed, size, holes):
    """30 points in each of the two colliding cells (of edge ``size``), and
    ``holes`` invalid points after them."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([(c + rng.uniform(0.2, 0.8, (30, 3))) * size for c in COLLIDING]
                         + [np.zeros((holes, 3))]).astype(np.float32)
    return pts, np.arange(len(pts)) < 60


def test_colliding_cells_stay_apart():
    """Two clusters in two cells of one hash (and a hole): their points
    share one sorted run, and each query keeps only its own cell's
    neighbours (the exact cell check), as the JAX package does."""
    size = 0.5
    pts, valid = _clusters(2, size, holes=1)
    grid = T.build_grid(torch.from_numpy(pts), torch.from_numpy(valid), size)
    h = grid.sorted_hash.numpy()
    assert (h == h[0]).sum() == 60            # one run of 60 points
    idx, ok = T.radius_neighbors(grid, torch.from_numpy(pts), torch.from_numpy(valid),
                                 size, cell_cap=64)
    jg = J.build_grid(jnp.asarray(pts), jnp.asarray(valid), size)
    ji, jo = J.radius_neighbors(jg, jnp.asarray(pts), jnp.asarray(valid), size, 64)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.asarray(ji)[np.asarray(jo)])
    d2 = np.sum((pts[None] - pts[:, None]) ** 2, axis=-1)
    for q in (0, 29, 30, 59):
        assert set(idx[q][ok[q]].tolist()) == set(np.nonzero(d2[q, :60] <= size ** 2)[0].tolist())
        assert all((i < 30) == (q < 30) for i in idx[q][ok[q]].tolist())


def test_a_run_that_ends_the_array_counts_each_point_once():
    """Where every point is valid, the largest hash's run ends the sorted
    array, and the JAX package clamps the slots past the end to the last
    point and counts that point once a slot (a fault of the JAX package,
    which is not edited).  The port stops the run at the end: its counts are
    brute force's, and every pair the JAX package finds once it finds."""
    size = 0.5
    pts, valid = _clusters(2, size, holes=0)
    d2 = np.sum((pts[None] - pts[:, None]) ** 2, axis=-1)
    truth = (d2 <= size ** 2).sum(axis=1)
    grid = T.build_grid(torch.from_numpy(pts), torch.from_numpy(valid), size)
    idx, ok = T.radius_neighbors(grid, torch.from_numpy(pts), torch.from_numpy(valid),
                                 size, cell_cap=64)
    np.testing.assert_array_equal(ok.numpy().sum(axis=1), truth)
    jg = J.build_grid(jnp.asarray(pts), jnp.asarray(valid), size)
    ji, jo = map(np.asarray, J.radius_neighbors(jg, jnp.asarray(pts), jnp.asarray(valid),
                                                size, 64))
    last = int(grid.order[-1])
    assert (jo.sum(axis=1) > truth).any()                    # the JAX package's repeats
    for q in range(60):
        got = idx[q][ok[q]].numpy()
        assert len(set(got.tolist())) == len(got)            # no repeats here
        assert set(got.tolist()) == set(ji[q][jo[q]].tolist())
        assert (ji[q][jo[q]] != last).sum() == (got != last).sum()


@pytest.mark.parametrize("cell_cap", [8, 64])
def test_remove_radius_outlier_matches_jax(cell_cap):
    """Masks equal, on a dense cluster with stragglers and holes; at cap 64
    (no run truncated) also brute force's count."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform(-0.08, 0.08, (800, 3)),
                          rng.uniform(-1.0, 1.0, (200, 3))]).astype(np.float32)
    valid = rng.random(1000) > 0.05
    ref, got = _both("remove_radius_outlier", pts, valid, nb_points=16, radius=0.05,
                     cell_cap=cell_cap)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < valid.sum()
    if cell_cap == 64:
        d2 = np.sum((pts[None] - pts[:, None]) ** 2, axis=-1)
        count = ((d2 <= 0.05 ** 2) & valid[None]).sum(axis=1)
        np.testing.assert_array_equal(got, valid & (count >= 16))


@pytest.mark.parametrize("cloud", ["plane", "random"])
def test_estimate_normals_match_jax(cloud):
    """``ok`` equal and normals within 2e-3 where ok (the covariance is an
    einsum of the neighbours on both sides, in another summation order; a
    random cloud's smallest eigenvalue is barely separated, which the
    measured 4e-5 reflects); on a plane z = 2 the normal is -z (flipped to
    the camera at the origin)."""
    rng = np.random.default_rng(4)
    if cloud == "plane":
        xy = rng.uniform(-0.5, 0.5, (1000, 2))
        pts = np.concatenate([xy, np.full((1000, 1), 2.0)], axis=1).astype(np.float32)
        valid = np.ones(1000, bool)
    else:
        pts, valid = _cloud(5, scale=0.6)
    (rn, rok), (gn, gok) = _both("estimate_normals", pts, valid, radius=0.2, cell_cap=32)
    np.testing.assert_array_equal(gok, rok)
    assert gok.mean() > 0.8
    np.testing.assert_allclose(gn[gok], rn[rok], atol=2e-3, rtol=0)
    if cloud == "plane":
        np.testing.assert_allclose(gn[gok, 2], -1.0, atol=1e-4)


def test_compact_matches_jax():
    rng = np.random.default_rng(6)
    valid = rng.random(50) > 0.6
    vals = rng.normal(size=(50, 3)).astype(np.float32)
    ids = np.arange(50, dtype=np.int32)
    for budget in (5, int(valid.sum()), 60):
        ref = J.compact(jnp.asarray(valid), budget, jnp.asarray(vals), jnp.asarray(ids))
        got = T.compact(torch.from_numpy(valid), budget, torch.from_numpy(vals),
                        torch.from_numpy(ids))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[2].numpy()[:valid.sum()], np.nonzero(valid)[0])


def test_point_box_filter_unbounded_matches_jax():
    """The hash + lexsort path (no aabb): the same voxels in the same order,
    means within 5e-5 (f32 prefix sums), with NaN on invalid rows contained;
    and the same voxel set as the bounded path."""
    pts, valid = _cloud(7)
    rng = np.random.default_rng(8)
    normals = rng.normal(size=(1000, 3)).astype(np.float32)
    pts[~valid] = np.nan
    (rp, rn, rok), (gp, gn, gok) = _both("point_box_filter", pts, normals, valid,
                                         voxel_size=0.1, out_budget=1100)
    np.testing.assert_array_equal(gok, rok)
    np.testing.assert_allclose(gp, rp, atol=5e-5, rtol=0)
    np.testing.assert_allclose(gn, rn, atol=5e-5, rtol=0)
    assert np.isfinite(gp[gok]).all() and 300 < gok.sum() < 1000
    bp, _, bok = T.point_box_filter(torch.from_numpy(pts), torch.from_numpy(normals),
                                    torch.from_numpy(valid), 0.1, 1100,
                                    aabb=((-2.0,) * 3, (2.0,) * 3))
    a = gp[gok][np.lexsort(gp[gok].T)]
    b = bp.numpy()[bok.numpy()]
    np.testing.assert_allclose(a, b[np.lexsort(b.T)], atol=5e-5)
