"""Parity of the port's hash-indexed map (``core/hash_map.py``) and its
mesher's prep against the JAX package on the CPU: the hash, cells on voxel
boundaries, parallel insertion under collisions, duplicates, probe
exhaustion and capacity overflow, fusion (by cell), the SDF-term gather,
the query, save/load across the packages, and ``_mesh_prep_hash``."""
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
import torch

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.core.meshing import _dilate6_cells
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core.meshing import _mesh_prep_hash
from difusion_tpu_torch.models.decoder import DecoderSpec
from difusion_tpu_torch.models.weights import from_jax_params

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
FUSE = dict(voxel_size=0.1, latent_dim=29, capacity=4096, table_size=1 << 13,
            prune_min_vox_obs=4, ignore_count_th=2.0, encoder_count_th=600.0)


@pytest.fixture(scope="module")
def nets():
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    t_dec, t_enc = from_jax_params(jax.tree.map(np.asarray, dec),
                                   jax.tree.map(np.asarray, enc), DecoderSpec(*spec),
                                   device="cpu")
    return dec, enc, spec, t_dec, t_enc


def _both(cfg_kw):
    jcfg, tcfg = JHM.HashMapConfig(**cfg_kw), HM.HashMapConfig(**cfg_kw)
    return jcfg, JHM.create_hash_map_state(jcfg), tcfg, HM.create_hash_map_state(tcfg, "cpu")


def _insert_both(cfg_kw, cells, want=None):
    jcfg, js, tcfg, ts = _both(cfg_kw)
    want = np.ones(len(cells), bool) if want is None else want
    js, jpos = JHM.insert(jcfg, js, jnp.asarray(cells), jnp.asarray(want))
    ts, tpos = HM.insert(tcfg, ts, torch.from_numpy(cells), torch.from_numpy(want))
    return (jcfg, js, np.asarray(jpos)), (tcfg, ts, tpos.numpy())


def _assert_same_table(js, ts):
    """Insertion is deterministic (same hash, same ranks, same claims): the
    table, the slots and the counters match exactly."""
    for f in ("keys", "table_slot", "slot_cell", "n_occupied", "overflow"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)


@pytest.mark.parametrize("table_size", [1 << 8, 1 << 13, 1 << 18])
def test_hash_matches_jax(table_size):
    """The int64 hash against the JAX uint32 product hash: negative cells,
    cells near +-2^20 and the int32 extremes."""
    rng = np.random.default_rng(0)
    cells = np.concatenate([rng.integers(-60, 60, (2000, 3)),
                            rng.integers(-(1 << 20), 1 << 20, (2000, 3)),
                            [[-2 ** 31, -1, 0], [2 ** 31 - 1, -2 ** 31 + 1, 7]]]).astype(np.int32)
    cfg_kw = dict(voxel_size=0.1, table_size=table_size)
    got = HM._hash(HM.HashMapConfig(**cfg_kw), torch.from_numpy(cells)).numpy()
    ref = np.asarray(JHM._hash(JHM.HashMapConfig(**cfg_kw), jnp.asarray(cells)))
    np.testing.assert_array_equal(got, ref)


def test_cells_on_voxel_boundaries_match_jax():
    """Points on cell faces and one f32 ulp either side: the fusion's cell
    (``cell_of``) and the SDF gather's (from ``pn * voxel_size``) against the
    jitted JAX functions, where XLA divides by the voxel size as a multiply
    by its reciprocal.  (XLA on the CPU flushes denormals to zero, so the
    ulp neighbours of 0 are left out: no scene point is a denormal.)"""
    cfg_kw = dict(voxel_size=0.1, capacity=64, table_size=256)
    jcfg, js, tcfg, ts = _both(cfg_kw)
    k = np.arange(-40, 41, dtype=np.float32) * np.float32(0.1)
    nz = k[k != 0]
    edge = np.concatenate([k, np.nextafter(nz, np.float32(np.inf)),
                           np.nextafter(nz, np.float32(-np.inf))])
    pts = np.stack([edge, np.roll(edge, 7), np.roll(edge, 19)], 1).astype(np.float32)
    ref = np.asarray(jax.jit(JHM.cell_of, static_argnums=0)(jcfg, jnp.asarray(pts)))
    np.testing.assert_array_equal(HM.cell_of(tcfg, torch.from_numpy(pts)).numpy(), ref)
    # the gather's cell shows in rel: rel = pn - cell - 0.5
    table = M.latent_count_table(ts)
    jg = jax.jit(JHM.gather_latent_rel, static_argnums=0)
    _, jrel, _ = jg(jcfg, js, jnp.asarray(pts), JM.latent_count_table(js))
    _, trel, _ = HM.gather_latent_rel(tcfg, ts, torch.from_numpy(pts), table)
    np.testing.assert_array_equal(trel.numpy(), np.asarray(jrel))


def test_insert_lookup_roundtrip_with_collisions():
    """150 unique cells into a 512-entry table: every cell gets its own
    entry holding its key, lookup finds it, a missing cell gives -1; the
    port's table equals the JAX package's."""
    rng = np.random.default_rng(0)
    cells = np.unique(rng.integers(-50, 50, (150, 3)).astype(np.int32), axis=0)
    (jcfg, js, jpos), (tcfg, ts, tpos) = _insert_both(
        dict(voxel_size=0.1, capacity=512, table_size=512), cells)
    _assert_same_table(js, ts)
    np.testing.assert_array_equal(tpos, jpos)
    assert (tpos >= 0).all() and len(np.unique(tpos)) == len(cells)
    assert (ts.keys.numpy()[tpos] == cells).all()
    found = HM.lookup(tcfg, ts.keys, torch.from_numpy(cells)).numpy()
    np.testing.assert_array_equal(found, tpos)
    assert HM.lookup(tcfg, ts.keys, torch.tensor([[999, 999, 999]])).item() == -1


def test_insert_duplicates_and_reinsert():
    """Duplicate cells in one batch resolve to one entry; inserting again
    changes nothing."""
    cells = np.array([[1, 2, 3]] * 5 + [[4, 5, 6]] * 3, np.int32)
    cfg_kw = dict(voxel_size=0.1, capacity=64, table_size=128)
    (jcfg, js, jpos), (tcfg, ts, tpos) = _insert_both(cfg_kw, cells)
    _assert_same_table(js, ts)
    assert int(ts.n_occupied) == 2
    assert (tpos[:5] == tpos[0]).all() and (tpos[5:] == tpos[5]).all()
    ts2, tpos2 = HM.insert(tcfg, ts, torch.from_numpy(cells), torch.ones(8, dtype=torch.bool))
    assert int(ts2.n_occupied) == 2
    np.testing.assert_array_equal(tpos2.numpy(), tpos)


def test_probe_exhaustion_counts_overflow():
    """At load ~0.6 with 8 probes some keys find no entry: they are counted
    in ``overflow``, as the JAX package counts them, and the table holds
    only whole keys."""
    rng = np.random.default_rng(3)
    cells = np.unique(rng.integers(-50, 50, (170, 3)).astype(np.int32), axis=0)
    want = rng.uniform(size=len(cells)) > 0.05
    (jcfg, js, jpos), (tcfg, ts, tpos) = _insert_both(
        dict(voxel_size=0.1, capacity=256, table_size=256, n_probes=8), cells, want)
    _assert_same_table(js, ts)
    n_in = (tpos >= 0).sum()
    assert n_in == int(ts.n_occupied) and int(ts.overflow) == want.sum() - n_in > 0
    assert (tpos[~want] == -1).all()
    assert (ts.keys.numpy()[tpos[tpos >= 0]] == cells[tpos >= 0]).all()


def test_capacity_overflow_counted():
    """More new cells than slots: the slots fill, the rest is counted."""
    cells = np.stack([np.arange(20), np.zeros(20), np.zeros(20)], 1).astype(np.int32)
    (jcfg, js, _), (tcfg, ts, _) = _insert_both(
        dict(voxel_size=0.1, capacity=8, table_size=64), cells)
    _assert_same_table(js, ts)
    assert int(ts.n_occupied) == 8 and int(ts.overflow) >= 12


def _surface(seed, n=4096, x0=0.0):
    """Points on the corrugated surface over a 1 m patch around the origin
    (negative cells too), with normals and ~5% invalid rows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(x0 - 0.5, x0 + 0.5, n)
    y = rng.uniform(-0.5, 0.5, n)
    z = 0.1 * (np.sin(5 * x) + 0.7 * np.cos(4 * y))
    nrm = np.stack([0.5 * np.cos(5 * x), -0.28 * np.sin(4 * y), -np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (np.stack([x, y, z], 1).astype(np.float32), nrm.astype(np.float32),
            rng.uniform(size=n) > 0.05)


def _fused(nets):
    """Two overlapping fusions through both packages."""
    _, enc, _, _, t_enc = nets
    jcfg, js, tcfg, ts = _both(FUSE)
    fuse = jax.jit(JHM.integrate_keyframe, static_argnums=0)
    for seed, x0 in ((0, 0.0), (1, 0.4)):
        pts, nrm, valid = _surface(seed, x0=x0)
        js = fuse(jcfg, enc, js, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(valid))
        ts = HM.integrate_keyframe(tcfg, t_enc, ts, torch.from_numpy(pts),
                                   torch.from_numpy(nrm), torch.from_numpy(valid))
    return jcfg, js, tcfg, ts


def test_fusion_matches_jax_by_cell(nets):
    """The hash fusion against the JAX package's: the same cells allocated
    (compared by cell: slots follow insertion order), the same overflow and
    dirty cells; per cell, obs_count to rtol 1e-5 and latents to rtol 1e-5
    (atol 1e-6), the tolerance of the dense fusion's parity test."""
    jcfg, js, tcfg, ts = _fused(nets)
    n = int(ts.n_occupied)
    assert n == int(js.n_occupied) > 100 and int(ts.overflow) == int(js.overflow) == 0
    cells = ts.slot_cell[:n].numpy()
    jslots = np.asarray(JHM.slot_of(jcfg, js, jnp.asarray(cells)))
    assert (jslots >= 0).all()
    assert set(map(tuple, cells)) == set(map(tuple, np.asarray(js.slot_cell)[:n]))
    np.testing.assert_allclose(ts.obs_count[:n].numpy(), np.asarray(js.obs_count)[jslots],
                               rtol=1e-5)
    np.testing.assert_allclose(ts.latents[:n].numpy(), np.asarray(js.latents)[jslots],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.mesh_dirty[:n].numpy(),
                                  np.asarray(js.mesh_dirty)[jslots])


def test_fusion_matches_dense_map(nets):
    """One cloud fused into the port's dense map and its hash map: the same
    voxels, counts and latents cell by cell (shared fusion semantics)."""
    t_enc = nets[4]
    pts, nrm, valid = _surface(2)
    pts = pts + np.float32(1.0)                  # into the dense map's octant
    dcfg = M.MapConfig(bound_min=(0.0, 0.0, 0.0), n_xyz=(20, 20, 20), voxel_size=0.1,
                       capacity=4096, prune_min_vox_obs=4, ignore_count_th=2.0)
    args = (torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(valid))
    ds = M.integrate_keyframe(dcfg, t_enc, M.create_map_state(dcfg, "cpu"), *args)
    hcfg = HM.HashMapConfig(**FUSE)
    hs = HM.integrate_keyframe(hcfg, t_enc, HM.create_hash_map_state(hcfg, "cpu"), *args)
    occupied = torch.nonzero(ds.indexer >= 0)[:, 0]
    assert len(occupied) > 50 and int(ds.n_occupied) == int(hs.n_occupied)
    h_slots = HM.slot_of(hcfg, hs, M.unlinearize(dcfg, occupied))
    assert bool((h_slots >= 0).all())
    d_slots = ds.indexer[occupied].long()
    np.testing.assert_allclose(hs.obs_count[h_slots].numpy(), ds.obs_count[d_slots].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(hs.latents[h_slots].numpy(), ds.latents[d_slots].numpy(),
                               atol=1e-5)


def test_gather_query_and_save_load(nets, tmp_path):
    """The SDF term's map read against the jitted JAX gather on points near
    the fused surface and far from it (validity, latents, rel); the query is
    finite where valid; a snapshot written by either package loads in the
    other (and through ``core/map.load_map``) unchanged."""
    dec, _, spec, t_dec, _ = nets
    jcfg, js, tcfg, ts = _fused(nets)
    pts, _, _ = _surface(5, n=512, x0=0.2)
    pts = np.concatenate([pts + np.random.default_rng(6).normal(0, 0.03, pts.shape),
                          np.full((4, 3), 100.0)]).astype(np.float32)
    jg = jax.jit(JHM.gather_latent_rel, static_argnums=0)
    ref = jg(jcfg, js, jnp.asarray(pts), JM.latent_count_table(js))
    got = HM.gather_latent_rel(tcfg, ts, torch.from_numpy(pts), M.latent_count_table(ts))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[2][:512].float().mean() > 0.5 and not bool(got[2][512:].any())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    sdf, std, ok = HM.query_sdf(tcfg, t_dec, ts, torch.from_numpy(pts))
    assert torch.isfinite(sdf[ok]).all() and bool((std[ok] > 0).all())

    HM.save_map(str(tmp_path / "port.npz"), tcfg, ts)
    cfg2, js2 = JHM.load_map(str(tmp_path / "port.npz"))
    assert cfg2 == jcfg
    np.testing.assert_array_equal(np.asarray(js2.keys), ts.keys.numpy())
    np.testing.assert_array_equal(np.asarray(js2.latents), ts.latents.numpy())
    JHM.save_map(str(tmp_path / "jax.npz"), jcfg, js)
    cfg3, ts3 = M.load_map(str(tmp_path / "jax.npz"), device="cpu")
    assert cfg3 == tcfg
    for f in HM.HashMapState._fields:
        np.testing.assert_array_equal(getattr(ts3, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)


def test_mesh_prep_hash_matches_jax_and_a_dict_reference():
    """``_mesh_prep_hash`` over 8000 occupied cells (negatives included, some
    below the confidence threshold, 1500 dirty) against the JAX package's
    (cells and slots in the same order) and a dict reference over the
    6-dilated dirty set (the JAX package's ``_dilate6_cells``)."""
    rng = np.random.default_rng(5)
    cfg_kw = dict(voxel_size=0.1, latent_dim=4, capacity=1 << 14, table_size=1 << 16,
                  ignore_count_th=1.0)
    cells = np.unique(rng.integers(-40, 40, (16000, 3)).astype(np.int32), axis=0)[:8000]
    (jcfg, js, _), (tcfg, ts, _) = _insert_both(cfg_kw, cells)
    n = len(cells)
    obs = np.zeros(tcfg.capacity, np.float32)
    obs[:n] = rng.uniform(0.5, 50.0, n)
    dirty = np.zeros(tcfg.capacity, bool)
    dirty[rng.choice(n, 1500, replace=False)] = True
    ts = ts._replace(obs_count=torch.from_numpy(obs), mesh_dirty=torch.from_numpy(dirty))
    js = js._replace(obs_count=jnp.asarray(obs), mesh_dirty=jnp.asarray(dirty))
    from difusion_tpu.core.meshing import _mesh_prep_hash as jax_prep
    t_cells, t_slots = _mesh_prep_hash(tcfg, ts, False)
    j_cells, j_slots, count = jax_prep(jcfg, js, False)
    k = int(count)
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots)[:k])
    np.testing.assert_array_equal(t_cells.numpy(), np.asarray(j_cells)[:k])
    slot_of_cell = {tuple(c): s for s, c in enumerate(ts.slot_cell[:n].numpy())}
    want = {}
    for c in _dilate6_cells(ts.slot_cell.numpy()[dirty].astype(np.int64)):
        s = slot_of_cell.get(tuple(c))
        if s is not None and obs[s] > tcfg.ignore_count_th:
            want[tuple(c)] = s
    assert dict(zip(map(tuple, t_cells.numpy()), t_slots.tolist())) == want
    # no_cache: every observed cell above the threshold
    _, all_slots = _mesh_prep_hash(tcfg, ts, True)
    assert set(all_slots.tolist()) == set(np.nonzero(obs[:n] > 1.0)[0].tolist())
