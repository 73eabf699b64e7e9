"""The splice of an extract's marching-cubes chunks (``ops.marching_cubes``
``mc_splice`` and its plain version, the CPU's route) against the numpy
splice the JAX package runs on the host, kept here as the oracle: each
chunk's count read and download, the concatenation, the truncation at
``max_triangles``, the world transform, the block -> slot lookup and the
cache splice.  Equal means ``np.array_equal`` with the same dtype, shape
and contiguity."""
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import meshing
from difusion_tpu_torch.models.weights import load_prior
from difusion_tpu_torch.ops import marching_cubes as MC

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
ROW = MC.ROW


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the oracle: the host's numpy splice ----------------------------------------

def numpy_chunk(packed: np.ndarray, total: int):
    """One chunk's host unpack: its first min(count, budget) rows."""
    count = min(total, packed.shape[0])
    rows = packed[:count]
    return rows[:, :9].reshape(count, 3, 3), rows[:, 9:12], rows.view(np.int32)[:, 12], total


def numpy_splice(chunks, lin_local, slots, n_cells, origin, voxel_size, world_origin,
                 max_triangles):
    """(tris, stds, tri_slot, emitted) from the chunks' (packed, count)."""
    parts = [numpy_chunk(p, c) for p, c in chunks]
    emitted = sum(p[3] for p in parts)
    tris = np.concatenate([p[0] for p in parts])
    stds = np.concatenate([p[1] for p in parts])
    blocks = np.concatenate([p[2] for p in parts])
    if emitted > max_triangles or len(tris) > max_triangles:
        tris = tris[:max_triangles]
        stds = stds[:max_triangles]
        blocks = blocks[:max_triangles]
    tris = ((tris + origin[None, None, :].astype(np.float32)) * voxel_size
            + world_origin[None, None, :])
    lin_to_slot = np.full(n_cells, -1, np.int64)
    lin_to_slot[lin_local] = slots
    return tris, stds, lin_to_slot[blocks], emitted


def numpy_cache(cache, tris, stds, tri_slot, slots, capacity):
    """The cache splice: a re-meshed slot's old triangles replaced."""
    old_tris, old_std, old_slot = cache
    remeshed = np.zeros(capacity, bool)
    remeshed[slots] = True
    keep_mask = ~remeshed[old_slot] if len(old_slot) else np.zeros(0, bool)
    return (np.concatenate([old_tris[keep_mask], tris]),
            np.concatenate([old_std[keep_mask], stds]),
            np.concatenate([old_slot[keep_mask], tri_slot])), int(keep_mask.sum())


def assert_same(got, want):
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.flags.c_contiguous
        assert np.array_equal(g, w)


# -- the op on synthetic chunks ------------------------------------------------------

def _chunks(seed, counts, budget, n_xyz):
    """(K, budget, 13) buffers as marching cubes leaves them: each chunk's
    survivors (up to its budget) carry vertices in grid units around their
    block, stds and the block id of one of the chunk's own blocks; the rest
    zeros and block -1.  Returns the buffers, the counts, the blocks'
    linear cells (chunk by chunk) and their slots."""
    rng = np.random.default_rng(seed)
    n_cells = int(np.prod(n_xyz))
    K = len(counts)
    per_chunk = 16
    lin_local = rng.choice(n_cells, K * per_chunk, replace=False).astype(np.int32)
    slots = rng.choice(1 << 14, K * per_chunk, replace=False).astype(np.int64)
    packed = np.zeros((K, budget, ROW), np.float32)
    packed.view(np.int32)[:, :, 12] = -1
    for k, c in enumerate(counts):
        m = min(c, budget)
        blk = rng.choice(lin_local[k * per_chunk:(k + 1) * per_chunk], m)
        cell = np.stack([blk // (n_xyz[1] * n_xyz[2]), (blk // n_xyz[2]) % n_xyz[1],
                         blk % n_xyz[2]], 1).astype(np.float32)
        v = cell[:, None, :] + rng.uniform(0, 1, (m, 3, 3)).astype(np.float32)
        packed[k, :m, :9] = v.reshape(m, 9)
        packed[k, :m, 9:12] = rng.uniform(0.01, 0.2, (m, 3)).astype(np.float32)
        packed[k, :m].view(np.int32)[:, 12] = blk
    return packed, np.asarray(counts, np.int64), lin_local, slots


SPLICE_CASES = {
    # name: counts, budget, max_triangles, n_xyz, origin, world origin
    "chunks": ([300, 517, 12, 800], 1024, 1 << 16, (40, 40, 40), (0, 0, 0),
               (-2.0, -2.0, -0.5)),
    "chunk_over_budget": ([50, 2000, 70], 1024, 1024, (40, 40, 40), (0, 0, 0),
                          (-3.5, -0.5, -2.7)),
    "over_max_triangles": ([600, 600, 600], 1024, 1000, (40, 40, 40), (0, 0, 0),
                           (-2.0, -2.0, -0.5)),
    "hash_origin": ([257, 31, 900], 1024, 1 << 16, (48, 32, 64), (-7, 3, -12),
                    (0.0, 0.0, 0.0)),
    "empty_chunk": ([0, 123, 0, 45], 512, 1 << 16, (16, 16, 16), (2, -5, 9),
                    (0.0, 0.0, 0.0)),
    "all_empty": ([0, 0], 64, 1 << 16, (16, 16, 16), (0, 0, 0), (-2.0, -2.0, -0.5)),
}


@pytest.mark.parametrize("case", list(SPLICE_CASES))
def test_splice_plain_equals_numpy_splice(case):
    """The op's CPU route: the vertices, stds and slots of the numpy splice
    bit for bit (in chunk order, each chunk's kept rows, truncated at
    ``max_triangles``), and the survivors emitted."""
    counts, budget, max_triangles, n_xyz, origin, world_origin = SPLICE_CASES[case]
    packed, counts, lin_local, slots = _chunks(len(case), counts, budget, n_xyz)
    origin = np.asarray(origin, np.int64)
    world_origin = np.asarray(world_origin, np.float32)
    n_cells = int(np.prod(n_xyz))
    table = torch.full((n_cells,), -1, dtype=torch.int64)
    table[torch.from_numpy(lin_local).long()] = torch.from_numpy(slots)
    res = MC.mc_splice(torch.from_numpy(packed), torch.from_numpy(counts), table, origin, 0.1,
                       world_origin, max_triangles)
    tris, stds, tri_slot, emitted = MC.mc_triangles_np(res)
    want = numpy_splice([(packed[k], int(c)) for k, c in enumerate(counts)], lin_local, slots,
                        n_cells, origin, 0.1, world_origin, max_triangles)
    assert_same((tris, stds, tri_slot), want[:3])
    assert emitted == want[3] == int(counts.sum())
    assert res.totals.tolist() == [emitted, len(want[0])]
    assert len(tris) == min(max_triangles, int(np.minimum(counts, budget).sum()))
    if case == "all_empty":
        assert len(tris) == 0
    else:
        assert len(tris) > 0 and (tri_slot >= 0).all()


def test_splice_slot_outside_the_table_reads_minus_one():
    """A block id outside the table (never one marching cubes writes) gets
    slot -1, as the kernel gives it, instead of wrapping."""
    packed, counts, lin_local, slots = _chunks(5, [40], 64, (8, 8, 8))
    packed[0, :2].view(np.int32)[:, 12] = (-1, 512)
    table = torch.full((512,), -1, dtype=torch.int64)
    table[torch.from_numpy(lin_local).long()] = torch.from_numpy(slots)
    res = MC.mc_splice(torch.from_numpy(packed), torch.from_numpy(counts), table,
                       np.zeros(3, np.int64), 0.1, np.zeros(3, np.float32), 1 << 10)
    got = MC.mc_triangles_np(res)[2]
    assert got[:2].tolist() == [-1, -1] and (got[2:] >= 0).all()


# -- the extractor: its splice and cache against the numpy ones ---------------------

def _surface(seed, x0, n=8000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(x0 - 0.5, x0 + 0.5, n)
    y = rng.uniform(-0.5, 0.5, n)
    z = 2.0 + 0.1 * (np.sin(5 * x) + 0.7 * np.cos(4 * y))
    nrm = np.stack([0.5 * np.cos(5 * x), -0.28 * np.sin(4 * y), -np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (torch.from_numpy(np.stack([x, y, z], 1).astype(np.float32)),
            torch.from_numpy(nrm.astype(np.float32)), torch.ones(n, dtype=torch.bool))


CFG = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 12, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
HCFG = dict(voxel_size=0.1, latent_dim=29, capacity=1 << 12, table_size=1 << 14,
            prune_min_vox_obs=4, ignore_count_th=1.0, encoder_count_th=600.0)


@pytest.fixture(scope="module")
def fused():
    """Per backend: the config, a fused state and the state after a second,
    overlapping fusion (its dirty blocks re-mesh through the cache)."""
    dec, enc, _ = load_prior(HYPER, 300, device="cpu")
    out = {}
    for kind, mod, cfg in (("dense", M, M.MapConfig(**CFG)),
                           ("hash", HM, HM.HashMapConfig(**HCFG))):
        create = M.create_map_state if mod is M else HM.create_hash_map_state
        state = mod.integrate_keyframe(cfg, enc, create(cfg, "cpu"), *_surface(1, 0.1))
        second = mod.integrate_keyframe(
            cfg, enc, state._replace(mesh_dirty=torch.zeros_like(state.mesh_dirty)),
            *_surface(11, 0.45))
        out[kind] = cfg, state, second
    return out, dec


@pytest.mark.parametrize("max_triangles", [1 << 16, 300], ids=["room", "over_budget"])
@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_extract_splice_and_cache_equal_numpy(fused, kind, max_triangles, monkeypatch,
                                              caplog):
    """A no_cache extract in several marching-cubes chunks, then an
    incremental one whose cache keeps the triangles of the blocks it does
    not re-mesh: after each, ``triangles()``, ``_std`` and ``_slot`` equal
    the numpy splice and cache splice of the same chunk buffers; one host
    read an extract.  With 300 triangles a chunk's count exceeds its budget
    and the extract's total exceeds ``max_triangles``: the same truncation
    and the same warning."""
    states, dec = fused
    cfg, first, second = states[kind]
    cls = meshing.MeshExtractor if kind == "dense" else meshing.HashMeshExtractor
    ex = cls(cfg, dec, voxel_resolution=3, max_triangles=max_triangles,
             max_eval_points=64 * 6 ** 3)
    seen = {}
    mc, prep = meshing.marching_cubes_sparse, ex._mesh_prep

    def recording_mc(*args, **kw):
        res = mc(*args, **kw)
        seen["chunks"].append((args[2].numpy().copy(), res.packed.numpy().copy(),
                               int(res.count)))
        seen["grid"] = args[5]
        return res

    def recording_prep(state, no_cache):
        cells, slots = prep(state, no_cache)
        seen["slots"] = slots.numpy().copy()
        return cells, slots

    def recording_splice(packed, counts, table, origin, voxel_size, world_origin, max_tri):
        seen["origin"] = origin
        return MC.mc_splice(packed, counts, table, origin, voxel_size, world_origin, max_tri)
    monkeypatch.setattr(meshing, "marching_cubes_sparse", recording_mc)
    monkeypatch.setattr(meshing, "mc_splice", recording_splice)
    monkeypatch.setattr(ex, "_mesh_prep", recording_prep)
    for step, (state, no_cache) in enumerate(((first, True), (second, False))):
        seen["chunks"] = []
        cache = (ex._tris, ex._std, ex._slot) if not no_cache else (
            np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros(0, np.int64))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            ex.extract(state, max_std=0.15, no_cache=no_cache)
        lin_local = np.concatenate([c[0] for c in seen["chunks"]])
        tris, stds, tri_slot, emitted = numpy_splice(
            [(p, c) for _, p, c in seen["chunks"]], lin_local, seen["slots"],
            int(np.prod(seen["grid"])), seen["origin"], ex.voxel_size, ex.world_origin,
            max_triangles)
        want, kept = numpy_cache(cache, tris, stds, tri_slot, seen["slots"],
                                 cfg.capacity)
        assert_same((ex._tris, ex._std, ex._slot), want)
        assert ex.triangles()[0] is ex._tris and ex.triangles()[1] is ex._std
        assert len(ex._tris) > 100
        assert ex.last_stats["mc_chunks"] == len(seen["chunks"]) > 1
        assert ex.last_stats["host_reads"] == 1
        assert (kept > 0) == (step == 1)
        warned = [r for r in caplog.records if "triangle budget too small" in r.message]
        assert len(warned) == (emitted > max_triangles)
        if max_triangles == 300:
            assert emitted > max_triangles
            assert max(c for _, _, c in seen["chunks"]) > 300
            assert warned[0].getMessage() == (f"marching cubes: triangle budget too small "
                                              f"({emitted} > {max_triangles})")


def test_extract_without_a_kept_part_holds_the_downloaded_arrays(fused, monkeypatch):
    """With nothing kept the cache takes the downloaded arrays as they are:
    no second copy."""
    states, dec = fused
    cfg, first, _ = states["dense"]
    ex = meshing.MeshExtractor(cfg, dec, voxel_resolution=3)
    got = []
    unpack = meshing.mc_triangles_np

    def recording(res):
        out = unpack(res)
        got.append(out)
        return out
    monkeypatch.setattr(meshing, "mc_triangles_np", recording)
    ex.extract(first, max_std=0.15, no_cache=True)
    tris, stds, slots, _ = got[0]
    assert ex._tris is tris and ex._std is stds and ex._slot is slots
    assert len(got) == 1 and len(tris) > 100
