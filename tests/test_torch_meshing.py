"""Parity of the port's mesher (kernel 3's plain version, the dense
MeshExtractor with its cache splice, the HashMeshExtractor over a hash map,
map save/load, the exporters and the offline mesh tool) against the JAX
package on the CPU, with the in-repo prior.  Map state crosses between the
packages through the npz snapshot."""
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
import torch

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.core.meshing import HashMeshExtractor as JHashMeshExtractor
from difusion_tpu.core.meshing import MeshExtractor as JMeshExtractor
from difusion_tpu.models.decoder import DecoderSpec as JDecoderSpec
from difusion_tpu.models.decoder import decode as jax_decode
from difusion_tpu.models.decoder import fold_decoder_params, init_decoder_params
from difusion_tpu.models import encoder as JE
from difusion_tpu.ops import decoder_fused as jax_fused
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch import mesh_tool
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import meshing
from difusion_tpu_torch.core.meshing import HashMeshExtractor, MeshExtractor
from difusion_tpu_torch.models.decoder import Decoder, DecoderSpec
from difusion_tpu_torch.models.weights import from_jax_params, load_prior
from difusion_tpu_torch.ops import _build
from difusion_tpu_torch.ops import decoder_fused as fused

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CFG = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 12, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
MAX_STD = 0.15


@pytest.fixture(scope="module")
def prior():
    """The JAX package's folded prior and the port's decoder built from the
    same numpy trees, so both sides hold identical weights."""
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    t_dec, _ = from_jax_params(jax.tree.map(np.asarray, dec),
                               jax.tree.map(np.asarray, enc), DecoderSpec(*spec),
                               device="cpu")
    return dec, enc, spec, t_dec


def _surface(seed, x0, n=8000):
    """Points and normals on the corrugated surface over a 1 m patch."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(x0 - 0.5, x0 + 0.5, n)
    y = rng.uniform(-0.5, 0.5, n)
    z = 2.0 + 0.1 * (np.sin(5 * x) + 0.7 * np.cos(4 * y))
    nrm = np.stack([0.5 * np.cos(5 * x), -0.28 * np.sin(4 * y), -np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (jnp.asarray(np.stack([x, y, z], 1).astype(np.float32)),
            jnp.asarray(nrm.astype(np.float32)), jnp.ones(n, bool))


def _to_port(cfg, state, path):
    """JAX state -> npz (JAX save_map) -> the port's (cfg, state)."""
    JM.save_map(str(path), cfg, state)
    return M.load_map(path, device="cpu")


@pytest.fixture(scope="module", params=[3, 4], ids=lambda r: f"r{r}")
def meshes(request, prior, tmp_path_factory):
    """Both meshers on the same fused state, then again after a second,
    overlapping fusion (an incremental extract through the cache splice).
    Records (triangles, stds, transfer bytes, re-meshed blocks) per step."""
    dec, enc, spec, t_dec = prior
    r = request.param
    tmp = tmp_path_factory.mktemp(f"mesh_r{r}")
    jcfg = JM.MapConfig(**CFG)
    jm = JMeshExtractor(jcfg, dec, spec, voxel_resolution=r, max_triangles=1 << 16)
    tm = None
    steps = []
    js = JM.create_map_state(jcfg)
    for k, x0 in enumerate((0.0, 0.35)):
        js = JM.integrate_keyframe(jcfg, enc, js, *_surface(k, x0))
        tcfg, ts = _to_port(jcfg, js, tmp / f"map{k}.npz")
        if tm is None:
            tm = MeshExtractor(tcfg, t_dec, voxel_resolution=r, max_triangles=1 << 16)
        js = jm.extract(js, max_std=MAX_STD)
        ts = tm.extract(ts, max_std=MAX_STD)
        assert not bool(ts.mesh_dirty.any())
        steps.append(dict(jax=jm.triangles(), port=tm.triangles(),
                          jax_slot=jm._slot, port_slot=tm._slot,
                          jax_bytes=jm.last_transfer_bytes,
                          port_bytes=tm.last_transfer_bytes,
                          blocks=tm.last_stats["blocks"],
                          observed=int((ts.obs_count > CFG["ignore_count_th"]).sum())))
    return steps, jm, tm


@pytest.mark.parametrize("step", [0, 1], ids=["first", "incremental"])
def test_mesh_extract_matches_jax(meshes, step):
    """Triangle count exact; triangles and stds atol 1e-5 in the JAX
    package's own order (blocks by slot, the MC slab order, the cache
    splice), which is stricter than comparing them sorted: a lexsort of
    vertices that agree to ~1e-7 can break ties differently.  Host transfer
    accounting equal.  Step 1 re-meshes only the blocks the second fusion
    touched and keeps the rest from the cache."""
    steps, _, _ = meshes
    s = steps[step]
    (jt, jstd), (tt, tstd) = s["jax"], s["port"]
    assert len(tt) == len(jt) > 500
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    np.testing.assert_allclose(tstd, jstd, atol=1e-5)
    assert s["port_bytes"] == s["jax_bytes"]
    if step == 1:
        assert 0 < s["blocks"] < s["observed"]


def test_decode_fused_plain_matches_jax_kernel_and_decode(prior):
    """Kernel 3's plain version == the Pallas kernel in interpret mode and
    == models.decoder.decode at N = 777 (ragged against the tile), f32 atol
    2e-6; on CPU tensors the wrapper is the plain version and counts no
    launch."""
    dec, _, spec, t_dec = prior
    rng = np.random.default_rng(5)
    lat = rng.normal(0, 0.3, (777, 29)).astype(np.float32)
    rel = rng.uniform(-1.0, 0.75, (777, 3)).astype(np.float32)
    packed = fused.pack_fused_decoder(t_dec)
    got = fused.decode_fused_plain(packed, torch.from_numpy(lat), torch.from_numpy(rel))
    kern = jax_fused.decode_fused(dec, spec, jnp.asarray(lat), jnp.asarray(rel),
                                  tile=256, interpret=True)
    ref = jax_decode(dec, spec, jnp.asarray(lat), jnp.asarray(rel))
    for want in (kern, ref):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6, rtol=0)
    before = _build.launch_counts().get("decode_fused", 0)
    via = fused.decode_fused(packed, torch.from_numpy(lat), torch.from_numpy(rel))
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    assert _build.launch_counts().get("decode_fused", 0) == before


def test_save_map_round_trip_to_jax(prior, tmp_path):
    """A port snapshot loads in the JAX package (the optimizer's fields as
    zeros) and back in the port unchanged."""
    _, enc, _, _ = prior
    jcfg = JM.MapConfig(**CFG)
    js = JM.integrate_keyframe(jcfg, enc, JM.create_map_state(jcfg), *_surface(7, 0.0))
    tcfg, ts = _to_port(jcfg, js, tmp_path / "a.npz")
    M.save_map(tmp_path / "b.npz", tcfg, ts)
    jcfg2, js2 = JM.load_map(str(tmp_path / "b.npz"))
    assert jcfg2 == jcfg
    for f in JM.MapState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js2, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)
    tcfg2, ts2 = M.load_map(tmp_path / "b.npz", device="cpu")
    assert tcfg2 == tcfg
    for f in M.MapState._fields:
        assert torch.equal(getattr(ts2, f), getattr(ts, f)), f


def test_exporters_match_jax(meshes, tmp_path):
    """For the same triangles, write_ply's bytes (with the port's own jet
    table) and write_obj's text equal the JAX package's."""
    _, jm, tm = meshes
    out = MeshExtractor(tm.cfg, tm.decoder)
    out._tris, out._std = jm.triangles()
    for name, rng in (("a.ply", None), ("b.ply", (0.05, 0.1))):
        jm.write_ply(str(tmp_path / f"j{name}"), std_range=rng)
        out.write_ply(str(tmp_path / f"t{name}"), std_range=rng)
        assert (tmp_path / f"t{name}").read_bytes() == (tmp_path / f"j{name}").read_bytes()
    jm.write_obj(str(tmp_path / "j.obj"))
    out.write_obj(str(tmp_path / "t.obj"))
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()


def test_mesh_tool_matches_no_cache_extract(prior, tmp_path):
    """The offline tool on a port snapshot == a no_cache extract with the
    same prior, at r = 4 without std pruning."""
    _, enc, _, _ = prior
    jcfg = JM.MapConfig(**CFG)
    js = JM.integrate_keyframe(jcfg, enc, JM.create_map_state(jcfg), *_surface(3, 0.0))
    tcfg, ts = _to_port(jcfg, js, tmp_path / "map.npz")
    tool = mesh_tool.main([str(tmp_path / "map.npz"), str(tmp_path / "m.ply"),
                           "--hyper", str(HYPER), "--resolution", "4",
                           "--device", "cpu"])
    dec, _, _ = load_prior(HYPER, 300, device="cpu")
    ref = MeshExtractor(tcfg, dec, voxel_resolution=4, max_triangles=int(1e7))
    ref.extract(ts, no_cache=True)
    (a, sa), (b, sb) = tool.triangles(), ref.triangles()
    assert len(a) > 500
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)
    assert (tmp_path / "m.ply").stat().st_size > 1000


def test_chunked_extract_matches_unchunked(prior):
    """A max_eval_points budget that splits the lattice decode into several
    dispatches and marching cubes into several chunks reproduces the
    one-dispatch mesh: corner blending reads neighbours across chunk
    seams."""
    _, enc, _, t_dec = prior
    jcfg = JM.MapConfig(**CFG)
    js = JM.integrate_keyframe(jcfg, enc, JM.create_map_state(jcfg), *_surface(4, 0.0))
    tcfg = M.MapConfig(**CFG)
    ts = M.MapState(**{f: torch.from_numpy(np.array(getattr(js, f)))
                       for f in M.MapState._fields})
    one = MeshExtractor(tcfg, t_dec, voxel_resolution=3)
    one.extract(ts, max_std=MAX_STD)
    chunked = MeshExtractor(tcfg, t_dec, voxel_resolution=3,
                            max_eval_points=64 * 6 ** 3)
    chunked.extract(ts, max_std=MAX_STD)
    assert one.last_stats["decode_dispatches"] == 1
    assert chunked.last_stats["decode_dispatches"] == -(-chunked.last_stats["blocks"] // 64) > 1
    assert chunked.last_stats["mc_chunks"] > 1
    # chunks emit their triangles one after the other: compare them sorted
    a, b = (np.concatenate([t.reshape(len(t), 9), sd], axis=1)
            for t, sd in (one.triangles(), chunked.triangles()))
    assert len(b) == len(a) > 500
    np.testing.assert_allclose(b[np.lexsort(b.T)], a[np.lexsort(a.T)], atol=1e-6)



@pytest.fixture(scope="module")
def ragged_states(prior, tmp_path_factory):
    """Per backend, a fused state of 337 live blocks (odd, not a power of
    two) and the state after a second, overlapping fusion whose dirty
    blocks (365 dense, 371 hash: odd again) re-mesh through the cache."""
    _, enc, _, _ = prior
    tmp = tmp_path_factory.mktemp("ragged")
    out = {}
    for kind, mod, cfg_kw in (("dense", JM, CFG), ("hash", JHM, HCFG)):
        jcfg = (JM.MapConfig if mod is JM else JHM.HashMapConfig)(**cfg_kw)
        create = mod.create_map_state if mod is JM else mod.create_hash_map_state
        js = mod.integrate_keyframe(jcfg, enc, create(jcfg), *_surface(1, 0.1))
        states = []
        for k in range(2):
            mod.save_map(str(tmp / f"{kind}{k}.npz"), jcfg, js)
            states.append(M.load_map(tmp / f"{kind}{k}.npz", device="cpu"))
            js = mod.integrate_keyframe(
                jcfg, enc, js._replace(mesh_dirty=jnp.zeros_like(js.mesh_dirty)),
                *_surface(11, 0.45))
        out[kind] = states
    return out


@pytest.mark.parametrize("shard", [False, True], ids=["unsharded", "sharded"])
@pytest.mark.parametrize("fast", [False, True], ids=["plain", "fast"])
@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_ragged_extract_decodes_only_live_blocks(prior, ragged_states, kind, fast, shard,
                                                 monkeypatch):
    """n live blocks, not a power of two, under a max_eval_points of 64
    blocks a decode dispatch and 128 a marching-cubes chunk: the last
    dispatch and the last chunk hold only the blocks that are left, no
    padding block is decoded, and the mesh (first extract, then an
    incremental one through the cache splice) is the one-dispatch
    extract's.  Sharded over a device list naming the CPU twice, the full
    dispatches split in two and the odd last one decodes whole."""
    t_dec = prior[3]
    cls = MeshExtractor if kind == "dense" else HashMeshExtractor
    (tcfg, first), (_, second) = ragged_states[kind]
    monkeypatch.setattr(meshing, "_shard_devices", lambda dev: [dev] * 2)
    one = cls(tcfg, t_dec, voxel_resolution=3, fast=fast, shard=shard)
    ragged = cls(tcfg, t_dec, voxel_resolution=3, fast=fast, shard=shard,
                 max_eval_points=64 * 6 ** 3)
    for state, want_n in ((first, 337), (second, 365 if kind == "dense" else 371)):
        one.extract(state, max_std=MAX_STD)
        ragged.extract(state, max_std=MAX_STD)
        st = ragged.last_stats
        assert st["blocks"] == one.last_stats["blocks"] == want_n
        assert st["decoded_blocks"] == st["blocks"] == one.last_stats["decoded_blocks"]
        assert st["bucket"] == 512 and st["sites_per_dispatch"] == 64 * 6 ** 3
        assert st["decode_dispatches"] == -(-want_n // 64)
        assert st["mc_chunks"] == -(-want_n // 128)
        assert one.last_stats["decode_dispatches"] == one.last_stats["mc_chunks"] == 1
        evals = 3 ** 3 + ragged.refine_k if fast else 6 ** 3
        assert st["decoder_evals"] == want_n * evals
        assert st["decode_devices"] == (2 if shard else 1)
        assert one.last_stats["decode_devices"] == 1
        # a chunk emits its blocks' triangles slab by slab, so the soups differ
        # in order; a block's own triangles keep theirs (slab, then subcell):
        # compare them grouped by block, stably
        a, b = (np.concatenate([t.reshape(len(t), 9), sd], axis=1)[
                    np.argsort(m._slot, kind="stable")]
                for m, (t, sd) in ((one, one.triangles()), (ragged, ragged.triangles())))
        assert len(b) == len(a) > 500
        np.testing.assert_allclose(b, a, atol=1e-6)


@pytest.mark.parametrize("fast", [False, True], ids=["plain", "fast"])
def test_one_block_dispatch_hands_the_kernel_contiguous_inputs(prior, fast, monkeypatch):
    """A dispatch may hold one block (the last of n = 64 k + 1): its
    per-site latents reach kernel 3 contiguous, as the card's wrapper
    requires (one row expanded and reshaped is only a view with a zero
    stride), and its lattice is the first row of a two-block dispatch's."""
    t_dec = prior[3]
    packed = fused.pack_fused_decoder(t_dec)
    table = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.3, (8, 29)).astype(np.float32))
    slots = torch.tensor([5, 2])
    rows = []

    def checked(packed, lat, rel):
        assert lat.is_contiguous() and rel.is_contiguous()
        rows.append(lat.shape[0])
        return fused.decode_fused_plain(packed, lat, rel)
    monkeypatch.setattr(fused, "decode_fused", checked)
    if fast:
        refine_k = int(0.2 * 6 ** 3)
        one, two = (meshing._eval_and_negate_fast(t_dec, packed, table, slots[:m], 3,
                                                  refine_k) for m in (1, 2))
        assert rows == [3 ** 3, refine_k, 2 * 3 ** 3, 2 * refine_k]
    else:
        one, two = (meshing._eval_and_negate(t_dec, packed, table, slots[:m], 3)
                    for m in (1, 2))
        assert rows == [6 ** 3, 2 * 6 ** 3]
    for a, b in zip(one, two):
        assert a.shape == (1, 6, 6, 6)
        torch.testing.assert_close(a, b[:1], atol=1e-6, rtol=0)


def test_unsupported_decoder_meshes_through_decode(prior, tmp_path):
    """A decoder kernel 3 does not take (48-wide, re-injection at layer 2:
    neither the 128-wide kernels' decoder nor of the wide instances' family,
    whose widths are multiples of 64) decodes through Decoder.decode, as the
    JAX mesher's XLA route does, and meshes like it: count exact, triangles
    in order atol 1e-5.  Random weights and latents give many sign
    changes."""
    _, enc, _, _ = prior
    spec = JDecoderSpec(latent_size=29, dims=(48, 48, 48, 48), latent_in=(2,))
    dec = fold_decoder_params(init_decoder_params(spec, jax.random.key(0)))
    t_dec = Decoder(DecoderSpec(*spec), jax.tree.map(np.asarray, dec))
    assert not fused.supports_spec(t_dec.spec)
    jcfg = JM.MapConfig(**CFG)
    js = JM.integrate_keyframe(jcfg, enc, JM.create_map_state(jcfg), *_surface(5, 0.0))
    js = js._replace(latents=jnp.asarray(np.random.default_rng(6).normal(
        0, 0.8, js.latents.shape).astype(np.float32)))
    tcfg, ts = _to_port(jcfg, js, tmp_path / "map.npz")
    jm = JMeshExtractor(jcfg, dec, spec, voxel_resolution=2, max_triangles=1 << 16)
    tm = MeshExtractor(tcfg, t_dec, voxel_resolution=2, max_triangles=1 << 16)
    assert tm.packed is None
    jm.extract(js, max_std=100.0)
    tm.extract(ts, max_std=100.0)
    (jt, jsd), (tt, tsd) = jm.triangles(), tm.triangles()
    assert len(tt) == len(jt) > 500
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    np.testing.assert_allclose(tsd, jsd, atol=1e-5)


HCFG = dict(voxel_size=0.1, latent_dim=29, capacity=1 << 12, table_size=1 << 14,
            prune_min_vox_obs=4, ignore_count_th=1.0, encoder_count_th=600.0)


@pytest.fixture(scope="module")
def hash_meshes(prior, tmp_path_factory):
    """Both hash meshers (r = 3) on the same fused hash state, then again
    after a second, overlapping fusion (incremental, through the cache)."""
    dec, enc, spec, t_dec = prior
    tmp = tmp_path_factory.mktemp("hash_mesh")
    jcfg = JHM.HashMapConfig(**HCFG)
    jm = JHashMeshExtractor(jcfg, dec, spec, voxel_resolution=3, max_triangles=1 << 16)
    tm = HashMeshExtractor(HM.HashMapConfig(**HCFG), t_dec, voxel_resolution=3,
                           max_triangles=1 << 16)
    js, steps = JHM.create_hash_map_state(jcfg), []
    for k, x0 in enumerate((0.0, 0.35)):
        js = JHM.integrate_keyframe(jcfg, enc, js, *_surface(k, x0))
        JHM.save_map(str(tmp / f"map{k}.npz"), jcfg, js)
        _, ts = M.load_map(tmp / f"map{k}.npz", device="cpu")
        js = jm.extract(js, max_std=MAX_STD)
        ts = tm.extract(ts, max_std=MAX_STD)
        assert not bool(ts.mesh_dirty.any())
        steps.append(dict(jax=jm.triangles(), port=tm.triangles(),
                          jax_slot=jm._slot, port_slot=tm._slot,
                          jax_bytes=jm.last_transfer_bytes,
                          port_bytes=tm.last_transfer_bytes))
    return steps, tmp


@pytest.mark.parametrize("step", [0, 1], ids=["first", "incremental"])
def test_hash_mesh_extract_matches_jax(hash_meshes, step):
    """HashMeshExtractor against the JAX package's on a fused hash state:
    triangle count exact, triangles and stds atol 1e-5 in the JAX package's
    order (the sub-grid, its origin and the cache splice are the same), the
    same transfer bytes (the 12-byte origin among them); the mesh lies on
    the surface (z = 2 + 0.1 (sin 5x + 0.7 cos 4y), within a voxel)."""
    s = hash_meshes[0][step]
    (jt, jsd), (tt, tsd) = s["jax"], s["port"]
    assert len(tt) == len(jt) > 500
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    np.testing.assert_allclose(tsd, jsd, atol=1e-5)
    assert s["port_bytes"] == s["jax_bytes"]
    v = tt.reshape(-1, 3).astype(np.float64)
    z = 2.0 + 0.1 * (np.sin(5 * v[:, 0]) + 0.7 * np.cos(4 * v[:, 1]))
    assert np.percentile(np.abs(v[:, 2] - z), 95) < 0.05


@pytest.mark.parametrize("step", [0, 1], ids=["first", "incremental"])
@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_cache_arrays_match_jax(meshes, hash_meshes, kind, step):
    """The cache's three arrays after each extract (the first, then one
    that keeps the blocks it does not re-mesh): the JAX package's dtypes,
    shapes and contiguity, and its per-triangle slots exactly."""
    s = (meshes[0] if kind == "dense" else hash_meshes[0])[step]
    got = (*s["port"], s["port_slot"])
    want = (*s["jax"], s["jax_slot"])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.flags.c_contiguous and w.flags.c_contiguous
    assert np.array_equal(s["port_slot"], s["jax_slot"]) and len(s["port_slot"]) > 500


@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_no_cache_extract_matches_jax(prior, kind, tmp_path):
    """A full (no_cache) extract in several marching-cubes chunks, the
    offline export's route, on a map that already holds a cache: the JAX
    package's triangles and stds (atol 1e-5, in its order), its slots
    exactly, the same dtypes, shapes and contiguity, and the same transfer
    bytes."""
    dec, enc, spec, t_dec = prior
    jmod, cfg_kw = (JM, CFG) if kind == "dense" else (JHM, HCFG)
    jcfg = (JM.MapConfig if kind == "dense" else JHM.HashMapConfig)(**cfg_kw)
    create = JM.create_map_state if kind == "dense" else JHM.create_hash_map_state
    js = jmod.integrate_keyframe(jcfg, enc, create(jcfg), *_surface(7, 0.2))
    jmod.save_map(str(tmp_path / "map.npz"), jcfg, js)
    tcfg, ts = M.load_map(tmp_path / "map.npz", device="cpu")
    jcls, tcls = ((JMeshExtractor, MeshExtractor) if kind == "dense"
                  else (JHashMeshExtractor, HashMeshExtractor))
    jm = jcls(jcfg, dec, spec, voxel_resolution=3, max_triangles=1 << 16,
              max_eval_points=64 * 6 ** 3)
    tm = tcls(tcfg, t_dec, voxel_resolution=3, max_triangles=1 << 16,
              max_eval_points=64 * 6 ** 3)
    for _ in range(2):                  # the second extract replaces the first's cache
        jm.extract(js, max_std=MAX_STD, no_cache=True)
        tm.extract(ts, max_std=MAX_STD, no_cache=True)
    assert tm.last_stats["mc_chunks"] > 1 and tm.last_stats["host_reads"] == 1
    got = (*tm.triangles(), tm._slot)
    want = (*jm.triangles(), jm._slot)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.flags.c_contiguous
    assert len(got[0]) > 500
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    assert np.array_equal(got[2], want[2])
    assert tm.last_transfer_bytes == jm.last_transfer_bytes


def test_mesh_tool_hash_fast_and_shard(prior, hash_meshes, tmp_path):
    """``mesh_tool`` meshes a hash snapshot (the JAX package's, through
    ``HashMeshExtractor``) as the JAX tool does; --fast meshes a hash
    snapshot coarse-to-fine (tests/test_torch_mesh_fast.py holds it against
    the JAX package); --shard meshes a dense snapshot as the JAX tool's
    sharded extract does (on the CPU one device: the unsharded extract)."""
    dec, enc, spec, _ = prior
    snap = hash_meshes[1] / "map1.npz"
    base = [str(tmp_path / "out.ply"), "--hyper", str(HYPER), "--device", "cpu"]
    tool = mesh_tool.main([str(snap), *base, "--resolution", "3", "--max-std", str(MAX_STD)])
    assert isinstance(tool, HashMeshExtractor)
    jcfg, js = JHM.load_map(str(snap))
    ref = JHashMeshExtractor(jcfg, dec, spec, voxel_resolution=3, max_triangles=int(1e7))
    ref.extract(js, max_std=MAX_STD, no_cache=True)
    assert len(tool.triangles()[0]) == len(ref.triangles()[0]) > 500
    np.testing.assert_allclose(tool.triangles()[0], ref.triangles()[0], atol=1e-5)
    assert (tmp_path / "out.ply").stat().st_size > 0
    jcfg = JM.MapConfig(**CFG)
    js = JM.integrate_keyframe(jcfg, enc, JM.create_map_state(jcfg), *_surface(6, 0.0))
    JM.save_map(str(tmp_path / "dense.npz"), jcfg, js)
    fast = mesh_tool.main([str(snap), *base, "--resolution", "3", "--max-std",
                           str(MAX_STD), "--fast", "--refine-fraction", "0.3"])
    assert fast.fast and fast.refine_k == int(0.3 * 6 ** 3)
    assert len(fast.triangles()[0]) > 500
    sharded = mesh_tool.main([str(tmp_path / "dense.npz"), *base, "--resolution", "3",
                              "--max-std", str(MAX_STD), "--shard"])
    assert isinstance(sharded, MeshExtractor) and sharded.shard
    assert sharded.last_stats["decode_devices"] == 1
    jref = JMeshExtractor(jcfg, dec, spec, voxel_resolution=3, max_triangles=int(1e7),
                          shard=True)
    assert jref._row_sharding is not None            # the JAX tool's 8-device mesh
    jref.extract(js, max_std=MAX_STD, no_cache=True)
    assert len(sharded.triangles()[0]) == len(jref.triangles()[0]) > 500
    for x, y in zip(sharded.triangles(), jref.triangles()):
        np.testing.assert_allclose(x, y, atol=1e-5)


# tests/test_meshing.py's sharded setup: a plane through a 20^3 map, latents
# drawn at random so that many blocks emit, r = 2, chunks of 256 blocks
TINY = JDecoderSpec(latent_size=8, dims=(16, 16, 16, 16))
PLANE_CFG = dict(bound_min=(-1.0, -1.0, -1.0), n_xyz=(20, 20, 20), voxel_size=0.1,
                 capacity=4096, prune_min_vox_obs=2, ignore_count_th=1.0,
                 encoder_count_th=600.0)
PLANE_HCFG = dict(voxel_size=0.1, capacity=4096, table_size=1 << 14, prune_min_vox_obs=2,
                  ignore_count_th=1.0, encoder_count_th=600.0)
SHARD_KW = dict(voxel_resolution=2, max_triangles=1 << 16, max_eval_points=1 << 14)


def _plane_state(mod, cfg, enc, latent_dim):
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.8, 0.8, size=(6000, 2))
    pts = np.stack([xy[:, 0], xy[:, 1], 0.05 + 0.05 * np.sin(3 * xy[:, 0])], 1)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (6000, 1))
    create = mod.create_map_state if mod is JM else mod.create_hash_map_state
    state = mod.integrate_keyframe(cfg, enc, create(cfg), jnp.asarray(pts.astype(np.float32)),
                                   jnp.asarray(nrm), jnp.ones(6000, bool))
    return state._replace(latents=jax.random.normal(jax.random.key(9),
                                                    state.latents.shape) * 0.8)


@pytest.fixture(scope="module")
def sharded_refs(prior, tmp_path_factory):
    """For each decoder (the prior, which kernel 3 takes; the JAX tests'
    tiny one, which goes through Decoder.decode) and each map (dense,
    hash): the JAX package's sharded extract on its 8 devices, the port's
    snapshot of the same state and its unsharded extract."""
    dec, enc, spec, t_dec = prior
    tmp = tmp_path_factory.mktemp("sharded")
    tiny = fold_decoder_params(init_decoder_params(TINY, jax.random.key(0)))
    tiny_enc = JE.fold_encoder_params(JE.init_encoder_params(JE.EncoderSpec(latent_size=8),
                                                             jax.random.key(1)))
    nets = {"prior": (dec, enc, spec, t_dec),
            "tiny": (tiny, tiny_enc, TINY,
                     Decoder(DecoderSpec(*TINY), jax.tree.map(np.asarray, tiny)))}
    out = {}
    for name, (jdec, jenc, jspec, tdec) in nets.items():
        for kind, mod, cfg_kw, jcls, tcls in (
                ("dense", JM, PLANE_CFG, JMeshExtractor, MeshExtractor),
                ("hash", JHM, PLANE_HCFG, JHashMeshExtractor, HashMeshExtractor)):
            cfg_cls = JM.MapConfig if mod is JM else JHM.HashMapConfig
            jcfg = cfg_cls(latent_dim=jspec.latent_size, **cfg_kw)
            js = _plane_state(mod, jcfg, jenc, jspec.latent_size)
            ref = jcls(jcfg, jdec, jspec, shard=True, **SHARD_KW)
            assert ref._row_sharding is not None
            ref.extract(js, max_std=100.0)
            path = tmp / f"{name}_{kind}.npz"
            mod.save_map(str(path), jcfg, js)
            tcfg, ts = M.load_map(path, device="cpu")
            single = tcls(tcfg, tdec, **SHARD_KW)
            single.extract(ts, max_std=100.0)
            out[name, kind] = (ref, path, tdec, tcls, single)
    return out


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("kind", ["dense", "hash"])
@pytest.mark.parametrize("net", ["prior", "tiny"])
def test_sharded_extract_matches_jax_and_unsharded(sharded_refs, net, kind, n_dev,
                                                   monkeypatch):
    """shard=True over a device list naming the CPU 4 or 8 times (the
    module's device list patched) splits
    each decode chunk into as many slices (kernel 3's plain version for the
    prior, Decoder.decode for the tiny decoder) and meshes as the JAX
    package's sharded extract on 8 devices (tests/test_meshing.py's setup;
    count exact, triangles and stds atol 1e-6 in the JAX package's order),
    and exactly as the port's unsharded extract."""
    ref, path, tdec, tcls, single = sharded_refs[net, kind]
    tcfg, ts = M.load_map(path, device="cpu")
    monkeypatch.setattr(meshing, "_shard_devices", lambda dev: [dev] * n_dev)
    sharded = tcls(tcfg, tdec, shard=True, **SHARD_KW)
    sharded.extract(ts, max_std=100.0)
    assert sharded.last_stats["decode_devices"] == n_dev
    assert single.last_stats["decode_devices"] == 1
    assert len(sharded.triangles()[0]) == len(ref.triangles()[0]) > 100
    for x, y in zip(sharded.triangles(), ref.triangles()):
        np.testing.assert_allclose(x, y, atol=1e-6)
    for x, y in zip(sharded.triangles(), single.triangles()):
        assert torch.equal(torch.from_numpy(x), torch.from_numpy(y))
