"""The port's latent optimizer pieces against the JAX package on the CPU,
with the in-repo prior: ``ops/segment.padded_unique_inverse`` and
``segment_sum`` / ``segment_mean``,
``build_optimize_samples`` (dense and hash), ``optimize_latents`` (Adam as
optax computes it), ``merge_optimize_result``, and the save/load round trip
of the optimizer's state fields.  Map state and samples cross from the JAX
package as numpy arrays; the samples' noise is the JAX key's own draw,
passed to the port."""
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
import torch

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.ops import segment as JS
from difusion_tpu.ops.segment import padded_unique_inverse as jax_unique
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.models.decoder import DecoderSpec
from difusion_tpu_torch.models.weights import from_jax_params
from difusion_tpu_torch.ops import segment as TS
from difusion_tpu_torch.ops.segment import padded_unique_inverse

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
# encoder_count_th low, so one fusion converges voxels for the optimizer
CFG = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 12, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=20.0)
HASH = dict(voxel_size=0.1, latent_dim=29, capacity=1 << 12, table_size=1 << 14,
            prune_min_vox_obs=4, ignore_count_th=1.0, encoder_count_th=20.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several workers at once: two threads each keep
    them from crowding the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    t_dec, _ = from_jax_params(jax.tree.map(np.asarray, dec),
                               jax.tree.map(np.asarray, enc), DecoderSpec(*spec),
                               device="cpu")
    return dec, enc, spec, t_dec


def _surface(seed, n=4096):
    """Points on the corrugated surface over a 1 m patch, with normals and
    ~5% invalid rows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, n)
    y = rng.uniform(-0.5, 0.5, n)
    z = 2.0 + 0.1 * (np.sin(5 * x) + 0.7 * np.cos(4 * y))
    nrm = np.stack([0.5 * np.cos(5 * x), -0.28 * np.sin(4 * y), -np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (np.stack([x, y, z], 1).astype(np.float32), nrm.astype(np.float32),
            rng.uniform(size=n) > 0.05)


def _port_state(cls, js):
    return cls(**{f: torch.from_numpy(np.array(getattr(js, f))) for f in cls._fields})


@pytest.fixture(scope="module")
def fused(nets):
    """Per map kind: (JAX module, JAX cfg, JAX state, port module, port cfg,
    port state) after one JAX fusion, the surface and the noise key."""
    _, enc, _, _ = nets
    pts, nrm, valid = _surface(0)
    out = {}
    for kind, jmod, tmod, kw in (("dense", JM, M, CFG), ("hash", JHM, HM, HASH)):
        if kind == "dense":
            jcfg, tcfg = JM.MapConfig(**kw), M.MapConfig(**kw)
            js0, cls = JM.create_map_state(jcfg), M.MapState
        else:
            jcfg, tcfg = JHM.HashMapConfig(**kw), HM.HashMapConfig(**kw)
            js0, cls = JHM.create_hash_map_state(jcfg), HM.HashMapState
        js = jmod.integrate_keyframe(jcfg, enc, js0, jnp.asarray(pts), jnp.asarray(nrm),
                                     jnp.asarray(valid))
        out[kind] = (jmod, jcfg, js, tmod, tcfg, _port_state(cls, js))
    return out, (pts, nrm, valid), jax.random.key(3)


@pytest.mark.parametrize("case", ["ties_and_invalid", "all_valid", "all_invalid",
                                  "one_value"])
def test_padded_unique_inverse_matches_jax(case):
    """Segment ids and the distinct count exactly equal, with repeated ids,
    invalid ids (one trailing segment, not counted) and the extremes."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 40, 500).astype(np.int32)
    valid = {"ties_and_invalid": rng.random(500) > 0.3, "all_valid": np.ones(500, bool),
             "all_invalid": np.zeros(500, bool), "one_value": np.ones(500, bool)}[case]
    if case == "one_value":
        ids[:] = 7
    ref = jax_unique(jnp.asarray(ids), jnp.asarray(valid))
    got = padded_unique_inverse(torch.from_numpy(ids), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.inverse.numpy(), np.asarray(ref.inverse))
    assert int(got.count) == int(ref.count)
    plain = padded_unique_inverse(torch.from_numpy(ids))
    assert int(plain.count) == len(np.unique(ids))


@pytest.mark.parametrize("width", [0, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_sum_and_mean_match_jax(width, weighted):
    """``segment_sum`` and ``segment_mean`` on (N,) and (N, L) values, with
    and without weights, ids out of range dropped: 1e-5 (f32 sums in
    another order)."""
    rng = np.random.default_rng(6)
    shape = (400,) if width == 0 else (400, width)
    values = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(-3, 33, 400).astype(np.int32)
    w = rng.random(400).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    ref = JS.segment_sum(jnp.asarray(values), jnp.asarray(ids), 30, jw)
    got = TS.segment_sum(torch.from_numpy(values), torch.from_numpy(ids), 30, tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for g, r in zip(TS.segment_mean(torch.from_numpy(values), torch.from_numpy(ids), 30, tw),
                    JS.segment_mean(jnp.asarray(values), jnp.asarray(ids), 30, jw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_build_optimize_samples_matches_jax(fused, kind):
    """Slot ids and mask exactly equal; rel and gt within 1e-6 (the JAX
    package computes ``0.05 * normal`` inside jit, where XLA may fold the
    constant into the draw's last product: 1 ulp)."""
    maps, (pts, nrm, valid), key = fused
    jmod, jcfg, js, tmod, tcfg, ts = maps[kind]
    ref = jmod.build_optimize_samples(jcfg, js, jnp.asarray(pts), jnp.asarray(nrm),
                                      jnp.asarray(valid), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (pts.shape[0], 8))))
    got = tmod.build_optimize_samples(tcfg, ts, torch.from_numpy(pts), torch.from_numpy(nrm),
                                      torch.from_numpy(valid), noise)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[0].dtype == torch.int32 and int(got[3].sum()) > 1000
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind,max_slots,reg", [("dense", 2048, 0.0), ("dense", 100, 0.0),
                                                ("dense", 2048, 0.1), ("hash", 2048, 0.0)])
def test_optimize_latents_matches_jax(nets, fused, kind, max_slots, reg):
    """Five Adam iterations on the same state and samples: ``optimized``,
    ``mesh_dirty`` and ``opt_overflow`` exactly equal (also when the
    working table truncates, ``max_slots`` 100, and across a second call
    that accumulates); latents of untouched slots bit-equal; of the touched
    entries 99% within 1e-5 and none off by more than 2e-3.  Not tighter:
    Adam's first step is ``lr * g / |g|``, so an entry whose summed gradient
    is near 0 moves by about +-lr whatever its size, and a gradient summed
    in another order can take the other sign there."""
    dec, _, spec, t_dec = nets
    maps, (pts, nrm, valid), key = fused
    jmod, jcfg, js, tmod, tcfg, ts = maps[kind]
    samples = jmod.build_optimize_samples(jcfg, js, jnp.asarray(pts), jnp.asarray(nrm),
                                          jnp.asarray(valid), key)
    t_samples = [torch.from_numpy(np.array(x)) for x in samples]
    jkw = dict(n_iters=5, code_reg_lambda=reg)
    if kind == "dense":
        jkw["max_slots"] = max_slots
    ref = jmod.optimize_latents(jcfg, dec, spec, js, *samples, **jkw)
    got = tmod.optimize_latents(tcfg, t_dec, ts, *t_samples, n_iters=5,
                                code_reg_lambda=reg, max_slots=max_slots)
    for f in ("optimized", "mesh_dirty", "opt_overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    n_unique = len(np.unique(np.asarray(samples[0])[np.asarray(samples[3])]))
    assert int(got.optimized.sum()) == min(n_unique, max_slots) > 50
    assert int(got.opt_overflow) == max(n_unique - max_slots, 0)
    touched = np.asarray(ref.optimized)
    a, b = got.latents.numpy(), np.asarray(ref.latents)
    np.testing.assert_array_equal(a[~touched], b[~touched])
    err = np.abs(a[touched] - b[touched])
    assert (err <= 1e-5).mean() >= 0.99 and err.max() < 2e-3, (err.max(), (err > 1e-5).mean())
    assert np.abs(a[touched] - np.asarray(js.latents)[touched]).mean() > 1e-3   # it moved
    if max_slots < n_unique:
        again = tmod.optimize_latents(tcfg, t_dec, got, *t_samples, n_iters=2,
                                      max_slots=max_slots)
        assert int(again.opt_overflow) == 2 * (n_unique - max_slots)


def test_optimize_latents_decreases_nll(nets, fused):
    """Ten iterations lower the samples' NLL (the JAX package's slow-marked
    check, here at CPU-test size)."""
    _, _, _, t_dec = nets
    maps, (pts, nrm, valid), _ = fused
    _, _, _, tmod, tcfg, ts = maps["dense"]
    gen = torch.Generator().manual_seed(0)
    slot_ids, rel, gt, mask = tmod.build_optimize_samples(
        tcfg, ts, torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(valid),
        torch.randn(pts.shape[0], 8, generator=gen))

    def nll(latents):
        sdf, std = t_dec.decode(latents[torch.clamp(slot_ids, max=tcfg.capacity - 1).long()],
                                rel)
        ll = 0.5 * ((gt.clamp(-0.2, 0.2) - sdf.clamp(-0.2, 0.2)) / std) ** 2 + torch.log(std)
        return float((ll * mask).sum() / mask.sum())
    after = tmod.optimize_latents(tcfg, t_dec, ts, slot_ids, rel, gt, mask, n_iters=10)
    assert nll(after.latents) < nll(ts.latents)
    assert int(after.opt_overflow) == 0 and bool(after.optimized.any())


@pytest.mark.parametrize("case", ["delta_deintegration", "no_fusion_since"])
def test_merge_optimize_result_matches_jax(case):
    """tests/test_map.py's two merge cases through both packages: the
    delta de-integration formula (the port to 1e-6 of the JAX package, both
    to 1e-3 of the formula in f64, as that test allows for cancellation)
    and, with nothing fused since the snapshot, plain replacement."""
    cfg = M.MapConfig(**CFG)
    rng = np.random.default_rng(0 if case == "delta_deintegration" else 1)
    shape = (cfg.capacity, cfg.latent_dim)
    cur = rng.normal(size=shape).astype(np.float32)
    new = rng.normal(size=shape).astype(np.float32)
    n_cur = rng.uniform(1, 100, cfg.capacity).astype(np.float32)
    if case == "delta_deintegration":
        old = rng.normal(size=shape).astype(np.float32)
        n_old = rng.uniform(1, 100, cfg.capacity).astype(np.float32)
        touched = rng.random(cfg.capacity) < 0.3
    else:
        old, n_old, touched = cur, n_cur, np.ones(cfg.capacity, bool)
    n_cur[:5] = 0.0                             # unobserved slots never merge
    js = JM.create_map_state(JM.MapConfig(**CFG))._replace(
        latents=jnp.asarray(cur), obs_count=jnp.asarray(n_cur))
    ref = JM.merge_optimize_result(js, jnp.asarray(old), jnp.asarray(new),
                                   jnp.asarray(n_old), jnp.asarray(touched))
    ts = M.create_map_state(cfg, "cpu")._replace(latents=torch.from_numpy(cur),
                                                 obs_count=torch.from_numpy(n_cur))
    got = M.merge_optimize_result(ts, torch.from_numpy(old), torch.from_numpy(new),
                                  torch.from_numpy(n_old), torch.from_numpy(touched))
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(ref.latents), rtol=1e-6,
                               atol=1e-6)
    for f in ("optimized", "mesh_dirty"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    apply = touched & (n_cur > 0)
    expect = np.where(apply[:, None], (cur * n_cur[:, None] + (new - old) * n_old[:, None])
                      / np.maximum(n_cur, 1e-12)[:, None], cur)
    np.testing.assert_allclose(got.latents.numpy(), expect, rtol=1e-3, atol=1e-3)
    assert not got.optimized[:5].any()
    if case == "no_fusion_since":
        np.testing.assert_allclose(got.latents.numpy()[5:], new[5:], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "hash"])
def test_optimizer_fields_round_trip_both_ways(nets, fused, tmp_path, kind):
    """A state with optimized voxels and a nonzero ``opt_overflow`` saved by
    either package loads in the other with every field equal; a file
    without the two fields loads them as zeros."""
    dec, _, spec, _ = nets
    maps, (pts, nrm, valid), key = fused
    jmod, jcfg, js, tmod, tcfg, _ = maps[kind]
    samples = jmod.build_optimize_samples(jcfg, js, jnp.asarray(pts), jnp.asarray(nrm),
                                          jnp.asarray(valid), key)
    js = jmod.optimize_latents(jcfg, dec, spec, js, *samples, n_iters=1)
    js = js._replace(opt_overflow=jnp.asarray(3, jnp.int32))
    assert int(js.optimized.sum()) > 0
    jmod.save_map(str(tmp_path / "j.npz"), jcfg, js)
    tcfg2, ts = M.load_map(tmp_path / "j.npz", device="cpu")
    assert tcfg2 == tcfg
    for f in ts._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    tmod.save_map(tmp_path / "t.npz", tcfg, ts)
    jcfg2, js2 = jmod.load_map(str(tmp_path / "t.npz"))
    assert jcfg2 == jcfg
    for f in js2._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js2, f)), np.asarray(getattr(js, f)),
                                      err_msg=f)
    with np.load(tmp_path / "t.npz") as data:
        old = {k: data[k] for k in data.files
               if k not in ("state.optimized", "state.opt_overflow")}
    np.savez(tmp_path / "old.npz", **old)
    _, ts3 = M.load_map(tmp_path / "old.npz", device="cpu")
    assert ts3.optimized.shape == (tcfg.capacity,) and not bool(ts3.optimized.any())
    assert ts3.optimized.dtype == torch.bool and int(ts3.opt_overflow) == 0
    assert torch.equal(ts3.latents, ts.latents)


@pytest.mark.parametrize("width", [29, 1, 0])
def test_sorted_segment_sum_matches_index_add(width):
    """The card's segment sum (a stable sort of the ids, then a segmented
    reduction over each (segment, column); run here on the CPU) against
    ``index_add_``: equal to 1e-5, with a segment of thousands of rows, empty
    segments and 1-D values (``width`` 0)."""
    gen = torch.Generator().manual_seed(width)
    seg = torch.randint(0, 300, (6000,), generator=gen)
    seg[:3000] = 300
    values = torch.randn(6000, *((width,) if width else ()), generator=gen)
    ref = torch.zeros(302, *values.shape[1:]).index_add_(0, seg, values)
    got = M._sorted_segment_sum(302, values, M._segment_plan(seg, 302))
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert not bool(got[301].any())


def test_query_sdf_matches_jax(nets, fused):
    """The dense map's SDF query against the JAX package's on points near the
    fused surface and outside the grid: validity equal, sdf and std to
    1e-5 where valid."""
    dec, _, spec, t_dec = nets
    maps, (pts, _, _), _ = fused
    _, jcfg, js, _, tcfg, ts = maps["dense"]
    xyz = np.concatenate([pts[:512] + np.random.default_rng(9).normal(0, 0.03, (512, 3)),
                          np.full((4, 3), 50.0)]).astype(np.float32)
    sdf_j, std_j, ok_j = JM.query_sdf(jcfg, dec, spec, js, jnp.asarray(xyz))
    sdf_t, std_t, ok_t = M.query_sdf(tcfg, t_dec, ts, torch.from_numpy(xyz))
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    assert ok[:512].mean() > 0.5 and not ok[512:].any()
    np.testing.assert_allclose(sdf_t.numpy()[ok], np.asarray(sdf_j)[ok], atol=1e-5)
    np.testing.assert_allclose(std_t.numpy()[ok], np.asarray(std_j)[ok], atol=1e-5)
