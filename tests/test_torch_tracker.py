"""Parity of the port's tracker pieces against the JAX package on the CPU:
frame unpack + preprocessing (and where its normals differ), the SDF term on
the fused route (kernel 1's plain version) over the dense and the hash map,
the per-pixel photometric term, both under each ``solve_dtype``, the
preconditioned solve with and without refinement and the se(3)
exponential."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
import torch

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.core import tracker as JT
from difusion_tpu.data import SyntheticSequence as JSequence
from difusion_tpu.ops import imgproc as JIP
from difusion_tpu.ops.imgproc import Intrinsic as JIntrinsic
from difusion_tpu.ops.se3 import Pose as JPose
from difusion_tpu.ops.se3 import exp_twist as jax_exp_twist
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.models.decoder import DecoderSpec
from difusion_tpu_torch.models.weights import from_jax_params
from difusion_tpu_torch.ops.decoder_fused import pack_fused_decoder
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.ops.se3 import Pose, exp_twist

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CALIB = (300.0, 300.0, 39.5, 29.5, 5000.0)
H, W = 60, 80


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frames():
    seq = JSequence(n_frames=2, h=H, w=W, calib=JIntrinsic(*CALIB),
                    corrugation=0.1, motion_scale=0.6)
    return list(seq)


@pytest.fixture(scope="module")
def prior():
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    t_dec, _ = from_jax_params(jax.tree.map(np.asarray, dec),
                               jax.tree.map(np.asarray, enc), DecoderSpec(*spec),
                               device="cpu")
    return dec, spec, t_dec


def _preprocess_both(frame, lossless):
    jt = JT.TrackerConfig(point_budget=2048, warp_tiled=False,
                          lossless_packing=lossless)
    packed = JT.pack_frame(frame.rgb, frame.depth, CALIB[4], lossless=lossless)
    np.testing.assert_array_equal(
        T.pack_frame(frame.rgb, frame.depth, CALIB[4], lossless=lossless), packed)
    a = JT.preprocess_frame_packed(jt, JIntrinsic(*CALIB), jnp.asarray(packed), H, W)
    b = T.preprocess_packed(T.TrackerConfig(point_budget=2048),
                            Intrinsic(*CALIB), torch.from_numpy(packed), W)
    return a, b


@pytest.mark.parametrize("lossless", [False, True])
def test_preprocess_matches_jax(frames, lossless):
    """Byte-plane unpack + _preprocess_core vs JAX preprocess_frame_packed
    (jitted) at 60x80.  Intensity, depth and masks agree exactly; Sobel
    gradients to 1e-6 (XLA may contract the jitted stencil into FMAs);
    box-filtered points to 1e-5 m (f32 prefix sums in another order);
    normals to 2e-3: XLA on the CPU contracts the JAX stencil's
    second-moment sums into FMAs, and the covariance of a small window
    cancels the few-ulp difference into 1e-3-level normal differences
    (``test_normal_difference_is_xla_fma_contraction``)."""
    a, b = _preprocess_both(frames[1], lossless)
    for name in a.pyramid._fields:
        for lvl in range(3):
            got = getattr(b.pyramid, name)[lvl].numpy()
            ref = np.asarray(getattr(a.pyramid, name)[lvl])
            if name == "grad":
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(b.pc_mask.numpy(), np.asarray(a.pc_mask))
    assert b.pc_mask.sum() > 500
    np.testing.assert_allclose(b.pts_cam.numpy(), np.asarray(a.pts_cam), atol=1e-5)
    np.testing.assert_allclose(b.normals_cam.numpy(), np.asarray(a.normals_cam),
                               atol=2e-3)


def test_normal_difference_is_xla_fma_contraction(frames):
    """Where the 2e-3 between the packages' normals comes from, on frame 1's
    30x40 point map (the 60x80 frame subsampled by 2): (1) the eigen-solvers
    fed the same six moments agree to 2.4e-7 (about 2 ulp); (2) the port's
    plain stencil and the jitted JAX stencil the tracker runs (the scan
    route, not the Pallas kernel) give bit-equal count and first-moment
    planes, and second-moment planes a few ulp apart -- those equal, bit for
    bit, the port's own loop with each ``acc + (w n_i) n_j`` done as one
    fused multiply-add (emulated exactly in f64), which is how XLA on the
    CPU compiles it; (3) the port's finishing step fed the JAX sums gives
    the JAX normals to 1e-6.  Kernel 2 and its plain version round every
    product and sum alone (bit-equal to each other on the card), so the
    port keeps the two roundings the program text states."""
    from difusion_tpu_torch.ops import stencil as TS
    packed = JT.pack_frame(frames[1].rgb, frames[1].depth, CALIB[4])
    inten, depth = T.unpack_frame(torch.from_numpy(packed), Intrinsic(*CALIB), W)
    ok = (depth >= 0.5) & (depth <= 5.0)
    d_sub, ok_sub = T.imgproc.subsample2d(depth, 2), T.imgproc.subsample2d(ok, 2)
    pc = T.imgproc.unproject_depth(d_sub, ok_sub, *(c * 0.5 for c in CALIB[:4]))
    r2 = (0.05 ** 2, 0.1 ** 2)
    px, py, pz = (torch.where(ok_sub, pc[..., c], torch.zeros(())) for c in range(3))
    port = [t.numpy() for t in TS.window_stat_sums_plain(px, py, pz, ok_sub.float(), 6, *r2)]

    captured = {}

    def keep_sums(sums, *args):
        captured["sums"] = sums
        return sums

    orig = JT._finish_window_stats
    JT._finish_window_stats = keep_sums
    try:
        jsums = jax.jit(lambda p, v: JT._window_stats(p, v, 6, r2[0], 16, r2[1], 6.0))(
            jnp.asarray(pc.numpy()), jnp.asarray(ok_sub.numpy()))
    finally:
        JT._finish_window_stats = orig
    jsums = [np.asarray(t) for t in jsums]
    for k in range(5):
        np.testing.assert_array_equal(port[k], jsums[k], err_msg=f"plane {k}")
    ulps = [np.abs(port[k].view(np.int32).astype(np.int64)
                   - jsums[k].view(np.int32).astype(np.int64)).max() for k in range(5, 11)]
    assert 0 < max(ulps) <= 64, ulps

    # the port's loop with the second moments accumulated by an exact FMA
    h, w = px.shape
    P = [np.pad(a.numpy(), 6) for a in (px, py, pz, ok_sub.float())]
    X = [a.numpy() for a in (px, py, pz)]
    fma = [np.zeros((h, w), np.float32) for _ in range(6)]
    for dv in range(13):
        for du in range(13):
            n = [a[dv:dv + h, du:du + w] for a in P]
            d = [n[i] - X[i] for i in range(3)]
            d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            wgt = np.where(d2 <= np.float32(r2[1]), n[3], np.float32(0))
            for k, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
                fma[k] = (fma[k].astype(np.float64) + (wgt * n[i]).astype(np.float64)
                          * n[j].astype(np.float64)).astype(np.float32)
    for k in range(6):
        np.testing.assert_array_equal(fma[k], jsums[5 + k], err_msg=f"plane {5 + k}")

    # (1) the eigen-solvers on the same moments
    c = np.float32(1) / np.maximum(jsums[1], np.float32(1))
    s1 = jsums[2:5]
    mom = [jsums[5 + k] - s1[i] * s1[j] * c for k, (i, j) in
           enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))]
    jeig = jax.jit(JIP.sym3eig_smallest_components)(*map(jnp.asarray, mom))
    teig = T.imgproc.sym3eig_smallest_components(*map(torch.from_numpy, mom))
    sel = ok_sub.numpy() & (jsums[1] >= 6)
    for a, b in zip(teig, jeig):
        np.testing.assert_allclose(a.numpy()[sel], np.asarray(b)[sel], atol=2.4e-7, rtol=0)
    # (3) the port's finishing step on the JAX sums
    _, t_nrm, _ = T._finish_window_stats(tuple(torch.tensor(a) for a in jsums), ok_sub,
                                         px, py, pz, 16, 6.0)
    _, j_nrm, _ = JT._finish_window_stats(tuple(map(jnp.asarray, jsums)),
                                          jnp.asarray(ok_sub.numpy()), jnp.asarray(px.numpy()),
                                          jnp.asarray(py.numpy()), jnp.asarray(pz.numpy()), 16, 6.0)
    np.testing.assert_allclose(t_nrm.numpy()[sel], np.asarray(j_nrm)[sel], atol=1e-6)


def _random_map(seed=0):
    """A map whose allocated slots hold random latents with converged counts
    (valid wherever a query lands), as JAX and port states."""
    cfg = (dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
                latent_dim=29, capacity=1 << 12, prune_min_vox_obs=4,
                ignore_count_th=2.0, encoder_count_th=600.0))
    jcfg, tcfg = JM.MapConfig(**cfg), M.MapConfig(**cfg)
    rng = np.random.default_rng(seed)
    n_slots = 2048
    cells = rng.choice(jcfg.n_cells, size=n_slots, replace=False)
    indexer = np.full(jcfg.n_cells, -1, np.int32)
    indexer[cells] = np.arange(n_slots)
    positions = np.full(jcfg.capacity, -1, np.int32)
    positions[:n_slots] = cells
    latents = np.zeros((jcfg.capacity, 29), np.float32)
    latents[:n_slots] = rng.normal(size=(n_slots, 29)).astype(np.float32) * 0.1
    counts = np.zeros(jcfg.capacity, np.float32)
    counts[:n_slots] = 100.0
    jstate = JM.create_map_state(jcfg)._replace(
        indexer=jnp.asarray(indexer), positions=jnp.asarray(positions),
        latents=jnp.asarray(latents), obs_count=jnp.asarray(counts))
    tstate = M.create_map_state(tcfg, "cpu")._replace(
        indexer=_t(indexer), positions=_t(positions), latents=_t(latents),
        obs_count=_t(counts))
    return jcfg, jstate, tcfg, tstate, cells


@pytest.mark.parametrize("weights", ["random", "prior"])
def test_sdf_term_matches_jax(prior, weights):
    """H, g, E of the port's SDF term (fused route, plain kernel version)
    vs JAX's XLA forward+vjp route.  With a random decoder, atol 1e-5 as the
    JAX package's own fused-vs-vjp term test (tests/test_tracker.py).  With
    the in-repo prior, r = sdf/std and G = grad/(std * voxel) with std near
    0.05 amplify the decoder's 1e-6-level f32 differences ~200x and put H
    at ~1e3: 1e-4 relative to each output's largest entry."""
    dec, spec, t_dec = prior
    if weights == "random":
        from difusion_tpu.models.decoder import (fold_decoder_params,
                                                 init_decoder_params)
        from difusion_tpu.models.encoder import EncoderSpec, init_encoder_params
        dec = fold_decoder_params(init_decoder_params(spec, jax.random.key(0)))
        enc = init_encoder_params(EncoderSpec(), jax.random.key(1))
        t_dec, _ = from_jax_params(jax.tree.map(np.asarray, dec),
                                   jax.tree.map(np.asarray, enc),
                                   DecoderSpec(*spec), device="cpu")
    jcfg, jstate, tcfg, tstate, cells = _random_map()
    rng = np.random.default_rng(5)
    cell_xyz = np.stack(np.unravel_index(cells[:512], jcfg.n_xyz), axis=1)
    pts = ((cell_xyz + rng.uniform(0.1, 0.9, (512, 3))) * jcfg.voxel_size
           + np.asarray(jcfg.bound_min)).astype(np.float32)
    mask = rng.uniform(size=512) > 0.1
    R = np.asarray(jax_exp_twist(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)).R)
    t = rng.normal(0, 0.01, 3).astype(np.float32)
    pts_cam = ((pts - t) @ R).astype(np.float32)
    xi = rng.normal(0, 0.005, 6).astype(np.float32)
    jd = jax_exp_twist(jnp.asarray(xi))
    td = exp_twist(_t(xi))
    ref = JT._sdf_term(jcfg, dec, spec, jstate, JPose(jnp.asarray(R), jnp.asarray(t)),
                       jd, jnp.asarray(pts_cam), jnp.asarray(mask), "huber", 5.0,
                       aug_table=JM.latent_count_table(jstate), fused=False)
    got = T._sdf_term(tcfg, pack_fused_decoder(t_dec), tstate, Pose(_t(R), _t(t)),
                      td, _t(pts_cam), _t(mask), "huber", 5.0,
                      M.latent_count_table(tstate))
    assert float(got[2]) > 0
    for g, r in zip(got, ref):
        r = np.asarray(r)
        atol = 1e-5 if weights == "random" else 1e-4 * np.abs(r).max()
        np.testing.assert_allclose(g.numpy(), r, atol=atol, rtol=0)


def _random_decoder(spec):
    from difusion_tpu.models.decoder import fold_decoder_params, init_decoder_params
    from difusion_tpu.models.encoder import EncoderSpec, init_encoder_params
    dec = fold_decoder_params(init_decoder_params(spec, jax.random.key(0)))
    enc = init_encoder_params(EncoderSpec(), jax.random.key(1))
    t_dec, _ = from_jax_params(jax.tree.map(np.asarray, dec), jax.tree.map(np.asarray, enc),
                               DecoderSpec(*spec), device="cpu")
    return dec, t_dec


def _sdf_inputs(points_cells, voxel_size, bound_min, n=512, seed=5):
    """Camera-space points inside the given cells, a mask, the last pose
    and a small delta (numpy, then both packages' types)."""
    rng = np.random.default_rng(seed)
    pts = ((points_cells[:n] + rng.uniform(0.1, 0.9, (n, 3))) * voxel_size
           + np.asarray(bound_min)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    R = np.asarray(jax_exp_twist(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)).R)
    t = rng.normal(0, 0.01, 3).astype(np.float32)
    pts_cam = ((pts - t) @ R).astype(np.float32)
    xi = rng.normal(0, 0.005, 6).astype(np.float32)
    return pts_cam, mask, R, t, xi


@pytest.mark.parametrize("mode", ["compensated", "blocked"])
def test_sdf_term_gram_modes_match_jax(prior, mode):
    """H, g, E of the SDF term under ``solve_dtype`` ``compensated`` and
    ``blocked`` (one order-robust Gram of [J | r]) against the JAX package's
    with a random decoder: atol 1e-5, as the f32 route."""
    _, spec, _ = prior
    dec, t_dec = _random_decoder(spec)
    jcfg, jstate, tcfg, tstate, cells = _random_map()
    cell_xyz = np.stack(np.unravel_index(cells, jcfg.n_xyz), axis=1)
    pts_cam, mask, R, t, xi = _sdf_inputs(cell_xyz, jcfg.voxel_size, jcfg.bound_min, n=2000)
    ref = JT._sdf_term(jcfg, dec, spec, jstate, JPose(jnp.asarray(R), jnp.asarray(t)),
                       jax_exp_twist(jnp.asarray(xi)), jnp.asarray(pts_cam), jnp.asarray(mask),
                       "huber", 5.0, aug_table=JM.latent_count_table(jstate), fused=False,
                       gram_mode=mode)
    got = T._sdf_term(tcfg, pack_fused_decoder(t_dec), tstate, Pose(_t(R), _t(t)),
                      exp_twist(_t(xi)), _t(pts_cam), _t(mask), "huber", 5.0,
                      M.latent_count_table(tstate), mode)
    assert float(got[2]) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_sdf_term_on_hash_map_matches_jax(prior):
    """The SDF term over a hash map (probe + gather, then kernel 1's plain
    version) against the JAX package's fused-off route on the same hash
    state, with a random decoder: atol 1e-5."""
    _, spec, _ = prior
    dec, t_dec = _random_decoder(spec)
    rng = np.random.default_rng(4)
    cells = np.unique(rng.integers(-12, 12, (3000, 3)).astype(np.int32), axis=0)[:1500]
    kw = dict(voxel_size=0.1, latent_dim=29, capacity=4096, table_size=1 << 14,
              ignore_count_th=2.0)
    jcfg, tcfg = JHM.HashMapConfig(**kw), HM.HashMapConfig(**kw)
    jstate, _ = JHM.insert(jcfg, JHM.create_hash_map_state(jcfg), jnp.asarray(cells),
                           jnp.ones(len(cells), bool))
    lat = np.zeros((4096, 29), np.float32)
    lat[:len(cells)] = rng.normal(size=(len(cells), 29)) * 0.1
    cnt = np.zeros(4096, np.float32)
    cnt[:len(cells)] = 100.0
    jstate = jstate._replace(latents=jnp.asarray(lat), obs_count=jnp.asarray(cnt))
    tstate = HM.create_hash_map_state(tcfg, "cpu")._replace(
        **{f: torch.from_numpy(np.array(getattr(jstate, f)))
           for f in ("keys", "table_slot", "slot_cell", "n_occupied", "latents", "obs_count")})
    pts_cam, mask, R, t, xi = _sdf_inputs(cells.astype(np.float64), 0.1, (0.0, 0.0, 0.0))
    ref = JT._sdf_term(jcfg, dec, spec, jstate, JPose(jnp.asarray(R), jnp.asarray(t)),
                       jax_exp_twist(jnp.asarray(xi)), jnp.asarray(pts_cam), jnp.asarray(mask),
                       "huber", 5.0, aug_table=JM.latent_count_table(jstate), fused=False)
    got = T._sdf_term(tcfg, pack_fused_decoder(t_dec), tstate, Pose(_t(R), _t(t)),
                      exp_twist(_t(xi)), _t(pts_cam), _t(mask), "huber", 5.0,
                      M.latent_count_table(tstate))
    assert float(got[2]) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("level", [0, 1])
def test_rgb_term_matches_jax(frames, level):
    """H, g, E of the per-pixel photometric term vs JAX _rgb_term on the
    per-pixel route (warp_tiled=False), f32: H and g to rtol 1e-4 of their
    largest entry (sums over ~5k pixels in another order), E to rtol 1e-5."""
    a0, b0 = _preprocess_both(frames[0], False)
    a1, b1 = _preprocess_both(frames[1], False)
    jt = JT.TrackerConfig(point_budget=2048, warp_tiled=False)
    tt = T.TrackerConfig(point_budget=2048)
    xi = np.array([0.004, -0.003, 0.002, 0.003, -0.002, 0.001], np.float32)
    cur_level = JT._rgb_level_inputs(jt, a1.pyramid, level)
    tex = ("packed", JIP.warp_texture(a0.pyramid.intensity[level],
                                      a0.pyramid.depth[level]))
    ref = JT._rgb_term(level, jt, JIntrinsic(*CALIB), a0.pyramid, cur_level, tex,
                       jax_exp_twist(jnp.asarray(xi)), jnp.float32(500.0))
    p = b1.pyramid
    got = T._rgb_term(tt, T.level_camera(tt, Intrinsic(*CALIB), level, "cpu"), 1,
                      T.imgproc.warp_texture(b0.pyramid.intensity[level],
                                             b0.pyramid.depth[level]),
                      (p.intensity[level], p.depth[level], p.depth_ok[level],
                       p.grad[level], p.grad_ok[level]),
                      exp_twist(_t(xi)), 500.0)
    assert float(got[2]) > 0
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("mode,level", [("compensated", 0), ("compensated", 1),
                                        ("blocked", 0)])
def test_rgb_term_gram_modes_match_jax(frames, mode, level):
    """H, g, E of the per-pixel photometric term under ``compensated`` /
    ``blocked`` against the JAX package's flattened route: the tolerance of
    the f32 term (the residuals themselves differ at f32 rounding)."""
    a0, b0 = _preprocess_both(frames[0], False)
    a1, b1 = _preprocess_both(frames[1], False)
    jt = JT.TrackerConfig(point_budget=2048, warp_tiled=False, solve_dtype=mode)
    tt = T.TrackerConfig(point_budget=2048, solve_dtype=mode)
    xi = np.array([0.004, -0.003, 0.002, 0.003, -0.002, 0.001], np.float32)
    tex = ("packed", JIP.warp_texture(a0.pyramid.intensity[level], a0.pyramid.depth[level]))
    ref = JT._rgb_term(level, jt, JIntrinsic(*CALIB), a0.pyramid,
                       JT._rgb_level_inputs(jt, a1.pyramid, level), tex,
                       jax_exp_twist(jnp.asarray(xi)), jnp.float32(500.0), gram_mode=mode)
    p = b1.pyramid
    got = T._rgb_term(tt, T.level_camera(tt, Intrinsic(*CALIB), level, "cpu"), 1,
                      T.imgproc.warp_texture(b0.pyramid.intensity[level],
                                             b0.pyramid.depth[level]),
                      (p.intensity[level], p.depth[level], p.depth_ok[level],
                       p.grad[level], p.grad_ok[level]),
                      exp_twist(_t(xi)), 500.0, mode)
    assert float(got[2]) > 0
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-4 * np.abs(r).max())


def test_solve_precond_and_exp_twist_match_jax():
    """The preconditioned 6x6 solve with and without the refinement step
    of ``compensated`` (both LAPACK LU in f32, rtol 1e-5) and
    the se(3) exponential (atol 1e-6) agree with the JAX package."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(40, 6)).astype(np.float32)
    Hm = (A.T @ A * np.array([1, 10, 100, 1, 0.1, 5], np.float32)).astype(np.float32)
    Hm = (Hm + Hm.T) / 2
    g = rng.normal(size=6).astype(np.float32)
    for refine in (False, True):
        np.testing.assert_allclose(T._solve_precond(_t(Hm), _t(g), refine).numpy(),
                                   np.asarray(JT._solve_precond(jnp.asarray(Hm),
                                                                jnp.asarray(g), refine)),
                                   rtol=1e-5, atol=1e-7)
    for xi in (rng.normal(0, 0.2, 6), rng.normal(0, 1e-7, 6), np.zeros(6)):
        xi = xi.astype(np.float32)
        a, b = jax_exp_twist(jnp.asarray(xi)), exp_twist(_t(xi))
        np.testing.assert_allclose(b.R.numpy(), np.asarray(a.R), atol=1e-6)
        np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), atol=1e-6)


def test_config_fields_and_unsupported_values():
    """TrackerConfig keeps the JAX fields, defaults (except the two routes
    the port takes) and from_args; every value the JAX package documents
    for the tracker's modes is accepted, and values outside them raise."""
    j, t = JT.TrackerConfig(), T.TrackerConfig()
    assert j._fields == t._fields
    diff = {f for f in j._fields if getattr(j, f) != getattr(t, f)}
    assert diff == {"warp_tiled", "sdf_fused"}
    args = SimpleNamespace(
        iter_config=[{"n": 3, "type": [["rgb", 2]]},
                     {"n": 5, "type": [["sdf"], ["rgb", 0]]}],
        sdf={"robust_kernel": "huber", "robust_k": 5.0, "subsample": 0.5},
        rgb={"weight": 500.0, "robust_kernel": None, "min_grad_scale": 0.0,
             "max_depth_delta": 0.2}, xi_tol=0.0)
    jf, tf = JT.TrackerConfig.from_args(args, 4096), T.TrackerConfig.from_args(args, 4096)
    assert jf._replace(warp_tiled=False, sdf_fused="on") == tuple(tf)
    T.check_supported(tf)
    for field, value in (("warp_tiled", True), ("warp_texture_bf16", False),
                         ("sdf_compute_dtype", "bfloat16"), ("sdf_fused", "off"),
                         ("sdf_fused", "auto"), ("rgb_bilinear", False),
                         ("sdf_gather_cache", True), ("gn_unroll", 2)):
        T.check_supported(tf._replace(**{field: value}))
    for field, value in (("solve_dtype", "f64"), ("sdf_compute_dtype", "float16"),
                         ("sdf_fused", "maybe"), ("gn_unroll", 0)):
        with pytest.raises(NotImplementedError):
            T.check_supported(tf._replace(**{field: value}))


@pytest.mark.parametrize("mode", ["compensated", "blocked"])
def test_solve_dtype_and_perturb_points_are_supported(mode):
    """``solve_dtype`` ``compensated`` / ``blocked`` and ``perturb_points``
    pass the check and come through ``from_args`` as the JAX package reads
    them."""
    args = SimpleNamespace(iter_config=[{"n": 3, "type": [["rgb", 2]]}],
                           sdf={}, rgb={}, solve_dtype=mode, perturb_points=7)
    jf, tf = JT.TrackerConfig.from_args(args, 4096), T.TrackerConfig.from_args(args, 4096)
    assert (tf.solve_dtype, tf.perturb_points) == (jf.solve_dtype, jf.perturb_points) == (mode, 7)
    T.check_supported(tf)
