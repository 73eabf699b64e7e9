"""The tracker's remaining modes on the CPU, against the JAX package: the SDF
term under ``sdf_compute_dtype="bfloat16"`` (kernel 1's plain bf16
version), under ``sdf_fused="off"`` (autograd through ``Decoder.decode``,
f32 and bf16), also beside the JAX package's cached gather; the block-tiled warp (its
textures and parity planes bit for bit, ``rgb_odometry_tiled`` and the
tiled photometric term under each ``solve_dtype``); the round-to-nearest
warp of ``rgb_bilinear=False``; ``filter_depth``; two-frame tracking under
each variant of the accuracy study; and ``gn_unroll`` and the gather cache
giving poses ``torch.equal`` to the baseline's.

Tolerances: the f32 terms as tests/test_torch_tracker.py holds them (atol
1e-5 with a random decoder; per pixel 1e-6 on the warp, whose sums XLA may
contract into FMAs); bf16 terms 5e-3 of each output's largest entry, about
one bf16 ulp (2^-8): where the f32 sums run in another order an
activation's bf16 rounding may land on the other side, which moves that
point's row by about an ulp; poses 1e-4 m and 1e-4 rad in f32, 5e-4 under
bf16.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.core import tracker as JT
from difusion_tpu.data import SyntheticSequence as JSequence
from difusion_tpu.models.decoder import fold_decoder_params, init_decoder_params
from difusion_tpu.models.encoder import EncoderSpec, init_encoder_params
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
from difusion_tpu_torch.ops import imgproc as IP
from difusion_tpu_torch.ops.decoder_fused import pack_fused_decoder
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.ops.se3 import Pose, exp_twist

torch.set_num_threads(2)
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
def decoders():
    """(JAX params, spec, port Decoder) of a random decoder and the prior."""
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    t_dec, _ = from_jax_params(jax.tree.map(np.asarray, dec), jax.tree.map(np.asarray, enc),
                               DecoderSpec(*spec), device="cpu")
    rdec = fold_decoder_params(init_decoder_params(spec, jax.random.key(0)))
    renc = init_encoder_params(EncoderSpec(), jax.random.key(1))
    r_t, _ = from_jax_params(jax.tree.map(np.asarray, rdec), jax.tree.map(np.asarray, renc),
                             DecoderSpec(*spec), device="cpu")
    return {"prior": (dec, spec, t_dec), "random": (rdec, spec, r_t)}


def _dense_map(seed=0):
    cfg = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
               latent_dim=29, capacity=1 << 12, prune_min_vox_obs=4,
               ignore_count_th=2.0, encoder_count_th=600.0)
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
    cell_xyz = np.stack(np.unravel_index(cells, jcfg.n_xyz), axis=1).astype(np.float64)
    return jcfg, jstate, tcfg, tstate, cell_xyz, jcfg.bound_min


def _hash_map(seed=4):
    rng = np.random.default_rng(seed)
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
    return jcfg, jstate, tcfg, tstate, cells.astype(np.float64), (0.0, 0.0, 0.0)


def _sdf_inputs(cells, voxel_size, bound_min, n=512, seed=5):
    rng = np.random.default_rng(seed)
    pts = ((cells[:n] + rng.uniform(0.1, 0.9, (n, 3))) * voxel_size
           + np.asarray(bound_min)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    R = np.asarray(jax_exp_twist(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)).R)
    t = rng.normal(0, 0.01, 3).astype(np.float32)
    pts_cam = ((pts - t) @ R).astype(np.float32)
    xi = rng.normal(0, 0.005, 6).astype(np.float32)
    return pts_cam, mask, R, t, xi


def _close(got, ref, rel):
    assert float(got[2]) > 0
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=rel * np.abs(r).max(), rtol=0)


def _terms(kind, decoders, weights, seed=5, xi_scale=1.0):
    jcfg, jstate, tcfg, tstate, cells, bmin = (_dense_map() if kind == "dense"
                                               else _hash_map())
    dec, spec, t_dec = decoders[weights]
    pts_cam, mask, R, t, xi = _sdf_inputs(cells, 0.1, bmin, seed=seed)
    xi = xi * xi_scale
    jargs = (jcfg, dec, spec, jstate, JPose(jnp.asarray(R), jnp.asarray(t)),
             jax_exp_twist(jnp.asarray(xi)), jnp.asarray(pts_cam), jnp.asarray(mask),
             "huber", 5.0)
    targs = (tstate, Pose(_t(R), _t(t)), exp_twist(_t(xi)), _t(pts_cam), _t(mask),
             "huber", 5.0, M.latent_count_table(tstate))
    return jargs, JM.latent_count_table(jstate), tcfg, t_dec, targs


@pytest.mark.parametrize("weights", ["random", "prior"])
def test_sdf_term_bf16_fused_matches_jax(decoders, weights):
    """The SDF term through kernel 1's bf16 mode (plain version) against the
    JAX package's fused route with a bf16 w_stack (interpret mode)."""
    jargs, jaug, tcfg, t_dec, targs = _terms("dense", decoders, weights)
    ref = JT._sdf_term(*jargs, compute_dtype=jnp.bfloat16, aug_table=jaug, fused=True)
    got = T._sdf_term(tcfg, pack_fused_decoder(t_dec, torch.bfloat16), *targs)
    _close(got, ref, 5e-3)


@pytest.mark.parametrize("kind,dtype", [("dense", "float32"), ("dense", "bfloat16"),
                                        ("hash", "float32"), ("hash", "bfloat16")])
def test_sdf_term_off_matches_jax(decoders, kind, dtype):
    """``sdf_fused="off"``: autograd of sdf / std.detach() through
    ``Decoder.decode`` against the JAX package's vjp route, dense and hash
    map, f32 (atol 1e-5 of the largest entry, random decoder) and bf16."""
    jargs, jaug, tcfg, t_dec, targs = _terms(kind, decoders, "random")
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = JT._sdf_term(*jargs, compute_dtype=jd, aug_table=jaug, fused=False)
    got = T._sdf_term(tcfg, None, *targs, decoder=t_dec, compute_dtype=td)
    _close(got, ref, 5e-3 if dtype == "bfloat16" else 1e-5)
    fused = T._sdf_term(tcfg, pack_fused_decoder(t_dec, td), *targs)
    _close(fused, [g.numpy() for g in got], 5e-3 if dtype == "bfloat16" else 1e-5)


def test_sdf_term_gather_cache_matches_jax(decoders):
    """``sdf_gather_cache`` (dense map, ``sdf_fused`` off): the JAX package's
    cached gather, two evaluations (the first from the empty cache, the
    second reusing its rows), against the port's term, which gathers every
    time: the same terms (atol 1e-5 of the largest entry), and the JAX
    cache holds the rows the port gathers."""
    jargs, jaug, tcfg, t_dec, targs = _terms("dense", decoders, "random")
    n = targs[3].shape[0]
    jcache = (jnp.full((n, 3), -(1 << 30), jnp.int32), jnp.zeros((n, 29), jnp.float32),
              jnp.zeros((n,), bool))
    got = T._sdf_term(tcfg, None, *targs, decoder=t_dec)
    state, last, delta, pts = targs[:4]
    latent, _, valid = M.gather_latent_rel(tcfg, state, last.apply(delta.apply(pts)),
                                           targs[-1])
    for _ in range(2):
        *ref, jcache = JT._sdf_term(*jargs, aug_table=jaug, fused=False, cache=jcache)
        _close(got, ref, 1e-5)
        np.testing.assert_array_equal(latent.numpy(), np.asarray(jcache[1]))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jcache[2]))


def _pyramids(frames):
    """The JAX package's preprocessed frames 0 and 1, and the same values as
    the port's types: each warp function is held against the JAX one on the
    same inputs (the two preprocessings differ at 1e-6 in the gradients,
    tests/test_torch_tracker.py)."""
    jt = JT.TrackerConfig(point_budget=2048, warp_tiled=False)
    out = []
    for frame in frames:
        packed = JT.pack_frame(frame.rgb, frame.depth, CALIB[4])
        a = JT.preprocess_frame_packed(jt, JIntrinsic(*CALIB), jnp.asarray(packed), H, W)
        b = T.ProcessedFrame(
            IP.Pyramid(*(tuple(_t(np.asarray(x)) for x in field) for field in a.pyramid)),
            *(_t(np.asarray(x)) for x in (a.pts_cam, a.normals_cam, a.pc_mask)))
        out.append((a, b))
    return out


def test_tiled_textures_and_planes_equal_jax(frames):
    """``warp_texture_tiled`` (f32), ``warp_texture_tiled_quantized`` (bf16)
    and ``make_tiled_frame_planes`` are exact copies: torch.equal to the JAX
    package's (jitted) at levels 0 and 1."""
    (a0, b0), (a1, b1) = _pyramids(frames)
    for lvl in (0, 1):
        ji, jd = a0.pyramid.intensity[lvl], a0.pyramid.depth[lvl]
        ti, td = b0.pyramid.intensity[lvl], b0.pyramid.depth[lvl]
        np.testing.assert_array_equal(IP.warp_texture_tiled(ti, td).numpy(),
                                      np.asarray(jax.jit(JIP.warp_texture_tiled)(ji, jd)))
        jq = jax.jit(JIP.warp_texture_tiled_quantized, static_argnums=2)(ji, jd, CALIB[4])
        tq = IP.warp_texture_tiled_quantized(ti, td, CALIB[4])
        assert tq.dtype == torch.bfloat16 and tq.shape == (H * W // 4 >> (2 * lvl), 75)
        np.testing.assert_array_equal(tq.float().numpy(), np.asarray(jq.astype(jnp.float32)))
        p, q = a1.pyramid, b1.pyramid
        jp = jax.jit(JIP.make_tiled_frame_planes)(p.intensity[lvl], p.depth[lvl],
                                                   p.depth_ok[lvl], p.grad[lvl],
                                                   p.grad_ok[lvl])
        tp = IP.make_tiled_frame_planes(q.intensity[lvl], q.depth[lvl], q.depth_ok[lvl],
                                        q.grad[lvl], q.grad_ok[lvl])
        for x, y in zip(tp, jp):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("texture", ["f32", "bf16"])
def test_rgb_odometry_tiled_matches_jax(frames, texture):
    """``rgb_odometry_tiled`` through either texture against the JAX
    package's (jitted): the kept pixels equal, f and J to 1e-6 (per pixel;
    XLA may contract the bilinear sums into FMAs); and the two textures give
    the port the same values bit for bit (sensor-grid frames)."""
    (a0, b0), (a1, b1) = _pyramids(frames)
    xi = np.array([0.004, -0.003, 0.002, 0.003, -0.002, 0.001], np.float32)
    cam = T.level_camera(T.TrackerConfig(), Intrinsic(*CALIB), 0, "cpu")
    d = exp_twist(_t(xi))
    krkinv, kt = cam.K @ d.R @ cam.Kinv, cam.K @ d.t
    p, q = a1.pyramid, b1.pyramid
    jplanes = JIP.make_tiled_frame_planes(p.intensity[0], p.depth[0], p.depth_ok[0],
                                          p.grad[0], p.grad_ok[0])
    tplanes = IP.make_tiled_frame_planes(q.intensity[0], q.depth[0], q.depth_ok[0],
                                         q.grad[0], q.grad_ok[0])
    if texture == "f32":
        jtex = JIP.warp_texture_tiled(a0.pyramid.intensity[0], a0.pyramid.depth[0])
        ttex = IP.warp_texture_tiled(b0.pyramid.intensity[0], b0.pyramid.depth[0])
    else:
        jtex = JIP.warp_texture_tiled_quantized(a0.pyramid.intensity[0],
                                                a0.pyramid.depth[0], CALIB[4])
        ttex = IP.warp_texture_tiled_quantized(b0.pyramid.intensity[0],
                                               b0.pyramid.depth[0], CALIB[4])
    f = jax.jit(JIP.rgb_odometry_tiled, static_argnums=(5, 6, 7))
    jf, jJ, jok = f(jplanes, jtex, jnp.asarray(cam.intr), jnp.asarray(krkinv.numpy()),
                    jnp.asarray(kt.numpy()), 0.0, 0.2, CALIB[4])
    tf, tJ, tok = IP.rgb_odometry_tiled(tplanes, ttex, cam.intr, krkinv, kt, 0.0, 0.2,
                                        dcam_scale=CALIB[4])
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert int(tok.sum()) > 1000
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=1e-6, rtol=1e-5)
    if texture == "bf16":
        other = IP.rgb_odometry_tiled(
            tplanes, IP.warp_texture_tiled(b0.pyramid.intensity[0], b0.pyramid.depth[0]),
            cam.intr, krkinv, kt, 0.0, 0.2)
        for x, y in zip((tf, tJ, tok), other):
            assert torch.equal(x, y)


def test_rgb_odometry_nearest_matches_jax(frames):
    """``rgb_bilinear=False``: the round-to-nearest warp over the
    2-channel previous frame against the JAX package's ``bilinear=False``
    (jitted), at stride 1 and 2."""
    (a0, b0), (a1, b1) = _pyramids(frames)
    xi = np.array([0.004, -0.003, 0.002, 0.003, -0.002, 0.001], np.float32)
    cam = T.level_camera(T.TrackerConfig(rgb_fullres_K=True), Intrinsic(*CALIB), 1, "cpu")
    d = exp_twist(_t(xi))
    krkinv, kt = cam.K @ d.R @ cam.Kinv, cam.K @ d.t
    for stride in (1, 2):
        p, q = a1.pyramid, b1.pyramid
        jcur = [JIP.subsample2d(x[0], stride) for x in (p.intensity, p.depth, p.depth_ok,
                                                         p.grad, p.grad_ok)]
        tcur = [IP.subsample2d(x[0], stride) for x in (q.intensity, q.depth, q.depth_ok,
                                                        q.grad, q.grad_ok)]
        jtex = jnp.stack([a0.pyramid.intensity[0], a0.pyramid.depth[0]], -1)
        ttex = torch.stack([b0.pyramid.intensity[0], b0.pyramid.depth[0]], -1)
        f = jax.jit(lambda *a: JIP.rgb_odometry(
            a0.pyramid.intensity[0], a0.pyramid.depth[0], None, *a, 0.0, 0.2,
            bilinear=False, coord_stride=stride, prev_tex=jtex))
        ref = f(*jcur, jnp.asarray(cam.intr), jnp.asarray(krkinv.numpy()),
                jnp.asarray(kt.numpy()))
        got = IP.rgb_odometry(ttex, *tcur, cam.intr, krkinv, kt, 0.0, 0.2,
                              coord_stride=stride, bilinear=False)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("mode,texture", [("f32", "bf16"), ("f32", "f32"),
                                          ("compensated", "bf16"), ("blocked", "bf16")])
def test_tiled_rgb_term_matches_jax(frames, mode, texture):
    """H, g, E of the tiled photometric term at L0 against the JAX package's
    ``_rgb_term`` with the tiled texture: the (7, 4, H2, W2) Gram (``f32``),
    flattened into the cascade (``compensated``), one partial per image row
    (``blocked``).  rtol 1e-4 of each output's largest entry, as the
    per-pixel term (the sums run in another order)."""
    (a0, b0), (a1, b1) = _pyramids(frames)
    jt = JT.TrackerConfig(point_budget=2048, solve_dtype=mode,
                          warp_texture_bf16=texture == "bf16")
    tt = T.TrackerConfig(point_budget=2048, solve_dtype=mode, warp_tiled=True,
                         warp_texture_bf16=texture == "bf16")
    xi = np.array([0.004, -0.003, 0.002, 0.003, -0.002, 0.001], np.float32)
    jlevel = JT._rgb_level_inputs(jt, a1.pyramid, 0)
    jtex = (JIP.warp_texture_tiled_quantized(a0.pyramid.intensity[0], a0.pyramid.depth[0],
                                             CALIB[4]) if texture == "bf16" else
            JIP.warp_texture_tiled(a0.pyramid.intensity[0], a0.pyramid.depth[0]))
    ref = JT._rgb_term(0, jt, JIntrinsic(*CALIB), a0.pyramid, jlevel, ("tiled", jtex),
                       jax_exp_twist(jnp.asarray(xi)), jnp.float32(500.0), gram_mode=mode)
    prep = T.gn_prepare(tt._replace(iter_config=((1, (("rgb", 0),)),)),
                        M.create_map_state(M.MapConfig(bound_min=(0, 0, 0), n_xyz=(2, 2, 2),
                                                       voxel_size=0.1, capacity=8), "cpu"),
                        b0.pyramid, b1, CALIB[4])
    assert prep.tex_kinds == {0: "tiled"}
    assert prep.prev_texs[0].dtype == (torch.bfloat16 if texture == "bf16" else torch.float32)
    got = T._rgb_term(tt, T.level_camera(tt, Intrinsic(*CALIB), 0, "cpu"), 1,
                      prep.prev_texs[0], prep.cur_levels[0], exp_twist(_t(xi)),
                      torch.tensor(500.0), mode, "tiled", CALIB[4])
    _close(got, ref, 1e-4)


def test_filter_depth_matches_jax(frames):
    """The 5x5 bilateral depth filter against the JAX package's (jitted) on
    metric depth: rtol 1e-6 (exp and division in another order)."""
    depth = frames[0].depth.astype(np.float32) * np.float32(1 / CALIB[4])
    valid = (depth > 0.5) & (np.random.default_rng(0).uniform(size=depth.shape) > 0.05)
    jd, jv = jax.jit(JIP.filter_depth)(jnp.asarray(depth), jnp.asarray(valid))
    td, tv = IP.filter_depth(torch.from_numpy(depth), torch.from_numpy(valid))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=0, rtol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(td.numpy(), depth)
