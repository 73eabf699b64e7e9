"""onet_cbn, Occupancy Networks' conditional-batch-norm decoder, on the
port's normal path, on the CPU at small widths with every weight drawn at
random (ONet's own initialisation, fc_1 zero and gamma 1, would make every
block the identity and hide it): the inference form against the
benchmark's plain reference (BN unfolded there, folded here), the three
kernels' plain versions, the tracker's SDF term fused and not, the
conditioning table's refresh, a mesher extract, the trainer's step and BN,
the npz round trip and the work counts at the published widths."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import flops
from benchmark.reference.prior import Prior
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import meshing as MS
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.data.production import SyntheticSequence
from difusion_tpu_torch.models import decoder as D
from difusion_tpu_torch.models import weights as W
from difusion_tpu_torch.models.encoder import EncoderSpec, init_encoder_params
from difusion_tpu_torch.ops import decoder_fused as DF
from difusion_tpu_torch.ops.imgproc import Intrinsic
from difusion_tpu_torch.ops.se3 import Pose
from difusion_tpu_torch.slam import SLAMSystem
from difusion_tpu_torch.train import trainer as TR
from difusion_tpu_torch.train.losses import LossConfig

SPEC = D.CbnSpec(latent_size=16, hidden=32, blocks=2)
HYPER = {"code_length": 16, "network_name": "onet_cbn",
         "network_specs": {"hidden_size": 32, "n_blocks": 2},
         "encoder_name": "di_encoder", "encoder_specs": {"per_point_feat": [6, 32, 64, 256]}}
PUBLISHED = {"code_length": 256, "network_name": "onet_cbn",
             "network_specs": {"hidden_size": 256, "n_blocks": 5}}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_params(spec=SPEC, seed=0, gamma=0.0):
    """ONet's tree with every weight drawn (U(-k, k), k = 1/sqrt(fan_in);
    ``gamma`` added to each gamma map's bias) and running statistics away
    from (0, 1)."""
    params = D.init_cbn_params(spec, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def drawn(a):
        k = 1.0 / np.sqrt(a.shape[-1] if a.ndim == 2 else spec.latent_size)
        return rng.uniform(-k, k, a.shape).astype(np.float32)
    for b in params["blocks"]:
        b["fc_1"]["w"] = drawn(b["fc_1"]["w"])
    for c in params["cbn"]:
        for k in ("gamma_w", "gamma_b", "beta_w", "beta_b"):
            c[k] = drawn(c[k])
        c["gamma_b"] += np.float32(gamma)
        c["mean"] = rng.normal(0.0, 0.3, spec.hidden).astype(np.float32)
        c["var"] = rng.uniform(0.3, 2.0, spec.hidden).astype(np.float32)
    return params


def write_prior(path: Path, params, epoch=1, seed=0):
    """A prior directory (hyper.json + prior_<epoch>.npz) with a random
    di_encoder whose codes are the decoder's width."""
    path.mkdir(parents=True, exist_ok=True)
    enc = init_encoder_params(EncoderSpec((6, 32, 64, 256), SPEC.latent_size),
                              torch.Generator().manual_seed(seed + 1))
    W.save_params_npz(path / f"prior_{epoch}.npz", decoder=params, encoder=enc)
    (path / "hyper.json").write_text(json.dumps(HYPER))
    return path / "hyper.json"


@pytest.fixture(scope="module")
def dec():
    return D.CbnDecoder(SPEC, random_params())


@pytest.fixture(scope="module")
def pack(dec):
    return DF.pack_fused_decoder(dec)


def _inputs(n, m=7, seed=1):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randn(m, SPEC.latent_size, generator=g)
    idx = torch.randint(0, m, (n,), generator=g, dtype=torch.int32)
    rel = torch.rand(n, 3, generator=g) - 0.5
    return codes, idx, rel


def test_inference_form_against_the_reference_with_bn_unfolded(tmp_path, dec):
    """The port's folded decoder (load_prior) against the benchmark's plain
    reference, which reads the raw npz and applies BN's running statistics
    unfolded.  Tolerance 2e-5: the fold reorders a handful of f32 products
    a value (measured ~1e-6 at these widths)."""
    hyper = write_prior(tmp_path / "p", random_params())
    port, _, spec = W.load_prior(hyper, 1, device="cpu")
    assert isinstance(port, D.CbnDecoder) and spec == SPEC
    ref = Prior(hyper, 1, torch.device("cpu"))
    codes, idx, rel = _inputs(300)
    lat = codes[idx.long()]
    sdf, std = port.decode(lat, rel)
    rsdf, rstd = ref.decode(lat, rel)
    torch.testing.assert_close(sdf, rsdf, atol=2e-5, rtol=0)
    torch.testing.assert_close(std, rstd, atol=2e-5, rtol=0)
    # the fold is the whole difference: the unfolded CBN by hand agrees too
    c = random_params()["cbn"][0]
    x = torch.randn(5, SPEC.hidden)
    g = lat[:5] @ torch.tensor(c["gamma_w"]).T + torch.tensor(c["gamma_b"])
    b = lat[:5] @ torch.tensor(c["beta_w"]).T + torch.tensor(c["beta_b"])
    unfolded = g * (x - torch.tensor(c["mean"])) / torch.sqrt(torch.tensor(c["var"]) + 1e-5) + b
    G, B = port.cbn_layer(lat[:5], 0)
    torch.testing.assert_close(G * x + B, unfolded, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 64, 200])
def test_plain_kernels_against_the_decoder_and_autograd(dec, pack, n):
    """The conditioning's plain version against CbnDecoder.condition,
    kernel 3's and kernel 1's against decode and its autograd gradient
    (f32 both: the written-out backward reorders sums, 1e-5)."""
    codes, idx, rel = _inputs(n)
    cond = DF.cbn_condition(pack, codes)
    torch.testing.assert_close(cond, dec.condition(codes), atol=1e-6, rtol=1e-6)
    sdf, std = DF.decode_fwd_cbn(pack, cond, idx, rel)
    x = rel.clone().requires_grad_(True)
    rsdf, rstd = dec.decode(codes[idx.long()], x)
    rgrad, = torch.autograd.grad(rsdf.sum(), x)
    torch.testing.assert_close(sdf, rsdf.detach(), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(std, rstd.detach(), atol=1e-6, rtol=1e-6)
    gsdf, gstd, grad = DF.decode_grad_cbn(pack, cond, idx, rel)
    assert torch.equal(gsdf, sdf) and torch.equal(gstd, std)
    torch.testing.assert_close(grad, rgrad, atol=1e-5, rtol=1e-5)
    assert not DF.cbn_grad_rows_off(grad, pack, cond, idx, rel).any()


def test_conditioning_by_row_list_and_device_count(pack):
    """rows + count condition the first `count` rows of the list in place,
    and leave every other row of the output as it was."""
    codes, *_ = _inputs(1, m=9)
    out = torch.full((9, SPEC.n_cbn, 2, SPEC.hidden), 7.0)
    rows = torch.tensor([4, 1, 8, 0], dtype=torch.int32)
    DF.cbn_condition(pack, codes, rows, torch.tensor(3, dtype=torch.int32), out=out)
    full = DF.cbn_condition(pack, codes)
    for r in range(9):
        if r in (4, 1, 8):
            assert torch.equal(out[r], full[r])
        else:
            assert bool((out[r] == 7.0).all())


def test_pack_fragments_hold_the_plain_weights(pack):
    """The kernels' fragment segments are the plain weights re-laid: the
    trunk's forward W^T and backward W of every block, in stream order, and
    each CBN's (gamma | beta) map with its columns interleaved eight by
    eight; the layout is the one csrc/decoder_cbn.cu reads."""
    p, lay = DF.unpack_cond(pack), pack.layout
    H, L = lay.H, lay.L

    def unfrag(f, k, n):   # _wide_frag's inverse
        return f.reshape(k // 8, n // 8, 8, 4, 2).permute(0, 3, 4, 1, 2).reshape(k, n)
    mats = p["frag"].reshape(4 * lay.NB, H * H)
    fwd = [m for i in range(lay.NB) for m in (p["w0"][i].T, p["w1"][i].T)]
    bwd = [m for i in range(lay.NB - 1, -1, -1) for m in (p["w1"][i], p["w0"][i])]
    for got, want in zip(mats, fwd + bwd):
        assert torch.equal(unfrag(got, H, H), want)
    for j, got in enumerate(p["cfrag"].reshape(lay.NC, L * 2 * H)):
        b = unfrag(got, L, 2 * H).reshape(L, H // 8, 2, 8)
        assert torch.equal(b[:, :, 0].reshape(L, H), p["cw"][j, 0].T)
        assert torch.equal(b[:, :, 1].reshape(L, H), p["cw"][j, 1].T)
    assert p["meta"].tolist() == [L, H, lay.NB, lay.NC]
    assert pack.flat.numel() == lay.size
    assert DF.CbnLayout(256, 256, 5).size == 4 + 4 * 256 + 2 * 5 * (256 * 256 + 256) + 2 * 256 \
        + 4 + 11 * 2 * 256 * 256 + 11 * 2 * 256 + 2 * 11 * 256 + 20 * 256 * 256 + 11 * 512 * 256


def _small_map(n_slots=40, seed=3):
    """A dense map whose first slots hold random latents, over cells around
    the origin, with counts past the threshold."""
    cfg = M.MapConfig(bound_min=(-0.4, -0.4, -0.4), n_xyz=(8, 8, 8), voxel_size=0.1,
                      latent_dim=SPEC.latent_size, capacity=64, ignore_count_th=1.0)
    st = M.create_map_state(cfg, "cpu")
    g = torch.Generator().manual_seed(seed)
    cells = torch.randperm(cfg.n_cells, generator=g)[:n_slots]
    indexer = st.indexer.clone()
    indexer[cells] = torch.arange(n_slots, dtype=torch.int32)
    latents = st.latents.clone()
    latents[:n_slots] = torch.randn(n_slots, SPEC.latent_size, generator=g)
    count = st.obs_count.clone()
    count[:n_slots] = 5.0
    positions = st.positions.clone()
    positions[:n_slots] = cells.to(torch.int32)
    st = st._replace(indexer=indexer, latents=latents, obs_count=count, positions=positions,
                     n_occupied=torch.tensor(n_slots, dtype=torch.int32),
                     mesh_dirty=torch.arange(cfg.capacity) < n_slots)
    return cfg, st


def test_sdf_term_fused_plain_against_autograd(dec, pack):
    """The SDF term through kernel 1's plain version (each point's slot,
    the conditioning table) against sdf_fused "off" (autograd through
    CbnDecoder.decode): H, g and E within 2e-5 relative (f32 both; the
    written-out backward and the per-row conditioning order sums apart)."""
    cfg, st = _small_map()
    table = T.CondTable(pack, cfg.capacity, "cpu")
    table.refresh(st.latents)
    g = torch.Generator().manual_seed(5)
    pts = (torch.rand(500, 3, generator=g) - 0.5) * 0.7
    mask = torch.rand(500, generator=g) > 0.1
    last = Pose(torch.eye(3), torch.tensor([0.01, -0.02, 0.0]))
    delta = Pose(torch.eye(3), torch.zeros(3))
    aug = M.latent_count_table(st)
    fused = T._sdf_term(cfg, pack, st, last, delta, pts, mask, "huber", 5.0, aug,
                        cond=table.table)
    off = T._sdf_term(cfg, None, st, last, delta, pts, mask, "huber", 5.0, aug, decoder=dec)
    for a, b in zip(fused, off):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=2e-5)
    _, _, valid = M.gather_latent_rel(cfg, st, pts, aug)
    slot, _, svalid = M.gather_slot_rel(cfg, st, pts, aug)
    assert torch.equal(valid, svalid) and int(valid.sum()) > 20
    assert slot.dtype == torch.int32 and bool((slot[~valid] == 0).all())


def test_conditioning_table_refreshes_changed_slots_only(pack):
    """refresh conditions exactly the slots whose latent changed, counts
    them, and is free for the tensor it last saw."""
    cfg, st = _small_map()
    table = T.CondTable(pack, cfg.capacity, "cpu")
    zero = DF.cbn_condition(pack, torch.zeros(1, SPEC.latent_size))[0]
    assert all(torch.equal(table.table[r], zero) for r in (0, 63))
    table.refresh(st.latents)
    assert table.cond_rows() == 40
    torch.testing.assert_close(table.table[:40], DF.cbn_condition(pack, st.latents[:40]))
    table.refresh(st.latents)
    assert table.cond_rows() == 40
    lat = st.latents.clone()
    lat[[3, 50]] += 1.0
    before = table.table.clone()
    table.refresh(lat)
    assert table.cond_rows() == 42
    changed = (table.table != before).flatten(1).any(dim=1)
    assert changed.nonzero()[:, 0].tolist() == [3, 50]


def test_mesher_conditions_each_live_block_once(dec):
    """A dense extract under onet_cbn: the live blocks conditioned once
    (mesh.cond), each site decoded by kernel 3's plain version from its
    block's row, against the same extract through CbnDecoder.decode: the
    same triangles to 1e-5 (the conditioning's matmul shapes differ)."""
    cfg, st = _small_map(n_slots=60)
    fused = MS.MeshExtractor(cfg, dec, voxel_resolution=4)
    assert isinstance(fused.packed, DF.CondPack)
    plain = MS.MeshExtractor(cfg, dec, voxel_resolution=4)
    plain.packed = None
    fused.extract(st, no_cache=True)
    plain.extract(st, no_cache=True)
    assert fused.last_stats["conditioned_blocks"] == fused.last_stats["blocks"] > 0
    assert fused.cond_rows == fused.last_stats["blocks"]
    assert fused.last_stats["decode_instance"] == "plain"
    a, b = fused.triangles(), plain.triangles()
    assert a[0].shape == b[0].shape and a[0].shape[0] > 0
    np.testing.assert_allclose(a[0], b[0], atol=1e-5)
    np.testing.assert_allclose(a[1], b[1], atol=1e-5)
    with pytest.raises(NotImplementedError, match="fast"):
        MS.MeshExtractor(cfg, dec, voxel_resolution=4, fast=True)


def test_train_step_bn_and_conditioning_once_a_lif():
    """One trainer step under onet_cbn: BN takes batch statistics over all
    the batch's samples and moves the running ones as
    torch.nn.BatchNorm1d does; conditioning each LIF once and broadcasting
    equals conditioning every sample; Adam moves every parameter."""
    params = random_params()
    tr = D.CbnDecoderTrain(SPEC, params)
    Bn, S = 3, 20
    g = torch.Generator().manual_seed(2)
    codes = torch.randn(Bn, SPEC.latent_size, generator=g)
    xyz = torch.rand(Bn * S, 3, generator=g) - 0.5
    x = torch.randn(Bn, S, SPEC.hidden, generator=g)
    bn = torch.nn.BatchNorm1d(SPEC.hidden, affine=False)
    bn.running_mean.copy_(tr.cbn[1].mean)
    bn.running_var.copy_(tr.cbn[1].var)
    got = tr._cbn(1, x, codes)
    xn = bn(x.reshape(-1, SPEC.hidden)).reshape(Bn, S, -1)
    per_sample = torch.repeat_interleave(codes, S, dim=0)
    c = tr.cbn[1].p
    want = ((per_sample @ c["gamma_w"].T + c["gamma_b"]) * xn.reshape(Bn * S, -1)
            + per_sample @ c["beta_w"].T + c["beta_b"]).reshape(Bn, S, -1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tr.cbn[1].mean, bn.running_mean, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(tr.cbn[1].var, bn.running_var, atol=1e-6, rtol=1e-6)

    spec_e = EncoderSpec((6, 32, 64, 256), SPEC.latent_size)
    state = TR.state_from_params(SPEC, spec_e, params,
                                 init_encoder_params(spec_e, torch.Generator().manual_seed(4)),
                                 "cpu")
    sdf_data = torch.cat([torch.rand(Bn, S, 3, generator=g) - 0.5,
                          torch.randn(Bn, S, 1, generator=g) * 0.1], dim=2)
    surface = torch.randn(Bn, 16, 6, generator=g)
    cfg = LossConfig(types=("neg_log_likelihood", "reg_loss"))
    before = {k: v.detach().clone() for k, v in state.dec.named_parameters()}
    mean0 = state.dec.cbn[0].mean.clone()
    state, losses = TR.train_step(cfg, state, sdf_data, surface, 1e-3, 1e-3, 1)
    assert all(torch.isfinite(v) for v in losses.values())
    assert all(not torch.equal(before[k], v) for k, v in state.dec.named_parameters())
    assert not torch.equal(mean0, state.dec.cbn[0].mean)
    tree = state.dec.to_params()
    assert torch.equal(torch.tensor(tree["cbn"][0]["mean"]), state.dec.cbn[0].mean)


def test_npz_round_trip_and_family_dispatch(tmp_path):
    """A train-form tree -> prior_E.npz -> the same tree (running
    statistics included) and the same inference decoder; a hyper without
    network_name is di_decoder's; an unknown family raises; bf16 raises."""
    params = random_params(seed=7)
    W.save_params_npz(tmp_path / "p.npz", decoder=params)
    back = W.load_params_npz(tmp_path / "p.npz")["decoder"]
    assert json.dumps(jax_like(back)) == json.dumps(jax_like(params))
    a, b = D.CbnDecoder(SPEC, params), D.inference_decoder(SPEC, back)
    for (na, ta), (nb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    assert D.spec_from_hyper({"code_length": 29, "network_specs": {"dims": [128] * 4}}) \
        == D.DecoderSpec(29, (128,) * 4, (), 0.0, (), (), False)
    assert D.spec_from_hyper(HYPER) == SPEC
    with pytest.raises(ValueError, match="unknown decoder family"):
        D.spec_from_hyper({"code_length": 8, "network_name": "siren"})
    with pytest.raises(ValueError, match="float32"):
        a.decode(torch.zeros(1, 16), torch.zeros(1, 3), compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 mode"):
        DF.pack_fused_decoder(a, torch.bfloat16)


def jax_like(tree):
    """A tree of arrays as nested lists (for an exact comparison)."""
    if isinstance(tree, dict):
        return {k: jax_like(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [jax_like(v) for v in tree]
    return np.asarray(tree).tolist()


@pytest.mark.parametrize("what,want", [
    ("fwd", 2 * (3 * 256 + 10 * 256 * 256 + 2 * 256)),
    ("grad", 2 * (3 * 256 + 10 * 256 * 256 + 2 * 256) + 2 * (256 + 10 * 256 * 256 + 3 * 256)),
    ("cond", 2 * 11 * 2 * 256 * 256)])
def test_work_counts_at_the_published_widths(what, want):
    """By hand at c_dim 256, hidden 256, five blocks: the trunk forward
    fc_p (3 x 256), ten 256 x 256 products and two heads (1,313,280 FLOP);
    the gradient back through the sdf head, the ten products and fc_p's
    xyz columns (1,312,768 more); the conditioning 11 x 2 maps of 256 x 256
    a code (2,883,584)."""
    fam = flops.decoders.load(PUBLISHED)
    got = {"fwd": flops.decoder_fwd_flops, "grad": flops.decoder_grad_flops,
           "cond": fam.cond_flops}[what](PUBLISHED)
    assert got == want
    assert {"fwd": 1_313_280, "grad": 2_626_048, "cond": 2_883_584}[what] == want


def test_slam_tracks_fuses_and_meshes_under_onet_cbn(tmp_path):
    """A SLAMSystem built from an onet_cbn prior on the dense map: frames
    tracked per frame and in a chunk give equal poses (one TrackProgram,
    the conditioning table refreshed at each fusion), the table follows
    the map's latents, and an extract conditions its blocks."""
    hyper = write_prior(tmp_path / "p", D.init_cbn_params(SPEC, torch.Generator().manual_seed(3)))
    calib = (300.0, 300.0, 79.5, 59.5, 5000.0)
    seq = dict(n_frames=7, h=120, w=160, corrugation=0.1, motion_scale=0.6)
    cfg = M.MapConfig(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
                      latent_dim=16, capacity=1 << 12, prune_min_vox_obs=4,
                      ignore_count_th=1.0)
    tcfg = T.TrackerConfig(point_budget=1024, iter_config=(
        (2, (("rgb", 2),)), (2, (("sdf",), ("rgb", 1))), (3, (("sdf",), ("rgb", 0)))))
    frames = list(SyntheticSequence(calib=Intrinsic(*calib), **seq))
    systems = []
    for chunked in (False, True):
        dec, enc, _ = W.load_prior(hyper, 1, device="cpu")
        sys_ = SLAMSystem(cfg, tcfg, dec, enc, Intrinsic(*calib), integrate_interval=3,
                          mesh_resolution=2, device="cpu")
        assert sys_.tracker.cond is not None
        sys_.process_frame(frames[0])
        if chunked:
            from difusion_tpu_torch.core.tracker import pack_frame
            packed = torch.stack([torch.from_numpy(pack_frame(f.rgb, f.depth, 5000.0))
                                  for f in frames[1:]])
            sys_.process_chunk(packed, 160)
        else:
            for f in frames[1:]:
                sys_.process_frame(f)
        systems.append(sys_)
    per, chunk = systems
    for i in range(len(frames)):
        a, b = per.tracker.pose_at(i), chunk.tracker.pose_at(i)
        assert np.array_equal(a.t, b.t) and np.array_equal(a.q.rotation_matrix,
                                                           b.q.rotation_matrix)
    for s in systems:
        assert torch.equal(s.tracker.cond.latents, s.state.latents)
        assert s.tracker.cond.cond_rows() > 0
        assert int(s.state.n_occupied) > 0
    per.mesher.extract(per.state, no_cache=True)
    assert per.mesher.last_stats["conditioned_blocks"] > 0
