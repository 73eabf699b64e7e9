"""pigan_film, pi-GAN's FiLM-SIREN decoder, on the port's normal path, on the
CPU with pi-GAN's own initialisation from a seeded generator: the family's
dispatch beside the three priors the repository has, the npz round trip, the
initialisation's ranges, the inference form and the three kernels' plain
versions against the benchmark's plain reference (every row mapped on its
own code there, the mapping once a code here) at a small size and at the
published widths, the TF32 control, a trainer step, the modulation table's
refresh, a mesher extract, a SLAM run, and the onet_cbn family's calls
through the shared seam.

Tolerances, measured on these weights (both sides f32; the port folds the
frequency affine 15 f + 30 into the mapping's last layer and the box warp's
2 into W_0, and sums in another order):
- sdf and std 1e-5: read up to 4.3e-7 at the published widths; the
  reference with its products' operands rounded to TF32 reads 3.3e-4 at the
  small size and 9.4e-4 at the published one;
- d sdf / d xyz 3e-4 (gradients up to ~5 a unit): read up to 3.4e-5; the
  TF32 control 9.7e-3 and 1.1e-1 (eight layers of gamma ~30 amplify a
  preactivation's rounding ~1.7x each);
- the modulation rows 2e-5: read 3.8e-6, one or two ulps of gamma ~30
  from the fold."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import flops
from benchmark.reference import decoders as ref_decoders
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

ROOT = Path(__file__).resolve().parents[1]
SMALL = D.FilmSpec(latent_size=16, hidden=32, layers=3, map_hidden=32)
PUBLISHED = D.FilmSpec()
ATOL, GRAD_ATOL, MOD_ATOL = 1e-5, 3e-4, 2e-5


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def hyper_of(spec):
    return {"code_length": spec.latent_size, "network_name": "pigan_film",
            "network_specs": {"hidden_dim": spec.hidden, "n_layers": spec.layers,
                              "mapping_hidden_dim": spec.map_hidden},
            "encoder_name": "di_encoder", "encoder_specs": {"per_point_feat": [6, 32, 64, 256]}}


def params_of(spec, seed=0):
    return D.init_film_params(spec, torch.Generator().manual_seed(seed))


def write_prior(path: Path, spec, params, epoch=1, seed=0):
    """A prior directory (hyper.json + prior_<epoch>.npz) with a random
    di_encoder whose codes are the decoder's width."""
    path.mkdir(parents=True, exist_ok=True)
    enc = init_encoder_params(EncoderSpec((6, 32, 64, 256), spec.latent_size),
                              torch.Generator().manual_seed(seed + 1))
    W.save_params_npz(path / f"prior_{epoch}.npz", decoder=params, encoder=enc)
    (path / "hyper.json").write_text(json.dumps(hyper_of(spec)))
    return path / "hyper.json"


def _inputs(spec, n, m=7, seed=2):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randn(m, spec.latent_size, generator=g) * 0.5
    idx = torch.randint(0, m, (n,), generator=g, dtype=torch.int32)
    rel = torch.rand(n, 3, generator=g) - 0.5
    return codes, idx, rel


def _ref_grad(decode, lat, rel):
    x = rel.clone().requires_grad_(True)
    with torch.enable_grad():
        sdf, std = decode(lat, x)
        g, = torch.autograd.grad(sdf.sum(), x)
    return sdf.detach(), std.detach(), g


def _ref_modulation(w, spec, codes):
    """The raw npz's mapping, gamma = 15 f + 30 and beta = phi unfolded."""
    a = codes
    for k in range(3):
        a = torch.nn.functional.leaky_relu(
            a @ torch.tensor(w[f"decoder.mapping#{k}.w"]).T
            + torch.tensor(w[f"decoder.mapping#{k}.b"]), 0.2)
    m = a @ torch.tensor(w["decoder.mapping#3.w"]).T + torch.tensor(w["decoder.mapping#3.b"])
    NL, H = spec.layers, spec.hidden
    f, phi = m[:, :NL * H].view(-1, NL, H), m[:, NL * H:].view(-1, NL, H)
    return torch.stack([15 * f + 30, phi], dim=2)


@pytest.fixture(scope="module", params=["small", "published"])
def prior(request, tmp_path_factory):
    """(spec, the port's decoder, its pack, the reference, the raw npz)."""
    spec = SMALL if request.param == "small" else PUBLISHED
    hyper = write_prior(tmp_path_factory.mktemp(request.param), spec, params_of(spec))
    port, _, got_spec = W.load_prior(hyper, 1, device="cpu")
    assert got_spec == spec and isinstance(port, D.FilmDecoder)
    with np.load(hyper.parent / "prior_1.npz") as data:
        raw = {k: data[k] for k in data.files}
    return spec, port, DF.pack_fused_decoder(port), Prior(hyper, 1, torch.device("cpu")), raw


def test_inference_form_against_the_reference(prior):
    """FilmDecoder.decode (every row mapped on its own code) and its autograd
    gradient against the plain reference's on 64 points (300 at the small
    size), and its modulation rows against the raw npz's mapping."""
    spec, port, _, ref, raw = prior
    codes, idx, rel = _inputs(spec, 300 if spec == SMALL else 64)
    lat = codes[idx.long()]
    sdf, std, g = _ref_grad(port.decode, lat, rel)
    rsdf, rstd, rg = _ref_grad(ref.decode, lat, rel)
    torch.testing.assert_close(sdf, rsdf, atol=ATOL, rtol=0)
    torch.testing.assert_close(std, rstd, atol=ATOL, rtol=0)
    torch.testing.assert_close(g, rg, atol=GRAD_ATOL, rtol=0)
    mod = port.modulation(codes)
    assert mod.shape == (7, spec.layers, 2, spec.hidden)
    torch.testing.assert_close(mod, _ref_modulation(raw, spec, codes), atol=MOD_ATOL, rtol=0)


def test_plain_kernels_against_the_reference(prior):
    """The mapping kernel's, kernel 3's and kernel 1's plain versions (the
    mapping once a code, the reverse pass over staged cosines) against
    the reference; kernel 1's sdf and std are kernel 3's."""
    spec, _, pack, ref, raw = prior
    codes, idx, rel = _inputs(spec, 300 if spec == SMALL else 64)
    mod = DF.film_map(pack, codes)
    torch.testing.assert_close(mod, _ref_modulation(raw, spec, codes), atol=MOD_ATOL, rtol=0)
    assert torch.equal(DF.condition(pack, codes), mod)
    rsdf, rstd, rg = _ref_grad(ref.decode, codes[idx.long()], rel)
    sdf, std = DF.decode_fwd_film(pack, mod, idx, rel)
    torch.testing.assert_close(sdf, rsdf, atol=ATOL, rtol=0)
    torch.testing.assert_close(std, rstd, atol=ATOL, rtol=0)
    gsdf, gstd, grad = DF.decode_grad_cond(pack, mod, idx, rel)
    assert torch.equal(gsdf, sdf) and torch.equal(gstd, std)
    torch.testing.assert_close(grad, rg, atol=GRAD_ATOL, rtol=0)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, nearest, ties away), its
    gradient passed straight through."""
    bits = (x.detach().contiguous().view(torch.int32) + 0x1000) & -0x2000
    return x + (bits.view(torch.float32) - x.detach())


def test_tf32_reference_fails_the_tolerances(prior):
    """The control: the reference with every product's operands rounded to
    TF32 misses the f32 reference past the tolerances the port meets, in
    sdf and in the gradient."""
    spec, _, _, ref, raw = prior
    codes, idx, rel = _inputs(spec, 300 if spec == SMALL else 64)
    lat = codes[idx.long()]
    low = ref_decoders.load(hyper_of(spec)).build(
        raw, hyper_of(spec), lambda x, Wt, b: _tf32(x) @ _tf32(Wt).T + b, ref._t)
    rsdf, _, rg = _ref_grad(ref.decode, lat, rel)
    lsdf, _, lg = _ref_grad(low, lat, rel)
    assert float((lsdf - rsdf).abs().max()) > 10 * ATOL
    assert float((lg - rg).abs().max()) > 10 * GRAD_ATOL


def test_spec_dispatch_and_the_repository_priors(tmp_path):
    """network_name pigan_film gives a FilmSpec; the repository's three
    other priors load as before (their spec types and decoder classes) and
    decode as the plain reference does, and so does the pigan_film prior
    trained in the repository (sdf and std within 1e-3 there: its trained
    frequencies reach ~80 and amplify the fold's f32 rounding ~100x, read
    4.5e-5 / 3.8e-4 on these codes)."""
    assert D.spec_from_hyper(hyper_of(SMALL)) == SMALL
    assert D.spec_from_hyper({"code_length": 256, "network_name": "pigan_film"}) == PUBLISHED
    assert D.is_conditioned(SMALL) and D.is_conditioned(D.CbnSpec())
    assert not D.is_conditioned(D.DecoderSpec())
    with pytest.raises(ValueError, match="pigan_film"):
        D.spec_from_hyper({"code_length": 8, "network_name": "siren"})
    codes, idx, rel = _inputs(SMALL, 40, seed=5)
    for name, epoch, cls, spec_cls, tol in (
            ("study_mixed", 300, D.Decoder, D.DecoderSpec, 2e-5),
            ("deepsdf_mixed", 100, D.Decoder, D.DecoderSpec, 2e-5),
            ("onet_mixed", 100, D.CbnDecoder, D.CbnSpec, 2e-5),
            ("pigan_mixed", 100, D.FilmDecoder, D.FilmSpec, 1e-3)):
        hyper = ROOT / "di-checkpoints" / name / "hyper.json"
        dec, _, spec = W.load_prior(hyper, epoch, device="cpu")
        assert type(dec) is cls and type(spec) is spec_cls
        lat = torch.randn(40, spec.latent_size, generator=torch.Generator().manual_seed(1)) * 0.3
        got = dec.decode(lat, rel)
        want = Prior(hyper, epoch, torch.device("cpu")).decode(lat, rel)
        torch.testing.assert_close(got[0], want[0], atol=tol, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=tol, rtol=0)


def test_npz_round_trip(tmp_path):
    """A train-form tree -> prior_E.npz -> the same tree and the same
    inference decoder; bf16 and several ranks raise, naming the family."""
    params = params_of(SMALL, 7)
    W.save_params_npz(tmp_path / "p.npz", decoder=params)
    back = W.load_params_npz(tmp_path / "p.npz")["decoder"]
    assert sorted(back) == ["fc_out", "film", "mapping", "uncertainty"]
    for k in ("mapping", "film"):
        assert len(back[k]) == len(params[k])
        for a, b in zip(back[k], params[k]):
            assert all(np.array_equal(a[x], b[x]) for x in ("w", "b"))
    a, b = D.FilmDecoder(SMALL, params), D.inference_decoder(SMALL, back)
    for (na, ta), (nb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    tr = D.train_decoder(SMALL, back)
    assert isinstance(tr, D.FilmDecoderTrain)
    got = tr.to_params()
    assert all(np.array_equal(got["film"][i]["w"], params["film"][i]["w"]) for i in range(3))
    with pytest.raises(ValueError, match="float32"):
        a.decode(torch.zeros(1, 16), torch.zeros(1, 3), compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pigan_film"):
        DF.pack_fused_decoder(a, torch.bfloat16)


def test_what_is_not_written_raises_naming_the_family():
    """The hash map's fused route, tensor-parallel training and the bf16
    mode are not written for pigan_film: each raises and names it."""
    tcfg = T.TrackerConfig(sdf_fused="on")
    with pytest.raises(ValueError, match="pigan_film"):
        T.resolve_sdf_fused(tcfg, SMALL, "cpu", hash_map=True)
    assert T.resolve_sdf_fused(tcfg, SMALL, "cpu") is True
    assert T.resolve_sdf_fused(T.TrackerConfig(sdf_fused="auto"), SMALL, "cuda",
                               hash_map=True) is False
    from difusion_tpu_torch.train import distributed as TD
    spec_e = EncoderSpec((6, 32, 64, 256), SMALL.latent_size)
    state = TR.create_train_state(SMALL, spec_e, 0, "cpu")
    with pytest.raises(NotImplementedError, match="pigan_film"):
        TD._full_rows(state)


def test_pi_gan_initialisation_ranges():
    """frequency_init(25) on the FiLM layers after the first and the heads,
    first_layer_film_sine_init on the first, Kaiming normal (leaky ReLU
    0.2, fan_in) on the mapping with its last layer x0.25, torch's bias
    bounds; the same seed draws the same tree."""
    spec = PUBLISHED
    p = params_of(spec)
    H, L = spec.hidden, spec.latent_size
    k = np.sqrt(6.0 / H) / 25
    for layer in p["film"][1:] + [p["fc_out"], p["uncertainty"]]:
        w = layer["w"]
        assert np.abs(w).max() <= k and np.abs(w).max() > 0.95 * k
        assert np.abs(layer["b"]).max() <= 1 / np.sqrt(H)
    assert np.abs(p["film"][0]["w"]).max() <= 1 / 3 and np.abs(p["film"][0]["w"]).max() > 0.3
    assert np.abs(p["film"][0]["b"]).max() <= 1 / np.sqrt(3)
    gain = np.sqrt(2 / 1.04)
    for i, layer in enumerate(p["mapping"]):
        want = gain / np.sqrt(L if i == 0 else spec.map_hidden) * (0.25 if i == 3 else 1.0)
        assert abs(layer["w"].std() / want - 1) < 0.05, (i, layer["w"].std(), want)
        assert abs(layer["w"].mean()) < 0.05 * want
    assert p["mapping"][3]["w"].shape == (2 * spec.layers * H, spec.map_hidden)
    again = params_of(spec)
    assert np.array_equal(again["mapping"][3]["w"], p["mapping"][3]["w"])


def test_pack_segments_hold_the_plain_weights(prior):
    """The kernels' fragments are the plain weights re-laid (the trunk's
    W_i^T for the forward, then W_i from the last for kernel 1's reverse
    pass, the mapping's W^T and its last layer's 2 NL column blocks); the
    first layer carries the box warp; the size is csrc/decoder_film.cu's."""
    spec, port, pack, _, _ = prior
    p, lay = DF.unpack_cond(pack), pack.layout
    H, L, MH, NL = lay.H, lay.L, lay.MH, lay.NL

    def unfrag(f, k, n):   # _wide_frag's inverse
        return f.reshape(k // 8, n // 8, 8, 4, 2).permute(0, 3, 4, 1, 2).reshape(k, n)
    frags = p["frag"].reshape(2 * (NL - 1), H * H)
    for i in range(NL - 1):
        assert torch.equal(unfrag(frags[i], H, H), port.film[i + 1].weight.T)
        assert torch.equal(unfrag(frags[2 * (NL - 1) - 1 - i], H, H), port.film[i + 1].weight)
    mf = p["mfrag"]
    sizes = [L * MH, MH * MH, MH * MH] + [MH * H] * (2 * NL)
    parts = mf.split(sizes)
    for k in range(3):
        assert torch.equal(unfrag(parts[k], L if k == 0 else MH, MH), port.mapping[k].weight.T)
    for q in range(2 * NL):
        assert torch.equal(unfrag(parts[3 + q], MH, H), port.map_w[q // 2, q % 2].T)
    assert torch.equal(p["wp"][:, :3], 2 * port.film[0].weight)
    assert p["meta"].tolist() == [L, H, NL, MH]
    assert pack.flat.numel() == lay.size
    assert DF.FilmLayout(256, 256, 8, 256).size == (
        4 + 4 * 256 + 7 * (256 * 256 + 256) + 2 * 256 + 4 + 3 * (256 * 256 + 256)
        + 16 * 256 * 256 + 16 * 256 + 14 * 256 * 256 + 3 * 256 * 256 + 16 * 256 * 256)


def test_mapping_by_row_list_and_device_count(prior):
    """rows + count map the first `count` rows of the list in place and
    leave every other row of the output as it was."""
    spec, _, pack, _, _ = prior
    codes, _, _ = _inputs(spec, 1, m=9)
    out = torch.full((9, spec.layers, 2, spec.hidden), 7.0)
    rows = torch.tensor([4, 1, 8, 0], dtype=torch.int32)
    DF.condition(pack, codes, rows, torch.tensor(3, dtype=torch.int32), out=out)
    full = DF.film_map(pack, codes)
    for r in range(9):
        if r in (4, 1, 8):
            assert torch.equal(out[r], full[r])
        else:
            assert bool((out[r] == 7.0).all())


def test_train_step_maps_each_lif_once():
    """One trainer step under pigan_film: the train form equals the
    inference form on every sample (the mapping once a LIF, broadcast over
    its samples), the losses are finite and Adam moves every parameter."""
    params = params_of(SMALL, 3)
    tr = D.FilmDecoderTrain(SMALL, params)
    Bn, S = 3, 20
    g = torch.Generator().manual_seed(2)
    codes = torch.randn(Bn, SMALL.latent_size, generator=g)
    xyz = torch.rand(Bn * S, 3, generator=g) - 0.5
    sdf, std = tr(codes, xyz)
    rsdf, rstd = D.FilmDecoder(SMALL, params).decode(torch.repeat_interleave(codes, S, 0), xyz)
    torch.testing.assert_close(sdf[:, 0], rsdf, atol=1e-6, rtol=0)
    torch.testing.assert_close(std[:, 0], rstd, atol=1e-6, rtol=0)

    spec_e = EncoderSpec((6, 32, 64, 256), SMALL.latent_size)
    state = TR.state_from_params(SMALL, spec_e, params,
                                 init_encoder_params(spec_e, torch.Generator().manual_seed(4)),
                                 "cpu")
    sdf_data = torch.cat([torch.rand(Bn, S, 3, generator=g) - 0.5,
                          torch.randn(Bn, S, 1, generator=g) * 0.1], dim=2)
    surface = torch.randn(Bn, 16, 6, generator=g)
    cfg = LossConfig(types=("neg_log_likelihood", "reg_loss"))
    before = {k: v.detach().clone() for k, v in state.dec.named_parameters()}
    state, losses = TR.train_step(cfg, state, sdf_data, surface, 1e-3, 1e-3, 1)
    assert all(torch.isfinite(v) for v in losses.values())
    assert all(not torch.equal(before[k], v) for k, v in state.dec.named_parameters())


def _small_map(spec, n_slots=40, seed=3):
    """A dense map whose first slots hold random latents, over cells around
    the origin, with counts past the threshold."""
    cfg = M.MapConfig(bound_min=(-0.4, -0.4, -0.4), n_xyz=(8, 8, 8), voxel_size=0.1,
                      latent_dim=spec.latent_size, capacity=64, ignore_count_th=1.0)
    st = M.create_map_state(cfg, "cpu")
    g = torch.Generator().manual_seed(seed)
    cells = torch.randperm(cfg.n_cells, generator=g)[:n_slots]
    indexer = st.indexer.clone()
    indexer[cells] = torch.arange(n_slots, dtype=torch.int32)
    latents = st.latents.clone()
    latents[:n_slots] = torch.randn(n_slots, spec.latent_size, generator=g) * 0.5
    count = st.obs_count.clone()
    count[:n_slots] = 5.0
    positions = st.positions.clone()
    positions[:n_slots] = cells.to(torch.int32)
    st = st._replace(indexer=indexer, latents=latents, obs_count=count, positions=positions,
                     n_occupied=torch.tensor(n_slots, dtype=torch.int32),
                     mesh_dirty=torch.arange(cfg.capacity) < n_slots)
    return cfg, st


@pytest.fixture(scope="module")
def small():
    """The small decoder with its sdf head widened to a unit's range and its
    bias 0 (frequency_init's head reads within ~0.05 of its bias, where
    no surface crosses)."""
    params = params_of(SMALL, 1)
    params["fc_out"]["w"] = params["fc_out"]["w"] * np.float32(25.0)
    params["fc_out"]["b"] = np.zeros_like(params["fc_out"]["b"])
    dec = D.FilmDecoder(SMALL, params)
    return dec, DF.pack_fused_decoder(dec)


def test_modulation_table_refreshes_changed_slots_only(small):
    """CondTable under pigan_film: refresh maps exactly the slots whose
    latent changed, counts them, and is free for the tensor it last saw."""
    _, pack = small
    cfg, st = _small_map(SMALL)
    table = T.CondTable(pack, cfg.capacity, "cpu")
    assert table.table.shape == (64, SMALL.layers, 2, SMALL.hidden)
    zero = DF.film_map(pack, torch.zeros(1, SMALL.latent_size))[0]
    assert all(torch.equal(table.table[r], zero) for r in (0, 63))
    table.refresh(st.latents)
    assert table.cond_rows() == 40
    torch.testing.assert_close(table.table[:40], DF.film_map(pack, st.latents[:40]))
    table.refresh(st.latents)
    assert table.cond_rows() == 40
    lat = st.latents.clone()
    lat[[3, 50]] += 1.0
    before = table.table.clone()
    table.refresh(lat)
    assert table.cond_rows() == 42
    changed = (table.table != before).flatten(1).any(dim=1)
    assert changed.nonzero()[:, 0].tolist() == [3, 50]


def test_sdf_term_fused_plain_against_autograd(small):
    """The SDF term through kernel 1's plain version (each point's slot,
    the modulation table) against sdf_fused "off" (autograd through
    FilmDecoder.decode): H, g and E within 2e-5 relative (f32 both; the
    written-out reverse pass and autograd order sums apart)."""
    dec, pack = small
    cfg, st = _small_map(SMALL)
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


def test_mesher_maps_each_live_block_once(small):
    """A dense extract under pigan_film: the live blocks mapped once
    (mesh.cond), each site decoded by kernel 3's plain version from its
    block's row, against the same extract through FilmDecoder.decode: the
    same triangles to 1e-5; the coarse-to-fine mesher raises, naming the
    family."""
    dec, _ = small
    cfg, st = _small_map(SMALL, n_slots=60)
    fused = MS.MeshExtractor(cfg, dec, voxel_resolution=4)
    assert isinstance(fused.packed, DF.CondPack)
    plain = MS.MeshExtractor(cfg, dec, voxel_resolution=4)
    plain.packed = None
    fused.extract(st, no_cache=True)
    plain.extract(st, no_cache=True)
    assert fused.last_stats["conditioned_blocks"] == fused.last_stats["blocks"] > 0
    assert fused.cond_rows == fused.last_stats["blocks"]
    a, b = fused.triangles(), plain.triangles()
    assert a[0].shape == b[0].shape and a[0].shape[0] > 0
    np.testing.assert_allclose(a[0], b[0], atol=1e-5)
    np.testing.assert_allclose(a[1], b[1], atol=1e-5)
    with pytest.raises(NotImplementedError, match="pigan_film"):
        MS.MeshExtractor(cfg, dec, voxel_resolution=4, fast=True)


def _slam(hyper, frames, calib, chunked):
    cfg = M.MapConfig(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
                      latent_dim=16, capacity=1 << 12, prune_min_vox_obs=4,
                      ignore_count_th=1.0)
    tcfg = T.TrackerConfig(point_budget=1024, iter_config=(
        (2, (("rgb", 2),)), (2, (("sdf",), ("rgb", 1))), (3, (("sdf",), ("rgb", 0)))))
    dec, enc, _ = W.load_prior(hyper, 1, device="cpu")
    sys_ = SLAMSystem(cfg, tcfg, dec, enc, Intrinsic(*calib), integrate_interval=3,
                      mesh_resolution=2, device="cpu")
    sys_.process_frame(frames[0])
    if chunked:
        from difusion_tpu_torch.core.tracker import pack_frame
        packed = torch.stack([torch.from_numpy(pack_frame(f.rgb, f.depth, 5000.0))
                              for f in frames[1:]])
        sys_.process_chunk(packed, 160)
    else:
        for f in frames[1:]:
            sys_.process_frame(f)
    return sys_


def test_slam_tracks_fuses_and_meshes_under_pigan_film(tmp_path):
    """A SLAMSystem from a pigan_film prior on the dense map: frames tracked
    per frame and in a chunk give equal poses (one TrackProgram, the table
    remapped at each fusion), the table follows the map's latents, and an
    extract maps its blocks."""
    hyper = write_prior(tmp_path / "p", SMALL, params_of(SMALL, 3))
    calib = (300.0, 300.0, 79.5, 59.5, 5000.0)
    seq = dict(n_frames=7, h=120, w=160, corrugation=0.1, motion_scale=0.6)
    frames = list(SyntheticSequence(calib=Intrinsic(*calib), **seq))
    per, chunk = (_slam(hyper, frames, calib, c) for c in (False, True))
    for i in range(len(frames)):
        a, b = per.tracker.pose_at(i), chunk.tracker.pose_at(i)
        assert np.array_equal(a.t, b.t) and np.array_equal(a.q.rotation_matrix,
                                                           b.q.rotation_matrix)
    for s in (per, chunk):
        assert isinstance(s.tracker.packed, DF.CondPack) and s.tracker.cond is not None
        assert torch.equal(s.tracker.cond.latents, s.state.latents)
        assert s.tracker.cond.cond_rows() > 0
    per.mesher.extract(per.state, no_cache=True)
    assert per.mesher.last_stats["conditioned_blocks"] > 0


def test_onet_cbn_calls_its_own_kernels_through_the_seam(tmp_path, monkeypatch):
    """The shared seam (CondPack, condition, decode_grad_cond,
    decode_fwd_cond) routes an onet_cbn system to onet_cbn's three entry
    points, the same calls as before it was shared: one conditioning when
    the table is built, one a refresh that sees new latents, one kernel 1
    call an SDF evaluation, one conditioning and one kernel 3 call an
    extract of one dispatch; pigan_film's are never called."""
    from test_torch_onet import random_params
    from test_torch_onet import write_prior as write_onet
    calls = {}

    def counting(name):
        fn = getattr(DF, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped
    for name in ("cbn_condition", "decode_grad_cbn", "decode_fwd_cbn", "film_map",
                 "decode_grad_film", "decode_fwd_film"):
        monkeypatch.setattr(DF, name, counting(name))
    refresh, sdf_term = T.CondTable.refresh, T._sdf_term

    def counted_refresh(self, latents):
        if latents is not self._src:
            calls["new_latents"] = calls.get("new_latents", 0) + 1
        return refresh(self, latents)

    def counted_term(*a, **k):
        calls["sdf_terms"] = calls.get("sdf_terms", 0) + 1
        return sdf_term(*a, **k)
    monkeypatch.setattr(T.CondTable, "refresh", counted_refresh)
    monkeypatch.setattr(T, "_sdf_term", counted_term)
    hyper = write_onet(tmp_path / "onet", random_params())
    calib = (300.0, 300.0, 79.5, 59.5, 5000.0)
    seq = dict(n_frames=4, h=120, w=160, corrugation=0.1, motion_scale=0.6)
    frames = list(SyntheticSequence(calib=Intrinsic(*calib), **seq))
    sys_ = _slam(hyper, frames, calib, chunked=False)
    assert "film_map" not in calls and "decode_grad_film" not in calls
    # the table's zero row, one a refresh that sees new latents, one a live
    # extract (the fusion frames mesh)
    live = sys_.mesher._n_extracts
    assert calls["new_latents"] >= 2 and live >= 1
    assert calls["cbn_condition"] == 1 + calls["new_latents"] + live
    assert calls["decode_grad_cbn"] == calls["sdf_terms"] > 0
    fwd = calls["decode_fwd_cbn"]
    sys_.mesher.extract(sys_.state, no_cache=True)
    assert calls["cbn_condition"] == 2 + calls["new_latents"] + live
    assert calls["decode_fwd_cbn"] - fwd == sys_.mesher.last_stats["decode_dispatches"]
    assert sys_.mesher.last_stats["decode_instance"] == "plain"


@pytest.mark.parametrize("what,want", [
    ("fwd", 2 * (3 * 256 + 7 * 256 * 256 + 2 * 256)),
    ("grad", 2 * (3 * 256 + 7 * 256 * 256 + 2 * 256) + 2 * (256 + 7 * 256 * 256 + 3 * 256)),
    ("cond", 2 * (256 * 256 + 2 * 256 * 256 + 256 * 2 * 8 * 256))])
def test_work_counts_at_the_published_widths(what, want):
    """By hand at latent_dim 256, hidden_dim 256, eight FiLM layers: the
    trunk forward 3 x 256, seven 256 x 256 products and two heads (920,064
    FLOP); the gradient back through the sdf head, the seven products and
    the first layer's xyz columns (919,552 more); the mapping 256 x 256,
    two 256 x 256 and 256 x 4,096 a code (2,490,368)."""
    hyper = hyper_of(PUBLISHED)
    fam = flops.decoders.load(hyper)
    got = {"fwd": flops.decoder_fwd_flops, "grad": flops.decoder_grad_flops,
           "cond": fam.cond_flops}[what](hyper)
    assert got == want
    assert {"fwd": 920_064, "grad": 1_839_616, "cond": 2_490_368}[what] == want
    assert fam.cond_row_floats(hyper) == 256 + 4096
