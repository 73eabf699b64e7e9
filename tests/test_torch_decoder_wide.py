"""The wide instances' route on the CPU (their plain versions), held to the
benchmark's plain reference (``benchmark/reference/prior.py``) and to the
JAX package's decoder, and that
reference held to DeepSDF's equations (Park et al., CVPR 2019,
arXiv:1901.05103: ``specs.json``'s 8 hidden layers, the input fed again
before layer 4, weight norm, a final tanh), at a small width of DeepSDF's
shape: code 32, 8 x 64, latent_in [4], the std head of DI-Fusion's
di_decoder on the last hidden layer.  The prior is seeded and written to a
temporary directory as a trained one is (``hyper.json``, ``prior_1.npz``)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from benchmark.reference.prior import Prior
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import meshing
from difusion_tpu_torch.core import tracker as T
from difusion_tpu_torch.core.meshing import MeshExtractor
from difusion_tpu_torch.models.decoder import DecoderSpec, init_decoder_params
from difusion_tpu_torch.models.encoder import EncoderSpec, init_encoder_params
from difusion_tpu_torch.models.weights import load_prior, save_params_npz
from difusion_tpu_torch.ops import decoder_fused as fused
from difusion_tpu_torch.ops.se3 import Pose, exp_twist

ROOT = Path(__file__).resolve().parents[1]
L, H, D, J = 32, 64, 8, 4

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def prior_dir(tmp_path_factory):
    """DeepSDF's recipe (configs/train-deepsdf-mixed.yaml) at code 32 and
    width 64, seeded weights; the sdf head's bias moved so that half the
    sdf values of the test's inputs fall on either side of 0 (a mesh needs
    a surface)."""
    hyper = yaml.safe_load((ROOT / "configs/train-deepsdf-mixed.yaml").read_text())
    hyper["code_length"] = L
    hyper["network_specs"]["dims"] = [H] * D
    spec = DecoderSpec.from_hyper(hyper)
    g = torch.Generator().manual_seed(20)
    dec = init_decoder_params(spec, g)
    enc = init_encoder_params(EncoderSpec.from_hyper(hyper), g)
    out = tmp_path_factory.mktemp("deepsdf_small")
    save_params_npz(out / "prior_1.npz", decoder=dec, encoder=enc)
    (out / "hyper.json").write_text(json.dumps(hyper))
    ref = Prior(out / "hyper.json", 1, "cpu")
    lat, xyz = _inputs(4096, 1)
    with torch.no_grad():
        sdf, _ = ref.decode(lat, xyz)
    dec["layers"][D]["b"] = dec["layers"][D]["b"] - np.float32(
        torch.atanh(sdf.clamp(-0.999, 0.999)).median())
    save_params_npz(out / "prior_1.npz", decoder=dec, encoder=enc)
    return out


def _inputs(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, L, generator=g) * 0.3, torch.rand(n, 3, generator=g) * 1.75 - 1.0


@pytest.fixture(scope="module")
def port(prior_dir):
    dec, _, spec = load_prior(prior_dir / "hyper.json", 1, device="cpu")
    return dec, fused.pack_fused_decoder(dec)


def test_reference_follows_deepsdf_equations(prior_dir):
    """The reference's decoder against DeepSDF's forward written out here in
    float64 from the raw weight-normed arrays: W_i = g_i v_i / ||v_i|| by
    rows; x = [z | p]; h_0 = relu(W_0 x + b_0), h_1, h_2; layer 3 narrowed
    to 64 - 35 = 29 outputs; h_4 = relu(W_4 [h_3 | x] + b_4), 64 inputs;
    h_5 .. h_7; sdf = tanh(W_8 h_7 + b_8); std = 0.05 + 0.5 softplus(u h_7 +
    c).  atol 2e-6: the reference sums in float32."""
    with np.load(prior_dir / "prior_1.npz") as w:
        W = [w[f"decoder.layers#{i}.g"].astype(np.float64)[:, None]
             * w[f"decoder.layers#{i}.v"] / np.linalg.norm(
                 w[f"decoder.layers#{i}.v"].astype(np.float64), axis=1, keepdims=True)
             for i in range(D)]
        W.append(w[f"decoder.layers#{D}.w"].astype(np.float64)
                 if f"decoder.layers#{D}.w" in w else
                 w[f"decoder.layers#{D}.g"].astype(np.float64)[:, None]
                 * w[f"decoder.layers#{D}.v"] / np.linalg.norm(
                     w[f"decoder.layers#{D}.v"].astype(np.float64), axis=1, keepdims=True))
        b = [w[f"decoder.layers#{i}.b"].astype(np.float64) for i in range(D + 1)]
        u, c = (w["decoder.uncertainty.w"].astype(np.float64),
                w["decoder.uncertainty.b"].astype(np.float64))
    assert [m.shape for m in W] == ([(H, L + 3), (H, H), (H, H), (H - L - 3, H), (H, H)]
                                    + [(H, H)] * 3 + [(1, H)])
    lat, xyz = _inputs(512, 2)
    x = np.concatenate([lat.numpy(), xyz.numpy()], axis=1).astype(np.float64)
    relu = lambda a: np.maximum(a, 0.0)  # noqa: E731
    h = x
    for i in range(D):
        h = relu((np.concatenate([h, x], axis=1) if i == 4 else h) @ W[i].T + b[i])
    sdf = np.tanh(h @ W[D].T + b[D])[:, 0]
    std = 0.05 + 0.5 * np.logaddexp(0.0, h @ u.T + c)[:, 0]
    ref = Prior(prior_dir / "hyper.json", 1, "cpu")
    got = ref.decode(lat, xyz)
    np.testing.assert_allclose(got[0].numpy(), sdf, atol=2e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), std, atol=2e-6, rtol=0)
    assert (sdf > 0).mean() > 0.2 and (sdf < 0).mean() > 0.2


def test_wide_plain_versions_match_the_reference(prior_dir, port):
    """decode_fused / decode_grad_fused on CPU tensors (the wide route's
    plain versions over the padded pack) against the reference decoder and
    autograd through it: f32 both, sums in another order, atol 2e-6; the
    gradient 1e-5 of its largest entry."""
    dec, packed = port
    assert fused.wide_layout(dec.spec) == (L, H, D, J)
    ref = Prior(prior_dir / "hyper.json", 1, "cpu")
    lat, xyz = _inputs(777, 3)
    sdf, std = fused.decode_fused(packed, lat, xyz)
    x = xyz.clone().requires_grad_(True)
    r_sdf, r_std = ref.decode(lat, x)
    r_grad, = torch.autograd.grad(r_sdf.sum(), x)
    torch.testing.assert_close(sdf, r_sdf.detach(), atol=2e-6, rtol=0)
    torch.testing.assert_close(std, r_std.detach(), atol=2e-6, rtol=0)
    g_sdf, g_std, grad = fused.decode_grad_fused(packed, lat, xyz)
    assert torch.equal(g_sdf, sdf) and torch.equal(g_std, std)
    torch.testing.assert_close(grad, r_grad, atol=1e-5 * float(r_grad.abs().max()), rtol=0)
    assert not bool(fused.grad_rows_off(grad, packed, lat, xyz).any())


def test_wide_plain_versions_match_jax(prior_dir, port):
    """The same plain versions against the JAX package on the same prior
    (its ``load_prior`` reads the same ``prior_1.npz``): ``decode`` for sdf
    and std, ``jax.vjp`` of the sdf w.r.t. xyz with the latent held fixed
    (the GN SDF term's gradient); the tolerances of the reference test
    above."""
    import jax
    import jax.numpy as jnp

    from difusion_tpu.models.decoder import decode as jax_decode
    from difusion_tpu.slam import load_prior as jax_load_prior

    _, packed = port
    jdec, _, jspec = jax_load_prior(str(prior_dir / "hyper.json"), 1)
    lat, xyz = _inputs(777, 4)
    jl, jx = jnp.asarray(lat.numpy()), jnp.asarray(xyz.numpy())
    j_sdf, vjp_fn = jax.vjp(lambda x: jax_decode(jdec, jspec, jl, x)[0], jx)
    (j_grad,) = vjp_fn(jnp.ones_like(j_sdf))
    j_std = jax_decode(jdec, jspec, jl, jx)[1]
    j_sdf, j_std, j_grad = (torch.from_numpy(np.asarray(a)) for a in (j_sdf, j_std, j_grad))
    sdf, std = fused.decode_fused(packed, lat, xyz)
    torch.testing.assert_close(sdf, j_sdf, atol=2e-6, rtol=0)
    torch.testing.assert_close(std, j_std, atol=2e-6, rtol=0)
    g_sdf, g_std, grad = fused.decode_grad_fused(packed, lat, xyz)
    torch.testing.assert_close(g_sdf, j_sdf, atol=2e-6, rtol=0)
    torch.testing.assert_close(g_std, j_std, atol=2e-6, rtol=0)
    torch.testing.assert_close(grad, j_grad, atol=1e-5 * float(j_grad.abs().max()), rtol=0)
    assert (j_sdf > 0).float().mean() > 0.2 and (j_sdf < 0).float().mean() > 0.2


def _map(seed=0):
    """A dense map whose allocated slots hold code-32 latents with converged
    counts."""
    cfg = M.MapConfig(bound_min=(-1.0, -1.0, -1.0), n_xyz=(20, 20, 20), voxel_size=0.1,
                      latent_dim=L, capacity=1 << 12, prune_min_vox_obs=4,
                      ignore_count_th=2.0, encoder_count_th=600.0)
    rng = np.random.default_rng(seed)
    n_slots = 1500
    cells = rng.choice(int(np.prod(cfg.n_xyz)), size=n_slots, replace=False)
    state = M.create_map_state(cfg, "cpu")
    indexer = torch.full_like(state.indexer, -1)
    indexer[torch.from_numpy(cells)] = torch.arange(n_slots, dtype=indexer.dtype)
    positions = torch.full_like(state.positions, -1)
    positions[:n_slots] = torch.from_numpy(cells).to(positions.dtype)
    latents = torch.zeros_like(state.latents)
    latents[:n_slots] = torch.from_numpy(rng.normal(0, 0.3, (n_slots, L)).astype(np.float32))
    counts = torch.zeros_like(state.obs_count)
    counts[:n_slots] = 100.0
    state = state._replace(indexer=indexer, positions=positions, latents=latents,
                           obs_count=counts, n_occupied=torch.tensor(n_slots, dtype=torch.int32),
                           mesh_dirty=torch.ones_like(state.mesh_dirty))
    return cfg, state, cells


class _RefDecoder:
    """The reference's decoder where the SDF term's autograd route calls
    ``decoder.decode``."""

    def __init__(self, prior):
        self.prior = prior

    def decode(self, latent, xyz, compute_dtype=torch.float32):
        return self.prior.decode(latent, xyz)


def test_sdf_term_through_the_wide_pack_matches_the_reference(prior_dir, port):
    """The GN SDF term (H, g, E) through the wide pack (the fused route,
    as ``sdf_fused`` "on" takes it) against its autograd route driven by
    the reference decoder: 1e-5 of each output's largest entry (f32 both; r
    = sdf/std and G = grad/(std voxel) amplify the decoders' 1e-7-level
    differences)."""
    dec, packed = port
    cfg, state, cells = _map()
    rng = np.random.default_rng(5)
    cell_xyz = np.stack(np.unravel_index(cells[:512], cfg.n_xyz), axis=1)
    pts = ((cell_xyz + rng.uniform(0.1, 0.9, (512, 3))) * cfg.voxel_size
           + np.asarray(cfg.bound_min)).astype(np.float32)
    mask = torch.from_numpy(rng.uniform(size=512) > 0.1)
    last = exp_twist(torch.from_numpy(rng.normal(0, 0.05, 6).astype(np.float32)))
    pts_cam = (torch.from_numpy(pts) - last.t) @ last.R
    delta = exp_twist(torch.from_numpy(rng.normal(0, 0.005, 6).astype(np.float32)))
    aug = M.latent_count_table(state)
    got = T._sdf_term(cfg, packed, state, Pose(last.R, last.t), delta, pts_cam, mask,
                      "huber", 5.0, aug)
    ref = T._sdf_term(cfg, None, state, Pose(last.R, last.t), delta, pts_cam, mask,
                      "huber", 5.0, aug,
                      decoder=_RefDecoder(Prior(prior_dir / "hyper.json", 1, "cpu")))
    assert float(got[2]) > 0
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5 * float(r.abs().max()), rtol=0)


def test_mesh_extract_through_the_wide_pack_matches_the_reference(prior_dir, port,
                                                                  monkeypatch):
    """One full extract (r = 2) through the wide pack against the same
    extract whose lattice decode is the reference's: the same triangles,
    vertices within 1e-5 (f32 both)."""
    dec, _ = port
    cfg, state, _ = _map(1)
    mesher = MeshExtractor(cfg, dec, voxel_resolution=2)
    assert mesher.packed is not None and mesher.packed.numel() == fused.WideLayout(L, H, D, J).size
    mesher.extract(state, max_std=2000.0, no_cache=True)
    got = mesher.triangles()[0]
    assert mesher.last_stats["decode_instance"] == "plain" and len(got) > 100
    ref_prior = Prior(prior_dir / "hyper.json", 1, "cpu")
    monkeypatch.setattr(meshing, "_decode_lattice",
                        lambda decoder, packed, lat, xyz: ref_prior.decode(lat, xyz))
    ref_mesher = MeshExtractor(cfg, dec, voxel_resolution=2)
    ref_mesher.extract(state, max_std=2000.0, no_cache=True)
    ref = ref_mesher.triangles()[0]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_wide_pack_layout(port):
    """The pack's segments: W_l^T zero-padded (layer 3's 29 outputs to 64,
    the input's 35 columns to 40, layer 4's input [h_3 | x] at rows 0 and
    64), the xyz columns, the meta head that names the layout, the f32
    fragments in mma order; the layout read again from that head; the
    published widths' size, which csrc/decoder_wide.cu's PACKED must give."""
    dec, packed = port
    lay = fused.WideLayout(L, H, D, J)
    assert (lay.K0, lay.NJ, lay.K(0), lay.K(J), lay.N(J - 1), lay.HK(J)) == (40, 64, 40, 104,
                                                                            64, 64)
    p = fused.unpack_wide(packed, lay)
    w = [lin.weight for lin in dec.layers]
    assert torch.equal(p["f0"][:L + 3], w[0].T) and not p["f0"][L + 3:].any()
    assert torch.equal(p["f3"][:, :H - L - 3], w[3].T) and not p["f3"][:, H - L - 3:].any()
    assert not p["b3"][H - L - 3:].any()
    assert torch.equal(p["f4"][:H - L - 3], w[4][:, :H - L - 3].T)
    assert not p["f4"][H - L - 3:lay.NJ].any()
    assert torch.equal(p["f4"][lay.NJ:lay.NJ + L + 3], w[4][:, H - L - 3:].T)
    assert torch.equal(p["w0_xyz"], w[0][:, L:]) and torch.equal(p["wJ_xyz"], w[4][:, -3:])
    assert packed[:4].tolist() == p["meta"].tolist() == [L, H, D, J]
    frag = p["frag"][:lay.K(0) * lay.N(0)].view(lay.K(0) // 8, lay.N(0) // 8, 8, 4, 2)
    kt, nt, g, t, e = 3, 5, 6, 1, 1
    assert frag[kt, nt, g, t, e] == p["f0"][8 * kt + 2 * t + e, 8 * nt + g]
    assert fused._wide_of(packed, L) == lay and fused._wide_of(packed, L + 1) is None
    assert fused.WideLayout(256, 512, 8, 4).size == 5267208
    assert fused.instance_name(packed, L, "cpu") == "plain"
    assert fused.supports_spec(dec.spec) and not fused.supports_spec(dec.spec, "cuda")
    deepsdf = DecoderSpec(latent_size=256, dims=(512,) * 8, latent_in=(4,))
    assert fused.supports_spec(deepsdf, "cuda") and fused.wide_layout(deepsdf) in [
        fused.WideLayout(*i) for i in fused.WIDE_INSTANCES]
    with pytest.raises(ValueError):
        fused.pack_fused_decoder(dec, torch.bfloat16)

