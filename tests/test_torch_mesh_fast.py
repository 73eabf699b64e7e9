"""The port's coarse-to-fine mesher (``core/meshing._eval_and_negate_fast``,
``MeshExtractor(fast=True)``, ``HashMeshExtractor(fast=True)``, ``mesh_tool
--fast``) against the JAX package on the CPU, with the in-repo prior.  The
refine set is compared first (it depends on tie order), then the decoded
volumes, then the meshes."""
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
import torch

from difusion_tpu.core import hash_map as JHM
from difusion_tpu.core import map as JM
from difusion_tpu.core import meshing as JMesh
from difusion_tpu.ops.sampling import get_samples as jax_get_samples
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch import mesh_tool
from difusion_tpu_torch.core import hash_map as HM
from difusion_tpu_torch.core import map as M
from difusion_tpu_torch.core import meshing as TMesh
from difusion_tpu_torch.data.production import mesh_error_stats
from difusion_tpu_torch.models.decoder import DecoderSpec
from difusion_tpu_torch.models.weights import from_jax_params
from difusion_tpu_torch.ops import decoder_fused as fused

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
CFG = dict(bound_min=(-2.0, -2.0, -0.5), n_xyz=(40, 40, 40), voxel_size=0.1,
           latent_dim=29, capacity=1 << 12, prune_min_vox_obs=4,
           ignore_count_th=1.0, encoder_count_th=600.0)
HASH = dict(voxel_size=0.1, latent_dim=29, capacity=1 << 12, table_size=1 << 14,
            prune_min_vox_obs=4, ignore_count_th=1.0, encoder_count_th=600.0)
MAX_STD = 0.15


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several workers at once: two threads each keep
    them from crowding the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prior():
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    t_dec, _ = from_jax_params(jax.tree.map(np.asarray, dec),
                               jax.tree.map(np.asarray, enc), DecoderSpec(*spec),
                               device="cpu")
    return dec, enc, spec, t_dec


def _surface(seed, n=8000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, n)
    y = rng.uniform(-0.5, 0.5, n)
    z = 2.0 + 0.1 * (np.sin(5 * x) + 0.7 * np.cos(4 * y))
    nrm = np.stack([0.5 * np.cos(5 * x), -0.28 * np.sin(4 * y), -np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (jnp.asarray(np.stack([x, y, z], 1).astype(np.float32)),
            jnp.asarray(nrm.astype(np.float32)), jnp.ones(n, bool))


@pytest.fixture(scope="module")
def dense(prior):
    """A JAX-fused dense map and the same state in the port."""
    _, enc, _, _ = prior
    jcfg = JM.MapConfig(**CFG)
    js = JM.integrate_keyframe(jcfg, enc, JM.create_map_state(jcfg), *_surface(0))
    ts = M.MapState(**{f: torch.from_numpy(np.array(getattr(js, f)))
                       for f in M.MapState._fields})
    return jcfg, js, M.MapConfig(**CFG), ts


def _jax_coarse_to_fine(dec, spec, latents, r):
    """The JAX ``_eval_and_negate_fast``'s interpolated (B, (2r)^3) sdf,
    built from the JAX package's own pieces as that function builds it."""
    B, L = latents.shape
    a, b = -(r // 2) * (1.0 / r), 1.0 + ((r - 1) // 2) * (1.0 / r)
    coarse = jax_get_samples(r, a=a, b=b) - 0.5
    lat = jnp.broadcast_to(latents[:, None, :], (B, r ** 3, L)).reshape(-1, L)
    xyz = jnp.broadcast_to(coarse[None], (B, r ** 3, 3)).reshape(-1, 3)
    sdf_c, _ = JMesh._decode_lattice(dec, spec, lat, xyz, False)
    m = JMesh._align_corners_matrix(2 * r, r)
    vol = jnp.einsum("xa,Bayz->Bxyz", m, sdf_c.reshape(B, r, r, r))
    vol = jnp.einsum("yb,Bxbz->Bxyz", m, vol)
    return jnp.einsum("zc,Bxyc->Bxyz", m, vol).reshape(B, -1)


@pytest.mark.parametrize("case", ["all_equal", "signed_pairs", "quantized", "zeros_mixed"])
def test_refine_sites_tie_rule_matches_jax_top_k(case):
    """With ties in |sdf| the refine set is the one ``jax.lax.top_k`` picks
    (the lower site index first among equal values), in its order."""
    rng = np.random.default_rng({"all_equal": 0, "signed_pairs": 1, "quantized": 2,
                                 "zeros_mixed": 3}[case])
    shape = (6, 512)
    if case == "all_equal":
        x = np.full(shape, 0.25, np.float32)
    elif case == "signed_pairs":
        x = rng.choice([-0.1, 0.1, -0.2, 0.2, 0.05, -0.05], size=shape).astype(np.float32)
    elif case == "quantized":
        x = (np.round(rng.normal(0, 0.1, shape) * 50) / 50).astype(np.float32)
    else:
        x = np.where(rng.random(shape) < 0.3, 0.0, rng.normal(0, 0.1, shape)).astype(np.float32)
        x[:, ::7] = -0.0
    k = 102
    _, ref = jax.lax.top_k(-jnp.abs(jnp.asarray(x)), k)
    got = TMesh._refine_sites(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("r", [3, 4])
def test_eval_and_negate_fast_matches_jax(prior, dense, r):
    """On 64 fused blocks: the interpolated sdf to 1e-5, then the refine
    set equal to the JAX package's in every block without a near-tie at
    the set's edge (the two packages' |sdf| differ by f32 rounding), then
    the returned sdf and std within 1e-5."""
    dec, _, spec, t_dec = prior
    _, js, _, ts = dense
    slots = np.nonzero(np.asarray(js.obs_count) > 0)[0][:64]
    assert len(slots) == 64
    k = max(int(0.2 * (2 * r) ** 3), 8)
    lat_j = jnp.asarray(js.latents)[jnp.asarray(slots)]
    sdf_fj = np.asarray(_jax_coarse_to_fine(dec, spec, lat_j, r))
    packed = fused.pack_fused_decoder(t_dec)
    sdf_ft, _ = TMesh._coarse_to_fine(t_dec, packed, ts.latents[torch.from_numpy(slots)], r)
    np.testing.assert_allclose(sdf_ft.numpy(), sdf_fj, atol=1e-5)
    # a block whose k-th and (k+1)-th smallest |sdf| lie further apart than
    # the two packages' largest difference has one refine set in both; in
    # another block the sets may swap only sites within that margin
    margin = 2 * np.abs(sdf_ft.numpy() - sdf_fj).max()
    a = np.sort(np.abs(sdf_fj), axis=1)
    clear = a[:, k] - a[:, k - 1] > margin
    assert clear.mean() > 0.9
    _, idx_j = jax.lax.top_k(-jnp.abs(jnp.asarray(sdf_fj)), k)
    idx_t = TMesh._refine_sites(sdf_ft, k).numpy()
    for b, (row_t, row_j) in enumerate(zip(idx_t, np.asarray(idx_j))):
        swapped = set(row_t.tolist()) ^ set(row_j.tolist())
        assert not swapped if clear[b] else all(
            abs(abs(sdf_fj[b, i]) - a[b, k - 1]) <= margin for i in swapped)

    cs_j, ct_j = JMesh._eval_and_negate_fast(dec, spec, js.latents, jnp.asarray(slots),
                                             r, k, fused=False)
    cs_t, ct_t = TMesh._eval_and_negate_fast(t_dec, packed, ts.latents,
                                             torch.from_numpy(slots), r, k)
    np.testing.assert_allclose(cs_t.numpy(), np.asarray(cs_j), atol=1e-5)
    np.testing.assert_allclose(ct_t.numpy(), np.asarray(ct_j), atol=1e-5)
    # refined sites hold exact decodes: they differ from the interpolation
    assert (cs_t.reshape(64, -1).numpy() != -sdf_ft.numpy()).sum() > 0


def test_fast_extract_matches_jax_and_dense(prior, dense):
    """A fast r = 6 extract of the same map in both packages: triangle counts
    within 0.5% and the meshes within 1e-3 m of each other in the 95th
    percentile of their distance to the analytic surface; the decoder
    evaluations cut >= 3x against the dense extract, whose surface the fast
    one follows (p95 within 2e-3 m)."""
    dec, _, spec, t_dec = prior
    jcfg, js, tcfg, ts = dense
    r = 6
    jfast = JMesh.MeshExtractor(jcfg, dec, spec, voxel_resolution=r, fast=True,
                                max_triangles=1 << 19)
    jfast.extract(js, max_std=MAX_STD)
    tfast = TMesh.MeshExtractor(tcfg, t_dec, voxel_resolution=r, fast=True,
                                max_triangles=1 << 19)
    tfast.extract(ts, max_std=MAX_STD)
    tdense = TMesh.MeshExtractor(tcfg, t_dec, voxel_resolution=r, max_triangles=1 << 19)
    tdense.extract(ts, max_std=MAX_STD)
    assert tfast.refine_k == jfast.refine_k == 345
    assert tdense.last_stats["decoder_evals"] / tfast.last_stats["decoder_evals"] >= 3.0
    (tt, _), (jt, _), (td, _) = tfast.triangles(), jfast.triangles(), tdense.triangles()
    assert len(jt) > 1000 and abs(len(tt) - len(jt)) <= 0.005 * len(jt)
    e_t, e_j, e_d = (mesh_error_stats(x)["mesh_err_p95"] for x in (tt, jt, td))
    assert abs(e_t - e_j) < 1e-3 and abs(e_t - e_d) < 2e-3 and e_t < 0.02


def test_hash_fast_extract_and_mesh_tool(prior, tmp_path):
    """``HashMeshExtractor(fast=True)`` on a JAX hash snapshot against the
    JAX package's fast extract (counts within 0.5%, the same surface), and
    ``mesh_tool --fast`` on that snapshot gives the extractor's triangles
    with the tool's own prior."""
    dec, enc, spec, t_dec = prior
    jcfg = JHM.HashMapConfig(**HASH)
    js = JHM.integrate_keyframe(jcfg, enc, JHM.create_hash_map_state(jcfg), *_surface(1))
    JHM.save_map(str(tmp_path / "h.npz"), jcfg, js)
    ref = JMesh.HashMeshExtractor(jcfg, dec, spec, voxel_resolution=4, fast=True,
                                  max_triangles=1 << 19)
    ref.extract(js, max_std=MAX_STD, no_cache=True)
    tool = mesh_tool.main([str(tmp_path / "h.npz"), str(tmp_path / "h.ply"), "--hyper",
                           str(HYPER), "--resolution", "4", "--max-std", str(MAX_STD),
                           "--fast", "--device", "cpu"])
    assert isinstance(tool, TMesh.HashMeshExtractor) and tool.fast
    _, ts = HM.load_map(tmp_path / "h.npz", device="cpu")
    mine = TMesh.HashMeshExtractor(HM.HashMapConfig(**HASH), tool.decoder, voxel_resolution=4,
                                   fast=True, max_triangles=1 << 19)
    mine.extract(ts, max_std=MAX_STD, no_cache=True)
    np.testing.assert_array_equal(tool.triangles()[0], mine.triangles()[0])
    tt, jt = mine.triangles()[0], ref.triangles()[0]
    assert len(jt) > 500 and abs(len(tt) - len(jt)) <= 0.005 * len(jt)
    e_t, e_j = (mesh_error_stats(x)["mesh_err_p95"] for x in (tt, jt))
    assert abs(e_t - e_j) < 1e-3 and e_t < 0.02
