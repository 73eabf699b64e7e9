"""The port's LIF sample generator against the JAX package on the CPU, at a
small size (a sphere mesh, 2,000 candidates, a 64x64 z-buffer, 20 cameras,
5,000 queries): mesh I/O and primitives, triangle sampling, the z-buffer
visibility, the 11-vote SDF with its tie order, the reference methods,
the three providers and run_generation, and the generator's CLI.  The
numpy draws are the same in both packages (one seed)."""
import json
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp
import torch

from difusion_tpu.config import dict_to_args
from difusion_tpu.sampler import generator as JG
from difusion_tpu.sampler import mesh_io as jmesh_io
from difusion_tpu.sampler import sampler as JSM
from difusion_tpu.utils.motion import Isometry as JIsometry
from difusion_tpu.utils.motion import Quaternion as JQuaternion
from difusion_tpu_torch.sampler import generator as G
from difusion_tpu_torch.sampler import mesh_io
from difusion_tpu_torch.sampler import sampler as SM
from difusion_tpu_torch.train import lif_dataset as ldata
from difusion_tpu_torch.utils.motion import Isometry, Quaternion

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several workers at once: two threads each keep
    them from crowding the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cams(n=20, dist=1.5):
    return [Isometry.look_at(p * dist, np.zeros(3))
            for p in SM.equidist_points_on_sphere(n)]


def _world_to_cam(cams):
    R = np.stack([c.inv().q.rotation_matrix for c in cams]).astype(np.float32)
    t = np.stack([c.inv().t for c in cams]).astype(np.float32)
    return R, t


def test_motion_random_and_look_at():
    """Quaternion.random, Isometry.random (same draws) and look_at equal the
    JAX package's numpy versions bit for bit."""
    for seed in range(5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(Quaternion.random(a).q, JQuaternion.random(b).q)
        np.testing.assert_array_equal(Isometry.random(a).matrix, JIsometry.random(b).matrix)
    for src, up in (([1.0, 2.0, 3.0], None), ([0.0, 2.0, 0.0], None),
                    ([0.5, -1.0, 0.2], [0.0, 0.0, 1.0])):
        p = Isometry.look_at(np.array(src), np.zeros(3), None if up is None else np.array(up))
        q = JIsometry.look_at(np.array(src), np.zeros(3), None if up is None else np.array(up))
        np.testing.assert_array_equal(p.matrix, q.matrix)
        # +z points at the target
        np.testing.assert_allclose(p.q.rotation_matrix[:, 2],
                                   -np.array(src) / np.linalg.norm(src), atol=1e-12)


def test_mesh_io_primitives_and_files(tmp_path):
    for make, args in ((mesh_io.make_box, (1.0, 0.8, 1.2)), (mesh_io.make_sphere, (0.5, 16)),
                       (mesh_io.make_cylinder, (0.4, 1.0, 24))):
        m, j = make(*args), getattr(jmesh_io, make.__name__)(*args)
        np.testing.assert_array_equal(m.vertices, j.vertices)
        np.testing.assert_array_equal(m.faces, j.faces)
        np.testing.assert_array_equal(m.face_normals(), j.face_normals())
        np.testing.assert_array_equal(m.face_areas(), j.face_areas())
    box = mesh_io.make_box()
    mesh_io.save_obj(str(tmp_path / "m.obj"), box)
    back = mesh_io.load_mesh(str(tmp_path / "m.obj"))
    np.testing.assert_allclose(back.vertices, box.vertices)
    np.testing.assert_array_equal(back.faces, box.faces)
    (tmp_path / "q.off").write_text("OFF\n4 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    quad = mesh_io.load_mesh(str(tmp_path / "q.off"))
    np.testing.assert_array_equal(quad.faces, [[0, 1, 2], [0, 2, 3]])


def test_sample_on_triangles_bit_equal():
    mesh = mesh_io.make_sphere(0.5, 20)
    a, ta = SM.sample_on_triangles(mesh, 3000, np.random.default_rng(0))
    b, tb = JSM.sample_on_triangles(jmesh_io.make_sphere(0.5, 20), 3000,
                                    np.random.default_rng(0))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta, tb)


def test_visibility_mask_matches_jax():
    """The z-buffer pass's mask on >= 99.9% of 2,000 candidates (the JAX
    package's jitted projection may round a pixel coordinate differently),
    20 cameras in batches of 7 against the JAX package's one batch; the
    sampler's harvest of two nested spheres is the outer one's, as much as
    the JAX package's is."""
    outer, inner = mesh_io.make_sphere(0.5, 24), mesh_io.make_sphere(0.2, 16)
    mesh = mesh_io.TriMesh(np.concatenate([outer.vertices, inner.vertices]),
                           np.concatenate([outer.faces, inner.faces + len(outer.vertices)]
                                          ).astype(np.int32))
    pts, _ = SM.sample_on_triangles(mesh, 2000, np.random.default_rng(1))
    cams = _cams(20)
    R, t = _world_to_cam(cams)
    j = np.asarray(JSM._visible_pass(jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t),
                                     jnp.full((20,), 0.8, jnp.float32), 64))
    p = torch.zeros(2000, dtype=torch.bool)
    for s in range(0, 20, 7):
        p |= SM._visible_pass(torch.from_numpy(pts), torch.from_numpy(R[s:s + 7]),
                              torch.from_numpy(t[s:s + 7]), 0.8, 64)
    p = p.numpy()
    assert (p == j).mean() >= 0.999, (p != j).sum()
    assert 300 < j.sum() < 1900
    vis, nrm = SM.visible_surface_samples(mesh, cams, 0.8, 2000, np.random.default_rng(1),
                                          res=64, cam_batch=7, device="cpu")
    jvis, _ = JSM.visible_surface_samples(mesh, cams, 0.8, 2000, np.random.default_rng(1),
                                          res=64)
    assert abs(len(vis) - len(jvis)) <= 2
    # at this z-buffer size a few inner points get through, in both packages
    outer_t = (np.linalg.norm(vis, axis=1) > 0.4).mean()
    assert outer_t > 0.97 and abs(outer_t - (np.linalg.norm(jvis, axis=1) > 0.4).mean()) < 2e-3
    assert (np.sum(nrm * vis, axis=1) > 0).mean() > 0.97


def _lex_reference(d2, k):
    """The k smallest of each row by (value, index), by numpy's lexsort."""
    order = np.stack([np.lexsort((np.arange(d2.shape[1]), row)) for row in d2])[:, :k]
    return np.take_along_axis(d2, order, 1), order


def test_smallest_resolves_ties_to_the_lowest_index():
    """_smallest on rows full of equal values (more ties at the k-th rank
    than its 2k candidates hold) gives numpy's lexicographic order."""
    rng = np.random.default_rng(3)
    d2 = rng.integers(0, 6, (64, 300)).astype(np.float32)
    d2[:8] = 1.0                                  # every entry tied
    d2[8:16, :40] = 0.5                           # 40 ties before the rest
    for k in (1, 11, 25):
        v, i = SM._smallest(torch.from_numpy(d2), k)
        rv, ri = _lex_reference(d2, k)
        np.testing.assert_array_equal(v.numpy(), rv)
        np.testing.assert_array_equal(i.numpy(), ri)


@pytest.fixture(scope="module")
def surface_cloud():
    """The visible cloud of a sphere (2,000 candidates, 20 cameras, z-buffer
    64) and 5,000 queries drawn as generate_mesh_samples draws them."""
    mesh = mesh_io.make_sphere(0.5, 24)
    rng = np.random.default_rng(2)
    xyz, nrm = SM.visible_surface_samples(mesh, _cams(20), 0.8, 2000, rng, res=64,
                                          device="cpu")
    base, _ = SM.sample_on_triangles(mesh, 2000, rng)
    q = np.concatenate([base + rng.standard_normal((2000, 3)).astype(np.float32) * 0.07,
                        base + rng.standard_normal((2000, 3)).astype(np.float32) * 0.03,
                        rng.uniform(-0.6, 0.6, (1000, 3)).astype(np.float32)])
    return xyz, nrm, q


def _gap_ok(q, ref, k=11, gap=1e-6):
    """Queries whose k-th and (k+1)-th squared distances (f64) differ by
    more than ``gap``: where f32 rounding cannot swap the last voter."""
    d2 = ((q[:, None, :].astype(np.float64) - ref[None].astype(np.float64)) ** 2).sum(-1)
    part = np.sort(d2, axis=1)[:, k - 1:k + 1]
    return (part[:, 1] - part[:, 0]) > gap


@pytest.mark.parametrize("tile", [None, 256], ids=["one_tile", "tiles_of_256"])
def test_compute_sdf_matches_jax(surface_cloud, monkeypatch, tile):
    """The same NaN set and values within 1e-5 on every query whose 11th and
    12th distances differ by more than 1e-6; also when the cloud goes
    through several tiles (the running top-11 and its merge)."""
    xyz, nrm, q = surface_cloud
    j = JSM.compute_sdf(q, xyz, nrm, stdv=np.sqrt(0.005))
    if tile is not None:
        monkeypatch.setattr(SM, "REF_TILE", tile)
    t = SM.compute_sdf(q, xyz, nrm, stdv=np.sqrt(0.005), chunk=1024, device="cpu")
    ok = _gap_ok(q, xyz)
    assert ok.mean() > 0.98
    np.testing.assert_array_equal(np.isnan(t)[ok], np.isnan(j)[ok])
    fin = ok & ~np.isnan(j)
    assert fin.sum() > 3000 and np.isnan(j).sum() > 0
    np.testing.assert_allclose(t[fin], j[fin], atol=1e-5)
    # the cloud given twice: every distance is tied with its copy's, which
    # the lower index (the first copy) wins; the 11 votes are then 6 points,
    # so hold the queries whose 6th and 7th distances are apart
    xyz2, nrm2 = np.concatenate([xyz, xyz]), np.concatenate([nrm, nrm])
    t2 = SM.compute_sdf(q[:1000], xyz2, nrm2, stdv=np.sqrt(0.005), chunk=512, device="cpu")
    j2 = JSM.compute_sdf(q[:1000], xyz2, nrm2, stdv=np.sqrt(0.005))
    ok2 = _gap_ok(q[:1000], xyz, k=6)
    np.testing.assert_array_equal(np.isnan(t2)[ok2], np.isnan(j2)[ok2])
    fin2 = ok2 & ~np.isnan(j2)
    np.testing.assert_allclose(t2[fin2], j2[fin2], atol=1e-5)


def test_reference_methods_match_jax():
    """generate_mesh_samples under reference methods 1-3, same seed: the
    same surface clouds (2, 3) and the same sdf rows within 1e-5, allowing
    the few rows a near-tie can flip."""
    mesh = mesh_io.make_sphere(0.5, 24)
    cams = _cams(20)
    ext_xyz, ext_tri = SM.sample_on_triangles(mesh, 1500, np.random.default_rng(9))
    ext = np.concatenate([ext_xyz, mesh.face_normals()[ext_tri]], axis=1)
    for method in (1, 2, 3):
        cfg_t = SM.SamplerConfig(reference_method=method, num_sample=5000,
                                 n_surface_candidates=2000, zbuffer_res=64)
        cfg_j = JSM.SamplerConfig(*cfg_t)
        dt, st = SM.generate_mesh_samples(mesh, cams, 0.8, cfg_t, np.random.default_rng(4),
                                          reference_points=ext, device="cpu")
        dj, sj = JSM.generate_mesh_samples(mesh, cams, 0.8, cfg_j, np.random.default_rng(4),
                                           reference_points=ext)
        if method > 1:
            np.testing.assert_array_equal(st, sj)
        assert abs(len(dt) - len(dj)) <= 0.002 * len(dj)
        rows_j = {tuple(r[:3]): r[3] for r in dj}
        common = [(r[3], rows_j[tuple(r[:3])]) for r in dt if tuple(r[:3]) in rows_j]
        assert len(common) >= 0.995 * len(dj)
        a, b = np.array(common).T
        assert (np.abs(a - b) <= 1e-5).mean() >= 0.995
    with pytest.raises(ValueError):
        SM.generate_mesh_samples(mesh, cams, 0.8, SM.SamplerConfig(reference_method=3),
                                 np.random.default_rng(0), device="cpu")


def _payloads(path):
    out = []
    for f in sorted((path / "payload").glob("*.npz")):
        with np.load(f) as z:
            out.append({k: z[k] for k in z.files})
    return out


@pytest.mark.parametrize("provider,kwargs", [
    ("simple_shape", dict(n_shapes=1, seed=0)),
    ("height_field", dict(n_shapes=1, seed=1, grid=24)),
], ids=["simple_shape", "height_field"])
def test_run_generation_matches_jax(tmp_path, provider, kwargs):
    """run_generation on one small shape: the same source.json and LIF
    count, every payload within 1e-5."""
    cfg = dict(provider=provider, provider_kwargs=kwargs, sampler_count=5000,
               sampler_var=0.005, voxel_size=0.3, nn_size=2.0, seed=4)
    small = SM.SamplerConfig(num_sample=5000, n_surface_candidates=2000, zbuffer_res=64)
    n_t = G.run_generation(dict_to_args(dict(cfg, output=str(tmp_path / "t"))), small,
                           device="cpu")
    n_j = JG.run_generation(dict_to_args(dict(cfg, output=str(tmp_path / "j"))),
                            JSM.SamplerConfig(*small))
    assert n_t == n_j > 0
    assert (json.loads((tmp_path / "t" / "source.json").read_text())
            == json.loads((tmp_path / "j" / "source.json").read_text()))
    for pt, pj in zip(_payloads(tmp_path / "t"), _payloads(tmp_path / "j")):
        assert set(pt) == set(pj) == {"min", "max", "data", "surface"}
        for k in pt:
            assert pt[k].shape == pj[k].shape, k
            np.testing.assert_allclose(pt[k], pj[k], atol=1e-5, err_msg=k)
    ds = ldata.LifDataset(str(tmp_path / "t"), num_sample=64, num_surface_sample=32)
    s, f = ds[0]
    assert s.shape == (64, 4) and f.shape == (32, 6)


def test_providers_match_jax(tmp_path):
    """The three providers build the JAX package's meshes and cameras;
    ShapeNetGenerator over a mock ShapeNetCore.v2 tree of make_box /
    make_sphere meshes (ShapeNet is not in the repository)."""
    for cls, kw in ((G.SimpleShapeGenerator, dict(n_shapes=4, seed=3)),
                    (G.HeightFieldGenerator, dict(n_shapes=2, seed=2, grid=12))):
        a, b = cls(**kw), getattr(JG, cls.__name__)(**kw)
        for i in range(len(a)):
            (ma, (ha, ca), sa), (mb, (hb, cb), sb) = a[i], b[i]
            assert a.get_source(i) == b.get_source(i) and ha == hb and sa == sb
            np.testing.assert_array_equal(ma.vertices, mb.vertices)
            np.testing.assert_array_equal(ma.faces, mb.faces)
            np.testing.assert_array_equal(np.stack([c.matrix for c in ca]),
                                          np.stack([c.matrix for c in cb]))
    root = tmp_path / "ShapeNetCore.v2"
    for cat, mid, mesh in (("02691156", "m0", mesh_io.make_box(0.9, 0.7, 1.1)),
                           ("02691156", "m1", mesh_io.make_sphere(0.5, 12)),
                           ("03001627", "c0", mesh_io.make_box(0.5, 0.5, 0.5))):
        (root / cat / mid / "models").mkdir(parents=True)
        lo, hi = mesh.bounds()
        mesh_io.save_obj(str(root / cat / mid / "models" / "model_normalized.obj"),
                         mesh_io.TriMesh(mesh.vertices - (lo + hi) / 2.0, mesh.faces))
    (tmp_path / "valid.json").write_text(json.dumps(
        {"ShapeNetV2": {"02691156": ["m0", "m1"], "03001627": ["c0"]}}))
    kw = dict(shapenet_path=str(root), categories=["02691156", "03001627"],
              shapes_per_category=[1, -1], scale=[0.6, 0.5],
              valid_list_path=str(tmp_path / "valid.json"))
    a, b = G.ShapeNetGenerator(**kw), JG.ShapeNetGenerator(**kw)
    assert len(a) == len(b) == 2
    for i in range(2):
        (pa, (ha, ca), sa), (pb, (hb, cb), sb) = a[i], b[i]
        assert pa == pb and ha == hb == 0.8 and sa == sb and len(ca) == 300
        np.testing.assert_array_equal(ca[7].matrix, cb[7].matrix)
    args = dict(provider="shapenet_model", provider_kwargs=kw, sampler_count=4000,
                sampler_var=0.005, voxel_size=0.25, nn_size=2.0, seed=4,
                output=str(tmp_path / "lifs"))
    n = G.run_generation(dict_to_args(args), SM.SamplerConfig(
        num_sample=4000, n_surface_candidates=3000, zbuffer_res=64), device="cpu")
    src = json.loads((tmp_path / "lifs" / "source.json").read_text())
    assert n == len(src) > 0 and all(s[0].startswith(str(root)) for s in src)


def test_generator_cli_on_the_cpu(tmp_path, monkeypatch):
    """The generator's command line (``main``, which ``python -m
    difusion_tpu_torch.sampler.generator`` runs) on configs/data-simple.yaml
    with --device cpu, cut to one shape and 3,000 queries, and here to 20,000
    surface candidates and a 100x100 z-buffer (the command line keeps the
    sampler's 500,000 and 400x400); without --device it needs a card."""
    small = SM.SamplerConfig

    def small_sampler(**kw):
        return small(**kw, n_surface_candidates=20000, zbuffer_res=100)
    monkeypatch.setattr(G, "SamplerConfig", small_sampler)
    monkeypatch.chdir(ROOT)
    out = tmp_path / "lifs"
    n = G.main(["configs/data-simple.yaml", "--device", "cpu", "--sampler_count", "3000",
                "--set", "provider_kwargs.n_shapes=1", "--output", str(out)])
    src = json.loads((out / "source.json").read_text())
    assert n == len(src) == len(list((out / "payload").glob("*.npz")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            G.main(["configs/data-simple.yaml", "--output", str(tmp_path / "x")])
