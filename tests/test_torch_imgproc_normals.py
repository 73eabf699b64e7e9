"""The port's image-space normals (``difusion_tpu_torch/ops/imgproc.py``:
``compute_normal_weight``, ``compute_normal_weight_robust``,
``sym3eig_smallest``, ``masked_half_bilinear``, ``Intrinsic.to_K`` /
``scaled``) against the JAX package's on the same seeded inputs.  The
point maps are tests/test_tracker.py's 120x160 surface frames (a plane and
the corrugated surface) seen from a tilted camera, with 5% of the pixels
dropped."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp

from difusion_tpu.ops import imgproc as J
from difusion_tpu.utils.motion import Isometry
from difusion_tpu_torch.ops import imgproc as T
from test_tracker import CALIB, render_surface_frame


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Several workers run the suite at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _point_map(corrugation):
    pose = Isometry.from_twist(np.array([0.05, -0.02, 0.0, 0.03, -0.05, 0.02]))
    _, depth, ok = render_surface_frame(pose, CALIB, corrugation=corrugation)
    ok = np.asarray(ok) & (np.random.default_rng(0).random(ok.shape) > 0.05)
    pc = J.unproject_depth(jnp.asarray(depth), jnp.asarray(ok), CALIB.fx, CALIB.fy,
                           CALIB.cx, CALIB.cy)
    return np.array(pc), ok


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("corrugation", [0.0, 0.1])
def test_normal_weight_matches_jax(robust, corrugation):
    """``ok`` equal; normals within 1e-6 (measured 0 and 1.8e-7: the
    robust variant's window sums add in the same order, XLA may contract
    them into FMAs); weights (up to ~170) within rtol 1e-6 (measured 2e-7);
    -1 where not ok on both sides."""
    pc, ok = _point_map(corrugation)
    name = "compute_normal_weight_robust" if robust else "compute_normal_weight"
    rn, rw, rok = map(np.asarray, getattr(J, name)(jnp.asarray(pc), jnp.asarray(ok)))
    gn, gw, gok = (t.numpy() for t in getattr(T, name)(torch.from_numpy(pc),
                                                       torch.from_numpy(ok)))
    np.testing.assert_array_equal(gok, rok)
    assert gok.sum() > 0.7 * ok.sum()
    np.testing.assert_allclose(gn[gok], rn[rok], atol=1e-6, rtol=0)
    np.testing.assert_allclose(gw[gok], rw[rok], rtol=1e-6, atol=0)
    assert (gw[~gok] == -1.0).all() and (rw[~rok] == -1.0).all()
    if corrugation == 0.0 and robust:      # the plane's normal, facing the camera
        assert (np.sum(gn[gok] * pc[gok], axis=-1) < 0).all()


def test_sym3eig_smallest_matches_jax_and_eigh():
    """Eigenvectors and eigenvalues against the JAX function at 1e-5, and
    numpy.linalg.eigh's smallest pair at the JAX test's tolerances."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(200, 3, 3)).astype(np.float32)
    cov = np.einsum("nij,nkj->nik", a, a).reshape(10, 20, 3, 3)
    rv, rl = map(np.asarray, J.sym3eig_smallest(jnp.asarray(cov)))
    gv, gl = (t.numpy() for t in T.sym3eig_smallest(torch.from_numpy(cov)))
    assert gv.shape == (10, 20, 3) and gl.shape == (10, 20)
    np.testing.assert_allclose(gv, rv, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gl, rl, atol=1e-5, rtol=1e-5)
    wref, vref = np.linalg.eigh(cov.astype(np.float64))
    np.testing.assert_allclose(gl, wref[..., 0], rtol=2e-2, atol=2e-3)
    assert (np.abs(np.sum(gv * vref[..., :, 0], axis=-1)) > 0.99).all()


@pytest.mark.parametrize("shape", [(7, 9), (8, 10), (1, 5)])
def test_masked_half_bilinear_matches_jax(shape):
    """Odd sizes drop the last row / column; blocks with no valid pixel are
    not ok.  Values within 1e-7 of the N(0, 1) inputs: the port sums a block
    in row-major order, XLA's reduce in an order of its own that depends on
    the shape (row-major at 8x10 and 64x80, pairwise at 7x9; measured 3e-8,
    one ulp)."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=shape).astype(np.float32)
    ok = rng.random(shape) > 0.4
    ri, rok = map(np.asarray, J.masked_half_bilinear(jnp.asarray(img), jnp.asarray(ok)))
    gi, gok = (t.numpy() for t in T.masked_half_bilinear(torch.from_numpy(img),
                                                         torch.from_numpy(ok)))
    assert gi.shape == ri.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_array_equal(gok, rok)
    np.testing.assert_allclose(gi, ri, atol=1e-7, rtol=0)


def test_intrinsic_to_k_and_scaled():
    j = J.Intrinsic(481.2, 480.0, 319.5, 239.5, 5000.0)
    t = T.Intrinsic(*j)
    np.testing.assert_array_equal(t.to_K(), j.to_K())
    assert tuple(t.scaled(0.5)) == tuple(j.scaled(0.5))


def test_sensor_weight_matches_jax():
    """The sensor-noise weight over depth 0.3-6 m and every normal z from
    facing the camera (-1) through grazing (0) to facing away (1).  XLA's
    f32 arccos and torch's differ by up to 2 ulps (2.4e-7); theta / (c -
    theta), c = 0.5 * 3.14159, turns that into a relative error of the
    weight of at most 2 c dtheta / (theta |c - theta|).  So: rtol 1e-6 plus
    that bound (measured: 1.2e-4 at theta 0.002 from c, 0 elsewhere)."""
    rng = np.random.default_rng(4)
    z = rng.uniform(0.3, 6.0, 2000).astype(np.float32)
    nz = np.concatenate([rng.uniform(-1.0, 1.0, 1997), [-1.0, 0.0, 1.0]]).astype(np.float32)
    ref = np.asarray(J._sensor_weight(jnp.asarray(z), jnp.asarray(nz))).astype(np.float64)
    got = T._sensor_weight(torch.from_numpy(z), torch.from_numpy(nz)).numpy()
    theta, c = np.arccos(nz.astype(np.float64)), 0.5 * 3.14159
    tol = 1e-6 + 2 * c * 2.4e-7 / np.maximum(theta * np.abs(c - theta), 1e-12)
    assert (np.abs(got - ref) <= tol * np.abs(ref)).all()
    far = np.abs(c - theta) > 0.2              # the arccos ulp is harmless here
    np.testing.assert_allclose(got[far], ref[far], rtol=1e-6, atol=0)
    assert np.isfinite(got).all() and (got > 0).all()
