"""The port's host SE(3) algebra (``difusion_tpu_torch/utils/motion.py``)
against the JAX package's (``difusion_tpu/utils/motion.py``): every case of
tests/test_motion.py and the rest of the module's surface, run through both
modules on the same seeded inputs.  Both are float64 numpy, so every output
agrees at 1e-10; each case also asserts its property at test_motion.py's
tolerance.  ``Isometry @`` an f32 torch tensor against the numpy product at
1e-6, and the tensor ``Pose.compose`` / ``Pose.inv`` against the JAX ones."""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp

from difusion_tpu.ops import se3 as jse3
from difusion_tpu.utils import motion as JM
from difusion_tpu_torch.ops import se3
from difusion_tpu_torch.utils import motion as TM

close = np.testing.assert_allclose


# -- the cases of tests/test_motion.py ----------------------------------------

def quaternion_matrix_round_trip(M, rng):
    out = []
    for _ in range(20):
        R = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
        q = M.Quaternion(matrix=R)
        close(q.rotation_matrix, R, atol=1e-10)
        out.append(q.q)
    return out


def quaternion_axis_angle(M, rng):
    q = M.Quaternion(axis=[0, 0, 1], degrees=90.0)
    close(q.rotate([1, 0, 0]), [0, 1, 0], atol=1e-12)
    return [q.q, M.Quaternion(axis=[1.0, 2.0, -0.5], radians=0.7).q]


def quaternion_mul_matches_matrix_product(M, rng):
    q1, q2 = M.Quaternion.random(rng), M.Quaternion.random(rng)
    close((q1 * q2).rotation_matrix, q1.rotation_matrix @ q2.rotation_matrix, atol=1e-10)
    return [(q1 * q2).q]


def quaternion_inverse(M, rng):
    q = M.Quaternion.random(rng)
    close((q * q.inverse).rotation_matrix, np.eye(3), atol=1e-10)
    return [q.inverse.q]


def quaternion_slerp_endpoints(M, rng):
    q1, q2 = M.Quaternion.random(rng), M.Quaternion.random(rng)
    close(M.Quaternion.slerp(q1, q2, 0.0).rotation_matrix, q1.rotation_matrix, atol=1e-8)
    close(M.Quaternion.slerp(q1, q2, 1.0).rotation_matrix, q2.rotation_matrix, atol=1e-8)
    near = M.Quaternion(array=q1.q + 1e-4)            # the linear branch
    return [M.Quaternion.slerp(q1, q2, a).q for a in (0.0, 0.3, 1.0)] + [
        M.Quaternion.slerp(q1, near, 0.5).q]


def lie_so3_exp_log_round_trip(M, rng):
    out = []
    for _ in range(10):
        phi = rng.normal(size=3) * 0.5
        close(M.so3_log(M.so3_exp(phi)), phi, atol=1e-8)
        out.append(M.so3_log(M.so3_exp(phi)))
    # near pi, and at 0
    phi = np.array([0.0, 0.0, np.pi - 1e-9])
    return out + [M.so3_log(M.so3_exp(phi)), M.so3_log(np.eye(3))]


def lie_so3_exp_matches_scipy(M, rng):
    phi = np.array([0.3, -0.2, 0.9])
    close(M.so3_exp(phi), Rotation.from_rotvec(phi).as_matrix(), atol=1e-10)
    return [M.so3_exp(phi), M.so3_exp(np.array([1e-8, 0.0, 0.0]))]


def lie_twist_exp_log_round_trip(M, rng):
    xi = rng.normal(size=6) * 0.4
    iso = M.Isometry.from_twist(xi)
    close(iso.log(), xi, atol=1e-8)
    return [iso.log(), iso.matrix]


def lie_left_jacobian_inverse(M, rng):
    phi = rng.normal(size=3)
    close(M.so3_left_jacobian(phi) @ M.so3_inv_left_jacobian(phi), np.eye(3), atol=1e-9)
    return [M.so3_inv_left_jacobian(phi), M.so3_inv_left_jacobian(phi * 1e-8)]


def lie_se3_left_jacobian_inverse(M, rng):
    xi = rng.normal(size=6)
    close(M.se3_left_jacobian(xi) @ M.se3_inv_left_jacobian(xi), np.eye(6), atol=1e-8)
    small = xi * 1e-8                                  # the Taylor branch
    return [M.se3_left_jacobian(xi), M.se3_inv_left_jacobian(xi),
            M.se3_left_jacobian(small), M.se3_inv_left_jacobian(small),
            M._se3_translation_block(xi[:3], xi[3:])]


def isometry_compose_inverse(M, rng):
    a, b = M.Isometry.random(rng), M.Isometry.random(rng)
    close(a.dot(b).matrix, a.matrix @ b.matrix, atol=1e-10)
    close(a.inv().dot(a).matrix, np.eye(4), atol=1e-10)
    return [a.dot(b).matrix, a.inv().matrix]


def isometry_apply_points(M, rng):
    iso = M.Isometry.random(rng)
    pts = rng.normal(size=(10, 3))
    close(iso @ pts, (iso.q.rotation_matrix @ pts.T).T + iso.t, atol=1e-10)
    return [iso @ pts, iso @ pts[0]]


def isometry_twist_small_angle(M, rng):
    xi = np.array([1e-9, 0, 0, 0, 0, 1e-10])
    iso = M.Isometry.from_twist(xi)
    close(iso.matrix[:3, 3], xi[:3], atol=1e-12)
    return [iso.matrix]


def isometry_matmul_isometry(M, rng):
    a, b = M.Isometry.random(rng), M.Isometry.random(rng)
    close((a @ b).matrix, a.dot(b).matrix, atol=1e-12)
    return [(a @ b).matrix]


def isometry_continuous_repr_round_trip(M, rng):
    iso = M.Isometry.random(rng)
    rec = M.Isometry.from_continuous_repr(iso.continuous_repr)
    close(rec.matrix, iso.matrix, atol=1e-9)
    raw = rng.normal(size=9)                           # Gram-Schmidt at work
    return [iso.continuous_repr, rec.matrix,
            M.Isometry.from_continuous_repr(raw).matrix]


def ate_rmse_zero_for_identical(M, rng):
    traj = [M.Isometry.random(rng) for _ in range(10)]
    assert M.ate_rmse(traj, traj) < 1e-9
    return [np.array(M.ate_rmse(traj, traj))]


def ate_rmse_alignment_invariance(M, rng):
    traj = [M.Isometry.random(rng) for _ in range(10)]
    offset = M.Isometry.random(rng)
    moved = [offset.dot(t) for t in traj]
    assert M.ate_rmse(traj, moved, align=True) < 1e-9
    return [np.array(M.ate_rmse(traj, moved, align=False))]


# -- the rest of the module's surface -----------------------------------------

def so3_vee_and_curlywedge(M, rng):
    phi = rng.normal(size=(4, 3))
    close(M.so3_vee(M.so3_wedge(phi)), phi, atol=0)
    xi = rng.normal(size=6)
    return [M.so3_wedge(phi), M.so3_vee(M.so3_wedge(phi)), M.se3_curlywedge(xi),
            M.se3_curlywedge(rng.normal(size=(2, 6)))]


def quaternion_accessors(M, rng):
    q = M.Quaternion(*(rng.normal(size=4) * 2.0))
    v = M.Quaternion(imaginary=[0.1, -0.2, 0.3], real=0.9)
    return [np.array(q.w), q.vector, q.elements, np.array(q.norm), q.normalised.q,
            q.conjugate.q, q.transformation_matrix, v.q]


def quaternion_log_exp(M, rng):
    q = M.Quaternion.random(rng)
    back = M.Quaternion.exp(M.Quaternion.log(q))
    close(back.rotation_matrix, q.rotation_matrix, atol=1e-10)
    return [M.Quaternion.log(q).q, back.q, M.Quaternion.log(M.Quaternion()).q,
            M.Quaternion.exp(M.Quaternion(0.3, 0.0, 0.0, 0.0)).q,
            M.Quaternion.exp(M.Quaternion(array=rng.normal(size=4))).q]


def isometry_lie_and_adjoint(M, rng):
    a = M.Isometry.random(rng)
    xi = rng.normal(size=6)
    # Ad(T) exp(xi) = T exp(xi) T^-1
    lhs = M.Isometry.from_twist(a.adjoint_matrix() @ xi).matrix
    close(lhs, a.matrix @ M.Isometry.from_twist(xi).matrix @ a.inv().matrix, atol=1e-10)
    phi = rng.normal(size=3)
    return [a.log(), a.adjoint_matrix(), M.Isometry.from_so3_exp(phi).matrix,
            a.rotation.matrix, a.to_gl_camera().matrix, M.Isometry.GL_POST_MULT.q]


def isometry_interpolate_and_tangent(M, rng):
    a, b, c = (M.Isometry.random(rng) for _ in range(3))
    mid = M.Isometry.interpolate(a, b, 0.25)
    close(M.Isometry.interpolate(a, b, 0.0).matrix, a.matrix, atol=1e-8)
    return [mid.matrix, b.tangent(a, c).q.q, b.tangent(a, c).t]


def isometry_full_repr(M, rng):
    iso = M.Isometry.random(rng)
    close(M.Isometry.from_full_repr(iso.full_repr).matrix, iso.matrix, atol=1e-10)
    noisy = iso.full_repr + rng.normal(size=12) * 1e-3
    return [iso.full_repr, M.Isometry.from_full_repr(noisy, ortho=True).matrix]


def isometry_from_matrix_and_look_at(M, rng):
    m = M.Isometry.random(rng).matrix
    m[:3, :3] += rng.normal(size=(3, 3)) * 1e-3
    look = M.Isometry.look_at(rng.normal(size=3), rng.normal(size=3) + 3.0)
    vertical = M.Isometry.look_at(np.zeros(3), np.array([0.0, 2.0, 0.0]))
    return [M.Isometry.from_matrix(m, ortho=True).matrix,
            M.Isometry.from_matrix(m[:3, :3], m[:3, 3], ortho=True).matrix,
            look.matrix, vertical.matrix]


CASES = {f.__name__: f for f in (
    quaternion_matrix_round_trip, quaternion_axis_angle,
    quaternion_mul_matches_matrix_product, quaternion_inverse,
    quaternion_slerp_endpoints, lie_so3_exp_log_round_trip, lie_so3_exp_matches_scipy,
    lie_twist_exp_log_round_trip, lie_left_jacobian_inverse,
    lie_se3_left_jacobian_inverse, isometry_compose_inverse, isometry_apply_points,
    isometry_twist_small_angle, isometry_matmul_isometry,
    isometry_continuous_repr_round_trip, ate_rmse_zero_for_identical,
    ate_rmse_alignment_invariance, so3_vee_and_curlywedge, quaternion_accessors,
    quaternion_log_exp, isometry_lie_and_adjoint, isometry_interpolate_and_tangent,
    isometry_full_repr, isometry_from_matrix_and_look_at)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_motion_matches_jax(case):
    ref = CASES[case](JM, np.random.default_rng(0))
    got = CASES[case](TM, np.random.default_rng(0))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.asarray(g).shape == np.asarray(r).shape
        close(g, r, atol=1e-10, rtol=0)


def test_isometry_matmul_on_a_tensor():
    """``Isometry @`` an (N, 3) f32 tensor stays a tensor of that dtype (and
    device) and agrees with the numpy product at 1e-6."""
    rng = np.random.default_rng(1)
    iso = TM.Isometry.random(rng)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    out = iso @ torch.from_numpy(pts)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.device == torch.device("cpu")
    close(out.numpy(), iso @ pts.astype(np.float64), atol=1e-6, rtol=0)
    close(out.numpy(), JM.Isometry(JM.Quaternion(array=iso.q.q), iso.t) @ pts,
          atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        iso @ torch.zeros(3)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-8])
def test_pose_ops_match_jax(scale):
    """The tensor ``Pose``'s apply / compose / inv and ``exp_twist`` against
    the JAX package's and the host ``Isometry`` (f32: 1e-6 / 2e-6)."""
    rng = np.random.default_rng(2)
    a, b = TM.Isometry.random(rng), TM.Isometry.from_twist(rng.normal(size=6) * scale)
    f32 = np.float32
    pa = se3.Pose(torch.tensor(a.q.rotation_matrix, dtype=torch.float32),
                  torch.tensor(a.t, dtype=torch.float32))
    pb = se3.exp_twist(torch.tensor(b.log(), dtype=torch.float32))
    ja = jse3.Pose(jnp.asarray(a.q.rotation_matrix, f32), jnp.asarray(a.t, f32))
    jb = jse3.exp_twist(jnp.asarray(b.log(), f32))
    close(pb.R.numpy(), b.q.rotation_matrix, atol=2e-6)
    close(pb.t.numpy(), b.t, atol=2e-6)
    for got, ref in ((pa.compose(pb), ja.compose(jb)), (pa.inv(), ja.inv()),
                     (pa.compose(pa.inv()), ja.compose(ja.inv()))):
        close(got.R.numpy(), np.asarray(ref.R), atol=1e-6, rtol=0)
        close(got.t.numpy(), np.asarray(ref.t), atol=1e-6, rtol=0)
    close(pa.compose(pa.inv()).R.numpy(), np.eye(3), atol=1e-5)
    pts = rng.normal(size=(5, 3)).astype(f32)
    close(pa.apply(torch.from_numpy(pts)).numpy(), a @ pts, atol=1e-5)
