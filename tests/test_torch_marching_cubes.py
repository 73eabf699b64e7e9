"""Parity of the port's lattice sampling and sparse marching cubes against
the JAX package on the CPU, on an analytic sphere field over a small dense
world with free cells, unevaluated blocks and padding rows."""
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax.numpy as jnp
import torch

from difusion_tpu.ops import marching_cubes as JMC
from difusion_tpu.ops import mc_tables as jax_tables
from difusion_tpu.ops import sampling as JS
from difusion_tpu_torch.ops import marching_cubes as MC
from difusion_tpu_torch.ops import mc_tables
from difusion_tpu_torch.ops import sampling as S

N = 6             # world cells a side
VOXEL = 0.25
BOUND_MIN = np.array([-0.75, -0.75, -0.75], np.float32)


def test_mc_tables_are_the_jax_tables():
    for name in ("EDGE_CORNERS", "CORNER_OFFSETS", "TRI_TABLE", "EDGE_TABLE"):
        np.testing.assert_array_equal(getattr(mc_tables, name),
                                      getattr(jax_tables, name), err_msg=name)


@pytest.mark.parametrize("r", [2, 3, 4, 8])
def test_samples_bit_equal(r):
    """get_samples and block_lattice are the same numpy f32 arithmetic."""
    np.testing.assert_array_equal(S.block_lattice(r), np.asarray(JS.block_lattice(r)))
    np.testing.assert_array_equal(S.get_samples(r), np.asarray(JS.get_samples(r)))
    np.testing.assert_array_equal(S.get_samples(r, a=-0.5, b=1.25),
                                  np.asarray(JS.get_samples(r, a=-0.5, b=1.25)))


def _world(r, seed=0):
    """Indexer with ~1/7 of the cells free, a slot_to_batch that leaves ~1/9
    of the allocated slots unevaluated, valid_blocks padded with -1 rows,
    and per-slot (2r)^3 lattices of a sphere sdf with a varying std."""
    rng = np.random.default_rng(seed)
    n_cells = N ** 3
    indexer = np.arange(n_cells, dtype=np.int32)
    indexer[rng.uniform(size=n_cells) < 1 / 7] = -1
    slot_to_batch = np.concatenate([np.arange(n_cells, dtype=np.int32), [-1]])
    slot_to_batch[:-1][rng.uniform(size=n_cells) < 1 / 9] = -1
    live = np.nonzero(indexer >= 0)[0].astype(np.int32)
    valid_blocks = np.concatenate([live, np.full(256 - len(live) % 256, -1, np.int32)])
    lat = S.block_lattice(r)
    cell = np.stack(np.meshgrid(*([np.arange(N)] * 3), indexing="ij"), -1).reshape(-1, 3)
    world = BOUND_MIN + (cell[:, None, :] + 0.5 + lat[None]) * VOXEL
    side = 2 * r
    sdf = (np.linalg.norm(world - [0.05, -0.02, 0.03], axis=-1) - 0.5)
    std = 0.1 + 0.04 * np.sin(7.0 * world[..., 0]) * np.cos(5.0 * world[..., 1])
    return (indexer, slot_to_batch, valid_blocks,
            sdf.reshape(-1, side, side, side).astype(np.float32),
            std.reshape(-1, side, side, side).astype(np.float32))


def _both(fn_j, fn_t, args, *rest, **kw):
    ref = fn_j(*(jnp.asarray(a) for a in args), *rest, **kw)
    got = fn_t(*(torch.from_numpy(a) for a in args), *rest, **kw)
    return ref, got


@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("r", [2, 3, 4])
def test_corner_field_and_mc_match_jax(r, interpolate):
    """Corner-valid masks, triangle count and block ids exact; corner values,
    triangles and stds to f32 rounding (atol 1e-5 in grid units), in the
    JAX package's triangle order."""
    args = _world(r)
    (js, jt, jv), (ts, tt, tv) = _both(JMC.corner_field, MC.corner_field, args,
                                       (N, N, N), r, interpolate=interpolate)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any() and not tv.all()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)

    ref, got = _both(JMC.marching_cubes_sparse, MC.marching_cubes_sparse, args,
                     (N, N, N), r, 1 << 14, interpolate=interpolate)
    assert int(got.count) == int(ref.count) > 100
    np.testing.assert_array_equal(got.tri_block.numpy(), np.asarray(ref.tri_block))
    np.testing.assert_allclose(got.triangles.numpy(), np.asarray(ref.triangles), atol=1e-5)
    np.testing.assert_allclose(got.tri_std.numpy(), np.asarray(ref.tri_std), atol=1e-5)
    # the host's unpack, through the splice with the identity transform and
    # the identity block -> slot table: the JAX package's rows
    spliced = MC.mc_splice(got.packed[None], got.count[None], torch.arange(N ** 3),
                           np.zeros(3, np.int64), 1.0, np.zeros(3, np.float32), 1 << 14)
    for a, b in zip(MC.mc_triangles_np(spliced), JMC.mc_triangles_np(ref)):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("max_std,budget", [(0.12, 1 << 14), (2000.0, 100)])
def test_max_std_pruning_and_budget_overflow(max_std, budget):
    """Pruning by vertex std, and a budget below the count: the same true
    count and the same truncated buffer as the JAX package."""
    args = _world(4, seed=1)
    ref, got = _both(JMC.marching_cubes_sparse, MC.marching_cubes_sparse, args,
                     (N, N, N), 4, budget, max_std=max_std)
    full = MC.marching_cubes_sparse(*(torch.from_numpy(a) for a in args), (N, N, N), 4,
                                    1 << 14)
    assert int(got.count) == int(ref.count)
    if max_std < 1.0:     # some triangles pruned, not all
        assert 0 < int(got.count) < int(full.count)
    else:                 # the true count, beyond the buffer
        assert int(got.count) == int(full.count) > budget
    assert got.triangles.shape == (9, budget)
    np.testing.assert_array_equal(got.tri_block.numpy(), np.asarray(ref.tri_block))
    np.testing.assert_allclose(got.triangles.numpy(), np.asarray(ref.triangles), atol=1e-5)
    np.testing.assert_allclose(got.tri_std.numpy(), np.asarray(ref.tri_std), atol=1e-5)


def test_kernel_wrapper_checks_its_inputs():
    """The checks the CUDA route makes before it launches (``_check_inputs``,
    run here on CPU tensors and one on the meta device): the mesher's
    dtypes and shapes pass; a wrong dtype, a tensor on another device, a
    non-contiguous lattice, lattices of another r or shape, an indexer that
    is not the grid's, and sizes past the kernels' 32-bit indices raise."""
    indexer, s2b, blocks, sdf, std = (torch.from_numpy(a) for a in _world(2))
    good = [indexer, s2b, blocks, sdf, std]
    MC._check_inputs(*good, (N, N, N), 2, 1 << 14)
    for i, bad in ((0, indexer.long()), (1, s2b.int()), (2, blocks.long()),
                   (3, sdf.double()), (4, std.double()), (0, indexer.to("meta")),
                   (2, blocks[::2]), (3, sdf.transpose(1, 3)), (4, std[:-1]),
                   (3, sdf[:, :2, :2, :2].contiguous())):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            MC._check_inputs(*args, (N, N, N), 2, 1 << 14)
    for n_xyz, r, budget in (((N, N, N + 1), 2, 1 << 14), ((N, N, N), 3, 1 << 14),
                             ((N, N, N), 2, -1), ((N, N, N), 2, 2 ** 31 // 13 + 1)):
        with pytest.raises(ValueError):
            MC._check_inputs(*good, n_xyz, r, budget)
    lattice = torch.zeros(1, 32, 32, 32)
    many = torch.full((2 ** 31 // (5 * 16 ** 3) + 1,), -1, dtype=torch.int32)
    MC._check_inputs(indexer, s2b, many[:-1], lattice, lattice, (N, N, N), 16, 1 << 14)
    with pytest.raises(ValueError):       # 5 * blocks * r^3 >= 2^31
        MC._check_inputs(indexer, s2b, many, lattice, lattice, (N, N, N), 16, 1 << 14)
