"""Parity of the port's order-robust reductions (``ops/compsum.py``) against
the JAX package's on the CPU, and the properties the tracker relies on: the
TwoSum cascade beats a plain f32 sum on cancellation and does not depend on
the order of its input."""
import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
import torch

from difusion_tpu.ops import compsum as JC
from difusion_tpu_torch.ops import compsum as C


def _rows(n, r=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, r)).astype(np.float32),
            rng.random(n).astype(np.float32))


def _rel_close(got, ref, rtol):
    """Every entry within ``rtol`` of the largest entry of ``ref``."""
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(1,), (2,), (1000,), (4096,), (3001, 5)])
def test_pairwise_compensated_sum_matches_jax(shape):
    """The cascade against the jitted JAX one (powers of two and not, one
    row, a column stack) at 1e-7 relative."""
    x = (np.random.default_rng(1).standard_normal(shape) * 1e3).astype(np.float32)
    got = C.pairwise_compensated_sum(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(JC.pairwise_compensated_sum)(jnp.asarray(x)))
    _rel_close(got, ref, 1e-7)


def test_cascade_beats_plain_sum_on_cancellation():
    """On a cancellation-heavy vector the cascade is within 1e-4 of the
    plain f32 sum's error of the exact (f64) sum: each TwoSum step ran as
    written, nothing cancelled its error term."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(40001).astype(np.float32) * 1e4
    x = np.concatenate([x, -x * (1 + 1e-7)]).astype(np.float32)
    exact = np.sum(x.astype(np.float64))
    plain = float(torch.from_numpy(x).sum())
    comp = float(C.pairwise_compensated_sum(torch.from_numpy(x)))
    assert abs(comp - exact) < 1e-4 * max(abs(plain - exact), 1e-30), (comp, plain, exact)


@pytest.mark.parametrize("seed", [7, 23])
def test_pairwise_sum_is_permutation_invariant(seed):
    """A permutation of the input moves the compensated sum by at most an
    ulp of the exact sum; on these inputs it does not move it at all."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((20000, 28)) * rng.uniform(1e-3, 1e3, 28)).astype(np.float32)
    a = C.pairwise_compensated_sum(torch.from_numpy(x))
    b = C.pairwise_compensated_sum(torch.from_numpy(x[rng.permutation(len(x))]))
    exact = x.astype(np.float64).sum(0)
    assert np.all(np.abs((a - b).numpy()) <= np.spacing(np.abs(exact).astype(np.float32)))
    assert torch.equal(a, b)


@pytest.mark.parametrize("n", [3000, 4096, 307200])
def test_gram_compensated_matches_jax(n):
    """``gram_compensated`` of [J | r]-shaped rows (R = 7, the L0 image's
    307,200 pixels included) against the JAX package's at 1e-7 relative, and
    against the f64 Gram: at the JAX package's own tolerance for its 3000
    rows, at 1e-7 of the largest entry for all (each product is rounded
    to f32 before the exact sum)."""
    rows, w = _rows(n)
    got = C.gram_compensated(torch.from_numpy(rows), torch.from_numpy(w), 0.5).numpy()
    ref = np.asarray(jax.jit(lambda r, w: JC.gram_compensated(r, w, 0.5))(rows, w))
    _rel_close(got, ref, 1e-7)
    assert np.array_equal(got, got.T)
    M64 = 0.5 * (rows.astype(np.float64) * w[:, None]).T @ rows.astype(np.float64)
    _rel_close(got, M64, 1e-7)
    if n == 3000:
        np.testing.assert_allclose(got, M64, rtol=5e-6, atol=1e-6)


@pytest.mark.parametrize("block", [512, 499])
def test_gram_blocked_matches_jax(block):
    """``gram_blocked`` against the JAX package's: the blocks' products run
    in another order (the CPU's / cuBLAS's, not XLA's), so to 1e-6 relative,
    not bit for bit; and against f64 to 5e-7 of the largest entry (a few
    f32 ulps: the within-block sums are plain f32)."""
    rows, w = _rows(3000, seed=2)
    got = C.gram_blocked(torch.from_numpy(rows), torch.from_numpy(w), 1.0, block).numpy()
    ref = np.asarray(jax.jit(lambda r, w: JC.gram_blocked(r, w, 1.0, block))(rows, w))
    _rel_close(got, ref, 1e-6)
    M64 = (rows.astype(np.float64) * w[:, None]).T @ rows.astype(np.float64)
    _rel_close(got, M64, 5e-7)


def test_gram_dispatch():
    rows, w = _rows(100)
    tr, tw = torch.from_numpy(rows), torch.from_numpy(w)
    assert torch.equal(C.gram(tr, tw, 2.0, "compensated"), C.gram_compensated(tr, tw, 2.0))
    assert torch.equal(C.gram(tr, tw, 2.0, "blocked"), C.gram_blocked(tr, tw, 2.0))
    with pytest.raises(ValueError):
        C.gram(tr, tw, 2.0, "f64")
