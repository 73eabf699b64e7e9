"""Parity of the PyTorch port's decoder, encoder, weight loading and the
plain version of kernel 1 (fused decoder forward + d sdf/d xyz) against the
JAX package, on the CPU, with the in-repo study_mixed prior."""
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
import torch

from difusion_tpu.models.decoder import decode as jax_decode
from difusion_tpu.models.encoder import encode_points as jax_encode
from difusion_tpu.ops import decoder_fused as jax_fused
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.models.decoder import DecoderSpec
from difusion_tpu_torch.models.weights import from_jax_params, load_prior
from difusion_tpu_torch.ops import _build
from difusion_tpu_torch.ops import decoder_fused as fused

HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"


@pytest.fixture(scope="module")
def prior():
    """The JAX package's folded prior, and the port's modules built from the
    same (numpy) trees, so both sides hold identical weights."""
    dec, enc, spec = jax_load_prior(str(HYPER), 300)
    dec_np = jax.tree.map(np.asarray, dec)
    enc_np = jax.tree.map(np.asarray, enc)
    t_dec, t_enc = from_jax_params(dec_np, enc_np, DecoderSpec(*spec), device="cpu")
    return dec, enc, spec, t_dec, t_enc


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    lat = rng.normal(0, 0.3, (n, 29)).astype(np.float32)
    rel = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return lat, rel


def _jax_vjp(dec, spec, lat, rel):
    """decode + jax.vjp w.r.t. xyz with the latent stop-gradiented: the GN
    SDF term's computation in the JAX default route."""
    lat, rel = jnp.asarray(lat), jnp.asarray(rel)

    def f(x):
        return jax_decode(dec, spec, jax.lax.stop_gradient(lat), x)[0]
    sdf, vjp_fn = jax.vjp(f, rel)
    (g,) = vjp_fn(jnp.ones_like(sdf))
    return sdf, jax_decode(dec, spec, lat, rel)[1], g


def test_decode_matches_jax(prior):
    """Decoder.decode == models.decoder.decode, f32 atol 2e-6 (both are f32
    matmul stacks; only the summation order of the 128-wide dots differs)."""
    dec, _, spec, t_dec, _ = prior
    lat, rel = _inputs(777, 1)
    sdf_j, std_j = jax_decode(dec, spec, jnp.asarray(lat), jnp.asarray(rel))
    sdf_t, std_t = t_dec.decode(torch.from_numpy(lat), torch.from_numpy(rel))
    np.testing.assert_allclose(sdf_t.numpy(), np.asarray(sdf_j), atol=2e-6, rtol=0)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), atol=2e-6, rtol=0)


def test_decode_grad_plain_matches_jax_kernel_and_vjp(prior):
    """Kernel 1's plain version == the Pallas kernel in interpret mode and
    == decode + vjp, at N = 777 (ragged against every tile), f32 atol 2e-6
    as the JAX package's own kernel test (tests/test_decoder_fused.py)."""
    dec, _, spec, t_dec, _ = prior
    lat, rel = _inputs(777, 2)
    packed = fused.pack_fused_decoder(t_dec)
    got = fused.decode_grad_plain(packed, torch.from_numpy(lat), torch.from_numpy(rel))
    kern = jax_fused.decode_grad_fused(dec, spec, jnp.asarray(lat), jnp.asarray(rel),
                                       tile=256, interpret=True)
    vjp = _jax_vjp(dec, spec, lat, rel)
    for ref in (kern, vjp):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-6, rtol=0)


def test_wrapper_on_cpu_runs_plain_without_counting(prior):
    """On CPU tensors the wrapper is the plain version, and no kernel launch
    is counted."""
    *_, t_dec, _ = prior
    lat, rel = (torch.from_numpy(a) for a in _inputs(65, 3))
    packed = fused.pack_fused_decoder(t_dec)
    before = _build.launch_counts().get("decode_grad_fused", 0)
    a = fused.decode_grad_fused(packed, lat, rel)
    b = fused.decode_grad_plain(packed, lat, rel)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert _build.launch_counts().get("decode_grad_fused", 0) == before


def test_pack_layout_and_unsupported_spec(prior):
    *_, t_dec, _ = prior
    packed = fused.pack_fused_decoder(t_dec)
    assert packed.shape == (fused.PACKED_SIZE,) and packed.dtype == torch.float32
    p = fused.unpack(packed)
    w3 = t_dec.layers[3].weight
    assert torch.equal(p["f3"], w3.T) and torch.equal(p["g3"], w3[:, :96])
    assert torch.equal(p["w0_xyz"], t_dec.layers[0].weight[:, 29:])
    # outside both the 128-wide kernels and the wide family: a width that is
    # not a multiple of 64, unequal widths, two latent_in layers
    assert not fused.supports_spec(DecoderSpec(dims=(96, 96), latent_in=(1,)))
    assert not fused.supports_spec(DecoderSpec(dims=(128, 64), latent_in=(1,)))
    assert not fused.supports_spec(DecoderSpec(dims=(128,) * 4, latent_in=(1, 3)))
    # a member of the wide family: its plain versions on the CPU, no instance
    # compiled for the card
    assert fused.supports_spec(DecoderSpec(dims=(64, 64), latent_in=(1,)))
    assert not fused.supports_spec(DecoderSpec(dims=(64, 64), latent_in=(1,)), "cuda")
    assert fused.supports_spec(DecoderSpec()) and fused.supports_spec(DecoderSpec(), "cuda")


def test_grad_rows_off_takes_the_other_side_only_at_a_kink(prior):
    """The kernel-1 check passes the plain gradient; flipping each row's
    relu mask at its preactivation nearest to 0 is passed exactly on the
    rows where that preactivation lies within 1e-5 of 0 (and everywhere the
    flip moves the gradient less than the tolerance)."""
    *_, t_dec, _ = prior
    lat, rel = (torch.from_numpy(a) for a in _inputs(4096, 5))
    packed = fused.pack_fused_decoder(t_dec)
    p = fused.unpack(packed)
    _, zs, _, sdf, _ = fused._forward(p, lat, rel)
    ref = fused._grad(p, [z > 0 for z in zs], sdf)
    assert not bool(fused.grad_rows_off(ref, packed, lat, rel).any())
    z = torch.cat(zs, dim=1)
    dist, unit = z.abs().min(dim=1)
    flip = torch.zeros_like(z, dtype=torch.bool)
    flip[torch.arange(z.shape[0]), unit] = True
    flips = flip.split([zl.shape[1] for zl in zs], dim=1)
    alt = fused._grad(p, [(zl > 0) ^ f for zl, f in zip(zs, flips)], sdf)
    moved = ((alt - ref).abs() > 1e-4 + 1e-4 * ref.abs()).any(dim=1)
    near = dist < 1e-5
    assert bool((moved & near).any()) and bool((moved & ~near).any())
    assert torch.equal(fused.grad_rows_off(alt, packed, lat, rel), moved & ~near)


def test_encode_points_matches_jax(prior):
    """Encoder.encode_points == models.encoder.encode_points, atol 1e-5
    (a 256-wide f32 dot summed in another order, on codes of order 1)."""
    _, enc, _, _, t_enc = prior
    rng = np.random.default_rng(4)
    xyzn = np.concatenate([rng.uniform(-0.5, 0.5, (513, 3)),
                           rng.normal(size=(513, 3))], axis=1).astype(np.float32)
    ref = np.asarray(jax_encode(enc, jnp.asarray(xyzn)))
    got = t_enc.encode_points(torch.from_numpy(xyzn)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_load_prior_matches_jax_fold(prior):
    """The port's numpy-only npz loader folds weight-norm and BatchNorm to
    the JAX package's folded weights (f32 norm/sqrt rounding: atol 1e-6)."""
    dec, enc, spec, _, _ = prior
    t_dec, t_enc, t_spec = load_prior(HYPER, 300, device="cpu")
    assert tuple(t_spec) == tuple(spec)
    for lin, layer in zip(t_dec.layers, dec["layers"]):
        np.testing.assert_allclose(lin.weight.numpy(), np.asarray(layer["w"]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(lin.bias.numpy(), np.asarray(layer["b"]),
                                   atol=0, rtol=0)
    for lin, layer in zip(t_enc.layers, enc["layers"]):
        np.testing.assert_allclose(lin.weight.numpy(), np.asarray(layer["w"]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(lin.bias.numpy(), np.asarray(layer["b"]),
                                   atol=1e-6, rtol=1e-6)
