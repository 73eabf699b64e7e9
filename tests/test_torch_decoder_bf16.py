"""The bf16 mode of kernels 1 and 3 on the CPU, against the JAX package.

``pack_fused_decoder(decoder, torch.bfloat16)`` is the JAX package's bf16
``w_stack`` (difusion_tpu/ops/decoder_fused.py:99): the folded weights
rounded to bf16, the biases f32.  The plain versions (which the wrappers run
on CPU tensors) round the input, every hidden activation and every backward
``dz`` to bf16 as the Pallas kernels do, and sum each product in f32; the
JAX kernels run in interpret mode.  Only the order of the f32 sums differs,
so the two agree to about one bf16 rounding of an activation, not bit for
bit: where a sum lands on the other side of a bf16 rounding boundary, one
activation moves by an ulp of bf16 (2^-8 relative), which the heads and the
gradient carry on.  Tolerances: sdf and std atol 2e-3; the gradient, of up
to ~2 in size, within 1e-2 on 99% of the rows and within the JAX package's
own bf16-against-f32 bound (atol 0.15, rtol 0.05, tests/test_decoder_fused.py)
on every row.  ``Decoder.decode(compute_dtype=bfloat16)`` follows the JAX
package's XLA ``decode`` cast for cast: atol 2e-3.  The kernels' weight
segment is read back through the kernels' own wgmma descriptors, and the
pack's offsets against the kernels' header."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp

from difusion_tpu.models.decoder import decode as jax_decode
from difusion_tpu.models.decoder import fold_decoder_params, init_decoder_params
from difusion_tpu.models.encoder import EncoderSpec, init_encoder_params
from difusion_tpu.ops import decoder_fused as JF
from difusion_tpu.slam import load_prior as jax_load_prior
from difusion_tpu_torch.models.decoder import DecoderSpec
from difusion_tpu_torch.models.weights import from_jax_params
from difusion_tpu_torch.ops import decoder_fused as F

torch.set_num_threads(2)
HYPER = Path(__file__).resolve().parents[1] / "di-checkpoints/study_mixed/hyper.json"
N = 512
ATOL = 2e-3


@pytest.fixture(scope="module", params=["random", "prior"])
def decoders(request):
    """(JAX folded params, spec, port Decoder) of a random decoder and of
    the in-repo prior."""
    if request.param == "prior":
        dec, enc, spec = jax_load_prior(str(HYPER), 300)
    else:
        _, _, spec = jax_load_prior(str(HYPER), 300)
        dec = fold_decoder_params(init_decoder_params(spec, jax.random.key(3)))
        enc = init_encoder_params(EncoderSpec(), jax.random.key(4))
    t_dec, _ = from_jax_params(jax.tree.map(np.asarray, dec), jax.tree.map(np.asarray, enc),
                               DecoderSpec(*spec), device="cpu")
    return dec, spec, t_dec


def _inputs(seed, lo=-0.5, hi=0.5):
    rng = np.random.default_rng(seed)
    lat = (rng.normal(size=(N, 29)) * 0.3).astype(np.float32)
    rel = rng.uniform(lo, hi, size=(N, 3)).astype(np.float32)
    return lat, rel


def test_bf16_pack_is_the_jax_w_stack(decoders):
    """The bf16 pack's weight segments are the JAX package's bf16 w_stack
    (folded in f32, then rounded) bit for bit, the biases its f32 b_stack;
    the pack is shorter and selects the bf16 mode."""
    dec, spec, t_dec = decoders
    w_stack, b_stack = JF.pack_fused_decoder(dec, spec, jnp.bfloat16)
    w = np.asarray(w_stack.astype(jnp.float32))
    b = np.asarray(b_stack)
    pk = F.pack_fused_decoder(t_dec, torch.bfloat16)
    assert pk.numel() == F.PACKED_SIZE_BF16 < F.PACKED_SIZE and F.is_bf16(pk)
    assert not F.is_bf16(F.pack_fused_decoder(t_dec))
    p = {k: v.numpy() for k, v in F.unpack(pk).items()}
    np.testing.assert_array_equal(p["f0"], w[0][:32])
    np.testing.assert_array_equal(p["f1"], w[1])
    np.testing.assert_array_equal(p["f2"], w[2][:, :96])
    np.testing.assert_array_equal(p["f3"], np.concatenate([w[3][:96], w[4][:32]]))
    np.testing.assert_array_equal(p["w_sdf"], w[5][:, 0])
    np.testing.assert_array_equal(p["w_std"], w[5][:, 1])
    for k, name in enumerate(("b0", "b1", "b2", "b3")):
        np.testing.assert_array_equal(p[name], b[k][:p[name].shape[0]])
    np.testing.assert_array_equal(p["b_head"][:2], b[4][:2])
    with pytest.raises(ValueError):
        F.pack_fused_decoder(t_dec, torch.float16)


def _b_desc(addr):
    """csrc/decoder_bf16.cu ``b_desc``: wgmma's 64-bit shared-memory
    descriptor of a K-major B operand, layout type 0 (no swizzle)."""
    return ((addr & 0x3FFFF) >> 4) | ((128 >> 4) << 16) | ((256 >> 4) << 32)


def _wgmma_b_read(smem, desc, n):
    """The (16, n) B operand of one m64nNk16 bf16 wgmma, read from the byte
    array ``smem`` as the hardware reads a K-major operand through ``desc``:
    8 x 8 core matrices of 16-byte rows (one per column), the two k halves
    LBO bytes apart, 8-column groups SBO bytes apart."""
    start = (desc & 0x3FFF) << 4
    lbo, sbo = ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    assert desc >> 62 == 0 and (desc >> 49) & 7 == 0, "no swizzle, base offset 0"
    k, c = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    addr = start + (k // 8) * lbo + (c // 8) * sbo + (c % 8) * 16 + (k % 8) * 2
    bits = smem[addr].astype(np.uint32) | (smem[addr + 1].astype(np.uint32) << 8)
    return (bits << 16).view(np.float32)


def test_bf16_fragments_read_back_by_the_kernels_indexing(decoders):
    """The bf16 pack's kernel segment, copied whole into shared memory as
    the kernels' TMA copies place it, reads back through the kernels' own
    wgmma descriptors (matrix l at byte mat_off(l), k-step s N x 32 bytes
    on) as each of the seven weight matrices, bit for bit, in stream order."""
    *_, t_dec = decoders
    p = F.unpack(F.pack_fused_decoder(t_dec, torch.bfloat16))
    smem = p["tc"].contiguous().view(torch.uint8).numpy()
    off = 0
    for name in F.TC_LAYERS:
        k, n = dict(F._SEGMENTS)[name]
        got = np.concatenate([_wgmma_b_read(smem, _b_desc(off + s * n * 32), n)
                              for s in range(k // 16)])
        np.testing.assert_array_equal(got, p[name].numpy(), err_msg=name)
        off += k * n * 2
    assert off == smem.size


def _header_constants():
    """The ``constexpr int`` constants of csrc/decoder_pack.cuh, evaluated in
    order (their expressions use + * / of the ones before)."""
    src = (Path(F.__file__).resolve().parents[1] / "csrc/decoder_pack.cuh").read_text()
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_offsets_match_the_kernels_header(dtype):
    """Each OFF_* of the header that kernels 1 and 3 read in both modes is
    where ops/decoder_fused.py puts the segment, and the mode's size
    (PACKED_SIZE / PACKED_SIZE_BF16) is the pack's."""
    env = _header_constants()
    seg = {"OFF_W3XYZ": "w3_xyz", "OFF_W0XYZ": "w0_xyz", "OFF_WSDF": "w_sdf",
           "OFF_WSTD": "w_std", "OFF_BHEAD": "b_head"}
    starts, off = {}, 0
    for name, shape in F._SEGMENTS:
        starts[name] = off
        off += int(torch.Size(shape).numel())
    offs = {k: v for k, v in env.items() if k.startswith("OFF_")}
    assert len(offs) == len(F._SEGMENTS)
    for k, v in offs.items():
        assert v == starts[seg.get(k, k[4:].lower())], k
    if dtype == torch.bfloat16:
        assert env["PACKED_SIZE_BF16"] == F.PACKED_SIZE_BF16
        assert starts["tc"] + env["TC_FLOATS"] // 4 == F.PACKED_SIZE_BF16
    else:
        assert env["PACKED_SIZE"] == F.PACKED_SIZE
        assert starts["tc"] + env["TC_FLOATS"] == F.PACKED_SIZE


def _close_grad(got, ref):
    err = np.abs(got - ref).max(axis=1)
    assert np.mean(err <= 1e-2) >= 0.99, np.sort(err)[-10:]
    np.testing.assert_allclose(got, ref, atol=0.15, rtol=0.05)


@pytest.mark.parametrize("inputs", ["kernel1", "kernel3"])
def test_plain_bf16_matches_jax_kernels(decoders, inputs):
    """Kernel 1's and kernel 3's plain bf16 versions against the Pallas
    kernels with a bf16 w_stack (interpret mode), at the input ranges of
    each kernel's path."""
    dec, spec, t_dec = decoders
    lat, rel = _inputs(1, *((-0.5, 0.5) if inputs == "kernel1" else (-1.0, 0.75)))
    pk = F.pack_fused_decoder(t_dec, torch.bfloat16)
    js, jd, jg = JF.decode_grad_fused(dec, spec, jnp.asarray(lat), jnp.asarray(rel),
                                      compute_dtype=jnp.bfloat16, tile=256, interpret=True)
    ts, td, tg = F.decode_grad_fused(pk, torch.from_numpy(lat), torch.from_numpy(rel))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    _close_grad(tg.numpy(), np.asarray(jg))
    js, jd = JF.decode_fused(dec, spec, jnp.asarray(lat), jnp.asarray(rel),
                             compute_dtype=jnp.bfloat16, tile=256, interpret=True)
    ts, td = F.decode_fused(pk, torch.from_numpy(lat), torch.from_numpy(rel))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    # the mode matters: the f32 mode is further from the JAX bf16 kernel
    fs, _ = F.decode_fused(F.pack_fused_decoder(t_dec), torch.from_numpy(lat),
                           torch.from_numpy(rel))
    js = torch.from_numpy(np.array(js))
    assert (fs - js).abs().mean() > 2 * (ts - js).abs().mean()


def test_decode_bf16_matches_jax_decode(decoders):
    """``Decoder.decode(compute_dtype=bfloat16)`` against the JAX package's
    ``decode(compute_dtype=bfloat16)`` (jitted), and autograd through it
    against ``jax.vjp`` of sdf w.r.t. xyz: the route of the SDF term with
    ``sdf_fused`` off."""
    dec, spec, t_dec = decoders
    lat, rel = _inputs(2)
    f = jax.jit(lambda l, x: jax_decode(dec, spec, l, x, compute_dtype=jnp.bfloat16))
    js, jd = f(jnp.asarray(lat), jnp.asarray(rel))
    xyz = torch.from_numpy(rel).requires_grad_(True)
    ts, td = t_dec.decode(torch.from_numpy(lat), xyz, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), atol=ATOL, rtol=0)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    tg, = torch.autograd.grad(ts, xyz, grad_outputs=torch.ones_like(ts))
    _, vjp = jax.vjp(lambda x: f(jnp.asarray(lat), x)[0], jnp.asarray(rel))
    jg, = vjp(jnp.ones(N, jnp.float32))
    _close_grad(tg.numpy(), np.asarray(jg))
    with pytest.raises(ValueError):
        t_dec.decode(torch.from_numpy(lat), xyz, compute_dtype=torch.float16)
