"""The port's prior trainer against the JAX package on the CPU, at a small
size (decoder dims (32,)*4, batch 4, 64 samples): the train forms of the
networks, the losses and schedules, one train step (with and without
dropout masks drawn by the JAX recipe), the SIREN loss's double backward,
a 5-step ``train()`` of each package from the same JAX checkpoint, the
checkpoint files both ways, the LIF loaders and the segment helpers.
Nothing random is compared across the packages: draws are made once and
given to both."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import jax
import jax.numpy as jnp
import torch

from difusion_tpu.models import decoder as JD
from difusion_tpu.models import encoder as JE
from difusion_tpu.models import torch_import as JTI
from difusion_tpu.ops import segment as JS
from difusion_tpu.train import lif_dataset as jldata
from difusion_tpu.train import losses as JL
from difusion_tpu.train import lr_schedule as JLR
from difusion_tpu.train import trainer as JTR
from difusion_tpu_torch.models import decoder as D
from difusion_tpu_torch.models import encoder as E
from difusion_tpu_torch.models import weights as W
from difusion_tpu_torch.ops import segment as S
from difusion_tpu_torch.train import lif_dataset as ldata
from difusion_tpu_torch.train import losses as L
from difusion_tpu_torch.train import lr_schedule as LR
from difusion_tpu_torch.train import trainer as TR
from difusion_tpu_torch.utils.meters import LossMeter

ROOT = Path(__file__).resolve().parents[1]
# latent 13 + xyz = 16 columns, so the layer before latent_in keeps 16 of 32
HYPER_NETS = dict(
    code_length=13,
    network_specs=dict(dims=[32, 32, 32, 32], dropout=[0, 1, 2, 3, 4, 5],
                       dropout_prob=0.2, norm_layers=[0, 1, 2, 3, 4, 5],
                       latent_in=[3], weight_norm=True),
    encoder_specs=dict(per_point_feat=[6, 16, 16, 32], latent_size=13))
SPEC_D = D.DecoderSpec.from_hyper(HYPER_NETS)
SPEC_E = E.EncoderSpec.from_hyper(HYPER_NETS)
JSPEC_D = JD.DecoderSpec.from_hyper(HYPER_NETS)
JSPEC_E = JE.EncoderSpec.from_hyper(HYPER_NETS)
B, NS, NSURF = 4, 64, 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several workers at once: two threads each keep
    them from crowding the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _jax_params(seed=0):
    kd, ke = jax.random.split(jax.random.key(seed))
    return (_np_tree(JD.init_decoder_params(JSPEC_D, kd)),
            _np_tree(JE.init_encoder_params(JSPEC_E, ke)))


def _batch(seed=0):
    """A batch as the LIF loader gives it: (B, S, 4) xyz+sdf, (B, N, 6)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, (B, NS, 3)).astype(np.float32)
    sdf = (np.linalg.norm(xyz, axis=-1, keepdims=True) - 0.6).astype(np.float32)
    n = rng.normal(size=(B, NSURF, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    surf = np.concatenate([0.6 * n, n], -1).astype(np.float32)
    surf[..., :3] += rng.normal(0, 0.02, (B, NSURF, 3)).astype(np.float32)
    return np.concatenate([xyz, sdf], -1), surf


def _jax_masks(key, n_rows):
    """The dropout keeps the JAX decoder draws from ``key``."""
    ins, outs = JSPEC_D.layer_dims()
    keep = 1.0 - JSPEC_D.dropout_prob
    return {i: np.array(jax.random.bernoulli(jax.random.fold_in(key, i), keep,
                                               (n_rows, outs[i])))
            for i in JSPEC_D.dropout if i < len(outs) - 1}


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def test_init_forms_and_carrier_round_trip():
    """init draws a tree of the JAX layout with torch's Linear bounds; the
    modules' to_params gives it back bit for bit."""
    gen = torch.Generator().manual_seed(3)
    dec_t, enc_t = D.init_decoder_params(SPEC_D, gen), E.init_encoder_params(SPEC_E, gen)
    jdec, jenc = _jax_params()
    assert jax.tree.structure(dec_t) == jax.tree.structure(jdec)
    assert jax.tree.structure(enc_t) == jax.tree.structure(jenc)
    for a, b in zip(_leaves(dec_t), _leaves(jdec)):
        assert a.shape == b.shape and a.dtype == np.float32
    ins, _ = SPEC_D.layer_dims()
    for layer, din in zip(dec_t["layers"], ins):
        assert np.abs(layer["v"]).max() <= 1 / np.sqrt(din)
        np.testing.assert_allclose(layer["g"], np.linalg.norm(layer["v"], axis=1), rtol=1e-6)
    for tree, mod in ((dec_t, D.DecoderTrain(SPEC_D, dec_t)),
                      (enc_t, E.EncoderTrain(SPEC_E, enc_t))):
        for a, b in zip(_leaves(tree), _leaves(mod.to_params())):
            np.testing.assert_array_equal(a, b)


def test_decode_train_with_jax_masks_and_encode_train():
    """decode_train with the JAX recipe's masks, encode_train's codes and
    running statistics: within 1e-5."""
    jdec, jenc = _jax_params(1)
    sdf, surf = _batch(1)
    n = 500
    rng = np.random.default_rng(2)
    net_in = rng.normal(0, 0.5, (n, SPEC_D.input_dim)).astype(np.float32)
    key = jax.random.key(7)
    masks = _jax_masks(key, n)
    j_sdf, j_std = jax.jit(lambda p, x, k: JD.decode_train(p, JSPEC_D, x, k))(
        jax.tree.map(jnp.asarray, jdec), jnp.asarray(net_in), key)
    dec = D.DecoderTrain(SPEC_D, jdec)
    t_sdf, t_std = dec(torch.from_numpy(net_in),
                       masks={i: torch.from_numpy(m) for i, m in masks.items()})
    np.testing.assert_allclose(t_sdf.detach().numpy(), np.asarray(j_sdf), atol=1e-5)
    np.testing.assert_allclose(t_std.detach().numpy(), np.asarray(j_std), atol=1e-5)
    # no masks, no generator: no dropout, the folded decoder's forward
    t_sdf0, _ = dec(torch.from_numpy(net_in))
    folded = D.Decoder(SPEC_D, D.fold_decoder_params(jdec))
    f_sdf, _ = folded.decode(torch.from_numpy(net_in[:, :13]), torch.from_numpy(net_in[:, 13:]))
    np.testing.assert_allclose(t_sdf0[:, 0].detach().numpy(), f_sdf.numpy(), atol=1e-5)

    codes_j, new_j = jax.jit(JE.encode_train)(jax.tree.map(jnp.asarray, jenc),
                                              jnp.asarray(surf))
    enc = E.EncoderTrain(SPEC_E, jenc)
    codes_t = enc(torch.from_numpy(surf))
    np.testing.assert_allclose(codes_t.detach().numpy(), np.asarray(codes_j), atol=1e-5)
    for a, b in zip(_leaves(enc.to_params()), _leaves(new_j)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    # torch's BatchNorm1d on (B, C, N) is the same normalisation and update
    bn = torch.nn.BatchNorm1d(SPEC_E.per_point_feat[1], eps=1e-5, momentum=0.1)
    x = torch.from_numpy(surf) @ torch.from_numpy(jenc["layers"][0]["w"]).T
    y = bn(x.transpose(1, 2)).transpose(1, 2)
    ref = torch.relu(y) @ torch.from_numpy(jenc["layers"][1]["w"]).T
    enc2 = E.EncoderTrain(SPEC_E, jenc)
    x2 = torch.relu((x - x.mean((0, 1))) / torch.sqrt(x.var((0, 1), unbiased=False) + 1e-5))
    np.testing.assert_allclose((x2 @ enc2.layers[1].w.T).detach().numpy(),
                               ref.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(enc.layers[0].bn_var.numpy(), bn.running_var.numpy(), rtol=1e-6)
    np.testing.assert_allclose(enc.layers[0].bn_mean.numpy(), bn.running_mean.numpy(),
                               atol=1e-7)


def test_losses_and_schedules():
    """Every loss at 1e-6 relative; the lr schedules exactly."""
    rng = np.random.default_rng(4)
    n = 256
    pd = rng.uniform(-0.4, 0.4, (n, 1)).astype(np.float32)
    std = rng.uniform(0.05, 0.5, (n, 1)).astype(np.float32)
    gt = rng.uniform(-0.4, 0.4, (n, 1)).astype(np.float32)
    lat = rng.normal(size=(n, 13)).astype(np.float32)
    grad = rng.normal(size=(n, 3)).astype(np.float32)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals[::3] = 0.0
    cfg_j, cfg_t = JL.LossConfig(), L.LossConfig()
    ns = float(n)
    for epoch in (1, 37, 250):
        pairs = [
            (jax.jit(lambda p, g: JL.l1_loss(cfg_j, p, g, ns))(pd, gt),
             L.l1_loss(cfg_t, torch.from_numpy(pd), torch.from_numpy(gt), ns)),
            (jax.jit(lambda p, s, g: JL.neg_log_likelihood(cfg_j, p, s, g, ns))(pd, std, gt),
             L.neg_log_likelihood(cfg_t, *map(torch.from_numpy, (pd, std, gt)), ns)),
            (jax.jit(lambda v, e: JL.reg_loss(cfg_j, v, e, ns))(lat, jnp.float32(epoch)),
             L.reg_loss(cfg_t, torch.from_numpy(lat), epoch, ns)),
            (jax.jit(lambda p, g, nn: JL.siren_loss(cfg_j, p, g, nn, ns))(pd, grad, normals),
             L.siren_loss(cfg_t, *map(torch.from_numpy, (pd, grad, normals)), ns)),
        ]
        for j, t in pairs:
            assert set(j) == set(t)       # jit returns the dict's keys sorted
            for k in j:
                np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-6, err_msg=k)
    specs = [{"Type": "Step", "Initial": 1e-3, "Interval": 80, "Factor": 0.4},
             {"Type": "Warmup", "Initial": 1e-4, "Final": 1e-3, "Length": 10},
             {"Type": "Constant", "Value": 5e-4}]
    for sj, st in zip(JLR.get_learning_rate_schedules(specs),
                      LR.get_learning_rate_schedules(specs)):
        assert [sj(e) for e in range(0, 400, 7)] == [st(e) for e in range(0, 400, 7)]
    with pytest.raises(ValueError):
        LR.make_schedule({"Type": "Cosine"})


def _jax_grads(jdec, jenc, sdf, surf, key, epoch, cfg):
    """The gradient of the JAX trainer's loss (its train_step's loss_fn)."""
    Bn, Sn, _ = sdf.shape
    xyz = sdf[:, :, :3].reshape(-1, 3)
    gt = sdf[:, :, 3:].reshape(Bn * Sn, -1)
    ns = jnp.float32(Bn * Sn)

    def loss_fn(params):
        codes, _ = JE.encode_train(params["enc"], surf)
        lat = jnp.repeat(codes, Sn, axis=0)

        def decode_at(x):
            return JD.decode_train(params["dec"], JSPEC_D, jnp.concatenate([lat, x], 1), key)
        if "siren_loss" in cfg.types:
            (pd, pstd), vjp_fn = jax.vjp(decode_at, xyz)
            (pg,) = vjp_fn((jnp.ones_like(pd), jnp.zeros_like(pstd)))
            losses = JL.siren_loss(cfg, pd, pg, gt, ns)
        else:
            pd, pstd = decode_at(xyz)
            losses = {**JL.neg_log_likelihood(cfg, pd, pstd, gt[:, :1], ns),
                      **JL.reg_loss(cfg, lat, epoch, ns)}
        return sum(losses.values())
    params = {"dec": jax.tree.map(jnp.asarray, jdec), "enc": jax.tree.map(jnp.asarray, jenc)}
    return jax.jit(jax.grad(loss_fn))(params)


def _port_grad_tree(grads, jdec, jenc):
    """The port's gradient by name, in the JAX tree's layout (the BatchNorm
    statistics, which no loss reads, as zeros)."""
    def layer_tree(prefix, layers):
        return [{k: (grads[f"{prefix}.layers.{i}.{k}"].numpy()
                     if f"{prefix}.layers.{i}.{k}" in grads else np.zeros_like(v))
                 for k, v in layer.items()} for i, layer in enumerate(layers)]
    dec = {"layers": layer_tree("dec", jdec["layers"]),
           "uncertainty": {k: grads[f"dec.uncertainty.{k}"].numpy() for k in ("w", "b")}}
    return {"dec": dec, "enc": {"layers": layer_tree("enc", jenc["layers"])}}


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "jax_masks"])
def test_train_step_matches_jax(dropout):
    """One train_step from the same parameters and batch: every gradient leaf
    within 1e-4 x the leaf's largest |g|; after the step, entries whose JAX
    gradient exceeds 1e-3 x the leaf's largest within 1e-6 and every entry
    within 2 lr (Adam's first step moves an entry by ~lr whatever its
    gradient's size, so a tiny gradient's sign decides it); the BatchNorm
    buffers within 1e-6; the losses at 1e-5 relative."""
    jdec, jenc = _jax_params(2)
    sdf, surf = _batch(2)
    hyper = dict(HYPER_NETS)
    if not dropout:
        hyper["network_specs"] = dict(hyper["network_specs"], dropout_prob=0.0)
    jspec = JD.DecoderSpec.from_hyper(hyper)
    spec = D.DecoderSpec.from_hyper(hyper)
    cfg_j, cfg_t = JL.LossConfig(), L.LossConfig()
    key = jax.random.key(11)
    lr_dec, lr_enc, epoch = 1e-3, 5e-4, 3

    state_j = JTR.TrainState(jax.tree.map(jnp.asarray, jdec), jax.tree.map(jnp.asarray, jenc),
                             JTR._optimizer().init({"dec": jdec, "enc": jenc}),
                             jnp.zeros((), jnp.int32))
    new_j, losses_j = JTR.train_step(jspec, cfg_j, state_j, jnp.asarray(sdf), jnp.asarray(surf),
                                     key, jnp.float32(lr_dec), jnp.float32(lr_enc),
                                     jnp.float32(epoch))
    masks = ({i: torch.from_numpy(m) for i, m in _jax_masks(key, B * NS).items()}
             if dropout else None)

    g_global = globals()
    g_global["JSPEC_D"], saved = jspec, JSPEC_D
    try:
        grads_j = _jax_grads(jdec, jenc, jnp.asarray(sdf), jnp.asarray(surf), key,
                             jnp.float32(epoch), cfg_j)
    finally:
        g_global["JSPEC_D"] = saved
    probe = TR.state_from_params(spec, SPEC_E, jdec, jenc, torch.device("cpu"))
    _, grads_t = TR.loss_and_grads(cfg_t, probe, torch.from_numpy(sdf),
                                   torch.from_numpy(surf), epoch, masks=masks)
    for gj, gt in zip(_leaves(grads_j), _leaves(_port_grad_tree(grads_t, jdec, jenc))):
        scale = np.abs(gj).max()
        assert np.abs(gt - gj).max() <= 1e-4 * scale + 1e-12, (np.abs(gt - gj).max(), scale)

    state = TR.state_from_params(spec, SPEC_E, jdec, jenc, torch.device("cpu"))
    state, losses_t = TR.train_step(cfg_t, state, torch.from_numpy(sdf),
                                    torch.from_numpy(surf), lr_dec, lr_enc, epoch, masks=masks)
    assert state.step == 1 and list(losses_t) == list(losses_j)
    for k in losses_j:
        np.testing.assert_allclose(float(losses_t[k]), float(losses_j[k]), rtol=1e-5, err_msg=k)
    after_j = {"dec": new_j.dec_params, "enc": new_j.enc_params}
    after_t = {"dec": state.dec.to_params(), "enc": state.enc.to_params()}
    flat_g = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(after_j)[0]
    flat_t = jax.tree.leaves(after_t)
    for (path, gj), (_, pj), pt in zip(flat_g, flat_j, flat_t):
        name = jax.tree_util.keystr(path)
        pj, gj = np.asarray(pj), np.asarray(gj)
        lr = lr_dec if name.startswith("['dec']") else lr_enc
        if "bn_mean" in name or "bn_var" in name:
            np.testing.assert_allclose(pt, pj, atol=1e-6, err_msg=name)
            continue
        assert np.abs(pt - pj).max() <= 2 * lr, name
        big = np.abs(gj) > 1e-3 * np.abs(gj).max()
        np.testing.assert_allclose(pt[big], pj[big], atol=1e-6, err_msg=name)


def test_siren_loss_double_backward():
    """siren_loss through d sdf / d xyz: the losses and the parameter
    gradient of the double backward against jax.vjp inside jax.grad."""
    hyper = dict(HYPER_NETS, network_specs=dict(HYPER_NETS["network_specs"], dropout_prob=0.0))
    spec = D.DecoderSpec.from_hyper(hyper)
    jdec, jenc = _jax_params(5)
    sdf, surf = _batch(5)
    # siren batches carry normals in place of the sdf; a third off-surface
    normals = surf[:, :1, 3:6].repeat(NS, axis=1)
    normals[:, ::3] = 0.0
    sdf = np.concatenate([sdf[..., :3], normals], -1)
    cfg_j = JL.LossConfig(types=("siren_loss",))
    cfg_t = L.LossConfig(types=("siren_loss",))
    g_global = globals()
    g_global["JSPEC_D"], saved = JD.DecoderSpec.from_hyper(hyper), JSPEC_D
    try:
        grads_j = _jax_grads(jdec, jenc, jnp.asarray(sdf), jnp.asarray(surf),
                             jax.random.key(0), jnp.float32(1), cfg_j)
    finally:
        g_global["JSPEC_D"] = saved
    state = TR.state_from_params(spec, SPEC_E, jdec, jenc, torch.device("cpu"))
    losses_t, grads_t = TR.loss_and_grads(cfg_t, state, torch.from_numpy(sdf),
                                          torch.from_numpy(surf), 1)
    assert set(losses_t) >= {"sdf_in", "sdf_out", "normal", "eikonal"}
    for gj, gt in zip(_leaves(grads_j), _leaves(_port_grad_tree(grads_t, jdec, jenc))):
        scale = np.abs(gj).max()
        assert np.abs(gt - gj).max() <= 1e-4 * scale + 1e-12, (np.abs(gt - gj).max(), scale)


def make_lif_dir(path, n_lifs=12, seed=0):
    """Sphere-cap SDFs in voxel-local coordinates, the reference payload
    format (tests/test_trainer.py's make_synthetic_lif_dir)."""
    rng = np.random.default_rng(seed)
    payload = path / "payload"
    payload.mkdir(parents=True)
    for i in range(n_lifs):
        r = rng.uniform(0.2, 0.4)
        c = rng.uniform(-0.15, 0.15, 3)
        xyz = rng.uniform(-0.5, 0.5, (800, 3)).astype(np.float32)
        sdf = (np.linalg.norm(xyz - c, axis=1) - r).astype(np.float32)
        dirs = rng.normal(size=(600, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        surf = np.concatenate([(c + dirs * r).astype(np.float32),
                               dirs.astype(np.float32)], axis=1)
        np.savez(payload / ("%08d.npz" % i), data=np.concatenate([xyz, sdf[:, None]], 1),
                 surface=surf)
    (path / "source.json").write_text(json.dumps([f"lif_{i}" for i in range(n_lifs)]))
    return path


def _hyper(lif_dir, save_dir, **kw):
    hyper = dict(
        run_name="t", num_epochs=2, batch_size=B, batch_split=1, samples_per_lif=NS,
        lr_schedule=[{"Type": "Step", "Initial": 1e-3, "Interval": 80, "Factor": 0.4},
                     {"Type": "Constant", "Value": 1e-3}],
        train_set=[{"data_path": "cached$local://" + str(lif_dir), "augment_rotation": "Y",
                    "num_surface_sample": NSURF, "augment_noise": [0.01, 20.0]}],
        code_bound=None, network_name="di_decoder", encoder_name="di_encoder",
        snapshot_frequency=1, additional_snapshots=[], upload_dtype="float16",
        training_loss=dict(types=["neg_log_likelihood", "reg_loss"], enforce_minmax=True,
                           clamping_distance=0.2, code_reg_lambda=0.01),
        save_dir=str(save_dir), **HYPER_NETS)
    hyper.update(kw)
    return hyper


# the JAX trainer in a process of its own (as tests/test_trainer.py runs it),
# on one device (no data-parallel mesh), recording the batches it trains on
_JAX_TRAIN = """
import json, sys
import numpy as np
import difusion_tpu.utils.jaxtools as jt
jt.enable_persistent_compilation_cache = lambda: None
from difusion_tpu.train import trainer as TR
seen = []
step = TR.train_step
def recording(spec, cfg, state, sdf, surf, *rest):
    seen.append((np.asarray(sdf), np.asarray(surf)))
    return step(spec, cfg, state, sdf, surf, *rest)
TR.train_step = recording
TR.train(json.load(open(sys.argv[1])), max_steps=5, log_every=1)
np.savez(sys.argv[2], **{f"sdf{i}": a for i, (a, _) in enumerate(seen)},
         **{f"surf{i}": b for i, (_, b) in enumerate(seen)})
"""


def test_train_five_steps_resumed_from_jax_checkpoint(tmp_path):
    """A 5-step train() of each package, resumed from the same prior_1.npz
    (written by the JAX package's save_checkpoint, its training_1.npz
    removed), dropout 0: the batches bit-equal, every logged loss within
    1e-3 relative; then the port's checkpoint files: prior_E.npz read by
    the JAX package's load_params_npz and decoded the same within 1e-6,
    the .pth.tar round trip and its keys, and resume within the port."""
    lif_dir = make_lif_dir(tmp_path / "lifs")
    hyper = _hyper(lif_dir, tmp_path / "x", resume_epoch=1, num_epochs=3)
    hyper["network_specs"] = dict(hyper["network_specs"], dropout_prob=0.0)
    jdec, jenc = _jax_params(4)
    for run in ("jax", "port"):
        st = JTR.TrainState(jax.tree.map(jnp.asarray, jdec), jax.tree.map(jnp.asarray, jenc),
                            JTR._optimizer().init({"dec": jdec, "enc": jenc}),
                            jnp.zeros((), jnp.int32))
        JTR.save_checkpoint(tmp_path / run, 1, st, hyper)
        (tmp_path / run / "training_1.npz").unlink()
    (tmp_path / "jax.json").write_text(json.dumps(dict(hyper, save_dir=str(tmp_path / "jax"))))
    env = dict(os.environ, XLA_FLAGS="", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_TRAIN, str(tmp_path / "jax.json"),
                           str(tmp_path / "jax_batches.npz")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]

    seen = []
    step = TR.train_step

    def recording(cfg, state, sdf, surf, *rest, **kw):
        seen.append((sdf.numpy().copy(), surf.numpy().copy()))
        return step(cfg, state, sdf, surf, *rest, **kw)
    TR.train_step = recording
    try:
        state = TR.train(dict(hyper, save_dir=str(tmp_path / "port")), max_steps=5,
                         log_every=1, device="cpu")
    finally:
        TR.train_step = step
    assert state.step == 5 and len(seen) == 5
    with np.load(tmp_path / "jax_batches.npz") as jb:
        for i, (sdf, surf) in enumerate(seen):
            assert sdf.dtype == np.float16 and surf.dtype == np.float16
            np.testing.assert_array_equal(sdf, jb[f"sdf{i}"])
            np.testing.assert_array_equal(surf, jb[f"surf{i}"])
    rows = {run: [json.loads(x) for x in (tmp_path / run / "metrics.jsonl").read_text()
                  .splitlines()] for run in ("jax", "port")}
    assert len(rows["port"]) == len(rows["jax"]) == 5
    for rj, rt in zip(rows["jax"], rows["port"]):
        assert set(rj) == set(rt) and rj["it"] == rt["it"] and rj["epoch"] == rt["epoch"]
        for k in ("ll", "reg", "surface_abs_sdf", "total"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-3, err_msg=k)

    # epoch 2 ran 3 steps (12 LIFs / 4), epoch 3 the last 2: its snapshot is
    # the final state
    port = tmp_path / "port"
    assert {p.name for p in port.iterdir()} >= {
        "prior_3.npz", "model_3.pth.tar", "encoder_3.pth.tar", "hyper.json",
        "training_3.npz", "metrics.jsonl"}
    trees = JTI.load_params_npz(str(port / "prior_3.npz"))
    dec_t, enc_t = state.dec.to_params(), state.enc.to_params()
    for a, b in zip(_leaves(trees["decoder"]), _leaves(dec_t)):
        np.testing.assert_array_equal(a, b)
    folded_j = JD.fold_decoder_params(jax.tree.map(jnp.asarray, trees["decoder"]))
    rng = np.random.default_rng(0)
    lat = rng.normal(0, 0.3, (300, 13)).astype(np.float32)
    xyz = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    sj, dj = JD.decode(folded_j, JSPEC_D, jnp.asarray(lat), jnp.asarray(xyz))
    dec, enc, spec = W.load_prior(port / "hyper.json", 3, device="cpu")
    st_, dt_ = dec.decode(torch.from_numpy(lat), torch.from_numpy(xyz))
    np.testing.assert_allclose(st_.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), atol=1e-6)
    # .pth.tar: the reference's keys, and the same trees back
    dsd = torch.load(port / "model_3.pth.tar", weights_only=True)["model_state"]
    esd = torch.load(port / "encoder_3.pth.tar", weights_only=True)["model_state"]
    assert dsd["lin0.weight_g"].shape == (32, 1) and "lin4.weight_v" in dsd
    assert {"uncertainty_layer.weight", "uncertainty_layer.bias"} <= set(dsd)
    assert esd["mlp.layer0.conv.weight"].shape == (16, 6, 1)
    assert "mlp.layer2.normlayer.bn.running_var" in esd and "mlp.layer3.conv.bias" in esd
    d2, e2, _, _, _ = W.load_torch_prior(port / "hyper.json", 3)
    for a, b in zip(_leaves(d2) + _leaves(e2), _leaves(dec_t) + _leaves(enc_t)):
        np.testing.assert_array_equal(a, b)
    jd2, je2, _, _, _ = JTI.load_torch_prior(str(port / "hyper.json"), 3)
    for a, b in zip(_leaves(jd2) + _leaves(je2), _leaves(dec_t) + _leaves(enc_t)):
        np.testing.assert_array_equal(a, b)
    # load_prior reads .pth.tar where there is no npz
    (port / "prior_3.npz").rename(port / "held.npz")
    dec2, _, _ = W.load_prior(port / "hyper.json", 3, device="cpu")
    s2, _ = dec2.decode(torch.from_numpy(lat), torch.from_numpy(xyz))
    np.testing.assert_array_equal(s2.numpy(), st_.numpy())
    (port / "held.npz").rename(port / "prior_3.npz")
    # resume within the port: the optimizer's moments and step come back
    back = TR.load_checkpoint(port, 3, spec, E.EncoderSpec.from_hyper(HYPER_NETS), "cpu")
    assert back.step == 5
    for name, (mu, nu) in state.opt.items():
        assert torch.equal(back.opt[name][0], mu) and torch.equal(back.opt[name][1], nu)
    # the JAX package's training_E.npz is not the port's layout: refused
    JTR.save_checkpoint(tmp_path / "jx", 1, JTR.TrainState(
        jax.tree.map(jnp.asarray, jdec), jax.tree.map(jnp.asarray, jenc),
        JTR._optimizer().init({"dec": jdec, "enc": jenc}), jnp.zeros((), jnp.int32)), hyper)
    with pytest.raises(ValueError, match="optimizer state"):
        TR.load_checkpoint(tmp_path / "jx", 1, spec, SPEC_E, "cpu")


def test_trainer_cli_on_the_cpu(tmp_path):
    """python -m difusion_tpu_torch.train.trainer <yaml> --device cpu runs a
    one-epoch training end to end and writes its snapshot; without
    --device it needs a card."""
    lif_dir = make_lif_dir(tmp_path / "lifs", n_lifs=8)
    hyper = _hyper(lif_dir, tmp_path / "out", num_epochs=1)
    (tmp_path / "h.json").write_text(json.dumps(hyper))
    proc = subprocess.run([sys.executable, "-m", "difusion_tpu_torch.train.trainer",
                           str(tmp_path / "h.json"), "--device", "cpu",
                           "--set", "samples_per_lif=32"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "out" / "prior_1.npz").exists()
    assert json.loads((tmp_path / "out" / "hyper.json").read_text())["samples_per_lif"] == 32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TR.main([str(tmp_path / "h.json")])


def test_lif_loaders_bit_equal_and_prefetch(tmp_path):
    """Given one numpy seed the port's loaders give the JAX package's batches
    bit for bit (per item and packed, combined, cached$ scheme, disk pack
    cache); prefetch_device casts to the upload dtype, keeps the order and
    stops its worker when the consumer leaves early."""
    import threading
    import time
    d = make_lif_dir(tmp_path / "lifs", n_lifs=9, seed=1)
    kw = dict(num_sample=33, num_surface_sample=16, augment_noise=(0.01, 20.0))
    for rot in (None, "Y", "X", "Z", "3D"):
        mk = [(pkg.LifDataset("cached$local://" + str(d), augment_rotation=rot, **kw),
               pkg.LifDataset(str(d), augment_rotation="Y", **kw)) for pkg in (jldata, ldata)]
        (ja, jb), (ta, tb) = mk
        np.testing.assert_array_equal(ja[3][0], ta[3][0])
        np.testing.assert_array_equal(ja[3][1], ta[3][1])
        jc, tc = jldata.LifCombinedDataset(ja, jb), ldata.LifCombinedDataset(ta, tb)
        for (a, b, c), (x, y, z) in zip(
                jldata.iterate_batches(jc, 4, np.random.default_rng(2)),
                ldata.iterate_batches(tc, 4, np.random.default_rng(2))):
            np.testing.assert_array_equal(a, x)
            np.testing.assert_array_equal(b, y)
            np.testing.assert_array_equal(c, z)
        jp, tp = jldata.pack_dataset(jc), ldata.pack_dataset(tc)
        for (a, b, c), (x, y, z) in zip(
                jldata.iterate_batches_packed(jp, 4, np.random.default_rng(3)),
                ldata.iterate_batches_packed(tp, 4, np.random.default_rng(3))):
            np.testing.assert_array_equal(a, x)
            np.testing.assert_array_equal(b, y)
            np.testing.assert_array_equal(c, z)
    assert (d / "packed_cache" / "meta.json").exists()
    again = ldata.PackedLifDataset(ldata.LifDataset(str(d), **kw))
    assert isinstance(again.pos, np.memmap)

    batches = list(ldata.iterate_batches_packed(tp, 3, np.random.default_rng(5)))
    got = list(ldata.prefetch_device(iter(batches), "cpu", np.float16))
    assert len(got) == len(batches)
    for (s, f, i), (a, b, c) in zip(got, batches):
        assert s.dtype == torch.float16 and torch.equal(s, torch.from_numpy(a.astype(np.float16)))
        assert torch.equal(f, torch.from_numpy(b.astype(np.float16)))
        np.testing.assert_array_equal(i, c)
    n_alive = threading.active_count()
    gen = ldata.prefetch_device(iter(batches * 100), "cpu")
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > n_alive and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_alive

    def broken():
        yield batches[0]
        raise OSError("disk")
    with pytest.raises(OSError, match="disk"):
        list(ldata.prefetch_device(broken(), "cpu"))


def test_loss_meter_json_round_trip(tmp_path):
    m = LossMeter(ewma_alpha=0.8)
    for v in (1.0, 2.0, float("nan"), None, 4.0):
        m.update({"ll": v, "reg": 0.5})
    assert m.count("ll") == 3 and m.count("reg") == 5
    assert abs(m.mean()["ll"] - 7 / 3) < 1e-12 and m.last()["ll"] == 4.0
    back = LossMeter.from_json(m.to_json(str(tmp_path / "m.json")))
    again = LossMeter.from_json(str(tmp_path / "m.json"))
    for other in (back, again):
        assert other.mean() == m.mean() and other.ewma() == m.ewma()
        assert other.std("ll") == m.std("ll") and other.summary() == m.summary()


def test_segment_helpers_match_jax():
    """segment_mean, pack_batch, groupby_max and pack_samples against the JAX
    package's, pack_samples with the JAX key's own draws passed in."""
    rng = np.random.default_rng(6)
    n, nseg = 200, 12
    ids = rng.integers(-1, nseg + 1, n).astype(np.int32)
    vals = rng.normal(size=(n, 5)).astype(np.float32)
    w = rng.uniform(0, 2, n).astype(np.float32)
    valid = rng.random(n) > 0.2
    for weights in (None, w):
        jm, jc = JS.segment_mean(jnp.asarray(vals), jnp.asarray(ids), nseg,
                                 None if weights is None else jnp.asarray(weights))
        tm, tc = S.segment_mean(torch.from_numpy(vals), torch.from_numpy(ids), nseg,
                                None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    for v in (None, valid):
        jp, jc = JS.pack_batch(jnp.asarray(ids), nseg, 9, None if v is None else jnp.asarray(v))
        tp, tc = S.pack_batch(torch.from_numpy(ids), nseg, 9,
                              None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        S.groupby_max(torch.from_numpy(vals), torch.from_numpy(ids), nseg + 2).numpy(),
        np.asarray(JS.groupby_max(jnp.asarray(vals), jnp.asarray(ids), nseg + 2)))
    key = jax.random.key(9)
    count, max_b = 6, 16
    indexer = rng.integers(0, 10, n).astype(np.int32)
    shuffle = np.array(jax.random.permutation(key, n))
    uniform = np.array(jax.random.uniform(jax.random.fold_in(key, 1), (max_b, count)))
    for values in (None, vals):
        j = JS.pack_samples(jnp.asarray(indexer), count, key, max_b,
                            None if values is None else jnp.asarray(values))
        t = S.pack_samples(torch.from_numpy(indexer), count, torch.from_numpy(shuffle),
                           torch.from_numpy(uniform), max_b,
                           None if values is None else torch.from_numpy(values))
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
