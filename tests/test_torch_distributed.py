"""The port's several-process training (``train/distributed.py`` over gloo
on the CPU) against the JAX package's data- and tensor-parallel step on its
8-device CPU mesh (tests/test_trainer.py's recipe and tolerances), against
the port's own single-process step, and through ``train()`` on two ranks.
Shapes of tests/test_trainer.py: the default networks, batch 8 x 64
samples, 32 surface points.  Dropout keeps are the JAX recipe's for the
global batch.  Every launch is bounded in time; a failed or hung rank fails
it."""
import json

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU, 8 devices)

import jax
import jax.numpy as jnp
import torch

import torch_dist_ranks as R
from difusion_tpu.models import decoder as JD
from difusion_tpu.models import encoder as JE
from difusion_tpu.train import losses as JL
from difusion_tpu.train import trainer as JTR
from difusion_tpu_torch.models.decoder import DecoderSpec
from difusion_tpu_torch.models.encoder import EncoderSpec
from difusion_tpu_torch.models.weights import load_prior
from difusion_tpu_torch.train import distributed as D
from difusion_tpu_torch.train import trainer as TR
from difusion_tpu_torch.train.losses import LossConfig
from difusion_tpu_torch.utils.adam import EPS

JSPEC_D, JSPEC_E = JD.DecoderSpec(), JE.EncoderSpec()
B, NS, NSURF = 8, 64, 32
LR, EPOCH = 1e-3, 1.0
LAUNCH_S = 120.0
# the JAX tests' tolerances: loss rtol 1e-4; parameters after one step atol
# 2e-5 under data parallelism, 3e-5 with tensor parallelism
TOL = {"dp8": 2e-5, "dp2_tp4": 3e-5}
MESHES = {"dp8": (8, 1), "dp2_tp4": (8, 4)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _inputs():
    """JAX-initialised parameters, a batch as the LIF loader gives it, and
    the dropout keeps the JAX decoder draws for the global batch."""
    kd, ke = jax.random.split(jax.random.key(0))
    dec = _np_tree(JD.init_decoder_params(JSPEC_D, kd))
    enc = _np_tree(JE.init_encoder_params(JSPEC_E, ke))
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.0, 1.0, (B, NS, 3)).astype(np.float32)
    sdf = (np.linalg.norm(xyz, axis=-1, keepdims=True) - 0.6).astype(np.float32)
    n = rng.normal(size=(B, NSURF, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    surf = np.concatenate([0.6 * n, n], -1).astype(np.float32)
    surf[..., :3] += rng.normal(0, 0.02, (B, NSURF, 3)).astype(np.float32)
    key = jax.random.key(3)
    _, outs = JSPEC_D.layer_dims()
    keep = 1.0 - JSPEC_D.dropout_prob
    masks = {i: np.array(jax.random.bernoulli(jax.random.fold_in(key, i), keep,
                                              (B * NS, outs[i])))
             for i in JSPEC_D.dropout if i < len(outs) - 1}
    return dec, enc, np.concatenate([xyz, sdf], -1), surf, key, masks


def _jax_step(dec, enc, sdf, surf, key, mesh_shape=None):
    """The JAX package's train_step, on one device or on make_mesh(n, tp)
    (replicate + shard_batch, or shard_state_tp)."""
    state = JTR.TrainState(jax.tree.map(jnp.asarray, dec), jax.tree.map(jnp.asarray, enc),
                           JTR._optimizer().init({"dec": dec, "enc": enc}),
                           jnp.zeros((), jnp.int32))
    sdf, surf = jnp.asarray(sdf), jnp.asarray(surf)
    if mesh_shape is not None:
        mesh = JTR.make_mesh(*mesh_shape)
        state = (JTR.shard_state_tp(state, mesh) if mesh_shape[1] > 1
                 else JTR.TrainState(*JTR.replicate(mesh, tuple(state))))
        sdf, surf = JTR.shard_batch(mesh, sdf, surf)
    new, losses = JTR.train_step(JSPEC_D, JL.LossConfig(), state, sdf, surf, key,
                                 jnp.float32(LR), jnp.float32(LR), jnp.float32(EPOCH))
    return new, {k: float(v) for k, v in losses.items()}


def _port_single(dec, enc, sdf, surf, masks):
    state = TR.state_from_params(DecoderSpec(), EncoderSpec(), dec, enc, torch.device("cpu"))
    state, losses = TR.train_step(LossConfig(), state, torch.from_numpy(sdf),
                                  torch.from_numpy(surf), LR, LR, EPOCH,
                                  masks={i: torch.from_numpy(m) for i, m in masks.items()})
    return ({"dec": state.dec.to_params(), "enc": state.enc.to_params()},
            {k: float(v) for k, v in losses.items()})


@pytest.fixture(scope="module")
def runs():
    """Each mesh's step once: the JAX package's (and its sharded state),
    the port's on 8 spawned ranks, and both single-process steps."""
    dec, enc, sdf, surf, key, masks = _inputs()
    out = {"single_port": _port_single(dec, enc, sdf, surf, masks)}
    new, losses = _jax_step(dec, enc, sdf, surf, key)
    out["single_jax"] = ({"dec": new.dec_params, "enc": new.enc_params}, losses)
    for name, (n, tp) in MESHES.items():
        new, losses = _jax_step(dec, enc, sdf, surf, key, (n, tp))
        out[f"{name}_jax"] = ({"dec": new.dec_params, "enc": new.enc_params}, losses)
        if tp > 1:
            placed = JTR.shard_state_tp(JTR.create_train_state(JSPEC_D, JSPEC_E,
                                                               jax.random.key(0)),
                                        JTR.make_mesh(n, tp=tp))
            out[f"{name}_jax_shards"] = jax.tree.map(
                lambda a: a.sharding.shard_shape(a.shape),
                {"dec": placed.dec_params, "enc": placed.enc_params})
        out[f"{name}_port"] = D.launch(R.step, n, dec, enc, sdf, surf, masks, LR, EPOCH,
                                       n=n, tp=tp, timeout=LAUNCH_S)
    return out


def _max_diff(a, b):
    """The largest difference of two trees of the same structure, leaf by
    leaf with its path."""
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = jax.tree.leaves(b)
    assert len(flat_a) == len(flat_b)
    return max((float(np.abs(np.asarray(x) - np.asarray(y)).max()),
                jax.tree_util.keystr(p)) for (p, x), y in zip(flat_a, flat_b))


def _port_result(runs, name):
    r0 = runs[f"{name}_port"][0]
    assert r0["mesh"] == (MESHES[name][0] // MESHES[name][1], MESHES[name][1])
    assert r0["step"] == 1
    return {"dec": r0["dec"], "enc": r0["enc"]}, r0["losses"]


@pytest.mark.parametrize("name", list(MESHES))
def test_multi_rank_step_matches_jax_mesh(runs, name):
    """One step of the port on 8 ranks == the JAX package's step on its
    8-device mesh of the same shape: every loss at rtol 1e-4, every
    parameter and BatchNorm running statistic within the JAX tests'
    tolerance."""
    (jparams, jlosses), (pparams, plosses) = runs[f"{name}_jax"], _port_result(runs, name)
    assert set(plosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(plosses[k], jlosses[k], rtol=1e-4, err_msg=k)
    worst, where = _max_diff(jparams, pparams)
    assert worst <= TOL[name], (worst, where)


@pytest.mark.parametrize("name", list(MESHES))
def test_multi_rank_step_matches_single_process(runs, name):
    """The same 8-rank step == the port's single-process step on the whole
    batch with the same masks, at the same tolerances; and the JAX mesh's
    step == the JAX single-device step (the yardstick)."""
    (sparams, slosses), (pparams, plosses) = runs["single_port"], _port_result(runs, name)
    for k in slosses:
        np.testing.assert_allclose(plosses[k], slosses[k], rtol=1e-4, err_msg=k)
    worst, where = _max_diff(sparams, pparams)
    assert worst <= TOL[name], (worst, where)
    jworst, jwhere = _max_diff(runs["single_jax"][0], runs[f"{name}_jax"][0])
    assert jworst <= TOL[name], (jworst, jwhere)


def test_tp_shards_follow_the_jax_placement(runs):
    """dp=2 x tp=4: each rank holds the shard shape JAX's shard_state_tp
    gives every parameter and BatchNorm buffer; Adam's moments follow
    their parameters."""
    flat = jax.tree_util.tree_flatten_with_path(runs["dp2_tp4_jax_shards"],
                                                is_leaf=lambda x: isinstance(x, tuple))[0]
    for rank_out in runs["dp2_tp4_port"]:
        shapes = rank_out["shapes"]
        for path, shard_shape in flat:
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            assert shapes[name] == tuple(shard_shape), name
            if f"mu.{name}" in shapes:
                assert shapes[f"mu.{name}"] == shapes[f"nu.{name}"] == shapes[name], name
    # the decoder's layers 0-3 and the encoder's 0-2 are sharded, the rest not
    assert shapes["dec.layers.0.v"] == (32, 32) and shapes["dec.layers.2.g"] == (24,)
    assert shapes["dec.layers.4.v"] == (1, 128) and shapes["enc.layers.3.w"] == (29, 256)
    assert shapes["enc.layers.2.bn_var"] == (64,) and shapes["mu.enc.layers.1.w"] == (16, 32)


def test_world_of_one_equals_single_process():
    """A launched world of one (a process group, make_mesh a world of one)
    steps bit for bit as the plain single-process call (on one thread, as
    each launched rank runs: CPU sums split by thread in another order)."""
    dec, enc, sdf, surf, _, masks = _inputs()
    torch.set_num_threads(1)
    try:
        params, losses = _port_single(dec, enc, sdf, surf, masks)
    finally:
        torch.set_num_threads(2)
    (r0,) = D.launch(R.step, 1, dec, enc, sdf, surf, masks, LR, EPOCH, timeout=LAUNCH_S)
    assert r0["mesh"] == (1, 1) and r0["losses"] == losses
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves({"dec": r0["dec"],
                                                              "enc": r0["enc"]})):
        assert np.array_equal(a, b)


def _lif_dir(path, n_lifs=24, seed=0):
    """Sphere-cap SDFs in the reference payload format
    (tests/test_trainer.py's make_synthetic_lif_dir)."""
    rng = np.random.default_rng(seed)
    (path / "payload").mkdir(parents=True)
    for i in range(n_lifs):
        r, c = rng.uniform(0.2, 0.4), rng.uniform(-0.15, 0.15, 3)
        xyz = rng.uniform(-0.5, 0.5, (800, 3)).astype(np.float32)
        sdf = (np.linalg.norm(xyz - c, axis=1) - r).astype(np.float32)
        dirs = rng.normal(size=(600, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        np.savez(path / "payload" / ("%08d.npz" % i),
                 data=np.concatenate([xyz, sdf[:, None]], 1),
                 surface=np.concatenate([c + dirs * r, dirs], 1).astype(np.float32))
    (path / "source.json").write_text(json.dumps([f"lif_{i}" for i in range(n_lifs)]))
    return path


def _hyper(lifs):
    return dict(
        run_name="t", num_epochs=1, batch_size=B, batch_split=1, samples_per_lif=NS,
        lr_schedule=[{"Type": "Constant", "Value": LR}, {"Type": "Constant", "Value": LR}],
        train_set=[{"data_path": "cached$local://" + str(lifs), "augment_rotation": "Y",
                    "num_surface_sample": NSURF, "augment_noise": [0.01, 20.0]}],
        code_length=29, network_specs=dict(dims=[128] * 4, dropout=[0, 1, 2, 3, 4, 5],
                                           dropout_prob=0.2, norm_layers=[0, 1, 2, 3, 4, 5],
                                           latent_in=[3], weight_norm=True),
        encoder_specs=dict(per_point_feat=[6, 32, 64, 256]), snapshot_frequency=1,
        additional_snapshots=[], upload_dtype="float16",
        training_loss=dict(types=["neg_log_likelihood", "reg_loss"], enforce_minmax=True,
                           clamping_distance=0.2, code_reg_lambda=0.01))


@pytest.fixture(scope="module")
def single_train(tmp_path_factory):
    """3 steps of a single-process train() (one epoch of 3 batches, dropout
    drawn from the trainer's generator, float16 upload): the hyper, its
    save_dir, and each parameter's smallest gradient size over the steps."""
    tmp = tmp_path_factory.mktemp("train")
    hyper = _hyper(_lif_dir(tmp / "lifs"))
    small = {}

    def recording(*args, **kwargs):
        losses, grads = loss_and_grads(*args, **kwargs)
        for name, g in grads.items():
            small[name] = torch.minimum(small[name], g.abs()) if name in small else g.abs()
        return losses, grads
    loss_and_grads = TR.loss_and_grads
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "loss_and_grads", recording)
        single = TR.train(dict(hyper, save_dir=str(tmp / "one")), max_steps=3, log_every=1,
                          device="cpu")
    assert single.step == 3
    return hyper, tmp / "one", {n: g.numpy() for n, g in small.items()}


def _assert_run_matches(one, two, small_grad):
    """The files of train() in ``two`` against the single process's in
    ``one``: the same names, 3 logged rows whose losses agree at rtol 1e-4
    (atol 1e-6: the NLL, negative, and the regularizer sum to ~5e-5 here),
    and a prior_1.npz that loads through load_prior and agrees within 1e-5.
    Adam moves an entry by lr * g / (|g| + eps) a step, which a gradient
    error d changes by up to lr * eps * d / (|g| + eps)^2: where a gradient
    comes within a few tens of eps of 0, the sums' rounding moves the entry
    by a good part of lr, either way.  So an entry past 1e-5 passes only
    where its single-process gradient g was so small at some step that an
    error no larger than |g| + eps could move it past 1e-5 (lr * eps / (|g|
    + eps) > 1e-5), and then within lr; at most 1e-4 of the entries may
    (one of ~78k, 2.3e-5 off, on this data)."""
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())
    rows = [[json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
            for run in (one, two)]
    assert len(rows[0]) == len(rows[1]) == 3
    for a, b in zip(*rows):
        for k in ("ll", "reg", "surface_abs_sdf", "total"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6, err_msg=k)
    n_all, n_off, worst = 0, 0, 0.0
    with np.load(one / "prior_1.npz") as x, np.load(two / "prior_1.npz") as y:
        assert set(x.files) == set(y.files)
        for key in x.files:
            diff = np.abs(x[key] - y[key])
            n_all, worst = n_all + diff.size, max(worst, float(diff.max()))
            off = diff > 1e-5
            if off.any():
                # decoder.layers#0.v -> dec.layers.0.v; BatchNorm statistics
                # have no gradient and are never exempt
                name = (key.replace("decoder.", "dec.", 1).replace("encoder.", "enc.", 1)
                        .replace("#", "."))
                g = small_grad.get(name)
                assert g is not None and (g[off] < LR * EPS / 1e-5 - EPS).all(), \
                    (key, diff[off], None if g is None else g[off])
                n_off += int(off.sum())
    assert worst <= 1e-3 and n_off <= 1e-4 * n_all, (worst, n_off, n_all)
    for run in (one, two):
        dec, enc, _ = load_prior(run / "hyper.json", 1, device="cpu")
        assert all(bool(torch.isfinite(p).all()) for p in dec.parameters())


def test_train_on_two_ranks_matches_single_process(single_train, tmp_path):
    """3 data-parallel steps of train() on 2 ranks: rank 0 writes
    prior_1.npz and metrics.jsonl, the other rank nothing; they match the
    single-process train() (:func:`_assert_run_matches`)."""
    hyper, one, small_grad = single_train
    steps = D.launch(R.train, 2, dict(hyper, save_dir=str(tmp_path / "two")), 3,
                     timeout=LAUNCH_S)
    assert steps == [3, 3]
    _assert_run_matches(one, tmp_path / "two", small_grad)


@pytest.mark.parametrize("world, mesh", [(3, 1), (6, 2)])
def test_train_with_ranks_outside_the_mesh(single_train, tmp_path, world, mesh):
    """train() on a world that batch 8 does not divide meshes gcd(8, world)
    ranks, as the JAX train meshes gcd(batch_size, devices): 3 ranks train
    on rank 0 alone, 6 ranks data-parallel on 2; the ranks past the mesh
    return None and leave the group while the mesh trains and meets at
    its snapshot barrier.  The files match the single process's."""
    hyper, one, small_grad = single_train
    steps = D.launch(R.train, world, dict(hyper, save_dir=str(tmp_path / "run")), 3,
                     timeout=LAUNCH_S)
    assert steps == [3] * mesh + [None] * (world - mesh)
    _assert_run_matches(one, tmp_path / "run", small_grad)


@pytest.mark.parametrize("how", ["raises", "hangs"])
def test_launch_fails_when_a_rank_fails(how):
    """A rank that raises (the others wait in an all-reduce) or that outlives
    the time limit fails the launch within its bound, naming the rank."""
    if how == "raises":
        with pytest.raises(RuntimeError, match="rank 2 fails on purpose"):
            D.launch(R.fail_on_rank, 4, 2, timeout=LAUNCH_S)
    else:
        with pytest.raises(RuntimeError, match=r"hung ranks: \[1\]"):
            D.launch(R.hang_on_rank, 2, 1, 300.0, timeout=20.0)


def test_mesh_layout_and_its_errors():
    """Rank d * tp + m holds data coordinate d and model coordinate m (JAX's
    reshape(n // tp, tp)); gather_cols concatenates the model ranks'
    slices in order; ranks past the mesh sit out.  Without a process group
    make_mesh is a world of one and refuses more ranks, as JAX refuses more
    devices than exist, and a world not divisible by tp."""
    out = D.launch(R.mesh_coords, 6, 4, 2, timeout=LAUNCH_S)
    for rank, got in enumerate(out[:4]):
        dp, tp, d, m, gathered = got
        assert (dp, tp, d, m) == (2, 2, rank // 2, rank % 2)
        np.testing.assert_array_equal(gathered, np.repeat([[0.0, 0, 0, 1, 1, 1]], 2, 0))
    assert out[4:] == [None, None]
    assert D.make_mesh() == D.SINGLE
    with pytest.raises(RuntimeError, match="asked for 2 ranks"):
        D.make_mesh(2)
    with pytest.raises(RuntimeError, match="not divisible by tp=2"):
        D.make_mesh(1, tp=2)


def test_no_rank_leaves_before_the_slowest_returns(tmp_path):
    """A rank whose function returns at once stays in the process group
    (its process alive) until the slowest rank's function has returned too:
    leaving early closed its connections while a slower peer could still be
    completing gloo's full-mesh handshake in init_process_group, which then
    failed with "Connection closed by peer"."""
    gone = D.launch(R.outlive_peers, 4, str(tmp_path), 1.5, timeout=LAUNCH_S)
    assert gone == [[], None, None, None]
