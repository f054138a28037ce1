"""The port's augmentation, trainer and train-state bridge against the JAX
package, on the CPU, at the toy hparams of tests/test_torch_model.py.

Both packages start from the same weights (the JAX init, loaded with
``convert.load_jax_params``) and see the same numpy batches. The JAX remix
draws its permutations from a key; the tests recompute those draws from the
key exactly as ``sudo_rm_rf_tpu/train/augment.py`` does and feed them to the
port. The JAX oracle for a step's gradients is ``jax.value_and_grad`` of the
JAX trainer's own ``prepare_batch``, ``_forward`` and ``loss_fn`` with the
clamp; it is held to the JAX ``train_step``'s loss and grad-norm metrics.

Tolerances: remix and normalize 1e-6; the optimizer fed identical grads,
params within rtol = atol = 1e-6 over 3 steps; the schedule exact; a fp32
step's loss rtol 1e-5 and each grad tensor rtol 1e-4 with atol 1e-4 x its
largest |grad|; a bf16 step as ``test_bf16_step_matches_jax`` states. Parity
steps assert that the loss clamp is inactive, so no gradient test passes on
zeros.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.parallel import make_mesh
from sudo_rm_rf_tpu.train import augment as jaug
from sudo_rm_rf_tpu.train import trainer as jtrainer
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params, load_jax_train_state
from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import read_checkpoint
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import params_to_state_dict
from sudo_rm_rf_tpu_torch.train import augment
from sudo_rm_rf_tpu_torch.train import trainer as ttrainer
from sudo_rm_rf_tpu_torch.utils import CheckpointManager
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

TOY = dict(out_channels=32, in_channels=64, num_blocks=2, upsampling_depth=3,
           enc_kernel_size=21, enc_num_basis=24, num_sources=2)
B, S, T = 4, 2, 1000
CLAMP = 30.0


def _sources(seed, b=B, s=S, t=T):
    """Brown-noise sources: at init the toy model's loss sits well inside
    the clamp on them (white noise sits near it)."""
    x = np.cumsum(np.random.default_rng(seed).standard_normal((b, s, t)), axis=-1)
    return (x / x.std(axis=-1, keepdims=True)).astype(np.float32)


def _jax_draws(key, b, s):
    """The permutations ``online_remix_sources`` draws from ``key``."""
    k_slot, *k_batch = jax.random.split(key, s + 1)
    slot = np.array(jax.random.permutation(k_slot, s))
    perms = np.stack([np.array(jax.random.permutation(k, b)) for k in k_batch])
    return torch.from_numpy(slot), torch.from_numpy(perms)


def _jax_pair_draws(key, b, s):
    """The permutations ``online_remix_pairs`` draws from ``key``."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.permutation(k, b))
                                      for k in jax.random.split(key, s)]))


@functools.lru_cache(maxsize=None)
def _jax_params(block_impl="fma"):
    model = jmodels.SuDORMRFImproved(**TOY, block_impl=block_impl)
    params = model.init(jax.random.key(0), jnp.zeros((B, 1, T)))["params"]
    return jax.tree.map(np.asarray, params)


def _jax_trainer(block_impl="fma", **cfg):
    model = jmodels.SuDORMRFImproved(**TOY, block_impl=block_impl)
    return jtrainer.Trainer(model, jtrainer.TrainerConfig(**cfg),
                            mesh=make_mesh(devices=jax.devices()[:1]))


def _port(block_impl="fma", **cfg):
    model = load_jax_params(models.get_model("relu", **TOY, block_impl=block_impl),
                            _jax_params(block_impl))
    tr = ttrainer.Trainer(model, ttrainer.TrainerConfig(**cfg))
    return tr, tr.init_state()


def _jax_loss_and_grads(jt, params, batch, key):
    """Loss and grads of one JAX step (grad_accum_steps=1)."""
    cfg = jt.config
    mixture, targets = jt.prepare_batch(key, jnp.asarray(batch))
    cdtype = jnp.dtype(cfg.compute_dtype) if cfg.compute_dtype else None

    def loss_of(p):
        mix = mixture
        if cdtype is not None:
            p = jax.tree.map(lambda a: a.astype(cdtype), p)
            mix = mix.astype(cdtype)
        loss = jt.loss_fn(jt._forward(p, mix).astype(jnp.float32), targets)
        if cfg.loss_clamp > 0:
            loss = jnp.clip(loss, -cfg.loss_clamp, cfg.loss_clamp)
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _grads_by_name(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _assert_grads_close(got: dict, want_tree, keys):
    want = params_to_state_dict(want_tree, keys)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


# -- augmentation -------------------------------------------------------------


def test_normalize_wav_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 2, 501)).astype(np.float32)
    got = augment.normalize_wav(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jaug.normalize_wav(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_online_remix_sources_matches_jax_with_its_draws(s, seed):
    src = _sources(seed, b=5, s=s, t=300) * np.arange(1, s + 1)[None, :, None]
    key = jax.random.key(seed)
    jmix, jsrc = jaug.online_remix_sources(key, jnp.asarray(src))
    mix, out = augment.online_remix_sources(torch.from_numpy(src), *_jax_draws(key, 5, s))
    np.testing.assert_allclose(mix.numpy(), np.asarray(jmix), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jsrc), rtol=1e-6, atol=1e-6)


def test_online_remix_pairs_matches_jax_with_its_draws():
    src = _sources(3, b=5, s=3, t=300)
    tgt = (0.5 * src + 0.1 * _sources(4, b=5, s=3, t=300)).astype(np.float32)
    key = jax.random.key(9)
    jmix, jtgt = jaug.online_remix_pairs(key, jnp.asarray(src), jnp.asarray(tgt))
    mix, out = augment.online_remix_pairs(torch.from_numpy(src), torch.from_numpy(tgt),
                                          _jax_pair_draws(key, 5, 3))
    np.testing.assert_allclose(mix.numpy(), np.asarray(jmix), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jtgt), rtol=1e-6, atol=1e-6)


def test_draw_remix_is_seeded_permutations():
    a = augment.draw_remix(torch.Generator().manual_seed(3), 6, 3)
    b = augment.draw_remix(torch.Generator().manual_seed(3), 6, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    slot, perms = a
    assert sorted(slot.tolist()) == [0, 1, 2] and perms.shape == (3, 6)
    assert all(sorted(p.tolist()) == list(range(6)) for p in perms)


# -- schedule and optimizer ---------------------------------------------------


@pytest.mark.parametrize("epoch_end_phase", [False, True])
@pytest.mark.parametrize("patience", [0, 1, 3])
def test_stepped_lr_schedule_matches_jax_exactly(epoch_end_phase, patience):
    args = (1e-3, 3.0, patience, 7)
    js = jtrainer.stepped_lr_schedule(*args, epoch_end_phase=epoch_end_phase)
    ts = ttrainer.stepped_lr_schedule(*args, epoch_end_phase=epoch_end_phase)
    for step in range(0, 120, 3):
        assert np.float32(ts(step)) == np.float32(js(jnp.asarray(step, jnp.int32))), step


@pytest.mark.parametrize("clip,scale", [(5.0, 10.0), (5.0, 1e-3), (0.0, 10.0)])
def test_optimizer_matches_optax_fed_identical_grads(clip, scale):
    """clip_by_global_norm + Adam + the stepped LR over 3 updates (the LR
    changes every update, so the count before the increment is checked)."""
    cfg = dict(clip_grad_norm=clip, patience_epochs=1, steps_per_epoch=1)
    jt = _jax_trainer(**cfg)
    params = jax.tree.map(jnp.asarray, _jax_params())
    opt_state = jt.tx.init(params)
    tr, state = _port(**cfg)
    keys = tr.model.state_dict().keys()
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)
        updates, opt_state = jt.tx.update(jax.tree.map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        by_name = params_to_state_dict(grads, keys)
        for name, p in tr.model.named_parameters():
            p.grad = by_name[name].clone()
        norm = tr.apply_gradients(state)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-5)
    want = params_to_state_dict(jax.tree.map(np.asarray, params), keys)
    for name, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert state.step == 3


# -- train steps --------------------------------------------------------------


@pytest.mark.parametrize("block_impl", ["fma", "xla"])
def test_train_step_loss_and_grads_match_jax(block_impl):
    batch, key = _sources(11), jax.random.key(4)
    jt = _jax_trainer(block_impl, loss_clamp=CLAMP)
    jparams = jax.tree.map(jnp.asarray, _jax_params(block_impl))
    jloss, jgrads = _jax_loss_and_grads(jt, jparams, batch, key)
    assert abs(jloss) < CLAMP, jloss  # the clamp is inactive: real gradients
    _, jmetrics = jt.train_step(jt.state_from_params(jparams), jnp.asarray(batch), key)
    np.testing.assert_allclose(float(jmetrics["loss"]), jloss, rtol=1e-6)
    np.testing.assert_allclose(float(jmetrics["grad_norm"]),
                               float(optax.global_norm(jgrads)), rtol=1e-5)

    tr, state = _port(block_impl, loss_clamp=CLAMP)
    draws = _jax_draws(key, B, S)
    loss = tr.compute_gradients(state, batch, draws)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_grads_close(_grads_by_name(tr.model), jgrads, tr.model.state_dict().keys())

    tr, state = _port(block_impl, loss_clamp=CLAMP)
    state, metrics = tr.train_step(state, batch, draws)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    assert state.step == 1


def test_saturated_clamp_gives_zero_grads_in_both():
    batch, key = _sources(12), jax.random.key(1)
    jt = _jax_trainer(loss_clamp=1.0)
    jloss, jgrads = _jax_loss_and_grads(jt, jax.tree.map(jnp.asarray, _jax_params()),
                                        batch, key)
    assert jloss == 1.0 and all(not g.any() for g in jax.tree.leaves(jgrads))
    tr, state = _port(loss_clamp=1.0)
    state, metrics = tr.train_step(state, batch, _jax_draws(key, B, S))
    assert float(metrics["loss"]) == 1.0 and float(metrics["grad_norm"]) == 0.0
    assert all(not p.grad.any() for p in tr.model.parameters())


def test_grad_accum_matches_one_batch_and_jax():
    """grad_accum_steps=2 against 1 in the port (clamp off: per-microbatch
    clamping is the one difference), and against the JAX step with 2."""
    batch, key = _sources(13), jax.random.key(2)
    draws = _jax_draws(key, B, S)
    got = {}
    for k in (1, 2):
        tr, state = _port(loss_clamp=0.0, grad_accum_steps=k)
        got[k] = (float(tr.compute_gradients(state, batch, draws)), _grads_by_name(tr.model))
    np.testing.assert_allclose(got[2][0], got[1][0], rtol=1e-5)
    for name, g in got[1][1].items():
        np.testing.assert_allclose(got[2][1][name], g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)

    jt = _jax_trainer(loss_clamp=CLAMP, grad_accum_steps=2)
    jstate = jt.state_from_params(jax.tree.map(jnp.asarray, _jax_params()))
    _, jm = jt.train_step(jstate, jnp.asarray(batch), key)
    assert abs(float(jm["loss"])) < CLAMP
    tr, state = _port(loss_clamp=CLAMP, grad_accum_steps=2)
    _, m = tr.train_step(state, batch, draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def test_bf16_step_matches_jax():
    """compute_dtype='bfloat16': the same whole-tree cast over fp32 master
    params. The loss within rtol 2e-2; each grad tensor of 8 or more
    elements within a relative L2 error of 0.1, and the whole gradient
    within 0.05. A scalar PReLU slope's gradient is a sum over every
    activation, which bf16 rounding moves a long way: JAX's own bf16 slope
    gradients differ from its fp32 ones by up to ~170 % here. So a slope is
    held to JAX's bf16 value within twice JAX's own bf16-vs-fp32 distance."""
    batch, key = _sources(14), jax.random.key(3)
    jparams = jax.tree.map(jnp.asarray, _jax_params())
    _, j32 = _jax_loss_and_grads(_jax_trainer(loss_clamp=CLAMP), jparams, batch, key)
    jt = _jax_trainer(loss_clamp=CLAMP, compute_dtype="bfloat16")
    jloss, jgrads = _jax_loss_and_grads(jt, jparams, batch, key)
    assert abs(jloss) < CLAMP
    tr, state = _port(loss_clamp=CLAMP, compute_dtype="bfloat16")
    loss = tr.compute_gradients(state, batch, _jax_draws(key, B, S))
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-2)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tr.model.parameters())
    keys = tr.model.state_dict().keys()
    got = _grads_by_name(tr.model)
    want = {k: v.numpy() for k, v in params_to_state_dict(jgrads, keys).items()}
    want32 = {k: v.numpy() for k, v in params_to_state_dict(j32, keys).items()}
    rel = lambda a, b: np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
    for name, w in want.items():
        if w.size >= 8:
            assert rel(got[name], w) < 0.1, name
        else:
            assert np.abs(got[name] - w).max() <= 2 * np.abs(w - want32[name]).max() + 1e-6, name
    flat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])
    assert rel(flat(got), flat(want)) < 0.05


def test_fma_grads_match_xla_grads():
    """The fma blocks differentiate to the plain blocks' gradients."""
    batch = _sources(15)
    draws = augment.draw_remix(torch.Generator().manual_seed(0), B, S)
    got = {}
    for impl in ("fma", "xla"):
        tr, state = _port(impl, loss_clamp=CLAMP)
        tr.model.load_state_dict(load_jax_params(
            models.get_model("relu", **TOY), _jax_params()).state_dict())
        loss = float(tr.compute_gradients(state, batch, draws))
        assert abs(loss) < CLAMP
        got[impl] = (loss, _grads_by_name(tr.model))
    np.testing.assert_allclose(got["fma"][0], got["xla"][0], rtol=1e-5)
    for name, g in got["xla"][1].items():
        np.testing.assert_allclose(got["fma"][1][name], g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)


def test_load_jax_train_state_resumes_a_jax_run():
    """Two JAX steps, the state carried into the port, then one more step
    in each: the same loss, grad norm and Adam moments, and the same loss
    after that update."""
    jt = _jax_trainer(loss_clamp=CLAMP, patience_epochs=1, steps_per_epoch=2)
    jstate = jt.state_from_params(jax.tree.map(jnp.asarray, _jax_params()))
    for i in range(2):
        jstate, _ = jt.train_step(jstate, jnp.asarray(_sources(20 + i)), jax.random.key(i))
    host = jax.tree.map(np.asarray, jax.device_get(jstate))

    tr, _ = _port(loss_clamp=CLAMP, patience_epochs=1, steps_per_epoch=2)
    model = models.get_model("relu", **TOY, block_impl="fma")
    opt = torch.optim.Adam(model.parameters(), betas=(0.9, 0.999), eps=1e-8)
    state = load_jax_train_state(model, opt, host.params, host.opt_state, host.step)
    tr.model = model
    assert state.step == 2
    keys = model.state_dict().keys()
    adam = host.opt_state[1][0]
    mu = params_to_state_dict(adam.mu, keys)
    for name, p in model.named_parameters():
        assert float(opt.state[p]["step"]) == 2.0
        assert torch.equal(opt.state[p]["exp_avg"], mu[name])

    batch, key = _sources(22), jax.random.key(7)
    jstate, jm = jt.train_step(jstate, jnp.asarray(batch), key)
    state, m = tr.train_step(state, batch, _jax_draws(key, B, S))
    assert abs(float(jm["loss"])) < CLAMP
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    mu = params_to_state_dict(jax.tree.map(np.asarray, jstate.opt_state[1][0].mu), keys)
    for name, p in model.named_parameters():
        w = mu[name].numpy()
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)

    # the update itself (moments, count, the LR of update 2): the next loss
    after, key = _sources(23), jax.random.key(8)
    jloss, _ = _jax_loss_and_grads(jt, jstate.params, after, key)
    loss = tr.compute_gradients(state, after, _jax_draws(key, B, S))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)


def test_eval_step_sisdri_matches_jax():
    tgt = _sources(30)
    mix = tgt.sum(1, keepdims=True)
    jt = _jax_trainer()
    want = jt.eval_step(jax.tree.map(jnp.asarray, _jax_params()), mix, tgt)["SISDRi"]
    tr, state = _port()
    got = tr.eval_step(state.model, mix, tgt)["SISDRi"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("weights", ["uniform", "magsq"])
def test_mixture_consistency_in_the_step_matches_jax(weights):
    batch, key = _sources(16), jax.random.key(6)
    jt = _jax_trainer(loss_clamp=CLAMP, mixture_consistency=weights)
    jloss, jgrads = _jax_loss_and_grads(jt, jax.tree.map(jnp.asarray, _jax_params()),
                                        batch, key)
    assert abs(jloss) < CLAMP
    tr, state = _port(loss_clamp=CLAMP, mixture_consistency=weights)
    loss = tr.compute_gradients(state, batch, _jax_draws(key, B, S))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_grads_close(_grads_by_name(tr.model), jgrads, tr.model.state_dict().keys())


@pytest.mark.parametrize("cfg,error", [
    # taken since radam_cosine was ported; its cosine decay needs more steps
    # than the warmup, as optax's schedule does
    (dict(optimizer="radam_cosine", total_steps=1000), ValueError),
    # taken since train_dropout was ported, but only by a model with dropout
    (dict(train_dropout=True), ValueError),
    # taken since upload_dtype was ported, but only as a floating dtype
    (dict(upload_dtype="int8"), ValueError),
    (dict(compute_dtype="bfloat17"), ValueError),
])
def test_trainer_raises_for_options_that_wait(cfg, error):
    with pytest.raises(error, match="ROADMAP|compute_dtype|upload_dtype|no dropout layers|"
                                    "warmup_steps"):
        ttrainer.Trainer(models.get_model("relu", **TOY), ttrainer.TrainerConfig(**cfg))


def test_shard_params_without_a_model_group_trains_as_replicated():
    """shard_params is taken since storage TP was ported; with no mesh (one
    process, a model group of one) it shards nothing, as JAX's is a no-op on
    model=1, and the step is the replicated one bit for bit."""
    batch, draws = _sources(30), _jax_draws(jax.random.key(3), B, S)
    got = {}
    for shard in (False, True):
        tr, state = _port(shard_params=shard)
        assert tr.shards is None and state.shards is None
        _, m = tr.train_step(state, batch, draws)
        got[shard] = (float(m["loss"]), tr.model.state_dict())
    assert got[True][0] == got[False][0]
    for k, v in got[False][1].items():
        assert torch.equal(got[True][1][k], v), k


def test_trainer_rejects_the_forward_only_kernel():
    with pytest.raises(ValueError, match="forward-only"):
        ttrainer.Trainer(models.get_model("relu", **TOY, block_impl="kernel"))


# -- checkpoints and the CLI --------------------------------------------------


def test_checkpoint_manager_policies_and_roundtrip(tmp_path):
    tr, state = _port()
    state, _ = tr.train_step(state, _sources(40), augment.draw_remix(
        torch.Generator().manual_seed(0), B, S))
    ck = CheckpointManager(str(tmp_path), "relu")
    assert ck.save_every(state, 2, 2) and ck.save_every(state, 3, 2) is None
    assert ck.latest_epoch() == 2
    assert ck.save_if_best(state, "val_SISDRi", 1.5, 2)
    assert not ck.save_if_best(state, "val_SISDRi", 1.0, 3)
    names = sorted(os.listdir(tmp_path))
    assert [n.split("_2026")[0][:18] for n in names if n.startswith("best_")] == \
        ["best_val_SISDRi_1.", "best_val_SISDRi_1."]
    assert sum(n.startswith("current_val_SISDRi_1.0000") for n in names) == 2
    assert not any(n.endswith(".tmp") for n in names)

    fresh_tr, fresh = _port()
    assert not torch.equal(next(fresh.model.parameters()), next(state.model.parameters()))
    ck.load_best(fresh)
    assert fresh.step == 1
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = fresh.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sb)
    assert ck.load_latest(fresh).step == 1


def test_state_from_params_loads_weights_with_fresh_adam():
    tr, state = _port()
    state, _ = tr.train_step(state, _sources(41), augment.draw_remix(
        torch.Generator().manual_seed(1), B, S))
    trained = {k: v.clone() for k, v in tr.model.state_dict().items()}
    other, _ = _port()
    fresh = other.state_from_params(trained)
    assert fresh.step == 0 and not fresh.optimizer.state
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, trained[k]), k


def _mk_corpus(root):
    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus

    return write_wham_corpus(root, n_train=4, n_val=2, seconds=0.5, seed=0)


def test_cli_train_cpu_one_epoch_then_resume(tmp_path, capsys):
    from sudo_rm_rf_tpu_torch.cli.train import main

    wham = _mk_corpus(str(tmp_path / "wham"))
    argv = ["--train", "WHAM", "--val", "WHAM", "--separation_task", "sep_clean",
            "--model_type", "relu", "--out_channels", "16", "--in_channels", "32",
            "--num_blocks", "1", "--upsampling_depth", "2", "--enc_num_basis", "16",
            "-bs", "2", "--audio_timelength", "0.5", "--n_jobs", "1",
            "--experiment_name", "cli", "-elp", str(tmp_path / "logs"),
            "-clp", str(tmp_path / "ckpt"), "--wham_root", wham,
            "--save_checkpoint_every", "1", "--device", "cpu"]
    assert main(argv + ["--n_epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "epoch 1/1" in out and "val_SISDRi=" in out
    ck = tmp_path / "ckpt" / "cli" / "relu_epoch_1"
    assert read_checkpoint(str(ck))["step"] == 2  # 4 files at batch 2
    assert main(argv + ["--n_epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 1: step 2, Adam step 2" in out and "epoch 2/2" in out
    blob = read_checkpoint(str(tmp_path / "ckpt" / "cli" / "relu_epoch_2"))
    assert blob["step"] == 4
    # optax's Adam count and its schedule's count, as the JAX trainer saves them
    assert [int(s["count"]) for s in blob["opt_state"]["1"].values()] == [4, 4]
    assert (tmp_path / "logs" / "cli" / "metrics.jsonl").exists()
    assert (tmp_path / "logs" / "cli" / "val_SISDRi" / "epoch_2.npy").exists()


def test_run_experiment_stops_early_on_a_plateau(tmp_path, monkeypatch):
    """At learning rate 0 the val metric never improves after epoch 1, so
    early_stop_patience=1 ends the run after epoch 2 of 4."""
    from sudo_rm_rf_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from sudo_rm_rf_tpu_torch.train.experiment import run_experiment
    from sudo_rm_rf_tpu_torch.utils import ExperimentLogger

    cfg = ExperimentConfig(
        model=ModelConfig(out_channels=16, in_channels=32, num_blocks=1,
                          upsampling_depth=2, enc_num_basis=16),
        data=DataConfig(audio_timelength=0.5, batch_size=2, n_jobs=1),
        train=TrainConfig(n_epochs=4, learning_rate=0.0, early_stop_patience=1,
                          save_checkpoint_every=0, checkpoints_path=str(tmp_path / "ck")),
        experiment_name="plateau",
    )
    monkeypatch.setenv("SUDO_TPU_WHAM_ROOT", _mk_corpus(str(tmp_path / "wham")))
    logger = ExperimentLogger(str(tmp_path / "logs"), "plateau")
    state, history = run_experiment(cfg, logger=logger, device="cpu")
    logger.close()
    assert len(history) == 2 and state.step == 4
    assert history[0]["val_SISDRi"] == history[1]["val_SISDRi"]


@pytest.mark.parametrize("extra,error", [
    (["--block_impl", "kernel"], ValueError),
    # taken since tensor parallelism was ported, over a launch of >= 2 ranks:
    # in one process it exceeds the ranks, as JAX's exceeds its devices
    (["--n_model", "2"], ValueError),
    (["--remat_blocks", "--block_impl", "kernel"], ValueError),
    # taken since MUSDB was ported, but on a mono model input only, as in JAX
    (["--train", "MUSDB", "--n_channels", "2"], ValueError),
    (["--train", "NOSUCH"], ValueError),
    # the baselines take their own hparams: the JAX CLI cannot build them either
    (["--model_type", "dprnn"], ValueError),
    (["--model_type", "sepformer"], ValueError),
    (["--model_type", "groupcomm_v2", "--block_impl", "kernel"], ValueError),
    (["--device", "cuda"], RuntimeError),
])
def test_cli_train_rejects_what_the_port_does_not_take(tmp_path, extra, error, monkeypatch):
    from sudo_rm_rf_tpu_torch.cli.train import main

    if extra == ["--device", "cuda"]:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--train", "WHAM", "--wham_root", str(tmp_path), "--n_epochs", "1",
            "-elp", str(tmp_path / "logs"), "-clp", str(tmp_path / "ckpt"),
            "--num_blocks", "1", "--device", "cpu"] + extra
    with pytest.raises(error):
        main(argv)


@pytest.mark.parametrize("extra,check", [
    (["--block_impl", "auto"], "block_impl auto -> "),
    (["--chain_steps", "3"], "epoch 1/1"),
    (["--max_inflight", "1"], "epoch 1/1"),
    (["--device_data"], "device-resident pool: "),
])
def test_cli_train_takes_the_options_jax_takes(tmp_path, extra, check, capsys):
    """The flags the JAX CLI takes and the port once refused train one toy
    epoch on the CPU."""
    from sudo_rm_rf_tpu_torch.cli.train import main

    argv = ["--train", "WHAM", "--val", "WHAM", "--wham_root", _mk_corpus(str(tmp_path / "w")),
            "--n_epochs", "1", "-bs", "2", "--audio_timelength", "0.5", "--n_jobs", "1",
            "--out_channels", "16", "--in_channels", "32", "--num_blocks", "1",
            "--upsampling_depth", "2", "--enc_num_basis", "16", "-elp", str(tmp_path / "logs"),
            "-clp", str(tmp_path / "ckpt"), "--device", "cpu"] + extra
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert check in out and "epoch 1/1 tr_loss=" in out and "val_SISDRi=" in out


def test_cli_args_defaults_match_the_jax_cli():
    from sudo_rm_rf_tpu.cli.args import build_parser as jax_parser
    from sudo_rm_rf_tpu_torch.cli.args import build_parser

    got, want = vars(build_parser().parse_args([])), vars(jax_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_sudo_torch_train_is_a_console_script():
    import tomllib

    with open(os.path.join(os.path.dirname(__file__), "..", "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["sudo-torch-train"] == "sudo_rm_rf_tpu_torch.cli.train:main"
