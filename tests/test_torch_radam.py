"""The port's ``optimizer="radam_cosine"`` against the JAX trainer's
``chain(clip_by_global_norm, radam(warmup_cosine_decay_schedule(0, lr,
warmup_steps, total_steps)))``, on the CPU.

Fed identical gradients, the port's update and optax's (jitted, as the
JAX trainer runs it) agree over 16
updates that span the rectification threshold (rho_t >= 5 first at update
6 with b2 = 0.999), the end of a 4-update warmup and the end of the cosine
decay, with clipped and unclipped gradients: params within rtol 1e-6,
atol 1e-7 (float32 rounding), the moments within rtol 1e-4, atol 1e-6 x
the tensor's largest (XLA fuses the moment updates and the clip's global
norm is summed in another order, so a moment moves by ulps, which a sum
of small terms of both signs, as a PReLU slope's, makes ~1e-5 of it), the
count exactly. The schedule
is held to optax's within rtol 1e-6. A ``radam_cosine`` TrainState written
by either package resumes in the other, and ``sudo-torch-train --optimizer
radam_cosine`` trains and resumes at total_steps = n_epochs x
steps_per_epoch, as the JAX experiment sets it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_zoo_parity import brown_sources, jax_draws, jax_init, rand
from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.parallel import make_mesh
from sudo_rm_rf_tpu.train import trainer as jtrainer
from sudo_rm_rf_tpu.utils import checkpoint as jcheckpoint
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import read_checkpoint
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import params_to_state_dict
from sudo_rm_rf_tpu_torch.train import experiment
from sudo_rm_rf_tpu_torch.train import trainer as ttrainer
from sudo_rm_rf_tpu_torch.utils import CheckpointManager
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

HP = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
          enc_kernel_size=21, enc_num_basis=16, num_sources=2)
CFG = dict(optimizer="radam_cosine", learning_rate=1e-2, warmup_steps=4, total_steps=14,
           loss_clamp=0.0)
N_UPDATES = 16


@functools.lru_cache(maxsize=None)
def _jax_setup():
    jmodel = jmodels.get_model("relu", **HP)
    return jmodel, jax_init(jmodel, rand((2, 1, 800), 1))


def _jax_trainer(**cfg):
    return jtrainer.Trainer(_jax_setup()[0], jtrainer.TrainerConfig(**cfg),
                            mesh=make_mesh(devices=jax.devices()[:1]))


def _port(**cfg):
    model = load_jax_params(models.get_model("relu", **HP), _jax_setup()[1])
    tr = ttrainer.Trainer(model, ttrainer.TrainerConfig(**cfg))
    return tr, tr.init_state()


def _by_name(tree, keys):
    return {k: v.numpy() for k, v in params_to_state_dict(
        jax.tree.map(np.asarray, tree), keys).items()}


@pytest.mark.parametrize("lr,warmup,total", [(1e-3, 4, 14), (1e-2, 1, 2), (3e-4, 1000, 100_000),
                                             (1e-3, 0, 10), (5e-4, 7, 8)])
def test_schedule_matches_optax(lr, warmup, total):
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
    got = ttrainer.warmup_cosine_schedule(lr, warmup, total)
    steps = sorted({*range(min(total + 3, 40)), warmup - 1, warmup, warmup + 1, total // 2,
                    total - 1, total, total + 10, 10 * total} - {-1})
    for step in steps:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=str(step))
    assert (got(0) == 0.0) == (warmup > 0)


def test_schedule_raises_where_optax_does():
    for warmup, total in ((1000, 10), (5, 5)):
        with pytest.raises(ValueError, match="positive decay_steps"):
            optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, total)
        with pytest.raises(ValueError, match="total_steps > warmup_steps"):
            ttrainer.warmup_cosine_schedule(1e-3, warmup, total)
        with pytest.raises(ValueError, match="total_steps > warmup_steps"):
            _port(**dict(CFG, warmup_steps=warmup, total_steps=total))


def _grads(k, shapes):
    """Seeded grads; every third update's are large enough to be clipped."""
    rng = np.random.default_rng(100 + k)
    scale = 3.0 if k % 3 == 2 else 0.05
    return {n: (rng.standard_normal(s) * scale).astype(np.float32) for n, s in shapes.items()}


def test_radam_cosine_matches_optax_fed_identical_grads():
    jt = _jax_trainer(**CFG)
    tr, state = _port(**CFG)
    keys = state.model.state_dict().keys()
    jparams = jax.tree.map(jnp.asarray, _jax_setup()[1])
    jstate = jt.tx.init(jparams)
    update = jax.jit(jt.tx.update)  # as the JAX trainer runs it
    shapes = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
    clipped = 0
    for k in range(N_UPDATES):
        g = _grads(k, shapes)
        jgrads = jax.tree.map(jnp.asarray, _unflatten(g, _jax_setup()[1]))
        updates, jstate = update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        for n, p in state.model.named_parameters():
            # a copy: on the CPU jnp.asarray may alias a 64-byte-aligned numpy
            # array, and the port clips p.grad in place, which would change
            # JAX's grads under an update that is still running
            p.grad = torch.tensor(g[n]).reshape(p.shape)
        norm = float(tr.apply_gradients(state))
        clipped += norm > 5.0
        want = _by_name(jparams, keys)
        adam = jstate[1][0]
        mu, nu = _by_name(adam.mu, keys), _by_name(adam.nu, keys)
        assert int(adam.count) == k + 1 == state.step
        for n, p in state.model.named_parameters():
            st = state.optimizer.state[p]
            assert int(st["step"]) == k + 1
            np.testing.assert_allclose(p.detach().numpy(), want[n].reshape(p.shape),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{n} at update {k}")
            for got, want_m in ((st["exp_avg"], mu[n]), (st["exp_avg_sq"], nu[n])):
                np.testing.assert_allclose(got.numpy(), want_m.reshape(p.shape), rtol=1e-4,
                                           atol=1e-6 * np.abs(want_m).max(),
                                           err_msg=f"{n} at update {k}")
            if k == 0:  # at schedule(0) = 0: the moments move, no param does
                assert torch.equal(p.detach(), before[n]) and st["exp_avg"].abs().max() > 0
    assert clipped == N_UPDATES // 3


def _unflatten(by_name, template):
    """A JAX param tree shaped as ``template`` from port-named arrays."""
    from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import torch_key_to_flax_path

    out = jax.tree.map(np.zeros_like, template)
    for name, arr in by_name.items():
        node = out
        path = torch_key_to_flax_path(name)
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = arr.reshape(node[path[-1]].shape)
    return out


def test_torch_radam_is_not_optax_radam():
    """torch.optim.RAdam parts from optax once the update is rectified, at
    update 6: its eps is added to sqrt(nu), not to sqrt(nu_hat), which
    weighs on small gradients (its threshold, rho_t > 5 against optax's >=,
    would part them only at rho_t = 5 exactly): why the port writes optax's
    formula."""
    p_opt = torch.nn.Parameter(torch.ones(50))
    p_ref = torch.nn.Parameter(torch.ones(50))
    ours = ttrainer.RAdam([p_opt], lr=1e-2)
    ref = torch.optim.RAdam([p_ref], lr=1e-2)
    rng = np.random.default_rng(3)
    gaps = []
    for _ in range(8):
        g = torch.from_numpy((rng.standard_normal(50) * 1e-6).astype(np.float32))
        p_opt.grad, p_ref.grad = g.clone(), g.clone()
        ours.step()
        ref.step()
        gaps.append(float((p_opt - p_ref).detach().abs().max()))
    assert gaps[4] == 0.0 and gaps[5] > 1e-5


def _batch():
    return brown_sources(3, 2, 2, 800)


def _jax_steps(jt, n, key=5):
    state = jt.state_from_params(jax.tree.map(jnp.asarray, _jax_setup()[1]))
    for i in range(n):
        state, _ = jt.train_step(state, jnp.asarray(_batch()), jax.random.key(key + i))
    return state


def _port_steps(tr, state, n, key=5):
    for i in range(n):
        state, _ = tr.train_step(state, _batch(), jax_draws(jax.random.key(key + i), 2, 2))
    return state


def test_train_state_resumes_across_the_packages(tmp_path):
    """A port radam_cosine TrainState after 5 updates restored by JAX's
    CheckpointManager, and one after JAX's 5 by the port's: params, moments
    and count equal; one more update from each restored state agrees with
    the other package's (as :func:`_assert_next_update_close` holds it)."""
    cfg = dict(CFG, clip_grad_norm=5.0)
    jt = _jax_trainer(**cfg)
    tr, state = _port(**cfg)
    state = _port_steps(tr, state, 5)
    CheckpointManager(str(tmp_path / "port"), "relu").save(state, "e1")
    template = jt.state_from_params(jax.tree.map(jnp.asarray, _jax_setup()[1]))
    got = jcheckpoint.CheckpointManager(str(tmp_path / "port"), "relu").restore(template, "e1")
    keys = state.model.state_dict().keys()
    assert int(got.step) == 5 and int(got.opt_state[1][0].count) == 5
    want_p, want_mu = _by_name(got.params, keys), _by_name(got.opt_state[1][0].mu, keys)
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want_p[n].reshape(p.shape))
        np.testing.assert_array_equal(state.optimizer.state[p]["exp_avg"].numpy(),
                                      want_mu[n].reshape(p.shape))
    jnext, _ = jt.train_step(got, jnp.asarray(_batch()), jax.random.key(50))
    _assert_next_update_close(tr, state, 50, _by_name(jnext.params, keys))

    jstate = _jax_steps(jt, 5)
    jcheckpoint.CheckpointManager(str(tmp_path / "jax"), "relu").save(jstate, "e1")
    blob = read_checkpoint(str(tmp_path / "jax" / "e1"))
    assert [int(s["count"]) for s in blob["opt_state"]["1"].values()] == [5, 5]
    tr2, fresh = _port(**cfg)
    back = CheckpointManager(str(tmp_path / "jax"), "relu").restore(fresh, "e1")
    assert back.step == 5 and isinstance(back.optimizer, ttrainer.RAdam)
    want_p, want_nu = _by_name(jstate.params, keys), _by_name(jstate.opt_state[1][0].nu, keys)
    for n, p in back.model.named_parameters():
        st = back.optimizer.state[p]
        assert int(st["step"]) == 5
        np.testing.assert_array_equal(p.detach().numpy(), want_p[n].reshape(p.shape))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), want_nu[n].reshape(p.shape))
    jnext, _ = jt.train_step(jstate, jnp.asarray(_batch()), jax.random.key(60))
    _assert_next_update_close(tr2, back, 60, _by_name(jnext.params, keys))


def _assert_next_update_close(tr, state, key, want):
    """One port update from ``state`` against JAX's from the same restored
    state (``want``: its params after, by name). The update is the
    rectified RAdam step, mu_hat / sqrt(nu_hat) per element, which
    magnifies the packages' ~1e-5 grad differences where a gradient is
    small: each tensor's update within rtol 1e-3, atol 1e-3 x its largest."""
    before = {n: p.detach().clone().numpy() for n, p in state.model.named_parameters()}
    _port_steps(tr, state, 1, key=key)
    for n, p in state.model.named_parameters():
        got, ref = p.detach().numpy() - before[n], want[n].reshape(p.shape) - before[n]
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max(),
                                   err_msg=n)


def _cli_argv(tmp_path, wham):
    return ["--train", "WHAM", "--val", "WHAM", "--model_type", "relu", "--out_channels",
            "16", "--in_channels", "32", "--num_blocks", "1", "--upsampling_depth", "2",
            "--enc_num_basis", "16", "-bs", "2", "--audio_timelength", "0.5", "--n_jobs", "1",
            "--experiment_name", "radam", "-elp", str(tmp_path / "logs"), "-clp",
            str(tmp_path / "ckpt"), "--wham_root", wham, "--save_checkpoint_every", "1",
            "--optimizer", "radam_cosine", "--device", "cpu"]


def test_cli_trains_and_resumes_with_radam_cosine(tmp_path, capsys, monkeypatch):
    """``--optimizer radam_cosine`` runs the RAdam step with total_steps =
    n_epochs x steps_per_epoch. The CLI keeps the trainer's warmup of 1000,
    as the JAX CLI does, so a run of fewer steps raises as optax's schedule
    does; the short run here lowers the warmup to 1 through the config."""
    from sudo_rm_rf_tpu_torch.cli.train import main
    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus

    wham = write_wham_corpus(str(tmp_path / "wham"), n_train=4, n_val=2, seconds=0.5, seed=0)
    argv = _cli_argv(tmp_path, wham)
    with pytest.raises(ValueError, match="total_steps > warmup_steps"):
        main(argv + ["--n_epochs", "1"])
    seen = []

    def config(**kw):
        if "total_steps" in kw:  # the trainer's, not check_supported's
            seen.append(kw["total_steps"])
        return ttrainer.TrainerConfig(**kw, warmup_steps=1)

    monkeypatch.setattr(experiment, "TrainerConfig", config)
    assert main(argv + ["--n_epochs", "1"]) == 0
    assert main(argv + ["--n_epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 1: step 2, Adam step 2" in out and "epoch 2/2" in out
    assert seen == [2, 4]  # 4 files at batch 2, times n_epochs
    blob = read_checkpoint(str(tmp_path / "ckpt" / "radam" / "relu_epoch_2"))
    assert blob["step"] == 4
    assert [int(s["count"]) for s in blob["opt_state"]["1"].values()] == [4, 4]
