"""Training options of the port on the CPU: ``remat_blocks`` (each block
under ``torch.utils.checkpoint``) gives the grads of the plain forward for
the Improved and GroupComm models in both trainable block forms, in fp32 and
under the trainer's bf16 compute dtype, and the new
model types train through ``sudo-torch-train``. Grads with and without
remat: equal within rtol = atol = 1e-6 (the same ops recomputed).
``upload_dtype``: the host cast equals ml_dtypes' bf16 bit for bit, and one
step with bf16 (and fp32) uploads gives JAX's loss within rtol 1e-4."""

import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.config import ModelConfig
from sudo_rm_rf_tpu_torch.models import improved_sudormrf
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

TOY = {"relu": dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=2,
                    enc_kernel_size=21, enc_num_basis=16, num_sources=2),
       "groupcomm_v2": dict(out_channels=16, in_channels=32, num_blocks=2,
                            upsampling_depth=2, enc_kernel_size=21, enc_num_basis=16,
                            num_sources=2, group_size=4)}


def _grads(model_type, block_impl, remat, x, r):
    model = models.get_model(model_type, **TOY[model_type], block_impl=block_impl,
                             remat_blocks=remat, generator=torch.Generator().manual_seed(0))
    (model(x) * r).sum().backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("block_impl", ["fma", "xla"])
@pytest.mark.parametrize("model_type", sorted(TOY))
def test_remat_blocks_grads_equal_the_plain_ones(model_type, block_impl, monkeypatch):
    g = torch.Generator().manual_seed(1)
    x, r = torch.randn(2, 1, 643, generator=g), torch.randn(2, 2, 643, generator=g)
    calls = []
    real = improved_sudormrf.checkpoint
    monkeypatch.setattr(improved_sudormrf, "checkpoint",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    plain = _grads(model_type, block_impl, False, x, r)
    assert not calls
    remat = _grads(model_type, block_impl, True, x, r)
    assert calls == [{"use_reentrant": False}] * TOY[model_type]["num_blocks"]
    assert sorted(plain) == sorted(remat)
    for name in plain:
        np.testing.assert_allclose(remat[name].numpy(), plain[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("block_impl", ["fma", "xla"])
@pytest.mark.parametrize("model_type", sorted(TOY))
def test_remat_blocks_under_a_bf16_compute_dtype(model_type, block_impl):
    """The trainer's bf16 step casts the params through
    ``torch.func.functional_call``: the recompute takes those casts, so the
    remat step's loss and grads equal the plain step's."""
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix

    x = torch.randn(2, 2, 643, generator=torch.Generator().manual_seed(3))
    got = []
    for remat in (False, True):
        model = models.get_model(model_type, **TOY[model_type], block_impl=block_impl,
                                 remat_blocks=remat, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, TrainerConfig(compute_dtype="bfloat16", loss_clamp=0.0))
        loss = trainer.compute_gradients(trainer.init_state(), x,
                                         draw_remix(torch.Generator().manual_seed(4), 2, 2))
        got.append((float(loss), {n: p.grad for n, p in model.named_parameters()}))
    assert got[0][0] == got[1][0]
    for name, g in got[0][1].items():
        np.testing.assert_allclose(got[1][1][name].numpy(), g.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_remat_blocks_forward_without_autograd_runs_plainly():
    model = models.get_model("relu", **TOY["relu"], remat_blocks=True)
    x = torch.randn(1, 1, 300, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = model(x)
    model.remat_blocks = False
    with torch.no_grad():
        assert torch.equal(model(x), out)


@pytest.mark.parametrize("model_type", ["relu", "groupcomm_v2"])
def test_config_passes_remat_blocks(model_type):
    hp = dict(TOY[model_type])
    hp.pop("enc_kernel_size")
    model = ModelConfig(model_type=model_type, remat_blocks=True, **hp).build()
    assert model.remat_blocks


@pytest.mark.parametrize("model_type,extra", [
    ("attention_v3", ["--upsampling_depth", "3"]),
    ("causal", []),
    ("softmax", []),
    ("relu", ["--remat_blocks"]),
])
def test_train_cli_new_types_one_epoch_cpu(tmp_path, capsys, model_type, extra):
    from sudo_rm_rf_tpu_torch.cli.train import main
    from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import read_checkpoint
    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus

    wham = write_wham_corpus(str(tmp_path / "wham"), n_train=4, n_val=2, seconds=0.5, seed=0)
    argv = ["--train", "WHAM", "--val", "WHAM", "--model_type", model_type,
            "--out_channels", "16", "--in_channels", "32", "--num_blocks", "1",
            "--upsampling_depth", "2", "--enc_num_basis", "16", "-bs", "2",
            "--audio_timelength", "0.5", "--n_jobs", "1", "--n_epochs", "1",
            "--experiment_name", "x", "-elp", str(tmp_path / "logs"),
            "-clp", str(tmp_path / "ckpt"), "--wham_root", wham, "--loss_clamp", "0",
            "--save_checkpoint_every", "1", "--device", "cpu", *extra]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "epoch 1/1" in out and "val_SISDRi=" in out
    blob = read_checkpoint(str(tmp_path / "ckpt" / "x" / f"{model_type}_epoch_1"))
    assert blob["step"] == 2 and "sm_0" in blob["params"]
    losses = np.load(tmp_path / "logs" / "x" / "tr_loss" / "epoch_1.npy")
    assert losses.shape == (2,) and np.isfinite(losses).all()



# -- upload_dtype ----------------------------------------------------------------


def test_upload_host_cast_equals_ml_dtypes_bf16():
    """The host cast rounds to nearest even as ml_dtypes (JAX's numpy cast)
    does, bit for bit, ties and inf included; integer arrays and an unset
    upload_dtype pass unchanged; the step's upcast restores float32."""
    import ml_dtypes

    from sudo_rm_rf_tpu_torch.train import trainer as ttrainer

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
        -30, 30, 4096), np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 3.4e38, np.inf,
                                  -np.inf, 1e-40, 0.0, -0.0], np.float32)]).astype(np.float32)
    model = models.get_model("relu", **TOY["relu"])
    tr = ttrainer.Trainer(model, ttrainer.TrainerConfig(upload_dtype="bfloat16"))
    got = tr.host_cast(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  x.astype(ml_dtypes.bfloat16).view(np.int16))
    ix = tr.host_cast(np.arange(4, dtype=np.int32))
    assert ix.dtype == torch.int32
    up = tr._upcast(tr.upload((x, np.arange(4, dtype=np.int32))))
    assert up[0].dtype == torch.float32 and up[1].dtype == torch.int32
    np.testing.assert_array_equal(up[0].numpy(), x.astype(ml_dtypes.bfloat16).astype(np.float32))
    plain = ttrainer.Trainer(model, ttrainer.TrainerConfig())
    assert plain.host_cast(x).dtype == torch.float32 and plain._upcast(x) is x


def test_upload_step_matches_jax():
    """One WHAM step with fp32 and with bf16 uploads from the same params,
    batch and remix draws: the port's loss within 1e-4 of JAX's (the same
    rounding of the batch in both), and the bf16 loss differs from the fp32
    one (the batch was rounded)."""
    import jax
    import jax.numpy as jnp

    from _torch_zoo_parity import brown_sources, jax_draws, jax_init
    from sudo_rm_rf_tpu import models as jmodels
    from sudo_rm_rf_tpu.parallel import make_mesh
    from sudo_rm_rf_tpu.train import trainer as jtrainer
    from sudo_rm_rf_tpu_torch.convert import load_jax_params
    from sudo_rm_rf_tpu_torch.train import trainer as ttrainer

    hp = dict(TOY["relu"], num_blocks=1)
    jmodel = jmodels.get_model("relu", **hp)
    params = jax_init(jmodel, np.zeros((2, 1, 800), np.float32))
    batch = brown_sources(3, 2, 2, 800)
    losses = []
    for upload_dtype in (None, "bfloat16"):
        cfg = dict(loss_clamp=0.0, upload_dtype=upload_dtype)
        jt = jtrainer.Trainer(jmodel, jtrainer.TrainerConfig(**cfg),
                              mesh=make_mesh(devices=jax.devices()[:1]))
        key = jax.random.key(3)
        _, jm = jt.train_step(jt.state_from_params(jax.tree.map(jnp.asarray, params)), batch,
                              key)
        tr = ttrainer.Trainer(load_jax_params(models.get_model("relu", **hp), params),
                              ttrainer.TrainerConfig(**cfg))
        _, m = tr.train_step(tr.init_state(), batch, jax_draws(key, 2, 2))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        losses.append(float(m["loss"]))
    assert losses[0] != losses[1]


def test_upload_dtype_flag_trains(tmp_path, capsys):
    """``--upload_dtype bfloat16`` no longer raises: an epoch trains."""
    from sudo_rm_rf_tpu_torch.cli.train import main
    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus

    wham = write_wham_corpus(str(tmp_path / "wham"), n_train=4, n_val=2, seconds=0.5, seed=0)
    argv = ["--train", "WHAM", "--val", "WHAM", "--out_channels", "16", "--in_channels",
            "32", "--num_blocks", "1", "--upsampling_depth", "2", "--enc_num_basis", "16",
            "-bs", "2", "--audio_timelength", "0.5", "--n_jobs", "1", "--n_epochs", "1",
            "-elp", str(tmp_path / "logs"), "-clp", str(tmp_path / "ckpt"), "--wham_root",
            wham, "--loss_clamp", "0", "--device", "cpu", "--upload_dtype", "bfloat16"]
    assert main(argv) == 0
    assert "epoch 1/1" in capsys.readouterr().out
