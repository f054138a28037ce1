"""Training options of the port on the CPU: ``remat_blocks`` (each block
under ``torch.utils.checkpoint``) gives the grads of the plain forward for
the Improved and GroupComm models in both trainable block forms, and the new
model types train through ``sudo-torch-train``. Grads with and without
remat: equal within rtol = atol = 1e-6 (the same ops recomputed)."""

import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.config import ModelConfig
from sudo_rm_rf_tpu_torch.models import improved_sudormrf

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

