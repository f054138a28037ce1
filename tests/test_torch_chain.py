"""Chained steps, the bound on work in flight and the device-resident val
cache of the port (``Trainer.train_steps``, ``train.experiment``), on the
CPU: each must change how the steps are fed, never what they compute. The
JAX counterparts are ``tests/test_trainer.py``'s chain tests; here the
oracle is the port's own per-step path, and the checks are bit for bit.
"""

import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_pair_remix, draw_remix
from sudo_rm_rf_tpu_torch.train import augment
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

TINY = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
            enc_kernel_size=9, enc_num_basis=16, num_sources=2)


def _sources(seed, b=4, t=800):
    x = np.cumsum(np.random.default_rng(seed).standard_normal((b, 2, t)), axis=-1)
    return (x / x.std(axis=-1, keepdims=True)).astype(np.float32)


def _pair_prepare(draws, batch):
    mixture, targets = augment.online_remix_pairs(*batch, draws)
    return mixture[:, None, :], targets


def _trainer(pairs):
    model = models.get_model("relu", **TINY, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, TrainerConfig(learning_rate=1e-3),
                      prepare_batch=_pair_prepare if pairs else None)
    return trainer, trainer.init_state()


@pytest.mark.parametrize("pairs", [False, True], ids=["sources", "pairs"])
def test_train_steps_equal_sequential_steps(pairs):
    """Two chains of 3 against 6 single steps with the same batches and
    draws: every loss, grad norm and param bit for bit; the chain copies its
    stack once (each array of a pair once)."""
    batches = [(_sources(i), _sources(100 + i)) if pairs else _sources(i) for i in range(6)]
    g = torch.Generator().manual_seed(7)
    draws = [draw_pair_remix(g, 4, 2) if pairs else draw_remix(g, 4, 2) for _ in batches]

    tr_a, st_a = _trainer(pairs)
    seq = [tr_a.train_step(st_a, b, d)[1] for b, d in zip(batches, draws)]

    tr_b, st_b = _trainer(pairs)
    chained = []
    for c in range(2):
        chunk = batches[3 * c:3 * c + 3]
        stacked = (tuple(np.stack(x) for x in zip(*chunk)) if pairs else np.stack(chunk))
        st_b, metrics = tr_b.train_steps(st_b, stacked, draws[3 * c:3 * c + 3])
        assert metrics["loss"].shape == (3,)
        chained += [dict(loss=a, grad_norm=b) for a, b in zip(metrics["loss"],
                                                               metrics["grad_norm"])]
    for key in ("loss", "grad_norm"):
        assert [float(m[key]) for m in chained] == [float(m[key]) for m in seq], key
    assert st_b.step == st_a.step == 6
    for (name, a), b in zip(tr_a.model.state_dict().items(), tr_b.model.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="draws"):
        tr_b.train_steps(st_b, np.stack(batches[:2]) if not pairs else
                         tuple(np.stack(x) for x in zip(*batches[:2])), draws[:1])


def _experiment(tmp_path, monkeypatch, name, n_train=14, **train):
    from sudo_rm_rf_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus
    from sudo_rm_rf_tpu_torch.train.experiment import run_experiment
    from sudo_rm_rf_tpu_torch.utils import ExperimentLogger

    root = tmp_path / "wham"
    if not root.exists():
        write_wham_corpus(str(root), n_train=n_train, n_val=4, seconds=0.5, seed=0)
    monkeypatch.setenv("SUDO_TPU_WHAM_ROOT", str(root))
    cfg = ExperimentConfig(
        model=ModelConfig(**TINY),
        data=DataConfig(train=("WHAM",), val=("WHAM",), audio_timelength=0.5, batch_size=2,
                        n_jobs=1),
        train=TrainConfig(n_epochs=2, learning_rate=1e-3, save_checkpoint_every=0,
                          checkpoints_path=str(tmp_path / "ck"), **train),
        experiment_name=name,
    )
    logger = ExperimentLogger(str(tmp_path / "logs"), name)
    state, history = run_experiment(cfg, logger=logger, device="cpu")
    logger.close()
    losses = [np.load(tmp_path / "logs" / name / "tr_loss" / f"epoch_{e}.npy") for e in (1, 2)]
    vals = [np.load(tmp_path / "logs" / name / "val_SISDRi" / f"epoch_{e}.npy") for e in (1, 2)]
    return state, history, losses, vals


def test_chained_epochs_with_a_ragged_tail_equal_single_steps(tmp_path, monkeypatch):
    """7 steps an epoch as chains of 3 (two chains and a ragged step) with
    one dispatch in flight: the history, every step's loss and the params
    equal one step a dispatch with no bound."""
    st_a, hist_a, loss_a, _ = _experiment(tmp_path, monkeypatch, "chain",
                                          chain_steps=3, max_inflight=1)
    st_b, hist_b, loss_b, _ = _experiment(tmp_path, monkeypatch, "single",
                                          chain_steps=1, max_inflight=0)
    assert st_a.step == st_b.step == 14 and len(loss_a[0]) == 7
    assert hist_a == hist_b
    for a, b in zip(loss_a, loss_b):
        np.testing.assert_array_equal(a, b)
    for (name, a), b in zip(st_a.model.state_dict().items(), st_b.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_resident_val_cache_gives_the_streaming_path_sisdri(tmp_path, monkeypatch):
    """The unshuffled val loader kept on the device (read once) scores each
    epoch as the streaming loader path (SUDO_TPU_VAL_RESIDENT_MAX=0 keeps
    nothing) does, bit for bit."""
    from sudo_rm_rf_tpu_torch.train import experiment

    cached = []
    real = experiment._val_cache_entry
    monkeypatch.setattr(experiment, "_val_cache_entry",
                        lambda *a: cached.append(real(*a)) or cached[-1])
    _, hist_a, _, val_a = _experiment(tmp_path, monkeypatch, "cached", n_train=4)
    assert len(cached) == 1 and cached[0][0] == "pairs" and cached[0][1].shape == (2, 2, 1, 4000)
    monkeypatch.setenv("SUDO_TPU_VAL_RESIDENT_MAX", "0")
    _, hist_b, _, val_b = _experiment(tmp_path, monkeypatch, "streamed", n_train=4)
    assert cached[1] is None  # over the budget: the streaming path
    assert hist_a == hist_b
    for a, b in zip(val_a, val_b):
        np.testing.assert_array_equal(a, b)
