"""The port's training auto-tuner (``train/autotune.py``), on the CPU: the six
cases of ``tests/test_autotune.py`` on the port, and its one departure from
JAX: only ``torch.cuda.OutOfMemoryError`` becomes a failed row, every other
error is raised.
"""

import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu_torch.train import autotune
from sudo_rm_rf_tpu_torch.train.autotune import (
    TUNABLE_FAMILIES,
    autotune_block_impl,
    autotune_train_config,
)
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

TINY = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
            enc_kernel_size=21, enc_num_basis=16, num_sources=2)
QUICK = dict(audio_seconds=0.125, n_hi=3, device="cpu")


def test_autotune_picks_measured_max():
    res = autotune_train_config(TINY, batch_sizes=(2, 4), compute_dtype=None,
                                model_type="relu", impls=("xla", "fma"), **QUICK)
    ok = [r for r in res.rows if r.error is None]
    assert len(ok) == 4, res.rows
    best = max(ok, key=lambda r: r.audio_sec_per_sec)
    assert (res.impl, res.batch_size) == (best.impl, best.batch_size)
    assert all(best.audio_sec_per_sec >= r.audio_sec_per_sec for r in ok)
    assert "*" in res.table()


def test_autotune_single_batch_keeps_user_semantics():
    res = autotune_block_impl(TINY, batch_size=2, compute_dtype=None, model_type="relu",
                              **QUICK)
    assert res.batch_size == 2  # the tuner never changes the user's batch
    assert res.impl in ("xla", "fma")


def test_autotune_groupcomm_family():
    assert "groupcomm_v2" in TUNABLE_FAMILIES
    res = autotune_block_impl(dict(TINY, group_size=4), batch_size=2, compute_dtype=None,
                              model_type="groupcomm_v2", **QUICK)
    assert res.impl in ("xla", "fma")


def test_autotune_four_sources():
    """A 4-slot model (MUSDB, FUSS) calibrates with a 4-source batch."""
    res = autotune_block_impl(dict(TINY, num_sources=4), batch_size=2, compute_dtype=None,
                              model_type="relu", **QUICK)
    assert res.impl in ("xla", "fma")
    assert all(r.error is None for r in res.rows), res.rows


def test_autotune_rejects_multichannel():
    with pytest.raises(ValueError, match="in_audio_channels"):
        autotune_block_impl(dict(TINY, group_size=4, in_audio_channels=2), batch_size=2,
                            compute_dtype=None, model_type="groupcomm_v2", **QUICK)


def test_experiment_block_impl_auto(tmp_path, capsys):
    """``block_impl='auto'`` resolves to a measured form before the model is
    built, through the experiment runner; the table and pick are printed."""
    from sudo_rm_rf_tpu_torch.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from sudo_rm_rf_tpu_torch.train.experiment import run_experiment
    from sudo_rm_rf_tpu_torch.utils import ExperimentLogger

    rng = np.random.default_rng(0)
    t = int(0.25 * 8000)

    class _Gen:
        dataset = None  # the loader surface run_experiment reads
        batch_size = 2

        def __iter__(self):
            return iter([rng.standard_normal((2, 2, t)).astype(np.float32)
                         for _ in range(2)])

        def __len__(self):
            return 2

    cfg = ExperimentConfig(
        model=ModelConfig(model_type="relu", block_impl="auto", **TINY),
        data=DataConfig(train=("WHAM",), val=(), test=(), fs=8000, audio_timelength=0.25,
                        batch_size=2),
        train=TrainConfig(n_epochs=1, learning_rate=1e-3, loss_clamp=0.0,
                          checkpoints_path=str(tmp_path / "ckpt")),
        experiment_name="auto_impl",
    )
    logger = ExperimentLogger(str(tmp_path / "logs"), "auto_impl")
    state, history = run_experiment(cfg, generators={"train": _Gen()}, logger=logger,
                                    device="cpu")
    logger.close()
    assert cfg.model.block_impl in ("xla", "fma")  # resolved, not 'auto'
    assert all(b.block_impl == cfg.model.block_impl for b in state.model.sm)
    assert f"block_impl auto -> {cfg.model.block_impl}\nimpl      bs" in capsys.readouterr().out
    assert np.isfinite(history[-1]["tr_loss"])


def _failing_on(impl, error):
    real = autotune.measure_train_step_secs

    def measure(model, *a, **kw):
        if model.sm[0].block_impl == impl:
            raise error
        return real(model, *a, **kw)

    return measure


def test_autotune_records_an_out_of_memory_row(monkeypatch):
    """A candidate that runs out of device memory is a failed row of the
    table; the other is picked."""
    monkeypatch.setattr(autotune, "measure_train_step_secs",
                        _failing_on("fma", torch.cuda.OutOfMemoryError("CUDA out of memory")))
    res = autotune_block_impl(TINY, batch_size=2, compute_dtype=None, **QUICK)
    assert res.impl == "xla"
    (bad,) = [r for r in res.rows if r.error is not None]
    assert bad.impl == "fma" and "out of memory" in bad.error
    assert "ERROR" in res.table()


def test_autotune_raises_every_other_error(monkeypatch):
    """Any other fault of a candidate is raised, not hidden behind the
    other block form (JAX records every exception as a row)."""
    monkeypatch.setattr(autotune, "measure_train_step_secs",
                        _failing_on("fma", RuntimeError("illegal memory access")))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        autotune_block_impl(TINY, batch_size=2, compute_dtype=None, **QUICK)
