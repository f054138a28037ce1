"""Pick the training step's block implementation by measuring it
(counterpart of ``sudo_rm_rf_tpu/train/autotune.py``).

The U-ConvBlock has interchangeable forms with one param tree (``xla``: the
plain convolutions; ``fma``: the fused depthwise ladder), so the pick moves
speed, never numerics or checkpoints. :func:`autotune_block_impl` times each
on the live device at the user's batch and dtype through the real
``Trainer`` step (remix, forward, PIT loss, backward, clip and Adam) and
returns the fastest; :func:`autotune_train_config` sweeps batch sizes too,
for throughput-oriented callers (``sudo_rm_rf_tpu_torch.bench``'s training
row). ``sudo-torch-train --block_impl auto`` calibrates once at build,
prints the table and trains with the pick.

Timing is ``utils.benchmark.time_call``'s: CUDA events around each step
after warm-up steps, the median (the host clock on the CPU).

One departure from JAX: a candidate that runs out of device memory
(``torch.cuda.OutOfMemoryError``) becomes a failed row, and every other
error is raised. JAX records any exception as a failed row; on the card that
would hide a fault of one block form behind the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

SR, SECS = 8000, 4.0

# model families with interchangeable block implementations (one param tree)
TUNABLE_FAMILIES = ("relu", "groupcomm_v2")


@dataclass
class AutotuneRow:
    impl: str
    batch_size: int
    ms_per_step: float
    audio_sec_per_sec: float
    error: Optional[str] = None


@dataclass
class AutotuneResult:
    impl: str
    batch_size: int
    rows: list = field(default_factory=list)

    def table(self) -> str:
        lines = ["impl      bs  ms/step   au-s/s"]
        for r in self.rows:
            if r.error:
                lines.append(f"{r.impl:<8} {r.batch_size:>3}  ERROR {r.error[:60]}")
            else:
                star = " *" if (r.impl == self.impl and r.batch_size == self.batch_size) else ""
                lines.append(f"{r.impl:<8} {r.batch_size:>3}  {r.ms_per_step:>8.2f} "
                             f"{r.audio_sec_per_sec:>8.1f}{star}")
        return "\n".join(lines)


def measure_train_step_secs(
    model,
    batch_size: int,
    compute_dtype: Optional[str],
    audio_seconds: float = SECS,
    fs: int = SR,
    n_hi: int = 9,
    loss_clamp: float = 30.0,
    num_sources: int = 2,
) -> float:
    """Median seconds of one real train step of ``model`` on its device (a
    seeded random source batch resident there, the remix drawn there)."""
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix
    from sudo_rm_rf_tpu_torch.utils.benchmark import time_call

    trainer = Trainer(model, TrainerConfig(learning_rate=1e-3, compute_dtype=compute_dtype,
                                           loss_clamp=loss_clamp))
    device = trainer.device
    t = int(audio_seconds * fs)
    batch = torch.randn((batch_size, num_sources, t),
                        generator=torch.Generator(device=device).manual_seed(1), device=device)
    state = trainer.init_state()
    draws = torch.Generator(device=device).manual_seed(2)
    return time_call(
        lambda: trainer.train_step(state, batch, draw_remix(draws, batch_size, num_sources)),
        device, n=n_hi)


def autotune_train_config(
    model_kwargs: dict,
    batch_sizes: Sequence[int],
    compute_dtype: Optional[str],
    model_type: str = "relu",
    impls: Sequence[str] = ("xla", "fma"),
    audio_seconds: float = SECS,
    fs: int = SR,
    n_hi: int = 9,
    device="cuda",
) -> AutotuneResult:
    """Measure every (impl, batch) candidate on ``device``; return the one
    that trains the most audio seconds a second, with the whole table.

    The calibration batch has the model's ``num_sources``. Multichannel
    input (``in_audio_channels > 1``) takes another batch contract than the
    remix: callers pick its block form themselves (the experiment falls back
    to 'xla')."""
    from sudo_rm_rf_tpu_torch import models

    if model_kwargs.get("in_audio_channels", 1) != 1:
        raise ValueError("autotune calibrates with the single-channel remix batch "
                         "contract; pass in_audio_channels=1 or pick block_impl "
                         "explicitly for multichannel models")
    device = torch.device(device)
    num_sources = int(model_kwargs.get("num_sources", 2))
    rows = []
    for impl in impls:
        for bs in batch_sizes:
            model = models.get_model(model_type, **model_kwargs, block_impl=impl,
                                     device=device, generator=torch.Generator().manual_seed(0))
            try:
                secs = measure_train_step_secs(model, bs, compute_dtype, num_sources=num_sources,
                                               audio_seconds=audio_seconds, fs=fs, n_hi=n_hi)
            except torch.cuda.OutOfMemoryError as e:
                rows.append(AutotuneRow(impl, bs, 0.0, 0.0, repr(e)[:200]))
                continue
            finally:
                del model
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            rows.append(AutotuneRow(impl, bs, round(secs * 1e3, 2),
                                    round(bs * audio_seconds / secs, 1)))
    ok = [r for r in rows if r.error is None]
    if not ok:
        raise RuntimeError("autotune: every candidate ran out of memory:\n"
                           + "\n".join(f"{r.impl}/bs{r.batch_size}: {r.error}" for r in rows))
    best = max(ok, key=lambda r: r.audio_sec_per_sec)
    return AutotuneResult(impl=best.impl, batch_size=best.batch_size, rows=rows)


def autotune_block_impl(
    model_kwargs: dict,
    batch_size: int,
    compute_dtype: Optional[str],
    model_type: str = "relu",
    impls: Sequence[str] = ("xla", "fma"),
    audio_seconds: float = SECS,
    fs: int = SR,
    n_hi: int = 9,
    device="cuda",
) -> AutotuneResult:
    """The fastest block implementation at the user's batch size: the tuner
    never changes what trains (effective batch, learning rate), only the
    block form, which computes the same function."""
    return autotune_train_config(model_kwargs, (batch_size,), compute_dtype,
                                 model_type=model_type, impls=impls,
                                 audio_seconds=audio_seconds, fs=fs, n_hi=n_hi, device=device)
