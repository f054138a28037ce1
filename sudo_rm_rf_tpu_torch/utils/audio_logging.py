"""Audio logging (counterpart of ``sudo_rm_rf_tpu/utils/audio_logging.py``):
peak-normalized wav dumps of ``mixture``, ``true_s{i}`` and ``est_s{i}`` for
the first items of a batch.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _peak_normalize(wav: np.ndarray, peak: float = 0.9) -> np.ndarray:
    m = np.abs(wav).max()
    return wav * (peak / m) if m > 0 else wav


class AudioLogger:
    def __init__(self, out_dir: str, fs: int = 8000, bs: int = 1, n_sources: int = 2):
        self.out_dir = out_dir
        self.fs = fs
        self.bs = bs
        self.n_sources = n_sources
        os.makedirs(out_dir, exist_ok=True)

    def log_batch(
        self,
        pr_batch,
        t_batch,
        mix_batch,
        experiment=None,
        step: Optional[int] = None,
        tag: str = "",
        max_batch_items: int = 4,
    ):
        """pr/t: (B, S, T); mix: (B, T) or (B, 1, T)."""
        from scipy.io import wavfile

        pr = np.asarray(pr_batch)
        t = np.asarray(t_batch)
        mix = np.asarray(mix_batch)
        if mix.ndim == 3:
            mix = mix[:, 0, :]

        step_dir = os.path.join(
            self.out_dir, f"{tag}_step_{step}" if step is not None else tag or "batch"
        )
        os.makedirs(step_dir, exist_ok=True)
        for b in range(min(pr.shape[0], max_batch_items)):
            items = {"mixture": mix[b]}
            # FUSS per-count val sets have fewer true sources than estimates
            for s in range(min(self.n_sources, t.shape[1])):
                items[f"true_s{s + 1}"] = t[b, s]
            for s in range(min(self.n_sources, pr.shape[1])):
                items[f"est_s{s + 1}"] = pr[b, s]
            for name, wav in items.items():
                wav16 = (
                    _peak_normalize(wav.astype(np.float32)) * 32767
                ).astype(np.int16)
                path = os.path.join(step_dir, f"b{b}_{name}.wav")
                wavfile.write(path, self.fs, wav16)
                if experiment is not None and hasattr(experiment, "log_audio"):
                    experiment.log_audio(path, sample_rate=self.fs, step=step)
