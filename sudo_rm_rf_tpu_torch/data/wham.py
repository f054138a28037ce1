"""WHAM dataset loader (counterpart of ``sudo_rm_rf_tpu/data/wham.py``).

Task table, path layout ``root/wav{8,16}k/{min,max}/{tr,cv,tt}``,
length-metadata cache, a random crop drawn from the numpy rng
``(seed, epoch, idx)`` when augmenting, per-wav standardization then joint
re-standardization by the mixture std. With the same files and seed it
yields the JAX package's arrays.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from sudo_rm_rf_tpu_torch.data import base
from sudo_rm_rf_tpu_torch.data.base import check_arg, normalize_wav, read_wav, safe_pad

# task -> mixture dir, source dirs, n separable sources
WHAM_TASKS = {
    "enhance_single_white_noise": {
        "mixture": "source_with_white_noise",
        "sources": ["s1", "white_noise"],
        "n_sources": 1,
    },
    "enhance_single": {
        "mixture": "mix_single",
        "sources": ["s1", "noise"],
        "n_sources": 1,
    },
    "enhance_both": {
        "mixture": "mix_both",
        "sources": ["mix_clean", "noise"],
        "n_sources": 1,
    },
    "sep_clean": {
        "mixture": "mix_clean",
        "sources": ["s1", "s2"],
        "n_sources": 2,
    },
    "sep_noisy": {
        "mixture": "mix_both",
        "sources": ["s1", "s2", "noise"],
        "n_sources": 2,
    },
}
WHAM_TASKS["enh_single"] = WHAM_TASKS["enhance_single"]
WHAM_TASKS["enh_both"] = WHAM_TASKS["enhance_both"]


class WhamDataset:
    """Map-style dataset yielding (mixture [T], sources [S, T]) float32."""

    splits = ("cv", "tr", "tt")

    def __init__(self, **kwargs):
        self.task = check_arg(kwargs, "task", str, choices=WHAM_TASKS)
        self.zero_pad = check_arg(kwargs, "zero_pad", bool)
        self.augment = check_arg(kwargs, "augment", bool, default=False)
        self.normalize_audio = check_arg(kwargs, "normalize_audio", bool)
        self.min_or_max = check_arg(kwargs, "min_or_max", str, choices=["min", "max"])
        self.split = check_arg(kwargs, "split", str, choices=self.splits)
        self.n_samples = check_arg(
            kwargs, "n_samples", int, extra_checks=[lambda x: x >= 0], default=0
        )
        self.sample_rate = check_arg(kwargs, "sample_rate", int)
        self.root_path = check_arg(
            kwargs, "root_dirpath", str, extra_checks=[os.path.lexists]
        )
        self.timelength = float(check_arg(kwargs, "timelength", (int, float)))
        self.time_samples = int(self.sample_rate * self.timelength)
        # explicit seeding replaces the reference's time-seeded workers
        self.seed = check_arg(kwargs, "seed", int, default=0)
        self._epoch = 0

        self.dataset_dirpath = self._get_path()
        mix_dir = os.path.join(self.dataset_dirpath, WHAM_TASKS[self.task]["mixture"])
        wavs = glob.glob(os.path.join(mix_dir, "*.wav"))
        info = base.length_metadata(self.dataset_dirpath, wavs)
        kept = [
            (name, n) for (name, n) in info
            if n >= self.time_samples or self.zero_pad
        ]
        if self.n_samples > 0:
            kept = kept[: self.n_samples]
        if not kept:
            raise base.DatasetConfigError(f"no usable wavs under {mix_dir}")
        max_len = max(n for _, n in kept)
        self.file_names = [name for name, _ in kept]
        if self.time_samples <= 0:
            self.time_samples = max_len

    def _get_path(self):
        path = os.path.join(
            self.root_path,
            f"wav{int(self.sample_rate / 1000)}k",
            self.min_or_max,
            self.split,
        )
        if not os.path.lexists(path):
            raise IOError(f"Dataset path: {path} not found!")
        return path

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.file_names)

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self._epoch, idx))

    def __getitem__(self, idx):
        filename = self.file_names[idx]
        task = WHAM_TASKS[self.task]
        _, mixture = read_wav(
            os.path.join(self.dataset_dirpath, task["mixture"], filename)
        )
        rand_start = 0
        if self.augment and len(mixture) > self.time_samples:
            rand_start = int(
                self._rng(idx).integers(0, len(mixture) - self.time_samples)
            )
            mixture = mixture[rand_start : rand_start + self.time_samples]
        if self.normalize_audio:
            mixture = normalize_wav(mixture)
        mixture = safe_pad(mixture, self.time_samples, self.zero_pad)

        sources = []
        for source_name in task["sources"]:
            _, wav = read_wav(
                os.path.join(self.dataset_dirpath, source_name, filename)
            )
            wav = wav[rand_start : rand_start + self.time_samples]
            if self.normalize_audio:
                wav = normalize_wav(wav)
            sources.append(safe_pad(wav, self.time_samples, self.zero_pad))

        if self.normalize_audio:
            mix_std = mixture.std()
            mixture = normalize_wav(mixture, std=mix_std)
            sources = [normalize_wav(s, std=mix_std) for s in sources]
        return mixture.astype(np.float32), np.stack(sources).astype(np.float32)

    def get_generator(self, batch_size=4, shuffle=True, num_workers=4, **kw):
        from sudo_rm_rf_tpu_torch.data.loader import DataLoader

        return DataLoader(
            self, batch_size=batch_size, shuffle=shuffle,
            num_workers=num_workers, drop_last=True, **kw,
        )
