"""WHAMR! dataset loader (counterpart of ``sudo_rm_rf_tpu/data/whamr.py``).

A task maps to the *sources* the model hears (reverberant for
``noisy_reverberant``) and the anechoic *targets*; one random crop start,
drawn from the numpy rng ``(seed, epoch, idx)`` when augmenting, is shared by
the sources and targets of an item. Path layout
``root/wav{8,16}k/{min,max}/{tr,cv,tt}/<dir>/*.wav``. With the same files and
seed it yields the JAX package's arrays.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from sudo_rm_rf_tpu_torch.data import base
from sudo_rm_rf_tpu_torch.data.base import check_arg, read_wav, safe_pad

WHAMR_TASKS = {
    "noisy": {
        "mixture": "mix_both_anechoic",
        "sources": ["s1_anechoic", "s2_anechoic", "noise"],
        "targets": ["s1_anechoic", "s2_anechoic", "noise"],
        "n_sources": 3,
    },
    "noisy_reverberant": {
        "mixture": "mix_both_reverb",
        "sources": ["s1_reverb", "s2_reverb", "noise"],
        "targets": ["s1_anechoic", "s2_anechoic", "noise"],
        "n_sources": 3,
    },
}


class WhamRDataset:
    """Map-style dataset yielding (sources [3, T], targets [3, T]) float32."""

    def __init__(self, **kwargs):
        self.task = check_arg(kwargs, "task", str, choices=WHAMR_TASKS)
        self.zero_pad = check_arg(kwargs, "zero_pad", bool)
        self.augment = check_arg(kwargs, "augment", bool, default=False)
        self.min_or_max = check_arg(kwargs, "min_or_max", str, choices=["min", "max"])
        self.split = check_arg(kwargs, "split", str, choices=["cv", "tr", "tt"])
        self.n_samples = check_arg(
            kwargs, "n_samples", int, extra_checks=[lambda x: x >= 0], default=0
        )
        self.sample_rate = check_arg(kwargs, "sample_rate", int)
        self.root_path = check_arg(
            kwargs, "root_dirpath", str, extra_checks=[os.path.lexists]
        )
        self.timelength = float(check_arg(kwargs, "timelength", (int, float)))
        self.time_samples = int(self.sample_rate * self.timelength)
        self.seed = check_arg(kwargs, "seed", int, default=0)
        self._epoch = 0

        self.dataset_dirpath = self._get_path()
        mix_dir = os.path.join(self.dataset_dirpath, WHAMR_TASKS[self.task]["mixture"])
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
        if self.time_samples <= 0:  # whole recordings, padded to the longest
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

    def __getitem__(self, idx):
        filename = self.file_names[idx]
        task = WHAMR_TASKS[self.task]
        _, mixture = read_wav(os.path.join(self.dataset_dirpath, task["mixture"], filename))
        rand_start = 0
        if self.augment and len(mixture) > self.time_samples:
            rng = np.random.default_rng((self.seed, self._epoch, idx))
            rand_start = int(rng.integers(0, len(mixture) - self.time_samples))

        def load(names):
            wavs = []
            for name in names:
                _, wav = read_wav(os.path.join(self.dataset_dirpath, name, filename))
                wav = wav[rand_start : rand_start + self.time_samples]
                wavs.append(safe_pad(wav, self.time_samples, self.zero_pad))
            return np.stack(wavs).astype(np.float32)

        return load(task["sources"]), load(task["targets"])

    def get_generator(self, batch_size=4, shuffle=True, num_workers=4, **kw):
        from sudo_rm_rf_tpu_torch.data.loader import DataLoader

        return DataLoader(
            self, batch_size=batch_size, shuffle=shuffle,
            num_workers=num_workers, drop_last=True, **kw,
        )
