"""FUSS universal sound separation dataset loader (counterpart of
``sudo_rm_rf_tpu/data/fuss.py``).

Parses ``{split}_example_list.txt``, whose lines are ``mixture src1 src2
...``, keeps the examples whose source count lies in [min, max], and yields a
zero-padded [max_num_sources, T] stack of the example's sources, sorted by
path (the mixture is their sum, made downstream). Each source gets its own
random crop start from the numpy rng ``(seed, epoch, idx)`` when augmenting.
16 kHz only.
"""

from __future__ import annotations

import os

import numpy as np

from sudo_rm_rf_tpu_torch.data.base import DatasetConfigError, check_arg, read_wav, safe_pad


class FUSSDataset:
    """Map-style dataset yielding sources [max_num_sources, T] float32
    (silent rows zero)."""

    def __init__(self, **kwargs):
        self.zero_pad = check_arg(kwargs, "zero_pad", bool, default=True)
        self.augment = check_arg(kwargs, "augment", bool, default=False)
        self.min_num_sources = check_arg(
            kwargs, "min_num_sources", int, extra_checks=[lambda x: x >= 1]
        )
        self.max_num_sources = check_arg(
            kwargs, "max_num_sources", int,
            extra_checks=[lambda x: x >= self.min_num_sources],
        )
        self.split = check_arg(kwargs, "split", str, choices=["train", "eval", "validation"])
        self.sample_rate = check_arg(kwargs, "sample_rate", int, choices=[16000])
        self.root_path = check_arg(
            kwargs, "root_dirpath", str, extra_checks=[os.path.lexists]
        )
        self.timelength = float(check_arg(kwargs, "timelength", (int, float)))
        self.time_samples = int(self.sample_rate * self.timelength)
        self.seed = check_arg(kwargs, "seed", int, default=0)
        self._epoch = 0

        list_path = os.path.join(self.root_path, f"{self.split}_example_list.txt")
        if not os.path.lexists(list_path):
            raise IOError(f"FUSS example list not found: {list_path}")
        with open(list_path) as f:
            lines = [line.split() for line in f if line.strip()]
        self.source_folder_names = [
            [os.path.join(self.root_path, sp) for sp in sorted(toks[1:])]
            for toks in lines
            if self.min_num_sources <= len(toks) - 1 <= self.max_num_sources
        ]
        if not self.source_folder_names:
            raise DatasetConfigError("no FUSS examples matched the source-count range")
        n_samples = check_arg(
            kwargs, "n_samples", int, default=0,
            extra_checks=[lambda x: 0 <= x <= len(self.source_folder_names)],
        )
        if n_samples > 0:
            self.source_folder_names = self.source_folder_names[:n_samples]

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.source_folder_names)

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        wavs = []
        for p in self.source_folder_names[idx]:
            _, wav = read_wav(p)
            if self.time_samples > 0:
                rand_start = 0
                if self.augment and len(wav) > self.time_samples:
                    rand_start = int(rng.integers(0, len(wav) - self.time_samples))
                wav = wav[rand_start : rand_start + self.time_samples]
            wavs.append(safe_pad(wav, self.time_samples, self.zero_pad))
        stacked = np.stack(wavs)
        out = np.zeros((self.max_num_sources, stacked.shape[-1]), np.float32)
        out[: len(wavs)] = stacked
        return out

    def get_generator(self, batch_size=4, shuffle=True, num_workers=4,
                      drop_last=True, **kw):
        from sudo_rm_rf_tpu_torch.data.loader import DataLoader

        return DataLoader(
            self, batch_size=batch_size, shuffle=shuffle,
            num_workers=num_workers, drop_last=drop_last, **kw,
        )
