"""MUSDB18 music source-separation loader (counterpart of
``sudo_rm_rf_tpu/data/musdb.py``).

Four stems, drums / bass / other / vocals, read from the decoded directory
layout ``root/{train,test}/<track>/{mixture,drums,bass,other,vocals}.wav``
(the musdb decode output). Augmented epochs draw a random track and segment
per item from ``default_rng((seed, epoch, idx))``; otherwise each track gives
one segment, drawn once at construction from ``default_rng(seed)`` on a grid
of whole segments. Mono is the sum over the audio channels. A track shorter
than the segment is zero-padded. The JAX package's loader draws the same
segments and yields the same items. Imports numpy and scipy only.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from sudo_rm_rf_tpu_torch.data.base import DatasetConfigError, check_arg, read_wav

STEMS = ["drums", "bass", "other", "vocals"]


class MusdbDataset:
    """Yields stem stacks (n_channels, 4, T) float32 (mono: n_channels = 1)."""

    def __init__(self, **kwargs):
        self.augment = check_arg(kwargs, "augment", bool, default=False)
        self.zero_pad = check_arg(kwargs, "zero_pad", bool, default=True)
        self.split = check_arg(kwargs, "split", str, choices=["train", "test"])
        self.sample_rate = check_arg(kwargs, "sample_rate", int)
        self.n_channels = check_arg(kwargs, "n_channels", int, choices=[1, 2])
        self.root_path = check_arg(kwargs, "root_dirpath", str, extra_checks=[os.path.lexists])
        self.timelength = float(check_arg(kwargs, "timelength", (int, float)))
        self.time_samples = int(self.sample_rate * self.timelength)
        self.n_samples = check_arg(kwargs, "n_samples", int, extra_checks=[lambda x: x >= 0],
                                   default=0)
        self.seed = check_arg(kwargs, "seed", int, default=0)
        self._epoch = 0

        split_dir = os.path.join(self.root_path, self.split)
        self.track_dirs = sorted(
            d for d in glob.glob(os.path.join(split_dir, "*")) if os.path.isdir(d))
        if not self.track_dirs:
            raise DatasetConfigError(f"no musdb track dirs under {split_dir}")
        if self.n_samples <= 0:
            self.n_samples = len(self.track_dirs)

        # one segment per track for the epochs without augmentation
        self._predefined = None
        if not self.augment:
            rng = np.random.default_rng(self.seed)
            self._predefined = []
            for i, d in enumerate(self.track_dirs):
                _, wav = read_wav(os.path.join(d, "mixture.wav"))
                dur = wav.shape[0]
                if self.time_samples <= 0 or dur <= self.time_samples:
                    start = 0
                else:
                    start = int(rng.integers(0, dur // self.time_samples)) * self.time_samples
                self._predefined.append((i, start))
            self.n_samples = min(self.n_samples, len(self._predefined))

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return self.n_samples

    def _read_stems(self, track_dir: str, start: int) -> np.ndarray:
        stems = []
        for stem in STEMS:
            sr, wav = read_wav(os.path.join(track_dir, f"{stem}.wav"))
            if sr != self.sample_rate:
                raise DatasetConfigError(
                    f"{track_dir}/{stem}.wav: rate {sr} != {self.sample_rate}")
            if wav.ndim == 1:
                wav = wav[:, None]
            if self.time_samples > 0:
                wav = wav[start:start + self.time_samples]
            stems.append(wav.T.astype(np.float32))  # (ch, T)
        out = np.stack(stems, axis=1)  # (ch, 4, T)
        if self.time_samples > 0 and out.shape[-1] < self.time_samples:
            pad = np.zeros(out.shape[:-1] + (self.time_samples,), np.float32)
            pad[..., :out.shape[-1]] = out
            out = pad
        return out

    def __getitem__(self, idx):
        if self.augment:
            rng = np.random.default_rng((self.seed, self._epoch, idx))
            track_dir = self.track_dirs[int(rng.integers(0, len(self.track_dirs)))]
            _, wav = read_wav(os.path.join(track_dir, "mixture.wav"))
            start = 0
            if self.time_samples > 0 and wav.shape[0] > self.time_samples:
                start = int(rng.integers(0, wav.shape[0] - self.time_samples))
        else:
            track_id, start = self._predefined[idx]
            track_dir = self.track_dirs[track_id]
        data = self._read_stems(track_dir, start)
        if self.n_channels == 1:
            return np.sum(data, axis=0, keepdims=True)  # (1, 4, T)
        return data

    def get_generator(self, batch_size=4, shuffle=True, num_workers=4, **kw):
        from sudo_rm_rf_tpu_torch.data.loader import DataLoader

        return DataLoader(self, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=True, **kw)
