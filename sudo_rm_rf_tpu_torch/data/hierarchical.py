"""Augmented online mixing over hierarchical class folders (counterpart of
``sudo_rm_rf_tpu/data/hierarchical.py``: the same draws in the same order,
so the same items).

Items are read as ``data[dataset][class_folder][sample]``. For each source:
a dataset drawn by the priors, a class (not the first source's class when in
the same dataset), a sample, a random delay; then source 0 is scaled to a
random SNR in +-max_abs_snr dB against unit-energy source 1, and mixture and
sources are standardized by the mixture's std (ddof=1). ``fixed_seed`` > 0
pre-draws every random number, so val and test sets are the same in every
epoch; otherwise item ``idx`` of epoch ``e`` draws from
``np.random.default_rng((seed, e, idx))``.

Each sample folder holds files written as ``joblib.dump`` writes them
(``prep.hierarchical``, ``data.synthetic.write_hierarchical_corpus``), read
here with ``utils.joblib_format``.
"""

from __future__ import annotations

import collections
import glob
import os
import threading
from typing import List

import numpy as np

from sudo_rm_rf_tpu_torch.data.base import DatasetConfigError, check_arg
from sudo_rm_rf_tpu_torch.utils import joblib_format


def _to_numpy(x):
    if hasattr(x, "detach"):  # a torch tensor, as older hierarchical folders hold
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _DecodedSourceCache:
    """Bounded LRU of decoded source arrays, keyed by file path.

    Online mixing redraws its sources from a fixed pool of files, so after
    one epoch nearly every read hits and an item costs a slice and a stack.
    Thread-safe (the loader's workers share it); entries are read-only by
    convention. Its size is ``SUDO_TPU_WAV_CACHE_BYTES`` (0 disables; default
    2 GiB), the setting the JAX package reads too.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._data: "collections.OrderedDict[str, np.ndarray]" = collections.OrderedDict()
        self._bytes = 0

    def get(self, path: str):
        if self.max_bytes <= 0:
            return _to_numpy(joblib_format.load(path)).astype(np.float32)
        with self._lock:
            arr = self._data.get(path)
            if arr is not None:
                self._data.move_to_end(path)
                return arr
        arr = _to_numpy(joblib_format.load(path)).astype(np.float32)
        with self._lock:
            if path not in self._data:
                self._data[path] = arr
                self._bytes += arr.nbytes
                while self._bytes > self.max_bytes and len(self._data) > 1:
                    _, old = self._data.popitem(last=False)
                    self._bytes -= old.nbytes
        return arr


_source_cache = _DecodedSourceCache(int(os.environ.get("SUDO_TPU_WAV_CACHE_BYTES", 2 << 30)))


class AugmentedOnlineMixingDataset:
    """Yields (mixture [T], sources [n_sources, T]) float32, and one stacked
    array per extra ``return_items`` entry."""

    def __init__(self, **kwargs):
        self.input_dataset_p = check_arg(
            kwargs, "input_dataset_p", list,
            extra_checks=[lambda ps: all(os.path.lexists(p) for p in ps)],
        )
        self.datasets_priors = check_arg(
            kwargs, "datasets_priors", list,
            default=[1.0 / len(self.input_dataset_p)] * len(self.input_dataset_p),
            extra_checks=[lambda pr: abs(sum(pr) - 1.0) < 1e-5],
        )
        if len(self.datasets_priors) != len(self.input_dataset_p):
            raise DatasetConfigError("one prior per dataset path required")
        self.n_sources = check_arg(kwargs, "n_sources", int, extra_checks=[lambda x: x >= 1],
                                   default=2)
        self.n_samples = check_arg(kwargs, "n_samples", int, extra_checks=[lambda x: x >= 1])
        self.max_abs_snr = float(check_arg(kwargs, "max_abs_snr", (int, float), default=2.5))
        self.sample_rate = check_arg(kwargs, "sample_rate", int, default=8000)
        self.selected_timelength = float(
            check_arg(kwargs, "selected_timelength", (int, float), default=4.0))
        self.selected_wav_samples = int(self.sample_rate * self.selected_timelength)
        self.return_items = check_arg(kwargs, "return_items", list, default=["wav"])
        self.fixed_seed = check_arg(kwargs, "fixed_seed", int, default=0,
                                    extra_checks=[lambda x: x >= 0])
        self.seed = check_arg(kwargs, "seed", int, default=0)
        self._epoch = 0

        self.n_datasets = len(self.input_dataset_p)
        self.priors_cdf = np.cumsum(self.datasets_priors)
        self.hierarchical_folders = [sorted(glob.glob(os.path.join(dp, "*")))
                                     for dp in self.input_dataset_p]
        self.n_hierarchical_folders = [len(f) for f in self.hierarchical_folders]
        self.sample_folders: List[List[List[str]]] = []
        self.n_sample_folders: List[List[int]] = []
        for dataset_folders in self.hierarchical_folders:
            samples = [sorted(glob.glob(os.path.join(h, "*"))) for h in dataset_folders]
            self.sample_folders.append(samples)
            self.n_sample_folders.append([len(s) for s in samples])
        if any(n == 0 for n in self.n_hierarchical_folders):
            raise DatasetConfigError("a dataset root has no class folders")

        # every draw made up front, so val and test sets repeat each epoch
        if self.fixed_seed:
            rng = np.random.default_rng(self.fixed_seed)
            self.random_draws = rng.random((self.n_samples, self.n_sources, 5))
        else:
            self.random_draws = None

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return self.n_samples

    def _draw(self, rng, mixture_idx, source_idx, j):
        if self.random_draws is not None:
            return self.random_draws[mixture_idx, source_idx, j]
        return rng.random()

    def __getitem__(self, mixture_idx):
        rng = np.random.default_rng((self.seed, self._epoch, mixture_idx))

        sources, energies, extra_files = [], [], []
        prev_indexes = []
        for source_idx in range(self.n_sources):
            draw = self._draw(rng, mixture_idx, source_idx, 0)
            dataset_idx = int(np.searchsorted(self.priors_cdf, draw, side="right"))
            dataset_idx = min(dataset_idx, self.n_datasets - 1)

            # never two sounds of one class in a mixture
            not_equal_to = None
            if prev_indexes:
                prev_d, prev_h = prev_indexes[0]
                if prev_d == dataset_idx:
                    not_equal_to = prev_h
            h_draw = self._draw(rng, mixture_idx, source_idx, 1)
            h_idx = int(h_draw * self.n_hierarchical_folders[dataset_idx])
            if not_equal_to is not None and h_idx == not_equal_to:
                h_idx = (h_idx + 1) % self.n_hierarchical_folders[dataset_idx]

            s_draw = self._draw(rng, mixture_idx, source_idx, 2)
            s_idx = int(s_draw * self.n_sample_folders[dataset_idx][h_idx])
            prev_indexes.append((dataset_idx, h_idx))

            folder = self.sample_folders[dataset_idx][h_idx][s_idx]
            wav = _source_cache.get(os.path.join(folder, self.return_items[0]))
            if wav.ndim == 1:
                wav = wav[None, :]

            d_draw = self._draw(rng, mixture_idx, source_idx, 3)
            delay = int(d_draw * (wav.shape[-1] - self.selected_wav_samples))
            chunk = wav[:, delay: delay + self.selected_wav_samples]
            if np.allclose(chunk, 0):
                chunk = wav[:, : self.selected_wav_samples]

            energies.append(np.sqrt(np.sum(chunk**2)))
            sources.append(chunk)
            for j, item in enumerate(self.return_items[1:]):
                loaded = joblib_format.load(os.path.join(folder, item))
                if j >= len(extra_files):
                    extra_files.append([loaded])
                else:
                    extra_files[j].append(loaded)

        # source 0 at a random SNR against unit-energy source 1
        snr_ratio = (self._draw(rng, mixture_idx, 0, 4) - 0.5) * self.max_abs_snr * 2
        ratio = np.sqrt(10.0 ** (snr_ratio / 10.0))
        sources[0] = ratio * sources[0] / (energies[0] + 10e-8)
        sources[1] = sources[1] / (energies[1] + 10e-8)

        clean = np.concatenate(sources, axis=0)  # (n_sources, T)
        mixture = np.sum(clean, axis=0, keepdims=True)
        clean = clean - clean.mean(axis=1, keepdims=True)
        mixture = mixture - mixture.mean(axis=1, keepdims=True)
        mix_std = mixture.std(axis=1, ddof=1)

        out_mix = (mixture / (mix_std + 10e-8)).squeeze(0).astype(np.float32)
        out_src = (clean / (mix_std + 10e-8)).astype(np.float32)
        if len(self.return_items) > 1:
            packed = [np.stack([_to_numpy(e) for e in items]) for items in extra_files]
            return (out_mix, out_src, *packed)
        return out_mix, out_src

    def get_generator(self, batch_size=4, shuffle=True, num_workers=4, **kw):
        from sudo_rm_rf_tpu_torch.data.loader import DataLoader

        return DataLoader(self, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=True, **kw)
