"""Loader of per-utterance preprocessed folders (counterpart of
``sudo_rm_rf_tpu/data/preprocessed.py``).

One folder an utterance, holding one joblib file an item: ``mixture_wav``,
``clean_wav_{i}`` and ``wav`` (the energy-normalized mixture), as
``prep.hierarchical.convert_wsj0mix_to_universal`` writes them in either
package. The files are read with the port's own ``utils.joblib_format``, so
the loader needs no ``joblib``.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from sudo_rm_rf_tpu_torch.data.base import DatasetConfigError, check_arg
from sudo_rm_rf_tpu_torch.utils import joblib_format


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a pickled torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


class PreprocessedDataset:
    """Yields tuples of the requested items, each (..., T) float32; a
    leading axis of one is dropped."""

    def __init__(self, **kwargs):
        self.root = check_arg(kwargs, "root_dirpath", str, extra_checks=[os.path.lexists])
        self.return_items = check_arg(kwargs, "return_items", list,
                                      default=["mixture_wav", "clean_wav_0", "clean_wav_1"])
        self.n_samples = check_arg(kwargs, "n_samples", int, default=0,
                                   extra_checks=[lambda x: x >= 0])
        self.folders: List[str] = sorted(
            d for d in glob.glob(os.path.join(self.root, "*")) if os.path.isdir(d))
        if not self.folders:
            raise DatasetConfigError(f"no utterance folders under {self.root}")
        if self.n_samples > 0:
            self.folders = self.folders[: self.n_samples]

    def __len__(self):
        return len(self.folders)

    def __getitem__(self, idx):
        out = []
        for item in self.return_items:
            path = os.path.join(self.folders[idx], item)
            try:
                data = _to_numpy(joblib_format.load(path)).astype(np.float32)
            except Exception as exc:
                raise IOError(f"failed to load {path}: {exc}") from exc
            out.append(data.squeeze(0) if data.ndim > 1 and data.shape[0] == 1 else data)
        return tuple(out)

    def get_generator(self, batch_size=4, shuffle=True, num_workers=4, **kw):
        from sudo_rm_rf_tpu_torch.data.loader import DataLoader

        return DataLoader(self, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=True, **kw)
