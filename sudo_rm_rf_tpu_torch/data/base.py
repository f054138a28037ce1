"""Dataset plumbing shared by the port's loaders (counterpart of
``sudo_rm_rf_tpu/data/base.py``).

Validated kwargs, wav reading, per-sample standardization, fixed-length
zero-pad/crop and the wav-length metadata cache. The cache is the JAX
package's file (``metadata``, a pickled list of (basename, n_samples) next to
the data), so both packages keep the same files and draw the same crops.
Lengths come from the wav headers and windows are decoded alone through the
native reader (``native/``) where it builds, else through scipy. Imports
numpy and scipy only.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class DatasetConfigError(ValueError):
    pass


def check_arg(
    kwargs: dict,
    name: str,
    known_type: type,
    choices: Optional[Iterable] = None,
    extra_checks: Sequence[Callable] = (),
    default=None,
):
    """Validated-kwarg accessor."""
    if name not in kwargs:
        if default is not None:
            return default
        raise DatasetConfigError(f"missing required dataset argument {name!r}")
    value = kwargs[name]
    if not isinstance(value, known_type):
        raise DatasetConfigError(
            f"argument {name!r} must be {getattr(known_type, '__name__', known_type)}, "
            f"got {type(value).__name__}"
        )
    if choices is not None and value not in list(choices):
        raise DatasetConfigError(
            f"argument {name!r} must be one of {sorted(map(str, choices))}, "
            f"got {value!r}"
        )
    for check in extra_checks:
        if not check(value):
            raise DatasetConfigError(f"argument {name!r}={value!r} failed validation")
    return value


def read_wav(path: str) -> Tuple[int, np.ndarray]:
    """Read a wav file to float32 (int PCM scaled by dtype max; float wavs
    passed through)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return sr, data


def read_wav_window(path: str, start: int, want: int) -> np.ndarray:
    """``want`` mono float32 samples from ``start`` (zero-padded past the
    end): the native reader decodes only the window; without it scipy
    decodes the whole file (``native.read_batch``)."""
    from sudo_rm_rf_tpu_torch import native

    return native.read_batch([path], want, starts=[start])[0]


def wav_frames(path: str) -> int:
    """Number of frames, from the header alone where the native reader
    builds (``native.wav_info``)."""
    from sudo_rm_rf_tpu_torch import native

    return native.wav_info(path)[0]


def normalize_wav(wav: np.ndarray, eps: float = 1e-8, std=None) -> np.ndarray:
    """(x - mean) / (std + eps); std defaults to the wav's own (ddof=1, as
    torch.std)."""
    mean = wav.mean(axis=-1, keepdims=True)
    if std is None:
        std = wav.std(axis=-1, keepdims=True, ddof=1)
    return (wav - mean) / (std + eps)


def safe_pad(wav: np.ndarray, time_samples: int, zero_pad: bool) -> np.ndarray:
    """Crop to time_samples; zero-pad first if shorter and allowed."""
    if zero_pad and wav.shape[-1] < time_samples:
        out = np.zeros(wav.shape[:-1] + (time_samples,), np.float32)
        out[..., : wav.shape[-1]] = wav
        return out
    return wav[..., :time_samples]


def length_metadata(
    dirpath: str,
    wav_paths: List[str],
    cache_name: str = "metadata",
    expected_sr: Optional[int] = None,
) -> List[Tuple[str, int]]:
    """(basename, n_samples) for every wav, cached in a pickle next to the
    data. The cache is keyed only by existence. The native reader probes
    the headers only; without it every file is decoded."""
    cache_path = os.path.join(dirpath, cache_name)
    if os.path.lexists(cache_path):
        with open(cache_path, "rb") as fh:
            return pickle.load(fh)

    from sudo_rm_rf_tpu_torch import native

    info = []
    for p in sorted(wav_paths):
        n, sr, _ = native.wav_info(p)
        if expected_sr is not None and sr != expected_sr:
            raise DatasetConfigError(f"{p}: sample rate {sr} != expected {expected_sr}")
        info.append((os.path.basename(p), n))
    try:
        with open(cache_path, "wb") as fh:
            pickle.dump(info, fh)
    except OSError:
        pass  # read-only dataset dirs: just skip the cache
    return info
