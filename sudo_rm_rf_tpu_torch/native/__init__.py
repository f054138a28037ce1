"""ctypes bindings of the native wav reader ``wavio.cpp`` (counterpart of
``sudo_rm_rf_tpu/native/__init__.py``).

At first use ``g++`` (or ``c++``, ``clang++``) compiles ``wavio.cpp`` into
``sudo_rm_rf_tpu_torch/_build/libwavio_<hash>.so``, keyed on a hash of the
source as ``ops/_build.py`` keys the CUDA kernels, so an edited source
rebuilds. Nothing is built at import. Where no compiler or library is at
hand, or ``SUDO_TPU_DISABLE_NATIVE`` is set, every entry point takes the
scipy path of ``data.base.read_wav`` instead, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

SRC = Path(__file__).resolve().parent / "wavio.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]


def library_path() -> Path:
    """Path of the library built from the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libwavio_{h.hexdigest()[:16]}.so"


def _build_lib() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    for cc in ("g++", "c++", "clang++"):
        try:
            subprocess.run([cc, *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, so)
        return so
    tmp.unlink(missing_ok=True)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("SUDO_TPU_DISABLE_NATIVE"):
            return None
        so = _build_lib()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.wav_info.restype = ctypes.c_long
        lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
        lib.wav_read.restype = ctypes.c_long
        lib.wav_read.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_float)]
        lib.wav_read_batch.restype = ctypes.c_int
        lib.wav_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long), ctypes.c_int,
            ctypes.c_long, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


def wav_info(path: str) -> Tuple[int, int, int]:
    """(n_frames, sample_rate, channels) from the header only."""
    lib = get_lib()
    if lib is None:
        from sudo_rm_rf_tpu_torch.data.base import read_wav

        sr, wav = read_wav(path)
        return wav.shape[0], sr, (wav.shape[1] if wav.ndim > 1 else 1)
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    n = lib.wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise IOError(f"wav_info failed for {path} (code {n})")
    return int(n), int(sr.value), int(ch.value)


def read_batch(
    paths: Sequence[str],
    want: int,
    starts: Optional[Sequence[int]] = None,
    n_threads: int = 8,
) -> np.ndarray:
    """Decode n wavs into a (n, want) float32 mono array (crop/zero-pad),
    in parallel threads of the native library without the interpreter lock,
    or one by one through scipy without it. Channels are averaged to mono."""
    n = len(paths)
    out = np.empty((n, want), np.float32)
    lib = get_lib()
    if lib is None:
        from sudo_rm_rf_tpu_torch.data.base import read_wav

        for i, p in enumerate(paths):
            _, wav = read_wav(p)
            if wav.ndim > 1:
                wav = wav.mean(axis=-1)
            s = starts[i] if starts is not None else 0
            chunk = wav[s : s + want]
            row = np.zeros(want, np.float32)
            row[: chunk.shape[0]] = chunk
            out[i] = row
        return out

    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = None
    if starts is not None:
        c_starts = (ctypes.c_long * n)(*[int(s) for s in starts])
    totals = (ctypes.c_long * n)()
    bad = lib.wav_read_batch(c_paths, c_starts, n, want,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), totals,
                             n_threads)
    if bad:
        for i in range(n):
            if totals[i] < 0:
                raise IOError(f"native wav decode failed: {paths[i]} (code {totals[i]})")
    return out
