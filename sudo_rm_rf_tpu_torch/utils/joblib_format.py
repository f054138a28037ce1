"""The subset of joblib's file format that the hierarchical corpora hold.

The JAX package reads and writes these files with ``joblib`` itself
(``sudo_rm_rf_tpu/data/hierarchical.py``, ``sudo_rm_rf_tpu/prep/
hierarchical.py``); it has no reader of its own to port. The port carries
this small reader and writer instead, so that it needs no ``joblib``.

What ``joblib.dump(array, path)`` writes for a numpy array, uncompressed:

1. a pickle (protocol 4) of a ``joblib.numpy_pickle.NumpyArrayWrapper``
   whose state holds ``subclass``, ``shape``, ``order``, ``dtype``,
   ``allow_mmap`` and ``numpy_array_alignment_bytes`` (16), ending in
   ``BUILD``; the pickle frame is committed there;
2. one byte, the count of pad bytes, then that many ``0xff`` bytes, so the
   array starts on a 16-byte boundary of the file;
3. the array's raw bytes in ``order`` ('C' or 'F');
4. the rest of the pickle, ending in ``STOP``.

:func:`load` reads such files, and also plain pickles with no wrapper (older
hierarchical folders hold pickled torch tensors). :func:`dump` writes the
same bytes as ``joblib.dump``. Compressed files raise: the corpus writers
never compress.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np

_WRAPPER = ("joblib.numpy_pickle", "NumpyArrayWrapper")
_ALIGNMENT = 16
# the first bytes of joblib's compressed files, by compressor
_COMPRESSED = ((b"\x78", "zlib"), (b"\x1f\x8b", "gzip"), (b"BZh", "bz2"),
               (b"\xfd7zXZ", "xz"), (b"\x5d\x00\x00", "lzma"), (b"\x04\x22\x4d\x18", "lz4"))


class NumpyArrayWrapper:
    """Stands in for joblib's wrapper: the array's metadata, in the order
    joblib's constructor sets it."""

    def __init__(self, array: np.ndarray | None = None):
        if array is None:  # unpickling: BUILD fills __dict__
            return
        self.subclass = np.ndarray
        self.shape = array.shape
        self.order = "F" if (array.flags.f_contiguous and not array.flags.c_contiguous) else "C"
        self.dtype = array.dtype
        self.allow_mmap = True
        self.numpy_array_alignment_bytes = _ALIGNMENT

    def read(self, fh) -> np.ndarray:
        if self.dtype.hasobject:
            raise ValueError("arrays of Python objects are not supported")
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            pad = fh.read(1)[0]
            fh.read(pad)
        count = int(np.prod(self.shape, dtype=np.int64))
        nbytes = count * self.dtype.itemsize
        data = fh.read(nbytes)
        if len(data) != nbytes:
            raise EOFError(f"array data: expected {nbytes} bytes, got {len(data)}")
        array = np.frombuffer(data, dtype=self.dtype, count=count).copy()
        if self.order == "F":
            return array.reshape(self.shape[::-1]).transpose()
        return array.reshape(self.shape)


class _Unpickler(pickle._Unpickler):
    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, fh):
        super().__init__(fh)
        self._fh = fh

    def find_class(self, module, name):
        if (module, name) == _WRAPPER:
            return NumpyArrayWrapper
        if module.startswith("joblib"):
            raise pickle.UnpicklingError(f"unsupported joblib class {module}.{name}")
        return super().find_class(module, name)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], NumpyArrayWrapper):
            # the frame ends at BUILD: the array's bytes follow in the file
            self.stack.append(self.stack.pop().read(self._fh))

    dispatch[pickle.BUILD[0]] = load_build


def _check_uncompressed(path: str, head: bytes) -> None:
    if head[:1] == b"\x80":  # PROTO: a pickle of protocol 2 or later
        return
    for magic, name in _COMPRESSED:
        if head.startswith(magic):
            raise ValueError(f"{path}: a {name}-compressed joblib file; only "
                             "uncompressed files are read")
    raise ValueError(f"{path}: not an uncompressed joblib file (first bytes {head[:4]!r})")


def load(path: str) -> Any:
    """Read a file written by ``joblib.dump`` (uncompressed) or a plain
    pickle; arrays come back as numpy arrays."""
    with open(path, "rb") as fh:
        _check_uncompressed(path, fh.read(8))
        fh.seek(0)
        return _Unpickler(fh).load()


class _Pickler(pickle._Pickler):
    def __init__(self, fh):
        super().__init__(fh, protocol=4)
        self._fh = fh

    def save(self, obj, save_persistent_id=True):
        if type(obj) is np.ndarray:
            wrapper = NumpyArrayWrapper(obj)
            super().save(wrapper, save_persistent_id)
            self.framer.commit_frame(force=True)
            fh = self._fh
            pad = _ALIGNMENT - (fh.tell() + 1) % _ALIGNMENT
            fh.write(bytes([pad]) + b"\xff" * pad)
            fh.write(obj.tobytes(wrapper.order))
            return
        super().save(obj, save_persistent_id)

    def save_global(self, obj, name=None):
        if obj is NumpyArrayWrapper:  # under joblib's name, which joblib.load finds
            self.save(_WRAPPER[0])
            self.save(_WRAPPER[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def dump(value: Any, path: str) -> str:
    """Write ``value`` (a numpy array, or a tree holding some) as
    ``joblib.dump(value, path)`` does, uncompressed; returns ``path``."""
    with open(path, "wb") as fh:
        _Pickler(fh).dump(value)
    return path

