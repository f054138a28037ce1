"""The subset of msgpack that ``flax.serialization`` writes and reads.

The JAX package saves every checkpoint with ``flax.serialization.to_bytes``
(``sudo_rm_rf_tpu/utils/checkpoint.py``): a msgpack map of the state dict,
whose array leaves are msgpack ext types. The port reads and writes the same
bytes with this module, so it needs neither ``msgpack`` nor flax.

Covered: nil, bool, int, float, str, bin, array, map, and flax's ext types

- 1, an ndarray: the msgpack array (shape, dtype name, C-order bytes);
- 2, a Python complex: the msgpack array (real, imag);
- 3, a numpy scalar: packed as a 0-d ndarray.

Arrays over :data:`MAX_CHUNK_SIZE` bytes are split into
``__msgpack_chunked_array__`` maps on write and assembled on read, as flax
does. Anything else raises. numpy has no bfloat16: a bfloat16 ndarray is
read into a ``torch.bfloat16`` tensor (through its uint16 bits), and such a
tensor is written as flax writes a ``jnp.bfloat16`` array.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax's limit on one array's bytes before it is chunked
MAX_CHUNK_SIZE = 2**30
CHUNKED_KEY = "__msgpack_chunked_array__"


# -- packing -------------------------------------------------------------------


def _pack_int(out: list, n: int) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < hi:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= lo:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_len(out: list, n: int, fix_base: int | None, fix_max: int, codes) -> None:
    """A length header: fix form below ``fix_max``, else 8/16/32-bit forms
    (``codes``, None where the type has no such form)."""
    if fix_base is not None and n < fix_max:
        out.append(bytes([fix_base | n]))
        return
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < hi:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(bytes([code]))
    out.append(data)


def _array_parts(x) -> tuple:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if not isinstance(x, np.ndarray):  # a torch tensor
        import torch

        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return x.shape, x.dtype.name, x.tobytes("C")


def _ndarray_payload(x) -> bytes:
    shape, name, data = _array_parts(x)
    return packb([list(shape), name, data])


def _is_tensor(x) -> bool:
    return type(x).__module__.startswith("torch") and hasattr(x, "detach")


def _pack(out: list, x) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif type(x) in (bytes, bytearray, memoryview):
        data = bytes(x)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif type(x) in (list, tuple):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, Mapping):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, np.ndarray) or _is_tensor(x):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif type(x) is complex:
        _pack_ext(out, EXT_COMPLEX, packb([x.real, x.imag]))
    else:
        raise TypeError(f"cannot pack {type(x).__name__} as flax msgpack")


def _nbytes(x) -> int:
    if isinstance(x, np.ndarray):
        return x.nbytes
    return x.numel() * x.element_size()


def _chunk(x) -> dict:
    """flax's ``_chunk``: a flat array in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = x.dtype.itemsize if isinstance(x, np.ndarray) else x.element_size()
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {CHUNKED_KEY: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[j: j + size]
                       for i, j in enumerate(range(0, flat.shape[0], size))}}


def _chunk_leaves(tree):
    """Oversized array leaves of maps (and a bare array) become chunk maps."""
    if isinstance(tree, Mapping):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if (isinstance(tree, np.ndarray) or _is_tensor(tree)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``: maps, lists, Python
    scalars, numpy arrays and scalars, torch tensors (bfloat16 included)."""
    out: list = []
    _pack(out, _chunk_leaves(tree))
    return b"".join(out)


# -- unpacking -----------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
        0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
        0xDC: ">H", 0xDD: ">I",  # array
        0xDE: ">H", 0xDF: ">I",  # map
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _dtype_from_name(name: str):
    """flax's ``_dtype_from_name``; bfloat16 is read as its uint16 bits."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _ndarray_from_payload(data: bytes):
    shape, name, buf = unpackb(data, _unchunk=False)
    if isinstance(name, bytes):
        name = name.decode()
    array = np.frombuffer(buf, dtype=_dtype_from_name(name)).reshape(shape)
    if name == "bfloat16":
        import torch

        return torch.from_numpy(array.copy()).view(torch.bfloat16)
    return array


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        array = _ndarray_from_payload(data)
        return array[()] if isinstance(array, np.ndarray) else array.reshape(())
    if code == EXT_COMPLEX:
        real, imag = unpackb(data, _unchunk=False)
        return complex(real, imag)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _read(r: _Reader):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXEXT[b])))
    if b in _LEN:
        n = r.unpack(_LEN[b])
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(r.take(n)).decode("utf-8")
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xDC, 0xDD):
            return [_read(r) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return _read_map(r, n)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], np.ndarray):
                return np.concatenate(chunks).reshape(shape)
            import torch

            return torch.cat(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes, _unchunk: bool = True):
    """``flax.serialization.msgpack_restore(data)``: maps come back as dicts,
    arrays as numpy arrays (bfloat16 ones as torch tensors)."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk_leaves(out) if _unchunk else out


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file's first byte opens a msgpack map (fixmap, map16 or
    map32), as every flax checkpoint does."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
