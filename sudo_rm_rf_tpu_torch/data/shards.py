"""Sharded-file ingestion for many-file corpora (counterpart of
``sudo_rm_rf_tpu/data/shards.py``).

A corpus of many small wavs costs an open and a decode per source per
example. :func:`pack_dataset` writes a map-style dataset's items once into a
few large shard files of raw little-endian samples with a byte-offset index,
so an item is one ``os.pread`` per field from the page cache, with no decode.
:class:`ShardedDataset` reads them through the port's threaded
``data.loader.DataLoader``, whose ``device_put_fn`` hook copies each batch to
the device in the producer thread while the next batch is read.

Format (version 1, shared with the JAX package: a set written by either
reads in the other):
  <name>.shard-NNNNN.bin   concatenated raw record payloads
  <name>.index.json        {"version", "schema": [[field, dtype], ...],
                            "records": [[shard, offset, [shape...] per
                            field], ...]}

A record is a tuple of arrays in ``schema`` order; shapes may differ between
records (FUSS's source counts), and byte sizes follow from dtype and shape.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

_VERSION = 1


def write_shards(
    records: Iterable[Tuple[np.ndarray, ...]],
    out_dir: str,
    name: str = "data",
    schema: Optional[Sequence[Tuple[str, str]]] = None,
    target_shard_bytes: int = 256 * 2**20,
) -> str:
    """Pack an iterable of array tuples into shards; returns the index path.
    A shard is closed once it holds ``target_shard_bytes``."""
    os.makedirs(out_dir, exist_ok=True)
    index: List = []
    shard_id, shard_f, shard_off = -1, None, 0

    def roll():
        nonlocal shard_id, shard_f, shard_off
        if shard_f is not None:
            shard_f.close()
        shard_id += 1
        shard_off = 0
        shard_f = open(os.path.join(out_dir, f"{name}.shard-{shard_id:05d}.bin"), "wb")

    roll()
    for rec in records:
        rec = tuple(np.ascontiguousarray(a) for a in rec)
        if schema is None:
            schema = [(f"field{i}", str(a.dtype)) for i, a in enumerate(rec)]
        if len(rec) != len(schema):
            raise ValueError(f"record arity {len(rec)} != schema arity {len(schema)}")
        if shard_off > 0 and shard_off >= target_shard_bytes:
            roll()
        shapes = []
        for (fname, dtype), a in zip(schema, rec):
            if str(a.dtype) != dtype:
                raise ValueError(f"{fname}: dtype {a.dtype} != schema {dtype}")
            shard_f.write(a.tobytes())
            shapes.append(list(a.shape))
        index.append([shard_id, shard_off, shapes])
        shard_off += sum(a.nbytes for a in rec)
    shard_f.close()

    index_path = os.path.join(out_dir, f"{name}.index.json")
    with open(index_path, "w") as fh:
        json.dump({"version": _VERSION, "schema": [list(s) for s in schema],
                   "records": index}, fh)
    return index_path


class ShardedDataset:
    """Map-style dataset over a shard set: ``__getitem__`` is one pread per
    field and returns a tuple of read-only arrays."""

    def __init__(self, index_path: str):
        with open(index_path) as fh:
            meta = json.load(fh)
        if meta["version"] != _VERSION:
            raise ValueError(f"{index_path}: shard version {meta['version']}, "
                             f"this reader takes {_VERSION}")
        self.schema = [(n, np.dtype(d)) for n, d in meta["schema"]]
        self.records = meta["records"]
        self._base = index_path[: -len(".index.json")]
        self._files: dict = {}
        # the loader reads items from a pool of threads: each shard is opened
        # once, and every reader holds the file it reads
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.records)

    def _file(self, sid: int):
        with self._lock:
            f = self._files.get(sid)
            if f is None:
                f = open(f"{self._base}.shard-{sid:05d}.bin", "rb", buffering=0)
                self._files[sid] = f
            return f

    def __getitem__(self, idx: int):
        sid, off, shapes = self.records[idx]
        f = self._file(sid)
        out = []
        for (_, dtype), shape in zip(self.schema, shapes):
            nbytes = int(np.prod(shape)) * dtype.itemsize
            out.append(np.frombuffer(os.pread(f.fileno(), nbytes, off),
                                     dtype=dtype).reshape(shape))
            off += nbytes
        return tuple(out)

    def close(self):
        with self._lock:
            for f in self._files.values():
                f.close()
            self._files.clear()

    def get_generator(self, batch_size=4, shuffle=True, num_workers=4, drop_last=True, **kw):
        from sudo_rm_rf_tpu_torch.data.loader import DataLoader

        return DataLoader(self, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last, **kw)


def pack_dataset(dataset, out_dir: str, name: str = "data",
                 schema: Optional[Sequence[Tuple[str, str]]] = None,
                 target_shard_bytes: int = 256 * 2**20) -> str:
    """Pack any map-style dataset (a tuple of arrays, or one array, per item:
    a WHAM, LibriMix, FUSS or MUSDB loader) into shards, so training epochs
    read a handful of files instead of the raw corpus. Returns the index
    path."""

    def gen():
        for i in range(len(dataset)):
            item = dataset[i]
            if not isinstance(item, tuple):
                item = (item,)
            yield tuple(np.asarray(a) for a in item)

    return write_shards(gen(), out_dir, name=name, schema=schema,
                        target_shard_bytes=target_shard_bytes)
