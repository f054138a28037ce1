"""Batching data loader with threaded prefetch (counterpart of
``sudo_rm_rf_tpu/data/loader.py``).

A numpy-native loader: deterministic seeded shuffling per epoch, drop_last
batching, a thread pool for IO-bound wav reads, and a bounded prefetch
queue. With the same seed it yields the JAX package's batches in the same
order. A ``device_put_fn`` hook can move each batch to the device in the
producer thread, overlapping the copy with the next batch's disk reads. An
exception in the producer thread is raised by the iterator (the JAX
package's loader would wait for a batch that never comes).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np


class DataLoader:
    """Iterate minibatches over a map-style dataset.

    Dataset protocol: __len__ and __getitem__(idx) -> tuple of np.ndarrays
    (all items must share shapes so they stack).
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        device_put_fn: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self.seed = seed
        self.device_put_fn = device_put_fn
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            yield order[start : start + self.batch_size]

    def _collate(self, items):
        first = items[0]
        if isinstance(first, tuple):
            return tuple(
                np.stack([np.asarray(it[k]) for it in items]) for k in range(len(first))
            )
        return np.stack([np.asarray(it) for it in items])

    def __iter__(self) -> Iterator:
        self._epoch += 1
        batches = list(self._batch_indices())
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, idxs))
                        batch = self._collate(items)
                        if self.device_put_fn is not None:
                            batch = self.device_put_fn(batch)
                        out_q.put(batch)
            except Exception as exc:  # handed to the consumer, which raises it
                out_q.put(_Failure(exc))
                return
            out_q.put(_END)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                batch = out_q.get()
                if batch is _END:
                    return
                if isinstance(batch, _Failure):
                    raise batch.exc
                yield batch
        finally:
            stop.set()
            # drain so the producer can exit
            while worker.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break


_END = object()


class _Failure:
    """An exception of the producer thread, on its way to the consumer."""

    def __init__(self, exc: Exception):
        self.exc = exc
