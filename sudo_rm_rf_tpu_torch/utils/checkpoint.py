"""Checkpoint manager of the port (counterpart of
``sudo_rm_rf_tpu/utils/checkpoint.py``).

The JAX manager's policies and file names: periodic saves
``<model>_epoch_<n>`` every N epochs, ``save_if_best`` keeping one
``best_<metric>_<value>_<ts>`` and one ``current_<metric>_<value>_<ts>``
snapshot (each with a ``.json`` of its metadata), ``latest_epoch``,
``load_best`` and ``load_latest``; every write is atomic. A file holds what
the JAX manager writes: the flax-msgpack state dict of the JAX trainer's
``TrainState`` (the update count, the params and optax's Adam state;
``convert.flax_checkpoint``), so a run resumes with its Adam moments and
either package resumes the other's run. ``restore`` also reads the
``torch.save({"step", "model", "optimizer"})`` files that earlier versions
of the port wrote; ``convert.checkpoint_format`` tells the two apart by
their first bytes.

Over a (data, model) grid of ranks every rank calls every policy, and one
manager (rank 0's, ``writer=True``) writes and removes files. A state whose
params are stored as row shards (``TrainState.shards``) is gathered whole
first, a collective of the model group, so every file holds the whole tree
that a one-process run (of either package) reads. ``restore`` reads the
whole file on every rank and keeps each rank's rows.
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import re
from typing import Optional

import torch

from sudo_rm_rf_tpu_torch.convert import flax_checkpoint


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


class CheckpointManager:
    """Manages best/current/periodic checkpoints for one experiment dir."""

    def __init__(self, directory: str, model_name: str = "model", writer: bool = True):
        self.directory = directory
        self.model_name = model_name
        self.writer = writer
        if writer:
            os.makedirs(directory, exist_ok=True)
        self._best_value: Optional[float] = None

    # -- low-level -----------------------------------------------------------

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def save(self, state, tag: str, metadata: Optional[dict] = None) -> str:
        """Write a ``TrainState`` to <dir>/<tag> (the writer only; a sharded
        state is gathered on every rank)."""
        path = self._path(tag)
        if not self.writer:
            if getattr(state, "shards", None) is not None:
                flax_checkpoint.train_state_to_flax(state)  # the gather's collectives
            return path
        tmp = path + ".tmp"
        flax_checkpoint.save_train_state(state, tmp)
        os.replace(tmp, path)  # atomic: a crash never leaves a torn file
        if metadata is not None:
            with open(path + ".json", "w") as fh:
                json.dump(metadata, fh)
        return path

    def restore(self, state, tag: Optional[str] = None, path: Optional[str] = None):
        """Load a checkpoint into ``state`` (its model and optimizer, in
        place) and return it."""
        if path is None:
            path = self._path(tag)
        shards = getattr(state, "shards", None)
        if flax_checkpoint.checkpoint_format(path) == "msgpack":
            state.step = flax_checkpoint.load_train_state_from_checkpoint(
                path, state.model, state.optimizer, shards=shards).step
            return state
        if shards is not None:
            raise ValueError(f"{path}: a torch.save checkpoint does not resume sharded params")
        # on the host: load_state_dict copies each tensor to where its param
        # lives, and Adam keeps its step counts on the host
        blob = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(blob["model"], strict=True)
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        return state

    # -- policies ------------------------------------------------------------

    def save_every(self, state, epoch: int, every: int) -> Optional[str]:
        """Periodic save."""
        if every > 0 and epoch % every == 0:
            return self.save(state, f"{self.model_name}_epoch_{epoch}", {"epoch": epoch})
        return None

    def save_if_best(self, state, metric_name: str, value: float, epoch: int,
                     higher_is_better: bool = True) -> bool:
        """Replace the current_ snapshot; replace the best_ one if ``value``
        beats every earlier one. Returns whether it did."""
        ts = _timestamp()
        meta = {"epoch": epoch, metric_name: value}
        for old in glob.glob(self._path("current_*")) if self.writer else ():
            os.remove(old)
        self.save(state, f"current_{metric_name}_{value:.4f}_{ts}", meta)

        is_best = (
            self._best_value is None
            or (higher_is_better and value > self._best_value)
            or (not higher_is_better and value < self._best_value)
        )
        if is_best:
            self._best_value = value
            for old in glob.glob(self._path("best_*")) if self.writer else ():
                os.remove(old)
            self.save(state, f"best_{metric_name}_{value:.4f}_{ts}", meta)
        return is_best

    def _latest(self, pattern: str) -> str:
        matches = sorted(glob.glob(self._path(pattern)))
        matches = [m for m in matches if not m.endswith((".json", ".tmp"))]
        if not matches:
            raise FileNotFoundError(f"no checkpoint matching {pattern} in {self.directory}")
        return matches[-1]

    def load_best(self, state):
        return self.restore(state, path=self._latest("best_*"))

    def load_latest(self, state):
        try:
            return self.restore(state, path=self._latest("current_*"))
        except FileNotFoundError:
            return self.restore(state, path=self._latest(f"{self.model_name}_epoch_*"))

    def latest_epoch(self) -> int:
        epochs = []
        for m in glob.glob(self._path(f"{self.model_name}_epoch_*")):
            match = re.search(r"_epoch_(\d+)$", m)
            if match:
                epochs.append(int(match.group(1)))
        return max(epochs) if epochs else 0
