"""The JAX package's msgpack checkpoints, read and written by the port
(counterpart of ``sudo_rm_rf_tpu/convert/flax_checkpoint.py``).

The JAX package saves with ``flax.serialization.to_bytes``: either a bare
param tree, or a whole ``TrainState`` of its trainer, whose state dict is

    {"step": int32,
     "params": {<module>: {... {"weight": array}}},
     "opt_state": {"0": {},                        # clip_by_global_norm
                   "1": {"0": {"count": int32,      # scale_by_adam
                               "mu": <params tree>, "nu": <params tree>},
                         "1": {"count": int32}}}}  # scale_by_schedule

(``optax.chain(clip_by_global_norm, adam(schedule))``). The port reads and
writes these bytes with ``convert.msgpack_format``; params move through the
same renaming as every other JAX tree (``convert.load_jax_params``), and
Adam's ``mu``/``nu``/``count`` are ``torch.optim.Adam``'s ``exp_avg``,
``exp_avg_sq`` and ``step``.
"""

from __future__ import annotations

import numpy as np
import torch

from sudo_rm_rf_tpu_torch.convert import msgpack_format
from sudo_rm_rf_tpu_torch.convert.jax_params import load_jax_params, load_jax_train_state
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import torch_key_to_flax_path


def checkpoint_format(path: str) -> str:
    """``"msgpack"`` for a flax-msgpack checkpoint of either package,
    ``"torch"`` for a ``torch.save`` file (the zip of torch >= 1.6, or the
    older bare pickle); anything else raises. Decided by the first bytes, as
    the JAX package's file names carry no suffix."""
    with open(path, "rb") as fh:
        head = fh.read(2)
    # a pickle opens with PROTO (0x80) and its protocol; msgpack's 0x80 is an
    # empty map, with nothing after it
    if head == b"PK" or (len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5):
        return "torch"
    if msgpack_format.is_msgpack_map(head):
        return "msgpack"
    raise ValueError(f"{path} is neither a msgpack nor a torch.save checkpoint "
                     f"(first bytes {head!r})")


def read_checkpoint(path: str) -> dict:
    """The state dict of a msgpack checkpoint file, as numpy trees."""
    if checkpoint_format(path) != "msgpack":
        raise ValueError(f"{path} is a torch.save file, not a msgpack checkpoint")
    with open(path, "rb") as fh:
        return msgpack_format.unpackb(fh.read())


def _is_train_state(tree: dict) -> bool:
    return {"step", "params", "opt_state"} <= set(tree)


def load_params_from_checkpoint(path: str) -> dict:
    """The nested param tree (numpy arrays) of a checkpoint holding bare
    params or a whole ``TrainState`` (its ``params``)."""
    tree = read_checkpoint(path)
    return tree["params"] if _is_train_state(tree) else tree


def load_model_from_checkpoint(path: str, model):
    """Strict-load a checkpoint's params into ``model``; returns it."""
    return load_jax_params(model, load_params_from_checkpoint(path))


def load_train_state_from_checkpoint(path: str, model, optimizer, shards=None):
    """A JAX ``TrainState`` file into the port: params into ``model``, Adam's
    moments and count into ``optimizer`` (a ``torch.optim.Adam`` over
    ``model.parameters()``); with ``shards`` (a ``parallel.RowShards``) each
    sharded param and its moments as this rank's rows. Returns the port's
    ``TrainState``."""
    tree = read_checkpoint(path)
    if not _is_train_state(tree):
        raise ValueError(f"{path} holds bare params, not a TrainState")
    return load_jax_train_state(model, optimizer, tree["params"], tree["opt_state"],
                                int(tree["step"]), shards=shards)


def _insert(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def train_state_to_flax(state) -> dict:
    """The state dict of the JAX trainer's ``TrainState`` for a port
    ``TrainState`` (its model, its Adam and its count of updates). Params
    stored as row shards (``state.shards``) and their moments are gathered
    whole: a collective that every rank of the model group calls."""
    shards = getattr(state, "shards", None)
    whole = (lambda name, v: v) if shards is None else shards.whole
    params, mu, nu, counts = {}, {}, {}, set()
    for name, p in state.model.named_parameters():
        path = torch_key_to_flax_path(name)
        adam = state.optimizer.state.get(p, {})
        _insert(params, path, whole(name, p.detach()).cpu().numpy())
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            moment = adam.get(key)
            moment = torch.zeros_like(p) if moment is None else moment.detach()
            _insert(tree, path, whole(name, moment).cpu().numpy())
        counts.add(int(adam["step"]) if "step" in adam else 0)
    if len(counts) > 1:
        raise ValueError(f"Adam's params were stepped unequally: {sorted(counts)}")
    count = np.array(counts.pop() if counts else 0, np.int32)
    return {"step": np.array(state.step, np.int32), "params": params,
            "opt_state": {"0": {}, "1": {"0": {"count": count, "mu": mu, "nu": nu},
                                         "1": {"count": count.copy()}}}}


def save_train_state(state, path: str) -> str:
    """Write ``state`` as the JAX package's ``CheckpointManager`` writes a
    ``TrainState``; returns ``path``."""
    with open(path, "wb") as fh:
        fh.write(msgpack_format.packb(train_state_to_flax(state)))
    return path
