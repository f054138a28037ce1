"""Load the JAX package's param trees and train states into the port, and
write a model's params as such a tree.

The port's modules carry the torch reference's attribute names, so a flax
param tree (nested dicts of arrays) maps onto ``model.state_dict()`` by pure
renaming (``convert.torch_checkpoint``). Adam's moments are trees of the same
structure and map the same way. The JAX package's scan layouts are read as
the unrolled trees: the attentive models' ``sm_scan/block/...`` (each leaf
stacked over the blocks on axis 0; JAX's ``attentive.stack_block_params``)
as ``sm_{i}``, and SepFormer's ``layers_scan/layer/...`` inside every
encoder (``masknet/dual_mdl_i/{intra,inter}_mdl/mdl``; JAX's
``sepformer.stack_sepformer_params``) as ``layers_{j}``.
"""

from __future__ import annotations

from collections.abc import Mapping
from types import SimpleNamespace

import torch

from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import (
    load_state_dict_checked,
    params_to_state_dict,
    torch_key_to_flax_path,
)


def _take(tree, i):
    if isinstance(tree, Mapping):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


# scan node -> (its child holding the stacked leaves, the unrolled prefix)
_SCAN_LAYOUTS = {"sm_scan": ("block", "sm"), "layers_scan": ("layer", "layers")}


def unstack_block_params(params):
    """The unrolled tree of a tree in a JAX scan layout, at any depth: each
    ``sm_scan/block`` becomes ``sm_0`` .. ``sm_{n-1}`` and each
    ``layers_scan/layer`` ``layers_0`` .. (leaves stacked on axis 0), the
    inverse of JAX's ``stack_block_params`` and ``stack_sepformer_params``;
    a tree in no scan layout comes back as it is (the same object)."""
    if not isinstance(params, Mapping):
        return params
    out = {}
    for key, value in params.items():
        if key in _SCAN_LAYOUTS:
            child, prefix = _SCAN_LAYOUTS[key]
            stacked = value[child]
            n = len(next(iter(_leaves(stacked))))
            out.update({f"{prefix}_{i}": unstack_block_params(_take(stacked, i))
                        for i in range(n)})
        else:
            out[key] = unstack_block_params(value)
    same = out.keys() == params.keys() and all(out[k] is params[k] for k in out)
    return params if same else out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


def load_jax_params(model, params):
    """Copy a flax ``params`` tree (nested dicts of numpy arrays, unrolled
    or in the scan layout) into ``model`` with a strict
    ``load_state_dict``; returns the model."""
    return load_state_dict_checked(
        model, params_to_state_dict(unstack_block_params(params), model.state_dict().keys()))


def params_to_flax(model) -> dict:
    """The model's params as an unrolled flax ``params`` tree (nested dicts
    of numpy arrays), the inverse of :func:`load_jax_params`."""
    tree: dict = {}
    for name, p in model.named_parameters():
        node, path = tree, torch_key_to_flax_path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().cpu().numpy().copy()
    return tree


def _find_adam_state(tree):
    """The optax ``ScaleByAdamState`` (count, mu, nu) inside an opt state: a
    tree of optax's states, or their state dicts as a checkpoint holds them."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return SimpleNamespace(count=tree["count"], mu=tree["mu"], nu=tree["nu"])
        tree = list(tree.values())
    if all(hasattr(tree, k) for k in ("count", "mu", "nu")):
        return tree
    if isinstance(tree, (tuple, list)):
        for item in tree:
            found = _find_adam_state(item)
            if found is not None:
                return found
    return None


def load_jax_train_state(model, optimizer, params, opt_state, step, shards=None):
    """Carry a JAX ``TrainState`` (as numpy trees) into the port.

    ``params`` go into ``model`` as in :func:`load_jax_params`; the optax
    Adam state inside ``opt_state`` (``ScaleByAdamState.mu/nu/count``)
    becomes ``optimizer``'s ``exp_avg``, ``exp_avg_sq`` and ``step`` for each
    param; ``step`` is the count of updates, which the LR schedule reads.
    ``optimizer`` is a ``torch.optim.Adam`` over ``model.parameters()``.
    With ``shards`` (a ``parallel.RowShards``) each param it names, and its
    moments, go in as this rank's rows. Returns the port's ``TrainState``.
    """
    from sudo_rm_rf_tpu_torch.train.trainer import TrainState

    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam state (count, mu, nu)")
    keys = model.state_dict().keys()
    local = (lambda sd: sd) if shards is None else shards.local_state_dict
    load_state_dict_checked(model, local(params_to_state_dict(unstack_block_params(params), keys)))
    mu, nu = (local(params_to_state_dict(unstack_block_params(m), keys))
              for m in (adam.mu, adam.nu))
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    count = float(adam.count)
    for name, p in model.named_parameters():
        if id(p) not in owned:
            raise ValueError(f"optimizer does not hold param {name}")
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].reshape(p.shape).to(p.device, p.dtype),
            "exp_avg_sq": nu[name].reshape(p.shape).to(p.device, p.dtype),
        }
    return TrainState(step=int(step), model=model, optimizer=optimizer, shards=shards)
