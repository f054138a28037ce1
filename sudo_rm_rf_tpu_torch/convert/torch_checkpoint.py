"""Torch ``.pt`` checkpoints and flax param trees, for the port.

The port keeps its own copy of the renaming that the JAX package's
``sudo_rm_rf_tpu/convert/torch_checkpoint.py`` defines, so that it imports
nothing of that package. Every module of both packages names its params after
the torch reference's attributes, so conversion is pure renaming:

    torch ``sm.0.proj_1x1.conv.weight``
      <-> flax path ``('sm_0', 'proj_1x1', 'conv', 'weight')``

(list indices are fused into the parent name with '_').
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

# hyperparameters a whole pickled module carries as attributes
_HPARAM_ATTRS = (
    "in_audio_channels", "out_channels", "in_channels", "num_blocks",
    "upsampling_depth", "enc_kernel_size", "enc_num_basis", "num_sources",
    "group_size",
)


def torch_key_to_flax_path(key: str) -> Tuple[str, ...]:
    """Map a torch state_dict key to a flax param path: digit tokens
    (ModuleList/Sequential indices) merge into the preceding token,
    ``a.0.b`` -> (``a_0``, ``b``)."""
    parts: list[str] = []
    for tok in key.split("."):
        if tok.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{tok}"
        else:
            parts.append(tok)
    return tuple(parts)


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def params_to_state_dict(params: Mapping, target_keys: Iterable[str]) -> Dict[str, torch.Tensor]:
    """A flax param tree (nested dicts of arrays) -> a torch state_dict whose
    keys are the matching ``target_keys`` (the destination model's
    ``state_dict().keys()``). Params with no torch key raise."""
    by_path = {torch_key_to_flax_path(k): k for k in target_keys}
    flat = _flatten(params)
    missing = sorted(set(flat) - set(by_path))
    if missing:
        raise ValueError(f"no torch key for params: {missing[:10]}")
    # copy(): an owned, writable buffer (a JAX array's numpy view is read-only)
    return {by_path[path]: torch.from_numpy(np.ascontiguousarray(arr).copy())
            for path, arr in flat.items()}


def load_pt_file(path: str, reference_root: str | None = None):
    """Load a ``.pt`` file into a (state_dict, hyperparameter attrs) pair.

    Takes a bare state_dict (attrs then empty) or a whole pickled module;
    unpickling a module needs its package importable, which
    ``reference_root`` puts on ``sys.path``.
    """
    if reference_root is not None and reference_root not in sys.path:
        sys.path.insert(0, reference_root)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        return obj, {}
    attrs = {k: getattr(obj, k) for k in _HPARAM_ATTRS if hasattr(obj, k)}
    # GroupComm keeps its group size only on its blocks, as num_group
    if "group_size" not in attrs and hasattr(obj, "modules"):
        for m in obj.modules():
            if hasattr(m, "num_group"):
                attrs["group_size"] = int(m.num_group)
                break
    return obj.state_dict(), attrs
