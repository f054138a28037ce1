"""Checkpoint interchange: torch ``.pt`` files, the JAX package's param trees
and its msgpack checkpoints, into and out of the port."""

from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import (
    checkpoint_format,
    load_model_from_checkpoint,
    load_params_from_checkpoint,
    load_train_state_from_checkpoint,
    save_train_state,
)
from sudo_rm_rf_tpu_torch.convert.jax_params import (
    load_jax_params,
    load_jax_train_state,
    params_to_flax,
    unstack_block_params,
)
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import load_pt_file, load_state_dict_checked

__all__ = [
    "checkpoint_format",
    "load_jax_params",
    "load_jax_train_state",
    "load_model_from_checkpoint",
    "load_params_from_checkpoint",
    "load_pt_file",
    "load_state_dict_checked",
    "load_train_state_from_checkpoint",
    "params_to_flax",
    "save_train_state",
    "unstack_block_params",
]
