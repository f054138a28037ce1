"""Checkpoint interchange: torch ``.pt`` files and the JAX package's param
trees, into the port."""

from sudo_rm_rf_tpu_torch.convert.jax_params import load_jax_params
from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import load_pt_file

__all__ = ["load_jax_params", "load_pt_file"]
