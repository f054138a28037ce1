"""Checkpoint interchange between the JAX package and the port."""

from sudo_rm_rf_tpu_torch.convert.jax_params import load_jax_params

__all__ = ["load_jax_params"]
