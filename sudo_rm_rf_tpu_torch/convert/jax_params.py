"""Load the JAX package's param trees into the port.

The port's modules carry the torch reference's attribute names, so a flax
param tree (nested dicts of arrays) maps onto ``model.state_dict()`` by pure
renaming (``convert.torch_checkpoint``).
"""

from __future__ import annotations

from sudo_rm_rf_tpu_torch.convert.torch_checkpoint import params_to_state_dict


def load_jax_params(model, params):
    """Copy a flax ``params`` tree (nested dicts of numpy arrays) into
    ``model`` with a strict ``load_state_dict``; returns the model."""
    model.load_state_dict(params_to_state_dict(params, model.state_dict().keys()),
                          strict=True)
    return model
