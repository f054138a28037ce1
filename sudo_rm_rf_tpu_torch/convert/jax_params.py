"""Load the JAX package's param trees into the port.

The port's modules carry the torch reference's attribute names, so a flax
param tree (nested dicts of arrays) maps onto ``model.state_dict()`` by pure
renaming through ``sudo_rm_rf_tpu.convert.torch_checkpoint``, a module that
imports no JAX.
"""

from __future__ import annotations

from sudo_rm_rf_tpu.convert.torch_checkpoint import params_to_state_dict


def load_jax_params(model, params):
    """Copy a flax ``params`` tree (nested dicts of numpy arrays) into
    ``model`` with a strict ``load_state_dict``; returns the model."""
    sd = params_to_state_dict(params, target_keys=model.state_dict().keys(),
                              to_torch=True)
    model.load_state_dict(sd, strict=True)
    return model
