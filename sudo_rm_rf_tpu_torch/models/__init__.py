"""Model zoo of the port.

Each model is an ``nn.Module`` whose ``state_dict()`` names are the torch
reference's, so the published ``.pt`` checkpoints load strictly and
``sudo_rm_rf_tpu.convert.torch_key_to_flax_path`` maps every name to the JAX
package's param path. `get_model(name, **overrides)` mirrors the JAX
package's registry; this slice holds the Improved SuDoRM-RF only.
"""

from sudo_rm_rf_tpu_torch.models.improved_sudormrf import SuDORMRFImproved

_REGISTRY = {
    "relu": SuDORMRFImproved,
    "improved": SuDORMRFImproved,
}


def get_model(name: str, **kwargs):
    """Build a model by reference-compatible name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


__all__ = ["SuDORMRFImproved", "get_model"]
