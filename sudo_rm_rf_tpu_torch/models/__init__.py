"""Model zoo of the port.

Each model is an ``nn.Module`` whose ``state_dict()`` names are the torch
reference's, so the published ``.pt`` checkpoints load strictly and
``sudo_rm_rf_tpu_torch/convert/torch_checkpoint.py::torch_key_to_flax_path``
maps every name to the JAX package's param path. `get_model(name,
**overrides)` mirrors the JAX package's registry; the model types the port
does not have yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from sudo_rm_rf_tpu_torch.models.attentive import (
    AttentiveSuDORMRF,
    AttentiveSuDORMRFv2,
    AttentiveSuDORMRFv3,
)
from sudo_rm_rf_tpu_torch.models.causal_sudormrf import CausalSuDORMRF
from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import GroupCommSuDORMRF
from sudo_rm_rf_tpu_torch.models.improved_sudormrf import SuDORMRFImproved
from sudo_rm_rf_tpu_torch.models.sudormrf import SuDORMRFv1

_REGISTRY = {
    "relu": SuDORMRFImproved,
    "improved": SuDORMRFImproved,
    "softmax": SuDORMRFv1,
    "groupcomm_v2": GroupCommSuDORMRF,
    "causal": CausalSuDORMRF,
    "attention": AttentiveSuDORMRF,
    "attention_v2": AttentiveSuDORMRFv2,
    "attention_v3": AttentiveSuDORMRFv3,
}
# model types of the JAX package still to port: the baselines, ROADMAP
# queue 1, item 9
_WAITING = dict.fromkeys(("convtasnet", "dprnn", "demucs", "tdcn", "residual_tdcn",
                          "sepformer"), 9)


def check_model_type(name: str) -> None:
    """Raise unless the port has the model type ``name``."""
    if name in _WAITING:
        raise NotImplementedError(
            f"model_type {name!r} is not ported yet (ROADMAP queue 1, item {_WAITING[name]})")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")


def get_model(name: str, **kwargs):
    """Build a model by reference-compatible name."""
    check_model_type(name)
    return _REGISTRY[name](**kwargs)


def load_checkpoint_model(name: str, hp: dict, path: str, device, reference_root=None):
    """A ``name`` model built from ``hp`` on ``device``, strictly loaded from
    a checkpoint and in eval mode: a ``torch.save`` file holding a state_dict
    or a whole pickled module (whose hyperparameters override ``hp``), or a
    msgpack checkpoint of either package (bare params or a TrainState), told
    apart by ``convert.checkpoint_format``."""
    from sudo_rm_rf_tpu_torch import convert

    hp = dict(hp)
    if convert.checkpoint_format(path) == "torch":
        sd, attrs = convert.load_pt_file(path, reference_root=reference_root)
        hp.update(attrs)
        model = get_model(name, **hp, device=device)
        # the published v1 checkpoints carry a dead ``ln_mask_in``
        convert.load_state_dict_checked(
            model, {k: v for k, v in sd.items() if k.split(".")[0] != "ln_mask_in"})
    else:
        model = convert.load_model_from_checkpoint(path, get_model(name, **hp, device=device))
    return model.eval()


__all__ = ["AttentiveSuDORMRF", "AttentiveSuDORMRFv2", "AttentiveSuDORMRFv3",
           "CausalSuDORMRF", "GroupCommSuDORMRF", "SuDORMRFImproved", "SuDORMRFv1",
           "check_model_type", "get_model", "load_checkpoint_model"]
