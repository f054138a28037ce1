"""Model zoo of the port.

Each model is an ``nn.Module`` whose ``state_dict()`` names are the torch
reference's, so the published ``.pt`` checkpoints load strictly and
``sudo_rm_rf_tpu_torch/convert/torch_checkpoint.py::torch_key_to_flax_path``
maps every name to the JAX package's param path. `get_model(name,
**overrides)` mirrors the JAX package's registry, the baselines included.

The baselines take their own hyperparameters (their class defaults are the
published configurations), never the SuDoRM-RF ones that ``ModelConfig`` and
the train, separate, evaluate and export CLIs pass. The JAX package's
``ModelConfig.build`` passes those to every model type, so its CLIs cannot
build a baseline (a ``TypeError``; ROADMAP queue 3); the port's raise the
``ValueError`` of :func:`check_cli_model_type` instead. A baseline is built
with ``get_model(name, ...)``, as the bench zoo and the Trainer called from
Python do in both packages.
"""

from sudo_rm_rf_tpu_torch.models.attentive import (
    AttentiveSuDORMRF,
    AttentiveSuDORMRFv2,
    AttentiveSuDORMRFv3,
)
from sudo_rm_rf_tpu_torch.models.baselines.convtasnet import ConvTasNet
from sudo_rm_rf_tpu_torch.models.baselines.demucs import Demucs
from sudo_rm_rf_tpu_torch.models.baselines.dprnn import DPRNN
from sudo_rm_rf_tpu_torch.models.baselines.sepformer import SepFormer
from sudo_rm_rf_tpu_torch.models.baselines.tdcn import TDCN, ResidualTN
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
    "convtasnet": ConvTasNet,
    "dprnn": DPRNN,
    "demucs": Demucs,
    "tdcn": TDCN,
    "residual_tdcn": ResidualTN,
    "sepformer": SepFormer,
}
BASELINES = ("convtasnet", "dprnn", "demucs", "tdcn", "residual_tdcn", "sepformer")


def check_model_type(name: str) -> None:
    """Raise unless the port has the model type ``name``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")


def check_cli_model_type(name: str) -> None:
    """Raise unless ``name`` is a model type that the config and the CLIs
    build from the SuDoRM-RF hyperparameters: not a baseline."""
    check_model_type(name)
    if name in BASELINES:
        raise ValueError(
            f"model_type {name!r} is a baseline: it takes its own hyperparameters, not the "
            f"SuDoRM-RF ones that ModelConfig and the CLIs pass. The JAX package's "
            f"ModelConfig.build cannot build it either (its CLIs raise a TypeError; ROADMAP "
            f"queue 3). Build it with models.get_model({name!r}, ...).")


def get_model(name: str, **kwargs):
    """Build a model by reference-compatible name."""
    check_model_type(name)
    return _REGISTRY[name](**kwargs)


def load_checkpoint_model(name: str, hp: dict, path: str, device, reference_root=None):
    """A ``name`` model built from ``hp`` on ``device``, strictly loaded from
    a checkpoint and in eval mode: a ``torch.save`` file holding a state_dict
    or a whole pickled module (whose hyperparameters override ``hp``), or a
    msgpack checkpoint of either package (bare params or a TrainState), told
    apart by ``convert.checkpoint_format``. ``hp`` are the model's own
    keyword arguments (a baseline's, or the SuDoRM-RF ones)."""
    from sudo_rm_rf_tpu_torch import convert

    hp = dict(hp)
    if convert.checkpoint_format(path) == "torch":
        sd, attrs = convert.load_pt_file(path, reference_root=reference_root)
        hp.update(attrs)
        model = get_model(name, **hp, device=device)
        # the published v1 checkpoints carry a dead ``ln_mask_in`` (the
        # two-step TDCNs have a live one)
        own = model.state_dict()
        convert.load_state_dict_checked(
            model, {k: v for k, v in sd.items()
                    if k in own or k.split(".")[0] != "ln_mask_in"})
    else:
        model = convert.load_model_from_checkpoint(path, get_model(name, **hp, device=device))
    return model.eval()


__all__ = ["AttentiveSuDORMRF", "AttentiveSuDORMRFv2", "AttentiveSuDORMRFv3", "BASELINES",
           "CausalSuDORMRF", "ConvTasNet", "DPRNN", "Demucs", "GroupCommSuDORMRF",
           "ResidualTN", "SepFormer", "SuDORMRFImproved", "SuDORMRFv1", "TDCN",
           "check_cli_model_type", "check_model_type", "get_model", "load_checkpoint_model"]
