"""Training of the port: online remix augmentation and the trainer.

``train.experiment.run_experiment`` (the epoch loop behind
``sudo-torch-train``) is imported from its module, since it pulls in the data
loaders and the checkpoint manager; so are ``train.resident`` (the
device-resident pools and epoch) and ``train.autotune`` (``block_impl
'auto'``).
"""

from sudo_rm_rf_tpu_torch.train.augment import (
    draw_fuss,
    draw_pair_remix,
    draw_remix,
    fuss_mixture,
    fuss_online_augment,
    normalize_wav,
    online_remix_pairs,
    online_remix_sources,
)
from sudo_rm_rf_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    TrainState,
    clip_by_global_norm_,
    global_norm,
    stepped_lr_schedule,
)

__all__ = [
    "Trainer",
    "TrainerConfig",
    "TrainState",
    "clip_by_global_norm_",
    "draw_fuss",
    "draw_pair_remix",
    "draw_remix",
    "fuss_mixture",
    "fuss_online_augment",
    "global_norm",
    "normalize_wav",
    "online_remix_pairs",
    "online_remix_sources",
    "stepped_lr_schedule",
]
