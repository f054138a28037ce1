"""Configuration of the port (counterpart of ``sudo_rm_rf_tpu/config.py``).

The same dataclass tree and the same environment variables for the dataset
roots, resolved when read:

    SUDO_TPU_WHAM_ROOT, SUDO_TPU_WHAMR_ROOT, SUDO_TPU_FUSS_ROOT,
    SUDO_TPU_LIBRI2MIX_ROOT, SUDO_TPU_MUSDB_ROOT, SUDO_TPU_MUSDB8K_ROOT,
    SUDO_TPU_CKPT_DIR, SUDO_TPU_METRICS_DIR
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


class DataPaths:
    """Dataset roots, resolved from env vars at access time (so tests and
    CLI flags can set them after import)."""

    @property
    def wham_root(self):
        return _env("SUDO_TPU_WHAM_ROOT", "/mnt/data/wham")

    @property
    def whamr_root(self):
        return _env("SUDO_TPU_WHAMR_ROOT", "/mnt/data/whamr")

    @property
    def fuss_root(self):
        return _env("SUDO_TPU_FUSS_ROOT", "/mnt/data/fuss")

    @property
    def libri2mix_root(self):
        return _env("SUDO_TPU_LIBRI2MIX_ROOT", "/mnt/data/libri_mix/Libri2Mix")

    @property
    def musdb_root(self):
        return _env("SUDO_TPU_MUSDB_ROOT", "/mnt/data/musdb")

    @property
    def musdb8k_root(self):
        return _env("SUDO_TPU_MUSDB8K_ROOT", "/mnt/data/musdb8k")

    @property
    def checkpoints(self):
        return _env("SUDO_TPU_CKPT_DIR", os.path.expanduser("~/sudo_tpu_checkpoints"))

    @property
    def metrics(self):
        return _env("SUDO_TPU_METRICS_DIR", os.path.expanduser("~/sudo_tpu_metrics"))


paths = DataPaths()

@dataclass
class ModelConfig:
    """Hyperparameters of the SuDoRM-RF family (the reference CLI's flags)."""

    model_type: str = "relu"
    out_channels: int = 128
    in_channels: int = 512
    num_blocks: int = 16
    upsampling_depth: int = 5
    enc_kernel_size: int = 21
    enc_num_basis: int = 512
    num_sources: int = 2
    group_size: int = 16  # groupcomm only
    in_audio_channels: int = 1
    # attentive only
    n_heads: int = 4
    att_dims: int = 256
    att_dropout: float = 0.1
    # U-ConvBlock form: 'fma' (the training default, as in the JAX
    # package), 'xla' (plain layers) or 'kernel' (the CUDA kernel, forward
    # only)
    block_impl: str = "fma"
    # recompute each block's activations in the backward (relu and
    # groupcomm_v2 only, as in the JAX package)
    remat_blocks: bool = False
    # attentive only: the JAX scan layout of the block params; the port's
    # blocks are a plain loop either way
    scan_blocks: bool = False

    def build(self, device=None, generator=None, tp_mesh=None):
        """The port's model for this config, its params drawn from
        ``generator`` and placed on ``device``. A baseline raises the
        ``ValueError`` of ``models.check_cli_model_type``: this config holds
        the SuDoRM-RF hyperparameters only. ``tp_mesh`` (a
        ``parallel.Mesh``) splits the blocks' channels over its model group
        (relu/improved with block_impl 'fma' only, as JAX's)."""
        from sudo_rm_rf_tpu_torch import models

        models.check_cli_model_type(self.model_type)
        kwargs = dict(
            out_channels=self.out_channels,
            in_channels=self.in_channels,
            num_blocks=self.num_blocks,
            upsampling_depth=self.upsampling_depth,
            enc_kernel_size=self.enc_kernel_size,
            enc_num_basis=self.enc_num_basis,
            num_sources=self.num_sources,
        )
        if self.model_type in ("relu", "improved"):
            kwargs.update(block_impl=self.block_impl, remat_blocks=self.remat_blocks)
            if tp_mesh is not None:
                kwargs.update(tp_mesh=tp_mesh)
        elif tp_mesh is not None:
            raise ValueError(f"tp_mesh: compute tensor parallelism takes model_type "
                             f"relu/improved, not {self.model_type!r}")
        if self.model_type == "groupcomm_v2":
            kwargs.update(group_size=self.group_size,
                          in_audio_channels=self.in_audio_channels,
                          block_impl=self.block_impl, remat_blocks=self.remat_blocks)
        elif self.model_type == "causal":
            kwargs.update(in_audio_channels=self.in_audio_channels)
        elif self.model_type.startswith("attention"):
            kwargs.update(n_heads=self.n_heads, att_dims=self.att_dims,
                          att_dropout=self.att_dropout, scan_blocks=self.scan_blocks)
        return models.get_model(self.model_type, **kwargs, generator=generator,
                                device=device)


@dataclass
class DataConfig:
    train: Tuple[str, ...] = ("WHAM",)
    val: Tuple[str, ...] = ("WHAM",)
    test: Tuple[str, ...] = ()
    train_val: Tuple[str, ...] = ()
    separation_task: str = "sep_clean"
    fs: int = 8000
    audio_timelength: float = 4.0
    min_or_max: str = "min"
    zero_pad_audio: bool = True
    normalize_audio: bool = False
    n_channels: int = 1
    min_num_sources: int = 1
    max_num_sources: int = 4
    n_train: int = 0
    n_val: int = 0
    n_test: int = 0
    n_train_val: int = 0
    batch_size: int = 4
    n_jobs: int = 4
    # hierarchical online-mixing datasets (AUGMENTED_*): wait
    train_dataset_paths: Tuple[str, ...] = ()
    val_dataset_paths: Tuple[str, ...] = ()
    test_dataset_paths: Tuple[str, ...] = ()
    max_abs_snr: float = 2.5


@dataclass
class TrainConfig:
    n_epochs: int = 200
    learning_rate: float = 1e-3
    divide_lr_by: float = 3.0
    patience_epochs: int = 0
    clip_grad_norm: float = 5.0
    loss_clamp: float = 30.0
    mixture_consistency: Optional[str] = None
    # 'adam', or 'radam_cosine' (RAdam, a linear warmup of TrainerConfig's
    # warmup_steps, cosine decay to n_epochs x steps_per_epoch)
    optimizer: str = "adam"
    grad_accum_steps: int = 1
    # train steps a host batch copy: K batches stacked into one copy and
    # queued together (Trainer.train_steps), bit for bit the K single steps
    chain_steps: int = 1
    # fwd/bwd compute dtype over fp32 master params and loss, e.g. 'bfloat16'
    compute_dtype: Optional[str] = None
    # host-to-device dtype of the train batches (cast back on the device)
    upload_dtype: Optional[str] = None
    # train dispatches queued ahead of the card before the host waits on the
    # oldest (0 = no bound)
    max_inflight: int = 2
    # the training set decoded once into a pool on the device, every batch
    # drawn there (train/resident.py)
    device_data: bool = False
    # stop after this many epochs without a new best on the primary val
    # metric (0 = train all n_epochs)
    early_stop_patience: int = 0
    # model-group size of the (data, model) grid of ranks: > 1 stores the
    # large params as row shards over it (storage TP) and, for relu/improved
    # models with block_impl 'fma', splits the blocks' channels (compute TP)
    n_model: int = 1
    save_checkpoint_every: int = 10
    checkpoints_path: str = field(default_factory=lambda: paths.checkpoints)
    seed: int = 0


@dataclass
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    experiment_name: str = "sudo_tpu_experiment"
    tags: Tuple[str, ...] = ()

    def hparams(self) -> dict:
        """Flatten into the reference-style hparams dict."""
        out = {}
        for section in (self.model, self.data, self.train):
            out.update(dataclasses.asdict(section))
        out["train"] = list(self.data.train)
        out["val"] = list(self.data.val)
        out["test"] = list(self.data.test)
        out["train_val"] = list(self.data.train_val)
        return out
