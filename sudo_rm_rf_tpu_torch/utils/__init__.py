"""Experiment bookkeeping of the port: checkpoints, metric logs, audio dumps."""

from sudo_rm_rf_tpu_torch.utils.audio_logging import AudioLogger
from sudo_rm_rf_tpu_torch.utils.checkpoint import CheckpointManager
from sudo_rm_rf_tpu_torch.utils.logging import ExperimentLogger, report_losses_mean_and_std

__all__ = [
    "AudioLogger",
    "CheckpointManager",
    "ExperimentLogger",
    "report_losses_mean_and_std",
]
