"""Host-side audio I/O and the dataset loaders of the port (numpy only)."""

from sudo_rm_rf_tpu_torch.data.base import DatasetConfigError, read_wav
from sudo_rm_rf_tpu_torch.data.fuss import FUSSDataset
from sudo_rm_rf_tpu_torch.data.libri2mix import LibriMixDataset
from sudo_rm_rf_tpu_torch.data.loader import DataLoader
from sudo_rm_rf_tpu_torch.data.musdb import MusdbDataset
from sudo_rm_rf_tpu_torch.data.shards import ShardedDataset, pack_dataset, write_shards
from sudo_rm_rf_tpu_torch.data.wham import WHAM_TASKS, WhamDataset
from sudo_rm_rf_tpu_torch.data.whamr import WHAMR_TASKS, WhamRDataset

__all__ = [
    "DataLoader",
    "DatasetConfigError",
    "FUSSDataset",
    "LibriMixDataset",
    "MusdbDataset",
    "ShardedDataset",
    "WHAM_TASKS",
    "WHAMR_TASKS",
    "WhamDataset",
    "WhamRDataset",
    "pack_dataset",
    "read_wav",
    "write_shards",
]
