"""Host-side audio I/O of the port."""

from sudo_rm_rf_tpu_torch.data.base import read_wav

__all__ = ["read_wav"]
