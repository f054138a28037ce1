"""Long-recording and streaming separation runtimes of the port."""

from sudo_rm_rf_tpu_torch.inference.overlap_add import OverlapAddSeparator, separate_file
from sudo_rm_rf_tpu_torch.inference.streaming import StreamingSeparator

__all__ = ["OverlapAddSeparator", "StreamingSeparator", "separate_file"]
