"""Long-recording separation runtimes of the port."""

from sudo_rm_rf_tpu_torch.inference.overlap_add import OverlapAddSeparator, separate_file

__all__ = ["OverlapAddSeparator", "separate_file"]
