"""Long-recording and streaming separation runtimes of the port."""

from sudo_rm_rf_tpu_torch.inference.overlap_add import OverlapAddSeparator, separate_file
from sudo_rm_rf_tpu_torch.inference.sequence_parallel import (
    DistributedShards,
    LocalShards,
    SequenceParallelSeparator,
    make_seq_comm,
)
from sudo_rm_rf_tpu_torch.inference.streaming import StreamingSeparator

__all__ = ["DistributedShards", "LocalShards", "OverlapAddSeparator",
           "SequenceParallelSeparator", "StreamingSeparator", "make_seq_comm",
           "separate_file"]
