"""Low-level numerical ops, with the semantics of ``sudo_rm_rf_tpu.ops``.

The U-ConvBlock forms and the wrapper of its CUDA kernel are in
``sudo_rm_rf_tpu_torch.ops.uconv``.
"""

from sudo_rm_rf_tpu_torch.ops.conv import conv1d, conv_transpose1d
from sudo_rm_rf_tpu_torch.ops.frame import overlap_and_add
from sudo_rm_rf_tpu_torch.ops.norm import channel_ln, cumulative_ln, glob_ln
from sudo_rm_rf_tpu_torch.ops.pad import pad_to_multiple, unpad_to_length
from sudo_rm_rf_tpu_torch.ops.resample import upsample_nearest_2x

__all__ = [
    "channel_ln",
    "conv1d",
    "conv_transpose1d",
    "cumulative_ln",
    "glob_ln",
    "overlap_and_add",
    "pad_to_multiple",
    "unpad_to_length",
    "upsample_nearest_2x",
]
