"""Time-axis resampling (counterpart of ``sudo_rm_rf_tpu/ops/resample.py``)."""

from __future__ import annotations

import torch


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor x2 upsampling along the trailing (time) dim.

    (..., T) -> (..., 2T), x[..., 2t] == x[..., 2t+1] == input[..., t].
    """
    return x.repeat_interleave(2, dim=-1)
