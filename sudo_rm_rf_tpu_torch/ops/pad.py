"""Length padding helpers (counterpart of ``sudo_rm_rf_tpu/ops/pad.py``).

The model pads its input to a multiple of (L//2)·2**depth before the encoder
and crops the decoder output back to the input length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def padded_length(input_length: int, multiple: int) -> int:
    """Smallest multiple of `multiple` that is >= max(input_length, multiple)."""
    if input_length < multiple:
        return multiple
    res = 1 if input_length % multiple else 0
    return (input_length // multiple + res) * multiple


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the trailing (time) dim up to `padded_length`."""
    pad = padded_length(x.shape[-1], multiple) - x.shape[-1]
    if pad == 0:
        return x
    return F.pad(x, (0, pad))


def unpad_to_length(x: torch.Tensor, length: int) -> torch.Tensor:
    """Crop the trailing dim back to the original length."""
    return x[..., :length]
