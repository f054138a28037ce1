"""Framing ops (counterpart of ``sudo_rm_rf_tpu/ops/frame.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def overlap_and_add(signal: torch.Tensor, frame_step: int) -> torch.Tensor:
    """[..., frames, frame_length] -> [..., (frames-1)*step + frame_length]."""
    *outer, frames, frame_length = signal.shape
    out_len = (frames - 1) * frame_step + frame_length
    cols = signal.reshape(-1, frames, frame_length).transpose(1, 2)
    out = F.fold(cols, output_size=(1, out_len), kernel_size=(1, frame_length),
                 stride=(1, frame_step))
    return out.reshape(*outer, out_len)
