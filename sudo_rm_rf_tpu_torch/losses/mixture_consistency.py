"""Differentiable mixture-consistency projection (Wisdom et al., ICASSP 2019),
counterpart of ``sudo_rm_rf_tpu/losses/mixture_consistency.py``."""

from __future__ import annotations

import torch


def mixture_consistency(
    pr_batch: torch.Tensor,
    input_mixture: torch.Tensor,
    mix_weights_type: str = "uniform",
) -> torch.Tensor:
    """est + w * (mix - sum(est)) with uniform or magnitude-squared weights.

    pr_batch: (B, S, T) estimates; input_mixture: (B, 1, T).
    """
    num_sources = pr_batch.shape[1]
    pr_mixture = pr_batch.sum(dim=1, keepdim=True)
    if mix_weights_type == "magsq":
        w = (pr_batch**2).mean(dim=-1, keepdim=True)
        w = w / (w.sum(dim=1, keepdim=True) + 1e-9)
    elif mix_weights_type == "uniform":
        w = 1.0 / num_sources
    else:
        raise ValueError(f"Invalid mixture consistency weight type: {mix_weights_type}")
    return pr_batch + w * (input_mixture - pr_mixture)
