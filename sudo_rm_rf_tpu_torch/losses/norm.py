"""Permutation-invariant weighted-L1 loss (counterpart of
``sudo_rm_rf_tpu/losses/norm.py``). As the reference reduces it, the min over
permutations is taken of the *batch-mean* loss, not per sample."""

from __future__ import annotations

from typing import Optional

import torch

from sudo_rm_rf_tpu_torch.losses.sisdr import all_permutations


def perm_invariant_norm(
    pr_batch: torch.Tensor,
    t_batch: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    weighted_norm: float = 0.0,
) -> torch.Tensor:
    """min over permutations of mean |w^p * (pr_perm - t)|."""
    w = (t_batch if weights is None else weights) ** weighted_norm
    losses = [
        (w * (pr_batch[:, list(perm), :] - t_batch)).abs().flatten(1).mean(dim=1)
        for perm in all_permutations(pr_batch.shape[1])
    ]
    return torch.stack(losses, dim=1).mean(dim=-2).amin(dim=-1)
