"""Permutation-invariant SNR with zero-reference (silent source) handling,
the FUSS training loss (counterpart of ``sudo_rm_rf_tpu/losses/snr.py``).

A target is *active* iff its input SNR against the mixture (the sum of the
targets) is >= ``inactivity_threshold`` dB. Inactive targets are left out of
the numerator and stabilized in the denominator by the mixture power, so the
model is rewarded for putting silence there. One pairwise (B, S, S) SNR
matrix, permutations scored by a one-hot einsum, as in ``sisdr.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sudo_rm_rf_tpu_torch.losses.sisdr import _onehots_like, all_permutations


@dataclass(frozen=True)
class PermInvariantSNRwithZeroRefs:
    n_sources: int
    zero_mean: bool = False
    backward_loss: bool = True
    inactivity_threshold: float = -40.0
    return_individual_results: bool = False

    @property
    def permutations(self) -> np.ndarray:
        return all_permutations(self.n_sources)

    def __call__(
        self,
        pr_batch: torch.Tensor,
        t_batch: torch.Tensor,
        eps: float = 1e-9,
        thresh: float = 0.001,
        return_best_permutation: bool = False,
    ):
        min_len = min(pr_batch.shape[-1], t_batch.shape[-1])
        pr_batch = pr_batch[:, :, :min_len]
        t_batch = t_batch[:, :, :min_len]
        if self.zero_mean:
            pr_batch = pr_batch - pr_batch.mean(dim=-1, keepdim=True)
            t_batch = t_batch - t_batch.mean(dim=-1, keepdim=True)

        mixture = t_batch.sum(dim=-2, keepdim=True)  # (B, 1, T)
        mixture_power = (mixture * mixture).sum(dim=-1)  # (B, 1)
        target_powers = (t_batch * t_batch).sum(dim=-1)  # (B, S)
        input_snr = 10.0 * torch.log10(target_powers / (mixture_power + eps))
        active = (input_snr >= self.inactivity_threshold).to(t_batch.dtype)  # (B, S)
        denom_stab = thresh * (active * target_powers + (1.0 - active) * mixture_power)
        num_active = active.sum(dim=-1, keepdim=True)  # (B, 1)

        # pair[b, i, j]: 10 active_j log10((||t_j||^2 + eps)
        #                 / (||pr_i - t_j||^2 + stab_j + eps) + eps)
        nom = target_powers + eps  # (B, S_tgt)
        err = pr_batch[:, :, None, :] - t_batch[:, None, :, :]
        denom = (err * err).sum(dim=-1) + denom_stab[:, None, :] + eps
        pair = 10.0 * active[:, None, :] * torch.log10(nom[:, None, :] / denom + eps)

        perms = self.permutations
        onehot = _onehots_like(perms, self.n_sources, pair)
        # the SUM over sources, weighted by the count of active targets
        scores = torch.einsum("bij,pji->bp", pair, onehot) * num_active
        best_perm_ind = scores.argmax(dim=-1)
        best_snr = scores.amax(dim=-1)

        if not self.return_individual_results:
            best_snr = best_snr.mean()
        if self.backward_loss:
            best_snr = -best_snr
        if return_best_permutation:
            return best_snr, torch.from_numpy(perms).to(pair.device)[best_perm_ind]
        return best_snr


# the reference's near-duplicate "Simpler" class computes the same
SimplerPermInvariantSNRwithZeroRefs = PermInvariantSNRwithZeroRefs
