"""Permutation-invariant SI-SDR losses and metrics (counterpart of
``sudo_rm_rf_tpu/losses/sisdr.py``).

Every PIT variant computes the (B, S_est, S_tgt) pairwise measure matrix
once and scores all S! permutations with a one-hot einsum over that small
matrix. Minima and maxima are taken with ``amin``/``amax``, which share the
gradient among ties as JAX's ``min``/``max`` do.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


def _perm_onehots(perms: np.ndarray, n: int) -> np.ndarray:
    """(P, S) index array -> (P, S, n) one-hot selector, float32."""
    p, s = perms.shape
    oh = np.zeros((p, s, n), np.float32)
    oh[np.arange(p)[:, None], np.arange(s)[None, :], perms] = 1.0
    return oh


def _onehots_like(perms: np.ndarray, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_perm_onehots(perms, n)).to(like.device, like.dtype)


def all_permutations(n_sources: int) -> np.ndarray:
    return np.array(list(itertools.permutations(range(n_sources))), np.int64)


def partial_permutations(n_estimated: int, n_actual: int) -> np.ndarray:
    """The P(n_estimated, n_actual) injections of targets into estimates."""
    return np.array(
        list(itertools.permutations(range(n_estimated), r=n_actual)), np.int64)


def pairwise_neg_sdr(
    est_targets: torch.Tensor,
    targets: torch.Tensor,
    *,
    sdr_type: str = "sisdr",
    zero_mean: bool = True,
    take_log: bool = True,
) -> torch.Tensor:
    """Pairwise negative (SI-)SDR matrix, shape (B, S_est, S_tgt): element
    [b, i, j] is the negative SDR of estimate i against target j."""
    if sdr_type not in ("snr", "sisdr", "sdsdr"):
        raise ValueError(f"sdr_type {sdr_type!r} not in ('snr', 'sisdr', 'sdsdr')")
    if zero_mean:
        targets = targets - targets.mean(dim=-1, keepdim=True)
        est_targets = est_targets - est_targets.mean(dim=-1, keepdim=True)

    s_tgt = targets[:, None, :, :]  # (B, 1, S_tgt, T)
    s_est = est_targets[:, :, None, :]  # (B, S_est, 1, T)

    if sdr_type in ("sisdr", "sdsdr"):
        dot = (s_est * s_tgt).sum(dim=-1, keepdim=True)
        tgt_energy = (s_tgt**2).sum(dim=-1, keepdim=True) + 1e-8
        proj = dot * s_tgt / tgt_energy  # (B, S_est, S_tgt, T)
    else:
        proj = s_tgt.expand(s_est.shape[:2] + s_tgt.shape[2:])
    if sdr_type in ("sdsdr", "snr"):
        e_noise = s_est - s_tgt
    else:
        e_noise = s_est - proj

    sdr = (proj**2).sum(dim=-1) / ((e_noise**2).sum(dim=-1) + 1e-8)
    if take_log:
        sdr = 10.0 * torch.log10(sdr + 1e-8)
    return -sdr


def pit_from_pair_matrix(
    pair_losses: torch.Tensor, perms: Optional[np.ndarray] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-permutation loss from a pairwise loss matrix.

    The matrix is transposed so rows are targets, each permutation's score
    is the mean over sources, and the minimum is returned. Returns
    (min_loss (B,), min_loss_idx (B,)); ``perms[min_loss_idx[b]]`` maps
    target row i -> chosen estimate column perms[i].
    """
    n_src = pair_losses.shape[-1]
    if perms is None:
        perms = all_permutations(n_src)
    pwl = pair_losses.transpose(-1, -2)  # (B, tgt, est)
    onehot = _onehots_like(perms, n_src, pwl)  # (P, tgt, est)
    loss_set = torch.einsum("bij,pij->bp", pwl, onehot) / n_src
    return loss_set.amin(dim=1), loss_set.argmin(dim=1)


def reorder_sources(
    est_targets: torch.Tensor, min_loss_idx: torch.Tensor,
    perms: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Reorder estimates into target order given PIT indices: output row i
    holds the estimate assigned to target i."""
    n_src = est_targets.shape[1]
    if perms is None:
        perms = all_permutations(n_src)
    batch_perms = torch.from_numpy(perms).to(est_targets.device)[min_loss_idx]
    index = batch_perms[:, :, None].expand(-1, -1, est_targets.shape[-1])
    return torch.gather(est_targets, 1, index)


def pit_neg_sdr_loss(
    est_targets: torch.Tensor,
    targets: torch.Tensor,
    *,
    sdr_type: str = "sisdr",
    zero_mean: bool = True,
    return_est: bool = False,
):
    """PIT over the pairwise negative SDR matrix: the training loss of the
    reference's best recipes. Returns the batch-mean min loss; with
    ``return_est`` also the reordered estimates."""
    pw = pairwise_neg_sdr(est_targets, targets, sdr_type=sdr_type, zero_mean=zero_mean)
    min_loss, min_idx = pit_from_pair_matrix(pw)
    mean_loss = min_loss.mean()
    if return_est:
        return mean_loss, reorder_sources(est_targets, min_idx)
    return mean_loss


@dataclass(frozen=True)
class PermInvariantSISDR:
    """Permutation-invariant SI-SDR loss / SISDRi metric: optional
    zero-mean, optional improvement over the mixture-vs-targets SI-SDR
    (whose mean over the whole batch is subtracted), sign flip for use as a
    loss, per-sample results. ``eps`` defaults to 1e-9."""

    n_sources: int
    zero_mean: bool = False
    backward_loss: bool = True
    improvement: bool = False
    return_individual_results: bool = False

    @property
    def permutations(self) -> np.ndarray:
        return all_permutations(self.n_sources)

    @staticmethod
    def _pair_sisnr(pr, t, t_energy, eps):
        """(B, S_est, S_tgt) matrix of SI-SNR(pr_i, t_j)."""
        dot = (pr[:, :, None, :] * t[:, None, :, :]).sum(dim=-1, keepdim=True)
        s_t = dot / (t_energy[:, None, :, :] + eps) * t[:, None, :, :]
        e_t = pr[:, :, None, :] - s_t
        return 10.0 * torch.log10((s_t**2).sum(dim=-1) / ((e_t**2).sum(dim=-1) + eps))

    def __call__(
        self,
        pr_batch: torch.Tensor,
        t_batch: torch.Tensor,
        eps: float = 1e-9,
        initial_mixtures: Optional[torch.Tensor] = None,
        return_best_permutation: bool = False,
    ):
        min_len = min(pr_batch.shape[-1], t_batch.shape[-1])
        if initial_mixtures is not None:
            min_len = min(min_len, initial_mixtures.shape[-1])
            initial_mixtures = initial_mixtures[:, :, :min_len]
        pr_batch = pr_batch[:, :, :min_len]
        t_batch = t_batch[:, :, :min_len]
        if self.zero_mean:
            pr_batch = pr_batch - pr_batch.mean(dim=-1, keepdim=True)
            t_batch = t_batch - t_batch.mean(dim=-1, keepdim=True)
            if initial_mixtures is not None:
                initial_mixtures = initial_mixtures - initial_mixtures.mean(
                    dim=-1, keepdim=True)

        t_energy = (t_batch * t_batch).sum(dim=-1, keepdim=True)
        pair = self._pair_sisnr(pr_batch, t_batch, t_energy, eps)  # (B, Se, St)

        perms = self.permutations
        onehot = _onehots_like(perms, self.n_sources, pair)  # (P, j, i)
        # score[p] = mean_j pair[perm[j], j]
        scores = torch.einsum("bij,pji->bp", pair, onehot) / self.n_sources
        best_perm_ind = scores.argmax(dim=-1)
        best_sisdr = scores.amax(dim=-1)

        if self.improvement:
            if initial_mixtures is None:
                raise ValueError("improvement=True needs initial_mixtures")
            mix = initial_mixtures.expand(
                initial_mixtures.shape[0], self.n_sources, min_len)
            dot = (mix * t_batch).sum(dim=-1, keepdim=True)
            s_t = dot / (t_energy + eps) * t_batch
            e_t = mix - s_t
            base = 10.0 * torch.log10((s_t**2).sum(dim=-1) / ((e_t**2).sum(dim=-1) + eps))
            best_sisdr = best_sisdr - base.mean()

        if not self.return_individual_results:
            best_sisdr = best_sisdr.mean()
        if self.backward_loss:
            best_sisdr = -best_sisdr
        if return_best_permutation:
            return best_sisdr, torch.from_numpy(perms).to(pair.device)[best_perm_ind]
        return best_sisdr


def _stabilized_db(rho_sq: torch.Tensor, eps: float) -> torch.Tensor:
    """10 log10(rho^2 / (1 - rho^2)), eps-stabilized, with rho^2 clipped to
    [0, 1]: Cauchy-Schwarz bounds it at 1, and fp32 rounding can land a hair
    above when an estimate equals its target (the improvement baseline of an
    example whose other sources are silent), which would make the log NaN and
    the batch mean spread it. Clipped values hit the +90 dB eps ceiling."""
    rho_sq = rho_sq.clamp(0.0, 1.0)
    return 10.0 * torch.log10((rho_sq + eps) / (1.0 - rho_sq + eps))


@dataclass(frozen=True)
class StabilizedPermInvSISDRMetric:
    """Stabilized SI-SDR over the P(n_estimated, n_actual) injections of
    targets into estimates, the FUSS metric per source count.

    SI-SDR is ``10 log10(rho^2 / (1 - rho^2))`` with rho the normalized
    inner product, bounded for silent estimates. With ``single_source`` the
    estimates are summed into one signal first and only the trivial
    assignment remains. The improvement baseline is the sum of the targets,
    and its mean over the whole batch is subtracted.
    """

    n_estimated_sources: int
    n_actual_sources: int
    zero_mean: bool = False
    single_source: bool = False
    backward_loss: bool = True
    improvement: bool = False
    return_individual_results: bool = False

    def __post_init__(self):
        if self.n_estimated_sources < self.n_actual_sources:
            raise ValueError("n_estimated_sources must be >= n_actual_sources")
        if self.single_source and self.n_actual_sources != 1:
            raise ValueError("single_source needs n_actual_sources == 1")

    @property
    def permutations(self) -> np.ndarray:
        if self.single_source:
            return np.zeros((1, 1), np.int64)
        return partial_permutations(self.n_estimated_sources, self.n_actual_sources)

    def __call__(
        self,
        pr_batch: torch.Tensor,
        t_batch: torch.Tensor,
        eps: float = 1e-9,
        return_best_permutation: bool = False,
    ):
        if self.single_source:
            pr_batch = pr_batch.sum(dim=-2, keepdim=True)
        if self.zero_mean:
            pr_batch = pr_batch - pr_batch.mean(dim=-1, keepdim=True)
            t_batch = t_batch - t_batch.mean(dim=-1, keepdim=True)
        if t_batch.shape[-2] != self.n_actual_sources:
            raise ValueError(f"targets hold {t_batch.shape[-2]} sources, "
                             f"not n_actual_sources={self.n_actual_sources}")

        t_powers = (t_batch * t_batch).sum(dim=-1)  # (B, St)
        pr_powers = (pr_batch * pr_batch).sum(dim=-1)[:, :, None]  # (B, Se, 1)
        inner_sq = (pr_batch[:, :, None, :] * t_batch[:, None, :, :]).sum(dim=-1) ** 2
        pair = _stabilized_db(inner_sq / (pr_powers * t_powers[:, None, :] + eps), eps)

        perms = self.permutations  # (P, n_actual) of estimate indices
        n_est_eff = 1 if self.single_source else self.n_estimated_sources
        onehot = _onehots_like(perms, n_est_eff, pair)
        scores = torch.einsum("bij,pji->bp", pair, onehot) / self.n_actual_sources
        best_perm_ind = scores.argmax(dim=-1)
        best_sisdr = scores.amax(dim=-1)

        if self.improvement:
            mixture = t_batch.sum(dim=-2, keepdim=True)
            if self.zero_mean:
                mixture = mixture - mixture.mean(dim=-1, keepdim=True)
            mix = mixture.expand(mixture.shape[0], self.n_actual_sources, mixture.shape[-1])
            mix_powers = (mix * mix).sum(dim=-1)
            inner_sq = (mix * t_batch).sum(dim=-1) ** 2
            base = _stabilized_db(inner_sq / (mix_powers * t_powers + eps), eps)
            best_sisdr = best_sisdr - base.mean()

        if not self.return_individual_results:
            best_sisdr = best_sisdr.mean()
        if self.backward_loss:
            best_sisdr = -best_sisdr
        if return_best_permutation:
            return best_sisdr, torch.from_numpy(perms).to(pair.device)[best_perm_ind]
        return best_sisdr
