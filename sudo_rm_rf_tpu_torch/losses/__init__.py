"""Losses and metrics of the port: the PIT SI-SDR training loss, the SISDRi
validation metric, the stabilized per-source-count metric and zero-reference
SNR loss of FUSS, the reference's functional losses, BSS-eval and the
mixture-consistency projection."""

from sudo_rm_rf_tpu_torch.losses.bss_eval import bss_eval_improvement, bss_eval_sources
from sudo_rm_rf_tpu_torch.losses.functional import pit_loss, sdr, sdri_loss, sisdr_loss
from sudo_rm_rf_tpu_torch.losses.mixture_consistency import mixture_consistency
from sudo_rm_rf_tpu_torch.losses.norm import perm_invariant_norm
from sudo_rm_rf_tpu_torch.losses.sisdr import (
    PermInvariantSISDR,
    StabilizedPermInvSISDRMetric,
    all_permutations,
    pairwise_neg_sdr,
    partial_permutations,
    pit_from_pair_matrix,
    pit_neg_sdr_loss,
    reorder_sources,
)
from sudo_rm_rf_tpu_torch.losses.snr import (
    PermInvariantSNRwithZeroRefs,
    SimplerPermInvariantSNRwithZeroRefs,
)

__all__ = [
    "PermInvariantSISDR",
    "PermInvariantSNRwithZeroRefs",
    "SimplerPermInvariantSNRwithZeroRefs",
    "StabilizedPermInvSISDRMetric",
    "all_permutations",
    "bss_eval_improvement",
    "bss_eval_sources",
    "mixture_consistency",
    "pairwise_neg_sdr",
    "partial_permutations",
    "perm_invariant_norm",
    "pit_from_pair_matrix",
    "pit_loss",
    "pit_neg_sdr_loss",
    "reorder_sources",
    "sdr",
    "sdri_loss",
    "sisdr_loss",
]
