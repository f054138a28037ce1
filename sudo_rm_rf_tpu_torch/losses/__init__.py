"""Losses and metrics of the port: the PIT SI-SDR training loss, the SISDRi
validation metric and the mixture-consistency projection."""

from sudo_rm_rf_tpu_torch.losses.mixture_consistency import mixture_consistency
from sudo_rm_rf_tpu_torch.losses.sisdr import (
    PermInvariantSISDR,
    all_permutations,
    pairwise_neg_sdr,
    pit_from_pair_matrix,
    pit_neg_sdr_loss,
    reorder_sources,
)

__all__ = [
    "PermInvariantSISDR",
    "all_permutations",
    "mixture_consistency",
    "pairwise_neg_sdr",
    "pit_from_pair_matrix",
    "pit_neg_sdr_loss",
    "reorder_sources",
]
