"""Offline data preparation of the port (counterpart of
``sudo_rm_rf_tpu/prep``): the writers of the hierarchical corpora."""

from sudo_rm_rf_tpu_torch.prep.hierarchical import (
    convert_esc50_to_hierarchical,
    convert_wsj0mix_to_universal,
    make_hierarchical_from_wavs,
    partition_esc50,
    resample_poly,
)

__all__ = [
    "convert_esc50_to_hierarchical",
    "convert_wsj0mix_to_universal",
    "make_hierarchical_from_wavs",
    "partition_esc50",
    "resample_poly",
]
