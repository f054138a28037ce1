"""Heatmaps of estimated masks and of the learned encoder and decoder bases
(counterpart of ``sudo_rm_rf_tpu/utils/visualization.py``).

They render to local PNGs when matplotlib is importable, and are uploaded
through ``ExperimentLogger``'s comet backend when one is given; without
matplotlib nothing is drawn and the functions return no paths.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def save_heatmap(array: np.ndarray, path: str, title: str = "",
                 xlabel: str = "time frames", ylabel: str = "basis index") -> Optional[str]:
    """A 2-D heatmap PNG; returns the path, or None without matplotlib."""
    plt = _plt()
    if plt is None:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(np.asarray(array), aspect="auto", origin="lower", interpolation="nearest")
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def log_masks_and_bases(out_dir: str, masks=None, encoder_basis=None, decoder_basis=None,
                        step: int = 0, experiment=None) -> List[str]:
    """Render per-source masks (S, N, T) and the filterbanks: the encoder's
    (N, 1, L) and the decoder's weights (any shape, one row per first index).
    Returns the written paths."""
    paths = []
    if masks is not None:
        masks = np.asarray(masks)
        for s in range(masks.shape[0]):
            paths.append(save_heatmap(
                masks[s], os.path.join(out_dir, f"mask_s{s + 1}_step{step}.png"),
                title=f"estimated mask, source {s + 1}"))
    for name, basis in (("encoder", encoder_basis), ("decoder", decoder_basis)):
        if basis is not None:
            w = np.asarray(basis)
            paths.append(save_heatmap(
                w.reshape(w.shape[0], -1), os.path.join(out_dir, f"{name}_basis_step{step}.png"),
                title=f"{name} basis", xlabel="tap", ylabel="filter"))
    paths = [p for p in paths if p]
    if experiment is not None and hasattr(experiment, "log_image"):
        for p in paths:
            experiment.log_image(p, step=step)
    return paths
