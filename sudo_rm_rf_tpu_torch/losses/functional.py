"""The reference's closed-form SDR losses (counterpart of
``sudo_rm_rf_tpu/losses/functional.py``): ``sdr``, ``sdri_loss``,
``sisdr_loss`` and ``pit_loss``. The class-based losses in ``sisdr.py`` are
the ones the recipes train with."""

from __future__ import annotations

import itertools

import torch


def sdr(y: torch.Tensor, z: torch.Tensor, si: bool = False) -> torch.Tensor:
    """Closed-form (scale-invariant) SDR of estimate z against target y over
    the trailing dim."""
    if si:
        a = ((z * y).mean(-1) / (y * y).mean(-1))[..., None] * y
        return 10 * torch.log10((a**2).mean(-1) / ((a - z) ** 2).mean(-1))
    return 10 * torch.log10((y * y).mean(-1) / ((y - z) ** 2).mean(-1))


def _ensure_3d(x):
    return x[None] if x.ndim < 3 else x


def sdri_loss(y, z, of=0.0):
    """Negative SDR improvement over ``of``."""
    return -(sdr(_ensure_3d(y), _ensure_3d(z), si=False) - of).mean()


def sisdr_loss(y, z, of=0.0):
    """Negative SI-SDR improvement over ``of``."""
    return -(sdr(_ensure_3d(y), _ensure_3d(z), si=True) - of).mean()


def pit_loss(y, z, of=0.0, si: bool = False):
    """Negative best-permutation mean SDR."""
    y, z = _ensure_3d(y), _ensure_3d(z)
    perms = itertools.permutations(range(y.shape[-2]))
    scores = torch.stack([sdr(y[:, list(p), :], z, si) for p in perms], dim=2)
    return -scores.mean(dim=1).amax(dim=-1).mean()
