"""Online mixing augmentation (counterpart of ``sudo_rm_rf_tpu/train/augment.py``):
the WSJ0/WHAM remix, the WHAMR pair remix and the FUSS augmentation.

The JAX package draws its permutations from a threefry key inside the jitted
step; that stream cannot be reproduced in torch. So each remix here takes its
draws explicitly, and :func:`draw_remix` makes them from a
``torch.Generator``: the same draws give the same remix in both packages.
The draws are made on the generator's device, so a CUDA generator draws
them on the card without a copy from the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def normalize_wav(wav: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(x - mean) / (std + eps) over the trailing time dim, with the
    unbiased (ddof=1) std."""
    mean = wav.mean(dim=-1, keepdim=True)
    std = wav.std(dim=-1, keepdim=True, correction=1)
    return (wav - mean) / (std + eps)


def _energy_match(new: torch.Tensor, energy: torch.Tensor) -> torch.Tensor:
    """Rescale `new` so its per-row energy equals `energy`."""
    return new * torch.sqrt(energy / (new**2).sum(dim=-1, keepdim=True))


def draw_remix(generator: torch.Generator, b: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws of one remix: a permutation of the ``s`` source slots and
    one permutation of the ``b`` batch rows per source, (s,) and (s, b)."""
    dev = generator.device
    slot_perm = torch.randperm(s, generator=generator, device=dev)
    batch_perms = torch.stack([torch.randperm(b, generator=generator, device=dev)
                               for _ in range(s)])
    return slot_perm, batch_perms


def draw_pair_remix(generator: torch.Generator, b: int, s: int) -> torch.Tensor:
    """The draws of one pair remix: a permutation of the ``b`` batch rows
    per source slot, (s, b)."""
    return torch.stack([torch.randperm(b, generator=generator, device=generator.device)
                        for _ in range(s)])


def online_remix_sources(clean_wavs: torch.Tensor, slot_perm: torch.Tensor,
                         batch_perms: Sequence[torch.Tensor]):
    """WSJ0/WHAM-style online remixing of a (B, S, T) source batch.

    Permute the source slots once for the whole batch, shuffle each new
    source across the batch, rescale new source i to the energies of the
    original slot i (not of the permuted one) and re-standardize. Returns
    (mixture (B, T), sources (B, S, T)).
    """
    s = clean_wavs.shape[1]
    energies = (clean_wavs**2).sum(dim=-1, keepdim=True)  # (B, S, 1)
    shuffled = clean_wavs[:, slot_perm.to(clean_wavs.device)]
    new_sources = [
        _energy_match(shuffled[batch_perms[i].to(clean_wavs.device), i, :], energies[:, i])
        for i in range(s)
    ]
    sources = torch.stack([normalize_wav(x) for x in new_sources], dim=1)
    mixture = normalize_wav(sum(new_sources))
    return mixture, sources


def online_remix_pairs(sources: torch.Tensor, targets: torch.Tensor,
                       batch_perms: Sequence[torch.Tensor]):
    """WHAMR-style remixing of (reverberant source, anechoic target) pairs:
    the same batch permutation for the source and the target of each slot,
    both rescaled to their original per-slot energies. Returns (mixture
    (B, T), targets (B, S, T))."""
    s = sources.shape[1]
    s_energies = (sources**2).sum(dim=-1, keepdim=True)
    t_energies = (targets**2).sum(dim=-1, keepdim=True)
    new_s, new_t = [], []
    for k in range(s):
        perm = batch_perms[k].to(sources.device)
        new_s.append(_energy_match(sources[perm, k, :], s_energies[:, k]))
        new_t.append(_energy_match(targets[perm, k, :], t_energies[:, k]))
    mixture = normalize_wav(sum(new_s))
    return mixture, torch.stack(new_t, dim=1)


def draw_fuss(generator: torch.Generator, b: int, s: int):
    """The draws of one FUSS augmentation: gains (b, s, 1) in [0.5, 1.5), a
    permutation of the ``s`` source slots (s,) and one permutation of the
    ``b`` batch rows per slot (s, b)."""
    gains = torch.rand(b, s, 1, generator=generator, device=generator.device) + 0.5
    slot_perm, batch_perms = draw_remix(generator, b, s)
    return gains, slot_perm, batch_perms


def fuss_online_augment(clean_sources: torch.Tensor, gains: torch.Tensor,
                        slot_perm: torch.Tensor,
                        batch_perms: Sequence[torch.Tensor]) -> torch.Tensor:
    """FUSS universal-separation augmentation of a (B, S, T) source stack:
    shuffle each source slot across the batch, permute the slots, then apply
    the gains. Returns the augmented sources; the mixture is their sum."""
    dev = clean_sources.device
    cols = [clean_sources[batch_perms[i].to(dev), i] for i in range(clean_sources.shape[1])]
    aug = torch.stack(cols, dim=1)[:, slot_perm.to(dev)]
    return aug * gains.to(dev, aug.dtype)


def fuss_mixture(sources: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """The standardized sum of a (B, S, T) source stack, (B, T). FUSS
    stabilizes the std with 1e-9, not ``normalize_wav``'s 1e-8."""
    return normalize_wav(sources.sum(dim=1), eps)
