"""Device-resident training data (counterpart of
``sudo_rm_rf_tpu/train/resident.py``).

The online-mixing recipes draw every training example from a fixed pool of
decoded sources. Here the pool itself lives on the device, with its index
tables; each step draws its uniforms (or its row indices) and its remix
draws on the device from an explicit ``torch.Generator`` on the device,
gathers its batch there and runs the trainer's step. Over a resident epoch
nothing is copied from the host (``Trainer.h2d_bytes`` does not move), and
the losses stay on the device until the epoch (or, with
``SUDO_TPU_RESIDENT_CHUNK``, each chunk of that many steps) is read.

Two pool flavors cover every recipe:

* :class:`HierarchicalPool`: the AUGMENTED_* online-mixing semantics
  (``data/hierarchical.py``) as a function of a (B, n_sources, 5) tensor of
  uniform draws: dataset by the priors, class (never source 0's class of the
  same dataset), sample, delay, SNR. Fed a host dataset's pre-generated
  ``random_draws`` it gives the host loader's items to float tolerance.
* an example bank (:func:`examples_pool_from_dataset`): every item of a
  map-style dataset stacked (FUSS source stacks, WHAMR (reverberant,
  anechoic) pairs, MUSDB stem stacks); each step gathers a random batch of
  rows, and the recipe's own augmentation on the device supplies the
  variation.

Every draw can also be given explicitly (``mix_from_draws``, the epoch's
``draws``), so the pool is held to the JAX package's with JAX's draws. Under
a mesh every rank holds the pool, draws the global batch from a generator
seeded alike and keeps its rows, as ``Trainer.train_step`` does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(fn(a) for a in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree) if isinstance(tree, (tuple, list)) else [tree]


# -- hierarchical (AUGMENTED_*) pool -----------------------------------------


@dataclass(frozen=True)
class HierarchicalPool:
    """Static spec and the device tensors: wavs, lengths, priors_cdf,
    ds_class_offset, ds_n_classes, class_sample_offset, class_n_samples."""

    t_sel: int              # selected_wav_samples
    max_abs_snr: float
    n_sources: int
    arrays: Dict[str, torch.Tensor]


def hierarchical_pool_from_dataset(ds, device="cuda") -> HierarchicalPool:
    """Decode an ``AugmentedOnlineMixingDataset``'s whole source pool into one
    float32 (n_utterances, longest) tensor on ``device`` with its index
    tables. The utterances are walked in the dataset's own sorted order, so
    flat indices match the host loader's (dataset, class, sample)."""
    from sudo_rm_rf_tpu_torch.data.hierarchical import _source_cache

    wavs, lengths = [], []
    ds_class_offset, ds_n_classes = [], []
    class_sample_offset, class_n_samples = [], []
    for d in range(ds.n_datasets):
        ds_class_offset.append(len(class_n_samples))
        ds_n_classes.append(ds.n_hierarchical_folders[d])
        for folders in ds.sample_folders[d]:
            class_sample_offset.append(len(wavs))
            class_n_samples.append(len(folders))
            for folder in folders:
                wav = _source_cache.get(os.path.join(folder, ds.return_items[0]))
                wav = np.asarray(wav, np.float32).reshape(-1)  # mono pools
                if wav.shape[-1] < ds.selected_wav_samples:
                    raise ValueError(f"utterance {folder} shorter ({wav.shape[-1]}) than "
                                     f"selected_wav_samples ({ds.selected_wav_samples})")
                wavs.append(wav)
                lengths.append(wav.shape[-1])
    pool = np.zeros((len(wavs), max(lengths)), np.float32)
    for i, w in enumerate(wavs):
        pool[i, : w.shape[-1]] = w
    host = {
        "wavs": pool,
        "lengths": np.asarray(lengths, np.int64),
        "priors_cdf": np.asarray(ds.priors_cdf, np.float32),
        "ds_class_offset": np.asarray(ds_class_offset, np.int64),
        "ds_n_classes": np.asarray(ds_n_classes, np.int64),
        "class_sample_offset": np.asarray(class_sample_offset, np.int64),
        "class_n_samples": np.asarray(class_n_samples, np.int64),
    }
    return HierarchicalPool(
        t_sel=int(ds.selected_wav_samples), max_abs_snr=float(ds.max_abs_snr),
        n_sources=int(ds.n_sources),
        arrays={k: torch.from_numpy(v).to(device) for k, v in host.items()})


def mix_from_draws(pool: Dict[str, torch.Tensor], draws: torch.Tensor, t_sel: int,
                   max_abs_snr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, 5) uniform draws -> (mixture (B, T), sources (B, S, T)), on
    the pool's device.

    The host loader's ``__getitem__`` restated over a batch: per source, the
    draws select the dataset (prior CDF, right side), the class (+1 mod n
    where it collides with source 0's class of the same dataset), the sample
    and the delay; an all-silent window (|x| <= 1e-8) falls back to the
    utterance's head; draw 4 of source 0 sets its SNR against unit-energy
    source 1; the result is mean-centred and standardized by the mixture's
    std (ddof=1). As JAX's, it matches the host loader to float32 tolerance.
    """
    draws = draws.to(pool["wavs"].device, torch.float32)
    n_src = draws.shape[1]
    cdf = pool["priors_cdf"]
    window = torch.arange(t_sel, device=draws.device)
    srcs, energies = [], []
    d0 = h0 = None
    for s in range(n_src):
        d = torch.searchsorted(cdf, draws[:, s, 0].contiguous(), right=True)
        d = torch.clamp(d, max=cdf.shape[0] - 1)
        n_cls = pool["ds_n_classes"][d]
        h = torch.minimum(torch.floor(draws[:, s, 1] * n_cls).long(), n_cls - 1)
        if s > 0:
            h = torch.where((d == d0) & (h == h0), (h + 1) % n_cls, h)
        g = pool["ds_class_offset"][d] + h
        n_smp = pool["class_n_samples"][g]
        si = torch.minimum(torch.floor(draws[:, s, 2] * n_smp).long(), n_smp - 1)
        u = pool["class_sample_offset"][g] + si
        margin = (pool["lengths"][u] - t_sel).to(draws.dtype)
        delay = torch.floor(draws[:, s, 3] * margin).long()
        chunk = pool["wavs"][u[:, None], delay[:, None] + window]
        silent = torch.all(chunk.abs() <= 1e-8, dim=-1, keepdim=True)
        chunk = torch.where(silent, pool["wavs"][u[:, None], window], chunk)
        if s == 0:
            d0, h0 = d, h
        srcs.append(chunk)
        energies.append(torch.sqrt(torch.sum(chunk**2, dim=-1)))
    snr_db = (draws[:, 0, 4] - 0.5) * max_abs_snr * 2.0
    ratio = torch.sqrt(10.0 ** (snr_db / 10.0))
    scales = [ratio / (energies[0] + 1e-7), 1.0 / (energies[1] + 1e-7)]
    clean = torch.stack([c * sc[:, None] for c, sc in zip(srcs, scales)] + srcs[2:], dim=1)
    mixture = clean.sum(dim=1)
    clean = clean - clean.mean(dim=-1, keepdim=True)
    mixture = mixture - mixture.mean(dim=-1, keepdim=True)
    std = mixture.std(dim=-1, keepdim=True, correction=1)
    return mixture / (std + 1e-7), clean / (std[:, :, None] + 1e-7)


@dataclass(frozen=True)
class Sampler:
    """How a resident step gets its batch: ``draw(generator)`` makes the
    step's draws on the generator's device, ``gather(arrays, draws)`` turns
    them into the batch."""

    draw: Callable
    gather: Callable


def make_hier_sampler(pool: HierarchicalPool, batch_size: int) -> Sampler:
    """Uniform (B, S, 5) draws -> the (B, S, T) source batch of
    :func:`mix_from_draws` (the recipe then remixes it, as it would the host
    loader's sources)."""
    t_sel, max_snr, n_src = pool.t_sel, pool.max_abs_snr, pool.n_sources

    def draw(generator):
        return torch.rand((batch_size, n_src, 5), generator=generator,
                          device=generator.device)

    return Sampler(draw, lambda arrays, draws: mix_from_draws(arrays, draws, t_sel, max_snr)[1])


# -- pre-stacked example pools (FUSS / WHAMR / MUSDB / preprocessed) ----------


def examples_pool_from_dataset(ds, project: Optional[Callable] = None, device="cuda"):
    """Every item of a map-style dataset stacked on ``device``: a tuple of
    (N, ...) stacks for tuple items, else one (N, ...) stack. ``project``
    maps a raw item to what the recipe takes (e.g. drops the loader's
    mixture for the remixing recipes). An augmenting dataset is taken in
    its epoch-0 state; the recipe's augmentation on the device varies it."""
    items = []
    for i in range(len(ds)):
        it = ds[i]
        items.append(project(it) if project is not None else it)
    if isinstance(items[0], (tuple, list)):
        return tuple(torch.from_numpy(np.stack([np.asarray(it[j]) for it in items])).to(device)
                     for j in range(len(items[0])))
    return torch.from_numpy(np.stack([np.asarray(it) for it in items])).to(device)


def make_examples_sampler(n_examples: int, batch_size: int) -> Sampler:
    """A uniform random batch of rows, with replacement (over an epoch of
    n / B steps each example is drawn once in expectation)."""

    def draw(generator):
        return torch.randint(0, n_examples, (batch_size,), generator=generator,
                             device=generator.device)

    return Sampler(draw, lambda pool, idx: _tree_map(lambda a: a[idx.to(a.device)], pool))


# -- the resident epoch ------------------------------------------------------


def make_resident_epoch(trainer, sampler: Sampler, steps: int, step_draw: Callable):
    """-> epoch(state, arrays, generator=None, draws=None) -> (state, losses
    (steps,) on the device).

    Each step draws its batch (``sampler.draw``) and then its recipe draws
    (``step_draw(generator, batch)``, e.g. ``Recipe.draw``) from
    ``generator``, gathers the batch from the pool and runs
    ``trainer.train_step``; nothing waits on the device. A generator in a
    given state reproduces the epoch bit for bit. ``draws``, a list of
    (sampler draws, step draws) per step, replaces the generator."""

    def epoch(state, arrays, generator=None, draws=None):
        if (generator is None) == (draws is None):
            raise ValueError("give the epoch a generator or its draws, not both")
        if draws is not None and len(draws) != steps:
            raise ValueError(f"{len(draws)} draws for an epoch of {steps} steps")
        losses = []
        for i in range(steps):
            if draws is None:
                batch = sampler.gather(arrays, sampler.draw(generator))
                step_draws = step_draw(generator, batch)
            else:
                batch = sampler.gather(arrays, draws[i][0])
                step_draws = draws[i][1]
            state, metrics = trainer.train_step(state, batch, step_draws)
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return epoch


class ResidentData:
    """A pool and its epoch runner. ``run_epoch(state, generator)`` runs the
    epoch's steps, reading the losses once an epoch, or once a chunk of
    ``SUDO_TPU_RESIDENT_CHUNK`` steps (which bounds the work queued ahead of
    the device)."""

    def __init__(self, trainer, sampler: Sampler, arrays, steps_per_epoch: int,
                 step_draw: Callable):
        self.arrays = arrays
        self.steps_per_epoch = steps_per_epoch
        chunk = int(os.environ.get("SUDO_TPU_RESIDENT_CHUNK", 0))
        if chunk <= 0 or chunk >= steps_per_epoch:
            self._plan = [steps_per_epoch]
        else:
            n_full, rest = divmod(steps_per_epoch, chunk)
            self._plan = [chunk] * n_full + ([rest] if rest else [])
        self._fns = {n: make_resident_epoch(trainer, sampler, n, step_draw)
                     for n in sorted(set(self._plan))}

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in _leaves(self.arrays))

    def run_epoch(self, state, generator=None, draws=None):
        """-> (state, the epoch's losses): on the device with one chunk, on
        the host (read chunk by chunk) with several."""
        losses, start = [], 0
        for n in self._plan:
            part = None if draws is None else draws[start:start + n]
            state, chunk_losses = self._fns[n](state, self.arrays, generator, part)
            losses.append(chunk_losses if len(self._plan) == 1 else chunk_losses.cpu())
            start += n
        return state, torch.cat(losses)


def build_for_experiment(trainer, train_gen, dataset_name: str, step_draw: Callable):
    """The pool flavor of an experiment's train generator, on the trainer's
    device: the AUGMENTED_* hierarchical datasets draw every item on the
    device; any other loader whose items stack becomes an example bank (the
    loader's mixture dropped for the remixing recipes, as the host batches
    drop it; WHAMR keeps its (sources, targets) pairs)."""
    from sudo_rm_rf_tpu_torch.data.hierarchical import AugmentedOnlineMixingDataset

    ds = train_gen.dataset
    steps = len(train_gen)
    batch = train_gen.batch_size
    device = trainer.device
    if isinstance(ds, AugmentedOnlineMixingDataset):
        pool = hierarchical_pool_from_dataset(ds, device)
        return ResidentData(trainer, make_hier_sampler(pool, batch), pool.arrays, steps,
                            step_draw)
    project = None
    if dataset_name != "WHAMR":
        project = lambda it: it[-1] if isinstance(it, (tuple, list)) else it  # noqa: E731
    stacks = examples_pool_from_dataset(ds, project=project, device=device)
    n = _leaves(stacks)[0].shape[0]
    return ResidentData(trainer, make_examples_sampler(n, batch), stacks, steps, step_draw)
