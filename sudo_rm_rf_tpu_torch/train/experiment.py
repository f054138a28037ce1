"""The experiment runner behind ``sudo-torch-train`` (counterpart of
``sudo_rm_rf_tpu/train/experiment.py``). The recipe follows the training set:

  * WHAM / LIBRI2MIX / AUGMENTED_*: online cross-batch remix of the
    loader's sources, PIT SI-SDR clamped to +-loss_clamp;
  * WHAMR: the same remix permutation for each slot's reverberant source and
    anechoic target, the mixture the standardized sum of the sources;
  * FUSS: per-slot batch shuffles, a slot permutation and random gains, the
    mixture the standardized sum, the zero-reference SNR loss, always through
    the mixture-consistency projection ('uniform' unless set), and
    validation per source count with the stabilized SI-SDR;
  * MUSDB: the four stems (drums, bass, other, vocals) are output slots with
    fixed identities, so the loss is fixed-assignment SI-SDR, not PIT (PIT
    would credit a vocals estimate in the drums slot); the mixture is the
    stem sum, with no batch-level remix (the loader draws random segments),
    and validation scores the fixed-order SI-SDRi of batches that hold only
    the stems. This path draws nothing at random.

Each epoch: train -> validate each val set (per-sample metrics through the
model's own forward, in the training compute dtype) -> report mean/std ->
audio log -> periodic and best checkpoints (with optimizer state, so a run
resumes) -> optional early stop.

Under a ``torch.distributed`` launch (``sudo-torch-train`` under torchrun)
the ranks form a (data, model) grid as JAX's devices do: ``n_model`` from
the config, ``n_data = gcd(batch_size, world // n_model)``; ranks beyond
the grid idle. Every rank loads the same global batches and draws the same
remixes, and the trainer keeps its rows (``train.trainer``). ``n_model >
1`` stores the large params as row shards (storage TP) and, for relu /
improved models with block_impl 'fma', splits the blocks' channels (compute
TP). Every rank validates the whole val set, so the metrics are one
process's. Rank 0 alone logs, writes audio and writes the checkpoints, which
hold the gathered whole tree (JAX's ``CheckpointManager`` and a one-process
run read them); ``resume`` reads rank 0's files on every rank.

How the steps are fed:

* host batches: the loader's batches are copied to the device step by step,
  or with ``chain_steps`` K > 1 stacked K at a time and copied in one pinned
  copy (``Trainer.train_steps``; a ragged tail runs step by step), bit for
  bit the same updates; ``max_inflight`` N > 0 makes the host wait on the
  CUDA event of the (i - N)-th dispatch before it queues more, which bounds
  the work queued ahead of the card and the pinned host batches (0: no
  bound);
* ``device_data``: the training set is decoded once into a pool on the
  device (``train.resident``) and every step draws its batch there from a
  generator on the device: no byte a step is copied from the host.

``block_impl='auto'`` times the block forms through the real train step at
the run's batch and dtype once at build (``train.autotune``), prints the
table and trains with the fastest. A validation generator that replays the
same batches every epoch (an unshuffled loader) is stacked and copied to
the device once, up to ``SUDO_TPU_VAL_RESIDENT_MAX`` bytes (4 GiB); under
``device_data`` an AUGMENTED_* val set is made on the device from its
dataset's ``random_draws``.
"""

from __future__ import annotations

import collections
import glob
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sudo_rm_rf_tpu_torch import losses as losses_lib
from sudo_rm_rf_tpu_torch.config import ExperimentConfig
from sudo_rm_rf_tpu_torch.models import check_cli_model_type
from sudo_rm_rf_tpu_torch.parallel import make_mesh
from sudo_rm_rf_tpu_torch.train import augment as augment_lib
from sudo_rm_rf_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    _default_loss,
    _default_prepare,
    check_config,
)
from sudo_rm_rf_tpu_torch.utils import (
    AudioLogger,
    CheckpointManager,
    ExperimentLogger,
    report_losses_mean_and_std,
)

RECIPES = ("WHAM", "LIBRI2MIX", "WHAMR", "FUSS", "MUSDB")
# every hierarchical online-mixing set (AUGMENTED_WSJMIX, ...) takes the
# WSJ0 remix recipe
AUGMENTED_PREFIX = "AUGMENTED"


@dataclass(frozen=True)
class Recipe:
    """How a training set becomes train steps.

    draw: (generator, batch) -> the step's random draws;
    prepare: (draws, batch on the device) -> (mixture (B, 1, T), targets);
    loss_fn: (est, targets) -> scalar;
    pairs: whether the step takes the loader's whole (sources, targets)
      pair (WHAMR) rather than its last array.
    """

    draw: Callable
    prepare: Callable
    loss_fn: Callable
    pairs: bool = False


def make_recipe(config: ExperimentConfig) -> Recipe:
    """The recipe of ``config``'s training set."""
    dataset = config.data.train[0] if config.data.train else "WHAM"
    n_src = config.model.num_sources

    if dataset == "FUSS":
        snr = losses_lib.PermInvariantSNRwithZeroRefs(n_sources=n_src)

        def prepare(draws, batch):  # batch: sources (B, S, T)
            aug = augment_lib.fuss_online_augment(batch, *draws)
            return augment_lib.fuss_mixture(aug)[:, None, :], aug

        return Recipe(lambda g, batch: augment_lib.draw_fuss(g, *batch.shape[:2]),
                      prepare, lambda est, targets: snr(est, targets))

    if dataset == "WHAMR":

        def prepare(draws, batch):  # batch: (sources, targets), each (B, 3, T)
            mixture, targets = augment_lib.online_remix_pairs(*batch, draws)
            return mixture[:, None, :], targets[:, :n_src]

        return Recipe(lambda g, batch: augment_lib.draw_pair_remix(g, *batch[0].shape[:2]),
                      prepare, _default_loss, pairs=True)

    if dataset == "MUSDB":

        def prepare(draws, batch):  # batch: (B, ch, 4, T) stem stacks
            stems = batch.sum(dim=1) if batch.ndim == 4 else batch  # mono sum
            return stems.sum(dim=1)[:, None, :], stems

        return Recipe(lambda g, batch: None, prepare, musdb_loss)

    # WHAM / LIBRI2MIX / AUGMENTED_*: the trainer's own WSJ0-style remix of (B, S, T) sources
    return Recipe(lambda g, batch: augment_lib.draw_remix(g, *batch.shape[:2]),
                  _default_prepare, _default_loss)


def musdb_loss(est: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Negated mean SI-SDR of each stem slot against its own target."""
    return -torch.mean(losses_lib.sdr(targets, est, si=True))


def fixed_order_sisdri(est: torch.Tensor, targets: torch.Tensor,
                       initial_mixtures: torch.Tensor) -> torch.Tensor:
    """Per-sample SI-SDRi (B,) of slot i against target i, averaged over the
    slots, with the mixture (B, 1, T) as every slot's baseline: MUSDB's
    validation metric."""
    si = losses_lib.sdr(targets, est, si=True)
    base = losses_lib.sdr(targets, initial_mixtures.expand_as(targets), si=True)
    return torch.mean(si - base, dim=-1)


def fuss_val_batch(forward: Callable, batch: torch.Tensor, n_actual: int, num_sources: int):
    """One FUSS validation batch: the mixture is the standardized sum of the
    ``n_actual`` sources (std eps 1e-9), the estimates come from ``forward``
    (which includes the mixture-consistency projection), scored with the
    stabilized SI-SDR over P(num_sources, n_actual) injections, as an
    improvement for n_actual > 1; with one source only estimate slot 0 is
    scored. Returns (per-sample values, estimates, mixture)."""
    mixture = augment_lib.normalize_wav(batch.sum(dim=1, keepdim=True), eps=1e-9)
    est = forward(mixture)
    metric = losses_lib.StabilizedPermInvSISDRMetric(
        n_estimated_sources=num_sources if n_actual > 1 else 1,
        n_actual_sources=n_actual,
        zero_mean=True,
        improvement=n_actual > 1,
        backward_loss=False,
        return_individual_results=True,
    )
    return metric(est[:, :1] if n_actual == 1 else est, batch), est, mixture


def val_mixture(m: np.ndarray) -> np.ndarray:
    """The model input of a val batch, (B, 1, T): a loader yields a (B, T)
    mixture (WHAM family) or a (B, S, T) stack of the input sources (WHAMR's
    reverberant s1, s2 and noise), whose standardized sum is the input."""
    if m.ndim == 2:
        return m[:, None, :]
    if m.shape[1] > 1:
        return augment_lib.normalize_wav(torch.from_numpy(m).sum(dim=1)).numpy()[:, None, :]
    return m


def val_targets(t: np.ndarray) -> np.ndarray:
    """The (B, S, T) targets of a val batch: MUSDB's items are (ch, 4, T)
    stem stacks, whose audio channels are summed to mono as its loader's
    own rule does."""
    return t.sum(axis=1) if t.ndim == 4 else t


def check_supported(config: ExperimentConfig) -> None:
    """Raise for an option the port does not take (yet)."""
    m, t = config.model, config.train
    check_cli_model_type(m.model_type)
    if m.block_impl == "kernel":
        raise ValueError("block_impl 'kernel' is forward-only: train with "
                         "block_impl 'fma' or 'xla'")
    check_config(TrainerConfig(optimizer=t.optimizer, upload_dtype=t.upload_dtype))
    for split in ("train", "val", "test", "train_val"):
        for name in getattr(config.data, split):
            if name not in RECIPES and not name.startswith(AUGMENTED_PREFIX):
                raise ValueError(f"Dataset: {name} is not yet supported!")
    if m.in_audio_channels != 1:
        # every recipe feeds the model a mono (B, 1, T) mixture (MUSDB sums
        # its stereo stems); JAX's trainer raises at the encoder's conv
        raise ValueError(
            f"--n_channels {m.in_audio_channels}: every training recipe feeds a mono "
            "mixture, so the model must take in_audio_channels=1 (ROADMAP queue 3)")


def experiment_mesh(config: ExperimentConfig):
    """The (data, model) mesh of a launch, sized as JAX's experiment sizes
    its device mesh: ``n_model`` from the config, ``n_data = gcd(batch_size,
    world // n_model)``. None in one process with ``n_model`` 1 (nothing to
    communicate). Every rank of the launch calls it."""
    import torch.distributed as dist

    n_model = max(config.train.n_model, 1)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    avail = world // n_model
    if avail < 1:
        raise ValueError(f"n_model={n_model} exceeds {world} ranks: launch at least "
                         f"{n_model} (torchrun --nproc_per_node {n_model} ...)")
    if world == 1:
        return None
    return make_mesh(n_data=math.gcd(config.data.batch_size, avail), n_model=n_model)


def resolve_block_impl(config: ExperimentConfig, device, mesh=None) -> str:
    """Replace ``block_impl 'auto'`` in ``config`` by a measured form:
    relu and groupcomm_v2 time 'xla' and 'fma' at the run's batch and
    compute dtype on ``device`` (and print the table and the pick); other
    model types and multichannel GroupComm take 'xla', as in JAX. Under a
    launch every rank measures and rank 0's pick holds on all. Returns the
    block form."""
    m = config.model
    if m.block_impl != "auto":
        return m.block_impl
    from sudo_rm_rf_tpu_torch.train.autotune import TUNABLE_FAMILIES, autotune_block_impl

    multichannel = m.model_type == "groupcomm_v2" and m.in_audio_channels != 1
    if m.model_type in TUNABLE_FAMILIES and not multichannel:
        kw = dict(out_channels=m.out_channels, in_channels=m.in_channels,
                  num_blocks=m.num_blocks, upsampling_depth=m.upsampling_depth,
                  enc_kernel_size=m.enc_kernel_size, enc_num_basis=m.enc_num_basis,
                  num_sources=m.num_sources,
                  # calibrate the program that trains: remat moves the
                  # backward's cost of each form
                  remat_blocks=m.remat_blocks)
        if m.model_type == "groupcomm_v2":
            kw.update(group_size=m.group_size)
        tuned = autotune_block_impl(kw, config.data.batch_size, config.train.compute_dtype,
                                    model_type=m.model_type,
                                    audio_seconds=config.data.audio_timelength,
                                    fs=config.data.fs, device=device)
        pick = tuned.impl
        if mesh is not None:
            import torch.distributed as dist

            picks = [pick]
            dist.broadcast_object_list(picks, src=0)
            pick = picks[0]
        if mesh is None or mesh.rank == int(mesh.grid[0, 0]):
            print(f"block_impl auto -> {pick}\n{tuned.table()}", flush=True)
    else:
        if multichannel:
            print("block_impl auto: multichannel batch contract is not calibratable, "
                  "using 'xla'")
        pick = "xla"
    m.block_impl = pick
    return pick


class InflightBound:
    """At most ``max_inflight`` train dispatches queued ahead of the card:
    :meth:`dispatched` records a CUDA event after each dispatch and waits on
    the (i - max_inflight)-th. 0, or a device other than CUDA, bounds
    nothing."""

    def __init__(self, max_inflight: int, device):
        self.max_inflight = max_inflight
        self.on = max_inflight > 0 and torch.device(device).type == "cuda"
        self.events: collections.deque = collections.deque()

    def dispatched(self) -> None:
        if not self.on:
            return
        event = torch.cuda.Event()
        event.record()
        self.events.append(event)
        if len(self.events) > self.max_inflight:
            self.events.popleft().synchronize()


def host_epoch(trainer: Trainer, state, batches, recipe: Recipe, generator: torch.Generator,
               chain_steps: int = 1, max_inflight: int = 0, phase: Optional[Dict] = None):
    """One epoch of host batches through ``trainer``, as ``sudo-torch-train``
    feeds them: each batch's recipe draws come from ``generator`` as it
    arrives; with ``chain_steps`` K > 1 every K batches go through
    ``Trainer.train_steps`` (one stacked copy), a ragged tail step by step;
    ``max_inflight`` bounds the dispatches queued ahead of the card
    (:class:`InflightBound`). Returns (state, the steps' losses as device
    tensors). ``phase`` gets the host seconds waiting for the loader
    ("data") and dispatching ("disp"), the wait for the card at the end
    included."""
    phase = {"data": 0.0, "disp": 0.0} if phase is None else phase
    chain = max(chain_steps, 1)
    bound = InflightBound(max_inflight, trainer.device)
    losses: list = []
    chunk: list = []

    def flush(state):
        if len(chunk) == chain and chain > 1:
            batches_ = [b for b, _ in chunk]
            stacked = (tuple(np.stack(xs) for xs in zip(*batches_))
                       if isinstance(batches_[0], tuple) else np.stack(batches_))
            state, metrics = trainer.train_steps(state, stacked, [d for _, d in chunk])
            losses.append(metrics["loss"])
            bound.dispatched()
        else:
            for b, d in chunk:
                state, metrics = trainer.train_step(state, b, d)
                losses.append(metrics["loss"])
                bound.dispatched()
        chunk.clear()
        return state

    t_mark = time.time()
    for batch in batches:
        # the WHAM-family recipes remix the sources and never read the
        # loader's mixture; WHAMR takes the (sources, targets) pair
        if isinstance(batch, (tuple, list)) and not recipe.pairs:
            batch = batch[-1]
        t0 = time.time()
        phase["data"] += t0 - t_mark
        chunk.append((batch, recipe.draw(generator, batch)))
        if len(chunk) == chain:
            state = flush(state)
        t_mark = time.time()
        phase["disp"] += t_mark - t0
    t0 = time.time()
    if chunk:
        state = flush(state)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    phase["disp"] += time.time() - t0
    return state, losses


def _val_cache_entry(gen, device, val_max: int, on_device_pool: bool):
    """The batches of a val generator that replays them every epoch, on
    ``device``: ("targets", (Nb, B, S, T)) or ("pairs", (Nb, B, 1, T),
    (Nb, B, S, T)); None where they are ragged or over ``val_max`` bytes.
    With ``on_device_pool`` an AUGMENTED_* set with fixed draws is mixed on
    the device from them (``train.resident.mix_from_draws``)."""
    from sudo_rm_rf_tpu_torch.data.hierarchical import AugmentedOnlineMixingDataset

    ds = getattr(gen, "dataset", None)
    if (on_device_pool and isinstance(ds, AugmentedOnlineMixingDataset)
            and ds.random_draws is not None):
        from sudo_rm_rf_tpu_torch.train import resident as resident_lib

        bs = gen.batch_size
        n_b = len(ds) // bs
        if n_b == 0:
            return None
        pool = resident_lib.hierarchical_pool_from_dataset(ds, device)
        draws = torch.from_numpy(ds.random_draws[: n_b * bs].astype(np.float32))
        mix, src = resident_lib.mix_from_draws(pool.arrays, draws, pool.t_sel,
                                               pool.max_abs_snr)
        return ("pairs", mix.reshape(n_b, bs, 1, mix.shape[-1]),
                src.reshape(n_b, bs, src.shape[1], src.shape[-1]))
    mixtures, targets = [], []
    for batch in gen:
        if isinstance(batch, (tuple, list)):
            mixtures.append(val_mixture(batch[0]))
            targets.append(val_targets(batch[-1]))
        else:  # targets only (MUSDB): the mixture is their sum
            targets.append(val_targets(batch))
    if not targets:
        return None
    nbytes = sum(t.nbytes for t in targets) + sum(m.nbytes for m in mixtures)
    if (len({t.shape for t in targets}) != 1 or len({m.shape for m in mixtures}) > 1
            or nbytes > val_max):
        return None
    tstack = torch.from_numpy(np.stack(targets)).to(device)
    if mixtures:
        return ("pairs", torch.from_numpy(np.stack(mixtures)).to(device), tstack)
    return ("targets", tstack)


def _val_batch(batch, device):
    """(mixture (B, 1, T), targets (B, S, T)) of a loader's val batch on
    ``device``."""
    if isinstance(batch, (tuple, list)):
        return (torch.from_numpy(val_mixture(batch[0])).to(device),
                torch.from_numpy(val_targets(batch[-1])).to(device))
    targets = torch.from_numpy(val_targets(batch)).to(device)  # MUSDB: the sum is the mixture
    return targets.sum(dim=1, keepdim=True), targets


def _adam_step(optimizer) -> int:
    steps = [int(s["step"]) for s in optimizer.state.values() if "step" in s]
    return max(steps) if steps else 0


def run_experiment(
    config: ExperimentConfig,
    generators: Optional[Dict] = None,
    logger: Optional[ExperimentLogger] = None,
    resume: bool = False,
    log_audio_every: int = 1,
    device="cuda",
):
    """Train per config on ``device`` (never the CPU unless asked).
    ``generators`` overrides data.setup (for tests). Returns (state,
    history of per-epoch metric means)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    check_supported(config)
    mesh = experiment_mesh(config)
    if mesh is not None and not mesh.member:
        print(f"rank {mesh.rank}: outside the {mesh.n_data} x {mesh.n_model} mesh, idle")
        return None, []
    lead = mesh is None or mesh.rank == int(mesh.grid[0, 0])  # logs and writes
    if generators is None:
        from sudo_rm_rf_tpu_torch.data import setup as data_setup

        generators = data_setup.setup(config.hparams())
    if lead and logger is None:
        logger = ExperimentLogger("./logs", config.experiment_name, tags=list(config.tags))
    if not lead:
        logger = None
    if logger is not None:
        logger.log_parameters(config.hparams())

    resolve_block_impl(config, device, mesh)
    # one generator for the init and one for the remix draws, seeded as the
    # JAX package seeds its two keys (seed and seed + 1)
    n_model = 1 if mesh is None else mesh.n_model
    tp_mesh = (mesh if n_model > 1 and config.model.model_type in ("relu", "improved")
               and config.model.block_impl == "fma" else None)
    model = config.model.build(device=device,
                               generator=torch.Generator().manual_seed(config.train.seed),
                               tp_mesh=tp_mesh)
    recipe = make_recipe(config)
    dataset = config.data.train[0] if config.data.train else "WHAM"
    mixture_consistency = config.train.mixture_consistency
    if dataset == "FUSS" and mixture_consistency is None:
        # FUSS always projects its estimates onto the mixture, in train and val
        mixture_consistency = "uniform"
    steps_per_epoch = max(len(generators["train"]), 1)
    trainer = Trainer(
        model,
        TrainerConfig(
            learning_rate=config.train.learning_rate,
            divide_lr_by=config.train.divide_lr_by,
            patience_epochs=config.train.patience_epochs,
            steps_per_epoch=steps_per_epoch,
            clip_grad_norm=config.train.clip_grad_norm,
            loss_clamp=config.train.loss_clamp,
            mixture_consistency=mixture_consistency,
            optimizer=config.train.optimizer,
            grad_accum_steps=config.train.grad_accum_steps,
            total_steps=max(config.train.n_epochs * steps_per_epoch, 1),
            compute_dtype=config.train.compute_dtype,
            upload_dtype=config.train.upload_dtype,
            shard_params=n_model > 1,
        ),
        loss_fn=recipe.loss_fn,
        prepare_batch=recipe.prepare,
        mesh=mesh,
    )
    state = trainer.init_state()

    ckpt = CheckpointManager(
        os.path.join(config.train.checkpoints_path, config.experiment_name),
        config.model.model_type, writer=lead,
    )
    start_epoch = 0
    if resume:
        last = ckpt.latest_epoch()
        if last > 0:
            state = ckpt.restore(state, f"{config.model.model_type}_epoch_{last}")
            start_epoch = last
            if lead:
                print(f"resumed from epoch {last}: step {state.step}, "
                      f"Adam step {_adam_step(state.optimizer)}")

    audio_logger = None if logger is None else AudioLogger(
        os.path.join(logger.log_dir, "audio"), fs=config.data.fs,
        n_sources=config.model.num_sources)
    n_src = config.model.num_sources
    if dataset == "MUSDB":
        sisdri = fixed_order_sisdri
    else:
        sisdri = losses_lib.PermInvariantSISDR(
            n_sources=n_src, zero_mean=True, backward_loss=False, improvement=True,
            return_individual_results=True,
        )

    print_lead = print if lead else (lambda *a, **k: None)
    # the training set decoded once into a pool on the device, each step's
    # batch and draws made there from a generator on the device
    resident = None
    if config.train.device_data:
        from sudo_rm_rf_tpu_torch.train import resident as resident_lib

        t0 = time.time()
        resident = resident_lib.build_for_experiment(trainer, generators["train"], dataset,
                                                     recipe.draw)
        print_lead(f"device-resident pool: {resident.nbytes / 2**20:.1f} MiB, "
                   f"{steps_per_epoch} steps/epoch, built in {time.time() - t0:.1f}s",
                   flush=True)
    val_max = int(os.environ.get("SUDO_TPU_VAL_RESIDENT_MAX", 4 * 1024**3))
    val_cache: Dict = {}

    history = []
    remix_generator = torch.Generator(device=device if resident is not None else "cpu")
    remix_generator.manual_seed(config.train.seed + 1)
    best_seen, since_best = -np.inf, 0
    for epoch in range(start_epoch, config.train.n_epochs):
        res_dic: Dict = {"tr_loss": {"acc": []}}
        epoch_start = time.time()
        train_gen = generators["train"]
        if hasattr(train_gen.dataset, "set_epoch"):
            train_gen.dataset.set_epoch(epoch)
        # host wall-clock by phase, printed in the epoch line: data = waiting
        # for the loader, disp = dispatching train steps and waiting for the
        # card to finish them, val and ckpt; and the bytes and copies of the
        # train batches from the host to the device, by step
        phase = {"data": 0.0, "disp": 0.0, "val": 0.0, "ckpt": 0.0}
        h2d_start, copies_start = trainer.h2d_bytes, trainer.h2d_copies
        if resident is not None:
            t0 = time.time()
            state, losses = resident.run_epoch(state, remix_generator)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            res_dic["tr_loss"]["acc"].append(losses)
            phase["disp"] += time.time() - t0
        else:
            state, losses = host_epoch(trainer, state, train_gen, recipe, remix_generator,
                                       config.train.chain_steps, config.train.max_inflight,
                                       phase)
            res_dic["tr_loss"]["acc"].extend(losses)

        t_val0 = time.time()
        val_names = [k for k in generators if k != "train" and (
            k in ("val", "test", "train_val") or k.endswith("_srcs"))]
        forward = lambda m: trainer.forward(model, m, trainer.compute_dtype)
        for val_name in val_names:
            gen = generators.get(val_name)
            if gen is None or len(gen) == 0:
                continue
            last_batch = None
            if val_name.endswith("_srcs"):  # FUSS, one source count
                n_actual = int(val_name.split("_")[1])
                metric_name = f"{val_name}_SISDRi" if n_actual > 1 else f"{val_name}_SISDR"
                res_dic.setdefault(metric_name, {"acc": []})
                for batch in gen:
                    targets = torch.from_numpy(batch).to(device)
                    with torch.no_grad():
                        vals, est, mixture = fuss_val_batch(forward, targets, n_actual, n_src)
                    res_dic[metric_name]["acc"].append(vals)
                    last_batch = (est, targets, mixture)
            else:
                metric_name = f"{val_name}_SISDRi"
                res_dic.setdefault(metric_name, {"acc": []})
                if val_name not in val_cache:
                    # only a generator that replays the same batches every
                    # epoch (an unshuffled loader) is kept on the device
                    val_cache[val_name] = (
                        _val_cache_entry(gen, device, val_max, resident is not None)
                        if getattr(gen, "shuffle", None) is False else None)
                cached = val_cache[val_name]
                if cached is not None:
                    batches = (zip(cached[1], cached[2]) if cached[0] == "pairs"
                               else ((t.sum(dim=1, keepdim=True), t) for t in cached[1]))
                else:
                    batches = (_val_batch(batch, device) for batch in gen)
                for mixture, targets in batches:
                    with torch.no_grad():
                        est = forward(mixture)
                        vals = sisdri(est, targets[:, :n_src], initial_mixtures=mixture)
                    res_dic[metric_name]["acc"].append(vals)
                    last_batch = (est, targets, mixture)
            if (audio_logger is not None and last_batch is not None
                    and epoch % log_audio_every == 0):
                audio_logger.log_batch(
                    *(v.cpu().numpy() for v in last_batch), experiment=logger,
                    step=epoch, tag=val_name,
                )
        # one device-to-host copy per metric and epoch
        for vals in res_dic.values():
            if vals["acc"]:
                vals["acc"] = torch.cat([a.reshape(-1) for a in vals["acc"]]).cpu().tolist()
        phase["val"] = time.time() - t_val0
        res_dic = report_losses_mean_and_std(res_dic, logger, epoch, epoch)
        history.append({k: v["mean"] for k, v in res_dic.items()})

        t_ck0 = time.time()
        ckpt.save_every(state, epoch + 1, config.train.save_checkpoint_every)
        best_key = "val_SISDRi" if "val_SISDRi" in res_dic else next(
            (k for k in res_dic if k.startswith("val") and "_SISDR" in k), None)
        if best_key is not None:
            if ckpt.save_if_best(state, best_key, res_dic[best_key]["mean"], epoch + 1):
                for p in glob.glob(os.path.join(ckpt.directory, "best_*")) if lead else ():
                    if not p.endswith(".json"):
                        logger.log_asset(p)
        phase["ckpt"] = time.time() - t_ck0
        n_copies = (trainer.h2d_copies - copies_start) / steps_per_epoch
        print_lead(
            f"epoch {epoch + 1}/{config.train.n_epochs} "
            + " ".join(f"{k}={v['mean']:.3f}" for k, v in res_dic.items())
            + f" ({time.time() - epoch_start:.1f}s:"
            + f" data={phase['data']:.1f} disp={phase['disp']:.1f}"
            + f" val={phase['val']:.1f} ckpt={phase['ckpt']:.1f}"
            + (f" h2d={(trainer.h2d_bytes - h2d_start) // steps_per_epoch} B/step,"
               f" {n_copies:g} copies/step)" if trainer.h2d_bytes > h2d_start else ")"),
            flush=True,
        )
        for metric, vals in res_dic.items():
            if vals["acc"] and logger is not None:
                logger.log_metric_array(metric, vals["acc"], epoch + 1)

        # plateau-based early stop on the primary val metric (higher is better)
        if best_key is not None and config.train.early_stop_patience > 0:
            cur = res_dic[best_key]["mean"]
            if cur > best_seen + 1e-6:
                best_seen, since_best = cur, 0
            else:
                since_best += 1
                if since_best >= config.train.early_stop_patience:
                    print_lead(f"early stop at epoch {epoch + 1}: no {best_key} "
                          f"improvement for {since_best} epochs (best {best_seen:.4f})")
                    break

    return state, history
