"""`sudo-torch-evaluate`: evaluate a torch checkpoint on a dataset split.

Counterpart of ``sudo_rm_rf_tpu/cli/evaluate.py``. Loads a ``.pt`` (a
state_dict, or a whole pickled module) or a msgpack checkpoint of either
package (bare params or a ``TrainState``), standardizes each mixture (ddof=1,
eps 1e-9), separates it on ``--device`` through ``improved_forward_fast``
(model types ``relu``/``improved``) or ``groupcomm_forward_fast``
(``groupcomm_v2``), which run the CUDA U-ConvBlock kernel on a CUDA tensor,
or the module's own forward (the other types; ``attention*`` take
``--n_heads``/``--att_dims``),
applies the optional mixture-consistency projection, de-standardizes, and
reports mean and median SI-SDR, SI-SDRi and BSS-eval SDR, SDRi, SIR and SAR
per example as one JSON line (the JAX CLI's keys):

    sudo-torch-evaluate --checkpoint Improved_Sudormrf_U36_Bases4096_WHAMRexclmark.pt \\
        --dataset WHAMR --separation_task noisy_reverberant -fs 16000 \\
        --out_channels 512 --in_channels 512 --num_blocks 36 \\
        --enc_num_basis 4096 --root_dirpath /mnt/data/whamr

``--full_length`` scores whole recordings (padded to the split's longest)
through the overlap-add separator, or with ``--full_length_mode
seq_parallel`` in one exact pass (``inference.SequenceParallelSeparator``);
``--batch_size`` chunks a forward. Under a torchrun launch every rank reads
the split: ``seq_parallel`` runs one time shard a rank, ``overlap_add``
splits each chunk batch over the ranks, the crops run on every rank, and
rank 0 prints (and pickles) the results.
``--dataset AUGMENTED --dataset_paths ROOT ...`` scores ``--n_samples``
(default 1000) fixed mixtures of a hierarchical corpus (seed 42, as the
JAX CLI draws them).

Departure from the JAX CLI, for ``--dataset FUSS``: an example's target
stack is zero-padded to ``--num_sources`` rows, and the JAX CLI scores the
zero rows too (a zero target's SI-SDR is -inf, which its permutation einsum
turns into NaN, so every mean is NaN). The port scores each example over its
active (non-zero) targets only, as training's per-source-count validation
does (:func:`fuss_scores`); an example whose rows are all active is scored
as before.
"""

from __future__ import annotations

import argparse
import functools
import json
import pickle
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate separation quality")
    p.add_argument("--checkpoint", required=True,
                   help="torch .pt, or a msgpack checkpoint (bare params or TrainState)")
    p.add_argument("--model_type", default="relu")
    p.add_argument("--dataset", default="WHAMR",
                   choices=["WHAM", "WHAMR", "LIBRI2MIX", "FUSS", "AUGMENTED"])
    p.add_argument("--dataset_paths", nargs="+", default=[],
                   help="hierarchical corpus roots (AUGMENTED only)")
    p.add_argument("--split", default="test")
    p.add_argument("--separation_task", default="sep_clean")
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--timelength", type=float, default=4.0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--n_samples", type=int, default=0)
    p.add_argument("--min_or_max", default="min")
    p.add_argument("--mixture_consistency", default=None,
                   choices=[None, "uniform", "magsq"])
    p.add_argument("--full_length_mode", default="overlap_add",
                   choices=["overlap_add", "seq_parallel"],
                   help="whole-recording engine: overlap-add chunking, or "
                        "seq_parallel, one exact pass (relu, groupcomm_v2, causal, "
                        "attention, attention_v2); under a torchrun launch one time "
                        "shard a rank (overlap_add: each chunk batch split over the "
                        "ranks), and rank 0 prints the results")
    p.add_argument("--full_length", action="store_true",
                   help="evaluate whole recordings through the engine of "
                        "--full_length_mode instead of fixed-length crops")
    p.add_argument("--bss_filter_taps", type=int, default=512,
                   help="BSS-eval distortion-filter length: 512 = the "
                        "museval/mir_eval convention; 1 = scalar-gain closed form")
    p.add_argument("--out_pickle", default=None)
    p.add_argument("--reference_root", default=None,
                   help="path that makes a whole-pickled torch module loadable")
    p.add_argument("--root_dirpath", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on; never falls back to the CPU")
    # model hyperparams (needed for bare state_dicts)
    p.add_argument("--out_channels", type=int, default=256)
    p.add_argument("--in_channels", type=int, default=512)
    p.add_argument("--num_blocks", type=int, default=16)
    p.add_argument("--upsampling_depth", type=int, default=5)
    p.add_argument("--enc_kernel_size", type=int, default=21)
    p.add_argument("--enc_num_basis", type=int, default=512)
    p.add_argument("--num_sources", type=int, default=2)
    p.add_argument("--group_size", type=int, default=16)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--att_dims", type=int, default=256)
    return p


def _scores(est, tgt, mix, taps: int) -> dict:
    """Per-example SI-SDR, SI-SDRi (over the batch-mean mixture baseline)
    and BSS-eval SDR, SDRi, SIR and SAR (each example's mean over its
    sources) of est (B, S, T) against tgt (B, S, T)."""
    from sudo_rm_rf_tpu_torch import losses

    kw = dict(n_sources=tgt.shape[1], zero_mean=True, backward_loss=False,
              return_individual_results=True)
    out = {"si_sdr": losses.PermInvariantSISDR(**kw)(est, tgt).cpu().tolist(),
           "si_sdri": losses.PermInvariantSISDR(improvement=True, **kw)(
               est, tgt, initial_mixtures=mix).cpu().tolist()}
    bss = losses.bss_eval_improvement(est, tgt, mix, filter_taps=taps)
    for ours, theirs in (("sdr", "sdr"), ("sdri", "sdr_i"), ("sir", "sir"), ("sar", "sar")):
        out[ours] = bss[theirs].mean(-1).cpu().tolist()
    return out


def fuss_scores(est, tgt, mix, taps: int) -> dict:
    """FUSS scores of a batch, each example over its active targets.

    tgt (B, S, T) holds each example's sources and zero rows after them.
    Examples are scored in groups of one active-source count n: n == S as
    :func:`_scores`; 1 < n < S with the stabilized SI-SDR over the P(S, n)
    injections of targets into estimates (and its improvement over the sum
    of the targets), BSS-eval on the estimates that injection picked; n == 1
    on estimate slot 0, as training's validation scores it, without an
    improvement (the mixture is the target itself): such examples add no
    SI-SDRi and no SDRi. Returns the per-example lists in batch order."""
    import torch

    from sudo_rm_rf_tpu_torch import losses

    s = tgt.shape[1]
    active = tgt.abs().amax(dim=-1) > 0  # (B, S)
    counts = active.sum(dim=1).tolist()
    if min(counts) == 0:
        raise ValueError("a FUSS example has no active source")
    per_example = [dict() for _ in counts]
    for n in sorted(set(counts)):
        idx = [i for i, c in enumerate(counts) if c == n]
        e, m = est[idx], mix[idx]
        t = torch.stack([tgt[i][active[i]] for i in idx])
        if n == s:
            got = _scores(e, t, m, taps)
        else:
            kw = dict(zero_mean=True, backward_loss=False, return_individual_results=True)
            n_est = s if n > 1 else 1
            e = e if n > 1 else e[:, :1]
            metric = losses.StabilizedPermInvSISDRMetric(
                n_estimated_sources=n_est, n_actual_sources=n, **kw)
            si, perm = metric(e, t, return_best_permutation=True)
            picked = torch.stack([e[j, perm[j]] for j in range(len(idx))])
            bss = losses.bss_eval_improvement(picked, t, m, filter_taps=taps)
            got = {"si_sdr": si.cpu().tolist(),
                   **{ours: bss[theirs].mean(-1).cpu().tolist()
                      for ours, theirs in (("sdr", "sdr"), ("sir", "sir"), ("sar", "sar"))}}
            if n > 1:
                got["si_sdri"] = losses.StabilizedPermInvSISDRMetric(
                    n_estimated_sources=n_est, n_actual_sources=n, improvement=True,
                    **kw)(e, t).cpu().tolist()
                got["sdri"] = bss["sdr_i"].mean(-1).cpu().tolist()
        for j, i in enumerate(idx):
            per_example[i] = {k: v[j] for k, v in got.items()}
    keys = ("si_sdr", "si_sdri", "sdr", "sdri", "sir", "sar")
    return {k: [ex[k] for ex in per_example if k in ex] for k in keys}


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models

    models.check_cli_model_type(args.model_type)
    if args.dataset == "AUGMENTED" and not args.dataset_paths:
        raise SystemExit("--dataset_paths is required with AUGMENTED")
    if args.full_length and args.full_length_mode == "seq_parallel":
        from sudo_rm_rf_tpu_torch.inference.sequence_parallel import SEQ_TYPES

        if args.model_type not in SEQ_TYPES:
            p.error(f"--full_length_mode seq_parallel supports model_type in {SEQ_TYPES} "
                    "(attention_v3 falls back to overlap_add)")

    import torch.distributed as dist

    from sudo_rm_rf_tpu_torch.inference import make_seq_comm
    from sudo_rm_rf_tpu_torch.parallel import launch_group, make_mesh, rank_device

    with launch_group(args.device) as joined:
        if joined:
            return _evaluate(args, rank_device(args.device), dist.get_rank() == 0,
                             make_seq_comm(), make_mesh())
        return _evaluate(args, torch.device(args.device), True, None, None)


def _evaluate(args, device, lead: bool, comm, mesh) -> int:
    """Evaluate on ``device``; ``comm`` / ``mesh``: a launch's communicator
    and mesh for the whole-recording engines (None in one process);
    ``lead``: this rank prints and writes the results."""
    import numpy as np
    import torch

    from sudo_rm_rf_tpu_torch import losses, models
    from sudo_rm_rf_tpu_torch.data.setup import (
        create_augmented_loader,
        create_loader_for_simple_dataset,
    )
    from sudo_rm_rf_tpu_torch.utils.benchmark import serving_forward

    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")

    hp = dict(
        out_channels=args.out_channels, in_channels=args.in_channels,
        num_blocks=args.num_blocks, upsampling_depth=args.upsampling_depth,
        enc_kernel_size=args.enc_kernel_size, enc_num_basis=args.enc_num_basis,
        num_sources=args.num_sources,
    )
    if args.model_type == "groupcomm_v2":
        hp["group_size"] = args.group_size
    if args.model_type.startswith("attention"):
        hp.update(n_heads=args.n_heads, att_dims=args.att_dims)
    model = models.load_checkpoint_model(args.model_type, hp, args.checkpoint, device,
                                         reference_root=args.reference_root)
    separate = functools.partial(serving_forward(model), model)

    if args.dataset == "AUGMENTED":
        # fixed mixtures of a hierarchical corpus (seed 42 for val and test)
        dataset = create_augmented_loader({
            f"{args.split}_dataset_paths": list(args.dataset_paths),
            f"n_{args.split}": args.n_samples or 1000,
            "fs": args.fs,
            "audio_timelength": args.timelength,
            "n_sources": args.num_sources,
        }, split=args.split)
    else:
        dataset = create_loader_for_simple_dataset(
            dataset_name=args.dataset, separation_task=args.separation_task,
            data_split=args.split, sample_rate=args.fs,
            min_or_max=args.min_or_max, zero_pad=True,
            timelength=-1.0 if args.full_length else args.timelength,
            n_samples=args.n_samples, root_dirpath=args.root_dirpath,
        )
    loader = dataset.get_generator(
        batch_size=1 if args.full_length else args.batch_size,
        shuffle=False, num_workers=2,
    )

    @torch.no_grad()
    def forward(mixture):  # (B, 1, T)
        mean = mixture.mean(dim=-1, keepdim=True)
        std = mixture.std(dim=-1, keepdim=True)  # ddof=1
        xn = (mixture - mean) / (std + 1e-9)
        est = separate(xn)
        if args.mixture_consistency:
            est = losses.mixture_consistency(est, xn, args.mixture_consistency)
        return est * std + mean

    ola = None
    if args.full_length and args.full_length_mode == "seq_parallel":
        from sudo_rm_rf_tpu_torch.inference import SequenceParallelSeparator

        ola = SequenceParallelSeparator(model, comm=comm,
                                        mixture_consistency=args.mixture_consistency)
    elif args.full_length:
        from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator

        ola = OverlapAddSeparator(
            model, chunk_samples=int(args.timelength * args.fs),
            num_sources=args.num_sources, batch_chunks=args.batch_size,
            mixture_consistency=args.mixture_consistency, forward_fn=separate, mesh=mesh,
        )

    results = {"si_sdr": [], "si_sdri": [], "sdr": [], "sdri": [], "sir": [], "sar": []}
    for batch in loader:
        if isinstance(batch, (tuple, list)):
            mixture, targets = np.asarray(batch[0]), batch[-1]
            if mixture.ndim == 2:
                mixture = mixture[:, None, :]
            elif mixture.shape[1] > 1:
                if args.dataset != "WHAMR":
                    raise SystemExit(
                        f"{args.dataset} yielded a (B, {mixture.shape[1]}, T) first "
                        "tensor; only WHAMR input-source stacks are summed to mono")
                # WHAMR's (B, S, T) stack of input sources (reverberant s1, s2
                # and noise): the input is their sum, standardized by forward
                mixture = mixture.sum(axis=1, keepdims=True)
        else:
            targets = batch
            mixture = np.asarray(batch).sum(1, keepdims=True)
        mix = torch.from_numpy(np.ascontiguousarray(mixture, np.float32)).to(device)
        tgt = torch.from_numpy(np.ascontiguousarray(np.asarray(targets)[:, : args.num_sources],
                                                    np.float32)).to(device)
        if ola is not None:
            est = torch.from_numpy(ola.separate(mixture[0, 0])[None]).to(device)
        else:
            est = forward(mix)
        score = fuss_scores if args.dataset == "FUSS" else _scores
        for k, v in score(est, tgt, mix, args.bss_filter_taps).items():
            results[k] += v

    summary = {k + "_mean": float(np.mean(v)) for k, v in results.items() if v}
    summary.update({k + "_median": float(np.median(v)) for k, v in results.items() if v})
    summary["n_examples"] = len(results["si_sdr"])
    if results["sdr"]:
        summary["bss_eval_filter_taps"] = args.bss_filter_taps
        if args.bss_filter_taps < 512:
            # SI-SDR rows compare with published tables at any tap count;
            # absolute sdr/sir/sar only at museval's 512
            summary["bss_eval_note"] = (
                f"sdr/sir/sar use length-{args.bss_filter_taps} distortion "
                "filters; museval uses 512 - do not compare absolutes "
                "against museval-based tables"
            )
    if not lead:
        return 0
    print(json.dumps(summary))
    if args.out_pickle:
        with open(args.out_pickle, "wb") as fh:
            pickle.dump(results, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
