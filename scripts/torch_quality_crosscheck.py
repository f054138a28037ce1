"""Quality cross-check of a checkpoint in both packages: the PyTorch port
and the JAX package score one checkpoint on the same fixed-seed mixtures of
a hierarchical corpus (the port's counterpart of
``scripts/quality_crosscheck.py``, which holds JAX against the reference).

Three sides, so that the port runs where JAX is absent (the card's
machine):

  * ``--side port`` (``--device cuda`` by default, or ``cpu``): the port's
    AUGMENTED test loader (seed 42) and the checkpoint's module forward on
    standardized mixtures (optional mixture consistency), writing each
    example's SI-SDRi, the mixtures, targets and estimates to ``--npz``;
  * ``--side jax``: the JAX package (imported here only) on the same
    checkpoint and corpus, checking that its loader made the port's
    mixtures, writing its SI-SDRi and estimates to ``--jax_npz``;
  * ``--side report``: JAX's keys from the two files: both means,
    ``abs_delta_db`` and ``output_fidelity_db`` (the port's estimates
    against JAX's).

    python scripts/torch_quality_crosscheck.py --side port --checkpoint CKPT \\
        --corpus .artifacts/corpus/test --npz port.npz [--n_samples 32]
    python scripts/torch_quality_crosscheck.py --side jax --checkpoint CKPT \\
        --corpus .artifacts/corpus/test --npz port.npz --jax_npz jax.npz
    python scripts/torch_quality_crosscheck.py --side report --npz port.npz \\
        --jax_npz jax.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hparams(args) -> dict:
    hp = dict(out_channels=args.out_channels, in_channels=args.in_channels,
              num_blocks=args.num_blocks, upsampling_depth=args.upsampling_depth,
              enc_kernel_size=args.enc_kernel_size, enc_num_basis=args.enc_num_basis,
              num_sources=args.num_sources)
    if args.model_type == "groupcomm_v2":
        hp["group_size"] = args.group_size
    return hp


def _loader_hparams(args) -> dict:
    return {"test_dataset_paths": [args.corpus], "n_test": args.n_samples, "fs": args.fs,
            "audio_timelength": args.timelength, "n_sources": args.num_sources}


def _batches(ds, n: int, batch_size: int):
    """(mixtures (B, T), targets (B, S, T)) of items 0..n-1, in order; a
    partial last batch is dropped, as the loaders drop it."""
    for start in range(0, n - batch_size + 1, batch_size):
        items = [ds[i] for i in range(start, start + batch_size)]
        yield (np.stack([np.asarray(m, np.float32) for m, _ in items]),
               np.stack([np.asarray(s, np.float32) for _, s in items]))


def side_port(args) -> dict:
    import torch

    from sudo_rm_rf_tpu_torch import losses, models
    from sudo_rm_rf_tpu_torch.data.setup import create_augmented_loader
    from sudo_rm_rf_tpu_torch.utils.benchmark import card_label, script_device

    device = script_device(args.device)
    model = models.load_checkpoint_model(args.model_type, _hparams(args), args.checkpoint,
                                         device)
    ds = create_augmented_loader(_loader_hparams(args), split="test")
    metric = losses.PermInvariantSISDR(n_sources=args.num_sources, zero_mean=True,
                                       backward_loss=False, improvement=True,
                                       return_individual_results=True)
    mixes, targets, ests, sisdri = [], [], [], []
    for mix, tgt in _batches(ds, args.n_samples, args.batch_size):
        m = torch.from_numpy(mix[:, None, :]).to(device)
        with torch.no_grad():
            mean = m.mean(-1, keepdim=True)
            std = m.std(-1, keepdim=True)  # ddof=1, as JAX's
            xn = (m - mean) / (std + 1e-9)
            est = model(xn)
            if args.mixture_consistency:
                est = losses.mixture_consistency(est, xn, args.mixture_consistency)
            est = est * std + mean
            sisdri += metric(est, torch.from_numpy(tgt).to(device),
                             initial_mixtures=m).cpu().tolist()
        mixes.append(mix)
        targets.append(tgt)
        ests.append(est.cpu().numpy())
    np.savez(args.npz, sisdri=np.asarray(sisdri), mixtures=np.concatenate(mixes),
             targets=np.concatenate(targets), estimates=np.concatenate(ests))
    out = {"torch_sisdri_mean": float(np.mean(sisdri)), "n_examples": len(sisdri),
           "checkpoint": args.checkpoint, "device": card_label(device)}
    print(json.dumps(out), flush=True)
    return out


def side_jax(args) -> dict:
    """The JAX package's score of the checkpoint (imports JAX: the CPU)."""
    import jax
    import jax.numpy as jnp

    from sudo_rm_rf_tpu import losses, models
    from sudo_rm_rf_tpu.data.setup import create_augmented_loader

    hp = _hparams(args)
    model = models.get_model(args.model_type, **hp)
    t = int(args.fs * args.timelength)
    template = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 1, t)))["params"]
    from sudo_rm_rf_tpu_torch.convert import checkpoint_format

    if checkpoint_format(args.checkpoint) == "torch":  # the port's own .pt
        from sudo_rm_rf_tpu_torch import models as tmodels
        from sudo_rm_rf_tpu_torch.convert import params_to_flax

        params = params_to_flax(tmodels.load_checkpoint_model(
            args.model_type, hp, args.checkpoint, "cpu"))
    else:
        from sudo_rm_rf_tpu.convert.flax_checkpoint import load_params_from_checkpoint

        params = load_params_from_checkpoint(args.checkpoint, template)
    ds = create_augmented_loader(_loader_hparams(args), split="test")
    port = np.load(args.npz)
    metric = losses.PermInvariantSISDR(n_sources=args.num_sources, zero_mean=True,
                                       backward_loss=False, improvement=True,
                                       return_individual_results=True)

    @jax.jit
    def forward(params, mixture):
        mean = jnp.mean(mixture, axis=-1, keepdims=True)
        std = jnp.std(mixture, axis=-1, keepdims=True, ddof=1)
        xn = (mixture - mean) / (std + 1e-9)
        est = model.apply({"params": params}, xn)
        if args.mixture_consistency:
            est = losses.mixture_consistency(est, xn, args.mixture_consistency)
        return est * std + mean

    ests, sisdri, i = [], [], 0
    for mix, tgt in _batches(ds, args.n_samples, args.batch_size):
        b = mix.shape[0]
        if not (np.array_equal(mix, port["mixtures"][i:i + b])
                and np.array_equal(tgt, port["targets"][i:i + b])):
            raise RuntimeError(f"the JAX loader's items {i}..{i + b - 1} differ from the port's")
        i += b
        mixture = jnp.asarray(mix[:, None, :])
        est = forward(params, mixture)
        sisdri += np.asarray(metric(est, jnp.asarray(tgt), initial_mixtures=mixture)).tolist()
        ests.append(np.asarray(est))
    np.savez(args.jax_npz, sisdri=np.asarray(sisdri), estimates=np.concatenate(ests))
    out = {"jax_sisdri_mean": float(np.mean(sisdri)), "n_examples": len(sisdri)}
    print(json.dumps(out), flush=True)
    return out


def side_report(args) -> dict:
    port, jx = np.load(args.npz), np.load(args.jax_npz)
    est_t, est_j = port["estimates"].astype(np.float64), jx["estimates"].astype(np.float64)
    fid_den = float(((est_t - est_j) ** 2).sum())
    fidelity = 10 * np.log10(float((est_t**2).sum()) / max(fid_den, 1e-30))
    j, t = float(np.mean(jx["sisdri"])), float(np.mean(port["sisdri"]))
    out = {"jax_sisdri_mean": j, "torch_sisdri_mean": t, "abs_delta_db": abs(j - t),
           "output_fidelity_db": float(fidelity), "n_examples": int(len(port["sisdri"]))}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--side", required=True, choices=("port", "jax", "report"))
    p.add_argument("--checkpoint")
    p.add_argument("--corpus")
    p.add_argument("--npz", default="quality_port.npz")
    p.add_argument("--jax_npz", default="quality_jax.npz")
    p.add_argument("--model_type", default="groupcomm_v2")
    p.add_argument("--n_samples", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--timelength", type=float, default=4.0)
    p.add_argument("--mixture_consistency", default=None)
    p.add_argument("--device", default="cuda", help="the port side's device")
    p.add_argument("--out_channels", type=int, default=256)
    p.add_argument("--in_channels", type=int, default=512)
    p.add_argument("--num_blocks", type=int, default=16)
    p.add_argument("--upsampling_depth", type=int, default=5)
    p.add_argument("--enc_kernel_size", type=int, default=21)
    p.add_argument("--enc_num_basis", type=int, default=512)
    p.add_argument("--num_sources", type=int, default=2)
    p.add_argument("--group_size", type=int, default=16)
    args = p.parse_args(argv)
    if args.side != "report" and not (args.checkpoint and args.corpus):
        p.error(f"--side {args.side} needs --checkpoint and --corpus")
    return {"port": side_port, "jax": side_jax, "report": side_report}[args.side](args)


if __name__ == "__main__":
    main()
