#!/usr/bin/env python
"""Quickstart of the PyTorch port: train a tiny separator on synthetic
tones, then separate a 10x-longer recording with the overlap-add runtime
(the port's copy of ``examples/quickstart.py``). Runs on the card by
default; ``--device cpu`` runs it on the CPU.

    python examples/torch_quickstart.py [--device cuda] [--steps 200]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SR, T = 8000, 1024


def band_sources(rng, b):
    t = np.arange(T) / SR
    src = np.zeros((b, 2, T), np.float32)
    for i in range(b):
        src[i, 0] = np.sin(2 * np.pi * rng.uniform(80, 200) * t)
        src[i, 1] = np.sin(2 * np.pi * rng.uniform(1500, 3000) * t)
    return src


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=200)
    args = p.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import losses, models
    from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig
    from sudo_rm_rf_tpu_torch.utils.benchmark import card_label, script_device

    device = script_device(args.device)
    model = models.SuDORMRFImproved(
        out_channels=24, in_channels=48, num_blocks=2, upsampling_depth=3,
        enc_kernel_size=21, enc_num_basis=32, num_sources=2, block_impl="fma",
        device=device, generator=torch.Generator().manual_seed(0),
    )
    trainer = Trainer(model, TrainerConfig(learning_rate=2e-3),
                      prepare_batch=lambda draws, b: (b.sum(1, keepdim=True), b))
    rng = np.random.default_rng(0)
    state = trainer.init_state()
    losses_seen = []
    for step in range(args.steps):
        batch = torch.from_numpy(band_sources(rng, 8)).to(device)
        state, m = trainer.train_step(state, batch, None)
        if step % 50 == 0 or step == args.steps - 1:
            losses_seen.append(float(m["loss"]))
            print(f"step {step}: loss {losses_seen[-1]:.2f}")

    # separate a 10x-longer mixture
    t = np.arange(T * 10) / SR
    mixture = np.sin(2 * np.pi * 150 * t) + np.sin(2 * np.pi * 2200 * t)
    sep = OverlapAddSeparator(model.eval(), chunk_samples=T, num_sources=2)
    est = sep.separate(mixture.astype(np.float32))

    metric = losses.PermInvariantSISDR(n_sources=2, zero_mean=True, backward_loss=False)
    truth = np.stack([np.sin(2 * np.pi * 150 * t), np.sin(2 * np.pi * 2200 * t)])
    score = float(metric(torch.from_numpy(np.asarray(est, np.float32)[None]),
                         torch.from_numpy(truth[None].astype(np.float32))))
    print(f"long-mixture SI-SDR: {score:.1f} dB")
    out = {"steps": args.steps, "losses": losses_seen, "long_mixture_si_sdr_db": score,
           "device": card_label(device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
