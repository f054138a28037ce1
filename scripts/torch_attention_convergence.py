"""Short at-scale convergence runs of the attention families with the
PyTorch port, on a CUDA device: the port's counterpart of
``scripts/attention_convergence.py``, under its protocol.

  * attention_v2 / attention_v3: the reference parser's defaults (out 128,
    U16/512, depth 5, 4 heads of 256 dims, dropout 0.1 in train steps),
    bs4, the loss clamped to +-30;
  * sepformer: the published SpeechBrain configuration (25.68 M params),
    bs1 (the published batch), the loss unclamped (a fresh SepFormer starts
    past the reference's +-30 clamp);
  * Adam at 1e-3, gradient clip 5, PIT SI-SDR, the online remix; 300 steps
    of 4 s at 8 kHz, fp32 (TF32 off);
  * mixtures drawn online by ``AugmentedOnlineMixingDataset`` from the
    train split of the hierarchical synthetic corpus of
    ``docs/runs/improved_u16_synth/README.md`` (50 x 60 utterances, seed 0),
    written by the port's ``data.synthetic.write_hierarchical_corpus``
    (byte for byte ``scripts/make_synthetic_corpus.py``'s files) unless it
    exists.

The port starts from its own seeded init and draws its remixes from a torch
generator: it shares no random stream with the JAX run, so the curves can
agree in trend, not step by step. Writes ``loss_curve.jsonl`` (step,
tr_loss) and ``summary.json`` (the JAX script's keys plus the card, torch,
seeds and the JAX run's summary beside, where ``docs/runs/<model>_synth``
has one). Imports the port only:

    python scripts/torch_attention_convergence.py --model sepformer \\
        [--steps 300] [--out docs/runs/torch_sepformer_synth]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FS, SECS, LR = 8000, 4.0, 1e-3
INIT_SEED, REMIX_SEED, DATA_SEED = 0, 1, 0
CORPUS = os.path.join(REPO, ".artifacts/corpus")
CORPUS_KW = dict(train_speakers=50, val_speakers=10, test_speakers=10, utts=60, val_utts=20,
                 fs=FS, seconds=SECS, seed=0)
ATTENTIVE = dict(out_channels=128, in_channels=512, num_blocks=16, upsampling_depth=5,
                 enc_kernel_size=21, enc_num_basis=512, num_sources=2, n_heads=4,
                 att_dims=256, att_dropout=0.1, scan_blocks=True)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read (no nvidia-smi)"


def _corpus(root: str) -> str:
    from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus

    if not os.path.isdir(os.path.join(root, "train")):
        t0 = time.time()
        write_hierarchical_corpus(root, **CORPUS_KW)
        print(f"corpus written to {root} in {time.time() - t0:.1f} s", flush=True)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True,
                    choices=["attention_v2", "attention_v3", "sepformer"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--bs", type=int, default=None,
                    help="default: 1 for sepformer (its published batch), else 4")
    ap.add_argument("--corpus", default=CORPUS)
    ap.add_argument("--out", default=None, help="default: docs/runs/torch_<model>_synth")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.data.hierarchical import AugmentedOnlineMixingDataset
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}; torch {torch.__version__}", flush=True)

    init = torch.Generator().manual_seed(INIT_SEED)
    if args.model == "sepformer":
        model = models.get_model("sepformer", scan_layers=True, generator=init, device=device)
        bs = args.bs or 1
        loss_clamp, train_dropout = 0.0, False
    else:
        model = models.get_model(args.model, **ATTENTIVE, generator=init, device=device)
        bs = args.bs or 4
        loss_clamp, train_dropout = 30.0, True
    n_params = sum(p.numel() for p in model.parameters())
    corpus = _corpus(args.corpus)
    ds = AugmentedOnlineMixingDataset(
        input_dataset_p=[os.path.join(corpus, "train")], datasets_priors=[1.0],
        sample_rate=FS, selected_timelength=SECS, n_samples=args.steps * bs, seed=DATA_SEED)
    trainer = Trainer(model, TrainerConfig(learning_rate=LR, loss_clamp=loss_clamp,
                                           train_dropout=train_dropout))
    state = trainer.init_state()
    remix = torch.Generator().manual_seed(REMIX_SEED)

    out = args.out or os.path.join(REPO, "docs", "runs", f"torch_{args.model}_synth")
    os.makedirs(out, exist_ok=True)
    losses = []
    t0 = time.time()
    for batch in ds.get_generator(batch_size=bs, shuffle=True, num_workers=2):
        state, m = trainer.train_step(state, batch[-1], draw_remix(remix, bs, 2))
        losses.append(m["loss"])
        if len(losses) % 25 == 0:
            print(f"step {len(losses)}: loss {float(losses[-1]):.3f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if len(losses) >= args.steps:
            break
    losses = [float(v) for v in losses]
    wall = time.time() - t0

    with open(os.path.join(out, "loss_curve.jsonl"), "w") as fh:
        for i, v in enumerate(losses):
            fh.write(json.dumps({"step": i + 1, "tr_loss": v}) + "\n")
    k = max(len(losses) // 10, 1)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    summary = {
        "model": args.model, "bs": bs, "steps": len(losses), "train_dropout": train_dropout,
        "compute_dtype": "float32", "loss_clamp": loss_clamp,
        "first_mean_loss": round(first, 3), "last_mean_loss": round(last, 3),
        "improved": bool(last < first), "finite": bool(np.isfinite(losses).all()),
        "wall_s": round(wall, 1), "ms_per_step": round(1e3 * wall / max(len(losses), 1), 1),
        "params": n_params, "card": card, "torch": torch.__version__,
        "seeds": {"init": INIT_SEED, "remix": REMIX_SEED, "data": DATA_SEED},
    }
    jax_summary = os.path.join(REPO, "docs", "runs", f"{args.model}_synth", "summary.json")
    if os.path.exists(jax_summary):
        with open(jax_summary) as fh:
            summary["jax_run"] = json.load(fh)
    with open(os.path.join(out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if summary["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
