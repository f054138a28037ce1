"""Training-dynamics check of the PyTorch port against the JAX package.

``docs/runs/torch_training_parity`` trained Improved SuDoRM-RF U8/256 with
the JAX package's Trainer and recorded its per-epoch validation curve
(``metrics_jax.jsonl``). This script trains the same configuration with the
port, on a CUDA device, under that run's protocol
(``scripts/torch_training_crosscheck.py``):

- Improved SuDoRM-RF U8/256 (``MODEL_KW``: out 128, in 256, 8 blocks, depth
  5, 256 bases), bs4 x 300 steps x 14 epochs, 2 s at 8 kHz;
- the online remix, PIT SI-SDR clamped to +-30, gradient clip 5, Adam at
  1e-3 divided by 3 at the reference's epoch-end phase (patience 5);
- training mixtures drawn online by ``AugmentedOnlineMixingDataset`` from
  the corpus' train split at train seed 7, the loader rebuilt each epoch;
- validation on the fixed 600 mixtures of the val split at seed 42, each
  mixture standardized, served through ``improved_forward_fast(impl=
  "kernel")`` (the CUDA U-ConvBlock kernel at (4, 128, 256, 1600, 5)) and
  scored by the permutation-invariant SI-SDRi.

The corpus is ``scripts/make_synthetic_corpus.py --train_speakers 50 --utts
60`` at seed 0, written by the port's own copy
(``data.synthetic.write_hierarchical_corpus``) unless it exists. The port
starts from its own seeded init: the JAX run started from the torch
reference's init, which is not in the repo. The remix draws come from a
torch generator; the two packages share no random stream, so the curves can
agree statistically, not bit for bit.

After each epoch it appends a line to ``metrics_port<tag>.jsonl`` (keys
``epoch``, ``lr`` (the rate of the epoch's last update), ``tr_loss``,
``val_sisdri``, ``wall_s``), writes ``run_port<tag>.json`` (train seed,
card, torch version, K1 launches a validation) and saves the run as a
msgpack TrainState (the JAX package's layout) with a sidecar of the remix
generator's state, so ``--resume`` continues where a run stopped.
``--report`` holds ``metrics_port.jsonl`` to the pass bounds against
``metrics_jax.jsonl``, compares every port run with both JAX seeds and
their band, and writes ``summary.json`` and ``README.md``. Imports the port
only:

    python scripts/torch_port_convergence.py                    # seed 7
    python scripts/torch_port_convergence.py --train_seed 8 --tag _seed8
    python scripts/torch_port_convergence.py --resume           # go on
    python scripts/torch_port_convergence.py --report
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT_DEFAULT = os.path.join(REPO, "docs/runs/torch_port_convergence")
JAX_RUNS = os.path.join(REPO, "docs/runs/torch_training_parity")
CORPUS = os.path.join(REPO, ".artifacts/corpus")
STATE_DIR = os.path.join(REPO, ".artifacts/torch_port_convergence")
# the operating point and protocol of scripts/torch_training_crosscheck.py
MODEL_KW = dict(out_channels=128, in_channels=256, num_blocks=8, upsampling_depth=5,
                enc_kernel_size=21, enc_num_basis=256, num_sources=2)
FS, SECS, BS = 8000, 2.0, 4
N_TRAIN, N_VAL, N_EPOCHS = 1200, 600, 14
LR, DIVIDE_LR_BY, PATIENCE = 1e-3, 3.0, 5
CLIP_GRAD_NORM, LOSS_CLAMP = 5.0, 30.0
VAL_SEED, TRAIN_SEED, INIT_SEED = 42, 7, 0
# the corpus of docs/runs/improved_u16_synth/README.md
CORPUS_KW = dict(train_speakers=50, val_speakers=10, test_speakers=10, utts=60, val_utts=20,
                 fs=FS, seconds=4.0, seed=0)
# ROADMAP queue 1, item 3: the reference-vs-JAX figures of
# docs/runs/torch_training_parity/summary.json
PASS_MEAN_ABS_DB, PASS_MAX_ABS_DB = 0.257, 0.705


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read (no nvidia-smi)"


def _stem(path: str) -> str:
    """``metrics_port_seed8.jsonl`` -> ``port_seed8``."""
    return os.path.basename(path)[len("metrics_"):-len(".jsonl")]


def _runs(directory: str, side: str) -> dict:
    """The curves ``metrics_<side>*.jsonl`` in ``directory`` by stem, the
    untagged run first."""
    paths = sorted(glob.glob(os.path.join(directory, f"metrics_{side}*.jsonl")),
                   key=lambda p: (_stem(p) != side, p))
    return {_stem(p): _rows(p) for p in paths}


def _corpus(root: str) -> str:
    from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus

    if not all(os.path.isdir(os.path.join(root, s)) for s in ("train", "val")):
        t0 = time.time()
        write_hierarchical_corpus(root, **CORPUS_KW)
        print(f"corpus written to {root} in {time.time() - t0:.1f} s", flush=True)
    return root


def train(args) -> None:
    import torch

    from sudo_rm_rf_tpu_torch import losses, models
    from sudo_rm_rf_tpu_torch.convert import load_train_state_from_checkpoint, save_train_state
    from sudo_rm_rf_tpu_torch.data.hierarchical import AugmentedOnlineMixingDataset
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
    from sudo_rm_rf_tpu_torch.ops import uconv as U
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix, normalize_wav

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    # fp32 is compared with fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}; torch {torch.__version__}", flush=True)

    corpus = _corpus(args.corpus)
    train_ds = AugmentedOnlineMixingDataset(
        input_dataset_p=[os.path.join(corpus, "train")], datasets_priors=[1.0],
        sample_rate=FS, selected_timelength=SECS, n_samples=args.n_train, seed=args.train_seed)
    val_ds = AugmentedOnlineMixingDataset(
        input_dataset_p=[os.path.join(corpus, "val")], datasets_priors=[1.0], sample_rate=FS,
        selected_timelength=SECS, n_samples=N_VAL, fixed_seed=VAL_SEED)
    val_mix, val_src = map(np.stack, zip(*(val_ds[i] for i in range(N_VAL))))
    val_mix = normalize_wav(torch.from_numpy(val_mix)).to(device)
    val_src = torch.from_numpy(val_src).to(device)

    model = models.get_model("relu", **MODEL_KW, block_impl=args.block_impl, device=device,
                             generator=torch.Generator().manual_seed(INIT_SEED))
    trainer = Trainer(model, TrainerConfig(
        learning_rate=LR, divide_lr_by=DIVIDE_LR_BY, patience_epochs=PATIENCE,
        steps_per_epoch=args.n_train // BS, clip_grad_norm=CLIP_GRAD_NORM,
        loss_clamp=LOSS_CLAMP, lr_decay_at_epoch_end=True))
    state = trainer.init_state()
    generator = torch.Generator().manual_seed(args.train_seed)
    sisdri = losses.PermInvariantSISDR(n_sources=2, zero_mean=True, backward_loss=False,
                                       improvement=True, return_individual_results=True)

    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.state_dir, exist_ok=True)
    metrics_path = os.path.join(args.out, f"metrics_port{args.tag}.jsonl")
    ckpt = os.path.join(args.state_dir, f"train_state{args.tag}")
    start, wall0, rows = 0, 0.0, []
    if args.resume and os.path.exists(ckpt):
        state = load_train_state_from_checkpoint(ckpt, model, state.optimizer)
        with open(ckpt + ".json") as fh:
            side = json.load(fh)
        generator.set_state(torch.tensor(bytearray.fromhex(side["remix_generator"]),
                                         dtype=torch.uint8))
        start, wall0 = side["epoch"], side["wall_s"]
        rows = _rows(metrics_path)[:start]
        print(f"resumed after epoch {start}: step {state.step}", flush=True)

    t0 = time.time() - wall0
    val_launches = 0
    for epoch in range(start, args.epochs):
        train_ds.set_epoch(epoch)
        # a new loader each epoch, as the JAX run built one
        gen = train_ds.get_generator(batch_size=BS, shuffle=True, num_workers=2)
        tr_losses = []
        for batch in gen:
            state, m = trainer.train_step(state, batch[-1], draw_remix(generator, BS, 2))
            tr_losses.append(m["loss"])
        lr = trainer.schedule(state.step - 1)
        tr_loss = float(torch.stack(tr_losses).mean())

        U.fused_uconv_block.launches = 0
        accs = []
        with torch.no_grad():
            for i in range(0, N_VAL, BS):
                mix = val_mix[i: i + BS, None, :]
                est = improved_forward_fast(model, mix, impl="kernel" if device.type == "cuda"
                                            else "fma")
                accs.append(sisdri(est, val_src[i: i + BS], initial_mixtures=mix))
        val_launches = U.fused_uconv_block.launches
        row = {"epoch": epoch + 1, "lr": lr, "tr_loss": tr_loss,
               "val_sisdri": float(torch.cat(accs).mean()), "wall_s": round(time.time() - t0, 1)}
        rows.append(row)
        with open(metrics_path, "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in rows)
        save_train_state(state, ckpt)
        with open(ckpt + ".json", "w") as fh:
            json.dump({"epoch": epoch + 1, "wall_s": row["wall_s"],
                       "remix_generator": bytes(generator.get_state().tolist()).hex()}, fh)
        with open(os.path.join(args.out, f"run_port{args.tag}.json"), "w") as fh:
            json.dump({"train_seed": args.train_seed, "card": card, "torch": torch.__version__,
                       "block_impl": args.block_impl,
                       "k1_launches_per_validation": val_launches}, fh, indent=1)
        print("port", json.dumps(row), f"K1 launches in validation {val_launches}",
              flush=True)


def _compare(port: list, jax: list) -> dict:
    """Per-epoch val SI-SDRi deltas (port - JAX) over the common epochs."""
    n = min(len(port), len(jax))
    d = np.array([port[i]["val_sisdri"] - jax[i]["val_sisdri"] for i in range(n)])
    return {"epochs": n, "mean_delta_db": round(float(d.mean()), 3),
            "mean_abs_delta_db": round(float(np.abs(d).mean()), 3),
            "max_abs_delta_db": round(float(np.abs(d).max()), 3),
            "epochs_above": int((d > 0).sum())}


def report(args) -> dict:
    jax_runs = _runs(args.jax_runs, "jax")
    port_runs = _runs(args.out, "port")
    jax_rows, port = jax_runs["jax"], port_runs["port"]
    with open(os.path.join(args.jax_runs, "summary.json")) as fh:
        parity = json.load(fh)
    main_cmp = _compare(port, jax_rows)
    n = main_cmp["epochs"]
    summary = {
        "epochs": n,
        "max_abs_delta_db": main_cmp["max_abs_delta_db"],
        "mean_abs_delta_db": main_cmp["mean_abs_delta_db"],
        "mean_delta_db": main_cmp["mean_delta_db"],
        "final_port_db": round(port[n - 1]["val_sisdri"], 3),
        "final_jax_db": round(jax_rows[n - 1]["val_sisdri"], 3),
        "port_wall_s": port[n - 1]["wall_s"],
        "jax_wall_s": jax_rows[n - 1]["wall_s"],
        "pass_mean_abs_db": PASS_MEAN_ABS_DB,
        "pass_max_abs_db": PASS_MAX_ABS_DB,
    }
    summary["passed"] = bool(n == N_EPOCHS and summary["mean_abs_delta_db"] <= PASS_MEAN_ABS_DB
                             and summary["max_abs_delta_db"] <= PASS_MAX_ABS_DB)
    # every port run against each JAX seed and against the band of the two
    m = min(len(r) for r in (*jax_runs.values(), *port_runs.values()))
    jv = np.array([[r[i]["val_sisdri"] for i in range(m)] for r in jax_runs.values()])
    lo, hi, mid = jv.min(0), jv.max(0), jv.mean(0)
    runs = {}
    for stem, rows in port_runs.items():
        run_file = os.path.join(args.out, f"run_{stem}.json")
        meta = {}
        if os.path.exists(run_file):
            with open(run_file) as fh:
                meta = json.load(fh)
        v = np.array([rows[i]["val_sisdri"] for i in range(m)])
        vs = {j: _compare(rows, jr) for j, jr in jax_runs.items()}
        runs[stem] = {
            "train_seed": meta.get("train_seed"), "card": meta.get("card"),
            "final_db": round(rows[-1]["val_sisdri"], 3), "wall_s": rows[-1]["wall_s"],
            "vs": vs, "passes_vs_jax": bool(
                vs["jax"]["epochs"] == N_EPOCHS
                and vs["jax"]["mean_abs_delta_db"] <= PASS_MEAN_ABS_DB
                and vs["jax"]["max_abs_delta_db"] <= PASS_MAX_ABS_DB),
            "epochs_in_jax_band": int(((v >= lo) & (v <= hi)).sum()),
            "mean_delta_vs_jax_mid_db": round(float((v - mid).mean()), 3)}
    summary["band_epochs"] = m
    summary["runs"] = runs
    # |delta| between port runs: of two seeds (seed spread), or of one seed
    # run twice (run-to-run spread: cuDNN's and atomic sums' order)
    spreads = {"seed": [], "rerun": []}
    for i, a in enumerate(port_runs):
        for b in list(port_runs)[i + 1:]:
            d = [abs(port_runs[a][e]["val_sisdri"] - port_runs[b][e]["val_sisdri"])
                 for e in range(m)]
            same = runs[a]["train_seed"] == runs[b]["train_seed"]
            spreads["rerun" if same else "seed"].append(d)
    for kind, ds in spreads.items():
        if ds:
            summary[f"port_{kind}_spread_mean_db"] = round(float(np.mean(ds)), 3)
            summary[f"port_{kind}_spread_max_db"] = round(float(np.max(ds)), 3)
    summary.update(jax_seed_spread_max_db=parity["jax_seed_spread_max_db"],
                   jax_seed_spread_mean_db=parity["jax_seed_spread_mean_db"])

    cards = sorted({r["card"] for r in runs.values() if r["card"]})
    lines = [
        "# torch_port_convergence: the PyTorch port's training against the JAX package",
        "",
        "`scripts/torch_port_convergence.py` trains Improved SuDoRM-RF U8/256 with the",
        "port on one H100 under the protocol of `../torch_training_parity` (bs4 x 300",
        "steps x 14 epochs, 2 s at 8 kHz, LR 1e-3 / 3 at the epoch-end phase, patience",
        "5, clip 5, clamp 30, the fixed 600-mixture val set at seed 42) on the",
        "50-speaker synthetic corpus, from the port's own seeded init. Validation runs",
        "through the CUDA U-ConvBlock kernel. The JAX curves are that run's",
        "`metrics_jax.jsonl` and `metrics_jax_seed8.jsonl` (the JAX Trainer on a TPU,",
        "from the torch reference's init).",
        "",
        "Each `metrics_port<tag>.jsonl` is one run of the port, and `run_port<tag>.json`",
        "names its train seed and card.",
        "",
        f"Card: {'; '.join(cards) or 'not recorded'}.",
        "",
        "| epoch | JAX val SI-SDRi (dB) | port val SI-SDRi (dB) | delta (dB) |",
        "|---|---|---|---|",
    ]
    lines += [f"| {i + 1} | {jax_rows[i]['val_sisdri']:.3f} | {port[i]['val_sisdri']:.3f} "
              f"| {port[i]['val_sisdri'] - jax_rows[i]['val_sisdri']:+.3f} |" for i in range(n)]
    lines += ["", f"`metrics_port.jsonl` against `metrics_jax.jsonl`: mean |delta| "
              f"{summary['mean_abs_delta_db']} dB (pass <= {PASS_MEAN_ABS_DB}), max |delta| "
              f"{summary['max_abs_delta_db']} dB (pass <= {PASS_MAX_ABS_DB}), signed mean "
              f"{summary['mean_delta_db']:+} dB over {n} epochs: "
              f"{'passed' if summary['passed'] else 'missed'}. The port's wall clock on the "
              f"card: {summary['port_wall_s']} s (`jax_wall_s` in `summary.json` is the JAX "
              "run's, on a TPU).", "",
              "| port run | train seed | vs JAX | mean delta (dB) | mean abs delta | "
              "max abs delta | epochs above | final (dB) |", "|---|---|---|---|---|---|---|---|"]
    for stem, r in runs.items():
        lines += [f"| `{stem}` | {r['train_seed']} | `{j}` | {c['mean_delta_db']:+} | "
                  f"{c['mean_abs_delta_db']} | {c['max_abs_delta_db']} | "
                  f"{c['epochs_above']}/{c['epochs']} | {r['final_db']} |"
                  for j, c in r["vs"].items()]
    lines += ["", f"{sum(r['passes_vs_jax'] for r in runs.values())} of {len(runs)} port runs "
              "meet both bounds against `metrics_jax.jsonl`."]
    lines += ["", f"Against the band of the two JAX seeds over {m} epochs: " + "; ".join(
        f"`{s}` {r['epochs_in_jax_band']} epochs inside, mean delta from its middle "
        f"{r['mean_delta_vs_jax_mid_db']:+} dB" for s, r in runs.items()) + "."]
    spread_text = [f"{what} mean {summary[f'port_{kind}_spread_mean_db']} dB, max "
                   f"{summary[f'port_{kind}_spread_max_db']} dB"
                   for kind, what in (("seed", "between port runs of two seeds"),
                                      ("rerun", "between port runs of one seed"))
                   if f"port_{kind}_spread_mean_db" in summary]
    lines += ["", "Spread of |delta| per epoch: " + "; ".join(
        spread_text + [f"between the JAX package's seeds (`../torch_training_parity/"
                       f"summary.json`) mean {summary['jax_seed_spread_mean_db']}, max "
                       f"{summary['jax_seed_spread_max_db']}"]) + "."]
    lines += ["", "Reproduce (the corpus is written on first use, into the gitignored "
              "`.artifacts/`):", "", "```",
              "python scripts/torch_port_convergence.py",
              "python scripts/torch_port_convergence.py --train_seed 8 --tag _seed8",
              "python scripts/torch_port_convergence.py --report", "```"]
    with open(os.path.join(args.out, "README.md"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT_DEFAULT)
    ap.add_argument("--corpus", default=CORPUS)
    ap.add_argument("--state_dir", default=STATE_DIR,
                    help="where the msgpack TrainState and its sidecar are kept")
    ap.add_argument("--jax_runs", default=JAX_RUNS,
                    help="the dir of metrics_jax*.jsonl and the parity summary.json")
    ap.add_argument("--train_seed", type=int, default=TRAIN_SEED)
    ap.add_argument("--tag", default="", help="suffix of metrics_port<tag>.jsonl")
    ap.add_argument("--epochs", type=int, default=N_EPOCHS)
    ap.add_argument("--n_train", type=int, default=N_TRAIN)
    ap.add_argument("--block_impl", default="xla", choices=["xla", "fma"],
                    help="the blocks trained through (both fp32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--report", action="store_true",
                    help="compare the port's curves with JAX's and write the report")
    args = ap.parse_args(argv)
    if args.report:
        report(args)
    else:
        train(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
