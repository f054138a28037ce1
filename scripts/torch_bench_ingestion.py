"""Input-pipeline bench of the PyTorch port: does the loader keep up with the
training step? (Port-side copy of ``scripts/bench_ingestion.py``, which
imports JAX.)

Three ways to feed the same train step (Improved U16/512 at out 128, the
``fma`` blocks in bf16, bs8, the WSJ0 remix and PIT loss of
``sudo-torch-train``):

  1. step_only: one batch resident on the device, reused: the rate the
     input pipeline must sustain;
  2. hier_files+train: ``AugmentedOnlineMixingDataset`` (a joblib read per
     source and the online mixing on the host) through the threaded loader;
  3. shards+train: the same items packed into shard files first
     (``data/shards.py``: one pread a record).

A mode keeps up when its ms a step is within a few per cent of step_only.
Each row is host-clock ms a step over ``--steps`` steps that end in a
synchronize, after warm-up steps; ``--loader_only`` times the loaders
without a step. The corpus is ``--corpus`` (a hierarchical ``train`` root)
or a synthetic one written from ``--seed`` (12 speakers of 8 utterances;
noise under ``--tiny``). Prints one JSON row a mode.

    python scripts/torch_bench_ingestion.py [--corpus DIR] [--steps 60]
        [--batch_size 8] [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Sources:
    """The hierarchical items' (S, T) sources as single-field records."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (self.ds[i][1],)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--corpus", default=None, help="a hierarchical train root")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--timelength", type=float, default=4.0)
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--loader_only", action="store_true",
                   help="time the loaders alone, without a train step")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="toy widths and lengths for a CPU rehearsal (not a benchmark)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from sudo_rm_rf_tpu_torch.config import ModelConfig
    from sudo_rm_rf_tpu_torch.data.hierarchical import AugmentedOnlineMixingDataset
    from sudo_rm_rf_tpu_torch.data.shards import ShardedDataset, pack_dataset
    from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus
    from sudo_rm_rf_tpu_torch.prep.hierarchical import _dump_sample
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix
    from sudo_rm_rf_tpu_torch.utils.benchmark import card_label

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    card = card_label(device)
    bs, steps = args.batch_size, args.steps
    n_samples = (steps + 5) * bs
    with tempfile.TemporaryDirectory() as tmp:
        corpus = args.corpus
        if corpus is None and args.tiny:  # noise utterances: the voices take seconds each
            corpus = os.path.join(tmp, "corpus")
            rng = np.random.default_rng(args.seed)
            for i in range(6):
                _dump_sample(os.path.join(corpus, f"spk{i // 2}", f"utt{i % 2}"),
                             rng.standard_normal(int(args.fs * (args.timelength + 1.0)))
                             .astype(np.float32))
        elif corpus is None:
            corpus = os.path.join(write_hierarchical_corpus(
                os.path.join(tmp, "corpus"), train_speakers=12, val_speakers=0,
                test_speakers=0, utts=8, val_utts=0, fs=args.fs,
                seconds=args.timelength + 1.0, seed=args.seed), "train")
        ds = AugmentedOnlineMixingDataset(
            input_dataset_p=[corpus], datasets_priors=[1.0], n_sources=2,
            n_samples=n_samples, sample_rate=args.fs, selected_timelength=args.timelength,
            fixed_seed=17)
        t0 = time.perf_counter()
        index = pack_dataset(_Sources(ds, n_samples), os.path.join(tmp, "shards"), name="bench")
        pack_s = time.perf_counter() - t0
        loaders = {
            "hier_files": lambda: ds.get_generator(batch_size=bs, num_workers=args.workers,
                                                   shuffle=False),
            "shards": lambda: ShardedDataset(index).get_generator(
                batch_size=bs, num_workers=args.workers, shuffle=False),
        }
        base = dict(batch_size=bs, steps=steps, device=card, pack_s=pack_s)
        rows = []
        if args.loader_only:
            for mode, make in loaders.items():
                it = iter(make())
                for _ in range(4):  # warm the prefetch queue and the page cache
                    next(it)
                t0 = time.perf_counter()
                for _ in range(steps):
                    next(it)
                dt = time.perf_counter() - t0
                rows.append(dict(base, mode=mode, batches_per_s=steps / dt,
                                 ms_per_batch=1e3 * dt / steps))
                print(json.dumps(rows[-1]), flush=True)
            return rows

        dims = (dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
                     enc_num_basis=16) if args.tiny else
                dict(out_channels=128, in_channels=512, num_blocks=16, enc_num_basis=512))
        model = ModelConfig(model_type="relu", num_sources=2, block_impl="fma", **dims).build(
            device=device, generator=torch.Generator().manual_seed(args.seed))
        trainer = Trainer(model, TrainerConfig(compute_dtype="bfloat16"))
        state = trainer.init_state()
        draws = torch.Generator().manual_seed(args.seed + 1)

        def run(batches):
            """ms a step through train_step, to a synchronize."""
            t0 = time.perf_counter()
            n = 0
            for batch in batches:
                if isinstance(batch, tuple):
                    batch = batch[-1]
                trainer.train_step(state, batch, draw_remix(draws, bs, 2))
                n += 1
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return 1e3 * (time.perf_counter() - t0) / n

        resident = torch.from_numpy(np.stack([ds[i][1] for i in range(bs)])).to(device)
        run([resident] * 4)  # warm-up
        step_only = run([resident] * steps)
        rows.append(dict(base, mode="step_only", ms_per_step=step_only))
        for mode, make in loaders.items():
            it = iter(make())
            run([next(it) for _ in range(4)])
            ms = run(next(it) for _ in range(steps))
            rows.append(dict(base, mode=f"{mode}+train", ms_per_step=ms,
                             overhead_vs_step_only_pct=100 * (ms / step_only - 1)))
        for row in rows:
            row["steps_per_s"] = 1e3 / row["ms_per_step"]
            print(json.dumps(row), flush=True)
        return rows


if __name__ == "__main__":
    main()
