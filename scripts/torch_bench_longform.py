"""Long-recording serving bench of the PyTorch port: overlap-add against the
exact one-pass engine (port-side copy of ``scripts/bench_longform.py``,
which imports JAX).

Separates one seeded white-noise mixture of each ``--seconds`` (default 60
s and 10 minutes at 8 kHz) with the flagship Improved U16/512 (``--gc``:
GroupComm v2 U16/512, group 16), seeded random weights:

  * ``OverlapAddSeparator`` (4 s chunks at 50 % hop, batches of 8, per-chunk
    source realignment) through the serving forward of ``sudo-torch-separate``
    (``impl="kernel"``, K1, on a card);
  * ``SequenceParallelSeparator`` on one rank: on a card the serving
    forward through K1 on the padded signal (in ``--compute_dtype`` too),
    on the CPU the shard body.

Each row: seconds per recording and audio-s/s (host clock over ``--reps``
separations after one warm-up, the host's blending included), the peak of
``torch.cuda.max_memory_allocated`` over them, K1 launches in one
separation, the route, and for the exact pass its fidelity in dB against
the unsharded ``fma`` forward (``fma_merged`` for GroupComm) on the same
padded signal, in the same ``--compute_dtype`` and in fp32.

    python scripts/torch_bench_longform.py [--seconds 60 600] [--gc]
        [--compute_dtype bfloat16] [--reps 3] [--out rows.jsonl]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fidelity_db(ref, est) -> float:
    import numpy as np

    ref, est = ref.astype(np.float64), est.astype(np.float64)
    err = float(((ref - est) ** 2).sum())
    return float("inf") if err == 0.0 else float(10 * np.log10((ref**2).sum() / err))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, nargs="+", default=[60.0, 600.0])
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--gc", action="store_true",
                   help="bench GroupComm v2 U16/512 (group 16) instead")
    p.add_argument("--compute_dtype", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="append the rows to this JSON-lines file")
    p.add_argument("--tiny", action="store_true",
                   help="tiny config for a CPU rehearsal (not a benchmark)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator, SequenceParallelSeparator
    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    card = "cpu (not a device measurement)"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        card = card.splitlines()[0]
        print(card)
    if args.tiny:
        dims = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
                    enc_kernel_size=17, enc_num_basis=16)
    else:
        dims = dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
                    enc_kernel_size=21, enc_num_basis=512)
    model_type = "groupcomm_v2" if args.gc else "relu"
    hp = dict(dims, num_sources=2)
    if args.gc:
        hp["group_size"] = 4 if args.tiny else 16
    fast = fi.groupcomm_forward_fast if args.gc else fi.improved_forward_fast
    plain = "fma_merged" if args.gc else "fma"
    model = models.get_model(model_type, **hp, device=device,
                             generator=torch.Generator().manual_seed(args.seed)).eval()
    cdt = args.compute_dtype
    ola_impl = "kernel" if cuda else plain
    ola_model = fi.cast_model(model, cdt, ola_impl)
    ola_fwd = functools.partial(fast, ola_model, impl=ola_impl, compute_dtype=cdt)

    rows = []
    for seconds in args.seconds:
        t = int(seconds * args.fs)
        mixture = np.random.default_rng(args.seed).standard_normal(t).astype(np.float32)
        engines = {
            "overlap_add": OverlapAddSeparator(model, chunk_samples=4 * args.fs,
                                               num_sources=2, batch_chunks=8,
                                               forward_fn=ola_fwd),
            "seq_parallel": SequenceParallelSeparator(model, compute_dtype=cdt),
        }
        for name, sep in engines.items():
            U.fused_uconv_block.launches = 0
            est = sep.separate(mixture)  # warm-up, launches counted
            launches = U.fused_uconv_block.launches
            if not np.isfinite(est).all() or est.shape != (2, t):
                raise RuntimeError(f"{name}: bad output {est.shape}")
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                est = sep.separate(mixture)
            dt = (time.perf_counter() - t0) / args.reps
            row = dict(engine=name, model=model_type, recording_s=seconds,
                       compute_dtype=cdt or "float32", device=card,
                       seconds_per_recording=dt, audio_sec_per_sec=seconds / dt,
                       peak_mib=(torch.cuda.max_memory_allocated(device) / 2**20
                                 if cuda else None),
                       k1_launches=launches,
                       route=getattr(sep, "route", None) or f"overlap_add({ola_impl})")
            if name == "seq_parallel":
                mean, std = float(mixture.mean()), float(mixture.std(ddof=1))
                padded = np.zeros(sep._padded_len(t), np.float32)
                padded[:t] = (mixture - mean) / (std + 1e-9)
                x = torch.from_numpy(padded).to(device)[None, None]
                for key, dtype in (("fidelity_db", cdt), ("fidelity_fp32_db", None)):
                    ref = fast(model, x, impl=plain, compute_dtype=dtype)
                    ref = ref[0, :, :t].cpu().numpy() * std + mean
                    row[key] = fidelity_db(ref, est)
                    del ref
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
    raise SystemExit(0)
