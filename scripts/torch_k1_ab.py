"""Compare the PyTorch port's U-ConvBlock kernel (K1) and its serving
forwards between two source trees, in turns, on one CUDA card.

    python scripts/torch_k1_ab.py --trees OLD NEW            # turns 0 1 1 0
    python scripts/torch_k1_ab.py --trees OLD NEW --order 0 1 1 0 --reps 50

Each turn is a process of its own with ``PYTHONPATH`` set to one tree, so it
imports (and builds K1 from) that tree's ``sudo_rm_rf_tpu_torch``. With TF32
off it measures, by CUDA events (median of ``--reps`` calls after warm-up):

* K1 alone at the flagship block (4, 256, 512, 3200, 5) and at the U36
  WHAMR! block (4, 512, 512, 6400, 5): its time, and its error against a
  float64 plain block on the same input (max and rms), beside the fp32
  plain block's;
* the bs4 fp32 ``kernel`` serving forward of Improved U16/512 and GroupComm
  U16/512 (group 16) on 4 s at 8 kHz, and of Improved U36/Bases4096 on 4 s
  at 16 kHz, seeded random weights.

It prints the card's name and power limit, one JSON line per turn, and last
a JSON summary: per tree, each number's values over its turns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

FLAGSHIP = dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
                enc_kernel_size=21, enc_num_basis=512, num_sources=2)
GROUPCOMM = dict(FLAGSHIP, group_size=16)
U36 = dict(out_channels=512, in_channels=512, num_blocks=36, upsampling_depth=5,
           enc_kernel_size=21, enc_num_basis=4096, num_sources=2)
BLOCKS = {"flagship": (4, 256, 512, 3200, 5), "u36": (4, 512, 512, 6400, 5)}
FORWARDS = {"improved_u16": ("relu", FLAGSHIP, 8000), "groupcomm_u16": ("groupcomm_v2",
                                                                        GROUPCOMM, 8000),
            "improved_u36_16k": ("relu", U36, 16000)}
BATCH, SECONDS = 4, 4.0


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Median device time (ms) of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_params(torch, depth, ci, co, seed):
    """Seeded U-ConvBlock params in the kernel's dict layout, on the card."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    u = lambda *s: 0.5 + torch.rand(*s, generator=g)  # noqa: E731
    p = dict(proj_w=r(ci, co) * co**-0.5, proj_b=r(ci) * 0.1, proj_g=u(ci),
             proj_beta=r(ci) * 0.1, proj_slope=torch.tensor(0.25),
             dw_w=r(depth, ci, 5) * 0.3, dw_b=r(depth, ci) * 0.1, dw_g=u(depth, ci),
             dw_beta=r(depth, ci) * 0.1, final_g=u(ci), final_beta=r(ci) * 0.1,
             final_slope=torch.tensor(0.25), res_w=r(co, ci) * ci**-0.5, res_b=r(co) * 0.1)
    return {k: v.cuda() for k, v in p.items()}


def turn(root: str, reps: int) -> dict:
    """One turn's measurements, from the package under ``root``."""
    import torch

    import sudo_rm_rf_tpu_torch
    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    pkg = os.path.realpath(os.path.dirname(sudo_rm_rf_tpu_torch.__file__))
    if not pkg.startswith(os.path.realpath(root) + os.sep):
        raise RuntimeError(f"imported {pkg}, not the tree {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"tree": root}
    for name, (b, co, ci, t, depth) in BLOCKS.items():
        p = block_params(torch, depth, ci, co, seed=0)
        x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).cuda()
        want = U.uconv_block_reference(x.double(), {k: v.double() for k, v in p.items()}, depth)
        row = {}
        for form, y in (("k1", U.fused_uconv_block(x, p, depth)),
                        ("fp32_reference", U.uconv_block_reference(x, p, depth))):
            d = y.double() - want
            row[f"{form}_vs_float64_max"] = d.abs().max().item()
            row[f"{form}_vs_float64_rms"] = d.pow(2).mean().sqrt().item()
        row["k1_ms"] = time_ms(torch, lambda: U.fused_uconv_block(x, p, depth), reps)
        out[f"k1_{name}"] = row
    for name, (model_type, hp, fs) in FORWARDS.items():
        model = models.get_model(model_type, **hp, device="cuda",
                                 generator=torch.Generator().manual_seed(0)).eval()
        forward = fi.groupcomm_forward_fast if model_type == "groupcomm_v2" \
            else fi.improved_forward_fast
        x = torch.randn(BATCH, 1, int(SECONDS * fs), generator=torch.Generator().manual_seed(3))
        x = x.cuda()
        U.fused_uconv_block.launches = 0
        y = forward(model, x, impl="kernel")
        if U.fused_uconv_block.launches != hp["num_blocks"] or not torch.isfinite(y).all():
            raise RuntimeError(f"{name}: {U.fused_uconv_block.launches} K1 launches")
        ms = time_ms(torch, lambda: forward(model, x, impl="kernel"), reps)
        out[f"forward_{name}"] = {"ms": ms, "audio_s_per_s": BATCH * SECONDS / (ms / 1e3)}
        del model
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--order", nargs="+", type=int, default=[0, 1, 1, 0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:
        print(json.dumps(turn(args.turn, args.reps)))
        return 0
    if not args.trees:
        ap.error("--trees OLD NEW is required")
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    trees = [os.path.abspath(t) for t in args.trees]
    turns = []
    for i in args.order:
        env = dict(os.environ, PYTHONPATH=trees[i])
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", trees[i],
                               "--reps", str(args.reps)], env=env, cwd=trees[i],
                              capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return done.returncode
        row = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        turns.append((i, row))
    summary = {}
    for i, row in turns:
        tree = summary.setdefault(args.trees[i], {})
        for key, vals in row.items():
            if isinstance(vals, dict):
                for k, v in vals.items():
                    tree.setdefault(f"{key}.{k}", []).append(v)
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
