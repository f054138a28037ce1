"""`sudo-torch-bench`: the performance-measurement CLI of the port.

Counterpart of ``sudo_rm_rf_tpu/cli/bench.py``: sweeps models x measures x
batch sizes on ``--device`` (a CUDA card unless asked for the CPU) and
prints one JSON row per combination, with the JAX CLI's keys
(``utils/benchmark.py::benchmark_model``):

    sudo-torch-bench --models sudormrf_R16 groupcomm_R16 --batch_sizes 1 4
    sudo-torch-bench --models sudormrf_R16 --dtype bfloat16
    sudo-torch-bench --models sudormrf_R16 --measures backward --batch_sizes 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Benchmark model compute/memory")
    p.add_argument("--models", nargs="+", default=["sudormrf_R16"],
                   help="names from the reference zoo, or 'all'")
    p.add_argument("--measures", nargs="+", default=["forward"],
                   choices=["forward", "backward"])
    p.add_argument("--batch_sizes", nargs="+", type=int, default=[1, 4])
    p.add_argument("--timelength", type=float, default=4.0)
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--path", default="serving", choices=["serving", "apply"],
                   help="forward to time: the model's serving forward (default; "
                        "the CUDA kernel blocks on a card) or the module's own")
    p.add_argument("--dtype", default=None,
                   help="compute dtype for forward rows (e.g. bfloat16)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of one forward here")
    p.add_argument("--device", default="cuda",
                   help="torch device to measure on; never falls back to the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch.utils import benchmark

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    zoo = benchmark.reference_model_zoo()
    names = list(zoo) if args.models == ["all"] else args.models
    for name in names:
        if name not in zoo:
            print(f"unknown model {name}; have {sorted(zoo)}", file=sys.stderr)
            return 1
    for name in names:
        model = zoo[name]()
        for measure in args.measures:
            for bs in args.batch_sizes:
                row = benchmark.benchmark_model(
                    model, batch_size=bs, timelength=args.timelength, fs=args.fs,
                    measure=measure, path=args.path, dtype=args.dtype, device=device)
                row["model"] = name
                print(json.dumps(row, default=str), flush=True)
        if args.profile_dir:
            _trace_one(model, args, device, name)
    return 0


def _trace_one(model, args, device, name: str):
    """A ``torch.profiler`` Chrome trace of one forward of ``--path`` at the
    last batch size (after one untraced call), written to
    ``<profile_dir>/<model>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sudo_rm_rf_tpu_torch.models.fast_inference import cast_model
    from sudo_rm_rf_tpu_torch.utils.benchmark import has_fast_forward, serving_forward

    t = int(args.timelength * args.fs)
    x = torch.randn((args.batch_sizes[-1], 1, t),
                    generator=torch.Generator().manual_seed(1)).to(device)
    fast = args.path == "serving" and has_fast_forward(model)
    impl = "kernel" if fast and device.type == "cuda" else None
    model = cast_model(model.to(device).eval(), args.dtype, impl)
    if fast:
        fwd = serving_forward(model, compute_dtype=args.dtype)
        run = lambda: fwd(model, x)  # noqa: E731
    else:
        xin = x.to(next(model.parameters()).dtype)
        run = lambda: model(xin)  # noqa: E731
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.no_grad():
        run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with profile(activities=activities) as prof:
            run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    os.makedirs(args.profile_dir, exist_ok=True)
    path = os.path.join(args.profile_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    print(json.dumps({"profile_trace": path}))


if __name__ == "__main__":
    sys.exit(main())
