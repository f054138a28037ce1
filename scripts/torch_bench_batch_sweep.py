"""Serving batch-size sweep of the PyTorch port (port-side copy of
``scripts/bench_batch_sweep.py``, which imports JAX): the throughput of each
serving path of Improved SuDoRM-RF U16/512 as the batch grows.

Paths (4 s at 8 kHz, seeded random weights):

  * ``bf16_conv``: the plain (``xla``) forward from a copy cast to bf16
    once (``fast_inference.cast_model``), the counterpart of JAX's bf16
    ``model.apply``;
  * ``fma_fp32`` and ``fma_bf16``: the ``fma`` blocks, in fp32 and with
    ``compute_dtype="bfloat16"`` (fp32 GlobLN statistics);
  * ``int8_static``: ``models/quantized.py`` with static scales calibrated
    on a different batch;
  * ``kernel_fp32`` and ``kernel_bf16_pyramid``: the ``kernel`` blocks (K1,
    16 launches a forward), fp32, and bf16 serving with K1's bf16 pyramid.

Each row: ``path``, ``bs``, ``ms_batch`` (the median of ``--n_hi`` calls,
CUDA events; the host clock on the CPU), ``au_s_per_s``, ``idle_pct`` (the
device's idle share over 3 profiled calls; null on the CPU), ``k1_launches``
(a forward), ``fidelity_db`` against the fp32 ``kernel`` forward of the same
input and ``device``. Prints one JSON line a row.

    python scripts/torch_bench_batch_sweep.py [--bs 8 16 24 32 48 64]
        [--paths ...] [--n_hi 21] [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SECONDS, SR = 4.0, 8000
HP = dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
          enc_kernel_size=21, enc_num_basis=512, num_sources=2)
TINY = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=2,
            enc_kernel_size=21, enc_num_basis=16, num_sources=2)
TINY_SECONDS = 0.25
PATHS = ("bf16_conv", "fma_fp32", "fma_bf16", "int8_static", "kernel_fp32",
         "kernel_bf16_pyramid")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bs", type=int, nargs="+", default=[8, 16, 24, 32, 48, 64])
    p.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    p.add_argument("--n_hi", type=int, default=21)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="toy widths and lengths for a CPU rehearsal (not a benchmark)")
    args = p.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.models import quantized as q
    from sudo_rm_rf_tpu_torch.utils.benchmark import (card_label, profile_calls, script_device,
                                                      time_call)

    device = script_device(args.device)
    card = card_label(device)
    hp, seconds = (TINY, TINY_SECONDS) if args.tiny else (HP, SECONDS)
    t = int(seconds * SR)
    model = models.get_model("relu", **hp, device=device,
                             generator=torch.Generator().manual_seed(0)).eval()
    qkw = dict(upsampling_depth=hp["upsampling_depth"], enc_kernel_size=hp["enc_kernel_size"],
               num_sources=hp["num_sources"])
    casts = {"xla": fi.cast_model(model, torch.bfloat16, "xla"),
             "kernel": fi.cast_model(model, torch.bfloat16, "kernel")}
    qp = scales = None
    if "int8_static" in args.paths:
        qp = q.quantize_improved_params(model)
        calib = torch.randn((4, 1, t), generator=torch.Generator().manual_seed(1))
        scales = q.calibrate_improved_scales(qp, calib.to(device), **qkw)
    fwd = fi.improved_forward_fast
    paths = {
        "bf16_conv": lambda c: fwd(casts["xla"], c, impl="xla", compute_dtype="bfloat16"),
        "fma_fp32": lambda c: fwd(model, c, impl="fma"),
        "fma_bf16": lambda c: fwd(model, c, impl="fma", compute_dtype="bfloat16"),
        "int8_static": lambda c: q.improved_forward_int8(qp, c, scales=scales, **qkw),
        "kernel_fp32": lambda c: fwd(model, c, impl="kernel"),
        "kernel_bf16_pyramid": lambda c: fwd(casts["kernel"], c, impl="kernel",
                                             compute_dtype="bfloat16",
                                             pyramid_dtype=torch.bfloat16),
    }
    rows = []
    for bs in args.bs:
        x = torch.randn((bs, 1, t), generator=torch.Generator().manual_seed(2)).to(device)
        want = paths["kernel_fp32"](x)
        for path in args.paths:
            fn = paths[path]
            fid = q.fidelity_db(want, fn(x))
            secs = time_call(lambda: fn(x), device, n=args.n_hi)
            prof = profile_calls(lambda: fn(x), device)
            row = dict(path=path, bs=bs, ms_batch=secs * 1e3, au_s_per_s=bs * seconds / secs,
                       idle_pct=prof["idle_pct"], k1_launches=prof["k1_launches"],
                       fidelity_db=fid, device=card)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, want
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
