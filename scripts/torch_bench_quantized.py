"""Quantized-serving sweep of the PyTorch port (port-side copy of
``scripts/bench_quantized.py``, which imports JAX): int8 (dynamic and static
calibrated scales) against bf16 and fp32 as ``in_channels`` and
``enc_num_basis`` grow and the 1x1 products dominate.

Configurations (``CONFIGS``, 4 s at 8 kHz, seeded random weights):
``u16_512`` (Improved U16/512), ``u36_2048`` (the zoo's U36/2048, out 512,
in 512) and ``u36_wide`` (in 2048: K1 runs at (B, 512, 2048, 3200, 5)).

Fidelity is that of a bs1 probe against its fp32 ``fma`` forward; the static
scales are calibrated on a different (bs4) batch. Rows at each ``--bs``:
``fp32_fma``, ``fp32_kernel`` (K1, one launch a block), ``bf16_conv`` (the
plain ``xla`` forward from a copy cast to bf16 once), ``int8`` (dynamic) and
``int8_static``, each with ``config``, ``bs``, ``path``, ``ms_per_batch``
(median of ``--n_hi`` calls, CUDA events; the host clock on the CPU),
``au_s_per_s``, ``fidelity_db_vs_fp32`` (not on ``fp32_fma``), ``idle_pct``
(3 profiled calls; null on the CPU), ``k1_launches`` (a forward), ``device``,
and ``families`` where ``--families`` quantizes only some.
``--attribute`` first prints one fidelity row per family quantized alone
(dynamic scales, no timing).

    python scripts/torch_bench_quantized.py [--config u16_512|u36_2048|u36_wide]
        [--bs 4 8] [--families proj res ...] [--attribute] [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = {
    "u16_512": dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
                    enc_kernel_size=21, enc_num_basis=512, num_sources=2),
    # the zoo's published-shape U36/2048
    "u36_2048": dict(out_channels=512, in_channels=512, num_blocks=36, upsampling_depth=5,
                     enc_kernel_size=21, enc_num_basis=2048, num_sources=2),
    # 4x-wider blocks (69 M params): the product-dominated regime
    "u36_wide": dict(out_channels=512, in_channels=2048, num_blocks=36, upsampling_depth=5,
                     enc_kernel_size=21, enc_num_basis=2048, num_sources=2),
}
# --tiny: each configuration's shape at toy widths and depth
TINY = {
    "u16_512": dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=2,
                    enc_kernel_size=21, enc_num_basis=16, num_sources=2),
    "u36_2048": dict(out_channels=32, in_channels=32, num_blocks=3, upsampling_depth=2,
                     enc_kernel_size=21, enc_num_basis=64, num_sources=2),
    "u36_wide": dict(out_channels=32, in_channels=128, num_blocks=3, upsampling_depth=2,
                     enc_kernel_size=21, enc_num_basis=64, num_sources=2),
}
SECONDS, SR = 4.0, 8000
TINY_SECONDS = 0.25


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="u36_2048", choices=sorted(CONFIGS))
    p.add_argument("--bs", type=int, nargs="+", default=[4])
    p.add_argument("--n_hi", type=int, default=21)
    p.add_argument("--families", nargs="+", default=None,
                   help="matmul families to quantize (default: all)")
    p.add_argument("--attribute", action="store_true",
                   help="per-family fidelity attribution rows (no timing)")
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
    hp = (TINY if args.tiny else CONFIGS)[args.config]
    seconds = TINY_SECONDS if args.tiny else SECONDS
    t = int(seconds * SR)
    families = tuple(args.families) if args.families else q.ALL_FAMILIES
    model = models.get_model("relu", **hp, device=device,
                             generator=torch.Generator().manual_seed(0)).eval()
    bf16 = fi.cast_model(model, torch.bfloat16, "xla")
    qp = q.quantize_improved_params(model, families=families)
    kw = dict(upsampling_depth=hp["upsampling_depth"], enc_kernel_size=hp["enc_kernel_size"],
              num_sources=hp["num_sources"])

    def batch(bs, seed):
        return torch.randn((bs, 1, t), generator=torch.Generator().manual_seed(seed)).to(device)

    # calibrate on a different batch than the fidelity probe (held-out
    # scales are the configuration users would run)
    scales = q.calibrate_improved_scales(qp, batch(4, 7), **kw)
    paths = {
        "fp32_fma": lambda c: fi.improved_forward_fast(model, c, impl="fma"),
        "fp32_kernel": lambda c: fi.improved_forward_fast(model, c, impl="kernel"),
        "bf16_conv": lambda c: fi.improved_forward_fast(bf16, c, impl="xla",
                                                        compute_dtype="bfloat16"),
        "int8": lambda c: q.improved_forward_int8(qp, c, **kw),
        "int8_static": lambda c: q.improved_forward_int8(qp, c, scales=scales, **kw),
    }
    x1 = batch(1, 1)
    ref1 = paths["fp32_fma"](x1)
    fid = {name: q.fidelity_db(ref1, fn(x1)) for name, fn in paths.items() if name != "fp32_fma"}
    rows = []
    if args.attribute:
        for fam in q.ALL_FAMILIES:
            qf = q.quantize_improved_params(model, families=(fam,))
            got = q.improved_forward_int8(qf, x1, **kw)
            row = dict(config=args.config, attribute_family=fam,
                       fidelity_db_vs_fp32=q.fidelity_db(ref1, got), device=card)
            print(json.dumps(row), flush=True)
        del qf
    for bs in args.bs:
        x = batch(bs, 2)
        for name, fn in paths.items():
            secs = time_call(lambda: fn(x), device, n=args.n_hi)
            prof = profile_calls(lambda: fn(x), device)
            row = dict(config=args.config, bs=bs, path=name, ms_per_batch=secs * 1e3,
                       au_s_per_s=bs * seconds / secs, idle_pct=prof["idle_pct"],
                       k1_launches=prof["k1_launches"], device=card)
            if families != q.ALL_FAMILIES:
                row["families"] = list(families)
            if name in fid:
                row["fidelity_db_vs_fp32"] = fid[name]
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
