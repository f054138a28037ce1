"""Written roofline floors for the port's serving rows on the H100 (port-side
copy of ``scripts/roofline_bound.py``, which imports JAX and reckons the
v5e's).

Rows (Improved U16/512, 4 s at 8 kHz, seeded random weights):
``bs4_fp32_kernel`` (K1 blocks), ``bs4_fp32_fma`` and ``bs8_bf16_xla`` (the
plain forward from a copy cast to bf16 once). Each op of the row's forward
is counted under a ``TorchDispatchMode`` on the ``meta`` device (shapes
only); a ``kernel`` row counts the plain forward outside its blocks and K1's
own work (``utils.benchmark.k1_flops``) for each block.

* Compute floor: each op's FLOPs over the peak of the unit that runs it:
  products and channel-mixing convolutions on the tensor cores (bf16 at
  989 TFLOP/s; fp32 in 3xTF32, a third of the 495 TFLOP/s TF32 peak, as K1
  takes its GEMMs), depthwise convolutions, norms and elementwise ops on
  the fp32 pipes (67 TFLOP/s; an elementwise op counts one flop an output,
  a reduction one an input). fp32 rows also print the floor with every op
  on the fp32 pipes (``compute_floor_fp32_simt_ms``): a plain fp32 product
  with TF32 off runs there.
* Logical bytes: the operands and results of every op but views, each op
  counted alone (XLA's pre-fusion ``bytes_accessed``), over 3.35 TB/s:
  ``logical_roofline_ms``. Not a floor: a fused program keeps that traffic
  on chip; ``fused_traffic_max_x`` = measured / logical bounds the share of
  it that still reaches memory.
* Least bytes: params, input and output, each moved once: the floor on
  bytes (``least_bytes_ms``). ``floor_ms`` is the larger of it and the
  compute floor, and ``recoverable_x_max`` = measured / floor.

``--measure`` times each row on the card (CUDA events, median of
``--n_hi``), with its idle share and K1 launches; else ``--measured_*_ms``
give the times (no default: a time is a card's reading). Prints one JSON
line a row and returns the rows.

    python scripts/torch_roofline_bound.py --measure [--n_hi 21]
    python scripts/torch_roofline_bound.py --measured_kernel_ms 6.8 \\
        --measured_fp32_ms ... --measured_bf16_ms ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HP = dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
          enc_kernel_size=21, enc_num_basis=512, num_sources=2)
TINY = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=2,
            enc_kernel_size=21, enc_num_basis=16, num_sources=2)
SECONDS, SR = 4.0, 8000
TINY_SECONDS = 0.25
# (row, impl, compute dtype, batch)
ROWS = (("bs4_fp32_kernel", "kernel", None, 4), ("bs4_fp32_fma", "fma", None, 4),
        ("bs8_bf16_xla", "xla", "bfloat16", 8))
# ops that move or view data and compute nothing
MOVES = {"view", "_unsafe_view", "expand", "permute", "transpose", "t", "slice", "select",
         "squeeze", "unsqueeze", "alias", "detach", "as_strided", "split", "unbind",
         "clone", "copy_", "_to_copy", "constant_pad_nd", "cat", "stack", "empty",
         "empty_like", "zeros", "zeros_like", "new_zeros", "new_empty", "full", "lift_fresh",
         "_reshape_alias", "contiguous", "index", "repeat"}
VIEWS = {"view", "_unsafe_view", "expand", "permute", "transpose", "t", "slice", "select",
         "squeeze", "unsqueeze", "alias", "detach", "as_strided", "split", "unbind",
         "_reshape_alias", "lift_fresh"}
REDUCTIONS = {"sum", "mean", "var", "std", "amax", "amin", "max", "min", "norm",
              "var_mean", "std_mean"}


def op_counts(fn, *args) -> dict:
    """The work of one call of fn, by unit: ``tensor`` (products and
    channel-mixing convolutions, FLOPs by dtype name), ``fp32_pipes``
    (depthwise convolutions, norms, elementwise: FLOPs) and
    ``logical_bytes`` (operands and results of every op but views)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import conv_flop_count

    out = {"tensor": {}, "depthwise": 0.0, "fp32_pipes": 0.0, "logical_bytes": 0.0}

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
            outs = [r for r in tree_flatten(res)[0] if isinstance(r, torch.Tensor)]
            if name not in VIEWS:
                out["logical_bytes"] += nbytes(ins) + nbytes(outs)
            if name in ("mm", "bmm", "addmm", "baddbmm"):
                a, b = args[-2], args[-1]
                flops = 2.0 * a.numel() * b.shape[-1]
                dt = str(a.dtype).replace("torch.", "")
                out["tensor"][dt] = out["tensor"].get(dt, 0.0) + flops
            elif name == "convolution":
                x, w, transposed, groups = args[0], args[1], args[6], args[8]
                flops = float(conv_flop_count(list(x.shape), list(w.shape), list(res.shape),
                                              transposed=transposed))
                if groups > 1 and groups == x.shape[1] and not transposed:
                    out["depthwise"] += flops
                    out["fp32_pipes"] += flops
                else:
                    dt = str(x.dtype).replace("torch.", "")
                    out["tensor"][dt] = out["tensor"].get(dt, 0.0) + flops
            elif name in REDUCTIONS:
                out["fp32_pipes"] += float(max(t.numel() for t in ins))
            elif name not in MOVES and outs:
                out["fp32_pipes"] += float(outs[0].numel())
            return res

    with torch.no_grad(), Counter():
        fn(*args)
    return out


def row_work(model, impl, compute_dtype, bs, t) -> dict:
    """Counted work of one serving forward of ``model`` (on the meta device)
    through ``impl``: FLOPs by unit and dtype, logical and least bytes."""
    import torch

    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.utils.benchmark import count_params, k1_flops, on_meta

    meta = fi.cast_model(on_meta(model), compute_dtype, None if impl == "kernel" else impl)
    x = torch.empty((bs, 1, t), device="meta")
    plain = "xla" if impl == "kernel" else impl
    work = op_counts(lambda v: fi.improved_forward_fast(meta, v, impl=plain,
                                                       compute_dtype=compute_dtype), x)
    if impl == "kernel":  # the plain forward outside the blocks, and K1 in each
        one = op_counts(fi.uconv_block_reference, *_block_args(meta, bs, t))
        n = model.num_blocks
        for dt, f in one["tensor"].items():
            work["tensor"][dt] -= n * f
        work["fp32_pipes"] -= n * one["fp32_pipes"]
        work["depthwise"] -= n * one["depthwise"]
        work["logical_bytes"] -= n * one["logical_bytes"]
        frames = _frames(model, t)
        gemm, other = k1_flops(bs, model.out_channels, model.in_channels, frames,
                               model.upsampling_depth)
        work["tensor"]["float32"] += n * gemm
        work["fp32_pipes"] += n * other
        work["logical_bytes"] += n * 4 * (2 * bs * model.out_channels * frames
                                          + sum(p.numel() for p in model.sm[0].parameters()))
    width = 2 if compute_dtype == "bfloat16" else 4
    work["least_bytes"] = float(width * count_params(model) + 4 * bs * t
                                + 4 * bs * model.num_sources * t)
    return work


def _frames(model, t: int) -> int:
    """Encoder frames of a t-sample input (t a multiple of the model's least
    length): the encoder's stride is half its kernel."""
    half = model.enc_kernel_size // 2
    return (t + 2 * half - model.enc_kernel_size) // half + 1


def _block_args(model, bs, t):
    import torch

    from sudo_rm_rf_tpu_torch.ops.uconv import params_from_module

    x = torch.empty((bs, model.out_channels, _frames(model, t)), device="meta",
                    dtype=next(model.parameters()).dtype)
    return x, params_from_module(model.sm[0]), model.upsampling_depth


def floors(work: dict, fp32: bool) -> dict:
    """Compute, fp32-pipe and byte floors (ms) of counted work on the H100."""
    from sudo_rm_rf_tpu_torch.utils.benchmark import (H100_BYTES_PER_S, H100_FP32_SIMT_PEAK,
                                                      H100_PEAKS)

    tensor_s = sum(f / H100_PEAKS["bfloat16" if dt == "bfloat16" else "float32"]
                   for dt, f in work["tensor"].items())
    compute_ms = 1e3 * (tensor_s + work["fp32_pipes"] / H100_FP32_SIMT_PEAK)
    flops = sum(work["tensor"].values()) + work["fp32_pipes"]
    out = dict(flops_g=flops / 1e9, tensor_core_flops_g=sum(work["tensor"].values()) / 1e9,
               fp32_pipe_flops_g=work["fp32_pipes"] / 1e9,
               depthwise_flops_g=work["depthwise"] / 1e9, compute_floor_ms=compute_ms)
    if fp32:
        out["compute_floor_fp32_simt_ms"] = 1e3 * flops / H100_FP32_SIMT_PEAK
    least_ms = 1e3 * work["least_bytes"] / H100_BYTES_PER_S
    out.update(logical_bytes_gb=work["logical_bytes"] / 1e9,
               logical_roofline_ms=1e3 * work["logical_bytes"] / H100_BYTES_PER_S,
               least_bytes_gb=work["least_bytes"] / 1e9, least_bytes_ms=least_ms,
               floor_ms=max(compute_ms, least_ms),
               floor_by="operations" if compute_ms >= least_ms else "bytes")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--measure", action="store_true", help="time each row on the device")
    p.add_argument("--measured_kernel_ms", type=float, default=None)
    p.add_argument("--measured_fp32_ms", type=float, default=None,
                   help="the bs4 fp32 fma row's time")
    p.add_argument("--measured_bf16_ms", type=float, default=None)
    p.add_argument("--n_hi", type=int, default=21)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="toy widths and lengths for a CPU rehearsal (not a benchmark)")
    args = p.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.utils.benchmark import (card_label, profile_calls, script_device,
                                                      time_call)

    hp, seconds = (TINY, TINY_SECONDS) if args.tiny else (HP, SECONDS)
    t = int(seconds * SR)
    given = {"bs4_fp32_kernel": args.measured_kernel_ms, "bs4_fp32_fma": args.measured_fp32_ms,
             "bs8_bf16_xla": args.measured_bf16_ms}
    device = script_device(args.device) if args.measure else None
    card = card_label(device) if args.measure else None
    model = models.get_model("relu", **hp, generator=torch.Generator().manual_seed(0)).eval()
    served = model.to(device) if args.measure else model
    rows = []
    for name, impl, dtype, bs in ROWS:
        row = dict(row=name, **floors(row_work(model, impl, dtype, bs, t), dtype is None))
        measured = given[name]
        if args.measure:
            cast = fi.cast_model(served, dtype, impl)
            x = torch.randn((bs, 1, t), generator=torch.Generator().manual_seed(2)).to(device)
            fn = lambda: fi.improved_forward_fast(cast, x, impl=impl,  # noqa: E731
                                                  compute_dtype=dtype)
            measured = 1e3 * time_call(fn, device, n=args.n_hi)
            prof = profile_calls(fn, device)
            row.update(idle_pct=prof["idle_pct"], k1_launches=prof["k1_launches"], device=card)
        row["measured_ms"] = measured
        if measured is not None:
            row.update(recoverable_x_max=measured / row["floor_ms"],
                       recoverable_x_max_fp32_simt=(measured / row["compute_floor_fp32_simt_ms"]
                                                    if dtype is None else None),
                       fused_traffic_max_x=measured / row["logical_roofline_ms"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
