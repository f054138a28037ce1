"""Where a U16/512 training step's time goes, forward against backward
(port-side copy of ``scripts/profile_train_step.py``, which imports JAX).

For the ``fma`` and ``xla`` blocks, each with and without ``remat_blocks``,
on a bs ``--bs`` 4 s batch with the params and input cast to bf16 (the
trainer's ``compute_dtype``) and a squared-error loss:

  * fwd: the forward alone (no autograd);
  * fwdbwd: forward and backward of every param (bwd = fwdbwd - fwd);
  * fwdbwd_blocks_only: only the U-ConvBlocks' params take a gradient (the
    encoder's, decoder's, bottleneck's and mask's weight gradients are not
    computed), and fwdbwd_encdec_only the reverse: their difference from
    fwdbwd splits the backward between the blocks and the rest;

with the allocator's peak for each. Times are CUDA-event medians of
``--reps`` calls after warm-up (``utils.benchmark.time_call``; the host
clock on the CPU). ``--trace DIR`` writes a Chrome trace of three fwdbwd
steps of the fma blocks. Prints one JSON row a measurement.

    python scripts/torch_profile_train_step.py [--bs 4] [--reps 11]
        [--trace DIR] [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--reps", type=int, default=11)
    p.add_argument("--trace", default=None, help="write a Chrome trace into this directory")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="toy widths and lengths for a CPU rehearsal (not a benchmark)")
    args = p.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.utils.benchmark import card_label, time_call

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    card = card_label(device)
    t = int(8000 * (0.25 if args.tiny else 4.0))
    hp = (dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=2,
               enc_kernel_size=21, enc_num_basis=16, num_sources=2) if args.tiny else
          dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
               enc_kernel_size=21, enc_num_basis=512, num_sources=2))
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((args.bs, 1, t), generator=g, device=device)
    tgt = torch.randn((args.bs, 2, t), generator=g, device=device)
    rows = []

    def bench(name, fn, tag):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        ms = 1e3 * time_call(fn, device, n=args.reps)
        row = dict(what=f"{name}_{tag}", ms=ms, batch_size=args.bs, device=card,
                   peak_mib=torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None)
        rows.append(row)
        print(json.dumps(row), flush=True)
        return ms

    for impl, remat in (("fma", False), ("fma", True), ("xla", False), ("xla", True)):
        model = models.get_model("relu", **hp, block_impl=impl, remat_blocks=remat,
                                 device=device, generator=torch.Generator().manual_seed(0))
        params = dict(model.named_parameters())

        def loss(subset):
            cast = {n: (v.bfloat16() if n in subset else v.detach().bfloat16())
                    for n, v in params.items()}
            est = torch.func.functional_call(model, cast, (x.bfloat16(),)).float()
            return ((est - tgt) ** 2).sum(-1).mean()

        def grad(subset):
            return torch.autograd.grad(loss(subset), [params[n] for n in subset])

        def fwd():
            with torch.no_grad():
                loss(())

        tag = impl + ("_remat" if remat else "")
        f = bench("fwd", fwd, tag)
        fb = bench("fwdbwd", lambda: grad(list(params)), tag)
        rows[-1]["bwd_ms"] = fb - f
        if not remat:
            blocks = [n for n in params if n.startswith("sm.")]
            rest = [n for n in params if not n.startswith("sm.")]
            bench("fwdbwd_blocks_only", lambda: grad(blocks), tag)
            bench("fwdbwd_encdec_only", lambda: grad(rest), tag)
        if args.trace and impl == "fma" and not remat and cuda:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    grad(list(params))
                torch.cuda.synchronize(device)
            os.makedirs(args.trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.trace, "fwdbwd_fma.json"))
            print(json.dumps({"trace": os.path.join(args.trace, "fwdbwd_fma.json")}))
        del model, params
    return rows


if __name__ == "__main__":
    main()
