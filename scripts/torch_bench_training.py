"""Training-step sweep and attribution of the PyTorch port (port-side copy of
``scripts/bench_training.py``, which imports JAX).

Every row times the real ``Trainer`` step (WSJ0 remix, forward, PIT
SI-SDR clamped at 30, backward, global-norm clip, Adam) of Improved
U16/512 (out 256) on a batch resident on the device:

  * the ``fma`` blocks at bs {4, 8, 16} x fp32 / bf16, and with
    ``remat_blocks`` at bs8 bf16;
  * at the fastest of those (audio seconds a second), the ablations: no
    remix (the mixture is the sources' sum), no clamp, the forward alone
    (no autograd), and forward plus backward without the clip and the
    optimizer;
  * the ``xla`` blocks at bs4 and bs8 bf16 and bs8 fp32;
  * GroupComm v2 U16/512 (group 16), ``xla`` against ``fma``, bs8 fp32 and
    bf16.

Times are CUDA-event medians of ``--reps`` steps after warm-up
(``utils.benchmark.time_call``; the host clock on the CPU), with the
allocator's peak. A row that runs out of device memory is printed with its
error. Prints one JSON row a configuration and a summary line.

    python scripts/torch_bench_training.py [--quick] [--reps 11]
        [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sum_prepare(draws, batch):
    return batch.sum(dim=1, keepdim=True), batch


def time_step(model, bs, t, dtype, device, reps, augment=True, loss_clamp=30.0, mode="train"):
    """Median seconds of one step of ``mode``: "train" (the whole step),
    "fwdbwd" (forward, loss and backward: no clip, no optimizer) or "fwd"
    (the training forward and loss without autograd)."""
    import torch

    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix
    from sudo_rm_rf_tpu_torch.utils.benchmark import time_call

    trainer = Trainer(model, TrainerConfig(learning_rate=1e-3, compute_dtype=dtype,
                                           loss_clamp=loss_clamp),
                      prepare_batch=None if augment else _sum_prepare)
    state = trainer.init_state()
    batch = torch.randn((bs, 2, t), generator=torch.Generator(device=device).manual_seed(1),
                        device=device)
    g = torch.Generator(device=device).manual_seed(2)
    if mode == "train":
        fn = lambda: trainer.train_step(state, batch, draw_remix(g, bs, 2))  # noqa: E731
    elif mode == "fwdbwd":
        fn = lambda: trainer.compute_gradients(state, batch, draw_remix(g, bs, 2))  # noqa: E731
    else:
        def fn():
            with torch.no_grad():
                mixture, targets = trainer.prepare_batch(draw_remix(g, bs, 2), batch)
                trainer._loss(model, mixture, targets)
    return time_call(fn, device, n=reps)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="the bf16 rows and bs8 fp32 only, then the ablations and GroupComm")
    p.add_argument("--reps", type=int, default=11)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="toy widths and lengths for a CPU rehearsal (not a benchmark)")
    args = p.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.utils.benchmark import card_label

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = card_label(device)
    seconds = 0.25 if args.tiny else 4.0
    t = int(8000 * seconds)
    u16 = (dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
                enc_kernel_size=21, enc_num_basis=16, num_sources=2) if args.tiny else
           dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
                enc_kernel_size=21, enc_num_basis=512, num_sources=2))
    rows = []

    def measure(name, model_type, hp, bs, dtype, **kw):
        model = models.get_model(model_type, **hp, device=device,
                                 generator=torch.Generator().manual_seed(0))
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        try:
            secs = time_step(model, bs, t, dtype, device, args.reps, **kw)
        except torch.cuda.OutOfMemoryError as e:
            row = dict(config=name, error=repr(e)[:200], device=card)
        else:
            row = dict(config=name, ms_per_step=secs * 1e3, examples_per_sec=bs / secs,
                       audio_sec_per_sec=bs * seconds / secs, batch_size=bs,
                       compute_dtype=dtype or "float32", device=card,
                       peak_mib=torch.cuda.max_memory_allocated(device) / 2**20 if cuda
                       else None)
        finally:
            del model
            if cuda:
                torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    sweep = [(bs, dt, False) for bs in (4, 8, 16) for dt in (None, "bfloat16")
             if not (args.quick and dt is None and bs != 8)]
    sweep.append((8, "bfloat16", True))
    for bs, dt, remat in sweep:
        measure(f"u16_fma_bs{bs}_{dt or 'fp32'}" + ("_remat" if remat else ""), "relu",
                dict(u16, block_impl="fma", remat_blocks=remat), bs, dt)
    best = max((r for r in rows if "ms_per_step" in r and "remat" not in r["config"]),
               key=lambda r: r["audio_sec_per_sec"])
    bs, dt = best["batch_size"], None if best["compute_dtype"] == "float32" else "bfloat16"
    tag = f"bs{bs}_{dt or 'fp32'}"
    for name, kw in (("noaugment", dict(augment=False)), ("noclamp", dict(loss_clamp=0.0)),
                     ("fwd_only", dict(mode="fwd")), ("fwdbwd_only", dict(mode="fwdbwd"))):
        measure(f"attrib_{name}_{tag}", "relu", dict(u16, block_impl="fma"), bs, dt, **kw)
    for bs, dt in ((4, "bfloat16"), (8, "bfloat16"), (8, None)):
        measure(f"u16_xla_bs{bs}_{dt or 'fp32'}", "relu", dict(u16, block_impl="xla"), bs, dt)
    gc = dict(u16, group_size=4 if args.tiny else 16)
    for impl in ("xla", "fma"):
        for dt in (None, "bfloat16"):
            measure(f"gc_{impl}_bs8_{dt or 'fp32'}", "groupcomm_v2", dict(gc, block_impl=impl),
                    8, dt)
    print(json.dumps({"best": best["config"], "rows": len(rows), "device": card}))
    return rows


if __name__ == "__main__":
    main()
