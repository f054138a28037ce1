"""Streaming (block-online) serving latency of the causal SuDoRM-RF
(counterpart of ``scripts/bench_streaming.py``).

Times the step of ``inference.StreamingSeparator`` with ``num_streams``
set to each number of concurrent streams: one push of every stream's next
hop from host memory (the upload, the window's roll, one batched forward of
the causal model at the JAX class defaults with seeded random weights over
the fixed [context | hop] window, and the emitted hop's copy back). Prints
one JSON line per count of streams, with the keys of the JAX script: the
per-hop step time (CUDA events, median of ``--n_hi`` steps after warm-up),
the real-time factor (streams x hop duration / step time) and the padding
granule.

    python -m sudo_rm_rf_tpu_torch.bench_streaming [--hop 160] [--context 3200]
                                                   [--streams 1 16]
"""

from __future__ import annotations

import argparse
import json
import sys

SR = 8000


def main(argv=None, model_kwargs=None) -> int:
    ap = argparse.ArgumentParser(description="causal SuDoRM-RF streaming step latency")
    ap.add_argument("--hop", type=int, default=160,
                    help="samples per step (160 = 20 ms @ 8 kHz)")
    ap.add_argument("--context", type=int, default=3200,
                    help="left context samples (multiple of the granule)")
    ap.add_argument("--streams", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--n_hi", type=int, default=51)
    ap.add_argument("--device", default="cuda",
                    help="torch device; never falls back to the CPU")
    args = ap.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.inference import StreamingSeparator
    from sudo_rm_rf_tpu_torch.utils.benchmark import time_call

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    model = models.get_model("causal", **(model_kwargs or {}),
                             generator=torch.Generator().manual_seed(1), device=device).eval()
    granule = model.n_least_samples_req
    if args.context % granule:
        raise SystemExit(f"--context must be a multiple of the model granule ({granule})")

    for n in args.streams:
        sep = StreamingSeparator(model, hop_samples=args.hop, context_samples=args.context,
                                 num_streams=n)
        hops = torch.randn((n, args.hop), generator=torch.Generator().manual_seed(2)).numpy()
        step_ms = 1e3 * time_call(lambda: sep.push(hops), device, n=args.n_hi)
        hop_ms = 1e3 * args.hop / SR
        print(json.dumps({
            "streams": n,
            "hop_ms": round(hop_ms, 1),
            "context_ms": round(1e3 * args.context / SR, 1),
            "step_ms": round(step_ms, 3),
            "per_stream_rtf": round(n * hop_ms / step_ms, 1),
            "granule": granule,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
