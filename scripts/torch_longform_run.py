"""Long-form run of the PyTorch port: one N-minute recording separated by a
trained checkpoint with both long-context engines, scored against ground
truth (port-side copy of ``scripts/longform_run.py``, which imports JAX).

The recording is built from held-out speakers ``spk000`` and ``spk001`` of
a hierarchical corpus (each speaker's utterances concatenated, cycled to
the length, unit variance: 0 dB long-term SNR). Engines:

  * ``overlap_add``: ``OverlapAddSeparator`` over 4 s chunks, 8 a batch,
    through the ``fma`` forward in ``--compute_dtype`` (JAX's run);
  * ``overlap_add_kernel``: the same through the ``kernel`` forward (K1);
  * ``seq_parallel``: ``SequenceParallelSeparator``, the exact single pass
    (on a card, one rank: the K1 route; on the CPU, the shard body).

Each engine's row: ``si_sdr_db``, ``si_sdri_db`` (best permutation),
``seconds_per_recording`` (median of ``--reps`` after a warm-up, CUDA
events around the call; the host clock on the CPU), ``audio_sec_per_sec``,
``k1_launches`` and ``idle_pct`` of one separation (null on the CPU), and
``device``. Writes ``summary.json`` (JAX's keys, and the card) to ``--out``.

    python scripts/torch_longform_run.py --checkpoint CKPT [--minutes 10]
        [--corpus .artifacts/corpus/test] [--out docs/runs/longform_u16_torch]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _si_sdr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    est = est - est.mean()
    ref = ref - ref.mean()
    a = float(np.dot(est, ref) / (np.dot(ref, ref) + eps))
    target = a * ref
    noise = est - target
    return float(10.0 * np.log10(
        (np.dot(target, target) + eps) / (np.dot(noise, noise) + eps)
    ))


def pit_si_sdri(est: np.ndarray, refs: np.ndarray, mixture: np.ndarray):
    """Best-permutation SI-SDR and its improvement of (S, T) estimates vs refs."""
    n = refs.shape[0]
    best = max(
        np.mean([_si_sdr(est[p[i]], refs[i]) for i in range(n)])
        for p in itertools.permutations(range(n))
    )
    base = np.mean([_si_sdr(mixture, refs[i]) for i in range(n)])
    return float(best), float(best - base)


def build_long_sources(corpus: str, seconds: float, fs: int,
                       speakers=("spk000", "spk001")) -> np.ndarray:
    """Concatenate each speaker's held-out utterances into one long stream
    (S, T), each at unit variance."""
    from sudo_rm_rf_tpu_torch.utils import joblib_format

    t = int(seconds * fs)
    streams = []
    for spk in speakers:
        utts = sorted(glob.glob(os.path.join(corpus, spk, "utt*", "wav")))
        if not utts:
            raise SystemExit(f"no utterances under {corpus}/{spk}")
        parts, total = [], 0
        for path in itertools.cycle(utts):
            wav = np.asarray(joblib_format.load(path), dtype=np.float32).reshape(-1)
            parts.append(wav)
            total += wav.shape[-1]
            if total >= t:
                break
        stream = np.concatenate(parts)[:t]
        # unit-variance per speaker => 0 dB long-term mixing SNR
        stream = (stream - stream.mean()) / (stream.std() + 1e-9)
        streams.append(stream)
    return np.stack(streams)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="a msgpack checkpoint or a torch .pt (a glob: the last match)")
    p.add_argument("--minutes", type=float, default=10.0)
    p.add_argument("-fs", type=int, default=8000)
    p.add_argument("--corpus", default=".artifacts/corpus/test")
    p.add_argument("--out", default="docs/runs/longform_u16_torch")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--engines", default="overlap_add,overlap_add_kernel,seq_parallel")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out_channels", type=int, default=256)
    p.add_argument("--in_channels", type=int, default=512)
    p.add_argument("--num_blocks", type=int, default=16)
    p.add_argument("--upsampling_depth", type=int, default=5)
    p.add_argument("--enc_kernel_size", type=int, default=21)
    p.add_argument("--enc_num_basis", type=int, default=512)
    args = p.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator, SequenceParallelSeparator
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
    from sudo_rm_rf_tpu_torch.utils.benchmark import (card_label, profile_calls, script_device,
                                                      time_call)

    device = script_device(args.device)
    card = card_label(device)
    ckpt = [c for c in sorted(glob.glob(args.checkpoint)) if not c.endswith(".json")]
    if not ckpt:
        raise SystemExit(f"no checkpoint matches {args.checkpoint}")
    ckpt = ckpt[-1]
    hp = dict(out_channels=args.out_channels, in_channels=args.in_channels,
              num_blocks=args.num_blocks, upsampling_depth=args.upsampling_depth,
              enc_kernel_size=args.enc_kernel_size, enc_num_basis=args.enc_num_basis,
              num_sources=2)
    # the params load in fp32 whatever dtype the run trained in
    model = models.load_checkpoint_model("relu", hp, ckpt, device)

    seconds = args.minutes * 60.0
    sources = build_long_sources(args.corpus, seconds, args.fs)
    mixture = sources.sum(axis=0)
    cdt = None if args.compute_dtype in ("", "float32", "none") else args.compute_dtype

    def chunked(impl):
        return OverlapAddSeparator(
            model, chunk_samples=4 * args.fs, num_sources=2, batch_chunks=8,
            forward_fn=lambda v: improved_forward_fast(model, v, impl=impl, compute_dtype=cdt))

    makers = {"overlap_add": lambda: chunked("fma"),
              "overlap_add_kernel": lambda: chunked("kernel"),
              "seq_parallel": lambda: SequenceParallelSeparator(model, compute_dtype=cdt)}
    rows = {}
    for name in args.engines.split(","):
        sep = makers[name]()
        est = np.asarray(sep.separate(mixture))
        if est.ndim == 3:
            est = est[0]
        if not np.isfinite(est).all():
            raise RuntimeError(f"{name}: non-finite output")
        dt = time_call(lambda: sep.separate(mixture), device, n=args.reps, warmup=0)
        prof = profile_calls(lambda: sep.separate(mixture), device, calls=1)
        sisdr, sisdri = pit_si_sdri(est, sources, mixture)
        rows[name] = {
            "si_sdr_db": sisdr, "si_sdri_db": sisdri, "seconds_per_recording": dt,
            "audio_sec_per_sec": seconds / dt, "k1_launches": prof["k1_launches"],
            "idle_pct": prof["idle_pct"], "device": card,
        }
        if name == "seq_parallel":
            rows[name]["route"] = sep.route
        print(json.dumps({"engine": name, **rows[name]}), flush=True)

    summary = {
        "model": "improved U16/512 (relu)" if hp["num_blocks"] == 16 else f"improved {hp}",
        "checkpoint": ckpt,
        "recording_minutes": args.minutes,
        "fs": args.fs,
        "compute_dtype": args.compute_dtype,
        "n_devices": torch.cuda.device_count() if device.type == "cuda" else 1,
        "corpus": args.corpus,
        "engines": rows,
        "device": card,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    print("wrote", os.path.join(args.out, "summary.json"))
    return summary


if __name__ == "__main__":
    main()
