"""Headline benchmark of the port: real-time separation factor on one card.

    python -m sudo_rm_rf_tpu_torch.bench [--device cuda]

The counterpart of the repo's root ``bench.py``: Improved SuDoRM-RF
U16/Bases512 (its hparams) on 4 s @ 8 kHz mixtures, against the reference's
2080 Ti bs4 forward (213.2 audio-s/s). Rows:

* conservative: bs4 fp32 through the serving default (``improved_forward_
  fast``, the CUDA kernel blocks on a card); its output is the fp32
  reference the gates compare with;
* max: bs8 full-bf16 module forward (params and input cast, the module's
  own blocks), gated on bf16-vs-fp32 fidelity >= 35 dB; the headline only
  if gated and faster than the conservative row;
* int8: bs8 ``models/quantized.py`` with static scales calibrated on a
  held-out batch, gated on its own fidelity >= 25 dB; the headline only if
  gated and faster than the value so far;
* train: JAX's autotuned row, a full ``Trainer`` step (remix, PIT loss,
  backward, clip, Adam) in bf16 over bs {4, 8, 16} x the ``xla`` and
  ``fma`` blocks (``train.autotune.autotune_train_config``), the row that
  trains the most audio seconds a second, against the reference's 47.2
  audio-s/s; ``train_config`` reads ``bs{B}_bf16_{impl}_auto``.

Times are CUDA-event medians after warm-up (utils/benchmark.time_call);
``mfu_pct`` divides FLOPs counted on the plain forward (the same for every
impl and dtype) by the card's peak for the row's dtype. Prints one JSON line
with the root bench's keys, plus ``device`` and the rows' own values.
"""

from __future__ import annotations

import argparse
import json
import sys

BASELINE_AU_S = 213.2  # 2080 Ti fwd bs4 (BASELINE.md derived)
TRAIN_BASELINE_AU_S = 47.2  # 2080 Ti bwd bs4, 11.8 ex/s (README.md:123)
FIDELITY_GATE_DB = 35.0
INT8_GATE_DB = 25.0
SECONDS = 4.0
SR = 8000
HP = dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
          enc_kernel_size=21, enc_num_basis=512, num_sources=2)
REPS, WARMUP = 21, 3


def _round(v, digits=1):
    return round(v, digits) if v is not None else None


def main(argv=None, hp=None, seconds: float = SECONDS, reps: int = REPS) -> int:
    """Run the rows and print the line. hp overrides :data:`HP` (the tests'
    toy widths); seconds and reps set the input length and the timed calls."""
    p = argparse.ArgumentParser(description="Headline benchmark of the port")
    p.add_argument("--device", default="cuda",
                   help="torch device to measure on; never falls back to the CPU")
    args = p.parse_args(argv)

    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.models import quantized as q
    from sudo_rm_rf_tpu_torch.models.fast_inference import cast_model, improved_forward_fast
    from sudo_rm_rf_tpu_torch.train.autotune import autotune_train_config
    from sudo_rm_rf_tpu_torch.utils.benchmark import (
        backward_flops,
        forward_flops,
        mfu_pct,
        time_call,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    hp = dict(HP, **(hp or {}))
    t = int(seconds * SR)
    rand = lambda b, seed: torch.randn(  # noqa: E731
        (b, 1, t), generator=torch.Generator().manual_seed(seed)).to(device)
    timed = lambda fn: time_call(fn, device, n=reps, warmup=WARMUP)  # noqa: E731
    model = models.get_model("relu", **hp, device=device,
                             generator=torch.Generator().manual_seed(0)).eval()
    x4, x8 = rand(4, 1), rand(8, 2)

    # conservative: bs4 fp32 through the serving default
    ref = improved_forward_fast(model, x4)
    cons_secs = timed(lambda: improved_forward_fast(model, x4))
    cons_au = 4 * seconds / cons_secs

    # max: bs8 full-bf16 module forward; fidelity on the bs4 batch
    mbf = cast_model(model, torch.bfloat16)
    with torch.no_grad():
        bf = mbf(x4.bfloat16()).float()
        max_secs = timed(lambda: mbf(x8.bfloat16()))
    fidelity = q.fidelity_db(ref, bf)
    max_au = 8 * seconds / max_secs

    # int8: static scales calibrated on a held-out batch; fidelity on bs4
    qp = q.quantize_improved_params(model)
    kw = dict(upsampling_depth=hp["upsampling_depth"], enc_kernel_size=hp["enc_kernel_size"],
              num_sources=hp["num_sources"])
    scales = q.calibrate_improved_scales(qp, rand(4, 7), **kw)
    int8_fid = q.fidelity_db(ref, q.improved_forward_int8(qp, x4, scales=scales, **kw))
    x8f = rand(8, 3)
    int8_secs = timed(lambda: q.improved_forward_int8(qp, x8f, scales=scales, **kw))
    int8_au = 8 * seconds / int8_secs

    # train: the autotuned (block form, batch) of a full bf16 Trainer step
    tuned = autotune_train_config(hp, batch_sizes=(4, 8, 16), compute_dtype="bfloat16",
                                  model_type="relu", audio_seconds=seconds, fs=SR,
                                  n_hi=reps, device=device)
    tuned_row = next(r for r in tuned.rows
                     if r.impl == tuned.impl and r.batch_size == tuned.batch_size)
    train_secs = tuned_row.ms_per_step / 1e3
    train_au = tuned_row.audio_sec_per_sec
    tr_model = models.get_model("relu", **hp, block_impl=tuned.impl, device=device)

    mfu = {
        "bs4_fp32_kernel": mfu_pct(forward_flops(model, 4, t), cons_secs, "float32", device),
        "bs8_bf16_module": mfu_pct(forward_flops(model, 8, t), max_secs, "bfloat16", device),
        "bs8_int8": mfu_pct(forward_flops(model, 8, t), int8_secs, "int8", device),
    }
    train_mfu = mfu_pct(backward_flops(tr_model, tuned.batch_size, t), train_secs,
                        "bfloat16", device)

    gated = fidelity >= FIDELITY_GATE_DB and max_au > cons_au
    value = max_au if gated else cons_au
    headline_fid = fidelity if gated else None
    config = "bs8_bf16_module" if gated else "bs4_fp32_kernel"
    int8_gated = int8_fid >= INT8_GATE_DB
    if int8_gated and int8_au > value:
        value, config, headline_fid = int8_au, "bs8_int8", int8_fid
    print(json.dumps({
        "metric": "fwd_realtime_factor_u16_bases512_max",
        "value": round(value, 2),
        "unit": "audio-sec/sec/chip",
        "vs_baseline": round(value / BASELINE_AU_S, 3),
        "config": config,
        # fidelity (dB vs the fp32 serving output) of the config 'value'
        # came from; null == the fp32 path itself
        "headline_fidelity_db": _round(headline_fid),
        "bf16_fidelity_db": round(fidelity, 1),
        "fidelity_gate_db": FIDELITY_GATE_DB,
        "bf16_gate_passed": fidelity >= FIDELITY_GATE_DB,
        "max_bs8_bf16": round(max_au, 2),
        "conservative_bs4_fp32": round(cons_au, 2),
        "int8_bs8": round(int8_au, 2),
        "int8_fidelity_db": round(int8_fid, 1),
        "int8_gate_db": INT8_GATE_DB,
        "int8_gate_passed": int8_gated,
        "int8_scales": "static_calibrated",
        "mfu_pct": _round(mfu[config]),
        "mfu_pct_conservative": _round(mfu["bs4_fp32_kernel"]),
        "train_config": f"bs{tuned.batch_size}_bf16_{tuned.impl}_auto",
        "train_ms_per_step": round(train_secs * 1e3, 2),
        "train_au_s_per_s": round(train_au, 1),
        "train_vs_baseline": round(train_au / TRAIN_BASELINE_AU_S, 3),
        "train_mfu_pct": _round(train_mfu),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
