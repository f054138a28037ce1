"""GroupComm serving sweep of the PyTorch port (port-side copy of
``scripts/bench_gc_serving.py``, which imports JAX): every serving path of
GroupComm SuDoRM-RF v2 U16/512, group 16 (565,073 params), on one card.

  * every forward of ``fast_inference.GC_IMPLS`` (``kernel``: the fused
    TAC, and K1 on the group-folded layout, 16 launches a forward;
    ``fma_merged``; ``xla``), each in fp32 and with
    ``compute_dtype="bfloat16"`` from a copy cast once for it (rows
    ``<impl>_fp32``, ``<impl>_bf16``);
  * int8 (``models/quantized.py::groupcomm_forward_int8``) with dynamic and
    with static scales (``calibrate_gc_scales`` on a different batch).

Each row: ``path``, ``bs``, ``ms_batch`` (median of ``--n_hi`` calls, CUDA
events; the host clock on the CPU), ``au_s_per_s``, ``idle_pct`` (3
profiled calls; null on the CPU), ``k1_launches`` (a forward),
``fidelity_db`` against the fp32 ``xla`` forward and ``device``; a path
that raises prints its error instead.

``--families_sweep`` runs JAX's per-family int8 attribution instead: one
row with each family alone in int8 and one with all but it, then the
greedy search that returns the most damaging family (lowest only-F
fidelity) to bf16 until the 25 dB gate passes, ``gated_recipe`` (null
where none passes), and ``int8_mixed_gated`` timed at each ``--bs`` (its
row carries the gate's fidelity, ``gated_fidelity_db``, beside its own
batch's, ``fidelity_db``).

    python scripts/torch_bench_gc_serving.py [--bs 4 8] [--n_hi 21]
        [--families_sweep] [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SECONDS, SR = 4.0, 8000
HP = dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
          enc_kernel_size=21, enc_num_basis=512, num_sources=2, group_size=16)
# toy widths with 8 channels a group, which the int8 product needs
TINY = dict(out_channels=32, in_channels=64, num_blocks=2, upsampling_depth=2,
            enc_kernel_size=21, enc_num_basis=16, num_sources=2, group_size=4)
TINY_SECONDS = 0.25
GATE_DB = 25.0


def _setup(args):
    import torch

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.utils.benchmark import card_label, script_device

    device = script_device(args.device)
    hp, seconds = (TINY, TINY_SECONDS) if args.tiny else (HP, SECONDS)
    model = models.get_model("groupcomm_v2", **hp, device=device,
                             generator=torch.Generator().manual_seed(0)).eval()
    kw = dict(num_blocks=hp["num_blocks"], upsampling_depth=hp["upsampling_depth"],
              enc_kernel_size=hp["enc_kernel_size"], num_sources=hp["num_sources"],
              group_size=hp["group_size"])
    t = int(seconds * SR)

    def batch(bs, seed):
        return torch.randn((bs, 1, t), generator=torch.Generator().manual_seed(seed)).to(device)

    return device, card_label(device), model, kw, seconds, batch


def _timed(path, bs, fn, x, want, seconds, device, card, n_hi, **extra):
    from sudo_rm_rf_tpu_torch.models.quantized import fidelity_db
    from sudo_rm_rf_tpu_torch.utils.benchmark import profile_calls, time_call

    fid = fidelity_db(want, fn(x))
    secs = time_call(lambda: fn(x), device, n=n_hi)
    prof = profile_calls(lambda: fn(x), device)
    row = dict(path=path, bs=bs, **extra, ms_batch=secs * 1e3, au_s_per_s=bs * seconds / secs,
               idle_pct=prof["idle_pct"], k1_launches=prof["k1_launches"], fidelity_db=fid,
               device=card)
    print(json.dumps(row), flush=True)
    return row


def families_sweep(args) -> list:
    """Per-family int8 attribution, the greedy 25 dB gate search and the
    gated recipe's timed rows (returned)."""
    import torch

    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.models import quantized as q

    device, card, model, kw, seconds, batch = _setup(args)
    x0, x = batch(4, 1), batch(4, 2)
    want = fi.groupcomm_forward_fast(model, x, impl="xla")
    bf16 = fi.cast_model(model, torch.bfloat16, "fma_merged")

    def fid_of(families):
        if not families:  # the all-bf16 control
            return q.fidelity_db(want, fi.groupcomm_forward_fast(
                bf16, x, impl="fma_merged", compute_dtype="bfloat16"))
        qp = q.quantize_gc_params(model, families=tuple(families))
        sc = q.calibrate_gc_scales(qp, x0, **kw)
        return q.fidelity_db(want, q.groupcomm_forward_int8(qp, x, scales=sc, **kw))

    control, all_int8 = fid_of(()), fid_of(q.GC_ALL_FAMILIES)
    only = {f: fid_of((f,)) for f in q.GC_ALL_FAMILIES}
    all_but = {f: fid_of(tuple(g for g in q.GC_ALL_FAMILIES if g != f))
               for f in q.GC_ALL_FAMILIES}
    print(json.dumps({"attribution_only_F_int8": only, "device": card}), flush=True)
    print(json.dumps({"attribution_all_but_F_int8": all_but, "device": card}), flush=True)
    active = sorted(q.GC_ALL_FAMILIES, key=lambda f: only[f])
    recipe, dropped, fid = list(q.GC_ALL_FAMILIES), [], all_int8
    while fid < GATE_DB and active:
        worst = active.pop(0)
        recipe.remove(worst)
        dropped.append(worst)
        fid = fid_of(tuple(recipe))
        print(json.dumps({"greedy_drop": worst, "recipe": recipe, "fidelity_db": fid}),
              flush=True)
    passed = fid >= GATE_DB
    print(json.dumps({"bf16_control_db": control, "all_int8_db": all_int8,
                      "gated_recipe": recipe if passed else None, "kept_bf16": dropped,
                      "gated_fidelity_db": fid if passed else None, "gate_db": GATE_DB,
                      "device": card}), flush=True)
    rows = []
    if passed and recipe:
        qp = q.quantize_gc_params(model, families=tuple(recipe))
        sc = q.calibrate_gc_scales(qp, x0, **kw)
        fwd = lambda c: q.groupcomm_forward_int8(qp, c, scales=sc, **kw)  # noqa: E731
        for bs in args.bs:
            xb = batch(bs, 3)
            row = _timed("int8_mixed_gated", bs, fwd, xb,
                         fi.groupcomm_forward_fast(model, xb, impl="xla"), seconds, device,
                         card, args.n_hi, families=recipe, gated_fidelity_db=fid)
            rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bs", type=int, nargs="+", default=[4, 8])
    p.add_argument("--n_hi", type=int, default=21)
    p.add_argument("--families_sweep", action="store_true",
                   help="per-family int8 attribution and the greedy 25 dB gate search")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="toy widths and lengths for a CPU rehearsal (not a benchmark)")
    args = p.parse_args(argv)
    if args.families_sweep:
        return families_sweep(args)

    import torch

    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.models import quantized as q

    device, card, model, kw, seconds, batch = _setup(args)
    qp = q.quantize_gc_params(model)
    scales = q.calibrate_gc_scales(qp, batch(4, 1), **kw)
    fwd = fi.groupcomm_forward_fast
    casts = {impl: fi.cast_model(model, torch.bfloat16, impl) for impl in fi.GC_IMPLS}
    paths = {}
    for impl in fi.GC_IMPLS:
        paths[f"{impl}_fp32"] = lambda c, i=impl: fwd(model, c, impl=i)
        paths[f"{impl}_bf16"] = lambda c, i=impl: fwd(casts[i], c, impl=i,
                                                      compute_dtype="bfloat16")
    paths["int8_dynamic"] = lambda c: q.groupcomm_forward_int8(qp, c, **kw)
    paths["int8_static"] = lambda c: q.groupcomm_forward_int8(qp, c, scales=scales, **kw)
    rows = []
    for bs in args.bs:
        x = batch(bs, 2)
        want = fwd(model, x, impl="xla")
        for name, fn in paths.items():
            try:
                rows.append(_timed(name, bs, fn, x, want, seconds, device, card, args.n_hi))
            except (RuntimeError, ValueError) as e:  # out of memory, an int8 shape
                print(json.dumps({"path": name, "bs": bs, "error": repr(e)[:160],
                                  "device": card}), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
