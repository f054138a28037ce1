"""The GroupComm cell's files: a toy cell through the harness on the CPU,
correct when sound and not when its forward is broken underneath; the
closed-form count against FlopCounterMode; the seeded weights; the TAC
readers on hand-made traces and spans; and on a card, every cell's traced
line against the metrics BENCHMARK.json lists for it."""

import contextlib
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from perfbench import control, core, flops_gc, run, trace, weights
from perfbench.drivers import serve_gc_batches
from perfbench.reference import groupcomm as ref
from perfbench.tests.conftest import SERVE

TOY_GC = dict(model_type="groupcomm_v2", in_audio_channels=1, out_channels=32,
              in_channels=64, num_blocks=2, upsampling_depth=3, enc_kernel_size=21,
              enc_num_basis=24, num_sources=2, group_size=4, fs=8000,
              serve={"impl": "kernel", "compute_dtype": None})
WIDTHS = [
    {k: v for k, v in TOY_GC.items() if k not in ("model_type", "fs", "serve")},
    dict(in_audio_channels=2, out_channels=24, in_channels=48, num_blocks=3,
         upsampling_depth=4, enc_kernel_size=11, enc_num_basis=16, num_sources=3,
         group_size=3),
]
CELL = "gc-u16-batch32"


def _toy_cell():
    tr = dict(core.load_json(core.HERE / "traffic" / "offline_gc_batch32_4s.json"), **SERVE)
    return core.Cell("toy-gc", "toy", dict(TOY_GC), "offline_gc_batch32_4s", tr, 1, [], [])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextlib.contextmanager
def _broken_forward(how: str):
    """``groupcomm_forward_fast`` with one row's estimate scaled by 1.01
    (``answer``) or the second half of the batch zeroed (``half_batch``)."""
    from sudo_rm_rf_tpu_torch.models import fast_inference

    plain = fast_inference.groupcomm_forward_fast

    def broken(model, x, **kw):
        est = plain(model, x, **kw)
        if how == "answer":
            est[0, 0] *= 1.01
        else:
            est[est.shape[0] // 2:] = 0.0
        return est

    fast_inference.groupcomm_forward_fast = broken
    try:
        yield
    finally:
        fast_inference.groupcomm_forward_fast = plain


def test_a_sound_toy_run_is_correct():
    line = run.run_cell(_toy_cell(), 2**31 + 5, 0.2, False, "cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["rel_err_max"]["value"] < 1e-5


@pytest.mark.parametrize("how", ["answer", "half_batch"])
def test_serving_faults_fail_the_check(how):
    with _broken_forward(how):
        assert not run.run_cell(_toy_cell(), 2**31 + 5, 0.2, False, "cpu")["correct"]


@pytest.mark.card
@pytest.mark.parametrize("how", ["answer", "half_batch"])
def test_serving_faults_fail_the_check_at_the_cells_size(how):
    device = _card()
    cell = core.load_cell(CELL)
    with _broken_forward(how):
        r = control.readings(cell, 2**31 + 29, 0.5, device, control=False)
    assert not all(c.ok for c in core.checks_from(r["program"], cell.traffic["limits"])), r


def _meta_weights(hp):
    from sudo_rm_rf_tpu_torch.models import GroupCommSuDORMRF

    with torch.device("meta"):
        model = GroupCommSuDORMRF(**hp)
    return {n: p.detach() for n, p in model.named_parameters()}


@pytest.mark.parametrize("hp", WIDTHS)
@pytest.mark.parametrize("batch,n_samples", [(2, 4000), (3, 5123)])
def test_forward_flops_match_flop_counter(hp, batch, n_samples):
    w = _meta_weights(hp)
    x = torch.empty((batch, hp["in_audio_channels"], n_samples), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(w, hp, x)
    assert flops_gc.forward_flops(hp, batch, n_samples) == counter.get_total_flops()


def test_weights_repeat_for_a_seed_and_cover_every_leaf():
    hp = WIDTHS[0]
    m1, f1, names = serve_gc_batches.gc_model(torch, hp, 5, "cpu")
    _, f2, _ = serve_gc_batches.gc_model(torch, hp, 5, "cpu")
    _, f3, _ = serve_gc_batches.gc_model(torch, hp, 6, "cpu")
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    assert f1.numel() == sum(p.numel() for p in m1.parameters())
    w = weights.unflatten(f1, names)
    for n, p in m1.named_parameters():
        assert torch.equal(p.detach(), w[n]), n
    # TAC's Linears as groupcomm_sudormrf.Linear draws them: +-1/sqrt(in)
    for lin, fan_in in (("TAC_input", 8), ("TAC_mean", 24), ("TAC_output", 48)):
        for leaf in ("weight", "bias"):
            v = w[f"sm.1.TAC.{lin}.0.{leaf}"]
            assert float(v.abs().max()) <= 1 / math.sqrt(fan_in)
            assert float(v.abs().max()) > 0.5 / math.sqrt(fan_in)
    assert 0.19 < float(w["sm.0.TAC.TAC_output.1.weight"]) < 0.31
    assert float(w["sm.0.TAC.TAC_norm.gamma"].min()) >= 0.9


_K1 = "void split_kernel(float const*)"


def _ev(name, start, dur):
    return trace.DeviceEvent(name, start, dur, name.startswith(("Memcpy", "Memset")))


def _forward(t0, tac_ns, memset=False):
    """One toy forward of 3 K1 calls of two kernels each: the encoder and
    the first TAC, then a TAC between calls, the decoder and the copy back;
    returns (events, the end)."""
    evs, t = [], t0

    def add(name, dur):
        nonlocal t
        evs.append(_ev(name, t, dur))
        t += dur + 5

    add("at::native::elementwise_kernel", 40)  # encoder and first TAC: not counted
    for call in range(3):
        if call:
            add("sm80_xmma_gemm_f32f32", tac_ns[0])
            if memset:
                add("Memset (Device)", 7)
            add("at::native::vectorized_elementwise_kernel", tac_ns[1])
        add(_K1, 100)
        add("void gemm_kernel<64>(float const*)", 100)
    add("cudnn::detail::dgrad_engine", 60)  # decoder: not counted
    add("Memcpy DtoH (Device -> Pageable)", 30)
    return evs, t


def test_tac_ms_on_a_hand_made_trace():
    reader = core.load_module(core.HERE / "metrics" / "tac_ms.gc.py")
    events = [_ev("at::native::reduce_kernel", 0, 1000)]  # before any K1 kernel
    t = 2000
    for tac_ns, memset in (((10, 20), False), ((30, 40), True), ((50, 60), False)):
        evs, t = _forward(t, tac_ns, memset)
        events += evs
    # 3 batches, 3 K1 calls each (2 stretches a batch), 3 TAC calls a batch
    tr = trace.Trace(events, 1.0, units=3, counters={"k1_launches": 9, "tac_calls": 9})
    stretches = 2 * (10 + 20) + 2 * (30 + 40) + 2 * (50 + 60)
    assert reader.read(tr) == pytest.approx(stretches / 1e6 / (3 * 2) * 3)
    # a stretch that crosses a copy back is never counted
    assert reader.stretch_ns([_ev(_K1, 0, 1), _ev("elementwise", 2, 50),
                              _ev("Memcpy DtoH (Device -> Pinned)", 60, 1),
                              _ev(_K1, 70, 1)]) == 0
    # no kernel between the K1 calls reads 0, not None
    bare = [_ev(_K1, 10 * i, 5) for i in range(4)] + [_ev("Memcpy DtoH", 50, 1)]
    assert reader.read(trace.Trace(bare, 1.0, units=1,
                                   counters={"k1_launches": 4, "tac_calls": 4})) == 0.0
    # nothing to read: no batch, one K1 call a batch, or no TAC counter
    assert reader.read(trace.Trace(bare, 1.0, units=0, counters={"k1_launches": 4,
                                                                 "tac_calls": 4})) is None
    assert reader.read(trace.Trace(bare, 1.0, units=4, counters={"k1_launches": 4,
                                                                 "tac_calls": 4})) is None
    assert reader.read(trace.Trace(bare, 1.0, units=1, counters={"k1_launches": 4})) is None


def test_tac_host_us_reads_the_forwards_tac_spans():
    from sudo_rm_rf_tpu_torch.models.fast_inference import groupcomm_forward_fast
    from sudo_rm_rf_tpu_torch.utils import tracing

    reader = core.load_module(core.HERE / "metrics" / "tac_host_us.gc.py")
    hp = WIDTHS[0]
    model, _, _ = serve_gc_batches.gc_model(torch, hp, 3, "cpu")
    x = torch.randn(2, 1600)
    tracing.clear()
    try:
        assert reader.read(trace.Trace([], 1.0, units=0)) is None
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                groupcomm_forward_fast(model, x, impl="fma_merged")
        tacs = [r.end_ns - r.start_ns for r in tracing.spans() if r.name == "forward.tac"]
        assert len(tacs) == 2 * hp["num_blocks"]
        got = reader.read(trace.Trace([], 1.0, units=2))
        assert got == pytest.approx(sum(tacs) / len(tacs) / 1e3)
    finally:
        tracing.clear()


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in core.load_json(
    core.ROOT / "BENCHMARK.json")["workloads"]])
def test_every_cells_traced_line_has_its_metrics(workload):
    from sudo_rm_rf_tpu_torch.utils import tracing

    device = _card()
    cell = core.load_cell(workload)
    tracing.clear()  # records of earlier windows in this process
    line = run.run_cell(cell, 2**31 + 41, 2.0, True, device)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}, line["metrics"]
    assert all(math.isfinite(m["value"]) for m in line["metrics"].values()), line["metrics"]
