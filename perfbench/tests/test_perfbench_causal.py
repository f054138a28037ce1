"""The causal streaming cell's files: a toy ``streams`` cell through the
harness on the CPU, correct when sound and not with each of three faults
planted underneath; the closed-form count against FlopCounterMode; the
seeded weights; a tree without ``num_streams`` refused in set-up; and the
cell's five readers on hand-made traces beside the program's own spans."""

import functools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from perfbench import core, flops_causal, run, trace, weights
from perfbench.drivers import streams
from perfbench.reference import causal as ref

TOY_CAUSAL = dict(model_type="causal", in_audio_channels=1, out_channels=16, in_channels=32,
                  num_blocks=2, upsampling_depth=2, enc_kernel_size=21, enc_num_basis=16,
                  num_sources=2, fs=8000, skipinit_gain=0.2,
                  serve={"path": "StreamingSeparator", "compute_dtype": None, "tf32": False})
TOY_STREAMS = dict(streams=3, hop_samples=40, context_samples=160, lookahead_samples=40,
                   audio_seconds=0.3, sample=4)
WIDTHS = [
    {k: v for k, v in TOY_CAUSAL.items() if k in streams.MODEL_KEYS},
    dict(in_audio_channels=2, out_channels=24, in_channels=48, num_blocks=3,
         upsampling_depth=3, enc_kernel_size=11, enc_num_basis=16, num_sources=3),
    {k: v for k, v in core.load_json(core.HERE / "configs" / "causal_v3_u16_b512.json").items()
     if k in streams.MODEL_KEYS},
]
SEED = 2**31 + 7
READERS = ("idle_pct.stream", "launches_per_step.stream", "idle_dispatch_ms.stream",
           "block_host_us.stream", "mfu_pct.stream")


def _toy_cell():
    tr = dict(core.load_json(core.HERE / "traffic" / "stream16_hop160_ctx3200.json"),
              **TOY_STREAMS)
    return core.Cell("toy-stream", "toy", dict(TOY_CAUSAL), "stream16_hop160_ctx3200", tr, 1,
                     [], [])


def _run(cell=None):
    return run.run_cell(cell or _toy_cell(), SEED, 0.2, False, "cpu")


def test_the_cell_is_in_the_benchmark():
    cell = core.load_cell("causal-stream-hop")
    assert cell.config["model_type"] == "causal" and cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"latency_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    tr = cell.traffic
    assert (tr["streams"], tr["hop_samples"], tr["context_samples"]) == (16, 160, 3200)
    # the window fills in 21 hops, the set-up's pushes
    assert streams.Driver(cell, 1, "cpu").warm == 21


def test_a_sound_toy_run_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == set()  # the toy cell lists no end-to-end metric
    assert line["checks"]["rel_err_max"]["value"] < 1e-5


def test_a_sound_toy_run_reports_its_latency():
    cell = _toy_cell()
    cell.end_to_end = [{"name": "latency_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}]
    line = _run(cell)
    assert line["correct"] and line["metrics"]["latency_p95_ms"]["value"] > 0


def _unrolled(self, hops):
    """The newest hop written over the window's last hop, nothing shifted."""
    self._buffer = torch.cat([self._buffer[..., :-self.hop], hops[:, None]], dim=-1)


@pytest.mark.parametrize("fault", ["unrolled", "hop_off", "swapped"])
def test_each_fault_fails_the_check(fault, monkeypatch):
    from sudo_rm_rf_tpu_torch.inference import StreamingSeparator

    if fault == "unrolled":
        monkeypatch.setattr(StreamingSeparator, "_roll", _unrolled)
    elif fault == "hop_off":  # the emitted slice one hop earlier
        plain_init = StreamingSeparator.__init__

        @functools.wraps(plain_init)
        def init(self, *a, **kw):
            plain_init(self, *a, **kw)
            self._emit = slice(self._emit.start - self.hop, self._emit.stop - self.hop)

        monkeypatch.setattr(StreamingSeparator, "__init__", init)
    else:  # streams 0 and 1 swapped in the answer
        plain_push = StreamingSeparator.push

        def push(self, hop_audio):
            out = plain_push(self, hop_audio)
            return out[[1, 0] + list(range(2, out.shape[0]))]

        monkeypatch.setattr(StreamingSeparator, "push", push)
    line = _run()
    assert not line["correct"], line["checks"]


def test_a_tree_without_num_streams_is_refused_in_setup(monkeypatch):
    import sudo_rm_rf_tpu_torch.inference as inference

    class OneStream:
        def __init__(self, model, hop_samples, context_samples, num_sources=2,
                     lookahead_samples=None):
            raise AssertionError("set-up went past the check")

    monkeypatch.setattr(inference, "StreamingSeparator", OneStream)
    drv = streams.Driver(_toy_cell(), SEED, "cpu")
    with pytest.raises(core.BenchError, match="num_streams"):
        drv.setup()


def _meta_weights(hp):
    from sudo_rm_rf_tpu_torch.models import CausalSuDORMRF

    with torch.device("meta"):
        model = CausalSuDORMRF(**hp)
    return {n: p.detach() for n, p in model.named_parameters()}


@pytest.mark.parametrize("hp", WIDTHS, ids=["toy", "stereo", "cell"])
@pytest.mark.parametrize("batch,n_samples", [(16, 3360), (3, 1001)])
def test_forward_flops_match_flop_counter(hp, batch, n_samples):
    w = _meta_weights(hp)
    x = torch.empty((batch, hp["in_audio_channels"], n_samples), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(w, hp, x)
    assert flops_causal.forward_flops(hp, batch, n_samples) == counter.get_total_flops()


def test_weights_repeat_for_a_seed_and_set_every_gain():
    hp = dict(WIDTHS[0], skipinit_gain=0.2)
    m1, f1, names = streams.causal_model(torch, hp, 5, "cpu")
    _, f2, _ = streams.causal_model(torch, hp, 5, "cpu")
    _, f3, _ = streams.causal_model(torch, hp, 6, "cpu")
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    assert f1.numel() == sum(p.numel() for p in m1.parameters())
    w = weights.unflatten(f1, names)
    for n, p in m1.named_parameters():
        assert torch.equal(p.detach(), w[n]), n
    gains = [float(w[f"sm.{i}.skipinit_gain"]) for i in range(hp["num_blocks"])]
    assert gains == pytest.approx([0.2] * hp["num_blocks"])
    # the model's buffers are its own: every masked conv's mask zeroes its last k//2 taps
    from sudo_rm_rf_tpu_torch.models.causal_sudormrf import CausalConv1d

    for mod in m1.modules():
        if isinstance(mod, CausalConv1d) and mod.masked:
            k = mod.weight.shape[-1]
            assert mod.mask.tolist() == [1.0] * (k - k // 2) + [0.0] * (k // 2)


def test_the_streaming_rule():
    audio = np.arange(1, 11, dtype=np.float32)[None].repeat(2, axis=0)
    audio[1] *= -1
    np.testing.assert_array_equal(ref.windows(audio, 0, 2, 6)[0], [0, 0, 0, 0, 1, 2])
    np.testing.assert_array_equal(ref.windows(audio, 2, 2, 6)[1], [-1, -2, -3, -4, -5, -6])
    # round the end of the audio: a looped stream
    np.testing.assert_array_equal(ref.windows(audio, 5, 2, 6)[0], [7, 8, 9, 10, 1, 2])
    est = torch.arange(12.0).view(1, 1, 12)
    assert ref.emitted(est, 3, 4).tolist() == [[[5.0, 6.0, 7.0]]]


def _ev(name, start, dur):
    return trace.DeviceEvent(name, start, dur, name.startswith(("Memcpy", "Memset")))


def _reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py")


def test_readers_on_a_synthetic_trace_beside_the_programs_spans():
    """Spans from three real steps of a toy separator; device events laid
    by hand beside them: busy from each step's start to its forward's
    start, and from the forward's end to the step's end. So the device is
    idle under the forward for exactly the forward's span, and the caller's
    between steps."""
    from sudo_rm_rf_tpu_torch.inference import StreamingSeparator
    from sudo_rm_rf_tpu_torch.utils import tracing

    hp = dict(WIDTHS[0], skipinit_gain=0.2)
    model, _, _ = streams.causal_model(torch, hp, 3, "cpu")
    sep = StreamingSeparator(model, 40, 160, num_streams=3)
    hops = np.zeros((3, 40), np.float32)
    tracing.clear()
    try:
        assert _reader("block_host_us.stream").read(trace.Trace([], 1.0, units=0)) is None
        steps = StreamingSeparator.steps
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                sep.push(hops)
        units = StreamingSeparator.steps - steps
        recs = tracing.spans()
        roots = [r for r in recs if r.parent == 0]
        assert units == 3 and len(roots) == units
        fwd = {r.parent: r for r in recs if r.name == "forward"}
        events = []
        for root in roots:
            f = fwd[root.id]
            events += [_ev("void at::native::elementwise_kernel", root.start_ns,
                           f.start_ns - root.start_ns),
                       _ev("Memcpy DtoH (Device -> Pageable)", f.end_ns, root.end_ns - f.end_ns)]
        flops = flops_causal.forward_flops(hp, 3, 200)
        tr = trace.Trace(events, 0.5, units=units, counters={"steps": 3, "mask_applies": 15},
                         shapes={"forward_flops": flops})
        got = {name: _reader(name).read(tr) for name in READERS}
        blocks = [r.end_ns - r.start_ns for r in recs if r.name == "forward.block"]
        assert len(blocks) == units * hp["num_blocks"]
        assert got["block_host_us.stream"] == pytest.approx(sum(blocks) / len(blocks) / 1e3)
        forward_ms = sum(f.end_ns - f.start_ns for f in fwd.values()) / 1e6 / units
        assert got["idle_dispatch_ms.stream"] == pytest.approx(forward_ms)
        assert got["launches_per_step.stream"] == 2.0
        assert got["idle_pct.stream"] == pytest.approx(100 * (1 - tr.busy_s / 0.5))
        assert got["mfu_pct.stream"] == pytest.approx(100 * 3 * flops / 0.5 / 495e12)
        # the roots must be the window's steps
        with pytest.raises(AssertionError):
            _reader("idle_dispatch_ms.stream").read(
                trace.Trace(events, 0.5, units=units + 1, shapes={"forward_flops": flops}))
    finally:
        tracing.clear()
    # no span recorded: the span readers leave their metric out
    tr = trace.Trace([], 1.0, units=2, shapes={"forward_flops": 1})
    assert _reader("idle_dispatch_ms.stream").read(tr) is None
    assert _reader("block_host_us.stream").read(tr) is None
    assert _reader("launches_per_step.stream").read(tr) is None
    assert _reader("idle_pct.stream").read(tr) is None


def test_the_config_file_holds_the_class_defaults():
    from sudo_rm_rf_tpu_torch.models import CausalSuDORMRF

    conf = core.load_json(core.HERE / "configs" / "causal_v3_u16_b512.json")
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "causal_v3_u16_b512")
    assert entry["source"] in conf["source"] and entry["reduced"] == conf["reduced"] == []
    with torch.device("meta"):
        model = CausalSuDORMRF()
    for k in streams.MODEL_KEYS:
        assert getattr(model, k) == conf[k], k
    assert sum(p.numel() for p in model.parameters()) == 3_090_146
