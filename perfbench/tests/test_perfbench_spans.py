"""The span readers: idle time attributed to the innermost host span over
hand-made traces, each reader's value and its silence on a tree without the
tracing module, a toy recordings window traced on the CPU, and on a card the
spans' clock against the card's copies."""

import sys

import numpy as np
import pytest

from perfbench import core, spans
from perfbench import trace as tr

US = 1_000  # ns
NEW_READERS = ("idle_frontend_ms.latency", "idle_dispatch_ms.latency", "idle_fetch_ms.latency",
               "idle_client_ms.latency", "k1_host_us.latency", "chunk_fill_pct.latency",
               "copy_mb_per_request.latency", "idle_dispatch_ms.serve")


def _reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py")


def _ev(start_us, dur_us, name="kernel"):
    return tr.DeviceEvent(name, start_us * US, dur_us * US, name.startswith("Memcpy"))


class _Tree:
    """Hand-made span records with ids, parents and requests as the
    program's tracing module gives them."""

    def __init__(self):
        from sudo_rm_rf_tpu_torch.utils import tracing

        self.Span, self.recs = tracing.Span, []

    def add(self, name, start_us, end_us, parent=None, **attrs):
        sid = len(self.recs) + 1
        req = parent.request if parent else sid
        r = self.Span(name, start_us * US, end_us * US, sid, parent.id if parent else 0, req,
                      attrs)
        self.recs.append(r)
        return r


@pytest.fixture
def recorded(monkeypatch):
    """Install a hand-made list as what the program recorded."""
    from sudo_rm_rf_tpu_torch.utils import tracing

    def install(recs):
        monkeypatch.setattr(tracing, "spans", lambda: recs)
    return install


def _request(tree, at):
    """One recording from ``at`` us: separate 0-100 holding chunk 0-10,
    batch 10-80 (upload 10-20, forward 20-50 holding forward 22-48 and its
    block 25-35, fetch 50-78) and stitch 80-98 holding align 85-90."""
    sep = tree.add("overlap_add.separate", at, at + 100, samples=10, chunks=3)
    tree.add("overlap_add.chunk", at, at + 10, sep)
    b = tree.add("overlap_add.batch", at + 10, at + 80, sep, rows=3, slots=8, h2d_bytes=2_000_000,
                 d2h_bytes=1_500_000)
    tree.add("overlap_add.upload", at + 10, at + 20, b)
    fw = tree.add("overlap_add.forward", at + 20, at + 50, b)
    f = tree.add("forward", at + 22, at + 48, fw, rows=8)
    tree.add("forward.block", at + 25, at + 35, f)
    tree.add("overlap_add.fetch", at + 50, at + 78, b)
    st = tree.add("overlap_add.stitch", at + 80, at + 98, sep)
    tree.add("overlap_add.align", at + 85, at + 90, st)


def test_idle_goes_to_the_innermost_span_or_the_caller():
    t = _Tree()
    _request(t, 0)
    # device busy 0-5 (chunk), 15-24 (upload into forward), 30-60 (block
    # into fetch), 70-86 (fetch into align), then 150-160 after the request:
    # gaps 5-15 chunk 5 + batch 0 + upload 5; 24-30 forward 1 + block 5;
    # 60-70 fetch 10; 86-150 align 4, stitch 8, separate 2, caller 50
    events = [_ev(0, 5), _ev(15, 9), _ev(30, 30), _ev(70, 16), _ev(150, 10)]
    got = spans.idle_by_span(events, t.recs)
    assert got == {"overlap_add.chunk": 5 * US, "overlap_add.upload": 5 * US,
                   "forward": 1 * US, "forward.block": 5 * US, "overlap_add.fetch": 10 * US,
                   "overlap_add.align": 4 * US, "overlap_add.stitch": 8 * US,
                   "overlap_add.separate": 2 * US, spans.CALLER: 50 * US}
    assert sum(got.values()) == sum(hi - lo for lo, hi in spans.device_gaps(events))


def test_a_gap_over_two_requests_and_the_window_edges():
    t = _Tree()
    _request(t, 0)
    _request(t, 200)
    # busy only inside each forward's block: a gap from the first block's
    # end to the second's start covers both requests and the caller's turn
    events = [_ev(25, 10), _ev(225, 10)]
    got = spans.idle_by_span(events, t.recs)
    # the first request from its block's end, the caller's 100-200, the
    # second request to its block's start; the window's edges are not gaps
    assert got == {"forward": (13 + 3) * US, "overlap_add.forward": (2 + 2) * US,
                   "overlap_add.fetch": 28 * US, "overlap_add.batch": 2 * US,
                   "overlap_add.stitch": 13 * US, "overlap_add.align": 5 * US,
                   "overlap_add.separate": 2 * US, spans.CALLER: 100 * US,
                   "overlap_add.chunk": 10 * US, "overlap_add.upload": 10 * US}
    assert sum(got.values()) == 190 * US


def test_overlapping_events_make_one_busy_interval():
    assert spans.device_gaps([_ev(10, 5), _ev(0, 12), _ev(20, 1), _ev(20, 3)]) == [
        (15 * US, 20 * US)]


def _trace_with(recs, units, events=None):
    return tr.Trace(events if events is not None else [_ev(0, 5), _ev(15, 9), _ev(30, 30),
                                                       _ev(70, 16), _ev(150, 10)],
                    0.001, units=units)


def test_each_reader_over_one_recording(recorded):
    t = _Tree()
    _request(t, 0)
    recorded(t.recs)
    trace = _trace_with(t.recs, units=1)
    want = {"idle_frontend_ms.latency": (5 + 5 + 8 + 4 + 2) / 1e3,
            "idle_dispatch_ms.latency": 6 / 1e3, "idle_fetch_ms.latency": 10 / 1e3,
            "idle_client_ms.latency": 50 / 1e3, "k1_host_us.latency": 10.0,
            "chunk_fill_pct.latency": 100 * 3 / 8, "copy_mb_per_request.latency": 3.5}
    for name, value in want.items():
        assert _reader(name).read(trace) == pytest.approx(value), name
    split = sum(want[n] for n in want if n.startswith("idle_"))
    assert split == pytest.approx(sum(hi - lo for lo, hi in spans.device_gaps(trace.events)) / 1e6)
    # a root span a unit of the window, or the reader refuses
    with pytest.raises(AssertionError):
        _reader("chunk_fill_pct.latency").read(_trace_with(t.recs, units=2))


def test_serve_dispatch_over_forward_roots(recorded):
    t = _Tree()
    for at in (0, 100):
        f = t.add("forward", at, at + 40, rows=32)
        t.add("forward.encode", at, at + 5, f)
        t.add("forward.block", at + 5, at + 30, f)
        t.add("forward.decode", at + 30, at + 40, f)
    recorded(t.recs)
    # each batch: busy 3-20 and 25-60 (the caller's copy back to 60), so
    # idle 0-3 of the second's encode, 20-25 of a block, 60-100 the caller's
    events = [_ev(3, 17), _ev(25, 35), _ev(103, 17), _ev(125, 35)]
    trace = _trace_with(t.recs, units=2, events=events)
    assert _reader("idle_dispatch_ms.serve").read(trace) == pytest.approx((3 + 5 + 5) / 2 / 1e3)
    assert _reader("idle_client_ms.latency").read(trace) == pytest.approx(40 / 2 / 1e3)


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_tree_without_the_tracing_module_reads_nothing(name, monkeypatch):
    import sudo_rm_rf_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "sudo_rm_rf_tpu_torch.utils.tracing", None)
    assert _reader(name).read(_trace_with([], units=1)) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_window_without_spans_reads_nothing(name, recorded):
    recorded([])
    assert _reader(name).read(_trace_with([], units=1)) is None


def test_a_toy_recordings_window_splits_all_its_idle(recordings_cell):
    """The recordings driver at toy widths, traced on the CPU with the
    profiler's CPU ops standing in for device events: the four idle readers
    split every gap, and the counts match the lengths served."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.drivers import recordings
    from sudo_rm_rf_tpu_torch.utils import tracing

    d = recordings.Driver(recordings_cell, 2**33 + 5, "cpu")
    d.setup()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        win = d.window(0.3)
    ops = [tr.DeviceEvent(e.name(), e.start_ns(), e.duration_ns(), False)
           for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    trace = tr.Trace(sorted(ops, key=lambda e: e.start_ns), 0.3, **d.trace_info())
    assert trace.units == win["attempted"]
    try:
        idle = {n: _reader(n).read(trace) for n in NEW_READERS[:4]}
        gaps = sum(hi - lo for lo, hi in spans.device_gaps(trace.events)) / 1e6
        assert sum(idle.values()) == pytest.approx(gaps / trace.units)
        chunk = d.chunk
        n_chunks = [max(1, -(-(int(d.lengths[k]) - chunk) // (chunk // 2)) + 1) for k in d.served]
        slots = sum(-(-n // d.batch_chunks) * d.batch_chunks for n in n_chunks)
        assert _reader("chunk_fill_pct.latency").read(trace) == pytest.approx(
            100 * sum(n_chunks) / slots)
        assert _reader("copy_mb_per_request.latency").read(trace) == pytest.approx(
            4 * chunk * (slots + 2 * sum(n_chunks)) / 1e6 / len(d.served))
        assert _reader("k1_host_us.latency").read(trace) > 0
    finally:
        tracing.clear()
        d.release()


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_the_spans_clock_brackets_the_cards_copies():
    """One ``separate`` of a 58 s mixture at the recordings cell's size,
    traced as the benchmark traces: each batch's copy up lies inside its
    ``overlap_add.upload`` span and its copy back inside its
    ``overlap_add.fetch`` span, within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.drivers import recordings
    from sudo_rm_rf_tpu_torch.utils import tracing

    device = _card()
    d = recordings.Driver(core.load_cell("u16-recordings"), 2**31 + 41, device)
    d.setup()
    k = int(np.argmin(np.abs(d.lengths - 58 * d.fs)))
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            d.separator.separate(d.mixtures[k])
        events = tr.device_events(prof)
        recs = list(tracing.spans())
    finally:
        tracing.clear()
        d.release()
    tol = 50 * US
    for span_name, way in (("overlap_add.upload", "HtoD"), ("overlap_add.fetch", "DtoH")):
        sp = sorted((r for r in recs if r.name == span_name), key=lambda r: r.start_ns)
        copies = [e for e in events if e.name.startswith("Memcpy") and way in e.name]
        assert len(sp) == len(copies) == 4, (span_name, len(sp), [e.name for e in copies])
        for r, e in zip(sp, copies):
            lead, lag = e.start_ns - r.start_ns, r.end_ns - (e.start_ns + e.dur_ns)
            print(f"{span_name} {way}: copy starts {lead} ns after the span, ends {lag} ns "
                  f"before it")
            assert lead >= -tol and lag >= -tol
