"""The traced window's reduction: the interval union, the breakdown and the
per-layer readers over a hand-made trace."""

import pytest

from perfbench import core, flops
from perfbench import trace as tr

NS = 1_000_000  # 1 ms


def _ev(name, start_ms, dur_ms):
    return tr.DeviceEvent(name, int(start_ms * NS), int(dur_ms * NS),
                          name.startswith("Memcpy"))


def _reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py")


@pytest.mark.parametrize("spans,want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 12)], 12),
    ([(0, 10), (2, 3), (20, 25)], 15),
    ([(20, 25), (0, 10), (10, 20)], 25),
])
def test_union(spans, want):
    assert tr.union_ns(spans) == want


def _k1_trace(**kw):
    events = [_ev("void gemm_kernel<64>(float const*)", 0, 2), _ev("ladder_kernel", 2, 1),
              _ev("void at::native::conv_depthwise2d(float*)", 4, 3),
              _ev("Memcpy DtoH (Device -> Pageable)", 8, 1)]
    args = dict(units=2, counters={"k1_launches": 2},
                shapes={"k1": (4, 16, 32, 64, 3), "forward_flops": 1e12})
    args.update(kw)
    return tr.Trace(events, 0.010, **args)


def test_busy_idle_and_breakdown():
    t = _k1_trace()
    assert t.busy_s == pytest.approx(0.007)
    assert _reader("idle_pct.serve").read(t) == pytest.approx(30.0)
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["at::native::conv_depthwise2d", pytest.approx(0.003)]
    assert b["idle_gaps"] == [
        ["after ladder_kernel before at::native::conv_depthwise2d", pytest.approx(0.001)],
        ["after at::native::conv_depthwise2d before Memcpy DtoH", pytest.approx(0.001)]]
    assert len(b["device_ops"]) == 4


def test_k1_readers():
    t = _k1_trace()
    least = flops.block_least_seconds(4, 16, 32, 64, 3)["seconds"]
    assert _reader("k1_roofline_pct").read(t) == pytest.approx(100 * 2 * least / 0.003)
    assert _reader("outside_k1_ms").read(t) == pytest.approx(3.0 / 2)
    # K1 did not run: nothing to read; it ran and none of its kernels is seen: missing, not 0
    assert _reader("k1_roofline_pct").read(_k1_trace(counters={"k1_launches": 0})) is None
    t.events = [e for e in t.events if "kernel" not in e.name]
    assert _reader("k1_roofline_pct").read(t) is None


def test_rates_per_unit():
    t = _k1_trace()
    assert _reader("mfu_pct.serve").read(t) == pytest.approx(100 * 2 * 1e12 / 0.010 / 495e12)
    assert _reader("launches_per_request.latency").read(t) == 2.0
    assert _reader("launches_per_request.latency").read(_k1_trace(units=0)) is None
    assert _reader("idle_pct.latency").read(tr.Trace([], 1.0)) is None


def test_closed_loop_percentile_and_reservoir():
    calls = []
    loop = core.closed_loop(calls.append, 0.0, min_requests=5)
    assert loop["count"] == 5 and calls == list(range(5))
    assert core.percentile(list(range(1, 101)), 95) == 95
    assert core.percentile([3.0], 95) == 3.0
    r1, r2 = core.Reservoir(4, 9), core.Reservoir(4, 9)
    for i in range(100):
        r1.offer(i)
        r2.offer(i)
    assert r1.items == r2.items and len(set(r1.items)) == 4


def test_check_fails_on_nan_and_above_the_limit():
    import torch

    assert core.worst(torch.tensor([1.0, float("nan")])) == float("inf")
    checks = core.checks_from({"a": 0.5, "b": 2.0, "c": float("nan")},
                              {"a": 1.0, "b": 1.0, "c": 1.0})
    assert [c.ok for c in checks] == [True, False, False]
    with pytest.raises(core.BenchError):
        core.checks_from({}, {"a": 1.0})
