"""The traced window: ``torch.profiler`` over the device's activity, reduced
to intervals, busy time and a breakdown that the per-layer readers read.

Only device activity (kernels and copies, from CUPTI) is recorded: a host
trace of a 20 s window holds millions of events.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class DeviceEvent:
    name: str
    start_ns: int
    dur_ns: int
    is_copy: bool


@dataclass
class Trace:
    """A finished traced window: its device events in start order, its host
    wall seconds, and what the driver counted in it (``units``: batches,
    recordings or steps; ``counters``: the program's counters' deltas;
    ``shapes``: sizes the readers need)."""

    events: List[DeviceEvent]
    window_s: float
    units: int = 0
    counters: Dict[str, float] = field(default_factory=dict)
    shapes: Dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        return union_ns([(e.start_ns, e.start_ns + e.dur_ns) for e in self.events]) / 1e9


def union_ns(spans) -> int:
    """Length of the union of (start, end) intervals."""
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy


def device_events(prof) -> List[DeviceEvent]:
    """The device's kernels and copies of a finished profile, from its raw
    events (``key_averages`` takes seconds a step)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        out.append(DeviceEvent(name, e.start_ns(), e.duration_ns(),
                               name.startswith("Memcpy") or name.startswith("Memset")))
    out.sort(key=lambda ev: ev.start_ns)
    return out


@contextlib.contextmanager
def traced(enabled: bool, holder: dict):
    """Profile the device inside the block when ``enabled``; afterwards
    ``holder['events']`` holds its events and ``holder['wall_s']`` the
    block's host seconds (to its last synchronize)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        holder["wall_s"] = time.perf_counter() - t0
    holder["events"] = device_events(prof)


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments and signature."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "").strip()
    for stop in ("<", "("):
        cut = name.find(stop)
        if cut > 0:
            name = name[:cut]
    return name.strip()[:width]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, summed by name, and
    the longest idle stretches summed by the pair of operations around
    them, each in seconds as measured."""
    by_op: Dict[str, int] = collections.defaultdict(int)
    for e in tr.events:
        by_op[short_name(e.name)] += e.dur_ns
    gaps: Dict[str, int] = collections.defaultdict(int)
    end, prev = None, None
    for e in tr.events:
        if end is not None and e.start_ns > end:
            gaps[f"after {prev} before {short_name(e.name)}"] += e.start_ns - end
        if end is None or e.start_ns + e.dur_ns > end:
            end, prev = e.start_ns + e.dur_ns, short_name(e.name)
    pick = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": pick(by_op), "idle_gaps": pick(gaps)}


def kernel_time_ns(tr: Trace, match) -> Tuple[int, int]:
    """(summed ns, count) of the kernels (not copies) whose name ``match``
    accepts."""
    ns = n = 0
    for e in tr.events:
        if not e.is_copy and match(e.name):
            ns += e.dur_ns
            n += 1
    return ns, n


def idle_pct(tr: Trace) -> Optional[float]:
    if tr.window_s <= 0 or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def per_unit(value: float, tr: Trace) -> Optional[float]:
    return None if tr.units <= 0 or not tr.events else value / tr.units
