"""The program's host spans (``sudo_rm_rf_tpu_torch.utils.tracing``) laid
beside the traced window's device events, for the per-layer readers.

The device is idle in each gap between consecutive intervals of the union
of its kernels and copies; the stretches before the window's first event
and after its last are not gaps. Each instant of a gap goes to the
innermost span open on the host at that instant (a span's own time is its
interval less its children's), or to the caller where no span is open.
Spans and device events are stamped on one clock, the profiler's.

A tree without the tracing module, or a window in which the program
recorded no span, reads None: the readers then leave their metric out.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

CALLER = None  # the key of idle time outside every span


def records() -> Optional[list]:
    """The spans the program recorded, or None where it has no tracing
    module or recorded none."""
    try:
        from sudo_rm_rf_tpu_torch.utils import tracing
    except ImportError:
        return None
    return list(tracing.spans()) or None


def root_count(recs, tr) -> int:
    """The number of root spans, one a unit of the window (a recording, or
    a batch where the forward is the root)."""
    n = sum(r.parent == 0 for r in recs)
    assert n == tr.units, f"{n} root spans for {tr.units} units of the window"
    return n


def device_gaps(events) -> List[Tuple[int, int]]:
    """(start, end) ns of each idle stretch between the union's intervals."""
    gaps, end = [], None
    for e in sorted(events, key=lambda ev: ev.start_ns):
        lo, hi = e.start_ns, e.start_ns + e.dur_ns
        if end is not None and lo > end:
            gaps.append((end, lo))
        if end is None or hi > end:
            end = hi
    return gaps


def self_segments(recs) -> List[Tuple[int, int, str]]:
    """(start, end, name) of each stretch of a span's own time, in time
    order: the innermost open span's name at every instant a span covers."""
    kids = collections.defaultdict(list)
    for r in recs:
        kids[r.parent].append(r)
    out = []

    def walk(r):
        t = r.start_ns
        for c in sorted(kids.get(r.id, ()), key=lambda c: c.start_ns):
            if c.start_ns > t:
                out.append((t, c.start_ns, r.name))
            walk(c)
            t = max(t, c.end_ns)
        if r.end_ns > t:
            out.append((t, r.end_ns, r.name))

    for r in kids.get(0, ()):
        walk(r)
    out.sort()
    return out


def idle_by_span(events, recs) -> Dict[Optional[str], int]:
    """Idle ns of the device by the name of the innermost span open on the
    host, ``CALLER`` where none is."""
    segs = self_segments(recs)
    out: Dict[Optional[str], int] = collections.defaultdict(int)
    j = 0
    for lo, hi in device_gaps(events):
        while j < len(segs) and segs[j][1] <= lo:
            j += 1
        t, k = lo, j
        while t < hi:
            if k < len(segs) and segs[k][0] < hi:
                s_lo, s_hi, name = segs[k]
                if s_lo > t:
                    out[CALLER] += s_lo - t
                    t = s_lo
                end = min(s_hi, hi)
                out[name] += end - t
                t = end
                k += 1
            else:
                out[CALLER] += hi - t
                t = hi
    return dict(out)


def idle_ms_per_root(tr, accept: Callable[[Optional[str]], bool]) -> Optional[float]:
    """Device-idle ms a root span under the spans whose name ``accept``
    takes (``CALLER`` for time outside every span)."""
    recs = records()
    if recs is None:
        return None
    n = root_count(recs, tr)
    idle = idle_by_span(tr.events, recs)
    return sum(ns for name, ns in idle.items() if accept(name)) / 1e6 / n


def is_forward(name: Optional[str]) -> bool:
    """The serving forward's spans: ``forward`` and ``forward.*``."""
    return name is not None and (name == "forward" or name.startswith("forward."))
