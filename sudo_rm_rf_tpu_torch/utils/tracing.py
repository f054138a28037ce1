"""Host spans of the serving path, stamped on the clock of ``torch.profiler``.

A span records only while a ``torch.profiler`` session is active (any of
its activities): outside one, :func:`span` checks one flag and hands back a
shared object that does nothing. Inside one, each span keeps its name, its
start and end in ns on the clock the profiler's events carry
(``time.time_ns``, CLOCK_REALTIME: ``kineto_results.events()`` gives the
CPU's and the card's events on it), its own id, its parent's id (0 for a
root), the id of its root (``request``), and a few int attributes. So a
reader can lay the spans beside the card's kernels and copies and say what
the host was doing while the card waited.

Spans add no event to the profiler's trace: no ``record_function``, no CUDA
event. The records stay in memory (:func:`spans`, :func:`clear`). The
serving path runs on one host thread, so one module-level stack gives each
span its parent.

    with tracing.span("overlap_add.batch", rows=n) as sp:
        ...
        sp.set(h2d_bytes=x.nbytes)
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

# True while a torch.profiler session is active, whatever its activities
_profiling = torch._C._autograd._profiler_enabled
_clock = time.time_ns


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    request: int
    attrs: Dict[str, int] = field(default_factory=dict)


_records: List[Span] = []
_stack: List[Span] = []
_ids = itertools.count(1)


class _Open:
    """A span being recorded: ``with`` stamps its start and end."""

    __slots__ = ("record",)

    def __init__(self, name: str, attrs: dict):
        parent = _stack[-1] if _stack else None
        sid = next(_ids)
        self.record = Span(name, 0, 0, sid, parent.id if parent else 0,
                           parent.request if parent else sid, attrs)

    def __enter__(self):
        _stack.append(self.record)
        self.record.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        self.record.end_ns = _clock()
        _stack.pop()
        _records.append(self.record)
        return False

    def set(self, **attrs) -> None:
        self.record.attrs.update(attrs)


class _Off:
    """What :func:`span` returns outside a profiler session."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager that records ``name`` from entry to exit while a
    profiler session is active; ``set(**attrs)`` adds int attributes."""
    if not _profiling():
        return _OFF
    return _Open(name, attrs)


def spans() -> List[Span]:
    """Every span recorded so far, in the order they ended."""
    return _records


def clear() -> None:
    _records.clear()
