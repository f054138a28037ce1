"""Faults planted in the program underneath a run, for the tests that see
``correct`` come out false (``python3 -m perfbench.control --fault <name>``
reads them at a cell's own size):

* ``answer``: an answer altered where it is made: one row's estimate
  scaled by 1.01 in the serving forward;
* ``half_batch``: half of the batch left out: the serving forward's second
  half of rows zeroed;
* ``alignment`` (overlap-add cells): the front end takes, from the second
  chunk on, the source order that correlates worst with the previous
  chunk's tail instead of best.
"""

from __future__ import annotations

import contextlib

SERVING = ("answer", "half_batch")
RECORDINGS = SERVING + ("alignment",)


@contextlib.contextmanager
def _patched(obj, name, value):
    plain = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield plain
    finally:
        setattr(obj, name, plain)


@contextlib.contextmanager
def _worst_alignment():
    from sudo_rm_rf_tpu_torch.inference.overlap_add import OverlapAddSeparator

    def worst(self, prev_tail, est):
        head = est[:, : self.hop]
        scores = [sum(float(prev_tail[s] @ head[p[s]]) for s in range(self.num_sources))
                  for p in self._perms]
        return est[list(self._perms[min(range(len(scores)), key=scores.__getitem__)])]

    with _patched(OverlapAddSeparator, "_align", worst):
        yield


@contextlib.contextmanager
def _broken_forward(how: str):
    from sudo_rm_rf_tpu_torch.models import fast_inference

    plain = fast_inference.improved_forward_fast

    def broken(model, x, **kw):
        est = plain(model, x, **kw)
        if how == "answer":
            est[0, 0] *= 1.01
        else:  # half_batch
            est[est.shape[0] // 2:] = 0.0
        return est

    with _patched(fast_inference, "improved_forward_fast", broken):
        yield


def kinds(driver: str) -> tuple:
    """The faults a cell of ``driver`` (a traffic's driver) can have."""
    return RECORDINGS if driver == "recordings" else SERVING


def plant(driver: str, how: str):
    """The fault ``how`` for a cell of ``driver``."""
    if how not in kinds(driver):
        raise ValueError(f"no fault {how!r} for a {driver} cell")
    return _worst_alignment() if how == "alignment" else _broken_forward(how)
