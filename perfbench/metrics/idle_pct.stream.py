"""The device's idle share of the traced window: 1 - the union of its
kernel and copy intervals over the window's wall time."""

from perfbench import trace


def read(tr: trace.Trace):
    return trace.idle_pct(tr)
