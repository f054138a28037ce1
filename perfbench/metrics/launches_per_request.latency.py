"""Device kernels and copies in the traced window, per recording
separated (``OverlapAddSeparator``'s dispatch)."""

from perfbench import trace


def read(tr: trace.Trace):
    return trace.per_unit(float(len(tr.events)), tr)
