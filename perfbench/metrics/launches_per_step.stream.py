"""Device kernels and copies in the traced window, per step of the live
streams (one ``StreamingSeparator.push`` of every stream)."""

from perfbench import trace


def read(tr: trace.Trace):
    return trace.per_unit(float(len(tr.events)), tr)
