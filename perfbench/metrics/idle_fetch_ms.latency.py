"""Device-idle ms a recording while the host copies a batch's estimates
back (``overlap_add.fetch``: waiting for the device, then the copy into
host memory). None where the program records no span."""

from perfbench import spans


def read(tr):
    return spans.idle_ms_per_root(tr, lambda name: name == "overlap_add.fetch")
