"""Device-idle ms a recording outside every ``overlap_add.separate`` span:
the caller's turn between two recordings, not the program's. None where the
program records no span."""

from perfbench import spans


def read(tr):
    return spans.idle_ms_per_root(tr, lambda name: name is spans.CALLER)
