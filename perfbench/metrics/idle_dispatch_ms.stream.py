"""Device-idle ms a step while the host launches the causal forward (its
``forward`` and ``forward.*`` spans), over the ``stream.step`` root spans;
the rest of a step's idle is the separator's own (``stream.upload``,
``stream.roll``, ``stream.fetch``) and the caller's. None where the
program records no span."""

from perfbench import spans


def read(tr):
    return spans.idle_ms_per_root(tr, spans.is_forward)
