"""Device-idle ms a batch while the host launches the serving forward
(``improved_forward_fast``'s ``forward`` and ``forward.*`` spans); the rest
of the idle time is the caller's, outside the forward. None where the
program records no span."""

from perfbench import spans


def read(tr):
    return spans.idle_ms_per_root(tr, spans.is_forward)
