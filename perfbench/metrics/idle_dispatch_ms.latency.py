"""Device-idle ms a recording while the host launches the forward: under
``overlap_add.forward`` (standardization, the model, de-standardization)
and the serving forward's ``forward`` and ``forward.*`` spans. None where
the program records no span."""

from perfbench import spans


def read(tr):
    return spans.idle_ms_per_root(
        tr, lambda name: name == "overlap_add.forward" or spans.is_forward(name))
