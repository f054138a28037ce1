"""MB (1e6 bytes) copied between host and card a recording: the
``h2d_bytes`` and ``d2h_bytes`` of the ``overlap_add.batch`` spans, over
the recordings. None where the program records no span."""

from perfbench import spans


def read(tr):
    recs = spans.records()
    if recs is None:
        return None
    n = spans.root_count(recs, tr)
    return sum(r.attrs["h2d_bytes"] + r.attrs["d2h_bytes"]
               for r in recs if r.name == "overlap_add.batch") / 1e6 / n
