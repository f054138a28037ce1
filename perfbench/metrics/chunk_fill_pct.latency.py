"""Share of the chunk rows forwarded that carry audio: the sum of the
``overlap_add.batch`` spans' ``rows`` (valid chunks) over the sum of their
``slots`` (rows forwarded, the last batch of a recording padded with zero
chunks). None where the program records no span."""

from perfbench import spans


def read(tr):
    recs = spans.records()
    if recs is None:
        return None
    spans.root_count(recs, tr)
    batches = [r.attrs for r in recs if r.name == "overlap_add.batch"]
    slots = sum(a["slots"] for a in batches)
    return 100.0 * sum(a["rows"] for a in batches) / slots if slots else None
