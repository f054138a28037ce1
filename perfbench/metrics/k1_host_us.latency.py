"""Mean host microseconds to dispatch one U-ConvBlock: the duration of the
``forward.block`` spans (``params_from_module`` and K1's wrapper). None
where the program records no span."""

from perfbench import spans


def read(tr):
    recs = spans.records()
    if recs is None:
        return None
    spans.root_count(recs, tr)
    blocks = [r.end_ns - r.start_ns for r in recs if r.name == "forward.block"]
    return sum(blocks) / len(blocks) / 1e3 if blocks else None
