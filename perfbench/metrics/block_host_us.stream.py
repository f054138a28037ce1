"""Mean host microseconds of one causal U-ConvBlock: the duration of the
causal forward's ``forward.block`` spans (a block's launches, or the replay
of its CUDA graph where the streaming separator captured one). None where
the program records no span."""

from perfbench import spans


def read(tr):
    recs = spans.records()
    if recs is None:
        return None
    spans.root_count(recs, tr)
    blocks = [r.end_ns - r.start_ns for r in recs if r.name == "forward.block"]
    return sum(blocks) / len(blocks) / 1e3 if blocks else None
