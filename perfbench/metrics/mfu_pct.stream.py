"""The causal forward's counted flops (``flops_causal.forward_flops`` of a
step's (streams, 1, context + hop) window) times the steps, over the traced
window's seconds and the H100's dense TF32 peak: the whole step's share of
the card's peak."""

from perfbench import peaks, trace


def read(tr: trace.Trace):
    if tr.units <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * tr.units * tr.shapes["forward_flops"] / tr.window_s / peaks.TF32_FLOPS
