"""The serving forward's counted flops (``flops.forward_flops``) a second
of the traced window, over the H100's dense TF32 peak."""

from perfbench import peaks, trace


def read(tr: trace.Trace):
    if tr.units <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * tr.units * tr.shapes["forward_flops"] / tr.window_s / peaks.TF32_FLOPS
