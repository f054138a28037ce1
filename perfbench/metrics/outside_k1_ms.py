"""Device ms a batch of every kernel that is not K1's: the encoder, GlobLN,
bottleneck, mask head and decoder (``fast_inference._encode``,
``_decode``). None where K1 did not run."""

from perfbench import core, trace

_k1 = core.load_module(core.HERE / "metrics" / "k1_roofline_pct.py")


def read(tr: trace.Trace):
    if tr.counters.get("k1_launches", 0) <= 0:
        return None
    ns, _ = trace.kernel_time_ns(tr, lambda name: not _k1.is_k1(name))
    return trace.per_unit(ns / 1e6, tr)
