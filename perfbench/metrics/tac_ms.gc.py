"""TAC's device ms a batch (``groupcomm_sudormrf._tac_fast``), read by
stream order: the kernel time (not copies) of every kernel that is not K1's
and lies between one K1 kernel and the next, with no copy back to the host
(``Memcpy DtoH``) in between. Such a stretch is one block's TAC and the
next block's parameter stacks (a few us); K1's own kernels follow each
other with nothing between. A forward of n K1 calls has n - 1 such
stretches: its first TAC shares the stretch after the previous batch's
copy back with the encoder, and that stretch is left out. So the value is
the mean stretch times the TAC calls a batch.

Only a copy back ends a stretch, never any copy: a cuBLAS memset inside a
TAC does not drop it. None where the window served no batch, the forward
called K1 fewer than twice, or the program does not count TAC calls; a
number, 0 included, otherwise."""

from perfbench import core, trace

_k1 = core.load_module(core.HERE / "metrics" / "k1_roofline_pct.py")


def _is_copy_back(e: trace.DeviceEvent) -> bool:
    return e.is_copy and e.name.startswith("Memcpy") and "DtoH" in e.name


def stretch_ns(events) -> int:
    """Summed kernel ns of the non-K1 kernels between consecutive K1
    kernels with no copy back between them."""
    total = pending = 0
    seen_k1 = copied_back = False
    for e in events:
        if e.is_copy:
            copied_back = copied_back or _is_copy_back(e)
        elif _k1.is_k1(e.name):
            if seen_k1 and not copied_back:
                total += pending
            seen_k1, copied_back, pending = True, False, 0
        else:
            pending += e.dur_ns
    return total


def read(tr: trace.Trace):
    units, tac_calls = tr.units, tr.counters.get("tac_calls")
    if units < 1 or tac_calls is None:
        return None
    n = tr.counters.get("k1_launches", 0) / units
    if n < 2:
        return None
    return stretch_ns(tr.events) / 1e6 / (units * (n - 1)) * (tac_calls / units)
