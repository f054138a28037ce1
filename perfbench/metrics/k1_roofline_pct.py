"""K1's share of its roofline: the calls the program counted
(``fused_uconv_block.launches``) times the least time of one call
(``flops.block_least_seconds`` at the cell's block shape), over the device
time of K1's kernels in the trace. None where K1 did not run, or ran and
none of its kernels is found."""

import re

from perfbench import flops, trace

# the kernels of csrc/uconv.cu that one K1 call launches
K1_KERNELS = ("split_kernel", "gemm_kernel", "fold_kernel", "ladder_kernel", "upsum_kernel")
_K1 = re.compile(r"\b(" + "|".join(K1_KERNELS) + r")\b")


def is_k1(name: str) -> bool:
    return bool(_K1.search(name))


def read(tr: trace.Trace):
    calls = tr.counters.get("k1_launches", 0)
    ns, n = trace.kernel_time_ns(tr, is_k1)
    if calls <= 0 or n == 0:
        return None
    least = flops.block_least_seconds(*tr.shapes["k1"])["seconds"]
    return 100.0 * calls * least / (ns / 1e9)
