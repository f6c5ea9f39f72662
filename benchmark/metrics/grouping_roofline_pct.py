"""The k-mer grouping's kernels' share of their roofline, in %: the least
time their bytes need at the H100's HBM rate, over the time the profiler's
trace of the window shows the kernels of ``csrc/sortnet.cu`` running. Each
call reads its codes once (k bytes a window, up to the whole buffer, as
``ops/mfu.py`` counts them) and its int32 starts, and writes the int32
order and one boundary flag a window, from which a cumsum outside the
kernels makes the group ids; the grouping does no arithmetic worth a bound.
The bytes come from the shapes each call was given, read on the host.
Nothing to read without the trace or with no such kernel in it."""

import re

from benchmark.lib import peaks

KERNEL = re.compile(r"(?:::|\d)(?:hist0|scatter0|hist|scatter|sort_generic|sort_reg"
                    r"|boundary)_kernel")


def call_bytes(code_bytes: int, windows: int) -> int:
    return code_bytes + 4 * windows + 4 * windows + windows


def kernel_seconds(op_s: dict) -> float:
    """Seconds of the trace's operations that are ``csrc/sortnet.cu``'s
    kernels (demangled, ``(anonymous namespace)::hist0_kernel<2>(...)``, or
    mangled, ``...12hist0_kernelILi2EE...``)."""
    return sum(s for name, s in op_s.items() if KERNEL.search(name))


def read(record):
    calls = [c for r in record["isolates"] for c in r["grouping"]]
    busy = kernel_seconds((record.get("trace") or {}).get("op_s", {}))
    if not calls or busy <= 0:
        return None
    least = sum(peaks.least_seconds(0, call_bytes(c["code_bytes"], c["windows"]))[0]
                for c in calls)
    return 100.0 * least / busy
