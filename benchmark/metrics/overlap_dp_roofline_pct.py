"""Trim's overlap DP's share of its roofline, in %: the least time for the
work its shapes need, over ``overlap_dp_ms``'s time, summed over the
window's calls. A job of k rows is k * k cells; each cell needs at least 10
int64 operations, 2 instructions each on 32-bit lanes. Its bytes are one
traceback bit a cell and one int64 score a row written, and the four int64
windows (both paths' unitigs and weights) read. The larger bound is taken;
it reads the same work whatever implements the DP."""

from benchmark.lib import peaks

INSTRUCTIONS_PER_CELL = 10 * 2


def call_work(ks):
    """(instructions, bytes) of one call over jobs of ``ks`` rows."""
    cells = sum(k * k for k in ks)
    return (INSTRUCTIONS_PER_CELL * cells,
            sum(k * k / 8 + 8 * k + 4 * 8 * k for k in ks))


def read(record):
    calls = [c for r in record["isolates"] for c in r["overlap_dp"]]
    ms = sum(c["ms"] for c in calls)
    if not calls or ms <= 0:
        return None
    least = sum(peaks.least_seconds(*call_work(c["k"]))[0] for c in calls)
    return 100.0 * least / (ms / 1e3) if least > 0 else None
