"""Milliseconds per isolate in trim's overlap DP: CUDA events that the
benchmark's wrapper puts around each call into ``ops/align.py``
``overlap_screen_traceback``, summed over the window and divided by its
isolates. It is the span trim waits on, host launch gaps included, not the
card's busy time. Nothing to read where no DP was dispatched."""


def read(record):
    isolates = record["isolates"]
    calls = [c for r in isolates for c in r["overlap_dp"]]
    if not calls:
        return None
    return sum(c["ms"] for c in calls) / len(isolates)
