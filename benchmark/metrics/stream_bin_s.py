"""Seconds per isolate in the streamed grouping's first pass: the delta of
the program's ``stream-bin`` substage around each ``compress`` call,
averaged over the window's isolates. Nothing to read where no compress
streamed."""


def read(record):
    isolates = record["isolates"]
    total = sum(r["substages"].get("stream-bin", 0.0) for r in isolates)
    return total / len(isolates) if isolates and total > 0 else None
