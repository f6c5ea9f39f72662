"""Milliseconds per isolate in the k-mer grouping: CUDA events that the
benchmark's wrapper puts around each call into ``ops/sortnet.py``'s CUDA
entry, summed over the window and divided by its isolates."""


def read(record):
    isolates = record["isolates"]
    calls = [c for r in isolates for c in r["grouping"]]
    if not calls:
        return None
    return sum(c["ms"] for c in calls) / len(isolates)
