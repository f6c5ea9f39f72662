"""Seconds per isolate in ``compress``: the benchmark's host clock around
its call, ending in a synchronise, averaged over the window's isolates."""


def read(record):
    isolates = record["isolates"]
    if not isolates:
        return None
    return sum(r["stages"].get("compress", 0.0) for r in isolates) / len(isolates)
