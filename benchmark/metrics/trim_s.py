"""Seconds per isolate in ``trim``: the benchmark's host clock around every
call of the isolate, each ending in a synchronise, averaged over the
window's isolates."""


def read(record):
    isolates = [r for r in record["isolates"] if "trim" in r["stages"]]
    if not isolates:
        return None
    return sum(r["stages"]["trim"] for r in isolates) / len(isolates)
