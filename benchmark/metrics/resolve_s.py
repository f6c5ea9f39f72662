"""Seconds per isolate in the program's ``resolve-*`` substages, which tile
``resolve``'s steps and do not nest in one another, over every QC-pass
cluster of the isolate: their deltas around each stage call, summed,
averaged over the window's isolates. Nothing to read where the program opens
no such substage."""

PREFIX = "resolve-"


def read(record):
    isolates = record["isolates"]
    total = sum(secs for r in isolates for name, secs in r["substages"].items()
                if name.startswith(PREFIX))
    return total / len(isolates) if isolates and total > 0 else None
