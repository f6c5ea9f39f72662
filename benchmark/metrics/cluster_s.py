"""Seconds per isolate in the program's ``cluster-*`` substages, which tile
``cluster``'s steps and do not nest in one another: their deltas around each
stage call of the isolate (as ``stream_bin_s`` reads ``stream-bin``), summed,
averaged over the window's isolates. Nothing to read where the program opens
no such substage."""

PREFIX = "cluster-"


def read(record):
    isolates = record["isolates"]
    total = sum(secs for r in isolates for name, secs in r["substages"].items()
                if name.startswith(PREFIX))
    return total / len(isolates) if isolates and total > 0 else None
