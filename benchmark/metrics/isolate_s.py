"""Wall seconds per isolate: the window's whole elapsed time over the
isolates it completed (host clock, each isolate ending in a synchronise)."""


def read(record):
    n = len(record["isolates"])
    return record["window_s"] / n if n else None
