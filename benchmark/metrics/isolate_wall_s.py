"""Wall seconds per isolate, as ``isolate_s`` reads them (the window's whole
elapsed time over the isolates it completed), kept per layer in the cells
whose host walls spread too widely for a bound end to end."""


def read(record):
    n = len(record["isolates"])
    return record["window_s"] / n if n else None
