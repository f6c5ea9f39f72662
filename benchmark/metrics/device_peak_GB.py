"""The window's peak of device memory allocated by torch
(``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start), in units of 1e9 bytes."""


def read(record):
    peak = record.get("device_peak_bytes")
    return peak / 1e9 if peak else None
