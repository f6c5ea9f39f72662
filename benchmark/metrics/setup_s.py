"""Seconds from the process's start to the window's: imports, the device
probe and CUDA context, the kernel libraries (built on a checkout's first
run), the isolates' generation and the warm-up isolate."""


def read(record):
    return record["setup_s"]
