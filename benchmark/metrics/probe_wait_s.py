"""Seconds the program waited on its device probe, inside ``setup_s``: its
counter ``autocycler_device_wait_seconds_total``, read from the program's
registry once the window has closed. Only the process's first request for
CUDA waits on the probe, and the benchmark makes it as set-up attaches the
card, so the count is set-up's. Nothing to read where no request for CUDA
was made (a run on the CPU)."""

COUNTER = "autocycler_device_wait_seconds_total"


def read(record):
    from autocycler_tpu_torch.obs import metrics_registry

    reg = metrics_registry.registry()
    if COUNTER not in reg.snapshot():
        return None
    return reg.value(COUNTER)
