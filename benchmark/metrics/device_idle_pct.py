"""The device's idle share of the window, in %: 100 x (1 - the union of the
kernel, copy and set intervals of the ``torch.profiler`` CUDA trace of the
window, over the window)."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
