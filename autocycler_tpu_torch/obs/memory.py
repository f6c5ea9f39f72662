"""Lightweight memory sampling for top-level trace spans, as the JAX
package's obs/memory.py samples.

Three sources, each best-effort (a missing source is simply absent from the
sample — telemetry never fails the pipeline):

- peak RSS from ``resource.getrusage`` (ru_maxrss is KiB on Linux);
- current RSS from ``/proc/self/statm`` (page count x page size);
- CUDA device bytes in use (``torch.cuda.memory_allocated`` summed over the
  devices), only once this process has initialised CUDA: a sample must
  never be what brings the CUDA context up, just as the JAX package's
  never initialises a backend.
"""

from __future__ import annotations

import os
import sys


def memory_sample() -> dict:
    out: dict = {}
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        scale = 1024 if sys.platform != "darwin" else 1
        out["peak_rss_bytes"] = int(ru.ru_maxrss) * scale
    except Exception:  # noqa: BLE001 — absent source == absent field
        pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        out["rss_bytes"] = pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001
        pass
    out.update(cuda_memory_sample())
    return out


def cuda_memory_sample() -> dict:
    """``{"device_bytes_in_use": n}`` when CUDA is already initialised in
    this process, else ``{}``."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    try:
        if not torch.cuda.is_initialized():
            return {}
        return {"device_bytes_in_use": sum(
            int(torch.cuda.memory_allocated(d))
            for d in range(torch.cuda.device_count()))}
    except Exception:  # noqa: BLE001 — a broken context: skip device stats
        return {}
