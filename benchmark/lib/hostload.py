"""The host's load around a run: a copy of the port's
``obs/timeseries.py`` ``host_sample``, so that the yardstick does not move
with the program; this process's CPU seconds and bytes, read around each
stage call; and a fixed probe of the host's speed, read once the window
has closed."""

import os
import resource
import statistics
import threading
import time


def host_sample() -> dict:
    """One host-load sample: loadavg, cumulative /proc/stat CPU jiffies
    (total + idle, so two samples give the busy fraction between them), RSS
    and the interpreter's thread count. Best-effort on every field."""
    snap: dict = {"ts": round(time.time(), 3),
                  "threads": threading.active_count()}
    try:
        snap["loadavg"] = [round(v, 2) for v in os.getloadavg()]
    except (OSError, AttributeError):
        snap["loadavg"] = None
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        vals = [int(v) for v in fields[1:]]
        snap["cpu_jiffies_total"] = sum(vals)
        # idle + iowait: neither is work stolen from this process
        snap["cpu_jiffies_idle"] = vals[3] + (vals[4] if len(vals) > 4 else 0)
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        snap["rss_bytes"] = pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    return snap


def process_counters() -> dict:
    """This process's cumulative host counters: CPU seconds in user and
    kernel mode, and the bytes it read and wrote through system calls
    (/proc/self/io). Two readings give what a stretch of the run cost the
    host; a field the kernel does not give is left out."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    snap = {"user_s": ru.ru_utime, "sys_s": ru.ru_stime}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("rchar", "wchar"):
                    snap[key] = int(value)
    except (OSError, ValueError):
        pass
    return snap


def counters_delta(before: dict, after: dict) -> dict:
    """``after`` less ``before``, field by field, for the fields both have."""
    return {k: after[k] - before[k] for k in after if k in before}


def host_speed(repeats: int = 3) -> dict:
    """Seconds that the host takes for two fixed pieces of work, the median
    of ``repeats``: an interpreter loop (``python_s``) and a sort of 2**21
    fixed int64 keys (``sort_s``). Read beside a run's walls, they say how
    much of a wall's spread is the host's own speed."""
    import numpy as np

    keys = np.random.default_rng(0).integers(0, 2**62, 2**21)
    python_s, sort_s = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        acc = 0
        for i in range(1_000_000):
            acc += i * i % 7
        python_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.sort(keys)
        sort_s.append(time.perf_counter() - t0)
    return {"python_s": statistics.median(python_s),
            "sort_s": statistics.median(sort_s)}
