"""The host's load around a run: a copy of the port's
``obs/timeseries.py`` ``host_sample``, so that the yardstick does not move
with the program."""

import os
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
