"""Wall-clock seconds per named substage of a command.

Each substage that ends with a device result copied to the host has waited
for its device work, so its wall time includes that work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

# substage name -> summed wall seconds since the last reset()
seconds: Dict[str, float] = {}


@contextlib.contextmanager
def substage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


def reset() -> None:
    seconds.clear()
