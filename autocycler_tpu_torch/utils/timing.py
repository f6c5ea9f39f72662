"""Wall-clock seconds per pipeline stage and per substage, in two
registries as the JAX package keeps them.

A stage (``stage_timer``) is a step of a command under the JAX package's
name, such as ``compress/build_graph`` or ``trim/overlaps``; a substage
(``substage``) is a hot part inside one, such as ``k-mer grouping`` or
``repair``. Both accumulate over the process until :func:`reset`. With
``AUTOCYCLER_TIMINGS=1`` each stage prints its time and the substages that
ran inside it to stderr. Each stage or substage that ends with a device
result copied to the host has waited for its device work, so its wall time
includes that work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

from . import log
from .env import env_bool
from .misc import format_duration

# name -> summed wall seconds since the last reset()
_stages: Dict[str, float] = {}
_substages: Dict[str, float] = {}


@contextlib.contextmanager
def substage(name: str):
    """Times one substage; several entries of one name add up."""
    start = time.perf_counter()
    try:
        yield
    finally:
        _substages[name] = _substages.get(name, 0.0) + \
            time.perf_counter() - start


def substage_snapshot() -> Dict[str, float]:
    """Copy of the summed seconds per substage so far."""
    return dict(_substages)


def substage_deltas(before: Dict[str, float], digits: int = 3
                    ) -> Dict[str, float]:
    """Substage seconds added since ``before`` (a snapshot), rounded to
    ``digits``, leaving out those that round to zero."""
    out = {}
    for name, total in _substages.items():
        delta = round(total - before.get(name, 0.0), digits)
        if delta > 0:
            out[name] = delta
    return out


def stage_seconds() -> Dict[str, float]:
    """Copy of the summed wall seconds per stage so far."""
    return dict(_stages)


@contextlib.contextmanager
def stage_timer(name: str):
    """Times one pipeline stage; with AUTOCYCLER_TIMINGS set, prints it and
    the substages inside it as ``[timing] <stage>: H:MM:SS.micros`` lines."""
    before = substage_snapshot()
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        _stages[name] = _stages.get(name, 0.0) + elapsed
        if env_bool("AUTOCYCLER_TIMINGS", False):
            log.message(f"[timing] {name}: {format_duration(elapsed)}")
            for sub, secs in substage_deltas(before).items():
                log.message(f"[timing] {name} · {sub}: "
                            f"{format_duration(secs)}")


def reset() -> None:
    """Clears both registries."""
    _stages.clear()
    _substages.clear()
