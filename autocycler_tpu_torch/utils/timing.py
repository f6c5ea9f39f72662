"""Wall-clock seconds per pipeline stage and per substage, kept in the
metrics registry (``obs.metrics_registry``) as the JAX package's
utils/timing.py keeps them, and traced as spans.

A stage (``stage_timer``) is a step of a command under the JAX package's
name, such as ``compress/build_graph`` or ``trim/overlaps``; a substage
(``substage``) is a hot part inside one, such as ``k-mer grouping`` or
``repair``. Both accumulate over the process until :func:`reset`, and each
opens a span (``cat="stage"`` or ``"substage"``) in the trace run when one
is active. With ``AUTOCYCLER_TIMINGS=1`` each stage prints its time and the
substages that ran inside it to stderr. Each stage or substage that ends
with a device result copied to the host has waited for its device work, so
its wall time includes that work.

It names the device families, the JAX package's, that
``device.fold_records`` writes (seconds, dispatches, the per-dispatch and
per-kernel histograms), and counts device-path failures
(:func:`record_device_failure`).

The device token (:func:`enable_device_token`, which the multi-worker
serve scheduler turns on) serializes device work through one process-wide
lock: ``device.py`` holds it across every kernel launch and torch-op
dispatch, and across compress's adjacency and chains and cluster's
distance product. Each block synchronises its stream before the token is
released, so the token covers the device work itself and not only its
enqueue. Off (the CLI, and a daemon of one worker) it adds nothing.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional

from ..obs import metrics_registry, trace
from . import log
from .env import env_bool
from .misc import format_duration

# metric names, the JAX package's
DEVICE_SECONDS = "autocycler_device_seconds_total"
DEVICE_DISPATCHES = "autocycler_device_dispatches_total"
DEVICE_FAILURES = "autocycler_device_failures_total"
DEVICE_FAILURE_LAST = "autocycler_device_failure_last"
DEVICE_DISPATCH_HIST = "autocycler_device_dispatch_seconds"
DEVICE_KERNEL_HIST = "autocycler_device_kernel_seconds"
STAGE_SECONDS = "autocycler_stage_seconds_total"
STAGE_LATENCY_HIST = "autocycler_stage_latency_seconds"
SUBSTAGE_SECONDS = "autocycler_substage_seconds_total"
DEVICE_TOKEN_WAIT = "autocycler_serve_device_token_wait_seconds_total"

_token_lock = threading.RLock()
_token_enabled = False


def enable_device_token(enabled: bool) -> None:
    """Turn device-work serialization on/off (the serve scheduler only)."""
    global _token_enabled
    with _token_lock:
        _token_enabled = bool(enabled)


def device_token_enabled() -> bool:
    return _token_enabled


@contextlib.contextmanager
def device_token(kernel: str, sync: Optional[Callable[[], None]] = None):
    """Hold the device token across one block of device work, counting the
    wait into :data:`DEVICE_TOKEN_WAIT` (per kernel). ``sync`` (the block's
    stream synchronise) runs before the token is released, so the work
    has finished on the device when the next holder starts. With the
    token off this yields at once and ``sync`` is not called."""
    if not _token_enabled:
        yield
        return
    t0 = time.perf_counter()
    _token_lock.acquire()
    try:
        metrics_registry.counter_inc(
            DEVICE_TOKEN_WAIT, time.perf_counter() - t0,
            help="seconds device dispatches waited for the serve device "
                 "token", kernel=kernel)
        yield
        if sync is not None:
            sync()
    finally:
        _token_lock.release()


# an exception that already went through record_device_failure carries
# this attribute, so that an enclosing device block does not count it again
_RECORDED_ATTR = "_autocycler_device_failure_recorded"


def record_device_failure(what: str, exc: BaseException = None) -> None:
    """Counts one device-path failure into :data:`DEVICE_FAILURES` and
    describes it in :data:`DEVICE_FAILURE_LAST`. When ``exc`` already went
    through here (a block inside another), only the description changes."""
    already = exc is not None and getattr(exc, _RECORDED_ATTR, False)
    if exc is not None:
        try:
            setattr(exc, _RECORDED_ATTR, True)
        except AttributeError:
            pass
    reg = metrics_registry.registry()
    if not already:
        reg.counter_inc(DEVICE_FAILURES, 1,
                        help="device-path failures")
    reg.info_set(DEVICE_FAILURE_LAST, what,
                 help="description of the most recent device-path failure")


def token_wait_seconds() -> float:
    """Seconds device work has waited for the token so far, all kernels."""
    return sum(metrics_registry.registry().labeled(
        DEVICE_TOKEN_WAIT, "kernel").values())


@contextlib.contextmanager
def substage(name: str):
    """Times one substage; several entries of one name add up. Thread-safe:
    concurrent workers each add their own elapsed time."""
    start = time.perf_counter()
    try:
        with trace.span(name, cat="substage"):
            yield
    finally:
        metrics_registry.counter_inc(
            SUBSTAGE_SECONDS, time.perf_counter() - start,
            help="cumulative seconds per hot-kernel sub-stage",
            substage=name)


def substage_snapshot() -> Dict[str, float]:
    """Copy of the summed seconds per substage so far."""
    return metrics_registry.registry().labeled(SUBSTAGE_SECONDS, "substage")


def substage_deltas(before: Dict[str, float], digits: int = 3
                    ) -> Dict[str, float]:
    """Substage seconds added since ``before`` (a snapshot), rounded to
    ``digits``, leaving out those that round to zero."""
    out = {}
    for name, total in substage_snapshot().items():
        delta = round(total - before.get(name, 0.0), digits)
        if delta > 0:
            out[name] = delta
    return out


def stage_seconds() -> Dict[str, float]:
    """Copy of the summed wall seconds per stage so far."""
    return metrics_registry.registry().labeled(STAGE_SECONDS, "stage")


@contextlib.contextmanager
def stage_timer(name: str):
    """Times one pipeline stage; with AUTOCYCLER_TIMINGS set, prints it and
    the substages inside it as ``[timing] <stage>: H:MM:SS.micros`` lines."""
    before = substage_snapshot()
    start = time.perf_counter()
    try:
        with trace.span(name, cat="stage"):
            yield
    finally:
        elapsed = time.perf_counter() - start
        reg = metrics_registry.registry()
        reg.counter_inc(STAGE_SECONDS, elapsed,
                        help="cumulative wall seconds per pipeline stage",
                        stage=name)
        reg.observe(STAGE_LATENCY_HIST, elapsed,
                    help="per-stage wall latency distribution",
                    buckets=metrics_registry.SECONDS_BUCKETS, stage=name)
        if env_bool("AUTOCYCLER_TIMINGS"):
            log.message(f"[timing] {name}: {format_duration(elapsed)}")
            for sub, secs in substage_deltas(before).items():
                log.message(f"[timing] {name} · {sub}: "
                            f"{format_duration(secs)}")


def reset() -> None:
    """Clears the metrics registry: the stage and substage seconds and
    every other count in it (cache events, QC gauges)."""
    metrics_registry.reset()
