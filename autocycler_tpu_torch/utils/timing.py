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
``device.fold_records`` writes (seconds, dispatches, the per-kernel
histogram, and the useful flops and bytes a dispatch site declares, by
kernel and phase, beside the seconds they divide), reads them
back by kernel (:func:`device_kernel_snapshot`, rated by
``ops.mfu.kernel_rates``), times the waits on the device probe
(:func:`device_wait`) and counts device-path failures
(:func:`record_device_failure`).

The two profiler knobs write ``torch.profiler`` Chrome traces:
``AUTOCYCLER_PROFILE_DIR=<dir>`` one per :func:`stage_timer`, at
``<dir>/<stage>/trace-<n>.json``; ``AUTOCYCLER_XPROF=<dir>`` one for each
of the first ``AUTOCYCLER_XPROF_LIMIT`` (2) launches, DP dispatches and
``device_work`` blocks of each name (:func:`xprof_capture`, which
``device.py`` opens around them), at ``<dir>/<name>-<n>.json``, linked
from the block's span as its ``xprof`` attr. torch allows one active
profiler per process: a capture that would nest in another (or in a
caller's own ``torch.profiler``) is skipped, and neither knob ever raises.

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
import os
import re
import threading
import time
from typing import Callable, Dict, Optional

from ..obs import metrics_registry, trace
from . import log
from .knobs import knob_bool, knob_int, knob_str
from .misc import format_duration

# metric names, the JAX package's
DEVICE_SECONDS = "autocycler_device_seconds_total"
DEVICE_WAIT = "autocycler_device_wait_seconds_total"
DEVICE_DISPATCHES = "autocycler_device_dispatches_total"
DEVICE_FAILURES = "autocycler_device_failures_total"
DEVICE_FAILURE_LAST = "autocycler_device_failure_last"
DEVICE_KERNEL_HIST = "autocycler_device_kernel_seconds"
DEVICE_KERNEL_FLOPS = "autocycler_device_kernel_flops_total"
DEVICE_KERNEL_BYTES = "autocycler_device_kernel_bytes_total"
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


def device_kernel_snapshot() -> dict:
    """Per-name dispatch accounting from the registry (what
    ``device.fold_records`` folded): ``{kernel: {phase: {count, total_s,
    mean_s, min_s, max_s, flops?, bytes?}}}``, phase "first" (the name's
    first record in the process) or "steady"."""
    snap = metrics_registry.registry().snapshot()
    out: dict = {}
    for entry in snap.get(DEVICE_KERNEL_HIST, {}).get("values", []):
        labels = entry.get("labels", {})
        kernel, phase = labels.get("kernel"), labels.get("phase")
        if not kernel or not phase or not entry.get("count"):
            continue
        # the mean clamped to [min, max]: sum / count can fall an ulp
        # outside them, and rounding would then order them wrongly
        mean = min(max(entry["sum"] / entry["count"], entry["min"]),
                   entry["max"])
        out.setdefault(kernel, {})[phase] = {
            "count": entry["count"],
            "total_s": round(entry["sum"], 6),
            "mean_s": round(mean, 6),
            "min_s": round(entry["min"], 6),
            "max_s": round(entry["max"], 6),
        }
    for name, field in ((DEVICE_KERNEL_FLOPS, "flops"),
                        (DEVICE_KERNEL_BYTES, "bytes")):
        for entry in snap.get(name, {}).get("values", []):
            labels = entry.get("labels", {})
            kernel, phase = labels.get("kernel"), labels.get("phase")
            if kernel and phase and kernel in out and phase in out[kernel]:
                out[kernel][phase][field] = entry["value"]
    return out


def device_seconds() -> float:
    """Device seconds folded into the registry so far."""
    return metrics_registry.registry().value(DEVICE_SECONDS)


@contextlib.contextmanager
def device_wait(what: str = ""):
    """Times one bounded wait on the device probe into :data:`DEVICE_WAIT`,
    not :data:`DEVICE_SECONDS` (no kernel runs while the process waits to
    learn whether the card answers), and opens a ``cat="device_wait"``
    span, so the trace shows where a stage waited on the probe."""
    start = time.perf_counter()
    try:
        with trace.span(what or "probe future", cat="device_wait"):
            yield
    finally:
        metrics_registry.registry().counter_inc(
            DEVICE_WAIT, time.perf_counter() - start,
            help="host seconds blocked on the device-attach future "
                 "(probe wait, excluded from device_seconds)")


def device_wait_seconds() -> float:
    """Host seconds blocked on the device probe so far."""
    return metrics_registry.registry().value(DEVICE_WAIT)


# ---- the profiler knobs ----

# one torch.profiler at a time in this process: a capture that finds it
# held (or finds a caller's profiler running) is skipped
_profiler_lock = threading.Lock()
_xprof_lock = threading.Lock()
_xprof_counts: Dict[str, int] = {}
_stage_traces: Dict[str, int] = {}


def _safe_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("_") or "kernel"


@contextlib.contextmanager
def _profiled(path: str):
    """Runs the block under ``torch.profiler`` (CUDA activities too once
    CUDA is initialised) and writes its Chrome trace to ``path``; yields
    whether it did. Skips when another profiler is active; never raises
    for the profiler's sake."""
    prof = None
    if _profiler_lock.acquire(blocking=False):
        try:
            import torch
            from torch.autograd import profiler as autograd_profiler
            if not autograd_profiler._is_profiler_enabled:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_initialized():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.__enter__()
        except Exception:  # noqa: BLE001 — profiling is evidence only
            prof = None
        if prof is None:
            _profiler_lock.release()
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                import torch
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                prof.export_chrome_trace(path)
            except Exception:  # noqa: BLE001
                pass
            finally:
                _profiler_lock.release()


@contextlib.contextmanager
def xprof_capture(name: str):
    """With ``AUTOCYCLER_XPROF=<dir>``, captures one of the first
    ``AUTOCYCLER_XPROF_LIMIT`` blocks of ``name`` (the count is taken
    whether or not the profiler was free) and yields its trace path, else
    None. The caller links the path from the block's span."""
    xprof_dir = (knob_str("AUTOCYCLER_XPROF") or "").strip()
    if not xprof_dir:
        yield None
        return
    limit = knob_int("AUTOCYCLER_XPROF_LIMIT")
    with _xprof_lock:
        n = _xprof_counts.get(name, 0)
        if n >= limit:
            n = None
        else:
            _xprof_counts[name] = n + 1
    if n is None:
        yield None
        return
    path = os.path.join(xprof_dir, f"{_safe_name(name)}-{n}.json")
    with _profiled(path) as active:
        yield path if active else None


@contextlib.contextmanager
def _stage_profile(name: str):
    """With ``AUTOCYCLER_PROFILE_DIR=<dir>``, the stage ``name`` under the
    profiler, its trace at ``<dir>/<name>/trace-<n>.json``."""
    profile_dir = (knob_str("AUTOCYCLER_PROFILE_DIR") or "").strip()
    if not profile_dir:
        yield
        return
    with _xprof_lock:
        n = _stage_traces.get(name, 0)
        _stage_traces[name] = n + 1
    with _profiled(os.path.join(profile_dir, name, f"trace-{n}.json")):
        yield


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
    the substages inside it as ``[timing] <stage>: H:MM:SS.micros`` lines;
    with AUTOCYCLER_PROFILE_DIR set, profiles it."""
    before = substage_snapshot()
    start = time.perf_counter()
    try:
        with _stage_profile(name), trace.span(name, cat="stage"):
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
        if knob_bool("AUTOCYCLER_TIMINGS"):
            log.message(f"[timing] {name}: {format_duration(elapsed)}")
            for sub, secs in substage_deltas(before).items():
                log.message(f"[timing] {name} · {sub}: "
                            f"{format_duration(secs)}")


def reset() -> None:
    """Clears the metrics registry: the stage and substage seconds and
    every other count in it (cache events, QC gauges)."""
    metrics_registry.reset()
