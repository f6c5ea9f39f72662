"""The benchmark's own instrumentation of the window.

Always: a host clock around each stage call, ending in a synchronise, the
program's substage seconds and the process's host counters (CPU seconds,
bytes read and written) read around it, and for each isolate the program's
degrade events and its stream's summary (``spill.last_run``). With
``--trace 1`` also:

- CUDA events around every call into the k-mer grouping
  (``ops/sortnet.py``'s CUDA entry), into the overlap DP (``ops/align.py``
  ``overlap_screen_traceback``) and into cluster's sketch path
  (``ops/sketch.py``: ``sketch_from_codes``, one contig's minimizer hashing,
  and ``sketch_intersections``, the grid), with the shapes each call was
  given as the host holds them (no device work is added), by wrappers put
  in place for the window and taken out after; a sketch call is also
  synchronised at both ends, and its own kernels' and copies' seconds are
  taken from the trace (:func:`call_device_ms`);
- a ``torch.profiler`` trace of the device's activity in the window, read
  into the device's busy time, each device operation's seconds, and the
  longest idle gaps, labelled by the stage the host had open.
- the device's peak of allocated memory inside each stage call (the
  allocator's peak is reset as a stage begins, and the window's peak is the
  largest of the pieces).

The wrappers and the trace are the benchmark's: the program is not changed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from . import hostload


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Isolate:
    """What one isolate of the window recorded."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.substages: Dict[str, float] = {}
        self.grouping: List[dict] = []
        self.overlap_dp: List[dict] = []
        self.sketch_hash: List[dict] = []
        self.sketch_grid: List[dict] = []
        self.stage_peaks: Dict[str, int] = {}
        self.stream: dict = {}
        self.degrades: List[dict] = []
        self.qc_pass_clusters = 0
        self.wall_s = 0.0
        self.host: Dict[str, dict] = {}

    def as_dict(self) -> dict:
        return {"wall_s": self.wall_s, "stages": self.stages,
                "substages": self.substages, "grouping": self.grouping,
                "overlap_dp": self.overlap_dp, "sketch_hash": self.sketch_hash,
                "sketch_grid": self.sketch_grid, "stage_peaks": self.stage_peaks,
                "stream": self.stream, "degrades": self.degrades,
                "qc_pass_clusters": self.qc_pass_clusters, "host": self.host}


class Instrument:
    def __init__(self, device, trace: bool):
        self.device = device
        self.trace = trace and device.type == "cuda"
        self.current: Isolate = None
        self._pending: List[tuple] = []
        self._undo: List[tuple] = []
        self.spans: List[tuple] = []
        self._peak = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        """Host seconds of one stage call, ending in a synchronise, and the
        program's substage seconds it added."""
        from autocycler_tpu_torch.utils import timing

        before = timing.substage_snapshot()
        counters = hostload.process_counters()
        if self.trace:
            self._peak = max(self._peak, torch.cuda.max_memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)
        t0, ns0 = time.perf_counter(), time.time_ns()
        yield
        synchronize(self.device)
        rec = self.current
        if self.trace:
            peak = torch.cuda.max_memory_allocated(self.device)
            rec.stage_peaks[name] = max(rec.stage_peaks.get(name, 0), peak)
            self._peak = max(self._peak, peak)
        rec.stages[name] = rec.stages.get(name, 0.0) + time.perf_counter() - t0
        spent = hostload.counters_delta(counters, hostload.process_counters())
        summed = rec.host.setdefault(name, {})
        for key, value in spent.items():
            summed[key] = summed.get(key, 0) + value
        self.spans.append((ns0, time.time_ns(), name))
        for key, secs in timing.substage_snapshot().items():
            delta = secs - before.get(key, 0.0)
            if delta > 0:
                rec.substages[key] = rec.substages.get(key, 0.0) + delta

    def begin_isolate(self) -> Isolate:
        """A fresh record; the program's degrade events and stream summary
        are cleared, so that what the isolate leaves there is its own."""
        from autocycler_tpu_torch.stream import spill
        from autocycler_tpu_torch.utils import resilience

        resilience.reset_degrades()
        spill.reset_last_run()
        self.current = Isolate()
        return self.current

    def end_isolate(self) -> None:
        """Resolve the isolate's CUDA events (the isolate has synchronised),
        and keep its degrade events and stream summary."""
        from autocycler_tpu_torch.stream import spill
        from autocycler_tpu_torch.utils import resilience

        for kind, start, end, shape in self._pending:
            shape["ms"] = start.elapsed_time(end)
            getattr(self.current, kind).append(shape)
        self._pending.clear()
        self.current.stream = dict(spill.last_run)
        self.current.degrades = resilience.degrade_events()

    def peak_bytes(self) -> int:
        """The device's peak of allocated memory since ``install``."""
        return max(self._peak, torch.cuda.max_memory_allocated(self.device))

    # ---- the wrappers (--trace 1) ----

    def install(self) -> None:
        """At the window's start, once the allocator's peak is reset."""
        self._peak = 0
        if not self.trace:
            return
        from autocycler_tpu_torch.ops import align, sketch, sortnet

        self._wrap(sortnet, "pack_rank_cuda", self._grouping)
        self._wrap(align, "overlap_screen_traceback", self._overlap_dp)
        self._wrap(sketch, "sketch_from_codes", self._sketch_hash)
        self._wrap(sketch, "sketch_intersections", self._sketch_grid)

    def uninstall(self) -> None:
        for module, name, real in reversed(self._undo):
            setattr(module, name, real)
        self._undo.clear()

    def _wrap(self, module, name, make):
        real = getattr(module, name)
        self._undo.append((module, name, real))
        setattr(module, name, make(real))

    def _events(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        return start, end

    def _grouping(self, real):
        def timed(codes, starts, k):
            start, end = self._events()
            out = real(codes, starts, k)
            end.record()
            n = starts.numel()
            self._pending.append(("grouping", start, end, {
                "windows": n, "code_bytes":
                min(codes.numel(), k * n) * codes.element_size()}))
            return out
        return timed

    def _overlap_dp(self, real):
        def timed(arrs):
            start, end = self._events()
            out = real(arrs)
            end.record()
            self._pending.append(("overlap_dp", start, end, {
                "k": [int(v) for v in arrs["k"].tolist()]}))
            return out
        return timed

    def _sketch_hash(self, real):
        def timed(fwd, rc, k, w, s):
            shape = {"positions": int(fwd.shape[0]), "k": k, "w": w, "s": s}
            return self._between_synchronises(
                "sketch_hash", lambda: real(fwd, rc, k, w, s), shape)
        return timed

    def _sketch_grid(self, real):
        def timed(S, device=None):
            n, s = S.shape
            return self._between_synchronises("sketch_grid", lambda: real(S, device),
                                              {"contigs": n, "s": s})
        return timed

    def _between_synchronises(self, kind, call, shape):
        """``call()`` with the device idle before and after it: CUDA events
        around it (``ms``: the span on the stream, with its copies and the
        host's gaps between launches), and its host interval on the
        profiler's clock, from which :func:`call_device_ms` takes the device
        operations that are its own."""
        synchronize(self.device)
        ns0 = time.time_ns()
        start, end = self._events()
        out = call()
        end.record()
        synchronize(self.device)
        ns1 = time.time_ns()
        self._pending.append((kind, start, end, {**shape, "_ns": (ns0, ns1)}))
        return out


def call_device_ms(prof, isolates) -> None:
    """Each sketch call's own device time from the trace, put in its entry:
    ``kernel_ms``, the device operations that start inside the call's host
    interval, copies between host and device left out (what a roofline
    reads), and ``copy_ms``, those copies. The call synchronised at both
    ends, so nothing of another call starts inside it."""
    import bisect

    from . import attribute

    busy, copies = attribute.device_events(prof)

    def summed(intervals):
        intervals = sorted(intervals)
        starts = [t0 for t0, _ in intervals]
        total = [0]
        for t0, t1 in intervals:
            total.append(total[-1] + t1 - t0)
        return lambda lo, hi: (total[bisect.bisect_left(starts, hi)]
                               - total[bisect.bisect_left(starts, lo)])

    all_ns = summed(busy)
    copy_ns = summed([(t0, t1) for _, t0, t1 in copies])
    for rec in isolates:
        for entry in rec.sketch_hash + rec.sketch_grid:
            lo, hi = entry.pop("_ns")
            copied = copy_ns(lo, hi)
            entry["kernel_ms"] = (all_ns(lo, hi) - copied) / 1e6
            entry["copy_ms"] = copied / 1e6


# ---- the profiler (--trace 1) ----

def start_profiler():
    """A ``torch.profiler`` trace of the device's activity alone: recording
    every host op as well would slow the launch-bound loops it watches."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def read_trace(prof, spans, window) -> dict:
    """Busy seconds (the union of the device's kernel, copy and set
    intervals inside the ``window``), the window's seconds, each device
    operation's seconds inside it (``op_s``; the ten that took most are
    ``device_ops``), and the longest idle gaps, each cut at the edges of the
    stage ``spans`` (host ``time.time_ns()``, the clock the profiler's
    timestamps are on) and labelled by its stage."""
    w0, w1 = window
    device_iv = []
    by_name: Dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        device_iv.append((t0, t1))
        inside = min(t1, w1) - max(t0, w0)
        if inside > 0:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + inside / 1e9
    busy, gaps, cursor = 0, [], w0
    for t0, t1 in sorted(device_iv):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= cursor:
            continue
        if t0 > cursor:
            gaps.append((cursor, t0))
            busy += t1 - t0
        else:
            busy += t1 - cursor
        cursor = t1
    if cursor < w1:
        gaps.append((cursor, w1))
    pieces = []
    for g0, g1 in gaps:
        rest = g1 - g0
        for s0, s1, name in spans:
            lo, hi = max(g0, s0), min(g1, s1)
            if hi > lo:
                pieces.append((hi - lo, name))
                rest -= hi - lo
        if rest > 0:
            pieces.append((rest, "between stages"))
    pieces.sort(key=lambda p: -p[0])
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_events": len(device_iv),
        "first_event_after_window_start_s": (min(device_iv)[0] - w0) / 1e9
        if device_iv else None,
        "op_s": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[name, ns / 1e9] for ns, name in pieces[:10]],
    }
