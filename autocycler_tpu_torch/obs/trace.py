"""Span tracer: nested, attributed timing spans for a whole run, as the JAX
package's obs/trace.py records them.

One *run* (``start_run``/``finish_run``, normally driven by the CLI from
``AUTOCYCLER_TRACE_DIR``) records every :func:`span` the pipeline opens —
command, stage, substage and device granularity — to

- ``trace.jsonl``: one JSON record per completed span (id, parent, thread,
  start offset, duration, attributes, and a memory sample on top-level
  spans), streamed as spans close so a killed run keeps its partial trace;
- ``trace.chrome.json``: the same spans as Chrome ``trace_event`` complete
  ("ph": "X") events, loadable in Perfetto / ``chrome://tracing``;
- ``metrics.json`` / ``metrics.prom``: the metrics-registry snapshot at
  run end (JSON and Prometheus text format).

Parent/child nesting is tracked per thread (a span opened inside a pool
worker roots its own lane, as the Chrome viewer renders it).

Two kinds of run can be active at once:

- the process-wide run (``start_run``/``finish_run``): the CLI's; at most
  one exists, and a second ``start_run`` is an error;
- *scoped* runs (``open_run``/``bind_run``/``close_run``): the serve
  scheduler's, one per daemon job, bound to the thread(s) executing that
  job (``utils.pool`` carries the binding into pool tasks), so N
  concurrent jobs stream N disjoint ``trace.jsonl`` files from one
  process. A thread with no bound run falls back to the process-wide run,
  then, when exactly one scoped run is open, to that run.

The disabled path is free: with no active run, :func:`span` returns a
shared no-op context manager — no I/O, no per-call state — so tracing stays
in every hot path.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

from ..utils.env import env_str
from . import memory as obs_memory
from . import metrics_registry

TRACE_JSONL = "trace.jsonl"
TRACE_CHROME = "trace.chrome.json"
METRICS_JSON = "metrics.json"
METRICS_PROM = "metrics.prom"

# spans kept in memory for the Chrome export; a run that somehow exceeds
# this (a pathological per-item span in a hot loop) keeps streaming JSONL
# but stops growing the in-memory list, and records how many were dropped
MAX_SPANS_IN_MEMORY = 200_000

_lock = threading.Lock()
_local = threading.local()


class _Run:
    __slots__ = ("dir", "file", "t0_perf", "t0_epoch", "name", "spans",
                 "next_id", "dropped", "tids", "lock", "closed")

    def __init__(self, trace_dir: Path, name: str):
        self.dir = trace_dir
        self.file = open(trace_dir / TRACE_JSONL, "w")
        self.t0_perf = time.perf_counter()
        self.t0_epoch = time.time()
        self.name = name
        self.spans: List[dict] = []
        self.next_id = 1
        self.dropped = 0
        self.tids = {}          # thread ident -> small stable lane number
        self.lock = threading.Lock()   # per-run: id allocation + file writes
        self.closed = False


_run: Optional[_Run] = None
_scoped_runs: List[_Run] = []


def _active_run() -> Optional[_Run]:
    """The run the current thread should record into: its bound scoped run,
    else the process-wide run, else, when exactly one scoped run is open,
    that run."""
    run = getattr(_local, "run", None)
    if run is not None and not run.closed:
        return run
    run = _run
    if run is not None:
        return run
    scoped = _scoped_runs
    if len(scoped) == 1:
        return scoped[0]
    return None


class bind_run:
    """Bind a scoped run to the current thread for the duration of the
    ``with`` block: every :func:`span`, :func:`tracing_active` check and
    ledger hook on this thread resolves to ``run``. Nestable; restores the
    previous binding on exit."""

    def __init__(self, run: _Run):
        self.run = run

    def __enter__(self):
        self._prev = getattr(_local, "run", None)
        _local.run = self.run
        return self.run

    def __exit__(self, *exc):
        _local.run = self._prev
        return False


def current_run() -> Optional[_Run]:
    """The run the calling thread would record into (see
    :func:`_active_run`) — what pool helpers capture to propagate trace
    context into worker threads."""
    return _active_run()


def tracing_active() -> bool:
    return _active_run() is not None


def trace_dir() -> Optional[Path]:
    run = _active_run()
    return run.dir if run is not None else None


class _NoopSpan:
    """The shared disabled-path span: entering/exiting does nothing and
    allocates nothing (one module-level instance serves every call)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


def _stack(run: _Run) -> list:
    """The per-thread span stack of ``run``: nesting is tracked per
    (thread, run) so concurrent scoped runs never parent across runs."""
    stacks = getattr(_local, "stacks", None)
    if stacks is None:
        stacks = _local.stacks = {}
    stack = stacks.get(id(run))
    if stack is None:
        stack = stacks[id(run)] = []
    return stack


class _Span:
    __slots__ = ("name", "cat", "attrs", "id", "parent", "t0_perf", "ts",
                 "run")

    def __init__(self, name: str, cat: str, attrs: dict):
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def __enter__(self):
        run = _active_run()
        if run is None or run.closed:   # run finished before __enter__
            self.id = None
            self.run = None
            return self
        self.run = run
        stack = _stack(run)
        self.parent = stack[-1].id if stack else None
        with run.lock:
            self.id = run.next_id
            run.next_id += 1
        self.t0_perf = time.perf_counter()
        self.ts = self.t0_perf - run.t0_perf
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.id is None:
            return False
        dur = time.perf_counter() - self.t0_perf
        run = self.run
        stacks = getattr(_local, "stacks", None)
        stack = stacks.get(id(run)) if stacks else None
        if stack and stack[-1] is self:
            stack.pop()
            if not stack:
                del stacks[id(run)]
        record = {"type": "span", "name": self.name, "cat": self.cat,
                  "id": self.id, "parent": self.parent,
                  "ts": round(self.ts, 6), "dur": round(dur, 6)}
        if self.attrs:
            record["attrs"] = self.attrs
        if exc_type is not None:
            record["error"] = exc_type.__name__
        # top-level spans carry a memory sample: cheap (rusage, /proc and,
        # once CUDA is up, the caching allocator's count)
        if self.parent is None and self.cat in ("command", "stage", "run"):
            mem = obs_memory.memory_sample()
            if mem:
                record["mem"] = mem
        ident = threading.get_ident()
        with run.lock:
            if run.closed:
                return False
            record["tid"] = run.tids.setdefault(ident, len(run.tids))
            if len(run.spans) < MAX_SPANS_IN_MEMORY:
                run.spans.append(record)
            else:
                run.dropped += 1
            try:
                run.file.write(json.dumps(record, default=str) + "\n")
            except (OSError, ValueError):
                pass
        return False

    def set_attr(self, **attrs) -> None:
        """Attach/overwrite attributes after the span opened."""
        if self.attrs:
            self.attrs.update(attrs)
        else:
            self.attrs = dict(attrs)


def span(name: str, cat: str = "stage", **attrs):
    """A context manager timing one nested unit of work.

    With no active run this is the shared :data:`NOOP_SPAN`. With a run
    active it records start offset, duration, parent span (per-thread
    nesting), category and ``attrs`` into the run's span stream."""
    if _active_run() is None:
        return NOOP_SPAN
    return _Span(name, cat, attrs)


def current_span() -> Optional[_Span]:
    run = _active_run()
    if run is None:
        return None
    stacks = getattr(_local, "stacks", None)
    stack = stacks.get(id(run)) if stacks else None
    return stack[-1] if stack else None


def _create_run(trace_dir, name: str, trace_id: Optional[str] = None) -> _Run:
    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    run = _Run(trace_dir, name)
    header = {"type": "run", "name": name, "t0_epoch": run.t0_epoch,
              "pid": os.getpid(), "argv": list(sys.argv)}
    if trace_id:
        # cross-process correlation id (X-Autocycler-Trace)
        header["trace_id"] = trace_id
    run.file.write(json.dumps(header) + "\n")
    run.file.flush()
    return run


def start_run(trace_dir, name: str = "run") -> Path:
    """Begin recording the process-wide run into ``trace_dir`` (created if
    needed). Returns the directory. A second start while a run is active is
    an error — finish the first (the CLI owns the run lifecycle)."""
    global _run
    with _lock:
        if _run is not None:
            raise RuntimeError(
                f"a trace run is already active in {_run.dir}")
        _run = _create_run(trace_dir, name)
        return _run.dir


def open_run(trace_dir, name: str = "run",
             trace_id: Optional[str] = None) -> _Run:
    """Open a *scoped* run: records like the process-wide run but does not
    claim the process-wide slot, so any number can be open concurrently
    (one per serve job). Threads record into it via :class:`bind_run`;
    finish it with :func:`close_run`. ``trace_id`` (a client correlation
    id) lands in the run header."""
    run = _create_run(trace_dir, name, trace_id=trace_id)
    with _lock:
        _scoped_runs.append(run)
    return run


def maybe_start_run(name: str = "run") -> bool:
    """Start a run from ``AUTOCYCLER_TRACE_DIR`` when the variable is set
    and no run is active; returns True when this call started one (and so
    owns the matching :func:`finish_run`)."""
    target = (env_str("AUTOCYCLER_TRACE_DIR") or "").strip()
    if not target or _run is not None:
        return False
    try:
        start_run(target, name=name)
        return True
    except OSError as e:
        print(f"autocycler: cannot start trace run in {target!r}: {e}",
              file=sys.stderr)
        return False


def _finalize(run: _Run) -> Path:
    """Write the finish record, the Chrome trace and the metrics snapshot
    (JSON + Prometheus) for a run already removed from the active slots.
    Never raises on I/O problems — telemetry must not fail the pipeline."""
    wall = time.perf_counter() - run.t0_perf
    footer = {"type": "finish", "wall": round(wall, 6),
              "spans": len(run.spans) + run.dropped, "dropped": run.dropped,
              "mem": obs_memory.memory_sample()}
    try:
        run.file.write(json.dumps(footer, default=str) + "\n")
        run.file.close()
    except (OSError, ValueError):
        pass
    try:
        _write_chrome_trace(run.dir / TRACE_CHROME, run.spans, run.name)
    except OSError:
        pass
    try:
        reg = metrics_registry.registry()
        (run.dir / METRICS_JSON).write_text(reg.to_json() + "\n")
        (run.dir / METRICS_PROM).write_text(reg.to_prometheus())
    except OSError:
        pass
    return run.dir


def finish_run() -> Optional[Path]:
    """Close the process-wide run. Returns the run directory (None when no
    run was active)."""
    global _run
    with _lock:
        run = _run
        _run = None
    if run is None:
        return None
    with run.lock:
        run.closed = True
    return _finalize(run)


def close_run(run: _Run) -> Optional[Path]:
    """Close a scoped run opened with :func:`open_run`. Returns its
    directory (None when already closed). In-flight spans of other threads
    observe ``closed`` under the run lock and drop their records."""
    with _lock:
        if run in _scoped_runs:
            _scoped_runs.remove(run)
    with run.lock:
        if run.closed:
            return None
        run.closed = True
    return _finalize(run)


def write_metrics_file(path) -> None:
    """Write the Prometheus text snapshot to ``path`` (the
    ``AUTOCYCLER_METRICS`` hook for scrape-file collectors)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(metrics_registry.to_prometheus())


def _write_chrome_trace(path: Path, spans: List[dict], name: str) -> None:
    """Chrome trace_event JSON: one complete ("ph": "X") event per span,
    timestamps/durations in microseconds, thread lanes from the per-run
    small thread ids."""
    pid = os.getpid()
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": f"autocycler {name}"}}]
    for s in spans:
        events.append({
            "name": s["name"], "cat": s["cat"], "ph": "X",
            "ts": round(s["ts"] * 1e6, 3), "dur": round(s["dur"] * 1e6, 3),
            "pid": pid, "tid": s.get("tid", 0),
            "args": dict(s.get("attrs", {}),
                         **({"mem": s["mem"]} if "mem" in s else {})),
        })
    path.write_text(json.dumps({"traceEvents": events,
                                "displayTimeUnit": "ms"}))


def abort_run() -> None:
    """Drop every active run (process-wide and scoped) without writing its
    artifacts (test isolation)."""
    global _run
    with _lock:
        runs = ([_run] if _run is not None else []) + list(_scoped_runs)
        _run = None
        _scoped_runs.clear()
    for run in runs:
        run.closed = True
        try:
            run.file.close()
        except OSError:
            pass
