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
worker roots its own lane, as the Chrome viewer renders it). At most one
run is active in a process. The JAX package's scoped runs, one per serve
job, come with the serve daemon.

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
# this keeps streaming JSONL but stops growing the in-memory list, and
# records how many were dropped
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
        self.lock = threading.Lock()   # id allocation + file writes
        self.closed = False


_run: Optional[_Run] = None


def tracing_active() -> bool:
    return _run is not None


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
    """The per-thread span stack of ``run``."""
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
        run = _run
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
    if _run is None:
        return NOOP_SPAN
    return _Span(name, cat, attrs)


def current_span() -> Optional[_Span]:
    run = _run
    if run is None:
        return None
    stacks = getattr(_local, "stacks", None)
    stack = stacks.get(id(run)) if stacks else None
    return stack[-1] if stack else None


def start_run(trace_dir, name: str = "run") -> Path:
    """Begin recording the process-wide run into ``trace_dir`` (created if
    needed). Returns the directory. A second start while a run is active is
    an error: the CLI owns the run lifecycle."""
    global _run
    with _lock:
        if _run is not None:
            raise RuntimeError(
                f"a trace run is already active in {_run.dir}")
        trace_dir = Path(trace_dir)
        trace_dir.mkdir(parents=True, exist_ok=True)
        run = _Run(trace_dir, name)
        header = {"type": "run", "name": name, "t0_epoch": run.t0_epoch,
                  "pid": os.getpid(), "argv": list(sys.argv)}
        run.file.write(json.dumps(header) + "\n")
        run.file.flush()
        _run = run
        return run.dir


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


def finish_run() -> Optional[Path]:
    """Close the run: write the finish record, the Chrome trace and the
    metrics snapshot (JSON + Prometheus). Returns the run directory (None
    when no run was active). Never raises on I/O problems — telemetry must
    not fail the pipeline."""
    global _run
    with _lock:
        run = _run
        _run = None
    if run is None:
        return None
    with run.lock:
        run.closed = True
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
    """Drop the active run without writing its artifacts (test isolation)."""
    global _run
    with _lock:
        run = _run
        _run = None
    if run is not None:
        run.closed = True
        try:
            run.file.close()
        except OSError:
            pass
