"""Continuous telemetry: a background sampler that turns the point-in-time
metrics registry into a time series, as the JAX package's
obs/timeseries.py samples it.

Every observability surface before this one (spans, the registry snapshot,
`report`, `watch`, serve ``/metrics``) answers "what is true NOW / what was
true at the end?". The sampler answers "how did it evolve": a daemon thread
periodically snapshots the metrics registry, the host load (loadavg,
/proc/stat busy fraction, RSS), the card's bytes in use
(``device_bytes_in_use``, once CUDA is up) and the device probe's
overlap report (``device.probe_report``) into one JSON line per tick in
``timeseries.jsonl`` under the run or serve root. The CLI starts one beside
a traced run, the serve daemon one in its root.

Design constraints, in order:

- **Never block the pipeline.** The sampler shares no lock with the serve
  scheduler's run lock (or any pipeline code); it only takes the metrics
  registry's own re-entrant lock for the microseconds a snapshot takes,
  and every filesystem touch is wrapped so an unwritable disk degrades to
  silence, not a crashed worker.
- **Bounded size.** Counters are delta-encoded per tick (each line is
  self-contained — rotation never breaks decodability) and the file is
  rotated to the newest ``AUTOCYCLER_TIMESERIES_MAX`` lines with the same
  tempfile + atomic-replace pattern as
  ``probe_log.jsonl`` (obs/sentinel.py), so a weeks-long daemon cannot grow it unboundedly.
- **Torn-line safe readers.** A sampler killed mid-write leaves a partial
  final line; :func:`read_timeseries` only consumes up to the last
  newline and skips anything unparseable, mirroring the
  ``TraceFollower`` contract.

Knobs: ``AUTOCYCLER_TIMESERIES=0`` disables sampling,
``AUTOCYCLER_TIMESERIES_INTERVAL_S`` sets the tick period (default 5 s)
and ``AUTOCYCLER_TIMESERIES_MAX`` the rotation cap (default 2000 lines,
0 disables rotation).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import metrics_registry
from .memory import cuda_memory_sample
from ..utils.knobs import knob_bool, knob_float, knob_int

TIMESERIES_JSONL = "timeseries.jsonl"

# sampler self-telemetry: the liveness signal /healthz uses to detect a
# stale (wedged or dead) sampler, and the tick counter for rate math
TICKS_TOTAL = "autocycler_timeseries_ticks_total"
LAST_TICK_EPOCH = "autocycler_timeseries_last_tick_epoch"

def timeseries_enabled() -> bool:
    """Sampling is on by default; AUTOCYCLER_TIMESERIES=0/false/no/off
    turns it off."""
    return knob_bool("AUTOCYCLER_TIMESERIES")


def sample_interval() -> float:
    return max(0.05, float(knob_float("AUTOCYCLER_TIMESERIES_INTERVAL_S")))


def timeseries_max() -> int:
    """Rotation cap: keep only the newest N lines (0 disables rotation)."""
    return max(0, int(knob_int("AUTOCYCLER_TIMESERIES_MAX")))


# ---- host load ----

def host_sample() -> dict:
    """One host-load sample: loadavg, cumulative /proc/stat CPU jiffies
    (total + idle, so two samples give the busy fraction BETWEEN them),
    RSS and the interpreter's native thread count. Best-effort on every
    field — hosts without /proc still sample."""
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


def host_busy_frac(before: dict, after: dict) -> Optional[float]:
    """Whole-machine CPU busy fraction between two host samples (includes
    other processes — that contamination is the point), or None when
    either sample lacks /proc/stat."""
    t0, t1 = before.get("cpu_jiffies_total"), after.get("cpu_jiffies_total")
    i0, i1 = before.get("cpu_jiffies_idle"), after.get("cpu_jiffies_idle")
    if None in (t0, t1, i0, i1) or t1 <= t0:
        return None
    return round(1.0 - (i1 - i0) / (t1 - t0), 4)


# ---- registry flattening ----

def _flat_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    body = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{body}}}"


def snapshot_quantile(entry: dict, q: float) -> Optional[float]:
    """Quantile estimate from one SNAPSHOT histogram entry (the
    ``{"buckets": {le: count}, "count", "min", "max"}`` shape
    :meth:`MetricsRegistry.snapshot` emits) — the cross-process twin of
    :meth:`MetricsRegistry.quantile` for readers that only have the
    serialized state (top, report)."""
    count = entry.get("count") or 0
    buckets = entry.get("buckets")
    lo, hi = entry.get("min"), entry.get("max")
    if not count or not isinstance(buckets, dict) \
            or not isinstance(lo, (int, float)) \
            or not isinstance(hi, (int, float)):
        return None
    target = q * count
    cum = 0.0
    prev_edge = 0.0
    for raw_edge, c in buckets.items():
        edge = hi if raw_edge == "+Inf" else float(raw_edge)
        if c and cum + c >= target:
            frac = (target - cum) / c
            est = prev_edge + frac * (max(edge, prev_edge) - prev_edge)
            return min(max(est, lo), hi)
        cum += c
        prev_edge = edge
    return hi


def _flatten(snap: dict) -> Dict[str, dict]:
    """Registry snapshot -> {"gauges": {key: value}, "counters": {key:
    cumulative}, "hists": {key: {"count", "sum", "p50", "p95"}}}. Info
    metrics are skipped (strings do not plot)."""
    gauges: Dict[str, float] = {}
    counters: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    for name, metric in snap.items():
        kind = metric.get("type")
        for entry in metric.get("values", []):
            key = _flat_key(name, entry.get("labels") or {})
            if kind == "counter":
                counters[key] = entry.get("value", 0)
            elif kind == "gauge":
                gauges[key] = entry.get("value", 0)
            elif kind == "histogram" and entry.get("count"):
                hists[key] = {
                    "count": entry["count"],
                    "sum": entry.get("sum", 0.0),
                    "p50": snapshot_quantile(entry, 0.50),
                    "p95": snapshot_quantile(entry, 0.95),
                }
    return {"gauges": gauges, "counters": counters, "hists": hists}


# ---- the sampler ----

class TimeseriesSampler:
    """Background thread appending one telemetry tick per interval to
    ``<out_dir>/timeseries.jsonl``.

    Each line is self-contained: gauges carry current values, counters and
    histogram count/sum carry the DELTA since the previous tick (so a
    rotated-away prefix loses history, never decodability), and host load
    carries the busy fraction measured across the tick. ``extra`` is an
    optional callable merged into every tick (the serve daemon passes its
    SLO/queue state through it); it must be cheap and lock-light — the
    sampler never touches pipeline locks by construction."""

    def __init__(self, out_dir, interval: Optional[float] = None,
                 registry: Optional[metrics_registry.MetricsRegistry] = None,
                 extra: Optional[Callable[[], dict]] = None):
        self.path = Path(out_dir) / TIMESERIES_JSONL
        self.interval = sample_interval() if interval is None \
            else max(0.05, float(interval))
        self._registry = registry or metrics_registry.registry()
        self._extra = extra
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tick = 0
        self._prev_counters: Dict[str, float] = {}
        self._prev_hists: Dict[str, dict] = {}
        self._prev_host: Optional[dict] = None
        self.last_tick_epoch: Optional[float] = None

    # -- one tick --

    def sample(self) -> dict:
        """Take one tick now (the thread loop calls this; tests drive it
        synchronously). Returns the entry; never raises."""
        self._tick += 1
        now = time.time()
        entry: dict = {"ts": round(now, 3), "tick": self._tick,
                       "interval_s": self.interval}
        host = host_sample()
        if self._prev_host is not None:
            busy = host_busy_frac(self._prev_host, host)
            if busy is not None:
                host["cpu_busy_frac"] = busy
        self._prev_host = host
        entry["host"] = {k: v for k, v in host.items()
                         if k not in ("cpu_jiffies_total",
                                      "cpu_jiffies_idle")}
        try:
            flat = _flatten(self._registry.snapshot())
        except Exception:  # noqa: BLE001 — telemetry must never take
            flat = {"gauges": {}, "counters": {}, "hists": {}}  # down a run
        entry["gauges"] = flat["gauges"]
        entry["counters"] = {
            k: round(v - self._prev_counters.get(k, 0.0), 6)
            for k, v in flat["counters"].items()
            if v != self._prev_counters.get(k, 0.0)}
        self._prev_counters = flat["counters"]
        hists = {}
        for key, cur in flat["hists"].items():
            prev = self._prev_hists.get(key, {})
            hists[key] = {
                "count": cur["count"] - prev.get("count", 0),
                "sum": round(cur["sum"] - prev.get("sum", 0.0), 6),
                "p50": cur["p50"], "p95": cur["p95"]}
        self._prev_hists = flat["hists"]
        entry["hists"] = hists
        # the card's fields: bytes in use (only once CUDA is up: a tick
        # never initialises it) and the probe report
        entry.update(cuda_memory_sample())
        with contextlib.suppress(Exception):
            from ..device import probe_report
            entry["probe"] = probe_report()
        if self._extra is not None:
            with contextlib.suppress(Exception):
                entry.update(self._extra() or {})
        self.last_tick_epoch = now
        # self-telemetry AFTER the snapshot: the tick that records these
        # values is always the next one, keeping each line causal
        with contextlib.suppress(Exception):
            self._registry.counter_inc(
                TICKS_TOTAL, 1, help="telemetry sampler ticks taken")
            self._registry.gauge_set(
                LAST_TICK_EPOCH, now,
                help="epoch of the most recent telemetry sampler tick")
        self._append(entry)
        return entry

    def _append(self, entry: dict) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(entry, default=str) + "\n")
            _rotate_timeseries(self.path)
        except OSError:
            pass

    # -- lifecycle --

    def start(self) -> "TimeseriesSampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autocycler-timeseries", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        # no immediate tick: a run shorter than one interval records
        # nothing and pays only thread start/join — sampling overhead must
        # stay invisible next to a tiny traced run's wall clock
        while not self._stop.wait(self.interval):
            self.sample()

    def stop(self, final_sample: bool = True) -> None:
        """Stop the thread; by default takes one last tick — but only when
        the series already has ticks, so a sub-interval lifetime stays a
        zero-cost no-op."""
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=max(5.0, self.interval * 2))
        if final_sample and self._tick > 0:
            self.sample()

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


def _rotate_timeseries(path: Path) -> None:
    """Truncate to the newest ``timeseries_max()`` lines via tempfile +
    atomic replace: a reader never sees
    a torn file, and the cheap newline count keeps the steady state at one
    read."""
    cap = timeseries_max()
    if cap <= 0:
        return
    try:
        data = path.read_bytes()
    except OSError:
        return
    if data.count(b"\n") <= cap:
        return
    lines = data.splitlines(keepends=True)[-cap:]
    try:
        fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                   prefix=path.name + ".tmp")
        with os.fdopen(fd, "wb") as f:
            f.writelines(lines)
        os.replace(tmp, path)
    except OSError:
        pass


# ---- readers ----

def read_timeseries(path, limit: Optional[int] = None) -> List[dict]:
    """Parse a timeseries.jsonl (most recent last); ``limit`` keeps the
    tail. Torn final lines (no trailing newline yet) and malformed lines
    are skipped; a missing file is an empty series. Never raises."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError:
        return []
    cut = data.rfind(b"\n")
    if cut < 0:
        return []
    entries: List[dict] = []
    for line in data[:cut].split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(rec, dict):
            entries.append(rec)
    return entries[-limit:] if limit else entries


def _series(entries: List[dict], *path_keys: str) -> List[float]:
    """Numeric series for one nested key across entries (absent ticks are
    skipped, so schema growth never breaks old readers)."""
    out: List[float] = []
    for e in entries:
        node = e
        for k in path_keys:
            node = node.get(k) if isinstance(node, dict) else None
        if isinstance(node, (int, float)) and not isinstance(node, bool):
            out.append(float(node))
    return out


def _median(values: List[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    return ordered[mid] if n % 2 else (ordered[mid - 1] + ordered[mid]) / 2.0


def summarize_timeseries(entries: List[dict]) -> Optional[dict]:
    """min/median/max/last per sampled metric across the series — the
    ``report`` telemetry section. None for an empty series."""
    if not entries:
        return None

    def _dict(e: dict, key: str) -> dict:
        got = e.get(key)
        return got if isinstance(got, dict) else {}

    out: dict = {"ticks": len(entries)}
    ts = _series(entries, "ts")
    if len(ts) >= 2:
        out["span_s"] = round(ts[-1] - ts[0], 3)
    host: Dict[str, dict] = {}
    for field in ("cpu_busy_frac", "rss_bytes", "threads"):
        vals = _series(entries, "host", field)
        if vals:
            host[field] = {"min": min(vals), "median": _median(vals),
                           "max": max(vals), "last": vals[-1]}
    la = [_dict(e, "host").get("loadavg") for e in entries]
    la1 = [v[0] for v in la if isinstance(v, list) and v]
    if la1:
        host["loadavg1"] = {"min": min(la1), "median": _median(la1),
                            "max": max(la1), "last": la1[-1]}
    if host:
        out["host"] = host
    gauges: Dict[str, dict] = {}
    keys = {k for e in entries for k in _dict(e, "gauges")}
    for key in sorted(keys):
        vals = _series(entries, "gauges", key)
        if vals:
            gauges[key] = {"min": min(vals), "median": _median(vals),
                           "max": max(vals), "last": vals[-1]}
    if gauges:
        out["gauges"] = gauges
    counters: Dict[str, float] = {}
    for e in entries:
        for key, delta in _dict(e, "counters").items():
            if isinstance(delta, (int, float)):
                counters[key] = round(counters.get(key, 0.0) + delta, 6)
    if counters:
        out["counters"] = counters
    hists: Dict[str, dict] = {}
    for e in reversed(entries):
        for key, h in _dict(e, "hists").items():
            if key not in hists and isinstance(h, dict):
                hists[key] = {"p50": h.get("p50"), "p95": h.get("p95")}
    if hists:
        out["hists"] = hists
    return out


def purge_timeseries(root) -> tuple:
    """Delete the time-series artifacts under ``root``: the root's own
    ``timeseries.jsonl`` (+ leftover rotation temp files) and each serve
    job's. Returns (files removed, bytes reclaimed); missing dirs purge
    nothing — the `clean --cache` contract."""
    root = Path(root)
    removed = reclaimed = 0
    patterns = (TIMESERIES_JSONL, TIMESERIES_JSONL + ".tmp*",
                "jobs/*/" + TIMESERIES_JSONL,
                "jobs/*/" + TIMESERIES_JSONL + ".tmp*")
    for pattern in patterns:
        for path in root.glob(pattern):
            try:
                size = path.stat().st_size
                path.unlink()
            except OSError:
                continue
            removed += 1
            reclaimed += size
    return removed, reclaimed
