"""Process-wide metrics registry: named counters, gauges and histograms,
as the JAX package's obs/metrics_registry.py keeps them.

The run-level accounting of the port writes here: ``utils.timing``'s stage
and substage seconds, ``utils.cache``'s hit and miss counters and the QC
gauges of ``obs.qc``, and the serve daemon's job, queue, SLO and
device-token series. One snapshot answers "what did this run count?" for
``metrics.json`` in a trace run dir and for ``AUTOCYCLER_METRICS``.

Exports: :meth:`MetricsRegistry.snapshot` (JSON-able dict) and
:meth:`MetricsRegistry.to_prometheus` (Prometheus text exposition format,
version 0.0.4 — counters get a ``_total``-style sample per label set,
histograms get ``_bucket``/``_sum``/``_count`` samples with cumulative
``le`` buckets).

Thread-safe: one re-entrant lock guards the metric table; increments from
pool workers and the main thread interleave freely.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

# default histogram buckets: wall-clock seconds from sub-millisecond device
# dispatches up to multi-minute stages
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0, 300.0)

# seconds-to-minutes preset for stage latency histograms: the default
# buckets are device-dispatch-oriented (sub-millisecond resolution wasted on
# a 20 s stage)
SECONDS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.5, 10.0,
                   15.0, 20.0, 30.0, 45.0, 60.0, 120.0, 300.0, 600.0,
                   1200.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_sample(name: str, labels: _LabelKey, value) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


class _Metric:
    __slots__ = ("name", "kind", "help", "series")

    def __init__(self, name: str, kind: str, help: str = ""):
        self.name = name
        self.kind = kind          # "counter" | "gauge" | "histogram" | "info"
        self.help = help
        self.series: Dict[_LabelKey, object] = {}


class MetricsRegistry:
    """A named collection of counters/gauges/histograms with label support.

    One process-wide instance (:func:`registry`) backs the pipeline; tests
    construct private instances freely."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    # ---- write API ----

    def _metric(self, name: str, kind: str, help: str) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = _Metric(name, kind, help)
            self._metrics[name] = m
        elif m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, not {kind}")
        if help and not m.help:
            m.help = help
        return m

    def counter_inc(self, name: str, value: float = 1.0, help: str = "",
                    **labels) -> float:
        """Add ``value`` (>= 0) to a counter; returns the new total."""
        if value < 0:
            raise ValueError(f"counter {name} cannot decrease (got {value})")
        key = _label_key(labels)
        with self._lock:
            m = self._metric(name, "counter", help)
            total = m.series.get(key, 0.0) + value
            m.series[key] = total
            return total

    def gauge_set(self, name: str, value: float, help: str = "",
                  **labels) -> None:
        with self._lock:
            m = self._metric(name, "gauge", help)
            m.series[_label_key(labels)] = float(value)

    def info_set(self, name: str, text: str, help: str = "",
                 **labels) -> None:
        """A string-valued sample (e.g. the daemon's build). Exported to
        JSON verbatim and to Prometheus as a ``value="..."``-labelled 1."""
        with self._lock:
            m = self._metric(name, "info", help)
            m.series[_label_key(labels)] = str(text)

    def observe(self, name: str, value: float, help: str = "",
                buckets: Optional[Tuple[float, ...]] = None,
                **labels) -> None:
        """Record one observation into a histogram."""
        key = _label_key(labels)
        with self._lock:
            m = self._metric(name, "histogram", help)
            state = m.series.get(key)
            if state is None:
                bts = tuple(buckets) if buckets else DEFAULT_BUCKETS
                state = {"buckets": bts, "counts": [0] * (len(bts) + 1),
                         "sum": 0.0, "count": 0,
                         "min": float("inf"), "max": float("-inf")}
                m.series[key] = state
            state["sum"] += value
            state["count"] += 1
            state["min"] = min(state["min"], value)
            state["max"] = max(state["max"], value)
            for i, le in enumerate(state["buckets"]):
                if value <= le:
                    state["counts"][i] += 1
                    break
            else:
                state["counts"][-1] += 1

    # ---- read API ----

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current value of one counter/gauge series (0 when absent)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return default
            got = m.series.get(_label_key(labels))
            return default if got is None or isinstance(got, dict) else got

    def labeled(self, name: str, label: str) -> Dict[str, float]:
        """{label value: metric value} for every series of ``name`` carrying
        ``label`` (e.g. per-stage seconds keyed by the 'stage' label)."""
        out: Dict[str, float] = {}
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                return out
            for key, val in m.series.items():
                for k, v in key:
                    if k == label and not isinstance(val, dict):
                        out[v] = val
        return out

    def quantile(self, name: str, q: float, **labels) -> Optional[float]:
        """Streaming quantile estimate from one histogram series: walk the
        cumulative bucket counts to the bucket holding the ``q``-th
        observation and interpolate linearly inside it, clamped to the
        recorded [min, max]. None when the series is absent or empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m.kind != "histogram":
                return None
            state = m.series.get(_label_key(labels))
            if not isinstance(state, dict) or not state["count"]:
                return None
            edges = list(state["buckets"])
            counts = list(state["counts"])
            lo, hi = state["min"], state["max"]
            count = state["count"]
        target = q * count
        cum = 0.0
        prev_edge = 0.0
        for edge, c in zip(edges + [hi], counts):
            if c and cum + c >= target:
                frac = (target - cum) / c
                est = prev_edge + frac * (max(edge, prev_edge) - prev_edge)
                return min(max(est, lo), hi)
            cum += c
            prev_edge = edge
        return hi

    def snapshot(self) -> dict:
        """JSON-able {metric name: {"type", "help", "values": [...]}} where
        each value entry carries its labels dict and value (histograms: the
        full bucket state)."""
        out: dict = {}
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                values: List[dict] = []
                for key in sorted(m.series):
                    val = m.series[key]
                    entry: dict = {"labels": dict(key)}
                    if isinstance(val, dict):   # histogram state
                        entry.update(
                            sum=round(val["sum"], 6), count=val["count"],
                            min=(None if val["count"] == 0 else val["min"]),
                            max=(None if val["count"] == 0 else val["max"]),
                            buckets={str(le): c for le, c in
                                     zip(list(val["buckets"]) + ["+Inf"],
                                         val["counts"])})
                    else:
                        entry["value"] = round(val, 6) \
                            if isinstance(val, float) else val
                    values.append(entry)
                out[name] = {"type": m.kind, "help": m.help, "values": values}
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4). Counters/gauges export
        one sample per label set; histograms export cumulative ``_bucket``
        samples plus ``_sum``/``_count``; info metrics export a gauge 1 with
        the text riding in a ``value`` label."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                kind = {"info": "gauge"}.get(m.kind, m.kind)
                lines.append(f"# TYPE {name} {kind}")
                for key in sorted(m.series):
                    val = m.series[key]
                    if m.kind == "histogram":
                        cum = 0
                        for le, c in zip(list(val["buckets"]) + ["+Inf"],
                                         val["counts"]):
                            cum += c
                            lines.append(_prom_sample(
                                f"{name}_bucket", key + (("le", str(le)),),
                                cum))
                        lines.append(_prom_sample(f"{name}_sum", key,
                                                  round(val["sum"], 6)))
                        lines.append(_prom_sample(f"{name}_count", key,
                                                  val["count"]))
                    elif m.kind == "info":
                        lines.append(_prom_sample(
                            name, key + (("value", str(val)),), 1))
                    else:
                        v = round(val, 6) if isinstance(val, float) else val
                        lines.append(_prom_sample(name, key, v))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drops every metric."""
        with self._lock:
            self._metrics.clear()


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every pipeline accumulator writes to."""
    return _registry


# module-level conveniences over the process-wide registry
def counter_inc(name: str, value: float = 1.0, help: str = "",
                **labels) -> float:
    return _registry.counter_inc(name, value, help=help, **labels)


def gauge_set(name: str, value: float, help: str = "", **labels) -> None:
    _registry.gauge_set(name, value, help=help, **labels)


def info_set(name: str, text: str, help: str = "", **labels) -> None:
    _registry.info_set(name, text, help=help, **labels)


def observe(name: str, value: float, help: str = "",
            buckets: Optional[Tuple[float, ...]] = None, **labels) -> None:
    _registry.observe(name, value, help=help, buckets=buckets, **labels)


def quantile(name: str, q: float, **labels) -> Optional[float]:
    return _registry.quantile(name, q, **labels)


def snapshot() -> dict:
    return _registry.snapshot()


def to_prometheus() -> str:
    return _registry.to_prometheus()


def reset() -> None:
    _registry.reset()
