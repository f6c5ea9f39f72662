"""Latency SLOs for the serve daemon: objectives, rolling-window quantiles
and burn rate, as the JAX package's serve/slo.py keeps them (the same knob
and metric names).

The scheduler reports every finished job's latency split — queue wait (admit
-> start) vs execution (start -> finish) — and the tracker keeps a
BOUNDED rolling window of recent totals (a deque capped in both count and
age, so a weeks-long daemon stores O(1) samples, never an unbounded
list). Long-horizon quantiles come from the registry's fixed-bucket
histograms via :meth:`MetricsRegistry.quantile`; window quantiles come
from the (small, bounded) sample window and drive the burn rate.

Objectives are environment knobs read at evaluation time —
``AUTOCYCLER_SLO_P50_S`` / ``AUTOCYCLER_SLO_P95_S`` — so an operator can
tighten or relax them against a live daemon without restarting it. When
the window's observed quantile exceeds an objective, ``/healthz`` flips
to ``"degraded"`` and reports the burn rate: the fraction of window jobs
violating the objective divided by the fraction the objective tolerates
(50% for p50, 5% for p95). Burn rate 1.0 means "burning budget exactly
as fast as allowed"; 2.0 means the error budget empties in half the
window.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..obs import metrics_registry
from ..obs.metrics_registry import SECONDS_BUCKETS
from ..utils.knobs import knob_float

P50_ENV = "AUTOCYCLER_SLO_P50_S"
P95_ENV = "AUTOCYCLER_SLO_P95_S"
WINDOW_ENV = "AUTOCYCLER_SLO_WINDOW_S"
SHED_BURN_ENV = "AUTOCYCLER_SLO_SHED_BURN"

DEFAULT_WINDOW_S = 3600.0
WINDOW_MAX_SAMPLES = 1024   # the hard size bound behind the time window

# registry metric names (the /metrics exports): histograms carry the full
# latency split; the gauge carries the live quantile estimates, labelled
# q= (the label "quantile" itself is reserved by Prometheus) and phase=
QUEUE_WAIT_SECONDS = "autocycler_serve_queue_wait_seconds"
EXEC_SECONDS = "autocycler_serve_exec_seconds"
LATENCY_QUANTILE = "autocycler_serve_latency_quantile_seconds"
LAST_FINISHED = "autocycler_serve_last_job_finished_epoch"

# tolerated violation fraction per objective: a p50 objective tolerates
# half the jobs over it, a p95 objective one in twenty
_ALLOWED_FRAC = {"p50_s": 0.50, "p95_s": 0.05}


def objectives() -> Dict[str, Optional[float]]:
    """The configured objectives, re-read from the environment on every
    call so a live daemon picks up changes without a restart. Unset or
    unparseable knobs mean "no objective"."""
    out: Dict[str, Optional[float]] = {}
    for key, env in (("p50_s", P50_ENV), ("p95_s", P95_ENV)):
        val = knob_float(env)
        out[key] = val if (val is not None and val > 0) else None
    return out


def window_seconds() -> float:
    return max(1.0, float(knob_float(WINDOW_ENV)))


def shed_burn_threshold() -> Optional[float]:
    """The burn rate above which the daemon sheds new submissions
    (admission control), or None when shedding is disabled. Re-read per
    call like the objectives, so it is operator-tunable live."""
    val = knob_float(SHED_BURN_ENV)
    return val if (val is not None and val > 0) else None


def _percentile(values: List[float], q: float) -> float:
    """Linear-interpolation percentile of a SMALL sorted sample (the
    bounded window — never the full job history)."""
    ordered = sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    pos = q * (len(ordered) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (pos - lo) * (ordered[hi] - ordered[lo])


class SloTracker:
    """Rolling-window latency tracker for the serve scheduler.

    :meth:`record` is called by the scheduler once per finished job and
    takes only this tracker's own lock (never the scheduler's run lock —
    the sampler and health endpoint read through the same lock, so a
    slow reader can never stall job execution). :meth:`report` evaluates
    the objectives against the current window."""

    def __init__(self, registry=None):
        self._registry = registry or metrics_registry.registry()
        self._lock = threading.Lock()
        # (finished_epoch, queue_wait_s, exec_s, total_s)
        self._window: deque = deque(maxlen=WINDOW_MAX_SAMPLES)
        self.last_finished_epoch: Optional[float] = None
        # service capacity = scheduler worker count: a pool of N workers
        # burns error budget N× faster at the same queue pressure, so the
        # shed trigger scales with it (set_capacity; default 1 keeps the
        # single-worker thresholds bit-for-bit)
        self._capacity = 1

    def set_capacity(self, workers: int) -> None:
        self._capacity = max(1, int(workers))

    # -- write path (scheduler) --

    def record(self, queue_wait_s: float, exec_s: float,
               finished_epoch: Optional[float] = None,
               command: str = "") -> None:
        """One finished job's latency split. Updates the histograms, the
        window and the exported quantile gauges."""
        now = finished_epoch if finished_epoch is not None else time.time()
        queue_wait_s = max(0.0, float(queue_wait_s))
        exec_s = max(0.0, float(exec_s))
        total = queue_wait_s + exec_s
        reg = self._registry
        reg.observe(QUEUE_WAIT_SECONDS, queue_wait_s,
                    help="per-job wait in the work queue (admit -> start)",
                    buckets=SECONDS_BUCKETS, command=command)
        reg.observe(EXEC_SECONDS, exec_s,
                    help="per-job execution wall (start -> finish)",
                    buckets=SECONDS_BUCKETS, command=command)
        reg.gauge_set(LAST_FINISHED, now,
                      help="epoch when the last serve job finished")
        with self._lock:
            self._window.append((now, queue_wait_s, exec_s, total))
            self.last_finished_epoch = now
            self._prune(now)
        for q, label in ((0.50, "0.50"), (0.95, "0.95")):
            for name, phase in ((QUEUE_WAIT_SECONDS, "queue_wait"),
                                (EXEC_SECONDS, "exec")):
                est = reg.quantile(name, q, command=command)
                if est is not None:
                    reg.gauge_set(
                        LATENCY_QUANTILE, round(est, 6),
                        help="streaming job-latency quantile estimates "
                             "(histogram bucket interpolation)",
                        q=label, phase=phase, command=command)
            totals = self._window_totals()
            if totals:
                reg.gauge_set(
                    LATENCY_QUANTILE, round(_percentile(totals, q), 6),
                    help="streaming job-latency quantile estimates "
                         "(histogram bucket interpolation)",
                    q=label, phase="total", command=command)

    def _prune(self, now: float) -> None:
        horizon = now - window_seconds()
        while self._window and self._window[0][0] < horizon:
            self._window.popleft()

    def _window_totals(self) -> List[float]:
        with self._lock:
            return [t for (_, _, _, t) in self._window]

    # -- read path (/healthz, sampler, bench) --

    def report(self) -> dict:
        """Objectives vs the rolling window: observed quantiles, burn
        rate and the violation verdict. Cheap and lock-light — callable
        from the health endpoint and the telemetry sampler while a job
        runs."""
        now = time.time()
        with self._lock:
            self._prune(now)
            window = list(self._window)
        obj = objectives()
        out: dict = {
            "objectives": obj,
            "window_s": window_seconds(),
            "window_jobs": len(window),
            "last_finished_epoch": self.last_finished_epoch,
        }
        out["workers"] = self._capacity
        if window:
            totals = [t for (_, _, _, t) in window]
            waits = [w for (_, w, _, _) in window]
            out["p50_s"] = round(_percentile(totals, 0.50), 6)
            out["p95_s"] = round(_percentile(totals, 0.95), 6)
            out["queue_wait_p50_s"] = round(_percentile(waits, 0.50), 6)
            out["queue_wait_p95_s"] = round(_percentile(waits, 0.95), 6)
            out["exec_p50_s"] = round(
                _percentile([e for (_, _, e, _) in window], 0.50), 6)
        burn = None
        violated = False
        for key, target in obj.items():
            if target is None or not window:
                continue
            frac = sum(1 for (_, _, _, t) in window if t > target) \
                / len(window)
            rate = round(frac / _ALLOWED_FRAC[key], 4)
            burn = max(burn, rate) if burn is not None else rate
            if out.get(key) is not None and out[key] > target:
                violated = True
        out["burn_rate"] = burn
        out["violated"] = violated
        shed_burn = shed_burn_threshold()
        out["shed_burn"] = shed_burn
        # capacity-aware admission control: N workers drain the same queue
        # N× faster, so the effective shed trigger is the configured
        # threshold × capacity (capacity 1 → exactly the old behavior).
        # shed_burn stays the raw knob value; the effective value rides
        # alongside so /healthz shows both.
        effective = shed_burn * self._capacity if shed_burn is not None \
            else None
        out["shed_burn_effective"] = effective
        # shedding clears by itself as the window drains: pruned samples
        # drop the burn rate back under the threshold
        out["shedding"] = bool(effective is not None and burn is not None
                               and burn > effective)
        return out
