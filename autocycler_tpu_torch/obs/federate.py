"""Fleet federation: many serve replicas, one merged view, as the JAX
package's obs/federate.py has it (its build info names the port, torch and
CUDA).

Every surface below this module describes one daemon (``/metrics``,
``/healthz``, ``top``, ``timeseries.jsonl``); this is the layer that sees
the fleet:

- a **replica registry** (:func:`discover_replicas`): an explicit endpoint
  list, or a *fleet dir* scanned for ``serve.json`` discovery files (the
  fleet dir itself plus each immediate subdirectory — the natural layout
  is one serve root per replica under a shared parent). The router
  (``serve/router.py``) picks among these;
- a **never-raise scraper** (:class:`FleetScraper`): polls each replica's
  ``/healthz`` and ``/metrics?format=json`` with a per-replica timeout
  (``AUTOCYCLER_FED_TIMEOUT_S``). A replica that fails a scrape keeps its
  last-known health for ``AUTOCYCLER_FED_STALE_S`` seconds, marked
  ``stale``, and is never picked by the router;
- a **merged snapshot** written atomically to ``fleet_status.json``:
  counters summed across replicas, gauges kept per replica plus a
  rollup, and latency histograms merged bucket-wise (counts added edge
  for edge, min of mins and max of maxes), so that the fleet's p50/p95
  come from the same :func:`obs.timeseries.snapshot_quantile` every
  other reader uses;
- **build info** (:func:`build_info`, :func:`record_build_info`): the
  package and runtime versions of this process on every ``/metrics``
  scrape, so a reader of many replicas sees version skew.

On the snapshot rides the **scale-verdict engine**: scale_out / steady /
scale_in from the fleet's burn rate, worker utilization and queue depth,
gated by hysteresis (``AUTOCYCLER_SCALE_HYSTERESIS`` consecutive agreeing
polls) and a flip cooldown (``AUTOCYCLER_SCALE_COOLDOWN_S``). Its state
persists inside ``fleet_status.json``, so one-shot ``top --fleet`` calls
accumulate hysteresis across processes as a long-lived poller does.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

from .. import __version__
from ..serve.protocol import SERVE_INFO_JSON
from ..utils import AutocyclerError
from ..utils.env import env_float, env_int
from . import metrics_registry
from .timeseries import _flat_key, snapshot_quantile

FLEET_STATUS_JSON = "fleet_status.json"

# federation self-telemetry (the scraper is itself a replica-grade
# process, so its own registry carries these; label is `replica`, never
# the Prometheus-reserved `job`)
SCRAPES_TOTAL = "autocycler_fed_scrapes_total"
SCRAPE_SECONDS = "autocycler_fed_scrape_seconds"
REPLICAS_GAUGE = "autocycler_fed_replicas"
VERDICT_GAUGE = "autocycler_fed_scale_verdict"

# replica version skew detection: every /metrics export carries this info
# metric (package version in the value label, runtime versions as labels)
BUILD_INFO = "autocycler_build_info"

VERDICTS = ("scale_in", "steady", "scale_out")
_VERDICT_VALUE = {"scale_in": -1, "steady": 0, "scale_out": 1}


# ---- knobs (re-read per call, operator-tunable against a live poller) ----

def fed_timeout_s() -> float:
    """Seconds one replica probe or scrape may take."""
    return max(0.05, float(env_float("AUTOCYCLER_FED_TIMEOUT_S")))


def fed_stale_s() -> float:
    return max(0.0, float(env_float("AUTOCYCLER_FED_STALE_S")))


def scale_knobs() -> dict:
    return {
        "out_burn": float(env_float("AUTOCYCLER_SCALE_OUT_BURN")),
        "out_util": float(env_float("AUTOCYCLER_SCALE_OUT_UTIL")),
        "out_queue": float(env_float("AUTOCYCLER_SCALE_OUT_QUEUE")),
        "in_util": float(env_float("AUTOCYCLER_SCALE_IN_UTIL")),
        "cooldown_s": max(0.0,
                          float(env_float("AUTOCYCLER_SCALE_COOLDOWN_S"))),
        "hysteresis": max(1, int(env_int("AUTOCYCLER_SCALE_HYSTERESIS"))),
    }


# ---- build info ----

def build_info() -> Dict[str, str]:
    """Package + runtime versions of THIS process — what a federated
    scrape compares across replicas to detect version skew: the port's,
    torch's, the CUDA torch was built for, and numpy's. Best-effort on
    every import (a replica without numpy still exports)."""
    info = {"autocycler_tpu_torch": __version__}
    for mod in ("torch", "numpy"):
        try:
            info[mod] = str(__import__(mod).__version__)
        except Exception:  # noqa: BLE001 — version probing must never fail
            info[mod] = "unavailable"
    try:
        import torch
        info["cuda"] = str(torch.version.cuda or "unavailable")
    except Exception:  # noqa: BLE001
        info["cuda"] = "unavailable"
    return info


def record_build_info(registry=None) -> Dict[str, str]:
    """Export :func:`build_info` as the ``autocycler_build_info`` info
    metric (package version in the sample value, runtime versions as
    labels) — called once at daemon startup so every /metrics scrape
    carries it."""
    reg = registry or metrics_registry.registry()
    info = build_info()
    labels = {k: v for k, v in info.items() if k != "autocycler_tpu_torch"}
    reg.info_set(BUILD_INFO, info["autocycler_tpu_torch"],
                 help="package and runtime versions of this replica",
                 **labels)
    return info


# ---- replica registry ----

def read_serve_info(path) -> dict:
    """Never-raise ``serve.json`` reader: a missing, torn or non-object
    discovery file is an empty dict, mirroring ``read_manifest``."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def discover_replicas(fleet_dir=None,
                      endpoints: Optional[List[str]] = None) -> List[dict]:
    """The replica registry: explicit endpoints first (named
    ``replica-N``), then every ``serve.json`` under ``fleet_dir`` (the dir
    itself and each immediate subdirectory, named by the directory).
    Duplicate endpoints collapse to the first mention. Never raises."""
    replicas: List[dict] = []
    seen = set()
    for i, raw in enumerate(endpoints or []):
        endpoint = str(raw).strip()
        if not endpoint or endpoint in seen:
            continue
        seen.add(endpoint)
        replicas.append({"name": f"replica-{i}", "endpoint": endpoint,
                         "root": None, "info": {}})
    if fleet_dir is not None:
        fleet_dir = Path(fleet_dir)
        candidates = [fleet_dir / SERVE_INFO_JSON]
        with contextlib.suppress(OSError):
            candidates.extend(sorted(
                p / SERVE_INFO_JSON for p in fleet_dir.iterdir()
                if p.is_dir()))
        for path in candidates:
            info = read_serve_info(path)
            endpoint = info.get("endpoint")
            if not isinstance(endpoint, str) or not endpoint \
                    or endpoint in seen:
                continue
            seen.add(endpoint)
            replicas.append({"name": path.parent.name or str(path.parent),
                             "endpoint": endpoint,
                             "root": str(path.parent), "info": info})
    return replicas


# ---- scraping ----

def scrape_replica(endpoint: str, timeout: Optional[float] = None) -> dict:
    """One replica's /healthz + /metrics?format=json, or ``{"error":
    ...}``. Never raises — a dead or slow replica costs one timeout, not
    the poll."""
    timeout = fed_timeout_s() if timeout is None else timeout
    from ..serve.client import request_json
    try:
        status, health = request_json(endpoint, "GET", "/healthz",
                                      timeout=timeout)
        if status != 200 or not isinstance(health, dict):
            return {"error": f"healthz returned HTTP {status}"}
        out = {"health": health, "metrics": {}}
        status, snap = request_json(endpoint, "GET", "/metrics?format=json",
                                    timeout=timeout)
        if status == 200 and isinstance(snap, dict):
            out["metrics"] = {name: metric for name, metric in snap.items()
                              if isinstance(metric, dict)
                              and isinstance(metric.get("values"), list)}
        return out
    except (AutocyclerError, OSError, ValueError) as e:
        return {"error": str(e)}


# ---- merging ----

def merge_hist_entries(entries: List[dict]) -> Optional[dict]:
    """Merge per-replica snapshot histogram entries bucket-wise into one
    entry KEEPING the snapshot shape, so :func:`snapshot_quantile` works
    on the result unchanged. Only entries sharing the same bucket edges
    merge (mismatched ladders cannot be added meaningfully); when edges
    disagree across replicas, the group with the most observations wins
    and the rest are counted in ``skipped``."""
    groups: Dict[tuple, List[dict]] = {}
    for entry in entries:
        buckets = entry.get("buckets")
        if not isinstance(buckets, dict) or not entry.get("count"):
            continue
        groups.setdefault(tuple(buckets.keys()), []).append(entry)
    if not groups:
        return None
    sig, group = max(groups.items(),
                     key=lambda kv: sum(e.get("count", 0) for e in kv[1]))
    merged: dict = {"labels": dict(group[0].get("labels") or {}),
                    "sum": 0.0, "count": 0, "min": None, "max": None,
                    "buckets": {edge: 0 for edge in sig},
                    "replicas": len(group),
                    "skipped": sum(len(g) for g in groups.values())
                    - len(group)}
    for entry in group:
        merged["count"] += int(entry.get("count") or 0)
        merged["sum"] = round(merged["sum"]
                              + float(entry.get("sum") or 0.0), 6)
        for bound in ("min", "max"):
            val = entry.get(bound)
            if isinstance(val, (int, float)):
                best = merged[bound]
                pick = min if bound == "min" else max
                merged[bound] = val if best is None else pick(best, val)
        for edge in sig:
            count = entry["buckets"].get(edge)
            if isinstance(count, int):
                merged["buckets"][edge] += count
    return merged


def merge_metrics(snapshots: Dict[str, dict]) -> dict:
    """Merge per-replica registry snapshots into the fleet view:
    ``counters`` summed per flat key, ``gauges`` kept per-replica with a
    sum/min/max rollup, ``hists`` merged bucket-wise with fleet p50/p95
    attached. Info metrics are kept per-replica (skew shows up as
    differing values)."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, dict] = {}
    hists: Dict[str, List[dict]] = {}
    infos: Dict[str, Dict[str, str]] = {}
    for rname in sorted(snapshots):
        snap = snapshots.get(rname) or {}
        for name, metric in snap.items():
            kind = metric.get("type")
            for entry in metric.get("values") or []:
                if not isinstance(entry, dict):
                    continue
                key = _flat_key(name, entry.get("labels") or {})
                value = entry.get("value")
                if kind == "counter" and isinstance(value, (int, float)):
                    counters[key] = round(counters.get(key, 0.0) + value, 6)
                elif kind == "gauge" and isinstance(value, (int, float)):
                    gauges.setdefault(key, {"replicas": {}})
                    gauges[key]["replicas"][rname] = value
                elif kind == "info":
                    infos.setdefault(key, {})[rname] = str(value)
                elif kind == "histogram":
                    hists.setdefault(key, []).append(entry)
    for rollup in gauges.values():
        vals = [v for v in rollup["replicas"].values()
                if isinstance(v, (int, float))]
        if vals:
            rollup.update(sum=round(sum(vals), 6), min=min(vals),
                          max=max(vals))
    merged_hists: Dict[str, dict] = {}
    for key, entries in hists.items():
        merged = merge_hist_entries(entries)
        if merged is not None:
            merged["p50"] = snapshot_quantile(merged, 0.50)
            merged["p95"] = snapshot_quantile(merged, 0.95)
            merged_hists[key] = merged
    return {"counters": counters, "gauges": gauges, "hists": merged_hists,
            "info": infos}


def build_summary(blocks: Dict[str, dict]) -> dict:
    """The fleet rollup the verdict engine (and `top --fleet`) consumes:
    queue/busy/worker sums, utilization, the worst per-replica burn rate
    and a version-skew flag, over every replica with usable (fresh or
    stale-carried) health."""
    healthy = [b for b in blocks.values() if b.get("healthy")]
    stale = [b for b in blocks.values()
             if not b.get("healthy") and isinstance(b.get("health"), dict)]
    usable = healthy + stale
    queue = busy = workers = 0
    burn: Optional[float] = None
    versions = set()
    jobs: Dict[str, int] = {}
    for block in usable:
        health = block["health"]
        queue += int(health.get("queue_depth") or 0)
        busy += int(health.get("busy_workers") or 0)
        workers += int(health.get("workers") or 0)
        if isinstance(health.get("version"), str):
            versions.add(health["version"])
        for state, n in (health.get("jobs") or {}).items():
            if isinstance(n, int):
                jobs[state] = jobs.get(state, 0) + n
        rate = (health.get("slo") or {}).get("burn_rate")
        if isinstance(rate, (int, float)):
            burn = rate if burn is None else max(burn, rate)
    return {
        "replicas": len(blocks),
        "healthy": len(healthy),
        "stale": len(stale),
        "down": len(blocks) - len(healthy) - len(stale),
        "queue_depth": queue,
        "busy_workers": busy,
        "workers": workers,
        "utilization": round(busy / workers, 4) if workers else None,
        "queue_per_replica": round(queue / max(1, len(healthy)), 4),
        "burn_rate": burn,
        "jobs": jobs,
        "versions": sorted(versions),
        "version_skew": len(versions) > 1,
    }


# ---- scale verdicts ----

class ScaleVerdictEngine:
    """Hysteresis-gated scale verdicts over the fleet summary.

    The *desired* verdict is recomputed every poll from the knobs
    (scale_out on burn, utilization or queue pressure; scale_in only on
    an idle multi-replica fleet with ``AUTOCYCLER_SCALE_IN_UTIL`` raised
    above its scale_in-disabling default of 0.0). The *published* verdict
    only flips after ``AUTOCYCLER_SCALE_HYSTERESIS`` consecutive polls
    agree AND the last flip is older than ``AUTOCYCLER_SCALE_COOLDOWN_S``
    — a single noisy window sample can never flap an autoscaler.

    State round-trips through the ``verdict`` block of
    ``fleet_status.json`` so one-shot pollers keep hysteresis."""

    def __init__(self, state: Optional[dict] = None):
        state = state if isinstance(state, dict) else {}
        self.verdict = state.get("verdict") \
            if state.get("verdict") in VERDICTS else "steady"
        self.streak_verdict = state.get("streak_verdict") \
            if state.get("streak_verdict") in VERDICTS else self.verdict
        self.streak = state.get("streak") \
            if isinstance(state.get("streak"), int) else 0
        self.since_epoch = state.get("since_epoch") \
            if isinstance(state.get("since_epoch"), (int, float)) else None
        self.last_flip_epoch = state.get("last_flip_epoch") \
            if isinstance(state.get("last_flip_epoch"), (int, float)) \
            else None

    def desired(self, summary: dict) -> tuple:
        """(desired verdict, reasons) from one fleet summary — ungated."""
        knobs = scale_knobs()
        burn = summary.get("burn_rate")
        util = summary.get("utilization")
        queue_pr = summary.get("queue_per_replica") or 0.0
        reasons: List[str] = []
        if isinstance(burn, (int, float)) and burn > knobs["out_burn"]:
            reasons.append(f"burn {burn:g} > {knobs['out_burn']:g}")
        if isinstance(util, (int, float)) and util > knobs["out_util"]:
            reasons.append(
                f"utilization {util:g} > {knobs['out_util']:g}")
        if queue_pr > knobs["out_queue"]:
            reasons.append(
                f"queue/replica {queue_pr:g} > {knobs['out_queue']:g}")
        if reasons:
            return "scale_out", reasons
        if summary.get("healthy", 0) > 1 \
                and isinstance(util, (int, float)) \
                and util < knobs["in_util"] \
                and not summary.get("queue_depth", 0) \
                and (burn is None or burn <= knobs["out_burn"] / 2.0):
            return "scale_in", [f"utilization {util:g} < "
                                f"{knobs['in_util']:g} with empty queue"]
        return "steady", reasons

    def evaluate(self, summary: dict, now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        knobs = scale_knobs()
        desired, reasons = self.desired(summary)
        if desired == self.verdict:
            self.streak_verdict, self.streak = desired, 0
        else:
            if desired == self.streak_verdict:
                self.streak += 1
            else:
                self.streak_verdict, self.streak = desired, 1
            cooled = self.last_flip_epoch is None \
                or now - self.last_flip_epoch >= knobs["cooldown_s"]
            if self.streak >= knobs["hysteresis"] and cooled:
                self.verdict = desired
                self.since_epoch = now
                self.last_flip_epoch = now
                self.streak = 0
        if self.since_epoch is None:
            self.since_epoch = now
        remaining = 0.0
        if self.last_flip_epoch is not None:
            remaining = max(0.0, knobs["cooldown_s"]
                            - (now - self.last_flip_epoch))
        return {
            "verdict": self.verdict,
            "desired": desired,
            "reasons": reasons,
            "streak": self.streak,
            "streak_verdict": self.streak_verdict,
            "needed": knobs["hysteresis"],
            "since_epoch": round(self.since_epoch, 3),
            "last_flip_epoch": round(self.last_flip_epoch, 3)
            if self.last_flip_epoch is not None else None,
            "cooldown_s": knobs["cooldown_s"],
            "cooldown_remaining_s": round(remaining, 3),
        }


# ---- the poller ----

def read_fleet_status(path) -> dict:
    """Never-raise ``fleet_status.json`` reader (missing/torn -> {})."""
    if path is None:
        return {}
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def write_fleet_status(path, snap: dict) -> Optional[Path]:
    """Atomic write (tempfile + rename) — a crashed poller or a
    concurrent reader never sees a torn snapshot. Never raises."""
    path = Path(path)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                   prefix=path.name + ".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except OSError:
        return None


class FleetScraper:
    """Polls every registered replica and maintains ``fleet_status.json``.

    One :meth:`poll` = one scrape of each replica + merge + verdict +
    atomic snapshot write. Construction reloads prior snapshot state, so
    staleness carry-forward and verdict hysteresis survive process
    boundaries (each `top --fleet` frame is its own process)."""

    def __init__(self, fleet_dir=None,
                 endpoints: Optional[List[str]] = None,
                 out_path=None, registry=None):
        self.fleet_dir = Path(fleet_dir) if fleet_dir is not None else None
        self.endpoints = list(endpoints) if endpoints else None
        if out_path is None and self.fleet_dir is not None:
            out_path = self.fleet_dir / FLEET_STATUS_JSON
        self.out_path = Path(out_path) if out_path is not None else None
        self._registry = registry or metrics_registry.registry()
        prior = read_fleet_status(self.out_path)
        self.engine = ScaleVerdictEngine(state=prior.get("verdict"))
        prev = prior.get("replicas")
        self._prev_replicas: Dict[str, dict] = \
            prev if isinstance(prev, dict) else {}

    def poll(self) -> dict:
        """One fleet poll; returns (and persists) the merged snapshot.
        Never raises — every replica failure is data, not an exception."""
        now = time.time()
        timeout = fed_timeout_s()
        stale_s = fed_stale_s()
        replicas = discover_replicas(self.fleet_dir, self.endpoints)
        blocks: Dict[str, dict] = {}
        snapshots: Dict[str, dict] = {}
        for rep in replicas:
            t0 = time.perf_counter()
            result = scrape_replica(rep["endpoint"], timeout=timeout)
            elapsed = time.perf_counter() - t0
            block: dict = {"endpoint": rep["endpoint"],
                           "root": rep.get("root"),
                           "scrape_s": round(elapsed, 6)}
            health = result.get("health")
            if isinstance(health, dict):
                block.update(healthy=True, stale=False,
                             scraped_epoch=round(now, 3), health=health)
                snapshots[rep["name"]] = result.get("metrics") or {}
                outcome = "ok"
            else:
                prev = self._prev_replicas.get(rep["name"]) or {}
                prev_epoch = prev.get("scraped_epoch")
                carried = isinstance(prev_epoch, (int, float)) \
                    and now - prev_epoch <= stale_s \
                    and isinstance(prev.get("health"), dict)
                block.update(
                    healthy=False, stale=True,
                    error=result.get("error") or "unreachable",
                    scraped_epoch=prev_epoch if carried else None,
                    health=prev.get("health") if carried else None)
                outcome = "error"
            self._registry.counter_inc(
                SCRAPES_TOTAL, 1, help="federated replica scrapes",
                replica=rep["name"], outcome=outcome)
            self._registry.observe(
                SCRAPE_SECONDS, elapsed,
                help="per-replica scrape round-trip seconds",
                replica=rep["name"])
            blocks[rep["name"]] = block
        summary = build_summary(blocks)
        verdict = self.engine.evaluate(summary, now=now)
        for state, n in (("healthy", summary["healthy"]),
                         ("stale", summary["stale"]),
                         ("down", summary["down"])):
            self._registry.gauge_set(
                REPLICAS_GAUGE, n, help="fleet replicas by scrape state",
                state=state)
        self._registry.gauge_set(
            VERDICT_GAUGE, _VERDICT_VALUE[verdict["verdict"]],
            help="fleet scale verdict (-1 scale_in, 0 steady, 1 scale_out)")
        snap = {
            "schema": 1,
            "polled_epoch": round(now, 3),
            "source": str(self.fleet_dir) if self.fleet_dir is not None
            else "endpoints",
            "replicas": blocks,
            "summary": summary,
            "metrics": merge_metrics(snapshots),
            "verdict": verdict,
        }
        self._prev_replicas = blocks
        if self.out_path is not None:
            write_fleet_status(self.out_path, snap)
        return snap
