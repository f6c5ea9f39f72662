"""Client-side job router: pick the least-loaded healthy replica.

`autocycler submit --fleet-dir` discovers every replica's ``serve.json``
(via :mod:`obs.federate`'s registry), probes each ``/healthz`` with the
federation timeout, and routes the job to the replica with the lowest
load score::

    ((queue_depth + busy_workers) / max(1, workers), jobs_total, name)

The leading term is pressure normalised by capacity — a 1-worker replica
with one running job is MORE loaded than a 4-worker replica with two.
``jobs_total`` (lifetime admissions from /healthz job counts) breaks
ties so an idle fleet round-robins instead of hammering the
lexicographically-first replica, and the name keeps the choice
deterministic. Shedding replicas (burn-rate degraded, see serve/slo.py)
are avoided while any non-shedding healthy replica exists; probes never
raise — an unreachable replica is simply not a candidate."""

from __future__ import annotations

import time
from typing import List, Optional

from ..obs import metrics_registry
from ..obs.federate import discover_replicas, fed_timeout_s
from ..utils import AutocyclerError
from .client import request_json

PICKS_TOTAL = "autocycler_router_picks_total"


class NoHealthyReplicaError(AutocyclerError):
    """Raised when routing finds no replica that answers /healthz."""


def probe_replicas(replicas: List[dict],
                   timeout: Optional[float] = None) -> List[dict]:
    """One /healthz round trip per replica; never raises. Returns one
    block per replica with its load inputs (unreachable -> healthy=False
    plus the error string)."""
    timeout = fed_timeout_s() if timeout is None else timeout
    probes: List[dict] = []
    for rep in replicas:
        block = {"name": rep["name"], "endpoint": rep["endpoint"],
                 "healthy": False, "queue_depth": 0, "busy_workers": 0,
                 "workers": 1, "jobs_total": 0, "shedding": False}
        t0 = time.perf_counter()
        try:
            status, health = request_json(rep["endpoint"], "GET", "/healthz",
                                          timeout=timeout)
        except (AutocyclerError, OSError, ValueError) as e:
            block["error"] = str(e)
            probes.append(block)
            continue
        block["probe_s"] = round(time.perf_counter() - t0, 6)
        if status != 200 or not isinstance(health, dict):
            block["error"] = f"healthz returned HTTP {status}"
            probes.append(block)
            continue
        jobs = health.get("jobs") or {}
        block.update(
            healthy=True,
            queue_depth=int(health.get("queue_depth") or 0),
            busy_workers=int(health.get("busy_workers") or 0),
            workers=max(1, int(health.get("workers") or 1)),
            jobs_total=sum(n for n in jobs.values()
                           if isinstance(n, int)),
            shedding=bool((health.get("slo") or {}).get("shedding")),
            version=health.get("version"))
        probes.append(block)
    return probes


def load_score(probe: dict) -> tuple:
    """Sort key: lower is less loaded (see module docstring)."""
    pressure = (probe.get("queue_depth", 0) + probe.get("busy_workers", 0)) \
        / max(1, probe.get("workers", 1))
    return (pressure, probe.get("jobs_total", 0), probe.get("name", ""))


def pick_replica(fleet_dir=None, endpoints: Optional[List[str]] = None,
                 timeout: Optional[float] = None,
                 registry=None) -> dict:
    """Discover + probe + choose. Returns the winning probe block
    (``endpoint`` is what the caller submits to). Raises
    :class:`NoHealthyReplicaError` when nothing answers."""
    replicas = discover_replicas(fleet_dir=fleet_dir, endpoints=endpoints)
    if not replicas:
        where = f"fleet dir {fleet_dir}" if fleet_dir is not None \
            else "endpoint list"
        raise NoHealthyReplicaError(
            f"no replicas discovered in {where} — is any "
            f"`autocycler serve` running with a root under it?")
    probes = probe_replicas(replicas, timeout=timeout)
    healthy = [p for p in probes if p["healthy"]]
    if not healthy:
        errors = "; ".join(f"{p['name']}: {p.get('error', 'unreachable')}"
                           for p in probes)
        raise NoHealthyReplicaError(
            f"no healthy replica among {len(probes)} probed ({errors})")
    # prefer replicas that are not shedding load; if the whole fleet is
    # degraded, the least-loaded shedding replica still beats a client error
    pool = [p for p in healthy if not p.get("shedding")] or healthy
    winner = min(pool, key=load_score)
    reg = registry or metrics_registry.registry()
    reg.counter_inc(PICKS_TOTAL, 1, help="router replica picks",
                    replica=winner["name"])
    winner = dict(winner)
    winner["candidates"] = len(healthy)
    return winner
