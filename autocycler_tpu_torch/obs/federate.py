"""Fleet federation's replica registry and build info, as the JAX
package's obs/federate.py has them (its build info names the port, torch
and CUDA).

- **Build info** (:func:`build_info`, :func:`record_build_info`): the
  package and runtime versions of this process, exported on every
  ``/metrics`` scrape as the ``autocycler_build_info`` info metric, so a
  reader of many replicas can see version skew.
- **The replica registry** (:func:`discover_replicas`): an explicit
  endpoint list, or a *fleet dir* scanned for ``serve.json`` discovery
  files (the fleet dir itself plus each immediate subdirectory — the
  natural layout is one serve root per replica under a shared parent).
  The router (``serve/router.py``) picks among these, each probe bounded
  by ``AUTOCYCLER_FED_TIMEOUT_S`` (:func:`fed_timeout_s`).

The JAX module's scraper, merged ``fleet_status.json`` snapshot and
scale-verdict engine serve only ``top --fleet``, which the port does not
have yet; they come with it.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Dict, List, Optional

from .. import __version__
from ..serve.protocol import SERVE_INFO_JSON
from ..utils.env import env_float
from . import metrics_registry

# replica version skew detection: every /metrics export carries this info
# metric (package version in the value label, runtime versions as labels)
BUILD_INFO = "autocycler_build_info"


def fed_timeout_s() -> float:
    """Seconds one replica probe may take (``AUTOCYCLER_FED_TIMEOUT_S``),
    re-read per call."""
    return max(0.05, float(env_float("AUTOCYCLER_FED_TIMEOUT_S")))


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
