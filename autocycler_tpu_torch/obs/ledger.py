"""Per-run provenance ledger: what went in, what came out, what was reused,
as the JAX package's obs/ledger.py writes it.

``ledger.json`` makes a run auditable after the fact: the sha256 of every
input file, the package, torch and CUDA versions and the effective
``AUTOCYCLER_*`` knobs it ran under, the warm-start cache lineage (parse,
end repair, kernel builds: did this run recompute or reuse?), and a
per-stage record of input → output artifact hashes. Two runs whose ledgers
match inputs, versions and knobs should match artifact hashes; when they
don't, the ledger says which stage diverged.

Collection is gated on an active trace run that has a directory
(:func:`..obs.trace.trace_dir`): hashing artifacts costs real I/O, and the
ledger is only written into a run directory anyway, so a run kept in
memory hashes nothing. The hashing is timed as the ``ledger`` substage.
The CLI resets the ledger when it starts a run and writes ``ledger.json``
atomically at run end, next to ``trace.jsonl`` and ``qc_report.json``.

Keys that differ from the JAX package's ledger, because the port runs
another stack:

- ``versions``: ``autocycler_tpu_torch`` (not ``autocycler_tpu``), the
  ``torch``, ``triton`` and ``nvidia-*`` distributions and
  ``torch.version.cuda``, in place of the jax, TPU and PJRT distributions;
- ``env``: every ``AUTOCYCLER_*`` knob, with ``CUDA_VISIBLE_DEVICES`` in
  place of the JAX platform pins (``JAX_PLATFORMS``, ``XLA_FLAGS``,
  ``LIBTPU_INIT_ARGS``, ``TPU_NAME``, ``PJRT_DEVICE``,
  ``TPU_LIBRARY_PATH``);
- ``caches``: ``compile`` names the kernel build dir
  (``autocycler_tpu_torch/_build/``, where nvcc's outputs are kept by a
  hash of their source: the port's counterpart of the XLA compile cache),
  and ``probe`` (the JAX package's ``recoveries``, ``last`` and
  ``negative_cache``) also holds ``overlap``, the device probe's overlap
  report (``device.probe_overlap_report``: its resolve, wait and overlap
  seconds in the run's process).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from ..utils.timing import substage
from . import metrics_registry, trace
from .qc import current_scope

LEDGER_JSON = "ledger.json"
SCHEMA = 1

_lock = threading.Lock()
# input table keyed (isolate scope, path): concurrent serve jobs hashing
# the same input files never clobber each other's lineage rows
_inputs: Dict[tuple, dict] = {}
_stages: List[dict] = []


def reset() -> None:
    with _lock:
        _inputs.clear()
        _stages.clear()


def _in_scope(iso, scope_name: str) -> bool:
    return iso == scope_name or (isinstance(iso, str)
                                 and iso.startswith(scope_name + "/"))


def drain_scope(scope_name: str) -> int:
    """Drop every input/stage entry tagged with ``scope_name`` (the serve
    daemon drains each job after its ledger is written, keeping the
    process-wide tables bounded). Returns the count removed."""
    with _lock:
        doomed = [k for k in _inputs if _in_scope(k[0], scope_name)]
        for k in doomed:
            del _inputs[k]
        keep = [s for s in _stages if not _in_scope(s.get("isolate"),
                                                    scope_name)]
        removed = len(doomed) + (len(_stages) - len(keep))
        _stages[:] = keep
    return removed


def artifact_hash(path) -> Optional[dict]:
    """{"sha256", "bytes"} of a file, streamed; None when unreadable."""
    h = hashlib.sha256()
    size = 0
    try:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
                size += len(chunk)
    except OSError:
        return None
    return {"sha256": h.hexdigest(), "bytes": size}


def record_inputs(paths) -> None:
    """Hash run input files (assembly FASTAs) into the ledger's top-level
    input table. No-op without an active trace run that has a directory;
    never raises."""
    if trace.trace_dir() is None:
        return
    with substage("ledger"):
        for path in paths:
            digest = artifact_hash(path)
            if digest is None:
                continue
            iso = current_scope()
            if iso:
                digest = dict(digest, isolate=iso)
            with _lock:
                _inputs[(iso, str(path))] = digest


def record_stage(stage: str, inputs=(), outputs=(),
                 cluster: Optional[str] = None, **extra) -> Optional[dict]:
    """One stage's input → output artifact hashes. Missing/unreadable files
    are skipped silently (a stage may legitimately not write an optional
    artifact). No-op without an active trace run that has a directory."""
    if trace.trace_dir() is None:
        return None
    with substage("ledger"):
        return _record_stage(stage, inputs, outputs, cluster, extra)


def _record_stage(stage: str, inputs, outputs, cluster: Optional[str],
                  extra: dict) -> dict:
    def table(paths) -> Dict[str, dict]:
        out = {}
        for path in paths:
            digest = artifact_hash(path)
            if digest is not None:
                out[str(path)] = digest
        return out

    entry = {"stage": stage, "ts_epoch": round(time.time(), 3),
             "inputs": table(inputs), "outputs": table(outputs)}
    iso = current_scope()
    if iso:
        entry["isolate"] = iso
    if cluster:
        entry["cluster"] = cluster
    if extra:
        entry["extra"] = extra
    with _lock:
        _stages.append(entry)
    return entry


def _env_knobs() -> dict:
    """The effective environment this run saw: the device pin plus every
    AUTOCYCLER knob. Secret-bearing knobs (``*TOKEN*``, ``*SECRET*``) are
    redacted — a ledger is an artifact clients download, never a
    credential store."""
    out = {}
    for k in sorted(os.environ):
        if not (k == "CUDA_VISIBLE_DEVICES" or k.startswith("AUTOCYCLER_")):
            continue
        out[k] = "<redacted>" if ("TOKEN" in k or "SECRET" in k) \
            else os.environ[k]
    return out


def _versions() -> dict:
    """The port's version, python's, torch's CUDA and every torch, triton
    and nvidia-* distribution from importlib metadata."""
    import platform
    import sys

    from .. import __version__

    packages = {}
    try:
        from importlib import metadata
        for dist in metadata.distributions():
            name = (dist.metadata.get("Name") or "").lower()
            if name in ("torch", "triton") or name.startswith("nvidia-"):
                packages[name] = dist.version
    except Exception:  # noqa: BLE001 — provenance must not fail the run
        pass
    torch = sys.modules.get("torch")
    return {"autocycler_tpu_torch": __version__,
            "python": platform.python_version(),
            "cuda": getattr(getattr(torch, "version", None), "cuda", None),
            "packages": dict(sorted(packages.items()))}


def _cache_lineage() -> dict:
    """Hit/miss lineage for the warm-start layers: the parse and end-repair
    caches (metrics registry) and the kernel build dir; and the device
    probe's recoveries, last logged outcome, negative cache and overlap
    report."""
    reg = metrics_registry.registry()
    lineage: dict = {}
    for which in ("parse", "repair"):
        lineage[which] = {
            "hits": int(reg.value("autocycler_cache_events_total",
                                  cache=which, event="hit")),
            "misses": int(reg.value("autocycler_cache_events_total",
                                    cache=which, event="miss")),
        }
    from ..ops._build import BUILD_DIR
    lineage["compile"] = {"enabled": True, "dir": str(BUILD_DIR)}
    probe: dict = {
        "recoveries": int(reg.value("autocycler_probe_recoveries_total")),
    }
    try:
        from .. import device
        from . import sentinel
        tail = sentinel.read_probe_log(limit=1)
        if tail:
            probe["last"] = tail[-1]
        log_path = sentinel.probe_log_path()
        if log_path is not None:
            neg = log_path.parent / "device_probe.json"
            probe["negative_cache"] = neg.is_file()
        probe["overlap"] = device.probe_overlap_report()
    except Exception:  # noqa: BLE001 — provenance must not fail the run
        pass
    lineage["probe"] = probe
    return lineage


def build_ledger(command: Optional[str] = None,
                 scope: Optional[str] = None,
                 trace_id: Optional[str] = None) -> dict:
    """The full ledger payload. With ``scope``, only inputs and stage
    entries tagged with that isolate scope are included: each concurrent
    serve job's ledger carries its own lineage. ``trace_id`` (the
    submission's correlation id) is recorded as an additive key."""
    with _lock:
        inputs = {key[1]: dict(digest) for key, digest in _inputs.items()
                  if scope is None or _in_scope(key[0], scope)}
        stages = [dict(s) for s in _stages
                  if scope is None or _in_scope(s.get("isolate"), scope)]
    ledger = {
        "schema": SCHEMA,
        "created_epoch": round(time.time(), 3),
        "inputs": inputs,
        "stages": stages,
        "env": _env_knobs(),
        "versions": _versions(),
        "caches": _cache_lineage(),
    }
    if command:
        ledger["command"] = command
    if trace_id:
        ledger["trace_id"] = trace_id
    return ledger


def write_ledger(run_dir, command: Optional[str] = None,
                 scope: Optional[str] = None,
                 trace_id: Optional[str] = None) -> Optional[Path]:
    """Write ``ledger.json`` atomically (tempfile + rename — a reader or a
    crash never sees a torn ledger). Returns the path, or None when there
    is nothing to record or the write failed. ``scope`` filters to one
    isolate scope's entries (see :func:`build_ledger`)."""
    payload = build_ledger(command, scope=scope, trace_id=trace_id)
    if not payload["inputs"] and not payload["stages"]:
        return None
    path = Path(run_dir) / LEDGER_JSON
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                   prefix=path.name + ".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        from ..utils.resilience import crash_point
        crash_point("pre-artifact-rename", str(path))
        os.replace(tmp, path)
        return path
    except OSError:
        return None
