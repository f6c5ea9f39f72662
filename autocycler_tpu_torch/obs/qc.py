"""Scientific QC metrics: what the *science* of a run looked like, as the
JAX package's obs/qc.py records it.

The span tracer observes the process; this module observes the assembly
itself — how compact the unitig graph came out, which clusters passed QC
and why the rest failed, how much sequence trimming removed, how well
supported the consensus bridges were.

Each pipeline stage calls :func:`record` with its stage-specific metrics.
Every record is

- kept in an in-process journal, written to ``qc_report.json`` in the run
  directory at run end (the CLI drives this alongside ``ledger.json``);
- attached to the innermost open trace span as a ``qc`` attribute;
- registered in the metrics registry as ``autocycler_qc_<stage>_<key>``
  gauges (numeric scalars only).

:func:`scope` tags the records of one isolate (``batch`` wraps each
isolate's work in it, the serve daemon each job's). Collection is always on: the cost is a
few dict updates per *stage*, not per item.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import metrics_registry, trace

QC_REPORT_JSON = "qc_report.json"

# unitig depth histogram edges (×: bp of unitig sequence at that depth);
# depth ~= how many input assemblies cover the unitig, so the low buckets
# are assembler disagreement and the high ones are repeats
DEPTH_EDGES = (1.5, 2.5, 3.5, 5.0, 10.0, 100.0)
DEPTH_LABELS = ("<=1", "2", "3", "4-5", "5-10", "10-100", ">100")

_lock = threading.Lock()
_entries: List[dict] = []
_scope = threading.local()


def current_scope() -> Optional[str]:
    """The active isolate scope, or None: a serve job's id, an isolate's
    name (``batch``), or both as ``<job>/<isolate>`` when a serve job runs
    a fleet batch."""
    job = getattr(_scope, "job", None)
    name = getattr(_scope, "name", None)
    if job is None or name is None or name == job:
        return job if name is None else name
    return f"{job}/{name}"


class scope:
    """Context manager tagging every :func:`record` (and ledger entry)
    inside it with an isolate name — `batch` wraps each isolate's phases.
    Inside a :class:`job_scope` the tag is ``<job>/<name>``."""

    _attr = "name"

    def __init__(self, name: Optional[str]):
        self.name = name

    def __enter__(self):
        self._prev = getattr(_scope, self._attr, None)
        setattr(_scope, self._attr, self.name)
        return self

    def __exit__(self, *exc):
        setattr(_scope, self._attr, self._prev)
        return False


class job_scope(scope):
    """The serve scheduler's scope of one job: every record inside it is
    tagged with the job id, and an isolate :class:`scope` opened inside it
    (a fleet job's isolates) with ``<job>/<isolate>``, so the job's report
    and :func:`drain_scope` take them all."""

    _attr = "job"


def scope_context():
    """The calling thread's (job, isolate) scopes, for a pool task to run
    under (:func:`restore_scope`); None when neither is set."""
    ctx = (getattr(_scope, "job", None), getattr(_scope, "name", None))
    return None if ctx == (None, None) else ctx


@contextlib.contextmanager
def restore_scope(ctx):
    """Run the block under the scopes :func:`scope_context` captured."""
    job, name = ctx
    with job_scope(job), scope(name):
        yield


def reset() -> None:
    """Drop all journal entries (run start / test isolation)."""
    with _lock:
        _entries.clear()


def _in_scope(entry: dict, scope_name: str) -> bool:
    iso = entry.get("isolate")
    return iso == scope_name or (isinstance(iso, str)
                                 and iso.startswith(scope_name + "/"))


def drain_scope(scope_name: str) -> int:
    """Drop every journal entry tagged with ``scope_name`` (a serve daemon
    drains each job's entries after writing its report, so the process-wide
    journal stays bounded over thousands of jobs). Returns the count."""
    with _lock:
        keep = [e for e in _entries if not _in_scope(e, scope_name)]
        dropped = len(_entries) - len(keep)
        _entries[:] = keep
    return dropped


def record(stage: str, cluster: Optional[str] = None, **metrics) -> dict:
    """Journal one stage's QC metrics; returns the journal entry.

    Numeric scalars additionally become ``autocycler_qc_<stage>_<key>``
    gauges (labelled by isolate scope and cluster when present) and ride
    the innermost open span as a ``qc`` attribute. Never raises — QC
    observation must not fail the stage it observes."""
    entry = {"stage": stage, "ts_epoch": round(time.time(), 3),
             "metrics": metrics}
    iso = current_scope()
    if iso:
        entry["isolate"] = iso
    if cluster:
        entry["cluster"] = cluster
    with _lock:
        _entries.append(entry)
    scalars = {}
    for key, value in metrics.items():
        if isinstance(value, bool):
            scalars[key] = int(value)
        elif isinstance(value, (int, float)):
            scalars[key] = value
    try:
        labels = {}
        if iso:
            labels["isolate"] = iso
        if cluster:
            labels["cluster"] = cluster
        for key, value in scalars.items():
            metrics_registry.gauge_set(
                f"autocycler_qc_{stage}_{key}", value,
                help=f"assembly QC: {stage} {key.replace('_', ' ')}",
                **labels)
    except Exception:  # noqa: BLE001 — a bad metric name must not kill QC
        pass
    try:
        sp = trace.current_span()
        if sp is not None and hasattr(sp, "set_attr"):
            key = f"{stage}/{cluster}" if cluster else stage
            existing = (sp.attrs or {}).get("qc")
            merged = dict(existing) if isinstance(existing, dict) else {}
            merged[key] = scalars
            sp.set_attr(qc=merged)
    except Exception:  # noqa: BLE001
        pass
    return entry


def entries() -> List[dict]:
    with _lock:
        return [dict(e) for e in _entries]


def summary(journal: Optional[List[dict]] = None) -> dict:
    """Aggregate the journal per stage: numeric metrics sum across entries
    (one compress entry stays itself; per-cluster trim entries add up),
    booleans AND together, and an ``entries`` count records how many calls
    contributed. Isolate-scoped entries aggregate under ``isolates``.
    Pass ``journal`` to aggregate a given entry list instead of the live
    journal."""
    out: dict = {}
    iso_out: Dict[str, dict] = {}
    if journal is None:
        with _lock:
            journal = list(_entries)
    for entry in journal:
        target = out
        if entry.get("isolate"):
            target = iso_out.setdefault(entry["isolate"], {})
        agg = target.setdefault(entry["stage"], {"entries": 0})
        agg["entries"] += 1
        for key, value in entry["metrics"].items():
            if isinstance(value, bool):
                agg[key] = bool(agg.get(key, True)) and value
            elif isinstance(value, (int, float)):
                agg[key] = round(agg.get(key, 0) + value, 6)
    if iso_out:
        out["isolates"] = iso_out
    return out


def write_qc_report(run_dir, scope: Optional[str] = None,
                    trace_id: Optional[str] = None) -> Optional[Path]:
    """Write ``qc_report.json`` (journal + summary) atomically into the run
    directory; returns the path (None on failure or empty journal —
    telemetry never fails the pipeline). With ``scope``, only entries
    tagged with that isolate scope are written: how concurrent serve jobs
    each get a report of their own entries from the shared journal.
    ``trace_id`` (the submission's correlation id) rides along as an
    additive payload key."""
    with _lock:
        selected = [dict(e) for e in _entries
                    if scope is None or _in_scope(e, scope)]
    if not selected:
        return None
    payload = {"schema": 1, "created_epoch": round(time.time(), 3),
               "entries": selected}
    if trace_id:
        payload["trace_id"] = trace_id
    payload["summary"] = summary(selected)
    path = Path(run_dir) / QC_REPORT_JSON
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                   prefix=path.name + ".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except OSError:
        return None


# ---- per-stage metric builders (called by commands/*) ----

def n50(lengths) -> int:
    """Standard N50: the length at which half the total is in contigs at
    least that long."""
    ordered = sorted((int(n) for n in lengths), reverse=True)
    total = sum(ordered)
    running = 0
    for length in ordered:
        running += length
        if 2 * running >= total:
            return length
    return 0


def depth_histogram(graph) -> Dict[str, int]:
    """bp of unitig sequence per depth bucket (k-mer depth ~= assemblies
    covering the unitig)."""
    hist = {label: 0 for label in DEPTH_LABELS}
    for unitig in graph.unitigs:
        depth = float(unitig.depth)
        for edge, label in zip(DEPTH_EDGES, DEPTH_LABELS):
            if depth <= edge:
                hist[label] += unitig.length()
                break
        else:
            hist[DEPTH_LABELS[-1]] += unitig.length()
    return {label: bp for label, bp in hist.items() if bp}


def compress_qc(graph, sequences) -> dict:
    """Unitig count / N50 / total bp + the depth histogram of the
    compacted graph (called after simplify)."""
    lengths = [u.length() for u in graph.unitigs]
    return record(
        "compress",
        unitigs=len(graph.unitigs),
        total_bp=int(graph.total_length()),
        n50_bp=n50(lengths),
        input_contigs=len(sequences),
        input_bp=int(sum(s.length for s in sequences)),
        depth_hist_bp=depth_histogram(graph),
    )


def cluster_qc(sequences, qc_results) -> dict:
    """Pass/fail counts, size balance across passing clusters, and the
    per-cluster verdicts with distances and failure reasons."""
    clusters = []
    pass_sizes = []
    for c in sorted(qc_results):
        qc = qc_results[c]
        members = [s for s in sequences if s.cluster == c]
        passed = qc.passed()
        clusters.append({
            "cluster": c, "passed": passed,
            "contigs": len(members),
            "total_bp": int(sum(s.length for s in members)),
            "distance": round(float(qc.cluster_dist), 6),
            "failure_reasons": list(qc.failure_reasons),
        })
        if passed:
            pass_sizes.append(len(members))
    balance = round(min(pass_sizes) / max(pass_sizes), 4) \
        if pass_sizes and max(pass_sizes) else 0.0
    return record(
        "cluster",
        clusters_pass=sum(c["passed"] for c in clusters),
        clusters_fail=sum(not c["passed"] for c in clusters),
        size_balance_ratio=balance,
        clusters=clusters,
    )


def trim_qc(cluster_name: str, orig_lengths: Dict[int, int],
            start_end_count: int, hairpin_count: int, chosen,
            kept_sequences, excluded_ids) -> dict:
    """bp trimmed per contig plus the start-end vs hairpin decision.
    ``chosen`` is the winning TrimResult list aligned with the original
    sequence order (ids index ``orig_lengths``)."""
    per_contig = []
    trimmed_bp = 0
    for seq_id, result in chosen:
        if result is None:
            continue
        from_bp = int(orig_lengths.get(seq_id, 0))
        to_bp = int(result[1])
        per_contig.append({"id": seq_id, "from_bp": from_bp, "to_bp": to_bp,
                           "trimmed_bp": from_bp - to_bp})
        trimmed_bp += from_bp - to_bp
    trim_type = "none"
    if start_end_count or hairpin_count:
        trim_type = "start_end" if start_end_count >= hairpin_count \
            else "hairpin"
    return record(
        "trim", cluster=cluster_name,
        contigs=len(orig_lengths),
        trimmed_contigs=len(per_contig),
        trimmed_bp=trimmed_bp,
        start_end_trims=start_end_count,
        hairpin_trims=hairpin_count,
        excluded_contigs=len(excluded_ids),
        kept_contigs=len(kept_sequences),
        trim_type=trim_type,
        per_contig=per_contig,
    )


def resolve_qc(cluster_name: str, anchors: int, bridges,
               conflicting: int, culled: int) -> dict:
    """Anchor count, unique-vs-conflicting bridge split and consensus path
    support (the per-bridge count of input paths agreeing with the medoid)."""
    depths = [b.depth() for b in bridges]
    return record(
        "resolve", cluster=cluster_name,
        anchors=anchors,
        bridges=len(bridges),
        unique_bridges=len(bridges) - conflicting,
        conflicting_bridges=conflicting,
        culled_bridges=culled,
        min_bridge_support=min(depths) if depths else 0,
        mean_bridge_support=round(sum(depths) / len(depths), 3)
        if depths else 0.0,
    )


def combine_qc(metrics) -> dict:
    """Final consensus shape from the CombineMetrics the stage just saved."""
    return record(
        "combine",
        clusters=len(metrics.consensus_assembly_clusters),
        consensus_bp=int(metrics.consensus_assembly_bases),
        consensus_unitigs=int(metrics.consensus_assembly_unitigs),
        fully_resolved=bool(metrics.consensus_assembly_fully_resolved),
    )
