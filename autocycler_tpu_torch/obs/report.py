"""`autocycler report <dir>`: merge one run's telemetry into a readable
report, as the JAX package's obs/report.py renders it (its memory line
reads the card's ``device_bytes_in_use``, its provenance line names
``autocycler_tpu_torch`` and the CUDA version of the ledger).

Inputs, all optional except that at least one must exist in the directory:

- ``trace.jsonl`` (obs.trace) — the span stream: rendered as a nested stage
  tree with durations, call counts, share-of-parent percentages and the
  memory samples attached to top-level spans;
- ``metrics.json`` (metrics-registry snapshot) — rendered as the
  device-vs-host split, cache hit/miss summary, degradation/fault/retry
  summary and pool counters;
- ``batch_manifest.json`` (utils.resilience.RunManifest) — per-isolate
  status lines;
- ``qc_report.json`` (obs.qc) — per-stage scientific QC: unitig shape,
  cluster pass/fail verdicts, trim decisions, bridge support;
- ``ledger.json`` (obs.ledger) — input hashes, versions, env knobs, cache
  lineage and per-stage artifact hashes;
- ``BENCH*.json`` bench artifacts — one summary line each;
- ``lint_report.json`` (commands.lint ``--report``) — the static-analysis
  verdict, file count and findings.

``--json`` emits the merged structure as one JSON document instead, and
``--html`` additionally writes a self-contained ``run_report.html``.
"""

from __future__ import annotations

import html as _html
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from .ledger import LEDGER_JSON
from .qc import QC_REPORT_JSON
from .timeseries import (TIMESERIES_JSONL, read_timeseries,
                         summarize_timeseries)
from .trace import METRICS_JSON, TRACE_JSONL

RUN_REPORT_HTML = "run_report.html"
LINT_REPORT_JSON = "lint_report.json"

# report total vs recorded wall-clock agreement gate (the acceptance bar:
# a stage tree that disagrees with the wall by more than this is reported
# loudly — it means spans are missing or double-counted)
WALL_AGREEMENT = 0.05


def _fmt_s(seconds: float) -> str:
    if seconds >= 60:
        m, s = divmod(seconds, 60.0)
        return f"{int(m)}m{s:04.1f}s"
    if seconds >= 0.9995:
        return f"{seconds:.2f}s"
    return f"{seconds * 1000:.1f}ms"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def load_trace(path) -> Optional[dict]:
    """Parse a trace.jsonl into {"run": header, "spans": [...], "finish":
    footer-or-None}. Unparseable lines are skipped (a killed run can leave
    a torn final line)."""
    path = Path(path)
    if not path.is_file():
        return None
    run = finish = None
    spans: List[dict] = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        kind = rec.get("type")
        if kind == "run":
            run = rec
        elif kind == "finish":
            finish = rec
        elif kind == "span":
            spans.append(rec)
    return {"run": run or {}, "spans": spans, "finish": finish}


def span_tree(spans: List[dict]) -> List[dict]:
    """Aggregate the flat span stream into a nested tree: siblings with the
    same (name, cat) merge into one node carrying summed duration, call
    count, earliest start and the last memory sample seen. Children order
    is earliest-start first (pipeline order)."""
    by_parent: Dict[Optional[int], List[dict]] = {}
    for s in spans:
        by_parent.setdefault(s.get("parent"), []).append(s)

    def build(parent_ids: List[Optional[int]]) -> List[dict]:
        kids = [s for pid in parent_ids for s in by_parent.get(pid, [])]
        groups: Dict[tuple, dict] = {}
        for s in kids:
            g = groups.setdefault((s["name"], s.get("cat", "")), {
                "name": s["name"], "cat": s.get("cat", ""),
                "seconds": 0.0, "count": 0, "first_ts": s.get("ts", 0.0),
                "mem": None, "ids": []})
            g["seconds"] += s.get("dur", 0.0)
            g["count"] += 1
            g["first_ts"] = min(g["first_ts"], s.get("ts", 0.0))
            g["ids"].append(s.get("id"))
            if "mem" in s:
                g["mem"] = s["mem"]
        nodes = sorted(groups.values(), key=lambda g: g["first_ts"])
        for node in nodes:
            node["children"] = build(node.pop("ids"))
            node["seconds"] = round(node["seconds"], 6)
            del node["first_ts"]
        return nodes

    return build([None])


def _render_tree(nodes: List[dict], lines: List[str], depth: int = 0,
                 parent_seconds: Optional[float] = None) -> None:
    for node in nodes:
        pct = ""
        if parent_seconds and parent_seconds > 0:
            pct = f"  {100.0 * node['seconds'] / parent_seconds:5.1f}%"
        count = f"  x{node['count']}" if node["count"] > 1 else ""
        label = f"{'  ' * depth}{node['name']}"
        lines.append(f"  {label:<44} {_fmt_s(node['seconds']):>9}"
                     f"{pct}{count}")
        if node.get("mem"):
            mem = node["mem"]
            bits = []
            if "peak_rss_bytes" in mem:
                bits.append(f"peak RSS {_fmt_bytes(mem['peak_rss_bytes'])}")
            if "device_bytes_in_use" in mem:
                bits.append(
                    f"device {_fmt_bytes(mem['device_bytes_in_use'])}")
            if bits:
                lines.append(f"  {'  ' * depth}  [{'; '.join(bits)}]")
        _render_tree(node["children"], lines, depth + 1, node["seconds"])


def _metric_values(snapshot: dict, name: str) -> List[dict]:
    return snapshot.get(name, {}).get("values", [])


def _metric_total(snapshot: dict, name: str) -> float:
    return sum(v.get("value", 0) for v in _metric_values(snapshot, name)
               if isinstance(v.get("value"), (int, float)))


def _metric_by_label(snapshot: dict, name: str, label: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for v in _metric_values(snapshot, name):
        key = v.get("labels", {}).get(label)
        if key is not None and isinstance(v.get("value"), (int, float)):
            out[key] = out.get(key, 0) + v["value"]
    return out


def build_report(run_dir) -> Optional[dict]:
    """The merged report structure, or None when the directory holds no
    telemetry at all."""
    run_dir = Path(run_dir)
    trace = load_trace(run_dir / TRACE_JSONL)
    metrics = None
    metrics_path = run_dir / METRICS_JSON
    if metrics_path.is_file():
        try:
            metrics = json.loads(metrics_path.read_text())
        except (OSError, json.JSONDecodeError):
            metrics = None
    manifest = None
    manifest_path = run_dir / "batch_manifest.json"
    if manifest_path.is_file():
        try:
            manifest = json.loads(manifest_path.read_text())
        except (OSError, json.JSONDecodeError):
            manifest = None
    qc = ledger = None
    for name, slot in ((QC_REPORT_JSON, "qc"), (LEDGER_JSON, "ledger")):
        path = run_dir / name
        if path.is_file():
            try:
                data = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError):
                data = None
            if slot == "qc":
                qc = data
            else:
                ledger = data
    bench: List[dict] = []
    for path in sorted(run_dir.glob("BENCH*.json")) + \
            sorted(run_dir.glob("bench*.json")):
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(data, dict):
            bench.append({"file": path.name, **data})
    lint = None
    lint_path = run_dir / LINT_REPORT_JSON
    if lint_path.is_file():
        try:
            data = json.loads(lint_path.read_text())
        except (OSError, json.JSONDecodeError):
            data = None
        if isinstance(data, dict):
            lint = data
    timeseries = None
    ts_entries = read_timeseries(run_dir / TIMESERIES_JSONL)
    if ts_entries:
        timeseries = summarize_timeseries(ts_entries)
        # the SLO verdict rides the last sampled tick that carried one
        # (the serve sampler attaches its rolling-window report per tick)
        slo = next((e["slo"] for e in reversed(ts_entries)
                    if isinstance(e.get("slo"), dict)), None)
        if slo is not None:
            timeseries["slo"] = slo
    if trace is None and metrics is None and manifest is None \
            and qc is None and ledger is None and not bench \
            and timeseries is None and lint is None:
        return None
    report: dict = {"dir": str(run_dir)}
    if trace is not None:
        tree = span_tree(trace["spans"])
        total = round(sum(n["seconds"] for n in tree), 6)
        report["trace"] = {
            "run": trace["run"], "finish": trace["finish"],
            "span_count": len(trace["spans"]),
            "tree": tree, "tree_total_s": total,
        }
        wall = (trace["finish"] or {}).get("wall")
        if isinstance(wall, (int, float)) and wall > 0:
            report["trace"]["wall_s"] = wall
            report["trace"]["wall_agreement"] = round(total / wall, 4)
    if metrics is not None:
        report["metrics"] = metrics
    if manifest is not None:
        report["manifest"] = manifest
    if qc is not None:
        report["qc"] = qc
    if ledger is not None:
        report["ledger"] = ledger
    if bench:
        report["bench"] = bench
    if timeseries is not None:
        report["timeseries"] = timeseries
    if lint is not None:
        report["lint"] = lint
    return report


def _telemetry_lines(ts: dict, lines: List[str]) -> None:
    """The continuous-telemetry section: series shape, host envelope,
    latency quantiles and the SLO verdict. Every field optional — a
    foreign or truncated series renders partially, never raises."""
    if not isinstance(ts, dict):
        return
    head = f"  {ts.get('ticks', '?')} sampler ticks"
    span = ts.get("span_s")
    if isinstance(span, (int, float)) and span > 0:
        head += f" over {_fmt_s(span)}"
    lines.append(head)
    host = ts.get("host") or {}
    rss = host.get("rss_bytes")
    if isinstance(rss, dict):
        lines.append(f"  RSS: min {_fmt_bytes(rss.get('min', 0))} · "
                     f"median {_fmt_bytes(rss.get('median', 0))} · "
                     f"max {_fmt_bytes(rss.get('max', 0))}")
    busy = host.get("cpu_busy_frac")
    if isinstance(busy, dict):
        lines.append(f"  host CPU busy: min {busy.get('min', 0) * 100:.0f}%"
                     f" · median {busy.get('median', 0) * 100:.0f}%"
                     f" · max {busy.get('max', 0) * 100:.0f}%")
    for key, stats in sorted((ts.get("gauges") or {}).items()):
        if key.startswith("autocycler_serve_queue_depth") \
                and isinstance(stats, dict):
            lines.append(f"  queue depth: median "
                         f"{stats.get('median', 0):g} · max "
                         f"{stats.get('max', 0):g}")
    for key, h in sorted((ts.get("hists") or {}).items()):
        if key.startswith("autocycler_serve_job_seconds") \
                and isinstance(h, dict) and h.get("p50") is not None:
            line = f"  job latency ({key}): p50 {_fmt_s(h['p50'])}"
            if h.get("p95") is not None:
                line += f" · p95 {_fmt_s(h['p95'])}"
            lines.append(line)
    slo = ts.get("slo")
    if isinstance(slo, dict):
        obj = slo.get("objectives") or {}
        if any(v is not None for v in obj.values()):
            verdict = "VIOLATED" if slo.get("violated") else "met"
            bits = [f"{k.replace('_s', '')} <= {v:g}s"
                    for k, v in sorted(obj.items()) if v is not None]
            line = f"  SLO ({', '.join(bits)}): {verdict}"
            burn = slo.get("burn_rate")
            if isinstance(burn, (int, float)):
                line += f", burn rate {burn:g}"
            lines.append(line)
        elif slo.get("p50_s") is not None:
            lines.append(f"  SLO: no objective set (window p50 "
                         f"{_fmt_s(slo['p50_s'])}, p95 "
                         f"{_fmt_s(slo.get('p95_s', slo['p50_s']))})")


def render_report(report: dict) -> str:
    lines: List[str] = []
    run_dir = report.get("dir", "")
    lines.append(f"Autocycler run report — {run_dir}")
    trace = report.get("trace")
    if trace:
        header = trace.get("run") or {}
        name = header.get("name", "?")
        argv = header.get("argv")
        lines.append(f"Command: {name}" +
                     (f"  ({' '.join(argv)})" if argv else ""))
        wall = trace.get("wall_s")
        total = trace.get("tree_total_s", 0.0)
        summary = (f"Spans: {trace.get('span_count', 0)}"
                   f"  stage-tree total {_fmt_s(total)}")
        if wall:
            summary += f"  wall {_fmt_s(wall)}"
            agreement = trace.get("wall_agreement", 0.0)
            if abs(agreement - 1.0) > WALL_AGREEMENT:
                summary += (f"  [WARNING: tree covers {agreement * 100:.1f}%"
                            " of wall — spans missing or double-counted]")
        lines.append(summary)
        lines.append("")
        lines.append("Stage tree:")
        _render_tree(trace.get("tree", []), lines,
                     parent_seconds=wall or total)
        finish = trace.get("finish") or {}
        mem = finish.get("mem") or {}
        if mem.get("peak_rss_bytes"):
            lines.append(f"  peak RSS at finish: "
                         f"{_fmt_bytes(mem['peak_rss_bytes'])}")
        lines.append("")
    metrics = report.get("metrics")
    if metrics:
        dev_s = _metric_total(metrics, "autocycler_device_seconds_total")
        dispatches = _metric_total(metrics,
                                   "autocycler_device_dispatches_total")
        failures = _metric_total(metrics, "autocycler_device_failures_total")
        wall = (trace or {}).get("wall_s")
        split = (f"Device vs host: {_fmt_s(dev_s)} on device across "
                 f"{int(dispatches)} dispatch"
                 f"{'es' if dispatches != 1 else ''}")
        if wall:
            split += f" ({100.0 * dev_s / wall:.1f}% of wall)"
        split += f"; {int(failures)} failure{'s' if failures != 1 else ''}"
        lines.append(split)
        for v in _metric_values(metrics, "autocycler_device_failure_last"):
            if v.get("value"):
                lines.append(f"  last device failure: {v['value']}")
        cache = _metric_by_label(metrics, "autocycler_cache_events_total",
                                 "cache")
        if cache:
            bits = []
            for which in sorted(cache):
                hits = misses = 0
                for v in _metric_values(metrics,
                                        "autocycler_cache_events_total"):
                    labels = v.get("labels", {})
                    if labels.get("cache") == which:
                        if labels.get("event") == "hit":
                            hits = int(v.get("value", 0))
                        elif labels.get("event") == "miss":
                            misses = int(v.get("value", 0))
                bits.append(f"{which} {hits} hit{'s' if hits != 1 else ''}"
                            f" / {misses} miss"
                            f"{'es' if misses != 1 else ''}")
            lines.append("Caches: " + " · ".join(bits))
        degrades = _metric_by_label(metrics, "autocycler_degrades_total",
                                    "chain")
        if degrades:
            lines.append("Degradations: " + ", ".join(
                f"{chain} x{int(n)}" for chain, n in sorted(degrades.items())))
        else:
            lines.append("Degradations: none recorded")
        faults = _metric_by_label(metrics, "autocycler_fault_injections_total",
                                  "site")
        if faults:
            lines.append("Fault injections: " + ", ".join(
                f"{site} x{int(n)}" for site, n in sorted(faults.items())))
        retries = _metric_by_label(
            metrics, "autocycler_subprocess_retries_total", "command")
        if retries:
            lines.append("Subprocess retries: " + ", ".join(
                f"{cmd} x{int(n)}" for cmd, n in sorted(retries.items())))
        pool = _metric_total(metrics, "autocycler_pool_tasks_total")
        if pool:
            lines.append(f"Pool tasks: {int(pool)}")
        lines.append("")
    manifest = report.get("manifest")
    if manifest:
        items = manifest.get("items", {})
        counts: Dict[str, int] = {}
        for entry in items.values():
            counts[entry.get("status", "?")] = \
                counts.get(entry.get("status", "?"), 0) + 1
        summary = ", ".join(f"{n} {status}"
                            for status, n in sorted(counts.items()))
        lines.append(f"Isolates ({len(items)}): {summary}")
        for name in sorted(items):
            entry = items[name]
            if entry.get("status") == "failed":
                stage = entry.get("stage") or "?"
                lines.append(f"  FAILED {name} (stage {stage}): "
                             f"{entry.get('error')}")
        lines.append("")
    timeseries = report.get("timeseries")
    if timeseries:
        lines.append("Continuous telemetry:")
        _telemetry_lines(timeseries, lines)
        lines.append("")
    qc = report.get("qc")
    if qc:
        lines.append("Assembly QC:")
        _render_qc_lines(qc, lines)
        lines.append("")
    ledger = report.get("ledger")
    if ledger:
        lines.append("Provenance:")
        _render_ledger_lines(ledger, lines)
        lines.append("")
    lint = report.get("lint")
    if lint:
        lines.append("Static analysis:")
        _render_lint_lines(lint, lines)
        lines.append("")
    for artifact in report.get("bench", []):
        if "metric" in artifact:
            line = (f"Bench {artifact['file']}: {artifact['metric']} = "
                    f"{artifact.get('value')} {artifact.get('unit', '')}")
            if artifact.get("vs_baseline"):
                line += f" (vs_baseline {artifact['vs_baseline']})"
            lines.append(line.rstrip())
        elif "bench" in artifact:
            lines.append(f"Bench {artifact['file']}: {artifact['bench']} "
                         f"passed={artifact.get('passed')}")
    return "\n".join(lines).rstrip() + "\n"


def _render_qc_lines(qc: dict, lines: List[str]) -> None:
    """Readable per-stage QC from a qc_report.json payload; tolerates
    partial/foreign payloads (every field is optional)."""
    for entry in qc.get("entries", []) if isinstance(qc, dict) else []:
        if not isinstance(entry, dict):
            continue
        stage = entry.get("stage", "?")
        metrics = entry.get("metrics") or {}
        prefix = "  "
        if entry.get("isolate"):
            prefix += f"[{entry['isolate']}] "
        if stage == "compress":
            lines.append(
                f"{prefix}compress: {metrics.get('unitigs', '?')} unitigs, "
                f"{metrics.get('total_bp', '?')} bp, "
                f"N50 {metrics.get('n50_bp', '?')} "
                f"(from {metrics.get('input_contigs', '?')} contigs / "
                f"{metrics.get('input_bp', '?')} bp)")
            hist = metrics.get("depth_hist_bp")
            if isinstance(hist, dict) and hist:
                lines.append(f"{prefix}  depth histogram (bp): " + ", ".join(
                    f"{k}: {v}" for k, v in hist.items()))
        elif stage == "cluster":
            lines.append(
                f"{prefix}cluster: {metrics.get('clusters_pass', '?')} pass /"
                f" {metrics.get('clusters_fail', '?')} fail "
                f"(size balance {metrics.get('size_balance_ratio', '?')})")
            for c in metrics.get("clusters") or []:
                if not isinstance(c, dict):
                    continue
                verdict = "PASS" if c.get("passed") else "FAIL"
                line = (f"{prefix}  cluster {c.get('cluster', '?'):>3}: "
                        f"{verdict}  {c.get('contigs', '?')} contigs "
                        f"{c.get('total_bp', '?')} bp "
                        f"dist {c.get('distance', '?')}")
                reasons = c.get("failure_reasons") or []
                if reasons:
                    line += f"  [{', '.join(str(r) for r in reasons)}]"
                lines.append(line)
        elif stage == "trim":
            lines.append(
                f"{prefix}trim {entry.get('cluster', '?')}: "
                f"{metrics.get('trimmed_contigs', '?')}/"
                f"{metrics.get('contigs', '?')} contigs trimmed, "
                f"{metrics.get('trimmed_bp', '?')} bp removed "
                f"({metrics.get('trim_type', '?')}; "
                f"{metrics.get('excluded_contigs', '?')} excluded)")
        elif stage == "resolve":
            lines.append(
                f"{prefix}resolve {entry.get('cluster', '?')}: "
                f"{metrics.get('anchors', '?')} anchors, "
                f"{metrics.get('bridges', '?')} bridges "
                f"({metrics.get('unique_bridges', '?')} unique / "
                f"{metrics.get('conflicting_bridges', '?')} conflicting, "
                f"{metrics.get('culled_bridges', '?')} culled), "
                f"min support {metrics.get('min_bridge_support', '?')}")
        elif stage == "combine":
            resolved = metrics.get("fully_resolved")
            lines.append(
                f"{prefix}combine: {metrics.get('clusters', '?')} clusters "
                f"-> {metrics.get('consensus_bp', '?')} bp consensus in "
                f"{metrics.get('consensus_unitigs', '?')} unitigs"
                + (", fully resolved" if resolved else
                   ", NOT fully resolved" if resolved is not None else ""))
        else:
            scalars = {k: v for k, v in metrics.items()
                       if isinstance(v, (int, float, bool, str))}
            lines.append(f"{prefix}{stage}: " + ", ".join(
                f"{k}={v}" for k, v in sorted(scalars.items())) if scalars
                else f"{prefix}{stage}")


def _render_lint_lines(lint: dict, lines: List[str]) -> None:
    """The static-analysis section from a lint_report.json artifact
    (written by `autocycler lint --report`); every field optional."""
    if not isinstance(lint, dict):
        return
    findings = lint.get("findings")
    findings = findings if isinstance(findings, list) else []
    verdict = "clean" if not findings else f"{len(findings)} finding(s)"
    bits = [verdict]
    files = lint.get("files")
    if files is not None:
        bits.append(f"{files} files")
    wall = lint.get("wall_s")
    if isinstance(wall, (int, float)):
        bits.append(f"{wall:.2f}s")
    baselined = lint.get("baselined")
    if baselined:
        bits.append(f"{baselined} baselined")
    lines.append("  lint: " + ", ".join(bits))
    for f in findings[:20]:
        if isinstance(f, dict):
            lines.append(f"    {f.get('path')}:{f.get('line')} "
                         f"[{f.get('rule')}] {f.get('message')}")
    if len(findings) > 20:
        lines.append(f"    ... and {len(findings) - 20} more")


def _render_ledger_lines(ledger: dict, lines: List[str]) -> None:
    if not isinstance(ledger, dict):
        return
    inputs = ledger.get("inputs") or {}
    if inputs:
        total = sum(v.get("bytes", 0) for v in inputs.values()
                    if isinstance(v, dict))
        lines.append(f"  inputs: {len(inputs)} file"
                     f"{'s' if len(inputs) != 1 else ''} hashed "
                     f"({_fmt_bytes(total)})")
    versions = ledger.get("versions") or {}
    if versions:
        bits = [f"autocycler_tpu_torch "
                f"{versions.get('autocycler_tpu_torch', '?')}",
                f"python {versions.get('python', '?')}"]
        if versions.get("cuda"):
            bits.append(f"cuda {versions['cuda']}")
        for pkg, ver in sorted((versions.get("packages") or {}).items()):
            bits.append(f"{pkg} {ver}")
        lines.append("  versions: " + " · ".join(bits))
    caches = ledger.get("caches") or {}
    if caches:
        bits = []
        for which in ("parse", "repair"):
            c = caches.get(which)
            if isinstance(c, dict):
                bits.append(f"{which} {c.get('hits', 0)} hit/"
                            f"{c.get('misses', 0)} miss")
        compile_c = caches.get("compile") or {}
        bits.append("compile " +
                    ("on" if compile_c.get("enabled") else "off"))
        probe = caches.get("probe")
        if isinstance(probe, dict):
            bits.append(f"probe recoveries {probe.get('recoveries', 0)}")
        lines.append("  caches: " + " · ".join(bits))
    stages = ledger.get("stages") or []
    if stages:
        bits = []
        for s in stages:
            if not isinstance(s, dict):
                continue
            label = s.get("stage", "?")
            if s.get("cluster"):
                label += f"/{s['cluster']}"
            if s.get("isolate"):
                label = f"{s['isolate']}:{label}"
            bits.append(f"{label} ({len(s.get('inputs') or {})} in -> "
                        f"{len(s.get('outputs') or {})} out)")
        lines.append("  stages: " + ", ".join(bits))


def _esc(value) -> str:
    return _html.escape(str(value))


def _html_kv_table(rows, headers) -> List[str]:
    out = ["<table>", "<tr>" + "".join(f"<th>{_esc(h)}</th>"
                                       for h in headers) + "</tr>"]
    for row in rows:
        out.append("<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in row)
                   + "</tr>")
    out.append("</table>")
    return out


def render_html(report: dict) -> str:
    """One self-contained HTML document (inline CSS, no external assets)
    from the merged report structure — openable from a laptop that only
    scp'd the run directory home."""
    title = f"Autocycler run report — {report.get('dir', '')}"
    parts: List[str] = [
        "<!DOCTYPE html>",
        "<html lang=\"en\"><head><meta charset=\"utf-8\">",
        f"<title>{_esc(title)}</title>",
        "<style>",
        "body{font-family:system-ui,sans-serif;margin:2em auto;"
        "max-width:70em;padding:0 1em;color:#1a1a2e;}",
        "h1{font-size:1.4em;border-bottom:2px solid #4a4e69;}",
        "h2{font-size:1.1em;margin-top:1.6em;color:#4a4e69;}",
        "pre{background:#f4f4f8;padding:0.8em;overflow-x:auto;"
        "border-radius:4px;font-size:0.85em;}",
        "table{border-collapse:collapse;margin:0.5em 0;font-size:0.9em;}",
        "th,td{border:1px solid #c9c9d4;padding:0.25em 0.6em;"
        "text-align:left;}",
        "th{background:#e9e9f0;}",
        ".pass{color:#1b7a3d;font-weight:600;}",
        ".fail{color:#b3261e;font-weight:600;}",
        ".warn{color:#8a5a00;font-weight:600;}",
        "</style></head><body>",
        f"<h1>{_esc(title)}</h1>",
    ]
    trace = report.get("trace")
    if trace:
        header = trace.get("run") or {}
        wall = trace.get("wall_s")
        bits = [f"command <b>{_esc(header.get('name', '?'))}</b>",
                f"{trace.get('span_count', 0)} spans",
                f"stage-tree total {_esc(_fmt_s(trace.get('tree_total_s', 0)))}"]
        if wall:
            bits.append(f"wall {_esc(_fmt_s(wall))}")
            agreement = trace.get("wall_agreement", 0.0)
            if abs(agreement - 1.0) > WALL_AGREEMENT:
                bits.append(f"<span class=\"warn\">tree covers "
                            f"{agreement * 100:.1f}% of wall</span>")
        parts.append("<p>" + " · ".join(bits) + "</p>")
        tree_lines: List[str] = []
        _render_tree(trace.get("tree", []), tree_lines,
                     parent_seconds=wall or trace.get("tree_total_s"))
        parts.append("<h2>Stage tree</h2>")
        parts.append("<pre>" + _esc("\n".join(tree_lines)) + "</pre>")
    qc = report.get("qc")
    if qc:
        parts.append("<h2>Assembly QC</h2>")
        qc_lines: List[str] = []
        _render_qc_lines(qc, qc_lines)
        parts.append("<pre>" + _esc("\n".join(qc_lines)) + "</pre>")
        clusters = []
        for entry in qc.get("entries", []):
            if isinstance(entry, dict) and entry.get("stage") == "cluster":
                clusters = (entry.get("metrics") or {}).get("clusters") or []
        if clusters:
            parts.append("<table><tr><th>cluster</th><th>verdict</th>"
                         "<th>contigs</th><th>bp</th><th>distance</th>"
                         "<th>failure reasons</th></tr>")
            for c in clusters:
                if not isinstance(c, dict):
                    continue
                verdict = ("<span class=\"pass\">PASS</span>"
                           if c.get("passed")
                           else "<span class=\"fail\">FAIL</span>")
                reasons = ", ".join(str(r) for r in
                                    (c.get("failure_reasons") or []))
                parts.append(
                    f"<tr><td>{_esc(c.get('cluster', '?'))}</td>"
                    f"<td>{verdict}</td>"
                    f"<td>{_esc(c.get('contigs', '?'))}</td>"
                    f"<td>{_esc(c.get('total_bp', '?'))}</td>"
                    f"<td>{_esc(c.get('distance', '?'))}</td>"
                    f"<td>{_esc(reasons)}</td></tr>")
            parts.append("</table>")
    ledger = report.get("ledger")
    if ledger:
        parts.append("<h2>Provenance</h2>")
        led_lines: List[str] = []
        _render_ledger_lines(ledger, led_lines)
        parts.append("<pre>" + _esc("\n".join(led_lines)) + "</pre>")
        inputs = ledger.get("inputs") or {}
        if inputs:
            rows = [(path, digest.get("bytes", "?"),
                     digest.get("sha256", "?")[:16] + "…")
                    for path, digest in sorted(inputs.items())
                    if isinstance(digest, dict)]
            parts.append("<h2>Input files</h2>")
            parts.extend(_html_kv_table(rows, ("path", "bytes", "sha256")))
        stage_rows = []
        for s in ledger.get("stages") or []:
            if not isinstance(s, dict):
                continue
            for path, digest in sorted((s.get("outputs") or {}).items()):
                if isinstance(digest, dict):
                    label = s.get("stage", "?")
                    if s.get("cluster"):
                        label += f"/{s['cluster']}"
                    if s.get("isolate"):
                        label = f"{s['isolate']}:{label}"
                    stage_rows.append((label, path, digest.get("bytes", "?"),
                                       digest.get("sha256", "?")[:16] + "…"))
        if stage_rows:
            parts.append("<h2>Stage outputs</h2>")
            parts.extend(_html_kv_table(
                stage_rows, ("stage", "artifact", "bytes", "sha256")))
    timeseries = report.get("timeseries")
    if timeseries:
        parts.append("<h2>Continuous telemetry</h2>")
        ts_lines: List[str] = []
        _telemetry_lines(timeseries, ts_lines)
        parts.append("<pre>" + _esc("\n".join(ts_lines)) + "</pre>")
        slo = timeseries.get("slo")
        if isinstance(slo, dict):
            obj = slo.get("objectives") or {}
            if any(v is not None for v in obj.values()):
                verdict = ("<span class=\"fail\">SLO VIOLATED</span>"
                           if slo.get("violated")
                           else "<span class=\"pass\">SLO met</span>")
                parts.append(f"<p>{verdict}</p>")
    lint = report.get("lint")
    if lint:
        parts.append("<h2>Static analysis</h2>")
        findings = lint.get("findings")
        findings = findings if isinstance(findings, list) else []
        verdict = ("<span class=\"pass\">clean</span>" if not findings
                   else f"<span class=\"fail\">{len(findings)} "
                        "finding(s)</span>")
        lint_lines: List[str] = []
        _render_lint_lines(lint, lint_lines)
        parts.append(f"<p>lint: {verdict}</p>")
        parts.append("<pre>" + _esc("\n".join(lint_lines)) + "</pre>")
        if findings:
            rows = [(f.get("rule", "?"), f.get("path", "?"),
                     f.get("line", "?"), f.get("message", "?"))
                    for f in findings if isinstance(f, dict)]
            parts.extend(_html_kv_table(
                rows, ("rule", "path", "line", "message")))
    metrics = report.get("metrics")
    if metrics:
        dev_s = _metric_total(metrics, "autocycler_device_seconds_total")
        dispatches = _metric_total(metrics,
                                   "autocycler_device_dispatches_total")
        failures = _metric_total(metrics, "autocycler_device_failures_total")
        parts.append("<h2>Device</h2>")
        parts.append(f"<p>{_esc(_fmt_s(dev_s))} on device across "
                     f"{int(dispatches)} dispatches; {int(failures)} "
                     f"failures</p>")
    manifest = report.get("manifest")
    if manifest:
        items = manifest.get("items", {})
        rows = [(name, entry.get("status", "?"), entry.get("stage") or "",
                 entry.get("error") or "")
                for name, entry in sorted(items.items())]
        parts.append(f"<h2>Isolates ({len(items)})</h2>")
        parts.extend(_html_kv_table(
            rows, ("isolate", "status", "stage", "error")))
    parts.append("</body></html>")
    return "\n".join(parts) + "\n"


def find_correlated_traces(root, trace_id: str) -> List[dict]:
    """Every trace under ``root`` carrying ``trace_id``: the run header's
    ``trace_id`` (daemon-side jobs) or any span whose ``trace`` attr
    matches (fleet shards, legacy runs). Searches the root itself, its
    ``jobs/*`` run dirs, and one replica level down (``<replica>/jobs/*``)
    — the fleet-dir layout. Returns [{"path", "rel", "trace"}] sorted by
    run start time."""
    root = Path(root)
    candidates: List[Path] = []
    for pattern in (TRACE_JSONL, f"jobs/*/{TRACE_JSONL}",
                    f"*/{TRACE_JSONL}", f"*/jobs/*/{TRACE_JSONL}"):
        candidates.extend(root.glob(pattern))
    matched: List[dict] = []
    seen = set()
    for path in candidates:
        resolved = path.resolve()
        if resolved in seen:
            continue
        seen.add(resolved)
        loaded = load_trace(path)
        if loaded is None:
            continue
        run = loaded.get("run") or {}
        hit = run.get("trace_id") == trace_id or any(
            (s.get("attrs") or {}).get("trace") == trace_id
            for s in loaded["spans"])
        if not hit:
            continue
        try:
            rel = str(path.parent.relative_to(root)) or "."
        except ValueError:
            rel = str(path.parent)
        matched.append({"path": path, "rel": rel, "trace": loaded})
    matched.sort(key=lambda m: (m["trace"]["run"].get("t0_epoch") or 0.0,
                                m["rel"]))
    return matched


def write_correlated_trace(root, trace_id: str,
                           out_path=None) -> Optional[Path]:
    """Merge every trace under ``root`` matching ``trace_id`` into ONE
    Chrome trace: one process lane per matched run (labelled by its run
    dir relative to ``root``), events aligned on a shared wall clock via
    each run header's ``t0_epoch`` — so the client's submit, each
    replica's job and its fleet shards render on one timeline. Returns the
    output path, or None when nothing matched."""
    root = Path(root)
    matched = find_correlated_traces(root, trace_id)
    if not matched:
        return None
    t0 = min(m["trace"]["run"].get("t0_epoch") or 0.0 for m in matched)
    events: List[dict] = []
    for pid, m in enumerate(matched, start=1):
        run = m["trace"]["run"]
        label = m["rel"] if m["rel"] != "." else (run.get("name") or "run")
        offset_s = (run.get("t0_epoch") or t0) - t0
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        for s in m["trace"]["spans"]:
            events.append({
                "name": s.get("name", "?"), "cat": s.get("cat", "span"),
                "ph": "X",
                "ts": round((offset_s + (s.get("ts") or 0.0)) * 1e6, 3),
                "dur": round((s.get("dur") or 0.0) * 1e6, 3),
                "pid": pid, "tid": s.get("tid", 0),
                "args": dict(s.get("attrs", {}),
                             **({"mem": s["mem"]} if "mem" in s else {})),
            })
    out = Path(out_path) if out_path \
        else root / f"trace_correlated_{trace_id}.chrome.json"
    out.write_text(json.dumps({"traceEvents": events,
                               "displayTimeUnit": "ms"}))
    return out


def correlate_report(root, trace_id: str) -> int:
    """CLI body of `autocycler report --correlate <id>`."""
    matched = find_correlated_traces(root, trace_id)
    if not matched:
        print(f"Error: no trace under {root} carries correlation id "
              f"{trace_id!r} (looked in {TRACE_JSONL}, jobs/*/, */jobs/*/)",
              file=sys.stderr)
        return 1
    try:
        out = write_correlated_trace(root, trace_id)
    except OSError as e:
        print(f"Error: could not write merged trace: {e}", file=sys.stderr)
        return 1
    print(f"correlation {trace_id}: {len(matched)} trace(s)")
    for m in matched:
        run = m["trace"]["run"]
        spans = m["trace"]["spans"]
        t0_epoch = run.get("t0_epoch")
        started = time.strftime("%H:%M:%S", time.localtime(t0_epoch)) \
            if isinstance(t0_epoch, (int, float)) else "?"
        print(f"  {m['rel']:40s} {run.get('name', '?'):20s} "
              f"{len(spans):5d} spans  started {started}")
    print(f"merged Chrome trace: {out}")
    return 0


def report(run_dir, as_json: bool = False,
           html: Optional[str] = None,
           correlate: Optional[str] = None) -> int:
    """CLI entry point for `autocycler report`. ``html`` of "" writes
    ``run_report.html`` into the run dir; a non-empty value is the output
    path; None skips HTML. ``correlate`` switches to cross-run mode:
    merge every trace under ``run_dir`` carrying that correlation id into
    one Chrome trace with one process lane per replica/shard."""
    if correlate:
        return correlate_report(run_dir, correlate)
    built = build_report(run_dir)
    if built is None:
        print(f"Error: no telemetry found in {run_dir} (expected "
              f"{TRACE_JSONL}, {METRICS_JSON}, {QC_REPORT_JSON}, "
              f"{LEDGER_JSON}, {TIMESERIES_JSONL}, {LINT_REPORT_JSON}, "
              "batch_manifest.json or BENCH*.json)", file=sys.stderr)
        return 1
    if html is not None:
        out = Path(html) if html else Path(run_dir) / RUN_REPORT_HTML
        try:
            out.write_text(render_html(built))
            print(f"wrote {out}", file=sys.stderr)
        except OSError as e:
            print(f"Error: could not write {out}: {e}", file=sys.stderr)
            return 1
    if as_json:
        print(json.dumps(built, indent=2, sort_keys=True))
    else:
        print(render_report(built))
    return 0
