"""`autocycler watch <dir>`: follow a run's trace cross-process, as the
JAX package's obs/watch.py renders it, with the async-probe line from
the run dir's ``probe_log.jsonl`` (obs/sentinel.py).

The span tracer streams ``trace.jsonl`` one record per *closed* span, so a
separate process can tail the file and render the run as it happens —
what a long `batch` run or a `serve` daemon's job needs: "which isolate is
it on, what has passed QC so far, how much landed on device?" without
attaching to the worker process.

Two modes:

- ``--once`` (the default): parse whatever the trace holds right now,
  render one frame, exit;
- ``--follow``: poll the file (default every 2 s), re-render whenever new
  spans land, and exit when the run's ``finish`` footer arrives. The run
  dir (or its ``trace.jsonl``) not existing *yet* is not an error in this
  mode: `autocycler submit --follow` starts watching a job's run dir
  before the daemon has admitted the job, so the follower announces it is
  waiting and keeps polling until the tracer creates the file.

The follower is torn-line safe (it only consumes up to the last newline,
exactly the boundary the tracer writes atomically under its lock) and
restarts cleanly when the file is replaced by a new run (the tracer opens
``trace.jsonl`` with ``"w"``, so a shrink or a fresh run header means
"start over").
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import report as obs_report
from .qc import QC_REPORT_JSON
from .trace import TRACE_JSONL


class TraceFollower:
    """Incremental reader of one ``trace.jsonl``: each :meth:`poll` returns
    the records appended since the last poll, never a torn line."""

    def __init__(self, path):
        self.path = Path(path)
        self._pos = 0
        self._carry = b""

    def poll(self) -> List[dict]:
        try:
            size = self.path.stat().st_size
        except OSError:
            return []
        if size < self._pos:        # file replaced by a new run — restart
            self._pos = 0
            self._carry = b""
        if size == self._pos:
            return []
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                chunk = f.read()
        except OSError:
            return []
        self._pos += len(chunk)
        data = self._carry + chunk
        cut = data.rfind(b"\n")
        if cut < 0:                 # only a partial line so far — keep it
            self._carry = data
            return []
        self._carry = data[cut + 1:]
        records = []
        for line in data[:cut].split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
        return records


def _load_qc(run_dir: Path) -> Optional[dict]:
    path = run_dir / QC_REPORT_JSON
    if not path.is_file():
        return None
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _qc_from_spans(spans: List[dict]) -> Dict[str, dict]:
    """QC highlights straight from span attributes — available live, while
    ``qc_report.json`` only lands at run end."""
    out: Dict[str, dict] = {}
    for s in spans:
        qc = (s.get("attrs") or {}).get("qc")
        if isinstance(qc, dict):
            for key, metrics in qc.items():
                if isinstance(metrics, dict):
                    out[key] = metrics
    return out


def _fmt_metrics(metrics: dict) -> str:
    bits = []
    for key in sorted(metrics):
        value = metrics[key]
        if isinstance(value, float):
            bits.append(f"{key}={value:g}")
        else:
            bits.append(f"{key}={value}")
    return " ".join(bits)


def _async_probe_line(run_dir: Path) -> Optional[str]:
    """The run's async-probe state, reconstructed from its
    ``probe_log.jsonl`` (the watcher cannot see the worker's in-memory
    probe). None when no probe outcome is logged yet: rendered as
    pending by the caller."""
    from . import sentinel
    entries = sentinel.read_probe_log(Path(run_dir) / sentinel.PROBE_LOG,
                                      limit=50)
    last = next((e for e in reversed(entries)
                 if "attached" in e and "type" not in e), None)
    if last is None:
        return None
    state = "attached" if last.get("attached") else "failed"
    line = (f"Async probe: {state} kind={last.get('kind')} "
            f"after {last.get('seconds')}s [{last.get('source')}]")
    retries = sum(1 for e in entries
                  if e.get("source") == "background-retry")
    if retries:
        line += f" ({retries} retr{'ies' if retries != 1 else 'y'} "
        line += "before the final outcome)"
    return line


def render_frame(run_dir, records: List[dict]) -> str:
    """One full text frame from the records parsed so far: run state, the
    stage/isolate tree, the device/host split and QC highlights."""
    run_dir = Path(run_dir)
    run = next((r for r in records if r.get("type") == "run"), None)
    finish = next((r for r in records if r.get("type") == "finish"), None)
    spans = [r for r in records if r.get("type") == "span"]
    lines: List[str] = []

    name = (run or {}).get("name", "?")
    if finish:
        state = f"finished (wall {obs_report._fmt_s(finish.get('wall', 0))})"
    elif run:
        elapsed = max(0.0, time.time() - run.get("t0_epoch", time.time()))
        state = f"running {obs_report._fmt_s(elapsed)}"
    else:
        state = "waiting for run header"
    lines.append(f"Watching {run_dir} — {name} [{state}]  "
                 f"{len(spans)} span{'s' if len(spans) != 1 else ''}")

    if spans:
        lines.append("")
        lines.append("Stage tree (closed spans so far):")
        tree = obs_report.span_tree(spans)
        total = sum(n["seconds"] for n in tree)
        obs_report._render_tree(tree, lines, parent_seconds=total or None)

        device_s = sum(s.get("dur", 0.0) for s in spans
                       if s.get("cat") == "device")
        device_n = sum(s.get("cat") == "device" for s in spans)
        wall = finish.get("wall") if finish else None
        split = (f"Device vs host: {obs_report._fmt_s(device_s)} across "
                 f"{device_n} dispatch{'es' if device_n != 1 else ''}")
        if isinstance(wall, (int, float)) and wall > 0:
            split += f" ({100.0 * device_s / wall:.1f}% of wall)"
        lines.append("")
        lines.append(split)
        wait_s = sum(s.get("dur", 0.0) for s in spans
                     if s.get("cat") == "device_wait")
        if wait_s:
            lines.append(f"Blocked on probe future: "
                         f"{obs_report._fmt_s(wait_s)} "
                         "(device wait, excluded from device time)")

    probe_line = _async_probe_line(run_dir)
    if probe_line:
        lines.append("")
        lines.append(probe_line)
    elif not finish and run:
        lines.append("")
        lines.append("Async probe: pending (no outcome logged yet)")

    if spans:
        isolates: Dict[str, dict] = {}
        for s in spans:
            if s.get("cat") != "isolate":
                continue
            iso = isolates.setdefault(s["name"], {"seconds": 0.0,
                                                  "stages": []})
            iso["seconds"] += s.get("dur", 0.0)
            stage = (s.get("attrs") or {}).get("stage")
            if stage and stage not in iso["stages"]:
                iso["stages"].append(stage)
        if isolates:
            lines.append("")
            lines.append(f"Isolates ({len(isolates)}):")
            for name in sorted(isolates):
                iso = isolates[name]
                stages = " -> ".join(iso["stages"]) or "?"
                lines.append(f"  {name:<30} {stages}  "
                             f"({obs_report._fmt_s(iso['seconds'])})")

    qc_report = _load_qc(run_dir)
    highlights = _qc_from_spans(spans)
    if qc_report:
        for entry in qc_report.get("entries", []):
            key = entry.get("stage", "?")
            if entry.get("cluster"):
                key = f"{key}/{entry['cluster']}"
            if entry.get("isolate"):
                key = f"{entry['isolate']}:{key}"
            scalars = {k: v for k, v in (entry.get("metrics") or {}).items()
                       if isinstance(v, (int, float, bool))}
            if scalars:
                highlights[key] = scalars
    if highlights:
        lines.append("")
        lines.append("QC:")
        for key in sorted(highlights):
            lines.append(f"  {key:<24} {_fmt_metrics(highlights[key])}")
    return "\n".join(lines).rstrip() + "\n"


def watch(run_dir, follow: bool = False, interval: float = 2.0,
          cycles: Optional[int] = None) -> int:
    """CLI entry for `autocycler watch`. ``--once`` renders the current
    state and exits (1 when there is no trace at all); ``--follow`` keeps
    polling (bounded by ``cycles`` when given) until the run finishes."""
    run_dir = Path(run_dir)
    trace_path = run_dir / TRACE_JSONL
    if not follow:
        if not trace_path.is_file():
            print(f"Error: no {TRACE_JSONL} in {run_dir} — nothing to watch",
                  file=sys.stderr)
            return 1
        follower = TraceFollower(trace_path)
        print(render_frame(run_dir, follower.poll()), end="")
        return 0

    follower = TraceFollower(trace_path)
    records: List[dict] = []
    polled = 0
    announced_wait = False
    try:
        while True:
            if not records and not trace_path.is_file():
                # run dir not created yet (e.g. the job is still queued in a
                # serve daemon) — wait for the tracer, don't error out
                if not announced_wait:
                    print(f"Waiting for {trace_path} to appear "
                          "(run not started yet)...", flush=True)
                    announced_wait = True
                polled += 1
                if cycles is not None and polled >= cycles:
                    return 0
                time.sleep(max(0.1, interval))
                continue
            new = follower.poll()
            if new:
                # a fresh run header means the file was rewritten — drop
                # the previous run's records
                for i, rec in enumerate(new):
                    if rec.get("type") == "run" and records:
                        records = []
                        new = new[i:]
                        break
                records.extend(new)
                stamp = time.strftime("%H:%M:%S")
                print(f"--- {stamp} ---")
                print(render_frame(run_dir, records), end="", flush=True)
                if any(r.get("type") == "finish" for r in new):
                    return 0
            polled += 1
            if cycles is not None and polled >= cycles:
                return 0
            time.sleep(max(0.1, interval))
    except KeyboardInterrupt:
        return 0
