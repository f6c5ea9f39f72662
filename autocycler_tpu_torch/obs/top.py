"""``top <dir>``: a live dashboard over a serve root (or any run directory
with a time series), as the JAX package's obs/top.py has it.

``watch`` follows one run's span stream; ``top`` is the daemon's view: it
reads the discovery file (``serve.json``), the job manifest
(``serve_manifest.json``) and the time series (``timeseries.jsonl``,
written by :mod:`obs.timeseries`) into one frame: queue depth and
throughput sparklines, latency quantiles against the SLO, cache hit
rates, the device/host split (``autocycler_device_seconds_total``, the
CUDA-event seconds of the daemon's launches and dispatches), the stream's
spill and memory. Everything is read from files, so it works across
processes against a live daemon, a finished run or a copied directory,
with no HTTP endpoint. ``--fleet`` is the federated view
(:func:`render_fleet_frame`): the directory is a fleet dir of replica
serve roots, and each frame polls every replica through
:class:`obs.federate.FleetScraper`.

Modes follow ``watch``: ``--once`` (the default) renders one frame and
exits; ``--follow`` re-renders every ``--interval`` seconds (bounded by
``--cycles`` when given).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import report as obs_report
from .timeseries import (TIMESERIES_JSONL, read_timeseries,
                         summarize_timeseries)

SPARK_BLOCKS = "▁▂▃▄▅▆▇█"
SPARK_WIDTH = 32


def sparkline(values: List[float], width: int = SPARK_WIDTH) -> str:
    """Unicode block sparkline of the series tail (newest right). A flat
    series renders as a flat low line, not noise."""
    vals = [v for v in values if isinstance(v, (int, float))][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return SPARK_BLOCKS[0] * len(vals)
    span = hi - lo
    return "".join(
        SPARK_BLOCKS[min(len(SPARK_BLOCKS) - 1,
                         int((v - lo) / span * len(SPARK_BLOCKS)))]
        for v in vals)


def _load_json(path: Path) -> Optional[dict]:
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def _gauge_series(entries: List[dict], name: str) -> List[float]:
    """Per-tick values of one gauge, summed across label sets."""
    out = []
    for e in entries:
        total = None
        for key, v in (e.get("gauges") or {}).items():
            if key == name or key.startswith(name + "{"):
                if isinstance(v, (int, float)):
                    total = (total or 0.0) + v
        if total is not None:
            out.append(total)
    return out


def _counter_delta_series(entries: List[dict], name: str) -> List[float]:
    """Per-tick deltas of one counter, summed across label sets (absent
    in a tick means no change — rendered 0 so the sparkline stays dense)."""
    out = []
    for e in entries:
        total = 0.0
        for key, v in (e.get("counters") or {}).items():
            if key == name or key.startswith(name + "{"):
                if isinstance(v, (int, float)):
                    total += v
        out.append(total)
    return out


def _cache_rates(entries: List[dict]) -> Dict[str, dict]:
    """Cumulative hit/miss per cache from the delta-encoded counter
    stream."""
    out: Dict[str, dict] = {}
    for e in entries:
        for key, v in (e.get("counters") or {}).items():
            if not key.startswith("autocycler_cache_events_total{") \
                    or not isinstance(v, (int, float)):
                continue
            body = key[key.index("{") + 1:-1]
            labels = dict(part.split("=", 1) for part in body.split(",")
                          if "=" in part)
            which = labels.get("cache")
            event = labels.get("event")
            if which and event in ("hit", "miss"):
                out.setdefault(which, {"hit": 0.0, "miss": 0.0})
                out[which][event] += v
    return out


def _latest(entries: List[dict], key: str) -> Optional[dict]:
    for e in reversed(entries):
        node = e.get(key)
        if isinstance(node, dict):
            return node
    return None


def _load_entries(root: Path) -> List[dict]:
    """The root's own series, or — for a root whose jobs carry their own
    samplers — the per-job series merged in time order."""
    entries = read_timeseries(root / TIMESERIES_JSONL)
    if entries:
        return entries
    merged: List[dict] = []
    for path in sorted(root.glob("jobs/*/" + TIMESERIES_JSONL)):
        merged.extend(read_timeseries(path))
    merged.sort(key=lambda e: e.get("ts") or 0.0)
    return merged


def render_top_frame(root) -> Optional[str]:
    """One dashboard frame from the artifacts under ``root``; None when
    the directory holds neither a time series nor serve artifacts."""
    root = Path(root)
    info = _load_json(root / "serve.json")
    manifest = _load_json(root / "serve_manifest.json")
    if manifest is None:
        # a torn manifest (daemon crashed mid-save) still renders: the
        # resilience reader falls back to the last good .bak state
        from ..utils.resilience import read_manifest
        data = read_manifest(root / "serve_manifest.json")
        manifest = data if data.get("items") else None
    entries = _load_entries(root)
    if not entries and info is None and manifest is None:
        return None
    lines: List[str] = []

    head = f"Autocycler top — {root}"
    if info:
        up = ""
        started = info.get("started_epoch")
        if isinstance(started, (int, float)):
            up = f" up {obs_report._fmt_s(max(0.0, time.time() - started))}"
        head += (f"  [daemon pid {info.get('pid', '?')}{up} @ "
                 f"{info.get('endpoint', '?')}]")
    else:
        head += "  [no live daemon — rendering artifacts]"
    lines.append(head)

    if manifest:
        items = manifest.get("items") or {}
        counts: Dict[str, int] = {}
        for entry in items.values():
            if isinstance(entry, dict):
                status = entry.get("status", "?")
                counts[status] = counts.get(status, 0) + 1
        summary = " · ".join(f"{n} {status}"
                             for status, n in sorted(counts.items()))
        lines.append(f"Jobs:        {len(items)} total  ({summary})"
                     if items else "Jobs:        none yet")

    if entries:
        serve_last = _latest(entries, "serve")
        depth = _gauge_series(entries,
                              "autocycler_serve_queue_depth")
        if serve_last is not None or depth:
            now_depth = (serve_last or {}).get("queue_depth")
            if now_depth is None and depth:
                now_depth = int(depth[-1])
            spark = sparkline(depth)
            line = f"Queue depth  {spark or '-'}"
            if now_depth is not None:
                line += f"  now {int(now_depth)}"
            if depth:
                line += f" (max {int(max(depth))})"
            lines.append(line)

        # worker-pool width and live busy count: the serve block of the
        # latest tick when present, serve.json as the cross-version
        # fallback (older daemons record neither — line is omitted)
        workers = (serve_last or {}).get("workers") \
            or (info or {}).get("workers")
        if workers:
            busy = (serve_last or {}).get("busy_workers")
            wline = f"Workers      {workers}"
            if isinstance(busy, int):
                wline += f"  ({busy} busy)"
            lines.append(wline)

        jobs_deltas = _counter_delta_series(
            entries, "autocycler_serve_jobs_total")
        if any(jobs_deltas):
            total_jobs = sum(jobs_deltas)
            rate = ""
            interval = entries[-1].get("interval_s")
            if isinstance(interval, (int, float)) and interval > 0:
                rate = (f"  {jobs_deltas[-1] * 60.0 / interval:.1f} "
                        "jobs/min (last tick)")
            lines.append(f"Throughput   {sparkline(jobs_deltas)}"
                         f"{rate}  {int(total_jobs)} finished in view")

        slo = _latest(entries, "slo")
        lat = _latency_line(slo, entries)
        if lat:
            lines.append(lat)

        caches = _cache_rates(entries)
        if caches:
            bits = []
            for which in sorted(caches):
                hit, miss = caches[which]["hit"], caches[which]["miss"]
                total = hit + miss
                pct = f" ({100.0 * hit / total:.0f}% hit)" if total else ""
                bits.append(f"{which} {int(hit)}/{int(total)}{pct}")
            lines.append("Caches       " + " · ".join(bits))

        dev_deltas = _counter_delta_series(
            entries, "autocycler_device_seconds_total")
        busy = [v for v in
                (e.get("host", {}).get("cpu_busy_frac") for e in entries)
                if isinstance(v, (int, float))]
        if any(dev_deltas) or busy:
            bits = []
            if any(dev_deltas):
                bits.append(f"device {sparkline(dev_deltas)} "
                            f"{sum(dev_deltas):.2f}s in view")
            if busy:
                bits.append(f"host cpu {sparkline(busy)} "
                            f"now {busy[-1] * 100:.0f}%")
            lines.append("Device/host  " + " · ".join(bits))

        rss = [v for v in
               (e.get("host", {}).get("rss_bytes") for e in entries)
               if isinstance(v, (int, float))]
        if rss:
            lines.append(f"Memory       RSS {sparkline(rss)} now "
                         f"{obs_report._fmt_bytes(rss[-1])} "
                         f"(peak {obs_report._fmt_bytes(max(rss))})")

        spill = _gauge_series(entries, "autocycler_stream_spill_bytes")
        bin_deltas = _counter_delta_series(
            entries, "autocycler_stream_bins_total")
        rle = _gauge_series(entries, "autocycler_stream_rle_ratio")
        if any(spill) or any(bin_deltas):
            bits = [f"disk {sparkline(spill)} now "
                    f"{obs_report._fmt_bytes(spill[-1] if spill else 0)} "
                    f"(peak {obs_report._fmt_bytes(max(spill) if spill else 0)})"]
            if any(bin_deltas):
                bits.append(f"bins +{int(sum(bin_deltas))} in view")
            if any(rle):
                bits.append(f"rle {max(rle):.1f}x")
            lines.append("Spill        " + " · ".join(bits))

        summary = summarize_timeseries(entries) or {}
        span = summary.get("span_s")
        tick_bits = f"{summary.get('ticks', len(entries))} ticks"
        if isinstance(span, (int, float)) and span > 0:
            tick_bits += f" over {obs_report._fmt_s(span)}"
        interval = entries[-1].get("interval_s")
        if isinstance(interval, (int, float)):
            tick_bits += f" (interval {interval:g}s)"
        age = time.time() - (entries[-1].get("ts") or 0.0)
        if isinstance(interval, (int, float)) and age > 3 * interval:
            tick_bits += f"  [STALE: last tick {obs_report._fmt_s(age)} ago]"
        lines.append(f"Sampler      {tick_bits}")
    else:
        lines.append(f"No {TIMESERIES_JSONL} yet — queue/latency trends "
                     "appear once the sampler ticks")

    return "\n".join(lines).rstrip() + "\n"


def _latency_line(slo: Optional[dict], entries: List[dict]) -> Optional[str]:
    """The latency quantiles + SLO verdict line, preferring the daemon's
    windowed SLO block and falling back to histogram estimates from the
    latest tick."""
    p50 = p95 = None
    extra = ""
    if slo:
        p50, p95 = slo.get("p50_s"), slo.get("p95_s")
        qw, ex = slo.get("queue_wait_p50_s"), slo.get("exec_p50_s")
        if qw is not None or ex is not None:
            parts = []
            if qw is not None:
                parts.append(f"queue p50 {obs_report._fmt_s(qw)}")
            if ex is not None:
                parts.append(f"exec p50 {obs_report._fmt_s(ex)}")
            extra = "  (" + " · ".join(parts) + ")"
    if p50 is None:
        for e in reversed(entries):
            for key, h in (e.get("hists") or {}).items():
                if key.startswith("autocycler_serve_job_seconds") \
                        and isinstance(h, dict) and h.get("p50") is not None:
                    p50, p95 = h.get("p50"), h.get("p95")
                    break
            if p50 is not None:
                break
    if p50 is None:
        return None
    line = f"Latency      p50 {obs_report._fmt_s(p50)}"
    if p95 is not None:
        line += f"  p95 {obs_report._fmt_s(p95)}"
    line += extra
    if slo:
        obj = slo.get("objectives") or {}
        if any(v is not None for v in obj.values()):
            verdict = "VIOLATED" if slo.get("violated") else "ok"
            line += f"  SLO {verdict}"
            burn = slo.get("burn_rate")
            if isinstance(burn, (int, float)):
                line += f" (burn {burn:g})"
            if slo.get("shedding"):
                line += "  SHEDDING"
        else:
            line += "  SLO: no objective set"
    return line


def _fleet_snapshot(root: Path) -> Optional[dict]:
    """A fresh fleet snapshot: poll the replicas discovered under ``root``
    (this also refreshes ``fleet_status.json`` and advances the verdict
    engine's persisted hysteresis state); when nothing is discoverable,
    fall back to a previously written ``fleet_status.json``."""
    from .federate import FLEET_STATUS_JSON, FleetScraper, read_fleet_status
    scraper = FleetScraper(fleet_dir=root)
    snap = scraper.poll()
    if snap.get("replicas"):
        return snap
    stale = read_fleet_status(root / FLEET_STATUS_JSON)
    return stale if stale.get("replicas") else None


def render_fleet_frame(root) -> Optional[str]:
    """One `top --fleet` frame: per-replica health lines, the fleet
    rollup, merged latency quantiles and the hysteresis-gated scale
    verdict. None when no replica (live or recorded) is visible."""
    root = Path(root)
    snap = _fleet_snapshot(root)
    if snap is None:
        return None
    summary = snap.get("summary") or {}
    verdict = snap.get("verdict") or {}
    lines: List[str] = []
    lines.append(f"Autocycler fleet — {root}  "
                 f"[{summary.get('replicas', 0)} replica(s): "
                 f"{summary.get('healthy', 0)} healthy, "
                 f"{summary.get('stale', 0)} stale, "
                 f"{summary.get('down', 0)} down]")
    for name in sorted(snap.get("replicas") or {}):
        block = snap["replicas"][name] or {}
        health = block.get("health") or {}
        if block.get("healthy"):
            state = health.get("status", "ok")
        elif health:
            state = "stale"
        else:
            state = "down"
        line = (f"  {name:16s} {state:8s} "
                f"{block.get('endpoint', '?')}")
        if health:
            workers = health.get("workers") or 0
            busy = health.get("busy_workers") or 0
            line += (f"  queue {health.get('queue_depth', 0)}"
                     f"  busy {busy}/{workers}")
            slo = health.get("slo") or {}
            burn = slo.get("burn_rate")
            if isinstance(burn, (int, float)):
                line += f"  burn {burn:g}"
            if health.get("version"):
                line += f"  v{health['version']}"
        elif block.get("error"):
            line += f"  ({block['error']})"
        lines.append(line)
    util = summary.get("utilization")
    rollup = (f"Fleet        queue {summary.get('queue_depth', 0)}"
              f"  busy {summary.get('busy_workers', 0)}"
              f"/{summary.get('workers', 0)}")
    if isinstance(util, (int, float)):
        rollup += f"  util {util * 100:.0f}%"
    burn = summary.get("burn_rate")
    if isinstance(burn, (int, float)):
        rollup += f"  burn {burn:g}"
    jobs = summary.get("jobs") or {}
    if jobs:
        rollup += "  jobs " + " · ".join(
            f"{n} {state}" for state, n in sorted(jobs.items()))
    lines.append(rollup)
    # fleet latency: the merged (bucket-wise summed) job-seconds histogram
    # with the most observations across label sets
    hists = (snap.get("metrics") or {}).get("hists") or {}
    best = None
    for key, h in hists.items():
        if key.startswith("autocycler_serve_job_seconds") \
                and isinstance(h, dict) and h.get("count"):
            if best is None or h["count"] > best["count"]:
                best = h
    if best is not None and best.get("p50") is not None:
        line = (f"Latency      fleet p50 {obs_report._fmt_s(best['p50'])}")
        if best.get("p95") is not None:
            line += f"  p95 {obs_report._fmt_s(best['p95'])}"
        line += (f"  ({best['count']} job(s) across "
                 f"{best.get('replicas', '?')} replica(s))")
        lines.append(line)
    if summary.get("version_skew"):
        lines.append("Versions     SKEW: "
                     + ", ".join(summary.get("versions") or []))
    vline = f"Verdict      {verdict.get('verdict', 'steady').upper()}"
    reasons = verdict.get("reasons") or []
    if reasons:
        vline += "  (" + "; ".join(reasons) + ")"
    desired = verdict.get("desired")
    if desired and desired != verdict.get("verdict"):
        vline += (f"  [pending {desired}: streak "
                  f"{verdict.get('streak', 0)}/{verdict.get('needed', 1)}]")
    cooldown = verdict.get("cooldown_remaining_s")
    if isinstance(cooldown, (int, float)) and cooldown > 0:
        vline += f"  [cooldown {obs_report._fmt_s(cooldown)}]"
    lines.append(vline)
    return "\n".join(lines).rstrip() + "\n"


def top(root, follow: bool = False, interval: float = 2.0,
        cycles: Optional[int] = None, fleet: bool = False) -> int:
    """The ``top`` subcommand. ``--once`` renders the current
    fleet state and exits (1 when the directory holds no artifacts at
    all); ``--follow`` re-renders until interrupted (or ``cycles``
    frames). ``--fleet`` switches to the federated view: ``root`` is a
    fleet dir of replica serve roots, each frame polls every replica and
    renders the merged snapshot + scale verdict."""
    root = Path(root)
    render = render_fleet_frame if fleet else render_top_frame
    if not follow:
        frame = render(root)
        if frame is None:
            if fleet:
                print(f"Error: no replica serve.json (or fleet_status.json)"
                      f" under {root} — nothing to federate",
                      file=sys.stderr)
            else:
                print(f"Error: no {TIMESERIES_JSONL}, serve.json or "
                      f"serve_manifest.json in {root} — nothing to show",
                      file=sys.stderr)
            return 1
        print(frame, end="")
        return 0
    polled = 0
    announced_wait = False
    with contextlib.suppress(KeyboardInterrupt):
        while True:
            frame = render(root)
            if frame is None:
                if not announced_wait:
                    print(f"Waiting for artifacts in {root} "
                          "(no daemon or sampler output yet)...", flush=True)
                    announced_wait = True
            else:
                stamp = time.strftime("%H:%M:%S")
                print(f"--- {stamp} ---")
                print(frame, end="", flush=True)
            polled += 1
            if cycles is not None and polled >= cycles:
                return 0
            time.sleep(max(0.1, interval))
    return 0
