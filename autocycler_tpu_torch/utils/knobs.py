"""The registry of every AUTOCYCLER_* environment knob the port reads.

Each knob is declared here once, with its kind, its default and a one-line
doc: the JAX package's name, kind and default (its utils/knobs.py), and its
doc where the port's meaning is the same. All runtime reads go through the
typed accessors, with the JAX package's parse rules:

- booleans: a set value of ``0``/``false``/``no``/``off`` (any case,
  stripped) is False, any other non-empty value is True;
- numbers: a malformed value gives the default, with one stderr warning
  per knob per process;
- strings: returned as set; empty or unset gives the default.

``autocycler lint`` checks that no module of the port reads an
``AUTOCYCLER_*`` name from ``os.environ`` directly, that every name read
through the accessors is declared here, and that this registry and the
knob table of ``docs_torch/cli.md`` agree (``lint --knobs-md`` writes it).

This module imports nothing of the package: low-level modules read it.
"""

import os
import sys
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

__all__ = [
    "Knob",
    "KNOBS",
    "all_knobs",
    "knob_bool",
    "knob_float",
    "knob_int",
    "knob_raw",
    "knob_set",
    "knob_str",
    "knobs_markdown",
]

Default = Union[str, int, float, bool, None]


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "str" | "int" | "float" | "bool"
    default: Default
    doc: str


def _k(name: str, kind: str, default: Default, doc: str) -> Tuple[str, Knob]:
    return name, Knob(name=name, kind=kind, default=default, doc=doc)


# Declaration order (the JAX package's) is the order of the generated table.
KNOBS: Dict[str, Knob] = dict([
    # --- observability ---------------------------------------------------
    _k("AUTOCYCLER_TRACE_DIR", "str", None,
       "Root directory for per-run trace/artifact dirs; unset disables run tracing. "
       "Each span has ts/dur (s from the run's start) and t0_ns/t1_ns (Unix ns, the clock "
       "of time.time_ns() and torch.profiler's events); a run opened in memory "
       "(obs.trace.open_run(None)) writes no file and hashes nothing."),
    _k("AUTOCYCLER_METRICS", "str", None,
       "Path to write a Prometheus text-format metrics dump at process exit."),
    _k("AUTOCYCLER_TIMINGS", "bool", False,
       "Print a per-stage timing table to stderr at process exit."),
    _k("AUTOCYCLER_LOG_JSON", "bool", False,
       "Emit log lines as structured JSON instead of ANSI-decorated text."),
    _k("AUTOCYCLER_PROFILE_DIR", "str", None,
       "Directory for torch.profiler Chrome traces, one per stage timer: <dir>/<stage>/trace-<n>.json."),
    _k("AUTOCYCLER_XPROF", "str", None,
       "Directory for torch.profiler Chrome traces of single kernel launches, DP dispatches and device blocks: <dir>/<name>-<n>.json."),
    _k("AUTOCYCLER_XPROF_LIMIT", "int", 2,
       "Maximum number of AUTOCYCLER_XPROF captures of each name per process."),
    _k("AUTOCYCLER_TIMESERIES", "bool", True,
       "Enable the background time-series sampler when a run dir is active."),
    _k("AUTOCYCLER_TIMESERIES_INTERVAL_S", "float", 5.0,
       "Sampling interval in seconds for the time-series sampler."),
    _k("AUTOCYCLER_TIMESERIES_MAX", "int", 2000,
       "Maximum retained samples per timeseries.jsonl before rotation."),
    # --- device probe & recovery -----------------------------------------
    _k("AUTOCYCLER_PROBE_DEADLINE_S", "float", None,
       "Device probe deadline in seconds (unset: 60, 20 for the background probe); <=0 skips the probe."),
    _k("AUTOCYCLER_PROBE_NEG_TTL_S", "float", 300.0,
       "Seconds a negative device-probe verdict stays cached on disk."),
    _k("AUTOCYCLER_PROBE_RETRIES", "int", 1,
       "Extra subprocess probe attempts after the first failure."),
    _k("AUTOCYCLER_PROBE_RETRY_BACKOFF_S", "float", 2.0,
       "Base backoff in seconds between probe retry attempts."),
    _k("AUTOCYCLER_PROBE_WATCH", "float", None,
       "Interval in seconds for the background probe watcher; unset/invalid disables it."),
    _k("AUTOCYCLER_PROBE_LOG_MAX", "int", 500,
       "Maximum retained entries in the probe sentinel log."),
    _k("AUTOCYCLER_RECOVERY_CAPTURE", "bool", True,
       "Auto-capture a micro-bench when the device recovers from a wedged state."),
    _k("AUTOCYCLER_RECOVERY_DOTPLOT_N", "int", 65536,
       "Sequence length for the recovery micro-bench dotplot capture."),
    _k("AUTOCYCLER_RECOVERY_GROUPING_MBP", "float", 2.0,
       "Input size in Mbp for the recovery micro-bench grouping capture."),
    # --- device & grouping dispatch --------------------------------------
    _k("AUTOCYCLER_DEVICE_GROUPING", "str", None,
       "In-memory k-mer grouping: 'radix' shards radix buckets over every CUDA device; unset (or any other mode) keeps the partition-sort kernel."),
    _k("AUTOCYCLER_GROUPING_EXECUTOR", "str", None,
       "Set: take --threads as the grouping worker count without the core clamp."),
    # --- cluster distance: sketching -------------------------------------
    _k("AUTOCYCLER_SKETCH_DISTANCE", "str", "auto",
       "Cluster distance backend: 'auto' (sketch above AUTOCYCLER_SKETCH_MIN_CONTIGS), 'on'/'off' to force, 'verify' runs both and records the error."),
    _k("AUTOCYCLER_SKETCH_MIN_CONTIGS", "int", 256,
       "Contig count at which 'auto' sketch mode switches from the exact distance path to minimizer sketches."),
    _k("AUTOCYCLER_SKETCH_S", "int", 1024,
       "Bottom-s MinHash sketch size per contig (entries in the sorted sketch vector)."),
    _k("AUTOCYCLER_SKETCH_W", "int", 11,
       "Minimizer window: number of consecutive k-mer positions per window minimum."),
    _k("AUTOCYCLER_SKETCH_K", "int", 21,
       "Minimizer k-mer size (clamped to 27 so the base-5 pack stays exact in uint64)."),
    # --- streaming k-mer spill (two-pass disk binning) -------------------
    _k("AUTOCYCLER_STREAM_KMERS", "str", "auto",
       "Streamed two-pass k-mer grouping: 'on'/'off' force it, 'auto' engages above AUTOCYCLER_STREAM_AUTO_WINDOWS windows."),
    _k("AUTOCYCLER_STREAM_MEM_MB", "int", 512,
       "Host working-set budget in MiB for the streamed grouping (sizes bins, pass-1 chunks and write buffers)."),
    _k("AUTOCYCLER_STREAM_AUTO_WINDOWS", "int", 64_000_000,
       "Window count (2x total input bases) at which 'auto' streaming engages."),
    _k("AUTOCYCLER_STREAM_BINS", "int", 0,
       "Override the planned on-disk bin count; <=0 lets the planner size bins from the memory budget."),
    _k("AUTOCYCLER_STREAM_CHUNK", "int", 0,
       "Override the planned pass-1 chunk size in windows; <=0 lets the planner choose."),
    _k("AUTOCYCLER_STREAM_SIG_K", "int", 11,
       "Minimizer-signature m-mer length for bin assignment (clamped to k and 27)."),
    _k("AUTOCYCLER_STREAM_RLE", "bool", True,
       "Super-k-mer run-length-encoded spill records (format 2); off writes one record per window (format 1) for A/B comparison."),
    _k("AUTOCYCLER_STREAM_PIPELINE", "int", 2,
       "Streamed-grouping pipeline depth: outstanding pass-1 disk appends and prefetched pass-2 bin reads; <=1 runs the passes synchronously."),
    _k("AUTOCYCLER_STREAM_FLUSH", "int", 0,
       "Override the planned per-bin records buffered before a spill append; <=0 lets the planner size buffers from the memory budget."),
    # --- caches ----------------------------------------------------------
    _k("AUTOCYCLER_CACHE_DIR", "str", None,
       "Root of the shared content-addressed encode cache."),
    _k("AUTOCYCLER_CACHE_MAX_BYTES", "int", 4 * 1024**3,
       "LRU byte budget for the shared encode cache; <=0 disables eviction."),
    _k("AUTOCYCLER_ENCODE_CACHE", "bool", True,
       "Enable the content-addressed encode cache."),
    # --- resilience / faults ---------------------------------------------
    _k("AUTOCYCLER_FAULTS", "str", None,
       "Fault-injection plan: 'site[:match[:mode[:times]]]' rules separated by commas."),
    _k("AUTOCYCLER_SUBPROCESS_TIMEOUT", "float", None,
       "Timeout in seconds applied to helper subprocess invocations."),
    _k("AUTOCYCLER_SUBPROCESS_RETRIES", "int", 0,
       "Retry count for failed helper subprocess invocations."),
    _k("AUTOCYCLER_CRASH_POINTS", "str", None,
       "Arm registered crash points for chaos testing: comma list of 'point[@n]' entries, crashing the process at the n-th hit of the point (default first)."),
    # --- fleet batch -----------------------------------------------------
    _k("AUTOCYCLER_FLEET_MODE", "str", "off",
       "Fleet runner for `autocycler batch`: 'off' (serial oracle), 'on', or 'auto' (engage when >1 device and >1 isolate). The CLI --fleet flag overrides."),
    _k("AUTOCYCLER_FLEET_BUCKETS", "int", 4,
       "Number of isolate-size buckets the fleet planner packs shards from; fewer buckets = more padding waste."),
    _k("AUTOCYCLER_FLEET_PREFETCH", "int", 2,
       "Shards of isolate loads kept in flight ahead of the device step (multiplied by the shard width); <=1 disables host/device overlap."),
    _k("AUTOCYCLER_FLEET_DEVICES", "int", 0,
       "Device count the fleet planner shards for; 0 takes every CUDA device."),
    # --- serve / SLOs ----------------------------------------------------
    _k("AUTOCYCLER_SERVE", "str", None,
       "Default serve endpoint for `autocycler submit` (host:port or unix:/path)."),
    _k("AUTOCYCLER_SERVE_WORKERS", "int", None,
       "Worker threads in the serve scheduler pool; default min(4, cpu//2), floor 1. 1 reproduces the single-worker daemon bit for bit."),
    _k("AUTOCYCLER_SERVE_TOKEN", "str", None,
       "Shared-secret bearer token for the serve daemon; required on every request when binding beyond loopback. Never logged and redacted from ledgers/snapshots."),
    _k("AUTOCYCLER_SLO_P50_S", "float", None,
       "p50 end-to-end latency objective in seconds for serve SLO tracking."),
    _k("AUTOCYCLER_SLO_P95_S", "float", None,
       "p95 end-to-end latency objective in seconds for serve SLO tracking."),
    _k("AUTOCYCLER_SLO_WINDOW_S", "float", 3600.0,
       "Sliding window in seconds for serve SLO burn-rate accounting."),
    _k("AUTOCYCLER_SLO_SHED_BURN", "float", None,
       "Burn-rate threshold above which the serve daemon sheds new submissions with 503 + Retry-After; unset disables admission control."),
    # --- fleet federation / scale verdicts -------------------------------
    _k("AUTOCYCLER_FED_TIMEOUT_S", "float", 2.0,
       "Per-replica timeout in seconds for the fleet scraper's /healthz and /metrics polls; a slow replica is marked unhealthy, never waited on."),
    _k("AUTOCYCLER_FED_STALE_S", "float", 30.0,
       "Freshness window in seconds for fleet federation: a replica that fails a scrape keeps its last-known data (marked stale) for this long, then reports unknown."),
    _k("AUTOCYCLER_SCALE_OUT_BURN", "float", 1.0,
       "Fleet burn rate above which the scale-verdict engine proposes scale_out."),
    _k("AUTOCYCLER_SCALE_OUT_UTIL", "float", 0.8,
       "Fleet worker utilization (busy/total) above which the scale-verdict engine proposes scale_out."),
    _k("AUTOCYCLER_SCALE_OUT_QUEUE", "float", 2.0,
       "Queued jobs per healthy replica above which the scale-verdict engine proposes scale_out."),
    _k("AUTOCYCLER_SCALE_IN_UTIL", "float", 0.0,
       "Fleet utilization below which an idle multi-replica fleet proposes scale_in; the default 0.0 disables scale_in (utilization is never < 0)."),
    _k("AUTOCYCLER_SCALE_COOLDOWN_S", "float", 60.0,
       "Minimum seconds between scale-verdict flips; a fresh flip holds through the cooldown even when the inputs keep flapping."),
    _k("AUTOCYCLER_SCALE_HYSTERESIS", "int", 2,
       "Consecutive agreeing fleet polls required before the scale verdict flips (floor 1)."),
    # --- misc ------------------------------------------------------------
    _k("AUTOCYCLER_DOTPLOT_FONT", "str", None,
       "Path to a TTF font for dotplot labels, overriding the bundled DejaVu Sans."),
])


_warn_lock = threading.Lock()
_warned: set = set()


def _warn_once(name: str, raw: str, kind: str, default: Default) -> None:
    with _warn_lock:
        if name in _warned:
            return
        _warned.add(name)
    print(f"Warning: ignoring malformed {kind} value {raw!r} for {name}; "
          f"using default {default!r}", file=sys.stderr)


def _declared(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"{name} is not declared in autocycler_tpu_torch.utils.knobs."
            "KNOBS; declare it there before reading it") from None


_UNSET = object()
_FALSE_VALUES = ("0", "false", "no", "off")


def knob_raw(name: str) -> Optional[str]:
    """Raw environment value for a declared knob (None when unset)."""
    _declared(name)
    return os.environ.get(name)


def knob_set(name: str) -> bool:
    """True when the knob is set to a non-empty value in the environment."""
    _declared(name)
    raw = os.environ.get(name)
    return raw is not None and raw.strip() != ""


def knob_str(name: str, default: Default = _UNSET) -> Optional[str]:
    """String knob: unset/empty falls back to the declared (or given) default."""
    knob = _declared(name)
    fallback = knob.default if default is _UNSET else default
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return fallback  # type: ignore[return-value]
    return raw


def knob_bool(name: str, default: Default = _UNSET) -> bool:
    """Boolean knob: 0/false/no/off (any case) is False, any other set value True."""
    knob = _declared(name)
    fallback = knob.default if default is _UNSET else default
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return bool(fallback)
    return raw.strip().lower() not in _FALSE_VALUES


def _knob_number(name: str, default: Default, parse, kind: str):
    knob = _declared(name)
    fallback = knob.default if default is _UNSET else default
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return fallback
    try:
        return parse(raw.strip())
    except ValueError:
        _warn_once(name, raw, kind, fallback)
        return fallback


def knob_int(name: str, default: Default = _UNSET) -> Optional[int]:
    """Integer knob: malformed values fall back to the default with one warning."""
    return _knob_number(name, default, int, "int")


def knob_float(name: str, default: Default = _UNSET) -> Optional[float]:
    """Float knob: malformed values fall back to the default with one warning."""
    return _knob_number(name, default, float, "float")


def all_knobs() -> Tuple[Knob, ...]:
    """Every declared knob, in declaration order."""
    return tuple(KNOBS.values())


def _format_default(knob: Knob) -> str:
    if knob.default is None:
        return "unset"
    if knob.kind == "bool":
        return "on" if knob.default else "off"
    return f"`{knob.default}`"


def knobs_markdown() -> str:
    """Markdown table of every knob: the knob table of docs_torch/cli.md."""
    lines = [
        "| Knob | Type | Default | Description |",
        "| --- | --- | --- | --- |",
    ]
    for knob in all_knobs():
        lines.append(
            f"| `{knob.name}` | {knob.kind} | {_format_default(knob)} | {knob.doc} |")
    return "\n".join(lines) + "\n"
