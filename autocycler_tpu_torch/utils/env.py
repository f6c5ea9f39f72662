"""Environment knobs, read as the JAX package reads them: an unset or blank
variable gives the default, a malformed integer gives the default with one
warning on stderr, and 0/false/no/off (any case) is a false boolean. A call
without a default reads the knob's JAX default from :data:`DEFAULTS`."""

from __future__ import annotations

import os
import sys

_FALSE_VALUES = ("0", "false", "no", "off")
_warned = set()

# the JAX package's names and defaults (autocycler_tpu/utils/knobs.py)
DEFAULTS = {
    # the streamed k-mer grouping (stream/): on/off force it, auto engages
    # from AUTOCYCLER_STREAM_AUTO_WINDOWS windows (2 x the input bases)
    "AUTOCYCLER_STREAM_KMERS": "auto",
    "AUTOCYCLER_STREAM_MEM_MB": 512,
    "AUTOCYCLER_STREAM_AUTO_WINDOWS": 64_000_000,
    # <= 0: the planner sizes bins, chunks and flushes from the budget
    "AUTOCYCLER_STREAM_BINS": 0,
    "AUTOCYCLER_STREAM_CHUNK": 0,
    "AUTOCYCLER_STREAM_FLUSH": 0,
    "AUTOCYCLER_STREAM_SIG_K": 11,
    "AUTOCYCLER_STREAM_RLE": True,
    "AUTOCYCLER_STREAM_PIPELINE": 2,
    # set: take --threads as the worker count, without the core clamp
    "AUTOCYCLER_GROUPING_EXECUTOR": "",
    # the run record: a trace run dir, and a Prometheus dump at exit;
    # stage timings on stderr, and the log as JSON lines
    "AUTOCYCLER_TRACE_DIR": None,
    "AUTOCYCLER_METRICS": None,
    "AUTOCYCLER_TIMINGS": False,
    "AUTOCYCLER_LOG_JSON": False,
    # the warm-start cache: a shared dir (else <autocycler_dir>/.cache),
    # its LRU byte budget (<= 0: no eviction), and the switch
    "AUTOCYCLER_CACHE_DIR": None,
    "AUTOCYCLER_CACHE_MAX_BYTES": 4 << 30,
    "AUTOCYCLER_ENCODE_CACHE": True,
    # helper's assembler subprocesses: timeout (s, unset: none) and retries
    "AUTOCYCLER_SUBPROCESS_TIMEOUT": None,
    "AUTOCYCLER_SUBPROCESS_RETRIES": 0,
    # batch: the fleet runner ('off' = serial, 'on', 'auto' = more than one
    # device), its size buckets, shards of loads in flight ahead of the
    # device, the device count it shards for (0: every CUDA device), and
    # the armed crash points ('point[@n]' comma list)
    "AUTOCYCLER_FLEET_MODE": "off",
    "AUTOCYCLER_FLEET_BUCKETS": 4,
    "AUTOCYCLER_FLEET_PREFETCH": 2,
    "AUTOCYCLER_FLEET_DEVICES": 0,
    "AUTOCYCLER_CRASH_POINTS": "",
    # the fault plan: 'site[:match[:mode[:times]]]' rules, comma separated
    # (utils/resilience.py FaultPlan)
    "AUTOCYCLER_FAULTS": None,
    # the run record's background sampler (timeseries.jsonl beside a trace
    # run and in a serve root): on/off, seconds between ticks, ticks kept
    "AUTOCYCLER_TIMESERIES": True,
    "AUTOCYCLER_TIMESERIES_INTERVAL_S": 5.0,
    "AUTOCYCLER_TIMESERIES_MAX": 2000,
    # serve: submit's default endpoint, the worker count (unset:
    # min(4, cpu // 2)), the bearer token (never logged), the latency
    # objectives, the SLO window and the burn rate that sheds admissions
    "AUTOCYCLER_SERVE": None,
    "AUTOCYCLER_SERVE_WORKERS": None,
    "AUTOCYCLER_SERVE_TOKEN": None,
    "AUTOCYCLER_SLO_P50_S": None,
    "AUTOCYCLER_SLO_P95_S": None,
    "AUTOCYCLER_SLO_WINDOW_S": 3600.0,
    "AUTOCYCLER_SLO_SHED_BURN": None,
    # fleet federation: the probe and scrape timeout, how long a replica
    # that failed a scrape keeps its last health (marked stale), and the
    # scale-verdict engine's thresholds, flip cooldown and hysteresis
    "AUTOCYCLER_FED_TIMEOUT_S": 2.0,
    "AUTOCYCLER_FED_STALE_S": 30.0,
    "AUTOCYCLER_SCALE_OUT_BURN": 1.0,
    "AUTOCYCLER_SCALE_OUT_UTIL": 0.8,
    "AUTOCYCLER_SCALE_OUT_QUEUE": 2.0,
    "AUTOCYCLER_SCALE_IN_UTIL": 0.0,
    "AUTOCYCLER_SCALE_COOLDOWN_S": 60.0,
    "AUTOCYCLER_SCALE_HYSTERESIS": 2,
    # cluster's sketch distances: the mode, the contig count where auto
    # turns them on, and the sketch size, window and k
    "AUTOCYCLER_SKETCH_DISTANCE": "auto",
    "AUTOCYCLER_SKETCH_MIN_CONTIGS": 256,
    "AUTOCYCLER_SKETCH_S": 1024,
    "AUTOCYCLER_SKETCH_W": 11,
    "AUTOCYCLER_SKETCH_K": 21,
    # dotplot's font file (unset: the bundled DejaVu Sans)
    "AUTOCYCLER_DOTPLOT_FONT": None,
    # the profiler knobs (utils/timing.py): a torch.profiler Chrome trace
    # of every stage_timer under AUTOCYCLER_PROFILE_DIR/<stage>/; and under
    # the directory AUTOCYCLER_XPROF names, one of each of the first
    # AUTOCYCLER_XPROF_LIMIT launches, DP dispatches and device_work blocks
    # of a name. The JAX package's docstring calls AUTOCYCLER_XPROF a list
    # of stage names, but its code (utils/timing.py device_dispatch) reads
    # it as a directory; the port follows the code.
    "AUTOCYCLER_PROFILE_DIR": None,
    "AUTOCYCLER_XPROF": None,
    "AUTOCYCLER_XPROF_LIMIT": 2,
    # the device probe (obs/sentinel.py, device.py's gate): its deadline
    # (unset: 60 s, 20 s for the background probe; <= 0 skips the probe),
    # how long a persisted negative stays fresh, the retries before a
    # negative is persisted, the watcher's interval, the probe log's cap,
    # and the recovery capture's switch and sizes
    "AUTOCYCLER_PROBE_DEADLINE_S": None,
    "AUTOCYCLER_PROBE_NEG_TTL_S": 300.0,
    "AUTOCYCLER_PROBE_RETRIES": 1,
    "AUTOCYCLER_PROBE_RETRY_BACKOFF_S": 2.0,
    "AUTOCYCLER_PROBE_WATCH": None,
    "AUTOCYCLER_PROBE_LOG_MAX": 500,
    "AUTOCYCLER_RECOVERY_CAPTURE": True,
    "AUTOCYCLER_RECOVERY_DOTPLOT_N": 65536,
    "AUTOCYCLER_RECOVERY_GROUPING_MBP": 2.0,
}


def env_str(name: str, default: str = None) -> str:
    if default is None:
        default = DEFAULTS[name]
    raw = os.environ.get(name)
    return default if raw is None or not raw.strip() else raw.strip()


def env_bool(name: str, default: bool = None) -> bool:
    if default is None:
        default = DEFAULTS[name]
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in _FALSE_VALUES


def env_int(name: str, default: int = None) -> int:
    return _env_number(name, default, int, "int")


def env_float(name: str, default: float = None) -> float:
    return _env_number(name, default, float, "float")


def _env_number(name: str, default, kind, kind_name: str):
    if default is None:
        default = DEFAULTS[name]
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return kind(raw.strip())
    except ValueError:
        if name not in _warned:
            _warned.add(name)
            print(f"Warning: ignoring malformed {kind_name} value {raw!r} "
                  f"for {name}; using default {default!r}", file=sys.stderr)
        return default
