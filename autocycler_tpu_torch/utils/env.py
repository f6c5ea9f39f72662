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
    # the run record: a trace run dir, and a Prometheus dump at exit
    "AUTOCYCLER_TRACE_DIR": None,
    "AUTOCYCLER_METRICS": None,
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
