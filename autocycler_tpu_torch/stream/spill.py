"""On-disk spill layout of the streamed k-mer grouping, byte for byte the
JAX package's (stream/spill.py).

Layout under ``<autocycler_dir>/.stream/``::

    .stream/
      run-<pid>-<token>/
        manifest.json        {"version": 1, "format": 2, "pid": ...,
                              "k": ..., "sig_k": ..., "n_bins": ...,
                              "counts": [...], ...}
        bin-0000.u64         spill records (format 1 or 2, see below)
        ...

A live run owns one run dir and removes it when grouping ends, whether it
succeeded or not. A run killed mid-pass leaves its dir behind; the orphan
sweep at the next compress removes every run dir whose recorded pid is no
longer alive, and any dir without a readable manifest.

Two record formats, named by the manifest's ``format`` (absent = 1):

- **format 1**: one little-endian int64 occurrence index per window.
- **format 2** (super-k-mer RLE, KMC 2 arXiv:1407.1507): a maximal run of
  consecutive occurrence indices landing in one bin is one ``(start_occ,
  run_len)`` pair of little-endian int64s. The manifest's per-bin
  ``counts`` are WINDOW counts in both formats, so pass 2 catches a torn
  or truncated run.

The reader never raises: torn tails, count mismatches, non-positive run
lengths, records not ascending, unknown formats and unreadable files come
back as ``(None, reason)`` for the caller to quarantine.

The spill's posture goes to the metrics registry under the JAX package's
names: :data:`SPILL_BYTES_GAUGE` (the bytes on disk now, 0 once the run
dir is gone), :data:`SPILL_BYTES_TOTAL` (the bytes ever appended) and
:data:`ORPHANS_SWEPT_TOTAL`; the driver adds the bins, the RLE ratio and
the quarantined bins. :data:`last_run` summarises the last streamed
grouping.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..obs import metrics_registry
from ..utils import log
from ..utils.resilience import fault_fire

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
RECORD_DTYPE = "<i8"
RECORD_BYTES = 8
RLE_RECORD_BYTES = 16          # format 2: (start_occ, run_len) int64 pair
SUPPORTED_FORMATS = (1, 2)

ORPHANS_SWEPT_TOTAL = "autocycler_stream_orphans_swept_total"
SPILL_BYTES_GAUGE = "autocycler_stream_spill_bytes"
SPILL_BYTES_TOTAL = "autocycler_stream_spill_bytes_total"

# the summary of the last streamed grouping (stream.driver), until
# reset_last_run()
last_run: dict = {}


def reset_last_run() -> None:
    last_run.clear()


def set_spill_gauge(value: int) -> None:
    metrics_registry.gauge_set(
        SPILL_BYTES_GAUGE, float(value),
        help="bytes currently spilled to .stream k-mer bins")


def count_spill_bytes(n: int) -> None:
    if n > 0:
        metrics_registry.counter_inc(
            SPILL_BYTES_TOTAL, int(n),
            help="cumulative bytes appended to .stream k-mer bins")


_root_lock = threading.Lock()
_stream_root: Optional[Path] = None


def set_stream_root(path) -> None:
    """Install the spill root (``<autocycler_dir>/.stream``) for this
    process; compress calls this before building the unitig graph."""
    global _stream_root
    with _root_lock:
        _stream_root = Path(path) if path is not None else None


def stream_root() -> Optional[Path]:
    with _root_lock:
        return _stream_root


def bin_filename(b: int) -> str:
    return f"bin-{b:04d}.u64"


def new_run_dir(root: Path) -> Path:
    run = Path(root) / f"run-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    run.mkdir(parents=True, exist_ok=False)
    return run


def write_manifest(run_dir: Path, k: int, sig_k: int, n_bins: int,
                   counts: Optional[List[int]] = None,
                   spill_bytes: int = 0, fmt: int = 1) -> None:
    payload = {"version": MANIFEST_VERSION, "format": int(fmt),
               "pid": os.getpid(), "k": int(k),
               "sig_k": int(sig_k), "n_bins": int(n_bins),
               "spill_bytes": int(spill_bytes),
               "counts": [int(c) for c in counts] if counts is not None
               else None}
    tmp = Path(run_dir) / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(payload) + "\n")
    os.replace(tmp, Path(run_dir) / MANIFEST_NAME)


def read_manifest(run_dir) -> Optional[dict]:
    """The run manifest, or None when missing or unreadable (never raises)."""
    try:
        data = json.loads((Path(run_dir) / MANIFEST_NAME).read_text())
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def encode_rle(occ: np.ndarray) -> np.ndarray:
    """Format-2 encoder: a strictly ascending occurrence array becomes
    interleaved ``(start_occ, run_len)`` int64 pairs, one pair per maximal
    run of consecutive indices."""
    occ = np.asarray(occ, dtype=np.int64)
    if len(occ) == 0:
        return np.zeros(0, np.int64)
    breaks = np.flatnonzero(np.diff(occ) != 1) + 1
    bounds = np.concatenate(([0], breaks, [len(occ)]))
    out = np.empty(2 * (len(bounds) - 1), np.int64)
    out[0::2] = occ[bounds[:-1]]
    out[1::2] = np.diff(bounds)
    return out


def decode_rle(pairs: np.ndarray
               ) -> Tuple[Optional[np.ndarray], Optional[str]]:
    """Expands interleaved ``(start_occ, run_len)`` pairs back to the
    occurrence array, checking the format-2 invariants: every run length
    positive, starts non-negative, runs ascending and not overlapping.
    Adjacent runs that could merge are legal: flush and chunk boundaries
    split maximal runs."""
    pairs = np.asarray(pairs, dtype=np.int64)
    starts = pairs[0::2]
    lens = pairs[1::2]
    if len(starts) == 0:
        return np.zeros(0, np.int64), None
    if np.any(lens < 1):
        return None, "RLE record has a non-positive run length"
    if starts[0] < 0:
        return None, "RLE record has a negative start occurrence"
    if np.any(starts[1:] < starts[:-1] + lens[:-1]):
        return None, "RLE runs overlap or are not ascending"
    total = int(lens.sum())
    ends = np.cumsum(lens)
    # occ[j] = start of its run + offset within the run
    occ = np.repeat(starts - (ends - lens), lens) \
        + np.arange(total, dtype=np.int64)
    return occ, None


def read_bin_records(path, expected: Optional[int] = None, fmt: int = 1
                     ) -> Tuple[Optional[np.ndarray], Optional[str]]:
    """One bin file's occurrence records: ``(records, None)``, or ``(None,
    reason)`` on any corruption; never raises.

    ``fmt`` is the record format the sealed manifest declared. Valid means:
    a supported format, readable, a whole number of records, the manifest's
    WINDOW count when given (format 2 checks the expanded length), and
    strictly ascending occurrence indices (pass 1 appends each occurrence
    once, in ascending order). The fault sites ``stream_read`` (a corrupt
    read) and ``stream_format`` (a manifest sealed by a newer writer) are
    keyed by the bin's file name."""
    if fault_fire("stream_read", os.path.basename(str(path))) is not None:
        return None, "fault injection: forced corrupt bin read"
    if fault_fire("stream_format", os.path.basename(str(path))) is not None:
        fmt = -1
    if int(fmt) not in SUPPORTED_FORMATS:
        return None, (f"unsupported spill record format {int(fmt)} (this "
                      f"reader supports {SUPPORTED_FORMATS})")
    record_bytes = RLE_RECORD_BYTES if int(fmt) == 2 else RECORD_BYTES
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        return None, f"unreadable bin file: {e}"
    if len(data) % record_bytes:
        return None, (f"torn bin file: {len(data)} bytes is not a whole "
                      f"multiple of the {record_bytes}-byte format-"
                      f"{int(fmt)} record")
    raw = np.frombuffer(data, dtype=RECORD_DTYPE).astype(np.int64)
    if int(fmt) == 2:
        occ, reason = decode_rle(raw)
        if occ is None:
            return None, reason
    else:
        occ = raw
    if expected is not None and len(occ) != int(expected):
        return None, (f"bin holds {len(occ)} window records but the "
                      f"manifest recorded {int(expected)}")
    if len(occ) and (occ[0] < 0 or np.any(np.diff(occ) <= 0)):
        return None, "bin records are not strictly ascending"
    return occ, None


def _dir_bytes(path: Path) -> int:
    total = 0
    for p in path.rglob("*"):
        try:
            if p.is_file():
                total += p.stat().st_size
        except OSError:
            continue
    return total


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True      # exists but not ours (EPERM)
    return True


def sweep_orphan_spills(root) -> int:
    """Removes the run dirs of killed runs: every ``run-*`` dir under
    ``root`` whose manifest pid is dead, or whose manifest is unreadable.
    Returns the number removed."""
    root = Path(root)
    if not root.is_dir():
        return 0
    swept = 0
    for run in sorted(root.glob("run-*")):
        if not run.is_dir():
            continue
        manifest = read_manifest(run)
        pid = int(manifest.get("pid") or 0) if manifest else 0
        if pid == os.getpid() or (manifest is not None and _pid_alive(pid)):
            continue
        shutil.rmtree(run, ignore_errors=True)
        swept += 1
    if swept:
        metrics_registry.counter_inc(
            ORPHANS_SWEPT_TOTAL, swept,
            help="orphaned stream spill dirs removed at startup")
        log.message(f"Swept {swept} orphaned .stream spill "
                    f"director{'y' if swept == 1 else 'ies'} under {root}")
    return swept


def purge_stream_spills(cache_dir) -> Tuple[int, int]:
    """Removes the whole ``.stream`` spill tree of an autocycler dir (given
    as the dir, its ``.stream`` or its ``.cache``). Returns (run dirs
    removed, bytes reclaimed); (0, 0) when there is nothing to purge."""
    target = Path(cache_dir)
    if target.name == ".stream":
        root = target
    elif target.name == ".cache":
        root = target.parent / ".stream"
    else:
        root = target / ".stream"
    if not root.is_dir():
        return 0, 0
    removed = sum(1 for p in root.glob("run-*") if p.is_dir())
    reclaimed = _dir_bytes(root)
    shutil.rmtree(root, ignore_errors=True)
    return removed, reclaimed
