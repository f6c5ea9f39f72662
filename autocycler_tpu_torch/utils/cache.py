"""Warm-start caches for compress and cluster, as the JAX package's
utils/cache.py keeps them: the same entry names and ``.npz`` keys, so each
package reads the other's entries.

Content-addressed caches live under ``<autocycler_dir>/.cache``:

- the per-assembly **parse cache**: keyed by sha256 of the FASTA file's raw
  bytes plus k, storing every >= k contig's dot-padded forward strand,
  header and length, so a repeat run skips decompression, parsing, ACGT
  validation and padding. Content addressing means an mtime-only touch
  still hits while any byte change misses.
- the **repair cache**: sequence-end repair depends on every input file at
  once (candidates are searched across all sequences), so its key is the
  sha256 over ALL per-file content hashes plus k. Only the repaired
  2*(k-1) end bytes per sequence are stored; a hit patches the parsed
  strands on the host and skips end repair's grouping on the device.
- the per-contig **sketch cache** of cluster's sketch distances, keyed by
  the sha256 of the contig's forward bytes and (k, w, s).

All are best-effort: any read/write failure is a miss (the caller parses,
repairs or sketches again), and every payload re-derives the reverse strand
from the forward bytes, so a hit is bit-identical to a cold run by
construction. A cache never decides whether work runs on the device, only
whether it runs at all. AUTOCYCLER_ENCODE_CACHE=0 disables them.

A **shared cache directory** (:func:`set_shared_cache_dir`, which the
serve daemon calls, or ``AUTOCYCLER_CACHE_DIR``) points every
:func:`open_cache` at one directory;
entries are content-addressed, so sharing is safe. A **byte-budget LRU**
(``AUTOCYCLER_CACHE_MAX_BYTES``, default 4 GiB, <= 0 disables) evicts
least-recently-used entries (hits bump mtime) after every store.
``autocycler clean --cache <dir>`` purges a cache outright.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..obs import metrics_registry
from .knobs import knob_bool, knob_int, knob_str

# process-wide hit/miss accounting lives in the metrics registry
# (obs.metrics_registry), inspectable by tests, artifacts and
# `autocycler report` alike
CACHE_EVENTS = "autocycler_cache_events_total"
CACHE_EVICTIONS = "autocycler_cache_evictions_total"
CACHE_EVICTED_BYTES = "autocycler_cache_evicted_bytes_total"

_shared_dir_lock = threading.Lock()
_shared_dir: Optional[Path] = None


def set_shared_cache_dir(path) -> None:
    """Point every subsequent :func:`open_cache` at one directory (None
    restores per-autocycler-dir caches). The serve daemon sets this once at
    start so all jobs share warm-start entries."""
    global _shared_dir
    with _shared_dir_lock:
        _shared_dir = None if path is None else Path(path)


def shared_cache_dir() -> Optional[Path]:
    """The active shared cache directory: the explicit setter wins, then
    ``AUTOCYCLER_CACHE_DIR``, else None (per-dir caches)."""
    with _shared_dir_lock:
        if _shared_dir is not None:
            return _shared_dir
    env = (knob_str("AUTOCYCLER_CACHE_DIR") or "").strip()
    return Path(env) if env else None


def cache_max_bytes() -> Optional[int]:
    """The eviction budget in bytes, or None when eviction is disabled
    (``AUTOCYCLER_CACHE_MAX_BYTES`` <= 0 or unparsable)."""
    budget = int(knob_int("AUTOCYCLER_CACHE_MAX_BYTES"))
    return budget if budget > 0 else None


def cache_stats() -> dict:
    """{"parse_hits": n, "parse_misses": n, "repair_hits": n,
    "repair_misses": n} — a view over the registry's cache-event
    counters."""
    reg = metrics_registry.registry()
    out = {}
    for which in ("parse", "repair"):
        for event, suffix in (("hit", "hits"), ("miss", "misses")):
            out[f"{which}_{suffix}"] = int(
                reg.value(CACHE_EVENTS, cache=which, event=event))
    return out


def _count(key: str) -> None:
    which, event = key.rsplit("_", 1)
    metrics_registry.counter_inc(
        CACHE_EVENTS, 1, help="warm-start cache hits/misses",
        cache=which, event={"hits": "hit", "misses": "miss"}[event])


def cache_enabled() -> bool:
    return knob_bool("AUTOCYCLER_ENCODE_CACHE")


def content_hash(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


def _atomic_write(path: Path, payload: bytes) -> None:
    """Write to a pid-tagged tmp beside ``path``, then rename it into place:
    a reader never sees a torn entry, and a dead writer's tmp is swept by
    the next :func:`open_cache`. An armed ``mid-cache-store`` crash point
    writes half the payload to the tmp and kills the process there."""
    from .resilience import crash_armed, crash_point
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=f"{path.name}.{os.getpid()}.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            if crash_armed("mid-cache-store", path.name):
                f.write(payload[: len(payload) // 2])
                f.flush()
                crash_point("mid-cache-store", path.name)
                raise OSError("crash point mid-cache-store did not exit")
            f.write(payload)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _sweep_stale_tmps(cache_dir: Path) -> int:
    """Remove torn ``<entry>.npz.<pid>.*.tmp`` leftovers whose writing
    process is dead. Live pids are skipped so two processes sharing
    ``AUTOCYCLER_CACHE_DIR`` never delete each other's in-flight stores."""
    from .resilience import pid_alive
    removed = 0
    try:
        candidates = list(cache_dir.glob("*.npz.*"))
    except OSError:
        return 0
    for path in candidates:
        if ".tmp" not in path.name:
            continue
        pid_tok = path.name.split(".npz.", 1)[1].split(".", 1)[0]
        if pid_tok.isdigit() and pid_alive(int(pid_tok)):
            continue
        try:
            path.unlink()
            removed += 1
        except OSError:
            continue
    return removed


class EncodeCache:
    """Handle on one autocycler dir's ``.cache`` directory. ``None``-safe
    construction: :func:`open_cache` returns None when caching is disabled,
    and every call site guards on that."""

    def __init__(self, cache_dir) -> None:
        self.dir = Path(cache_dir)

    def _parse_path(self, file_hash: str, k: int) -> Path:
        return self.dir / f"asm-{file_hash[:24]}-k{k}.npz"

    def _repair_path(self, combined_hash: str, k: int) -> Path:
        return self.dir / f"repair-{combined_hash[:24]}-k{k}.npz"

    def _sketch_path(self, seq_hash: str, k: int, w: int, s: int) -> Path:
        return self.dir / f"sketch-{seq_hash[:24]}-k{k}w{w}s{s}.npz"

    # ---- byte-budget LRU ----

    @staticmethod
    def _touch(path: Path) -> None:
        """Bump an entry's mtime on a hit — mtime order IS the LRU order
        the evictor walks. Best-effort (a read-only cache still hits)."""
        try:
            os.utime(path)
        except OSError:
            pass

    def enforce_budget(self, max_bytes: Optional[int] = None) -> int:
        """Evict least-recently-used ``.npz`` entries until the directory
        fits ``max_bytes`` (default: :func:`cache_max_bytes`). The newest
        entry always survives — evicting what was just written would make
        a tiny budget equivalent to disabling the cache. Returns the number
        of entries evicted; never raises."""
        if max_bytes is None:
            max_bytes = cache_max_bytes()
        if max_bytes is None:
            return 0
        try:
            listing = list(self.dir.glob("*.npz"))
        except OSError:
            return 0
        entries = []
        for path in listing:
            try:
                st = path.stat()
            except OSError:
                # a concurrent evictor (another process sharing this cache
                # dir) removed it between listing and stat — its bytes are
                # already reclaimed, just drop it from our view
                continue
            entries.append((st.st_mtime, st.st_size, path))
        total = sum(size for _, size, _ in entries)
        if total <= max_bytes:
            return 0
        entries.sort()                      # oldest mtime first
        evicted = 0
        evicted_bytes = 0
        for mtime, size, path in entries[:-1]:   # keep the newest entry
            if total <= max_bytes:
                break
            try:
                path.unlink()
            except FileNotFoundError:
                # raced with another evictor: the bytes are gone either
                # way, so the budget accounting must still shrink
                total -= size
                continue
            except OSError:
                continue
            total -= size
            evicted += 1
            evicted_bytes += size
        if evicted:
            metrics_registry.counter_inc(
                CACHE_EVICTIONS, evicted,
                help="warm-start cache entries evicted by the byte budget")
            metrics_registry.counter_inc(
                CACHE_EVICTED_BYTES, evicted_bytes,
                help="bytes reclaimed by warm-start cache eviction")
        return evicted

    # ---- per-assembly parse cache ----

    def load_parsed(self, file_hash: str, k: int
                    ) -> Optional[List[Tuple[str, np.ndarray, int]]]:
        """[(contig_header, padded forward strand, unpadded length), ...] in
        file order for a previously-cached assembly, or None on a miss."""
        path = self._parse_path(file_hash, k)
        try:
            with np.load(path, allow_pickle=False) as z:
                payload = z["payload"]
                offs = z["offs"]
                meta = json.loads(bytes(z["meta"]).decode())
        except Exception:  # noqa: BLE001 — missing/corrupt entry == miss
            _count("parse_misses")
            return None
        records = []
        for i, (header, length) in enumerate(meta):
            records.append((header, payload[offs[i]:offs[i + 1]], int(length)))
        _count("parse_hits")
        self._touch(path)
        return records

    def store_parsed(self, file_hash: str, k: int,
                     records: List[Tuple[str, np.ndarray, int]]) -> None:
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            payload = np.concatenate([fwd for _, fwd, _ in records]) \
                if records else np.zeros(0, np.uint8)
            offs = np.zeros(len(records) + 1, np.int64)
            np.cumsum([len(fwd) for _, fwd, _ in records], out=offs[1:])
            meta = json.dumps([(header, length)
                               for header, _, length in records]).encode()
            buf = io.BytesIO()
            np.savez(buf, payload=payload, offs=offs,
                     meta=np.frombuffer(meta, np.uint8))
            _atomic_write(self._parse_path(file_hash, k), buf.getvalue())
            self.enforce_budget()
        except Exception:  # noqa: BLE001 — cache writes never fail the run
            pass

    # ---- whole-input repair cache ----

    def load_repair_ends(self, combined_hash: str, k: int, n_seqs: int
                         ) -> Optional[np.ndarray]:
        """[n_seqs, 2, k-1] uint8 repaired end bytes (start window, end
        window) for this exact input set, or None."""
        path = self._repair_path(combined_hash, k)
        try:
            with np.load(path, allow_pickle=False) as z:
                ends = z["ends"]
        except Exception:  # noqa: BLE001
            _count("repair_misses")
            return None
        if ends.shape != (n_seqs, 2, k - 1):
            _count("repair_misses")
            return None
        _count("repair_hits")
        self._touch(path)
        return ends

    def store_repair_ends(self, combined_hash: str, k: int,
                          ends: np.ndarray) -> None:
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            buf = io.BytesIO()
            np.savez(buf, ends=ends)
            _atomic_write(self._repair_path(combined_hash, k), buf.getvalue())
            self.enforce_budget()
        except Exception:  # noqa: BLE001
            pass

    # ---- per-contig minimizer-sketch cache ----

    def load_sketch(self, seq_hash: str, k: int, w: int, s: int
                    ) -> Optional[Tuple[np.ndarray, int]]:
        """A contig's cached bottom-s minimizer sketch ``(sketch, m)`` —
        length-s uint32 sorted vector plus valid count — keyed by the
        sha256 of its forward bytes and the (k, w, s) sketch parameters,
        or None on a miss. Any byte or parameter change misses by
        construction."""
        path = self._sketch_path(seq_hash, k, w, s)
        try:
            with np.load(path, allow_pickle=False) as z:
                sketch = z["sketch"]
                m = int(z["m"])
        except Exception:  # noqa: BLE001 — missing/corrupt entry == miss
            _count("sketch_misses")
            return None
        if sketch.shape != (s,) or sketch.dtype != np.uint32 \
                or not 0 <= m <= s:
            _count("sketch_misses")
            return None
        _count("sketch_hits")
        self._touch(path)
        return sketch, m

    def store_sketches(self, k: int, w: int, s: int, entries) -> None:
        """Stores each ``(seq_hash, sketch, m)`` of one cluster run (the
        JAX package stores them one at a time, as ``store_sketch``), then
        enforces the budget once: a sweep of the directory per entry would
        cost more than the hashing the entries save."""
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            for seq_hash, sketch, m in entries:
                buf = io.BytesIO()
                np.savez(buf, sketch=np.asarray(sketch, np.uint32),
                         m=np.int64(m))
                _atomic_write(self._sketch_path(seq_hash, k, w, s),
                              buf.getvalue())
            self.enforce_budget()
        except Exception:  # noqa: BLE001 — cache writes never fail the run
            pass


def open_cache(autocycler_dir) -> Optional[EncodeCache]:
    """The encode cache for ``autocycler_dir``, or None when disabled.
    A shared cache directory (``AUTOCYCLER_CACHE_DIR``) overrides the
    per-dir location."""
    if not cache_enabled():
        return None
    shared = shared_cache_dir()
    if shared is not None:
        cache = EncodeCache(shared)
    elif autocycler_dir is None:
        return None
    else:
        cache = EncodeCache(Path(autocycler_dir) / ".cache")
    if cache.dir.is_dir():
        _sweep_stale_tmps(cache.dir)
    return cache


def purge_cache(target) -> Tuple[int, int]:
    """Delete every entry of a warm-start cache: ``target`` may be an
    autocycler dir (its ``.cache`` subdirectory is purged) or a cache
    directory itself. Returns (files removed, bytes reclaimed); missing
    directories purge nothing. Only cache artifact files are touched —
    the directory and anything unrecognised stay."""
    target = Path(target)
    cache_dir = target / ".cache" if (target / ".cache").is_dir() \
        else target
    removed = 0
    reclaimed = 0
    if not cache_dir.is_dir():
        return 0, 0
    for pattern in ("*.npz", "*.npz.tmp*", "*.npz.*.tmp"):
        for path in cache_dir.glob(pattern):
            try:
                size = path.stat().st_size
                path.unlink()
            except OSError:
                continue
            removed += 1
            reclaimed += size
    return removed, reclaimed
