"""Streaming plan: bin count, chunk size and buffer sizes from input stats,
the JAX package's stream/planner.py arithmetic unchanged, so that the same
input, k, worker count and knobs give the same plan, and so the same spill
files. The port merges the bins' ranks in one grouping launch, so it has
no ``merge_parts``.

The two-pass spill pipeline (KMC 2 arXiv:1407.1507 / Gerbil arXiv:1607.06618)
has three memory consumers that share one host budget
(``AUTOCYCLER_STREAM_MEM_MB``):

- pass 1 chunk temporaries: the minimizer signature of the current chunk;
- pass 1 write buffers: one bounded record buffer per on-disk bin;
- pass 2 per-bin sort: the grouping's working set scales with the records
  of the one bin being sorted, so the bin count makes one bin fit.

Everything here is a pure function of (window count, k, workers, knobs).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..utils.env import env_bool, env_int, env_str

# pass-2 per-record working set: the byte starts (8) + order/gid outputs
# (16) + the packed keys (4 bytes per word of 10 symbols)
_SORT_BYTES_BASE = 24
# pass-1 per-window chunk temporaries: polynomial pack + hash + window
# minima + occurrence index + the stable bin sort
_PASS1_BYTES_PER_WINDOW = 48
# the bounded write buffers hold int64 occurrence indices
_RECORD_BYTES = 8


def _sort_bytes_per_record(k: int) -> int:
    return _SORT_BYTES_BASE + 4 * ((k + 9) // 10)


@dataclass(frozen=True)
class StreamPlan:
    """One streamed-grouping run's shape, fixed before pass 1 starts."""

    n_bins: int            # on-disk signature bins
    chunk_windows: int     # pass-1 windows binned per chunk
    flush_records: int     # per-bin buffered records before a disk append
    sig_k: int             # minimizer signature m-mer length
    mem_budget_bytes: int  # the budget the sizes were derived from
    record_format: int = 2     # spill record format: 2 = RLE runs, 1 = raw
    pipeline_depth: int = 2    # outstanding appends / prefetched bin reads

    @property
    def pipelined(self) -> bool:
        """Whether pass-1 appends and pass-2 reads overlap compute."""
        return self.pipeline_depth > 1


def _clamp(value: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(value)))


def plan_stream(total_windows: int, k: int, workers: int = 1) -> StreamPlan:
    """Size bins, chunks and buffers for ``total_windows`` windows of length
    ``k`` under the ``AUTOCYCLER_STREAM_MEM_MB`` budget. ``workers`` divides
    the per-bin budget (W bins' working sets fit together), which grows the
    bin count. ``AUTOCYCLER_STREAM_BINS``, ``_CHUNK`` and ``_FLUSH`` above
    0 override the derived sizes; ``AUTOCYCLER_STREAM_PIPELINE`` sets the
    appends and bin reads in flight (<= 1: synchronous) and
    ``AUTOCYCLER_STREAM_RLE`` the spill record format."""
    total_windows = max(1, int(total_windows))
    workers = max(1, int(workers))
    budget = max(64, env_int("AUTOCYCLER_STREAM_MEM_MB")) << 20

    # pass 2 gets half the budget, split across the concurrent bin sorts
    sort_bytes = _sort_bytes_per_record(k)
    target_bin_records = max(1, (budget // 2) // (sort_bytes * workers))
    n_bins = _clamp(-(-total_windows // target_bin_records), 8, 1024)
    bins_override = env_int("AUTOCYCLER_STREAM_BINS")
    if bins_override > 0:
        n_bins = _clamp(bins_override, 1, 4096)

    # pass 1 chunk temporaries get an eighth of the budget
    chunk = _clamp((budget // 8) // _PASS1_BYTES_PER_WINDOW, 1 << 12, 1 << 22)
    chunk_override = env_int("AUTOCYCLER_STREAM_CHUNK")
    if chunk_override > 0:
        chunk = _clamp(chunk_override, 1, 1 << 24)

    # bounded write buffers get another eighth, split evenly across bins
    flush = _clamp((budget // 8) // (n_bins * _RECORD_BYTES), 256, 1 << 20)
    flush_override = env_int("AUTOCYCLER_STREAM_FLUSH")
    if flush_override > 0:
        flush = _clamp(flush_override, 1, 1 << 22)

    sig_k = _clamp(env_int("AUTOCYCLER_STREAM_SIG_K"), 4, min(k, 27))
    fmt = 2 if env_bool("AUTOCYCLER_STREAM_RLE") else 1
    depth = _clamp(env_int("AUTOCYCLER_STREAM_PIPELINE"), 1, 64)
    return StreamPlan(n_bins=n_bins, chunk_windows=chunk, flush_records=flush,
                      sig_k=sig_k, mem_budget_bytes=budget,
                      record_format=fmt, pipeline_depth=depth)


_MODE_OFF = ("off", "0", "no", "false")


def resolve_stream_mode(total_windows: int, k: int) -> bool:
    """Whether the k-mer grouping streams: ``AUTOCYCLER_STREAM_KMERS`` 'on'
    and 'off' force it; 'auto' (the default, and any other value) streams
    from ``AUTOCYCLER_STREAM_AUTO_WINDOWS`` windows on."""
    mode = env_str("AUTOCYCLER_STREAM_KMERS").lower()
    if mode == "on":
        return True
    if mode in _MODE_OFF:
        return False
    if total_windows <= 0 or k < 2:
        return False
    return total_windows >= env_int("AUTOCYCLER_STREAM_AUTO_WINDOWS")


def resolve_threads(threads) -> int:
    return 1 if threads is None else max(1, int(threads))


def effective_workers(threads: int) -> int:
    """The worker count worth using: no more than the cores, unless
    ``AUTOCYCLER_GROUPING_EXECUTOR`` is set, which takes ``threads`` as
    asked."""
    if env_str("AUTOCYCLER_GROUPING_EXECUTOR"):
        return max(1, threads)
    return max(1, min(threads, os.cpu_count() or 1))
