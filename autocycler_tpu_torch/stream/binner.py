"""Pass 1: stream windows chunk by chunk into minimizer-signature bins.

Every k-window of every padded strand is one record. A window's bin is a
pure function of its content: the minimum splitmix64 hash over its
``sig_k``-mers (``ops.sketch``'s ``_kmer_hashes`` and ``_window_minima``,
torch ops on the codes' device), modulo the bin count. Identical k-mers
land in the same bin, so each k-mer group lies wholly in one bin, which is
what lets pass 2 sort bins on their own and the merge rank them exactly.

Per chunk of ``plan.chunk_windows`` windows, the hashes, the minima, the
bin ids and the stable routing sort run on the device; the routed
occurrences and the per-bin run lengths come to the host, where bounded
buffers of ``plan.flush_records`` records a bin are appended to the bin
files when full. Host memory is O(chunk + buffers) whatever the input.

Consecutive windows usually share a minimizer (a super-k-mer), so a flush
encodes each maximal run of consecutive occurrence indices as one
``(start, len)`` RLE pair. A pipelined plan appends on an
:class:`~autocycler_tpu_torch.utils.pool.OrderedSubmitter` lane, so the
next chunk is routed while the previous flush is written; the per-bin
append order is the synchronous one, so the files are the same bytes.
The same plan (chunk and flush sizes) writes the JAX package's bytes.

Dot-padded windows are binned like any others: '.' is symbol 0 of the
5-symbol code space and part of window content, as in the grouping.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
import torch

from ..device import to_host
from ..ops.sketch import _kmer_hashes, _window_minima
from ..utils.pool import OrderedSubmitter
from ..utils.resilience import crash_armed, crash_point, fault_fire
from . import spill
from .planner import StreamPlan
from .spill import RECORD_BYTES, bin_filename, encode_rle, write_manifest


class StreamBinner:
    """Routes one run's window stream into ``plan.n_bins`` on-disk bins
    under ``run_dir``. Feed strand runs in occurrence order (per sequence:
    forward strand then reverse strand), then :meth:`close`: the records of
    every bin are strictly ascending occurrence indices, which pass 2's
    reader checks and its stable sort relies on for ``first_occ``."""

    def __init__(self, run_dir, plan: StreamPlan, k: int):
        self.run_dir = Path(run_dir)
        self.plan = plan
        self.k = int(k)
        self.sig_k = min(plan.sig_k, self.k)
        n = plan.n_bins
        self._bufs: List[List[np.ndarray]] = [[] for _ in range(n)]
        self._buffered = np.zeros(n, np.int64)
        self.counts = np.zeros(n, np.int64)      # WINDOW records per bin
        self.spill_bytes = 0                     # on-disk bytes appended
        self.disk_records = 0                    # on-disk records appended
        self.chunks = 0                          # pass-1 chunks routed
        # serial writer lane: appends stay in submission order while the
        # caller routes the next chunk (None when depth <= 1)
        self._writer = (OrderedSubmitter(1, plan.pipeline_depth)
                        if plan.pipelined else None)
        write_manifest(self.run_dir, self.k, self.sig_k, n,
                       fmt=plan.record_format)

    # ---- pass-1 streaming ----

    def add_run(self, run_codes: torch.Tensor, occ_start: int) -> None:
        """Bins every window of one padded strand run (L + k - 1 codes, a
        uint8 tensor: L windows, occurrence indices occ_start ..
        occ_start + L - 1), in chunks of at most ``plan.chunk_windows``."""
        L = len(run_codes) - self.k + 1
        if L <= 0:
            return
        chunk = max(1, self.plan.chunk_windows)
        w = self.k - self.sig_k + 1
        for lo in range(0, L, chunk):
            hi = min(lo + chunk, L)
            # sig_k-mer hashes for positions lo .. hi-1+k-sig_k, then the
            # sliding minimum over w positions = each window's minimizer
            hashes = _kmer_hashes(run_codes[lo:hi + self.k - 1], self.sig_k)
            bins = _window_minima(hashes, w) % self.plan.n_bins
            sorted_bins, order = torch.sort(bins, stable=True)
            uniq, lens = torch.unique_consecutive(sorted_bins,
                                                  return_counts=True)
            occs = to_host(order + (occ_start + lo), "stream-bin")
            self._route(to_host(uniq, "stream-bin"),
                        to_host(lens, "stream-bin"), occs)
            self.chunks += 1

    def _route(self, uniq: np.ndarray, lens: np.ndarray,
               sorted_occs: np.ndarray) -> None:
        s = 0
        for b, n in zip(uniq.tolist(), lens.tolist()):
            self._bufs[b].append(sorted_occs[s:s + n])
            self._buffered[b] += n
            s += n
            if self._buffered[b] >= self.plan.flush_records:
                self._flush(b)

    def _flush(self, b: int) -> None:
        if not self._bufs[b]:
            return
        occ = np.concatenate(self._bufs[b]).astype(np.int64, copy=False)
        self._bufs[b] = []
        self._buffered[b] = 0
        self.counts[b] += len(occ)      # window count, format-independent
        data = (encode_rle(occ) if self.plan.record_format == 2
                else occ).astype("<i8", copy=False)
        payload = np.ascontiguousarray(data).tobytes()
        path = self.run_dir / bin_filename(b)
        if self._writer is not None:
            self._writer.submit(self._append, path, payload)
        else:
            self._append(path, payload)

    def _append(self, path: Path, payload: bytes) -> None:
        """The disk half of a flush, on the writer lane when the plan is
        pipelined (lane order = submission order). The fault site
        ``stream_write`` fails the append; an armed ``mid-spill-write``
        crash point writes half the payload and kills the process, leaving
        a torn bin in a run dir whose manifest was never sealed, which the
        next compress's orphan sweep removes."""
        if fault_fire("stream_write", path.name) is not None:
            raise OSError(f"fault injection: stream bin write failed: {path}")
        torn = crash_armed("mid-spill-write", path.name)
        with open(path, "ab") as f:
            f.write(payload[: max(1, len(payload) // 2)] if torn
                    else payload)
        crash_point("mid-spill-write", path.name)
        self.spill_bytes += len(payload)
        self.disk_records += len(payload) // RECORD_BYTES \
            // (2 if self.plan.record_format == 2 else 1)
        spill.set_spill_gauge(self.spill_bytes)
        spill.count_spill_bytes(len(payload))

    # ---- finalisation ----

    def abort(self) -> None:
        """Drains the writer lane on the failure path, so that the caller
        can remove the run dir without racing appends in flight."""
        if self._writer is not None:
            try:
                self._writer.drain()
            except OSError:
                pass

    def close(self) -> dict:
        """Flushes every buffer, drains the writer lane, and seals the
        manifest with per-bin WINDOW counts. Returns the spill summary."""
        for b in range(self.plan.n_bins):
            self._flush(b)
        if self._writer is not None:
            self._writer.drain()
        nonempty = int(np.count_nonzero(self.counts))
        windows = int(self.counts.sum())
        write_manifest(self.run_dir, self.k, self.sig_k, self.plan.n_bins,
                       counts=self.counts.tolist(),
                       spill_bytes=self.spill_bytes,
                       fmt=self.plan.record_format)
        return {"bins": nonempty, "n_bins": self.plan.n_bins,
                "records": windows,
                "spill_bytes": int(self.spill_bytes),
                "disk_records": int(self.disk_records),
                "format": int(self.plan.record_format),
                "raw_bytes": windows * RECORD_BYTES,
                "sig_k": int(self.sig_k), "chunks": self.chunks}
