"""Pass 1: stream windows in batches of plan chunks into minimizer-signature
bins.

Every k-window of every padded strand is one record. A window's bin is a
pure function of its content: the minimum splitmix64 hash over its
``sig_k``-mers (``ops.sketch``'s ``_kmer_hashes`` and ``_window_minima``,
torch ops on the codes' device), modulo the bin count. Identical k-mers
land in the same bin, so each k-mer group lies wholly in one bin, which is
what lets pass 2 sort bins on their own and the merge rank them exactly.

The reference rule (the JAX package's binner) routes each chunk of
``plan.chunk_windows`` windows in turn: a bin's part of the chunk is
appended to its buffer, and a bin whose buffer holds ``plan.flush_records``
records or more is flushed to its file; ``close`` flushes every bin. This
binner gives the same files by working a batch of up to
:data:`BATCH_CHUNKS` plan chunks at a time on the device:

1. each chunk's bin ids are computed on the device, and one stable sort by
   (bin, chunk) puts every bin's records, the buffer carried from the last
   batch first, in feed order;
2. the count matrix C[bin, chunk] (with the runs of consecutive
   occurrences each cell holds) comes to the host in one small copy, where
   the flush rule is applied to it, vectorised over the bins: it gives
   each bin's cut points;
3. on the device, a flushed bin's records are run-encoded (format 2:
   consecutive windows usually share a minimizer, a super-k-mer, so each
   maximal run of consecutive occurrences is one ``(start, len)`` pair,
   broken at every cut) or kept raw (format 1), and come to the host in
   one copy; the records after a bin's last cut stay on the device as the
   next batch's buffer, at most ``flush_records`` a bin;
4. one job on an :class:`~autocycler_tpu_torch.utils.pool.OrderedSubmitter`
   lane (when the plan is pipelined) appends each flushed bin's payload
   with one write, while the next batch is routed.

A flush's runs never join across a cut, and a bin's flushes keep their
order, so the bytes are the reference's. The host touches no occurrence:
it launches each chunk's hashing, applies the rule with a few array
operations a chunk, and writes. Every batch counts one in
:data:`PASS1_BATCHES_TOTAL`.

Dot-padded windows are binned like any others: '.' is symbol 0 of the
5-symbol code space and part of window content, as in the grouping.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..device import to_host
from ..obs import metrics_registry
from ..ops.sketch import _kmer_hashes, _window_minima
from ..utils.pool import OrderedSubmitter
from ..utils.resilience import crash_armed, crash_point, fault_fire
from . import spill
from .planner import StreamPlan
from .spill import RECORD_BYTES, bin_filename, write_manifest

# plan chunks routed together on the device: at the default plan (1.4 M
# windows a chunk) a batch's transients stay near 2 GB. The appends, one a
# flushed bin a batch, are most of pass 1's time, so fewer batches win
BATCH_CHUNKS = 32

PASS1_BATCHES_TOTAL = "autocycler_stream_pass1_batches_total"


def _ranges(starts: np.ndarray, lens: np.ndarray,
            device: torch.device) -> torch.Tensor:
    """The indices ``starts[i] .. starts[i] + lens[i] - 1`` for every i, in
    order, as an int64 tensor on ``device``, built without a synchronise."""
    total = int(lens.sum())
    shift = torch.from_numpy(starts - (np.cumsum(lens) - lens)).to(device)
    return (torch.repeat_interleave(shift, torch.from_numpy(lens).to(device),
                                    output_size=total)
            + torch.arange(total, device=device))


class _Cuts(NamedTuple):
    """One batch's flushes, by bin (rows) and column."""
    records: np.ndarray   # records of a bin up to and including a column
    total: np.ndarray     # records of each bin in the batch
    flushed: np.ndarray   # records of each bin its flushes write
    forced: np.ndarray    # cuts whose next record starts no run of its own
    runs: np.ndarray      # runs of each bin, cuts included
    pairs: np.ndarray     # runs of each bin its flushes write


def _flush_rule(counts: np.ndarray, starts: np.ndarray, first: np.ndarray,
                flush_records: int, final: bool) -> _Cuts:
    """The reference's flush rule over one batch's cells, vectorised over
    the bins. Cell (b, c) holds bin b's records of column c: c = 0 the
    buffer carried in, c >= 1 the batch's chunks in order; ``starts`` its
    run starts, ``first`` whether its first record starts a run. A bin
    flushes after a column that brings its buffer to ``flush_records``
    records or more; ``final`` flushes what is left, as ``close`` does."""
    n, ncol = counts.shape
    records = np.cumsum(counts, axis=1)
    cut = np.zeros((n, ncol), bool)      # a flush after column c
    buffered = counts[:, 0].copy()
    for c in range(1, ncol):
        buffered += counts[:, c]
        cut[:, c] = buffered >= flush_records
        buffered[cut[:, c]] = 0
    if final:
        cut[:, -1] |= buffered > 0
    # a cut breaks the run at its next record, unless that starts one
    ahead = np.ones((n, ncol), bool)     # the next nonempty cell's flag
    flag = np.ones(n, bool)
    for c in range(ncol - 1, -1, -1):
        ahead[:, c] = flag
        flag = np.where(counts[:, c] > 0, first[:, c].astype(bool), flag)
    forced = cut & ~ahead
    has_cut = cut.any(axis=1)
    last = np.where(has_cut, ncol - 1 - np.argmax(cut[:, ::-1], axis=1), -1)
    cols = np.arange(ncol)
    return _Cuts(
        records=records, total=records[:, -1],
        flushed=np.where(has_cut, records[np.arange(n), last], 0),
        forced=forced, runs=starts.sum(axis=1) + forced.sum(axis=1),
        pairs=((starts * (cols <= last[:, None])).sum(axis=1)
               + (forced & (cols < last[:, None])).sum(axis=1)))


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
        # plan chunks waiting for the next batch: (codes, first occurrence)
        self._queue: List[Tuple[torch.Tensor, int]] = []
        # the buffers carried between batches, on the device, in bin order:
        # (occurrences, bins)
        self._carry = None
        self.counts = np.zeros(n, np.int64)      # WINDOW records per bin
        self.spill_bytes = 0                     # on-disk bytes appended
        self.disk_records = 0                    # on-disk records appended
        self.chunks = 0                          # pass-1 plan chunks routed
        self.batches = 0                         # device batches of chunks
        self.appends = 0                         # bin appends submitted
        # serial writer lane: appends stay in submission order while the
        # caller routes the next batch (None when depth <= 1)
        self._writer = (OrderedSubmitter(1, plan.pipeline_depth)
                        if plan.pipelined else None)
        write_manifest(self.run_dir, self.k, self.sig_k, n,
                       fmt=plan.record_format)

    # ---- pass-1 streaming ----

    def add_run(self, run_codes: torch.Tensor, occ_start: int) -> None:
        """Queues every window of one padded strand run (L + k - 1 codes, a
        uint8 tensor: L windows, occurrence indices occ_start ..
        occ_start + L - 1), in plan chunks of at most
        ``plan.chunk_windows``; a full queue is routed as one batch."""
        L = len(run_codes) - self.k + 1
        if L <= 0:
            return
        chunk = max(1, self.plan.chunk_windows)
        for lo in range(0, L, chunk):
            if len(self._queue) >= BATCH_CHUNKS:
                self._batch(final=False)
            hi = min(lo + chunk, L)
            self._queue.append((run_codes[lo:hi + self.k - 1],
                                occ_start + lo))
            self.chunks += 1

    def _batch(self, final: bool) -> None:
        """Routes the queued chunks after the carried buffers, flushes what
        the reference rule flushes (every bin when ``final``), and keeps
        the rest on the device."""
        queue, self._queue = self._queue, []
        if not queue and self._carry is None:
            return
        dev = queue[0][0].device if queue else self._carry[0].device
        socc, sbin, brk, cells = self._route(queue, dev)
        cut = _flush_rule(*cells, self.plan.flush_records, final)
        seg = np.cumsum(cut.total) - cut.total   # each bin's first index

        # the records after each bin's last cut stay for the next batch
        keep = cut.total - cut.flushed
        if keep.any():
            idx = _ranges(seg + cut.flushed, keep, dev)
            self._carry = (socc[idx], sbin[idx])
        else:
            self._carry = None
        self.batches += 1
        metrics_registry.counter_inc(
            PASS1_BATCHES_TOTAL, 1,
            help="device batches of plan chunks routed by stream pass 1")
        if not cut.flushed.any():
            return

        # encode the flushed records and copy them to the host at once
        if self.plan.record_format == 2:
            b, c = np.nonzero(cut.forced)
            brk[torch.from_numpy(seg[b] + cut.records[b, c]).to(dev)] = True
            run_of = torch.cumsum(brk, 0)    # run id + 1 of each record
            ids = _ranges(np.cumsum(cut.runs) - cut.runs, cut.pairs, dev)
            lo = torch.searchsorted(run_of, ids + 1)
            hi = torch.searchsorted(run_of, ids + 2)
            payload = torch.stack([socc[lo], hi - lo], dim=1).reshape(-1)
            sizes = 2 * cut.pairs
        else:
            payload = socc[_ranges(seg, cut.flushed, dev)]
            sizes = cut.flushed
        data = to_host(payload, "stream-bin").astype("<i8", copy=False)
        self.counts += cut.flushed      # window counts, format-independent
        ends = np.cumsum(sizes)
        jobs = [(self.run_dir / bin_filename(int(b)),
                 int(ends[b] - sizes[b]), int(ends[b]))
                for b in np.flatnonzero(cut.flushed)]
        self.appends += len(jobs)
        if self._writer is not None:
            self._writer.submit(self._write, data, jobs)
        else:
            self._write(data, jobs)

    def _route(self, queue, dev):
        """The device half of a batch: every record of the carried buffers
        (column 0) and of the queued chunks (column 1 + c) sorted stably by
        (bin, column), so that each bin's records keep their feed order.
        Returns the sorted occurrences and bins, the run-break flags (where
        the bin changes or an occurrence is not its predecessor + 1) and,
        copied to the host, the cells' counts, run starts and first-record
        flags, each (n_bins, columns)."""
        n, ncol = self.plan.n_bins, len(queue) + 1
        w = self.k - self.sig_k + 1
        keys, occs = [], []
        if self._carry is not None:
            occs.append(self._carry[0])
            keys.append(self._carry[1] * ncol)
        for col, (codes, occ0) in enumerate(queue, start=1):
            bins = _window_minima(_kmer_hashes(codes, self.sig_k), w) % n
            keys.append((bins * ncol + col).to(torch.int32))
            occs.append(torch.arange(occ0, occ0 + len(bins), device=dev))
        skey, order = torch.sort(torch.cat(keys), stable=True)
        del keys
        socc = torch.cat(occs)[order]
        del occs, order
        N = len(socc)
        sbin = torch.div(skey, ncol, rounding_mode="floor")
        brk = torch.ones(N, dtype=torch.bool, device=dev)
        brk[1:] = (sbin[1:] != sbin[:-1]) | (socc[1:] != socc[:-1] + 1)
        bounds = torch.searchsorted(
            skey, torch.arange(n * ncol + 1, dtype=torch.int32, device=dev))
        del skey
        starts_before = torch.nn.functional.pad(torch.cumsum(brk, 0), (1, 0))
        cells = to_host(torch.stack([
            bounds[1:] - bounds[:-1],
            starts_before[bounds[1:]] - starts_before[bounds[:-1]],
            brk[bounds[:-1].clamp(max=N - 1)].to(torch.int64)]),
            "stream-bin").reshape(3, n, ncol)
        return socc, sbin, brk, cells

    def _write(self, data: np.ndarray, jobs) -> None:
        """A batch's appends, one a flushed bin, in bin order, straight from
        the host copy."""
        for path, lo, hi in jobs:
            self._append(path, memoryview(data[lo:hi]).cast("B"))

    def _append(self, path: Path, payload) -> None:
        """The disk half of a bin's flushes in one batch (a bytes-like
        payload), on the writer lane when the plan is pipelined (lane order
        = submission order). The fault site ``stream_write`` fails the
        append; an armed ``mid-spill-write`` crash point writes half the
        payload and kills the process, leaving a torn bin in a run dir
        whose manifest was never sealed, which the next compress's orphan
        sweep removes."""
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
        """Routes the last batch, flushing every buffer, drains the writer
        lane, and seals the manifest with per-bin WINDOW counts. Returns
        the spill summary."""
        self._batch(final=True)
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
