"""The two-pass streamed grouping driver.

Gives the exact ``(gid, order, depth, first_occ)`` of the in-memory
grouping over every window of every strand (the same lexicographic ranks,
the same stable order within a group, int64 on the host) without sorting
the whole window set at once:

1. pass 1 (:class:`.binner.StreamBinner`) spills RLE occurrence records
   into minimizer-signature bins under the run's ``.stream`` dir, hashing
   and routing each chunk on the device, with disk appends overlapping the
   next chunk on the writer lane;
2. pass 2 (:mod:`.sorter`) groups each bin with the grouping kernel, in
   bin order on one device stream, while the next bins' disk reads and
   decodes run ahead on the pool (more of them with more workers). A bin
   the reader finds corrupt raises :class:`SpillError`, and the caller
   groups in memory instead;
3. the merge (:mod:`.merge`) ranks the bins' representatives globally,
   and the stitch scatters every bin's groups into the M-sized outputs on
   the device, a bounded run of whole bins at a time.

Bins are read, sorted and stitched in bin order, the writer lane keeps the
per-bin append order, and the stitch writes each position once: the
output is the same at every pipeline depth and worker count.

The spill's posture is in the metrics registry under the JAX package's
names: ``autocycler_stream_spill_bytes`` (a gauge, live at every append,
0 once the run dir is removed), ``_spill_bytes_total``, ``_rle_ratio``
(raw int64 bytes over the bytes on disk), ``_bins_total``,
``_quarantined_bins_total`` and ``_orphans_swept_total``; ``top`` draws
its Spill line from them.
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from .. import device as _device
from ..obs import ledger, metrics_registry
from ..ops.sortnet import KERNEL
from ..utils.pool import prefetch_iter
from ..utils.resilience import SpillError
from ..utils.timing import substage
from . import spill
from .binner import StreamBinner
from .merge import merge_ranks
from .planner import (StreamPlan, effective_workers, plan_stream,
                      resolve_threads)
from .sorter import sort_bin

BINS_TOTAL = "autocycler_stream_bins_total"
QUARANTINED_BINS_TOTAL = "autocycler_stream_quarantined_bins_total"
RLE_RATIO_GAUGE = "autocycler_stream_rle_ratio"


def _launches() -> int:
    return _device.launches[KERNEL]


def stream_group_windows_stats(codes: torch.Tensor, seq_len: np.ndarray,
                               fwd_byte_off: np.ndarray,
                               rev_byte_off: np.ndarray,
                               occ_off: np.ndarray, k: int, threads=None,
                               plan: StreamPlan = None
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
    """The streamed equivalent of ``group_windows_stats`` over every window
    of every strand, on ``codes``' device (a uint8 tensor of the
    concatenated padded strands). Raises :class:`SpillError`, or OSError
    from the spill layer, on a spill it cannot trust; the caller then
    groups in memory."""
    dev = codes.device
    S = len(seq_len)
    M = int(2 * np.sum(seq_len))
    workers = effective_workers(resolve_threads(threads))
    if plan is None:
        plan = plan_stream(M, k, workers=workers)
    layout = tuple(torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                   for a in (seq_len, fwd_byte_off, rev_byte_off, occ_off))
    root = spill.stream_root()
    temp_root = None
    if root is None:
        # library callers without compress's wiring stream into a tempdir,
        # removed with the run dir below
        temp_root = Path(tempfile.mkdtemp(prefix="autocycler-stream-"))
        root = temp_root
    root.mkdir(parents=True, exist_ok=True)
    run_dir = spill.new_run_dir(root)
    binner = None
    try:
        # ---- pass 1: signature binning with bounded buffers ----
        with substage("stream-bin"):
            binner = StreamBinner(run_dir, plan, k)
            for i in range(S):
                L = int(seq_len[i])
                fo, ro = int(fwd_byte_off[i]), int(rev_byte_off[i])
                base = int(occ_off[i])
                binner.add_run(codes[fo:fo + L + k - 1], base)
                binner.add_run(codes[ro:ro + L + k - 1], base + L)
            summary = binner.close()
        spill.set_spill_gauge(summary["spill_bytes"])
        rle_ratio = (summary["raw_bytes"] / summary["spill_bytes"]
                     if summary["spill_bytes"] else 0.0)
        metrics_registry.gauge_set(
            RLE_RATIO_GAUGE, rle_ratio,
            help="raw int64 spill bytes over on-disk (RLE) spill bytes")
        metrics_registry.counter_inc(
            BINS_TOTAL, summary["bins"],
            help="stream spill bins written by pass 1")
        ledger.record_stage("stream-spill", bins=summary["bins"],
                            n_bins=summary["n_bins"],
                            records=summary["records"],
                            spill_bytes=summary["spill_bytes"],
                            disk_records=summary["disk_records"],
                            record_format=summary["format"],
                            rle_ratio=round(rle_ratio, 2),
                            pipeline_depth=plan.pipeline_depth,
                            workers=workers,
                            sig_k=summary["sig_k"],
                            mem_budget_mb=plan.mem_budget_bytes >> 20)

        # ---- pass 2: per-bin grouping, reads ahead of the sorts ----
        fmt = int((spill.read_manifest(run_dir) or {}).get("format", 1))
        todo = [b for b in range(plan.n_bins) if int(binner.counts[b])]

        def _read(b):
            return b, *spill.read_bin_records(
                run_dir / spill.bin_filename(b),
                expected=int(binner.counts[b]), fmt=fmt)

        groups = []
        launches0 = _launches()
        with substage("stream-sort"):
            # one device stream sorts the bins in order; the workers read
            # and decode the next bins meanwhile. A bad bin is quarantined
            # here, in bin order: a read still in flight when the run dir
            # goes is never counted
            depth_ahead = plan.pipeline_depth if plan.pipelined else 1
            reads = prefetch_iter(_read, todo, workers + depth_ahead,
                                  depth=depth_ahead + workers - 1)
            for b, occ, reason in reads:
                if occ is None:
                    metrics_registry.counter_inc(
                        QUARANTINED_BINS_TOTAL, 1,
                        help="stream bins quarantined as corrupt in pass 2")
                    raise SpillError(f"bin {b} quarantined: {reason}")
                groups.append(sort_bin(codes, torch.from_numpy(occ).to(dev),
                                       layout, k))
        launches1 = _launches()

        # ---- merge: bin-local ranks -> global lexicographic ranks ----
        with substage("stream-merge"):
            rep_starts = torch.cat([g.rep_start for g in groups]) if groups \
                else torch.zeros(0, dtype=torch.int64, device=dev)
            grank = merge_ranks(codes, rep_starts, k)
            del rep_starts
        launches2 = _launches()

        # ---- stitch: scatters into the M-sized outputs, over runs of
        # whole bins so that the transients stay a bounded slice of M ----
        with substage("stream-stitch"):
            gid, order, depth, first_occ = _stitch(groups, grank, M, plan)
        spill.last_run.clear()
        spill.last_run.update(
            summary, rle_ratio=rle_ratio, pipeline_depth=plan.pipeline_depth,
            workers=workers, mem_budget_mb=plan.mem_budget_bytes >> 20,
            chunk_windows=plan.chunk_windows,
            flush_records=plan.flush_records, representatives=len(depth),
            sort_launches=launches1 - launches0,
            merge_launches=launches2 - launches1)
        return gid, order, depth, first_occ
    finally:
        if binner is not None:
            binner.abort()      # never leave lane appends racing the rmtree
        shutil.rmtree(run_dir, ignore_errors=True)
        if temp_root is not None:
            shutil.rmtree(temp_root, ignore_errors=True)
        spill.set_spill_gauge(0)


def _stitch(groups, grank: torch.Tensor, M: int, plan: StreamPlan):
    """Every bin's groups scattered to their global ranks, on the device;
    ``groups`` is consumed. Returns host int64 (gid, order, depth,
    first_occ)."""
    dev = grank.device
    U = len(grank)
    depth = torch.empty(U, dtype=torch.int64, device=dev)
    first_occ = torch.empty(U, dtype=torch.int64, device=dev)
    u0 = 0
    for g in groups:                # U-scale pass: rank-scatter the stats
        r = grank[u0:u0 + len(g.depth)]
        depth[r] = g.depth
        first_occ[r] = g.first_occ
        u0 += len(g.depth)
    group_start = torch.nn.functional.pad(torch.cumsum(depth, 0), (1, 0))
    gid = torch.empty(M, dtype=torch.int64, device=dev)
    order = torch.empty(M, dtype=torch.int64, device=dev)
    # ~3 int64 transients per window of a run of bins (occ, pos, repeat)
    cap = max(1 << 20, plan.mem_budget_bytes // (24 * 8))
    i, u0 = 0, 0
    while i < len(groups):
        j, wins, nu = i, 0, 0
        while j < len(groups) and (
                j == i or wins + len(groups[j].occ_sorted) <= cap):
            wins += len(groups[j].occ_sorted)
            nu += len(groups[j].depth)
            j += 1
        occ_c = torch.cat([groups[t].occ_sorted for t in range(i, j)])
        dep_c = torch.cat([groups[t].depth for t in range(i, j)])
        for t in range(i, j):       # bins are consumed: free them now
            groups[t] = None
        r = grank[u0:u0 + nu]
        concat_start = torch.cumsum(dep_c, 0) - dep_c
        # element w of the run's occurrences belongs to run-order group u;
        # its global position is group_start[r[u]] + (w - concat_start[u])
        pos = (torch.repeat_interleave(group_start[r] - concat_start, dep_c,
                                       output_size=wins)
               + torch.arange(wins, device=dev))
        order[pos] = occ_c
        del pos
        gid[occ_c] = torch.repeat_interleave(r, dep_c, output_size=wins)
        del occ_c
        i, u0 = j, u0 + nu
    groups.clear()
    return tuple(_device.to_host(t, "stream-stitch")
                 for t in (gid, order, depth, first_occ))
