"""Sequence-end repair: replace dot padding with matching real sequence.

Parity target: reference compress.rs:202-270. Each padded sequence starts and
ends with half_k dots followed/preceded by half_k real bases; the reference
regex-matches that (k-1)-char dotted pattern against every sequence (both
strands) and substitutes the best match, defined as (1) fewest dots,
(2) highest occurrence count, (3) lexicographically first
(find_best_match, compress.rs:239-270). Regex ``find_iter`` yields
non-overlapping matches left-to-right, which we reproduce exactly.

A pattern of h dots + h real bases matches text at offset j iff
text[j+off : j+off+h] equals the h real bases — every match is an occurrence
of a query h-gram. The occurrences come from grouping ALL h-grams of the
5-symbol-encoded texts on the device with the k-mer grouping kernels
(ops/sortnet.py); only each query's matches come back to the host.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import Sequence
from ..utils import reverse_complement_bytes
from .kmers import rank_windows, run_starts


def _best_match_rows(rows: np.ndarray) -> bytes:
    """The reference's find_best_match over a [N, overlap] byte matrix of
    candidates: dedupe with counts, then pick (fewest dots, most frequent,
    lexicographically first)."""
    distinct, counts = np.unique(rows, axis=0, return_counts=True)  # sorted
    dots = (distinct == ord(".")).sum(axis=1)
    order = np.lexsort((np.arange(len(distinct)), -counts, dots))
    return distinct[order[0]].tobytes()


def _matches_by_query_grouped(codes, text_off, text_len, h, q_starts,
                              device=None) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Group every h-window of every text together with the queries, then
    read each query's group: per query, the (text, pos) of its matches in
    (text, pos) order.

    The stable order of the grouping already lists the windows of each group
    in window order, and groups in ascending id, so the windows' part of it
    is the stable sort of the windows by group id: no second sort is
    needed, and the window-sized arrays never leave the device."""
    dev = resolve_device(device)
    win_count = np.asarray(text_len, np.int64) - h + 1
    woff = np.zeros(len(text_len), np.int64)
    woff[1:] = np.cumsum(win_count)[:-1]
    W = int(win_count.sum())
    Q = len(q_starts)

    codes_d = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev)
    all_starts = torch.cat([
        run_starts(text_off, win_count, dev),
        torch.from_numpy(np.asarray(q_starts, np.int64)).to(dev)])
    order, gid_sorted = rank_windows(codes_d, all_starts, h)
    del all_starts
    order = order.long()
    is_win = order < W
    win_order = order[is_win]
    sorted_gid = gid_sorted[is_win]
    query_gid = torch.empty(Q, dtype=gid_sorted.dtype, device=dev)
    query_gid[order[~is_win] - W] = gid_sorted[~is_win]
    del order, gid_sorted, is_win
    lo = torch.searchsorted(sorted_gid, query_gid, side="left")
    hi = torch.searchsorted(sorted_gid, query_gid, side="right")
    counts = hi - lo
    total = int(counts.sum())
    base = torch.cumsum(counts, 0) - counts
    sel = win_order[torch.repeat_interleave(lo - base, counts,
                                            output_size=total)
                    + torch.arange(total, device=dev)]
    woff_d = torch.from_numpy(woff).to(dev)
    wtext = torch.searchsorted(woff_d, sel, right=True) - 1
    wpos = sel - woff_d[wtext]

    wtext = wtext.cpu().numpy()
    wpos = wpos.cpu().numpy()
    bounds = np.zeros(Q + 1, np.int64)
    np.cumsum(counts.cpu().numpy(), out=bounds[1:])
    return [(wtext[bounds[q]:bounds[q + 1]], wpos[bounds[q]:bounds[q + 1]])
            for q in range(Q)]


def sequence_end_repair(sequences: List[Sequence], k_size: int,
                        device=None) -> None:
    """In-place repair of every sequence's dotted ends (compress.rs:202-236).

    Matches are searched in the ORIGINAL (pre-repair) sequences, like the
    reference's cloned all_seqs snapshot (compress.rs:209)."""
    if not sequences:
        return
    h = k_size // 2
    if h == 0:
        return  # k=1: no padding, nothing to repair
    overlap = k_size - 1  # == 2h

    # text layout: per sequence, forward then reverse padded strands
    bufs = []
    text_off_list = []
    total = 0
    for s in sequences:
        for strand_seq in (s.forward_seq, s.reverse_seq):
            text_off_list.append(total)
            bufs.append(strand_seq)
            total += len(strand_seq)
    buf = np.concatenate(bufs)
    text_len = np.array([len(b) for b in bufs], dtype=np.int64)
    text_off = np.array(text_off_list, dtype=np.int64)

    # queries: per sequence, the start core (real bases at [h, 2h) of the
    # forward text) and the end core (real bases at [P-2h, P-h))
    q_starts = []
    for i, s in enumerate(sequences):
        fwd = text_off[2 * i]
        P = len(s.forward_seq)
        q_starts.append(fwd + h)          # start-pattern core (offset h in pattern)
        q_starts.append(fwd + P - 2 * h)  # end-pattern core (offset 0 in pattern)
    q_starts = np.array(q_starts, dtype=np.int64)

    # the buf layout is per sequence (forward, reverse) — exactly what
    # Sequence.encoded_strands caches
    codes = np.concatenate([c for s in sequences for c in s.encoded_strands()])
    by_query = _matches_by_query_grouped(codes, text_off, text_len, h,
                                         q_starts, device)

    def best_candidate(q: int, core_offset: int) -> bytes:
        """Best non-overlapping (k-1)-byte candidate window for query q,
        whose core h-gram sits at ``core_offset`` within the pattern."""
        t_arr, p_arr = by_query[q]
        j_arr = p_arr - core_offset  # pattern start within the text
        valid = (j_arr >= 0) & (j_arr + overlap <= text_len[t_arr])
        t_v = t_arr[valid]
        j_v = j_arr[valid]
        keep = np.empty(len(t_v), dtype=bool)
        prev_text, prev_end = -1, -1
        for idx, (ti, ji) in enumerate(zip(t_v.tolist(), j_v.tolist())):
            if ti == prev_text and ji < prev_end:
                keep[idx] = False  # regex find_iter skips overlapping matches
                continue
            keep[idx] = True
            prev_text, prev_end = ti, ji + overlap
        starts = text_off[t_v[keep]] + j_v[keep]
        rows = buf[starts[:, None] + np.arange(overlap)]
        return _best_match_rows(rows)

    for i, s in enumerate(sequences):
        P = len(s.forward_seq)
        best_start = best_candidate(2 * i, h)
        best_end = best_candidate(2 * i + 1, 0)
        repaired = s.forward_seq.copy()
        repaired[:overlap] = np.frombuffer(best_start, dtype=np.uint8)
        repaired[P - overlap:] = np.frombuffer(best_end, dtype=np.uint8)
        s.forward_seq = repaired
        s.reverse_seq = reverse_complement_bytes(repaired)
