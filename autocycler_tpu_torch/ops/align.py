"""Weighted path-overlap alignment (the trim DP) and global alignment
distance (the resolve DP), as batched torch ops on the device.

Parity target: reference trim.rs:366-507 and resolve.rs:387-418, and the
JAX package's ops/align.py. Both DPs run over unitig-ID paths (signed
ints), weighted by unitig length.

Each DP is one Python loop over the rows of its matrix; a row is a handful
of batched ops over every job at once. The insert recurrence along a row,

    S[i][j] = max(base[i][j], S[i][j-1] - w_j)

becomes a running max with column-weight prefix sums W,

    S[i][j] + W[j] = running_max(base[i][j] + W[j])

(a running min for the distance DP). The overlap DP keeps its scores
doubled, so they are integers, in int64 with a sentinel far below any
reachable score: every job runs on the device whatever its weights, and
the traceback decoded from its packed direction bits equals the host f64
DP's piece for piece. There is no host overlap DP in the port; the exact
host screen (:func:`overlap_may_be_positive`) keeps the jobs that provably
find nothing off the device.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import dp_dispatch

# weights: unitig number -> length, as a dict or a dense number-indexed array
Weights = Union[Dict[int, int], np.ndarray]

GAP = 0
NONE = -1  # the reference uses usize::MAX; -1 is the Python stand-in

# below any doubled score a job can reach (>= -2 * its windows' weight), and
# far enough from the int64 limit that sentinel arithmetic cannot wrap
_NEG_BIG = -(1 << 60)
# bits per packed traceback word, shared by the pack and the decode; 64 bits
# in int64 words: a sum of distinct powers of two, bit 63 included, never
# overflows in any order of summation
WORD_BITS = 64
# cap on one traceback dispatch's packed bits (≈ P·K²/8 bytes): K=5000 jobs
# carry ~3.1 MB each, so dispatches are chunked, and grouped by similar K so
# short jobs never pay a long job's padded K
_TRACEBACK_BITS_BUDGET = 256 << 20


class AlignmentPiece:
    """One column of the overlap alignment (reference trim.rs:329-349)."""

    __slots__ = ("a_unitig", "a_index", "b_unitig", "b_index")

    def __init__(self, a_unitig: int, a_index: int, b_unitig: int, b_index: int):
        self.a_unitig = a_unitig
        self.a_index = a_index
        self.b_unitig = b_unitig
        self.b_index = b_index

    def __eq__(self, other):
        return (self.a_unitig, self.a_index, self.b_unitig, self.b_index) == \
            (other.a_unitig, other.a_index, other.b_unitig, other.b_index)

    def __repr__(self):
        a_u = "GAP" if self.a_unitig == GAP else str(self.a_unitig)
        b_u = "GAP" if self.b_unitig == GAP else str(self.b_unitig)
        a_i = "NONE" if self.a_index == NONE else str(self.a_index)
        b_i = "NONE" if self.b_index == NONE else str(self.b_index)
        return f"{a_u},{a_i},{b_u},{b_i}"


def overlap_may_be_positive(job, max_unitigs: int) -> bool:
    """The exact screen of the overlap DP on the host (the JAX package's
    overlap_alignment, :93-118). A job is (path_a, path_b, weights,
    skip_diagonal). Matches are the only positive score contribution, so a
    job with no equal (a window, b window) pair off the skipped diagonal
    has no positive right-edge score and provably returns []: False. True
    means the DP must run."""
    path_a, path_b, _, skip_diagonal = job
    n = len(path_a)
    k = min(max_unitigs, n)
    if k == 0:
        return False
    pa = np.asarray(path_a, dtype=np.int64)
    pb = np.asarray(path_b, dtype=np.int64)
    a_win = pa[:k]
    b_vals = pb[n - k:]
    common = np.intersect1d(a_win, b_vals)
    if len(common) == 0:
        return False
    if not skip_diagonal:
        return True
    # total equal pairs against equal pairs that sit exactly on the skipped
    # diagonal j == gi - (n-k) + 1, i.e. global b index == gi
    a_sort = np.sort(a_win)
    b_sort = np.sort(b_vals)
    a_counts = np.searchsorted(a_sort, common, side="right") - \
        np.searchsorted(a_sort, common, side="left")
    b_counts = np.searchsorted(b_sort, common, side="right") - \
        np.searchsorted(b_sort, common, side="left")
    total_pairs = int((a_counts.astype(np.int64) * b_counts).sum())
    # column j = gi-(n-k)+1 has global b index gi, and is in range 1..k only
    # for gi in [max(0, n-k), k)
    gi_range = np.arange(max(0, n - k), k)
    diag_pairs = int((pa[gi_range] == pb[gi_range]).sum()) if len(gi_range) else 0
    return total_pairs != diag_pairs


def _traceback_and_identity(pa, pb, n: int, k: int, max_i: int, up_ge,
                            weights: Weights, min_identity: float
                            ) -> List[AlignmentPiece]:
    """Traceback from (max_i, k) to the top edge plus the identity gate
    (reference trim.rs:426-475)."""
    pieces: List[AlignmentPiece] = []
    i, j = max_i, k
    while i > 0 and j > 0:
        gi, gj = i - 1, n - k + j - 1
        if pa[gi] == pb[gj]:
            pieces.append(AlignmentPiece(int(pa[gi]), gi, int(pb[gj]), gj))
            i -= 1
            j -= 1
        elif up_ge(i, j):
            pieces.append(AlignmentPiece(int(pa[gi]), gi, GAP, NONE))
            i -= 1
        else:
            pieces.append(AlignmentPiece(GAP, NONE, int(pb[gj]), gj))
            j -= 1
    if i > 0:
        return []  # traceback must reach the top edge, not the left edge
    pieces.reverse()

    a_len = sum(weights[abs(p.a_unitig)] for p in pieces if p.a_unitig != GAP)
    b_len = sum(weights[abs(p.b_unitig)] for p in pieces if p.b_unitig != GAP)
    mean_length = (a_len + b_len) / 2.0
    matches = sum(weights[abs(p.a_unitig)] for p in pieces
                  if p.a_unitig == p.b_unitig)
    if mean_length == 0 or matches / mean_length < min_identity:
        return []
    return pieces


def _overlap_windows(path_a, path_b, weights, max_unitigs: int):
    """Window extraction for the overlap DP (trim.rs:366-386): the first k
    of a, the last k of b, and their weights."""
    n = len(path_a)
    k = min(max_unitigs, n)
    pa = np.asarray(path_a, dtype=np.int64)
    pb = np.asarray(path_b, dtype=np.int64)
    b_vals = pb[n - k:]
    wa = np.array([weights[abs(int(u))] for u in pa[:k]], dtype=np.int64)
    wcol = np.array([weights[abs(int(u))] for u in b_vals], dtype=np.int64)
    return n, k, pa[:k], b_vals, wa, wcol


def pack_overlap_jobs(jobs, max_unitigs: int, device):
    """Pack (path_a, path_b, weights, skip_diagonal) jobs into padded int64
    tensors on ``device`` for :func:`overlap_screen_traceback`, or None when
    no job has a row. A/B padding is 0, which only ever "matches" at columns
    the DP masks out (path values are nonzero signed ints)."""
    prepared = [_overlap_windows(pa, pb, w, max_unitigs)
                for pa, pb, w, _ in jobs]
    K = max((k for _, k, *_ in prepared), default=0)
    if not jobs or K == 0:
        return None
    P = len(jobs)
    A = np.zeros((P, K), np.int64)
    B = np.zeros((P, K), np.int64)
    WA = np.zeros((P, K), np.int64)
    WC = np.zeros((P, K), np.int64)
    k_arr = np.zeros(P, np.int64)
    n_arr = np.zeros(P, np.int64)
    skip_arr = np.zeros(P, bool)
    for p, ((_, _, _, skip), (n, k, a, b, wa, wcol)) in enumerate(
            zip(jobs, prepared)):
        A[p, :k] = a
        B[p, :k] = b
        WA[p, :k] = wa
        WC[p, :k] = wcol
        k_arr[p] = k
        n_arr[p] = n
        skip_arr[p] = skip
    Wc2 = np.zeros((P, K + 1), np.int64)
    np.cumsum(2 * WC, axis=1, out=Wc2[:, 1:])
    valid_col = np.arange(1, K + 1)[None, :] <= k_arr[:, None]
    arrays = {"A": A, "B": B, "WA": WA, "WC": WC, "Wc2": Wc2, "k": k_arr,
              "jd_off": n_arr - k_arr, "skip": skip_arr, "vcol": valid_col}
    return {name: torch.from_numpy(a).to(device) for name, a in arrays.items()}


def overlap_screen_traceback(arrs):
    """The batched overlap DP with traceback (the JAX package's
    _overlap_screen_scan with emit_traceback): per DP row i=1..K, the
    doubled right-edge score of every job ([K, P] int64) and the packed
    up_ge direction bits ([K, P, W] int64 words of WORD_BITS; bit j-1 of
    row i = S[i-1][j] >= S[i][j-1]) — enough for the host to run the
    traceback without the DP (reference trim.rs:426-461). Rows past a job's
    k repeat its last row."""
    A, B = arrs["A"], arrs["B"]
    WA, WC, Wc2 = arrs["WA"], arrs["WC"], arrs["Wc2"]
    k_j, jd_off, skip, vcol = arrs["k"], arrs["jd_off"], arrs["skip"], arrs["vcol"]
    P, K = A.shape
    W = -(-K // WORD_BITS)
    dev = A.device
    idx = torch.arange(K + 1, device=dev)[None, :]    # the column number
    shift = torch.arange(WORD_BITS, device=dev)
    k_col = k_j[:, None]
    zero_col = torch.zeros((P, 1), dtype=torch.int64, device=dev)
    edges = torch.empty((K, P), dtype=torch.int64, device=dev)
    bits = torch.empty((K, P, W), dtype=torch.int64, device=dev)
    prev = torch.zeros((P, K + 1), dtype=torch.int64, device=dev)  # row 0
    for i in range(1, K + 1):
        wi = WA[:, i - 1:i]
        match2 = torch.where((A[:, i - 1:i] == B) & vcol, 2 * wi, -(wi + WC))
        base = torch.maximum(prev[:, :-1] + match2, prev[:, 1:] - 2 * wi)
        base = torch.where(vcol, base, _NEG_BIG)
        X = torch.cat([zero_col, base + Wc2[:, 1:]], dim=1)
        # the skipped diagonal cell jd restarts the insert chain: the row is
        # two running maxes, over columns < jd and > jd, with jd itself at
        # the sentinel (torch has no segmented cummax); a job without a
        # diagonal cell in range gets jd past the end, one running max
        jd = torch.where(skip, i - jd_off, 0)[:, None]
        jd = torch.where((jd >= 1) & (jd <= k_col), jd, K + 1)
        before, after = idx < jd, idx > jd
        left = torch.cummax(torch.where(before, X, _NEG_BIG), dim=1).values
        right = torch.cummax(torch.where(after, X, _NEG_BIG), dim=1).values
        run = torch.where(before, left, torch.where(after, right, _NEG_BIG))
        row = torch.clamp_min(run - Wc2, _NEG_BIG)
        row[:, 0] = 0
        row = torch.where((i <= k_j)[:, None], row, prev)
        edges[i - 1] = row.gather(1, k_col)[:, 0]
        ge = F.pad((prev[:, 1:] >= row[:, :-1]).long(), (0, W * WORD_BITS - K))
        bits[i - 1] = (ge.view(P, W, WORD_BITS) << shift).sum(dim=-1)
        prev = row
    return edges, bits


def decode_overlap_alignment(path_a, path_b, weights: Weights,
                             min_identity: float, max_unitigs: int,
                             edges_col: np.ndarray, bits_col: np.ndarray
                             ) -> List[AlignmentPiece]:
    """Host decode of the device DP's packed traceback for ONE job: pick the
    best right-edge row (numpy's argmax takes the first, so the smallest row
    wins ties, like the reference's strict > scan), walk the packed up_ge
    bits, apply the top-edge and identity gates.

    edges_col: [>=k] doubled right-edge scores for rows 1..k;
    bits_col: [>=k, W] packed up_ge words for rows 1..k (bit j-1 = up_ge at
    column j)."""
    n = len(path_a)
    k = min(max_unitigs, n)
    if k == 0:
        return []
    pa = np.asarray(path_a, dtype=np.int64)
    pb = np.asarray(path_b, dtype=np.int64)
    max_i = int(np.argmax(edges_col[:k])) + 1
    if not int(edges_col[max_i - 1]) > 0:
        return []

    def up_ge(i: int, j: int) -> bool:
        word = int(bits_col[i - 1, (j - 1) // WORD_BITS])
        return bool((word >> ((j - 1) % WORD_BITS)) & 1)

    return _traceback_and_identity(pa, pb, n, k, max_i, up_ge, weights,
                                   min_identity)


def overlap_tracebacks_batch(jobs, max_unitigs: int, min_identity: float,
                             device) -> List[List[AlignmentPiece]]:
    """The overlap DP with packed traceback for many jobs on ``device``: the
    decoded alignment pieces of each job (possibly []), equal to the host
    f64 DP's. Jobs are grouped by power-of-two K class and chunked so one
    dispatch's bits stay under ~256 MB; each chunk's edges and bits come to
    the host in one copy each."""
    results: List[List[AlignmentPiece]] = [[] for _ in jobs]
    k_of = [min(max_unitigs, len(job[0])) for job in jobs]
    # padded K within a chunk is at most 2x any member's k
    chunks: List[List[int]] = []
    cur_class = -1
    for i in sorted(range(len(jobs)), key=k_of.__getitem__):
        cls = (max(k_of[i], 1) - 1).bit_length()
        kmax = 1 << cls
        per_job = kmax * -(-kmax // WORD_BITS) * (WORD_BITS // 8)
        if not chunks or cls != cur_class or \
                (len(chunks[-1]) + 1) * per_job > _TRACEBACK_BITS_BUDGET:
            chunks.append([i])
            cur_class = cls
        else:
            chunks[-1].append(i)

    for chunk in chunks:
        arrs = pack_overlap_jobs([jobs[i] for i in chunk], max_unitigs, device)
        if arrs is None:
            continue
        P, K = arrs["A"].shape
        with dp_dispatch("trim_overlap_dp", arrs["A"].device, rows=K, jobs=P,
                         cells=P * K * K,
                         bits_bytes=K * P * -(-K // WORD_BITS) * (WORD_BITS // 8)):
            edges, bits = overlap_screen_traceback(arrs)
            edges = edges.cpu().numpy()
            bits = bits.cpu().numpy()
        for p, i in enumerate(chunk):
            path_a, path_b, weights, _ = jobs[i]
            results[i] = decode_overlap_alignment(
                path_a, path_b, weights, min_identity, max_unitigs,
                edges[:, p], bits[:, p, :])
    return results


def find_midpoint(alignment: List[AlignmentPiece], weights: Weights) -> int:
    """Index of the match column whose cumulative weight is closest to the
    alignment's weighted midpoint (reference trim.rs:482-507)."""
    total = 0
    for p in alignment:
        if p.a_unitig != GAP:
            total += weights[abs(p.a_unitig)]
        if p.b_unitig != GAP:
            total += weights[abs(p.b_unitig)]
    cumulative = 0
    best_index, best_closeness = 0, 1.0
    for i, p in enumerate(alignment):
        if p.a_unitig != GAP:
            cumulative += weights[abs(p.a_unitig)]
        if p.b_unitig != GAP:
            cumulative += weights[abs(p.b_unitig)]
        closeness = abs(0.5 - cumulative / total)
        if p.a_unitig == p.b_unitig and closeness < best_closeness:
            best_index, best_closeness = i, closeness
    return best_index


def global_alignment_distance_batch(pairs, weights: Weights,
                                    device) -> np.ndarray:
    """Many weighted global-alignment (Needleman-Wunsch) distances in one
    padded DP on ``device`` (reference resolve.rs:387-418: match 0,
    mismatch max(w_a, w_b), indel w; the minimum total distance), one row
    of min-plus ops a step, with ``torch.cummin`` for the prefix scan of
    the insert recurrence. Resolve's medoid selection."""
    P = len(pairs)
    if P == 0:
        return np.zeros(0, np.int64)
    n_len = np.array([len(a) for a, _ in pairs], dtype=np.int64)
    m_len = np.array([len(b) for _, b in pairs], dtype=np.int64)
    n_max = max(int(n_len.max()), 1)
    m_max = max(int(m_len.max()), 1)
    A = np.zeros((P, n_max), np.int64)
    B = np.zeros((P, m_max), np.int64)
    WA = np.zeros((P, n_max), np.int64)
    WB = np.zeros((P, m_max), np.int64)
    for p, (a, b) in enumerate(pairs):
        A[p, :len(a)] = a
        B[p, :len(b)] = b
        WA[p, :len(a)] = [weights[abs(int(u))] for u in a]
        WB[p, :len(b)] = [weights[abs(int(u))] for u in b]
    Wb = np.zeros((P, m_max + 1), np.int64)
    np.cumsum(WB, axis=1, out=Wb[:, 1:])

    dev = torch.device(device)
    with dp_dispatch("resolve_medoid_dp", dev, rows=n_max, pairs=P,
                     cells=P * n_max * m_max):
        A_t, B_t, WA_t, WB_t, Wb_t = (torch.from_numpy(x).to(dev)
                                      for x in (A, B, WA, WB, Wb))
        n_t = torch.from_numpy(n_len).to(dev)
        prev = Wb_t.clone()                         # row 0: gaps in A
        for i in range(n_max):
            wi = WA_t[:, i:i + 1]
            mismatch = torch.where(A_t[:, i:i + 1] == B_t, 0,
                                   torch.maximum(wi, WB_t))
            base = torch.minimum(prev[:, :-1] + mismatch, prev[:, 1:] + wi)
            left = prev[:, :1] + wi
            # S[j] = min(base[j], S[j-1] + wb[j])  ->  min-plus prefix scan
            run = torch.cummin(torch.cat([left, base - Wb_t[:, 1:]], dim=1),
                               dim=1).values
            row = torch.cat([left, run[:, 1:] + Wb_t[:, 1:]], dim=1)
            prev = torch.where((i < n_t)[:, None], row, prev)
        out = prev.gather(1, torch.from_numpy(m_len).to(dev)[:, None])[:, 0]
        return out.cpu().numpy()

