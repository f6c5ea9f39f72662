"""Exact k-mer grouping and the k-mer index, on the device.

The port of the JAX package's ops/kmers.py: the in-memory grouping here,
and the dispatch to the streamed grouping (stream/) above a window count,
as the JAX package dispatches. Every k-window of
every padded sequence (both strands) is grouped by the partition-sort kernels
(ops/sortnet.py, csrc/sortnet.cu): group ids are the windows' lexicographic
ranks, so the reference's sorted k-mer iteration (kmer_graph.rs:168-173)
falls out for free. Per-group depth and first occurrence are a segment count
and a segment min of the stable order, (k-1)-gram ids give De Bruijn
adjacency by integer equality (kmer_graph.rs:136-166), and the adjacency
tables are scatter ops — all on the device, with one download per array.

Tensors stay int32 on the device, as in the JAX package; the host casts
to int64 once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import device_work, resolve_device
from ..utils.timing import substage
from .encode import encode_bytes
from .sortnet import INT32_MAX, pack_rank


def _to_host(t: torch.Tensor, dtype=np.int64) -> np.ndarray:
    return t.cpu().numpy().astype(dtype, copy=False)


def rank_windows(codes: torch.Tensor, starts: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, gid_sorted), int32 on the tensors' device. ``starts`` may be
    any integer dtype; zero-length windows (k == 0, the (k-1)-grams of k=1)
    are all identical."""
    n = len(starts)
    if k == 0:
        return (torch.arange(n, dtype=torch.int32, device=starts.device),
                torch.zeros(n, dtype=torch.int32, device=starts.device))
    return pack_rank(codes, starts.to(torch.int32), k)


def scatter_gid(order: torch.Tensor, gid_sorted: torch.Tensor) -> torch.Tensor:
    """Per-window group ids in original window order."""
    gid = torch.empty_like(gid_sorted)
    gid[order.long()] = gid_sorted
    return gid


def segment_stats(order: torch.Tensor, gid_sorted: torch.Tensor):
    """(depth, first_occ): per group, the occurrence count and the smallest
    window index — a segment count and a segment min of the stable order,
    as the JAX package's _radix_sharded_stats_fn computes them."""
    U = int(gid_sorted[-1]) + 1 if len(gid_sorted) else 0
    g = gid_sorted.long()
    depth = torch.zeros(U, dtype=torch.int32, device=order.device).index_add_(
        0, g, torch.ones_like(order))
    first_occ = torch.full((U,), INT32_MAX, dtype=torch.int32,
                           device=order.device).scatter_reduce_(
        0, g, order, "amin")
    return depth, first_occ


def _upload(codes: np.ndarray, starts: np.ndarray, device):
    dev = resolve_device(device)
    return (torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev),
            torch.from_numpy(np.asarray(starts, np.int64)).to(dev))


def group_windows_full(codes: np.ndarray, starts: np.ndarray, k: int,
                       device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(gid, order): ``gid[i]`` is window i's dense group id (its
    lexicographic rank), ``order`` the stable permutation grouping windows
    by gid."""
    codes_d, starts_d = _upload(codes, starts, device)
    order, gid_sorted = rank_windows(codes_d, starts_d, k)
    return _to_host(scatter_gid(order, gid_sorted)), _to_host(order)


def window_gids(codes: np.ndarray, starts: np.ndarray, k: int,
                device=None) -> torch.Tensor:
    """Per-window dense group ids (int32), left on the device."""
    codes_d, starts_d = _upload(codes, starts, device)
    return scatter_gid(*rank_windows(codes_d, starts_d, k))


def group_windows(codes: np.ndarray, starts: np.ndarray, k: int,
                  device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(order, gid_sorted) view of :func:`group_windows_full`."""
    codes_d, starts_d = _upload(codes, starts, device)
    order, gid_sorted = rank_windows(codes_d, starts_d, k)
    return _to_host(order), _to_host(gid_sorted)


def group_windows_stats(codes: np.ndarray, starts: np.ndarray, k: int,
                        device=None):
    """:func:`group_windows_full` plus per-group statistics:
    (gid, order, depth, first_occ)."""
    codes_d, starts_d = _upload(codes, starts, device)
    order, gid_sorted = rank_windows(codes_d, starts_d, k)
    depth, first_occ = segment_stats(order, gid_sorted)
    return (_to_host(scatter_gid(order, gid_sorted)), _to_host(order),
            _to_host(depth), _to_host(first_occ))


def run_starts(run_start: np.ndarray, run_len: np.ndarray,
               device: torch.device) -> torch.Tensor:
    """Concatenated ``run_start[r] + arange(run_len[r])`` for every run,
    built on the device (int64) without an M-sized host array."""
    run_start = torch.from_numpy(np.asarray(run_start, np.int64)).to(device)
    run_len = torch.from_numpy(np.asarray(run_len, np.int64)).to(device)
    base = torch.cumsum(run_len, 0) - run_len
    total = int(run_len.sum())
    return (torch.repeat_interleave(run_start - base, run_len,
                                    output_size=total)
            + torch.arange(total, device=device))


@dataclass
class KmerIndex:
    """Struct-of-arrays replacement for the reference's KmerGraph
    (kmer_graph.rs:73-182), built by :func:`build_kmer_index` in the JAX
    package's per-occurrence layout.

    Occurrence layout: per input sequence, first its L forward windows
    (window start p = Position.pos on the padded forward strand), then its
    L reverse windows. The partner of forward window p is reverse window
    L-1-p (and vice versa), mirroring how the reference adds each k-mer on
    both strands (kmer_graph.rs:103-133). Arrays are host numpy; ``device``
    is where the later device stages (chain following) run.
    """

    k: int
    half_k: int
    # concatenated padded byte buffer: per sequence, forward then reverse
    buf: np.ndarray
    seq_ids: np.ndarray          # (S,) external sequence ids
    seq_len: np.ndarray          # (S,) unpadded lengths
    fwd_byte_off: np.ndarray     # (S,) offset of forward padded seq in buf
    rev_byte_off: np.ndarray     # (S,)
    occ_off: np.ndarray          # (S,) occurrence-index base (2*L per seq)
    # per unique k-mer (U,):
    depth: np.ndarray            # occurrence count
    rep_byte: np.ndarray         # byte offset in buf of one occurrence's window
    rev_kid: np.ndarray          # (U,) id of the reverse-complement k-mer
    prefix_gid: np.ndarray       # (U,) (k-1)-gram id of the first k-1 bases
    suffix_gid: np.ndarray       # (U,) (k-1)-gram id of the last k-1 bases
    out_count: np.ndarray        # (U,) number of unique k-mers overlapping on the right
    in_count: np.ndarray         # (U,) ... on the left
    succ: np.ndarray             # (U,) the unique right-neighbour when out_count==1
    first_pos: np.ndarray        # (U,) bool: any occurrence at window 0
    # per occurrence (M = 2 * sum(L)):
    occ_kid: np.ndarray          # (M,) k-mer id of every occurrence
    first_occ: np.ndarray        # (U,) smallest occurrence per group
    occ_sorted: np.ndarray       # (M,) occurrences grouped by kid
    group_start: np.ndarray      # (U+1,) boundaries into occ_sorted
    device: torch.device         # where the later device stages run

    # ---- occurrence coordinate helpers (vectorised) ----

    def occ_coords(self, occ: np.ndarray):
        """occurrence indices -> (seq_index, strand(bool), local window pos)."""
        seq_idx = np.searchsorted(self.occ_off, occ, side="right") - 1
        rel = occ - self.occ_off[seq_idx]
        L = self.seq_len[seq_idx]
        strand = rel < L
        pos = np.where(strand, rel, rel - L)
        return seq_idx, strand, pos

    def positions_for_kmers_flat(self, kids: np.ndarray):
        """Occurrences of every requested k-mer, flat: (uniq_kids, offsets,
        seq_idx, strand, pos) where kid ``uniq_kids[i]`` owns rows
        ``offsets[i]:offsets[i+1]`` of the three parallel arrays, in
        occurrence order (seq ascending; forward windows before reverse
        windows within a sequence; position ascending)."""
        kids = np.unique(np.asarray(kids, dtype=np.int64))
        lo = self.group_start[kids]
        counts = self.group_start[kids + 1] - lo
        offsets = np.zeros(len(kids) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        # every requested group's occurrence slice, gathered in one pass
        slot = np.arange(offsets[-1], dtype=np.int64)
        occ = self.occ_sorted[np.repeat(lo - offsets[:-1], counts) + slot]
        seq_idx, strand, pos = self.occ_coords(occ)
        return kids, offsets, seq_idx, strand, pos

    @property
    def num_kmers(self) -> int:
        return len(self.depth)


def adjacency(prefix_gid: torch.Tensor, suffix_gid: torch.Tensor, G: int):
    """Neighbour counts over UNIQUE k-mers (next_kmers/prev_kmers semantics,
    kmer_graph.rs:136-166) by (k-1)-gram id equality, as scatter ops: counts
    by index_add_, the successor table by a scatter-max of ascending k-mer
    ids, which equals numpy's last-write-wins ``succ_by_gram[prefix] =
    arange(U)``. Returns (out_count, in_count, succ) on the device."""
    U = len(prefix_gid)
    dev = prefix_gid.device
    one = torch.ones(U, dtype=torch.int32, device=dev)
    cnt_prefix = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(
        0, prefix_gid, one)
    cnt_suffix = torch.zeros(G, dtype=torch.int32, device=dev).index_add_(
        0, suffix_gid, one)
    succ_by_gram = torch.full((G,), -1, dtype=torch.int64,
                              device=dev).scatter_reduce_(
        0, prefix_gid, torch.arange(U, device=dev), "amax")
    return cnt_prefix[suffix_gid], cnt_suffix[prefix_gid], \
        succ_by_gram[suffix_gid]


def build_kmer_index(sequences, k: int, device=None,
                     threads=None) -> KmerIndex:
    """Build the k-mer index from Sequence objects (padded, with bytes).

    Parity notes: every k-window of every padded sequence on both strands is
    an occurrence (reference kmer_graph.rs:103-133 — exactly L windows per
    strand because the padding is half_k per side); k-mers that would start a
    sequence are flagged (Kmer::first_position, kmer_graph.rs:57-60); right
    and left neighbour counts replace next_kmers/prev_kmers probing
    (kmer_graph.rs:136-166).

    The grouping streams through disk-spill bins (stream/) where the JAX
    package's does: ``AUTOCYCLER_STREAM_KMERS`` on, or auto from
    ``AUTOCYCLER_STREAM_AUTO_WINDOWS`` windows. ``threads`` sizes its plan.
    A spill it cannot trust degrades visibly to the in-memory grouping,
    which gives the same arrays.
    """
    from ..stream import (occ_byte_starts, resolve_stream_mode,
                          stream_group_windows_stats)
    from ..utils.resilience import SpillError, record_degrade

    dev = resolve_device(device)
    half_k = k // 2
    S = len(sequences)
    seq_ids = np.array([s.id for s in sequences], dtype=np.int32)
    seq_len = np.array([s.length for s in sequences], dtype=np.int64)
    for s in sequences:
        # L windows of length k per strand only fit when the padding is
        # exactly half_k per side (len + 2*(k//2) bytes)
        if len(s.forward_seq) != s.length + 2 * half_k:
            raise ValueError(
                f"sequence {s.id} is padded for half_k="
                f"{(len(s.forward_seq) - s.length) // 2}, not k={k}'s "
                f"half_k={half_k}; rebuild it with Sequence.with_seq(..., "
                f"{half_k})")

    bufs, fwd_off, rev_off = [], np.zeros(S, np.int64), np.zeros(S, np.int64)
    total = 0
    for i, s in enumerate(sequences):
        fwd_off[i] = total
        bufs.append(s.forward_seq)
        total += len(s.forward_seq)
        rev_off[i] = total
        bufs.append(s.reverse_seq)
        total += len(s.reverse_seq)
    buf = np.concatenate(bufs) if bufs else np.zeros(0, np.uint8)

    occ_off = np.zeros(S, np.int64)
    if S > 1:
        occ_off[1:] = np.cumsum(2 * seq_len)[:-1]
    M = int(2 * seq_len.sum())
    stream_on = bool(M) and k > 1 and resolve_stream_mode(M, k)

    # per-sequence cached both-strand encodings, in buf's (forward, reverse)
    # per-sequence layout
    strand_codes = []
    for s in sequences:
        enc = getattr(s, "encoded_strands", None)
        if enc is not None:
            fwd_c, rev_c = enc()
        else:               # duck-typed sequence stand-ins in tests
            fwd_c = encode_bytes(s.forward_seq)
            rev_c = encode_bytes(s.reverse_seq)
        strand_codes.append(fwd_c)
        strand_codes.append(rev_c)
    codes = np.concatenate(strand_codes) if strand_codes \
        else encode_bytes(buf)

    def codes_to_device():
        return torch.from_numpy(np.ascontiguousarray(codes)).to(dev)

    # streamed path first when enabled: disk-spill bins bound the grouping's
    # working set; a spill failure (a write error, a quarantined bin, a
    # duplicate representative) degrades VISIBLY to the in-memory grouping.
    # Each path's substage includes the codes' copy to the device.
    stats = codes_d = None
    if stream_on:
        try:
            with substage("stream-kmers"):
                codes_d = codes_to_device()
                stats = stream_group_windows_stats(
                    codes_d, seq_len, fwd_off, rev_off, occ_off, k,
                    threads=threads)
        except (SpillError, OSError) as e:
            record_degrade("stream-kmers", "stream", "in-memory",
                           f"{type(e).__name__}: {e}")
    if stats is not None:
        gid, order, depth, first_occ = stats
        occ_kid = gid.astype(np.int32)
        del gid, stats
        # the streamed path never builds the M-sized starts; the
        # representatives' byte starts follow from the occurrence layout
        rep_byte_d = occ_byte_starts(
            torch.from_numpy(first_occ).to(dev),
            *(torch.from_numpy(a).to(dev)
              for a in (seq_len, fwd_off, rev_off, occ_off)))
    else:
        with substage("k-mer grouping"):
            if codes_d is None:
                codes_d = codes_to_device()
            # byte start of every occurrence window: one run per strand
            starts_d = run_starts(
                np.stack([fwd_off, rev_off], 1).reshape(-1),
                np.repeat(seq_len, 2), dev)
            order_d, gid_sorted_d = rank_windows(codes_d, starts_d, k)
            depth_d, first_occ_d = segment_stats(order_d, gid_sorted_d)
            occ_kid = _to_host(scatter_gid(order_d, gid_sorted_d), np.int32)
            order = _to_host(order_d)
            del order_d, gid_sorted_d
            depth = _to_host(depth_d)
            first_occ = _to_host(first_occ_d)
            rep_byte_d = starts_d[first_occ_d.long()]
            del starts_d
    U = len(depth)
    # occurrences grouped by kid; stable grouping keeps occurrence order
    # inside each group ascending
    group_start = np.zeros(U + 1, np.int64)
    np.cumsum(depth, out=group_start[1:])

    # first-position flag: only the two window-0 occurrences per sequence
    # (forward occ_off[s], reverse occ_off[s] + L) can have pos == 0
    first_pos = np.zeros(U, bool)
    if M:
        window0 = np.concatenate([occ_off, occ_off + seq_len])
        first_pos[occ_kid[window0]] = True

    # reverse-complement partner: partner occurrence of the first occurrence
    seq_idx_f = np.searchsorted(occ_off, first_occ, side="right") - 1
    rel_f = first_occ - occ_off[seq_idx_f]
    L_f = seq_len[seq_idx_f]
    strand_f = rel_f < L_f
    pos_f = np.where(strand_f, rel_f, rel_f - L_f)
    partner = occ_off[seq_idx_f] + np.where(strand_f, L_f + (L_f - 1 - pos_f),
                                            L_f - 1 - pos_f)
    rev_kid = occ_kid[partner]

    # ---- (k-1)-gram ids for adjacency ----
    # Adjacency only ever counts UNIQUE k-mers per gram (next_kmers probes
    # the k-mer set, not occurrences — kmer_graph.rs:136-166), so it
    # suffices to group the 2U gram instances at the unique k-mers'
    # representative windows: the prefix gram starts at the representative
    # byte offset, the suffix gram one byte later.
    with substage("gram grouping"):
        gram_starts = torch.cat([rep_byte_d, rep_byte_d + 1])
        gorder, ggid_sorted = rank_windows(codes_d, gram_starts, k - 1)
        gram_gid = scatter_gid(gorder, ggid_sorted).long()
        G = int(ggid_sorted[-1]) + 1 if len(gram_starts) else 0
        rep_byte = _to_host(rep_byte_d)
    with substage("adjacency"), device_work("adjacency segment ops", dev):
        out_d, in_d, succ_d = adjacency(gram_gid[:U], gram_gid[U:], G)
        prefix_gid = _to_host(gram_gid[:U])
        suffix_gid = _to_host(gram_gid[U:])
        out_count, in_count, succ = _to_host(out_d), _to_host(in_d), \
            _to_host(succ_d)

    return KmerIndex(
        k=k, half_k=half_k, buf=buf, seq_ids=seq_ids, seq_len=seq_len,
        fwd_byte_off=fwd_off, rev_byte_off=rev_off, occ_off=occ_off,
        depth=depth, rep_byte=rep_byte, rev_kid=rev_kid,
        prefix_gid=prefix_gid, suffix_gid=suffix_gid,
        out_count=out_count, in_count=in_count, succ=succ, first_pos=first_pos,
        occ_kid=occ_kid, first_occ=first_occ, occ_sorted=order,
        group_start=group_start, device=dev)
