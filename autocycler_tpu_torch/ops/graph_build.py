"""Assemble a host UnitigGraph from the device k-mer index + chains.

This is the device-side replacement for UnitigGraph::from_kmer_graph
(reference unitig_graph.rs:36-48): chains come from ops.debruijn, unitig
sequences are gathered straight out of the padded input byte buffer (the
moral equivalent of the reference's raw-pointer k-mers, kmer_graph.rs:26-33,
without the unsafe), links are found by (k-1)-gram id equality instead of
hash-map joins (unitig_graph.rs:234-287), and overlap trimming
(unitig_graph.rs:289-293) happens implicitly by slicing half_k off both ends.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..models import PositionArray, Sequence, Unitig, UnitigGraph, UnitigStrand
from ..utils import FORWARD, REVERSE
from ..utils.timing import substage
from .debruijn import Chains, build_chains
from .kmers import KmerIndex, build_kmer_index


def _link_pairs_dict(fwd_start_gram, rev_start_gram, fwd_end_gram,
                     rev_end_gram):
    """Python dict-of-lists link join — the original per-chain formulation,
    kept as the order oracle for :func:`_link_pairs` (the regression test
    asserts triple-for-triple equality, which pins GFA L-line order).
    Returns (src c, tgt j, join kind) triples: kind 0 = a+ -> b+,
    1 = a+ -> b-, 2 = a- -> b+."""
    C = len(fwd_start_gram)
    by_fwd_start: dict = {}
    by_rev_start: dict = {}
    for c in range(C):
        by_fwd_start.setdefault(int(fwd_start_gram[c]), []).append(c)
        by_rev_start.setdefault(int(rev_start_gram[c]), []).append(c)
    out = []
    for c in range(C):
        for j in by_fwd_start.get(int(fwd_end_gram[c]), []):
            out.append((c, j, 0))
        for j in by_rev_start.get(int(fwd_end_gram[c]), []):
            out.append((c, j, 1))
        for j in by_fwd_start.get(int(rev_end_gram[c]), []):
            out.append((c, j, 2))
    return out


def _link_pairs(fwd_start_gram, rev_start_gram, fwd_end_gram, rev_end_gram):
    """Vectorised argsort/searchsorted join over gram ids, replacing the
    per-chain dict loops. Emission order is identical to the dict join by
    construction: a stable argsort of the start grams lists, per gram,
    chain indices ascending (the dict built them ascending); the final
    stable sort on src restores per-chain order with the three join kinds'
    blocks in their original sequence. Returns (src, tgt, kind) arrays."""
    C = len(fwd_start_gram)
    if C == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    ord_f = np.argsort(fwd_start_gram, kind="stable")
    sorted_f = fwd_start_gram[ord_f]
    ord_r = np.argsort(rev_start_gram, kind="stable")
    sorted_r = rev_start_gram[ord_r]

    def join(sorted_keys, ord_, queries):
        lo = np.searchsorted(sorted_keys, queries, side="left")
        hi = np.searchsorted(sorted_keys, queries, side="right")
        cnt = hi - lo
        total = int(cnt.sum())
        off = np.zeros(C + 1, np.int64)
        np.cumsum(cnt, out=off[1:])
        pos = np.repeat(lo, cnt) + (np.arange(total) - np.repeat(off[:-1], cnt))
        return np.repeat(np.arange(C, dtype=np.int64), cnt), ord_[pos]

    src1, tgt1 = join(sorted_f, ord_f, fwd_end_gram)   # a+ -> b+
    src2, tgt2 = join(sorted_r, ord_r, fwd_end_gram)   # a+ -> b-
    src3, tgt3 = join(sorted_f, ord_f, rev_end_gram)   # a- -> b+
    src = np.concatenate([src1, src2, src3])
    tgt = np.concatenate([tgt1, tgt2, tgt3])
    kind = np.concatenate([np.zeros(len(src1), np.int64),
                           np.full(len(src2), 1, np.int64),
                           np.full(len(src3), 2, np.int64)])
    order = np.argsort(src, kind="stable")
    return src[order], tgt[order], kind[order]


def unitig_graph_from_chains(index: KmerIndex, chains: Chains) -> UnitigGraph:
    graph = UnitigGraph(k_size=index.k)
    k, h = index.k, index.half_k

    # last byte of each unique k-mer's window (for chain sequence assembly);
    # any occurrence's bytes are the k-mer itself, so the representative works
    last_byte = index.buf[index.rep_byte + k - 1]

    C = chains.count
    members_all = chains.members
    chain_off = chains.chain_off
    sizes = np.diff(chain_off)
    heads = members_all[chain_off[:-1]] if C else np.zeros(0, np.int64)
    tails = members_all[chain_off[1:] - 1] if C else np.zeros(0, np.int64)
    rev_tails = index.rev_kid[tails].astype(np.int64) if C else heads

    # ---- chain sequences, assembled in one pass over all chains ----
    # untrimmed chain sequence = head k-mer bytes + last byte of each
    # following k-mer; trimming removes half_k from both ends, so trimmed
    # byte i of a chain is the head window byte h+i while h+i < k and the
    # last byte of member i-h after that
    slot = np.arange(len(members_all), dtype=np.int64)
    # per-slot chain attributes come from np.repeat (sequential writes) —
    # measurably cheaper than materialising chain_of_slot and gathering
    # C-sized arrays through it
    pos_ic = slot - np.repeat(chain_off[:-1], sizes)
    from_head = pos_ic <= h
    head_byte_idx = (np.repeat(index.rep_byte[heads] + h, sizes)
                     + np.minimum(pos_ic, h))
    tail_byte = last_byte[members_all[np.maximum(slot - h, 0)]]
    seq_bytes = np.where(from_head, index.buf[head_byte_idx], tail_byte)

    depths = (np.add.reduceat(index.depth[members_all].astype(np.float64),
                              chain_off[:-1]) / sizes) if C else np.zeros(0)

    # batched position query for every chain head and reverse-complement
    # tail, in flat SoA form: per-chain PositionArrays are views into the
    # query result, and sequences are views into the chain byte block — the
    # construction loop allocates only the Unitig shells
    if C:
        with substage("unitigs"):
            uniq, offs, seq_idx_f, strand_f, pos_f = index.positions_for_kmers_flat(
                np.concatenate([heads, rev_tails]))
            seqid_f = index.seq_ids[seq_idx_f].astype(np.int32, copy=False)
            strand_f = np.asarray(strand_f, bool)
            pos_f = np.asarray(pos_f, np.int64)
            h_at = np.searchsorted(uniq, heads)
            r_at = np.searchsorted(uniq, rev_tails)
            # batch shell construction: every per-chain slice bound becomes a
            # plain Python int up front (scalar-indexing numpy arrays inside
            # the loop costs ~3x the whole loop body)
            h_lo = offs[h_at].tolist()
            h_hi = offs[h_at + 1].tolist()
            r_lo = offs[r_at].tolist()
            r_hi = offs[r_at + 1].tolist()
            off_list = chain_off.tolist()
            depths_list = depths.tolist()
            unitigs = graph.unitigs
            for c in range(C):
                unitig = Unitig(number=c + 1,
                                forward_seq=seq_bytes[off_list[c]:off_list[c + 1]])
                unitig.depth = depths_list[c]
                unitig.forward_positions = PositionArray(
                    seqid_f[h_lo[c]:h_hi[c]], strand_f[h_lo[c]:h_hi[c]],
                    pos_f[h_lo[c]:h_hi[c]])
                unitig.reverse_positions = PositionArray(
                    seqid_f[r_lo[c]:r_hi[c]], strand_f[r_lo[c]:r_hi[c]],
                    pos_f[r_lo[c]:r_hi[c]])
                unitigs.append(unitig)

    fwd_start_gram = index.prefix_gid[heads].astype(np.int64)
    fwd_end_gram = index.suffix_gid[tails].astype(np.int64)
    rev_start_gram = index.prefix_gid[rev_tails].astype(np.int64)
    rev_end_gram = index.suffix_gid[index.rev_kid[heads]].astype(np.int64) \
        if C else fwd_start_gram

    # rev_end_gram is the strand mirror of fwd_start_gram's matching rule;
    # matching uses the same three joins as the reference
    # (unitig_graph.rs:253-285), vectorised — emission order identical to
    # the dict join (_link_pairs_dict, the tested oracle)
    with substage("links"):
        src, tgt, kind = _link_pairs(fwd_start_gram, rev_start_gram,
                                     fwd_end_gram, rev_end_gram)
        unitigs = graph.unitigs
        for c, j, g in zip(src.tolist(), tgt.tolist(), kind.tolist()):
            a = unitigs[c]
            b = unitigs[j]
            if g == 0:      # a+ -> b+ (and strand twin b- -> a-)
                a.forward_next.append(UnitigStrand(b, FORWARD))
                b.forward_prev.append(UnitigStrand(a, FORWARD))
                b.reverse_next.append(UnitigStrand(a, REVERSE))
                a.reverse_prev.append(UnitigStrand(b, REVERSE))
            elif g == 1:    # a+ -> b-
                a.forward_next.append(UnitigStrand(b, REVERSE))
                b.reverse_prev.append(UnitigStrand(a, FORWARD))
            else:           # a- -> b+
                a.reverse_next.append(UnitigStrand(b, FORWARD))
                b.forward_prev.append(UnitigStrand(a, REVERSE))

    graph.build_index()
    graph.renumber_unitigs()
    graph.check_links()
    return graph


def build_unitig_graph(sequences: List[Sequence], k: int,
                       device=None) -> UnitigGraph:
    """Sequences (padded, end-repaired) -> compacted unitig graph. The k-mer
    grouping, adjacency and chain following run on ``device`` (CUDA unless
    the caller asks for the CPU)."""
    from ..utils import log
    index = build_kmer_index(sequences, k, device=device)
    log.message(f"Graph contains {index.num_kmers} k-mers")
    log.message()
    chains = build_chains(index)
    return unitig_graph_from_chains(index, chains)
