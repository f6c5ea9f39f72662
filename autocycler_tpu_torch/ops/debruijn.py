"""Unitig chain construction over the k-mer index.

Replaces the reference's sequential greedy walk (unitig_graph.rs:176-226:
per-k-mer graph walk with hash probes and a `seen` set) with a vectorised,
order-independent formulation:

An edge A->B is *unitig-internal* iff
    out_count(A) == 1  and  not first_pos(rev(A))      (A may extend right)
    and in_count(B) == 1  and  not first_pos(B)        (B may be entered)
which is exactly the conjunction of break conditions in the reference's
extension loops (unitig_graph.rs:192-205 forward, :210-223 backward) and is
strand-symmetric: internal(A->B) <=> internal(rev B->rev A). Chains under
this relation are therefore well-defined without any walk order, and are
computed on the device by pointer doubling (O(U log U) gathers).

The reference's remaining walk behaviours are reproduced exactly:
- chains come in reverse-complement pairs; the one containing the globally
  smallest k-mer (= smallest id, ids are lexicographic ranks) is emitted,
  matching the sorted iteration order of the walk (kmer_graph.rs:168-173);
- cycles are rotated to start at their smallest k-mer (the walk starts
  there and goes around until it meets the start's `seen` mark);
- self-mirror chains (a chain that is its own reverse complement) split at
  the centre, keeping the half containing the smallest k-mer — the effect
  of the walk's `seen` check hitting the mirror half;
- self-mirror cycles fall back to a literal simulation of the walk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..device import device_work, to_host
from ..utils.timing import substage
from .kmers import KmerIndex


@dataclass
class Chains:
    """Emitted unitig chains: ordered k-mer ids, concatenated."""
    members: np.ndarray    # (T,) kmer ids in chain order, all chains concatenated
    chain_off: np.ndarray  # (C+1,) boundaries into members
    is_cycle: np.ndarray   # (C,) bool

    @property
    def count(self) -> int:
        return len(self.chain_off) - 1

    def chain(self, c: int) -> np.ndarray:
        return self.members[self.chain_off[c]:self.chain_off[c + 1]]


def internal_edges(index: KmerIndex) -> np.ndarray:
    """next_int[g] = unitig-internal successor of k-mer g, or -1."""
    U = index.num_kmers
    succ = index.succ
    ok = (index.out_count == 1) & (succ >= 0)
    ok &= ~index.first_pos[index.rev_kid]
    src = np.flatnonzero(ok)
    tgt = succ[src]
    keep = (index.in_count[tgt] == 1) & ~index.first_pos[tgt]
    result = np.full(U, -1, np.int64)
    result[src[keep]] = tgt[keep]
    return result


def chains_device(next_int: np.ndarray, device: torch.device):
    """Chain following by pointer doubling on the device: the predecessor
    scatter-max, head/rank doubling, masked cycle min-propagation, cycle
    breaking at each cycle's smallest member and the re-doubling, as the JAX
    package's _chains_fn. Valid because ``next_int`` is functional AND
    injective (every internal edge has in_count == 1), so the graph is
    exactly disjoint simple paths and cycles. One upload of ``next_int``,
    one download of (head, rank, in_cycle); the O(U) ordering scatters
    finish on the host. Returns (members, chain_off, chain_is_cycle)."""
    U = len(next_int)
    steps = max(1, int(np.ceil(np.log2(max(U, 2)))) + 1)
    nxt = torch.from_numpy(np.asarray(next_int, np.int64)).to(device)
    node = torch.arange(U, device=device)
    has_next = nxt >= 0
    # predecessor scatter (injective: no duplicate real targets); invalid
    # targets land in the extra slot U
    tgt = torch.where(has_next, nxt, U)
    prev = torch.full((U + 1,), -1, dtype=torch.int64,
                      device=device).scatter_reduce_(
        0, tgt, torch.where(has_next, node, -1), "amax")[:U]

    def double_heads(p):
        P = torch.where(p < 0, node, p)
        R = (p >= 0).to(torch.int64)
        for _ in range(steps):
            R = R + R[P]
            P = P[P]
        return P, R

    head, _ = double_heads(prev)
    in_cycle = prev[head] >= 0
    # cycle representatives (= smallest member id): masked min-propagation;
    # non-cycle nodes carry an out-of-band sentinel and self-loop pointers,
    # so they never contaminate a cycle's min
    cmin = torch.where(in_cycle, node, U)
    P = torch.where(in_cycle, prev, node)
    for _ in range(steps):
        cmin = torch.minimum(cmin, cmin[P])
        P = P[P]
    rep = in_cycle & (cmin == node)
    # break each cycle at its representative: dropping the rep's predecessor
    # is sufficient, the re-doubling only consults prev
    head, rank = double_heads(torch.where(rep, -1, prev))
    head = to_host(head, "chains")
    rank = to_host(rank, "chains")
    in_cycle = to_host(in_cycle, "chains")

    is_head = head == np.arange(U)
    cid_of_head = np.cumsum(is_head) - 1
    C = int(is_head.sum())
    chain_id = cid_of_head[head]
    sizes = np.bincount(chain_id, minlength=C)
    chain_off = np.zeros(C + 1, np.int64)
    chain_off[1:] = np.cumsum(sizes)
    members = np.empty(U, np.int64)
    members[chain_off[chain_id] + rank] = np.arange(U)
    chain_is_cycle = in_cycle[members[chain_off[:-1]]] if C \
        else np.zeros(0, bool)
    return members, chain_off, chain_is_cycle


def build_chains(index: KmerIndex) -> Chains:
    """Emitted chains of the index, following them on ``index.device``."""
    U = index.num_kmers
    if U == 0:
        return Chains(np.zeros(0, np.int64), np.zeros(1, np.int64), np.zeros(0, bool))

    with substage("chains"):
        next_int = internal_edges(index)
        # the JAX package's declared traffic: int32 next and head arrays,
        # read and written on each of the ceil(log2 U) doubling rounds
        with device_work("chain pointer doubling", index.device,
                         bytes_moved=4.0 * U * (
                             2 * np.ceil(np.log2(max(U, 2))) + 4)):
            members, chain_off, chain_is_cycle = chains_device(
                next_int, index.device)

    with substage("chain-emit"):
        C = len(chain_off) - 1
        sizes = np.diff(chain_off)
        # chain index of every node (members lists each node exactly once)
        node_chain = np.empty(U, np.int64)
        node_chain[members] = np.repeat(np.arange(C, dtype=np.int64), sizes)
        chain_head = members[chain_off[:-1]]

        # per-chain minima, own and mirror
        min_own = np.minimum.reduceat(members, chain_off[:-1]) if C else \
            np.zeros(0, np.int64)
        min_mirror = np.minimum.reduceat(index.rev_kid[members],
                                         chain_off[:-1]) \
            if C else np.zeros(0, np.int64)
        mirror_chain = node_chain[index.rev_kid[chain_head]]
        self_mirror = mirror_chain == np.arange(C)

        # Emit chains vectorised: of each mirror pair keep the chain holding
        # the smaller minimum (ties == self-mirror, handled separately below).
        normal_keep = ~self_mirror & (min_own <= min_mirror)
        keep_node = np.repeat(normal_keep, sizes)
        flat = members[keep_node]
        kept_sizes = sizes[normal_keep]
        off = np.concatenate([[0], np.cumsum(kept_sizes)]).astype(np.int64)
        out_is_cycle = list(chain_is_cycle[normal_keep])

        # self-mirror chains are rare; the literal per-chain handling only
        # runs for them (appended after the vectorised bulk — chain order is
        # irrelevant, renumbering happens downstream)
        extra_members: List[np.ndarray] = []
        for c in np.flatnonzero(self_mirror):
            mem = members[chain_off[c]:chain_off[c + 1]]
            if chain_is_cycle[c]:
                extra_members.append(_simulate_walk_cycle(index, next_int, mem,
                                                          int(min_own[c])))
            else:
                half = len(mem) // 2
                pos_of_min = int(np.argmin(mem))
                extra_members.append(mem[:half] if pos_of_min < half
                                     else mem[half:])
            out_is_cycle.append(False)  # walk results are never full cycles
        if extra_members:
            flat = np.concatenate([flat] + extra_members)
            off = np.concatenate(
                [off, off[-1] + np.cumsum([len(m) for m in extra_members])])
        return Chains(flat, off.astype(np.int64),
                      np.array(out_is_cycle, dtype=bool))


def _simulate_walk_cycle(index: KmerIndex, next_int: np.ndarray,
                         cycle_members: np.ndarray, start: int) -> np.ndarray:
    """Literal reproduction of the reference walk for a self-mirror cycle
    (unitig_graph.rs:188-223): extend right then left, stopping when the
    next k-mer (or its reverse complement) was already taken."""
    seen = {start, int(index.rev_kid[start])}
    chain = [start]
    cur = start
    while True:
        nxt = int(next_int[cur])
        if nxt < 0 or nxt in seen:
            break
        chain.append(nxt)
        seen.add(nxt)
        seen.add(int(index.rev_kid[nxt]))
        cur = nxt
    prev_map = {int(next_int[m]): int(m) for m in cycle_members if next_int[m] >= 0}
    cur = start
    while True:
        prv = prev_map.get(cur, -1)
        if prv < 0 or prv in seen:
            break
        chain.insert(0, prv)
        seen.add(prv)
        seen.add(int(index.rev_kid[prv]))
        cur = prv
    return np.array(chain, dtype=np.int64)
