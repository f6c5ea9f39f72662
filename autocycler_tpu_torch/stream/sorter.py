"""Pass 2: group one bin with the port's grouping kernel.

A bin is a list of ascending occurrence indices whose windows share a
minimizer signature. Their byte starts follow from the sequence layout
(no M-sized ``starts`` tensor exists on the streamed path), and the bin
goes through ``ops.kmers``'s :func:`rank_windows` (``csrc/sortnet.cu`` on
the card, its plain version on the CPU) and :func:`segment_stats`, the
in-memory grouping's own steps at bin scale. Per-bin ranks are local;
:mod:`.merge` lifts them to global lexicographic ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.kmers import rank_windows, segment_stats


def occ_byte_starts(occ: torch.Tensor, seq_len: torch.Tensor,
                    fwd_byte_off: torch.Tensor, rev_byte_off: torch.Tensor,
                    occ_off: torch.Tensor) -> torch.Tensor:
    """Byte offset (into the concatenated padded strands) of each
    occurrence's window start: the inverse of the occurrence layout (per
    sequence, L forward windows then L reverse windows), as torch ops on
    the tensors' device. All arguments are int64 tensors."""
    seq_idx = torch.searchsorted(occ_off, occ, right=True) - 1
    rel = occ - occ_off[seq_idx]
    L = seq_len[seq_idx]
    return torch.where(rel < L, fwd_byte_off[seq_idx] + rel,
                       rev_byte_off[seq_idx] + rel - L)


@dataclass
class BinGroups:
    """One bin's groups in bin-local lexicographic order, every field in
    GLOBAL occurrence coordinates (int64 tensors on the device)."""

    occ_sorted: torch.Tensor   # occurrences grouped by local rank
    depth: torch.Tensor        # per-group occurrence count
    first_occ: torch.Tensor    # smallest occurrence index per group
    rep_start: torch.Tensor    # byte start of each group's first occurrence


def sort_bin(codes: torch.Tensor, occ: torch.Tensor, layout, k: int
             ) -> BinGroups:
    """Group one bin's windows; ``layout`` is the (seq_len, fwd_byte_off,
    rev_byte_off, occ_off) tensors. The records ascend and the grouping is
    stable, so within every group the occurrences ascend and ``first_occ``
    is the group's true global minimum."""
    starts = occ_byte_starts(occ, *layout)
    order, gid_sorted = rank_windows(codes, starts, k)
    depth, first_local = segment_stats(order, gid_sorted)
    first_local = first_local.long()
    return BinGroups(occ_sorted=occ[order.long()], depth=depth.long(),
                     first_occ=occ[first_local],
                     rep_start=starts[first_local])
