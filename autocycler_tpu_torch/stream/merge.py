"""Global rank merge: bin-local groups -> global lexicographic ranks.

Signature bins are not prefix-aligned, so per-bin ranks cannot be stitched
by adding offsets. But every distinct k-mer lies in exactly one bin, so the
union of all bins' group representatives is the set of distinct k-mers,
each once: grouping that union with the port's grouping kernel gives every
group its global rank in one launch.
"""

from __future__ import annotations

import torch

from ..ops.kmers import rank_windows
from ..utils.resilience import SpillError


def merge_ranks(codes: torch.Tensor, rep_starts: torch.Tensor,
                k: int) -> torch.Tensor:
    """The global lexicographic rank (int64) of each representative window.

    ``rep_starts`` concatenates every bin's representative byte starts; all
    must be DISTINCT k-mers. A duplicate means the signature binning was
    violated (a corrupt spill or a signature that is not a pure function of
    content) and raises :class:`SpillError`: mis-ranked groups would corrupt
    the graph."""
    U = len(rep_starts)
    if U == 0:
        return torch.zeros(0, dtype=torch.int64, device=rep_starts.device)
    order, gid_sorted = rank_windows(codes, rep_starts, k)
    if int(gid_sorted[-1]) + 1 != U:
        raise SpillError(
            "bin-merge found duplicate k-mer representatives across "
            "bins — the signature partition is corrupt")
    grank = torch.empty(U, dtype=torch.int64, device=rep_starts.device)
    grank[order.long()] = torch.arange(U, device=rep_starts.device)
    return grank
