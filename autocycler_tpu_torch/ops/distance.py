"""All-vs-all contig distance as one device matrix product.

Parity target: reference cluster.rs:132-157 and the JAX package's
ops/distance.py — the asymmetric distance ``1 - |A∩B|_len / |A|_len`` over
the sets of unitig ids in each contig's graph path, weighted by unitig
length. With M the binary membership matrix (contigs × unitigs) and w the
unitig lengths:

    inter = (M * w) @ M.T
    dist[a, b] = 1 - inter[a, b] / inter[a, a]

The contraction runs on the device as a float64 ``torch.matmul``: every
term and partial sum is a non-negative integer no larger than a weighted
row sum, so below 2**53 the product is exact in any summation order. It is
cast to int64, and the one float expression of the JAX package
(:func:`_intersections_to_matrix`) runs in numpy, so the distances are
bit-identical to the JAX package's ``Mw @ M.T``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import device_work, resolve_device

EXACT_FLOAT64 = 2**53


def membership_matrix(graph, sequences) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(M: contigs × unitigs uint8, w: unitig lengths int64, seq ids)."""
    numbers = [u.number for u in graph.unitigs]
    col = {n: i for i, n in enumerate(numbers)}
    w = np.array([u.length() for u in graph.unitigs], dtype=np.int64)
    M = np.zeros((len(sequences), len(numbers)), dtype=np.uint8)
    ids = []
    paths = graph.get_unitig_paths_for_sequences([s.id for s in sequences])
    for i, seq in enumerate(sequences):
        ids.append(seq.id)
        for number, _ in paths[seq.id]:
            M[i, col[number]] = 1
    return M, w, ids


def _intersections_to_matrix(inter: np.ndarray) -> np.ndarray:
    """Integer intersection matrix -> asymmetric distance matrix (the JAX
    package's float expression, so the results stay bit-identical)."""
    a_len = np.diag(inter).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return 1.0 - inter / a_len[:, None]


def intersections_to_distances(inter: np.ndarray, ids: List[int]
                               ) -> Dict[Tuple[int, int], float]:
    """Reference-shaped {(id_a, id_b): distance} from an integer
    intersection matrix."""
    D = _intersections_to_matrix(inter)
    return {(ids[a], ids[b]): float(D[a, b])
            for a in range(len(ids)) for b in range(len(ids))}


def intersections(M: np.ndarray, w: np.ndarray, device=None) -> np.ndarray:
    """The int64 intersection matrix (M * w) @ M.T, contracted on ``device``
    (CUDA unless the caller asks for the CPU) as a float64 product."""
    dev = resolve_device(device)
    Mw = M.astype(np.int64) * w[None, :]
    if Mw.size and int(Mw.sum(axis=-1).max()) >= EXACT_FLOAT64:
        raise ValueError("a contig's weighted path length reaches 2**53: the "
                         "float64 distance contraction would not be exact")
    with device_work("cluster distance matmul", dev):
        mw = torch.from_numpy(Mw).to(dev, torch.float64)
        m = torch.from_numpy(M).to(dev, torch.float64)
        return torch.matmul(mw, m.T).cpu().numpy().astype(np.int64)


def pairwise_contig_distances(graph, sequences, device=None
                              ) -> Dict[Tuple[int, int], float]:
    """Distances keyed by (seq_a.id, seq_b.id), reference-shaped."""
    M, w, ids = membership_matrix(graph, sequences)
    return intersections_to_distances(intersections(M, w, device), ids)
