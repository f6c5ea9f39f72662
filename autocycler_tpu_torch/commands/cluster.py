"""`autocycler cluster`: group contigs into replicon clusters.

Parity target: reference cluster.rs, and the JAX package's
commands/cluster.py byte for byte. Pipeline: load input_assemblies.gfa,
compute the asymmetric pairwise distance matrix (one float64 matrix product
on the device, ops.distance), symmetrize by max, build a UPGMA tree,
normalise the root to 0.5, cut at --cutoff with hill-climb refinement
against the clustering score (balance + tightness), QC the clusters
(min_assemblies / containment / trusted overrides), and write per-cluster
1_untrimmed.gfa checkpoints plus PHYLIP, Newick, TSV and YAML outputs.

``AUTOCYCLER_SKETCH_DISTANCE`` picks the distances as in the JAX package:
the exact contraction, minimizer-sketch distances (ops.sketch; ``auto``
from ``AUTOCYCLER_SKETCH_MIN_CONTIGS`` contigs on), or ``verify``, which
computes both and clusters from the exact ones.
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..metrics import ClusteringMetrics, UntrimmedClusterMetrics
from ..models import Sequence, UnitigGraph
from ..models.simplify import merge_linear_paths
from ..obs import ledger
from ..obs import qc as obs_qc
from ..ops.distance import pairwise_contig_distances
from ..ops.sketch import sketch_contig_distances, sketch_params
from ..utils import (format_float, load_file_lines, log, median, quit_with_error,
                     usize_division_rounded)
from ..utils.cache import open_cache
from ..utils.env import env_int, env_str
from ..utils.timing import stage_timer


# ---------------- tree ----------------

class TreeNode:
    """UPGMA tree node (reference cluster.rs:195-348). ``distance`` is the
    node-to-tip distance; tips carry sequence ids, internal nodes get fresh
    ids above the largest sequence id."""

    __slots__ = ("id", "left", "right", "distance")

    def __init__(self, id: int, left=None, right=None, distance: float = 0.0):
        self.id = id
        self.left = left
        self.right = right
        self.distance = distance

    def is_tip(self) -> bool:
        return self.left is None

    def max_pairwise_distance(self, node_num: int) -> float:
        if self.id == node_num:
            return self.distance * 2.0
        if self.is_tip():
            return -1.0
        return max(self.left.max_pairwise_distance(node_num),
                   self.right.max_pairwise_distance(node_num))

    def automatic_clustering(self, cutoff: float) -> List[int]:
        clusters: List[int] = []
        self._collect_clusters(cutoff / 2.0, [], clusters)
        return sorted(clusters)

    def manual_clustering(self, cutoff: float, manual_clusters: List[int]) -> List[int]:
        clusters: List[int] = []
        self._check_consistency(manual_clusters)
        self._collect_clusters(cutoff / 2.0, manual_clusters, clusters)
        return sorted(clusters)

    def _collect_clusters(self, cutoff: float, manual: List[int],
                          clusters: List[int]) -> None:
        if self.id in manual or (self.distance <= cutoff
                                 and not self._has_manual_child(manual)):
            clusters.append(self.id)
        elif not self.is_tip():
            self.left._collect_clusters(cutoff, manual, clusters)
            self.right._collect_clusters(cutoff, manual, clusters)

    def _has_manual_child(self, manual: List[int]) -> bool:
        if self.id in manual:
            return True
        if not self.is_tip():
            return (self.left._has_manual_child(manual)
                    or self.right._has_manual_child(manual))
        return False

    def _check_consistency(self, manual: List[int]) -> None:
        if not self.is_tip():
            if self.id in manual and (self.left._has_manual_child(manual)
                                      or self.right._has_manual_child(manual)):
                quit_with_error("manual clusters cannot be nested")
            self.left._check_consistency(manual)
            self.right._check_consistency(manual)

    def get_tips(self, node_num: int) -> List[int]:
        node = self.find_node(node_num)
        if node is None:
            return []
        tips: List[int] = []
        node._collect_tips(tips)
        return tips

    def _collect_tips(self, tips: List[int]) -> None:
        if self.is_tip():
            tips.append(self.id)
        else:
            self.left._collect_tips(tips)
            self.right._collect_tips(tips)

    def check_complete_coverage(self, clusters: List[int]) -> None:
        all_tips = set(self.get_tips(self.id))
        covered = set()
        for c in clusters:
            for tip in self.get_tips(c):
                if tip in covered:
                    raise AssertionError("overlap detected")
                covered.add(tip)
        if covered != all_tips:
            raise AssertionError("incomplete coverage")

    def split_clusters(self, clusters: List[int]) -> List[List[int]]:
        """All clusterings reachable by splitting one splittable cluster into
        its two children (reference cluster.rs:311-334)."""
        self.check_complete_coverage(clusters)
        result = []
        for cluster in clusters:
            node = self.find_node(cluster)
            if node is not None and not node.is_tip():
                alt = [c for c in clusters if c != cluster]
                alt.extend([node.left.id, node.right.id])
                result.append(sorted(alt))
        result.sort()
        return result

    def find_node(self, node_num: int) -> Optional["TreeNode"]:
        if self.id == node_num:
            return self
        if self.is_tip():
            return None
        found = self.left.find_node(node_num)
        if found is not None:
            return found
        return self.right.find_node(node_num)


def _distances_to_matrix(distances: Dict[Tuple[int, int], float],
                         pos: Dict[int, int], n: int) -> np.ndarray:
    """One vectorised pass over a {(id_a, id_b): d} dict into a dense
    [n, n] float64 matrix, +inf where absent; pairs whose ids are missing
    from ``pos`` are ignored. Shared by upgma() and containment_counts()
    so the scatter pattern can't drift between them."""
    D = np.full((n, n), np.inf)
    if distances:
        idx = np.array([(pos.get(a, -1), pos.get(b, -1))
                        for a, b in distances], np.int64).reshape(-1, 2)
        vals = np.fromiter(distances.values(), np.float64, len(distances))
        m = (idx[:, 0] >= 0) & (idx[:, 1] >= 0)
        D[idx[m, 0], idx[m, 1]] = vals[m]
    return D


def upgma(distances: Dict[Tuple[int, int], float], sequences: List[Sequence]) -> TreeNode:
    """UPGMA over the symmetric distance map; merged clusters keep the id
    min(a, b); internal node ids count up from the largest sequence id; ties
    broken by the first pair in sorted-id order (reference cluster.rs:395-458).

    The reference (and the previous implementation here) re-scans a dict of
    pair distances per merge — O(n³) with heavy constants. This wraps the
    O(n²) matrix implementation below; the closest-pair tie-break (smallest
    id pair in sorted order) is preserved. Inter-cluster averages are the
    same sums of ORIGINAL pair distances divided once, accumulated in merge
    order rather than flat order — mathematically identical, but float
    addition is not associative, so candidate-pair averages can differ from
    the reference's flat re-summation by ulps: EXACT ties and ulp-level
    near-ties between closest-pair candidates may resolve differently on
    pathological inputs (the previous dict implementation summed in
    unordered set-iteration order, so it made no stronger guarantee).

    A pair missing from ``distances`` in BOTH directions is an error: the
    matrix would otherwise treat it as distance 0 and merge it first, where
    the dict implementation failed loudly during averaging.
    """
    ids = sorted(s.id for s in sequences)
    n = len(ids)
    pos = {a: i for i, a in enumerate(ids)}
    D = _distances_to_matrix(distances, pos, n)
    diag = np.diag(D).copy()
    diag[np.isinf(diag)] = 0.0       # absent self-pairs are distance 0
    np.fill_diagonal(D, diag)
    D = np.minimum(D, D.T)           # fills any one-directional entries
    if n > 1 and not np.isfinite(D).all():   # diagonal is finite, so any
        #                                      inf is a missing off-diag pair
        a, b = np.argwhere(~np.isfinite(D))[0]
        raise ValueError(
            f"distance map is missing pair ({ids[a]}, {ids[b]}): UPGMA "
            "requires every sequence pair (an absent pair would otherwise "
            "merge first as distance 0)")
    return upgma_matrix(D, ids)


def upgma_matrix(D: np.ndarray, ids: List[int]) -> TreeNode:
    """O(n²) UPGMA over a dense symmetric distance matrix (row/col order =
    ascending cluster ids). Cluster-to-cluster distance is the mean of the
    ORIGINAL member-pair distances, maintained as exact pair-sums merged
    additively; the closest pair is the row-major-first minimum (identical
    tie-break to scanning pairs in sorted-id order). Per merge only the
    merged row/column and invalidated row-minima are recomputed."""
    n = len(ids)
    if n == 1:
        return TreeNode(ids[0])
    S = np.asarray(D, dtype=np.float64).copy()  # pair-distance sums
    size = np.ones(n, dtype=np.int64)
    active = np.ones(n, dtype=bool)
    nodes: Dict[int, TreeNode] = {i: TreeNode(ids[i]) for i in range(n)}
    internal_node_num = max(ids)
    INF = np.inf

    # rowmin[i] = min over active j>i of avg(i, j); rowarg[i] = smallest such j
    def avg_row(i: int) -> np.ndarray:
        return S[i] / (size[i] * size)

    rowmin = np.full(n, INF)
    rowarg = np.full(n, -1, dtype=np.int64)

    def recompute_row(i: int) -> None:
        vals = avg_row(i)
        vals = np.where(active, vals, INF)
        vals[:i + 1] = INF
        j = int(np.argmin(vals))
        rowmin[i], rowarg[i] = vals[j], j

    for i in range(n):
        recompute_row(i)

    for _ in range(n - 1):
        a = int(np.argmin(rowmin))       # first occurrence = smallest id pair
        b = int(rowarg[a])
        pair_distance = float(rowmin[a])  # plain float: numpy scalars would
        #                                   leak np.float64 reprs into YAML/TSV

        internal_node_num += 1
        nodes[a] = TreeNode(internal_node_num, nodes.pop(a), nodes.pop(b),
                            pair_distance / 2.0)

        # merge b into a: sums add exactly; sizes add
        S[a] += S[b]
        S[:, a] = S[a]
        size[a] += size[b]
        active[b] = False
        rowmin[b] = INF

        if len(nodes) == 1:
            break

        # rows i<a: column a changed, column b vanished
        lo = np.flatnonzero(active[:a])
        if len(lo):
            newvals = S[lo, a] / (size[lo] * size[a])
            improve = (newvals < rowmin[lo]) | \
                ((newvals == rowmin[lo]) & (a < rowarg[lo]))
            rowmin[lo[improve]] = newvals[improve]
            rowarg[lo[improve]] = a
            stale = lo[~improve]
            for i in stale[np.isin(rowarg[stale], (a, b))]:
                recompute_row(int(i))
        # rows a<i<b that pointed at b
        mid = np.flatnonzero(active[a + 1:b]) + a + 1
        for i in mid[rowarg[mid] == b]:
            recompute_row(int(i))
        recompute_row(a)

    return next(iter(nodes.values()))


def normalise_tree(root: TreeNode) -> None:
    """Scale so root-to-tip distance is at most 0.5 (reference cluster.rs:483-494)."""
    if root.distance > 0.5:
        _scale(root, 0.5 / root.distance)


def _scale(node: TreeNode, factor: float) -> None:
    node.distance *= factor
    if node.left is not None:
        _scale(node.left, factor)
        _scale(node.right, factor)


def _fmt(x: float) -> str:
    """Shortest round-trip float representation, integral values without a
    decimal point (Rust `{}` Display semantics, which the reference uses for
    Newick branch lengths)."""
    s = repr(float(x))
    return s[:-2] if s.endswith(".0") else s


def tree_to_newick(node: TreeNode, index: Dict[int, Sequence]) -> str:
    if node.left is not None and node.right is not None:
        left = tree_to_newick(node.left, index)
        right = tree_to_newick(node.right, index)
        return (f"({left}:{_fmt(node.distance - node.left.distance)},"
                f"{right}:{_fmt(node.distance - node.right.distance)}){node.id}")
    return index[node.id].string_for_newick()


def save_tree_to_newick(root: TreeNode, sequences: List[Sequence], file_path) -> None:
    """Newick with a root branch padding root-to-tip distances to 0.5
    (reference cluster.rs:363-380)."""
    index = {s.id: s for s in sequences}
    newick = tree_to_newick(root, index)
    with open(file_path, "w") as f:
        if root.distance < 0.5:
            f.write(f"({newick}:{_fmt(0.5 - root.distance)});\n")
        else:
            f.write(f"{newick};\n")


# ---------------- QC ----------------

class ClusterQC:
    __slots__ = ("failure_reasons", "cluster_dist")

    def __init__(self, cluster_dist: float = 0.0):
        self.failure_reasons: List[str] = []
        self.cluster_dist = cluster_dist

    def passed(self) -> bool:
        return not self.failure_reasons


def make_symmetrical_distances(asym: Dict[Tuple[int, int], float],
                               sequences: List[Sequence]) -> Dict[Tuple[int, int], float]:
    """max(A->B, B->A) per pair (reference cluster.rs:177-192)."""
    sym = {}
    for a in sequences:
        for b in sequences:
            sym[(a.id, b.id)] = max(asym[(a.id, b.id)], asym[(b.id, a.id)])
    return sym


def generate_clusters(tree: TreeNode, sequences: List[Sequence],
                      distances: Dict[Tuple[int, int], float], cutoff: float,
                      min_assemblies: int, manual_clusters: List[int]
                      ) -> Dict[int, ClusterQC]:
    try:
        if not manual_clusters:
            auto = tree.automatic_clustering(cutoff)
            clusters = refine_auto_clusters(tree, sequences, distances, auto,
                                            cutoff, min_assemblies)
        else:
            clusters = tree.manual_clustering(cutoff, manual_clusters)
        tree.check_complete_coverage(clusters)
        return qc_clusters(tree, sequences, distances, clusters, manual_clusters,
                           cutoff, min_assemblies)
    finally:
        # the containment memo exists to serve the hill-climb's many score
        # evaluations above; release the dense matrix + dict reference when
        # clustering is done so a long batch run doesn't carry the largest
        # isolate's S x S matrix to process exit
        _contain_memo().clear()


def qc_clusters(tree: TreeNode, sequences: List[Sequence],
                distances: Dict[Tuple[int, int], float], cluster_nodes: List[int],
                manual_clusters: List[int], cutoff: float, min_assemblies: int
                ) -> Dict[int, ClusterQC]:
    """Assign cluster numbers and decide pass/fail: too-few-assemblies and
    containment failures, with trusted contigs exempting their cluster
    (reference cluster.rs:511-570)."""
    qc_results: Dict[int, ClusterQC] = {}
    current = 0
    for n in cluster_nodes:
        node = tree.find_node(n)
        if node is None:
            quit_with_error(f"clustering tree does not contain a node with id {n}")
        current += 1
        _assign_cluster_to_node(node, sequences, current)
        qc = ClusterQC(tree.max_pairwise_distance(n))
        if manual_clusters and n not in manual_clusters:
            qc.failure_reasons.append("not included in manual clusters")
        qc_results[current] = qc

    old_to_new = reorder_clusters(sequences)
    qc_results = {old_to_new[old]: qc for old, qc in qc_results.items()}

    if not manual_clusters:
        max_cluster = get_max_cluster(sequences)
        for c in range(1, max_cluster + 1):
            count = cluster_assembly_count(sequences, c)
            if count < min_assemblies and not cluster_is_trusted(sequences, c):
                qc_results[c].failure_reasons.append("present in too few assemblies")
        # the pair-count matrices are cluster-assignment-dependent but not
        # qc-status-dependent, so they are computed once; the sequential
        # loop below still sees earlier containment failures through
        # qc_results, exactly like the reference's per-cluster re-check
        counts = containment_counts(sequences, distances, cutoff)
        for c in range(1, max_cluster + 1):
            container = cluster_is_contained_in_another(c, sequences, distances, cutoff,
                                                        qc_results, counts=counts)
            if container > 0 and not cluster_is_trusted(sequences, c):
                qc_results[c].failure_reasons.append(
                    f"contained within cluster {container}")
    return qc_results


def _assign_cluster_to_node(node: TreeNode, sequences: List[Sequence],
                            cluster: int) -> None:
    for s in sequences:
        if s.id == node.id:
            s.cluster = cluster
    if node.left is not None:
        _assign_cluster_to_node(node.left, sequences, cluster)
        _assign_cluster_to_node(node.right, sequences, cluster)


def cluster_assembly_count(sequences: List[Sequence], c: int) -> int:
    """Assemblies represented in the cluster, scaled by the max cluster-weight
    directive per file (reference cluster.rs:572-585)."""
    weights: Dict[str, int] = {}
    for seq in sequences:
        if seq.cluster != c:
            continue
        w = seq.cluster_weight()
        if seq.filename not in weights or w > weights[seq.filename]:
            weights[seq.filename] = w
    return sum(weights.values())


def cluster_is_trusted(sequences: List[Sequence], c: int) -> bool:
    return any(s.cluster == c and s.is_trusted() for s in sequences)


# single-slot memo for the cluster-assignment-INDEPENDENT part of
# containment counting: the refinement hill-climb scores many candidate
# clusterings against the same distance dict, and rebuilding the dense
# [S, S] matrix per score evaluation would reintroduce the O(S²)-per-call
# Python constant this module just removed. A hit requires the SAME dict
# object (`is` against the held strong reference — id() alone can alias two
# distinct dicts once the first is garbage collected and its id recycled)
# plus equal cutoff and id tuple; generate_clusters() clears the slot when
# clustering finishes. The slot is per thread: the serve daemon clusters
# several jobs at once, and a shared slot would hand one job another's
# matrix (the JAX package's module-level slot has that race).
_contain_local = threading.local()


def _contain_memo() -> Dict[str, object]:
    """The calling thread's containment memo slot."""
    memo = getattr(_contain_local, "memo", None)
    if memo is None:
        memo = _contain_local.memo = {}
    return memo


def _contain_ab_cached(distances: Dict[Tuple[int, int], float],
                       cutoff: float, ids: Tuple[int, ...]) -> np.ndarray:
    memo = _contain_memo()
    key = (cutoff, ids)
    if memo.get("distances_ref") is distances and memo.get("key") == key:
        return memo["contain_ab"]  # type: ignore[return-value]
    pos = {a: i for i, a in enumerate(ids)}
    D = _distances_to_matrix(distances, pos, len(ids))
    contain_ab = (D < D.T) & (D < cutoff)
    memo.update(key=key, distances_ref=distances, contain_ab=contain_ab)
    return contain_ab


def containment_counts(sequences: List[Sequence],
                       distances: Dict[Tuple[int, int], float],
                       cutoff: float) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised cross-cluster containment accounting (the reference counts
    these pairs with nested per-cluster-pair loops, cluster.rs:692-723 —
    O(S²) Python at the 32,767-sequence cap the position model supports).

    One pass over the distance dict rebuilds the [S, S] matrix (the same
    pattern as upgma()); the per-cluster-pair pair counts are then two
    integer matmuls with the cluster-membership matrix. Returns
    ``(contain, total)``, both [C+1, C+1] int64 where C is the max cluster
    number: ``contain[c, o]`` = number of (a in c, b in o) pairs with
    d(a,b) < d(b,a) and d(a,b) < cutoff; ``total[c, o]`` = |c| * |o|.
    Pairs absent from the dict never count as contained (their distance is
    +inf); the product flow always passes a complete matrix-derived dict."""
    clustered = [s for s in sequences if s.cluster >= 1]
    max_cluster = max((s.cluster for s in clustered), default=0)
    if not clustered:
        z = np.zeros((1, 1), np.int64)
        return z, z
    S = len(clustered)
    contain_ab = _contain_ab_cached(distances, cutoff,
                                    tuple(s.id for s in clustered))
    P = np.zeros((max_cluster + 1, S), np.int64)
    P[np.array([s.cluster for s in clustered]), np.arange(S)] = 1
    # uint8 cast: the matmul promotes with int64 P, so the result is the
    # same exact integer count at 1/8 the temporary size (S² at the 32k
    # sequence cap is the design point)
    contain = P @ contain_ab.astype(np.uint8) @ P.T
    sizes = P.sum(axis=1)
    total = sizes[:, None] * sizes[None, :]
    return contain, total


def cluster_is_contained_in_another(cluster_num: int, sequences: List[Sequence],
                                    distances: Dict[Tuple[int, int], float],
                                    cutoff: float, qc_results: Dict[int, ClusterQC],
                                    counts: Optional[Tuple[np.ndarray, np.ndarray]] = None
                                    ) -> int:
    """A cluster is contained in a passing cluster when the majority of
    cross-pair distances are asymmetric and below the cutoff
    (reference cluster.rs:692-723). The pair counting is vectorised in
    :func:`containment_counts`; callers checking many clusters (qc_clusters)
    compute the matrices once and pass them as ``counts``. The first passing
    cluster in qc_results iteration order wins, as in the reference."""
    contain, total = counts if counts is not None else \
        containment_counts(sequences, distances, cutoff)
    C = contain.shape[0]
    for other in (c for c, qc in qc_results.items() if qc.passed()):
        if other == cluster_num or other >= C or cluster_num >= C:
            continue
        t = total[cluster_num, other]
        if t and contain[cluster_num, other] / t > 0.5:
            return other
    return 0


def score_clustering(tree: TreeNode, sequences: List[Sequence],
                     distances: Dict[Tuple[int, int], float], clusters: List[int],
                     cutoff: float, min_assemblies: int) -> float:
    qc = qc_clusters(tree, sequences, distances, clusters, [], cutoff, min_assemblies)
    return clustering_metrics(sequences, qc).overall_clustering_score


def refine_auto_clusters(tree: TreeNode, sequences: List[Sequence],
                         distances: Dict[Tuple[int, int], float], clusters: List[int],
                         cutoff: float, min_assemblies: int) -> List[int]:
    """Hill-climb: split any cluster whose split improves the overall score
    (reference cluster.rs:607-630)."""
    best = list(clusters)
    best_score = score_clustering(tree, sequences, distances, best, cutoff,
                                  min_assemblies)
    improved = True
    while improved:
        improved = False
        for alt in tree.split_clusters(best):
            alt_score = score_clustering(tree, sequences, distances, alt, cutoff,
                                         min_assemblies)
            if alt_score > best_score + 1e-12:
                best, best_score = alt, alt_score
                improved = True
    return best


def reorder_clusters(sequences: List[Sequence]) -> Dict[int, int]:
    """Renumber clusters by median sequence length, descending; ties by old
    number (reference cluster.rs:882-903)."""
    cluster_lengths = {}
    for c in range(1, get_max_cluster(sequences) + 1):
        lengths = [s.length for s in sequences if s.cluster == c]
        cluster_lengths[c] = median(lengths)
    ordered = sorted(cluster_lengths.items(), key=lambda kv: (-kv[1], kv[0]))
    old_to_new = {old: i + 1 for i, (old, _) in enumerate(ordered)}
    for s in sequences:
        if s.cluster >= 1:
            s.cluster = old_to_new[s.cluster]
    return old_to_new


def get_assembly_count(sequences: List[Sequence]) -> int:
    return len({s.filename for s in sequences})


def get_max_cluster(sequences: List[Sequence]) -> int:
    return max(s.cluster for s in sequences)


def set_min_assemblies(min_assemblies_option: Optional[int],
                       sequences: List[Sequence]) -> int:
    """Auto --min_assemblies: assemblies/4 rounded, min 2 (1 when there is a
    single assembly) (reference cluster.rs:645-661)."""
    if min_assemblies_option is not None:
        return min_assemblies_option
    count = get_assembly_count(sequences)
    if count == 1:
        return 1
    return max(2, usize_division_rounded(count, 4))


def parse_manual_clusters(manual: Optional[str]) -> List[int]:
    if not manual:
        return []
    out = []
    for token in manual.replace(" ", "").split(","):
        try:
            out.append(int(token))
        except ValueError:
            quit_with_error(f"failed to parse '{token}' as a node number")
    return sorted(out)


def clustering_metrics(sequences: List[Sequence], qc_results: Dict[int, ClusterQC]
                       ) -> ClusteringMetrics:
    metrics = ClusteringMetrics()
    cluster_filenames: Dict[int, List[str]] = {}
    for seq in sequences:
        qc = qc_results[seq.cluster]
        cluster_filenames.setdefault(seq.cluster, []).append(seq.filename)
        if qc.passed():
            metrics.pass_contig_count += 1
        else:
            metrics.fail_contig_count += 1
    pass_cluster_stats = []
    for c in range(1, get_max_cluster(sequences) + 1):
        qc = qc_results[c]
        if qc.passed():
            metrics.pass_cluster_count += 1
            size = len(cluster_filenames.get(c, []))
            pass_cluster_stats.append((qc.cluster_dist, size))
        else:
            metrics.fail_cluster_count += 1
    metrics.calculate_fractions()
    metrics.calculate_scores(cluster_filenames, pass_cluster_stats)
    return metrics


# ---------------- outputs ----------------

def save_distance_matrix(distances: Dict[Tuple[int, int], float],
                         sequences: List[Sequence], file_path) -> None:
    """PHYLIP matrix with display names (reference cluster.rs:160-174)."""
    with open(file_path, "w") as f:
        f.write(f"{len(sequences)}\n")
        for a in sequences:
            f.write(str(a))
            for b in sequences:
                f.write(f"\t{distances[(a.id, b.id)]:.8f}")
            f.write("\n")


def save_cluster_gfa(sequences: List[Sequence], cluster_num: int,
                     graph: UnitigGraph, out_gfa
                     ) -> Tuple[UnitigGraph, List[Sequence]]:
    """Per-cluster graph: subset the in-memory graph to the cluster's
    sequences, recalc depths, drop zero-depth unitigs, merge linear paths
    (reference cluster.rs:794-822, which filters P-lines and re-loads the
    GFA text — the subset produces the identical graph without the text
    round trip). Returns (cluster_graph, cluster_seqs) so in-process
    callers can hand them to trim(preloaded=...)."""
    cluster_seqs = [_clone_seq(s) for s in sequences if s.cluster == cluster_num]
    cluster_graph = graph.subset_for_sequences([s.id for s in cluster_seqs])
    cluster_graph.recalculate_depths()
    cluster_graph.remove_zero_depth_unitigs()
    merge_linear_paths(cluster_graph, cluster_seqs)
    cluster_graph.save_gfa(out_gfa, cluster_seqs)
    return cluster_graph, cluster_seqs


def _clone_seq(s: Sequence) -> Sequence:
    return Sequence(s.id, s.forward_seq, s.reverse_seq, s.filename, s.contig_header,
                    s.length, s.cluster)


def save_clusters(sequences: List[Sequence], qc_results: Dict[int, ClusterQC],
                  clustering_dir, graph: UnitigGraph,
                  collect_handoff: bool = False
                  ) -> Dict[Path, Tuple[UnitigGraph, List[Sequence]]]:
    """Writes every cluster's 1_untrimmed.gfa/.yaml. With ``collect_handoff``
    returns {qc-pass cluster dir: (cluster graph, cluster sequences)} for an
    in-process trim(preloaded=...); otherwise {} and one cluster's graph is
    alive at a time."""
    handoff = {}
    for c in range(1, get_max_cluster(sequences) + 1):
        qc = qc_results[c]
        sub = "qc_pass" if qc.passed() else "qc_fail"
        cluster_dir = Path(clustering_dir) / sub / f"cluster_{c:03d}"
        os.makedirs(cluster_dir, exist_ok=True)
        log.message(f"Cluster {c:03d}:")
        lengths = [s.length for s in sequences if s.cluster == c]
        for s in sequences:
            if s.cluster == c:
                log.message(f"  {s}")
        if len(lengths) > 1:
            log.message(f"  cluster distance: {format_float(qc.cluster_dist)}")
        if qc.passed():
            log.message("  passed QC")
        else:
            for reason in qc.failure_reasons:
                log.message(f"  failed QC: {reason}")
        pair = save_cluster_gfa(sequences, c, graph, cluster_dir / "1_untrimmed.gfa")
        if collect_handoff and qc.passed():
            handoff[cluster_dir] = pair
        del pair
        UntrimmedClusterMetrics.new(lengths, qc.cluster_dist).save_to_yaml(
            cluster_dir / "1_untrimmed.yaml")
        log.message()
    return handoff


def save_data_to_tsv(sequences: List[Sequence], qc_results: Dict[int, ClusterQC],
                     file_path) -> None:
    with open(file_path, "w") as f:
        f.write("node_name\tpassing_clusters\tall_clusters\tsequence_id\tfile_name\t"
                "contig_name\tlength\ttrusted\tcluster_weight\tconsensus_weight\n")
        for seq in sequences:
            assert seq.cluster != 0
            qc = qc_results[seq.cluster]
            pass_cluster = str(seq.cluster) if qc.passed() else "none"
            f.write(f"{seq.string_for_newick()}\t{pass_cluster}\t{seq.cluster}\t"
                    f"{seq.id}\t{seq.filename}\t{seq.contig_name()}\t{seq.length}\t"
                    f"{str(seq.is_trusted()).lower()}\t{seq.cluster_weight()}\t"
                    f"{seq.consensus_weight()}\n")


# ---------------- distance backend selection ----------------

def resolve_distance_mode(n_contigs: int) -> str:
    """'exact' | 'sketch' | 'verify' from AUTOCYCLER_SKETCH_DISTANCE, as the
    JAX package resolves it: 'auto' (the default) means sketch from
    AUTOCYCLER_SKETCH_MIN_CONTIGS contigs on."""
    raw = env_str("AUTOCYCLER_SKETCH_DISTANCE").lower()
    if raw in ("0", "off", "false", "no", "exact"):
        return "exact"
    if raw in ("1", "on", "true", "yes", "sketch"):
        return "sketch"
    if raw == "verify":
        return "verify"
    threshold = env_int("AUTOCYCLER_SKETCH_MIN_CONTIGS")
    return "sketch" if n_contigs >= threshold else "exact"


def compute_distances(graph, sequences, device=None, autocycler_dir=None
                      ) -> Tuple[Dict[Tuple[int, int], float], dict]:
    """The cluster distance dict plus a record ``{"mode", "sketch_s",
    "sketch_max_abs_error"?}``, as the JAX package's. Sketch mode replaces
    the exact contraction with bottom-s minimizer sketches and their
    intersection grid on ``device`` (ops.sketch), the sketches kept in the
    warm-start cache of ``autocycler_dir``; 'verify' computes both, returns
    the exact distances and records the largest difference."""
    mode = resolve_distance_mode(len(sequences))
    record = {"mode": mode, "sketch_s": sketch_params()[2]}
    sketch = exact = None
    if mode in ("sketch", "verify"):
        sketch = sketch_contig_distances(graph, sequences, device,
                                         cache=open_cache(autocycler_dir))
    if mode in ("exact", "verify"):
        exact = pairwise_contig_distances(graph, sequences, device=device)
    if mode == "verify":
        record["sketch_max_abs_error"] = max(
            (abs(sketch[p] - exact[p]) for p in exact), default=0.0)
    return (exact if exact is not None else sketch), record


# ---------------- entry point ----------------

def cluster(autocycler_dir, cutoff: float = 0.2, min_assemblies: Optional[int] = None,
            max_contigs: int = 25, manual: Optional[str] = None,
            device=None, precomputed_distances=None,
            collect_handoff: bool = False
            ) -> Optional[Dict[Path, Tuple[UnitigGraph, List[Sequence]]]]:
    """The distances run on ``device`` (CUDA unless the caller asks for the
    CPU); everything else is host code. ``precomputed_distances``, an
    optional {(id_a, id_b): distance} dict, replaces the distance
    computation. With ``collect_handoff`` returns {qc-pass cluster dir:
    (graph, sequences)} for in-process trim(preloaded=...); else None."""
    autocycler_dir = Path(autocycler_dir)
    gfa = autocycler_dir / "input_assemblies.gfa"
    clustering_dir = autocycler_dir / "clustering"
    if not autocycler_dir.is_dir():
        quit_with_error(f"directory does not exist: {autocycler_dir}")
    if not gfa.is_file():
        quit_with_error(f"file does not exist: {gfa}")
    if cutoff <= 0.0 or cutoff >= 1.0:
        quit_with_error("--cutoff must be between 0 and 1 (exclusive)")
    if min_assemblies is not None and min_assemblies < 1:
        quit_with_error("--min_assemblies must be 1 or greater")
    dev = resolve_device(device)
    if clustering_dir.is_dir():
        shutil.rmtree(clustering_dir)
    os.makedirs(clustering_dir)

    log.section_header("Starting autocycler cluster")
    log.explanation("This command takes a unitig graph (made by autocycler compress) and "
                    "clusters the sequences based on their similarity. Ideally, each "
                    "cluster will then contain sequences which can be combined into a "
                    "consensus.")
    with stage_timer("cluster/load"):
        gfa_lines = load_file_lines(gfa)
        graph, sequences = UnitigGraph.from_gfa_lines(gfa_lines)
    min_asm = set_min_assemblies(min_assemblies, sequences)
    manual_clusters = parse_manual_clusters(manual)

    if not sequences:
        quit_with_error("no sequences found in input_assemblies.gfa")
    mean = len(sequences) / get_assembly_count(sequences)
    if mean > max_contigs:
        quit_with_error(
            f"the mean number of contigs per input assembly ({mean:.1f}) exceeds the "
            f"allowed threshold ({max_contigs}). Are your input assemblies fragmented "
            "or contaminated?")

    log.section_header("Pairwise distances")
    log.explanation("Every pairwise distance between contigs is calculated based on the "
                    "similarity of their paths through the graph.")
    with stage_timer("cluster/distances"):
        if precomputed_distances is not None:
            asym = precomputed_distances
            distance_record = {"mode": "precomputed"}
        else:
            asym, distance_record = compute_distances(
                graph, sequences, dev, autocycler_dir=autocycler_dir)
        obs_qc.record("cluster_distance", contigs=len(sequences),
                      **distance_record)
        save_distance_matrix(asym, sequences,
                             clustering_dir / "pairwise_distances.phylip")

    log.section_header("Clustering sequences")
    log.explanation("Contigs are organised into a tree using UPGMA. Then clusters are "
                    "defined from the tree using the distance cutoff.")
    with stage_timer("cluster/tree"):
        sym = make_symmetrical_distances(asym, sequences)
        tree = upgma(sym, sequences)
        normalise_tree(tree)
        save_tree_to_newick(tree, sequences, clustering_dir / "clustering.newick")

        qc_results = generate_clusters(tree, sequences, asym, cutoff, min_asm,
                                       manual_clusters)
    with stage_timer("cluster/outputs"):
        handoff = save_clusters(sequences, qc_results, clustering_dir, graph,
                                collect_handoff=collect_handoff)
        save_data_to_tsv(sequences, qc_results, clustering_dir / "clustering.tsv")
        clustering_metrics(sequences, qc_results).save_to_yaml(
            clustering_dir / "clustering.yaml")
    obs_qc.cluster_qc(sequences, qc_results)
    ledger.record_stage(
        "cluster", inputs=[gfa],
        outputs=[clustering_dir / "pairwise_distances.phylip",
                 clustering_dir / "clustering.newick",
                 clustering_dir / "clustering.tsv",
                 clustering_dir / "clustering.yaml"]
        + sorted(clustering_dir.glob("qc_*/cluster_*/1_untrimmed.gfa")),
        **{f"distance_{key}": value
           for key, value in distance_record.items()})

    log.section_header("Finished!")
    log.explanation("You can now run autocycler trim on each cluster.")
    log.message(f"Pairwise distances:         {clustering_dir / 'pairwise_distances.phylip'}")
    log.message(f"Clustering tree (Newick):   {clustering_dir / 'clustering.newick'}")
    log.message(f"Clustering tree (metadata): {clustering_dir / 'clustering.tsv'}")
    log.message()
    return handoff if collect_handoff else None
