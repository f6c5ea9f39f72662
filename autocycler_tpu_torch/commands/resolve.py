"""`autocycler resolve`: bridge anchor unitigs into a consensus path.

Parity target: reference resolve.rs. Anchors are unitigs occurring exactly
once in every sequence; every sequence path is cut into anchor-to-anchor
segments (strand-canonicalised), segments sharing (start, end) form a
Bridge whose best path is the medoid under weighted global-alignment
distance; non-conflicting bridges are applied, then the lowest-depth
conflicting bridges are culled until none conflict and bridges are
re-applied from a fresh graph. Writes 3_bridged.gfa, 4_merged.gfa,
5_final.gfa, byte for byte as the JAX package's commands/resolve.py does.

Every distinct-path pair of every bridge runs through the batched distance
DP on the device (ops.align.global_alignment_distance_batch), in batches by
path-length class.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from typing import Dict, List, Optional, Set, Tuple

from ..device import resolve_device
from ..models import Sequence, Unitig, UnitigGraph, UnitigType
from ..models.simplify import merge_linear_paths
from ..obs import ledger, qc
from ..ops.align import global_alignment_distance_batch
from ..utils import (load_file_lines, log, quit_with_error, reverse_signed_path,
                     sign_at_end, sign_at_end_vec)
from ..utils.timing import stage_timer

# medoid pairs of up to 2**6 unitigs share one device batch
_SHORT_PAIR_CLASS = 6


class Bridge:
    """An anchor-to-anchor connection with its supporting paths
    (reference resolve.rs:420-514)."""

    __slots__ = ("start", "end", "all_paths", "best_path", "conflicting")

    def __init__(self, start: int, end: int, all_paths: List[List[int]],
                 pair_distances: Dict[tuple, int]):
        trimmed = [path[1:-1] for path in all_paths]
        # The medoid objective Σ_j d(i, j) over occurrences equals
        # Σ_distinct_j mult_j · d(i, j) (self-distance is 0), so distances
        # are computed between DISTINCT paths only — groups are dominated by
        # duplicates since most assemblies agree on each bridge.
        # pair_distances holds every distinct pair (smaller path first) from
        # the device DP (_batched_medoid_distances); a missing pair raises.
        mult: Dict[tuple, int] = {}
        for path in trimmed:
            mult[tuple(path)] = mult.get(tuple(path), 0) + 1
        distinct = sorted(mult)  # lexicographic: ties resolve to smaller path

        def dist(pi: tuple, pj: tuple) -> int:
            return pair_distances[(pi, pj) if pi < pj else (pj, pi)]

        best_path: List[int] = []
        best_total = None
        for path_i in distinct:
            total = 0
            for path_j, m in mult.items():
                if path_j != path_i:
                    total += m * dist(path_i, path_j)
            if best_total is None or total < best_total:
                best_total = total
                best_path = list(path_i)
        self.start = start
        self.end = end
        self.all_paths = trimmed
        self.best_path = best_path
        self.conflicting = False

    def rev_start(self) -> int:
        return -self.end

    def rev_end(self) -> int:
        return -self.start

    def depth(self) -> int:
        return len(self.all_paths)

    def sort_key(self):
        """(|start| asc, start desc, |end| asc, end desc, best_path asc) —
        reference resolve.rs Ord impl."""
        return (abs(self.start), -self.start, abs(self.end), -self.end, self.best_path)

    def __repr__(self):
        if not self.best_path:
            return f"{sign_at_end(self.start)} -> {sign_at_end(self.end)} ({self.depth()}x)"
        return (f"{sign_at_end(self.start)} -> {sign_at_end_vec(self.best_path)} -> "
                f"{sign_at_end(self.end)} ({self.depth()}x)")


def find_anchor_unitigs(graph: UnitigGraph, sequences: List[Sequence]) -> List[int]:
    """Anchors occur once and only once in every sequence
    (reference resolve.rs:134-163)."""
    all_seq_ids = np.sort(np.array([s.id for s in sequences], np.int32))
    anchor_ids = []
    for unitig in graph.unitigs:
        forward_seq_ids = np.sort(unitig.forward_positions.seq_id)
        if np.array_equal(forward_seq_ids, all_seq_ids):
            unitig.unitig_type = UnitigType.ANCHOR
            anchor_ids.append(unitig.number)
    n = len(anchor_ids)
    log.message(f"{n} anchor unitig{'' if n == 1 else 's'} found")
    log.message()
    return anchor_ids


def get_anchor_to_anchor_paths(sequence_paths: List[List[int]],
                               anchor_set: Set[int]) -> List[List[int]]:
    """Cut each path at anchors, canonicalising each segment to the
    lexicographically larger of itself and its reverse
    (reference resolve.rs:344-365)."""
    out = []
    for path in sequence_paths:
        last_anchor_i: Optional[int] = None
        for i, value in enumerate(path):
            if abs(value) in anchor_set:
                if last_anchor_i is not None:
                    forward = path[last_anchor_i:i + 1]
                    reverse = reverse_signed_path(forward)
                    out.append(forward if forward > reverse else reverse)
                last_anchor_i = i
    return out


def group_paths_by_start_end(paths: List[List[int]]
                             ) -> Dict[Tuple[int, int], List[List[int]]]:
    grouped: Dict[Tuple[int, int], List[List[int]]] = {}
    for path in paths:
        if path:
            grouped.setdefault((path[0], path[-1]), []).append(path)
    return grouped


def create_bridges(graph: UnitigGraph, sequences: List[Sequence], anchors: List[int],
                   verbose: bool = False, device=None) -> List[Bridge]:
    """One Bridge per (start, end) anchor pair; sequences contribute their
    path consensus_weight times (reference resolve.rs:166-190)."""
    anchor_set = set(anchors)
    all_paths = graph.get_unitig_paths_for_sequences([s.id for s in sequences])
    sequence_paths = []
    for s in sequences:
        weight = s.consensus_weight()
        if verbose:
            log.message(f"{s} consensus weight = {weight}")
        path = [n if st else -n for n, st in all_paths[s.id]]
        sequence_paths.extend([list(path) for _ in range(weight)])
    a_to_a = get_anchor_to_anchor_paths(sequence_paths, anchor_set)
    grouped = group_paths_by_start_end(a_to_a)
    unitig_lengths = {u.number: u.length() for u in graph.unitigs}
    pair_distances = _batched_medoid_distances(grouped, unitig_lengths, device)
    bridges = [Bridge(start, end, paths, pair_distances)
               for (start, end), paths in grouped.items()]
    bridges.sort(key=Bridge.sort_key)
    return bridges


def _batched_medoid_distances(grouped, unitig_lengths, device) -> Dict[tuple, int]:
    """Every bridge group's distinct-path pairs through the batched DP on
    ``device`` (ops.align.global_alignment_distance_batch) instead of
    O(paths^2) tiny calls per bridge (reference resolve.rs:387-418 scope).
    A batch pads every pair to its longest, so pairs go in batches by the
    power-of-two class of their longer path (all pairs of up to 64 unitigs
    in one): a long pair never multiplies the short pairs' cost."""
    wanted = {}
    for paths in grouped.values():
        distinct = sorted({tuple(p[1:-1]) for p in paths})
        for i, pi in enumerate(distinct):
            for pj in distinct[i + 1:]:
                wanted.setdefault((pi, pj), None)
    classes: Dict[int, List[tuple]] = {}
    for pair in wanted:
        longest = max(len(pair[0]), len(pair[1]))
        classes.setdefault(max(_SHORT_PAIR_CLASS, (longest - 1).bit_length()),
                           []).append(pair)
    out = {}
    for cls in sorted(classes):
        pairs = classes[cls]
        dists = global_alignment_distance_batch(pairs, unitig_lengths, device)
        out.update((pair, int(d)) for pair, d in zip(pairs, dists))
    return out


def determine_ambiguity(bridges: List[Bridge]) -> int:
    """Mark bridges sharing a start or end (on either strand) as conflicting
    (reference resolve.rs:193-220)."""
    start_count: Dict[int, int] = {}
    end_count: Dict[int, int] = {}
    for b in bridges:
        start_count[b.start] = start_count.get(b.start, 0) + 1
        start_count[b.rev_start()] = start_count.get(b.rev_start(), 0) + 1
        end_count[b.end] = end_count.get(b.end, 0) + 1
        end_count[b.rev_end()] = end_count.get(b.rev_end(), 0) + 1
    ambi_starts = {n for n, c in start_count.items() if c > 1}
    ambi_ends = {n for n, c in end_count.items() if c > 1}
    count = 0
    for b in bridges:
        b.conflicting = (b.start in ambi_starts or b.rev_start() in ambi_starts
                         or b.end in ambi_ends or b.rev_end() in ambi_ends)
        count += b.conflicting
    return count


def apply_bridges(graph: UnitigGraph, bridges: List[Bridge], bridge_depth: float) -> None:
    """Apply non-conflicting bridges: replace the links out of each start and
    into each end with a bridge unitig (or a direct link for empty paths),
    reduce constituent depths, drop anchor-less components
    (reference resolve.rs:223-251)."""
    graph.clear_positions()
    next_num = graph.max_unitig_number()
    for bridge in bridges:
        if bridge.conflicting:
            continue
        graph.delete_outgoing_links(bridge.start)
        graph.delete_incoming_links(bridge.end)
        if not bridge.best_path:
            graph.create_link(bridge.start, bridge.end)
        else:
            bridge_seq = graph.get_sequence_from_path_signed(bridge.best_path)
            next_num += 1
            bridge_num = next_num
            unitig = Unitig.bridge(bridge_num, bridge_seq, bridge_depth)
            graph.unitigs.append(unitig)
            graph.index[bridge_num] = unitig
            _reduce_depths(graph, bridge)
            graph.create_link(bridge.start, bridge_num)
            graph.create_link(bridge_num, bridge.end)
    _delete_unitigs_not_connected_to_anchor(graph)
    graph.remove_zero_depth_unitigs()


def _reduce_depths(graph: UnitigGraph, bridge: Bridge) -> None:
    for path in bridge.all_paths:
        for signed_num in path:
            graph.index[abs(signed_num)].reduce_depth_by_one()


def _delete_unitigs_not_connected_to_anchor(graph: UnitigGraph) -> None:
    to_delete: Set[int] = set()
    for component in graph.connected_components():
        if all(graph.index[num].unitig_type is not UnitigType.ANCHOR
               for num in component):
            to_delete.update(component)
    graph.remove_unitigs_by_number(to_delete)


def merge_after_bridging(graph: UnitigGraph) -> None:
    merge_linear_paths(graph, [])
    graph.print_basic_graph_info()
    graph.renumber_unitigs()


def print_bridges(bridges: List[Bridge], verbose: bool) -> None:
    """Bridge summary, or every bridge when verbose (reference
    resolve.rs:316-341)."""
    unique = [b for b in bridges if not b.conflicting]
    conflicting = [b for b in bridges if b.conflicting]
    if verbose:
        if unique:
            log.message("Unique bridges:")
            for b in unique:
                log.message(f"  {b}")
        if conflicting:
            log.message("")
            log.message("Conflicting bridges:")
            for b in conflicting:
                log.message(f"  {b}")
    else:
        log.message(f"     Unique bridges: {len(unique)}")
        log.message(f"Conflicting bridges: {len(conflicting)}")
    log.message()


def cull_ambiguity(bridges: List[Bridge], verbose: bool = False) -> int:
    """Iteratively remove the lowest-depth conflicting bridge until no
    conflicts remain (reference resolve.rs:285-313)."""
    ambi = [b for b in bridges if b.conflicting]
    if not ambi:
        return 0
    log.section_header("Culling conflicting bridges")
    log.explanation("The least-supported conflicting bridges are now culled until no "
                    "bridges conflict.")
    cull_count = 0
    while ambi:
        ambi.sort(key=lambda b: (b.depth(),) + b.sort_key())
        to_cull = ambi[0]
        if verbose:
            log.message(f"  {to_cull}")
        idx = next(i for i, b in enumerate(bridges)
                   if b.start == to_cull.start and b.end == to_cull.end)
        bridges.pop(idx)
        cull_count += 1
        determine_ambiguity(bridges)
        ambi = [b for b in bridges if b.conflicting]
    log.message(f"{cull_count} conflicting bridge{'' if cull_count == 1 else 's'} culled")
    log.message()
    return cull_count


def resolve(cluster_dir, verbose: bool = False, device=None,
            preloaded=None) -> None:
    """The medoid distance DPs run on ``device`` (CUDA unless the caller
    asks for the CPU). ``preloaded`` is an optional (graph, sequences) pair
    as ``trim`` returns it, used in place of parsing 2_trimmed.gfa; the file
    stays the record, and is read when culling needs the pristine graph."""
    dev = resolve_device(device)
    cluster_dir = Path(cluster_dir)
    trimmed_gfa = cluster_dir / "2_trimmed.gfa"
    if not cluster_dir.is_dir():
        quit_with_error(f"directory does not exist: {cluster_dir}")
    if not trimmed_gfa.is_file():
        quit_with_error(f"file does not exist: {trimmed_gfa}")

    log.section_header("Starting autocycler resolve")
    log.explanation("This command resolves repeats in the unitig graph.")
    with stage_timer("resolve/load"):
        if preloaded is not None:
            graph, sequences = preloaded
            gfa_lines = None
            graph.check_links()     # as parsing the file checks them
        else:
            gfa_lines = load_file_lines(trimmed_gfa)
            graph, sequences = UnitigGraph.from_gfa_lines(gfa_lines)
    graph.print_basic_graph_info()

    log.section_header("Finding anchor unitigs")
    log.explanation("Anchor unitigs are those that occur once and only once in each "
                    "sequence. They will definitely be present in the final sequence and "
                    "will serve as the connection points for bridges.")
    with stage_timer("resolve/anchors"):
        anchors = find_anchor_unitigs(graph, sequences)

    log.section_header("Building bridges")
    log.explanation("Bridges connect one anchor unitig to the next.")
    with stage_timer("resolve/bridges"):
        bridges = create_bridges(graph, sequences, anchors, verbose, dev)
        bridge_count = len(bridges)
        bridge_depth = float(len(sequences))
        conflicting = determine_ambiguity(bridges)
    print_bridges(bridges, verbose)

    log.section_header("Applying unique bridges")
    log.explanation("All unique bridges (those that do not conflict with other bridges) "
                    "are now applied to the graph, with linear paths merged to create "
                    "consentigs.")
    with stage_timer("resolve/apply"):
        apply_bridges(graph, bridges, bridge_depth)
        graph.save_gfa(cluster_dir / "3_bridged.gfa", [])
        merge_after_bridging(graph)
        graph.save_gfa(cluster_dir / "4_merged.gfa", [])

        cull_count = cull_ambiguity(bridges, verbose)
        if cull_count > 0:
            # the bridges were applied to the graph in hand: start again
            # from the file's
            if gfa_lines is None:
                gfa_lines = load_file_lines(trimmed_gfa)
            graph, _ = UnitigGraph.from_gfa_lines(gfa_lines)
            for num in anchors:
                graph.index[num].unitig_type = UnitigType.ANCHOR
            log.section_header("Applying final bridges")
            log.explanation("Now that conflicting bridges have been removed, bridges are "
                            "applied one more time to create the final graph.")
            apply_bridges(graph, bridges, bridge_depth)
            merge_after_bridging(graph)
        elif bridge_count > 0:
            log.message("All bridges were unique, no culling necessary.")
            log.message()

        final_gfa = cluster_dir / "5_final.gfa"
        graph.save_gfa(final_gfa, [], use_other_colour=True)
    qc.resolve_qc(cluster_dir.name, len(anchors), bridges, conflicting,
                  cull_count)
    ledger.record_stage("resolve", inputs=[trimmed_gfa],
                        outputs=[cluster_dir / "3_bridged.gfa",
                                 cluster_dir / "4_merged.gfa", final_gfa],
                        cluster=cluster_dir.name)
    log.section_header("Finished!")
    log.message(f"Final consensus graph: {final_gfa}")
    log.message()
