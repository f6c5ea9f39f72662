"""Graph-structure simplification: repeat expansion and linear-path merging.

Parity target: reference graph_simplification.rs.
- expand_repeats (:43-86) shifts common flanking sequence from branch unitigs
  into the shared repeat unitig until a fixpoint, e.g.

      ACTACTCAACT                    ACTACTC
                 \\                          \\
                  ATCGACTACGCTACG  ->         AACTATCGACTACGCTACGGCTA ...
                 /                          /
      GACTACGAACT                    GACTACG

  guarded so sequence paths keep unique start/end unitigs (:89-230).
- merge_linear_paths (:315-371) collapses 1-in/1-out chains, preserving path
  endpoints, circular loops and self-links.

These run on the host: the mutation pattern is irregular, but the sequences
being shuffled are numpy views so there is no byte copying beyond the edits.
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

from ..utils import FORWARD, REVERSE
from .sequence import Sequence
from .unitig import Unitig, UnitigStrand, UnitigType
from .unitig_graph import UnitigGraph


def simplify_structure(graph: UnitigGraph, seqs: List[Sequence]) -> None:
    """expand_repeats to fixpoint, then renumber
    (reference graph_simplification.rs:26-40).

    The fixed start/end sets are computed once: shifting sequence between
    unitigs never adds, removes or reorders path entries (and links are
    untouched), so the sets are invariant across iterations — the reference
    recomputes them each sweep with the same result."""
    fixed = get_fixed_unitig_starts_and_ends(graph, seqs)
    candidates = None  # first sweep visits everything
    while True:
        shifted, affected = _expand_repeats_pass(graph, seqs, fixed, candidates)
        if shifted == 0:
            break
        candidates = affected
    graph.renumber_unitigs()


def expand_repeats(graph: UnitigGraph, seqs: List[Sequence], fixed=None) -> int:
    """One full sweep of repeat expansion; returns total bases shifted
    (reference graph_simplification.rs:43-86)."""
    if fixed is None:
        fixed = get_fixed_unitig_starts_and_ends(graph, seqs)
    return _expand_repeats_pass(graph, seqs, fixed, None)[0]


def _expand_repeats_pass(graph: UnitigGraph, seqs: List[Sequence], fixed,
                         candidates) -> Tuple[int, Set[int]]:
    """One sweep in graph order; returns (bases shifted, the running
    ``affected`` set — every unitig a shift touched plus its immediate
    neighbours).

    ``candidates`` (None = visit all) restricts the sweep: a unitig is
    visited when it is in ``candidates`` OR already in ``affected`` (a shift
    EARLIER IN THIS SWEEP touched its neighbourhood). This reproduces the
    reference's re-sweep-everything fixpoint (graph_simplification.rs:33-39)
    exactly: a unitig's outcome depends only on its own seq/positions and
    its sources' (all within one link), so a skipped unitig — one no shift
    has touched since it last evaluated to 0 — would evaluate to 0 again,
    and every potentially non-zero unitig is visited at the same position
    in the same sweep as the reference's full sweep would visit it (units
    enabled mid-sweep by an earlier shift enter ``affected`` immediately;
    units before the enabling shift are re-visited next sweep, when the
    reference also re-visits them)."""
    fixed_starts, fixed_ends = fixed
    total_shifted = 0
    affected: Set[int] = set()

    def note_shift(centre: int, sources) -> None:
        touched = [centre] + [s.number for s in sources]
        affected.update(touched)
        for n in touched:
            u = graph.index[n]
            for links in (u.forward_next, u.forward_prev,
                          u.reverse_next, u.reverse_prev):
                affected.update(l.number for l in links)

    for unitig in graph.unitigs:
        number = unitig.number
        if (candidates is not None and number not in candidates
                and number not in affected):
            continue
        inputs = get_exclusive_inputs(unitig)
        if len(inputs) >= 2 and number not in fixed_starts:
            can_shift = all(
                not (inp.strand and inp.number in fixed_ends
                     or not inp.strand and inp.number in fixed_starts)
                for inp in inputs)
            if can_shift:
                amount = _shift_seq_into_start(inputs, unitig)
                if amount:
                    total_shifted += amount
                    note_shift(number, inputs)
        outputs = get_exclusive_outputs(unitig)
        if len(outputs) >= 2 and number not in fixed_ends:
            can_shift = all(
                not (out.strand and out.number in fixed_starts
                     or not out.strand and out.number in fixed_ends)
                for out in outputs)
            if can_shift:
                amount = _shift_seq_into_end(unitig, outputs)
                if amount:
                    total_shifted += amount
                    note_shift(number, outputs)
    return total_shifted, affected


def _shift_seq_into_start(sources: List[UnitigStrand], destination: Unitig) -> int:
    """Move common end-sequence of sources onto the destination's start
    (reference shift_sequence_1, graph_simplification.rs:89-119)."""
    common = _common_end_seq(sources)
    common = _avoid_zero_len_unitigs(common, sources, trim_from_start=True)
    common = _avoid_start_of_path(common, destination, trim_from_start=True)
    amount = len(common)
    if amount == 0:
        return 0
    for source in sources:
        if source.strand:
            source.unitig.remove_seq_from_end(amount)
        else:
            source.unitig.remove_seq_from_start(amount)
    destination.add_seq_to_start(common)
    return amount


def _shift_seq_into_end(destination: Unitig, sources: List[UnitigStrand]) -> int:
    """Move common start-sequence of sources onto the destination's end
    (reference shift_sequence_2, graph_simplification.rs:122-142)."""
    common = _common_start_seq(sources)
    common = _avoid_zero_len_unitigs(common, sources, trim_from_start=False)
    common = _avoid_start_of_path(common, destination, trim_from_start=False)
    amount = len(common)
    if amount == 0:
        return 0
    for source in sources:
        if source.strand:
            source.unitig.remove_seq_from_start(amount)
        else:
            source.unitig.remove_seq_from_end(amount)
    destination.add_seq_to_end(common)
    return amount


def _avoid_zero_len_unitigs(common: np.ndarray, sources: List[UnitigStrand],
                            trim_from_start: bool) -> np.ndarray:
    """Trim the common sequence so no source unitig reaches zero length;
    doubled requirement when a unitig appears in sources on both strands
    (reference graph_simplification.rs:145-161)."""
    if len(common) == 0:
        return common
    numbers = [s.number for s in sources]
    dup = 2 if len(set(numbers)) != len(numbers) else 1
    min_len = min(s.length() for s in sources)
    while len(common) and min_len <= len(common) * dup:
        common = common[1:] if trim_from_start else common[:-1]
    return common


def _avoid_start_of_path(common: np.ndarray, dest: Unitig,
                         trim_from_start: bool) -> np.ndarray:
    """Trim the common sequence so no destination position reaches the start
    of a path (reference graph_simplification.rs:164-181)."""
    if len(common) == 0:
        return common
    positions = dest.forward_positions if trim_from_start else dest.reverse_positions
    if len(positions):
        # the while-loop's fixpoint is min_pos > len(common); min is invariant
        min_pos = int(positions.pos.min())
        keep = min(len(common), max(0, min_pos - 1))
        common = common[len(common) - keep:] if trim_from_start else common[:keep]
    return common


def get_fixed_unitig_starts_and_ends(graph: UnitigGraph, sequences: List[Sequence]
                                     ) -> Tuple[Set[int], Set[int]]:
    """Unitigs whose start/end (forward-strand terms) must not change because
    a sequence path begins or ends there, plus their immediate neighbours
    (reference graph_simplification.rs:190-230)."""
    fixed_starts: Set[int] = set()
    fixed_ends: Set[int] = set()
    paths = graph.get_unitig_paths_for_sequences([s.id for s in sequences])
    for seq in sequences:
        path = paths[seq.id]
        if not path:
            continue
        first_unitig, first_strand = path[0]
        (fixed_starts if first_strand else fixed_ends).add(first_unitig)
        last_unitig, last_strand = path[-1]
        (fixed_ends if last_strand else fixed_starts).add(last_unitig)

    for u in list(fixed_starts):
        for upstream in graph.index[u].forward_prev:
            (fixed_ends if upstream.strand else fixed_starts).add(upstream.number)
    for u in list(fixed_ends):
        for downstream in graph.index[u].forward_next:
            (fixed_starts if downstream.strand else fixed_ends).add(downstream.number)
    return fixed_starts, fixed_ends


def get_exclusive_inputs(unitig: Unitig) -> List[UnitigStrand]:
    """Unitigs that feed ONLY into the given unitig; empty when any input is
    shared or is the unitig itself (reference graph_simplification.rs:233-255)."""
    inputs = []
    for prev in unitig.forward_prev:
        nxt = prev.unitig.forward_next if prev.strand else prev.unitig.reverse_next
        if not (len(nxt) == 1 and nxt[0].strand and nxt[0].number == unitig.number):
            return []
        inputs.append(UnitigStrand(prev.unitig, prev.strand))
    if any(inp.number == unitig.number for inp in inputs):
        return []
    return inputs


def get_exclusive_outputs(unitig: Unitig) -> List[UnitigStrand]:
    """Unitigs the given unitig feeds into exclusively
    (reference graph_simplification.rs:258-280)."""
    outputs = []
    for nxt in unitig.forward_next:
        prevs = nxt.unitig.forward_prev if nxt.strand else nxt.unitig.reverse_prev
        if not (len(prevs) == 1 and prevs[0].strand and prevs[0].number == unitig.number):
            return []
        outputs.append(UnitigStrand(nxt.unitig, nxt.strand))
    if any(out.number == unitig.number for out in outputs):
        return []
    return outputs


def _common_start_seq(unitigs: List[UnitigStrand]) -> np.ndarray:
    """Longest common prefix of the unitigs' strand-specific sequences
    (reference graph_simplification.rs:283-295). Probes only a
    min-length window of each strand (seq_prefix), never the full
    reverse-strand sequence."""
    if not unitigs:
        return np.zeros(0, np.uint8)
    prefix_len = min(u.length() for u in unitigs)
    first = unitigs[0].seq_prefix(prefix_len)
    for u in unitigs[1:]:
        if prefix_len == 0:
            break
        s = u.seq_prefix(prefix_len)
        neq = np.nonzero(first[:prefix_len] != s)[0]
        if len(neq):
            prefix_len = int(neq[0])
    return first[:prefix_len].copy()


def _common_end_seq(unitigs: List[UnitigStrand]) -> np.ndarray:
    """Longest common suffix (reference graph_simplification.rs:298-312),
    windowed like :func:`_common_start_seq`."""
    if not unitigs:
        return np.zeros(0, np.uint8)
    suffix_len = min(u.length() for u in unitigs)
    first = unitigs[0].seq_suffix(suffix_len)
    for u in unitigs[1:]:
        if suffix_len == 0:
            break
        s = u.seq_suffix(suffix_len)
        neq = np.nonzero(first[len(first) - suffix_len:] != s)[0]
        if len(neq):
            suffix_len = suffix_len - int(neq[-1]) - 1
    return (first[len(first) - suffix_len:].copy() if suffix_len
            else np.zeros(0, np.uint8))


# ---------------- linear-path merging ----------------

def merge_linear_paths(graph: UnitigGraph, seqs: List[Sequence]) -> None:
    """Collapse 1-in/1-out chains into single unitigs, respecting sequence
    path endpoints and circular-loop components
    (reference graph_simplification.rs:315-371)."""
    fixed_starts, fixed_ends = get_fixed_unitig_starts_and_ends(graph, seqs)
    _fix_circular_loops(graph, fixed_starts)
    already_used: Set[int] = set()
    merge_paths: List[List[UnitigStrand]] = []
    for unitig in graph.unitigs:
        number = unitig.number
        for strand in (FORWARD, REVERSE):
            if number in already_used:
                continue
            if (_has_single_exclusive_input(unitig, strand)
                    and not _cannot_merge_start(number, strand, fixed_starts, fixed_ends)):
                continue
            current = [UnitigStrand(unitig, strand)]
            already_used.add(number)
            while True:
                last = current[-1]
                if _cannot_merge_end(last.number, last.strand, fixed_starts, fixed_ends):
                    break
                outputs = (get_exclusive_outputs(last.unitig) if last.strand
                           else get_exclusive_inputs(last.unitig))
                if len(outputs) != 1:
                    break
                output = outputs[0]
                if not last.strand:
                    output = output.flipped()
                if output.number in already_used:
                    break
                if _cannot_merge_start(output.number, output.strand,
                                       fixed_starts, fixed_ends):
                    break
                current.append(output)
                already_used.add(output.number)
            if len(current) > 1:
                merge_paths.append(current)

    new_number = graph.max_unitig_number()
    for path in merge_paths:
        new_number += 1
        _merge_path(graph, path, new_number)
    graph.delete_dangling_links()
    graph.build_index()
    graph.check_links()


def _fix_circular_loops(graph: UnitigGraph, fixed_starts: Set[int]) -> None:
    """Mark the lowest-numbered unitig of each simple circular-loop component
    as a fixed start so the loop merges into one unitig
    (reference graph_simplification.rs:374-384)."""
    for component in graph.connected_components():
        if graph.component_is_circular_loop(component):
            fixed_starts.add(component[0])


def _cannot_merge_start(number: int, strand: bool, fixed_starts: Set[int],
                        fixed_ends: Set[int]) -> bool:
    return ((strand and number in fixed_starts)
            or (not strand and number in fixed_ends))


def _cannot_merge_end(number: int, strand: bool, fixed_starts: Set[int],
                      fixed_ends: Set[int]) -> bool:
    return ((strand and number in fixed_ends)
            or (not strand and number in fixed_starts))


def _has_single_exclusive_input(unitig: Unitig, strand: bool) -> bool:
    inputs = get_exclusive_inputs(unitig) if strand else get_exclusive_outputs(unitig)
    return len(inputs) == 1


def _merge_path(graph: UnitigGraph, path: List[UnitigStrand], new_number: int) -> None:
    """Replace a linear path with one merged unitig, rewiring neighbour and
    self links (reference graph_simplification.rs:410-485)."""
    merged_seq = np.concatenate([u.get_seq() for u in path])
    first, last = path[0], path[-1]
    forward_positions = (first.unitig.forward_positions if first.strand
                         else first.unitig.reverse_positions).copy()
    reverse_positions = (last.unitig.reverse_positions if last.strand
                         else last.unitig.forward_positions).copy()

    end_to_start = graph.link_exists(last.number, last.strand, first.number, first.strand)
    start_flip = graph.link_exists(first.number, not first.strand, first.number, first.strand)
    end_flip = graph.link_exists(last.number, last.strand, last.number, not last.strand)

    forward_prev = list(first.unitig.forward_prev if first.strand
                        else first.unitig.reverse_prev)
    reverse_next = list(first.unitig.reverse_next if first.strand
                        else first.unitig.forward_next)
    forward_next = list(last.unitig.forward_next if last.strand
                        else last.unitig.reverse_next)
    reverse_prev = list(last.unitig.reverse_prev if last.strand
                        else last.unitig.forward_prev)

    unitig = Unitig(new_number, merged_seq)
    unitig.depth = _merge_path_depth(path, forward_positions)
    unitig.forward_positions = forward_positions
    unitig.reverse_positions = reverse_positions
    unitig.forward_next = forward_next
    unitig.forward_prev = forward_prev
    unitig.reverse_next = reverse_next
    unitig.reverse_prev = reverse_prev
    if any(p.is_anchor() or p.is_consentig() for p in path):
        unitig.unitig_type = UnitigType.CONSENTIG
    graph.invalidate_paths_cache()
    graph.unitigs.append(unitig)

    for u in unitig.forward_next:
        (u.unitig.forward_prev if u.strand else u.unitig.reverse_prev).append(
            UnitigStrand(unitig, FORWARD))
    for u in unitig.forward_prev:
        (u.unitig.forward_next if u.strand else u.unitig.reverse_next).append(
            UnitigStrand(unitig, FORWARD))
    for u in unitig.reverse_next:
        (u.unitig.forward_prev if u.strand else u.unitig.reverse_prev).append(
            UnitigStrand(unitig, REVERSE))
    for u in unitig.reverse_prev:
        (u.unitig.forward_next if u.strand else u.unitig.reverse_next).append(
            UnitigStrand(unitig, REVERSE))

    if end_to_start:
        unitig.forward_next.append(UnitigStrand(unitig, FORWARD))
        unitig.forward_prev.append(UnitigStrand(unitig, FORWARD))
        unitig.reverse_next.append(UnitigStrand(unitig, REVERSE))
        unitig.reverse_prev.append(UnitigStrand(unitig, REVERSE))
    if start_flip:
        unitig.reverse_next.append(UnitigStrand(unitig, FORWARD))
        unitig.forward_prev.append(UnitigStrand(unitig, REVERSE))
    if end_flip:
        unitig.forward_next.append(UnitigStrand(unitig, REVERSE))
        unitig.reverse_prev.append(UnitigStrand(unitig, FORWARD))

    path_numbers = {u.number for u in path}
    graph.unitigs = [u for u in graph.unitigs if u.number not in path_numbers]


def _merge_path_depth(path: List[UnitigStrand], forward_positions) -> float:
    """Position count if available, else anchor depth, else length-weighted
    mean (reference graph_simplification.rs:501-526)."""
    if len(forward_positions):
        return float(len(forward_positions))
    for u in path:
        if u.is_anchor():
            return u.depth()
    total_length = sum(u.length() for u in path)
    return sum(u.depth() * u.length() for u in path) / total_length
