"""`autocycler trim`: remove start-end (circular) and hairpin (linear)
overlaps from each contig's unitig path.

Parity target: reference trim.rs, and the JAX package's commands/trim.py
byte for byte. This module owns the trimming policy: start-end trim cuts at
the alignment's weighted midpoint, hairpin trims use reverse-path
alignment, the more successful trim type wins, length outliers beyond
--mad MADs are excluded, and the graph is rebuilt.

The weighted path-overlap DPs run on the device (ops.align). Each sequence
gives three jobs on its original path (start-end, hairpin start, hairpin
end); the exact host screen clears the jobs that provably find nothing, and
the rest run in one batched DP, and each job's decoded pieces (``[]`` when
it finds no alignment) go to its path-level trim. A hairpin-end DP on a
path whose start was trimmed is a DP on another path: it runs in a second
device round. No alignment DP runs on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..metrics import TrimmedClusterMetrics
from ..models import Sequence, UnitigGraph
from ..models.simplify import merge_linear_paths
from ..obs import ledger, qc
from ..ops.align import (GAP, AlignmentPiece, Weights, find_midpoint,
                         overlap_may_be_positive, overlap_tracebacks_batch)
from ..utils import (check_threads, log, mad as mad_fn, median,
                     quit_with_error, reverse_signed_path)
from ..utils.pool import pool_map
from ..utils.timing import stage_timer

TrimResult = Optional[Tuple[List[int], int]]
# (seq_id, kind) -> the decoded alignment pieces, [] where there is none;
# kind is 'start_end', 'hairpin_start' or 'hairpin_end'
Alignments = Dict[Tuple[int, str], List[AlignmentPiece]]


def overlap_screen(jobs, min_identity: float, max_unitigs: int,
                   device) -> Alignments:
    """{key: (path_a, path_b, weights, skip_diagonal)} → {key: pieces}: the
    jobs the exact host screen clears get [], the rest run through one
    batched device DP and carry their decoded pieces."""
    keys = [key for key, job in jobs.items()
            if overlap_may_be_positive(job, max_unitigs)]
    alignments: Alignments = {key: [] for key in jobs}
    alignments.update(zip(keys, overlap_tracebacks_batch(
        [jobs[key] for key in keys], max_unitigs, min_identity, device)))
    return alignments


def trim(cluster_dir, min_identity: float = 0.75, max_unitigs: int = 5000,
         mad: float = 5.0, threads: int = 1, device=None, preloaded=None
         ) -> Tuple[UnitigGraph, List[Sequence]]:
    """The overlap DPs run on ``device`` (CUDA unless the caller asks for
    the CPU); ``threads`` runs the per-sequence host work that follows them
    on that many pool threads, with the log kept in sequence order, so no
    output byte depends on it. ``preloaded`` is an optional (graph, sequences) pair handed over
    in memory by ``cluster(collect_handoff=True)``, used in place of parsing
    1_untrimmed.gfa. Returns the trimmed (graph, sequences), which an
    in-process caller can hand to ``resolve(preloaded=...)``; 2_trimmed.gfa
    is written all the same and stays the record."""
    dev = resolve_device(device)
    cluster_dir = Path(cluster_dir)
    untrimmed_gfa = cluster_dir / "1_untrimmed.gfa"
    trimmed_gfa = cluster_dir / "2_trimmed.gfa"
    trimmed_yaml = cluster_dir / "2_trimmed.yaml"
    if not cluster_dir.is_dir():
        quit_with_error(f"directory does not exist: {cluster_dir}")
    if not untrimmed_gfa.is_file():
        quit_with_error(f"file does not exist: {untrimmed_gfa}")
    if not 0.0 <= min_identity <= 1.0:
        quit_with_error("--min_identity must be between 0.0 and 1 (inclusive)")
    if mad < 0.0:
        quit_with_error("--mad cannot be less than 0")
    check_threads(threads)

    log.section_header("Starting autocycler trim")
    log.explanation("This command takes a single-cluster unitig graph (made by autocycler "
                    "cluster) and trims any overlaps. It looks for both start-end overlaps "
                    "(can occur with circular sequences) and hairpin overlaps (can occur "
                    "with linear sequences).")
    with stage_timer("trim/load"):
        graph, sequences = preloaded if preloaded is not None else \
            UnitigGraph.from_gfa_file(untrimmed_gfa)
        graph.print_basic_graph_info()
        # dense number -> length array: scalar indexing works like a dict
        max_num = max((u.number for u in graph.unitigs), default=0)
        weights = np.zeros(max_num + 1, dtype=np.int64)
        for u in graph.unitigs:
            weights[u.number] = u.length()
        # one path query serves both trimming passes (the graph is unchanged
        # until choose_trim_type applies the results)
        all_paths = graph.get_unitig_paths_for_sequences(
            [s.id for s in sequences]) if max_unitigs else {}
    orig_lengths = {s.id: s.length for s in sequences}
    with stage_timer("trim/overlaps"):
        paths = {seq_id: [n if s else -n for n, s in path]
                 for seq_id, path in all_paths.items()}
        jobs = {}
        for seq_id, path in paths.items():
            rev = reverse_signed_path(path)
            jobs[(seq_id, "start_end")] = (path, path, weights, True)
            jobs[(seq_id, "hairpin_start")] = (path, rev, weights, False)
            jobs[(seq_id, "hairpin_end")] = (rev, path, weights, False)
        alignments = overlap_screen(jobs, min_identity, max_unitigs, dev)
        start_end = trim_start_end_overlap(sequences, weights, max_unitigs,
                                           paths, alignments, threads)
        hairpin = trim_hairpin_overlap(sequences, weights, max_unitigs, paths,
                                       alignments, min_identity, dev, threads)
        # choose_trim_type's winner (start-end wins ties), so that QC
        # records the trims that were applied
        se_count = sum(r is not None for r in start_end)
        hp_count = sum(r is not None for r in hairpin)
        winner = start_end if se_count >= hp_count else hairpin
        chosen = [(s.id, r if (se_count or hp_count) else None)
                  for s, r in zip(sequences, winner)]
        sequences = choose_trim_type(start_end, hairpin, graph, sequences)
    with stage_timer("trim/outputs"):
        pre_exclude_ids = {s.id for s in sequences}
        sequences = exclude_outliers_in_length(graph, sequences, mad)
        excluded_ids = pre_exclude_ids - {s.id for s in sequences}
        clean_up_graph(graph, sequences)
        graph.save_gfa(trimmed_gfa, sequences)
        TrimmedClusterMetrics.new(
            [s.length for s in sequences]).save_to_yaml(trimmed_yaml)
    qc.trim_qc(cluster_dir.name, orig_lengths, se_count, hp_count, chosen,
               sequences, excluded_ids)
    ledger.record_stage("trim", inputs=[untrimmed_gfa],
                        outputs=[trimmed_gfa, trimmed_yaml],
                        cluster=cluster_dir.name)
    log.section_header("Finished!")
    log.message(f"Unitig graph of trimmed sequences: {trimmed_gfa}")
    log.message()
    return graph, sequences


def trim_start_end_overlap(sequences: List[Sequence], weights: Weights,
                           max_unitigs: int, paths: Dict[int, List[int]],
                           alignments: Alignments, threads: int = 1
                           ) -> List[TrimResult]:
    """Per-sequence circular start-end trimming (reference trim.rs:113-136).
    A max_unitigs of 0 disables trimming."""
    if max_unitigs == 0:
        return [None] * len(sequences)

    def one(seq: Sequence) -> TrimResult:
        trimmed = trim_path_start_end(paths[seq.id], weights,
                                      alignments[(seq.id, "start_end")])
        if trimmed is None:
            return None
        return trimmed, sum(weights[abs(u)] for u in trimmed)

    results = pool_map(one, sequences, threads)
    for seq, result in zip(sequences, results):
        if result is not None:
            log.message(f"{seq}: trimmed to {result[1]} bp")
        else:
            log.message(f"{seq}: not trimmed")
    log.message()
    return results


def trim_hairpin_overlap(sequences: List[Sequence], weights: Weights,
                         max_unitigs: int, paths: Dict[int, List[int]],
                         alignments: Alignments, min_identity: float,
                         device, threads: int = 1) -> List[TrimResult]:
    """Per-sequence hairpin trimming at both path ends (reference
    trim.rs:139-186). The hairpin-end jobs of the paths whose start was
    trimmed run in a second device round."""
    if max_unitigs == 0:
        return [None] * len(sequences)
    trimmed_starts = pool_map(
        lambda seq: trim_path_hairpin_start(
            paths[seq.id], alignments[(seq.id, "hairpin_start")]),
        sequences, threads)
    # the first round's hairpin_end DP ran on the ORIGINAL path; it only
    # applies where hairpin_start left the path unchanged
    second_round = overlap_screen({
        (seq.id, "hairpin_end"): (reverse_signed_path(p2), p2, weights, False)
        for seq, p2 in zip(sequences, trimmed_starts) if p2 is not None},
        min_identity, max_unitigs, device)

    def end(pair):
        seq, p2 = pair
        trimmed_start = p2 is not None
        if not trimmed_start:
            p2 = paths[seq.id]
        p3 = trim_path_hairpin_end(p2, (second_round if trimmed_start
                                        else alignments)[(seq.id, "hairpin_end")])
        trimmed_end = p3 is not None
        return (p3 if trimmed_end else p2), trimmed_start, trimmed_end

    results: List[TrimResult] = []
    for seq, (p3, trimmed_start, trimmed_end) in zip(
            sequences, pool_map(end, list(zip(sequences, trimmed_starts)),
                                 threads)):
        if not trimmed_start and not trimmed_end:
            results.append(None)
            log.message(f"{seq}: not trimmed")
        else:
            length = sum(weights[abs(u)] for u in p3)
            results.append((p3, length))
            where = ("start and end" if trimmed_start and trimmed_end
                     else "start" if trimmed_start else "end")
            log.message(f"{seq}: trimmed from {where} to {length} bp")
    log.message()
    return results


def choose_trim_type(start_end_results: List[TrimResult],
                     hairpin_results: List[TrimResult], graph: UnitigGraph,
                     sequences: List[Sequence]) -> List[Sequence]:
    """Keep whichever trim type succeeded on more sequences, rebuild trimmed
    sequences' positions in the graph (reference trim.rs:189-226)."""
    start_end_count = sum(r is not None for r in start_end_results)
    hairpin_count = sum(r is not None for r in hairpin_results)
    if start_end_count == 0 and hairpin_count == 0:
        return list(sequences)
    results = start_end_results if start_end_count >= hairpin_count else hairpin_results
    # one batched removal + one batched stamping for ALL trimmed sequences
    graph.remove_sequences_from_graph(
        [seq.id for seq, r in zip(sequences, results) if r is not None])
    trimmed_sequences = []
    entries = []
    for seq, result in zip(sequences, results):
        if result is None:
            trimmed_sequences.append(seq)
        else:
            path, length = result
            arr = np.asarray(path, np.int64)
            entries.append((seq.id, length, np.abs(arr), arr > 0))
            trimmed_sequences.append(Sequence.without_seq(
                seq.id, seq.filename, seq.contig_header, length, seq.cluster))
    graph.stamp_paths_batch(entries)
    return trimmed_sequences


def exclude_outliers_in_length(graph: UnitigGraph, sequences: List[Sequence],
                               mad_threshold: float) -> List[Sequence]:
    """Exclude sequences outside median ± mad_threshold·MAD
    (reference trim.rs:229-257); 0 disables."""
    if mad_threshold == 0.0:
        return list(sequences)
    lengths = [s.length for s in sequences]
    med = median(lengths)
    deviation = mad_fn(lengths)
    min_length = round(med - deviation * mad_threshold)
    max_length = round(med + deviation * mad_threshold)
    log.message(f"Median sequence length:    {med} bp")
    log.message(f"Median absolute deviation: {deviation} bp")
    log.message(f"Allowed length range:      {min_length}-{max_length} bp")
    log.message()
    kept, excluded = [], []
    for seq in sequences:
        if min_length <= seq.length <= max_length:
            kept.append(seq)
            log.message(f"{seq}: kept")
        else:
            log.message(f"{seq}: excluded")
            excluded.append(seq.id)
    graph.remove_sequences_from_graph(excluded)
    log.message()
    return kept


def clean_up_graph(graph: UnitigGraph, sequences: List[Sequence]) -> None:
    """Recalculate depths, drop zero-depth unitigs, merge linear paths and
    renumber (reference trim.rs:260-269)."""
    graph.recalculate_depths()
    graph.remove_zero_depth_unitigs()
    merge_linear_paths(graph, sequences)
    graph.print_basic_graph_info()
    graph.renumber_unitigs()


# ---------------- path-level trimming ----------------
# each takes the alignment pieces the device DP decoded for its job

def trim_path_start_end(path: List[int], weights: Weights,
                        alignment: List[AlignmentPiece]) -> Optional[List[int]]:
    """Cut a start-end overlap, found by aligning the path against itself
    off the diagonal, at the alignment's weighted midpoint (reference
    trim.rs:288-296)."""
    if not alignment:
        return None
    midpoint = find_midpoint(alignment, weights)
    start = alignment[midpoint].a_index
    end = alignment[midpoint].b_index
    return list(path[start:end])


def trim_path_hairpin_end(path: List[int], alignment: List[AlignmentPiece]
                          ) -> Optional[List[int]]:
    """Trim a hairpin overlap at the path end, found by aligning the reverse
    path against the path (reference trim.rs:299-317). The walk pops
    pieces, so it takes a copy."""
    if not alignment:
        return None
    alignment = list(alignment)
    end = 0
    while alignment:
        while alignment and alignment[0].a_unitig == GAP:
            alignment.pop(0)
        while alignment and alignment[-1].b_unitig == GAP:
            alignment.pop()
        if not alignment:
            break
        back = alignment.pop()
        if alignment:
            assert back.b_unitig == -alignment[0].a_unitig
        if back.a_unitig != GAP:
            end = back.b_index
        if alignment:
            alignment.pop(0)
    return list(path[:end])


def trim_path_hairpin_start(path: List[int], alignment: List[AlignmentPiece]
                            ) -> Optional[List[int]]:
    """Hairpin trim at the path start = hairpin-end trim of the reverse path
    (reference trim.rs:320-326); ``alignment`` is the (path, reverse path)
    alignment, which is what that hairpin-end trim aligns."""
    trimmed = trim_path_hairpin_end(reverse_signed_path(path), alignment)
    if trimmed is None:
        return None
    return reverse_signed_path(trimmed)
