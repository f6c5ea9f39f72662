"""`autocycler compress`: input assemblies -> compacted unitig graph GFA.

Parity target: reference compress.rs:32-50. Pipeline: discover FASTAs, load
and pad contigs, repair dotted ends, build the k-mer index + unitig graph on
the device (ops.kmers / ops.debruijn / ops.graph_build — replacing the
reference's hash-map hot loops), simplify repeats, and write
input_assemblies.gfa plus input_assemblies.yaml metrics.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import List, Tuple

from ..device import resolve_device
from ..metrics import InputAssemblyDetails, InputAssemblyMetrics, InputContigDetails
from ..models import Sequence, UnitigGraph
from ..models.sequence import padded_strand
from ..models.simplify import simplify_structure
from ..ops.end_repair import sequence_end_repair
from ..ops.graph_build import build_unitig_graph
from ..utils import (Spinner, check_threads, find_all_assemblies,
                     format_duration, load_fasta, log, quit_with_error,
                     reverse_complement_bytes)
from ..utils.timing import substage

MAX_INPUT_SEQUENCES = 32767  # position packing limit (reference compress.rs:112-114)


def check_settings(assemblies_dir, autocycler_dir, k_size: int) -> None:
    """Flag validation (reference compress.rs:53-62)."""
    if not os.path.isdir(assemblies_dir):
        quit_with_error(f"directory does not exist: {assemblies_dir}")
    if os.path.exists(autocycler_dir) and not os.path.isdir(autocycler_dir):
        quit_with_error(f"{autocycler_dir} exists but is not a directory")
    if k_size < 11:
        quit_with_error("--kmer cannot be less than 11")
    if k_size > 501:
        quit_with_error("--kmer cannot be greater than 501")
    if k_size % 2 == 0:
        quit_with_error("--kmer must be odd")


def compress(assemblies_dir, autocycler_dir, k_size: int = 51,
             max_contigs: int = 25, threads: int = 1, device=None) -> None:
    """``threads`` is validated as in the reference and changes no output;
    the device work runs on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    start_time = time.perf_counter()
    check_settings(assemblies_dir, autocycler_dir, k_size)
    check_threads(threads)
    dev = resolve_device(device)
    log.section_header("Starting autocycler compress")
    log.explanation("This command finds all assemblies in the given input directory and "
                    "compresses them into a compacted De Bruijn graph. This graph can then "
                    "be used to recover the assemblies (with autocycler decompress) or "
                    "generate a consensus assembly (with autocycler resolve).")
    os.makedirs(autocycler_dir, exist_ok=True)
    metrics = InputAssemblyMetrics()
    sequences, assembly_count = load_sequences(assemblies_dir, k_size, metrics,
                                               max_contigs, dev)
    log.section_header("Building compacted unitig graph")
    log.explanation("K-mers are grouped with a sort-based device kernel, unitig chains "
                    "are assembled, and all non-branching paths are collapsed to form a "
                    "compacted De Bruijn graph, a.k.a. a unitig graph.")
    with Spinner("adding k-mers to graph..."):
        graph = build_unitig_graph(sequences, k_size, device=dev)
    graph.print_basic_graph_info()

    log.section_header("Simplifying unitig graph")
    log.explanation("The graph structure is now simplified by moving sequence into repeat "
                    "unitigs when possible.")
    with Spinner("simplifying graph..."), substage("simplify"):
        simplify_structure(graph, sequences)
    graph.print_basic_graph_info()

    out_gfa = Path(autocycler_dir) / "input_assemblies.gfa"
    out_yaml = Path(autocycler_dir) / "input_assemblies.yaml"
    with substage("write"):
        graph.save_gfa(out_gfa, sequences)
        _save_metrics(metrics, assembly_count, sequences, graph, out_yaml)

    log.section_header("Finished!")
    log.explanation("You can now run autocycler cluster to group contigs based on their "
                    "similarity.")
    log.message(f"Compressed unitig graph: {out_gfa}")
    log.message(f"Input assembly stats:    {out_yaml}")
    log.message(f"Time to run: {format_duration(time.perf_counter() - start_time)}")
    log.message()


def load_sequences(assemblies_dir, k_size: int, metrics: InputAssemblyMetrics,
                   max_contigs: int, device=None) -> Tuple[List[Sequence], int]:
    """Load all contigs from all assemblies, skipping sub-k contigs and
    ignored headers, then repair dotted ends (reference compress.rs:98-133)."""
    log.section_header("Loading input assemblies")
    log.explanation("Input assemblies are now loaded and each contig is given a unique ID.")
    assemblies = find_all_assemblies(assemblies_dir)
    half_k = k_size // 2
    seq_id = 0
    sequences: List[Sequence] = []
    with substage("load"):
        for assembly in assemblies:
            details = InputAssemblyDetails(filename=str(assembly))
            filename = Path(assembly).name
            for _, header, seq in load_fasta(assembly):
                if len(seq) < k_size:
                    continue
                seq_id += 1
                if seq_id > MAX_INPUT_SEQUENCES:
                    quit_with_error(
                        f"no more than {MAX_INPUT_SEQUENCES} input sequences are allowed")
                contig_header = " ".join(header.split())
                forward = padded_strand(seq, filename, half_k)
                sequence = Sequence(seq_id, forward, reverse_complement_bytes(forward),
                                    filename, contig_header, len(seq))
                log.message(f" {seq_id:>3}: {sequence}")
                details.contigs.append(InputContigDetails(
                    name=sequence.contig_name(),
                    description=sequence.contig_description(),
                    length=sequence.length))
                if not sequence.is_ignored():
                    sequences.append(sequence)
            metrics.input_assembly_details.append(details)
    log.message()
    check_sequence_count(sequences, len(assemblies), max_contigs)
    with Spinner("repairing sequence ends..."), substage("repair"):
        sequence_end_repair(sequences, k_size, device)
    n = seq_id
    log.message(f"{n} sequence{'' if n == 1 else 's'} loaded from {len(assemblies)} "
                f"assembl{'y' if len(assemblies) == 1 else 'ies'}")
    log.message()
    return sequences, len(assemblies)


def check_sequence_count(sequences: List[Sequence], assembly_count: int,
                         max_contigs: int) -> None:
    """Reject empty or overly-fragmented inputs (reference compress.rs:84-95)."""
    if not sequences:
        quit_with_error("no sequences found in input assemblies")
    mean = len(sequences) / assembly_count
    if mean > max_contigs:
        quit_with_error(
            f"the mean number of contigs per input assembly ({mean:.1f}) exceeds the "
            f"allowed threshold ({max_contigs}). Are your input assemblies fragmented "
            "or contaminated?")


def _save_metrics(metrics: InputAssemblyMetrics, assembly_count: int,
                  sequences: List[Sequence], graph: UnitigGraph, out_yaml) -> None:
    metrics.input_assemblies_count = assembly_count
    metrics.input_assemblies_total_contigs = len(sequences)
    metrics.input_assemblies_total_length = sum(s.length for s in sequences)
    metrics.compressed_unitig_count = len(graph.unitigs)
    metrics.compressed_unitig_total_length = graph.total_length()
    metrics.save_to_yaml(out_yaml)
