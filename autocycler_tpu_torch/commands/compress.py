"""`autocycler compress`: input assemblies -> compacted unitig graph GFA.

Parity target: reference compress.rs:32-50. Pipeline: discover FASTAs, load
and pad contigs, repair dotted ends, build the k-mer index + unitig graph on
the device (ops.kmers / ops.debruijn / ops.graph_build — replacing the
reference's hash-map hot loops), simplify repeats, and write
input_assemblies.gfa plus input_assemblies.yaml metrics. A warm-start
cache under ``<autocycler_dir>/.cache`` (utils.cache) lets a repeat run
skip the parse and end repair.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..metrics import InputAssemblyDetails, InputAssemblyMetrics, InputContigDetails
from ..models import Sequence, UnitigGraph
from ..models.sequence import padded_strand
from ..models.simplify import simplify_structure
from ..obs import ledger, qc
from ..ops.end_repair import sequence_end_repair
from ..ops.graph_build import build_unitig_graph
from ..stream import prepare_stream_root
from ..utils import (Spinner, check_threads, find_all_assemblies,
                     format_duration, load_fasta, log, quit_with_error,
                     reverse_complement_bytes)
from ..utils.cache import EncodeCache, content_hash, open_cache
from ..utils.pool import pool_map
from ..utils.resilience import crash_point, record_degrade
from ..utils.timing import stage_timer, substage

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
    """The device work runs on ``device`` (CUDA unless the caller asks for
    the CPU). ``threads`` loads that many FASTAs at once, sizes the streamed
    k-mer grouping's plan (its bin count) and how many bin reads run ahead
    of its sorts, as in the JAX package; no output byte depends on it. The
    streamed grouping spills under ``<autocycler_dir>/.stream``."""
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
    # the streamed k-mer grouping spills under <autocycler_dir>/.stream;
    # sweep what a killed run left behind before this run spills
    prepare_stream_root(autocycler_dir)
    metrics = InputAssemblyMetrics()
    with stage_timer("compress/load_and_repair"):
        sequences, assembly_count = load_sequences(
            assemblies_dir, k_size, metrics, max_contigs, threads,
            cache=open_cache(autocycler_dir), device=dev)
    log.section_header("Building compacted unitig graph")
    log.explanation("K-mers are grouped with a sort-based device kernel, unitig chains "
                    "are assembled, and all non-branching paths are collapsed to form a "
                    "compacted De Bruijn graph, a.k.a. a unitig graph.")
    with stage_timer("compress/build_graph"), \
            Spinner("adding k-mers to graph..."):
        graph = build_unitig_graph(sequences, k_size, device=dev,
                                   threads=threads)
    graph.print_basic_graph_info()

    log.section_header("Simplifying unitig graph")
    log.explanation("The graph structure is now simplified by moving sequence into repeat "
                    "unitigs when possible.")
    with stage_timer("compress/simplify"), Spinner("simplifying graph..."):
        simplify_structure(graph, sequences)
    graph.print_basic_graph_info()

    out_gfa = Path(autocycler_dir) / "input_assemblies.gfa"
    out_yaml = Path(autocycler_dir) / "input_assemblies.yaml"
    with substage("write"):
        graph.save_gfa(out_gfa, sequences)
        _save_metrics(metrics, assembly_count, sequences, graph, out_yaml)
    qc.compress_qc(graph, sequences)
    ledger.record_stage("compress", outputs=[out_gfa, out_yaml])
    # the artifacts are flushed but no caller's manifest has recorded the
    # stage yet: a crash here re-runs compress on resume, to the same bytes
    crash_point("post-stage", "compress")

    log.section_header("Finished!")
    log.explanation("You can now run autocycler cluster to group contigs based on their "
                    "similarity.")
    log.message(f"Compressed unitig graph: {out_gfa}")
    log.message(f"Input assembly stats:    {out_yaml}")
    log.message(f"Time to run: {format_duration(time.perf_counter() - start_time)}")
    log.message()


def load_sequences(assemblies_dir, k_size: int, metrics: InputAssemblyMetrics,
                   max_contigs: int, threads: int = 1,
                   cache: Optional[EncodeCache] = None, device=None
                   ) -> Tuple[List[Sequence], int]:
    """Load all contigs from all assemblies, skipping sub-k contigs and
    ignored headers, then repair dotted ends on ``device`` (reference
    compress.rs:98-133).

    Files load, parse and pad concurrently (one task per FASTA on the
    shared pool) and merge in file order, so sequence ids, log lines and
    metrics are the serial walk's at every thread count. The parse and
    repair caches (utils.cache) let a repeat run skip both phases."""
    log.section_header("Loading input assemblies")
    log.explanation("Input assemblies are now loaded and each contig is given a unique ID.")
    assemblies = find_all_assemblies(assemblies_dir)
    ledger.record_inputs(assemblies)
    with substage("load"):
        per_file, file_hashes = _load_assembly_files(assemblies, k_size,
                                                     threads, cache)
    seq_id = 0
    sequences: List[Sequence] = []
    for assembly, records in zip(assemblies, per_file):
        details = InputAssemblyDetails(filename=str(assembly))
        filename = Path(assembly).name
        for contig_header, forward, reverse, length in records:
            seq_id += 1
            if seq_id > MAX_INPUT_SEQUENCES:
                quit_with_error(
                    f"no more than {MAX_INPUT_SEQUENCES} input sequences are allowed")
            sequence = Sequence(seq_id, forward, reverse, filename,
                                contig_header, length)
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
        _repair_with_cache(sequences, k_size, cache, file_hashes, device)
    n = seq_id
    log.message(f"{n} sequence{'' if n == 1 else 's'} loaded from {len(assemblies)} "
                f"assembl{'y' if len(assemblies) == 1 else 'ies'}")
    log.message()
    return sequences, len(assemblies)


def _load_assembly_files(assemblies, k_size: int, threads: int,
                         cache: Optional[EncodeCache]):
    """One load/parse/pad/revcomp task per FASTA file on the shared pool,
    merged in file order. Returns (per-file record lists, per-file content
    hashes). Each record is (contig_header, forward, reverse, length) for a
    contig of at least k bases.

    A worker failure with threads > 1 degrades visibly to one serial retry,
    so a transient per-file fault neither reorders nor kills the run, while
    a persistent error propagates from the serial pass with its message."""
    half_k = k_size // 2

    def load_one(assembly):
        file_hash = None
        if cache is not None:
            try:
                file_hash = content_hash(Path(assembly).read_bytes())
            except OSError:
                file_hash = None
            if file_hash is not None:
                hit = cache.load_parsed(file_hash, k_size)
                if hit is not None:
                    return [(header, fwd, reverse_complement_bytes(fwd), ln)
                            for header, fwd, ln in hit], file_hash
        filename = Path(assembly).name
        parsed = []
        for _, header, seq in load_fasta(assembly):
            if len(seq) < k_size:
                continue
            contig_header = " ".join(header.split())
            parsed.append((contig_header, padded_strand(seq, filename, half_k),
                           len(seq)))
        if cache is not None and file_hash is not None:
            cache.store_parsed(file_hash, k_size, parsed)
        return [(header, fwd, reverse_complement_bytes(fwd), ln)
                for header, fwd, ln in parsed], file_hash

    workers = min(max(1, int(threads)), len(assemblies))
    if workers > 1:
        try:
            results = pool_map(load_one, assemblies, workers)
        except Exception as e:  # noqa: BLE001 — retried serially below
            record_degrade("assembly-load", "parallel", "serial",
                           f"{type(e).__name__}: {e}")
            results = [load_one(a) for a in assemblies]
    else:
        results = [load_one(a) for a in assemblies]
    return [r[0] for r in results], [r[1] for r in results]


def _repair_with_cache(sequences: List[Sequence], k_size: int,
                       cache: Optional[EncodeCache], file_hashes,
                       device=None) -> None:
    """Sequence-end repair with a warm-start cache: repair candidates are
    searched across ALL inputs, so the cache key is the hash over every
    file's content hash plus k, and only the repaired 2*(k-1) end bytes per
    sequence are stored. A hit patches the strands on the host and launches
    nothing on the device; a miss repairs on ``device`` and stores."""
    overlap = k_size - 1
    combined = None
    if (cache is not None and sequences and overlap > 0
            and all(h is not None for h in file_hashes)):
        combined = content_hash("|".join(file_hashes).encode())
        ends = cache.load_repair_ends(combined, k_size, len(sequences))
        if ends is not None:
            for i, s in enumerate(sequences):
                repaired = s.forward_seq          # fresh per run: own array
                repaired[:overlap] = ends[i, 0]
                repaired[len(repaired) - overlap:] = ends[i, 1]
                reverse = s.reverse_seq           # the strands' ends swap
                reverse[:overlap] = reverse_complement_bytes(ends[i, 1])
                reverse[len(reverse) - overlap:] = \
                    reverse_complement_bytes(ends[i, 0])
                s.forward_seq = repaired          # setters invalidate codes
                s.reverse_seq = reverse
            return
    sequence_end_repair(sequences, k_size, device)
    if combined is not None:
        ends = np.stack([
            np.stack([s.forward_seq[:overlap],
                      s.forward_seq[len(s.forward_seq) - overlap:]])
            for s in sequences])
        cache.store_repair_ends(combined, k_size, ends)


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
