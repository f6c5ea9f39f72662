"""`autocycler subsample`: split a long-read set into maximally-independent
subsets.

Parity target: reference subsample.rs — FASTQ stats (count/bases/N50),
subset depth formula ``min_depth * log2(4 * total_depth / min_depth) / 2``,
seeded shuffle, and ``count`` overlapping windows over the shuffled order.
The shuffle is REPRODUCTION-EXACT against the reference for the same seed:
utils/rust_rand.py reimplements rand 0.9's StdRng (ChaCha12) seeding +
SliceRandom::shuffle bit-for-bit, gated by a runtime self-test of the
cipher core; if that gate ever fails, the seeded Python Fisher-Yates is
used instead and the divergence is stamped into subsample.yaml's
``shuffle`` field.
"""

from __future__ import annotations

import math
import os
import random
from pathlib import Path
from typing import List, Set

from ..metrics import ReadSetDetails, SubsampleMetrics
from ..utils import Spinner, fastq_reader, log, quit_with_error


def parse_genome_size(genome_size_str: str) -> int:
    """'4.5m' -> 4500000; bare numbers, k/m/g suffixes (reference
    subsample.rs:77-93). Rounds half-away-from-zero like Rust's f64::round."""
    s = genome_size_str.strip().lower()
    try:
        return int(math.floor(float(s) + 0.5))
    except ValueError:
        pass
    multiplier = {"k": 1e3, "m": 1e6, "g": 1e9}.get(s[-1] if s else "")
    if multiplier is None:
        quit_with_error("cannot interpret genome size")
    try:
        return int(math.floor(float(s[:-1]) * multiplier + 0.5))
    except ValueError:
        quit_with_error("cannot interpret genome size")


def calculate_subsets(read_count: int, read_bases: int, genome_size: int,
                      min_depth: float) -> int:
    """Reads per subset from the subset-depth formula (reference
    subsample.rs:113-135)."""
    total_depth = read_bases / genome_size
    if total_depth < min_depth:
        quit_with_error("input reads are too shallow to subset")
    subset_depth = min_depth * math.log2(4.0 * total_depth / min_depth) / 2.0
    subset_ratio = subset_depth / total_depth
    reads_per_subset = round(subset_ratio * read_count)
    log.message(f"Total read depth: {total_depth:.1f}x")
    log.message(f"  subset depth: {subset_depth:.1f}x")
    log.message(f"  reads per subset: {reads_per_subset}")
    log.message()
    return reads_per_subset


def subsample_indices(subset_count: int, reads_per_subset: int,
                      read_order: List[int], i: int) -> Set[int]:
    """Window i over the shuffled read order, wrapping around
    (reference subsample.rs:165-189)."""
    input_count = len(read_order)
    indices: Set[int] = set()
    start_1 = round(i * input_count / subset_count)
    end_1 = start_1 + reads_per_subset
    if end_1 > input_count:
        end_2 = end_1 - input_count
        end_1 = input_count
        for j in range(0, end_2):
            indices.add(read_order[j])
    for j in range(start_1, end_1):
        indices.add(read_order[j])
    assert len(indices) == reads_per_subset
    return indices


def subsample(fastq_file, out_dir, genome_size: str, count: int = 4,
              min_read_depth: float = 25.0, seed: int = 0) -> None:
    out_dir = Path(out_dir)
    genome_size_int = parse_genome_size(genome_size)
    if not os.path.isfile(fastq_file):
        quit_with_error(f"file does not exist: {fastq_file}")
    if os.path.exists(out_dir) and not os.path.isdir(out_dir):
        quit_with_error(f"{out_dir} exists but is not a directory")
    if genome_size_int < 1:
        quit_with_error("--genome_size must be at least 1")
    if count < 2:
        quit_with_error("--count must be at least 2")
    if min_read_depth <= 0.0:
        quit_with_error("--min_read_depth must be greater than 0")
    os.makedirs(out_dir, exist_ok=True)

    log.section_header("Starting autocycler subsample")
    log.explanation("This command subsamples a long-read set into subsets that are "
                    "maximally independent from each other.")
    metrics = SubsampleMetrics()
    read_lengths = sorted(len(seq) for _, seq, _ in fastq_reader(fastq_file))
    details = ReadSetDetails.from_sorted_lengths(read_lengths)
    metrics.input_read_count = details.count
    metrics.input_read_bases = details.bases
    metrics.input_read_n50 = details.n50
    log.message(f"Input FASTQ:")
    log.message(f"  Read count: {details.count}")
    log.message(f"  Read bases: {details.bases}")
    log.message(f"  Read N50 length: {details.n50} bp")
    log.message()

    reads_per_subset = calculate_subsets(details.count, details.bases, genome_size_int,
                                         min_read_depth)

    from ..utils.rust_rand import std_rng_shuffled_order
    read_order = std_rng_shuffled_order(details.count, seed)
    if read_order is not None:
        metrics.shuffle = "rust-stdrng-0.9"
    else:  # cipher self-test failed: legacy shuffle, recorded divergence
        metrics.shuffle = "python-fisher-yates"
        rng = random.Random(seed)
        read_order = list(range(details.count))
        rng.shuffle(read_order)
    subset_index_sets = [subsample_indices(count, reads_per_subset, read_order, i)
                         for i in range(count)]
    files = []
    for i in range(count):
        path = out_dir / f"sample_{i + 1:02d}.fastq"
        log.message(f"subset {i + 1}: {path}")
        files.append(open(path, "w"))
    sample_read_lengths: List[List[int]] = [[] for _ in range(count)]
    with Spinner("writing subsampled reads to files..."):
        for read_i, (header, seq, quals) in enumerate(fastq_reader(fastq_file)):
            record = f"@{header}\n{seq}\n+\n{quals}\n"
            for subset_i in range(count):
                if read_i in subset_index_sets[subset_i]:
                    files[subset_i].write(record)
                    sample_read_lengths[subset_i].append(len(seq))
        for f in files:
            f.close()
    for lengths in sample_read_lengths:
        metrics.output_reads.append(ReadSetDetails.from_sorted_lengths(sorted(lengths)))
    metrics.save_to_yaml(out_dir / "subsample.yaml")
    log.section_header("Finished!")
    log.explanation("You can now assemble each of the subsampled read sets to produce a "
                    "set of assemblies for input into Autocycler compress.")
