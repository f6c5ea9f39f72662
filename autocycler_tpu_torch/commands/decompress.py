"""`autocycler decompress`: lossless inverse of compress.

Parity target: reference decompress.rs:27-138 — walk each P-line path through
the unitig graph and emit the original FASTA(s), either into a directory
(same filenames, gzip preserved by extension) or into one combined file.
"""

from __future__ import annotations

import gzip
import os
from pathlib import Path

from ..models import UnitigGraph
from ..utils import log, quit_with_error, up_to_first_space


def decompress(in_gfa, out_dir=None, out_file=None) -> None:
    if not os.path.isfile(in_gfa):
        quit_with_error(f"file does not exist: {in_gfa}")
    if out_dir is None and out_file is None:
        quit_with_error("either --out_dir or --out_file is required")
    if out_dir is not None and os.path.exists(out_dir) and not os.path.isdir(out_dir):
        quit_with_error(f"{out_dir} exists but is not a directory")

    log.section_header("Starting autocycler decompress")
    log.explanation("This command will take a unitig graph (made by autocycler compress), "
                    "reconstruct the assemblies used to build that graph and save them in "
                    "the specified directory and/or file.")
    graph, sequences = UnitigGraph.from_gfa_file(in_gfa)
    graph.print_basic_graph_info()

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        save_original_seqs_to_dir(out_dir, graph, sequences)
    if out_file is not None:
        save_original_seqs_to_file(out_file, graph, sequences)


def save_original_seqs_to_dir(out_dir, graph: UnitigGraph, sequences) -> None:
    """One output file per input filename, gzipped when the name ends .gz
    (reference decompress.rs:84-117)."""
    original = graph.reconstruct_original_sequences(sequences)
    for filename in sorted(original):
        path = Path(out_dir) / filename
        opener = gzip.open if str(path).endswith(".gz") else open
        log.message(f"{path}:")
        with opener(path, "wt") as f:
            for header, seq in original[filename]:
                log.message(f"  {up_to_first_space(header)} ({len(seq)} bp)")
                f.write(f">{header}\n{seq}\n")
        log.message()


def save_original_seqs_to_file(out_file, graph: UnitigGraph, sequences) -> None:
    """All contigs in one file, headers prefixed with their source filename
    (reference decompress.rs:120-138)."""
    original = graph.reconstruct_original_sequences(sequences)
    log.message(f"{out_file}:")
    with open(out_file, "w") as f:
        for filename in sorted(original):
            clean = filename.replace(" ", "_")
            for header, seq in original[filename]:
                log.message(f"  {filename}__{up_to_first_space(header)} ({len(seq)} bp)")
                f.write(f">{clean}__{header}\n{seq}\n")
    log.message()
