"""FASTA/FASTQ/GFA file I/O (plain and gzipped).

Behavioural parity targets (reference Autocycler src/misc.rs):
- assembly discovery by extension  misc.rs:65-96  (.fasta/.fna/.fa[.gz])
- FASTA loading with checks        misc.rs:145-220 (uppercase, dup-name check)
- gzip sniffing by magic bytes     misc.rs:259-271
- FASTQ streaming reader           misc.rs:198-208
"""

from __future__ import annotations

import gzip
import os
from pathlib import Path
from typing import Iterator, List, Tuple

from .misc import quit_with_error

_ASSEMBLY_EXTS = (".fasta", ".fna", ".fa", ".fasta.gz", ".fna.gz", ".fa.gz")


def find_all_assemblies(in_dir) -> List[Path]:
    """All FASTA-like files in a directory, sorted by path (misc.rs:65-96)."""
    in_dir = Path(in_dir)
    try:
        entries = list(in_dir.iterdir())
    except OSError as e:
        quit_with_error(f"unable to read directory {in_dir}\n{e}")
    assemblies = sorted(p for p in entries
                        if p.is_file() and p.name.lower().endswith(_ASSEMBLY_EXTS))
    if not assemblies:
        quit_with_error(f"no assemblies found in {in_dir}")
    return assemblies


def is_file_gzipped(filename) -> bool:
    """True when the file starts with the gzip magic bytes (misc.rs:259-271)."""
    try:
        with open(filename, "rb") as f:
            return f.read(2) == b"\x1f\x8b"
    except OSError as e:
        quit_with_error(f"unable to open {filename}: {e}")


def open_maybe_gzip(filename, mode: str = "rt"):
    """Open a possibly-gzipped file for text or binary reading/writing."""
    if "r" in mode and is_file_gzipped(filename):
        return gzip.open(filename, mode)
    if "w" in mode and str(filename).endswith(".gz"):
        return gzip.open(filename, mode)
    return open(filename, mode)


def _parse_fasta_text(lines: Iterator[str], filename) -> List[Tuple[str, str, str]]:
    records = []
    name, header, chunks = "", "", []
    for line in lines:
        line = line.rstrip("\r\n")
        if not line:
            continue
        if line.startswith(">"):
            if name:
                records.append((name, header, "".join(chunks).upper()))
                chunks = []
            header = line[1:]
            pieces = header.split()
            if not pieces:
                quit_with_error(f"{filename} is not correctly formatted")
            name = pieces[0]
        else:
            if not name:
                quit_with_error(f"{filename} is not correctly formatted")
            chunks.append(line)
    if name:
        records.append((name, header, "".join(chunks).upper()))
    return records


def load_fasta_allow_empty(filename) -> List[Tuple[str, str, str]]:
    """(name, header, uppercased sequence) records; empty file gives []."""
    try:
        with open_maybe_gzip(filename, "rt") as f:
            return _parse_fasta_text(f, filename)
    except OSError as e:
        quit_with_error(f"unable to load {filename}\n{e}")


def load_fasta(filename) -> List[Tuple[str, str, str]]:
    """Load a FASTA file, rejecting empty files/sequences and duplicate names
    (misc.rs:145-196)."""
    from .resilience import InputError, fault_fire
    if fault_fire("fasta", str(filename)) is not None:
        raise InputError(f"fault injection: corrupt FASTA read: {filename}")
    if os.path.exists(filename) and os.path.getsize(filename) == 0:
        quit_with_error(f"{filename} is an empty file")
    records = load_fasta_allow_empty(filename)
    if not records:
        quit_with_error(f"{filename} contains no sequences")
    seen = set()
    for name, _, seq in records:
        if not name:
            quit_with_error(f"{filename} has an unnamed sequence")
        if not seq:
            quit_with_error(f"{filename} has an empty sequence")
        if name in seen:
            quit_with_error(f"{filename} has a duplicate name: {name}")
        seen.add(name)
    return records


def total_fasta_length(filename) -> int:
    if not os.path.exists(filename):
        return 0
    return sum(len(seq) for _, _, seq in load_fasta_allow_empty(filename))


def is_fasta_empty(filename) -> bool:
    return total_fasta_length(filename) == 0


def fastq_reader(filename) -> Iterator[Tuple[str, str, str]]:
    """Stream (header, sequence, qualities) from a possibly-gzipped FASTQ."""
    with open_maybe_gzip(filename, "rt") as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip("\r\n")
            plus = f.readline()
            quals = f.readline().rstrip("\r\n")
            if not plus:
                quit_with_error(f"{filename} is not a valid FASTQ file")
            yield header.rstrip("\r\n").lstrip("@"), seq, quals


def load_file_lines(filename) -> List[str]:
    try:
        with open_maybe_gzip(filename, "rt") as f:
            return [line.rstrip("\r\n") for line in f]
    except OSError as e:
        quit_with_error(f"failed to open file {filename}\n{e}")
