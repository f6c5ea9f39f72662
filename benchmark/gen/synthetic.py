"""The frozen generator of the benchmark's isolates.

A copy of the repository's synthetic-assembly generator
(``random_genome_fast``, ``mutate_fast``, ``make_assemblies_fast``) and of
the start-end overlap writer (``append_start_overlaps``), kept here so that
the benchmark's inputs cannot change when the test helpers do. With a
plasmid, one seed gives byte-equal FASTA to the original; a plasmid length
of 0 is this copy's own case: no plasmid is drawn and no record is written.

The records are built in memory, as ``[(file name, [(header, sequence)])]``,
and written once by :func:`write_isolate`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_ALPHABET = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def rotate(seq: str, offset: int) -> str:
    offset %= len(seq)
    return seq[offset:] + seq[:offset]


def revcomp(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def random_genome_fast(np_rng, length: int) -> str:
    return _ALPHABET[np_rng.integers(0, 4, size=length)].tobytes().decode()


def mutate_fast(np_rng, seq: str, n_snps: int) -> str:
    arr = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
    sites = np_rng.choice(len(arr), size=n_snps, replace=False)
    subs = _ALPHABET[np_rng.integers(0, 4, size=n_snps)]
    clash = subs == arr[sites]
    while clash.any():
        subs[clash] = _ALPHABET[np_rng.integers(0, 4, size=int(clash.sum()))]
        clash = subs == arr[sites]
    arr[sites] = subs
    return arr.tobytes().decode()


def make_assemblies_fast(np_rng, n_assemblies: int, chromosome_len: int,
                         plasmid_len: int, n_snps: int):
    """Rotated copies of one chromosome (with ``n_snps`` SNPs each) and one
    plasmid (reverse-complemented in alternate assemblies), drawn from
    ``np_rng`` in the original's order."""
    chromosome = random_genome_fast(np_rng, chromosome_len)
    plasmid = random_genome_fast(np_rng, plasmid_len) if plasmid_len else ""
    files = []
    for i in range(n_assemblies):
        chrom = rotate(chromosome, int(np_rng.integers(0, chromosome_len)))
        records = [(f"chromosome_{i + 1}", chrom)]
        if plasmid_len:
            plas = rotate(plasmid, int(np_rng.integers(0, plasmid_len)))
            if i % 2 == 1:
                plas = revcomp(plas)
            records.append((f"plasmid_{i + 1}", plas))
        if n_snps:
            records[0] = (records[0][0], mutate_fast(np_rng, chrom, n_snps))
        files.append((f"assembly_{i + 1}.fasta", records))
    return files


def append_start_overlaps(files, np_rng, chromosome_range, plasmid_range):
    """Append to each contig its own first L bases, L uniform in its
    replicon's range, in assembly order and chromosome before plasmid: the
    start-end overlap an assembler leaves on a circular contig."""
    ranges = (chromosome_range, plasmid_range)
    out = []
    for name, records in files:
        grown = []
        for (header, seq), (low, high) in zip(records, ranges):
            grown.append((header, seq + seq[:int(np_rng.integers(low, high + 1))]))
        out.append((name, grown))
    return out


def fasta_text(records) -> str:
    return "".join(f">{header}\n{seq}\n" for header, seq in records)


def write_isolate(files, directory: Path) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    for name, records in files:
        (directory / name).write_text(fasta_text(records))
    return directory
