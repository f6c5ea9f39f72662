"""The frozen generator of the benchmark's isolates.

A copy of the repository's synthetic-assembly generator
(``random_genome_fast``, ``mutate_fast``, and ``make_assemblies_fast`` as
:func:`make_isolate`) and of the start-end overlap writer
(``append_start_overlaps``), kept here so that the benchmark's inputs cannot
change when the test helpers do. With one plasmid and no plasmid SNPs, one
seed gives byte-equal FASTA to the original. The copy's own cases: no
plasmid (no record is written), several plasmids, and SNPs on plasmids.

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


def plasmid_snps(length: int, per_mbp: float) -> int:
    """SNPs a copy of a plasmid of ``length`` bp carries at ``per_mbp``: at
    least one where the rate is above 0, so that every copy of a small
    plasmid differs from the others as the chromosome's do."""
    return max(1, round(length * per_mbp / 1e6)) if per_mbp > 0 else 0


def make_isolate(np_rng, n_assemblies: int, chromosome_len: int, plasmid_lens,
                 n_snps: int, plasmid_snps_per_mbp: float = 0):
    """Rotated copies of one chromosome (with ``n_snps`` SNPs each) and of
    each plasmid of ``plasmid_lens`` (reverse-complemented in alternate
    assemblies, with :func:`plasmid_snps` SNPs each), drawn from ``np_rng``:
    the chromosome, then the plasmids in list order; in each assembly every
    replicon's rotation, then the chromosome's SNPs, then each plasmid's.
    A single plasmid is ``plasmid_<i>``, as in the original; of several,
    the j-th (from 1) is ``plasmid_<j>_<i>``, so every header of a file is
    unique."""
    chromosome = random_genome_fast(np_rng, chromosome_len)
    plasmids = [random_genome_fast(np_rng, n) for n in plasmid_lens]
    names = (["plasmid"] if len(plasmids) == 1
             else [f"plasmid_{j + 1}" for j in range(len(plasmids))])
    snps = [plasmid_snps(n, plasmid_snps_per_mbp) for n in plasmid_lens]
    files = []
    for i in range(n_assemblies):
        chrom = rotate(chromosome, int(np_rng.integers(0, chromosome_len)))
        records = [(f"chromosome_{i + 1}", chrom)]
        for name, plasmid in zip(names, plasmids):
            plas = rotate(plasmid, int(np_rng.integers(0, len(plasmid))))
            if i % 2 == 1:
                plas = revcomp(plas)
            records.append((f"{name}_{i + 1}", plas))
        if n_snps:
            records[0] = (records[0][0], mutate_fast(np_rng, chrom, n_snps))
        for j, count in enumerate(snps, 1):
            if count:
                records[j] = (records[j][0], mutate_fast(np_rng, records[j][1], count))
        files.append((f"assembly_{i + 1}.fasta", records))
    return files


def append_start_overlaps(files, np_rng, chromosome_range, plasmid_range):
    """Append to each contig its own first L bases, L uniform in its
    replicon's range (the chromosome's for the first record of a file, the
    plasmids' for every other), in assembly order and record order: the
    start-end overlap an assembler leaves on a circular contig."""
    out = []
    for name, records in files:
        grown = []
        for j, (header, seq) in enumerate(records):
            low, high = plasmid_range if j else chromosome_range
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
