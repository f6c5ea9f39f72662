"""Input-contig record with dot padding and header directives.

Parity target: reference sequence.rs:20-110.
- Sequences are padded with half-k dots on each end so terminal k-mers exist;
  dots act as wildcards during sequence-end repair (sequence.rs:31-59).
- FASTA header directives configure behaviour in-band (sequence.rs:89-109):
  Autocycler_trusted / Autocycler_ignore / Autocycler_cluster_weight= /
  Autocycler_consensus_weight= (all case-insensitive).
"""

from __future__ import annotations

import numpy as np

from ..utils import quit_with_error, reverse_complement_bytes, up_to_first_space, after_first_space

# byte-value lookup beats np.isin's sort-based path on Mbp arrays
_IS_ACGT = np.zeros(256, dtype=bool)
_IS_ACGT[np.frombuffer(b"ACGT", dtype=np.uint8)] = True

_ACGT = frozenset(b"ACGT")


def padded_strand(seq: str, filename: str, half_k: int) -> np.ndarray:
    """Validated, dot-padded forward strand bytes for one contig — the
    sequence-independent half of :meth:`Sequence.with_seq`, shared with the
    parallel loader (which builds strands in worker tasks before sequence
    ids exist) and the parse cache."""
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    if not _IS_ACGT[raw].all():
        quit_with_error(f"{filename} contains non-ACGT characters")
    pad = np.full(half_k, ord("."), dtype=np.uint8)
    return np.concatenate([pad, raw, pad])


class Sequence:
    __slots__ = ("id", "_forward_seq", "_reverse_seq", "filename",
                 "contig_header", "length", "cluster", "_strand_codes")

    def __init__(self, id: int, forward_seq: np.ndarray, reverse_seq: np.ndarray,
                 filename: str, contig_header: str, length: int, cluster: int = 0):
        self.id = id
        self._strand_codes = None
        self.forward_seq = forward_seq      # uint8 array, dot-padded (may be empty)
        self.reverse_seq = reverse_seq
        self.filename = filename
        self.contig_header = contig_header
        self.length = length                # unpadded length
        self.cluster = cluster

    # the strand bytes are exposed through properties so reassignment (e.g.
    # sequence-end repair swapping in repaired strands) invalidates the
    # cached encoding — a length check would miss same-length rewrites
    @property
    def forward_seq(self) -> np.ndarray:
        return self._forward_seq

    @forward_seq.setter
    def forward_seq(self, value: np.ndarray) -> None:
        self._forward_seq = value
        self._strand_codes = None

    @property
    def reverse_seq(self) -> np.ndarray:
        return self._reverse_seq

    @reverse_seq.setter
    def reverse_seq(self, value: np.ndarray) -> None:
        self._reverse_seq = value
        self._strand_codes = None

    def encoded_strands(self):
        """(forward codes, reverse codes) of the padded strands, encoded at
        most once per sequence: the reverse strand is the arithmetic
        code-space reverse complement of the forward encoding (identical to
        encoding ``reverse_seq``, since reverse_seq is always the byte-space
        reverse complement of forward_seq)."""
        if self._strand_codes is None:
            from ..ops.encode import encode_both_strands
            self._strand_codes = encode_both_strands(self._forward_seq)
        return self._strand_codes

    @classmethod
    def with_seq(cls, id: int, seq: str, filename: str, contig_header: str,
                 half_k: int) -> "Sequence":
        """Construct with the actual sequence stored, dot-padded by half_k on
        both ends (reference sequence.rs:31-59)."""
        forward = padded_strand(seq, filename, half_k)
        return cls.from_padded_forward(id, forward, filename, contig_header,
                                       len(seq))

    @classmethod
    def from_padded_forward(cls, id: int, forward: np.ndarray, filename: str,
                            contig_header: str, length: int) -> "Sequence":
        """Construct from an already-validated padded forward strand (the
        parallel loader and the parse cache land here); the reverse strand
        is always re-derived, so cached bytes cannot desynchronise."""
        return cls(id, forward, reverse_complement_bytes(forward), filename,
                   contig_header, length)

    @classmethod
    def without_seq(cls, id: int, filename: str, contig_header: str, length: int,
                    cluster: int = 0) -> "Sequence":
        """Construct without sequence bytes — used once the sequence lives in
        the UnitigGraph (reference sequence.rs:61-75)."""
        empty = np.zeros(0, dtype=np.uint8)
        return cls(id, empty, empty, filename, contig_header, length, cluster)

    def contig_name(self) -> str:
        return up_to_first_space(self.contig_header)

    def contig_description(self) -> str:
        return after_first_space(self.contig_header)

    def string_for_newick(self) -> str:
        return f"{self.id}__{self.filename}__{self.contig_name()}__{self.length}_bp"

    def is_trusted(self) -> bool:
        return "autocycler_trusted" in self.contig_header.lower()

    def is_ignored(self) -> bool:
        return "autocycler_ignore" in self.contig_header.lower()

    def _weight_directive(self, prefix: str) -> int:
        for token in self.contig_header.lower().split():
            if token.startswith(prefix):
                value = token[len(prefix):]
                try:
                    n = int(value)
                except ValueError:
                    continue
                if n >= 0:
                    return n
        return 1

    def cluster_weight(self) -> int:
        return self._weight_directive("autocycler_cluster_weight=")

    def consensus_weight(self) -> int:
        return self._weight_directive("autocycler_consensus_weight=")

    def __str__(self) -> str:
        extras = []
        if self.is_trusted():
            extras.append("trusted")
        if self.is_ignored():
            extras.append("ignored")
        if self.cluster_weight() != 1:
            extras.append(f"cluster weight = {self.cluster_weight()}")
        if self.consensus_weight() != 1:
            extras.append(f"consensus weight = {self.consensus_weight()}")
        base = f"{self.filename} {self.contig_name()} ({self.length} bp)"
        return f"{base} [{', '.join(extras)}]" if extras else base

    __repr__ = __str__
