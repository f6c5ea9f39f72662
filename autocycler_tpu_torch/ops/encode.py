"""5-symbol sequence encoding for device kernels.

The alphabet is ``. A C G T`` (reference kmer_graph.rs:23) with codes 0..4
chosen in ASCII order so that integer comparisons reproduce byte-lexicographic
comparisons of the original sequences ('.' = 0x2E sorts before 'A' < 'C' <
'G' < 'T'). Reverse complement is the arithmetic map ``c -> (5 - c) % 5``:
dots stay dots, A<->T, C<->G.
"""

from __future__ import annotations

import numpy as np

ALPHABET = b".ACGT"
CODE_DOT, CODE_A, CODE_C, CODE_G, CODE_T = range(5)

_ENCODE = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(ALPHABET):
    _ENCODE[_b] = _i

_DECODE = np.frombuffer(ALPHABET, dtype=np.uint8)


def encode_bytes(seq: np.ndarray) -> np.ndarray:
    """ASCII uint8 -> codes 0..4 (unknown bytes map to 0)."""
    return _ENCODE[seq]


def decode_codes(codes: np.ndarray) -> np.ndarray:
    """codes 0..4 -> ASCII uint8."""
    return _DECODE[codes]


# complement in code space: dot->dot, A<->T, C<->G — the table gather beats
# the arithmetic (5 - c) % 5 form (one lookup, no modulo)
_COMPLEMENT = np.array([0, 4, 3, 2, 1], dtype=np.uint8)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space."""
    return _COMPLEMENT[codes[::-1]].astype(codes.dtype, copy=False)


def encode_both_strands(seq: np.ndarray):
    """(forward codes, reverse-complement codes) of one ASCII strand with a
    single encode pass: the reverse strand is derived arithmetically in code
    space instead of round-tripping through reverse_complement_bytes +
    re-encode. Identical to encoding the byte-space reverse complement —
    unknown bytes encode to 0 on both routes."""
    fwd = _ENCODE[seq]
    return fwd, _COMPLEMENT[fwd[::-1]]
