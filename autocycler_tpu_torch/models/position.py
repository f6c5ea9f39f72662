"""Occurrences of a graph element within input contigs.

Parity target: reference position.rs:19-56, which bit-packs seq_id (15 bits)
and strand (1 bit) into a u16 plus a u32 position, stored in per-unitig Vecs.
Here the model is struct-of-arrays: every unitig strand carries ONE
:class:`PositionArray` (parallel seq_id/strand/pos numpy arrays), so whole-
graph sweeps (path reconstruction, depth recalculation, sequence removal) are
vector ops instead of per-occurrence object traversals. :class:`Position` is
the ergonomic single-occurrence view, kept for display and tests. The
32767-sequence cap from the reference's bit packing is enforced at load time
(reference compress.rs:112-114).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

MAX_SEQ_ID = 32767  # 15-bit packing limit, reference position.rs:21 + compress.rs:112-114


class Position:
    __slots__ = ("seq_id", "strand", "pos")

    def __init__(self, seq_id: int, strand: bool, pos: int):
        self.seq_id = seq_id
        self.strand = strand
        self.pos = pos

    def __repr__(self) -> str:
        return f"{self.seq_id}{'+' if self.strand else '-'}{self.pos}"

    def __eq__(self, other) -> bool:
        return (self.seq_id, self.strand, self.pos) == (other.seq_id, other.strand, other.pos)

    def __hash__(self) -> int:
        return hash((self.seq_id, self.strand, self.pos))

    def copy(self) -> "Position":
        return Position(self.seq_id, self.strand, self.pos)


_EMPTY_I32 = np.zeros(0, np.int32)
_EMPTY_BOOL = np.zeros(0, bool)
_EMPTY_I64 = np.zeros(0, np.int64)


class PositionArray:
    """SoA of occurrences: parallel ``seq_id`` (int32), ``strand`` (bool) and
    ``pos`` (int64) arrays. Replaces the reference's Vec<Position> per unitig
    strand (unitig.rs:38-39). Arrays may be views into a graph-level batch
    (built by UnitigGraph's vectorised path stamping); in-place edits only
    ever touch this unitig's own slice."""

    __slots__ = ("seq_id", "strand", "pos")

    def __init__(self, seq_id: np.ndarray = None, strand: np.ndarray = None,
                 pos: np.ndarray = None):
        self.seq_id = _EMPTY_I32 if seq_id is None else seq_id
        self.strand = _EMPTY_BOOL if strand is None else strand
        self.pos = _EMPTY_I64 if pos is None else pos

    @classmethod
    def from_list(cls, positions: List[Position]) -> "PositionArray":
        return cls(np.array([p.seq_id for p in positions], np.int32),
                   np.array([p.strand for p in positions], bool),
                   np.array([p.pos for p in positions], np.int64))

    def __len__(self) -> int:
        return len(self.seq_id)

    def __iter__(self) -> Iterator[Position]:
        for i in range(len(self.seq_id)):
            yield Position(int(self.seq_id[i]), bool(self.strand[i]),
                           int(self.pos[i]))

    def __getitem__(self, i: int) -> Position:
        return Position(int(self.seq_id[i]), bool(self.strand[i]),
                        int(self.pos[i]))

    def __repr__(self) -> str:
        return f"[{', '.join(repr(p) for p in self)}]"

    def copy(self) -> "PositionArray":
        return PositionArray(self.seq_id.copy(), self.strand.copy(),
                             self.pos.copy())

    def shift_pos(self, amount: int) -> None:
        """Add ``amount`` to every position (sequence-edit bookkeeping,
        reference unitig.rs:216-248). Writes in place (own slice only)."""
        if len(self.pos):
            self.pos += amount

    def without_seq_ids(self, seq_ids, lut: np.ndarray = None
                        ) -> "PositionArray":
        """Occurrences not belonging to any of the given sequence ids
        (reference unitig.rs:250-257). Pass an int32 ndarray when calling in
        a loop — it goes through without conversion — or a ``seq_id_lut``
        for the one-gather fast path."""
        if not len(self.seq_id):
            return self
        if lut is not None:
            keep = ~lut[self.seq_id]
        else:
            if not isinstance(seq_ids, np.ndarray):
                seq_ids = np.asarray(list(seq_ids), np.int32)
            keep = ~np.isin(self.seq_id, seq_ids)
        if keep.all():
            return self
        return PositionArray(self.seq_id[keep], self.strand[keep],
                             self.pos[keep])

    def only_seq_ids(self, seq_ids: np.ndarray, lut: np.ndarray = None
                     ) -> "PositionArray":
        """Copy holding only occurrences of the given (int32 ndarray) ids.
        Always copies, so the result mutates independently of this array.
        ``lut`` (bool array indexed by seq id) skips the per-call set
        machinery — callers filtering many position lists against the same
        id set (one LUT gather per list vs np.isin's sort per call) should
        build it once with :func:`seq_id_lut`."""
        if not len(self.seq_id):
            return PositionArray()
        m = lut[self.seq_id] if lut is not None else np.isin(self.seq_id, seq_ids)
        return PositionArray(self.seq_id[m], self.strand[m], self.pos[m])

    @staticmethod
    def seq_id_lut(seq_ids) -> np.ndarray:
        """Bool LUT (indexed by seq id) for :meth:`only_seq_ids` /
        :meth:`without_seq_ids` loops. Sized to the full sequence-id space
        (ids are capped at 32767, compress.rs:112-114) so indexing with ANY
        stored seq id is in range regardless of the filter set."""
        ids = np.asarray(list(seq_ids) if not isinstance(seq_ids, np.ndarray)
                         else seq_ids, np.int64)
        lut = np.zeros(MAX_SEQ_ID + 1, bool)
        lut[ids] = True
        return lut

    def concat(self, other: "PositionArray") -> "PositionArray":
        if not len(other):
            return self
        if not len(self):
            return other
        return PositionArray(np.concatenate([self.seq_id, other.seq_id]),
                             np.concatenate([self.strand, other.strand]),
                             np.concatenate([self.pos, other.pos]))
