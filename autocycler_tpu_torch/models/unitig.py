"""Unitig: a compacted non-branching path of the De Bruijn graph.

Parity target: reference unitig.rs.
- dual-strand sequence plus four adjacency lists (unitig.rs:31-45)
- GFA segment serialization with DP/CL tags (unitig.rs:62-100, 167-181)
- sequence edit ops used by repeat expansion (unitig.rs:216-248)
- topology helpers: hairpin/open ends, isolated circular/linear
  (unitig.rs:196-292)

Where the reference juggles Rc<RefCell<Unitig>> + Weak references, we just use
Python object references (the GC handles the cycles) and keep sequences as
numpy uint8 arrays so device kernels can view them zero-copy.
"""

from __future__ import annotations

import enum
from typing import List, Optional

import numpy as np

from ..utils import FORWARD, REVERSE, quit_with_error, reverse_complement_bytes
from .position import PositionArray

ANCHOR_COLOUR = "forestgreen"
BRIDGE_COLOUR = "pink"
CONSENTIG_COLOUR = "steelblue"
OTHER_COLOUR = "orangered"


class UnitigType(enum.Enum):
    ANCHOR = "anchor"
    BRIDGE = "bridge"
    CONSENTIG = "consentig"
    OTHER = "other"


_COLOUR_FOR_TYPE = {
    UnitigType.ANCHOR: ANCHOR_COLOUR,
    UnitigType.BRIDGE: BRIDGE_COLOUR,
    UnitigType.CONSENTIG: CONSENTIG_COLOUR,
    UnitigType.OTHER: OTHER_COLOUR,
}


class Unitig:
    __slots__ = ("number", "forward_seq", "_reverse_seq", "depth", "unitig_type",
                 "forward_positions", "reverse_positions",
                 "forward_next", "forward_prev", "reverse_next", "reverse_prev")

    def __init__(self, number: int = 0,
                 forward_seq: Optional[np.ndarray] = None,
                 reverse_seq: Optional[np.ndarray] = None,
                 depth: float = 0.0,
                 unitig_type: UnitigType = UnitigType.OTHER):
        self.number = number
        self.forward_seq = forward_seq if forward_seq is not None else np.zeros(0, np.uint8)
        # reverse strand is derived lazily: most unitigs of a loaded graph
        # never have their reverse sequence read
        self._reverse_seq = reverse_seq
        self.depth = depth
        self.unitig_type = unitig_type
        self.forward_positions = PositionArray()
        self.reverse_positions = PositionArray()
        self.forward_next: List[UnitigStrand] = []
        self.forward_prev: List[UnitigStrand] = []
        self.reverse_next: List[UnitigStrand] = []
        self.reverse_prev: List[UnitigStrand] = []

    @property
    def reverse_seq(self) -> np.ndarray:
        if self._reverse_seq is None:
            self._reverse_seq = reverse_complement_bytes(self.forward_seq)
        return self._reverse_seq

    @reverse_seq.setter
    def reverse_seq(self, value: Optional[np.ndarray]) -> None:
        self._reverse_seq = value

    # ---------------- construction ----------------

    @classmethod
    def from_segment_line(cls, segment_line: str) -> "Unitig":
        """Parse a GFA S-line (reference unitig.rs:62-91). Requires a DP:f:
        depth tag; unitig type is recovered from the CL:Z: colour tag."""
        parts = segment_line.rstrip("\r\n").split("\t")
        if len(parts) < 3:
            quit_with_error("Segment line does not have enough parts.")
        try:
            number = int(parts[1])
        except ValueError:
            quit_with_error("Unable to parse unitig number.")
        forward_seq = np.frombuffer(parts[2].encode(), dtype=np.uint8).copy()
        depth = None
        for p in parts:
            if p.startswith("DP:f:"):
                try:
                    depth = float(p[5:])
                except ValueError:
                    pass
                break
        if depth is None:
            quit_with_error("Could not find a depth tag (e.g. DP:f:10.00) in the GFA "
                            "segment line.\nAre you sure this is an Autocycler-generated "
                            "GFA file?")
        unitig_type = UnitigType.OTHER
        if f"CL:Z:{CONSENTIG_COLOUR}" in parts:
            unitig_type = UnitigType.CONSENTIG
        elif f"CL:Z:{ANCHOR_COLOUR}" in parts:
            unitig_type = UnitigType.ANCHOR
        elif f"CL:Z:{BRIDGE_COLOUR}" in parts:
            unitig_type = UnitigType.BRIDGE
        return cls(number, forward_seq, depth=depth, unitig_type=unitig_type)

    @classmethod
    def bridge(cls, number: int, forward_seq: np.ndarray, depth: float) -> "Unitig":
        """Manually-built bridge unitig (reference unitig.rs:93-100)."""
        return cls(number, forward_seq, depth=depth, unitig_type=UnitigType.BRIDGE)

    # ---------------- basic accessors ----------------

    def length(self) -> int:
        return len(self.forward_seq)

    def get_seq(self, strand: bool) -> np.ndarray:
        return self.forward_seq if strand else self.reverse_seq

    def seq_str(self, strand: bool = FORWARD) -> str:
        return self.get_seq(strand).tobytes().decode()

    # ---------------- GFA ----------------

    def colour_tag(self, use_other_colour: bool) -> str:
        if self.unitig_type is UnitigType.OTHER and not use_other_colour:
            return ""
        return f"\tCL:Z:{_COLOUR_FOR_TYPE[self.unitig_type]}"

    def gfa_segment_line(self, use_other_colour: bool) -> str:
        return (f"S\t{self.number}\t{self.seq_str()}\tDP:f:{self.depth:.2f}"
                f"{self.colour_tag(use_other_colour)}")

    # ---------------- topology ----------------

    def open_start(self) -> bool:
        return not self.reverse_next

    def open_end(self) -> bool:
        return not self.forward_next

    def hairpin_start(self) -> bool:
        return (len(self.reverse_next) == 1 and self.reverse_next[0].strand == FORWARD
                and self.reverse_next[0].unitig is self)

    def hairpin_end(self) -> bool:
        return (len(self.forward_next) == 1 and self.forward_next[0].strand == REVERSE
                and self.forward_next[0].unitig is self)

    def is_isolated_and_circular(self) -> bool:
        """One circularising self-link and nothing else (unitig.rs:275-281)."""
        if len(self.forward_next) != 1 or len(self.forward_prev) != 1:
            return False
        nxt, prv = self.forward_next[0], self.forward_prev[0]
        return (nxt.unitig is self and nxt.strand and prv.unitig is self and prv.strand)

    def is_isolated_and_linear(self) -> bool:
        """No links except optional hairpin-end self-links (unitig.rs:283-292)."""
        if len(self.forward_next) > 1 or len(self.forward_prev) > 1:
            return False
        if self.is_isolated_and_circular():
            return False
        return (all(u.unitig is self and not u.strand for u in self.forward_next)
                and all(u.unitig is self and not u.strand for u in self.forward_prev)
                and all(u.unitig is self and u.strand for u in self.reverse_next)
                and all(u.unitig is self and u.strand for u in self.reverse_prev))

    # ---------------- sequence edits (repeat expansion) ----------------

    def remove_seq_from_start(self, amount: int) -> None:
        assert amount <= len(self.forward_seq)
        self.forward_positions.shift_pos(amount)
        self.forward_seq = self.forward_seq[amount:]
        if self._reverse_seq is not None:
            # rc reverses order: trimming the forward START trims the
            # reverse END, so a live cache survives as a slice
            self._reverse_seq = self._reverse_seq[:len(self._reverse_seq) - amount]

    def remove_seq_from_end(self, amount: int) -> None:
        assert amount <= len(self.forward_seq)
        self.reverse_positions.shift_pos(amount)
        self.forward_seq = self.forward_seq[:len(self.forward_seq) - amount]
        if self._reverse_seq is not None:
            self._reverse_seq = self._reverse_seq[amount:]

    def add_seq_to_start(self, seq: np.ndarray) -> None:
        self.forward_positions.shift_pos(-len(seq))
        self.forward_seq = np.concatenate([seq, self.forward_seq])
        self._reverse_seq = None

    def add_seq_to_end(self, seq: np.ndarray) -> None:
        self.reverse_positions.shift_pos(-len(seq))
        self.forward_seq = np.concatenate([self.forward_seq, seq])
        self._reverse_seq = None

    # ---------------- positions / depth ----------------

    def remove_sequence(self, seq_id: int) -> None:
        """Drop all positions with the given sequence ID and recalculate depth
        (unitig.rs:250-257)."""
        self.remove_sequences((seq_id,))

    def remove_sequences(self, seq_ids, lut=None) -> None:
        """Batch form of :meth:`remove_sequence` — one mask per strand for
        the whole id set."""
        self.forward_positions = self.forward_positions.without_seq_ids(seq_ids, lut)
        self.reverse_positions = self.reverse_positions.without_seq_ids(seq_ids, lut)
        assert len(self.forward_positions) == len(self.reverse_positions)
        self.recalculate_depth()

    def recalculate_depth(self) -> None:
        self.depth = float(len(self.forward_positions))

    def clear_positions(self) -> None:
        self.forward_positions = PositionArray()
        self.reverse_positions = PositionArray()

    def reduce_depth_by_one(self) -> None:
        self.depth = max(0.0, self.depth - 1.0)

    def clear_all_links(self) -> None:
        self.forward_next = []
        self.forward_prev = []
        self.reverse_next = []
        self.reverse_prev = []

    def __str__(self) -> str:
        seq = self.seq_str()
        display = seq if len(seq) < 15 else f"{seq[:6]}...{seq[-6:]}"
        return f"unitig {self.number}: {display}, {len(seq)} bp, {self.depth:.2f}x"

    __repr__ = __str__


class UnitigStrand:
    """A unitig viewed on one strand (reference unitig.rs:322-372)."""

    __slots__ = ("unitig", "strand")

    def __init__(self, unitig: Unitig, strand: bool):
        self.unitig = unitig
        self.strand = strand

    @property
    def number(self) -> int:
        return self.unitig.number

    def signed_number(self) -> int:
        return self.unitig.number if self.strand else -self.unitig.number

    def length(self) -> int:
        return self.unitig.length()

    def depth(self) -> float:
        return self.unitig.depth

    def get_seq(self) -> np.ndarray:
        return self.unitig.get_seq(self.strand)

    def seq_prefix(self, n: int) -> np.ndarray:
        """First n symbols of the strand sequence. On the reverse strand
        this reverse-complements only an n-symbol window of the forward
        sequence instead of materialising the full reverse strand (repeat
        expansion probes prefixes of multi-Mbp unitigs after every edit).

        Contract: n <= length(). The windowed reverse-strand slice would
        silently wrap on a larger n, so it is asserted rather than clamped.
        """
        u = self.unitig
        assert n <= u.length(), (n, u.length())
        if self.strand:
            return u.forward_seq[:n]
        if u._reverse_seq is not None:
            return u._reverse_seq[:n]
        f = u.forward_seq
        return reverse_complement_bytes(f[len(f) - n:]) if n else f[:0]

    def seq_suffix(self, n: int) -> np.ndarray:
        """Last n symbols of the strand sequence (windowed like
        :meth:`seq_prefix`; same n <= length() contract)."""
        u = self.unitig
        assert n <= u.length(), (n, u.length())
        f = u.forward_seq
        if self.strand:
            return f[len(f) - n:] if n else f[:0]
        if u._reverse_seq is not None:
            r = u._reverse_seq
            return r[len(r) - n:] if n else r[:0]
        return reverse_complement_bytes(f[:n])

    def is_anchor(self) -> bool:
        return self.unitig.unitig_type is UnitigType.ANCHOR

    def is_consentig(self) -> bool:
        return self.unitig.unitig_type is UnitigType.CONSENTIG

    def flipped(self) -> "UnitigStrand":
        return UnitigStrand(self.unitig, not self.strand)

    def __repr__(self) -> str:
        return f"{self.unitig.number}{'+' if self.strand else '-'}"
