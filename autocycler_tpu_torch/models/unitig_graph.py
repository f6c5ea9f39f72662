"""UnitigGraph: the central host-side graph structure.

Parity target: reference unitig_graph.rs (1501 LoC). The graph is the
serialization format of the whole data model: every pipeline stage writes a
self-contained GFA (S segments with DP/CL tags, 0M L links, P path lines with
LN/FN/HD/CL provenance tags) that the next stage re-loads — see reference
unitig_graph.rs:50-174 (load) and :317-360 (save).

Construction from k-mers happens in ops/ + commands/compress.py (the device
path); this module owns parsing, serialization, link surgery, invariants and
topology queries. Irregular pointer-chasing graph mutation stays on the host
by design (SURVEY.md §2.1, §7).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils import FORWARD, REVERSE, load_file_lines, quit_with_error
from .position import MAX_SEQ_ID, PositionArray
from .sequence import Sequence
from .unitig import Unitig, UnitigStrand


def parse_unitig_path(path_str: str) -> List[Tuple[int, bool]]:
    """'1+,2-,3+' -> [(1, True), (2, False), (3, True)]
    (reference unitig_graph.rs:971-979)."""
    path = []
    for token in path_str.split(","):
        if token.endswith("+"):
            strand = FORWARD
        elif token.endswith("-"):
            strand = REVERSE
        else:
            quit_with_error(f"Invalid path strand: {token}")
        try:
            number = int(token[:-1])
        except ValueError:
            quit_with_error(f"unable to parse path unitig number: {token!r}")
        if number < 1:
            # dense-LUT consumers index by number; a negative here would
            # wrap via Python negative indexing onto the wrong unitig
            quit_with_error(f"path unitig numbers must be positive: {token!r}")
        path.append((number, strand))
    return path


def parse_unitig_path_arrays(path_str: str) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised :func:`parse_unitig_path`: '1+,2-' -> (numbers int64[],
    strands bool[]). The whole P-line path is parsed with array ops (digit
    place-value accumulation per token) instead of per-token string slicing;
    malformed input falls back to the scalar parser for its error message."""
    b = np.frombuffer(path_str.encode(), np.uint8)
    if len(b) == 0:
        quit_with_error("Invalid path strand: ")
    is_comma = b == 44
    sign_idx = np.flatnonzero((b == 43) | (b == 45))
    comma_idx = np.flatnonzero(is_comma)
    T = len(comma_idx) + 1
    starts = np.concatenate([[0], comma_idx + 1])
    ends = np.concatenate([comma_idx, [len(b)]])
    digit_mask = (b >= 48) & (b <= 57)
    ok = (len(sign_idx) == T
          and np.array_equal(sign_idx, ends - 1)       # sign char ends token
          and (sign_idx - starts >= 1).all()           # >=1 digit per token
          # >15-digit ids would lose precision in the f64 place-value sum
          and (sign_idx - starts <= 15).all()
          and (digit_mask | is_comma | (b == 43) | (b == 45)).all())
    if not ok:
        path = parse_unitig_path(path_str)              # scalar error parity
        return (np.array([n for n, _ in path], np.int64),
                np.array([s for _, s in path], bool))
    # place-value accumulation: digit at i in token t weighs 10^(end_t-2-i)
    di = np.flatnonzero(digit_mask)
    tok = np.searchsorted(starts, di, side="right") - 1
    exp = (sign_idx[tok] - 1 - di).astype(np.float64)
    vals = np.bincount(tok, weights=(b[di] - 48) * 10.0 ** exp, minlength=T)
    if (vals < 1).any():
        parse_unitig_path(path_str)   # scalar parser rejects '0...' tokens
    return vals.astype(np.int64), b[sign_idx] == 43


def reverse_path(path: List[Tuple[int, bool]]) -> List[Tuple[int, bool]]:
    return [(num, not strand) for num, strand in reversed(path)]


class UnitigGraph:
    def __init__(self, k_size: int = 0):
        self.unitigs: List[Unitig] = []
        self.k_size = k_size
        self.index: Dict[int, Unitig] = {}
        # paths parsed from the GFA P-lines, valid until any mutation that
        # could change path composition (see invalidate_paths_cache callers);
        # position-COORDINATE edits (repeat expansion) keep it valid because
        # the (number, strand) sequence of every path is unchanged
        self._paths_cache = None
        # same P-line paths in array form (numbers int64[], strands bool[]),
        # kept so bulk consumers (get_sequences_for_ids) never touch
        # per-piece python tuples; invalidated together with _paths_cache
        self._paths_arrays_cache = None

    # ---------------- loading ----------------

    @classmethod
    def from_gfa_file(cls, gfa_filename) -> Tuple["UnitigGraph", List[Sequence]]:
        from ..utils.resilience import InputError, fault_fire
        if fault_fire("gfa", str(gfa_filename)) is not None:
            raise InputError(f"fault injection: corrupt GFA read: {gfa_filename}")
        return cls.from_gfa_lines(load_file_lines(gfa_filename))

    @classmethod
    def from_gfa_lines(cls, gfa_lines,
                       check: bool = True) -> Tuple["UnitigGraph", List[Sequence]]:
        """check=False skips the link-invariant pass — only for re-loading
        lines this process just generated itself (e.g. per-cluster subsetting
        of an in-memory graph); external files are always checked."""
        graph = cls()
        link_lines, path_lines = [], []
        for line in gfa_lines:
            parts = line.rstrip("\r\n").split("\t")
            if not parts:
                continue
            if parts[0] == "H":
                graph._read_header_line(parts)
            elif parts[0] == "S":
                graph.unitigs.append(Unitig.from_segment_line(line))
            elif parts[0] == "L":
                link_lines.append(parts)
            elif parts[0] == "P":
                path_lines.append(parts)
        seen = set()
        for u in graph.unitigs:
            if u.number < 1:
                # dense LUTs index by number; zero/negative would wrap via
                # Python negative indexing onto the wrong unitig
                quit_with_error(f"segment numbers must be positive: {u.number}")
            if u.number in seen:
                quit_with_error(f"duplicate segment number in GFA: {u.number}")
            seen.add(u.number)
        graph.build_index()
        graph._build_links_from_gfa(link_lines)
        sequences = graph._build_paths_from_gfa(path_lines)
        if check:
            graph.check_links()
        return graph, sequences

    def _read_header_line(self, parts: List[str]) -> None:
        for p in parts:
            if p.startswith("KM:i:"):
                try:
                    self.k_size = int(p[5:])
                    return
                except ValueError:
                    pass

    def build_index(self) -> None:
        self.index = {u.number: u for u in self.unitigs}

    def _dense_luts(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """(max_num, row_of, lengths): dense number-indexed tables; -1 in
        row_of marks absent numbers (lengths valid only where row_of >= 0).
        Valid only until the unitig list next changes."""
        max_num = self.max_unitig_number()
        row_of = np.full(max_num + 1, -1, np.int64)
        lengths = np.zeros(max_num + 1, np.int64)
        for r, u in enumerate(self.unitigs):
            row_of[u.number] = r
            lengths[u.number] = len(u.forward_seq)
        return max_num, row_of, lengths

    def _build_links_from_gfa(self, link_lines: List[List[str]]) -> None:
        for parts in link_lines:
            if len(parts) < 6 or parts[5] != "0M":
                quit_with_error("non-zero overlap found on the GFA link line.\n"
                                "Are you sure this is an Autocycler-generated GFA file?")
            try:
                seg_1, seg_2 = int(parts[1]), int(parts[3])
            except ValueError:
                quit_with_error(f"unable to parse link segment numbers: "
                                f"{parts[1]!r}, {parts[3]!r}")
            if parts[2] not in ("+", "-") or parts[4] not in ("+", "-"):
                quit_with_error(f"invalid strand on GFA link line: "
                                f"{parts[2]!r}, {parts[4]!r}")
            strand_1, strand_2 = parts[2] == "+", parts[4] == "+"
            u1 = self.index.get(seg_1)
            u2 = self.index.get(seg_2)
            if u1 is None:
                quit_with_error(f"link refers to nonexistent unitig: {seg_1}")
            if u2 is None:
                quit_with_error(f"link refers to nonexistent unitig: {seg_2}")
            (u1.forward_next if strand_1 else u1.reverse_next).append(UnitigStrand(u2, strand_2))
            (u2.forward_prev if strand_2 else u2.reverse_prev).append(UnitigStrand(u1, strand_1))

    def _build_paths_from_gfa(self, path_lines: List[List[str]]) -> List[Sequence]:
        sequences = []
        entries = []
        paths_cache = {}
        # dense LUTs for the vectorised per-path LN check, shared with
        # stamp_paths_batch (skipped entirely when there are no P-lines)
        luts = self._dense_luts() if path_lines else None
        for parts in path_lines:
            if len(parts) < 3:
                quit_with_error("GFA path line does not have enough parts.")
            try:
                seq_id = int(parts[1])
            except ValueError:
                quit_with_error(f"unable to parse P-line sequence id: {parts[1]!r}")
            if not 0 <= seq_id <= MAX_SEQ_ID:
                quit_with_error(f"P-line sequence id {seq_id} outside the "
                                f"supported range 0..{MAX_SEQ_ID} (15-bit "
                                "id space, reference position.rs:21)")
            if seq_id in paths_cache:
                quit_with_error(f"duplicate P-line sequence id in GFA: {seq_id}")
            length = filename = header = None
            cluster = 0
            try:
                for p in parts[2:]:
                    if p.startswith("LN:i:"):
                        length = int(p[5:])
                    elif p.startswith("FN:Z:"):
                        filename = p[5:]
                    elif p.startswith("HD:Z:"):
                        header = p[5:]
                    elif p.startswith("CL:i:"):
                        cluster = int(p[5:])
            except ValueError:
                quit_with_error(f"unable to parse integer tag on GFA path "
                                f"line for sequence {seq_id}")
            if length is None or filename is None or header is None:
                quit_with_error("missing required tag in GFA path line.")
            numbers, strands = parse_unitig_path_arrays(parts[2])
            # missing path unitigs get their own error in stamp_paths_batch;
            # only a complete path can be length-validated here
            max_num, row_of, lengths = luts
            if len(numbers) and numbers.max() <= max_num \
                    and (row_of[numbers] >= 0).all():
                path_bp = int(lengths[numbers].sum())
                if path_bp != length:
                    quit_with_error(
                        f"P-line for sequence {seq_id} declares LN:i:{length} "
                        f"but its path totals {path_bp} bp — the GFA paths "
                        "do not match its segments")
            entries.append((seq_id, length, numbers, strands))
            sequences.append(Sequence.without_seq(seq_id, filename, header,
                                                  length, cluster))
            paths_cache[seq_id] = list(zip(numbers.tolist(), strands.tolist()))
        self.stamp_paths_batch(entries, luts=luts)
        self._paths_cache = paths_cache
        self._paths_arrays_cache = {e[0]: (e[2], e[3]) for e in entries}
        return sequences

    def stamp_paths_batch(self, entries, luts=None) -> None:
        """Stamp many sequence paths in one vectorised pass. ``entries`` is a
        list of (seq_id, length, numbers int64[], strands bool[]).
        ``luts`` optionally passes a prebuilt :meth:`_dense_luts` result so
        a caller that already built the tables doesn't rebuild them.

        One pass covers both strands: the reverse-path position of the step
        at forward position p is length - p - len(unitig)
        (reference unitig_graph.rs:151-174). All stamps of the batch are
        grouped per (unitig, strand) with one sort, then assigned as array
        slices — positions become views into two batch-level SoA blocks.
        Position ORDER within a unitig is not part of the model's contract
        (every consumer sorts or filters)."""
        self.invalidate_paths_cache()
        entries = [e for e in entries if len(e[2])]
        if not entries:
            return
        numbers_all = np.concatenate([e[2] for e in entries])
        strands_all = np.concatenate([e[3] for e in entries])
        sid_all = np.concatenate([np.full(len(e[2]), e[0], np.int32)
                                  for e in entries])
        L_all = np.concatenate([np.full(len(e[2]), e[1], np.int64)
                                for e in entries])
        path_off = np.zeros(len(entries) + 1, np.int64)
        np.cumsum([len(e[2]) for e in entries], out=path_off[1:])

        # dense number -> (row, length) lookup
        max_num, row_of, lengths = luts if luts is not None \
            else self._dense_luts()
        if numbers_all.min(initial=1) < 1 or \
                numbers_all.max(initial=0) > max_num or \
                (row_of[numbers_all] < 0).any():
            # min check first: a negative number would silently wrap through
            # the dense LUTs via Python negative indexing
            bad = numbers_all[(numbers_all < 1) | (numbers_all > max_num) |
                              (row_of[np.clip(numbers_all, 0, max_num)] < 0)][0]
            quit_with_error(f"unitig {int(bad)} not found in unitig index")
        ln = lengths[numbers_all]
        rows = row_of[numbers_all]

        # per-path exclusive cumsum of step lengths = forward positions
        cum = np.cumsum(ln)
        base = np.zeros(len(ln), np.int64)
        base[path_off[1:-1]] = cum[path_off[1:-1] - 1]
        pos = cum - ln - np.maximum.accumulate(base)
        # every path must sum to its declared length
        ends = cum[path_off[1:] - 1] - np.concatenate(
            [[0], cum[path_off[1:-1] - 1]])
        declared = np.array([e[1] for e in entries])
        # internal invariant (reference unitig_graph.rs:386) — malformed GFA
        # input is caught with a user-facing error in _build_paths_from_gfa
        # before entries reach this helper
        assert np.array_equal(ends, declared), \
            f"path length mismatch for sequence " \
            f"{entries[int(np.nonzero(ends != declared)[0][0])][0]}"

        mirror = L_all - pos - ln
        # first half: FORWARD stamps at pos; second half: REVERSE at mirror.
        # A + step stamps FORWARD onto the forward list (side True); a - step
        # stamps FORWARD onto the reverse list.
        side = np.concatenate([strands_all, ~strands_all])
        st = np.concatenate([np.ones(len(pos), bool), np.zeros(len(pos), bool)])
        sp = np.concatenate([pos, mirror])
        ssid = np.concatenate([sid_all, sid_all])
        srow = np.concatenate([rows, rows])

        key = srow * 2 + side
        order = np.argsort(key, kind="stable")
        ssid = ssid[order]
        st = st[order]
        sp = sp[order]
        touched = np.unique(key[order])
        bounds = np.searchsorted(key[order], np.concatenate([touched,
                                                             [key.max() + 1]]))
        for t in range(len(touched)):
            r, is_fwd = divmod(int(touched[t]), 2)
            u = self.unitigs[r]
            arr = PositionArray(ssid[bounds[t]:bounds[t + 1]],
                                st[bounds[t]:bounds[t + 1]],
                                sp[bounds[t]:bounds[t + 1]])
            if is_fwd:
                u.forward_positions = u.forward_positions.concat(arr)
            else:
                u.reverse_positions = u.reverse_positions.concat(arr)

    # ---------------- saving ----------------

    def save_gfa(self, gfa_filename, sequences: List[Sequence],
                 use_other_colour: bool = False) -> None:
        """Streams the same bytes gfa_text produces, but writes each unitig's
        sequence array directly instead of decoding Mbp of segments into
        Python strings first."""
        with open(gfa_filename, "wb") as f:
            f.write(f"H\tVN:Z:1.0\tKM:i:{self.k_size}\n".encode())
            for unitig in self.unitigs:
                f.write(f"S\t{unitig.number}\t".encode())
                f.write(unitig.forward_seq.tobytes())
                f.write(f"\tDP:f:{unitig.depth:.2f}"
                        f"{unitig.colour_tag(use_other_colour)}\n".encode())
            for a, a_strand, b, b_strand in self.links_for_gfa():
                f.write(f"L\t{a}\t{a_strand}\t{b}\t{b_strand}\t0M\n".encode())
            paths = self.get_unitig_paths_for_sequences([s.id for s in sequences])
            for seq in sequences:
                f.write(self.gfa_path_line(seq, paths[seq.id]).encode())
                f.write(b"\n")

    def gfa_text(self, sequences: List[Sequence], use_other_colour: bool = False) -> str:
        lines = [f"H\tVN:Z:1.0\tKM:i:{self.k_size}"]
        for unitig in self.unitigs:
            lines.append(unitig.gfa_segment_line(use_other_colour))
        for a, a_strand, b, b_strand in self.links_for_gfa():
            lines.append(f"L\t{a}\t{a_strand}\t{b}\t{b_strand}\t0M")
        paths = self.get_unitig_paths_for_sequences([s.id for s in sequences])
        for seq in sequences:
            lines.append(self.gfa_path_line(seq, paths[seq.id]))
        return "\n".join(lines) + "\n"

    def links_for_gfa(self, offset: int = 0):
        links = []
        for a in self.unitigs:
            for b in a.forward_next:
                links.append((a.number + offset, "+", b.number + offset,
                              "+" if b.strand else "-"))
            for b in a.reverse_next:
                links.append((a.number + offset, "-", b.number + offset,
                              "+" if b.strand else "-"))
        return links

    def gfa_path_line(self, seq: Sequence, path=None) -> str:
        if path is None:
            path = self.get_unitig_path_for_sequence(seq)
        path_str = ",".join(f"{num}{'+' if strand else '-'}" for num, strand in path)
        cluster_tag = f"\tCL:i:{seq.cluster}" if seq.cluster > 0 else ""
        return (f"P\t{seq.id}\t{path_str}\t*\tLN:i:{seq.length}\tFN:Z:{seq.filename}"
                f"\tHD:Z:{seq.contig_header}{cluster_tag}")

    # ---------------- sequence reconstruction ----------------

    def get_sequence_from_path(self, path: List[Tuple[int, bool]]) -> np.ndarray:
        pieces = [self.index[num].get_seq(strand) for num, strand in path]
        if not pieces:
            return np.zeros(0, dtype=np.uint8)
        return np.concatenate(pieces)

    def get_sequence_from_path_signed(self, path: List[int]) -> np.ndarray:
        return self.get_sequence_from_path([(abs(n), n >= 0) for n in path])

    def _path_arrays_for_sequences(self, seq_ids
                                   ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """(numbers int64[], strands bool[]) per path. The GFA loader's
        array cache is returned directly; a mutated graph falls back to
        the tuple sweep and converts once."""
        cache = self._paths_arrays_cache
        if cache is not None and all(sid in cache for sid in seq_ids):
            return {sid: cache[sid] for sid in seq_ids}
        out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for sid, path in self.get_unitig_paths_for_sequences(seq_ids).items():
            nums = np.fromiter((p[0] for p in path), np.int64, len(path))
            strs = np.fromiter((p[1] for p in path), bool, len(path))
            out[sid] = (nums, strs)
        return out

    def get_sequences_for_ids(self, seq_ids) -> Dict[int, np.ndarray]:
        """Reconstruct many sequences at once: every unitig strand that
        any path touches is laid out once in a flat byte pool, pool
        offsets live in dense LUTs indexed by unitig number, and each
        path becomes a single fancy-index gather (one cumsum of per-piece
        position jumps). Bit-identical to get_sequence_from_path per id
        (asserted in tests), but O(total bp) array work with no per-piece
        python — the difference dominates on SNP-shredded graphs where
        pieces average tens of bases."""
        seq_ids = list(seq_ids)
        out: Dict[int, np.ndarray] = {}
        if not seq_ids:
            return out
        if not self.unitigs:
            return {sid: np.zeros(0, np.uint8) for sid in seq_ids}
        arrs = self._path_arrays_for_sequences(seq_ids)
        max_num = max(u.number for u in self.unitigs)
        # reverse strands are computed lazily per unitig; only pool the
        # ones some path actually walks backwards
        rev_used = np.zeros(max_num + 1, bool)
        for sid in seq_ids:
            nums, strs = arrs[sid]
            if nums.size:
                rev_used[nums[~strs]] = True
        len_lut = np.zeros(max_num + 1, np.int64)
        start_lut = np.zeros(2 * (max_num + 1), np.int64)
        parts: List[np.ndarray] = []
        cursor = 0
        for u in self.unitigs:
            n = len(u.forward_seq)
            len_lut[u.number] = n
            start_lut[2 * u.number + 1] = cursor
            parts.append(u.forward_seq)
            cursor += n
            if rev_used[u.number]:
                start_lut[2 * u.number] = cursor
                parts.append(u.reverse_seq)
                cursor += n
        pool = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        for sid in seq_ids:
            nums, strs = arrs[sid]
            ln = len_lut[nums]
            nz = ln > 0
            if not nz.all():
                nums, strs, ln = nums[nz], strs[nz], ln[nz]
            if not nums.size:
                out[sid] = np.zeros(0, np.uint8)
                continue
            st = start_lut[2 * nums + strs]
            total = int(ln.sum())
            # positions walk each piece start..start+len-1 consecutively:
            # ones everywhere, piece-boundary jumps patched in, one cumsum
            step = np.ones(total, np.int64)
            step[0] = st[0]
            ends = np.cumsum(ln)
            step[ends[:-1]] = st[1:] - st[:-1] - ln[:-1] + 1
            out[sid] = pool[np.cumsum(step)]
        return out

    def invalidate_paths_cache(self) -> None:
        self._paths_cache = None
        self._paths_arrays_cache = None

    def get_unitig_paths_for_sequences(self, seq_ids) -> Dict[int, List[Tuple[int, bool]]]:
        """Paths for many sequences in one sweep: every unitig's forward-
        strand positions are collected and sorted by coordinate, which
        reconstructs each path without the reference's step-by-step
        neighbour walk (unitig_graph.rs:407-465) — same result, O(total
        positions) instead of O(path · degree · positions).

        When the graph is unmutated since a GFA load, the parsed P-line
        paths are returned directly (identical by construction — asserted
        in tests/test_models_more.py).

        The sweep is pure array work on the per-unitig position SoAs: one
        concatenate per field, one mask, one lexsort."""
        cache = self._paths_cache
        if cache is not None and all(sid in cache for sid in seq_ids):
            return {sid: list(cache[sid]) for sid in seq_ids}
        wanted = set(seq_ids)
        out: Dict[int, List[Tuple[int, bool]]] = {sid: [] for sid in wanted}
        if not self.unitigs:
            return out
        sid = np.concatenate([a for u in self.unitigs
                              for a in (u.forward_positions.seq_id,
                                        u.reverse_positions.seq_id)])
        occ_strand = np.concatenate([a for u in self.unitigs
                                     for a in (u.forward_positions.strand,
                                               u.reverse_positions.strand)])
        pos = np.concatenate([a for u in self.unitigs
                              for a in (u.forward_positions.pos,
                                        u.reverse_positions.pos)])
        counts = np.fromiter((c for u in self.unitigs
                              for c in (len(u.forward_positions),
                                        len(u.reverse_positions))),
                             np.int64, count=2 * len(self.unitigs))
        codes = np.fromiter((c for u in self.unitigs
                             for c in ((u.number << 1) | 1, u.number << 1)),
                            np.int64, count=2 * len(self.unitigs))
        code = np.repeat(codes, counts)
        lens = np.repeat(
            np.fromiter((len(u.forward_seq) for u in self.unitigs),
                        np.int64, count=len(self.unitigs)).repeat(2), counts)

        m = occ_strand  # forward-strand occurrences define the path
        sid, pos, code, lens = sid[m], pos[m], code[m], lens[m]
        order = np.lexsort((pos, sid))
        sid, pos, code, lens = sid[order], pos[order], code[order], lens[order]
        starts = np.searchsorted(sid, np.unique(sid))
        bounds = np.concatenate([starts, [len(sid)]])
        uniq = sid[starts] if len(starts) else np.zeros(0, np.int32)
        for i, s in enumerate(uniq.tolist()):
            if s not in wanted:
                continue
            lo, hi = bounds[i], bounds[i + 1]
            p = pos[lo:hi]
            expected = np.zeros(hi - lo, np.int64)
            np.cumsum(lens[lo:hi - 1], out=expected[1:])
            assert np.array_equal(p, expected), "sequence path is not contiguous"
            c = code[lo:hi]
            out[s] = list(zip((c >> 1).tolist(), (c & 1).astype(bool).tolist()))
        return out

    def get_unitig_path_for_sequence(self, seq: Sequence) -> List[Tuple[int, bool]]:
        return self.get_unitig_paths_for_sequences([seq.id])[seq.id]

    def get_unitig_path_for_sequence_i32(self, seq: Sequence) -> List[int]:
        return [num if strand else -num
                for num, strand in self.get_unitig_path_for_sequence(seq)]

    def reconstruct_original_sequences(self, seqs: List[Sequence]
                                       ) -> Dict[str, List[Tuple[str, str]]]:
        """filename -> [(header, sequence string)], in input order
        (reference unitig_graph.rs:362-370)."""
        out: Dict[str, List[Tuple[str, str]]] = {}
        paths = self.get_unitig_paths_for_sequences([s.id for s in seqs])
        for seq in seqs:
            sequence = self.get_sequence_from_path(paths[seq.id])
            assert len(sequence) == seq.length, \
                "reconstructed sequence does not have expected length"
            out.setdefault(seq.filename, []).append(
                (seq.contig_header, sequence.tobytes().decode()))
        return out

    # ---------------- stats / topology ----------------

    def total_length(self) -> int:
        return sum(u.length() for u in self.unitigs)

    def link_count(self) -> Tuple[int, int]:
        """(all links incl. reverse-duplicates, single-direction links)
        (reference unitig_graph.rs:478-507). One canonical set instead of
        two: the closure size is 2·|undirected| − |self-symmetric| (a link
        equals its own reverse iff dst == −src)."""
        one_way = set()
        for a in self.unitigs:
            for signed_a, nexts in ((a.number, a.forward_next), (-a.number, a.reverse_next)):
                for b in nexts:
                    link = (signed_a, b.signed_number())
                    rev_link = (-link[1], -link[0])
                    one_way.add(link if link >= rev_link else rev_link)
        self_sym = sum(1 for (x, y) in one_way if x == -y)
        return 2 * len(one_way) - self_sym, len(one_way)

    def topology(self) -> str:
        """circular / linear-open-open / linear-hairpin-hairpin /
        linear-open-hairpin / fragmented / empty / other
        (reference unitig_graph.rs:527-545)."""
        if not self.unitigs:
            return "empty"
        if len(self.unitigs) > 1:
            return "fragmented"
        u = self.unitigs[0]
        if self.link_count()[0] == 0:
            return "linear-open-open"
        if u.is_isolated_and_circular():
            return "circular"
        if u.hairpin_start() and u.hairpin_end():
            return "linear-hairpin-hairpin"
        if u.hairpin_start() and u.open_end():
            return "linear-open-hairpin"
        if u.open_start() and u.hairpin_end():
            return "linear-open-hairpin"
        return "other"

    def max_unitig_number(self) -> int:
        return max((u.number for u in self.unitigs), default=0)

    def print_basic_graph_info(self, with_topology: bool = False) -> None:
        from ..utils import log
        n, links = len(self.unitigs), self.link_count()[1]
        topo = f" ({self.topology()})" if with_topology else ""
        log.message(f"{n} unitig{'' if n == 1 else 's'}, "
                    f"{links} link{'' if links == 1 else 's'}{topo}")
        log.message(f"total length: {self.total_length()} bp")
        log.message()

    # ---------------- renumbering ----------------

    def renumber_unitigs(self) -> None:
        """Deterministic renumbering by (length desc, sequence lex asc,
        depth desc) — the reproducibility anchor of the whole pipeline
        (reference unitig_graph.rs:295-315)."""
        self.invalidate_paths_cache()
        self.unitigs.sort(key=lambda u: (-u.length(), u.forward_seq.tobytes(), -u.depth))
        for i, unitig in enumerate(self.unitigs):
            unitig.number = i + 1
        self.build_index()

    # ---------------- link surgery ----------------

    def _unitig_for_signed(self, signed_num: int) -> Tuple[Unitig, bool]:
        unitig = self.index.get(abs(signed_num))
        if unitig is None:
            quit_with_error(f"unitig {abs(signed_num)} not found in unitig index")
        return unitig, signed_num > 0

    def create_link(self, start_num: int, end_num: int) -> None:
        """Create a signed link (and its reverse-strand twin unless it is its
        own twin, i.e. a hairpin) (reference unitig_graph.rs:867-893)."""
        self._create_link_one_way(start_num, end_num)
        if start_num != -end_num:
            self._create_link_one_way(-end_num, -start_num)

    def _create_link_one_way(self, start_num: int, end_num: int) -> None:
        start, start_strand = self._unitig_for_signed(start_num)
        end, end_strand = self._unitig_for_signed(end_num)
        (start.forward_next if start_strand else start.reverse_next).append(
            UnitigStrand(end, end_strand))
        (end.forward_prev if end_strand else end.reverse_prev).append(
            UnitigStrand(start, start_strand))

    def delete_link(self, start_num: int, end_num: int) -> None:
        self._delete_link_one_way(start_num, end_num)
        self._delete_link_one_way(-end_num, -start_num)

    def _delete_link_one_way(self, start_num: int, end_num: int) -> None:
        start, start_strand = self._unitig_for_signed(start_num)
        end, end_strand = self._unitig_for_signed(end_num)
        nexts = start.forward_next if start_strand else start.reverse_next
        keep = [c for c in nexts
                if not (c.number == abs(end_num) and c.strand == (end_num > 0))]
        if start_strand:
            start.forward_next = keep
        else:
            start.reverse_next = keep
        prevs = end.forward_prev if end_strand else end.reverse_prev
        keep = [c for c in prevs
                if not (c.number == abs(start_num) and c.strand == (start_num > 0))]
        if end_strand:
            end.forward_prev = keep
        else:
            end.reverse_prev = keep

    def delete_outgoing_links(self, signed_num: int) -> None:
        unitig, strand = self._unitig_for_signed(signed_num)
        nexts = unitig.forward_next if strand else unitig.reverse_next
        for next_num in [u.signed_number() for u in nexts]:
            self.delete_link(signed_num, next_num)

    def delete_incoming_links(self, signed_num: int) -> None:
        unitig, strand = self._unitig_for_signed(signed_num)
        prevs = unitig.forward_prev if strand else unitig.reverse_prev
        for prev_num in [u.signed_number() for u in prevs]:
            self.delete_link(prev_num, signed_num)

    def link_exists(self, a_num: int, a_strand: bool, b_num: int, b_strand: bool) -> bool:
        unitig = self.index.get(a_num)
        if unitig is None:
            return False
        nexts = unitig.forward_next if a_strand else unitig.reverse_next
        return any(n.number == b_num and n.strand == b_strand for n in nexts)

    def link_exists_prev(self, a_num: int, a_strand: bool, b_num: int, b_strand: bool) -> bool:
        unitig = self.index.get(b_num)
        if unitig is None:
            return False
        prevs = unitig.forward_prev if b_strand else unitig.reverse_prev
        return any(p.number == a_num and p.strand == a_strand for p in prevs)

    def check_links(self) -> None:
        """Invariant checker: every link has its strand twin, its prev/next
        mirror, and resolves through the index (reference
        unitig_graph.rs:752-793). Raises AssertionError on violation.

        Set-based: all next- and prev-edges are collected once, then every
        edge (either direction) must appear in both sets along with its
        strand twin — O(E) instead of per-link adjacency-list scans."""
        nexts, prevs = set(), set()
        for a in self.unitigs:
            for b in a.forward_next:
                nexts.add((a.number, FORWARD, b.number, b.strand))
            for b in a.reverse_next:
                nexts.add((a.number, REVERSE, b.number, b.strand))
            for b in a.forward_prev:
                prevs.add((b.number, b.strand, a.number, FORWARD))
            for b in a.reverse_prev:
                prevs.add((b.number, b.strand, a.number, REVERSE))
        # the per-edge form (each edge and its twin in both sets) reduces to
        # three whole-set relations, all C-speed; the assert messages (only
        # evaluated on failure) name the offending links
        assert nexts == prevs, \
            f"missing next/prev link: {sorted(nexts ^ prevs)[:5]}"
        twins = {(b_num, not b_strand, a_num, not a_strand)
                 for (a_num, a_strand, b_num, b_strand) in nexts}
        assert twins <= nexts, \
            f"missing strand-twin link: {sorted(twins - nexts)[:5]}"
        nums = {n for (a_num, _, b_num, _) in nexts for n in (a_num, b_num)}
        assert nums <= self.index.keys(), \
            f"unitig missing from index: {sorted(nums - self.index.keys())[:5]}"

    def delete_dangling_links(self) -> None:
        """Drop links that point at unitigs no longer in the graph
        (reference unitig_graph.rs:547-564)."""
        numbers = {u.number for u in self.unitigs}
        for u in self.unitigs:
            u.forward_next = [c for c in u.forward_next if c.number in numbers]
            u.forward_prev = [c for c in u.forward_prev if c.number in numbers]
            u.reverse_next = [c for c in u.reverse_next if c.number in numbers]
            u.reverse_prev = [c for c in u.reverse_prev if c.number in numbers]

    # ---------------- unitig-level surgery ----------------

    def remove_sequence_from_graph(self, seq_id: int) -> None:
        self.remove_sequences_from_graph((seq_id,))

    def remove_sequences_from_graph(self, seq_ids) -> None:
        """Batched removal: one position mask per unitig strand for the whole
        id set instead of a sweep per sequence."""
        self.invalidate_paths_cache()
        seq_ids = np.asarray(list(seq_ids), np.int32)
        if not len(seq_ids):
            return
        lut = PositionArray.seq_id_lut(seq_ids)
        for u in self.unitigs:
            u.remove_sequences(seq_ids, lut)

    def recalculate_depths(self) -> None:
        for u in self.unitigs:
            u.recalculate_depth()

    def clear_positions(self) -> None:
        self.invalidate_paths_cache()
        for u in self.unitigs:
            u.clear_positions()

    def remove_zero_depth_unitigs(self) -> None:
        self.invalidate_paths_cache()
        self.unitigs = [u for u in self.unitigs if u.depth > 0.0]
        self.delete_dangling_links()
        self.build_index()

    def remove_unitigs_by_number(self, to_remove) -> None:
        self.invalidate_paths_cache()
        to_remove = set(to_remove)
        self.unitigs = [u for u in self.unitigs if u.number not in to_remove]
        self.delete_dangling_links()
        self.build_index()

    def duplicate_unitig_by_number(self, unitig_num: int) -> None:
        """Split a unitig with exactly two non-self links into two half-depth
        copies, one link each; self-links are copied to both
        (reference unitig_graph.rs:594-653)."""
        self.invalidate_paths_cache()
        target = self.index.get(unitig_num)
        if target is None:
            quit_with_error(f"unitig {unitig_num} not found in unitig index")
        non_self = [(target.number, link.signed_number())
                    for link in target.forward_next if link.number != unitig_num]
        non_self += [(-target.number, link.signed_number())
                     for link in target.reverse_next if link.number != unitig_num]
        if len(non_self) != 2:
            quit_with_error(f"unitig {unitig_num} does not contain exactly two "
                            "non-self links")
        self_links_fwd = [link.strand for link in target.forward_next
                          if link.number == unitig_num]
        self_links_rev = [link.strand for link in target.reverse_next
                          if link.number == unitig_num]

        a_num = self.max_unitig_number() + 1
        b_num = a_num + 1
        copies = []
        for new_num in (a_num, b_num):
            copy = Unitig(new_num, target.forward_seq.copy(), target.reverse_seq.copy(),
                          depth=target.depth / 2.0, unitig_type=target.unitig_type)
            copy.forward_positions = target.forward_positions.copy()
            copy.reverse_positions = target.reverse_positions.copy()
            copies.append(copy)
        self.unitigs.extend(copies)
        self.remove_unitigs_by_number({unitig_num})

        for strand in self_links_fwd:
            self.create_link(a_num, a_num if strand else -a_num)
            self.create_link(b_num, b_num if strand else -b_num)
        for strand in self_links_rev:
            self.create_link(-a_num, a_num if strand else -a_num)
            self.create_link(-b_num, b_num if strand else -b_num)

        def substitute(pair, new_num):
            start, end = pair
            start = new_num if start == unitig_num else (-new_num if start == -unitig_num else start)
            end = new_num if end == unitig_num else (-new_num if end == -unitig_num else end)
            return start, end

        self.create_link(*substitute(non_self[0], a_num))
        self.create_link(*substitute(non_self[1], b_num))
        self.check_links()

    def remove_low_depth_unitigs(self, min_depth: float) -> None:
        """Remove unitigs at/below the depth threshold, but only when removal
        creates no dead ends (reference unitig_graph.rs:670-721). Iterates in
        reverse unitig order so longer unitigs are kept."""
        self.invalidate_paths_cache()
        for u in list(reversed(self.unitigs)):
            if u.number not in self.index:
                continue
            if u.depth > min_depth:
                continue
            ok = True
            for next_us in u.forward_next:
                if next_us.number == u.number:
                    continue
                prevs = (next_us.unitig.forward_prev if next_us.strand
                         else next_us.unitig.reverse_prev)
                if not any(lk.number != u.number for lk in prevs):
                    ok = False
                    break
            if ok:
                for prev_us in u.forward_prev:
                    if prev_us.number == u.number:
                        continue
                    nexts = (prev_us.unitig.forward_next if prev_us.strand
                             else prev_us.unitig.reverse_next)
                    if not any(lk.number != u.number for lk in nexts):
                        ok = False
                        break
            if not ok:
                continue
            self.unitigs = [x for x in self.unitigs if x.number != u.number]
            self.delete_dangling_links()
            self.build_index()

    def subset_for_sequences(self, keep_ids) -> "UnitigGraph":
        """Independent copy of the graph restricted to the given sequence
        ids: unitigs keep (copied) positions of only those sequences, links
        are rewired onto the new Unitig objects, sequence byte arrays are
        shared (all mutation paths rebind rather than write in place).
        Replaces the reference's filter-P-lines-and-reload flow
        (cluster.rs:794-822) without the GFA round trip; the caller then
        recalculates depths / drops zero-depth unitigs exactly as after a
        reload."""
        keep = np.asarray(sorted(set(keep_ids)), np.int32)
        lut = PositionArray.seq_id_lut(keep)
        g = UnitigGraph(self.k_size)
        mapping: Dict[int, Unitig] = {}
        for u in self.unitigs:
            nu = Unitig(u.number, u.forward_seq, u._reverse_seq,
                        depth=u.depth, unitig_type=u.unitig_type)
            nu.forward_positions = u.forward_positions.only_seq_ids(keep, lut)
            nu.reverse_positions = u.reverse_positions.only_seq_ids(keep, lut)
            mapping[u.number] = nu
            g.unitigs.append(nu)
        for u in self.unitigs:
            nu = mapping[u.number]
            nu.forward_next = [UnitigStrand(mapping[l.number], l.strand)
                               for l in u.forward_next]
            nu.forward_prev = [UnitigStrand(mapping[l.number], l.strand)
                               for l in u.forward_prev]
            nu.reverse_next = [UnitigStrand(mapping[l.number], l.strand)
                               for l in u.reverse_next]
            nu.reverse_prev = [UnitigStrand(mapping[l.number], l.strand)
                               for l in u.reverse_prev]
        g.build_index()
        return g

    # ---------------- components ----------------

    def connected_components(self) -> List[List[int]]:
        """Connected components as sorted lists of unitig numbers, sorted
        (reference unitig_graph.rs:905-933). NOTE: a scipy.sparse.csgraph
        variant was measured 6x SLOWER here (1.7 s vs 0.29 s on the 43k-
        unitig headline graph) — the per-link Python edge extraction costs
        more than the BFS's set churn — so the plain BFS stays."""
        visited = set()
        components = []
        for unitig in self.unitigs:
            if unitig.number in visited:
                continue
            component = []
            stack = [unitig.number]
            while stack:
                current = stack.pop()
                if current in visited:
                    continue
                visited.add(current)
                component.append(current)
                u = self.index[current]
                for links in (u.forward_next, u.forward_prev, u.reverse_next, u.reverse_prev):
                    for c in links:
                        if c.number not in visited:
                            stack.append(c.number)
            component.sort()
            components.append(component)
        components.sort()
        return components

    def component_is_circular_loop(self, component: List[int]) -> bool:
        """Whether a component forms one simple circular loop
        (reference unitig_graph.rs:949-967)."""
        if not component:
            return False
        first = component[0]
        num, strand = first, FORWARD
        visited = set()
        while num != first or not visited:
            if num in visited:
                return False
            visited.add(num)
            unitig = self.index[num]
            if (len(unitig.forward_next) != 1 or len(unitig.forward_prev) != 1 or
                    len(unitig.reverse_next) != 1 or len(unitig.reverse_prev) != 1):
                return False
            nxt = unitig.forward_next[0] if strand else unitig.reverse_next[0]
            num, strand = nxt.number, nxt.strand
        return len(visited) == len(component)
