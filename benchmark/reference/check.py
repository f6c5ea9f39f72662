"""The plain reference of one isolate's hand-over, and the comparison that
decides ``correct``.

It reads the isolate's input FASTA files and the files the program wrote,
and works out from the inputs alone what each stage must give:

- compress: ``input_assemblies.gfa`` is lossless, every input contig spelled
  by its path, and every step of a path is one of the graph's links; and it
  is a unitig graph, in which every k-mer of the inputs is one node: no two
  segments spell the same sequence between the same neighbours (the bubble
  of twins that equal k-mers put into separate groups leave behind);
- cluster: one QC-pass cluster per replicon, holding every copy of it and
  nothing else (the replicons are found here by shared 32-mers);
- trim: each contig of ``2_trimmed.gfa`` spells its replicon copy once
  around, as a rotation of the input contig without its start-end overlap
  (found here as the longest suffix that repeats the contig's start);
- resolve and combine: ``consensus_assembly.fasta`` has one circular record
  per replicon, and each record is, up to rotation and strand, a most common
  choice of the copies: at every column where all copies agree it has their
  base, and over every variable region its sequence is one that the most
  copies carry. A region is a run of variable columns at most k apart: no
  k-mer that all copies share fits between two such columns, so the unitig
  graph has no anchor there, and the consensus chooses one path through the
  whole run (the most common one, any of them on a tie).

Every number is a count of faults, compared exactly (limit 0). Plain Python
and NumPy: nothing of the program is imported or called.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

ANCHOR = 32
N_ANCHORS = 8
MIN_OVERLAP = ANCHOR
_COMPLEMENT = str.maketrans("ACGT", "TGCA")
_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i

# the numbers compared, each with its limit: exact
LIMITS = {
    "graph_contigs_not_spelled": 0,
    "graph_link_faults": 0,
    "graph_twin_segments": 0,
    "cluster_contigs_misplaced": 0,
    "trim_contigs_wrong": 0,
    "consensus_replicon_faults": 0,
    "consensus_minority_sites": 0,
}


def revcomp(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def read_fasta(path: Path) -> List[Tuple[str, str]]:
    records, header, parts = [], None, []
    for line in Path(path).read_text().splitlines():
        if line.startswith(">"):
            if header is not None:
                records.append((header, "".join(parts)))
            header, parts = line[1:], []
        else:
            parts.append(line.strip())
    if header is not None:
        records.append((header, "".join(parts)))
    return records


def read_inputs(asm_dir: Path) -> Dict[Tuple[str, str], str]:
    """{(file name, contig name): sequence} of every input FASTA."""
    out = {}
    for f in sorted(Path(asm_dir).glob("*.fasta")):
        for header, seq in read_fasta(f):
            out[(f.name, header.split()[0])] = seq
    return out


class Gfa:
    def __init__(self, path: Path):
        self.segments: Dict[str, str] = {}
        self.links = set()
        self.paths: List[Tuple[Tuple[str, str], List[Tuple[str, str]]]] = []
        for line in Path(path).read_text().splitlines():
            parts = line.split("\t")
            if parts[0] == "S":
                self.segments[parts[1]] = parts[2]
            elif parts[0] == "L":
                self.links.add((parts[1], parts[2], parts[3], parts[4]))
            elif parts[0] == "P":
                tags = dict(t.split(":", 2)[::2] for t in parts[4:] if t.count(":") >= 2)
                steps = [(s[:-1], s[-1]) for s in parts[2].split(",") if s]
                self.paths.append(((tags.get("FN", ""), tags.get("HD", "")), steps))

    def spell(self, steps) -> str:
        return "".join(self.segments[u] if o == "+" else revcomp(self.segments[u])
                       for u, o in steps)


def _flip(o: str) -> str:
    return "-" if o == "+" else "+"


def graph_faults(gfa: Gfa, inputs) -> Tuple[int, int]:
    """(input contigs not spelled by their path, path steps that are no
    link of the graph in either direction)."""
    spelled = {}
    missing_links = 0
    for key, steps in gfa.paths:
        spelled[key] = gfa.spell(steps)
        for (a, oa), (b, ob) in zip(steps, steps[1:]):
            if (a, oa, b, ob) not in gfa.links and \
                    (b, _flip(ob), a, _flip(oa)) not in gfa.links:
                missing_links += 1
    not_spelled = sum(1 for key, seq in inputs.items() if spelled.get(key) != seq)
    return not_spelled, missing_links


def twin_segments(gfa: Gfa) -> int:
    """Segments beyond the first of each set that spell one sequence, read
    on some strand, between the same predecessors and successors on that
    strand. Two such walks spell the same bases, so the k-mers they hold
    would be two nodes each: in a unitig graph there are none. (A count of
    k-mers held by two segments misses them: the graph shifts the shared
    bases of a bubble's branches out of them, so a twin left by one split
    k-mer holds a base or so, no k-mer.)"""
    nxt: Dict[Tuple[str, str], set] = {}
    for a, oa, b, ob in gfa.links:
        nxt.setdefault((a, oa), set()).add((b, ob))
        nxt.setdefault((b, _flip(ob)), set()).add((a, _flip(oa)))

    def side(u: str, o: str):
        """(sequence, predecessors, successors) of ``u`` read on strand ``o``."""
        seq = gfa.segments[u] if o == "+" else revcomp(gfa.segments[u])
        before = tuple(sorted((v, _flip(ov)) for v, ov in nxt.get((u, _flip(o)), ())))
        return seq, before, tuple(sorted(nxt.get((u, o), ())))

    seen = Counter(min(side(u, "+"), side(u, "-")) for u in gfa.segments)
    return sum(n - 1 for n in seen.values())


def circular_period(seq: str) -> str:
    """The contig without its start-end overlap: the longest suffix of at
    least MIN_OVERLAP bases, and at most half the contig, that repeats its
    start."""
    anchor = seq[:ANCHOR]
    n = len(seq)
    p = seq.find(anchor, max(n // 2, 1))
    while p != -1 and n - p >= MIN_OVERLAP:
        if seq.startswith(seq[p:]):
            return seq[:p]
        p = seq.find(anchor, p + 1)
    return seq


def _anchors(seq: str):
    step = max(len(seq) // N_ANCHORS, 1)
    return [(j * step, seq[j * step:j * step + ANCHOR])
            for j in range(N_ANCHORS) if j * step + ANCHOR <= len(seq)]


def _place(seq: str, frame: str) -> Optional[Tuple[int, bool]]:
    """(rotation, reversed) that puts ``seq`` (as long as ``frame``) into
    ``frame``'s coordinates, found by one of its anchors; None if none is
    found on either strand."""
    if len(seq) != len(frame) or not frame:
        return None
    doubled = frame + frame[:ANCHOR - 1]
    for rev in (False, True):
        s = revcomp(seq) if rev else seq
        for pos, anchor in _anchors(s):
            hit = doubled.find(anchor)
            if hit != -1:
                return (pos - hit) % len(frame), rev
    return None


def _in_frame(seq: str, placed: Tuple[int, bool]) -> str:
    offset, rev = placed
    s = revcomp(seq) if rev else seq
    return s[offset:] + s[:offset]


class Replicon:
    """The copies of one replicon, in the first copy's coordinates."""

    def __init__(self, key, period: str):
        self.frame = period
        self.members = [key]
        self.copies = [period]

    def admit(self, key, period: str) -> bool:
        placed = _place(period, self.frame)
        if placed is None:
            return False
        self.members.append(key)
        self.copies.append(_in_frame(period, placed))
        return True

    def tally(self, k: int):
        """Most common base of each column; the variable regions with the
        count of each choice over them. The frame is first turned so that it
        starts in the longest stretch where all copies agree, so that no
        region wraps around its end."""
        stack = np.stack([_CODE[np.frombuffer(c.encode(), np.uint8)]
                          for c in self.copies])
        variable = np.flatnonzero((stack != stack[0]).any(axis=0))
        n = len(self.frame)
        if len(variable):
            gaps = np.diff(np.append(variable, variable[0] + n))
            widest = int(gaps.argmax())
            origin = (int(variable[widest]) + int(gaps[widest]) // 2) % n
            self.frame = self.frame[origin:] + self.frame[:origin]
            self.copies = [c[origin:] + c[:origin] for c in self.copies]
            stack = np.roll(stack, -origin, axis=1)
            variable = np.sort((variable - origin) % n)
        counts = np.stack([(stack == b).sum(axis=0) for b in range(4)])
        self.majority = np.frombuffer(b"ACGT", np.uint8)[counts.argmax(axis=0)] \
            .tobytes().decode()
        self.regions = []
        if len(variable):
            breaks = np.flatnonzero(np.diff(variable) > k) + 1
            for run in np.split(variable, breaks):
                lo, hi = int(run[0]), int(run[-1]) + 1
                self.regions.append((lo, hi, Counter(c[lo:hi] for c in self.copies)))
        self.variable = np.zeros(n, bool)
        self.variable[variable] = True

    def minority_sites(self, seq: str) -> Optional[int]:
        """Invariant columns where ``seq`` differs from every copy, plus
        variable regions where it carries a choice fewer copies carry than
        the most common one; None if it cannot be placed."""
        placed = _place(seq, self.majority)
        if placed is None:
            return None
        s = _in_frame(seq, placed)
        a = np.frombuffer(s.encode(), np.uint8)
        m = np.frombuffer(self.majority.encode(), np.uint8)
        faults = int(((a != m) & ~self.variable).sum())
        for lo, hi, choices in self.regions:
            if choices.get(s[lo:hi], 0) < max(choices.values()):
                faults += 1
        return faults


def replicons_of(inputs) -> List[Replicon]:
    """Group the contigs by shared sequence, each by its circular period."""
    groups: List[Replicon] = []
    for key in inputs:
        period = circular_period(inputs[key])
        if not any(g.admit(key, period) for g in groups):
            groups.append(Replicon(key, period))
    return groups


def _clusters(out_dir: Path) -> Dict[Tuple[str, str], str]:
    """{(file, contig): QC-pass cluster} from clustering.tsv."""
    table = out_dir / "clustering" / "clustering.tsv"
    rows = table.read_text().splitlines()
    head = rows[0].split("\t")
    col = {name: i for i, name in enumerate(head)}
    out = {}
    for row in rows[1:]:
        f = row.split("\t")
        out[(f[col["file_name"]], f[col["contig_name"]])] = f[col["passing_clusters"]]
    return out


def cluster_faults(groups: List[Replicon], assigned, qc_pass_dirs) -> int:
    """Contigs outside their replicon's cluster: each replicon's most common
    QC-pass cluster takes its members; the rest, contigs in no QC-pass
    cluster, and the members of a replicon whose cluster another, larger
    replicon took, are misplaced. QC-pass clusters beyond the replicons'
    count as one fault each."""
    passing = {d.name for d in qc_pass_dirs}
    faults, taken = 0, set()
    for g in sorted(groups, key=lambda g: -len(g.members)):
        labels = Counter(_pass_label(assigned.get(key), passing) for key in g.members)
        labels.pop(None, None)
        best = max(labels, key=labels.get) if labels else None
        if best is None or best in taken:
            faults += len(g.members)
            continue
        taken.add(best)
        faults += len(g.members) - labels[best]
    return faults + max(len(passing) - len(groups), 0)


def _pass_label(value: Optional[str], passing) -> Optional[str]:
    if value is None or not value.strip().isdigit():
        return None
    name = f"cluster_{int(value):03d}"
    return name if name in passing else None


def is_rotation(got: str, want: str) -> bool:
    """Whether ``got`` is ``want`` read from some other start, same strand."""
    if len(got) != len(want):
        return False
    doubled = want + want
    anchor = got[:ANCHOR]
    p = doubled.find(anchor)
    while p != -1 and p < len(want):
        if doubled[p:p + len(got)] == got:
            return True
        p = doubled.find(anchor, p + 1)
    return False


def trim_faults(groups: List[Replicon], inputs, qc_pass_dirs) -> int:
    """Contigs of the replicons whose trimmed path is not their circular
    period once around (any rotation), or that have no trimmed path."""
    seen = {}
    for d in qc_pass_dirs:
        gfa = Gfa(d / "2_trimmed.gfa")
        for key, steps in gfa.paths:
            seen[key] = gfa.spell(steps)
    faults = 0
    for g in groups:
        for key in g.members:
            got = seen.get(key)
            if got is None or not is_rotation(got, circular_period(inputs[key])):
                faults += 1
    return faults


def consensus_faults(groups: List[Replicon], fasta: Path) -> Tuple[int, int]:
    """(replicon faults, minority sites): a record that is not circular,
    matches no replicon or a replicon already matched, and a replicon that
    no record matches, are replicon faults."""
    records = read_fasta(fasta) if fasta.is_file() else []
    faults, minority, matched = 0, 0, set()
    for header, seq in records:
        found = None
        for i, g in enumerate(groups):
            sites = g.minority_sites(seq)
            if sites is not None:
                found = (i, sites)
                break
        if found is None or found[0] in matched or "circular=true" not in header:
            faults += 1
            continue
        matched.add(found[0])
        minority += found[1]
    return faults + len(groups) - len(matched), minority


def replicons_tallied(inputs, k: int) -> List[Replicon]:
    groups = replicons_of(inputs)
    for g in groups:
        g.tally(k)
    return groups


def check_isolate(asm_dir: Path, out_dir: Path, k: int) -> Dict[str, int]:
    """Every number of :data:`LIMITS` for one isolate compressed at ``k``."""
    inputs = read_inputs(asm_dir)
    out_dir = Path(out_dir)
    gfa_path = out_dir / "input_assemblies.gfa"
    if gfa_path.is_file():
        gfa = Gfa(gfa_path)
        not_spelled, link_faults = graph_faults(gfa, inputs)
        twins = twin_segments(gfa)
        del gfa
    else:
        not_spelled, link_faults, twins = len(inputs), 1, 1
    groups = replicons_tallied(inputs, k)
    qc_pass = out_dir / "clustering" / "qc_pass"
    dirs = sorted(d for d in qc_pass.iterdir() if d.is_dir()) if qc_pass.is_dir() else []
    try:
        assigned = _clusters(out_dir)
    except (OSError, KeyError, IndexError):
        assigned = {}
    replicon_faults, minority = consensus_faults(
        groups, out_dir / "consensus_assembly.fasta")
    return {
        "graph_contigs_not_spelled": not_spelled,
        "graph_link_faults": link_faults,
        "graph_twin_segments": twins,
        "cluster_contigs_misplaced": cluster_faults(groups, assigned, dirs),
        "trim_contigs_wrong": trim_faults(groups, inputs, dirs),
        "consensus_replicon_faults": replicon_faults,
        "consensus_minority_sites": minority,
    }
