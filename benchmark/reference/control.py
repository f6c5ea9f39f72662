"""The control of the comparison: the reference put in the program's place
with one guarantee broken.

The configurations state that each replicon's consensus is a most common
choice of its copies. The control skips the vote, the step that would tempt
a change that wants to be faster: it writes each replicon's first copy (its
circular period, in the first assembly that holds it) as the consensus.
The comparison has to find it not correct.
"""

from __future__ import annotations

from pathlib import Path

from . import check


def control_consensus(asm_dir: Path, fasta: Path) -> None:
    groups = check.replicons_of(check.read_inputs(asm_dir))
    fasta.parent.mkdir(parents=True, exist_ok=True)
    fasta.write_text("".join(
        f">{i + 1} length={len(g.copies[0])} circular=true\n{g.copies[0]}\n"
        for i, g in enumerate(groups)))


def control_numbers(asm_dir: Path, work: Path, k: int) -> dict:
    """The consensus numbers of the comparison, read off the control."""
    fasta = work / "consensus_assembly.fasta"
    control_consensus(asm_dir, fasta)
    groups = check.replicons_tallied(check.read_inputs(asm_dir), k)
    faults, minority = check.consensus_faults(groups, fasta)
    return {"consensus_replicon_faults": faults,
            "consensus_minority_sites": minority}
