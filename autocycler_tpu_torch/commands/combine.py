"""`autocycler combine`: concatenate per-cluster final graphs into one
consensus assembly.

Parity target: reference combine.rs:25-137 — unitig numbers are offset per
cluster, topology (circular=true/linear) is stamped into FASTA headers,
colour tags into the GFA, and consensus_assembly_fully_resolved records
whether every cluster collapsed to a single unitig. Host code only, writing
the same bytes as the JAX package's commands/combine.py.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List

from ..metrics import CombineMetrics, ResolvedClusterDetails
from ..models import UnitigGraph
from ..obs import ledger, qc
from ..utils import log, quit_with_error
from ..utils.timing import substage


def unitig_topology_suffix(unitig) -> str:
    if unitig.is_isolated_and_circular():
        return " circular=true topology=circular"
    if unitig.is_isolated_and_linear():
        return " circular=false topology=linear"
    return ""


def combine(autocycler_dir, in_gfas: List) -> None:
    autocycler_dir = Path(autocycler_dir)
    combined_gfa = autocycler_dir / "consensus_assembly.gfa"
    combined_fasta = autocycler_dir / "consensus_assembly.fasta"
    combined_yaml = autocycler_dir / "consensus_assembly.yaml"
    for gfa in in_gfas:
        if not os.path.isfile(gfa):
            quit_with_error(f"file does not exist: {gfa}")
    os.makedirs(autocycler_dir, exist_ok=True)

    log.section_header("Starting autocycler combine")
    log.explanation("This command combines different clusters into a single assembly file.")
    metrics = CombineMetrics()
    with substage("combine"):
        combine_clusters(in_gfas, combined_gfa, combined_fasta, metrics)
        metrics.save_to_yaml(combined_yaml)
    qc.combine_qc(metrics)
    ledger.record_stage("combine", inputs=in_gfas,
                        outputs=[combined_gfa, combined_fasta, combined_yaml])

    log.section_header("Finished!")
    log.message(f"Combined graph: {combined_gfa}")
    log.message(f"Combined fasta: {combined_fasta}")
    log.message()
    if metrics.consensus_assembly_fully_resolved:
        log.message("Consensus assembly is fully resolved")
    else:
        log.message("One or more clusters failed to fully resolve")
    log.message()


def combine_clusters(in_gfas: List, combined_gfa, combined_fasta,
                     metrics: CombineMetrics) -> None:
    """Concatenate cluster graphs with unitig-number offsets
    (reference combine.rs:90-137)."""
    gfa_lines = ["H\tVN:Z:1.0"]
    fasta_lines = []
    metrics.consensus_assembly_fully_resolved = True
    offset = 0
    for gfa in in_gfas:
        log.message(str(gfa))
        graph, _ = UnitigGraph.from_gfa_file(gfa)
        graph.print_basic_graph_info(with_topology=True)
        for unitig in graph.unitigs:
            num = unitig.number + offset
            seq = unitig.seq_str()
            colour_tag = unitig.colour_tag(True) or "\tCL:Z:orangered"
            gfa_lines.append(f"S\t{num}\t{seq}\tDP:f:{unitig.depth:.2f}{colour_tag}")
            fasta_lines.append(f">{num} length={unitig.length()}"
                               f"{unitig_topology_suffix(unitig)}")
            fasta_lines.append(seq)
        for a, a_strand, b, b_strand in graph.links_for_gfa(offset):
            gfa_lines.append(f"L\t{a}\t{a_strand}\t{b}\t{b_strand}\t0M")
        offset += graph.max_unitig_number()
        metrics.consensus_assembly_bases += graph.total_length()
        metrics.consensus_assembly_unitigs += len(graph.unitigs)
        metrics.consensus_assembly_clusters.append(ResolvedClusterDetails(
            length=graph.total_length(), unitigs=len(graph.unitigs),
            topology=graph.topology()))
        if len(graph.unitigs) > 1:
            metrics.consensus_assembly_fully_resolved = False
    with open(combined_gfa, "w") as f:
        f.write("\n".join(gfa_lines) + "\n")
    with open(combined_fasta, "w") as f:
        f.write("\n".join(fasta_lines) + "\n" if fasta_lines else "")
