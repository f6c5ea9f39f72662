"""`autocycler gfa2fasta`: GFA -> FASTA with topology annotations.

Parity target: reference gfa2fasta.rs — per-unitig headers carry
``length=`` plus ``circular=true topology=circular`` /
``circular=false topology=linear`` derived from the link structure.
"""

from __future__ import annotations

import os

from ..models import UnitigGraph
from ..utils import log, quit_with_error
from .combine import unitig_topology_suffix


def save_graph_to_fasta(graph: UnitigGraph, out_fasta) -> None:
    circ = linear = other = 0
    with open(out_fasta, "w") as f:
        for unitig in graph.unitigs:
            seq = unitig.seq_str()
            if not seq:
                continue
            topology = unitig_topology_suffix(unitig)
            if "circular=true" in topology:
                circ += 1
            elif "circular=false" in topology:
                linear += 1
            else:
                other += 1
            f.write(f">{unitig.number} length={unitig.length()}{topology}\n{seq}\n")
    log.message(f"{circ} circular sequence{'' if circ == 1 else 's'}")
    log.message(f"{linear} linear sequence{'' if linear == 1 else 's'}")
    log.message(f"{other} other sequence{'' if other == 1 else 's'}")
    log.message()


def gfa2fasta(in_gfa, out_fasta) -> None:
    if not os.path.isfile(in_gfa):
        quit_with_error(f"file does not exist: {in_gfa}")
    log.section_header("Starting autocycler gfa2fasta")
    log.explanation("This command loads an Autocycler graph and saves it as a FASTA file "
                    "with topological information in the sequence headers.")
    graph, _ = UnitigGraph.from_gfa_file(in_gfa)
    graph.print_basic_graph_info()
    save_graph_to_fasta(graph, out_fasta)
