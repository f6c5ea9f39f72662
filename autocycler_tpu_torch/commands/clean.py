"""`autocycler clean`: manual graph surgery on the final assembly graph.

Parity target: reference clean.rs — remove user-specified tigs, duplicate
tigs (requires exactly two non-self links), drop low-depth tigs when no dead
end results, then merge linear paths and renumber. ``--cache`` purges a
warm-start cache, as the JAX package's clean does.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..models import UnitigGraph
from ..models.simplify import merge_linear_paths
from ..obs.timeseries import purge_timeseries
from ..utils import log, quit_with_error
from ..utils.cache import purge_cache


def parse_tig_numbers(tig_num_str: Optional[str]) -> List[int]:
    """'1, 2,3' -> [1, 2, 3], sorted (reference clean.rs:142-152)."""
    if not tig_num_str:
        return []
    out = []
    for token in tig_num_str.replace(" ", "").split(","):
        try:
            out.append(int(token))
        except ValueError:
            quit_with_error(f"failed to parse '{token}' as a tig number")
    return sorted(out)


def clean_cache(cache_dir) -> None:
    """`autocycler clean --cache <dir>`: purge the warm-start cache under
    an autocycler dir (or a cache dir itself), plus any rotated
    continuous-telemetry series (``timeseries.jsonl`` at the root and
    under serve job dirs) and any ``lint_report.json`` artifact (the
    committed ``lint_baseline.json`` is config, not cache, and is kept).
    A shared cache is LRU-capped automatically; this is the manual full
    reset."""
    if not os.path.isdir(cache_dir):
        quit_with_error(f"directory does not exist: {cache_dir}")
    removed, reclaimed = purge_cache(cache_dir)
    log.message(f"Purged warm-start cache under {cache_dir}: "
                f"{removed} entr{'y' if removed == 1 else 'ies'}, "
                f"{reclaimed} bytes reclaimed")
    ts_removed, ts_reclaimed = purge_timeseries(cache_dir)
    if ts_removed:
        log.message(f"Purged telemetry series under {cache_dir}: "
                    f"{ts_removed} file{'' if ts_removed == 1 else 's'}, "
                    f"{ts_reclaimed} bytes reclaimed")
    # lint_report.json is a derived artifact (`autocycler lint --report`
    # regenerates it); lint_baseline.json is configuration and survives
    report_path = os.path.join(cache_dir, "lint_report.json")
    if os.path.isfile(report_path):
        report_bytes = os.path.getsize(report_path)
        os.remove(report_path)
        log.message(f"Purged lint report {report_path}: "
                    f"{report_bytes} bytes reclaimed")
    # streamed k-mer spill bins are per-run scratch; anything still on disk
    # here was left behind by a killed or crashed run (imported here: the
    # stream package brings torch in, which the graph surgery never needs)
    from ..stream import purge_stream_spills
    sp_removed, sp_reclaimed = purge_stream_spills(cache_dir)
    if sp_removed:
        log.message(f"Purged stream spill dirs under {cache_dir}: "
                    f"{sp_removed} run dir{'' if sp_removed == 1 else 's'}, "
                    f"{sp_reclaimed} bytes reclaimed")
    log.message()


def clean(in_gfa, out_gfa, remove: Optional[str] = None, duplicate: Optional[str] = None,
          min_depth: Optional[float] = None, cache: Optional[str] = None) -> None:
    if cache is not None:
        clean_cache(cache)
        if in_gfa is None and out_gfa is None:
            return
    if in_gfa is None or out_gfa is None:
        quit_with_error("clean requires -i and -o (or --cache DIR alone)")
    if not os.path.isfile(in_gfa):
        quit_with_error(f"file does not exist: {in_gfa}")
    log.section_header("Starting autocycler clean")
    log.explanation("This command removes user-specified tigs from a combined Autocycler "
                    "graph and then merges all linear paths to produce a clean output "
                    "graph.")
    remove_nums = parse_tig_numbers(remove)
    duplicate_nums = parse_tig_numbers(duplicate)
    graph, _ = UnitigGraph.from_gfa_file(in_gfa)
    graph.print_basic_graph_info()
    _check_tig_numbers_are_valid(in_gfa, graph, remove_nums)
    _check_tig_numbers_are_valid(in_gfa, graph, duplicate_nums)
    if remove_nums:
        graph.remove_unitigs_by_number(set(remove_nums))
        graph.print_basic_graph_info()
    for tig in duplicate_nums:
        graph.duplicate_unitig_by_number(tig)
    if min_depth is not None:
        graph.remove_low_depth_unitigs(min_depth)
    merge_linear_paths(graph, [])
    graph.renumber_unitigs()
    graph.print_basic_graph_info()
    graph.save_gfa(out_gfa, [], use_other_colour=True)
    log.section_header("Finished!")
    log.message(f"Cleaned graph: {out_gfa}")
    log.message()


def _check_tig_numbers_are_valid(in_gfa, graph: UnitigGraph, tig_numbers: List[int]) -> None:
    existing = {u.number for u in graph.unitigs}
    for tig in tig_numbers:
        if tig not in existing:
            quit_with_error(f"{in_gfa} does not contain tig {tig}")
