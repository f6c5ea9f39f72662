"""Streamed k-mer grouping: the two-pass disk-spill grouping of the JAX
package's stream/ (KMC 2 / Gerbil, arXiv:1407.1507 and arXiv:1607.06618)
on the port's device path.

``ops.kmers.build_kmer_index`` dispatches here behind
``AUTOCYCLER_STREAM_KMERS`` (off/on/auto, as the JAX package does); the
in-memory grouping gives the same arrays, and a spill failure degrades the
run to it visibly (``utils.resilience.record_degrade``). Pass 1 bins
batches of plan chunks on the device (``binner``), and the host appends
each flushed bin once a batch; the bin files are the JAX package's bytes.
"""

from pathlib import Path

from .binner import StreamBinner
from .driver import stream_group_windows_stats
from .merge import merge_ranks
from .planner import StreamPlan, plan_stream, resolve_stream_mode
from .sorter import BinGroups, occ_byte_starts, sort_bin
from .spill import (decode_rle, encode_rle, purge_stream_spills,
                    read_bin_records, set_stream_root, stream_root,
                    sweep_orphan_spills)

__all__ = [
    "BinGroups",
    "StreamBinner",
    "StreamPlan",
    "decode_rle",
    "encode_rle",
    "merge_ranks",
    "occ_byte_starts",
    "plan_stream",
    "prepare_stream_root",
    "purge_stream_spills",
    "read_bin_records",
    "resolve_stream_mode",
    "set_stream_root",
    "sort_bin",
    "stream_group_windows_stats",
    "stream_root",
    "sweep_orphan_spills",
]


def prepare_stream_root(autocycler_dir) -> None:
    """Compress's start: install ``<dir>/.stream`` as the spill root and
    sweep the run dirs a killed run left behind."""
    root = Path(autocycler_dir) / ".stream"
    set_stream_root(root)
    sweep_orphan_spills(root)
