"""Command-line interface of the port: the subcommands ported so far, with
the JAX package's flags and defaults (reference main.rs).

``compress``, ``cluster``, ``trim``, ``resolve`` and ``dotplot`` run their
device work on CUDA; without a CUDA device they fail with ``Error: ...``
and exit code 1. ``decompress`` and ``combine`` are host code only. The main
path is compress → cluster → trim → resolve (each QC-pass cluster) →
combine.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .utils import AutocyclerError


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="autocycler",
        description="a tool for generating consensus bacterial genome assemblies "
                    "(PyTorch/CUDA implementation)")
    parser.add_argument("--version", action="version",
                        version=f"Autocycler-TPU-torch v{__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("cluster",
                       help="cluster contigs in the unitig graph based on similarity")
    p.add_argument("-a", "--autocycler_dir", required=True)
    p.add_argument("--cutoff", type=float, default=0.2)
    p.add_argument("--min_assemblies", type=int)
    p.add_argument("--max_contigs", type=int, default=25)
    p.add_argument("--manual")

    p = sub.add_parser("combine", help="combine Autocycler GFAs into one assembly")
    p.add_argument("-a", "--autocycler_dir", required=True)
    p.add_argument("-i", "--in_gfas", required=True, nargs="+")

    p = sub.add_parser("compress", help="compress input contigs into a unitig graph")
    p.add_argument("-i", "--assemblies_dir", required=True)
    p.add_argument("-a", "--autocycler_dir", required=True)
    p.add_argument("--kmer", type=int, default=51)
    p.add_argument("--max_contigs", type=int, default=25)
    p.add_argument("-t", "--threads", type=int, default=8)

    p = sub.add_parser("decompress", help="decompress contigs from a unitig graph")
    p.add_argument("-i", "--in_gfa", required=True)
    p.add_argument("-o", "--out_dir")
    p.add_argument("-f", "--out_file")

    p = sub.add_parser("dotplot",
                       help="generate an all-vs-all dotplot from a unitig graph")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--out_png", required=True)
    p.add_argument("--res", type=int, default=2000)
    p.add_argument("--kmer", type=int, default=32)
    p.add_argument("--grid-mode", dest="grid_mode", default="auto",
                   choices=["auto", "host", "device"],
                   help="k-mer matching: auto and host run the sort-join "
                        "(the sort-network kernel groups the k-mers on the "
                        "card); device counts matches per tile with the "
                        "word-compare match-grid kernel on the card, then "
                        "refines the nonzero tiles exactly")

    p = sub.add_parser("resolve", help="resolve repeats in the unitig graph")
    p.add_argument("-c", "--cluster_dir", required=True)
    p.add_argument("--verbose", action="store_true")

    p = sub.add_parser("trim", help="trim contigs in a cluster")
    p.add_argument("-c", "--cluster_dir", required=True)
    p.add_argument("--min_identity", type=float, default=0.75)
    p.add_argument("--max_unitigs", type=int, default=5000)
    p.add_argument("--mad", type=float, default=5.0)
    p.add_argument("-t", "--threads", type=int, default=8)
    return parser


def dispatch(args) -> None:
    if args.command == "cluster":
        from .commands.cluster import cluster
        cluster(args.autocycler_dir, args.cutoff, args.min_assemblies,
                args.max_contigs, args.manual)
    elif args.command == "combine":
        from .commands.combine import combine
        combine(args.autocycler_dir, args.in_gfas)
    elif args.command == "compress":
        from .commands.compress import compress
        compress(args.assemblies_dir, args.autocycler_dir, args.kmer,
                 args.max_contigs, threads=args.threads)
    elif args.command == "decompress":
        from .commands.decompress import decompress
        decompress(args.in_gfa, args.out_dir, args.out_file)
    elif args.command == "dotplot":
        from .commands.dotplot import dotplot
        dotplot(args.input, args.out_png, args.res, args.kmer, args.grid_mode)
    elif args.command == "resolve":
        from .commands.resolve import resolve
        resolve(args.cluster_dir, args.verbose)
    elif args.command == "trim":
        from .commands.trim import trim
        trim(args.cluster_dir, args.min_identity, args.max_unitigs, args.mad,
             args.threads)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the unitig graph is reference-cyclic: generational collection would
    # repeatedly traverse millions of live graph objects for nothing in this
    # one bounded process
    import gc
    gc.disable()
    try:
        dispatch(args)
    except AutocyclerError as e:
        print(f"\nError: {e}", file=sys.stderr)
        return 1
    finally:
        gc.enable()
    return 0


if __name__ == "__main__":
    sys.exit(main())
