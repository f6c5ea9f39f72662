"""Command-line interface of the port: the subcommands ported so far, with
the JAX package's flags and defaults (reference main.rs).

``compress``, ``cluster``, ``trim``, ``resolve``, ``dotplot`` and ``batch``
run their device work on CUDA; without a CUDA device they fail with
``Error: ...`` and exit code 1. ``batch`` exits 0 when every isolate is
done, 2 when some failed (recorded in its manifest), 1 when all failed.
``decompress``, ``combine``, ``clean``, ``gfa2fasta``, ``helper``,
``subsample`` and ``table`` are host code only. The main path
is compress → cluster → trim → resolve (each QC-pass cluster) → combine;
a user's pipeline puts ``helper`` and ``subsample`` before it and ``table``
after it.

With ``AUTOCYCLER_TRACE_DIR`` set, a command writes its run record there:
``trace.jsonl`` (and ``trace.chrome.json``), ``metrics.json``/``.prom``,
``qc_report.json`` and ``ledger.json``. ``AUTOCYCLER_METRICS`` names a file
for a Prometheus dump at exit.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .utils import AutocyclerError
from .utils.env import env_str


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="autocycler",
        description="a tool for generating consensus bacterial genome assemblies "
                    "(PyTorch/CUDA implementation)")
    parser.add_argument("--version", action="version",
                        version=f"Autocycler-TPU-torch v{__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("batch",
                       help="compress + cluster distances for MANY isolates in one "
                            "mesh-batched device step, then trim, resolve and combine")
    p.add_argument("-i", "--assemblies_parent", required=True,
                   help="directory of isolate subdirectories, each a normal "
                        "--assemblies_dir")
    p.add_argument("-a", "--out_parent", required=True)
    p.add_argument("-k", "--kmer", type=int, default=51)
    p.add_argument("--max_contigs", type=int, default=25)
    p.add_argument("--resume", action="store_true",
                   help="replay a previous run from its batch_manifest.json, "
                        "retrying only failed/pending isolates")
    p.add_argument("--fleet", choices=["off", "on", "auto"], default=None,
                   help="route the run through the fleet runner (bucketed "
                        "shards, the isolate axis split over the devices, "
                        "prefetched loads); default: the AUTOCYCLER_FLEET_MODE "
                        "knob")
    p.add_argument("-t", "--threads", type=int, default=8)

    p = sub.add_parser("clean",
                       help="manual manipulation of the final consensus assembly graph "
                            "(and warm-start cache purging with --cache)")
    p.add_argument("-i", "--in_gfa")
    p.add_argument("-o", "--out_gfa")
    p.add_argument("-r", "--remove")
    p.add_argument("-d", "--duplicate")
    p.add_argument("-m", "--min_depth", type=float)
    p.add_argument("--cache", metavar="DIR",
                   help="purge the warm-start cache under DIR (an "
                        "autocycler dir or a .cache dir); may be used "
                        "alone, without -i/-o")

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

    p = sub.add_parser("gfa2fasta",
                       help="convert an Autocycler GFA file to FASTA format")
    p.add_argument("-i", "--in_gfa", required=True)
    p.add_argument("-o", "--out_fasta", required=True)

    p = sub.add_parser("helper", help="helper commands for long-read assemblers")
    p.add_argument("task")
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-o", "--out_prefix")
    p.add_argument("-g", "--genome_size")
    p.add_argument("-t", "--threads", type=int, default=8)
    p.add_argument("-d", "--dir")
    p.add_argument("--read_type", default="ont_r10",
                   choices=["ont_r9", "ont_r10", "pacbio_clr", "pacbio_hifi"])
    p.add_argument("--min_depth_abs", type=float)
    p.add_argument("--min_depth_rel", type=float)
    p.add_argument("--timeout", type=float,
                   help="per-subprocess wall-clock limit in seconds (a hung "
                        "assembler is killed and counts as a failed attempt)")
    p.add_argument("--retries", type=int,
                   help="failed/hung subprocess retries with exponential "
                        "backoff (default 0)")
    p.add_argument("--args", dest="extra_args", nargs="+", default=[])

    p = sub.add_parser("resolve", help="resolve repeats in the unitig graph")
    p.add_argument("-c", "--cluster_dir", required=True)
    p.add_argument("--verbose", action="store_true")

    p = sub.add_parser("subsample", help="subsample a long-read set")
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("-g", "--genome_size", required=True)
    p.add_argument("-c", "--count", type=int, default=4)
    p.add_argument("-d", "--min_read_depth", type=float, default=25.0)
    p.add_argument("-s", "--seed", type=int, default=0)

    p = sub.add_parser("table", help="create TSV line from YAML files")
    p.add_argument("-a", "--autocycler_dir")
    p.add_argument("-n", "--name", default="")
    from .commands.table import DEFAULT_FIELDS
    p.add_argument("-f", "--fields", default=DEFAULT_FIELDS)
    p.add_argument("-s", "--sigfigs", type=int, default=3)

    p = sub.add_parser("trim", help="trim contigs in a cluster")
    p.add_argument("-c", "--cluster_dir", required=True)
    p.add_argument("--min_identity", type=float, default=0.75)
    p.add_argument("--max_unitigs", type=int, default=5000)
    p.add_argument("--mad", type=float, default=5.0)
    p.add_argument("-t", "--threads", type=int, default=8)
    return parser


def dispatch(args) -> int:
    """Runs the subcommand; returns its exit code (batch returns 2 on a
    partial failure: some isolates quarantined, the rest complete)."""
    if args.command == "batch":
        from .commands.batch import batch
        return batch(args.assemblies_parent, args.out_parent, args.kmer,
                     args.max_contigs, resume=args.resume,
                     threads=args.threads, fleet=args.fleet)
    if args.command == "clean":
        from .commands.clean import clean
        clean(args.in_gfa, args.out_gfa, args.remove, args.duplicate,
              args.min_depth, cache=args.cache)
    elif args.command == "cluster":
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
    elif args.command == "gfa2fasta":
        from .commands.gfa2fasta import gfa2fasta
        gfa2fasta(args.in_gfa, args.out_fasta)
    elif args.command == "helper":
        from .commands.helper import helper
        helper(args.task, args.reads, args.out_prefix, args.genome_size,
               args.threads, args.dir, args.read_type, args.min_depth_abs,
               args.min_depth_rel, args.extra_args, timeout=args.timeout,
               retries=args.retries)
    elif args.command == "resolve":
        from .commands.resolve import resolve
        resolve(args.cluster_dir, args.verbose)
    elif args.command == "subsample":
        from .commands.subsample import subsample
        subsample(args.reads, args.out_dir, args.genome_size, args.count,
                  args.min_read_depth, args.seed)
    elif args.command == "table":
        from .commands.table import table
        table(args.autocycler_dir, args.name, args.fields, args.sigfigs)
    elif args.command == "trim":
        from .commands.trim import trim
        trim(args.cluster_dir, args.min_identity, args.max_unitigs, args.mad,
             args.threads)
    return 0


# The commands that build the reference-cyclic unitig graph, as the JAX
# package lists them: generational collection would repeatedly traverse
# millions of live graph objects for nothing in one bounded process.
# `helper` (hours of assembler subprocesses), `subsample` and `table` keep
# the collector.
GC_DISABLED_COMMANDS = frozenset({
    "compress", "cluster", "trim", "resolve", "combine", "clean",
    "decompress", "dotplot", "gfa2fasta", "batch",
})


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import gc
    gc_disabled = args.command in GC_DISABLED_COMMANDS
    if gc_disabled:
        gc.disable()
    from .obs import ledger, qc, trace
    # every ported command may own a run: none of them only reads another
    # run's record
    owns_run = trace.maybe_start_run(name=args.command)
    if owns_run:
        qc.reset()
        ledger.reset()
    try:
        with trace.span(args.command, cat="command",
                        **({"argv": list(argv)} if argv else {})):
            rc = dispatch(args)
    except AutocyclerError as e:
        print(f"\nError: {e}", file=sys.stderr)
        return 1
    finally:
        if owns_run:
            run_dir = trace.finish_run()
            if run_dir:
                qc.write_qc_report(run_dir)
                ledger.write_ledger(run_dir, command=args.command)
        metrics_path = env_str("AUTOCYCLER_METRICS")
        if metrics_path:
            trace.write_metrics_file(metrics_path)
        if gc_disabled:
            gc.enable()
    return rc


if __name__ == "__main__":
    sys.exit(main())
