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
after it. ``serve`` runs that path as a daemon on the card (without one it
fails with ``Error: ...`` and exit 1 before it binds a socket), ``submit``
is its client and needs no card, ``report`` and ``watch`` render a run
dir, and ``top`` a serve root (``--fleet``: a fleet dir of them).
``doctor`` renders the device probe's forensics without a CUDA call
(``--probe``: one live probe in a child process).

Every other command starts the device probe at launch (compress, batch
and serve once they have set its negative cache's dir), and the first
request for CUDA waits for its outcome: a probe that timed out or failed
ends the command with ``Error: ...`` and exit 1 before any CUDA call
(``device.py``). ``AUTOCYCLER_PROBE_WATCH`` starts the probe sentinel.

With ``AUTOCYCLER_TRACE_DIR`` set, a command writes its run record there:
``trace.jsonl`` (and ``trace.chrome.json``), ``metrics.json``/``.prom``,
``qc_report.json``, ``ledger.json`` and ``timeseries.jsonl``.
``AUTOCYCLER_METRICS`` names a file for a Prometheus dump at exit.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .utils import AutocyclerError
from .utils.knobs import knob_str


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

    p = sub.add_parser("doctor",
                       help="device forensics: probe history, negative-cache "
                            "state, environment snapshot and recommended "
                            "actions (reads state only — no device bring-up)")
    p.add_argument("-d", "--dir", default=".",
                   help="run directory holding probe_log.jsonl / "
                        "device_probe.json (default: cwd)")
    p.add_argument("--json", action="store_true",
                   help="emit the structured report as JSON")
    p.add_argument("--probe", action="store_true",
                   help="run one live subprocess probe (killable, captures "
                        "init stderr) before reporting")
    p.add_argument("--watch", action="store_true",
                   help="run the probe sentinel in the foreground, printing "
                        "one JSON outcome per cycle")
    p.add_argument("--interval", type=float,
                   help="--watch probe interval in seconds (default: "
                        "AUTOCYCLER_PROBE_WATCH or 30)")
    p.add_argument("--cycles", type=int,
                   help="--watch: stop after this many probe cycles")

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

    p = sub.add_parser("lint",
                       help="statically check the port's own invariants "
                            "(knob registry, lock discipline, purity, "
                            "reader contracts, metric naming, fault sites)")
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: the port's "
                        "package and chip_smoke.py)")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON")
    p.add_argument("--rule", action="append", default=None, metavar="ID",
                   help="only run this rule id or family prefix "
                        "(repeatable, e.g. --rule knobs)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline file of accepted findings "
                        "(default: lint_baseline_torch.json at the repo root)")
    p.add_argument("--write-baseline", default=None, metavar="PATH",
                   help="accept the current findings: write them as the "
                        "new baseline and exit 0")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="also write a lint_report.json artifact readable "
                        "by `autocycler report`")
    p.add_argument("--knobs-md", action="store_true",
                   help="print the generated AUTOCYCLER_* knob table "
                        "(markdown) and exit")

    p = sub.add_parser("report",
                       help="render a run's telemetry (trace spans, metrics, "
                            "batch manifest, bench artifacts) as one report")
    p.add_argument("run_dir",
                   help="directory holding trace.jsonl / metrics.json "
                        "(an AUTOCYCLER_TRACE_DIR run dir or an output dir)")
    p.add_argument("--json", action="store_true",
                   help="emit the merged report as JSON instead of text")
    p.add_argument("--html", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="additionally write a self-contained run_report.html "
                        "(into the run dir, or to PATH when given)")
    p.add_argument("--correlate", default=None, metavar="TRACE_ID",
                   help="cross-run mode: merge every trace under run_dir "
                        "carrying this correlation id (client submissions, "
                        "replica jobs, fleet shards) into one Chrome trace "
                        "with one process lane per run")

    p = sub.add_parser("resolve", help="resolve repeats in the unitig graph")
    p.add_argument("-c", "--cluster_dir", required=True)
    p.add_argument("--verbose", action="store_true")

    p = sub.add_parser("serve",
                       help="assembly-as-a-service daemon: accept isolate "
                            "jobs over a local HTTP endpoint, run on the "
                            "card with warm kernels and parse/repair "
                            "caches, a bounded work queue and live /metrics "
                            "+ /healthz")
    p.add_argument("-a", "--dir", dest="serve_dir", required=True,
                   help="daemon root: job run dirs, the shared warm-start "
                        "cache and serve_manifest.json live here")
    p.add_argument("--host", default="127.0.0.1",
                   help="TCP bind address (default 127.0.0.1)")
    p.add_argument("--port", type=int, default=8642,
                   help="TCP port (default 8642; 0 picks a free port)")
    p.add_argument("--socket", dest="socket_path",
                   help="serve on a Unix domain socket at this path "
                        "instead of TCP")
    p.add_argument("--queue-size", dest="queue_size", type=int, default=16,
                   help="bounded work queue capacity; submissions past it "
                        "get HTTP 503 (default 16)")
    p.add_argument("--workers", type=int, default=None,
                   help="worker threads executing jobs concurrently "
                        "(default AUTOCYCLER_SERVE_WORKERS or "
                        "min(4, cpu//2); more than one serializes device "
                        "work through the device token)")

    p = sub.add_parser("submit",
                       help="submit one isolate job to a running "
                            "`autocycler serve` daemon")
    p.add_argument("-i", "--assemblies_dir", required=True)
    p.add_argument("-a", "--out_dir",
                   help="assembly output directory (default: the job's "
                        "run dir under the daemon root)")
    p.add_argument("--server",
                   help="daemon endpoint URL (default: discovery via "
                        "--dir, AUTOCYCLER_SERVE, or localhost:8642)")
    p.add_argument("--socket", dest="socket_path",
                   help="daemon Unix socket path")
    p.add_argument("-d", "--dir", dest="serve_dir",
                   help="daemon root — reads its serve.json discovery file")
    p.add_argument("--fleet-dir", dest="fleet_dir",
                   help="fleet dir of replica serve roots: route the job "
                        "to the least-loaded healthy replica (probes each "
                        "replica's /healthz; overrides --server/--dir)")
    p.add_argument("--trace-id", dest="trace_id",
                   help="correlation id to propagate (default: minted per "
                        "submission; see `autocycler report --correlate`)")
    p.add_argument("--command", dest="job_command", default="compress",
                   choices=["compress", "pipeline"],
                   help="compress only, or the full per-isolate pipeline "
                        "(cluster + trim + resolve + combine)")
    p.add_argument("-k", "--kmer", type=int, default=51)
    p.add_argument("--max_contigs", type=int, default=25)
    p.add_argument("-t", "--threads", type=int, default=8)
    p.add_argument("--wait", action="store_true",
                   help="block until the job finishes; exit 1 on failure")
    p.add_argument("--follow", action="store_true",
                   help="follow the job's span stream live (implies "
                        "--wait; renders `autocycler watch` frames)")
    p.add_argument("--timeout", type=float,
                   help="--wait/--follow: give up after this many seconds")

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

    p = sub.add_parser("top",
                       help="live dashboard: queue depth and throughput "
                            "sparklines, latency quantiles with the SLO "
                            "verdict, cache hit-rate, the device/host split, "
                            "the stream's spill and memory, from a serve "
                            "root's (or run dir's) timeseries.jsonl and "
                            "manifests")
    p.add_argument("dir", nargs="?", default=".",
                   help="serve root or run directory (default: cwd)")
    p.add_argument("--follow", action="store_true",
                   help="keep re-rendering every --interval seconds "
                        "(default: render once and exit)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (the default; "
                        "overrides --follow)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--follow refresh interval in seconds (default 2)")
    p.add_argument("--cycles", type=int,
                   help="--follow: stop after this many frames")
    p.add_argument("--fleet", action="store_true",
                   help="federated view: treat DIR as a fleet dir of "
                        "replica serve roots, poll every replica's /healthz "
                        "+ /metrics and render the merged snapshot with the "
                        "scale verdict (writes fleet_status.json)")

    p = sub.add_parser("trim", help="trim contigs in a cluster")
    p.add_argument("-c", "--cluster_dir", required=True)
    p.add_argument("--min_identity", type=float, default=0.75)
    p.add_argument("--max_unitigs", type=int, default=5000)
    p.add_argument("--mad", type=float, default=5.0)
    p.add_argument("-t", "--threads", type=int, default=8)

    p = sub.add_parser("watch",
                       help="follow another process's run live: tail a run "
                            "directory's trace.jsonl and render the stage/"
                            "isolate tree with QC highlights")
    p.add_argument("run_dir",
                   help="the run's AUTOCYCLER_TRACE_DIR directory "
                        "(holds trace.jsonl)")
    p.add_argument("--follow", action="store_true",
                   help="keep polling and re-rendering until the run "
                        "finishes (default: render once and exit)")
    p.add_argument("--once", action="store_true",
                   help="render the current state once and exit "
                        "(the default; overrides --follow)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--follow poll interval in seconds (default 2)")
    p.add_argument("--cycles", type=int,
                   help="--follow: stop after this many polls even if the "
                        "run has not finished")
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
    elif args.command == "doctor":
        from .commands.doctor import doctor
        return doctor(args.dir, as_json=args.json, watch=args.watch,
                      probe=args.probe, interval=args.interval,
                      cycles=args.cycles)
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
    elif args.command == "lint":
        from .commands.lint import lint
        return lint(paths=args.paths or None, baseline=args.baseline,
                    rules=args.rule, as_json=args.json,
                    write_baseline_path=args.write_baseline,
                    report_path=args.report, knobs_md=args.knobs_md)
    elif args.command == "report":
        from .obs.report import report
        return report(args.run_dir, as_json=args.json, html=args.html,
                      correlate=args.correlate)
    elif args.command == "resolve":
        from .commands.resolve import resolve
        resolve(args.cluster_dir, args.verbose)
    elif args.command == "serve":
        from .serve.server import serve
        return serve(args.serve_dir, host=args.host, port=args.port,
                     workers=args.workers,
                     socket_path=args.socket_path,
                     queue_size=args.queue_size)
    elif args.command == "submit":
        from .serve.client import submit
        return submit(args.assemblies_dir, server=args.server,
                      socket_path=args.socket_path, serve_dir=args.serve_dir,
                      fleet_dir=args.fleet_dir,
                      command=args.job_command, out_dir=args.out_dir,
                      kmer=args.kmer, max_contigs=args.max_contigs,
                      threads=args.threads, wait=args.wait,
                      follow=args.follow, timeout=args.timeout,
                      trace_id=args.trace_id)
    elif args.command == "subsample":
        from .commands.subsample import subsample
        subsample(args.reads, args.out_dir, args.genome_size, args.count,
                  args.min_read_depth, args.seed)
    elif args.command == "table":
        from .commands.table import table
        table(args.autocycler_dir, args.name, args.fields, args.sigfigs)
    elif args.command == "top":
        from .obs.top import top
        return top(args.dir, follow=args.follow and not args.once,
                   interval=args.interval, cycles=args.cycles,
                   fleet=args.fleet)
    elif args.command == "trim":
        from .commands.trim import trim
        trim(args.cluster_dir, args.min_identity, args.max_unitigs, args.mad,
             args.threads)
    elif args.command == "watch":
        from .obs.watch import watch
        return watch(args.run_dir, follow=args.follow and not args.once,
                     interval=args.interval, cycles=args.cycles)
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


# The commands that never own a trace run, the JAX package's list
NO_RUN_COMMANDS = frozenset({"report", "doctor", "watch", "top", "serve",
                             "submit", "lint"})
# The commands that start no probe sentinel and no device probe (they read
# state, or are clients), and those that start the probe themselves, once
# they have pointed its negative cache at their dir: the JAX package's
NO_PROBE_COMMANDS = frozenset({"report", "doctor", "watch", "top",
                               "submit", "lint"})
OWN_PROBE_COMMANDS = frozenset({"compress", "batch", "serve"})


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import gc
    gc_disabled = args.command in GC_DISABLED_COMMANDS
    if gc_disabled:
        gc.disable()
    from .obs import ledger, qc, timeseries, trace
    # `report`, `watch` and `top` read another run's record (tracing them
    # would clobber what they render), `serve` owns one trace run per job and
    # `submit` is a thin client: none of them owns a run
    may_own_run = args.command not in NO_RUN_COMMANDS
    # the time series rides the run dir beside the trace; the sampler
    # starts before the run clock and stops after it, so its thread's start
    # and join stay outside the run's wall
    sampler = None
    trace_target = (knob_str("AUTOCYCLER_TRACE_DIR") or "").strip()
    if may_own_run and trace_target and timeseries.timeseries_enabled():
        sampler = timeseries.TimeseriesSampler(trace_target).start()
    owns_run = may_own_run and trace.maybe_start_run(name=args.command)
    if not owns_run and sampler is not None:
        sampler.stop(final_sample=False)   # another run is already active
        sampler = None
    if owns_run:
        qc.reset()
        ledger.reset()
    if args.command not in NO_PROBE_COMMANDS:
        # the probe runs beside the command's host work from here; the
        # first request for CUDA waits for its outcome (device.py)
        from . import device
        from .obs import sentinel
        sentinel.maybe_start_watcher()
        if args.command not in OWN_PROBE_COMMANDS:
            device.start_background_probe()
    try:
        with trace.span(args.command, cat="command",
                        **({"argv": list(argv)} if argv else {})):
            rc = dispatch(args)
    except AutocyclerError as e:
        print(f"\nError: {e}", file=sys.stderr)
        return 1
    finally:
        if may_own_run:
            # the run's launches and dispatches reach the registry before
            # its run dir and its metrics dump are written
            from . import device
            device.fold_records()
        if owns_run:
            run_dir = trace.finish_run()
            if run_dir:
                qc.write_qc_report(run_dir)
                ledger.write_ledger(run_dir, command=args.command)
        if sampler is not None:
            sampler.stop()   # outside the run wall; takes the final tick
        metrics_path = knob_str("AUTOCYCLER_METRICS")
        if metrics_path:
            trace.write_metrics_file(metrics_path)
        if gc_disabled:
            gc.enable()
    return int(rc) if rc else 0


if __name__ == "__main__":
    sys.exit(main())
