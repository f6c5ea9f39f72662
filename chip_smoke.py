"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-costs    # only the daemon's cost A/B
    python3 chip_smoke.py --doctor         # only [build] and [doctor]
    python3 chip_smoke.py --pipeline-costs DIR   # the fresh-process CLI
                                           # pipeline, DIR's checkout
                                           # against this one

Phases (any failure exits non-zero, and the result lines are not printed):

1. build   — compile every kernel under autocycler_tpu_torch/csrc with nvcc,
             one nvcc per source, all at once.
2. kernels — hold each kernel against its plain PyTorch version on the card
             (exact equality: the outputs are integers), the +-1 product
             also at the edges of its wgmma design (bands, stages, depth
             padding, work units, the generic path at k = 65); then [dp]:
             the two alignment DPs (torch ops) on the card against the
             same functions on CPU tensors, exact; then [hash]: the
             minimizer hashing (torch ops) and the sketches on the card
             against CPU tensors, exact; then [stream]: the streamed
             grouping at a forced plan (8 bins, chunks of 4096 windows,
             flushes of 512 records), RLE on and off, against the
             in-memory grouping on the card, exact.
3. main    — the headline configuration (24 assemblies of a 6 Mbp chromosome
             + 120 kb plasmid, seed 7) through the port's CLI: compress at
             k=51 with the default knobs, so streamed (one grouping launch
             a bin and one for the merge; no degrade may be recorded), then
             decompress, which must restore the input FASTAs byte
             for byte; then cluster (2 QC-pass clusters), the plasmid
             cluster's dotplot in auto and in device grid mode (identical
             PNGs), the chromosome cluster's dotplot (24 x 6 Mbp, 576
             pairs; cut to its first 4 contigs, 16 pairs, from a FASTA)
             in auto mode, and trim, resolve and combine: a
             consensus of 2 circular records equal to the generator's
             replicons up to rotation and strand. Then the overlap
             configuration, the first 12 of the headline's assemblies
             with each contig's first
             2-20 kb (chromosome) or 0.5-5 kb (plasmid) appended to its
             end, through compress, cluster, trim (whose overlap DP must
             run on the card and cut every contig back to its replicon's
             length), resolve and combine (the same consensus); its
             chromosome trim runs once more under the profiler (the
             profiled compress and device-grid dotplot were cut in depth
             to pay for [doctor]). Each
             path's kernels must have been launched in it. Two small
             inputs (start-end overlaps; a hairpin at both ends) also go
             through compress, cluster, dotplot, trim, resolve and combine
             on the card and on the CPU (the kernels' plain versions),
             which must write the same bytes. The headline compress is
             cold and traced, and writes the JAX package's tree, its .cache
             holding 24 parse entries and the repair entry; its report's
             "Device vs host" line must read the run's dispatches, and its
             metrics dump's device seconds the summed CUDA-event ms of its
             launches, DP dispatches and device_work blocks (within 1 %).
   doctor  — the device forensics: `doctor --probe --json` in a process
             of its own (kind ok, the card's name, capability (9, 0)); the
             probe child swapped for a stub that sleeps past a 3 s deadline
             (timeout, the child and a helper it started killed, its stderr
             tail kept); a compress in a fresh process against that stub
             (exit 1 with `Error:` naming the probe and doctor, no CUDA
             call, device_probe.json written), another (exit 1 in under a
             second from it), `doctor --json` (the negative cache fresh);
             then in this process the gate refusing the stub and a healthy
             probe's false -> true transition (the negative cache deleted,
             one recovery counted, the recovery capture on the card: the
             word compare at 65,536^2 and the grouping of 2 Mbp, exact
             against its plain version); one fresh-process trim and resolve
             of [main]'s plasmid cluster, traced (the probe's resolve, wait
             and overlap seconds from the ledger); ops.mfu.kernel_rates of
             [main]'s compress and cluster (each declared dispatch between 0
             and 100 % of its peak); and the small compress under
             AUTOCYCLER_PROFILE_DIR and under AUTOCYCLER_XPROF (Chrome
             traces with CUDA kernel events, the grouping's own kernels in
             its 2 captures of 3 launches, every span's link a file).
             (`--doctor` runs [build], a small compress and cluster and
             this phase alone.)
   batch   — `batch` through the CLI on [main]'s headline isolate (its
             assemblies symlinked), 7 of bench.py bench_batch's isolates
             (12 assemblies of a 50 kb chromosome + 5 kb plasmid, seeds
             500-506; cut from 96) and one whose FASTA record has no
             sequence: serial (exit 2; 8 done, the corrupt one failed at
             compress; 2 circular consensus records each; the headline's
             GFA, clustering, stage GFAs and consensus equal to [main]'s
             CLI files), --fleet on (the plan printed: shards of one, the
             headline first; every file of the 8 done isolates equal to
             the serial run's), then --resume of the fleet run (only the
             corrupt isolate tried again, so exit 1 as the JAX package's;
             no other file changed). Each run's grouping launches, DP and
             contraction dispatches, batch/* stage seconds, wall and
             isolates/s are printed. Then the sharded code with 4 shards
             on cuda:0 (a 2 x 2 mesh): the membership contraction over the
             serial run's matrices against the 1 x 1 mesh and the host
             int64 product, and the sketch step at 96 x 12 x 1024 (k=21,
             4096 buckets) against the single-device step on the card and
             on CPU tensors, exact.
   chaos   — one crash and resume at full size: `batch` of [batch]'s
             headline isolate alone in a child process with mid-spill-write
             armed (it dies with exit 43 and the marker inside the stream's
             pass 1), then --resume in a second child (exit 0, the dead
             spill dir swept, no tmp file or .stream/run-* left, the three
             final files equal to [batch]'s serial run's). Each child
             consults the device probe, as every fresh process does.
   serve   — the daemon on the card in this process, over loopback HTTP:
             ServeHandle(root, workers=2) with its process warmed as
             `serve` warms it (a shared .cache under its root, both kernel
             libraries loaded) and a sampler tick every 0.5 s. At once: two
             cold headline-size jobs (-t 8, streamed), one a worker: the
             headline ([main]'s assemblies dir) as a pipeline job and the
             headline's configuration drawn from seed 8 as a compress job;
             then a batch body of [batch]'s 7 small isolates as compress
             child jobs and the corrupt isolate, queued behind them; then
             the headline as a compress job, warm from the shared .cache;
             then a fleet body of the 7 isolates as pipeline jobs. Every
             file of the headline job equals [main]'s CLI file (2 circular
             consensus records), the second job's GFA decompresses to its
             inputs, each child's GFA [batch]'s serial run's, the fleet
             job's files [batch]'s fleet run's; the two cold jobs' device
             peak fits the card; the warm job hits 24 + 1 entries, launches
             no end-repair grouping and peaks below the cold jobs; the
             corrupt job fails while /healthz stays ok (workers 2, the
             card's probe); every run dir holds its own trace (its trace id
             in the header), QC and ledger; timeseries.jsonl ticks carry
             device_bytes_in_use; /metrics shows done and failed jobs and
             the token's wait; the grouping launches add up job by job;
             `top --fleet` over a fleet dir holding the live daemon's root
             finds 1 healthy replica, writes fleet_status.json and gives a
             verdict; POST /shutdown gives 200; `top` on the root shows
             device seconds in view and a Spill line with at least the
             headline's bins. Per job: queue wait, wall, stage and
             substage seconds, grouping launches; then the token's wait,
             the device peaks, memory_reserved, and the walls beside
             [main]'s CLI walls. (`--serve-costs` runs only the daemon's
             warm headline compress with the device token and the
             collector each on and off, beside the CLI's.)
   warm    — the headline compress once more through the CLI into a fresh
             directory, AUTOCYCLER_CACHE_DIR at [main]'s .cache and
             AUTOCYCLER_TRACE_DIR set: [main]'s GFA and YAML, 24 parse hits,
             1 repair hit, no miss, no end-repair grouping, no degrade; the
             ledger's sha256s equal the inputs' and outputs', its QC the
             GFA's unitig count, length and N50, its stage spans the stage
             timers (5 %), and the top-level span carries the device bytes;
             the warm compress's device peak must be below the cold one's.
             Then, after [sketch], its auto cluster once more on the
             plasmid-rich directory: every contig's sketch from the cache
             the cold run filled (264 hits, no miss), the cold run's files.
   tools   — the small input's host commands through the CLI: subsample
             (StdRng shuffle), table, gfa2fasta, clean --remove and
             --cache, helper flye with a stub on PATH and helper raven
             without one (exit 1); then the small pipeline traced, one run
             dir a command, each with its five files.
   handoff — the headline again in one process on the card, stages
             handing their graphs over in memory (cluster(collect_handoff=
             True), trim and resolve with preloaded=...), the collector off:
             every file must equal the CLI run's; each stage's wall, stage
             and substage seconds and the counters are printed. (The file
             flow in one process was cut in depth to pay for [doctor].)
   stream  — the headline compress once more through the CLI with
             AUTOCYCLER_STREAM_KMERS=off (the in-memory grouping): its GFA
             and YAML must equal [main]'s; both runs' walls,
             compress/build_graph and peak device memory. (Each compress
             once more in a fresh process, for its peak host RSS, was cut
             in depth to pay for [chaos].)
   sketch  — the plasmid-rich configuration (24 assemblies of a 5.3 Mbp
             chromosome and ten plasmids of 2.5-250 kb, 264 contigs, seed
             13): compress (streamed; the in-memory compress was cut in
             depth to pay for [chaos]), then cluster with the default knob
             (sketch
             distances, hashed on the card) and with verify (the cache
             off, so that it sketches cold; it computes the exact
             distances too), 11 QC-pass clusters and one partition in
             both (the cluster with exact distances alone was cut in depth
             to pay for [doctor]);
             then the sketch intersection grid on the card against its
             host version, and 8 contigs' sketches on the card against the
             CPU's, exact; then the auto cluster once more, warm (see
             [warm]).
4. grid    — the match-grid throughput entry (benchmark_gcells) at 524,288^2
             and k=32 for the word kernel and both product kernels; at equal
             tiles the three grids must equal one another and the plain
             version.
5. timing  — each kernel at the shapes its path gave it: the kernel, its
             plain version and a PyTorch library yardstick where one call
             computes the function, beside the least time the card allows.
             The +-1 product also gives its launch alone (kernel_ms, the
             wrapper's CUDA events) and its registers, spills and shared
             memory. The k-mer grouping is timed at the streamed compress's
             shapes (end repair, every bin, the merge, the gram grouping),
             at the in-memory k=51 shape of [stream] and at the first
             plasmid- and chromosome-dotplot pair's, with its first
             partition's statistics, its time per pass and, at k=51, its
             peak device memory.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
# the H100 SXM's peaks (autocycler_tpu_torch/ops/mfu.py, from the data
# sheet): device memory, tensor cores (dense) and the CUDA cores' issue rate
from autocycler_tpu_torch.ops.mfu import (  # noqa: E402
    H100_BF16_FLOPS as BF16_FLOPS, H100_HBM_BYTES as HBM_BYTES_PER_S,
    H100_INT8_OPS as INT8_OPS, H100_INT_OPS as INT_OPS, grouping_bytes)
GRID_N = 524_288                   # the match-grid entry's own sizes
GRID_K = 32
HEADLINE = dict(n_assemblies=24, chromosome_len=6_000_000,
                plasmid_len=120_000, n_snps=600, seed=7)
# the overlap configuration: bases of each contig's start appended to its
# end, a length drawn uniformly from these ranges (chromosome, plasmid).
# The ranges come from no published measurement of assembler overlaps: they
# are chosen so that every contig carries an overlap and trim's DP runs. Its
# time depends on the window K (capped at --max_unitigs), not on these
# lengths, once a job passes the host screen.
OVERLAPS = ((2_000, 20_000), (500, 5_000))
OVERLAP_SEED = 11
# Depth cuts, so that the streamed compresses (twice the in-memory wall on
# the card) fit the time the script has run in: the overlap configuration
# takes the first 12 of the headline's 24 assemblies (12 trim jobs a
# cluster; the overlap DP's rows stay at the K = 5000 cap), and the
# chromosome-cluster dotplot the first 4 of its 24 contigs (16 pairs; 8 of
# them until [doctor] needed the time).
OVERLAP_ASSEMBLIES = 12
CHROMOSOME_DOTPLOT_CONTIGS = 4
# the plasmid-rich configuration: a chromosome and ten plasmids, 24 times,
# 264 contigs, so that cluster's default (auto) sketches. No source gives
# these lengths: they span the plasmid sizes that multi-plasmid
# Enterobacterales isolates carry, and nothing is cut.
PLASMID_RICH = dict(n_assemblies=24, chromosome_len=5_300_000,
                    plasmid_lens=(2_500, 4_000, 6_000, 9_000, 15_000, 40_000,
                                  70_000, 110_000, 180_000, 250_000),
                    snps_per_mbp=100, seed=13)
KERNEL_SOURCES = {
    "sortnet_pack_rank": {
        "route": "cuda",
        "source": "autocycler_tpu_torch/csrc/sortnet.cu",
        "replaces": "autocycler_tpu/ops/sortnet.py:161",
    },
    "dotplot_match_grid": {
        "route": "cuda",
        "source": "autocycler_tpu_torch/csrc/match_grid.cu",
        "replaces": "autocycler_tpu/ops/dotplot_pallas.py:58",
    },
    "dotplot_match_grid_mxu": {
        "route": "cuda",
        "source": "autocycler_tpu_torch/csrc/match_grid.cu",
        "replaces": "autocycler_tpu/ops/dotplot_pallas.py:219",
    },
}


def log(*args) -> None:
    print(*args, flush=True)


def phase_build() -> None:
    from autocycler_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {len(_build.SOURCES)} source(s) built in "
        f"{time.perf_counter() - t0:.3f} s")
    for name in _build.SOURCES:
        for line in _build.log_path(name).read_text().splitlines():
            if ("registers" in line or "error" in line.lower()
                    or ("spill" in line and " 0 bytes spill stores" not in line)):
                log(f"[build] {name}: {line.strip()}")


def phase_kernels() -> None:
    kernels_sortnet()
    kernels_match_grid()
    kernels_pm1_edges()
    check_dps()
    check_hashing()
    check_stream()
    check_radix()


def check_radix() -> None:
    """[radix] in [kernels]: the radix-sharded grouping with statistics of
    a small input over [cuda:0] * 2 (the kernel once a row) against the
    same over CPU tensors (the plain version), exact, at k 51 and 5."""
    from autocycler_tpu_torch.ops import kmers

    rng = np.random.default_rng(29)
    errs = {}
    for k, n in ((51, 300_000), (5, 200_000)):
        codes = rng.integers(0, 5, size=n + k).astype(np.uint8)
        starts = rng.integers(0, n, size=n).astype(np.int64)
        runs = {}
        for dev in ("cuda:0", "cpu"):
            runs[dev] = kmers.radix_rank(
                torch.from_numpy(codes).to(dev),
                torch.from_numpy(starts).to(dev), k, devices=[dev] * 2,
                stats=True)
        errs[k] = max(_max_err(a.cpu(), b)
                      for a, b in zip(runs["cuda:0"], runs["cpu"]))
    if any(errs.values()):
        raise AssertionError(f"[kernels] radix-sharded grouping disagrees "
                             f"with its plain version: {errs}")
    log(f"[kernels] radix-sharded grouping over [cuda:0] * 2 exact against "
        f"CPU tensors (max_abs_err by k: {errs})")


def _strands(rng, k: int, w: int):
    """Code strands (numpy, 0..4) for the hashing: random at 1 Mbp, dotted
    inside, dot-padded, poly-A, one base short of a window of k + w - 1
    and exactly one window."""
    body = rng.integers(1, 5, size=1 << 20).astype(np.uint8)
    dotted = body.copy()
    dotted[rng.integers(0, len(dotted), size=1 << 12)] = 0
    dot = np.zeros(25, np.uint8)
    window = k + w - 1
    return {"random": body, "dotted": dotted,
            "padded": np.concatenate([dot, body[:100_000], dot]),
            "poly-A": np.full(50_000, 1, np.uint8),
            "short": body[:window - 1], "one window": body[:window]}


def check_hashing() -> None:
    """[hash]: the minimizer hashing (ops/sketch.py, torch ops) on the card
    against the same torch ops on CPU tensors, exact: splitmix64 over
    int64 with the top bit set, the base-5 packs both ways, the k-mer
    hashes, the window minima and sketch_from_codes at s = 1024, for k in
    4, 11, 21, 27 and w in 1, 11."""
    from autocycler_tpu_torch.ops import sketch

    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1,
                                      size=1 << 20, dtype=np.int64))
    if not torch.equal(sketch._splitmix64(x.cuda()).cpu(),
                       sketch._splitmix64(x)):
        raise AssertionError("[hash] splitmix64 differs on the card")
    cases = 1
    for k in (4, 11, 21, 27):
        for w in (1, 11):
            for label, fwd in _strands(rng, k, w).items():
                rc = ((5 - fwd[::-1].astype(np.int64)) % 5).astype(np.uint8)
                on = {dev: (torch.from_numpy(fwd).to(dev),
                            torch.from_numpy(rc).to(dev))
                      for dev in ("cuda", "cpu")}
                got, want = (
                    [sketch._pack_poly(f, k), sketch._pack_poly(r, k, True),
                     sketch._window_minima(sketch._kmer_hashes(f, k), w),
                     *sketch.sketch_from_codes(f, r, k, w, 1024)]
                    for f, r in (on["cuda"], on["cpu"]))
                for name, a, b in zip(("pack", "mirrored pack",
                                       "window minima", "sketch", "m"),
                                      got, want):
                    same = torch.equal(a.cpu(), b) if torch.is_tensor(a) \
                        else a == b
                    if not same:
                        raise AssertionError(f"[hash] k={k} w={w} {label}: "
                                             f"{name} differs on the card")
                cases += 1
    log(f"[hash] the hashing on the card equals the CPU's in {cases} cases "
        "(exact)")


def _strand_layout(seqs, k: int):
    """The concatenated padded strands of ``seqs`` (code arrays) as
    build_kmer_index lays them out: (codes, seq_len, fwd_off, rev_off,
    occ_off, starts)."""
    dots = np.zeros(k // 2, np.uint8)
    bufs, lens, fwd, rev, occ = [], [], [], [], []
    pos = base = 0
    for seq in seqs:
        f = np.concatenate([dots, seq, dots])
        r = ((5 - f[::-1].astype(np.int64)) % 5).astype(np.uint8)
        lens.append(len(seq))
        fwd.append(pos)
        rev.append(pos + len(f))
        occ.append(base)
        bufs += [f, r]
        pos += 2 * len(f)
        base += 2 * len(seq)
    arrays = [np.array(a, np.int64) for a in (lens, fwd, rev, occ)]
    starts = np.concatenate([np.arange(o, o + n) for n, fo, ro in
                             zip(*arrays[:3]) for o in (fo, ro)])
    return (np.concatenate(bufs), *arrays, starts)


def check_stream() -> None:
    """[stream] in [kernels]: stream_group_windows_stats on a small input
    (1.2 M windows with repeats across contigs and a poly-A stretch) at a
    forced plan, 8 bins, chunks of 4096 windows, flushes of 512 records,
    RLE on and off, against the in-memory grouping on the card, exact;
    each bin and the merge one counted grouping launch."""
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.ops import kmers
    from autocycler_tpu_torch.stream import spill, stream_group_windows_stats

    rng = np.random.default_rng(23)
    genome = rng.integers(1, 5, size=250_000).astype(np.uint8)
    variant = np.roll(genome, 4321)
    variant[rng.integers(0, len(variant), size=40)] = \
        rng.integers(1, 5, size=40).astype(np.uint8)
    poly_a = rng.integers(1, 5, size=60_000).astype(np.uint8)
    poly_a[10_000:20_000] = 1
    seqs = [genome, variant, genome[:30_000], poly_a,
            rng.integers(1, 5, size=180_000).astype(np.uint8), genome[:60]]
    k = 51
    codes, seq_len, fwd_off, rev_off, occ_off, starts = _strand_layout(seqs, k)
    want = kmers.group_windows_stats(codes, starts, k, device="cuda")
    knobs = {"AUTOCYCLER_STREAM_BINS": "8", "AUTOCYCLER_STREAM_CHUNK": "4096",
             "AUTOCYCLER_STREAM_FLUSH": "512"}
    saved = {name: os.environ.get(name) for name in
             (*knobs, "AUTOCYCLER_STREAM_RLE")}
    try:
        os.environ.update(knobs)
        for rle in ("1", "0"):
            os.environ["AUTOCYCLER_STREAM_RLE"] = rle
            spill.reset_last_run()
            device.reset_counts()
            got = stream_group_windows_stats(
                torch.from_numpy(codes).cuda(), seq_len, fwd_off, rev_off,
                occ_off, k, threads=1)
            run = dict(spill.last_run)
            for name, a, b in zip(("gid", "order", "depth", "first_occ"),
                                  got, want):
                if not np.array_equal(a, b):
                    raise AssertionError(f"[stream] RLE {rle}: {name} "
                                         "differs from the in-memory grouping")
            if run["n_bins"] != 8 or run["sort_launches"] != run["bins"] \
                    or run["merge_launches"] != 1:
                raise AssertionError(f"[stream] RLE {rle}: plan or launches "
                                     f"{json.dumps(run)}")
            log(f"[stream] RLE {rle}: {len(starts)} windows, equal to the "
                f"in-memory grouping on the card (exact); "
                + json.dumps({key: run[key] for key in (
                    "bins", "chunks", "spill_bytes", "rle_ratio",
                    "sort_launches", "merge_launches")}))
    finally:
        for name, value in saved.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value


def _random_path(rng, n: int, n_units: int, overlap):
    path = (rng.integers(1, n_units + 1, size=n)
            * rng.choice([-1, 1], size=n)).tolist()
    if overlap == "start_end":
        path[-5:] = path[:5]
    elif overlap == "hairpin":
        path[-5:] = [-u for u in reversed(path[-10:-5])]
    return path


def _trim_jobs(path, weights):
    rev = [-u for u in reversed(path)]
    return [(path, path, weights, True), (path, rev, weights, False),
            (rev, path, weights, False)]


def check_dps() -> None:
    """The two alignment DPs are torch ops, not hand-written kernels: this
    holds their CUDA semantics against the same functions on CPU tensors,
    exact. The overlap DP's edges and packed bits and the decoded pieces, on
    random trim jobs (start-end with the diagonal skipped, hairpin start and
    end) with weights up to 2**27 (past the JAX package's int32 domain), at
    K = 1, a small max_unitigs, and K = 5000; the medoid DP's distances on
    pairs of up to 64 unitigs and longer."""
    from autocycler_tpu_torch.ops import align

    rng = np.random.default_rng(17)
    jobs = []
    for trial in range(60):
        n_units = int(rng.integers(2, 40))
        w = np.zeros(n_units + 1, np.int64)
        w[1:] = rng.integers(1, 1 << 27 if trial % 4 == 0 else 500,
                             size=n_units)
        jobs += _trim_jobs(_random_path(rng, int(rng.integers(1, 400)), n_units,
                                        ("start_end", "hairpin", None)[trial % 3]),
                           w)
    body = _random_path(rng, 6000, 100_000, None)
    w_big = np.zeros(100_001, np.int64)
    w_big[1:] = rng.integers(50, 500, size=100_000)
    cases = [("random", jobs, 5000), ("random, max_unitigs 7", jobs, 7),
             ("K=1", _trim_jobs([3], {3: 9}) + _trim_jobs([-2], {2: 4}), 5000),
             ("K=5000", _trim_jobs(body + body[:500], w_big)[:2], 5000)]
    for label, batch, max_unitigs in cases:
        arrs = {dev: align.pack_overlap_jobs(batch, max_unitigs, dev)
                for dev in ("cuda", "cpu")}
        got = align.overlap_screen_traceback(arrs["cuda"])
        want = align.overlap_screen_traceback(arrs["cpu"])
        for name, a, b in zip(("edges", "bits"), got, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"[dp] overlap DP {label}: {name} on the "
                                     "card differ from the CPU's")
        pieces = align.overlap_tracebacks_batch(batch, max_unitigs, 0.5, "cuda")
        if pieces != align.overlap_tracebacks_batch(batch, max_unitigs, 0.5,
                                                    "cpu"):
            raise AssertionError(f"[dp] overlap DP {label}: decoded pieces on "
                                 "the card differ from the CPU's")
        log(f"[dp] trim overlap DP {label}: {len(batch)} jobs, K "
            f"{arrs['cpu']['A'].shape[1]}, edges, bits and pieces equal on the "
            f"card and the CPU ({sum(bool(p) for p in pieces)} alignments)")
    weights = {u: int(rng.integers(1, 1 << 27)) for u in range(1, 12)}
    for max_len in (64, 200):
        pairs = [tuple(tuple(_random_path(rng, int(rng.integers(0, max_len + 1)),
                                          11, None)) for _ in range(2))
                 for _ in range(100)]
        got = align.global_alignment_distance_batch(pairs, weights, "cuda")
        if not np.array_equal(got, align.global_alignment_distance_batch(
                pairs, weights, "cpu")):
            raise AssertionError(f"[dp] medoid DP, pairs up to {max_len}: "
                                 "the card differs from the CPU")
        log(f"[dp] resolve medoid DP: 100 pairs of up to {max_len} unitigs "
            "equal on the card and the CPU")


def _oversized_buckets(rng, plan, k: int):
    """Windows of one first-partition bucket of small + 1 records and one
    of cap + 1 (a sort block's capacity), among random DNA windows: the two
    buckets' prefixes start with a dot, which no random window holds."""
    pieces, starts, pos = [], [], 0
    for size, last in ((plan.small + 1, 0), (plan.cap + 1, 1)):
        head = np.zeros(plan.prefix, np.uint8)
        head[-1] = last
        tails = rng.integers(1, 5, size=(size, k - plan.prefix)).astype(np.uint8)
        pieces.append(np.concatenate([np.broadcast_to(head, (size, plan.prefix)),
                                      tails], 1).ravel())
        starts.append(pos + k * np.arange(size))
        pos += k * size
    tail = rng.integers(1, 5, size=plan.n - pos // k + k - 1).astype(np.uint8)
    starts.append(pos + np.arange(len(tail) - k + 1))
    return np.concatenate(pieces + [tail]), np.concatenate(starts)


def kernels_sortnet() -> None:
    """pack_rank against pack_rank_plain, on the card, exact: random windows
    at every k of the main path (25, 32, 50, 51), the word edges (1, 12, 13,
    14), k > 65, n from 1 to 2**24 and not powers of two; all-equal windows
    (one bucket of 2**22 + 3 records), buckets just over half and just over
    a sort block, dotted ends and a poly-A stretch."""
    from autocycler_tpu_torch.ops import sortnet
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    cases = []
    for k in (51, 50, 25, 11):
        block = sortnet.make_plan(1 << 20, k).cap
        for n in (1, 1000, block, block + 1, 3 * 2**20 + 7, 2**24):
            codes = rng.integers(0, 5, size=max(n // 3, 64) + k).astype(np.uint8)
            starts = rng.integers(0, len(codes) - k + 1, size=n)
            cases.append((f"random k={k} n={n}", codes, starts, k))
    for k in (32, 14, 13, 12, 1, 80):
        for n in (1000, 3 * 2**20 + 7):
            codes = rng.integers(0, 5, size=max(n // 3, 64) + k).astype(np.uint8)
            starts = rng.integers(0, len(codes) - k + 1, size=n)
            cases.append((f"random k={k} n={n}", codes, starts, k))
    genome = rng.integers(1, 5, size=6_000_000).astype(np.uint8)
    for k in (32, 51):                       # every window of a random genome
        cases.append((f"genome k={k}", genome, np.arange(len(genome) - k + 1), k))
    one_base = np.full(4096, 3, np.uint8)            # every window equal
    cases.append(("all-equal k=51", one_base,
                  rng.integers(0, 4096 - 51, size=100_000), 51))
    n_equal = 2**22 + 3
    cases.append((f"all-equal k=51 n={n_equal}", one_base,
                  rng.integers(0, 4096 - 51, size=n_equal), 51))
    for k in (51, 25):
        plan = sortnet.make_plan(1 << 20, k)
        codes, starts = _oversized_buckets(rng, plan, k)
        cases.append((f"buckets of {plan.small + 1} and {plan.cap + 1} k={k}",
                      codes, starts, k))
    dotted = rng.integers(1, 5, size=1 << 20).astype(np.uint8)
    dotted[rng.integers(0, len(dotted), size=1 << 14)] = 0   # '.' padding
    dotted[:25] = 0
    dotted[-25:] = 0
    for k in (51, 25):
        cases.append((f"dots k={k}", dotted,
                      np.arange(len(dotted) - k + 1), k))
    poly_a = rng.integers(1, 5, size=3 << 20).astype(np.uint8)
    poly_a[1 << 20:2 << 20] = 1
    for k in (51, 32):
        cases.append((f"poly-A k={k}", poly_a, np.arange(len(poly_a) - k + 1), k))
    for label, codes, starts, k in cases:
        c = torch.from_numpy(codes).to(dev)
        s = torch.from_numpy(starts.astype(np.int32)).to(dev)
        got = sortnet.pack_rank(c, s, k)
        want = sortnet.pack_rank_plain(c, s, k)
        torch.cuda.synchronize()
        for name, a, b in zip(("order", "gid_sorted"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"[kernels] {label}: {name} differs "
                                     "from the plain version")
        if label.startswith(("all-equal k=51 n", "buckets", "poly-A")):
            log(f"[kernels] {label}: exact; first partition "
                f"{json.dumps(sortnet.partition_stats(c, s, k))}")
    log(f"[kernels] sortnet_pack_rank equals its plain version in "
        f"{len(cases)} cases (exact)")


def _shared_words(rng, n_a: int, n_b: int, k: int):
    """Packed k-mer words of a random A and of a B that repeats a chunk of
    A and of A's reverse complement, so the counts are non-zero."""
    from autocycler_tpu_torch.ops.dotplot_grid import pack_2bit_words
    a = rng.integers(1, 5, size=n_a + k - 1).astype(np.uint8)
    m = n_b + k - 1
    b = rng.integers(1, 5, size=m).astype(np.uint8)
    if n_a and n_b:
        take = min(len(a), m // 2)
        b[:take] = a[:take]
        rc = (5 - a[::-1][:m - take]).astype(np.uint8)
        b[take:take + len(rc)] = rc
    return (torch.from_numpy(pack_2bit_words(a, k)).cuda(),
            torch.from_numpy(pack_2bit_words(b, k)).cuda())


def kernels_match_grid() -> None:
    """Both match-grid kernels (the word compare, and the +-1 product in
    bf16 and int8) against their plain versions on the card, exact, over
    k, n and tile shapes, edge tiles, poly-T and one empty side."""
    from autocycler_tpu_torch.ops import dotplot_grid as g
    rng = np.random.default_rng(12)
    ks = (10, 12, 16, 17, 31, 32, 33, 55, 100)
    tiles = ((128, 128), (256, 256), (1024, 1024), (2048, 2048), (2048, 4096))
    cases = []
    for ti, (ta, tb) in enumerate(tiles):
        for ni, n in enumerate(("empty", 1, "t-1", "t", "t+1", "3t+7",
                                100_003)):
            k = ks[(7 * ti + ni) % len(ks)]
            size = {"empty": 0, "t-1": ta - 1, "t": ta, "t+1": ta + 1,
                    "3t+7": 3 * ta + 7}.get(n, n)
            n_a, n_b = size, (size if n != "empty" else 3 * tb + 7)
            if n == "empty" and ti % 2:
                n_a, n_b = n_b, n_a
            cases.append((f"k={k} n={n_a}x{n_b} tiles {ta}x{tb}", k, ta, tb,
                          *_shared_words(rng, n_a, n_b, k)))
    for k in (1, 5, 128, 200, 256):        # the product kernels take k <= 256
        cases.append((f"k={k} n=391x300 tiles 128x256", k, 128, 256,
                      *_shared_words(rng, 391, 300, k)))
    poly_t = torch.full((1, 3 * 128 + 7), -1, dtype=torch.int32).cuda()
    cases.append(("poly-T k=16 n=391 tiles 128x128", 16, 128, 128,
                  poly_t, poly_t))
    nonzero = 0
    for label, k, ta, tb, a, b in cases:
        want = g.match_grid_plain(a, b, ta, tb)
        got = {"word": g.match_grid(a, b, ta, tb)}
        for dtype in g.IN_DTYPES:
            got[f"mxu {dtype}"] = g.match_grid_mxu(a, b, k, tile_a=ta,
                                                   tile_b=tb, in_dtype=dtype)
            plain = g.match_grid_mxu_plain(a, b, k, tile_a=ta, tile_b=tb,
                                           in_dtype=dtype)
            if not torch.equal(plain, want):
                raise AssertionError(f"[kernels] {label}: the plain product "
                                     f"({dtype}) differs from the plain "
                                     "word compare")
        torch.cuda.synchronize()
        for name, grid in got.items():
            if not torch.equal(grid, want):
                raise AssertionError(
                    f"[kernels] {label}: {name} kernel differs from its plain "
                    f"version ({int((grid - want).abs().max())} at most)")
        nonzero += int(want.sum() > 0)
    if nonzero < len(cases) // 2:
        raise AssertionError(f"[kernels] only {nonzero} match-grid cases had "
                             "any match")
    log(f"[kernels] dotplot_match_grid and dotplot_match_grid_mxu (bf16, "
        f"int8) equal their plain versions in {len(cases)} cases (exact; "
        f"{nonzero} with matches)")


def kernels_pm1_edges() -> None:
    """The +-1 product at the edges of the wgmma kernel's design, both
    dtypes, exact against match_grid_mxu_plain: n across the 256-row band
    and the 128-row stage, tiles of 128 that split a band, at least 3
    bands, the depths where int8 pads most (k = 1, 8, 16, 17), the last
    wgmma depth and the first generic one (k = 64, 65), a B of three
    256-stage work-unit chunks whose boundaries fall inside a 384-column
    output tile, poly-T words and one empty side."""
    from autocycler_tpu_torch.ops import dotplot_grid as g
    rng = np.random.default_rng(13)
    cases = []
    for n_a, n_b in ((255, 257), (256, 256), (257, 255), (100_003, 100_003)):
        cases.append((f"k=32 n={n_a}x{n_b} tiles 1024x1024", 32, 1024, 1024,
                      *_shared_words(rng, n_a, n_b, 32)))
    for ta, tb in ((128, 128), (128, 256)):
        for k in (1, 8, 16, 17, 64, 65):
            cases.append((f"k={k} n=775x1031 tiles {ta}x{tb}", k, ta, tb,
                          *_shared_words(rng, 3 * 256 + 7, 1031, k)))
    chunk_rows = 256 * 128                   # the kernel's CHUNK_STAGES x STAGE
    a, b = _shared_words(rng, 775, 2 * chunk_rows + 7, 16)
    for edge in (chunk_rows, 2 * chunk_rows):  # matches across each boundary
        hi = min(edge + 300, b.shape[1])
        b[:, edge - 300:hi] = a[:, :hi - edge + 300]
    cases.append(("k=16 n=775x65543 tiles 128x384", 16, 128, 384, a, b))
    poly_t = torch.full((1, 3 * 256 + 7), -1, dtype=torch.int32).cuda()
    cases.append(("poly-T k=16 n=775 tiles 128x256", 16, 128, 256,
                  poly_t, poly_t))
    a, b = _shared_words(rng, 777, 0, 20)
    cases.append(("k=20 n=777x0 tiles 128x128", 20, 128, 128, a, b))
    cases.append(("k=20 n=0x777 tiles 128x128", 20, 128, 128, b, a))
    for label, k, ta, tb, a, b in cases:
        for dtype in g.IN_DTYPES:
            want = g.match_grid_mxu_plain(a, b, k, tile_a=ta, tile_b=tb,
                                          in_dtype=dtype)
            got = g.match_grid_mxu_cuda(a, b, k, tile_a=ta, tile_b=tb,
                                        in_dtype=dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"[kernels] {label} {dtype}: the product kernel differs "
                    f"from its plain version "
                    f"({int((got - want).abs().max())} at most)")
    log(f"[kernels] dotplot_match_grid_mxu equals its plain version at the "
        f"wgmma design's edges in {len(cases)} cases x 2 dtypes (exact)")


def _same_files(a: Path, b: Path) -> bool:
    """The same files, byte for byte, in the two directory trees, leaving
    out the warm-start cache (``.cache``), which [main] and [warm] check
    apart: its entries' zip members carry their write time."""
    def names(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file()
                      and ".cache" not in p.relative_to(root).parts)
    return names(a) == names(b) and all(
        (a / n).read_bytes() == (b / n).read_bytes() for n in names(a))


def append_start_overlaps(asm_dir: Path, rng, chromosome_range,
                          plasmid_range) -> Path:
    """Append to each contig its own first L bases, L uniform in its
    replicon's range (each file holds the chromosome, then the plasmid), in
    assembly order: the start-end overlap an assembler leaves on a circular
    contig."""
    for path in sorted(asm_dir.glob("assembly_*.fasta"),
                       key=lambda f: int(f.stem.split("_")[1])):
        lines = path.read_text().splitlines()
        for i, (low, high) in zip((1, 3), (chromosome_range, plasmid_range)):
            lines[i] += lines[i][:int(rng.integers(low, high + 1))]
        path.write_text("\n".join(lines) + "\n")
    return asm_dir


def _hairpin_both_ends(root: Path) -> Path:
    """3 assemblies of one linear contig with a hairpin at each end
    (revcomp(body[:300]) + body + revcomp(body[-400:]), 2 SNPs each): trim
    cuts both ends, the end in a second device round."""
    import random

    from synthetic import mutate, random_genome, revcomp
    rng = random.Random(1)
    body = random_genome(rng, 3000)
    contig = revcomp(body[:300]) + body + revcomp(body[-400:])
    asm = root / "assemblies"
    asm.mkdir(parents=True)
    for i in range(1, 4):
        (asm / f"assembly_{i}.fasta").write_text(
            f">contig_1\n{mutate(rng, contig, 2)}\n")
    return asm


def small_pipeline(work: Path) -> None:
    """compress -> cluster -> dotplot -> trim -> resolve -> combine of small
    inputs on the card and on the CPU (the kernels' plain versions): the
    same bytes everywhere. One input has start-end overlaps to trim; the
    other a hairpin at both ends, whose end the card trims in a second
    round of the overlap DP."""
    from synthetic import make_assemblies

    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.commands.cluster import cluster
    from autocycler_tpu_torch.commands.combine import combine
    from autocycler_tpu_torch.commands.compress import compress
    from autocycler_tpu_torch.commands.dotplot import dotplot
    from autocycler_tpu_torch.commands.resolve import resolve
    from autocycler_tpu_torch.commands.trim import trim
    small = append_start_overlaps(
        make_assemblies(work / "small", n_assemblies=4, chromosome_len=30_000,
                        plasmid_len=4_000, n_snps=10, seed=3),
        np.random.default_rng(OVERLAP_SEED), (500, 5_000), (100, 1_000))
    hairpins = _hairpin_both_ends(work / "hairpins")
    for name, asm in (("small", small), ("hairpins", hairpins)):
        for dev in ("cuda", "cpu"):
            out = work / f"{name}_{dev}"
            device.reset_counts()
            with contextlib.redirect_stderr(io.StringIO()) as err:
                compress(asm, out, 51, device=dev)
                cluster(out, device=dev)
                clusters = sorted((out / "clustering" / "qc_pass").iterdir())
                for c in clusters:
                    gfa = c / "1_untrimmed.gfa"
                    dotplot(gfa, c / "auto.png", device=dev)
                    if c.name == "cluster_002":
                        dotplot(gfa, c / "device.png", grid_mode="device",
                                device=dev)
                    trim(c, device=dev)
                    resolve(c, device=dev)
                combine(out, [c / "5_final.gfa" for c in clusters])
            trims = device.dp_summary("trim_overlap_dp")["dispatches"]
            if dev == "cuda":
                log(f"[main] {name}: trim overlap DP dispatches on the card "
                    f"{trims}, trims logged "
                    f"{err.getvalue().count(': trimmed ')}")
                if name == "hairpins" and trims < 2 * len(clusters):
                    raise AssertionError("[main] the hairpin input ran no "
                                         "second round of the overlap DP")
                if name == "small" and not trims:
                    raise AssertionError("[main] the small input's trim "
                                         "never dispatched its overlap DP")
        if not _same_files(work / f"{name}_cuda", work / f"{name}_cpu"):
            raise AssertionError(f"[main] {name} compress/cluster/dotplot/"
                                 "trim/resolve/combine on the card differs "
                                 "from the CPU's plain versions")
    plots = sorted(p.name for p in (work / "small_cuda").rglob("*.png"))
    log(f"[main] small inputs through compress, cluster, dotplot "
        f"({len(plots)} PNGs), trim, resolve and combine: card and CPU "
        "outputs byte-identical")


def phase_main(work: Path):
    """Headline compress + decompress through the CLI, with the kernels'
    inputs captured for the timing phase."""
    sys.path.insert(0, str(REPO / "tests"))
    from synthetic import make_assemblies_fast

    from autocycler_tpu_torch import cli

    small_pipeline(work)

    t0 = time.perf_counter()
    asm = make_assemblies_fast(work / "headline", **HEADLINE)
    log(f"[main] headline inputs generated in "
        f"{time.perf_counter() - t0:.3f} s: {HEADLINE}")

    out = work / "out"
    compressed = compress_cold(asm, out)
    launches = compressed["launches"]

    stderr = io.StringIO()
    recon = work / "recon"
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(stderr):
        rc = cli.main(["decompress", "-i", str(out / "input_assemblies.gfa"),
                       "-o", str(recon)])
    if rc != 0:
        raise RuntimeError(f"[main] decompress exited {rc}")
    if not _same_files(asm, recon):
        raise AssertionError("[main] decompress did not restore the inputs")
    log(f"[main] decompress round trip byte-identical "
        f"({time.perf_counter() - t0:.3f} s); "
        f"{(out / 'input_assemblies.yaml').read_text().count('- name:')} "
        "contigs in input_assemblies.yaml")
    paths, plasmid_pair, dotplot_groupings = cluster_and_dotplot(work, out)
    replicons = headline_replicons()
    runs = trim_resolve_combine("headline", out, replicons)
    if not sum(r["dp"]["resolve_medoid_dp"]["dispatches"] for r in runs):
        raise AssertionError("[main] headline resolve never dispatched its "
                             "medoid DP")
    for r in runs:
        for record in r["dp"]["resolve_medoid_dp"]["each"]:
            log(f"[main] resolve_medoid_dp {record.get('ms')} ms, its bound "
                f"{json.dumps(medoid_dp_bound(record))}")
    overlap_configuration(work, replicons)
    return ({"compress": launches, **paths}, compressed, plasmid_pair,
            dotplot_groupings)


def compress_cold(asm: Path, out: Path) -> dict:
    """The headline compress through the CLI into a fresh directory, cold
    and traced (its run dir beside ``out``): it must stream, and leave the
    JAX package's tree, its .cache holding the 24 parse entries and the
    repair entry; its report's device line must read the run's CUDA-event
    seconds (check_device_record). Also records what it pays to key and
    fill the cache: seconds summed over the loader threads that hash and
    store at once."""
    from autocycler_tpu_torch.commands import compress as compress_mod
    from autocycler_tpu_torch.utils import cache

    run_dir = out.parent / "tel_compress"
    os.environ["AUTOCYCLER_TRACE_DIR"] = str(run_dir)
    try:
        with _recorded(compress_mod, "content_hash",
                       lambda a, r: None) as hashes, \
                _recorded(cache.EncodeCache, "store_parsed",
                          lambda a, r: None) as parse_stores, \
                _recorded(cache.EncodeCache, "store_repair_ends",
                          lambda a, r: None) as repair_stores:
            compressed = run_cli("compress", ["compress", "-i", asm, "-a",
                                              out, "--kmer", "51"])
    finally:
        os.environ.pop("AUTOCYCLER_TRACE_DIR")
    compressed["device_record"] = check_device_record(
        "main", "compress", compressed, run_dir)
    compressed["cache_store_s"] = {
        name: sum(secs for _, secs in calls) for name, calls in (
            ("content_hash", hashes), ("store_parsed", parse_stores),
            ("store_repair_ends", repair_stores))}
    compressed["stream"] = check_streamed("main", "compress", compressed)
    entries = sorted(p.name for p in (out / ".cache").iterdir())
    if sorted(p.name for p in out.iterdir()) != [
            ".cache", ".stream", "input_assemblies.gfa",
            "input_assemblies.yaml"] or list((out / ".stream").iterdir()) or \
            [e[:4] for e in entries] != ["asm-"] * 24 + ["repa"]:
        raise AssertionError("[main] compress left another tree than the "
                             "JAX package's streamed compress: "
                             f"{sorted(p.name for p in out.iterdir())}, "
                             f".cache {entries}")
    log(f"[main] compress wrote .cache: {len(entries)} entries "
        f"({sum((out / '.cache' / e).stat().st_size for e in entries)} B); "
        "seconds to hash and store them, summed over the loader threads: "
        f"{json.dumps(compressed['cache_store_s'])}")
    return compressed


def check_device_record(phase: str, label: str, run: dict,
                        run_dir: Path) -> dict:
    """The traced CLI call ``run``'s device record: its report prints a
    "Device vs host" line with a non-zero count, its metrics dump holds
    device seconds equal to the call's launches', DP dispatches' and
    device_work blocks' CUDA-event ms (within 1 %), and its dispatch count
    equals their number."""
    from autocycler_tpu_torch.obs import report

    text = report.render_report(report.build_report(run_dir))
    line = next((x for x in text.splitlines()
                 if x.startswith("Device vs host:")), "")
    snap = json.loads((run_dir / "metrics.json").read_text())

    def total(name):
        return sum(v["value"] for v in (snap.get(name) or {}).get("values",
                                                                  []))

    seconds = total("autocycler_device_seconds_total")
    dispatches = total("autocycler_device_dispatches_total")
    kernel_ms = sum(run["kernel_ms"].values())
    dp_ms = sum(d.get("ms", 0.0) for d in run["dp"].values())
    work_ms = sum(w["ms"] for w in run["work"].values())
    count = {"launches": sum(run["launches"].values()),
             "dp_dispatches": sum(d["dispatches"] for d in run["dp"].values()),
             "work_blocks": sum(w["blocks"] for w in run["work"].values())}
    want_ms = kernel_ms + dp_ms + work_ms
    shown = int(line.split(" across ")[1].split()[0]) if " across " in line \
        else 0
    record = {"report_line": line, "device_seconds": seconds,
              "dispatches": dispatches, "kernel_ms": kernel_ms,
              "dp_ms": dp_ms, "work_ms": work_ms, **count,
              "work": run["work"]}
    if not line or shown == 0 or seconds <= 0 \
            or abs(seconds * 1e3 - want_ms) > 0.01 * want_ms \
            or dispatches != sum(count.values()) or shown != dispatches:
        raise AssertionError(f"[{phase}] {label}: the device record does "
                             f"not add up: {json.dumps(record)}")
    log(f"[{phase}] {label}: report {line!r}; device seconds equal the "
        "launches' + DP dispatches' + device_work blocks' CUDA-event ms "
        f"within 1 %: {json.dumps(record)}")
    return record


def headline_replicons():
    """The headline's chromosome and plasmid, drawn again as
    make_assemblies_fast draws them (chromosome first)."""
    from synthetic import random_genome_fast
    rng = np.random.default_rng(HEADLINE["seed"])
    return [random_genome_fast(rng, HEADLINE["chromosome_len"]),
            random_genome_fast(rng, HEADLINE["plasmid_len"])]


def _revcomp(seq: str) -> str:
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _yaml_list(path: Path, key: str):
    """The integers of one block list in a stage YAML."""
    lines = path.read_text().splitlines()
    start = lines.index(f"{key}:") + 1
    values = []
    for line in lines[start:]:
        if not line.startswith("- "):
            break
        values.append(int(line[2:]))
    return values


def trim_resolve_combine(label: str, out: Path, replicons):
    """trim and resolve on each QC-pass cluster, then combine, through the
    CLI. The consensus must hold 2 circular records, each equal to one of
    the generator's replicons up to rotation and strand, and be fully
    resolved. Returns the runs of trim and resolve."""
    clusters = sorted((out / "clustering" / "qc_pass").iterdir())
    runs = []
    for c in clusters:
        runs.append(run_cli(f"{label} trim {c.name}", ["trim", "-c", c]))
        runs.append(run_cli(f"{label} resolve {c.name}",
                            ["resolve", "-c", c]))
    run_cli(f"{label} combine", ["combine", "-a", out, "-i",
                                 *[c / "5_final.gfa" for c in clusters]])
    lines = (out / "consensus_assembly.fasta").read_text().splitlines()
    records = list(zip(lines[0::2], lines[1::2]))
    if len(records) != 2 or not all("circular=true" in h for h, _ in records):
        raise AssertionError(f"[main] {label} consensus: "
                             f"{[h for h, _ in records]}, expected 2 "
                             "circular records")
    for header, seq in records:
        if not any(len(seq) == len(r) and (seq in r + r or _revcomp(seq) in r + r)
                   for r in replicons):
            raise AssertionError(f"[main] {label} consensus record {header} "
                                 "is no rotation of a generated replicon")
    if "consensus_assembly_fully_resolved: true" not in \
            (out / "consensus_assembly.yaml").read_text():
        raise AssertionError(f"[main] {label} consensus is not fully resolved")
    log(f"[main] {label} consensus: {[h for h, _ in records]}, fully "
        "resolved, each record equal to a generated replicon up to rotation "
        "and strand")
    return runs


def overlap_configuration(work: Path, replicons) -> None:
    """The headline with each contig's first bases appended to its end (a
    start-end overlap), through the whole pipeline: trim's overlap DP runs
    on the card and cuts every contig back to its replicon's length."""
    from synthetic import make_assemblies_fast

    t0 = time.perf_counter()
    asm = append_start_overlaps(make_assemblies_fast(
        work / "overlap", **{**HEADLINE, "n_assemblies": OVERLAP_ASSEMBLIES}),
                                np.random.default_rng(OVERLAP_SEED), *OVERLAPS)
    total = sum(len(line) for f in asm.iterdir()
                for line in f.read_text().splitlines()[1::2])
    log(f"[main] overlap configuration generated in "
        f"{time.perf_counter() - t0:.3f} s: {total} bp, overlaps {OVERLAPS}")
    out = work / "overlap_out"
    run_cli("overlap compress", ["compress", "-i", asm, "-a", out,
                                 "--kmer", "51"])
    run_cli("overlap cluster", ["cluster", "-a", out])
    clusters = sorted((out / "clustering" / "qc_pass").iterdir())
    if len(clusters) != 2:
        raise AssertionError(f"[main] overlap cluster: {len(clusters)} QC-pass "
                             "clusters, expected 2")
    runs = trim_resolve_combine("overlap", out, replicons)
    trims = runs[0::2]                  # trim, resolve for each cluster
    for c, run in zip(clusters, trims):
        lengths = _yaml_list(c / "2_trimmed.yaml", "trimmed_cluster_lengths")
        if len(set(lengths)) != 1 or lengths[0] not in (
                HEADLINE["chromosome_len"], HEADLINE["plasmid_len"]):
            raise AssertionError(f"[main] overlap trim {c.name}: lengths "
                                 f"{sorted(set(lengths))}")
        dp = run["dp"]["trim_overlap_dp"]
        log(f"[main] overlap trim {c.name}: {len(lengths)} contigs trimmed to "
            f"{lengths[0]} bp; trim/overlaps {run['stages']['trim/overlaps']}"
            f" s; trim_overlap_dp dispatches {json.dumps(dp['each'])}")
    if not sum(r["dp"]["trim_overlap_dp"]["dispatches"] for r in trims):
        raise AssertionError("[main] overlap trim never dispatched its "
                             "overlap DP")
    # the chromosome trim once more under the profiler: how much of its
    # overlap DP's time the card is busy
    chromosome = max(clusters, key=_cluster_median)
    trimmed = (chromosome / "2_trimmed.gfa").read_bytes()
    profile_cli("overlap trim, chromosome cluster", ["trim", "-c", chromosome])
    if (chromosome / "2_trimmed.gfa").read_bytes() != trimmed:
        raise AssertionError("[profile] the profiled trim differs")


# (phase, label, wall seconds) of every run_cli call, in order
CLI_WALLS = []
# (phase, label) -> ops.mfu.kernel_rates of the call's declared dispatches
KERNEL_RATES = {}


def run_cli(label: str, argv, phase: str = "main", expect_rc: int = 0) -> dict:
    """One CLI call with every launch count, DP record, spill counter,
    degrade record and timer set to 0 just before it and read just after.
    An exit code other than ``expect_rc``, or a degrade recorded in the
    call, fails it. Returns its launches and their CUDA-event ms, DP
    dispatches, device_work blocks, stage and substage seconds, wall
    seconds, the streamed
    grouping's record (empty when it grouped in memory), and its peak
    device memory above what was held before it; for a compress, also
    compress/build_graph's own peak device memory."""
    from autocycler_tpu_torch import cli, device
    from autocycler_tpu_torch.commands import compress
    from autocycler_tpu_torch.ops import mfu
    from autocycler_tpu_torch.stream import spill
    from autocycler_tpu_torch.utils import resilience, timing

    device.reset_counts()
    spill.reset_last_run()
    resilience.reset_degrades()
    timing.reset()
    stderr = io.StringIO()
    torch.cuda.synchronize()
    device_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    peaks = {"device_bytes_before": device_before}
    build_unitig_graph = compress.build_unitig_graph

    def build_graph_peak(*args, **kwargs):
        # the peak so far is kept, then build_graph's own is measured
        torch.cuda.synchronize()
        peaks["load_peak_device_bytes"] = \
            torch.cuda.max_memory_allocated() - device_before
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        graph = build_unitig_graph(*args, **kwargs)
        torch.cuda.synchronize()
        peaks["build_graph_peak_device_bytes"] = \
            torch.cuda.max_memory_allocated() - before
        return graph

    compress.build_unitig_graph = build_graph_peak
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(stderr):
            rc = cli.main([str(a) for a in argv])
            torch.cuda.synchronize()
    finally:
        compress.build_unitig_graph = build_unitig_graph
    wall = time.perf_counter() - t0
    peaks["peak_device_bytes"] = max(
        torch.cuda.max_memory_allocated() - device_before,
        peaks.get("load_peak_device_bytes", 0))
    launches = dict(device.launches)
    kernel_ms = {n: device.kernel_ms(n) for n, c in launches.items() if c}
    dps = {n: device.dp_summary(n) for n in device.dp_dispatches}
    work_blocks = device.work_summary()
    if rc != expect_rc:
        raise RuntimeError(f"[{phase}] {label} exited {rc}:\n"
                           f"{stderr.getvalue()[-3000:]}")
    if resilience.degrade_events():
        raise AssertionError(f"[{phase}] {label} recorded a degrade: "
                             f"{resilience.degrade_events()}")
    dp_text = "".join(
        f", {n} {json.dumps({k: v for k, v in d.items() if k != 'each'})}"
        for n, d in dps.items() if d["dispatches"])
    stages = timing.stage_seconds()
    substages = timing.substage_snapshot()
    rates = mfu.kernel_rates(timing.device_kernel_snapshot())
    KERNEL_RATES[(phase, label)] = rates
    CLI_WALLS.append((phase, label, wall))
    log(f"[{phase}] {label}: wall {wall} s, launches {launches}, kernel time "
        f"(ms, CUDA events) {json.dumps(kernel_ms)}, stages (s) "
        f"{json.dumps(stages)}, substages (s) "
        f"{json.dumps(substages)}{dp_text}, memory {json.dumps(peaks)}")
    return {"launches": launches, "kernel_ms": kernel_ms, "dp": dps,
            "rates": rates,
            "work": work_blocks, "stages": stages, "substages": substages,
            "wall_s": wall, "stream": dict(spill.last_run), **peaks}


STREAM_SUBSTAGES = ("stream-kmers", "stream-bin", "stream-sort",
                    "stream-merge", "stream-stitch")


def check_streamed(phase: str, label: str, run: dict) -> dict:
    """The compress ``run`` streamed its grouping: one counted grouping
    launch a bin and one for the merge. Logs the stream's substages, bins,
    spill bytes and RLE ratio; returns them."""
    stream = run["stream"]
    if not stream:
        raise AssertionError(f"[{phase}] {label} did not stream its grouping")
    if stream["sort_launches"] != stream["bins"] or \
            stream["merge_launches"] != 1:
        raise AssertionError(f"[{phase}] {label}: grouping launches "
                             f"{stream['sort_launches']} for {stream['bins']} "
                             f"bins, {stream['merge_launches']} for the merge")
    record = {**stream, "substages_s": {
        name: run["substages"].get(name) for name in STREAM_SUBSTAGES}}
    log(f"[{phase}] {label} streamed: {json.dumps(record)}")
    return record


def _cluster_median(cluster_dir: Path) -> int:
    for line in (cluster_dir / "1_untrimmed.yaml").read_text().splitlines():
        if line.startswith("untrimmed_cluster_median:"):
            return int(line.split(":")[1])
    raise AssertionError(f"[main] no median in {cluster_dir}")


@contextlib.contextmanager
def groupings_launched(first: bool = False, k=None):
    """Keeps the (codes, starts, k) of the groupings launched inside the
    block, for [timing]: all of them, or only the first; of any k, or of
    the given one."""
    from autocycler_tpu_torch.ops import sortnet

    seen = []
    real = sortnet.pack_rank_cuda

    def capture(codes, starts, window):
        if (k is None or window == k) and not (first and seen):
            seen.append((codes, starts, window))
        return real(codes, starts, window)

    sortnet.pack_rank_cuda = capture
    try:
        yield seen
    finally:
        sortnet.pack_rank_cuda = real


def cluster_and_dotplot(work: Path, out: Path):
    """cluster, then the dotplots: the plasmid cluster in auto and device
    grid mode (identical PNGs), and the chromosome cluster in auto mode."""
    from autocycler_tpu_torch.ops import dotplot_grid

    paths = {"cluster": run_cli("cluster", ["cluster", "-a", out])["launches"]}
    qc_pass = sorted((out / "clustering" / "qc_pass").iterdir())
    if len(qc_pass) != 2:
        raise AssertionError(f"[main] cluster: {len(qc_pass)} QC-pass "
                             "clusters, expected 2")
    log(f"[main] cluster: {len(qc_pass)} QC-pass clusters")
    plasmid = min(qc_pass, key=_cluster_median) / "1_untrimmed.gfa"
    chromosome = max(qc_pass, key=_cluster_median) / "1_untrimmed.gfa"

    pngs = {mode: work / f"plasmid_{mode}.png" for mode in ("auto", "device")}
    with groupings_launched(first=True) as plasmid_grouping:
        paths["dotplot auto"] = run_cli(
            "plasmid cluster dotplot, auto",
            ["dotplot", "-i", plasmid, "-o", pngs["auto"]])["launches"]
    pairs = []
    real = dotplot_grid.match_grid_cuda

    def capture(a, b, tile_a, tile_b):
        if not pairs:
            pairs.append((a, b, tile_a, tile_b))
        return real(a, b, tile_a, tile_b)

    dotplot_grid.match_grid_cuda = capture
    try:
        paths["dotplot device"] = run_cli(
            "plasmid cluster dotplot, --grid-mode device",
            ["dotplot", "-i", plasmid, "-o", pngs["device"],
             "--grid-mode", "device"])["launches"]
    finally:
        dotplot_grid.match_grid_cuda = real
    if paths["dotplot auto"]["sortnet_pack_rank"] == 0 \
            or paths["dotplot device"]["dotplot_match_grid"] == 0:
        raise AssertionError("[main] a dotplot path launched no kernel")
    if pngs["auto"].read_bytes() != pngs["device"].read_bytes():
        raise AssertionError("[main] auto and device-grid PNGs differ")
    log(f"[main] plasmid cluster dotplot: auto and device-grid PNGs "
        f"byte-identical ({pngs['auto'].stat().st_size} bytes)")

    # every pair is a 6 Mbp x 6 Mbp sort-join; the device grid would be
    # 3.6e13 cells a pair, past MAX_DEVICE_CELLS, so auto mode only. Cut in
    # depth to the cluster's first CHROMOSOME_DOTPLOT_CONTIGS contigs (a
    # FASTA decompressed from its GFA), so that the script keeps its time
    from autocycler_tpu_torch.commands.decompress import decompress
    with contextlib.redirect_stderr(io.StringIO()):
        decompress(chromosome, None, work / "chromosome_cluster.fasta")
    lines = (work / "chromosome_cluster.fasta").read_text().splitlines(True)
    fasta = work / "chromosomes.fasta"
    fasta.write_text("".join(lines[:2 * CHROMOSOME_DOTPLOT_CONTIGS]))
    with groupings_launched(first=True) as chromosome_grouping:
        paths["dotplot chromosomes"] = run_cli(
            f"chromosome cluster dotplot, auto, {CHROMOSOME_DOTPLOT_CONTIGS} "
            "contigs", ["dotplot", "-i", fasta, "-o",
                        work / "chromosomes.png"])["launches"]
    if paths["dotplot chromosomes"]["sortnet_pack_rank"] == 0:
        raise AssertionError("[main] the chromosome dotplot launched no "
                             "kernel")
    return paths, pairs[0], {"plasmid-dotplot pair": plasmid_grouping[0],
                             "chromosome-dotplot pair": chromosome_grouping[0]}


def profile_cli(label: str, argv) -> None:
    """Run a CLI call once more under torch.profiler: the device's busy
    time (kernels and copies) against the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from autocycler_tpu_torch import cli

    t0 = time.perf_counter()
    # the device's activity only: recording every host op too slowed the
    # profiled run and took longer to read than the run itself
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[profile] {label} exited {rc}")
    # the raw events: prof.events() builds the host-side tree first, which
    # took longer than the profiled run itself
    t0 = time.perf_counter()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns() / 1e3
    read_s = time.perf_counter() - t0
    busy_s = sum(by_name.values()) / 1e6
    if busy_s == 0:
        log(f"[profile] {label}: device busy time not measured (no device "
            "events)")
        return
    log(f"[profile] {label}: wall {wall} s under the profiler, device busy "
        f"{busy_s} s (kernels + copies), idle share {1 - busy_s / wall}; "
        f"the trace read in {read_s:.3f} s")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        log(f"[profile]   {us / 1e6} s  {name[:100]}")


def _pipeline_step(record: dict, name: str, fn, *args, **kwargs):
    """One in-process stage call: its wall seconds (ending in a
    synchronise), the stage and substage seconds it added, summed into
    ``record[name]``."""
    from autocycler_tpu_torch.utils import timing

    stages = timing.stage_seconds()
    substages = timing.substage_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    torch.cuda.synchronize()
    step = record.setdefault(name, {"wall_s": 0.0, "stages": {},
                                    "substages": {}})
    step["wall_s"] += time.perf_counter() - t0
    for key, secs in timing.stage_seconds().items():
        if secs > stages.get(key, 0.0):
            step["stages"][key] = step["stages"].get(key, 0.0) + \
                secs - stages.get(key, 0.0)
    for key, secs in timing.substage_deltas(substages).items():
        step["substages"][key] = step["substages"].get(key, 0.0) + secs
    return result


def _in_process(label: str, flow) -> dict:
    """Runs ``flow(steps)`` in one process with every count and timer set to
    0 just before it and the collector off, logs each step and the counts,
    and returns the steps with the pipeline's wall seconds under "wall_s".

    The unitig graph is cyclic, so every stage leaves many cycles behind;
    with the collector on, its scans in later stages walk all of them
    (bench.py measured +12 s in trim and resolve on the JAX package). A
    command-per-process run never pays that, so the collector is off here
    while the stages run."""
    import gc

    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.stream import spill
    from autocycler_tpu_torch.utils import resilience, timing

    steps = {}
    device.reset_counts()
    spill.reset_last_run()
    resilience.reset_degrades()
    timing.reset()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            flow(steps)
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
    gc.collect()
    launches = dict(device.launches)
    kernel_ms = {n: device.kernel_ms(n) for n, c in launches.items() if c}
    dps = {n: {k: v for k, v in device.dp_summary(n).items() if k != "each"}
           for n in device.dp_dispatches}
    for name, step in steps.items():
        log(f"[handoff] {label}, {name}: {json.dumps(step)}")
    log(f"[handoff] {label}: pipeline wall {wall} s, launches {launches}, "
        f"kernel time (ms, CUDA events) {json.dumps(kernel_ms)}, DP "
        f"dispatches {json.dumps(dps)}")
    if resilience.degrade_events():
        raise AssertionError(f"[handoff] {label} recorded a degrade: "
                             f"{resilience.degrade_events()}")
    steps["wall_s"] = wall
    steps["launches"] = launches
    steps["stream"] = dict(spill.last_run)
    return steps


def phase_handoff(work: Path) -> None:
    """The headline in one process on the card, as bench.py's headline runs
    the JAX package: compress (k=51) -> cluster(collect_handoff=True) ->
    trim(preloaded=...) -> resolve(preloaded=...) for each QC-pass cluster
    -> combine, on [main]'s inputs into a fresh directory. Every file it
    writes must equal the CLI run's in [main]. (The same stages reading and
    writing the files in one process were cut in depth to pay for
    [doctor].) The compress streams, as in [main]; every grouping it
    launches is kept for [timing] and returned."""
    from autocycler_tpu_torch.commands.cluster import cluster
    from autocycler_tpu_torch.commands.combine import combine
    from autocycler_tpu_torch.commands.compress import compress
    from autocycler_tpu_torch.commands.resolve import resolve
    from autocycler_tpu_torch.commands.trim import trim

    asm, out = work / "headline" / "assemblies", work / "handoff"

    def handed_over(steps):
        # the CLI's default --threads, so that the plan, and so the
        # grouping shapes kept for [timing], are [main]'s
        _pipeline_step(steps, "compress", compress, asm, out, 51, threads=8)
        handoff = _pipeline_step(steps, "cluster", cluster, out,
                                 collect_handoff=True)
        clusters = sorted(handoff)
        for c in clusters:
            trimmed = _pipeline_step(steps, "trim", trim, c,
                                     preloaded=handoff.pop(c))
            _pipeline_step(steps, "resolve", resolve, c, preloaded=trimmed)
            del trimmed
        _pipeline_step(steps, "combine", combine, out,
                       [c / "5_final.gfa" for c in clusters])

    with groupings_launched() as compress_groupings:
        run = _in_process("hand-over", handed_over)
    stream = run["stream"]
    if not stream or run["launches"]["sortnet_pack_rank"] != \
            stream["bins"] + 3:
        raise AssertionError("[handoff] compress did not stream, or launched "
                             "another grouping count than end repair, one a "
                             "bin, the merge and the gram grouping")
    if not _same_files(work / "out", out):
        raise AssertionError("[handoff] the in-process hand-over's files "
                             "differ from the CLI run's in [main]")
    log("[handoff] the hand-over writes every file the CLI run in [main] "
        "does, byte for byte")
    return compress_groupings, stream["bins"]


# [batch]: bench.py bench_batch's isolates (BASELINE.md's "96 genomes x 12
# assemblies" row), cut from 96 to 7 for the script's time, beside the
# headline isolate (a symlink to each of [main]'s assemblies) and an
# isolate whose FASTA record has no sequence
BATCH_SMALL = dict(fast=True, seed0=500, n_assemblies=12,
                   chromosome_len=50_000, plasmid_len=5_000, n_snps=20)
BATCH_SMALL_ISOLATES = 7
# the sharded sketch step's check: tests/test_parallel.py's headline batch
BATCH_SKETCH = dict(isolates=96, assemblies=12, length=1024, k=21,
                    buckets=4096)


def _batch_isolates(work: Path) -> Path:
    from synthetic import make_isolate_dirs

    parent = make_isolate_dirs(work / "batch_isolates", BATCH_SMALL_ISOLATES,
                               **BATCH_SMALL)
    headline = parent / "iso_headline"
    headline.mkdir()
    for f in sorted((work / "headline" / "assemblies").iterdir()):
        (headline / f.name).symlink_to(f)
    corrupt = parent / "iso_corrupt"
    corrupt.mkdir()
    (corrupt / "assembly_1.fasta").write_text(">broken_record\n")
    return parent


def _isolate_files(out: Path, names) -> dict:
    """{relative path: bytes} of the named isolates' out dirs; a
    warm-start cache entry by name only (its zip members carry their
    write time)."""
    files = {}
    for name in names:
        for f in sorted((out / name).rglob("*")):
            if f.is_file():
                rel = str(f.relative_to(out))
                files[rel] = None if ".cache" in f.parts else f.read_bytes()
    return files


def _batch_run(label: str, argv, n_done: int, expect_rc: int = 2) -> dict:
    """One batch CLI call (exit code 2: the corrupt isolate fails, the rest
    are done) with its counters read around it; logs launches, dispatches,
    the batch/* stage seconds, the wall and isolates/s."""
    run = run_cli(label, argv, phase="batch", expect_rc=expect_rc)
    dps = {name: run["dp"][name]["dispatches"] for name in (
        "trim_overlap_dp", "batch_membership_contraction",
        "fleet_membership_contraction")}
    stages = {name: run["stages"].get(name) for name in (
        "batch/compress", "batch/distances", "batch/cluster",
        "batch/trim_screen", "batch/finalise")}
    run["summary"] = {
        "grouping_launches": run["launches"]["sortnet_pack_rank"],
        "dispatches": dps, "stages_s": stages, "wall_s": run["wall_s"],
        "isolates_done": n_done, "isolates_per_s": n_done / run["wall_s"]}
    log(f"[batch] {label}: {json.dumps(run['summary'])}")
    return run


def _check_manifest(out: Path, label: str, good, attempts: int) -> dict:
    items = json.loads((out / "batch_manifest.json").read_text())["items"]
    bad = items.get("iso_corrupt", {})
    if sorted(n for n, e in items.items() if e["status"] == "done") != good \
            or bad.get("status") != "failed" or bad.get("stage") != "compress" \
            or bad.get("attempts") != attempts:
        raise AssertionError(f"[batch] {label} manifest: "
                             f"{json.dumps({n: [e['status'], e['stage'], e['attempts']] for n, e in items.items()})}")
    return items


def _consensus_circular(out: Path, name: str) -> None:
    headers = [line for line in (out / name / "consensus_assembly.fasta")
               .read_text().splitlines() if line.startswith(">")]
    if len(headers) != 2 or not all("circular=true" in h for h in headers):
        raise AssertionError(f"[batch] {name} consensus: {headers}")


def phase_batch(work: Path) -> None:
    """`batch` through the CLI on the card: the headline isolate, 7 of
    bench_batch's isolates and a corrupt one, serial (exit 2; 8 done and
    the corrupt one failed at compress; each consensus 2 circular records;
    the headline's files equal to [main]'s CLI files), then with
    ``--fleet on`` (every file of the 8 done isolates equal to the serial
    run's), then ``--resume`` of the fleet run (only the corrupt isolate
    tried again, no other file changed). Then the sharded code with more
    than one shard on the card: the membership contraction on a 2 x 2 mesh
    of cuda:0 over the serial run's membership matrices against the 1 x 1
    mesh and the host int64 product, and the sharded sketch step against
    the single-device step on the card and on CPU tensors, all exact."""
    from autocycler_tpu_torch.commands import batch as batch_mod
    from autocycler_tpu_torch.parallel import batch as pbatch
    from autocycler_tpu_torch.parallel import fleet, mesh
    from autocycler_tpu_torch.utils.knobs import knob_int

    t0 = time.perf_counter()
    parent = _batch_isolates(work)
    names = sorted(d.name for d in parent.iterdir())
    good = [n for n in names if n != "iso_corrupt"]
    log(f"[batch] isolates generated in {time.perf_counter() - t0:.3f} s: "
        f"{len(good)} good ({BATCH_SMALL_ISOLATES} of bench_batch's "
        f"{json.dumps(BATCH_SMALL)}, and the headline), iso_corrupt")
    serial, fleet_out = work / "batch_serial", work / "batch_fleet"
    base = ["batch", "-i", parent, "-k", "51", "-t", "8"]
    with _recorded(batch_mod, "batched_membership_intersections",
                   lambda a, r: (a[1], a[2])) as contractions:
        runs = {"serial": _batch_run("serial", base + ["-a", serial],
                                     len(good))}
    _check_manifest(serial, "serial", good, 1)
    for name in good:
        _consensus_circular(serial, name)
    headline = _isolate_files(serial, ["iso_headline"])
    mismatched = [rel for rel, data in headline.items()
                  if data is not None and
                  (work / "out" / Path(rel).relative_to("iso_headline"))
                  .read_bytes() != data]
    compared = [rel for rel, data in headline.items() if data is not None]
    wanted = ["input_assemblies.gfa", "clustering/pairwise_distances.phylip",
              "clustering/clustering.newick", "clustering/clustering.tsv",
              "clustering/clustering.yaml", "consensus_assembly.gfa",
              "consensus_assembly.fasta"]
    for c in sorted((work / "out" / "clustering" / "qc_pass").iterdir()):
        wanted += [f"clustering/qc_pass/{c.name}/{n}" for n in (
            "1_untrimmed.gfa", "2_trimmed.gfa", "5_final.gfa")]
    missing = [w for w in wanted if f"iso_headline/{w}" not in compared]
    if mismatched or missing:
        raise AssertionError(f"[batch] iso_headline against [main]'s CLI "
                             f"files: differ {mismatched}, missing {missing}")
    log(f"[batch] iso_headline: {len(compared)} files byte-identical to "
        "[main]'s CLI run (GFA, clustering, each cluster's stages, the "
        "consensus)")
    if runs["serial"]["summary"]["grouping_launches"] == 0 or \
            runs["serial"]["summary"]["dispatches"][
                "batch_membership_contraction"] != 1:
        raise AssertionError("[batch] serial: no grouping launch, or not "
                             "one contraction dispatch")

    n_dev = fleet.fleet_devices()
    plan = fleet.plan_fleet(
        {n: fleet.isolate_cost(parent / n) for n in names}, n_dev,
        knob_int("AUTOCYCLER_FLEET_BUCKETS"))
    shards = [(sh.index, sh.bucket, list(sh.names)) for sh in plan.shards]
    log(f"[batch] fleet plan ({n_dev} device(s)): {json.dumps(shards)}")
    if any(len(sh.names) != 1 for sh in plan.shards) or \
            plan.shards[0].names != ("iso_headline",):
        raise AssertionError("[batch] the fleet plan does not put the "
                             "headline first, in a shard of its own")
    runs["fleet"] = _batch_run("fleet", base + ["-a", fleet_out,
                                                "--fleet", "on"], len(good))
    _check_manifest(fleet_out, "fleet", good, 1)
    fleet_files = _isolate_files(fleet_out, good)
    if fleet_files != _isolate_files(serial, good):
        raise AssertionError("[batch] the fleet run's files differ from the "
                             "serial run's")
    summary = runs["fleet"]["summary"]
    if summary["grouping_launches"] == 0 or \
            summary["dispatches"]["fleet_membership_contraction"] != \
            len(plan.shards) - 1:
        raise AssertionError("[batch] fleet: no grouping launch, or not one "
                             "contraction a shard with a compressed isolate")
    log(f"[batch] fleet: every file of the {len(good)} done isolates "
        f"({len(fleet_files)} files) equal to the serial run's")

    # every isolate the resume tries fails, so it exits 1, as the JAX
    # package's does ("all 1 isolate(s) failed during compress")
    runs["resume"] = _batch_run("resume", base + ["-a", fleet_out, "--fleet",
                                                  "on", "--resume"], 0,
                                expect_rc=1)
    items = _check_manifest(fleet_out, "resume", good, 2)
    if any(items[n]["attempts"] != 1 for n in good) or \
            _isolate_files(fleet_out, good) != fleet_files or \
            runs["resume"]["summary"]["grouping_launches"]:
        raise AssertionError("[batch] the resume touched a done isolate")
    log("[batch] resume: exit 1 (its one isolate failed again), every done "
        "isolate skipped, iso_corrupt tried again (attempts 2), no other "
        "file changed, no grouping launched")

    # the sharded code with more than one shard, on the card
    (M_list, w_list), _ = contractions[0]
    cuda = torch.device("cuda:0")
    four = mesh.make_mesh(devices=[cuda] * 4)
    one = mesh.make_mesh(devices=[cuda])
    t0 = time.perf_counter()
    sharded = pbatch.batched_membership_intersections(four, M_list, w_list)
    sharded_s = time.perf_counter() - t0
    single = pbatch.batched_membership_intersections(one, M_list, w_list)
    host = [(m.astype(np.int64) * w[None, :]) @ m.astype(np.int64).T
            for m, w in zip(M_list, w_list)]
    if not all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(sharded, single, host)):
        raise AssertionError("[batch] the 2 x 2 mesh's contraction differs "
                             "from the 1 x 1 mesh's or the host's")
    log(f"[batch] membership contraction on a {four.shape} mesh of cuda:0, "
        f"{len(M_list)} isolates (contigs {[m.shape[0] for m in M_list]}, "
        f"unitigs up to {max(m.shape[1] for m in M_list)}): equal to the "
        f"1 x 1 mesh and the host int64 product, max_abs_err 0; "
        f"{sharded_s:.3f} s")
    cfg = BATCH_SKETCH
    rng = np.random.default_rng(9)
    genomes = []
    for _ in range(cfg["isolates"]):
        g = "".join(rng.choice(list("ACGT"), size=cfg["length"]))
        other = "".join(rng.choice(list("ACGT"), size=cfg["length"]))
        genomes.append([g, g[50:] + g[:50], other])
    codes = np.tile(pbatch.encode_batch(genomes, length=cfg["length"]),
                    (1, cfg["assemblies"] // 3, 1))
    kwargs = dict(k=cfg["k"], buckets=cfg["buckets"])
    on_mesh = pbatch.sharded_multi_isolate_step(four, codes, **kwargs)
    on_card = pbatch.multi_isolate_distance_step(
        torch.from_numpy(codes).to(cuda), **kwargs)
    on_cpu = pbatch.multi_isolate_distance_step(torch.from_numpy(codes),
                                                **kwargs)
    if on_mesh.shape != (cfg["isolates"], cfg["assemblies"],
                         cfg["assemblies"]) or \
            not (np.array_equal(on_mesh, on_card) and
                 np.array_equal(on_mesh, on_cpu)):
        raise AssertionError("[batch] the sharded sketch step differs from "
                             "the single-device step on the card or the CPU")
    log(f"[batch] sharded sketch step, {tuple(codes.shape)} on a "
        f"{four.shape} mesh of cuda:0: bitwise equal (float32) to the "
        "single-device step on the card and on CPU tensors")
    return {name: run["summary"] for name, run in runs.items()}


# [chaos]: the crash point it arms, and each child's time limit (s)
CHAOS_POINT = "mid-spill-write"
CHAOS_TIMEOUT_S = 600.0


def phase_chaos(work: Path) -> dict:
    """One chaos cycle at full size on the card: `batch` of [batch]'s
    headline isolate alone (24 assemblies, 146,880,000 bp, -k 51 -t 8) in
    a child process with mid-spill-write armed, which must die at that
    point (exit 43, the marker on stderr) inside the stream's pass 1; then
    --resume in a second child, which must exit 0, sweep the dead run's
    spill dir, leave no tmp file or .stream/run-* dir, and write the three
    final files of [batch]'s serial run, byte for byte (its files are the
    oracle: a batch of one isolate writes that isolate's files as the full
    batch does, tests/test_torch_chaos.py)."""
    from autocycler_tpu_torch.utils import chaos

    parent = work / "chaos_isolates"
    parent.mkdir()
    (parent / "iso_headline").symlink_to(
        (work / "batch_isolates" / "iso_headline").resolve())
    oracle = {rel: sha for rel, sha in
              chaos.artifact_digests(work / "batch_serial").items()
              if rel.startswith("iso_headline/")}
    if len(oracle) != len(chaos.FINAL_ARTIFACTS) or None in oracle.values():
        raise AssertionError(f"[chaos] [batch]'s oracle files: {oracle}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()        # the children need the card's memory
    verdict = chaos.chaos_cycle(parent, work / "chaos", CHAOS_POINT,
                                kmer=51, oracle=oracle,
                                timeout=CHAOS_TIMEOUT_S, device="cuda:0",
                                threads=8)
    line = verdict.get("crash_line") or ""
    if not verdict["passed"] or verdict["crash_rc"] != chaos.CRASH_EXIT \
            or ".u64" not in line or verdict["orphans_swept"] < 1:
        raise AssertionError(f"[chaos] {json.dumps(verdict)}")
    log(f"[chaos] {CHAOS_POINT} at the headline: the child died with exit "
        f"{verdict['crash_rc']} ({line!r}) after {verdict['crash_s']} s, "
        f"--resume exited 0 after {verdict['resume_s']} s and swept "
        f"{verdict['orphans_swept']} dead spill dir; the 3 final files equal "
        f"[batch]'s serial run's; no orphan: {json.dumps(verdict)}")
    return verdict


# [serve]: the daemon's workers, the sampler's tick (s) and each wait's cap
SERVE_WORKERS = 2
SERVE_TICK_S = "0.5"
SERVE_JOB_TIMEOUT_S = 900.0
# the second headline-size job's input: the headline's configuration drawn
# from another seed, so that it is as cold as the headline's own
SERVE_SECOND_SEED = 8


def _job_summary(record: dict) -> dict:
    """A finished job's queue wait, wall, stage and substage seconds and
    grouping launches, read from its record and its own trace.jsonl."""
    run_dir = Path(record["run_dir"])
    seconds = {"stage": {}, "substage": {}}
    launches = 0
    for r in _trace_records(run_dir):
        if r.get("type") != "span":
            continue
        if r["cat"] in seconds:
            into = seconds[r["cat"]]
            into[r["name"]] = round(into.get(r["name"], 0.0) + r["dur"], 6)
        elif r["cat"] == "device" and r["name"] == "sortnet_pack_rank":
            launches += 1
    return {"job": record["id"], "state": record["state"],
            "queue_wait_s": record["queue_wait_s"], "wall_s": record["wall_s"],
            "stages_s": seconds["stage"], "substages_s": seconds["substage"],
            "grouping_launches": launches}


def _check_job_run_dir(record: dict, trace_id: str, done: bool) -> None:
    """The job's run dir holds its own record: the trace's header carries
    its trace id and no other job's span; a done job's QC report and
    ledger hold only entries of its own scope."""
    job, run_dir = record["id"], Path(record["run_dir"])
    records = _trace_records(run_dir)
    header = records[0]
    jobs = {r["name"] for r in records
            if r.get("type") == "span" and r["name"].startswith("job/")}
    if header.get("type") != "run" or header.get("trace_id") != trace_id \
            or jobs != {f"job/{job}"}:
        raise AssertionError(f"[serve] {job} trace: header {header}, job "
                             f"spans {sorted(jobs)}")
    if not done:
        return

    def mine(iso) -> bool:
        return iso == job or (isinstance(iso, str)
                              and iso.startswith(job + "/"))

    qc = json.loads((run_dir / "qc_report.json").read_text())
    ledger = json.loads((run_dir / "ledger.json").read_text())
    if not qc["entries"] or not all(mine(e.get("isolate"))
                                    for e in qc["entries"]) \
            or qc.get("trace_id") != trace_id:
        raise AssertionError(f"[serve] {job} qc_report: "
                             f"{[e.get('isolate') for e in qc['entries']]}")
    if not ledger["stages"] or not all(mine(e.get("isolate"))
                                       for e in ledger["stages"]) \
            or ledger.get("trace_id") != trace_id:
        raise AssertionError(f"[serve] {job} ledger: "
                             f"{[e.get('isolate') for e in ledger['stages']]}")


def _out_files(out: Path) -> dict:
    """{relative path: bytes} under a job's or isolate's out dir, the
    warm-start cache left out (the daemon's is shared under its root)."""
    return {str(f.relative_to(out)): f.read_bytes()
            for f in sorted(out.rglob("*"))
            if f.is_file() and ".cache" not in f.relative_to(out).parts}


def _serve_jobs(handle, headline: Path, second: Path, parent: Path, small,
                fleet_out: Path) -> dict:
    """[serve]'s submissions to the running daemon, in order: the two cold
    headline-size jobs (the headline as a pipeline job, ``second`` as a
    compress job), the small isolates' compress batch and the corrupt
    isolate at once; then the warm headline compress; then the fleet body.
    Returns the finished records and what was read around them (device
    peaks, cache events, /healthz, /metrics, the shutdown's status)."""
    from autocycler_tpu_torch.serve.client import request_json, wait_for_job
    from autocycler_tpu_torch.serve.protocol import TRACE_HEADER
    from autocycler_tpu_torch.utils import cache

    def post(body: dict, trace_id: str) -> dict:
        status, record = request_json(handle.endpoint, "POST", "/jobs",
                                      body=body,
                                      headers={TRACE_HEADER: trace_id})
        if status != 202:
            raise AssertionError(f"[serve] POST /jobs {status}: {record}")
        return record

    def wait(job_id: str) -> dict:
        return wait_for_job(handle.endpoint, job_id, poll_s=0.2,
                            timeout=SERVE_JOB_TIMEOUT_S)

    def events_since(before: dict) -> dict:
        return {k: v - before[k] for k, v in cache.cache_stats().items()}

    run = {}
    t0 = time.perf_counter()
    head = post({"assemblies_dir": str(headline), "command": "pipeline",
                 "kmer": 51, "threads": 8}, "t-serve-headline")
    head2 = post({"assemblies_dir": str(second), "command": "compress",
                  "kmer": 51, "threads": 8}, "t-serve-second")
    batch = post({"batch": [{"assemblies_dir": str(parent / n)}
                            for n in small],
                  "command": "compress", "kmer": 51, "threads": 8},
                 "t-serve-batch")
    bad = post({"assemblies_dir": str(parent / "iso_corrupt"),
                "command": "compress", "threads": 8}, "t-serve-corrupt")
    run["head"] = wait(head["id"])
    run["head2"] = wait(head2["id"])
    run["children"] = [wait(c["id"]) for c in batch["children"]]
    run["bad"] = wait(bad["id"])
    run["concurrent_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    run["concurrent_peak"] = torch.cuda.max_memory_allocated()
    _, health = request_json(handle.endpoint, "GET", "/healthz")
    if health["status"] != "ok" or health["workers"] != SERVE_WORKERS \
            or health["probe"]["state"] != "attached" \
            or health["probe"]["kind"] != "ok":
        raise AssertionError(f"[serve] /healthz {health}")

    torch.cuda.reset_peak_memory_stats()
    before = cache.cache_stats()
    with groupings_launched(k=25) as repairs:
        run["warm"] = wait(post({"assemblies_dir": str(headline),
                                 "command": "compress", "kmer": 51,
                                 "threads": 8}, "t-serve-warm")["id"])
    torch.cuda.synchronize()
    run["warm_peak"] = torch.cuda.max_memory_allocated()
    run["warm_stats"] = events_since(before)
    run["warm_bins"] = spill_bins()
    run["repairs"] = repairs

    before = cache.cache_stats()
    run["fleet"] = wait(post({"batch": [{"assemblies_dir": str(parent / n),
                                         "out_dir": str(fleet_out / n)}
                                        for n in small],
                              "command": "pipeline", "kmer": 51,
                              "threads": 8, "fleet": True},
                             "t-serve-fleet")["id"])
    run["fleet_stats"] = events_since(before)
    _, run["metrics"] = request_json(handle.endpoint, "GET", "/metrics")
    _, run["health_end"] = request_json(handle.endpoint, "GET", "/healthz")
    run["fleet_top"] = serve_fleet_top(handle.root,
                                       handle.root.parent / "serve_fleet")
    run["shutdown"], _ = request_json(handle.endpoint, "POST", "/shutdown")
    return run


def _top(argv) -> str:
    """The port's `top` through the CLI; its frame (stdout)."""
    from autocycler_tpu_torch import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"[serve] {' '.join(argv)} exited {rc}")
    return out.getvalue()


def serve_fleet_top(root: Path, fleet_dir: Path) -> dict:
    """`top --fleet --once` over a fleet dir whose only replica is the live
    daemon's root: the scraper finds one healthy replica, writes
    fleet_status.json and gives a verdict."""
    from autocycler_tpu_torch.obs import federate
    fleet_dir.mkdir()
    (fleet_dir / root.name).symlink_to(root.resolve())
    t0 = time.perf_counter()
    frame = _top(["top", "--fleet", str(fleet_dir), "--once"])
    seconds = time.perf_counter() - t0
    status = federate.read_fleet_status(fleet_dir / federate.FLEET_STATUS_JSON)
    summary, verdict = status.get("summary") or {}, status.get("verdict") or {}
    if summary.get("replicas") != 1 or summary.get("healthy") != 1 \
            or verdict.get("verdict") not in federate.VERDICTS \
            or "1 healthy" not in frame or "Verdict" not in frame:
        raise AssertionError(f"[serve] top --fleet: {frame!r}, summary "
                             f"{summary}, verdict {verdict}")
    log(f"[serve] top --fleet over one replica ({seconds:.3f} s):\n{frame}")
    return {"summary": summary, "verdict": verdict["verdict"],
            "seconds": seconds}


def serve_top(root: Path, cold_bins: int) -> dict:
    """`top --once` on the stopped daemon's root: a Device/host line with
    device seconds in view, and a Spill line with at least ``cold_bins``
    more bins (the cold headline-size jobs streamed)."""
    frame = _top(["top", str(root), "--once"])
    lines = {line.split()[0]: line for line in frame.splitlines() if line}
    device_s = bins = 0
    if "Device/host" in lines and " in view" in lines["Device/host"]:
        device_s = float(lines["Device/host"].split("s in view")[0]
                         .split()[-1])
    if "Spill" in lines and "bins +" in lines["Spill"]:
        bins = int(lines["Spill"].split("bins +")[1].split()[0])
    if device_s <= 0 or bins < cold_bins:
        raise AssertionError(f"[serve] top: device {device_s} s, bins "
                             f"{bins} (want > 0 and >= {cold_bins}):\n"
                             f"{frame}")
    log(f"[serve] top --once on the daemon's root:\n{frame}")
    return {"device_s_in_view": device_s, "spill_bins_in_view": bins}


def phase_serve(work: Path, cold: dict) -> dict:
    """The daemon on the card, in this process, over loopback HTTP:
    ``ServeHandle(root, workers=2)``, its process warmed as `autocycler
    serve` warms it (the shared .cache under the root, both kernel
    libraries loaded). At once: two cold headline-size jobs, one a worker
    (the headline isolate as a pipeline job, and the headline's
    configuration drawn from seed SERVE_SECOND_SEED as a compress job:
    the device peak of a pipeline is its compress's), then a batch body
    of 7 of bench_batch's
    isolates as compress child jobs and [batch]'s corrupt isolate, queued
    behind them; after those, the headline as a compress job again, warm
    from the shared cache; then a fleet body of the 7 isolates as pipeline
    jobs. The headline job's files must equal [main]'s CLI files, the
    second job's GFA must decompress to its inputs, each child's GFA
    [batch]'s serial run's, the fleet's files [batch]'s fleet run's; the
    two cold jobs' device peak must fit the card; the warm job must hit
    24 + 1 cache entries, launch no end-repair grouping and peak below the
    cold jobs; the corrupt job fails while the daemon stays ok; every run
    dir holds only its job's scope; the grouping launches add up."""
    from synthetic import make_assemblies_fast

    from autocycler_tpu_torch import cli, device
    from autocycler_tpu_torch.serve.server import ServeHandle, warm_process
    from autocycler_tpu_torch.utils import cache, timing

    parent = work / "batch_isolates"
    # [main]'s own assemblies dir: input_assemblies.yaml records its paths
    headline = work / "headline" / "assemblies"
    t0 = time.perf_counter()
    second = make_assemblies_fast(work / "serve_second",
                                  **{**HEADLINE, "seed": SERVE_SECOND_SEED})
    log(f"[serve] second headline-size input generated in "
        f"{time.perf_counter() - t0:.3f} s (seed {SERVE_SECOND_SEED})")
    small = sorted(d.name for d in parent.iterdir()
                   if d.name not in ("iso_headline", "iso_corrupt"))
    root = work / "serve"
    t0 = time.perf_counter()
    warm_process(root)
    log(f"[serve] process warmed in {time.perf_counter() - t0:.3f} s "
        f"(shared cache {cache.shared_cache_dir()}, both kernel libraries "
        f"loaded); probe {json.dumps(device.probe_report())}")
    os.environ["AUTOCYCLER_TIMESERIES_INTERVAL_S"] = SERVE_TICK_S
    device.reset_counts()
    # a daemon's registry starts empty: its time series (and top) then
    # holds only its own jobs' counts
    timing.reset()
    token_before = timing.token_wait_seconds()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the daemon logs every job to stderr, as `autocycler serve` does: kept
    # here, and its tail printed if the phase fails
    daemon_log = io.StringIO()
    handle = None
    try:
        with contextlib.redirect_stderr(daemon_log):
            handle = ServeHandle(root, port=0, workers=SERVE_WORKERS).start()
            run = _serve_jobs(handle, headline, second, parent, small,
                              root / "fleet_out")
    except BaseException:
        log(f"[serve] the daemon's log, last 6000 characters:\n"
            f"{daemon_log.getvalue()[-6000:]}")
        raise
    finally:
        if handle is not None:
            handle.stop()
        os.environ.pop("AUTOCYCLER_TIMESERIES_INTERVAL_S")
        cache.set_shared_cache_dir(None)
        timing.enable_device_token(False)
    token_wait = timing.token_wait_seconds() - token_before
    launches = device.launches["sortnet_pack_rank"]
    top_view = serve_top(root, cold["stream"]["bins"])
    head, head2, children, bad, warm, fleet = (run[k] for k in (
        "head", "head2", "children", "bad", "warm", "fleet"))
    health_end, warm_stats, fleet_stats = (run[k] for k in (
        "health_end", "warm_stats", "fleet_stats"))
    concurrent_peak, warm_peak = run["concurrent_peak"], run["warm_peak"]

    if run["shutdown"] != 200:
        raise AssertionError(f"[serve] POST /shutdown gave {run['shutdown']}")
    states = {r["id"]: r["state"] for r in [head, head2, warm, fleet,
                                             *children]}
    if any(v != "done" for v in states.values()) or bad["state"] != "failed" \
            or not bad["error"] or "device error" in bad["error"] \
            or health_end["status"] != "ok":
        raise AssertionError(f"[serve] states {states}, corrupt {bad}, "
                             f"health {health_end['status']}")
    for record, trace_id, done in (
            [(head, "t-serve-headline", True),
             (head2, "t-serve-second", True), (bad, "t-serve-corrupt", False),
             (warm, "t-serve-warm", True), (fleet, "t-serve-fleet", True)]
            + [(c, "t-serve-batch", True) for c in children]):
        _check_job_run_dir(record, trace_id, done)

    main_out = work / "out"
    head_files = _out_files(Path(head["out_dir"]))
    differ = [rel for rel, data in head_files.items()
              if (main_out / rel).read_bytes() != data]
    lines = head_files["consensus_assembly.fasta"].decode().splitlines()
    if differ or len(head_files) < 12 or \
            [("circular=true" in h) for h in lines[0::2]] != [True, True]:
        raise AssertionError(f"[serve] headline job: {len(head_files)} "
                             f"files, differ from [main]'s {differ}")
    recon = work / "serve_second_recon"
    with contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["decompress", "-i", str(Path(head2["out_dir"]) /
                                               "input_assemblies.gfa"),
                       "-o", str(recon)])
    if rc != 0 or not _same_files(second, recon):
        raise AssertionError("[serve] the second headline-size job's GFA "
                             f"does not decompress to its inputs (exit {rc})")
    for name, child in zip(small, children):
        gfa = Path(child["out_dir"]) / "input_assemblies.gfa"
        if gfa.read_bytes() != (work / "batch_serial" / name /
                                "input_assemblies.gfa").read_bytes():
            raise AssertionError(f"[serve] {child['id']} ({name}): GFA "
                                 "differs from [batch]'s serial run's")
    warm_out = Path(warm["out_dir"])
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        if (warm_out / name).read_bytes() != (main_out / name).read_bytes():
            raise AssertionError(f"[serve] warm job: {name} differs from "
                                 "[main]'s")
    for name in small:
        if _out_files(root / "fleet_out" / name) != \
                _out_files(work / "batch_fleet" / name):
            raise AssertionError(f"[serve] fleet job: {name}'s files differ "
                                 "from [batch]'s fleet run's")

    summaries = {"headline pipeline, cold": _job_summary(head),
                 "second headline-size compress, cold": _job_summary(head2),
                 **{f"compress {n}": _job_summary(c)
                    for n, c in zip(small, children)},
                 "corrupt compress": _job_summary(bad),
                 "headline compress, warm": _job_summary(warm),
                 f"fleet pipeline, {len(small)} isolates": _job_summary(fleet)}
    for label, summary in summaries.items():
        log(f"[serve] {label}: {json.dumps(summary)}")
    counts = {label: s["grouping_launches"] for label, s in summaries.items()}
    cold_launches = cold["launches"]["sortnet_pack_rank"]
    # the second input has the headline's shape, so its stream plan and
    # its launches are the headline's
    expected = {"headline pipeline, cold": cold_launches,
                "second headline-size compress, cold": cold_launches,
                **{f"compress {n}": 3 for n in small},
                "corrupt compress": 0,
                "headline compress, warm": run["warm_bins"] + 2,
                f"fleet pipeline, {len(small)} isolates":
                    2 * len(small) + fleet_stats["repair_misses"]}
    if warm_stats != {"parse_hits": 24, "parse_misses": 0, "repair_hits": 1,
                      "repair_misses": 0} or run["repairs"] \
            or counts != expected \
            or launches != sum(expected.values()) \
            or cold_launches != run["warm_bins"] + 3:
        raise AssertionError(
            f"[serve] warm cache events {warm_stats}, {len(run['repairs'])} "
            f"end-repair groupings; grouping launches {counts} (phase "
            f"{launches}), expected {expected}")
    if warm_peak >= concurrent_peak:
        raise AssertionError(f"[serve] warm job's device peak {warm_peak} B "
                             f"not below the cold jobs' {concurrent_peak} B")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    if concurrent_peak >= card_bytes:
        raise AssertionError(f"[serve] the two cold jobs' device peak "
                             f"{concurrent_peak} B exceeds the card's "
                             f"{card_bytes} B")

    text = run["metrics"].get("raw", "")
    for needle in ('autocycler_serve_jobs_total{command="pipeline",'
                   'state="done"}',
                   'autocycler_serve_jobs_total{command="compress",'
                   'state="failed"}',
                   "autocycler_serve_device_token_wait_seconds_total{"):
        if needle not in text:
            raise AssertionError(f"[serve] /metrics lacks {needle}")
    ticks = [json.loads(line) for line in
             (root / "timeseries.jsonl").read_text().splitlines() if line]
    if not any("device_bytes_in_use" in t for t in ticks):
        raise AssertionError(f"[serve] timeseries.jsonl: {len(ticks)} ticks, "
                             "none with device_bytes_in_use")

    main_walls = {label: wall for phase, label, wall in CLI_WALLS
                  if phase == "main" and (label == "compress" or
                                          label == "cluster" or
                                          label.startswith("headline "))}
    result = {
        "concurrent_phase_s": run["concurrent_s"],
        "token_wait_s": token_wait,
        "device_peak_bytes": {"two cold headline-size jobs at once":
                                  concurrent_peak,
                              "warm": warm_peak, "card": card_bytes},
        "memory_reserved_bytes": torch.cuda.memory_reserved(),
        "grouping_launches": launches,
        "timeseries_ticks": len(ticks),
        "cache_events": {"warm": warm_stats, "fleet": fleet_stats},
        "walls_s": {"headline pipeline job": head["wall_s"],
                    "second headline-size compress job": head2["wall_s"],
                    "headline compress job, warm": warm["wall_s"],
                    "main CLI": main_walls,
                    "main CLI sum": sum(main_walls.values())},
        "sampler": health_end["sampler"], "probe": health_end["probe"],
        "top": top_view, "fleet_top": run["fleet_top"]}
    log("[serve] the headline job wrote [main]'s files, the second "
        "headline-size job a GFA that decompresses to its inputs, both cold "
        "at once "
        "within the card's memory; each child's GFA "
        "[batch]'s serial run's, the fleet job [batch]'s fleet files; the "
        "warm job hit 24 + 1 entries with no end-repair grouping; the corrupt "
        "job failed while the daemon stayed ok; every run dir holds its own "
        "job's scope: " + json.dumps(result))
    return result


def spill_bins() -> int:
    """The bins of the last streamed grouping of this process."""
    from autocycler_tpu_torch.stream import spill
    return int(spill.last_run["bins"])


def phase_stream(work: Path, streamed: dict):
    """The headline compress once more through the CLI, grouping in memory
    (AUTOCYCLER_STREAM_KMERS=off): its GFA and YAML must equal [main]'s
    streamed run's. Logs both runs' walls, compress/build_graph and peak
    device memory. Returns the in-memory k=51 grouping's inputs, for
    [timing]. (The fresh-process pair that measured each compress's peak
    host RSS was cut in depth to pay for [chaos].)"""
    asm, out = work / "headline" / "assemblies", work / "in_memory"
    os.environ["AUTOCYCLER_STREAM_KMERS"] = "off"
    try:
        with groupings_launched(first=True, k=51) as k51:
            in_memory = run_cli("headline compress, in memory",
                                ["compress", "-i", asm, "-a", out,
                                 "--kmer", "51"], "stream")
    finally:
        os.environ.pop("AUTOCYCLER_STREAM_KMERS")
    if in_memory["stream"] or (out / ".stream").exists():
        raise AssertionError("[stream] the in-memory compress streamed")
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        if (out / name).read_bytes() != (work / "out" / name).read_bytes():
            raise AssertionError(f"[stream] {name} of the in-memory compress "
                                 "differs from the streamed one's in [main]")
    keys = ("wall_s", "peak_device_bytes", "build_graph_peak_device_bytes",
            "device_bytes_before")
    log("[stream] headline compress, streamed ([main]) against in memory: "
        + json.dumps({label: {**{key: run[key] for key in keys},
                              "build_graph_s": run["stages"][
                                  "compress/build_graph"],
                              "grouping_launches": run["launches"][
                                  "sortnet_pack_rank"]}
                      for label, run in (("streamed", streamed),
                                         ("in_memory", in_memory))}))
    log("[stream] the in-memory compress writes [main]'s GFA and YAML, byte "
        "for byte")
    return k51[0]


def phase_radix(work: Path) -> dict:
    """The headline compress through the CLI with the radix-sharded
    grouping (AUTOCYCLER_DEVICE_GROUPING=radix) in memory
    (AUTOCYCLER_STREAM_KMERS=off): its GFA and YAML must equal [stream]'s
    in-memory compress's. Then the radix grouping with statistics of that
    compress's k=51 windows over a 4-shard mesh of cuda:0, which must equal
    the 1-device result and pack_rank over all windows. Returns the
    grouping launches of both runs, for the kernels line."""
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.ops import kmers

    asm, out = work / "headline" / "assemblies", work / "radix"
    seen = []
    real = kmers.radix_rank

    def capture(codes, starts, k, threads=None, devices=None, stats=False):
        if stats:
            seen.append((codes, starts, k))
        return real(codes, starts, k, threads, devices, stats)

    knobs = {"AUTOCYCLER_STREAM_KMERS": "off",
             "AUTOCYCLER_DEVICE_GROUPING": "radix"}
    os.environ.update(knobs)
    kmers.radix_rank = capture
    try:
        run = run_cli("headline compress, radix-sharded",
                      ["compress", "-i", asm, "-a", out, "--kmer", "51"],
                      "radix")
    finally:
        kmers.radix_rank = real
        for name in knobs:
            os.environ.pop(name)
    if run["stream"] or (out / ".stream").exists():
        raise AssertionError("[radix] the radix compress streamed")
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        if (out / name).read_bytes() != \
                (work / "in_memory" / name).read_bytes():
            raise AssertionError(f"[radix] {name} of the radix compress "
                                 "differs from [stream]'s in-memory one")
    dispatches = {name: run["dp"][name] for name in
                  (kmers.RADIX_STATS_DISPATCH, kmers.RADIX_DISPATCH)}
    launches = run["launches"]["sortnet_pack_rank"]
    if [d["dispatches"] for d in dispatches.values()] != [1, 2] or \
            launches < 3 or len(seen) != 1:
        raise AssertionError(f"[radix] dispatches {dispatches}, grouping "
                             f"launches {launches}, {len(seen)} k-mer "
                             "groupings with statistics")
    log("[radix] headline compress, radix-sharded: " + json.dumps({
        "wall_s": run["wall_s"],
        "substages_s": {name: run["substages"].get(name)
                        for name in ("partition", "sort", "stitch",
                                     "k-mer grouping", "gram grouping")},
        "grouping_launches": launches,
        "grouping_kernel_ms": run["kernel_ms"].get("sortnet_pack_rank"),
        "dispatches": {name: {key: d[key] for key in
                              ("dispatches", "rows", "windows", "ms")
                              if key in d}
                       for name, d in dispatches.items()},
        "peak_device_bytes": run["peak_device_bytes"]}))
    log("[radix] the radix compress writes [stream]'s in-memory GFA and "
        "YAML, byte for byte")

    codes, starts, k = seen[0]
    cuda0 = torch.device("cuda:0")
    device.reset_counts()
    t0 = time.perf_counter()
    mesh = real(codes, starts, k, devices=[cuda0] * 4, stats=True)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    mesh_launches = device.launches["sortnet_pack_rank"]
    mesh_record = device.dp_summary(kmers.RADIX_STATS_DISPATCH)
    one = real(codes, starts, k, devices=[cuda0], stats=True)
    order, gid_sorted = kmers.rank_windows(codes, starts, k)
    whole = (order, gid_sorted, *kmers.segment_stats(order, gid_sorted))
    names = ("order", "gid_sorted", "depth", "first_occ")
    bad = [name for name, a, b, c in zip(names, mesh, one, whole)
           if not (torch.equal(a, b) and torch.equal(a, c))]
    if bad or mesh_launches == 0:
        raise AssertionError(f"[radix] the 4-shard mesh differs in {bad} "
                             f"(launches {mesh_launches})")
    log("[radix] k=51 windows over [cuda:0] * 4: " + json.dumps({
        "windows": len(starts), "rows": mesh_record["rows"],
        "grouping_launches": mesh_launches, "wall_s": mesh_s,
        "dispatch_ms": mesh_record.get("ms")})
        + "; equal to the 1-device result and pack_rank over all windows")
    del seen, codes, starts, mesh, one, whole, order, gid_sorted
    return {"headline compress": launches, "mesh [cuda:0] * 4": mesh_launches}


def _file_hashes(root: Path) -> dict:
    """{path relative to root: sha256} of every file under root."""
    import hashlib
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _gfa_qc(gfa: Path) -> dict:
    """Unitig count, total length and N50 of a GFA's S lines, computed
    here without the package."""
    lengths = []
    with open(gfa) as f:
        for line in f:
            if line.startswith("S\t"):
                lengths.append(len(line.split("\t", 3)[2]))
    lengths.sort(reverse=True)
    total, running, n50 = sum(lengths), 0, 0
    for length in lengths:
        running += length
        if 2 * running >= total:
            n50 = length
            break
    return {"unitigs": len(lengths), "total_bp": total, "n50_bp": n50}


def _trace_records(run_dir: Path):
    return [json.loads(line) for line in
            (run_dir / "trace.jsonl").read_text().splitlines() if line]


RUN_FILES = ("trace.jsonl", "metrics.json", "metrics.prom", "qc_report.json",
             "ledger.json")


def phase_warm(work: Path, cold: dict) -> None:
    """[main]'s headline compress once more through the CLI into a fresh
    directory, warm: AUTOCYCLER_CACHE_DIR points at [main]'s .cache, and
    AUTOCYCLER_TRACE_DIR at a run dir. Its GFA and YAML must equal [main]'s;
    it must hit the 24 parse entries and the repair entry, miss none, and
    launch no end-repair grouping (k // 2 = 25) but still build its graph on
    the card, streamed; its ledger's input and output sha256s must equal
    the files', its QC the GFA's own counts, its stage spans the stage
    timers (5 %), and its top-level span must carry the device bytes."""
    import hashlib

    from autocycler_tpu_torch.utils import cache

    asm, main_out = work / "headline" / "assemblies", work / "out"
    out, run_dir = work / "warm", work / "warm_trace"
    os.environ["AUTOCYCLER_CACHE_DIR"] = str(main_out / ".cache")
    os.environ["AUTOCYCLER_TRACE_DIR"] = str(run_dir)
    try:
        with groupings_launched(k=25) as repairs:
            warm = run_cli("headline compress, warm",
                           ["compress", "-i", asm, "-a", out, "--kmer", "51"],
                           "warm")
        stats = cache.cache_stats()
    finally:
        os.environ.pop("AUTOCYCLER_CACHE_DIR")
        os.environ.pop("AUTOCYCLER_TRACE_DIR")
    stream = check_streamed("warm", "compress", warm)
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        if (out / name).read_bytes() != (main_out / name).read_bytes():
            raise AssertionError(f"[warm] {name} differs from [main]'s")
    if stats != {"parse_hits": 24, "parse_misses": 0, "repair_hits": 1,
                 "repair_misses": 0}:
        raise AssertionError(f"[warm] cache events {stats}")
    if repairs or warm["launches"]["sortnet_pack_rank"] != stream["bins"] + 2:
        raise AssertionError(
            f"[warm] {len(repairs)} end-repair groupings, "
            f"{warm['launches']['sortnet_pack_rank']} launches for "
            f"{stream['bins']} bins (expected the bins, the merge and the "
            "grams)")
    if sorted(p.name for p in run_dir.iterdir() if p.name in RUN_FILES) != \
            sorted(RUN_FILES):
        raise AssertionError(f"[warm] run dir: {sorted(run_dir.iterdir())}")
    ledger = json.loads((run_dir / "ledger.json").read_text())
    fastas = sorted(asm.glob("*.fasta"))
    if sorted(ledger["inputs"]) != [str(f) for f in fastas] or any(
            ledger["inputs"][str(f)]["sha256"] !=
            hashlib.sha256(f.read_bytes()).hexdigest() for f in fastas):
        raise AssertionError("[warm] the ledger's input sha256s differ from "
                             "the FASTAs'")
    stage = next(s for s in ledger["stages"] if s["stage"] == "compress")
    on_disk = {str(out / n): hashlib.sha256((out / n).read_bytes()).hexdigest()
               for n in ("input_assemblies.gfa", "input_assemblies.yaml")}
    if {p: d["sha256"] for p, d in stage["outputs"].items()} != on_disk:
        raise AssertionError("[warm] the ledger's compress outputs differ "
                             "from the files on disk")
    if ledger["caches"]["parse"] != {"hits": 24, "misses": 0} or \
            ledger["caches"]["repair"] != {"hits": 1, "misses": 0}:
        raise AssertionError(f"[warm] ledger caches {ledger['caches']}")
    report = json.loads((run_dir / "qc_report.json").read_text())
    entry = next(e for e in report["entries"] if e["stage"] == "compress")
    gfa_qc = _gfa_qc(out / "input_assemblies.gfa")
    if {k: entry["metrics"][k] for k in gfa_qc} != gfa_qc:
        raise AssertionError(f"[warm] QC {entry['metrics']} against the "
                             f"GFA's {gfa_qc}")
    records = _trace_records(run_dir)
    spans = {}
    for r in records:
        if r["type"] == "span" and r["cat"] == "stage":
            spans[r["name"]] = spans.get(r["name"], 0.0) + r["dur"]
    if set(spans) != set(warm["stages"]) or any(
            abs(spans[n] - secs) > 0.05 * secs + 1e-3
            for n, secs in warm["stages"].items()):
        raise AssertionError(f"[warm] stage spans {spans} against the "
                             f"timers {warm['stages']}")
    top = next(r for r in records
               if r["type"] == "span" and r["cat"] == "command")
    if "device_bytes_in_use" not in top.get("mem", {}):
        raise AssertionError(f"[warm] top-level span mem {top.get('mem')}")
    device_spans = sum(1 for r in records
                       if r["type"] == "span" and r["cat"] == "device")
    log("[warm] headline compress, warm from [main]'s .cache, the same GFA "
        "and YAML; 24 parse hits, 1 repair hit, 0 misses; no end-repair "
        "grouping; ledger sha256s, QC and stage spans agree: " + json.dumps({
            "wall_s": {"cold": cold["wall_s"], "warm": warm["wall_s"]},
            "load_and_repair_s": {
                label: run["stages"]["compress/load_and_repair"]
                for label, run in (("cold", cold), ("warm", warm))},
            "load_s": {label: run["substages"].get("load")
                       for label, run in (("cold", cold), ("warm", warm))},
            "repair_s": {label: run["substages"].get("repair")
                         for label, run in (("cold", cold), ("warm", warm))},
            "build_graph_s": {
                label: run["stages"]["compress/build_graph"]
                for label, run in (("cold", cold), ("warm", warm))},
            "peak_device_bytes": {
                label: run["peak_device_bytes"]
                for label, run in (("cold", cold), ("warm", warm))},
            "build_graph_peak_device_bytes": {
                label: run["build_graph_peak_device_bytes"]
                for label, run in (("cold", cold), ("warm", warm))},
            "grouping_launches": {
                label: run["launches"]["sortnet_pack_rank"]
                for label, run in (("cold", cold), ("warm", warm))},
            "cold_cache_store_s": cold["cache_store_s"],
            "trace": {"spans": len(records) - 2, "device_spans": device_spans,
                      "top_mem": top["mem"]}}))
    if warm["peak_device_bytes"] >= cold["peak_device_bytes"]:
        raise AssertionError("[warm] the warm compress's device peak is not "
                             "below the cold one's")


def warm_sketch_cluster(out: Path, n_contigs: int, cold_files: dict,
                        cold: dict, cold_sketch_s: float) -> None:
    """[sketch]'s auto cluster once more on its directory: every contig's
    sketch comes from the cache the cold auto run filled (264 hits, no
    miss), and the files are the cold run's."""
    from autocycler_tpu_torch.obs import metrics_registry
    from autocycler_tpu_torch.ops import sketch
    from autocycler_tpu_torch.utils import cache

    with _recorded(sketch, "sketch_matrix", lambda a, r: None) as hashing, \
            _recorded(sketch, "sketch_from_codes",
                      lambda a, r: None) as contig_hashes, \
            _recorded(cache, "_atomic_write", lambda a, r: None) as stores:
        warm = run_cli("plasmid-rich cluster, auto, warm",
                       ["cluster", "-a", out], "warm")
    reg = metrics_registry.registry()
    events = {e: int(reg.value(cache.CACHE_EVENTS, cache="sketch", event=e))
              for e in ("hit", "miss")}
    if events != {"hit": n_contigs, "miss": 0} or contig_hashes or stores:
        raise AssertionError(f"[warm] sketch cache events {events}, "
                             f"{len(contig_hashes)} contigs hashed, "
                             f"{len(stores)} entries stored")
    if _file_hashes(out / "clustering") != cold_files:
        raise AssertionError("[warm] the warm sketch cluster's files differ "
                             "from the cold auto run's")
    log(f"[warm] plasmid-rich cluster, auto, warm: {n_contigs} sketch hits, "
        "0 misses, the cold run's files: " + json.dumps({
            "sketch_matrix_s": {"cold": cold_sketch_s,
                                "warm": hashing[0][1]},
            "cluster_distances_s": {
                "cold": cold["stages"]["cluster/distances"],
                "warm": warm["stages"]["cluster/distances"]},
            "wall_s": {"cold": cold["wall_s"], "warm": warm["wall_s"]}}))


FLYE_STUB = r"""#!/usr/bin/env bash
out_dir=""
while [[ $# -gt 0 ]]; do
  case "$1" in
    --out-dir) out_dir=$2; shift 2;;
    *) shift;;
  esac
done
mkdir -p "$out_dir"
printf '>contig_1\nACGTACGTAC\n>contig_2\nGGGGCCCC\n' > "$out_dir/assembly.fasta"
printf '#seq_name\tlength\tcov.\tcirc.\ncontig_1\t10\t30\tY\ncontig_2\t8\t4\tN\n' > "$out_dir/assembly_info.txt"
printf 'log line\n' > "$out_dir/flye.log"
"""


def _cli_call(argv, env=None):
    """One in-process CLI call with ``env`` set around it: (exit code,
    stdout, stderr)."""
    from autocycler_tpu_torch import cli

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([str(a) for a in argv])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, out.getvalue(), err.getvalue()


def tools_lint() -> None:
    """`lint --json` over the port and chip_smoke.py in a fresh process: exit
    0 with 0 findings; `lint --knobs-md` equals docs_torch/cli.md's knob
    table."""
    lint = subprocess.run([sys.executable, "-m", "autocycler_tpu_torch",
                           "lint", "--json"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    result = json.loads(lint.stdout) if lint.returncode in (0, 1) else {}
    knobs_md = subprocess.run([sys.executable, "-m", "autocycler_tpu_torch",
                               "lint", "--knobs-md"], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
    page = (REPO / "docs_torch" / "cli.md").read_text()
    begin, end = "<!-- knobs:begin -->\n", "<!-- knobs:end -->"
    table = page[page.index(begin) + len(begin):page.index(end)]
    if lint.returncode or result.get("findings") or knobs_md.returncode \
            or knobs_md.stdout != table:
        raise AssertionError(f"[tools] lint: rc {lint.returncode}, "
                             f"{result.get('findings')}, --knobs-md rc "
                             f"{knobs_md.returncode}\n{lint.stderr[-2000:]}")
    log(f"[tools] lint: 0 findings across {result['files']} files, "
        f"{len(result['rules'])} rules, {result['wall_s']} s, Python "
        f"{sys.version.split()[0]}; --knobs-md equals docs_torch/cli.md's "
        "table")


def phase_tools(work: Path) -> None:
    """The host commands of a user's pipeline on the small inputs, through
    the CLI: subsample of a FASTQ drawn from a seed, table (the header, and
    a row whose fields are the YAML values), gfa2fasta of a 5_final.gfa,
    clean with --remove and with --cache, helper flye with a stub on PATH
    and helper raven without one (exit 1, "Error:"); then the small
    pipeline traced, one run dir a command, each with its run record."""
    import yaml

    t0 = time.perf_counter()
    small = work / "small_cuda"
    rng = np.random.default_rng(17)
    reads = work / "tools_reads.fastq"
    with open(reads, "w") as f:
        for i in range(400):
            seq = "".join("ACGT"[b] for b in rng.integers(0, 4,
                                                          rng.integers(1000, 4000)))
            f.write(f"@read_{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    rc, _, err = _cli_call(["subsample", "-r", reads, "-o", work / "subsets",
                            "-g", "34k", "--min_read_depth", "10"])
    subsets = sorted(p.name for p in (work / "subsets").iterdir())
    if rc != 0 or subsets != [f"sample_0{i}.fastq" for i in range(1, 5)] + [
            "subsample.yaml"] or "shuffle: rust-stdrng-0.9" not in \
            (work / "subsets/subsample.yaml").read_text():
        raise AssertionError(f"[tools] subsample: rc {rc}, {subsets}\n{err}")

    rc_h, header, _ = _cli_call(["table"])
    rc_r, row, _ = _cli_call(["table", "-a", small, "-n", "small"])
    fields = dict(zip(header.rstrip("\n").split("\t"),
                      row.rstrip("\n").split("\t")))
    clustering = yaml.safe_load((small / "clustering/clustering.yaml").read_text())
    consensus = yaml.safe_load((small / "consensus_assembly.yaml").read_text())
    want = {"name": "small",
            "pass_cluster_count": str(clustering["pass_cluster_count"]),
            "fail_cluster_count": str(clustering["fail_cluster_count"]),
            "consensus_assembly_bases":
                str(consensus["consensus_assembly_bases"]),
            "consensus_assembly_unitigs":
                str(consensus["consensus_assembly_unitigs"]),
            "consensus_assembly_fully_resolved":
                str(consensus["consensus_assembly_fully_resolved"]).lower()}
    if rc_h or rc_r or {k: fields.get(k) for k in want} != want:
        raise AssertionError(f"[tools] table: {fields} against {want}")

    final = sorted(small.glob("clustering/qc_pass/*/5_final.gfa"))[0]
    rc, _, _ = _cli_call(["gfa2fasta", "-i", final, "-o", work / "final.fasta"])
    fasta = (work / "final.fasta").read_text()
    if rc or not fasta.startswith(">1 length=") or "circular=true" not in fasta:
        raise AssertionError(f"[tools] gfa2fasta: rc {rc}, {fasta[:200]!r}")

    consensus_gfa = small / "consensus_assembly.gfa"
    rc, _, _ = _cli_call(["clean", "-i", consensus_gfa, "-o",
                          work / "cleaned.gfa", "-r", "2"])
    kept = [line for line in (work / "cleaned.gfa").read_text().splitlines()
            if line.startswith("S\t")]
    if rc or len(kept) != 1:
        raise AssertionError(f"[tools] clean --remove: rc {rc}, {len(kept)} "
                             "segments")
    entries = len(list((small / ".cache").glob("*.npz")))
    rc, _, err = _cli_call(["clean", "--cache", small])
    if rc or list((small / ".cache").glob("*.npz")) or \
            f"{entries} entries" not in err:
        raise AssertionError(f"[tools] clean --cache: rc {rc}\n{err}")

    bin_dir = work / "stub_bin"
    bin_dir.mkdir()
    (bin_dir / "flye").write_text(FLYE_STUB)
    (bin_dir / "flye").chmod(0o755)
    path = {"PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}
    rc, _, err = _cli_call(["helper", "flye", "-r", reads, "-o",
                            work / "asm/flye_01", "-d", work / "flye_work"],
                           path)
    flye = (work / "asm/flye_01.fasta").read_text() \
        if (work / "asm/flye_01.fasta").exists() else ""
    if rc or flye != (">contig_1 circular=true depth=30\nACGTACGTAC\n"
                      ">contig_2 depth=4\nGGGGCCCC\n"):
        raise AssertionError(f"[tools] helper flye: rc {rc}, {flye!r}\n{err}")
    rc, _, err = _cli_call(["helper", "raven", "-r", reads, "-o",
                            work / "asm/raven_01"], path)
    if rc != 1 or "Error: required program 'raven' not found" not in err:
        raise AssertionError(f"[tools] helper raven: rc {rc}\n{err}")

    asm, out, runs = work / "small" / "assemblies", work / "traced", \
        work / "traced_runs"
    steps = [("compress", ["compress", "-i", asm, "-a", out]),
             ("cluster", ["cluster", "-a", out])]
    rc, _, err = _cli_call(steps[0][1], {"AUTOCYCLER_TRACE_DIR":
                                         str(runs / "compress")})
    rc2, _, err2 = _cli_call(steps[1][1], {"AUTOCYCLER_TRACE_DIR":
                                           str(runs / "cluster")})
    if rc or rc2:
        raise AssertionError(f"[tools] traced compress/cluster: {err}{err2}")
    clusters = sorted((out / "clustering/qc_pass").iterdir())
    for c in clusters:
        steps += [(f"trim_{c.name}", ["trim", "-c", c]),
                  (f"resolve_{c.name}", ["resolve", "-c", c])]
    steps.append(("combine", ["combine", "-a", out, "-i",
                              *[c / "5_final.gfa" for c in clusters]]))
    for label, argv in steps[2:]:
        rc, _, err = _cli_call(argv, {"AUTOCYCLER_TRACE_DIR": str(runs / label)})
        if rc:
            raise AssertionError(f"[tools] traced {label}: {err}")
    for label, _ in steps:
        have = {p.name for p in (runs / label).iterdir()}
        report = json.loads((runs / label / "qc_report.json").read_text())
        if not set(RUN_FILES) <= have or not report["entries"] or \
                _trace_records(runs / label)[-1]["type"] != "finish":
            raise AssertionError(f"[tools] traced {label}: {sorted(have)}")
    traced = {n: h for n, h in _file_hashes(out).items()
              if not n.startswith(".cache/")}
    untraced = _file_hashes(small)
    if any(untraced.get(n) != h for n, h in traced.items()):
        raise AssertionError("[tools] the traced small pipeline's files "
                             "differ from [main]'s untraced run")
    tools_lint()
    log(f"[tools] subsample ({len(subsets) - 1} subsets, StdRng shuffle), "
        "table, gfa2fasta, clean --remove and --cache, helper flye (stub) "
        "and raven (missing: exit 1), and the small pipeline traced "
        f"({len(steps)} run dirs, each with {', '.join(RUN_FILES)}): "
        f"{time.perf_counter() - t0:.3f} s")


def make_plasmid_rich(root: Path) -> Path:
    """PLASMID_RICH's assemblies: every replicon rotated in each assembly,
    the plasmids reverse-complemented in alternate assemblies (as
    make_assemblies_fast does), SNPs in every copy."""
    from synthetic import mutate_fast, random_genome_fast, revcomp, rotate

    cfg = PLASMID_RICH
    rng = np.random.default_rng(cfg["seed"])
    lengths = (cfg["chromosome_len"],) + cfg["plasmid_lens"]
    replicons = [random_genome_fast(rng, n) for n in lengths]
    asm = root / "assemblies"
    asm.mkdir(parents=True)
    for i in range(cfg["n_assemblies"]):
        records = []
        for j, replicon in enumerate(replicons):
            seq = rotate(replicon, int(rng.integers(0, len(replicon))))
            if j and i % 2 == 1:
                seq = revcomp(seq)
            snps = max(1, round(len(seq) * cfg["snps_per_mbp"] / 1e6))
            seq = mutate_fast(rng, seq, snps)
            name = "chromosome" if j == 0 else f"plasmid_{j}"
            records.append(f">{name}_{i + 1}\n{seq}\n")
        (asm / f"assembly_{i + 1}.fasta").write_text("".join(records))
    return asm


def _tsv_partition(clustering: Path):
    """The (passing_clusters, all_clusters) column pair of every row."""
    lines = (clustering / "clustering.tsv").read_text().splitlines()
    header = lines[0].split("\t")
    cols = header.index("passing_clusters"), header.index("all_clusters")
    return [tuple(line.split("\t")[c] for c in cols) for line in lines[1:]]


@contextlib.contextmanager
def _recorded(module, name: str, keep):
    """Inside the block, each call of ``module.<name>`` appends
    ``keep(args, result)`` and the call's wall seconds to the yielded
    list."""
    calls = []
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        calls.append((keep(args, result), time.perf_counter() - t0))
        return result

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def phase_sketch(work: Path) -> None:
    """The plasmid-rich configuration (264 contigs): compress (287 M
    windows, so streamed), then cluster through the CLI with the default
    knob (auto, so
    sketch distances, hashed on the card) and with verify (which computes
    the exact distances too): 11 QC-pass clusters each time and the same
    partition. (The cluster with exact distances alone was cut in depth to
    pay for [doctor]: verify's exact product and [main]'s cluster run that
    path.) The
    sketch runs' sketching seconds, their grid's CUDA-event ms and verify's
    record are read from inside the CLI calls; each grid must equal
    sketch_intersections_host on its sketches, and 8 contigs' sketches on
    the card those on the CPU. Last, the auto cluster warm
    (:func:`warm_sketch_cluster`)."""
    from autocycler_tpu_torch.commands import cluster as cluster_mod
    from autocycler_tpu_torch.ops import sketch

    t0 = time.perf_counter()
    asm = make_plasmid_rich(work / "plasmid_rich")
    total = sum(len(line) for f in asm.iterdir()
                for line in f.read_text().splitlines()[1::2])
    log(f"[sketch] plasmid-rich inputs generated in "
        f"{time.perf_counter() - t0:.3f} s: {total} bp, {PLASMID_RICH}")
    out = work / "plasmid_rich_out"
    compressed = run_cli("plasmid-rich compress",
                         ["compress", "-i", asm, "-a", out, "--kmer", "51"],
                         "sketch")
    check_streamed("sketch", "plasmid-rich compress", compressed)
    partitions, runs = {}, {}
    saved = os.environ.pop("AUTOCYCLER_SKETCH_DISTANCE", None)
    try:
        with _recorded(sketch, "sketch_matrix", lambda a, r: None) as hashing, \
                _recorded(sketch, "sketch_from_codes",
                          lambda a, r: None) as contig_hashes, \
                _recorded(sketch, "sketch_intersections",
                          lambda a, r: (a[0], r)) as grids, \
                _recorded(cluster_mod, "compute_distances",
                          lambda a, r: r[1]) as records:
            for mode in ("auto", "verify"):
                if mode != "auto":
                    os.environ["AUTOCYCLER_SKETCH_DISTANCE"] = mode
                    # verify sketches cold: it reads none of the sketches
                    # the auto run stored, which [warm] reads
                    os.environ["AUTOCYCLER_ENCODE_CACHE"] = "0"
                runs[mode] = run_cli(f"plasmid-rich cluster, {mode}",
                                     ["cluster", "-a", out], "sketch")
                if mode == "auto":
                    auto_files = _file_hashes(out / "clustering")
                partitions[mode] = _tsv_partition(out / "clustering")
                passing = len(list((out / "clustering" / "qc_pass").iterdir()))
                grid = runs[mode]["dp"]["cluster_sketch_grid"]
                if passing != 11 or grid["dispatches"] != 1:
                    raise AssertionError(
                        f"[sketch] cluster {mode}: {passing} QC-pass clusters "
                        f"(expected 11), {grid['dispatches']} sketch grid "
                        "dispatches")
    finally:
        os.environ.pop("AUTOCYCLER_SKETCH_DISTANCE", None)
        os.environ.pop("AUTOCYCLER_ENCODE_CACHE", None)
        if saved is not None:
            os.environ["AUTOCYCLER_SKETCH_DISTANCE"] = saved
    if len(partitions["auto"]) != 264 or \
            partitions["auto"] != partitions["verify"]:
        raise AssertionError("[sketch] the sketch clustering's partition "
                             "differs from the exact distances'")
    log("[sketch] auto (sketch) and verify: 11 QC-pass clusters, "
        "the same partition of 264 contigs")

    (S, inter), _ = grids[0]
    t0 = time.perf_counter()
    want = sketch.sketch_intersections_host(S)
    plain_s = time.perf_counter() - t0
    err = max(int(np.abs(got - want).max()) for (_, got), _ in grids)
    if err != 0 or not all(np.array_equal(a, S) for (a, _), _ in grids):
        raise AssertionError("[sketch] the sketch grid on the card differs "
                             f"from sketch_intersections_host ({err} at most)")
    n, s = S.shape
    lookups = runs["auto"]["dp"]["cluster_sketch_grid"]["lookups"]
    # the grid's bound: its int64 rows read once and the counts written
    # once, against one comparison a lookup (a merge of two sorted rows
    # needs no fewer) at the CUDA cores' issue rate
    bound = {"bytes": 8 * (n * s + n * n) / HBM_BYTES_PER_S * 1e3,
             "operations": lookups / INT_OPS * 1e3}
    # what each path's cost follows: the host sketching the bases, the grid
    # the contigs, the exact distances the unitigs (set by the SNP rate)
    unitigs = next(int(line.split(":")[1]) for line in
                   (out / "input_assemblies.yaml").read_text().splitlines()
                   if line.startswith("compressed_unitig_count:"))
    log("[sketch] " + json.dumps({
        "contigs": n, "bp": total, "unitigs": unitigs, "s": s,
        "real_values": int((S != sketch.SENTINEL).sum()),
        "cluster_distances_s": {m: r["stages"]["cluster/distances"]
                                for m, r in runs.items()},
        "sketch_matrix_s": {m: secs for m, (_, secs)
                            in zip(("auto", "verify"), hashing)},
        "sketch_matrix_s_per_mbp": {
            m: secs / (total / 1e6)
            for m, (_, secs) in zip(("auto", "verify"), hashing)},
        # of which the hashing (k-mers, window minima, bottom s) on the
        # card, each call ending in a synchronising copy; the rest rebuilds
        # each contig from its graph path and encodes it on the host
        "sketch_from_codes_s": {
            m: sum(secs for _, secs in contig_hashes[i * n:(i + 1) * n])
            for i, m in enumerate(("auto", "verify"))},
        "grid": {"lookups": lookups,
                 "ms": {m: runs[m]["dp"]["cluster_sketch_grid"]["ms"]
                        for m in ("auto", "verify")},
                 "ms_median_of_3_with_copies": _time_ms(
                     lambda: sketch.sketch_intersections(S, "cuda")),
                 "bound_ms": max(bound.values()),
                 "bound_by": max(bound, key=bound.get),
                 "plain_host_s": plain_s, "max_abs_err": err},
        "verify_record": records[1][0],
        "hashing_bound": hashing_bound(total)}))
    log(f"[sketch] sketch_from_codes on the card: "
        f"{sum(secs for _, secs in contig_hashes[:n])} s for {n} contigs "
        "in auto")
    sketches_on_card_and_cpu(asm / "assembly_1.fasta")
    warm_sketch_cluster(out, n, auto_files, runs["auto"], hashing[0][1])


def hashing_bound(bases: int) -> dict:
    """The minimizer hashing's least time over ``bases`` bases
    (ops/sketch.py sketch_from_codes): 33 int64 operations a position
    (two rolling base-5 packs, 3 each; two splitmix64 finalisers, 9 each,
    and their 32-bit shifts; the canonical minimum; the dot mask, 3; a
    sliding window minimum, 3), 2 instructions each on 32-bit lanes, at
    the CUDA cores' issue rate; against both code strands read once."""
    ops_ms = 66 * bases / INT_OPS * 1e3
    bytes_ms = 2 * bases / HBM_BYTES_PER_S * 1e3
    return {"ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def medoid_dp_bound(record: dict) -> dict:
    """The medoid DP's least time for one dispatch (ops/align.py
    global_alignment_distance_batch): 10 int64 operations a cell (a
    compare, a max and a select for the mismatch, two adds and a min, the
    scan's subtract, min and add, the row's select), 2 instructions each
    on 32-bit lanes, at the CUDA cores' issue rate; against its int64
    inputs read once (both paths and their weights, the weights' prefix
    sums, both lengths) and its distances written once."""
    pairs, rows, cells = record["pairs"], record["rows"], record["cells"]
    cols = cells // max(pairs * rows, 1)
    ops_ms = 20 * cells / INT_OPS * 1e3
    bytes_ms = 8 * pairs * (2 * rows + 3 * cols + 4) / HBM_BYTES_PER_S * 1e3
    return {"pairs": pairs, "rows": rows, "cols": cols, "cells": cells,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def sketches_on_card_and_cpu(fasta: Path) -> None:
    """The first 8 contigs of one plasmid-rich assembly (its chromosome and
    seven plasmids) sketched on the card and on the CPU, at the default
    (k, w, s): the same sketches, exact."""
    from autocycler_tpu_torch.ops import encode, sketch

    k, w, s = sketch.sketch_params()
    lines = fasta.read_text().splitlines()
    n = 0
    for header, seq in list(zip(lines[0::2], lines[1::2]))[:8]:
        fwd, rc = encode.encode_both_strands(
            np.frombuffer(seq.encode(), np.uint8))
        got, want = (sketch.sketch_from_codes(
            torch.from_numpy(np.ascontiguousarray(fwd)).to(dev),
            torch.from_numpy(np.ascontiguousarray(rc)).to(dev), k, w, s)
            for dev in ("cuda", "cpu"))
        if got[1] != want[1] or not torch.equal(got[0].cpu(), want[0]):
            raise AssertionError(f"[sketch] {header}: the sketch on the card "
                                 "differs from the CPU's")
        n += 1
    log(f"[sketch] {n} contigs' sketches (k={k}, w={w}, s={s}) on the card "
        "equal the CPU's (exact)")


def phase_grid():
    """The match-grid throughput entry at its own sizes, with the launch
    counts set to 0 just before and read just after; then, at equal tiles
    on one input with matches, the three grids and the plain version must
    be equal."""
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.ops import dotplot_grid as g

    device.reset_counts()
    for kernel, tile, tile_b in (("vpu", 2048, 4096), ("mxu", 1024, 1024),
                                 ("mxu8", 1024, 1024)):
        best, rate = g.benchmark_gcells(n_a=GRID_N, n_b=GRID_N, k=GRID_K,
                                        tile=tile, tile_b=tile_b,
                                        kernel=kernel, device="cuda")
        log(f"[grid] {kernel} {GRID_N}x{GRID_N} k={GRID_K} tiles "
            f"{tile}x{tile_b}: best {best} s, {rate} Gcells/s")
    torch.cuda.synchronize()
    launches = dict(device.launches)
    log(f"[grid] launches {launches}")
    if not (launches["dotplot_match_grid"] and
            launches["dotplot_match_grid_mxu"]):
        raise AssertionError("[grid] a match-grid kernel was not launched")

    a, b = _shared_words(np.random.default_rng(21), GRID_N, GRID_N, GRID_K)
    want = g.match_grid_plain(a, b, 1024, 1024)
    grids = {"vpu": g.match_grid(a, b, 1024, 1024),
             "mxu": g.match_grid_mxu(a, b, GRID_K, tile=1024),
             "mxu8": g.match_grid_mxu(a, b, GRID_K, tile=1024,
                                      in_dtype="int8")}
    for name, grid in grids.items():
        if not torch.equal(grid, want):
            raise AssertionError(f"[grid] {name} differs from the plain "
                                 "version at 1024x1024 tiles")
    log(f"[grid] at 1024x1024 tiles vpu, mxu, mxu8 and the plain version "
        f"agree: {int(want.sum(dtype=torch.int64))} matching cells")
    return launches, (a, b)


def _time_ms(fn, reps: int = 3) -> float:
    fn()                                            # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _launch_ms(name: str, fn, reps: int = 3) -> float:
    """The median CUDA-event time of kernel `name`'s launch alone (the
    wrapper's events, device.kernel_ms) over `reps` calls of fn after a
    warm-up; resets the launch counts."""
    from autocycler_tpu_torch import device
    fn()
    times = []
    for _ in range(reps):
        device.reset_counts()
        fn()
        times.append(device.kernel_ms(name))
    device.reset_counts()
    return float(np.median(times))


def _ptxas_usage(kernel: str) -> dict:
    """ptxas's resource lines (registers, shared memory, spills) for each
    instantiation of `kernel`, from the nvcc log of csrc/match_grid.cu."""
    from autocycler_tpu_torch.ops import _build
    usage, current = {}, None
    for line in _build.log_path("match_grid").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = name if kernel in name else None
        elif current and ("Used" in line or "spill" in line):
            usage.setdefault(current, []).append(line.split(":", 1)[-1].strip())
    return usage


def _max_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


class _PassTimer:
    """The grouping kernels' C entry points with CUDA events around each
    pass, for a per-pass breakdown (ms summed by pass name)."""

    def __init__(self, kern):
        self.kern = kern
        self.ms = {}
        self.events = []

    def __getattr__(self, name):
        fn = getattr(self.kern, name)

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            self.events.append((name, start, end))
        return timed

    def summary(self) -> dict:
        torch.cuda.synchronize()
        for name, start, end in self.events:
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
        return self.ms


def sortnet_passes(codes, starts, k: int) -> dict:
    """One grouping through the kernels with each pass timed; the rest of
    the CUDA-event total is the torch bookkeeping and host syncs. Not a
    counted launch (it calls partition_rank, not the wrapper)."""
    from autocycler_tpu_torch.ops import sortnet

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        timer = _PassTimer(sortnet.CudaKernels(stream))
        start.record()
        sortnet.partition_rank(codes, starts, k, timer)
        end.record()
    passes = timer.summary()
    total = start.elapsed_time(end)
    return {"total_ms": total, **{f"{n}_ms": v for n, v in passes.items()},
            "bookkeeping_ms": total - sum(passes.values())}


def _time_sortnet_shape(label: str, codes, starts, k: int) -> dict:
    """The grouping at one shape of its path: the kernels, the plain version,
    the torch.sort LSD yardstick (one stable sort and gather per word, least
    significant first, from pre-packed words; one int64 sort at two words)
    and the bytes bound, with the first partition's statistics."""
    from autocycler_tpu_torch.ops import sortnet

    n = len(starts)
    got = sortnet.pack_rank_cuda(codes, starts, k)
    want = sortnet.pack_rank_plain(codes, starts, k)
    err = max(_max_err(a, b) for a, b in zip(got, want))
    del got, want
    lib_label, library = _sortnet_library(codes, starts, k)
    shape = {
        "shape": label, "k": k, "n": n, "codes": len(codes),
        "ms": _time_ms(lambda: sortnet.pack_rank_cuda(codes, starts, k)),
        "plain_ms": _time_ms(lambda: sortnet.pack_rank_plain(codes, starts, k)),
        "library_ms": _time_ms(library), "library": lib_label,
        "bound_ms": _sortnet_bound_ms(codes, starts, k),
        "max_abs_err": err,
        "partition": sortnet.partition_stats(codes, starts, k),
        "passes": sortnet_passes(codes, starts, k),
    }
    del library
    if k == 51:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sortnet.pack_rank_cuda(codes, starts, k)
        torch.cuda.synchronize()
        shape["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        shape["memory_allocated_before"] = before
    log(f"[timing] sortnet_pack_rank {json.dumps(shape)}")
    return shape


def _sortnet_library(codes, starts, k: int):
    """The grouping's PyTorch yardstick at one shape, from pre-packed
    words: one int64 torch.sort at two words, else one stable sort and
    gather per word, least significant first. Returns (label, call)."""
    from autocycler_tpu_torch.ops import sortnet

    words = sortnet.pack_words_plain(codes, starts, k)
    if len(words) == 2:
        key = words[0].long() * 5**13 + words[1].long()
        return "torch.sort(int64 key, stable=True), 1 call", \
            lambda: torch.sort(key, stable=True)

    def library():
        order = torch.arange(len(starts), device=codes.device)
        for w in reversed(words):
            _, perm = torch.sort(w[order], stable=True)
            order = order[perm]
    return f"torch.sort LSD, {len(words)} stable calls + gathers", library


def _sortnet_bound_ms(codes, starts, k: int) -> float:
    """Each input read once (the code bytes the windows cover, that is the
    union of their k-byte ranges, and the int32 starts), each output written
    once (int32 order and group ids), over the memory rate."""
    n = len(starts)
    if not n:
        return 0.0
    ordered = torch.sort(starts.long()).values
    covered = min(len(codes), int(torch.clamp(
        ordered[1:] - ordered[:-1], max=k).sum()) + k)
    return grouping_bytes(covered, n) / HBM_BYTES_PER_S * 1e3


def _once_ms(fn):
    """(fn(), its CUDA-event ms), one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _time_sortnet_bins(bins) -> dict:
    """Every bin of the streamed compress, one call each after a warm-up on
    the first: the kernels (the wrapper's call), the plain version and the
    yardstick, summed over the bins, with the bins' sizes."""
    from autocycler_tpu_torch.ops import sortnet

    sortnet.pack_rank_cuda(*bins[0])
    sortnet.pack_rank_plain(*bins[0])
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    err = 0
    for codes, starts, k in bins:
        got, ms = _once_ms(lambda: sortnet.pack_rank_cuda(codes, starts, k))
        want, plain_ms = _once_ms(
            lambda: sortnet.pack_rank_plain(codes, starts, k))
        err = max(err, *(_max_err(a, b) for a, b in zip(got, want)))
        del got, want
        lib_label, library = _sortnet_library(codes, starts, k)
        _, library_ms = _once_ms(library)
        del library
        for key, value in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", library_ms),
                           ("bound_ms", _sortnet_bound_ms(codes, starts, k))):
            sums[key] += value
    sizes = sorted(len(starts) for _, starts, _ in bins)
    shape = {"shape": f"compress stream bins k={bins[0][2]}",
             "bins": len(bins), "n_total": sum(sizes), "n_min": sizes[0],
             "n_median": sizes[len(sizes) // 2], "n_max": sizes[-1], **sums,
             "library": lib_label + " a bin", "max_abs_err": err}
    log(f"[timing] sortnet_pack_rank {json.dumps(shape)}")
    return shape


def timing_sortnet(compress_groupings, n_bins: int, in_memory,
                   dotplot_groupings):
    """Per streamed compress (the sums over its launches: end repair, the
    bins, the merge, the gram grouping), and per launch at the in-memory
    k=51 shape and the plasmid and chromosome dotplots' first pair."""
    repair, *bins, merge, gram = compress_groupings
    if len(bins) != n_bins:
        raise AssertionError(f"[timing] {len(bins)} bin groupings kept for "
                             f"{n_bins} bins")
    compress = [_time_sortnet_shape("compress end repair k=25", *repair),
                _time_sortnet_bins(bins),
                _time_sortnet_shape("compress stream merge k=51", *merge),
                _time_sortnet_shape("compress gram grouping k=50", *gram)]
    others = [_time_sortnet_shape("compress in memory k=51", *in_memory)]
    others += [_time_sortnet_shape(label, *inputs)
               for label, inputs in dotplot_groupings.items()]
    return {**{key: sum(s[key] for s in compress) for key in
               ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes",
            "max_abs_err": max(s["max_abs_err"] for s in compress + others),
            "shapes": compress + others}


def _grid_bytes_ms(a, b, ta, tb) -> float:
    """Each input word read once, each tile count written once."""
    ga, gb = -(-a.shape[1] // ta), -(-b.shape[1] // tb)
    return (4 * (a.numel() + b.numel()) + 4 * ga * gb) / HBM_BYTES_PER_S * 1e3


def timing_match_grid(shapes_in):
    """The word compare per launch. Its bound: W + 1 instructions per cell,
    the least a cell needs (W word compares chained through one predicate,
    then one predicated add), at the CUDA cores' issue rate, against the
    words read once and the counts written once. No one PyTorch call
    computes tile match counts of packed k-mers (an equality join with
    per-tile sums), so it has no library time."""
    from autocycler_tpu_torch.ops import dotplot_grid as g

    shapes = []
    for label, a, b, ta, tb in shapes_in:
        W, n_a, n_b = a.shape[0], a.shape[1], b.shape[1]
        got = g.match_grid_cuda(a, b, ta, tb)
        want = g.match_grid_plain(a, b, ta, tb)
        cells = float(n_a) * float(n_b)
        ops_ms = (W + 1) * cells / INT_OPS * 1e3
        bytes_ms = _grid_bytes_ms(a, b, ta, tb)
        shape = {
            "shape": label, "n_a": n_a, "n_b": n_b, "words": W,
            "tiles": f"{ta}x{tb}",
            "ms": _time_ms(lambda: g.match_grid_cuda(a, b, ta, tb)),
            "plain_ms": _time_ms(lambda: g.match_grid_plain(a, b, ta, tb), 1),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "max_abs_err": _max_err(got, want),
        }
        shape["gcells_per_s"] = cells / shape["ms"] / 1e6
        shapes.append(shape)
        log(f"[timing] dotplot_match_grid {json.dumps(shape)}")
    return {**{key: shapes[0][key] for key in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "shapes": shapes}


def timing_match_grid_mxu(a, b, k: int, tile: int):
    """The +-1 product per launch, bf16 and int8. Its bound: the product's
    4k operations per cell over the tensor cores' rate for the type, or the
    epilogue's 2 instructions per cell (compare with 2k, predicated add) at
    the CUDA cores' issue rate, whichever is larger, against the words read
    once. The library
    yardstick is the product alone, row-striped so that it fits: torch.matmul
    of the bf16 +-1 matrices and torch._int_mm of the int8 ones."""
    from autocycler_tpu_torch.ops import dotplot_grid as g

    n_a, n_b = a.shape[1], b.shape[1]
    cells = float(n_a) * float(n_b)
    epilogue_ms = 2 * cells / INT_OPS * 1e3
    shapes = []
    for dtype, peak in (("bfloat16", BF16_FLOPS), ("int8", INT8_OPS)):
        got = g.match_grid_mxu_cuda(a, b, k, tile, in_dtype=dtype)
        want = g.match_grid_mxu_plain(a, b, k, tile, in_dtype=dtype)
        product_ms = 4 * k * cells / peak * 1e3
        a_pm = g.expand_pm1_words(a, k, dtype=dtype)
        b_pm = g.expand_pm1_words(b, k, dtype=dtype)
        stripe = 8192 if dtype == "bfloat16" else 4096

        def library():
            for r0 in range(0, n_a, stripe):
                if dtype == "bfloat16":
                    torch.matmul(a_pm[r0:r0 + stripe], b_pm.T)
                else:
                    torch._int_mm(a_pm[r0:r0 + stripe], b_pm.T)
        library_ms = _time_ms(library)
        bound = {"operations": max(product_ms, epilogue_ms),
                 "bytes": _grid_bytes_ms(a, b, tile, tile)}
        shape = {
            "dtype": dtype, "n_a": n_a, "n_b": n_b, "k": k,
            "tiles": f"{tile}x{tile}",
            "ms": _time_ms(lambda: g.match_grid_mxu_cuda(
                a, b, k, tile, in_dtype=dtype)),
            "plain_ms": _time_ms(lambda: g.match_grid_mxu_plain(
                a, b, k, tile, in_dtype=dtype), 1),
            "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get),
            "product_ms": product_ms, "epilogue_ms": epilogue_ms,
            "library_ms": library_ms,
            "library": "product only: torch.matmul (bf16) / torch._int_mm "
                       f"(int8) in stripes of {stripe} rows",
            "max_abs_err": _max_err(got, want),
        }
        shape["gcells_per_s"] = cells / shape["ms"] / 1e6
        shape["kernel_ms"] = _launch_ms(g.KERNEL_PM1, lambda: (
            g.match_grid_mxu_cuda(a, b, k, tile, in_dtype=dtype)))
        shape["kernel_gcells_per_s"] = cells / shape["kernel_ms"] / 1e6
        row_bytes = g.pm1_depth(k, dtype) * g.IN_DTYPES[dtype].itemsize
        if k <= g.WGMMA_MAX_K:
            stages, smem = g.pm1_wgmma_shape(row_bytes)
            shape["kernel"] = {"name": "pm1_wgmma_kernel", "ring_stages": stages,
                               "dynamic_smem_bytes": smem,
                               "ptxas": _ptxas_usage("pm1_wgmma_kernel")}
        del a_pm, b_pm
        shapes.append(shape)
        log(f"[timing] dotplot_match_grid_mxu {json.dumps(shape)}")
    return {**{key: shapes[0][key] for key in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "shapes": shapes}


def phase_timing(paths, groupings, plasmid_pair, dotplot_groupings,
                 grid_words, batch_runs, radix_launches):
    """``groupings`` is (the streamed compress's groupings, its bin count,
    the in-memory k=51 grouping)."""
    a, b = grid_words
    timed = {
        "sortnet_pack_rank": (timing_sortnet(*groupings, dotplot_groupings),
                              "compress"),
        "dotplot_match_grid": (timing_match_grid([
            ("plasmid pair (dotplot --grid-mode device)", *plasmid_pair),
            (f"{GRID_N}^2 k={GRID_K} (benchmark_gcells vpu)", a, b, 2048,
             4096)]), "dotplot device"),
        "dotplot_match_grid_mxu": (timing_match_grid_mxu(a, b, GRID_K, 1024),
                                   "grid"),
    }
    rows = []
    for name, meta in KERNEL_SOURCES.items():
        numbers, path = timed[name]
        rows.append({"name": name, **meta,
                     "launches": paths[path][name], "path": path, **numbers})
    sortnet = next(r for r in rows if r["name"] == "sortnet_pack_rank")
    sortnet["batch_launches"] = {
        label: run["grouping_launches"] for label, run in batch_runs.items()}
    sortnet["radix_launches"] = radix_launches
    return rows


def serve_costs(work: Path) -> None:
    """``--serve-costs``: where a daemon job loses time against the CLI.
    The headline compress, warm from the daemon's shared .cache, as jobs
    of one ``ServeHandle(root, workers=2)`` (a sampler tick every 0.5 s,
    as in [serve]) with the device token on and off
    (``enable_device_token``) and the collector on and off
    (``gc.disable()`` around the job), each variant twice in the order
    ABCD DCBA; and through the CLI (the token off, the collector off, as
    the CLI runs compress) before and after them. Every run must write the
    cold job's GFA and YAML. Prints each run's wall, stage and substage
    seconds and token wait, then each variant's walls."""
    import gc

    from synthetic import make_assemblies_fast

    from autocycler_tpu_torch.serve.client import request_json, wait_for_job
    from autocycler_tpu_torch.serve.server import ServeHandle, warm_process
    from autocycler_tpu_torch.utils import cache, timing

    asm = make_assemblies_fast(work / "headline", **HEADLINE)
    root = work / "serve"
    warm_process(root)
    os.environ["AUTOCYCLER_TIMESERIES_INTERVAL_S"] = SERVE_TICK_S
    daemon_log = io.StringIO()
    handle = None
    runs = []

    def job(label: str, token: bool, collector: bool) -> dict:
        timing.enable_device_token(token)
        waited = timing.token_wait_seconds()
        if not collector:
            gc.disable()
        try:
            status, record = request_json(
                handle.endpoint, "POST", "/jobs",
                body={"assemblies_dir": str(asm), "command": "compress",
                      "kmer": 51, "threads": 8})
            if status != 202:
                raise AssertionError(f"[serve-costs] POST /jobs {status}: "
                                     f"{record}")
            record = wait_for_job(handle.endpoint, record["id"], poll_s=0.2,
                                  timeout=SERVE_JOB_TIMEOUT_S)
        finally:
            gc.enable()
        if record["state"] != "done":
            raise AssertionError(f"[serve-costs] {label}: {record}")
        summary = {"run": label, "token": token, "collector": collector,
                   **_job_summary(record),
                   "token_wait_s": timing.token_wait_seconds() - waited,
                   "out": Path(record["out_dir"])}
        runs.append(summary)
        return summary

    def cli_run(label: str) -> dict:
        timing.enable_device_token(False)
        out = work / label.replace(" ", "_")
        run = run_cli(label, ["compress", "-i", asm, "-a", out, "--kmer",
                              "51"], "serve-costs")
        summary = {"run": label, "token": False, "collector": False,
                   "wall_s": run["wall_s"], "stages_s": run["stages"],
                   "substages_s": run["substages"], "out": out}
        runs.append(summary)
        return summary

    variants = {"A": (True, True), "B": (False, True), "C": (True, False),
                "D": (False, False)}
    try:
        with contextlib.redirect_stderr(daemon_log):
            handle = ServeHandle(root, port=0, workers=SERVE_WORKERS).start()
            cold = job("cold", True, True)
            cli_run("CLI warm 1")
            for name in "ABCDDCBA":
                job(name, *variants[name])
            cli_run("CLI warm 2")
    except BaseException:
        log(f"[serve-costs] the daemon's log, last 6000 characters:\n"
            f"{daemon_log.getvalue()[-6000:]}")
        raise
    finally:
        if handle is not None:
            handle.stop()
        os.environ.pop("AUTOCYCLER_TIMESERIES_INTERVAL_S")
        cache.set_shared_cache_dir(None)
        timing.enable_device_token(False)
    for run in runs:
        for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
            if (run["out"] / name).read_bytes() != \
                    (cold["out"] / name).read_bytes():
                raise AssertionError(f"[serve-costs] {run['run']}: {name} "
                                     "differs from the cold job's")
        log("[serve-costs] " + json.dumps(
            {k: v for k, v in run.items() if k != "out"}))
    walls = {f"{name}: token {'on' if t else 'off'}, collector "
             f"{'on' if c else 'off'}": [r["wall_s"] for r in runs
                                         if r["run"] == name]
             for name, (t, c) in variants.items()}
    walls["CLI (token off, collector off)"] = [
        r["wall_s"] for r in runs if r["run"].startswith("CLI")]
    log("[serve-costs] warm headline compress walls (s), the same GFA and "
        "YAML in every run: " + json.dumps(walls))


def serve_costs_main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import autocycler_tpu_torch  # noqa: F401 — fails outside the repo
    sys.path.insert(0, str(REPO / "tests"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    with tempfile.TemporaryDirectory() as td, _phase("serve-costs"):
        serve_costs(Path(td))
    return 0


# [doctor]: the probe's deadline against the wedged stub, and the stub: a
# child that starts a helper in its session, says so on stderr and sleeps
DOCTOR_DEADLINE_S = 3.0
WEDGED_CHILD = """\
import os, subprocess, sys, time
helper = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
sys.stderr.write("probe stub: cuInit stalls (pid %d, helper %d)\\n"
                 % (os.getpid(), helper.pid))
sys.stderr.flush()
time.sleep(120)
"""
# a fresh process that swaps the probe child for WEDGED_CHILD, runs one CLI
# command and says whether it touched CUDA
FRESH_CLI = """\
import json, sys, time
import torch
from autocycler_tpu_torch import cli
from autocycler_tpu_torch.obs import sentinel
sentinel._probe_argv = lambda: [sys.executable, "-c", sys.argv[1]]
calls = []
for name in ("is_available", "init", "_lazy_init", "get_device_name",
             "get_device_properties", "device_count", "set_device"):
    real = getattr(torch.cuda, name)
    setattr(torch.cuda, name, lambda *a, _n=name, _r=real, **kw: (
        calls.append(_n), _r(*a, **kw))[1])
t0 = time.perf_counter()
rc = cli.main(sys.argv[2:])
print("RESULT " + json.dumps({"rc": rc, "seconds": time.perf_counter() - t0,
                              "cuda_calls": calls,
                              "initialized": torch.cuda.is_initialized()}))
"""


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie waiting for its reaper does not)."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().split()[2]
    except OSError:
        return False
    return state != "Z"


def _fresh_cli(argv, env: dict) -> tuple:
    """``argv`` through the CLI in a fresh process whose probe child is the
    wedged stub: (its RESULT record, its stderr)."""
    proc = subprocess.run(
        [sys.executable, "-c", FRESH_CLI, WEDGED_CHILD, *map(str, argv)],
        cwd=REPO, env={**os.environ, **env}, capture_output=True, text=True,
        timeout=120)
    line = next((x for x in proc.stdout.splitlines()
                 if x.startswith("RESULT ")), None)
    if proc.returncode != 0 or line is None:
        raise AssertionError(f"[doctor] {argv[0]} in a fresh process: exit "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(line[len("RESULT "):]), proc.stderr


def _doctor_json(run_dir: Path, *flags) -> dict:
    """``doctor --json`` (and ``flags``) in a process of its own."""
    proc = subprocess.run(
        [sys.executable, "-m", "autocycler_tpu_torch", "doctor", "--json",
         "-d", str(run_dir), *flags], cwd=REPO, capture_output=True,
        text=True, timeout=180)
    if proc.returncode != 0:
        raise AssertionError(f"[doctor] doctor {flags} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def _kernel_events(path: Path) -> list:
    """The CUDA kernels' names in a Chrome trace (raises if it does not
    parse)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def doctor_live_probe(work: Path) -> None:
    """`doctor --probe --json`: one live probe of the card, kind ok."""
    report = _doctor_json(work / "live", "--probe")
    last = report["probe_log"]["entries"][-1]
    if not last.get("attached") or last.get("kind") != "ok" \
            or last.get("name") != torch.cuda.get_device_name(0) \
            or last.get("capability") != [9, 0]:
        raise AssertionError(f"[doctor] live probe: {json.dumps(last)}")
    log(f"[doctor] doctor --probe --json: attached, kind ok, "
        f"{last['name']}, capability {last['capability']}, "
        f"{last['total_memory']} B, the driver's CUDA "
        f"{last['cuda_version']} (torch's {last['torch_cuda']}), "
        f"{last['device_count']} card(s), {last['seconds']} s from the "
        f"child's start; actions {report['actions']}")


def doctor_wedged_probe(work: Path, small_asm: Path) -> Path:
    """The wedged stub: killed at the deadline with its helper, its stderr
    kept; a fresh-process compress ends with Error: and exit 1 without a
    CUDA call and persists the negative; the next ends in under a second
    from it; doctor shows it fresh. Returns the negative cache's dir."""
    from autocycler_tpu_torch.obs import sentinel

    real_argv = sentinel._probe_argv
    sentinel._probe_argv = lambda: [sys.executable, "-c", WEDGED_CHILD]
    try:
        outcome = sentinel.subprocess_probe(DOCTOR_DEADLINE_S)
    finally:
        sentinel._probe_argv = real_argv
    tail = outcome.get("stderr_tail", "")
    pids = [int(x) for x in re.findall(r"(?:pid|helper) (\d+)", tail)]
    time.sleep(0.5)
    if outcome["kind"] != "timeout" or "cuInit stalls" not in tail \
            or len(pids) != 2 or any(_alive(pid) for pid in pids):
        raise AssertionError(f"[doctor] wedged probe: {json.dumps(outcome)}")
    log(f"[doctor] wedged probe: kind timeout after {outcome['seconds']} s "
        f"(deadline {DOCTOR_DEADLINE_S} s), the child and its helper "
        f"{pids} killed with their session, stderr tail kept: "
        f"{tail.strip()!r}")

    out = work / "wedged"
    env = {"AUTOCYCLER_PROBE_DEADLINE_S": str(DOCTOR_DEADLINE_S),
           "AUTOCYCLER_PROBE_RETRIES": "0"}
    argv = ["compress", "-i", small_asm, "-a", out]
    first, err = _fresh_cli(argv, env)
    cache = out / ".cache"
    if first["rc"] != 1 or first["cuda_calls"] or first["initialized"] \
            or "Error: the device probe failed (timeout)" not in err \
            or "autocycler doctor" not in err \
            or not (cache / "device_probe.json").is_file():
        raise AssertionError(f"[doctor] wedged compress: {json.dumps(first)}"
                             f"\n{err[-2000:]}")
    error_line = next(x for x in err.splitlines() if x.startswith("Error:"))
    second, err2 = _fresh_cli(argv, env)
    if second["rc"] != 1 or second["seconds"] >= 1.0 \
            or "persisted negative probe" not in err2 \
            or second["cuda_calls"] or second["initialized"]:
        raise AssertionError(f"[doctor] second compress: "
                             f"{json.dumps(second)}\n{err2[-2000:]}")
    report = _doctor_json(cache)
    neg = report["negative_cache"]
    if not neg.get("fresh") or neg.get("kind") != "timeout":
        raise AssertionError(f"[doctor] doctor --json: {json.dumps(neg)}")
    log(f"[doctor] a fresh-process compress against the wedged stub: exit 1 "
        f"in {first['seconds']} s with no CUDA call ({error_line!r}); "
        f"device_probe.json written; the next process: exit 1 in "
        f"{second['seconds']} s from it ('persisted negative probe'); "
        f"doctor --json: negative cache fresh, age {neg['age_s']} s of "
        f"{neg['ttl_s']} s; actions {report['actions']}")
    return cache


def doctor_recovery(work: Path, cache: Path) -> None:
    """The wedged outcome through this process's gate, then a healthy
    probe: the false -> true transition deletes the negative cache, counts
    one recovery and runs the recovery capture on the card."""
    from autocycler_tpu_torch import device
    from autocycler_tpu_torch.obs import metrics_registry, sentinel
    from autocycler_tpu_torch.ops import dotplot_grid, sortnet
    from autocycler_tpu_torch.utils import AutocyclerError

    sentinel._reset_for_tests()
    device._probe_reset()
    # the gate probes (and logs the wedged outcome) only without a fresh
    # negative to adopt: it writes the one the recovery must delete
    (cache / "device_probe.json").unlink()
    device.set_probe_cache_dir(cache)
    sentinel.set_probe_log_dir(work / "recovery")
    real_argv = sentinel._probe_argv
    env = {"AUTOCYCLER_PROBE_DEADLINE_S": str(DOCTOR_DEADLINE_S),
           "AUTOCYCLER_PROBE_RETRIES": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    sentinel._probe_argv = lambda: [sys.executable, "-c", WEDGED_CHILD]
    try:
        device.resolve_device(None)
        raise AssertionError("[doctor] the gate passed a wedged probe")
    except AutocyclerError as e:
        refused = str(e)
        wedged_cache = (cache / "device_probe.json").is_file()
    finally:
        sentinel._probe_argv = real_argv
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sentinel.on_recovery(sentinel.recovery_capture)
    reg = metrics_registry.registry()
    recoveries = reg.value("autocycler_probe_recoveries_total")
    names = (sortnet.KERNEL, dotplot_grid.KERNEL_WORDS)
    before = {n: device.launches[n] for n in names}
    entry = sentinel.ProbeWatcher(interval=1.0).cycle()
    capture = json.loads((work / "recovery" /
                          "recovery_capture.json").read_text())
    launched = {n: device.launches[n] - before[n] for n in names}
    dot, grp = capture["dotplot"], capture["grouping"]
    if not entry.get("attached") or not wedged_cache \
            or (cache / "device_probe.json").exists() \
            or reg.value("autocycler_probe_recoveries_total") != \
            recoveries + 1 \
            or "gcells_per_s" not in dot or not grp.get("kernel_exact") \
            or launched != {sortnet.KERNEL: grp["launches"],
                            dotplot_grid.KERNEL_WORDS: dot["launches"]} \
            or not all(launched.values()):
        raise AssertionError(f"[doctor] recovery: {json.dumps(entry)}, "
                             f"capture {json.dumps(capture)}, launched "
                             f"{launched}")
    sentinel.set_probe_log_dir(None)
    sentinel.clear_recovery_hooks()
    device._probe_reset()                # the gate again, as a process
    device.resolve_device(None)          # starts: through a fresh probe
    if device.probe_report()["kind"] != "ok":
        raise AssertionError(f"[doctor] the gate after the recovery: "
                             f"{device.probe_report()}")
    log(f"[doctor] the gate refused the wedged probe ({refused!r}); a "
        f"healthy probe then gave false -> true: negative cache deleted, "
        f"autocycler_probe_recoveries_total {recoveries} -> "
        f"{recoveries + 1}, recovery capture in {capture['seconds']} s: "
        f"word compare {dot['grid']} k={dot['k']} {dot['gcells_per_s']} "
        f"Gcells/s, {dot['tops']} T instructions/s, {dot['pct_peak']} % of "
        f"the 33.5e12 peak; grouping {grp['windows']} windows k={grp['k']} "
        f"kernel_s {grp['kernel_s']}, plain_s {grp['plain_s']} (CPU "
        f"tensors), kernel_exact {grp['kernel_exact']}; launches "
        f"{launched}")


def doctor_probe_cost(work: Path, cluster_dir: Path) -> dict:
    """One fresh-process CLI trim and resolve of a copy of ``cluster_dir``,
    traced: the probe's resolve, wait and overlap seconds (the ledger's
    caches.probe) beside the command's wall."""
    c = work / "cluster"
    shutil.copytree(cluster_dir, c)
    costs = {}
    for cmd in ("trim", "resolve"):
        run_dir = work / f"tel_{cmd}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "autocycler_tpu_torch", cmd, "-c", str(c)],
            cwd=REPO, env={**os.environ, "AUTOCYCLER_TRACE_DIR": str(run_dir)},
            capture_output=True, text=True, timeout=600)
        process_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[doctor] fresh-process {cmd}: exit "
                                 f"{proc.returncode}\n{proc.stderr[-2000:]}")
        probe = json.loads((run_dir / "ledger.json").read_text())[
            "caches"]["probe"]
        overlap, last = probe["overlap"], probe.get("last", {})
        finish = next(r for r in _trace_records(run_dir)
                      if r.get("type") == "finish")
        if overlap["state"] != "attached" or overlap["kind"] != "ok":
            raise AssertionError(f"[doctor] {cmd}'s probe: "
                                 f"{json.dumps(probe)}")
        costs[cmd] = {"run_wall_s": finish["wall"], "process_s": process_s,
                      **{k: overlap[k] for k in (
                          "resolve_s", "wait_s", "overlap_saved_s",
                          "attempts", "deadline_s")},
                      "child_s": last.get("seconds")}
    log(f"[doctor] the probe's cost in a fresh-process trim and resolve of "
        f"{cluster_dir.name} (traced): {json.dumps(costs)}")
    return costs


def doctor_rates() -> None:
    """ops.mfu.kernel_rates of [main]'s traced compress and its cluster:
    each declared dispatch's share of its peak, between 0 and 100 %."""
    for label in ("compress", "cluster"):
        rates = KERNEL_RATES[("main", label)]
        declared = {n: r for n, r in rates.items() if "pct_peak" in r}
        if not declared or not all(0 < r["pct_peak"] <= 100
                                   for r in declared.values()):
            raise AssertionError(f"[doctor] {label} rates: "
                                 f"{json.dumps(rates)}")
        log(f"[doctor] [main] {label}: kernel_rates of the declared "
            f"dispatches (a lower bound: CUDA events span host gaps): "
            f"{json.dumps(declared)}")


def _fresh_compress(asm: Path, out: Path, env: dict) -> float:
    """compress ``asm`` into ``out`` through the CLI in a process of its
    own with ``env`` set; returns its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "autocycler_tpu_torch", "compress", "-i",
         str(asm), "-a", str(out)], cwd=REPO, env={**os.environ, **env},
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"[doctor] compress with {env}: exit "
                             f"{proc.returncode}\n{proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def doctor_profiler_knobs(work: Path, small_asm: Path, walls) -> None:
    """A small compress under AUTOCYCLER_PROFILE_DIR, another under
    AUTOCYCLER_XPROF (traced), each in a fresh process: in a process that
    has run for minutes, torch.profiler's captures lose kernel events (a
    capture of the adjacency's 11 launches held none after 200 s of
    work). Every stage trace and capture parses, the stages and captures
    that ran kernels hold CUDA kernel events, the grouping's captures name
    the sortnet kernels, each span's xprof link exists, and the grouping's
    3 launches give the limit's 2 captures."""
    from autocycler_tpu_torch.ops import sortnet

    stages, xdir, run_dir = work / "profile", work / "xprof", work / "tel_xprof"
    traces = {p.parent.relative_to(stages).as_posix(): _kernel_events(p)
              for p in sorted(stages.rglob("*.json"))}
    for stage in ("compress/load_and_repair", "compress/build_graph"):
        if not traces.get(stage):
            raise AssertionError(f"[doctor] stage trace {stage}: no kernel "
                                 f"events ({sorted(traces)})")
    captures = {p.name: _kernel_events(p) for p in sorted(xdir.iterdir())}
    spans = [r for r in _trace_records(run_dir) if r.get("type") == "span"]
    launches = sum(r.get("name") == sortnet.KERNEL for r in spans)
    links = [r["attrs"]["xprof"] for r in spans
             if "xprof" in r.get("attrs", {})]
    grouping = [n for n in captures if n.startswith(sortnet.KERNEL)]
    sortnet_names = ("hist0_kernel", "scatter0_kernel", "sort_reg_kernel",
                     "sort_generic_kernel", "boundary_kernel")
    own = {k for n in grouping for e in captures[n] for k in sortnet_names
           if k in e}
    if launches <= 2 \
            or sorted(grouping) != [f"{sortnet.KERNEL}-0.json",
                                    f"{sortnet.KERNEL}-1.json"] \
            or not all(captures.values()) or not own \
            or sorted(Path(x).name for x in links) != sorted(captures) \
            or not all(Path(x).is_file() for x in links):
        raise AssertionError(f"[doctor] AUTOCYCLER_XPROF: {launches} "
                             f"grouping launches, captures "
                             f"{ {n: len(e) for n, e in captures.items()} }, "
                             f"links {links}")
    log(f"[doctor] AUTOCYCLER_PROFILE_DIR: "
        f"{ {s: len(e) for s, e in traces.items()} } kernel events by "
        f"stage trace; AUTOCYCLER_XPROF: "
        f"{ {n: len(e) for n, e in captures.items()} } kernel events by "
        f"capture ({launches} grouping launches, 2 captured), every span's "
        f"xprof link a file; the grouping's own kernels captured: "
        f"{sorted(own)}; walls (s, fresh processes beside the live and "
        f"wedged probes) "
        f"{json.dumps(walls)}")


def phase_doctor(work: Path, cluster_dir: Path, small_asm: Path) -> dict:
    """[doctor]: the device forensics on the card (see the module's
    docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # the profiler knobs' two fresh compresses run beside the live and
    # wedged probes; the probe's cost below is read with nothing beside it
    with ThreadPoolExecutor(2) as pool:
        knobs = _knob_compresses(work, small_asm, pool)
        doctor_live_probe(work)
        cache = doctor_wedged_probe(work, small_asm)
        walls = {k: f.result() for k, f in knobs.items()}
    doctor_recovery(work, cache)
    costs = doctor_probe_cost(work, cluster_dir)
    doctor_rates()
    doctor_profiler_knobs(work, small_asm, walls)
    log(f"[doctor] {time.perf_counter() - t0:.1f} s")
    return costs


def _knob_compresses(work: Path, small_asm: Path, pool) -> dict:
    """The two compresses of :func:`doctor_profiler_knobs`, started at once
    on ``pool``: {knob: future of its wall seconds}."""
    return {"AUTOCYCLER_PROFILE_DIR": pool.submit(
                _fresh_compress, small_asm, work / "p1",
                {"AUTOCYCLER_PROFILE_DIR": str(work / "profile")}),
            "AUTOCYCLER_XPROF": pool.submit(
                _fresh_compress, small_asm, work / "p2",
                {"AUTOCYCLER_XPROF": str(work / "xprof"),
                 "AUTOCYCLER_TRACE_DIR": str(work / "tel_xprof")})}


def doctor_main() -> int:
    """``--doctor``: [build], then the small input through compress and
    cluster on the card (for [doctor]'s rates and cluster), then [doctor]."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "tests"))
    from synthetic import make_assemblies

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    with _phase("build"):
        phase_build()
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        asm = make_assemblies(work / "small", n_assemblies=4,
                              chromosome_len=30_000, plasmid_len=4_000,
                              n_snps=10, seed=3)
        run_cli("compress", ["compress", "-i", asm, "-a", work / "out"])
        run_cli("cluster", ["cluster", "-a", work / "out"])
        with _phase("doctor"):
            phase_doctor(work / "doctor", min(
                (work / "out" / "clustering" / "qc_pass").iterdir(),
                key=_cluster_median), asm)
    return 0


def radix_main() -> int:
    """``--radix``: [build], [kernels], the headline compress in memory
    (as [stream] runs it), [radix] and the lint of [tools]."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "tests"))
    from synthetic import make_assemblies_fast

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    with _phase("build"):
        phase_build()
    with _phase("kernels"):
        phase_kernels()
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        asm = make_assemblies_fast(work / "headline", **HEADLINE)
        os.environ["AUTOCYCLER_STREAM_KMERS"] = "off"
        try:
            run_cli("headline compress, in memory",
                    ["compress", "-i", asm, "-a", work / "in_memory",
                     "--kmer", "51"], "stream")
        finally:
            os.environ.pop("AUTOCYCLER_STREAM_KMERS")
        with _phase("radix"):
            phase_radix(work)
    with _phase("tools"):
        tools_lint()
    return 0


PIPELINE_ORDER = ("parent", "change", "change", "parent")


def _cli_pipeline(tree: Path, asm: Path, out: Path) -> list:
    """The headline through ``tree``'s CLI one process a step, as a user
    runs it: compress, cluster, trim and resolve of each QC-pass cluster,
    combine. Returns [(step, process wall seconds)]."""
    env = {**os.environ, "PYTHONPATH": str(tree)}
    steps = []

    def step(name: str, *argv) -> None:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "autocycler_tpu_torch", *map(str, argv)],
            cwd=tree, env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[pipeline] {tree.name} {name}: exit "
                                 f"{proc.returncode}\n{proc.stderr[-2000:]}")
        steps.append((name, wall))

    step("compress", "compress", "-i", asm, "-a", out)
    step("cluster", "cluster", "-a", out)
    clusters = sorted((out / "clustering" / "qc_pass").iterdir())
    for c in clusters:
        step(f"trim {c.name}", "trim", "-c", c)
        step(f"resolve {c.name}", "resolve", "-c", c)
    step("combine", "combine", "-a", out, "-i",
         *[c / "5_final.gfa" for c in clusters])
    return steps


def pipeline_costs(parent: Path) -> None:
    """The device probe's cost where users pay it: the headline through the
    CLI one process a step (:func:`_cli_pipeline`), from the checkout at
    ``parent`` (a tree without the probe) and from this one, in the order
    parent, change, change, parent, each tree's kernels built first. Each
    run's consensus must equal the others'; each step's process wall and
    the sum are printed."""
    sys.path.insert(0, str(REPO / "tests"))
    from synthetic import make_assemblies_fast

    trees = {"parent": parent.resolve(), "change": REPO}
    for label, tree in trees.items():
        subprocess.run([sys.executable, "-c", "from autocycler_tpu_torch.ops "
                        "import _build; _build.build()"], cwd=tree,
                       env={**os.environ, "PYTHONPATH": str(tree)},
                       check=True, timeout=600)
    with tempfile.TemporaryDirectory() as td:
        asm = make_assemblies_fast(Path(td) / "headline", **HEADLINE)
        sums, consensus = {}, set()
        for i, label in enumerate(PIPELINE_ORDER):
            out = Path(td) / f"out{i}"
            steps = _cli_pipeline(trees[label], asm, out)
            total = sum(wall for _, wall in steps)
            sums.setdefault(label, []).append(total)
            consensus.add((out / "consensus_assembly.fasta").read_bytes())
            log(f"[pipeline] {label} (run {i + 1}): {total} s in "
                f"{len(steps)} processes: {json.dumps(dict(steps))}")
    if len(consensus) != 1:
        raise AssertionError("[pipeline] the consensus differs between runs")
    log(f"[pipeline] sums (s) {json.dumps(sums)}; the same consensus in "
        "every run")


def pipeline_costs_main() -> int:
    """``--pipeline-costs DIR``: :func:`pipeline_costs` against DIR."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    with _phase("pipeline"):
        pipeline_costs(Path(sys.argv[2]))
    return 0


@contextlib.contextmanager
def _phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import autocycler_tpu_torch  # noqa: F401 — fails outside the repo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    with _phase("build"):
        phase_build()
    with _phase("kernels"):
        phase_kernels()
    with tempfile.TemporaryDirectory() as td:
        with _phase("main"):
            paths, compressed, plasmid_pair, dotplot_groupings = phase_main(
                Path(td))
        with _phase("doctor"):
            phase_doctor(Path(td) / "doctor", min(
                (Path(td) / "out" / "clustering" / "qc_pass").iterdir(),
                key=_cluster_median), Path(td) / "small" / "assemblies")
        with _phase("batch"):
            batch_runs = phase_batch(Path(td))
        with _phase("chaos"):
            phase_chaos(Path(td))
        with _phase("serve"):
            phase_serve(Path(td), compressed)
        with _phase("warm"):
            phase_warm(Path(td), compressed)
        with _phase("tools"):
            phase_tools(Path(td))
        with _phase("handoff"):
            compress_groupings, n_bins = phase_handoff(Path(td))
        with _phase("stream"):
            in_memory = phase_stream(Path(td), compressed)
        with _phase("radix"):
            radix_launches = phase_radix(Path(td))
        with _phase("sketch"):
            phase_sketch(Path(td))
    with _phase("grid"):
        paths["grid"], grid_words = phase_grid()
    with _phase("timing"):
        rows = phase_timing(paths, (compress_groupings, n_bins, in_memory),
                            plasmid_pair, dotplot_groupings, grid_words,
                            batch_runs, radix_launches)
    if any(r["max_abs_err"] != 0 for r in rows):
        raise AssertionError("[timing] a kernel disagrees with its plain "
                             "version at the main path's shapes")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--serve-costs": serve_costs_main,
              "--doctor": doctor_main,
              "--pipeline-costs": pipeline_costs_main,
              "--radix": radix_main}.get(
                  " ".join(sys.argv[1:2]), main)())
