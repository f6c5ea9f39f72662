"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
             pairs; cut to its first 8 contigs, 64 pairs, from a FASTA)
             in auto mode, and trim, resolve and combine: a
             consensus of 2 circular records equal to the generator's
             replicons up to rotation and strand. Then the overlap
             configuration, the first 12 of the headline's assemblies
             with each contig's first
             2-20 kb (chromosome) or 0.5-5 kb (plasmid) appended to its
             end, through compress, cluster, trim (whose overlap DP must
             run on the card and cut every contig back to its replicon's
             length), resolve and combine (the same consensus); its
             chromosome trim runs once more under the profiler. Each
             path's kernels must have been launched in it. Two small
             inputs (start-end overlaps; a hairpin at both ends) also go
             through compress, cluster, dotplot, trim, resolve and combine
             on the card and on the CPU (the kernels' plain versions),
             which must write the same bytes. The headline compress is
             cold and writes the JAX package's tree, its .cache holding 24
             parse entries and the repair entry.
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
   warm    — the headline compress once more through the CLI into a fresh
             directory, AUTOCYCLER_CACHE_DIR at [main]'s .cache and
             AUTOCYCLER_TRACE_DIR set: [main]'s GFA and YAML, 24 parse hits,
             1 repair hit, no miss, no end-repair grouping, no degrade; the
             ledger's sha256s equal the inputs' and outputs', its QC the
             GFA's unitig count, length and N50, its stage spans the stage
             timers (5 %), and the top-level span carries the device bytes;
             the warm compress's device peak must be below the cold one's.
             (At the end of [sketch], its auto cluster once more: every
             sketch from the cache, the cold run's files.)
   tools   — the small input's host commands through the CLI: subsample
             (StdRng shuffle), table, gfa2fasta, clean --remove and
             --cache, helper flye with a stub on PATH and helper raven
             without one (exit 1); then the small pipeline traced, one run
             dir a command, each with its five files.
   handoff — the headline again in one process on the card, stages
             handing their graphs over in memory (cluster(collect_handoff=
             True), trim and resolve with preloaded=...), the collector off:
             every file must equal the CLI run's; each stage's wall, stage
             and substage seconds and the counters are printed.
   stream  — the headline compress once more through the CLI with
             AUTOCYCLER_STREAM_KMERS=off (the in-memory grouping): its GFA
             and YAML must equal [main]'s; both runs' walls,
             compress/build_graph and peak device memory. Then each
             compress (streamed, in memory) once more in a fresh process,
             the same GFA and YAML, for its wall, peak host RSS
             (VmRSS sampled every 10 ms) and peak device memory.
   sketch  — the plasmid-rich configuration (24 assemblies of a 5.3 Mbp
             chromosome and ten plasmids of 2.5-250 kb, 264 contigs, seed
             13): compress (streamed, and once more in memory: the same
             files), then cluster with the default knob (sketch
             distances, hashed on the card), with verify and with exact
             distances (verify with the cache off, so that it sketches
             cold), 11 QC-pass clusters and one partition in all three;
             then the sketch intersection grid on the card against its
             host version, and 8 contigs' sketches on the card against the
             CPU's, exact.
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
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12                # H100 SXM tensor cores, dense (data sheet)
INT8_OPS = 1979e12
# Instructions on the CUDA cores: 128 lanes per SM a clock (4 schedulers x 32
# lanes), x 132 SMs x 1.98 GHz boost = 33.5e12/s, the data sheet's float32
# rate (67 TFLOP/s) counted as one instruction per FMA. No integer or logic
# instruction issues faster.
INT_OPS = 132 * 128 * 1.98e9
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
# chromosome-cluster dotplot the first 8 of its 24 contigs (64 pairs).
OVERLAP_ASSEMBLIES = 12
CHROMOSOME_DOTPLOT_CONTIGS = 8
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
            spill.reset_counters()
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
    profile_compress(asm, work / "out_profiled", out)
    paths, plasmid_pair, dotplot_groupings = cluster_and_dotplot(work, out)
    replicons = headline_replicons()
    runs = trim_resolve_combine("headline", out, replicons)
    if not sum(r["dp"]["resolve_medoid_dp"]["dispatches"] for r in runs):
        raise AssertionError("[main] headline resolve never dispatched its "
                             "medoid DP")
    overlap_configuration(work, replicons)
    return ({"compress": launches, **paths}, compressed, plasmid_pair,
            dotplot_groupings)


def compress_cold(asm: Path, out: Path) -> dict:
    """The headline compress through the CLI into a fresh directory, cold:
    it must stream, and leave the JAX package's tree, its .cache holding
    the 24 parse entries and the repair entry. Also records what it pays to
    key and fill the cache: seconds summed over the loader threads that
    hash and store at once."""
    from autocycler_tpu_torch.commands import compress as compress_mod
    from autocycler_tpu_torch.utils import cache

    with _recorded(compress_mod, "content_hash", lambda a, r: None) as hashes, \
            _recorded(cache.EncodeCache, "store_parsed",
                      lambda a, r: None) as parse_stores, \
            _recorded(cache.EncodeCache, "store_repair_ends",
                      lambda a, r: None) as repair_stores:
        compressed = run_cli("compress", ["compress", "-i", asm, "-a", out,
                                          "--kmer", "51"])
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


def run_cli(label: str, argv, phase: str = "main", expect_rc: int = 0) -> dict:
    """One CLI call with every launch count, DP record, spill counter,
    degrade record and timer set to 0 just before it and read just after.
    An exit code other than ``expect_rc``, or a degrade recorded in the
    call, fails it. Returns its launches, DP
    dispatches, stage and substage seconds, wall seconds, the streamed
    grouping's record (empty when it grouped in memory), and its peak
    device memory above what was held before it; for a compress, also
    compress/build_graph's own peak device memory."""
    from autocycler_tpu_torch import cli, device
    from autocycler_tpu_torch.commands import compress
    from autocycler_tpu_torch.stream import spill
    from autocycler_tpu_torch.utils import resilience, timing

    device.reset_counts()
    spill.reset_counters()
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
    log(f"[{phase}] {label}: wall {wall} s, launches {launches}, kernel time "
        f"(ms, CUDA events) {json.dumps(kernel_ms)}, stages (s) "
        f"{json.dumps(stages)}, substages (s) "
        f"{json.dumps(substages)}{dp_text}, memory {json.dumps(peaks)}")
    return {"launches": launches, "dp": dps, "stages": stages,
            "substages": substages, "wall_s": wall, "stream": dict(spill.last_run),
            **peaks}


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
    profile_cli("plasmid cluster dotplot, --grid-mode device",
                ["dotplot", "-i", plasmid, "-o", work / "profiled.png",
                 "--grid-mode", "device"])
    if (work / "profiled.png").read_bytes() != pngs["device"].read_bytes():
        raise AssertionError("[profile] the profiled dotplot differs")

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof, contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[profile] {label} exited {rc}")
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    busy_s = sum(by_name.values()) / 1e6
    if busy_s == 0:
        log(f"[profile] {label}: device busy time not measured (no device "
            "events)")
        return
    log(f"[profile] {label}: wall {wall} s under the profiler, device busy "
        f"{busy_s} s (kernels + copies), idle share {1 - busy_s / wall}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        log(f"[profile]   {us / 1e6} s  {name[:100]}")


def profile_compress(asm: Path, out: Path, expected: Path) -> None:
    """The profiled compress must write the same bytes as the counted one."""
    profile_cli("compress", ["compress", "-i", asm, "-a", out, "--kmer", "51"])
    if not _same_files(out, expected):
        raise AssertionError("[profile] profiled compress differs from the "
                             "counted one")


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
    spill.reset_counters()
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
    -> combine, on [main]'s inputs into a fresh directory. Then, on a copy
    of its compressed graph, the same stages in one process reading and
    writing the files between them as the CLI does, so that the hand-over's
    gain stands apart from that of running in one process with the
    collector off. Every file either writes must equal the CLI run's in
    [main]. The compress streams, as in [main]; every grouping it launches
    is kept for [timing] and returned."""
    from autocycler_tpu_torch.commands.cluster import cluster
    from autocycler_tpu_torch.commands.combine import combine
    from autocycler_tpu_torch.commands.compress import compress
    from autocycler_tpu_torch.commands.resolve import resolve
    from autocycler_tpu_torch.commands.trim import trim

    asm, out = work / "headline" / "assemblies", work / "handoff"
    files = work / "handoff_files"

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

    def from_files(steps):
        _pipeline_step(steps, "cluster", cluster, files)
        clusters = sorted((files / "clustering" / "qc_pass").iterdir())
        for c in clusters:
            _pipeline_step(steps, "trim", trim, c)
            _pipeline_step(steps, "resolve", resolve, c)
        _pipeline_step(steps, "combine", combine, files,
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
    files.mkdir()
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        shutil.copyfile(out / name, files / name)
    _in_process("files", from_files)
    if not _same_files(work / "out", files):
        raise AssertionError("[handoff] the in-process file flow's files "
                             "differ from the CLI run's in [main]")
    log("[handoff] the hand-over and the in-process file flow write every "
        "file the CLI run in [main] does, byte for byte")
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
        int(os.environ.get("AUTOCYCLER_FLEET_BUCKETS", "4")))
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


# One CLI call in a fresh process: the resident set after torch's import
# and the CUDA context, then the call's wall, the process's peak resident
# set (VmRSS sampled every 10 ms: a peak shorter than that can be missed)
# and its peak device memory, as JSON into argv[1]. Neither VmHWM nor
# getrusage's ru_maxrss serves everywhere: some kernels give no VmHWM, and
# an ru_maxrss that is not the process's own.
_PEAK_CHILD = r"""
import json, sys, threading, time
import torch
from autocycler_tpu_torch import cli

def rss():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024

torch.zeros(1, device="cuda")
torch.cuda.synchronize()
before = sampled = rss()
stop = threading.Event()

def sample():
    global sampled
    while not stop.wait(0.01):
        sampled = max(sampled, rss())

sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
t0 = time.perf_counter()
rc = cli.main(sys.argv[2:])
torch.cuda.synchronize()
wall = time.perf_counter() - t0
stop.set()
sampler.join()
with open(sys.argv[1], "w") as f:
    json.dump({"rc": rc, "wall_s": wall, "host_rss_bytes_before": before,
               "peak_host_rss_bytes": max(sampled, rss()),
               "peak_device_bytes": torch.cuda.max_memory_allocated()}, f)
"""


def compress_fresh_process(label: str, asm: Path, out: Path, mode: str,
                        expected: Path) -> dict:
    """The headline compress with AUTOCYCLER_STREAM_KMERS=``mode`` in a
    fresh process, so that its host peak is its own: the process's peak
    resident set against its resident set once torch and the CUDA context
    are up. Its
    GFA and YAML must equal those in ``expected``."""
    result = out.parent / f"{out.name}.json"
    env = {**os.environ, "AUTOCYCLER_STREAM_KMERS": mode,
           "PYTHONPATH": os.pathsep.join(
               [str(REPO), os.environ.get("PYTHONPATH", "")])}
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, "-c", _PEAK_CHILD, str(result), "compress", "-i",
         str(asm), "-a", str(out), "--kmer", "51"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"[stream] {label} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    run = json.loads(result.read_text())
    if run["rc"] != 0:
        raise RuntimeError(f"[stream] {label}: compress returned {run['rc']}"
                           f":\n{proc.stderr[-3000:]}")
    if (out / ".stream").exists() != (mode == "auto"):
        raise AssertionError(f"[stream] {label}: the grouping path is not "
                             f"AUTOCYCLER_STREAM_KMERS={mode}'s")
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        if (out / name).read_bytes() != (expected / name).read_bytes():
            raise AssertionError(f"[stream] {label}: {name} differs from "
                                 "[main]'s")
    run["peak_host_rss_above_start_bytes"] = \
        run["peak_host_rss_bytes"] - run["host_rss_bytes_before"]
    return run


def phase_stream(work: Path, streamed: dict):
    """The headline compress once more through the CLI, grouping in memory
    (AUTOCYCLER_STREAM_KMERS=off): its GFA and YAML must equal [main]'s
    streamed run's. Logs both runs' walls, compress/build_graph and peak
    device memory; then each compress once more in a fresh process
    (streamed, in memory), for its peak host RSS. Returns the in-memory
    k=51 grouping's inputs, for [timing]."""
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
    fresh = {label: compress_fresh_process(f"headline compress, {label}, fresh "
                                        "process", asm,
                                        work / f"fresh_{label}", mode,
                                        work / "out")
             for label, mode in (("streamed", "auto"), ("in_memory", "off"))}
    log("[stream] headline compress in a fresh process each, the same GFA "
        "and YAML: " + json.dumps(fresh))
    return k51[0]


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
    windows, so streamed; once more in memory, which must write the same
    files), then cluster through the CLI with the default knob (auto, so
    sketch distances, hashed on the card), with verify, and with exact
    distances: 11 QC-pass clusters each time and the same partition. The
    sketch runs' sketching seconds, their grid's CUDA-event ms and verify's
    record are read from inside the CLI calls; each grid must equal
    sketch_intersections_host on its sketches, and 8 contigs' sketches on
    the card those on the CPU."""
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
    in_memory = work / "plasmid_rich_in_memory"
    os.environ["AUTOCYCLER_STREAM_KMERS"] = "off"
    try:
        run_cli("plasmid-rich compress, in memory",
                ["compress", "-i", asm, "-a", in_memory, "--kmer", "51"],
                "sketch")
    finally:
        os.environ.pop("AUTOCYCLER_STREAM_KMERS")
    if not _same_files(out, in_memory):
        raise AssertionError("[sketch] the streamed plasmid-rich compress "
                             "differs from the in-memory one")
    log("[sketch] streamed and in-memory plasmid-rich compress: the same "
        "files, byte for byte")
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
            for mode in ("auto", "verify", "exact"):
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
                if passing != 11 or grid["dispatches"] != (mode != "exact"):
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
            not partitions["auto"] == partitions["verify"] == partitions["exact"]:
        raise AssertionError("[sketch] the sketch clustering's partition "
                             "differs from the exact distances'")
    log("[sketch] auto (sketch), verify and exact: 11 QC-pass clusters, "
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
        "verify_record": records[1][0]}))
    log(f"[sketch] sketch_from_codes on the card: "
        f"{sum(secs for _, secs in contig_hashes[:n])} s for {n} contigs "
        "in auto")
    sketches_on_card_and_cpu(asm / "assembly_1.fasta")
    warm_sketch_cluster(out, n, auto_files, runs["auto"], hashing[0][1])


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
    return (covered + 4 * n + 8 * n) / HBM_BYTES_PER_S * 1e3


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
                 grid_words, batch_runs):
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
    return rows


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
        with _phase("batch"):
            batch_runs = phase_batch(Path(td))
        with _phase("warm"):
            phase_warm(Path(td), compressed)
        with _phase("tools"):
            phase_tools(Path(td))
        with _phase("handoff"):
            compress_groupings, n_bins = phase_handoff(Path(td))
        with _phase("stream"):
            in_memory = phase_stream(Path(td), compressed)
        with _phase("sketch"):
            phase_sketch(Path(td))
    with _phase("grid"):
        paths["grid"], grid_words = phase_grid()
    with _phase("timing"):
        rows = phase_timing(paths, (compress_groupings, n_bins, in_memory),
                            plasmid_pair, dotplot_groupings, grid_words,
                            batch_runs)
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
    sys.exit(main())
