"""`autocycler batch`: many isolates through compress, one batched exact
distance contraction, cluster, one batched trim DP, resolve and combine,
with per-isolate fault isolation and resume.

Parity target: the JAX package's commands/batch.py, file for file. Given
a directory of isolate subdirectories (each a normal ``--assemblies_dir``),
it compresses every isolate to its unitig graph (streaming the k-mer
grouping where compress would), computes ALL isolates' exact all-vs-all
contig intersection matrices in one contraction over the device mesh
(parallel.batch.batched_membership_intersections: isolates on 'data', the
unitig axis on 'seq', float64 ``torch.bmm``), runs the full `cluster`
stage of each isolate from them, decodes every isolate's first-round trim
DPs in one sharded traceback (parallel.batch.sharded_overlap_tracebacks),
and then trims, resolves and combines each isolate.

The device is resolved once, before any isolate is touched: without CUDA
the command fails with ``Error: ...``. The per-isolate quarantine catches
only AutocyclerError and OSError, so a CUDA error stops the run.

Fault isolation (utils.resilience): a malformed isolate (corrupt FASTA,
too many contigs, an unreadable cluster GFA) is quarantined, recorded in
``<out_parent>/batch_manifest.json`` (the JAX package's schema: status,
stage, error, attempts, per-stage output sha256s) and skipped; the batch
completes the rest. The exit status is 2 on a partial failure, and
``--resume`` replays only failed or pending isolates, re-entering each at
its last verified stage checkpoint.

Fleet mode (``--fleet`` / ``AUTOCYCLER_FLEET_MODE``, parallel/fleet.py):
isolates are packed into size-bucketed shards of the device count; each
shard's contraction is one dispatch with the isolate axis split over the
devices, padded up a power-of-two shape ladder, and the host loads of
upcoming isolates run ahead on the shared pool. Per-isolate outputs are
the serial sweep's byte for byte. The ``mid-fleet-shard`` crash point sits
between a shard's durable compress checkpoints and its cluster stage.
"""

from __future__ import annotations

import gc
import os
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from ..device import resolve_device, start_probe
from ..metrics import InputAssemblyMetrics
from ..models import UnitigGraph
from ..models.simplify import simplify_structure
from ..obs import ledger, trace
from ..obs import qc as obs_qc
from ..ops.align import overlap_may_be_positive
from ..ops.distance import intersections_to_distances, membership_matrix
from ..ops.graph_build import build_unitig_graph
from ..parallel import fleet as fleet_mod
from ..parallel.batch import (batched_membership_intersections,
                              sharded_overlap_tracebacks)
from ..parallel.mesh import make_mesh
from ..stream import prepare_stream_root
from ..utils import AutocyclerError, check_threads, log, quit_with_error
from ..utils.cache import open_cache
from ..utils.knobs import knob_int
from ..utils.pool import prefetch_iter
from ..utils.resilience import RunManifest, collect_errors, crash_point
from ..utils.timing import stage_timer
from .cluster import cluster as run_cluster
from .combine import combine
from .compress import load_sequences
from .resolve import resolve
from .trim import overlap_jobs, trim

MANIFEST_NAME = "batch_manifest.json"


class IsolateJob(NamedTuple):
    """One isolate of a (fleet) batch: where its assemblies live and where
    its outputs go."""
    name: str
    asm_dir: Path
    out_dir: Path


def find_isolate_dirs(parent) -> List[Path]:
    parent = Path(parent)
    if not parent.is_dir():
        quit_with_error(f"directory does not exist: {parent}")
    isolates = sorted(d for d in parent.iterdir() if d.is_dir())
    if not isolates:
        quit_with_error(f"no isolate subdirectories found in {parent}")
    return isolates


def batch_mesh(device):
    """The mesh of a batch on ``device``: every CUDA device for a CUDA run
    without an index, else that one device."""
    if device.type == "cuda" and device.index is None:
        return make_mesh()
    return make_mesh(devices=[device])


def _cluster_outputs(out_dir: Path) -> List[Path]:
    clustering = out_dir / "clustering"
    return [clustering / "pairwise_distances.phylip",
            clustering / "clustering.newick",
            clustering / "clustering.tsv",
            clustering / "clustering.yaml"] \
        + sorted(clustering.glob("qc_*/cluster_*/1_untrimmed.gfa"))


def _load_isolate(asm_dir, out_dir: Path, k_size: int, max_contigs: int,
                  threads: int, device):
    """The load side of one isolate's compress: load + parse + end repair
    (on ``device``). Shared by the serial loop and the fleet prefetch lane,
    so both paths produce identical sequences by construction. The
    warm-start cache lives under the isolate's out dir, so a --resume (or
    repeat) run skips load and repair for unchanged inputs."""
    sequences, _ = load_sequences(asm_dir, k_size, InputAssemblyMetrics(),
                                  max_contigs, threads,
                                  cache=open_cache(out_dir), device=device)
    return sequences


def _build_isolate(out_dir: Path, sequences, k_size: int, threads: int,
                   device):
    """Build + simplify + persist one isolate's unitig graph (the device
    side of compress). Must run one isolate at a time: the stream spill
    root is process-global state, and lives under the isolate's out dir."""
    prepare_stream_root(out_dir)
    graph = build_unitig_graph(sequences, k_size, device=device,
                               threads=threads)
    simplify_structure(graph, sequences)
    os.makedirs(out_dir, exist_ok=True)
    graph.save_gfa(out_dir / "input_assemblies.gfa", sequences)
    obs_qc.compress_qc(graph, sequences)
    ledger.record_stage(
        "compress", outputs=[out_dir / "input_assemblies.gfa"])
    return graph


def _screen_and_finalise(jobs: List[IsolateJob], mesh, errs, manifest,
                         completed: List[str], device) -> None:
    """The first-round trim DPs of every clustered isolate in one sharded
    traceback, then trim/resolve/combine of each isolate under quarantine.
    Serial batch calls this once over the whole run; fleet mode calls it
    per shard — per-isolate outputs are identical either way because every
    DP job's decoded pieces depend only on that job."""
    iso_cluster_dirs = {}
    graphs = {}
    with stage_timer("batch/trim_screen"):
        for job in jobs:
            qc_pass = job.out_dir / "clustering" / "qc_pass"
            dirs = sorted(d for d in qc_pass.iterdir() if d.is_dir()) \
                if qc_pass.is_dir() else []
            # per-isolate graph loading is quarantined too: one unreadable
            # cluster GFA must not sink the whole batched screen
            with errs.quarantine(job.name):
                for cdir in dirs:
                    graphs[cdir] = UnitigGraph.from_gfa_file(
                        cdir / "1_untrimmed.gfa")
            if errs.failed(job.name):
                manifest.fail(job.name, str(errs.errors[job.name].cause),
                              stage="trim")
                for cdir in dirs:
                    graphs.pop(cdir, None)
            else:
                iso_cluster_dirs[job.name] = dirs
        cluster_dirs = [d for dirs in iso_cluster_dirs.values()
                        for d in dirs]
        screens, n_decoded = _batched_trim_screens(cluster_dirs, graphs, mesh)
    n_all = sum(len(s) for s in screens.values())
    log.message(f"{n_all} trim DPs screened; {n_decoded} alignments decoded "
                "from the device traceback")
    log.message()

    with stage_timer("batch/finalise"):
        for job in jobs:
            if job.name not in iso_cluster_dirs:
                continue
            with trace.span(f"isolate/{job.name}", cat="isolate",
                            stage="finalise"), obs_qc.scope(job.name), \
                    errs.quarantine(job.name):
                for cdir in iso_cluster_dirs[job.name]:
                    trimmed = trim(cdir, alignments=screens[cdir],
                                   preloaded=graphs.pop(cdir), device=device)
                    resolve(cdir, preloaded=trimmed, device=device)
                    del trimmed   # reference-cyclic; drop before collecting
                    gc.collect()
                qc_pass = job.out_dir / "clustering" / "qc_pass"
                finals = sorted(qc_pass.glob("cluster_*/5_final.gfa")) \
                    if qc_pass.is_dir() else []
                if finals:
                    combine(job.out_dir, finals)
            if errs.failed(job.name):
                manifest.fail(job.name, str(errs.errors[job.name].cause),
                              stage="finalise")
            else:
                manifest.stage_done(
                    job.name, "finalise",
                    outputs=[job.out_dir / "consensus_assembly.gfa",
                             job.out_dir / "consensus_assembly.fasta"])
                manifest.done(job.name)
                completed.append(job.name)


def _summarise(completed: List[str], errs, manifest_path: Path,
               out_parent: Path, n_todo: int) -> int:
    log.section_header("Finished!")
    n_failed = len(errs)
    log.message(f"{len(completed)} isolate(s) complete, {n_failed} failed "
                f"(statuses recorded in {manifest_path})")
    if n_failed:
        for name in sorted(errs.errors):
            log.message(f"  FAILED {name}: {errs.errors[name].cause}")
        log.message("Re-run with --resume to retry only the failed isolates.")
    log.message(f"Per-isolate outputs: {out_parent}/<isolate>/clustering/ "
                f"+ consensus_assembly.gfa/.fasta")
    log.message()
    if not completed:
        raise AutocyclerError(
            f"all {n_todo} isolate(s) failed; see {manifest_path}")
    return 2 if n_failed else 0


def _resume_sets(manifest: RunManifest, names: List[str]):
    """(cluster-verified, compress-verified) isolate names: an interrupted
    isolate re-enters at its last checkpoint whose every recorded output
    re-hashes clean."""
    resume_cluster, resume_compress = set(), set()
    for name in names:
        if manifest.stage_complete(name, "cluster"):
            resume_cluster.add(name)
        elif manifest.stage_complete(name, "compress"):
            resume_compress.add(name)
    return resume_cluster, resume_compress


def batch(assemblies_parent, out_parent, k_size: int = 51,
          max_contigs: int = 25, resume: bool = False,
          threads: int = 1, fleet: Optional[str] = None,
          device=None) -> int:
    """Compress every isolate and emit per-isolate clustering from one
    batched distance contraction, then trim, resolve and combine each.
    The device work runs on ``device`` (CUDA unless the caller asks for
    the CPU; a CUDA run without an index uses every card). Per-isolate
    failures are quarantined into the run manifest; returns the process
    exit code (0 = all complete, 2 = partial failure; all-failed raises).
    ``threads`` reaches the load, end repair and k-mer grouping of every
    isolate's compress. ``fleet`` overrides the ``AUTOCYCLER_FLEET_MODE``
    knob ('off'/'on'/'auto'); when engaged the run goes through the fleet
    runner, with byte-identical per-isolate outputs."""
    if k_size < 11 or k_size > 501 or k_size % 2 == 0:
        quit_with_error("--kmer must be an odd number between 11 and 501")
    check_threads(threads)
    start_probe(Path(out_parent) / ".cache", device)
    dev = resolve_device(device)
    mode = fleet_mod.resolve_fleet_mode(fleet)
    log.section_header("Starting autocycler batch")
    log.explanation("Each isolate subdirectory is compressed into a unitig graph; the "
                    "exact all-vs-all contig distance matrices of ALL isolates are then "
                    "computed in a single sharded device step and clustered per isolate. "
                    "A malformed isolate is quarantined and recorded in the run "
                    "manifest; the batch completes the rest.")
    isolates = find_isolate_dirs(assemblies_parent)
    out_parent = Path(out_parent)
    os.makedirs(out_parent, exist_ok=True)
    manifest_path = out_parent / MANIFEST_NAME
    manifest = RunManifest.load(manifest_path) if resume \
        else RunManifest(manifest_path)

    todo = []
    for iso in isolates:
        if resume and manifest.status(iso.name) == "done":
            log.message(f"{iso.name}: already complete — skipped (--resume)")
            continue
        manifest.pending(iso.name)
        todo.append(iso)
    if not todo:
        log.message("All isolates already complete; nothing to do")
        return 0
    errs = collect_errors()
    resume_cluster, resume_compress = _resume_sets(
        manifest, [iso.name for iso in todo]) if resume else (set(), set())

    if fleet_mod.fleet_engaged(mode, len(todo), dev):
        jobs = [IsolateJob(iso.name, iso, out_parent / iso.name)
                for iso in todo]
        return _fleet_batch(jobs, out_parent, k_size, max_contigs, threads,
                            manifest, manifest_path, resume_cluster,
                            resume_compress, errs, dev)
    if mode != "off":
        log.message(f"Fleet mode {mode!r} not engaged for {len(todo)} "
                    "isolate(s) — running the serial path")

    # ---- per-isolate compress (quarantined) ----
    compressed = []   # (iso, (sequences, ids), M, w)
    with stage_timer("batch/compress"):
        for iso in todo:
            manifest.start(iso.name)
            out_dir = out_parent / iso.name
            if iso.name in resume_cluster:
                log.message(f"{iso.name}: compress + cluster checkpoints "
                            "verified — resuming at trim (--resume)")
                ledger.record_stage(
                    "compress", outputs=[out_dir / "input_assemblies.gfa"],
                    skipped=True)
                ledger.record_stage(
                    "cluster", outputs=_cluster_outputs(out_dir),
                    skipped=True)
                continue
            with trace.span(f"isolate/{iso.name}", cat="isolate",
                            stage="compress"), obs_qc.scope(iso.name), \
                    errs.quarantine(iso.name):
                if iso.name in resume_compress:
                    log.message(f"{iso.name}: compress checkpoint verified "
                                "— reloading unitig graph (--resume)")
                    graph, sequences = UnitigGraph.from_gfa_file(
                        out_dir / "input_assemblies.gfa")
                    ledger.record_stage(
                        "compress",
                        outputs=[out_dir / "input_assemblies.gfa"],
                        skipped=True)
                else:
                    log.message(f"Compressing isolate {iso.name}")
                    sequences = _load_isolate(iso, out_dir, k_size,
                                              max_contigs, threads, dev)
                    graph = _build_isolate(out_dir, sequences, k_size,
                                           threads, dev)
                M, w, ids = membership_matrix(graph, sequences)
                compressed.append((iso, (sequences, ids), M, w))
                del graph
                # the CLI disables the cycle collector; each isolate's graph
                # is reference-cyclic, so reclaim it explicitly or RSS grows
                # by one full graph per isolate
                gc.collect()
            if errs.failed(iso.name):
                manifest.fail(iso.name, str(errs.errors[iso.name].cause),
                              stage="compress")
            else:
                manifest.stage_done(
                    iso.name, "compress",
                    outputs=[out_dir / "input_assemblies.gfa"])
    log.message()
    if not compressed and not resume_cluster:
        raise AutocyclerError(
            f"all {len(todo)} isolate(s) failed during compress; "
            f"see {manifest_path}")

    log.section_header("Batched distance step")
    log.explanation("Isolates ride the mesh 'data' axis; the unitig axis is split over "
                    "'seq' and contracted as a float64 product whose partial sums are "
                    "added, so every isolate's matrix is exactly the single-isolate "
                    "computation.")
    with stage_timer("batch/distances"):
        mesh = batch_mesh(dev)
        inters = batched_membership_intersections(
            mesh, [c[2] for c in compressed], [c[3] for c in compressed])

    # ---- per-isolate clustering (quarantined) ----
    clustered = [iso for iso in todo if iso.name in resume_cluster]
    with stage_timer("batch/cluster"):
        for (iso, (sequences, ids), _, _), inter in zip(compressed, inters):
            with trace.span(f"isolate/{iso.name}", cat="isolate",
                            stage="cluster"), obs_qc.scope(iso.name), \
                    errs.quarantine(iso.name):
                distances = intersections_to_distances(inter, ids)
                run_cluster(out_parent / iso.name, max_contigs=max_contigs,
                            device=dev, precomputed_distances=distances)
                log.message(f"{iso.name}: {len(sequences)} contigs clustered")
                clustered.append(iso)
            if errs.failed(iso.name):
                manifest.fail(iso.name, str(errs.errors[iso.name].cause),
                              stage="cluster")
            else:
                manifest.stage_done(iso.name, "cluster",
                                    outputs=_cluster_outputs(
                                        out_parent / iso.name))
    clustered.sort(key=lambda p: p.name)

    log.section_header("Batched trim screen")
    log.explanation("Every isolate's first-round trim overlap DPs (start-end and both "
                    "hairpin passes for every sequence of every QC-pass cluster) pass "
                    "the exact host screen, and the rest are decoded from one sharded "
                    "device traceback, so the final graphs are bitwise identical to "
                    "sequential trim.")
    completed: List[str] = []
    _screen_and_finalise(
        [IsolateJob(iso.name, iso, out_parent / iso.name)
         for iso in clustered],
        mesh, errs, manifest, completed, dev)
    return _summarise(completed, errs, manifest_path, out_parent, len(todo))


# ---------------------------------------------------------------------------
# Fleet mode (parallel/fleet.py planning + bucketed device shapes)
# ---------------------------------------------------------------------------

def _fleet_batch(jobs: List[IsolateJob], out_parent: Path, k_size: int,
                 max_contigs: int, threads: int, manifest: RunManifest,
                 manifest_path: Path, resume_cluster: set,
                 resume_compress: set, errs, device) -> int:
    """The fleet runner: size-bucketed shards, one contraction per shard
    with the isolate axis split over the devices, prefetched host loads,
    stage-granular + fleet-granular resume. Byte-identical to the serial
    sweep per isolate."""
    by_name = {j.name: j for j in jobs}
    resume_jobs = [j for j in jobs if j.name in resume_cluster]
    fleet_jobs = [j for j in jobs if j.name not in resume_cluster]
    n_dev = fleet_mod.fleet_devices(device)
    plan = fleet_mod.plan_fleet(
        {j.name: fleet_mod.isolate_cost(j.asm_dir) for j in fleet_jobs},
        shard_size=n_dev,
        n_buckets=knob_int("AUTOCYCLER_FLEET_BUCKETS"))
    log.section_header("Fleet plan")
    log.explanation("Isolates are packed into size-bucketed shards; each shard's exact "
                    "membership contraction is ONE device dispatch with the isolate "
                    "axis split over the devices (padded up a power-of-two shape "
                    "ladder), and the host load of upcoming isolates runs ahead on "
                    "the shared pool, overlapping the current shard's device work.")
    log.message(f"{len(fleet_jobs)} isolate(s) in {len(plan.shards)} "
                f"shard(s) of up to {plan.shard_size} "
                f"({plan.n_buckets} size bucket(s), {n_dev} device(s))")
    log.message()

    prefetch = knob_int("AUTOCYCLER_FLEET_PREFETCH")
    depth = max(1, int(prefetch)) * plan.shard_size
    order = [by_name[name] for sh in plan.shards for name in sh.names]

    def _load_job(job: IsolateJob):
        """One isolate's host load, run ahead on the shared pool while the
        current shard owns the device. Failures are returned as values and
        re-raised under the consumer's quarantine, so one corrupt isolate
        cannot kill the prefetch lane for the isolates behind it."""
        try:
            with trace.span(f"isolate/{job.name}", cat="isolate",
                            stage="load"), obs_qc.scope(job.name):
                if job.name in resume_compress:
                    graph, sequences = UnitigGraph.from_gfa_file(
                        job.out_dir / "input_assemblies.gfa")
                    ledger.record_stage(
                        "compress",
                        outputs=[job.out_dir / "input_assemblies.gfa"],
                        skipped=True)
                    return ("graph", graph, sequences)
                sequences = _load_isolate(job.asm_dir, job.out_dir, k_size,
                                          max_contigs, threads, device)
                return ("seqs", sequences, None)
        except Exception as e:  # noqa: BLE001 — re-raised at consume time
            return ("err", e, None)

    # the lane is wider than the prefetch depth so a load task that fans
    # its own parse subtasks across the shared executor always leaves
    # >= threads free workers — no nested-submission starvation
    loads = prefetch_iter(_load_job, order, workers=threads + depth,
                          depth=depth)
    mesh = batch_mesh(device)
    completed: List[str] = []
    any_compressed = bool(resume_jobs)
    for shard in plan.shards:
        with trace.span(f"fleet/shard-{shard.index:03d}", cat="fleet",
                        bucket=shard.bucket, isolates=len(shard.names)):
            compressed = []   # (job, (sequences, ids), M, w)
            with stage_timer("batch/compress"):
                for name in shard.names:
                    job = by_name[name]
                    manifest.start(job.name)
                    loaded = next(loads)
                    with trace.span(f"isolate/{job.name}", cat="isolate",
                                    stage="compress"), \
                            obs_qc.scope(job.name), \
                            errs.quarantine(job.name):
                        if loaded[0] == "err":
                            raise loaded[1]
                        if loaded[0] == "graph":
                            log.message(
                                f"{job.name}: compress checkpoint verified "
                                "— reloading unitig graph (--resume)")
                            graph, sequences = loaded[1], loaded[2]
                        else:
                            log.message(f"Compressing isolate {job.name}")
                            sequences = loaded[1]
                            graph = _build_isolate(job.out_dir, sequences,
                                                   k_size, threads, device)
                        M, w, ids = membership_matrix(graph, sequences)
                        compressed.append((job, (sequences, ids), M, w))
                        del graph
                        gc.collect()
                    if errs.failed(job.name):
                        manifest.fail(job.name,
                                      str(errs.errors[job.name].cause),
                                      stage="compress")
                    else:
                        manifest.stage_done(
                            job.name, "compress",
                            outputs=[job.out_dir / "input_assemblies.gfa"])
            with stage_timer("batch/distances"):
                inters = fleet_mod.fleet_membership_intersections(
                    [c[2] for c in compressed],
                    [c[3] for c in compressed],
                    devices=n_dev, device=device)
            # the registered preemption boundary: every isolate of this
            # shard has a durable compress checkpoint, nothing after has
            # run — a kill here must resume into reload + re-cluster
            crash_point("mid-fleet-shard", f"shard-{shard.index:03d}")
            shard_clustered: List[IsolateJob] = []
            with stage_timer("batch/cluster"):
                for (job, (sequences, ids), _, _), inter \
                        in zip(compressed, inters):
                    with trace.span(f"isolate/{job.name}", cat="isolate",
                                    stage="cluster"), \
                            obs_qc.scope(job.name), \
                            errs.quarantine(job.name):
                        distances = intersections_to_distances(inter, ids)
                        run_cluster(job.out_dir, max_contigs=max_contigs,
                                    device=device,
                                    precomputed_distances=distances)
                        log.message(f"{job.name}: {len(sequences)} contigs "
                                    "clustered")
                        shard_clustered.append(job)
                    if errs.failed(job.name):
                        manifest.fail(job.name,
                                      str(errs.errors[job.name].cause),
                                      stage="cluster")
                    else:
                        manifest.stage_done(
                            job.name, "cluster",
                            outputs=_cluster_outputs(job.out_dir))
            if compressed:
                any_compressed = True
            _screen_and_finalise(shard_clustered, mesh, errs, manifest,
                                 completed, device)
            fleet_mod.record_shard_metrics(len(shard.names), shard.bucket)
    if resume_jobs:
        for job in resume_jobs:
            manifest.start(job.name)
            log.message(f"{job.name}: compress + cluster checkpoints "
                        "verified — resuming at trim (--resume)")
            with obs_qc.scope(job.name):
                ledger.record_stage(
                    "compress",
                    outputs=[job.out_dir / "input_assemblies.gfa"],
                    skipped=True)
                ledger.record_stage(
                    "cluster", outputs=_cluster_outputs(job.out_dir),
                    skipped=True)
        _screen_and_finalise(resume_jobs, mesh, errs, manifest, completed,
                             device)
    if not any_compressed:
        raise AutocyclerError(
            f"all {len(jobs)} isolate(s) failed during compress; "
            f"see {manifest_path}")
    return _summarise(completed, errs, manifest_path, out_parent, len(jobs))


def run_fleet_jobs(jobs: List[IsolateJob], k_size: int = 51,
                   max_contigs: int = 25, threads: int = 1,
                   manifest_path=None, resume: bool = False,
                   device=None) -> int:
    """The fleet runner for explicit jobs (the entry the JAX package's
    serve fleet route calls): ``jobs`` carry their own assembly and output
    dirs, and the manifest at ``manifest_path`` makes a re-run with
    ``resume=True`` re-enter at the per-isolate stage checkpoints. Returns
    the batch exit code (0 = all complete, 2 = partial failure;
    all-failed raises)."""
    dev = resolve_device(device)
    jobs = [IsolateJob(j.name, Path(j.asm_dir), Path(j.out_dir))
            for j in jobs]
    manifest_path = Path(manifest_path)
    manifest = RunManifest.load(manifest_path) if resume \
        else RunManifest(manifest_path)
    todo = []
    for job in jobs:
        if resume and manifest.status(job.name) == "done":
            log.message(f"{job.name}: already complete — skipped (resume)")
            continue
        manifest.pending(job.name)
        todo.append(job)
    if not todo:
        log.message("All fleet isolates already complete; nothing to do")
        return 0
    resume_cluster, resume_compress = _resume_sets(
        manifest, [job.name for job in todo]) if resume else (set(), set())
    errs = collect_errors()
    return _fleet_batch(todo, manifest_path.parent, k_size, max_contigs,
                        threads, manifest, manifest_path, resume_cluster,
                        resume_compress, errs, dev)


def _batched_trim_screens(cluster_dirs, graphs, mesh,
                          max_unitigs: int = 5000,
                          min_identity: float = 0.75):
    """The first-round overlap DP jobs of every sequence of every cluster
    (trim.overlap_jobs: start-end, hairpin start, hairpin end), through the
    exact host screen, then ONE sharded device traceback for the jobs it
    keeps. Returns ({cluster_dir: {(seq_id, kind): pieces or []}}, the
    number of jobs decoded on the device). ``graphs`` maps each cluster dir
    to its preloaded (graph, sequences) — loading happens in `batch` under
    per-isolate quarantine, so an unreadable GFA skips one isolate, not the
    screen."""
    jobs, keys = [], []
    for cdir in cluster_dirs:
        graph, sequences = graphs[cdir]
        max_num = max((u.number for u in graph.unitigs), default=0)
        weights = np.zeros(max_num + 1, dtype=np.int64)
        for u in graph.unitigs:
            weights[u.number] = u.length()
        all_paths = graph.get_unitig_paths_for_sequences(
            [s.id for s in sequences])
        paths = {s.id: [n if st else -n for n, st in all_paths[s.id]]
                 for s in sequences}
        for (seq_id, kind), job in overlap_jobs(paths, weights).items():
            jobs.append(job)
            keys.append((cdir, seq_id, kind))
    positive = [i for i, job in enumerate(jobs)
                if overlap_may_be_positive(job, max_unitigs)]
    decoded = sharded_overlap_tracebacks(
        mesh, [jobs[i] for i in positive], max_unitigs, min_identity)
    screens = {cdir: {} for cdir in cluster_dirs}
    for cdir, seq_id, kind in keys:
        screens[cdir][(seq_id, kind)] = []
    for i, pieces in zip(positive, decoded):
        cdir, seq_id, kind = keys[i]
        screens[cdir][(seq_id, kind)] = pieces
    return screens, len(positive)
