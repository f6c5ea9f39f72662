"""Bounded work queue with per-job fault isolation for `autocycler serve`,
as the JAX package's serve/scheduler.py runs it, on the card.

One scheduler owns the daemon's job table, a bounded FIFO queue and a
pool of worker threads (``AUTOCYCLER_SERVE_WORKERS``, default
``min(4, cpu//2)``; ``1`` runs one job at a time, whole). Each job runs
the same code path the CLI runs — compress, optionally through the full
cluster/trim/resolve/combine pipeline, with the daemon's device passed
down — but inside a quarantine: an :class:`AutocyclerError` or OSError (a
corrupt FASTA among them) marks the job failed in the job table and the
``serve_manifest.json`` run manifest (:class:`utils.resilience.RunManifest`)
and the worker moves on to the next job.

A ``RuntimeError`` (what a CUDA error is) is not quarantined: a sticky
CUDA error poisons every later job on the card. The job is marked failed
in the manifest with the error, the daemon stops admitting, and it shuts
down (`autocycler serve` exits 1 with ``Error: ...``); a restart replays
the jobs still pending. This follows ``batch``'s quarantine; the JAX
package quarantines every exception and keeps serving. Three
``RuntimeError`` subclasses are not device faults and are quarantined: a
``torch.cuda.OutOfMemoryError`` (not sticky: the allocator handed out
nothing, so only that job fails, as a device-memory failure), and
``NotImplementedError`` and ``RecursionError`` (bugs in the job's path).

Each job owns a run directory (``<root>/jobs/<id>/``) receiving the
standard per-run artifacts — ``trace.jsonl``, ``qc_report.json``,
``ledger.json`` — what ``AUTOCYCLER_TRACE_DIR`` produces for a CLI run, so
`autocycler watch` and `autocycler report` work unchanged on a daemon job.
Concurrent jobs stay disjoint because each opens its own *scoped* trace
run (:func:`obs.trace.open_run`, bound to the executing thread and carried
into pool tasks), tags QC/ledger entries with its job id as the isolate
scope, and writes scope-filtered reports at the end. With more than one
worker, device work serializes through the process-wide device token
(:func:`utils.timing.enable_device_token`): one job on the card at a time,
each block synchronised before the token passes on, while other jobs'
host stages — load, parse, the graph work — overlap freely. At the end of
each job, before its run dir is written, that job's launches and
dispatches fold into the registry's device seconds, dispatch counts and
per-kernel histograms (:func:`device.fold_records`, which waits for their
end events) and leave the per-launch lists, so the daemon's per-launch
state stays bounded.

The warm wins come from sharing the process: the CUDA context, the loaded
kernels, the shared ``utils.pool`` executor and — because the daemon
points ``utils.cache`` at one shared directory — the parse and end-repair
caches persist across jobs and across workers.

Batch fan-out: one ``POST /jobs`` body with a ``"batch"`` array admits N
child jobs under one parent id; ``GET /jobs/<parent>`` aggregates child
states. A ``"fleet": true`` batch admits as one job that runs ``batch``'s
fleet runner (``commands.batch.run_fleet_jobs``).
"""

from __future__ import annotations

import contextlib
import gc
import os
import queue
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from .. import device as device_mod
from ..obs import ledger, metrics_registry, trace
from ..obs import qc as obs_qc
from ..obs.metrics_registry import SECONDS_BUCKETS
from ..utils import AutocyclerError, log
from ..utils.resilience import InputError, RunManifest
from ..utils.timing import enable_device_token
from .protocol import JobSpec, parse_job_spec
from .slo import SloTracker
from ..utils.env import env_int

MANIFEST_NAME = "serve_manifest.json"

# registry metric names, the JAX package's: the live /metrics endpoint
# reads these
JOBS_TOTAL = "autocycler_serve_jobs_total"
SUBMITTED_TOTAL = "autocycler_serve_submitted_total"
REJECTED_TOTAL = "autocycler_serve_rejected_total"
SHED_TOTAL = "autocycler_serve_shed_total"
QUEUE_DEPTH = "autocycler_serve_queue_depth"
JOB_SECONDS = "autocycler_serve_job_seconds"
WORKERS_GAUGE = "autocycler_serve_workers"
BUSY_GAUGE = "autocycler_serve_busy_workers"
WORKER_BUSY_GAUGE = "autocycler_serve_worker_busy"


def default_workers() -> int:
    """The scheduler pool width: ``AUTOCYCLER_SERVE_WORKERS`` when set
    (floor 1), else ``min(4, cpu//2)`` with floor 1 — conservative because
    every job already fans its own stages across the shared pool."""
    configured = env_int("AUTOCYCLER_SERVE_WORKERS")
    if configured is not None:
        return max(1, int(configured))
    return max(1, min(4, (os.cpu_count() or 2) // 2))


def _id_num(name: str) -> int:
    try:
        return int(name.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return 0


class QueueFullError(AutocyclerError):
    """The bounded work queue is at capacity — the server maps this to
    HTTP 503 so clients can back off and retry."""


class DeviceFailure(AutocyclerError):
    """A job raised a device error (a ``RuntimeError``): the daemon stopped
    admitting and shuts down; a restart replays the pending jobs."""


class Job:
    """One job's record: the spec plus lifecycle state and artifact paths."""

    def __init__(self, job_id: str, spec: JobSpec, run_dir: Path,
                 out_dir: Path,
                 fleet_specs: Optional[List[JobSpec]] = None,
                 trace_id: Optional[str] = None):
        self.id = job_id
        self.spec = spec
        self.run_dir = run_dir
        self.out_dir = out_dir
        self.state = "queued"
        self.error: Optional[str] = None
        self.resumed = False              # replayed after a daemon restart
        self.parent: Optional[str] = None  # batch parent id, when fanned out
        # a fleet admission: ONE queue slot whose execution fans these
        # items over the mesh (commands.batch.run_fleet_jobs)
        self.fleet_specs: Optional[List[JobSpec]] = fleet_specs
        # cross-process correlation id (X-Autocycler-Trace): already
        # sanitized at the HTTP boundary, threaded (never assigned late —
        # the job is worker-visible once enqueued) into the trace run
        # header, QC report and ledger
        self.trace_id: Optional[str] = trace_id
        self.submitted_epoch = time.time()
        self.started_epoch: Optional[float] = None
        self.finished_epoch: Optional[float] = None
        self.wall_s: Optional[float] = None
        self.queue_wait_s: Optional[float] = None

    def to_dict(self) -> dict:
        if self.fleet_specs:
            # additive key only: existing clients keep parsing records
            # that predate fleet admissions unchanged
            return {**self._base_dict(),
                    "fleet": len(self.fleet_specs)}
        return self._base_dict()

    def _base_dict(self) -> dict:
        record = {
            "id": self.id,
            "state": self.state,
            "spec": self.spec.to_dict(),
            "run_dir": str(self.run_dir),
            "out_dir": str(self.out_dir),
            "error": self.error,
            "parent": self.parent,
            "submitted_epoch": round(self.submitted_epoch, 3),
            "started_epoch": round(self.started_epoch, 3)
            if self.started_epoch else None,
            "finished_epoch": round(self.finished_epoch, 3)
            if self.finished_epoch else None,
            "wall_s": round(self.wall_s, 3) if self.wall_s is not None
            else None,
            "queue_wait_s": round(self.queue_wait_s, 3)
            if self.queue_wait_s is not None else None,
        }
        if self.trace_id:
            # additive key only: pre-federation clients keep parsing
            record["trace_id"] = self.trace_id
        return record


class Scheduler:
    """The daemon's job table + bounded queue + worker pool."""

    def __init__(self, root, capacity: int = 16,
                 workers: Optional[int] = None, device=None):
        self.root = Path(root)
        # every job's device work runs here; None means CUDA
        self.device = device_mod.resolve_device(device)
        # the first device error a job raised (see DeviceFailure), and who
        # to tell: the server's shutdown request
        self.failure: Optional[DeviceFailure] = None
        self.on_failure = None
        self.root.mkdir(parents=True, exist_ok=True)
        self.capacity = max(1, int(capacity))
        self.workers = max(1, int(workers)) if workers is not None \
            else default_workers()
        self._queue: "queue.Queue[Job]" = queue.Queue(maxsize=self.capacity)
        self._jobs: Dict[str, Job] = {}
        self._parents: Dict[str, dict] = {}   # batch id -> children meta
        self._busy: Dict[str, str] = {}       # worker name -> job id
        self._lock = threading.Lock()
        # whole-job serialization: held across execute() only in
        # single-worker mode (SLO reads stay disjoint from it)
        self._run_lock = threading.Lock()
        self._next_id = 1
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # latency SLO tracking: its own lock, disjoint from _run_lock and
        # _lock by construction (the sampler and /healthz read it mid-job)
        self.slo = SloTracker()
        self.slo.set_capacity(self.workers)
        # multi-worker mode serializes device work through the device
        # token; single-worker leaves it off, at no cost
        enable_device_token(self.workers > 1)
        metrics_registry.gauge_set(
            WORKERS_GAUGE, self.workers,
            help="serve scheduler worker pool width")
        metrics_registry.gauge_set(
            BUSY_GAUGE, 0, help="serve workers currently executing a job")
        self.manifest = RunManifest.load(self.root / MANIFEST_NAME)
        # crash-safe replay: a previous daemon's unfinished jobs come back.
        # Jobs still "pending" re-enqueue, and EVERY job caught "running"
        # (a multi-worker daemon dies with up to N of them) resumes from
        # its last checkpointed stage when a worker picks it up.
        replay: List[Job] = []
        for name, entry in list(self.manifest.items.items()):
            # resume the id sequence past every recorded job so a restarted
            # daemon never reuses (and silently overwrites) a prior job id
            self._next_id = max(self._next_id, _id_num(name) + 1)
            if entry.get("kind") == "batch":
                # parents are aggregation records, never enqueued; rebuild
                # the fan-out map so GET /jobs/<parent> keeps answering
                kids = [k for k in (entry.get("children") or [])
                        if isinstance(k, str)]
                self._parents[name] = {
                    "children": kids,
                    "submitted_epoch": entry.get("submitted_epoch")}
                continue
            status = entry.get("status")
            if status not in ("pending", "running"):
                continue
            if entry.get("kind") == "fleet":
                # a fleet admission replays as ONE job; its execution
                # resumes from the fleet manifest's per-isolate stage
                # checkpoints (commands.batch.run_fleet_jobs resume=True)
                try:
                    fleet_specs = [parse_job_spec(s)
                                   for s in (entry.get("fleet_specs") or [])]
                    if not fleet_specs:
                        raise InputError("empty fleet spec list")
                except (InputError, TypeError) as e:
                    self.manifest.fail(name, f"unreplayable fleet spec: {e}")
                    continue
                run_dir = self.root / "jobs" / name
                out_dir = Path(entry.get("out_dir") or (run_dir / "out"))
                tid = entry.get("trace_id")
                job = Job(name, fleet_specs[0], run_dir, out_dir,
                          fleet_specs=fleet_specs,
                          trace_id=tid if isinstance(tid, str) else None)
                job.resumed = status == "running"
                submitted = entry.get("submitted_epoch")
                if isinstance(submitted, (int, float)):
                    job.submitted_epoch = float(submitted)
                replay.append(job)
                continue
            spec_data = entry.get("spec")
            if not isinstance(spec_data, dict):
                # pre-replay manifests carried no spec: nothing to re-run,
                # so record the interruption the way older daemons did
                if status == "running":
                    self.manifest.fail(name, "interrupted by daemon restart")
                continue
            try:
                spec = parse_job_spec(spec_data)
            except InputError as e:
                self.manifest.fail(name, f"unreplayable job spec: {e}")
                continue
            run_dir = self.root / "jobs" / name
            out_dir = Path(entry.get("out_dir") or (run_dir / "out"))
            tid = entry.get("trace_id")
            job = Job(name, spec, run_dir, out_dir,
                      trace_id=tid if isinstance(tid, str) else None)
            job.resumed = status == "running"
            parent = entry.get("parent")
            if isinstance(parent, str):
                job.parent = parent
            submitted = entry.get("submitted_epoch")
            if isinstance(submitted, (int, float)):
                job.submitted_epoch = float(submitted)
            replay.append(job)
        # re-enqueue in true submission order: the persisted submit
        # timestamp, tie-broken by the numeric id — NOT the lexicographic
        # id sort, which misorders once ids outgrow their zero padding
        replay.sort(key=lambda j: (j.submitted_epoch, _id_num(j.id)))
        for job in replay:
            try:
                self._queue.put_nowait(job)
            except queue.Full:
                # stays pending in the manifest; the next restart (or a
                # larger capacity) picks it up
                log.message(f"WARNING: serve: {job.id} not replayed — "
                            f"queue capacity {self.capacity} exhausted")
                continue
            self._jobs[job.id] = job
            log.message(
                f"serve: {job.id} "
                + ("resuming from last checkpointed stage"
                   if job.resumed else "re-enqueued after restart"))
        if replay:
            self._gauge_depth()

    # ---- admission ----

    def submit(self, spec: JobSpec,
               trace_id: Optional[str] = None) -> Job:
        """Admit one job into the bounded queue; raises
        :class:`QueueFullError` at capacity (never blocks the caller)."""
        self._check_admitting()
        with self._lock:
            job = self._admit_locked(spec, trace_id=trace_id)
        # persist everything replay needs: a restarted daemon rebuilds the
        # Job from the manifest entry alone
        self.manifest.annotate(
            job.id, spec=spec.to_dict(), out_dir=str(job.out_dir),
            submitted_epoch=round(job.submitted_epoch, 3),
            **({"trace_id": job.trace_id} if job.trace_id else {}))
        metrics_registry.counter_inc(
            SUBMITTED_TOTAL, 1, help="jobs admitted into the work queue")
        self._gauge_depth()
        return job

    def _admit_locked(self, spec: JobSpec,
                      parent: Optional[str] = None,
                      fleet_specs: Optional[List[JobSpec]] = None,
                      trace_id: Optional[str] = None) -> Job:
        """Create + enqueue one job. Caller holds ``self._lock``.
        ``fleet_specs`` and ``trace_id`` must be threaded through here
        (not assigned after) — the job is visible to workers the moment it
        is enqueued, and a late assignment would race a worker into the
        single-spec path (or an untagged trace run)."""
        job_id = f"job-{self._next_id:06d}"
        self._next_id += 1
        run_dir = self.root / "jobs" / job_id
        out_dir = Path(spec.out_dir) if spec.out_dir else run_dir / "out"
        job = Job(job_id, spec, run_dir, out_dir, fleet_specs=fleet_specs,
                  trace_id=trace_id)
        job.parent = parent
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            metrics_registry.counter_inc(
                REJECTED_TOTAL, 1, help="jobs rejected at admission",
                reason="queue_full")
            raise QueueFullError(
                f"work queue is full ({self.capacity} jobs); "
                "retry after a job completes") from None
        self._jobs[job_id] = job
        return job

    def submit_fleet(self, specs: List[JobSpec],
                     trace_id: Optional[str] = None) -> Job:
        """Admit a fleet batch as ONE job: a single queue slot and worker
        whose execution fans the items over the device mesh
        (commands.batch.run_fleet_jobs), instead of ``submit_batch``'s N
        independent child jobs. Raises :class:`QueueFullError` when the
        queue is at capacity."""
        specs = list(specs)
        self._check_admitting()
        with self._lock:
            job = self._admit_locked(specs[0], fleet_specs=specs,
                                     trace_id=trace_id)
        # persist the full item list: a restarted daemon rebuilds the
        # fleet job from the manifest entry alone and resumes it from the
        # per-isolate stage checkpoints in its fleet manifest
        self.manifest.annotate(
            job.id, kind="fleet",
            fleet_specs=[s.to_dict() for s in specs],
            out_dir=str(job.out_dir),
            submitted_epoch=round(job.submitted_epoch, 3),
            **({"trace_id": job.trace_id} if job.trace_id else {}))
        metrics_registry.counter_inc(
            SUBMITTED_TOTAL, 1, help="jobs admitted into the work queue")
        self._gauge_depth()
        return job

    def submit_batch(self, specs: List[JobSpec],
                     trace_id: Optional[str] = None) -> dict:
        """Fan a multi-isolate batch out into child jobs under one parent
        id. All-or-nothing: when fewer than ``len(specs)`` queue slots are
        free the whole batch is rejected (503), so a client never has to
        reconstruct which half of its fleet was admitted."""
        specs = list(specs)
        self._check_admitting()
        with self._lock:
            free = self.capacity - self._queue.qsize()
            if len(specs) > free:
                metrics_registry.counter_inc(
                    REJECTED_TOTAL, len(specs),
                    help="jobs rejected at admission", reason="queue_full")
                raise QueueFullError(
                    f"batch of {len(specs)} exceeds the {free} free queue "
                    f"slot(s) (capacity {self.capacity}); retry after jobs "
                    "complete")
            parent_id = f"batch-{self._next_id:06d}"
            self._next_id += 1
            children = [self._admit_locked(spec, parent=parent_id,
                                           trace_id=trace_id)
                        for spec in specs]
            self._parents[parent_id] = {
                "children": [j.id for j in children],
                "submitted_epoch": round(time.time(), 3)}
        for job in children:
            self.manifest.annotate(
                job.id, spec=job.spec.to_dict(), out_dir=str(job.out_dir),
                submitted_epoch=round(job.submitted_epoch, 3),
                parent=parent_id,
                **({"trace_id": job.trace_id} if job.trace_id else {}))
        self.manifest.annotate(
            parent_id, kind="batch", children=[j.id for j in children],
            submitted_epoch=self._parents[parent_id]["submitted_epoch"])
        metrics_registry.counter_inc(
            SUBMITTED_TOTAL, len(children),
            help="jobs admitted into the work queue")
        self._gauge_depth()
        record = self.batch_record(parent_id)
        assert record is not None
        return record

    def _check_admitting(self) -> None:
        """After a device failure the daemon admits nothing: 503, as at
        capacity, since a restarted daemon will take the job."""
        if self.failure is not None:
            metrics_registry.counter_inc(
                REJECTED_TOTAL, 1, help="jobs rejected at admission",
                reason="device_failure")
            raise QueueFullError(
                f"the daemon is shutting down after a device error "
                f"({self.failure}); retry once it restarts")

    def job(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> List[Job]:
        with self._lock:
            return list(self._jobs.values())

    def batch_record(self, parent_id: str) -> Optional[dict]:
        """The aggregated record of one batch: child job records plus the
        derived parent state (queued -> running -> done | failed) and the
        summed queue wait — what ``GET /jobs/<parent>`` serves."""
        with self._lock:
            meta = self._parents.get(parent_id)
            if meta is None:
                return None
            children = [self._jobs[c] for c in meta["children"]
                        if c in self._jobs]
            missing = len(meta["children"]) - len(children)
            records = [j.to_dict() for j in children]
        states = [r["state"] for r in records]
        if states and all(s == "queued" for s in states):
            state = "queued"
        elif any(s in ("queued", "running") for s in states):
            state = "running"
        elif any(s == "failed" for s in states):
            state = "failed"
        else:
            state = "done"
        waits = [r["queue_wait_s"] for r in records
                 if r["queue_wait_s"] is not None]
        finished = [r["finished_epoch"] for r in records]
        started = [r["started_epoch"] for r in records if r["started_epoch"]]
        wall = None
        if started and all(f is not None for f in finished):
            wall = round(max(finished) - min(started), 3)
        return {
            "id": parent_id,
            "kind": "batch",
            "state": state,
            "jobs": len(records),
            "children": records,
            "children_missing": missing,
            "states": {s: states.count(s) for s in sorted(set(states))},
            "agg_queue_wait_s": round(sum(waits), 3) if waits else None,
            "wall_s": wall,
            "submitted_epoch": meta.get("submitted_epoch"),
        }

    def batches(self) -> List[dict]:
        with self._lock:
            parent_ids = sorted(self._parents, key=_id_num)
        records = [self.batch_record(p) for p in parent_ids]
        return [r for r in records if r is not None]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for job in self.jobs():
            out[job.state] = out.get(job.state, 0) + 1
        return out

    def _gauge_depth(self) -> None:
        metrics_registry.gauge_set(
            QUEUE_DEPTH, self._queue.qsize(),
            help="jobs waiting in the serve work queue")

    # ---- worker pool ----

    def start(self) -> None:
        if self._threads:
            return
        for i in range(self.workers):
            thread = threading.Thread(
                target=self._worker_loop, args=(f"worker-{i}",),
                name=f"autocycler-serve-worker-{i}", daemon=True)
            self._threads.append(thread)
            thread.start()

    def shutdown(self, wait: bool = True, timeout: float = 30.0) -> None:
        """Stop the workers after their current jobs; queued jobs stay
        recorded as pending in the manifest (a restarted daemon replays
        them)."""
        self._stop.set()
        threads, self._threads = self._threads, []
        if wait:
            deadline = time.monotonic() + timeout
            for thread in threads:
                thread.join(timeout=max(0.0, deadline - time.monotonic()))

    def busy_count(self) -> int:
        with self._lock:
            return len(self._busy)

    def idle(self) -> bool:
        """True when the queue is drained and no worker is executing."""
        return self._queue.empty() and self.busy_count() == 0

    def _set_busy(self, worker: str, job_id: Optional[str]) -> None:
        with self._lock:
            if job_id is None:
                self._busy.pop(worker, None)
            else:
                self._busy[worker] = job_id
            busy = len(self._busy)
        metrics_registry.gauge_set(
            BUSY_GAUGE, busy, help="serve workers currently executing a job")
        metrics_registry.gauge_set(
            WORKER_BUSY_GAUGE, 0 if job_id is None else 1,
            help="per-worker busy flag (1 = executing a job)",
            worker=worker)

    def _worker_loop(self, worker: str) -> None:
        while not self._stop.is_set():
            try:
                job = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self._gauge_depth()
            self._set_busy(worker, job.id)
            try:
                self.execute(job)
            finally:
                self._set_busy(worker, None)
                self._queue.task_done()

    # ---- execution ----

    def execute(self, job: Job) -> None:
        """Run one job under quarantine, with its own trace/QC/ledger run.

        Every job opens a *scoped* trace run bound to the executing thread
        (and propagated into pool tasks), and tags its QC journal and
        ledger entries with the job id as the isolate scope — so N
        concurrent jobs stream N disjoint trace.jsonl files and each
        run directory's qc_report/ledger carries exactly that job's
        entries. In single-worker mode the legacy run lock is additionally
        held across the job, preserving the original daemon's execution
        semantics."""
        spec = job.spec
        gate = self._run_lock if self.workers == 1 \
            else contextlib.nullcontext()
        with gate:
            with self._lock:
                job.state = "running"
                job.started_epoch = time.time()
                job.queue_wait_s = max(
                    0.0, job.started_epoch - job.submitted_epoch)
            self.manifest.start(job.id)
            log.message(f"serve: {job.id} started "
                        f"({spec.command} {spec.assemblies_dir})")
            t0 = time.perf_counter()
            run = None
            try:
                run = trace.open_run(job.run_dir,
                                     name=f"serve-{spec.command}",
                                     trace_id=job.trace_id)
            except OSError:
                # unwritable run dir — run the job untraced rather than
                # refuse it
                pass
            failure: Optional[BaseException] = None
            prefix, fatal = "", False
            try:
                with contextlib.ExitStack() as ctx:
                    if run is not None:
                        ctx.enter_context(trace.bind_run(run))
                    span_attrs = {"job": job.id, "command": spec.command}
                    if job.trace_id:
                        span_attrs["trace"] = job.trace_id
                    ctx.enter_context(
                        trace.span(f"job/{job.id}", cat="command",
                                   **span_attrs))
                    ctx.enter_context(obs_qc.job_scope(job.id))
                    if job.fleet_specs:
                        self._run_fleet(job)
                    else:
                        self._run_spec(spec, job.out_dir, job_id=job.id)
            except (AutocyclerError, OSError) as e:
                failure = e
            except torch.cuda.OutOfMemoryError as e:
                # not sticky: this job fails, the daemon keeps serving
                failure, prefix = e, "device memory exhausted: "
            except (NotImplementedError, RecursionError) as e:
                failure, prefix = e, "unexpected error: "
            except RuntimeError as e:
                # a CUDA error: not quarantined (see the module docstring)
                failure, fatal = e, True
            except Exception as e:  # noqa: BLE001 — a bug in one job's
                # pipeline path must not take the worker (and every queued
                # job behind it) down with it
                failure, prefix = e, "unexpected error: "
            finally:
                job.wall_s = time.perf_counter() - t0
                # this job's launches and dispatches (its records only:
                # another job's may be in flight) reach the registry
                # before its run dir is written, and leave the daemon's
                # per-launch lists
                device_mod.fold_records(owner=run, drop=True)
                if run is not None:
                    run_dir = trace.close_run(run)
                    if run_dir:
                        obs_qc.write_qc_report(run_dir, scope=job.id,
                                               trace_id=job.trace_id)
                        ledger.write_ledger(
                            run_dir, command=f"serve/{spec.command}",
                            scope=job.id, trace_id=job.trace_id)
                # the job's journal/ledger entries are flushed into its run
                # dir; drain them so a long-lived daemon's shared tables
                # stay bounded
                obs_qc.drain_scope(job.id)
                ledger.drain_scope(job.id)
                # job graphs are reference-cyclic; a long-lived daemon must
                # reclaim them eagerly or RSS grows by one graph per job
                gc.collect()
                # the terminal state flips only AFTER the run artifacts,
                # metrics and SLO window are flushed: a client that polls
                # /jobs/<id> to a terminal state may immediately read
                # ledger.json or scrape /metrics and must find this job
                # already accounted for
                job.finished_epoch = time.time()
                final_state = "done" if failure is None else "failed"
                metrics_registry.counter_inc(
                    JOBS_TOTAL, 1,
                    help="jobs completed by the serve worker",
                    state=final_state, command=spec.command)
                metrics_registry.observe(
                    JOB_SECONDS, job.wall_s,
                    help="per-job wall seconds",
                    buckets=SECONDS_BUCKETS, command=spec.command)
                self.slo.record(job.queue_wait_s or 0.0, job.wall_s,
                                finished_epoch=job.finished_epoch,
                                command=spec.command)
                if failure is None:
                    self.manifest.done(job.id)
                    with self._lock:
                        job.state = "done"
                elif fatal:
                    self._fail_device(job, failure)
                else:
                    self._quarantine(job, failure, prefix=prefix)
                log.message(f"serve: {job.id} {job.state} "
                            f"({job.wall_s:.2f}s)")

    def _quarantine(self, job: Job, error: BaseException,
                    prefix: str = "") -> None:
        """Fail one job and keep serving. ``prefix`` names a failure that
        is not the job's input (a bug, the card's memory); the message then
        carries the exception's type too."""
        message = f"{prefix}{type(error).__name__}: {error}" if prefix \
            else str(error)
        # counter before the state flip, for the same poll-then-scrape
        # ordering contract as execute()'s terminal accounting
        metrics_registry.counter_inc(
            "autocycler_quarantined_items_total", 1,
            help="per-item failures quarantined instead of aborting")
        self.manifest.fail(job.id, message)
        with self._lock:
            job.state = "failed"
            job.error = message
        log.message(f"WARNING: serve: {job.id} quarantined — {message}")

    def _fail_device(self, job: Job, error: BaseException) -> None:
        """A device error: the job fails in the manifest with the error,
        the workers stop taking jobs (the queued ones stay pending in the
        manifest for a restart to replay) and the server is asked to shut
        down."""
        message = f"device error: {type(error).__name__}: {error}"
        self.manifest.fail(job.id, message)
        with self._lock:
            job.state = "failed"
            job.error = message
            if self.failure is None:
                self.failure = DeviceFailure(f"{job.id}: {message}")
        self._stop.set()
        log.message(f"ERROR: serve: {job.id} failed on the device — "
                    f"{message}; stopping the daemon")
        if self.on_failure is not None:
            self.on_failure()

    def _stage_skip(self, job_id: Optional[str], stage: str,
                    outputs, cluster: Optional[str] = None) -> bool:
        """True when ``stage`` may be skipped: the manifest has a verified
        checkpoint (every recorded output re-hashes clean). The skip is
        made visible in the run's ledger and log so replay is auditable."""
        if job_id is None or not self.manifest.stage_complete(job_id, stage):
            return False
        ledger.record_stage(stage.split("/", 1)[0], outputs=outputs,
                            cluster=cluster, skipped=True)
        log.message(f"serve: {job_id} skipping {stage} "
                    "(checkpoint verified)")
        return True

    def _stage_done(self, job_id: Optional[str], stage: str,
                    outputs) -> None:
        if job_id is not None:
            self.manifest.stage_done(job_id, stage, outputs=outputs)

    def _run_fleet(self, job: Job) -> None:
        """The fleet job body: one admission fanned over the mesh through
        the CLI's fleet runner. Each item's outputs land in its spec's
        ``out_dir`` (default: ``<job run_dir>/out/isolate-NN``); the fleet
        manifest in the job's run dir gives daemon restarts per-isolate
        stage-granular resume. Partial failure (exit 2 — some isolates
        quarantined inside the fleet run) fails the job with the manifest
        path, matching `autocycler batch`'s exit contract."""
        from ..commands.batch import IsolateJob, run_fleet_jobs
        assert job.fleet_specs
        jobs = []
        for i, spec in enumerate(job.fleet_specs):
            name = f"isolate-{i:02d}"
            out_dir = Path(spec.out_dir) if spec.out_dir \
                else job.out_dir / name
            jobs.append(IsolateJob(name, Path(spec.assemblies_dir), out_dir))
        manifest_path = job.run_dir / "fleet_manifest.json"
        spec = job.fleet_specs[0]
        rc = run_fleet_jobs(jobs, k_size=spec.kmer,
                            max_contigs=spec.max_contigs,
                            threads=spec.threads,
                            manifest_path=manifest_path,
                            resume=job.resumed, device=self.device)
        if rc != 0:
            raise AutocyclerError(
                f"fleet run completed with failed isolate(s); "
                f"see {manifest_path}")

    def _run_spec(self, spec: JobSpec, out_dir: Path,
                  job_id: Optional[str] = None) -> None:
        """The job body: the CLI code path on the daemon's device, so
        outputs are byte-identical to `autocycler compress` / the
        per-isolate slice of `autocycler batch` by construction. Trim hands
        its graph to resolve in memory.

        With a ``job_id``, every stage checkpoints into the serve manifest
        after its artifacts flush, and a resumed job skips stages whose
        recorded output hashes still verify — re-entering mid-isolate
        instead of starting over. Stages re-run from disk state, so the
        resumed run's outputs match a full rerun byte for byte."""
        out_dir = Path(out_dir)
        compress_out = [out_dir / "input_assemblies.gfa",
                        out_dir / "input_assemblies.yaml"]
        if not self._stage_skip(job_id, "compress", compress_out):
            from ..commands.compress import compress
            compress(spec.assemblies_dir, out_dir, spec.kmer,
                     spec.max_contigs, threads=spec.threads,
                     device=self.device)
            self._stage_done(job_id, "compress", compress_out)
        if spec.command != "pipeline":
            return
        clustering_dir = out_dir / "clustering"
        qc_pass = clustering_dir / "qc_pass"

        def cluster_out():
            return [clustering_dir / "pairwise_distances.phylip",
                    clustering_dir / "clustering.newick",
                    clustering_dir / "clustering.tsv",
                    clustering_dir / "clustering.yaml"] \
                + sorted(clustering_dir.glob("qc_*/cluster_*/1_untrimmed.gfa"))

        if not self._stage_skip(job_id, "cluster", cluster_out()):
            from ..commands.cluster import cluster
            cluster(out_dir, spec.cutoff, spec.min_assemblies,
                    spec.max_contigs, device=self.device)
            self._stage_done(job_id, "cluster", cluster_out())
        from ..commands.combine import combine
        from ..commands.resolve import resolve
        from ..commands.trim import trim
        cluster_dirs = sorted(d for d in qc_pass.iterdir() if d.is_dir()) \
            if qc_pass.is_dir() else []
        for cdir in cluster_dirs:
            trim_out = [cdir / "2_trimmed.gfa", cdir / "2_trimmed.yaml"]
            resolve_out = [cdir / "3_bridged.gfa", cdir / "4_merged.gfa",
                           cdir / "5_final.gfa"]
            trimmed = None
            if not self._stage_skip(job_id, f"trim/{cdir.name}", trim_out,
                                    cluster=cdir.name):
                trimmed = trim(cdir, threads=spec.threads,
                               device=self.device)
                self._stage_done(job_id, f"trim/{cdir.name}", trim_out)
            if not self._stage_skip(job_id, f"resolve/{cdir.name}",
                                    resolve_out, cluster=cdir.name):
                # on resume trimmed is None and resolve re-parses
                # 2_trimmed.gfa from disk — same bytes either way
                resolve(cdir, device=self.device, preloaded=trimmed)
                self._stage_done(job_id, f"resolve/{cdir.name}", resolve_out)
            del trimmed
        combine_out = [out_dir / "consensus_assembly.gfa",
                       out_dir / "consensus_assembly.fasta",
                       out_dir / "consensus_assembly.yaml"]
        finals = sorted(qc_pass.glob("cluster_*/5_final.gfa"))
        if finals and not self._stage_skip(job_id, "combine", combine_out):
            combine(out_dir, finals)
            self._stage_done(job_id, "combine", combine_out)
