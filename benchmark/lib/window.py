"""One run of one cell: set-up, the measured window, the check.

The window is a closed loop of whole isolates, one at a time, each through
the port's in-process hand-over, as ``batch`` and ``serve`` run it:
``compress`` -> ``cluster(collect_handoff=True)`` -> ``trim(preloaded)``
and ``resolve(preloaded)`` for each QC-pass cluster -> ``combine``. Each
isolate writes into a fresh directory, so the warm-start cache is cold, as
in a user's first run. The collector is off while an isolate runs and
collects once after it, inside the window: the unitig graph is cyclic, and
with the collector on its scans walk every cycle the stages leave behind,
which a command-per-process run never pays. A finished isolate's directory
is moved aside inside the window and checked, then deleted, once the
window has closed.

An isolate in which the program degraded (``resilience.degrade_events()``:
a spill failure sends compress back to the in-memory grouping, with its
stderr line discarded here), or that took another path than its
configuration states, ran off the path that its cell measures: it counts as
failed, and the run is not correct. The configuration states two paths:
``streams`` (whether compress streams its k-mer grouping) and ``distance``
(``"exact"``, the default, or ``"sketch"``: which distances cluster works
out, read from the isolate's own substages, ``cluster-distance-product``
and ``cluster-sketch-distances``).
"""

from __future__ import annotations

import contextlib
import gc
import io
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch

from ..gen import synthetic, traffic as traffic_gen
from ..reference import check as reference
from . import hostload, instrument

# the window's own numbers, each with its limit, beside the reference's
LIMITS = {**reference.LIMITS, "isolates_degraded": 0, "isolates_off_path": 0}

# the substage that each of cluster's distance paths, and only it, runs
DISTANCE_SUBSTAGES = {"exact": "cluster-distance-product",
                      "sketch": "cluster-sketch-distances"}


def distance_path(config: dict) -> str:
    """The configuration's ``distance``: ``"exact"`` where it gives none."""
    path = config.get("distance", "exact")
    if path not in DISTANCE_SUBSTAGES:
        raise ValueError(f"distance is one of {sorted(DISTANCE_SUBSTAGES)}: "
                         f"{path!r}")
    return path


def off_path(rec: instrument.Isolate, streams: bool, distance: str) -> bool:
    """Whether the isolate left its configuration's paths: compress streamed
    where ``streams`` says not, or not where it says so; or cluster did not
    run the ``distance`` path's substage, or ran another's (``verify`` runs
    both)."""
    if bool(rec.stream.get("bins")) != streams:
        return True
    return any((name in rec.substages) != (path == distance)
               for path, name in DISTANCE_SUBSTAGES.items())


def _discard():
    return contextlib.redirect_stderr(io.StringIO())


@contextlib.contextmanager
def _environment(env: dict):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_isolate(asm_dir: Path, out_dir: Path, config: dict, device,
                instr: instrument.Instrument) -> None:
    """One isolate through the hand-over, as the port's ``batch`` runs it."""
    from autocycler_tpu_torch.commands.cluster import cluster
    from autocycler_tpu_torch.commands.combine import combine
    from autocycler_tpu_torch.commands.compress import compress
    from autocycler_tpu_torch.commands.resolve import resolve
    from autocycler_tpu_torch.commands.trim import trim

    dev = None if device.type == "cuda" else device
    gc.disable()
    try:
        with _discard():
            with instr.stage("compress"):
                compress(asm_dir, out_dir, config["k"], threads=config["threads"],
                         device=dev)
            with instr.stage("cluster"):
                handoff = cluster(out_dir, collect_handoff=True, device=dev)
            clusters = sorted(handoff)
            instr.current.qc_pass_clusters = len(clusters)
            for c in clusters:
                with instr.stage("trim"):
                    trimmed = trim(c, preloaded=handoff.pop(c), device=dev)
                with instr.stage("resolve"):
                    resolve(c, preloaded=trimmed, device=dev)
                del trimmed
            with instr.stage("combine"):
                combine(out_dir, [c / "5_final.gfa" for c in clusters])
    finally:
        gc.enable()
    gc.collect()


def attach(device) -> None:
    """The device probe and the CUDA context, through the program's gate."""
    if device.type != "cuda":
        return
    from autocycler_tpu_torch.device import resolve_device
    with _discard():
        resolve_device(None)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, scale: float = None) -> dict:
    """The run's record: set-up and window seconds, each isolate's record,
    the device peak, the check's numbers, and with ``trace`` the profiler's
    reading."""
    config, traffic = cell["config"], cell["traffic"]
    if scale:
        config = traffic_gen.scaled(config, scale)
        traffic = traffic_gen.scaled_traffic(traffic, scale)
    work = Path(tempfile.mkdtemp(prefix=f"autocycler-bench-{cell['name']}-"))
    try:
        return _run(cell, config, traffic, seed, seconds, trace, device,
                    t_start, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, config, traffic, seed, seconds, trace, device, t_start, work):
    distance = distance_path(config)
    attach(device)
    pool = []
    for i in range(config["pool_isolates"]):
        pool.append(synthetic.write_isolate(
            traffic_gen.isolate(config, traffic, seed, i), work / "pool" / f"iso-{i}"))
    warm_dir = synthetic.write_isolate(
        traffic_gen.warmup_isolate(config, traffic, seed), work / "warmup" / "in")
    instr = instrument.Instrument(device, trace)
    with _environment(config["warmup"].get("env", {})):
        instr.begin_isolate()
        run_isolate(warm_dir, work / "warmup" / "out", config, device, instr)
        instr.end_isolate()
    shutil.rmtree(work / "warmup")
    instr.spans.clear()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    instr.install()
    prof = instrument.start_profiler() if instr.trace else None
    window_ns0 = time.time_ns()
    t0 = time.perf_counter()
    with _environment(config.get("env", {})):
        isolates, done_dirs, failure = _window(pool, work, config, device,
                                               instr, seconds)
    window_s = time.perf_counter() - t0
    window_ns1 = time.time_ns()
    if prof is not None:
        prof.stop()
    instr.uninstall()

    degraded = [bool(r.degrades) for r in isolates]
    strayed = [off_path(r, config["streams"], distance) for r in isolates]
    failed = sum(d or o for d, o in zip(degraded, strayed))
    record = {
        "setup_s": setup_s, "window_s": window_s, "attempted": len(isolates)
        + (failure is not None), "failed": failed + (failure is not None),
        "failure": failure, "isolates": [r.as_dict() for r in isolates],
        "device_peak_bytes": (instr.peak_bytes()
                              if device.type == "cuda" else None),
    }
    if prof is not None:
        record["trace"] = instrument.read_trace(prof, instr.spans,
                                                (window_ns0, window_ns1))
        instrument.call_device_ms(prof, isolates)
        del prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["host_speed"] = hostload.host_speed()
    record["check"] = {**check_all(done_dirs, config["k"]),
                       "isolates_degraded": sum(degraded),
                       "isolates_off_path": sum(strayed)}
    return record


def _window(pool, work, config, device, instr, seconds):
    """Whole isolates, one at a time, until the mean so far says the next
    would end after ``seconds``: (their records, their (inputs, outputs)
    directories, the program's failure or None)."""
    isolates, done_dirs = [], []
    t0 = time.perf_counter()
    try:
        while True:
            n = len(isolates)
            asm = pool[n % len(pool)]
            out = work / "run" / f"iso-{n}"
            rec = instr.begin_isolate()
            i0 = time.perf_counter()
            run_isolate(asm, out, config, device, instr)
            rec.wall_s = time.perf_counter() - i0
            instr.end_isolate()
            isolates.append(rec)
            kept = work / "done" / out.name
            kept.parent.mkdir(parents=True, exist_ok=True)
            out.rename(kept)
            done_dirs.append((asm, kept))
            elapsed = time.perf_counter() - t0
            if elapsed + elapsed / len(isolates) > seconds:
                return isolates, done_dirs, None
    except Exception as e:  # the program failed: the run is not correct
        return isolates, done_dirs, f"{type(e).__name__}: {e}"


def check_all(done_dirs, k: int) -> dict:
    """Each number of the reference's check, summed over the window's
    isolates; each isolate's directory is deleted once checked."""
    totals = {name: 0 for name in reference.LIMITS}
    for asm, out in done_dirs:
        for name, value in reference.check_isolate(asm, out, k).items():
            totals[name] += value
        shutil.rmtree(out, ignore_errors=True)
    return totals
