"""Device resolution and the per-kernel launch counters.

Entry points run on CUDA unless the caller asks for the CPU (the tests do).
There is no fallback: a request for CUDA on a machine without a card is an
error, never a silent CPU run.

Every hand-written kernel's wrapper launches it through :func:`launch` (or
:func:`kernel_launch`, for a kernel of several passes), which counts the
launch and puts CUDA events around it, so a run can show
that its main path went through the kernels and how long they took. Each
launch and each DP dispatch also opens a ``cat="device"`` span in the trace
run (``obs.trace``), whose duration is the host's enqueue and whatever
synchronisation the block itself does: no synchronise is added for it.

The alignment DPs of trim and resolve, cluster's sketch intersection
grid, and batch's contractions and sketch step (parallel/) are torch ops
on the device, not hand-written kernels. Each of their dispatches goes
through
:func:`dp_dispatch`, which records its shape (rows, jobs or pairs, cells)
on every device and its CUDA-event time on the card, under its own name,
apart from the kernels' counters.

Every launch, every DP dispatch and every :func:`device_work` block is
also one *dispatch* of the run record, as each ``device_dispatch`` of the
JAX package is: :func:`fold_records`, called once where a run ends (the
CLI, before its run dir is written; the serve daemon, after each job,
before the job's run dir), waits for the records' end events and writes
their seconds into the metrics registry under the JAX package's names:
``autocycler_device_seconds_total``, ``autocycler_device_dispatches_total``
and ``autocycler_device_kernel_seconds`` (by ``kernel`` and ``phase``,
first or steady). On the card the seconds are the CUDA events'; off it
they are the host's around the block (the work is synchronous there). The JAX
package counts host-observed seconds on every device. A block that raises
counts once in ``autocycler_device_failures_total`` and sets
``autocycler_device_failure_last`` (``utils.timing.record_device_failure``),
then raises on: the port has no fallback. On the CPU the kernel wrappers'
plain versions are such blocks, under the kernel's name, and are not
counted as launches. A launch, dispatch or block may declare its useful
work (``flops``, ``bytes_moved``): the fold adds it to
``autocycler_device_kernel_flops_total`` and ``_bytes_total`` by kernel
and phase, beside the seconds it divides (``ops.mfu.kernel_rates``). With
``AUTOCYCLER_XPROF`` set, the first launches, dispatches and blocks of
each name run under ``torch.profiler`` (``utils.timing.xprof_capture``).

Each copy of a device tensor to the host on the hand-over path goes
through :func:`to_host`, which counts its bytes and copies by the ``site``
that asked for it (``autocycler_device_to_host_bytes_total`` and
``autocycler_device_to_host_copies_total``). Small reads that steer the
host (``.item()``, ``.tolist()`` of a few values) are left out.

The serve daemon's device token (``utils.timing.enable_device_token``) is
held across each launch and each dispatch, and across compress's
adjacency and chains and cluster's distance product
(:func:`device_work`); with the token on, each block synchronises its
stream before the token passes on. The launch counts stay until
:func:`reset_counts`.

The device probe gate (the JAX package's ops/distance.py:24-615, kept here
beside the consult point, :func:`resolve_device`): before the process's
first CUDA call, a request for CUDA consults the probe, a child process
that asks the CUDA driver through libcuda (no torch import) and
round-trips one tiny op on ``cuda:0`` (``obs.sentinel.subprocess_probe``),
killed at its deadline. The consult waits for it (counted under
``utils.timing.device_wait``); a probe still pending past its budget is a
timeout. A positive
outcome holds for the process's life. A ``timeout`` or ``error`` outcome,
live or adopted from a fresh ``device_probe.json``, ends the command with
``Error:`` before any CUDA call, so a wedged driver costs at most the
deadline and its retries, not a hang. The JAX gate answers "use the host"
instead; the port has no host path, and nothing moves to the CPU on any
outcome. ``CUDA_VISIBLE_DEVICES`` empty or ``-1`` (``pinned``) and a host
without ``/dev/nvidia*`` (``no-cuda``) answer without a child, and then
give the error of a host without a card; ``AUTOCYCLER_PROBE_DEADLINE_S``
<= 0 (``disabled``) skips the probe and attaches directly.
:func:`probe_report` is the probe's overlap report and the card's name.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .obs import metrics_registry, trace
from .utils import quit_with_error, timing
from .utils.knobs import knob_float, knob_int

TO_HOST_BYTES = "autocycler_device_to_host_bytes_total"
TO_HOST_COPIES = "autocycler_device_to_host_copies_total"

# kernel name -> launches since the last reset_counts()
launches: Dict[str, int] = {"sortnet_pack_rank": 0, "dotplot_match_grid": 0,
                             "dotplot_match_grid_mxu": 0}
_events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {
    name: [] for name in launches}
_count_lock = threading.Lock()
# torch-op DP name -> one record per dispatch since the last reset_counts():
# its shape as the caller gave it, and on the card its CUDA events
dp_dispatches: Dict[str, List[dict]] = {"trim_overlap_dp": [],
                                        "resolve_medoid_dp": [],
                                        "cluster_sketch_grid": [],
                                        "batch_membership_contraction": [],
                                        "fleet_membership_contraction": [],
                                        "batch_sketch_step": [],
                                        "k-mer grouping sort (radix-sharded)": [],
                                        "k-mer grouping sort+stats "
                                        "(radix-sharded)": []}
# device_work name -> one record per block since the last reset_counts():
# on the card its CUDA events, off it its host seconds
work_blocks: Dict[str, List[dict]] = {}
# every launch, dispatch and block not folded into the registry yet:
# {"what", "events" (on the card) or "host_s", "phase", "owner" (the trace
# run it ran under), "item" and "source" (its entry in the lists above)}
_unfolded: List[dict] = []
# the names that have a record: a name's first record is "first"
_first_seen: set = set()


# ---- the device probe gate (the JAX package's ops/distance.py:24-615) ----

_PROBE_LOCK = threading.Lock()
# the last real probe outcome (short-circuit answers are never cached):
# {"attached", "seconds", "reason", "kind", "cached", "detail", "probes",
# "probing"}; a cached outcome holds for the process's life, a negative
# one until a recovery (notify_probe_recovered) clears it
_probe_state: dict = {"probes": 0}
# the background probe: {"started", "resolved", "event", "started_at"
# (monotonic), "deadline", "resolve_s", "wait_s", "pending_consults",
# "attempts"}
_bg_state: dict = {}
# the on-disk negative cache: one wedged probe costs a deadline, and its
# outcome (timeout or error only) is kept under the run's dir for
# AUTOCYCLER_PROBE_NEG_TTL_S, so that the next processes fail at once
_probe_cache_dir: Optional[str] = None
_PROBE_CACHE_FILE = "device_probe.json"
# the gate: one consult at a time (concurrent first calls wait for the one
# outcome); "passed" once CUDA is attached, with the card's "name". It is
# re-entrant: a recovery hook fired by the consult's own probe (the
# recovery capture) asks for CUDA again from the same thread
_GATE_LOCK = threading.RLock()
_gate: dict = {"passed": False}


def set_probe_cache_dir(path) -> None:
    """Keep the negative probe cache under ``path`` (compress, batch and
    the daemon point it at their ``.cache``; None disables), with the probe
    log beside it when no other dir is set. JAX ops/distance.py:57-69."""
    global _probe_cache_dir
    with _PROBE_LOCK:
        _probe_cache_dir = None if path is None else str(path)
    from .obs import sentinel
    sentinel.set_probe_log_dir(path, fallback=True)


def notify_probe_recovered() -> None:
    """The sentinel's hand-back on a false -> true transition: drop the
    cached failure and the persisted negative, so the next consult probes
    at once. JAX ops/distance.py:72-88."""
    with _PROBE_LOCK:
        cache_dir = _probe_cache_dir
        if not _probe_state.get("attached"):
            _probe_state["cached"] = False
    if cache_dir:
        try:
            os.unlink(os.path.join(cache_dir, _PROBE_CACHE_FILE))
        except OSError:
            pass


def _disk_probe_load() -> Optional[dict]:
    """A still-fresh persisted negative ({kind, reason, at}), or None.
    JAX ops/distance.py:96-118."""
    with _PROBE_LOCK:
        cache_dir = _probe_cache_dir
    ttl = knob_float("AUTOCYCLER_PROBE_NEG_TTL_S")
    if not cache_dir or ttl <= 0:
        return None
    try:
        with open(os.path.join(cache_dir, _PROBE_CACHE_FILE)) as f:
            entry = json.load(f)
        if entry.get("kind") not in ("timeout", "error"):
            return None
        if time.time() - float(entry.get("at", 0)) >= ttl:
            return None
        return entry
    except Exception:  # noqa: BLE001 — a missing or corrupt cache is none
        return None


def _disk_probe_store(attached: bool, reason: str, kind: str) -> None:
    """Persist a timeout or error; any other outcome clears a stale
    negative. JAX ops/distance.py:121-141."""
    with _PROBE_LOCK:
        cache_dir = _probe_cache_dir
    if not cache_dir:
        return
    path = os.path.join(cache_dir, _PROBE_CACHE_FILE)
    try:
        if attached or kind not in ("timeout", "error"):
            if os.path.exists(path):
                os.unlink(path)
            return
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"kind": kind, "reason": reason, "at": time.time()}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _record_probe(attached: bool, seconds: float, reason: str,
                  cache: bool, kind: str, detail: dict = None) -> None:
    with _PROBE_LOCK:
        _probe_state.update(attached=attached, seconds=round(seconds, 3),
                            reason=reason, cached=cache, kind=kind,
                            detail=detail or {},
                            probes=_probe_state.get("probes", 0)
                            + (1 if cache else 0))


def device_probe_report() -> dict:
    """The last probe outcome: {attached (None before any), seconds,
    reason, kind, probes, detail}. ``kind`` says why: "ok", "no-cuda" (no
    card, or torch without CUDA), "pinned" (CUDA_VISIBLE_DEVICES hides
    every card), "timeout" (the child never answered: a wedged driver or
    card), "error" (CUDA init failed) or "disabled" (no probe). JAX
    ops/distance.py:155-171."""
    with _PROBE_LOCK:
        return {"attached": _probe_state.get("attached"),
                "seconds": _probe_state.get("seconds"),
                "reason": _probe_state.get("reason"),
                "kind": _probe_state.get("kind"),
                "probes": _probe_state.get("probes", 0),
                "detail": dict(_probe_state.get("detail") or {})}


def _probe_reset() -> None:
    """Forget every probe outcome, the background probe, the cache dir and
    the gate, as a fresh process starts."""
    global _probe_cache_dir
    with _PROBE_LOCK:
        _probe_state.clear()
        _probe_state["probes"] = 0
        _bg_state.clear()
        _probe_cache_dir = None
    with _GATE_LOCK:
        _gate.clear()
        _gate["passed"] = False


def _short_circuit() -> Optional[Tuple[str, str]]:
    """(kind, reason) when the answer needs no child and no CUDA call:
    CUDA_VISIBLE_DEVICES empty or -1 ("pinned"), or no /dev/nvidia* device
    file ("no-cuda")."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and visible.strip() in ("", "-1"):
        return "pinned", f"CUDA_VISIBLE_DEVICES={visible!r} hides every card"
    if not glob.glob("/dev/nvidia*"):
        return "no-cuda", "no /dev/nvidia* device file on this host"
    return None


def _cuda_attached() -> bool:
    """The synchronous probe (JAX ``_tpu_attached``, ops/distance.py:
    271-377): answers without a child when :func:`_short_circuit` does, or
    when the deadline (``sentinel.probe_deadline``) is <= 0 ("disabled");
    else runs one probe. An outcome is cached for the process's life (the
    gate ends the command on a negative one; a recovery clears it). A
    fresh persisted negative is adopted without a probe. Every real
    outcome goes to the probe log."""
    from .obs import sentinel
    short = _short_circuit()
    if short is not None:
        _record_probe(False, 0.0, short[1], cache=False, kind=short[0])
        return False
    timeout = sentinel.probe_deadline()
    if timeout <= 0:
        _record_probe(False, 0.0, "AUTOCYCLER_PROBE_DEADLINE_S <= 0 "
                      "disables the device probe", cache=False,
                      kind="disabled")
        return False
    with _PROBE_LOCK:
        if _probe_state.get("cached"):
            return bool(_probe_state["attached"])
        if _probe_state.get("probing"):
            return bool(_probe_state.get("attached", False))
        _probe_state["probing"] = True
    try:
        persisted = _disk_probe_load()
        if persisted is not None:
            _record_probe(False, 0.0,
                          f"persisted negative probe: {persisted['reason']}",
                          cache=True, kind=persisted["kind"])
            return False
        attached, reason, kind, detail, elapsed = _probe_attempt(timeout)
        _record_probe(attached, elapsed, reason, cache=True, kind=kind,
                      detail=detail)
        _disk_probe_store(attached, reason, kind)
        sentinel.record_outcome(
            dict(detail or {}, attached=attached, kind=kind, reason=reason,
                 seconds=round(elapsed, 3)), source="gate")
    finally:
        with _PROBE_LOCK:
            _probe_state["probing"] = False
    return attached


def _probe_attempt(timeout: float) -> Tuple[bool, str, str, dict, float]:
    """One real probe, in a killable child (``sentinel.subprocess_probe``),
    with the deadline ``timeout``: ``(attached, reason, kind, detail,
    elapsed)``. The child runs from a thread joined with a small grace past
    the deadline, so that even a stalled spawn answers a timeout. JAX
    ops/distance.py:393-451."""
    result: List[Tuple[bool, str, str, dict]] = []

    def probe() -> None:
        try:
            from .obs import sentinel
            outcome = sentinel.subprocess_probe(timeout)
        except Exception as e:  # noqa: BLE001 — a failure like any other
            result.append((False, "probe subprocess machinery failed: "
                           f"{type(e).__name__}: {e}", "error", {}))
            return
        result.append((bool(outcome.get("attached")),
                       str(outcome.get("reason", "no reason recorded")),
                       str(outcome.get("kind", "error")), outcome))

    t0 = time.perf_counter()
    t = threading.Thread(target=probe, daemon=True, name="cuda-probe")
    t.start()
    t.join(timeout + min(5.0, 0.5 + 0.1 * timeout))
    if result:
        attached, reason, kind, detail = result[0]
    else:
        attached, kind, detail = False, "timeout", {}
        reason = (f"probe did not respond within {timeout:.0f}s "
                  "(wedged driver or card?)")
        print(f"autocycler: device {reason}", file=sys.stderr)
    return attached, reason, kind, detail, time.perf_counter() - t0


def _background_deadline() -> float:
    """The background probe's deadline (``sentinel.probe_deadline``)."""
    from .obs import sentinel
    return sentinel.probe_deadline(background=True)


def _probe_retries() -> Tuple[int, float]:
    """(retries, first backoff seconds) of the background probe, spent
    before a negative is persisted."""
    retries = max(0, knob_int("AUTOCYCLER_PROBE_RETRIES"))
    return retries, max(0.0, knob_float("AUTOCYCLER_PROBE_RETRY_BACKOFF_S"))


def _wait_budget(deadline: float) -> float:
    """The longest a consult waits for the background probe: every
    attempt's deadline and its grace, and the backoffs between them."""
    retries, backoff = _probe_retries()
    return (retries + 1) * (deadline + 5.0) \
        + sum(backoff * (2 ** i) for i in range(retries))


def _background_runner(deadline: float) -> None:
    """The background probe: retries with backoff around
    :func:`_probe_attempt`; only the final outcome reaches the caches and
    the log as source "background" (a failed attempt before a retry logs as
    "background-retry"). The final outcome is logged after the probe has
    resolved, so that a recovery hook it fires never holds up a consult
    waiting for it. JAX ops/distance.py:489-552."""
    from .obs import sentinel
    attached, reason, kind, detail = False, "probe never ran", "error", {}
    t0 = time.perf_counter()
    attempts = 0
    final = None
    try:
        persisted = _disk_probe_load()
        if persisted is not None:
            _record_probe(False, 0.0,
                          f"persisted negative probe: {persisted['reason']}",
                          cache=True, kind=persisted["kind"])
            return
        retries, backoff = _probe_retries()
        for i in range(retries + 1):
            attempts += 1
            with _PROBE_LOCK:
                _bg_state["attempts"] = attempts
            attached, reason, kind, detail, elapsed = \
                _probe_attempt(deadline)
            if attached or kind not in ("timeout", "error"):
                break
            if i < retries:
                sentinel.record_outcome(
                    dict(detail or {}, attached=False, kind=kind,
                         reason=reason, seconds=round(elapsed, 3),
                         retry=i + 1), source="background-retry")
                time.sleep(backoff * (2 ** i))
        total = time.perf_counter() - t0
        _record_probe(attached, total, reason, cache=True, kind=kind,
                      detail=detail)
        _disk_probe_store(attached, reason, kind)
        final = dict(detail or {}, attached=attached, kind=kind,
                     reason=reason, seconds=round(total, 3),
                     attempts=attempts)
    finally:
        with _PROBE_LOCK:
            _probe_state["probing"] = False
            _bg_state["resolved"] = True
            _bg_state["resolve_s"] = round(time.perf_counter() - t0, 3)
            event = _bg_state.get("event")
        if event is not None:
            event.set()
    if final is not None:
        sentinel.record_outcome(final, source="background")


def start_background_probe() -> bool:
    """Start the probe in a daemon thread, so that it runs beside the
    process's host work; the first call of a process does, later calls do
    nothing. Returns whether a thread started: a short-circuit, a disabled
    deadline or a known outcome resolves at once, without a child. JAX
    ops/distance.py:555-599."""
    with _PROBE_LOCK:
        if _bg_state.get("started"):
            return False
        _bg_state.update(started=True, resolved=False, wait_s=0.0,
                         pending_consults=0, attempts=0,
                         started_at=time.monotonic(),
                         event=threading.Event())
        already = _probe_state.get("cached")
        probing = _probe_state.get("probing")
    deadline = _background_deadline()
    if already or probing or _short_circuit() is not None or deadline <= 0:
        if not probing:
            _cuda_attached()
        with _PROBE_LOCK:
            _bg_state["resolved"] = True
            _bg_state["resolve_s"] = 0.0
            event = _bg_state.get("event")
        event.set()
        return False
    with _PROBE_LOCK:
        _probe_state["probing"] = True
        _bg_state["deadline"] = deadline
    threading.Thread(target=_background_runner, args=(deadline,), daemon=True,
                     name="cuda-probe-background").start()
    return True


def device_attached(wait: bool = False) -> bool:
    """The consult of the probe. While the background probe is pending,
    ``wait=False`` answers the last known state at once (and counts the
    consult), ``wait=True`` blocks until it resolves, for at most
    :func:`_wait_budget`, counted under ``utils.timing.device_wait``; a
    probe still pending then is a timeout, kept in memory and on disk.
    Otherwise the synchronous probe (:func:`_cuda_attached`). JAX
    ops/distance.py:602-647."""
    with _PROBE_LOCK:
        pending = _bg_state.get("started") and not _bg_state.get("resolved")
        if pending and not wait:
            _bg_state["pending_consults"] = \
                _bg_state.get("pending_consults", 0) + 1
            return bool(_probe_state.get("attached", False))
        event = _bg_state.get("event")
        started_at = _bg_state.get("started_at", 0.0)
        deadline = _bg_state.get("deadline", 0.0)
    if pending and event is not None:
        budget = _wait_budget(deadline)
        remaining = max(0.0, budget - (time.monotonic() - started_at))
        t0 = time.perf_counter()
        with timing.device_wait("probe future"):
            resolved = event.wait(remaining)
        with _PROBE_LOCK:
            _bg_state["wait_s"] = round(_bg_state.get("wait_s", 0.0)
                                        + time.perf_counter() - t0, 3)
        if not resolved:
            reason = (f"the background probe did not resolve within its "
                      f"budget of {budget:.0f}s (wedged driver or card?)")
            _record_probe(False, time.monotonic() - started_at, reason,
                          cache=True, kind="timeout")
            _disk_probe_store(False, reason, "timeout")
            return False
    return _cuda_attached()


def probe_overlap_report() -> dict:
    """The probe's ledger for the run record, ``/healthz``, ``doctor`` and
    ``watch``: ``state`` (unstarted, pending, attached or failed), ``kind``,
    ``resolve_s`` (the probe's wall from start to outcome), ``wait_s``
    (seconds callers blocked on it), ``overlap_saved_s`` (resolve_s -
    wait_s: the probe's time hidden behind host work), ``pending_consults``,
    ``attempts`` and ``deadline_s``. JAX ops/distance.py:650-681."""
    with _PROBE_LOCK:
        started = _bg_state.get("started", False)
        resolved = _bg_state.get("resolved", False)
        resolve_s = _bg_state.get("resolve_s")
        wait_s = _bg_state.get("wait_s", 0.0)
        attached = _probe_state.get("attached")
        kind = _probe_state.get("kind")
        pending_consults = _bg_state.get("pending_consults", 0)
        attempts = _bg_state.get("attempts", 0)
        deadline = _bg_state.get("deadline")
    if not started:
        state = "unstarted"
    elif not resolved:
        state = "pending"
    else:
        state = "attached" if attached else "failed"
    overlap = None
    if resolve_s is not None:
        overlap = round(max(0.0, resolve_s - wait_s), 3)
    return {"state": state, "kind": kind, "resolve_s": resolve_s,
            "wait_s": round(wait_s, 3), "overlap_saved_s": overlap,
            "pending_consults": pending_consults, "attempts": attempts,
            "deadline_s": deadline}


def probe_report() -> dict:
    """:func:`probe_overlap_report` and, once CUDA is attached, the card's
    ``name``: ``/healthz``'s and each time-series tick's ``probe``."""
    report = probe_overlap_report()
    if "name" in _gate:
        report["name"] = _gate["name"]
    return report


def consult_probe() -> bool:
    """Starts the probe if no one did, waits for its outcome, and ends the
    command with ``Error:`` on a timeout or an error, before any CUDA
    call; else returns whether the probe attached."""
    start_background_probe()
    attached = device_attached(wait=True)
    report = device_probe_report()
    if not attached and report["kind"] in ("timeout", "error"):
        quit_with_error(
            f"the device probe failed ({report['kind']}): "
            f"{report['reason']}. No CUDA call was made; run "
            "`autocycler doctor` (python -m autocycler_tpu_torch doctor) "
            "for a diagnosis")
    return attached


def _consult_gate(dev: torch.device) -> None:
    """The gate of the process's first CUDA call: :func:`consult_probe`,
    then attaches CUDA (the error of a host without a card if none
    answers) and keeps the card's name; a passed gate is not consulted
    again."""
    with _GATE_LOCK:
        if _gate["passed"]:
            return
        consult_probe()
        if not torch.cuda.is_available():
            quit_with_error("no CUDA device is available; the port runs its "
                            "device path on an NVIDIA GPU")
        _gate["name"] = torch.cuda.get_device_name(
            dev.index if dev.index is not None else 0)
        # a disabled probe attaches directly: the card answered all the same
        with _PROBE_LOCK:
            _probe_state["attached"] = True
        _gate["passed"] = True


def start_probe(cache_dir, device=None) -> None:
    """For a command that will ask for CUDA (``device`` None or a CUDA
    device): keep the negative probe cache (and the probe log) under
    ``cache_dir``, then start the background probe; the JAX package's
    compress, batch and daemon do the same."""
    if torch.device("cuda" if device is None else device).type == "cuda":
        set_probe_cache_dir(cache_dir)
        start_background_probe()


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. The first request for CUDA in a process goes
    through the probe gate (:func:`_consult_gate`). Raises AutocyclerError
    when CUDA is asked for and the probe failed or no card answers, or for
    a device type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not _gate["passed"]:
            _consult_gate(dev)
    elif dev.type != "cpu":
        quit_with_error(f"unsupported device {dev}: use cuda or cpu")
    return dev


def _stream_sync(device: torch.device):
    """The synchronise of ``device``'s current stream, or None off the card."""
    if device.type != "cuda":
        return None
    return lambda: torch.cuda.current_stream(device).synchronize()


def _note(what: str, item, source: list, events=None,
          host_s: Optional[float] = None, work: tuple = (None, None)
          ) -> None:
    """Keeps one launch's, dispatch's or block's record for the next
    :func:`fold_records`, with its declared ``work`` (flops, bytes)."""
    with _count_lock:
        phase = "steady" if what in _first_seen else "first"
        _first_seen.add(what)
        _unfolded.append({"what": what, "events": events, "host_s": host_s,
                          "phase": phase, "owner": trace.current_run(),
                          "item": item, "source": source, "work": work})


def _failed(what: str, e: BaseException) -> None:
    timing.record_device_failure(f"{what} raised {type(e).__name__}: {e}",
                                 exc=e)


@contextlib.contextmanager
def _host_timed(what: str):
    """Times the block on the host: yields a dict that holds its
    ``host_s`` once it ends (or raises, which is a device failure)."""
    out: dict = {}
    t0 = time.perf_counter()
    try:
        yield out
    except Exception as e:
        _failed(what, e)
        raise
    finally:
        out["host_s"] = time.perf_counter() - t0


@contextlib.contextmanager
def _event_timed(what: str, device: torch.device):
    """Times with CUDA events everything enqueued on ``device``'s current
    stream inside the block: yields a dict that holds the ``stream``, and
    its ``events`` once the block ends (or raises, which is a device
    failure)."""
    out: dict = {}
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out["stream"] = stream
        try:
            yield out
        except Exception as e:
            _failed(what, e)
            raise
        finally:
            end.record(stream)
            out["events"] = (start, end)


def _timed(what: str, device: torch.device):
    """CUDA events on the card, the host's clock off it."""
    if device.type == "cuda":
        return _event_timed(what, device)
    return _host_timed(what)


@contextlib.contextmanager
def _device_span(name: str, device: torch.device):
    """The device token, the ``AUTOCYCLER_XPROF`` capture and the
    ``cat="device"`` span (linking the capture) around one block."""
    with timing.xprof_capture(name) as xprof, \
            timing.device_token(name, _stream_sync(device)), \
            trace.span(name, cat="device",
                       **({"xprof": xprof} if xprof else {})):
        yield


@contextlib.contextmanager
def device_work(name: str, device: torch.device, flops: float = None,
                bytes_moved: float = None):
    """Device work that is neither a kernel launch nor a recorded dispatch
    (compress's adjacency and chains, cluster's distance product, and off
    the card the kernels' plain versions): one dispatch of the run record,
    held under the device token when it is on, and synchronised before
    the token passes on. ``flops`` and ``bytes_moved`` declare its useful
    work."""
    record: dict = {}
    with _count_lock:
        source = work_blocks.setdefault(name, [])
        source.append(record)
    t: dict = {}
    try:
        with _device_span(name, device), _timed(name, device) as t:
            yield
    finally:
        record.update((key, t[key]) for key in ("events", "host_s")
                      if key in t)
        _note(name, record, source, t.get("events"), t.get("host_s"),
              (flops, bytes_moved))


@contextlib.contextmanager
def kernel_launch(name: str, device: torch.device, flops: float = None,
                  bytes_moved: float = None):
    """One launch of kernel ``name``: counts it, and times with CUDA events
    everything enqueued on the current stream of ``device`` inside the
    block (a kernel made of several passes and their bookkeeping is one
    launch). Yields the stream's handle for the C entry points. A launch
    that raises is not counted, but is a dispatch and a device failure of
    the run record. ``flops`` and ``bytes_moved`` declare its useful
    work."""
    t: dict = {}
    launched = False
    try:
        with _device_span(name, device), _event_timed(name, device) as t:
            yield t["stream"].cuda_stream
        launched = True
    finally:
        if launched:
            record_launch(name, *t["events"], work=(flops, bytes_moved))
        elif "events" in t:
            _note(name, None, None, t["events"])


def check(name: str, err: int) -> None:
    """Raises on a CUDA error returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch(name: str, device: torch.device, fn, *args, flops: float = None,
           bytes_moved: float = None) -> None:
    """One launch of kernel ``name`` through its C entry point ``fn(*args,
    stream)``, timed and counted by :func:`kernel_launch`. Raises on a
    launch the runtime refused (``fn`` returns its CUDA error)."""
    with kernel_launch(name, device, flops, bytes_moved) as stream:
        check(name, fn(*args, stream))


def record_launch(name: str, start: torch.cuda.Event,
                  end: torch.cuda.Event, work: tuple = (None, None)) -> None:
    # batch's fleet runner repairs the next isolates' ends on pool threads
    # while the main thread builds a graph: both launch the grouping
    pair = (start, end)
    with _count_lock:
        launches[name] += 1
        _events[name].append(pair)
    _note(name, pair, _events[name], pair, work=work)


@contextlib.contextmanager
def dp_dispatch(name: str, device: torch.device, flops: float = None,
                bytes_moved: float = None, **shape):
    """One dispatch of the torch-op DP ``name`` on ``device``, recorded with
    its ``shape`` (for example rows, jobs or pairs, cells); on the card,
    timed with CUDA events around everything enqueued inside the block.
    ``flops`` and ``bytes_moved`` declare its useful work."""
    record = dict(shape)
    if device.type == "cuda":
        record["events"] = None         # in flight until the block ends
    with _count_lock:
        dp_dispatches[name].append(record)
    t: dict = {}
    try:
        with _device_span(name, device), _timed(name, device) as t:
            yield
    finally:
        if "events" in t:
            record["events"] = t["events"]
        _note(name, record, dp_dispatches[name], t.get("events"),
              t.get("host_s"), (flops, bytes_moved))


def dp_summary(name: str) -> dict:
    """Dispatches of DP ``name`` since the last reset: their count, their
    summed shape and, for those on the card, their summed CUDA-event
    ``ms`` (synchronises), with the per-dispatch records under ``each``."""
    records = dp_dispatches[name]
    if any(r.get("events") for r in records):
        torch.cuda.synchronize()
    each = []
    for r in records:
        row = {key: value for key, value in r.items() if key != "events"}
        if r.get("events"):
            row["ms"] = r["events"][0].elapsed_time(r["events"][1])
        each.append(row)
    totals: Dict[str, float] = {}
    for row in each:
        for key, value in row.items():
            totals[key] = totals.get(key, 0) + value
    return {"dispatches": len(each), **totals, "each": each}


def work_summary() -> Dict[str, dict]:
    """The :func:`device_work` blocks since the last reset, by name: their
    count and, on the card, their summed CUDA-event ``ms`` (synchronises)."""
    out = {}
    for name, records in work_blocks.items():
        ms = 0.0
        for r in records:
            if r.get("events"):
                r["events"][1].synchronize()
                ms += r["events"][0].elapsed_time(r["events"][1])
        out[name] = {"blocks": len(records), "ms": ms}
    return out


_ANY = object()


def fold_records(owner=_ANY, drop: bool = False) -> int:
    """Folds the records of every launch, dispatch and block not yet folded
    (of the trace run ``owner`` only, when given) into the registry: waits
    for their end events (one synchronise where the run ends, none in the
    hot path), then counts each as one dispatch with its seconds. With
    ``drop`` (the serve daemon, which keeps no per-launch state across
    jobs) their entries also leave the launch, DP and block lists; the
    launch counts stay. Returns the number of records folded."""
    with _count_lock:
        mine = [r for r in _unfolded if owner is _ANY or r["owner"] is owner]
        if not mine:
            return 0
        ids = {id(r) for r in mine}
        _unfolded[:] = [r for r in _unfolded if id(r) not in ids]
    reg = metrics_registry.registry()
    for r in mine:
        seconds = r["host_s"]
        if r["events"] is not None:
            start, end = r["events"]
            try:
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            except RuntimeError:      # a block the card never finished
                seconds = None
        seconds = seconds or 0.0
        reg.counter_inc(timing.DEVICE_SECONDS, seconds,
                        help="device seconds of launches and dispatches "
                             "(CUDA events on the card, host seconds off "
                             "it)")
        reg.counter_inc(timing.DEVICE_DISPATCHES, 1,
                        help="device dispatch count")
        reg.observe(timing.DEVICE_KERNEL_HIST, seconds,
                    help="per-kernel dispatch seconds, split first call "
                         "vs steady state",
                    kernel=r["what"], phase=r["phase"])
        flops, bytes_moved = r["work"]
        if flops:
            reg.counter_inc(timing.DEVICE_KERNEL_FLOPS, float(flops),
                            help="useful FLOPs dispatched per kernel",
                            kernel=r["what"], phase=r["phase"])
        if bytes_moved:
            reg.counter_inc(timing.DEVICE_KERNEL_BYTES, float(bytes_moved),
                            help="useful HBM bytes moved per kernel",
                            kernel=r["what"], phase=r["phase"])
    if drop:
        with _count_lock:
            gone: Dict[int, set] = {}
            for r in mine:
                if r["source"] is not None:
                    gone.setdefault(id(r["source"]), set()).add(id(r["item"]))
            for source in (*_events.values(), *dp_dispatches.values(),
                           *work_blocks.values()):
                if id(source) in gone:
                    source[:] = [x for x in source
                                 if id(x) not in gone[id(source)]]
    return len(mine)


def to_host(t: torch.Tensor, site: str, dtype=None) -> np.ndarray:
    """``t`` as a host numpy array (``.cpu().numpy()``, then ``astype(dtype,
    copy=False)`` when ``dtype`` is given), counting ``t``'s bytes and one
    copy under ``site`` in the registry. A tensor already on the host is
    counted alike: the count is what the site asks the device for.

    The hand-over path's copies all come here: the stream's pass 1
    (``stream-bin``) and its stitch (``stream-stitch``), the in-memory
    grouping (``k-mer grouping``, ``gram grouping``, ``adjacency``,
    ``group_windows``, ``radix partition``), the end repair (``repair``),
    the chains (``chains``), cluster's product and sketches (``cluster
    distance matmul``, ``sketch``, ``cluster_sketch_grid``) and the DPs of
    trim and resolve (``trim_overlap_dp``, ``resolve_medoid_dp``). Left
    out, being off that path: ``dotplot``'s canvas and ``parallel/``'s
    batch and fleet contractions."""
    out = t.cpu().numpy()
    reg = metrics_registry.registry()
    reg.counter_inc(TO_HOST_BYTES, float(t.numel() * t.element_size()),
                    help="bytes of device tensors copied to the host, by "
                         "the site that copied them", site=site)
    reg.counter_inc(TO_HOST_COPIES, 1,
                    help="copies of device tensors to the host, by site",
                    site=site)
    return out if dtype is None else out.astype(dtype, copy=False)


def to_host_bytes() -> float:
    """Bytes copied through :func:`to_host` so far, all sites."""
    return sum(metrics_registry.registry().labeled(TO_HOST_BYTES,
                                                   "site").values())


def reset_counts() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0
            _events[name].clear()
        for records in dp_dispatches.values():
            records.clear()
        work_blocks.clear()
        _unfolded.clear()


def kernel_ms(name: str) -> float:
    """Summed device time of the kernel's launches since the last reset,
    from their CUDA events (synchronises)."""
    if not _events[name]:
        return 0.0
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in _events[name])
