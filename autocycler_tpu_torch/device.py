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
``autocycler_device_seconds_total``, ``autocycler_device_dispatches_total``,
``autocycler_device_dispatch_seconds`` (by ``what``) and
``autocycler_device_kernel_seconds`` (by ``kernel`` and ``phase``, first
or steady). On the card the seconds are the CUDA events'; off it they are
the host's around the block (the work is synchronous there). The JAX
package counts host-observed seconds on every device. A block that raises
counts once in ``autocycler_device_failures_total`` and sets
``autocycler_device_failure_last`` (``utils.timing.record_device_failure``),
then raises on: the port has no fallback. On the CPU the kernel wrappers'
plain versions are such blocks, under the kernel's name, and are not
counted as launches.

The serve daemon's device token (``utils.timing.enable_device_token``) is
held across each launch and each dispatch, and across compress's
adjacency and chains and cluster's distance product
(:func:`device_work`); with the token on, each block synchronises its
stream before the token passes on. The launch counts stay until
:func:`reset_counts`. :func:`probe_report` says what the card is and when
it was attached, in the JAX package's probe shape.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from .obs import metrics_registry, trace
from .utils import quit_with_error, timing

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
                                        "batch_sketch_step": []}
# device_work name -> one record per block since the last reset_counts():
# on the card its CUDA events, off it its host seconds
work_blocks: Dict[str, List[dict]] = {}
# every launch, dispatch and block not folded into the registry yet:
# {"what", "events" (on the card) or "host_s", "phase", "owner" (the trace
# run it ran under), "item" and "source" (its entry in the lists above)}
_unfolded: List[dict] = []
# the names that have a record: a name's first record is "first"
_first_seen: set = set()


# what resolve_device saw of the card: when CUDA was first attached and
# how long the resolve (and the daemon's kernel loads) took
_probe: dict = {"state": "unstarted", "resolve_s": 0.0}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises AutocyclerError when CUDA is asked for and
    absent, or for a device type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        if not torch.cuda.is_available():
            quit_with_error("no CUDA device is available; the port runs its "
                            "device path on an NVIDIA GPU")
        if _probe["state"] != "attached":
            _probe.update(state="attached", name=torch.cuda.get_device_name(
                dev.index if dev.index is not None else 0))
            note_attach_seconds(time.perf_counter() - t0)
    elif dev.type != "cpu":
        quit_with_error(f"unsupported device {dev}: use cuda or cpu")
    return dev


def note_attach_seconds(seconds: float) -> None:
    """Add ``seconds`` of attach work (the resolve, the kernels' build and
    load at daemon start) to the probe report's ``resolve_s``."""
    _probe["resolve_s"] = round(_probe["resolve_s"] + seconds, 6)


def probe_report() -> dict:
    """The card's probe report (``/healthz``'s and each time-series tick's
    ``probe``), with the keys of the JAX package's ``probe_overlap_report``
    that the port can fill from what it did: ``state`` is ``attached``
    once :func:`resolve_device` resolved CUDA, else ``unstarted``; ``kind``
    is ``cuda``; ``resolve_s`` the resolve and kernel-load seconds (None
    before); ``wait_s`` 0 (no probe runs beside the pipeline, so nothing
    waits on one); and, once attached, the card's ``name``. The JAX
    probe's overlap, consult and attempt fields are left out: no probe
    runs, so there is nothing to report in them."""
    attached = _probe["state"] == "attached"
    report = {"state": _probe["state"], "kind": "cuda",
              "resolve_s": _probe["resolve_s"] if attached else None,
              "wait_s": 0.0}
    if "name" in _probe:
        report["name"] = _probe["name"]
    return report


def _stream_sync(device: torch.device):
    """The synchronise of ``device``'s current stream, or None off the card."""
    if device.type != "cuda":
        return None
    return lambda: torch.cuda.current_stream(device).synchronize()


def _note(what: str, item, source: list, events=None,
          host_s: Optional[float] = None) -> None:
    """Keeps one launch's, dispatch's or block's record for the next
    :func:`fold_records`."""
    with _count_lock:
        phase = "steady" if what in _first_seen else "first"
        _first_seen.add(what)
        _unfolded.append({"what": what, "events": events, "host_s": host_s,
                          "phase": phase, "owner": trace.current_run(),
                          "item": item, "source": source})


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
def device_work(name: str, device: torch.device):
    """Device work that is neither a kernel launch nor a recorded dispatch
    (compress's adjacency and chains, cluster's distance product, and off
    the card the kernels' plain versions): one dispatch of the run record,
    held under the device token when it is on, and synchronised before
    the token passes on."""
    record: dict = {}
    with _count_lock:
        source = work_blocks.setdefault(name, [])
        source.append(record)
    t: dict = {}
    try:
        with timing.device_token(name, _stream_sync(device)), \
                trace.span(name, cat="device"), _timed(name, device) as t:
            yield
    finally:
        record.update((key, t[key]) for key in ("events", "host_s")
                      if key in t)
        _note(name, record, source, t.get("events"), t.get("host_s"))


@contextlib.contextmanager
def kernel_launch(name: str, device: torch.device):
    """One launch of kernel ``name``: counts it, and times with CUDA events
    everything enqueued on the current stream of ``device`` inside the
    block (a kernel made of several passes and their bookkeeping is one
    launch). Yields the stream's handle for the C entry points. A launch
    that raises is not counted, but is a dispatch and a device failure of
    the run record."""
    t: dict = {}
    launched = False
    try:
        with timing.device_token(name, _stream_sync(device)), \
                trace.span(name, cat="device"), \
                _event_timed(name, device) as t:
            yield t["stream"].cuda_stream
        launched = True
    finally:
        if launched:
            record_launch(name, *t["events"])
        elif "events" in t:
            _note(name, None, None, t["events"])


def check(name: str, err: int) -> None:
    """Raises on a CUDA error returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch(name: str, device: torch.device, fn, *args) -> None:
    """One launch of kernel ``name`` through its C entry point ``fn(*args,
    stream)``, timed and counted by :func:`kernel_launch`. Raises on a
    launch the runtime refused (``fn`` returns its CUDA error)."""
    with kernel_launch(name, device) as stream:
        check(name, fn(*args, stream))


def record_launch(name: str, start: torch.cuda.Event,
                  end: torch.cuda.Event) -> None:
    # batch's fleet runner repairs the next isolates' ends on pool threads
    # while the main thread builds a graph: both launch the grouping
    pair = (start, end)
    with _count_lock:
        launches[name] += 1
        _events[name].append(pair)
    _note(name, pair, _events[name], pair)


@contextlib.contextmanager
def dp_dispatch(name: str, device: torch.device, **shape):
    """One dispatch of the torch-op DP ``name`` on ``device``, recorded with
    its ``shape`` (for example rows, jobs or pairs, cells); on the card,
    timed with CUDA events around everything enqueued inside the block."""
    record = dict(shape)
    if device.type == "cuda":
        record["events"] = None         # in flight until the block ends
    with _count_lock:
        dp_dispatches[name].append(record)
    t: dict = {}
    try:
        with timing.device_token(name, _stream_sync(device)), \
                trace.span(name, cat="device"), _timed(name, device) as t:
            yield
    finally:
        if "events" in t:
            record["events"] = t["events"]
        _note(name, record, dp_dispatches[name], t.get("events"),
              t.get("host_s"))


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
        reg.observe(timing.DEVICE_DISPATCH_HIST, seconds,
                    help="per-dispatch device seconds", what=r["what"])
        reg.observe(timing.DEVICE_KERNEL_HIST, seconds,
                    help="per-kernel dispatch seconds, split first call "
                         "vs steady state",
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
