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

The serve daemon's device token (``utils.timing.enable_device_token``) is
held across each launch and each dispatch, and across compress's
adjacency and chains and cluster's distance product
(:func:`device_work`); with the token on, each block synchronises its
stream before the token passes on. A long-lived daemon folds the finished
launches' and dispatches' records into the metrics registry's per-kernel
histograms (:func:`fold_records`), which keeps them bounded; the launch
counts stay until :func:`reset_counts`. :func:`probe_report` says what
the card is and when it was attached, in the JAX package's probe shape.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from .obs import metrics_registry, trace
from .utils import quit_with_error, timing

DEVICE_KERNEL_HIST = "autocycler_device_kernel_seconds"

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


@contextlib.contextmanager
def device_work(name: str, device: torch.device):
    """Device work that is neither a kernel launch nor a recorded dispatch
    (compress's adjacency and chains, cluster's distance product): held
    under the device token when it is on, and synchronised before the
    token passes on."""
    with timing.device_token(name, _stream_sync(device)):
        yield


@contextlib.contextmanager
def kernel_launch(name: str, device: torch.device):
    """One launch of kernel ``name``: counts it, and times with CUDA events
    everything enqueued on the current stream of ``device`` inside the
    block (a kernel made of several passes and their bookkeeping is one
    launch). Yields the stream's handle for the C entry points."""
    with timing.device_token(name, _stream_sync(device)), \
            torch.cuda.device(device), trace.span(name, cat="device"):
        stream = torch.cuda.current_stream()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield stream.cuda_stream
        end.record(stream)
    record_launch(name, start, end)


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
    with _count_lock:
        launches[name] += 1
        _events[name].append((start, end))


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
    if device.type != "cuda":
        with timing.device_token(name, _stream_sync(device)), \
                trace.span(name, cat="device"):
            yield
        return
    with timing.device_token(name, _stream_sync(device)), \
            torch.cuda.device(device), trace.span(name, cat="device"):
        stream = torch.cuda.current_stream()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
    record["events"] = (start, end)


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


def fold_records() -> int:
    """Fold every finished launch's and dispatch's record into the
    registry's per-kernel histogram (``autocycler_device_kernel_seconds``,
    CUDA-event seconds) and drop it; records whose work has not finished
    stay. The launch counts are left as they are. Returns the number of
    records folded. The serve scheduler calls it after each job, so a
    long-lived daemon keeps no per-launch state."""
    folded: List[Tuple[str, Optional[float]]] = []
    with _count_lock:
        for name, pairs in _events.items():
            keep = []
            for start, end in pairs:
                if end.query():
                    folded.append((name, start.elapsed_time(end) / 1e3))
                else:
                    keep.append((start, end))
            pairs[:] = keep
        for name, records in dp_dispatches.items():
            keep = []
            for r in records:
                events = r.get("events", ())
                if events == ():                # off the card
                    folded.append((name, None))
                elif events is not None and events[1].query():
                    folded.append(
                        (name, events[0].elapsed_time(events[1]) / 1e3))
                else:
                    keep.append(r)
            records[:] = keep
    for name, seconds in folded:
        if seconds is not None:
            metrics_registry.observe(
                DEVICE_KERNEL_HIST, seconds,
                help="per-kernel device seconds (CUDA events) of each "
                     "launch or dispatch", kernel=name)
        else:
            metrics_registry.counter_inc(
                "autocycler_device_dispatches_total", 1,
                help="device dispatches off the card (no CUDA events)",
                kernel=name)
    return len(folded)


def reset_counts() -> None:
    for name in launches:
        launches[name] = 0
        _events[name].clear()
    for records in dp_dispatches.values():
        records.clear()


def kernel_ms(name: str) -> float:
    """Summed device time of the kernel's launches since the last reset,
    from their CUDA events (synchronises)."""
    if not _events[name]:
        return 0.0
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in _events[name])
