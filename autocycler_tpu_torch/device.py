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

The alignment DPs of trim and resolve and cluster's sketch intersection
grid are torch ops on the device, not hand-written kernels. Each of their
dispatches goes through
:func:`dp_dispatch`, which records its shape (rows, jobs or pairs, cells)
on every device and its CUDA-event time on the card, under its own name,
apart from the kernels' counters.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from .obs import trace
from .utils import quit_with_error

# kernel name -> launches since the last reset_counts()
launches: Dict[str, int] = {"sortnet_pack_rank": 0, "dotplot_match_grid": 0,
                             "dotplot_match_grid_mxu": 0}
_events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {
    name: [] for name in launches}
# torch-op DP name -> one record per dispatch since the last reset_counts():
# its shape as the caller gave it, and on the card its CUDA events
dp_dispatches: Dict[str, List[dict]] = {"trim_overlap_dp": [],
                                        "resolve_medoid_dp": [],
                                        "cluster_sketch_grid": []}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises AutocyclerError when CUDA is asked for and
    absent, or for a device type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            quit_with_error("no CUDA device is available; the port runs its "
                            "device path on an NVIDIA GPU")
    elif dev.type != "cpu":
        quit_with_error(f"unsupported device {dev}: use cuda or cpu")
    return dev


@contextlib.contextmanager
def kernel_launch(name: str, device: torch.device):
    """One launch of kernel ``name``: counts it, and times with CUDA events
    everything enqueued on the current stream of ``device`` inside the
    block (a kernel made of several passes and their bookkeeping is one
    launch). Yields the stream's handle for the C entry points."""
    with torch.cuda.device(device), trace.span(name, cat="device"):
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
    launches[name] += 1
    _events[name].append((start, end))


@contextlib.contextmanager
def dp_dispatch(name: str, device: torch.device, **shape):
    """One dispatch of the torch-op DP ``name`` on ``device``, recorded with
    its ``shape`` (for example rows, jobs or pairs, cells); on the card,
    timed with CUDA events around everything enqueued inside the block."""
    record = dict(shape)
    dp_dispatches[name].append(record)
    if device.type != "cuda":
        with trace.span(name, cat="device"):
            yield
        return
    with torch.cuda.device(device), trace.span(name, cat="device"):
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
    if any("events" in r for r in records):
        torch.cuda.synchronize()
    each = []
    for r in records:
        row = {key: value for key, value in r.items() if key != "events"}
        if "events" in r:
            row["ms"] = r["events"][0].elapsed_time(r["events"][1])
        each.append(row)
    totals: Dict[str, float] = {}
    for row in each:
        for key, value in row.items():
            totals[key] = totals.get(key, 0) + value
    return {"dispatches": len(each), **totals, "each": each}


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
