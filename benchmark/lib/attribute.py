"""The device's idle time and its copies put down to the program's own spans.

The program's tracer (``autocycler_tpu_torch/obs/trace.py``) stamps each
span with ``t0_ns``/``t1_ns`` on the clock of ``time.time_ns()``, which is
the clock ``torch.profiler`` stamps its device events with, and which the
benchmark's own stage calls are timed on. So an idle interval of the card,
or a copy, can be put down to the innermost program span that covers it:

- each idle interval of the window (no kernel, copy or set on the card) is
  cut at span edges, and each piece goes to the innermost span that covers
  it; a copy goes whole to the innermost span that covers its midpoint;
- the innermost span is the one that started last among those covering the
  instant (of nested spans, the deepest; of spans on two threads, the one
  the host opened last);
- spans of cat ``isolate`` (the benchmark's own, one an isolate) name
  nothing; an instant under no other span is ``<stage> (unnamed)`` inside a
  benchmark stage call and ``between stages`` outside every one.

``idle_named_share`` is the share of the idle seconds inside the stage calls
that falls under a span below the program's stage steps: a span of a cat
other than ``isolate``, ``command`` and ``stage`` (``substage``, ``device``
and ``device_wait``).
"""

from __future__ import annotations

import heapq
import re
from typing import Dict, Iterable, List, Tuple

# spans that name no work of their own
UNNAMING = {"isolate"}
# spans above the program's named functions
COARSE = {"isolate", "command", "stage"}
BETWEEN = "between stages"
# a span keeps its own row from this many seconds on
MIN_S = 0.05

COPY = re.compile(r"Memcpy (DtoH|HtoD)")


def unnamed(stage: str) -> str:
    return f"{stage} (unnamed)"


def idle_intervals(busy: Iterable[Tuple[int, int]], window: Tuple[int, int]
                   ) -> List[Tuple[int, int]]:
    """The window's instants with no device interval, as sorted disjoint
    (t0, t1) pairs (ns)."""
    w0, w1 = window
    gaps, cursor = [], w0
    for t0, t1 in sorted(busy):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= cursor:
            continue
        if t0 > cursor:
            gaps.append((cursor, t0))
        cursor = t1
    if cursor < w1:
        gaps.append((cursor, w1))
    return gaps


def _sweep(spans: List[dict], stage_calls: List[Tuple[int, int, str]],
           idle: List[Tuple[int, int]], points: List[int]):
    """One pass over every edge in time order. Yields ("idle", gap index,
    seconds, key, cat) for each piece of an idle interval and ("point",
    point index, key, cat) for each point, where ``key`` is the innermost
    naming span's name, or a stage call's unnamed key, or ``between
    stages``, and ``cat`` that span's cat (None for the last two)."""
    START, END = 1, 0       # at one instant, ends are passed before starts
    events = []
    for i, s in enumerate(spans):
        events.append((s["t0_ns"], START, 0, i))
        events.append((s["t1_ns"], END, 0, i))
    for i, (t0, t1, _) in enumerate(stage_calls):
        events.append((t0, START, 1, i))
        events.append((t1, END, 1, i))
    for i, (t0, t1) in enumerate(idle):
        events.append((t0, START, 2, i))
        events.append((t1, END, 2, i))
    for i, t in enumerate(points):
        events.append((t, 2, 3, i))     # after the starts at its instant
    events.sort()
    heap: List[tuple] = []          # (-t0, t1, span index) of open spans
    open_spans = set()
    stage = None
    gap = None
    last = None

    def owner():
        while heap and heap[0][2] not in open_spans:
            heapq.heappop(heap)
        if heap:
            s = spans[heap[0][2]]
            return s["name"], s["cat"]
        if stage is not None:
            return unnamed(stage_calls[stage][2]), None
        return BETWEEN, None

    for t, kind, what, i in events:
        if gap is not None and last is not None and t > last:
            yield ("idle", gap, (t - last) / 1e9) + owner()
        last = t
        if what == 0:
            if kind == START:
                open_spans.add(i)
                heapq.heappush(heap, (-spans[i]["t0_ns"], spans[i]["t1_ns"], i))
            else:
                open_spans.discard(i)
        elif what == 1:
            stage = i if kind == START else None
        elif what == 2:
            gap = i if kind == START else None
        else:
            yield ("point", i) + owner()


def attribute(spans: List[dict], stage_calls: List[Tuple[int, int, str]],
              busy: List[Tuple[int, int]], copies: List[Tuple[str, int, int]],
              window: Tuple[int, int]) -> dict:
    """``idle_by_span`` ({key: [seconds, idle pieces]}), ``copies_by_span``
    ({"<key> <DtoH|HtoD>": [seconds, copies]}), each with the keys of
    ``MIN_S`` seconds or more, most first, and ``idle_named_share``.
    ``spans`` are the program's span records, ``stage_calls`` the
    benchmark's (t0, t1, stage), ``busy`` every device interval and
    ``copies`` the copies' (direction, t0, t1), all in ns."""
    naming = [s for s in spans if s["cat"] not in UNNAMING]
    idle = idle_intervals(busy, window)
    mids = [(t0 + t1) // 2 for _, t0, t1 in copies]
    idle_by: Dict[str, list] = {}
    copies_by: Dict[str, list] = {}
    in_stages = named = 0.0
    counted = set()
    for piece in _sweep(naming, stage_calls, idle, mids):
        if piece[0] == "idle":
            _, g, secs, key, cat = piece
            row = idle_by.setdefault(key, [0.0, 0])
            row[0] += secs
            if (g, key) not in counted:
                counted.add((g, key))
                row[1] += 1
            if key != BETWEEN:
                in_stages += secs
                named += secs if cat is not None and cat not in COARSE else 0.0
        else:
            _, i, key, _ = piece
            direction, t0, t1 = copies[i]
            row = copies_by.setdefault(f"{key} {direction}", [0.0, 0])
            row[0] += (t1 - t0) / 1e9
            row[1] += 1
    return {"idle_by_span": _rows(idle_by), "copies_by_span": _rows(copies_by),
            "idle_named_share": named / in_stages if in_stages else None}


def _rows(by: Dict[str, list]) -> Dict[str, list]:
    return {k: v for k, v in sorted(by.items(), key=lambda kv: -kv[1][0])
            if v[0] >= MIN_S}


def device_events(prof) -> Tuple[List[Tuple[int, int]], List[Tuple[str, int, int]]]:
    """Every device interval of a ``torch.profiler`` trace, and its copies
    between host and device as (direction, t0, t1), in ns."""
    import torch

    busy, copies = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        busy.append((t0, t1))
        m = COPY.search(e.name())
        if m:
            copies.append((m.group(1), t0, t1))
    return busy, copies


def per_isolate(spans: List[dict], stage_calls: List[Tuple[int, int, str]]
                ) -> List[dict]:
    """For each ``isolate``-cat span, in order: the seconds of the program's
    stage steps by command (``cluster/<step>`` spans summed as ``cluster``,
    and so on; they do not nest in one another) beside the benchmark's own
    seconds for each stage call inside it."""
    isolates = sorted((s for s in spans if s["cat"] == "isolate"),
                      key=lambda s: s["t0_ns"])
    out = []
    for iso in isolates:
        lo, hi = iso["t0_ns"], iso["t1_ns"]
        steps: Dict[str, float] = {}
        for s in spans:
            if s["cat"] == "stage" and "/" in s["name"] and lo <= s["t0_ns"] < hi:
                cmd = s["name"].split("/", 1)[0]
                steps[cmd] = steps.get(cmd, 0.0) + (s["t1_ns"] - s["t0_ns"]) / 1e9
        calls: Dict[str, float] = {}
        for t0, t1, name in stage_calls:
            if lo <= t0 < hi:
                calls[name] = calls.get(name, 0.0) + (t1 - t0) / 1e9
        out.append({"name": iso["name"], "program_steps_s": steps,
                    "benchmark_stages_s": calls})
    return out
