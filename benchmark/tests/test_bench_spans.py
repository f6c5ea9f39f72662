"""The readers of the program's spans and counters, the attribution of the
card's idle time and copies to the program's spans (``lib/attribute.py``),
``spans.py``'s hooks, and the clock those rest on, on the card."""

import json
import time

import pytest
import torch

from benchmark import spans as spans_script
from benchmark.lib import attribute, instrument, spec

T = 100_000_000     # ns: the attribution timelines count in tenths of s
MS = 1_000_000


def _record(*substages):
    return {"isolates": [{"wall_s": 1.0, "stages": {}, "substages": s,
                          "grouping": [], "overlap_dp": [], "stage_peaks": {},
                          "stream": {}} for s in substages],
            "window_s": 2.0, "setup_s": 3.0, "device_peak_bytes": 1}


def test_command_seconds_sum_their_prefix_per_isolate():
    rec = _record({"cluster-parse": 2.0, "cluster-upgma": 1.0,
                   "resolve-apply": 0.5, "stream-bin": 9.0},
                  {"cluster-parse": 3.0, "resolve-save": 1.5,
                   "resolve-apply": 1.0})
    assert spec.reader("cluster_s")(rec) == pytest.approx(3.0)
    assert spec.reader("resolve_s")(rec) == pytest.approx(1.5)
    assert spec.reader("cluster_s")(_record({"stream-bin": 1.0})) is None
    assert spec.reader("resolve_s")(_record()) is None


def test_probe_wait_reads_the_programs_counter():
    from autocycler_tpu_torch.obs import metrics_registry
    from autocycler_tpu_torch.utils import timing

    read = spec.reader("probe_wait_s")
    metrics_registry.reset()
    assert read(_record()) is None
    with timing.device_wait("probe future"):
        time.sleep(0.01)
    assert read(_record()) == pytest.approx(timing.device_wait_seconds())
    assert read(_record()) >= 0.01
    metrics_registry.reset()


def _span(name, cat, t0, t1):
    return {"name": name, "cat": cat, "t0_ns": round(t0 * T),
            "t1_ns": round(t1 * T)}


def _rows(rows):
    return {k: [round(v[0], 9), v[1]] for k, v in rows.items()}


def test_idle_goes_to_the_innermost_span():
    spans = [_span("isolate/0", "isolate", 0, 100),
             _span("cluster/load", "stage", 10, 50),
             _span("cluster-parse", "substage", 20, 40),
             _span("sortnet_pack_rank", "device", 25, 30)]
    stage_calls = [(5 * T, 60 * T, "cluster"), (70 * T, 90 * T, "trim")]
    # the card is busy 0-15 and 27-28, so idle 15-27, 28-100
    busy = [(0, 15 * T), (27 * T, 28 * T)]
    copies = [("DtoH", 27 * T, 28 * T), ("HtoD", 0, 2 * T)]
    out = attribute.attribute(spans, stage_calls, busy, copies, (0, 100 * T))
    idle = _rows(out["idle_by_span"])
    # 15-20 and 40-50 under the stage, 20-25 and 30-40 under the substage,
    # 25-27 and 28-30 under the device span; 50-60 and 70-90 in stage calls
    # under no program span, 60-70 and 90-100 outside both; a row counts
    # the idle intervals it has a piece of
    assert idle == ({
        "cluster-parse": [1.5, 2], "cluster/load": [1.5, 2],
        "cluster (unnamed)": [1.0, 1], "trim (unnamed)": [2.0, 1],
        "between stages": [2.0, 1], "sortnet_pack_rank": [0.4, 2]})
    assert _rows(out["copies_by_span"]) == ({
        "sortnet_pack_rank DtoH": [0.1, 1],
        "between stages HtoD": [0.2, 1]})
    # named: the substage's and the device span's 1.9 s of the 6.4 s
    # idle inside stage calls
    assert out["idle_named_share"] == pytest.approx(1.9 / 6.4)


def test_rows_below_the_floor_are_left_out_but_counted():
    spans = [_span("cluster-parse", "substage", 0, 0.4),
             _span("cluster-upgma", "substage", 0.4, 0.5)]
    out = attribute.attribute(spans, [(0, 0.5 * T, "cluster")], [], [],
                              (0, 0.5 * T))
    assert list(out["idle_by_span"]) == []     # 40 ms and 10 ms: both < 50 ms
    assert out["idle_named_share"] == pytest.approx(1.0)
    out = attribute.attribute([_span("s", "substage", 0, 2)],
                              [(0, 2 * T, "cluster")], [], [], (0, 2 * T))
    assert out["idle_by_span"] == {"s": [pytest.approx(0.2), 1]}


def test_overlapping_spans_of_two_threads_go_to_the_later_start():
    spans = [_span("main", "substage", 0, 100), _span("pool", "substage", 40, 60)]
    out = attribute.attribute(spans, [(0, 100 * T, "compress")], [], [],
                              (0, 100 * T))
    assert _rows(out["idle_by_span"]) == ({"main": [8.0, 1],
                                                 "pool": [2.0, 1]})


def test_per_isolate_program_steps_beside_the_stage_calls():
    spans = [_span("isolate/0", "isolate", 0, 100),
             _span("cluster/load", "stage", 1, 3),
             _span("cluster/tree", "stage", 3, 6),
             _span("cluster-parse", "substage", 1, 2),
             _span("resolve/apply", "stage", 7, 9),
             _span("isolate/1", "isolate", 100, 200),
             _span("cluster/load", "stage", 101, 102)]
    calls = [(0, 6 * T, "cluster"), (7 * T, 9 * T, "resolve"),
             (101 * T, 103 * T, "cluster")]
    assert attribute.per_isolate(spans, calls) == [
        {"name": "isolate/0",
         "program_steps_s": {"cluster": pytest.approx(0.5),
                             "resolve": pytest.approx(0.2)},
         "benchmark_stages_s": {"cluster": pytest.approx(0.6),
                                "resolve": pytest.approx(0.2)}},
        {"name": "isolate/1", "program_steps_s": {"cluster": pytest.approx(0.1)},
         "benchmark_stages_s": {"cluster": pytest.approx(0.2)}}]


class _Event:
    def __init__(self, name, t0, dur, cuda=True):
        self._name, self._t0, self._dur, self._cuda = name, t0, dur, cuda

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._dur

    def name(self):
        return self._name


class _Prof:
    """What ``read_trace`` and ``device_events`` read of a profiler."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


EVENTS = [_Event("hist0_kernel", 10 * MS, 2 * MS),
          _Event("Memcpy DtoH (Device -> Pageable)", 20 * MS, 5 * MS),
          _Event("Memcpy HtoD (Pageable -> Device)", 40 * MS, 1 * MS),
          _Event("aten::mm", 0, 90 * MS, cuda=False),
          _Event("hist0_kernel", 95 * MS, 10 * MS)]


def test_read_trace_and_the_readers_it_feeds_are_unchanged():
    """``read_trace`` and the existing readers read a fixed record as they
    did before the program's spans were added."""
    out = instrument.read_trace(_Prof(EVENTS), [(0, 30 * MS, "compress"),
                                                (35 * MS, 80 * MS, "trim")],
                                (0, 100 * MS))
    assert out["busy_s"] == pytest.approx(0.013)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["device_events"] == 4
    assert out["first_event_after_window_start_s"] == pytest.approx(0.01)
    assert out["op_s"] == pytest.approx({
        "hist0_kernel": 0.007, "Memcpy DtoH (Device -> Pageable)": 0.005,
        "Memcpy HtoD (Pageable -> Device)": 0.001})
    # idle 0-10, 12-20, 25-40 and 41-95, cut at the stage calls' edges
    assert out["idle_gaps"] == [
        ["trim", pytest.approx(0.039)], ["between stages", pytest.approx(0.015)],
        ["compress", pytest.approx(0.010)], ["compress", pytest.approx(0.008)],
        ["compress", pytest.approx(0.005)], ["trim", pytest.approx(0.005)],
        ["between stages", pytest.approx(0.005)]]
    rec = _record({"stream-bin": 4.0})
    rec["isolates"][0]["stages"] = {"compress": 5.0, "trim": 2.0}
    rec["trace"] = out
    assert spec.reader("device_idle_pct")(rec) == pytest.approx(87.0)
    assert spec.reader("stream_bin_s")(rec) == pytest.approx(4.0)
    assert spec.reader("trim_s")(rec) == pytest.approx(2.0)
    assert spec.reader("compress_s")(rec) == pytest.approx(5.0)


def test_device_events_are_the_cuda_intervals_and_their_copies():
    busy, copies = attribute.device_events(_Prof(EVENTS))
    assert busy == [(10 * MS, 12 * MS), (20 * MS, 25 * MS), (40 * MS, 41 * MS),
                    (95 * MS, 105 * MS)]
    assert copies == [("DtoH", 20 * MS, 25 * MS), ("HtoD", 40 * MS, 41 * MS)]


def test_the_hooks_hold_the_programs_spans_for_the_window(capsys):
    """``spans.py``'s hooks, with stand-ins for the profiler and the stages:
    the window's isolate runs inside an in-memory program run and an
    ``isolate/0`` span; its substage's idle time is named."""
    import types

    from autocycler_tpu_torch.obs import trace
    from autocycler_tpu_torch.utils import timing

    calls = []

    def real_isolate(asm, out, config, device, instr):
        with timing.stage_timer("cluster/load"), timing.substage("cluster-parse"):
            time.sleep(0.3)

    def real_read(prof, stage_calls, window_ns):
        calls.append(window_ns)
        return {}

    window = types.SimpleNamespace(run_isolate=real_isolate)
    instrument_ns = types.SimpleNamespace(start_profiler=lambda: _Prof([]),
                                          read_trace=real_read)
    run_ns = types.SimpleNamespace(finish=lambda *a: 0)
    hooks = spans_script.ProgramSpans()
    hooks.install(window, instrument_ns, run_ns)
    window.run_isolate(None, None, None, None, None)       # the warm-up
    prof = instrument_ns.start_profiler()
    w0 = time.time_ns()
    window.run_isolate(None, None, None, None, None)
    w1 = time.time_ns()
    assert not trace.tracing_active() or trace.trace_dir() is None
    instrument_ns.read_trace(prof, [(w0, w1, "cluster")], (w0, w1))
    assert not trace.tracing_active() and calls == [(w0, w1)]
    assert run_ns.finish() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["spans"]
    assert list(line["idle_by_span"]) == ["cluster-parse"]
    assert line["idle_named_share"] > 0.5
    (iso,) = line["isolates"]
    assert iso["name"] == "isolate/0" and iso["to_host_GB"] == 0.0
    assert iso["program_steps_s"]["cluster"] >= 0.3


@pytest.mark.card
def test_a_kernel_lies_inside_its_program_span(cuda_device):
    """A ``torch.cuda._sleep`` kernel launched inside a program span that
    ends in a synchronise lies, on the profiler's clock, inside the span's
    [t0_ns, t1_ns], within 0.1 ms at each edge."""
    from autocycler_tpu_torch.obs import trace

    torch.cuda._sleep(1000)
    torch.cuda.synchronize(cuda_device)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    run = trace.open_run(None, name="card-clock")
    with trace.span("sleep", cat="device"):
        torch.cuda._sleep(20_000_000)          # ~10 ms at ~2 GHz
        torch.cuda.synchronize(cuda_device)
    (span,) = trace.close_run(run)
    prof.stop()
    # the sleep (ATen's ``spin_kernel``) is the window's one long kernel
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.duration_ns() > 1_000_000]
    assert len(kernels) == 1, [e.name() for e in kernels]
    k0 = kernels[0].start_ns()
    k1 = k0 + kernels[0].duration_ns()
    print(f"span {span['t0_ns']} .. {span['t1_ns']}; {kernels[0].name()} starts "
          f"{(k0 - span['t0_ns']) / 1e3:.1f} us in, ends "
          f"{(span['t1_ns'] - k1) / 1e3:.1f} us before the span")
    assert span["t0_ns"] - 100_000 <= k0 < k1 <= span["t1_ns"] + 100_000
