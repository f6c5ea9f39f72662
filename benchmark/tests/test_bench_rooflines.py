"""The metric readers' arithmetic on fixed records and shapes."""

import pytest
import torch

from benchmark.lib import instrument, peaks, spec


def _record(**iso):
    base = {"wall_s": 1.0, "stages": {}, "substages": {}, "grouping": [],
            "overlap_dp": [], "stage_peaks": {}, "stream": {}}
    base.update(iso)
    return {"isolates": [base], "window_s": 2.0, "setup_s": 3.0,
            "device_peak_bytes": 2_500_000_000}


def test_overlap_dp_roofline_at_the_headline_overlap_shape():
    # 12 jobs at K 5000: 300 M cells, 20 instructions each, is 0.179 ms
    read = spec.reader("overlap_dp_roofline_pct")
    rec = _record(overlap_dp=[{"k": [5000] * 12, "ms": 3578.0}])
    least = 20 * 12 * 5000**2 / peaks.H100_INSTRUCTIONS_PER_S
    assert least == pytest.approx(0.179e-3, rel=0.01)
    assert read(rec) == pytest.approx(100 * least / 3.578)
    assert spec.reader("overlap_dp_ms")(rec) == pytest.approx(3578.0)


def test_overlap_dp_work_and_what_binds():
    from importlib import util
    path = spec.BENCH_DIR / "metrics" / "overlap_dp_roofline_pct.py"
    mod_spec = util.spec_from_file_location("_t_dp", path)
    mod = util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    ops, nbytes = mod.call_work([5000] * 12)
    assert ops == 20 * 3e8
    assert nbytes == 12 * (5000**2 / 8 + 40 * 5000)
    assert peaks.least_seconds(ops, nbytes)[1] == "operations"
    assert peaks.least_seconds(0, 1e9)[1] == "bytes"


def test_grouping_roofline_over_the_kernels_time_in_the_trace():
    read = spec.reader("grouping_roofline_pct")
    rec = _record(grouping=[{"windows": 1_000_000, "code_bytes": 1_000_050, "ms": 2.0},
                            {"windows": 10, "code_bytes": 60, "ms": 1.0}])
    rec["trace"] = {"op_s": {
        "void (anonymous namespace)::hist0_kernel<2>(unsigned char const*, int const*)": 2e-4,
        "_ZN12_GLOBAL__N_115sort_reg_kernelILi2EEEvPKi": 3e-4,
        "void at::native::_scatter_gather_elementwise_kernel<128, 4>(int)": 5.0,
        "Memcpy DtoH (Device -> Pageable)": 7.0}}
    nbytes = 1_000_050 + 9 * 1_000_000 + 60 + 9 * 10
    assert read(rec) == pytest.approx(100 * nbytes / peaks.H100_HBM_BYTES_PER_S / 5e-4)
    assert spec.reader("grouping_ms")(rec) == pytest.approx(3.0)
    rec["trace"]["op_s"] = {"Memcpy DtoH (Device -> Pageable)": 7.0}
    assert read(rec) is None


def test_grouping_shapes_are_read_on_the_host(monkeypatch):
    # the wrapper records k bytes a window up to the whole buffer, as
    # ops/mfu.py counts them, and launches nothing of its own
    class Event:
        def record(self):
            pass

    instr = instrument.Instrument(torch.device("cpu"), False)
    monkeypatch.setattr(instr, "_events", lambda: (Event(), Event()))
    timed = instr._grouping(lambda codes, starts, k: (starts, starts))
    timed(torch.zeros(200, dtype=torch.uint8), torch.tensor([100, 0, 3]), 5)
    timed(torch.zeros(200, dtype=torch.int32), torch.arange(196), 5)
    shapes = [shape for _, _, _, shape in instr._pending]
    assert shapes == [{"windows": 3, "code_bytes": 15},
                      {"windows": 196, "code_bytes": 800}]


def test_host_and_device_readers():
    rec = _record(stages={"compress": 1.5, "trim": 0.25},
                  substages={"stream-bin": 0.75})
    rec["trace"] = {"busy_s": 0.5, "window_s": 2.0}
    assert spec.reader("isolate_s")(rec) == 2.0
    assert spec.reader("setup_s")(rec) == 3.0
    assert spec.reader("device_peak_GB")(rec) == 2.5
    assert spec.reader("compress_s")(rec) == 1.5
    assert spec.reader("trim_s")(rec) == 0.25
    assert spec.reader("stream_bin_s")(rec) == 0.75
    assert spec.reader("device_idle_pct")(rec) == 75.0
    assert spec.reader("isolate_wall_s")(rec) == 2.0
    rec["isolates"].append(dict(rec["isolates"][0],
                                stage_peaks={"compress": 2_000_000_000}))
    rec["isolates"][0]["stage_peaks"] = {"compress": 1_500_000_000, "trim": 10}
    assert spec.reader("compress_peak_GB")(rec) == 2.0


def test_stage_peaks_and_the_window_peak_from_the_allocator(monkeypatch):
    # a fake allocator: each stage allocates its own peak over a resting 5
    state = {"peak": 40, "resets": 0}

    def reset(device=None):
        state["peak"] = 5
        state["resets"] += 1

    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: state["peak"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    instr = instrument.Instrument(torch.device("cpu"), False)
    instr.trace = True
    instr.install()
    try:
        instr.begin_isolate()
        for name, peak in (("compress", 30), ("trim", 12), ("compress", 20)):
            with instr.stage(name):
                state["peak"] = max(state["peak"], peak)
    finally:
        instr.uninstall()
    assert instr.current.stage_peaks == {"compress": 30, "trim": 12}
    assert state["resets"] == 3
    assert instr.peak_bytes() == 40  # the window's start, before any stage


@pytest.mark.parametrize("name", ["stream_bin_s", "overlap_dp_ms", "overlap_dp_roofline_pct",
                                  "grouping_ms", "grouping_roofline_pct", "device_idle_pct",
                                  "compress_peak_GB"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert spec.reader(name)(_record()) is None


def test_idle_gaps_are_cut_at_stage_edges_and_labelled():
    class E:
        def __init__(self, name, t0, dur, dev=torch.autograd.DeviceType.CUDA):
            self.n, self.t0, self.dur, self.dev = name, t0, dur, dev

        def name(self):
            return self.n

        def device_type(self):
            return self.dev

        def start_ns(self):
            return self.t0

        def duration_ns(self):
            return self.dur

    events = [E("k1", 100, 100), E("k2", 150, 100), E("k1", 700, 50),
              E("host op", 300, 500, torch.autograd.DeviceType.CPU)]

    class P:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    spans = [(0, 600, "compress"), (600, 900, "trim")]
    t = instrument.read_trace(P, spans, (0, 1000))
    assert t["busy_s"] == pytest.approx(200e-9) and t["window_s"] == pytest.approx(1e-6)
    assert t["device_events"] == 3
    assert t["idle_gaps"] == [["compress", pytest.approx(350e-9)],
                              ["trim", pytest.approx(150e-9)],
                              ["compress", pytest.approx(100e-9)],
                              ["trim", pytest.approx(100e-9)],
                              ["between stages", pytest.approx(100e-9)]]
    assert t["device_ops"][0] == ("k1", pytest.approx(150e-9))
    assert t["op_s"] == {"k1": pytest.approx(150e-9), "k2": pytest.approx(100e-9)}


def test_op_seconds_are_cut_at_the_window():
    class E:
        def __init__(self, t0, dur):
            self.t0, self.dur = t0, dur

        def name(self):
            return "k"

        def device_type(self):
            return torch.autograd.DeviceType.CUDA

        def start_ns(self):
            return self.t0

        def duration_ns(self):
            return self.dur

    class P:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [E(-50, 100), E(900, 200), E(2000, 10)]

    t = instrument.read_trace(P, [], (0, 1000))
    assert t["op_s"] == {"k": pytest.approx(150e-9)}
    assert t["busy_s"] == pytest.approx(150e-9)
