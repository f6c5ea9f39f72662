"""The port's per-kernel device telemetry (autocycler_tpu_torch/device.py's
records folded into utils/timing.py's families, rated by ops/mfu.py) and
its profiler knobs, case for case against the JAX package's
tests/test_device_telemetry.py: the first/steady phase split, the declared
flops and bytes per phase, the snapshot's shape, the rates against the
card's peaks and the AUTOCYCLER_XPROF captures (torch.profiler Chrome
traces here). Then what the port adds: its peaks and work counts against
the bounds PERF.md gives its kernels, the work its dispatches declare,
AUTOCYCLER_PROFILE_DIR's stage traces, and the row-blocked distance
product against the JAX package's, bit for bit."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from autocycler_tpu.ops import mfu as jax_mfu
from autocycler_tpu_torch import device
from autocycler_tpu_torch.ops import mfu
from autocycler_tpu_torch.utils import timing

CPU = torch.device("cpu")
_uniq = iter(range(10_000))


def _kernel():
    return f"telemetry test kernel {next(_uniq)}"


def _snapshot(kernel):
    device.fold_records()
    return timing.device_kernel_snapshot()[kernel]


def test_first_then_steady_phase_split():
    kernel = _kernel()
    for _ in range(3):
        with device.device_work(kernel, CPU):
            pass
    snap = _snapshot(kernel)
    assert snap["first"]["count"] == 1
    assert snap["steady"]["count"] == 2
    for phase in ("first", "steady"):
        stats = snap[phase]
        assert stats["total_s"] >= 0
        assert stats["min_s"] <= stats["mean_s"] <= stats["max_s"]


def test_flops_and_bytes_accumulate_per_phase():
    kernel = _kernel()
    for _ in range(2):
        with device.device_work(kernel, CPU, flops=1e9, bytes_moved=2e6):
            pass
    snap = _snapshot(kernel)
    assert snap["first"]["flops"] == 1e9
    assert snap["steady"]["flops"] == 1e9
    assert snap["steady"]["bytes"] == 2e6


def test_failure_still_records_the_dispatch():
    kernel = _kernel()
    with pytest.raises(RuntimeError):
        with device.device_work(kernel, CPU):
            raise RuntimeError("boom")
    assert _snapshot(kernel)["first"]["count"] == 1


def test_phase_survives_first_call_failure():
    kernel = _kernel()
    with pytest.raises(ValueError):
        with device.device_work(kernel, CPU):
            raise ValueError
    with device.device_work(kernel, CPU):
        pass
    snap = _snapshot(kernel)
    assert snap["first"]["count"] == 1 and snap["steady"]["count"] == 1


# ---------------- kernel_rates (ops.mfu) ----------------

def test_kernel_rates_prefers_steady_and_anchors_peaks():
    kernels = {
        "matmul": {
            "first": {"count": 1, "total_s": 2.0, "flops": 1e12},
            "steady": {"count": 4, "total_s": 1.0, "flops": 494.5e12},
        },
        "sort": {
            "first": {"count": 1, "total_s": 0.5, "bytes": 0.1675e12},
        },
        "empty": {"first": {"count": 0, "total_s": 0.0}},
    }
    rates = mfu.kernel_rates(kernels)
    mm = rates["matmul"]
    assert mm["phase"] == "steady" and mm["count"] == 4
    assert mm["tflops"] == pytest.approx(494.5, abs=0.01)
    # 494.5e12 flops/s on the H100's 989e12 bf16 peak = 50%
    assert mm["pct_peak_bf16"] == pytest.approx(50.0, abs=0.01)
    assert mm["peak"] == "bf16" and mm["pct_peak"] == pytest.approx(50.0)
    srt = rates["sort"]
    assert srt["phase"] == "first"
    assert srt["gb_per_s"] == pytest.approx(335.0, abs=0.01)
    # 335e9 B/s against the 3.35e12 HBM3 peak = 10%
    assert srt["pct_peak_hbm"] == pytest.approx(10.0, abs=0.01)
    assert srt["peak"] == "hbm" and srt["pct_peak"] == pytest.approx(10.0)
    assert "empty" not in rates


def test_kernel_rates_without_work_hints_reports_only_timing():
    rates = mfu.kernel_rates({"k": {"steady": {"count": 2, "total_s": 0.5}}})
    assert rates["k"]["mean_s"] == 0.25
    assert "tflops" not in rates["k"] and "gb_per_s" not in rates["k"]
    assert "pct_peak" not in rates["k"]


# ---------------- XPROF capture gating ----------------

def test_xprof_disabled_without_env(monkeypatch):
    monkeypatch.delenv("AUTOCYCLER_XPROF", raising=False)
    kernel = _kernel()
    with device.device_work(kernel, CPU):
        pass
    assert kernel not in timing._xprof_counts


def test_xprof_capture_limit_and_trace_paths(tmp_path, monkeypatch):
    # the default limit is 2 captures a name; each is a Chrome trace
    monkeypatch.setenv("AUTOCYCLER_XPROF", str(tmp_path))
    monkeypatch.delenv("AUTOCYCLER_XPROF_LIMIT", raising=False)
    kernel = _kernel() + " spaced/name"
    for _ in range(4):
        with device.device_work(kernel, CPU):
            torch.ones(64).sum()
    assert timing._xprof_counts[kernel] == 2
    traces = sorted(tmp_path.iterdir())
    assert len(traces) == 2
    # path is sanitised: no spaces or slashes from the kernel name
    assert all(" " not in t.name and "/" not in t.name for t in traces)
    for t in traces:
        assert "traceEvents" in json.loads(t.read_text())


def test_xprof_limit_env_override(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_XPROF", str(tmp_path))
    monkeypatch.setenv("AUTOCYCLER_XPROF_LIMIT", "1")
    kernel = _kernel()
    for _ in range(3):
        with device.device_work(kernel, CPU):
            pass
    assert len(list(tmp_path.iterdir())) == 1


# ---------------- what the port adds ----------------

def test_xprof_links_the_span_and_never_nests(tmp_path, monkeypatch):
    """A capture is linked from its block's span as ``xprof``; inside a
    profiler the caller runs, the capture is skipped without raising."""
    from autocycler_tpu_torch.obs import trace

    monkeypatch.setenv("AUTOCYCLER_XPROF", str(tmp_path / "x"))
    monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", str(tmp_path / "run"))
    kernel = _kernel()
    assert trace.maybe_start_run(name="compress")
    try:
        with device.device_work(kernel, CPU):
            pass
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with device.device_work(kernel, CPU):
                pass
    finally:
        run_dir = trace.finish_run()
    spans = [json.loads(x) for x in
             (run_dir / "trace.jsonl").read_text().splitlines()]
    linked = [s["attrs"]["xprof"] for s in spans
              if s.get("name") == kernel and "xprof" in s.get("attrs", {})]
    assert linked == [str(tmp_path / "x" / f"{timing._safe_name(kernel)}-0"
                          ".json")]
    assert (tmp_path / "x").joinpath(linked[0]).is_file()
    assert timing._xprof_counts[kernel] == 2     # the skipped one counts
    assert len(list((tmp_path / "x").iterdir())) == 1


def test_profile_dir_writes_one_trace_per_stage(tmp_path, monkeypatch):
    """AUTOCYCLER_PROFILE_DIR: one Chrome trace per stage_timer at
    <dir>/<stage>/trace-<n>.json; a stage inside a profiled one is not
    profiled again, and nothing raises."""
    monkeypatch.setenv("AUTOCYCLER_PROFILE_DIR", str(tmp_path))
    with timing.stage_timer("compress/build_graph"):
        torch.ones(16).sum()
        with timing.stage_timer("compress/inner"):
            pass
    with timing.stage_timer("compress/build_graph"):
        pass
    traces = sorted(p.relative_to(tmp_path).as_posix()
                    for p in tmp_path.rglob("*.json"))
    assert traces[:2] == ["compress/build_graph/trace-0.json",
                          "compress/build_graph/trace-1.json"]
    assert "compress/inner/trace-0.json" not in traces
    for t in traces:
        assert "traceEvents" in json.loads((tmp_path / t).read_text())


def test_mfu_structure_matches_jax_with_the_h100_peaks():
    """kernel_rates and sort_bandwidth give the JAX package's keys on the
    same snapshot (the port adds ``peak`` and ``pct_peak``), and the
    port's numbers against the H100's peaks."""
    snap = {"cluster distance matmul": {
                "first": {"count": 1, "total_s": 0.2, "flops": 6.7e12}},
            "dotplot_match_grid": {
                "steady": {"count": 2, "total_s": 0.01,
                           "flops": mfu.H100_INT_OPS / 100, "bytes": 3.35e9}},
            "sortnet_pack_rank": {
                "first": {"count": 1, "total_s": 1.0},
                "steady": {"count": 3, "total_s": 0.02, "bytes": 6.7e9}}}
    got, want = mfu.kernel_rates(snap), jax_mfu.kernel_rates(snap)
    assert set(got) == set(want)
    for name in got:
        assert set(got[name]) - {"peak", "pct_peak"} == set(want[name])
        assert {k: got[name][k] for k in ("phase", "count", "total_s",
                                          "mean_s")} == \
            {k: want[name][k] for k in ("phase", "count", "total_s",
                                        "mean_s")}
    # f64 product: 33.5e12 FLOP/s of the 67e12 f64 peak
    assert got["cluster distance matmul"]["peak"] == "f64"
    assert got["cluster distance matmul"]["pct_peak"] == pytest.approx(50.0)
    # word compare: 33.5e12 instructions/s, the CUDA cores' whole rate
    assert got["dotplot_match_grid"]["peak"] == "int"
    assert got["dotplot_match_grid"]["pct_peak"] == pytest.approx(100.0)
    assert got["sortnet_pack_rank"]["pct_peak_hbm"] == pytest.approx(10.0)
    for args in ((1 << 20, 6, 0.001), (1 << 20, 6, 0.001, 3), (5, 1, 0.0)):
        assert set(mfu.sort_bandwidth(*args)) == \
            set(jax_mfu.sort_bandwidth(*args))
    assert mfu.sort_bandwidth(1e9, 1, 16 / 3.35e3)["pct_peak"] == \
        pytest.approx(100.0)
    assert set(mfu.mxu_grid_mfu(1.0, 32)) == set(jax_mfu.mxu_grid_mfu(1.0,
                                                                      32))
    assert set(mfu.vpu_grid_mfu(1.0, 32)) == set(jax_mfu.vpu_grid_mfu(1.0,
                                                                      32))


def test_mfu_reproduces_the_kernel_bounds_in_perf():
    """PERF.md §6's bounds at 524,288^2, k = 32: the word compare 24.65 ms
    (operations), the +-1 product 35.58 ms bf16 and 17.78 ms int8; and
    pct_peak x kernel time = bound for the rates the grid entry reports."""
    cells = 524_288.0 ** 2
    assert mfu.word_compare_ops(cells, 32) / mfu.H100_INT_OPS * 1e3 == \
        pytest.approx(24.649720477502296, rel=1e-12)
    assert mfu.pm1_product_ops(cells, 32) / mfu.H100_BF16_FLOPS * 1e3 == \
        pytest.approx(35.57570484209505, rel=1e-12)
    assert mfu.pm1_product_ops(cells, 32) / mfu.H100_INT8_OPS * 1e3 == \
        pytest.approx(17.778864117651338, rel=1e-12)
    for ms, fn, bound in ((37.32432174682617, mfu.vpu_grid_mfu,
                           24.649720477502296),
                          (55.6126708984375, mfu.mxu_grid_mfu,
                           35.57570484209505)):
        rate = cells / (ms * 1e-3) / 1e9
        assert fn(rate, 32)["pct_peak"] / 100 * ms == \
            pytest.approx(bound, rel=2e-3)
    assert mfu.mxu_grid_mfu(cells / 46.92758560180664e-3 / 1e9, 32,
                            int8=True)["pct_peak"] / 100 * \
        46.92758560180664 == pytest.approx(17.778864117651338, rel=2e-3)


def test_grouping_bytes_count_each_input_once():
    """The grouping's bound counts the code bytes the windows cover (the
    union of their k-byte ranges), the int32 starts and the two int32
    outputs once: chip_smoke.py's bound and an interval union agree."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(1, 5, 5000).astype(np.uint8))
    starts = torch.from_numpy(np.sort(rng.choice(4900, 700, replace=False))
                              .astype(np.int32))
    k = 25
    covered = np.zeros(len(codes), bool)
    for s in starts.numpy():
        covered[s:s + k] = True
    want = covered.sum() + 12 * len(starts)
    assert mfu.grouping_bytes(int(covered.sum()), len(starts)) == want
    assert chip_smoke._sortnet_bound_ms(codes, starts, k) == \
        pytest.approx(want / mfu.H100_HBM_BYTES * 1e3, rel=1e-12)
    assert chip_smoke.HBM_BYTES_PER_S == mfu.H100_HBM_BYTES
    assert chip_smoke.INT_OPS == mfu.H100_INT_OPS


def test_port_dispatches_declare_their_work(tmp_path, monkeypatch):
    """A compress and an exact cluster on the CPU fold the JAX package's
    declarations: bytes on the grouping, the adjacency and the chains,
    2 S U S flops on the distance product."""
    from synthetic import make_assemblies

    from autocycler_tpu_torch.commands.cluster import cluster
    from autocycler_tpu_torch.commands.compress import compress
    from autocycler_tpu_torch.ops import distance

    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=3000,
                          plasmid_len=500)
    seen = []
    real = distance.intersections
    monkeypatch.setattr(distance, "intersections", lambda M, w, dev=None: (
        seen.append(M.shape) or real(M, w, dev)))
    timing.reset()
    device.reset_counts()
    compress(asm, tmp_path / "out", device="cpu")
    cluster(tmp_path / "out", device="cpu")
    device.fold_records()
    snap = timing.device_kernel_snapshot()
    for name in ("sortnet_pack_rank", "adjacency segment ops",
                 "chain pointer doubling"):
        assert all(p.get("bytes", 0) > 0 for p in snap[name].values()), name
    S, U = seen[0]
    flops = sum(p["flops"] for p in snap["cluster distance matmul"].values())
    assert flops == 2.0 * S * U * S
    rates = mfu.kernel_rates(snap)
    assert rates["cluster distance matmul"]["peak"] == "f64"
    declared = [r for r in rates.values() if "peak" in r]
    assert len(declared) == 4
    assert all(0 < r["pct_peak"] < 100 for r in declared)


@pytest.mark.parametrize("block", [1, 3, 1000])
def test_row_blocked_distance_product_equals_jax(block, monkeypatch):
    """The JAX package's host path contracts AUTOCYCLER_DISTANCE_BLOCK
    rows at a time (1, 3 and more than the row count here); the port's
    product of the whole operand equals each, bit for bit."""
    from autocycler_tpu.ops import distance as jax_distance
    from autocycler_tpu_torch.ops import distance

    rng = np.random.default_rng(block)
    M = (rng.random((11, 300)) < 0.3).astype(np.uint8)
    w = rng.integers(1, 100_000, size=300).astype(np.int64)
    monkeypatch.setenv("AUTOCYCLER_DISTANCE_BLOCK", str(block))
    got = distance._intersections_to_matrix(
        distance.intersections(M, w, "cpu"))
    want = jax_distance.pairwise_distance_matrix(M, w, use_jax=False)
    assert np.array_equal(got, want, equal_nan=True)
    assert got.tobytes() == want.tobytes()
