"""Each cell of BENCHMARK.json run once past the look for a chip, on the
CPU at a tiny size: the last line has exactly the contract's keys, with the
compared numbers last, and the program's outputs pass the check."""

import json

import pytest
import torch

from benchmark.gen import synthetic, traffic as traffic_gen
from benchmark.lib import instrument, spec, window

from .helpers import (PLASMID_RICH, STAND_IN, bench_with_stand_in, config_run,
                      dry_run)
from .test_bench_spans import _Event as _DeviceEvent, _Prof

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS + [STAND_IN])
def test_dry_run_prints_the_contract_line(workload, trace):
    # every cell, and a cell of the plasmid-rich fixture added as a new
    # cell is added: entries and a file
    bench = bench_with_stand_in()
    rc, line, err = dry_run(workload, seed=2**31 + 17, trace=trace, bench=bench)
    assert rc == 0, err
    assert set(line) == LINE_KEYS and list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["check"].items():
        assert c == {"value": 0, "limit": 0}, name
        assert f"check {name} 0 limit 0" in err
    assert err.strip().splitlines()[-1].startswith("check ")
    host = {m["name"] for m in spec.metrics_for(bench, workload, trace)
            if m["source"] == "host_clock"}
    assert host and host <= set(line["metrics"])
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_diagnostics_carry_each_stages_host_cost_and_the_hosts_speed():
    # the line before the result: each stage call's CPU seconds and bytes
    # written, beside its wall, and the fixed probe of the host's speed
    import contextlib
    import io
    import time

    from benchmark import run

    out, err = io.StringIO(), io.StringIO()
    run._T_START = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.execute("ecoli4.clean", 11, 0.1, False, torch.device("cpu"),
                         scale=20)
    assert rc == 0, err.getvalue()
    diag = json.loads(out.getvalue().strip().splitlines()[-2])["diagnostics"]
    assert diag["host_speed"]["python_s"] > 0 and diag["host_speed"]["sort_s"] > 0
    for iso in diag["per_isolate"]:
        assert set(iso["host"]) == set(iso["stages"])
        for name, spent in iso["host"].items():
            assert spent["user_s"] + spent["sys_s"] > 0, name
            assert spent["user_s"] + spent["sys_s"] < 64 * iso["stages"][name] + 1
        assert iso["host"]["compress"]["wchar"] > 0


@pytest.mark.card
def test_card_run_reports_device_metrics(cuda_device):
    rc, line, err = dry_run("ecoli4.clean", device=cuda_device)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["device_peak_GB"]["value"] > 0


def test_a_plasmid_rich_configuration_takes_the_sketch_path():
    # 264 contigs: cluster's auto mode sketches, and the reference check
    # finds eleven replicons, of plasmids of 2-5 kb with SNPs on them
    line, record = config_run(PLASMID_RICH, seed=2**31 + 23)
    assert line["correct"] is True and line["failed"] == 0, line["check"]
    assert all(c["value"] == 0 for c in line["check"].values())
    assert record["isolates"]
    for r in record["isolates"]:
        assert r["qc_pass_clusters"] == 11 and r["stream"]["bins"]
        assert "cluster-sketch-distances" in r["substages"]
        assert "cluster-distance-product" not in r["substages"]


class _Event:
    def record(self):
        pass

    def elapsed_time(self, end):
        return 0.5


@pytest.mark.parametrize("config,scale,hashed,grids", [
    (PLASMID_RICH, PLASMID_RICH["cpu_scale"], 264, 1),
    ("kleb-24x6M", 200, 0, 0),
    ("ecoli-4x4.6M", 50, 0, 0),
], ids=["plasmid-rich", "kleb-24x6M", "ecoli-4x4.6M"])
def test_traced_isolates_record_each_sketch_call(monkeypatch, tmp_path, config,
                                                 scale, hashed, grids):
    # the wrappers of --trace 1 on the CPU, with the CUDA events, the
    # allocator's peak and the profiler faked: one hashing entry a contig
    # hashed and one grid entry a grid, each with its shapes, its events'
    # ms, and its own kernels' and copies' ms from the trace;
    # the existing cells make none
    if isinstance(config, str):
        entry = next(c for c in spec.load_benchmark()["configs"] if c["name"] == config)
        config = json.loads((spec.ROOT / entry["file"]).read_text())
    config = traffic_gen.scaled(config, scale)
    files = traffic_gen.isolate(config, {}, 2**31 + 29, 0)
    asm = synthetic.write_isolate(files, tmp_path / "in")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda device=None: None)
    instr = instrument.Instrument(torch.device("cpu"), False)
    monkeypatch.setattr(instr, "_events", lambda: (_Event(), _Event()))
    instr.trace = True
    instr.install()
    try:
        rec = instr.begin_isolate()
        with window._environment(config.get("env", {})):
            window.run_isolate(asm, tmp_path / "out", config, torch.device("cpu"), instr)
        instr.end_isolate()
    finally:
        instr.uninstall()
    assert len(rec.sketch_hash) == hashed and len(rec.sketch_grid) == grids
    assert rec.as_dict()["sketch_hash"] is rec.sketch_hash
    if not hashed:
        return
    lengths = sorted(len(seq) for _, records in files for _, seq in records)
    assert sorted(c["positions"] for c in rec.sketch_hash) == lengths
    assert {(c["k"], c["w"], c["s"], c["ms"]) for c in rec.sketch_hash} == \
        {(21, 11, 1024, 0.5)}
    (grid,) = rec.sketch_grid
    assert (grid["contigs"], grid["s"], grid["ms"]) == (hashed, 1024, 0.5)
    # a kernel and a copy inside the second hashing call and the grid, and
    # a kernel before the first call: each call reads its own alone
    (a0, a1), (g0, g1) = rec.sketch_hash[1]["_ns"], grid["_ns"]
    start = rec.sketch_hash[0]["_ns"][0]
    assert a1 > a0 + 3 and g1 > g0 + 3
    events = [_DeviceEvent("minima_kernel", a0 + 1, 3_000),
              _DeviceEvent("Memcpy DtoH (Device -> Pageable)", a0 + 2, 2_000),
              _DeviceEvent("searchsorted_kernel", g0 + 1, 7_000),
              _DeviceEvent("Memcpy HtoD (Pageable -> Device)", g0 + 2, 5_000),
              _DeviceEvent("encode_kernel", start - 10, 9_000),
              _DeviceEvent("aten::unique", a0 + 3, 4_000, cuda=False)]
    instrument.call_device_ms(_Prof(events), [rec])
    assert (rec.sketch_hash[1]["kernel_ms"], rec.sketch_hash[1]["copy_ms"]) == (0.003, 0.002)
    assert (grid["kernel_ms"], grid["copy_ms"]) == (0.007, 0.005)
    others = rec.sketch_hash[:1] + rec.sketch_hash[2:]
    assert {(c["kernel_ms"], c["copy_ms"]) for c in others} == {(0.0, 0.0)}
    assert not any("_ns" in c for c in rec.sketch_hash + rec.sketch_grid)
