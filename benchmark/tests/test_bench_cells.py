"""Each cell of BENCHMARK.json run once past the look for a chip, on the
CPU at a tiny size: the last line has exactly the contract's keys, with the
compared numbers last, and the program's outputs pass the check."""

import pytest

from benchmark.lib import spec

from .helpers import dry_run

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_prints_the_contract_line(workload, trace):
    rc, line, err = dry_run(workload, seed=2**31 + 17, trace=trace)
    assert rc == 0, err
    assert set(line) == LINE_KEYS and list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["check"].items():
        assert c == {"value": 0, "limit": 0}, name
        assert f"check {name} 0 limit 0" in err
    assert err.strip().splitlines()[-1].startswith("check ")
    host = {m["name"] for m in spec.metrics_for(BENCH, workload, trace)
            if m["source"] == "host_clock"}
    assert host and host <= set(line["metrics"])
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]


@pytest.mark.card
def test_card_run_reports_device_metrics(cuda_device):
    rc, line, err = dry_run("ecoli4.clean", device=cuda_device)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["device_peak_GB"]["value"] > 0
