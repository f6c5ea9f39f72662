"""BENCHMARK.json against the contract it is written to, and the harness
finding every cell, configuration, mix and metric by name."""

import json
import re

import pytest

from benchmark.gen import traffic as traffic_gen
from benchmark.lib import spec, window

from .helpers import bench_with_stand_in, cpu_scale

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    _top_level_keys_and_limits(BENCH)


def _top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench).encode()) <= 64 * 1024
    cells = len(bench["workloads"])
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24


def test_configs():
    _configs(BENCH)


def _configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        loaded = json.loads((spec.ROOT / c["file"]).read_text())
        assert loaded["name"] == c["name"] and loaded["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_cells():
    _cells(BENCH)


def _cells(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _text(w["why"])
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
        cell = spec.cell(bench, w["name"])
        config = cell["config"]
        assert {"n_assemblies", "chromosome_len", "n_snps", "k", "threads",
                "pool_isolates", "streams", "warmup"} <= set(config)
        # one of the two plasmid keys, in the shape and in its warm-up
        traffic_gen.plasmid_lens(config)
        traffic_gen.plasmid_lens(config["warmup"])
        window.distance_path(config)
        assert cpu_scale(config) >= 1
        assert "overlap" in cell["traffic"]
        e2e = {m["name"] for m in spec.metrics_for(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(bench, w["name"], True)
    assert len(pairs) == len(bench["workloads"])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_metrics():
    _metrics(BENCH)


def _metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _text(m["layer"])
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m.get("layer"), set()).add(m["name"])


def test_a_cell_of_the_stand_in_passes_every_spec_check():
    # the plasmid-rich fixture added as a new cell is added, a file and
    # entries, goes through the checks that BENCHMARK.json's cells do
    bench = bench_with_stand_in()
    _top_level_keys_and_limits(bench)
    _configs(bench)
    _cells(bench)
    _metrics(bench)
    assert spec.cell(bench, "plasmid-rich.clean")["config"]["plasmid_lens"]


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    assert callable(spec.reader(name))


def test_files_under_paths_are_named_from_name_characters():
    for f in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no.such.cell")
