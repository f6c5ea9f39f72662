"""BENCHMARK.json against the contract it is written to, and the harness
finding every cell, configuration, mix and metric by name."""

import json
import re

import pytest

from benchmark.lib import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        loaded = json.loads((spec.ROOT / c["file"]).read_text())
        assert loaded["name"] == c["name"] and loaded["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_cells():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _text(w["why"])
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
        cell = spec.cell(BENCH, w["name"])
        assert {"n_assemblies", "chromosome_len", "plasmid_len", "n_snps", "k",
                "threads", "pool_isolates", "warmup"} <= set(cell["config"])
        assert "overlap" in cell["traffic"]
        e2e = {m["name"] for m in spec.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(BENCH, w["name"], True)
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _text(m["layer"])
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m.get("layer"), set()).add(m["name"])


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
