"""What a cell is made of, found by name: ``BENCHMARK.json``'s entries,
``configs/<name>.json`` (by the ``file`` its entry names),
``traffic/<name>.json`` and ``metrics/<name>.py``. A new cell, mix or metric
is a new file and a new entry; no code here names one."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The workload's entry with its configuration and traffic loaded."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "name": workload,
        "chips": entry["chips"],
        "config": json.loads((Path(root) / config["file"]).read_text()),
        "traffic": json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
                              .read_text()),
    }


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(record)``: the metric's value from a
    run's record, or None where the run gave it nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    module_name = "_bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
