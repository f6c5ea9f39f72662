"""Tiny runs of the harness on the CPU, for the benchmark's tests."""

import contextlib
import io
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib import spec  # noqa: E402

# the CPU tests divide every length of a configuration by its ``cpu_scale``,
# a key of its file; the two files that predate the key keep theirs here:
# 232 kb E. coli chromosomes, 150 kb Klebsiella ones with 3 kb plasmids
# (streamed, as at their own size)
PRE_KEY_SCALES = {"kleb-24x6M": 40, "ecoli-4x4.6M": 20}


def cpu_scale(config: dict) -> float:
    if "cpu_scale" in config:
        return config["cpu_scale"]
    return PRE_KEY_SCALES[config["name"]]


# a configuration that BENCHMARK.json does not hold, a test fixture with
# guessed lengths: a chromosome and ten plasmids, 24 times (264 contigs, so
# cluster sketches); divided by its cpu_scale, 50, its chromosomes are
# 106 kb and its plasmids 2-5 kb (scaled()'s floor)
STAND_IN_FILE = "benchmark/tests/data/plasmid-rich-24x5.3M.json"
PLASMID_RICH = json.loads((ROOT / STAND_IN_FILE).read_text())
STAND_IN = "plasmid-rich.clean"


def bench_with_stand_in() -> dict:
    """BENCHMARK.json with the entries that a new cell of the stand-in
    would add, and nothing else changed: its configuration, a cell of
    it under the clean traffic, and that cell in ``isolate_wall_s``'s list,
    as ``ecoli4.clean`` is. A file and entries: no code of the harness."""
    bench = spec.load_benchmark()
    bench["configs"].append({
        "name": PLASMID_RICH["name"], "source": PLASMID_RICH["source"],
        "file": STAND_IN_FILE, "reduced": [],
        "why": "a chromosome and ten plasmids, 24 times: 264 contigs, so cluster sketches"})
    bench["workloads"].append({
        "name": STAND_IN, "config": PLASMID_RICH["name"], "traffic": "clean",
        "chips": 1, "why": "one plasmid-rich isolate a window: the stream, the "
        "sketch distances, eleven trims and resolves"})
    next(m for m in bench["per_layer"]
         if m["name"] == "isolate_wall_s")["workloads"].append(STAND_IN)
    return bench


def config_run(config: dict, seed: int):
    """(the result line without metrics, the run's record) of one short
    window of a cell made of ``config`` and the clean traffic, on the CPU
    with lengths divided by its :func:`cpu_scale`."""
    from benchmark.lib import window

    cell = {"name": f"{config['name']}.clean", "chips": 1, "config": config,
            "traffic": json.loads((ROOT / "benchmark" / "traffic" / "clean.json")
                                  .read_text())}
    record = window.run(cell, seed, 0.1, False, torch.device("cpu"),
                        time.perf_counter(), scale=cpu_scale(config))
    line = run.result_line({"end_to_end": [], "per_layer": []}, cell["name"],
                           record, False, {"platform": "cpu"})
    return line, record


def dry_run(workload: str, seed: int = 7, trace: bool = False,
            seconds: float = 0.1, device=None, bench: dict = None):
    """(exit code, last stdout line as a dict or None, stderr) of one run of
    ``workload`` of ``bench`` (BENCHMARK.json where None) past the look for
    a chip, on the CPU at a tiny size."""
    bench = bench or spec.load_benchmark()
    scale = cpu_scale(spec.cell(bench, workload)["config"])
    out, err = io.StringIO(), io.StringIO()
    run._T_START = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.execute(workload, seed, seconds, trace,
                         device or torch.device("cpu"), scale=scale, bench=bench)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
