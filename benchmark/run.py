"""One run of one benchmark cell of the PyTorch/CUDA port, in a fresh process.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic and metric readers are found
by name under ``benchmark/``. Set-up (probe, kernels, inputs, a warm-up
isolate) is ``setup_s``; then the window runs whole isolates through the
port's hand-over for ``--seconds``; then the plain reference checks every
isolate the window finished. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with ``--trace
1``), ``device`` and, traced, ``breakdown``; last comes ``check``, each
compared number beside its limit, which also close standard error.

Exits 2 without a result where no CUDA device (or too few) is present or
the port is not this checkout's, 3 where ``jax``, ``jaxlib``, ``flax`` or
the JAX package is loaded once the window has closed, and 4 where a traced
window's profile holds no device event.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "autocycler_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def written_bytes():
    """Bytes this process has passed to write() so far (``wchar`` of
    /proc/self/io): the files it wrote, through the page cache or not."""
    try:
        with open("/proc/self/io") as f:
            return int(next(line for line in f if line.startswith("wchar")).split()[1])
    except (OSError, StopIteration, ValueError):
        return None


def result_line(bench: dict, workload: str, record: dict, trace: bool,
                device_info: dict) -> dict:
    """The contract's last line from a run's record."""
    from benchmark.lib import spec
    from benchmark.lib.window import LIMITS

    metrics = {}
    for m in spec.metrics_for(bench, workload, trace):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check = {name: {"value": record["check"][name], "limit": limit}
             for name, limit in LIMITS.items()}
    correct = (record["failed"] == 0 and len(record["isolates"]) > 0
               and all(c["value"] <= c["limit"] for c in check.values()))
    line = {"correct": correct, "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics, "device": device_info}
    if trace and record.get("trace"):
        t = record["trace"]
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": [list(x) for x in t["device_ops"]],
                             "idle_gaps": t["idle_gaps"]}
    line["check"] = check
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.lib import spec

    try:
        import autocycler_tpu_torch
    except ImportError as e:
        print(f"error: the port is not in this checkout: {e}", file=sys.stderr)
        return 2
    if Path(autocycler_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print("error: autocycler_tpu_torch was not loaded from this checkout",
              file=sys.stderr)
        return 2
    chips = spec.cell(spec.load_benchmark(), args.workload)["chips"]
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"error: the cell needs {chips} CUDA device(s); {found} present",
              file=sys.stderr)
        return 2
    return execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            scale: float = None, bench: dict = None) -> int:
    """The run past the look for a chip: set-up, window, check, the lines.
    ``scale`` divides the cell's lengths (the CPU tests' tiny runs);
    ``bench`` stands in for ``BENCHMARK.json`` (the tests' added cells)."""
    from benchmark.lib import spec, window
    from benchmark.lib.hostload import host_sample

    bench = bench or spec.load_benchmark()
    before = host_sample()
    record = window.run(spec.cell(bench, workload), seed, seconds, trace,
                        device, _T_START, scale=scale)
    return finish(bench, workload, record, trace, device, before)


def finish(bench, workload, record, trace, device, before) -> int:
    """Prints the host-load line, the result line and the check's lines."""
    import torch

    from benchmark.lib.hostload import host_sample

    bad = forbidden_modules()
    if bad:
        print(f"error: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    if trace and device.type == "cuda" and not record["trace"]["device_events"]:
        print("error: the profiler's trace of the window holds no device "
              "event", file=sys.stderr)
        return 4
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": record["device_peak_bytes"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    line = result_line(bench, workload, record, trace, info)
    if record["failure"]:
        print(f"the window failed: {record['failure']}", file=sys.stderr)
    for i, r in enumerate(record["isolates"]):
        for e in r["degrades"]:
            print(f"isolate {i} degraded: {e['chain']}: {e['from']} -> {e['to']}"
                  f" ({e['reason']})", file=sys.stderr)
    diag = {"isolates": len(record["isolates"]), "window_s": record["window_s"],
            "written_bytes": written_bytes(),
            "host_speed": record.get("host_speed"),
            "per_isolate": [{"wall_s": r["wall_s"], "stages": r["stages"],
                             "substages": r["substages"],
                             "stream_bins": r["stream"].get("bins"),
                             "qc_pass_clusters": r["qc_pass_clusters"],
                             "grouping_calls": len(r["grouping"]),
                             "overlap_dp_calls": len(r["overlap_dp"]),
                             "sketch_hash_calls": len(r["sketch_hash"]),
                             "sketch_grid_calls": len(r["sketch_grid"]),
                             "host": r["host"]}
                            for r in record["isolates"]]}
    if record.get("trace"):
        diag["device_events"] = record["trace"]["device_events"]
        diag["first_event_after_window_start_s"] = \
            record["trace"]["first_event_after_window_start_s"]
        diag["device_op_s"] = sorted(record["trace"]["op_s"].items(),
                                     key=lambda kv: -kv[1])[:40]
    print(json.dumps({"host_before": before, "host_after": host_sample(),
                      "diagnostics": diag}))
    print(json.dumps(line), flush=True)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
