"""The comparison's control at a cell's own size, on several seeds.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13

For each seed it draws the cell's first isolate, puts the control
(``reference/control.py``: the vote left out) in the program's place, and
prints one JSON line with the numbers the comparison reads off it, beside
their limits. The control needs no device: it is the reference.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from benchmark.gen import synthetic, traffic as traffic_gen
    from benchmark.lib import spec
    from benchmark.reference import check, control

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    config, traffic = cell["config"], cell["traffic"]
    for seed in args.seeds:
        work = Path(tempfile.mkdtemp(prefix="autocycler-bench-control-"))
        try:
            t0 = time.perf_counter()
            asm = synthetic.write_isolate(
                traffic_gen.isolate(config, traffic, seed, 0), work / "in")
            numbers = control.control_numbers(asm, work / "out", config["k"])
            correct = all(v <= check.LIMITS[n] for n, v in numbers.items())
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": numbers, "limits": {
                                  n: check.LIMITS[n] for n in numbers},
                              "correct": correct,
                              "seconds": time.perf_counter() - t0}), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
