"""The control (the reference in the program's place, the vote left out)
comes out not correct, on three seeds of every cell, at a size a test run
holds; ``benchmark/control.py`` reads it at each cell's own size."""

import pytest

from benchmark.gen import synthetic, traffic as traffic_gen
from benchmark.lib import spec
from benchmark.reference import check, control

from .helpers import STAND_IN, bench_with_stand_in, cpu_scale

# every cell of BENCHMARK.json, and a cell of the plasmid-rich fixture added
# as a new cell is added (entries and a file)
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]] + [STAND_IN]


@pytest.mark.parametrize("seed", [5, 2**31 + 3, 987654321])
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tmp_path, workload, seed):
    cell = spec.cell(bench_with_stand_in(), workload)
    scale = cpu_scale(cell["config"])
    config = traffic_gen.scaled(cell["config"], scale)
    traffic = traffic_gen.scaled_traffic(cell["traffic"], scale)
    asm = synthetic.write_isolate(traffic_gen.isolate(config, traffic, seed, 0),
                                  tmp_path / "in")
    numbers = control.control_numbers(asm, tmp_path / "out", config["k"])
    assert numbers["consensus_replicon_faults"] == 0
    # every SNP of the first copy is a minority site, bar the rare site
    # where another copy carries the same base
    assert numbers["consensus_minority_sites"] > check.LIMITS["consensus_minority_sites"]
    assert numbers["consensus_minority_sites"] >= config["n_snps"] // 2

