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

# lengths divided by this: 232 kb E. coli chromosomes, 150 kb Klebsiella
# ones with 3 kb plasmids (streamed, as at their own size)
SCALES = {"kleb24.clean": 40, "ecoli4.clean": 20}


def dry_run(workload: str, seed: int = 7, trace: bool = False,
            seconds: float = 0.1, device=None):
    """(exit code, last stdout line as a dict or None, stderr) of one run of
    ``workload`` past the look for a chip, on the CPU at a tiny size."""
    out, err = io.StringIO(), io.StringIO()
    run._T_START = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.execute(workload, seed, seconds, trace,
                         device or torch.device("cpu"), scale=SCALES[workload])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
