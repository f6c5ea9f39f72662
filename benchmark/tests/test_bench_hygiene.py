"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level module name (``autocycler_tpu_torch`` is the port, and passes),
and the reference takes nothing from the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.lib import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "autocycler_tpu"}
SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(spec.BENCH_DIR).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not {m.split(".")[0] for m in _imports(path)} & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not any(m.split(".")[0].startswith("autocycler") for m in _imports(path))
    assert "autocycler_tpu" not in path.read_text().replace("autocycler_tpu_torch", "")


def test_whole_top_level_names():
    from benchmark import run

    sys.modules.setdefault("autocycler_tpu_torch_fake_probe", sys)
    assert "autocycler_tpu_torch_fake_probe" not in run.forbidden_modules()
    del sys.modules["autocycler_tpu_torch_fake_probe"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process, then every loaded module."""
    code = (
        "import sys, json, torch\n"
        "from benchmark.tests.helpers import dry_run\n"
        "from benchmark import run\n"
        "rc, line, _ = dry_run('ecoli4.clean', seed=41)\n"
        "print(json.dumps([rc, line['correct'], run.forbidden_modules(),\n"
        "                  'autocycler_tpu_torch' in sys.modules]))\n")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, True, [], True]


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ecoli4.clean",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
