"""The crash-injection chaos harness, as the JAX package's utils/chaos.py
has it.

It runs a real ``batch`` in a CHILD process with one registered crash
point armed (``AUTOCYCLER_CRASH_POINTS``, see :mod:`.resilience`), checks
that the child died at that point with the distinctive
:data:`.resilience.CRASH_EXIT` status and the crash marker on stderr,
restarts it with ``--resume`` and nothing armed, and then holds the
recovered run to the bar an uninterrupted run meets:

- the resumed run completes (exit 0),
- its final outputs are byte-identical to an uninterrupted oracle run,
- no orphaned state survives: no ``*.tmp*`` file and no dead run's
  ``.stream/run-*`` spill dir anywhere under the output tree.

The child runs the port's batch on the device it is given on its command
line (CUDA unless the caller asks for the CPU, as the tests do). Without
a CUDA device a CUDA child exits 1 with ``Error:``, as the CLI does; it
never moves to the CPU. The resumed child dumps its metrics registry
beside the run, so a caller can read what the recovery swept.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from .resilience import CRASH_EXIT, CRASH_POINTS

# the files whose bytes define "the run": the compressed unitig graph and
# the combined consensus outputs of every isolate
FINAL_ARTIFACTS = ("input_assemblies.gfa", "consensus_assembly.gfa",
                   "consensus_assembly.fasta")

_CHAOS_CHILD = r"""
import json, sys
from autocycler_tpu_torch.commands.batch import batch
from autocycler_tpu_torch.obs import metrics_registry
from autocycler_tpu_torch.utils import AutocyclerError
asm, out, kmer, resume, threads, device, metrics = sys.argv[1:8]
try:
    rc = batch(asm, out, k_size=int(kmer), resume=resume == "1",
               threads=int(threads), device=device)
except AutocyclerError as e:
    print(f"\nError: {e}", file=sys.stderr)
    rc = 1
with open(metrics, "w") as f:
    json.dump(metrics_registry.snapshot(), f)
sys.exit(rc)
"""


def _child_env(repo_root: str, crash_points: Optional[str] = None) -> dict:
    """A deterministic child environment: the streamed grouping forced on
    (so mid-spill-write is reached), the warm-start cache on (so
    mid-cache-store is), and the fleet runner on with a one-device plan
    (two isolates are two shards, so mid-fleet-shard fires between the
    first shard's durable compress checkpoints and its cluster stage). The
    oracle runs in the same environment without the armed point: the bytes
    must hold across the crash, not across a mode switch."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update({"AUTOCYCLER_STREAM_KMERS": "on",
                "AUTOCYCLER_ENCODE_CACHE": "1",
                "AUTOCYCLER_FLEET_MODE": "on",
                "AUTOCYCLER_FLEET_DEVICES": "1"})
    env.pop("AUTOCYCLER_CRASH_POINTS", None)
    env.pop("AUTOCYCLER_FAULTS", None)
    if crash_points:
        env["AUTOCYCLER_CRASH_POINTS"] = crash_points
    return env


def _run_batch(child_script: Path, asm_parent: Path, out_dir: Path,
               kmer: int, resume: bool, env: dict, device: str,
               threads: int, metrics_path: Path,
               timeout: float = 900.0) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(child_script), str(asm_parent), str(out_dir),
         str(kmer), "1" if resume else "0", str(threads), str(device),
         str(metrics_path)],
        env=env, capture_output=True, text=True, timeout=timeout)


def _file_sha(path: Path) -> Optional[str]:
    try:
        return hashlib.sha256(path.read_bytes()).hexdigest()
    except OSError:
        return None


def artifact_digests(out_dir: Path) -> Dict[str, Optional[str]]:
    """{relative artifact path: sha256} over every isolate's final files."""
    out_dir = Path(out_dir)
    digests: Dict[str, Optional[str]] = {}
    for iso in sorted(d for d in out_dir.iterdir() if d.is_dir()) \
            if out_dir.is_dir() else []:
        if iso.name.startswith("."):
            continue
        for name in FINAL_ARTIFACTS:
            digests[f"{iso.name}/{name}"] = _file_sha(iso / name)
    return digests


def scan_orphans(out_dir: Path) -> List[str]:
    """Leftover crash debris under ``out_dir``: tmp files and
    ``.stream/run-*`` spill dirs. Called after every child has exited, so
    anything matching is an orphan (``.bak`` manifest fallbacks are
    expected state, not debris)."""
    out_dir = Path(out_dir)
    orphans: List[str] = []
    if not out_dir.is_dir():
        return orphans
    for path in sorted(out_dir.rglob("*")):
        name = path.name
        if path.is_file() and ".tmp" in name:
            orphans.append(str(path.relative_to(out_dir)))
        elif path.is_dir() and name.startswith("run-") \
                and path.parent.name == ".stream":
            orphans.append(str(path.relative_to(out_dir)) + "/")
    return orphans


def _swept(metrics_path: Path) -> int:
    """The orphan spill dirs the resumed child swept, from its registry
    dump (0 when it wrote none)."""
    try:
        snap = json.loads(Path(metrics_path).read_text())
    except (OSError, ValueError):
        return 0
    values = (snap.get("autocycler_stream_orphans_swept_total") or {}) \
        .get("values") or []
    return int(sum(v.get("value", 0) for v in values))


def _write_child(work_dir: Path) -> Path:
    child = work_dir / "chaos_child.py"
    child.write_text(_CHAOS_CHILD)
    return child


def _repo_root() -> str:
    return str(Path(__file__).resolve().parents[2])


def crash_marker(stderr: Optional[str], point: str) -> Optional[str]:
    """The line of ``stderr`` that names the crash at ``point``, or None."""
    return next((line for line in (stderr or "").splitlines()
                 if line.startswith(f"autocycler crash injection: {point}")),
                None)


def chaos_cycle(asm_parent, work_dir, point: str, kmer: int = 31,
                oracle: Optional[Dict[str, Optional[str]]] = None,
                timeout: float = 900.0, device: str = "cuda",
                threads: int = 1, hit: int = 1) -> dict:
    """One kill/restart cycle: arm ``point`` at its ``hit``-th hit, run
    batch on ``device`` in a child until it crashes there, restart it with
    ``--resume`` and nothing armed, and compare the recovered outputs with
    ``oracle`` (the digests of an uninterrupted run, see
    :func:`artifact_digests`). Returns a verdict: ``passed`` needs the
    crash, the recovery, byte identity and a clean orphan scan;
    ``orphans_swept`` is what the resumed run swept."""
    if point not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {point!r} "
                         f"(choose from {', '.join(CRASH_POINTS)})")
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    out_dir = work_dir / f"out-{point}"
    child = work_dir / "chaos_child.py"
    if not child.is_file():
        _write_child(work_dir)
    repo_root = _repo_root()
    metrics = work_dir / f"metrics-{point}.json"

    t0 = time.perf_counter()
    crashed = _run_batch(child, Path(asm_parent), out_dir, kmer,
                         resume=False,
                         env=_child_env(repo_root,
                                        crash_points=f"{point}@{hit}"),
                         device=device, threads=threads,
                         metrics_path=work_dir / f"metrics-{point}-crash.json",
                         timeout=timeout)
    crash_s = time.perf_counter() - t0
    crash_ok = crashed.returncode == CRASH_EXIT
    marker = crash_marker(crashed.stderr, point)

    t1 = time.perf_counter()
    resumed = _run_batch(child, Path(asm_parent), out_dir, kmer,
                         resume=True, env=_child_env(repo_root),
                         device=device, threads=threads,
                         metrics_path=metrics, timeout=timeout)
    resume_s = time.perf_counter() - t1
    recovered = resumed.returncode == 0

    digests = artifact_digests(out_dir)
    identical = oracle is not None and digests == oracle \
        and all(v is not None for v in digests.values())
    orphans = scan_orphans(out_dir)
    verdict = {
        "point": point,
        "crashed": crash_ok,
        "crash_rc": crashed.returncode,
        "crash_marker": marker is not None,
        "crash_line": marker,
        "recovered": recovered,
        "resume_rc": resumed.returncode,
        "identical": bool(identical),
        "orphans": orphans,
        "orphans_swept": _swept(metrics),
        "crash_s": round(crash_s, 3),
        "resume_s": round(resume_s, 3),
        "wall_s": round(time.perf_counter() - t0, 2),
        "passed": bool(crash_ok and marker and recovered and identical
                       and not orphans),
    }
    if not verdict["passed"]:
        verdict["crash_stderr_tail"] = (crashed.stderr or "")[-2000:]
        verdict["resume_stderr_tail"] = (resumed.stderr or "")[-2000:]
    return verdict


def run_chaos(asm_parent, work_dir, points=CRASH_POINTS, kmer: int = 31,
              timeout: float = 900.0, device: str = "cuda",
              threads: int = 1,
              oracle: Optional[Dict[str, Optional[str]]] = None,
              hit: int = 1) -> dict:
    """The full harness: one uninterrupted oracle run (unless ``oracle``
    gives its digests, from files already made), then a crash and restart
    cycle at the ``hit``-th hit of each of ``points``, each recovered run
    held byte-identical to the oracle. Returns the summary."""
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    child = _write_child(work_dir)

    t0 = time.perf_counter()
    if oracle is None:
        oracle_dir = work_dir / "out-oracle"
        oracle_run = _run_batch(child, Path(asm_parent), oracle_dir, kmer,
                                resume=False, env=_child_env(_repo_root()),
                                device=device, threads=threads,
                                metrics_path=work_dir / "metrics-oracle.json",
                                timeout=timeout)
        if oracle_run.returncode != 0:
            raise RuntimeError(
                "chaos oracle run failed "
                f"rc={oracle_run.returncode}: "
                f"{(oracle_run.stderr or '')[-2000:]}")
        oracle = artifact_digests(oracle_dir)
    if not oracle or any(v is None for v in oracle.values()):
        raise RuntimeError(f"chaos oracle run produced incomplete "
                           f"artifacts: {json.dumps(oracle)}")

    cycles = [chaos_cycle(asm_parent, work_dir, point, kmer=kmer,
                          oracle=oracle, timeout=timeout, device=device,
                          threads=threads, hit=hit)
              for point in points]
    return {
        "points": list(points),
        "cycles": cycles,
        "oracle_artifacts": len(oracle),
        "wall_s": round(time.perf_counter() - t0, 2),
        "passed": bool(cycles) and all(c["passed"] for c in cycles),
    }


def cleanup(work_dir) -> None:
    shutil.rmtree(work_dir, ignore_errors=True)
