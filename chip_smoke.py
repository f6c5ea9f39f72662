"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result lines are not printed):

1. build   — compile every kernel under autocycler_tpu_torch/csrc with nvcc.
2. kernels — hold each kernel against its plain PyTorch version on the card
             (exact equality: the outputs are integers).
3. main    — the headline configuration (24 assemblies of a 6 Mbp chromosome
             + 120 kb plasmid, seed 7) through the port's CLI: compress at
             k=51, then decompress, which must restore the input FASTAs byte
             for byte; every kernel of the path must have been launched.
             A small input is also compressed on the card and on the CPU
             (the kernels' plain versions), which must write the same bytes.
4. timing  — each kernel at the shapes the main path gave it: the kernel, its
             plain version and a PyTorch library yardstick, beside the least
             time the card's memory rate allows.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
HEADLINE = dict(n_assemblies=24, chromosome_len=6_000_000,
                plasmid_len=120_000, n_snps=600, seed=7)
KERNEL_SOURCES = {"sortnet_pack_rank": {
    "route": "cuda",
    "source": "autocycler_tpu_torch/csrc/sortnet.cu",
    "replaces": "autocycler_tpu/ops/sortnet.py:161",
}}


def log(*args) -> None:
    print(*args, flush=True)


def phase_build() -> None:
    from autocycler_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {len(_build.SOURCES)} source(s) built in "
        f"{time.perf_counter() - t0:.3f} s")
    for name in _build.SOURCES:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")


def phase_kernels() -> None:
    """pack_rank against pack_rank_plain, on the card, exact."""
    from autocycler_tpu_torch.ops import sortnet
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    cases = []
    for k in (51, 50, 25, 11):
        block = 1 << sortnet.network_shape(1 << 20, k)[2]
        for n in (1, 1000, block, block + 1, 3 * 2**20 + 7, 2**24):
            codes = rng.integers(0, 5, size=max(n // 3, 64) + k).astype(np.uint8)
            starts = rng.integers(0, len(codes) - k + 1, size=n)
            cases.append((f"random k={k} n={n}", codes, starts, k))
    one_base = np.full(4096, 3, np.uint8)            # every window equal
    cases.append(("all-equal k=51", one_base,
                  rng.integers(0, 4096 - 51, size=100_000), 51))
    dotted = rng.integers(1, 5, size=1 << 20).astype(np.uint8)
    dotted[rng.integers(0, len(dotted), size=1 << 14)] = 0   # '.' padding
    dotted[:25] = 0
    dotted[-25:] = 0
    for k in (51, 25):
        cases.append((f"dots k={k}", dotted,
                      np.arange(len(dotted) - k + 1), k))
    for label, codes, starts, k in cases:
        c = torch.from_numpy(codes).to(dev)
        s = torch.from_numpy(starts.astype(np.int32)).to(dev)
        got = sortnet.pack_rank(c, s, k)
        want = sortnet.pack_rank_plain(c, s, k)
        torch.cuda.synchronize()
        for name, a, b in zip(("order", "gid_sorted"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"[kernels] {label}: {name} differs "
                                     "from the plain version")
    log(f"[kernels] sortnet_pack_rank equals its plain version in "
        f"{len(cases)} cases (exact)")


def _same_files(a: Path, b: Path) -> bool:
    names = sorted(p.name for p in a.iterdir())
    return (names == sorted(p.name for p in b.iterdir())
            and all((a / n).read_bytes() == (b / n).read_bytes() for n in names))


def phase_main(work: Path):
    """Headline compress + decompress through the CLI, with the kernels'
    inputs captured for the timing phase."""
    sys.path.insert(0, str(REPO / "tests"))
    from synthetic import make_assemblies, make_assemblies_fast

    from autocycler_tpu_torch import cli, device
    from autocycler_tpu_torch.commands.compress import compress
    from autocycler_tpu_torch.ops import sortnet
    from autocycler_tpu_torch.utils import timing

    # a small input through the card and through the CPU's plain versions
    small = make_assemblies(work / "small", n_assemblies=4,
                            chromosome_len=30_000, plasmid_len=4_000,
                            n_snps=10, seed=3)
    with contextlib.redirect_stderr(io.StringIO()):
        compress(small, work / "small_gpu", 51, device="cuda")
        compress(small, work / "small_cpu", 51, device="cpu")
    if not _same_files(work / "small_gpu", work / "small_cpu"):
        raise AssertionError("[main] small compress on the card differs "
                             "from the CPU's plain versions")
    log("[main] small compress: card and CPU outputs byte-identical")

    t0 = time.perf_counter()
    asm = make_assemblies_fast(work / "headline", **HEADLINE)
    log(f"[main] headline inputs generated in "
        f"{time.perf_counter() - t0:.3f} s: {HEADLINE}")

    captured = []
    real = sortnet.pack_rank_cuda

    def capture(codes, starts, k):
        captured.append((codes, starts, k))
        return real(codes, starts, k)

    sortnet.pack_rank_cuda = capture
    out = work / "out"
    stderr = io.StringIO()
    try:
        device.reset_counts()
        timing.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(stderr):
            rc = cli.main(["compress", "-i", str(asm), "-a", str(out),
                           "--kmer", "51"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(device.launches)
        kernel_ms = {n: device.kernel_ms(n) for n in launches}
    finally:
        sortnet.pack_rank_cuda = real
    if rc != 0:
        raise RuntimeError(f"[main] compress exited {rc}:\n"
                           f"{stderr.getvalue()[-3000:]}")
    stages = dict(timing.seconds)
    log(f"[main] compress wall {wall:.3f} s, substages (s): "
        + json.dumps(stages))
    log(f"[main] kernel launches {launches}, kernel time (ms, CUDA events) "
        + json.dumps(kernel_ms))
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"[main] kernels never launched: {missing}")

    recon = work / "recon"
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(stderr):
        rc = cli.main(["decompress", "-i", str(out / "input_assemblies.gfa"),
                       "-o", str(recon)])
    if rc != 0:
        raise RuntimeError(f"[main] decompress exited {rc}")
    if not _same_files(asm, recon):
        raise AssertionError("[main] decompress did not restore the inputs")
    log(f"[main] decompress round trip byte-identical "
        f"({time.perf_counter() - t0:.3f} s); "
        f"{(out / 'input_assemblies.yaml').read_text().count('- name:')} "
        "contigs in input_assemblies.yaml")
    profile_compress(asm, work / "out_profiled", out)
    return launches, captured


def profile_compress(asm: Path, out: Path, expected: Path) -> None:
    """Compress once more under torch.profiler: the device's busy time
    (kernels and copies) against the run's wall time. The profiled run
    must write the same bytes as the counted one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from autocycler_tpu_torch import cli

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof, contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["compress", "-i", str(asm), "-a", str(out),
                       "--kmer", "51"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0 or not _same_files(out, expected):
        raise AssertionError("[profile] profiled compress differs from the "
                             "counted one")
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    busy_s = sum(by_name.values()) / 1e6
    if busy_s == 0:
        log("[profile] device busy time: not measured (no device events)")
        return
    log(f"[profile] compress wall {wall} s under the profiler, device busy "
        f"{busy_s} s (kernels + copies), idle share {1 - busy_s / wall}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        log(f"[profile]   {us / 1e6} s  {name[:100]}")


def _time_ms(fn, reps: int = 3) -> float:
    fn()                                            # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_timing(launches, captured):
    from autocycler_tpu_torch.ops import sortnet

    shapes = []
    for codes, starts, k in captured:
        n = len(starts)
        got = sortnet.pack_rank_cuda(codes, starts, k)
        want = sortnet.pack_rank_plain(codes, starts, k)
        err = max(int((a.long() - b.long()).abs().max()) if n else 0
                  for a, b in zip(got, want))
        del got, want
        words = sortnet.pack_words_plain(codes, starts, k)
        if len(words) == 2:
            # one stable sort of the single int64 key w0 * 5**13 + w1
            key = words[0].long() * 5**13 + words[1].long()
            lib_label = "torch.sort(int64 key, stable=True), 1 call"

            def library():
                torch.sort(key, stable=True)
        else:
            lib_label = f"torch.sort LSD, {len(words)} stable calls + gathers"

            def library():
                order = torch.arange(n, device=codes.device)
                for w in reversed(words):
                    _, perm = torch.sort(w[order], stable=True)
                    order = order[perm]
        shape = {
            "k": k, "n": n, "codes": len(codes),
            "ms": _time_ms(lambda: sortnet.pack_rank_cuda(codes, starts, k)),
            "plain_ms": _time_ms(lambda: sortnet.pack_rank_plain(codes, starts, k)),
            "library_ms": _time_ms(library), "library": lib_label,
            # each input read once (codes, starts), each output written once
            # (order, gid_sorted), over the memory rate
            "bound_ms": (len(codes) + 4 * n + 8 * n) / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err,
        }
        del words
        shapes.append(shape)
        log(f"[timing] sortnet_pack_rank {json.dumps(shape)}")
    rows = []
    for name, meta in KERNEL_SOURCES.items():
        rows.append({
            "name": name, **meta, "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            # per compress: the sum over the main path's launches
            "ms": sum(s["ms"] for s in shapes),
            "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(s["bound_ms"] for s in shapes),
            "bound_by": "bytes",
            "library_ms": sum(s["library_ms"] for s in shapes),
            "shapes": shapes,
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import autocycler_tpu_torch  # noqa: F401 — fails outside the repo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    phase_kernels()
    with tempfile.TemporaryDirectory() as td:
        launches, captured = phase_main(Path(td))
    rows = phase_timing(launches, captured)
    if any(r["max_abs_err"] != 0 for r in rows):
        raise AssertionError("[timing] a kernel disagrees with its plain "
                             "version at the main path's shapes")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
