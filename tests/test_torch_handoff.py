"""The in-process hand-over of the port on the CPU: compress →
cluster(collect_handoff=True) → trim(preloaded=...) → resolve(preloaded=...)
→ combine writes the same files as the command-by-command flow, which
re-parses each stage's GFA, and as the JAX package's hand-over; and the
stage timers carry the JAX package's names."""

import contextlib
import io
import random
import shutil
from pathlib import Path

import pytest

from autocycler_tpu.commands.cluster import cluster as jax_cluster
from autocycler_tpu.commands.combine import combine as jax_combine
from autocycler_tpu.commands.compress import compress as jax_compress
from autocycler_tpu.commands.resolve import resolve as jax_resolve
from autocycler_tpu.commands.trim import trim as jax_trim
from autocycler_tpu.utils import timing as jax_timing
from autocycler_tpu_torch import device
from autocycler_tpu_torch.commands.cluster import cluster
from autocycler_tpu_torch.commands.combine import combine
from autocycler_tpu_torch.commands.compress import compress
from autocycler_tpu_torch.commands.resolve import resolve
from autocycler_tpu_torch.commands.trim import trim
from autocycler_tpu_torch.models import UnitigGraph
from autocycler_tpu_torch.obs import metrics_registry
from autocycler_tpu_torch.ops.distance import pairwise_contig_distances
from autocycler_tpu_torch.utils import timing

from synthetic import make_assemblies, mutate, random_genome, revcomp

JAX = {"compress": jax_compress, "cluster": jax_cluster, "trim": jax_trim,
       "resolve": jax_resolve, "combine": jax_combine}
PORT = {"compress": compress, "cluster": cluster, "trim": trim,
        "resolve": resolve, "combine": combine}


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _inversion(root):
    """3 assemblies of a + b + c and 2 of a + revcomp(b) + c: resolve culls
    conflicting bridges and re-reads 2_trimmed.gfa for the pristine graph."""
    rng = random.Random(0)
    a, b, c = (random_genome(rng, 2000) for _ in range(3))
    asm = root / "assemblies"
    asm.mkdir(parents=True)
    for i, seq in enumerate([a + b + c] * 3 + [
            mutate(rng, a + revcomp(b) + c, 3) for _ in range(2)], start=1):
        (asm / f"assembly_{i}.fasta").write_text(f">contig_1\n{seq}\n")
    return asm


CASES = {
    "clean": lambda root: make_assemblies(root, n_assemblies=4, seed=42),
    "snps": lambda root: make_assemblies(root, n_assemblies=5, n_snps=5,
                                         seed=13),
    "inversion": _inversion,
}


def _run(fns, name, *args, **kwargs):
    """One stage of either package, quietly; the port's on the CPU."""
    if fns is PORT and name != "combine":
        kwargs["device"] = "cpu"
    return _quiet(fns[name], *args, **kwargs)


def file_flow(fns, asm, out):
    """Each command on its own, every stage read back from its file."""
    _run(fns, "compress", asm, out, 51)
    _run(fns, "cluster", out)
    clusters = sorted((out / "clustering/qc_pass").iterdir())
    for c in clusters:
        _run(fns, "trim", c)
        _run(fns, "resolve", c)
    _run(fns, "combine", out, [c / "5_final.gfa" for c in clusters])
    return [c.name for c in clusters]


def handoff_flow(fns, asm, out):
    """The stages in one process, graphs handed over in memory, as the
    headline benchmark runs them."""
    _run(fns, "compress", asm, out, 51)
    handoff = _run(fns, "cluster", out, collect_handoff=True)
    clusters = sorted((out / "clustering/qc_pass").iterdir())
    assert sorted(handoff) == clusters
    for c in clusters:
        trimmed = _run(fns, "trim", c, preloaded=handoff.pop(c))
        _run(fns, "resolve", c, preloaded=trimmed)
    _run(fns, "combine", out, [c / "5_final.gfa" for c in clusters])
    return [c.name for c in clusters]


def _pipeline_files(root: Path):
    """Every file the pipeline writes, by path under ``root``."""
    names = ["input_assemblies.gfa", "input_assemblies.yaml",
             "consensus_assembly.gfa", "consensus_assembly.fasta",
             "consensus_assembly.yaml"]
    names += [str(p.relative_to(root))
              for p in sorted((root / "clustering").rglob("*")) if p.is_file()]
    return {name: (root / name).read_bytes() for name in names}


def _all_files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_handoff_flow_byte_identical_to_file_flow(tmp_path, case):
    asm = CASES[case](tmp_path)
    device.reset_counts()
    names = handoff_flow(PORT, asm, tmp_path / "handoff")
    resolve_dp = device.dp_summary("resolve_medoid_dp")["dispatches"]
    assert file_flow(PORT, asm, tmp_path / "files") == names
    got, want = _all_files(tmp_path / "handoff"), _all_files(tmp_path / "files")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    stages = sum(name.endswith("5_final.gfa") for name in got)
    assert stages == len(names) >= 1
    if case == "clean":
        assert len(names) == 2
    if case == "snps":
        assert resolve_dp >= 1
    if case == "inversion":
        yaml = got["consensus_assembly.yaml"].decode()
        assert "consensus_assembly_fully_resolved" in yaml


def test_handoff_resolve_rereads_the_pristine_graph(tmp_path, monkeypatch):
    """With culling, resolve re-reads 2_trimmed.gfa, since the handed-over
    graph was mutated by the first round of bridges; without, it reads no
    file."""
    from autocycler_tpu_torch.commands import resolve as resolve_mod
    reads = []
    real = resolve_mod.load_file_lines

    def counted(path):
        reads.append(Path(path).name)
        return real(path)

    monkeypatch.setattr(resolve_mod, "load_file_lines", counted)
    for case, culls in (("inversion", True), ("clean", False)):
        reads.clear()
        log = io.StringIO()
        out = tmp_path / case
        asm = CASES[case](out)
        _quiet(compress, asm, out / "out", 51, device="cpu")
        handoff = _quiet(cluster, out / "out", device="cpu",
                         collect_handoff=True)
        for c, pair in sorted(handoff.items()):
            trimmed = _quiet(trim, c, device="cpu", preloaded=pair)
            with contextlib.redirect_stderr(log):
                resolve(c, device="cpu", preloaded=trimmed)
        assert ("2 conflicting bridges culled" in log.getvalue()) == culls
        assert reads == (["2_trimmed.gfa"] if culls else [])


@pytest.mark.parametrize("case", sorted(CASES))
def test_handoff_byte_identical_to_jax_handoff(tmp_path, case):
    asm = CASES[case](tmp_path)
    names = handoff_flow(JAX, asm, tmp_path / "jax")
    assert handoff_flow(PORT, asm, tmp_path / "port") == names
    got = _pipeline_files(tmp_path / "port")
    want = _pipeline_files(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_precomputed_distances_write_the_same_files(tmp_path):
    asm = make_assemblies(tmp_path, n_assemblies=5, n_snps=5, seed=13)
    _quiet(compress, asm, tmp_path / "plain", 51, device="cpu")
    shutil.copytree(tmp_path / "plain", tmp_path / "given")
    graph, sequences = UnitigGraph.from_gfa_file(
        tmp_path / "plain/input_assemblies.gfa")
    exact = pairwise_contig_distances(graph, sequences, device="cpu")
    assert _quiet(cluster, tmp_path / "plain", device="cpu") is None
    device.reset_counts()
    handoff = _quiet(cluster, tmp_path / "given", device="cpu",
                     precomputed_distances=exact, collect_handoff=True)
    assert sorted(handoff) == sorted(
        (tmp_path / "given/clustering/qc_pass").iterdir())
    for graph, sequences in handoff.values():
        assert isinstance(graph, UnitigGraph) and sequences
    want = _all_files(tmp_path / "plain/clustering")
    got = _all_files(tmp_path / "given/clustering")
    assert got == want


def test_stage_names_match_jax(tmp_path, monkeypatch):
    """After the same in-process pipeline the two packages have timed the
    same stages, and AUTOCYCLER_TIMINGS prints them."""
    asm = make_assemblies(tmp_path, n_assemblies=4, n_snps=3, seed=7)
    before = jax_timing.stage_seconds()
    handoff_flow(JAX, asm, tmp_path / "jax")
    after = jax_timing.stage_seconds()
    jax_stages = {name for name, secs in after.items()
                  if secs > before.get(name, 0.0)}
    timing.reset()
    handoff_flow(PORT, asm, tmp_path / "port")
    assert set(timing.stage_seconds()) == jax_stages
    assert {"compress/load_and_repair", "compress/build_graph",
            "compress/simplify", "cluster/load", "cluster/distances",
            "cluster/tree", "cluster/outputs", "trim/overlaps",
            "resolve/apply"} <= jax_stages
    assert {"load", "repair", "k-mer grouping"} <= set(
        timing.substage_snapshot())
    timing.reset()
    assert timing.stage_seconds() == {} and timing.substage_snapshot() == {}
    monkeypatch.setenv("AUTOCYCLER_TIMINGS", "1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        compress(asm, tmp_path / "timed", 51, device="cpu")
    lines = [line for line in err.getvalue().splitlines()
             if line.startswith("[timing] ")]
    assert lines[0].startswith("[timing] compress/load_and_repair: 0:00:")
    assert "[timing] compress/load_and_repair · repair: " in "\n".join(lines)
    assert any(line.startswith("[timing] compress/build_graph · k-mer "
                               "grouping: ") for line in lines)


def test_substage_deltas():
    timing.reset()
    with timing.substage("a"):
        pass
    before = timing.substage_snapshot()
    metrics_registry.counter_inc(timing.SUBSTAGE_SECONDS, 0.25, substage="a")
    metrics_registry.counter_inc(timing.SUBSTAGE_SECONDS, 0.0004,
                                 substage="b")
    assert timing.substage_deltas(before) == {"a": 0.25}
    assert timing.substage_deltas(before, digits=4) == {"a": 0.25, "b": 0.0004}
    with timing.stage_timer("x"), timing.stage_timer("x"):
        pass
    assert set(timing.stage_seconds()) == {"x"}
    timing.reset()
