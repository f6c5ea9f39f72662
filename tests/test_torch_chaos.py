"""The port's crash-injection chaos harness (utils/chaos.py) on the CPU.

Two tiny isolates; for every registered crash point the harness kills a
child batch run at that point (exit 43, the marker on stderr), resumes it,
and requires the recovered outputs to be byte-identical to an
uninterrupted oracle run with a clean orphan scan. The oracle's digests
equal the JAX package's batch on the same isolates with the same k and
environment. A batch of a subset of isolates writes each isolate's files
as the full batch does (what lets the card's [chaos] phase use
[batch]'s files as its oracle)."""

import contextlib
import io
import sys

import pytest

from synthetic import make_isolate_dirs

pytestmark = pytest.mark.chaos

TINY = dict(n_assemblies=3, chromosome_len=160, plasmid_len=70)


def test_every_crash_point_recovers_byte_identical(tmp_path, monkeypatch):
    from autocycler_tpu.commands.batch import batch as jax_batch
    from autocycler_tpu_torch.utils import chaos

    parent = make_isolate_dirs(tmp_path / "isolates", 2, seed0=7, **TINY)
    summary = chaos.run_chaos(parent, tmp_path / "work", kmer=21,
                              device="cpu")
    assert summary["points"] == list(chaos.CRASH_POINTS)
    assert summary["oracle_artifacts"] == 6    # 2 isolates x 3 final files
    for cycle in summary["cycles"]:
        assert cycle["passed"], cycle
        assert cycle["crash_rc"] == chaos.CRASH_EXIT
        assert cycle["crash_marker"]           # stderr names the point
        assert cycle["resume_rc"] == 0
        assert cycle["identical"]
        assert cycle["orphans"] == []
    # the torn spill's run dir was the resumed run's to sweep
    swept = {c["point"]: c["orphans_swept"] for c in summary["cycles"]}
    assert swept["mid-spill-write"] >= 1
    assert summary["passed"]

    # the recovered bytes are the reference's: the JAX package's batch in
    # the harness's environment, on the same isolates and k
    for name, value in chaos._child_env(str(tmp_path)).items():
        if name.startswith("AUTOCYCLER_"):
            monkeypatch.setenv(name, value)
    with contextlib.redirect_stderr(io.StringIO()):
        assert jax_batch(parent, tmp_path / "jax", k_size=21) == 0
    assert chaos.artifact_digests(tmp_path / "jax") == \
        chaos.artifact_digests(tmp_path / "work" / "out-oracle")


def test_a_torn_append_in_a_later_pass1_batch_recovers(tmp_path,
                                                        monkeypatch):
    """The torn append lands in pass 1's second batch (one bin, a flush
    every chunk: one append a batch; plan chunks of 10 windows, over 100
    of them an isolate, so several batches); the resumed run sweeps the
    torn run dir and writes the uninterrupted run's bytes."""
    from autocycler_tpu_torch.utils import chaos

    for name, value in (("BINS", "1"), ("CHUNK", "10"), ("FLUSH", "1")):
        monkeypatch.setenv(f"AUTOCYCLER_STREAM_{name}", value)
    parent = make_isolate_dirs(tmp_path / "isolates", 2, seed0=7, **TINY)
    summary = chaos.run_chaos(parent, tmp_path / "work", kmer=21,
                              device="cpu", points=("mid-spill-write",),
                              hit=2)
    (cycle,) = summary["cycles"]
    assert cycle["passed"], cycle
    assert cycle["crash_line"] == \
        "autocycler crash injection: mid-spill-write (bin-0000.u64)"
    assert cycle["orphans_swept"] == 1


def test_unknown_crash_point_rejected(tmp_path):
    from autocycler_tpu_torch.utils import chaos

    with pytest.raises(ValueError, match="unknown crash point"):
        chaos.chaos_cycle(tmp_path, tmp_path / "w", "mid-everything")


def test_orphan_scan_sees_tmp_debris_and_dead_spill_dirs(tmp_path):
    from autocycler_tpu.utils.chaos import scan_orphans as jax_scan
    from autocycler_tpu_torch.utils.chaos import scan_orphans

    out = tmp_path / "out"
    (out / "iso_000").mkdir(parents=True)
    assert scan_orphans(out) == []
    # a torn atomic-write tmp, a dead spill run dir, and expected state
    # that must NOT count (.bak fallback, ordinary artifacts)
    (out / "iso_000" / "batch_manifest.json.1234.ab.tmp").write_text("{")
    (out / "iso_000" / "batch_manifest.json.bak").write_text("{}")
    (out / "iso_000" / "consensus_assembly.gfa").write_text("H\n")
    run = out / "iso_000" / ".stream" / "run-99-dead"
    run.mkdir(parents=True)
    orphans = scan_orphans(out)
    assert "iso_000/batch_manifest.json.1234.ab.tmp" in orphans
    assert "iso_000/.stream/run-99-dead/" in orphans
    assert len(orphans) == 2
    assert orphans == jax_scan(out)


def test_artifact_digests_and_final_artifacts_are_the_jax_packages(tmp_path):
    from autocycler_tpu.utils import chaos as jax_chaos
    from autocycler_tpu_torch.utils import chaos

    assert chaos.FINAL_ARTIFACTS == jax_chaos.FINAL_ARTIFACTS
    out = tmp_path / "out"
    for iso in ("iso_000", ".hidden", "iso_001"):
        (out / iso).mkdir(parents=True)
    (out / "iso_000" / "input_assemblies.gfa").write_text("H\n")
    assert chaos.artifact_digests(out) == jax_chaos.artifact_digests(out)
    assert chaos.artifact_digests(tmp_path / "none") == {}


def test_a_subset_batch_writes_each_isolate_as_the_full_batch(tmp_path):
    """One isolate alone, serial, writes the files that the three-isolate
    batch wrote for it, serial and fleet, byte for byte."""
    from autocycler_tpu_torch.commands.batch import batch
    from autocycler_tpu_torch.utils import chaos

    parent = make_isolate_dirs(tmp_path / "isolates", 3, seed0=31, **TINY)
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "iso_001").symlink_to(parent / "iso_001")
    with contextlib.redirect_stderr(io.StringIO()):
        assert batch(parent, tmp_path / "full", k_size=21, fleet="off",
                     device="cpu") == 0
        assert batch(parent, tmp_path / "fleet", k_size=21, fleet="on",
                     device="cpu") == 0
        assert batch(alone, tmp_path / "one", k_size=21, fleet="off",
                     device="cpu") == 0
    one = tmp_path / "one" / "iso_001"
    files = sorted(p.relative_to(one) for p in one.rglob("*")
                   if p.is_file() and ".cache" not in p.parts)
    assert len(files) > len(chaos.FINAL_ARTIFACTS)
    for full in ("full", "fleet"):
        ref = tmp_path / full / "iso_001"
        assert files == sorted(p.relative_to(ref) for p in ref.rglob("*")
                               if p.is_file() and ".cache" not in p.parts)
        for rel in files:
            assert (one / rel).read_bytes() == (ref / rel).read_bytes(), rel


def test_a_cuda_child_without_a_card_fails_and_never_moves_to_the_cpu(
        tmp_path):
    """The harness's default device is CUDA: on a machine without one the
    child exits 1 with Error: before any isolate is touched, as the CLI
    does, and the cycle fails."""
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from autocycler_tpu_torch.utils import chaos

    parent = make_isolate_dirs(tmp_path / "isolates", 1, seed0=3, **TINY)
    verdict = chaos.chaos_cycle(parent, tmp_path / "work", "post-stage",
                                kmer=21)
    assert verdict["crash_rc"] == verdict["resume_rc"] == 1
    assert not verdict["passed"] and not verdict["crashed"]
    assert "Error: no CUDA device" in verdict["crash_stderr_tail"]
    assert not (tmp_path / "work" / "out-post-stage" / "iso_000").exists()


def test_the_crash_marker_starts_its_own_line_after_a_torn_print(
        monkeypatch):
    """A print from another thread writes its text and its newline in two
    calls (the fleet's prefetch thread logs while the main thread spills):
    a crash between them must still leave the marker on a line of its
    own, where the harness looks for it."""
    from autocycler_tpu_torch.utils import chaos, resilience

    class Exited(Exception):
        pass

    def _exit(code):
        raise Exited(code)

    err = io.StringIO()
    monkeypatch.setattr(resilience, "_exit", _exit)
    monkeypatch.setattr(sys, "stderr", err)
    err.write("6 sequences loaded from 3 assemblies")   # print's first write
    with pytest.raises(Exited):
        resilience._crash_exit("mid-spill-write", "bin-0000.u64")
    assert chaos.crash_marker(err.getvalue(), "mid-spill-write") == \
        "autocycler crash injection: mid-spill-write (bin-0000.u64)"
