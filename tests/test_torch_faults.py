"""The port's fault plan (utils/resilience.py FaultPlan, AUTOCYCLER_FAULTS)
against the JAX package's: parsing, firing, the environment spec, crash
mode at the crash points; the sites it reaches without patching code (a
FASTA read quarantines an isolate in batch, a GFA read fails trim, a
stream bin's write, read or format degrades the streamed grouping to the
in-memory one, a subprocess fails or hangs into run_command's retry and
timeout); and each of the five registered crash points killing a real
child process with exit 43 and the marker on stderr."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from autocycler_tpu.commands import batch as jax_batch_mod
from autocycler_tpu.utils import resilience as jax_rz
from autocycler_tpu_torch import cli
from autocycler_tpu_torch.commands import batch as batch_mod
from autocycler_tpu_torch.commands import compress as compress_mod
from autocycler_tpu_torch.commands import trim as trim_mod
from autocycler_tpu_torch.obs import metrics_registry
from autocycler_tpu_torch.utils import resilience as rz

from synthetic import make_assemblies, make_isolate_dirs

REPO = Path(__file__).resolve().parents[1]
TINY = dict(n_assemblies=3, chromosome_len=160, plasmid_len=70)
KNOBS = ("AUTOCYCLER_FAULTS", "AUTOCYCLER_CRASH_POINTS",
         "AUTOCYCLER_SUBPROCESS_TIMEOUT", "AUTOCYCLER_SUBPROCESS_RETRIES",
         "AUTOCYCLER_STREAM_KMERS", "AUTOCYCLER_STREAM_BINS",
         "AUTOCYCLER_STREAM_CHUNK")


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    for module in (rz, jax_rz):
        module.set_fault_plan(None)
        module._reset_crash_hits_for_tests()
    rz.reset_degrades()
    jax_rz._reset_degrades_for_tests()
    yield
    for module in (rz, jax_rz):
        module.set_fault_plan(None)
        module._reset_crash_hits_for_tests()
    rz.reset_degrades()
    jax_rz._reset_degrades_for_tests()


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _rules(plan):
    return [(r.site, r.match, r.mode, r.times) for r in plan.rules]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_fault_sites_are_the_jax_packages_but_the_native_library():
    assert rz.FAULT_SITES == tuple(
        s for s in jax_rz.FAULT_SITES if not s.startswith("native_"))
    assert rz.CRASH_POINTS == jax_rz.CRASH_POINTS


@pytest.mark.parametrize("spec", [
    "subprocess:flye:hang:1,fasta:iso_001,stream_read",
    "post-stage:::1,mid-spill-write:bin-0003",
    "gfa:cluster_002::2,stream_write:bin-:fail,stream_format",
    "mid-cache-store:asm-:crash:1, pre-artifact-rename", ""])
def test_fault_plan_parses_as_jax(spec):
    assert _rules(rz.FaultPlan.parse(spec)) == \
        _rules(jax_rz.FaultPlan.parse(spec))


def test_fault_plan_parse_full_spec():
    plan = rz.FaultPlan.parse("subprocess:flye:hang:1,fasta:iso_001,gfa")
    assert [r.site for r in plan.rules] == ["subprocess", "fasta", "gfa"]
    assert plan.rules[0].mode == "hang" and plan.rules[0].times == 1
    assert plan.rules[1].match == "iso_001" and plan.rules[1].times == -1


@pytest.mark.parametrize("spec", ["frobnicate", "subprocess::explode",
                                  "native_abi", "native_load:x"])
def test_fault_plan_rejects_bad_site_and_mode(spec):
    with pytest.raises(rz.InputError) as got:
        rz.FaultPlan.parse(spec)
    if not spec.startswith("native_"):
        with pytest.raises(jax_rz.InputError) as want:
            jax_rz.FaultPlan.parse(spec)
        # the port's list of sites has no native ones
        assert str(got.value).split(" (choose")[0] == \
            str(want.value).split(" (choose")[0]


def test_fault_fire_matches_substring_and_respects_times():
    for module in (rz, jax_rz):
        module.set_fault_plan(module.FaultPlan.parse("fasta:iso_001::2"))
    for site, key in (("fasta", "/data/iso_000/a.fasta"),
                      ("gfa", "/data/iso_001/a.gfa"),
                      ("fasta", "/data/iso_001/a.fasta"),
                      ("fasta", "/data/iso_001/b.fasta"),
                      ("fasta", "/data/iso_001/c.fasta")):
        fired = [m.fault_fire(site, key) is not None for m in (rz, jax_rz)]
        assert fired[0] == fired[1], (site, key)
    assert rz.fault_fire("fasta", "/data/iso_001/d.fasta") is None  # spent


def test_fault_fire_counts_injections():
    metrics_registry.reset()
    rz.set_fault_plan(rz.FaultPlan.parse("gfa:x::1"))
    rz.fault_fire("gfa", "x.gfa")
    rz.fault_fire("gfa", "x.gfa")
    assert metrics_registry.registry().value(
        rz.FAULT_INJECTIONS_TOTAL, site="gfa", mode="fail") == 1


def test_fault_fire_reads_env_spec(monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_FAULTS", "gfa:cluster_002")
    assert rz.fault_fire("gfa", "cluster_001/1_untrimmed.gfa") is None
    assert rz.fault_fire("gfa", "cluster_002/1_untrimmed.gfa") is not None
    monkeypatch.setenv("AUTOCYCLER_FAULTS", "nowhere")
    with pytest.raises(rz.InputError):
        rz.fault_fire("gfa", "x")


def test_explicit_plan_takes_precedence_over_env(monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_FAULTS", "fasta")
    rz.set_fault_plan(rz.FaultPlan.parse("gfa"))
    assert rz.fault_fire("fasta", "a.fasta") is None
    assert rz.fault_fire("gfa", "a.gfa") is not None


def test_fault_plan_crash_mode_defaults_at_crash_sites(monkeypatch):
    codes = []
    monkeypatch.setattr(rz, "_exit", codes.append)
    plan = rz.FaultPlan.parse("mid-cache-store:::1")
    assert plan.rules[0].mode == "crash"
    rz.set_fault_plan(plan)
    assert rz.crash_armed("mid-cache-store")
    rz.crash_point("mid-cache-store", "key")
    assert codes == [rz.CRASH_EXIT]
    assert not rz.crash_armed("mid-cache-store")   # single firing consumed
    rz.crash_point("mid-cache-store", "key")
    assert codes == [rz.CRASH_EXIT]


def test_crash_point_fires_at_nth_hit(monkeypatch):
    codes = []
    monkeypatch.setattr(rz, "_exit", codes.append)
    monkeypatch.setenv("AUTOCYCLER_CRASH_POINTS", "post-stage@2")
    rz.crash_point("post-stage", "a/compress")
    assert codes == []
    assert rz.crash_armed("post-stage")       # peek does not consume
    rz.crash_point("post-stage", "a/cluster")
    assert codes == [rz.CRASH_EXIT]


# ---------------------------------------------------------------------------
# the sites, reached through the plan alone
# ---------------------------------------------------------------------------

def test_fasta_and_gfa_hooks_raise_input_error(tmp_path):
    from autocycler_tpu_torch.models import UnitigGraph
    from autocycler_tpu_torch.utils.io import load_fasta
    rz.set_fault_plan(rz.FaultPlan.parse("fasta,gfa"))
    with pytest.raises(rz.InputError, match="corrupt FASTA"):
        load_fasta(tmp_path / "x.fasta")
    with pytest.raises(rz.InputError, match="corrupt GFA"):
        UnitigGraph.from_gfa_file(tmp_path / "x.gfa")


def _manifest_items(out_parent):
    items = json.loads((out_parent / "batch_manifest.json").read_text())[
        "items"]
    prefix = str(out_parent) + "/"
    return {name: {"status": e["status"], "stage": e["stage"],
                   "error": (e["error"] or "").replace(prefix, "")}
            for name, e in items.items()}


@pytest.mark.parametrize("fleet", ["off", "on"])
def test_fasta_fault_quarantines_the_isolate_as_jax(tmp_path, monkeypatch,
                                                    fleet):
    parent = make_isolate_dirs(tmp_path / "isolates", 3, seed0=60, **TINY)
    monkeypatch.setenv("AUTOCYCLER_FAULTS", "fasta:iso_001")
    monkeypatch.setenv("AUTOCYCLER_FLEET_DEVICES", "1")
    rc = _quiet(batch_mod.batch, parent, tmp_path / "port", k_size=21,
                fleet=fleet, device="cpu")
    jax_rc = _quiet(jax_batch_mod.batch, parent, tmp_path / "jax",
                    k_size=21, fleet=fleet)
    assert rc == jax_rc == 2
    items = _manifest_items(tmp_path / "port")
    assert items == _manifest_items(tmp_path / "jax")
    assert items["iso_001"]["status"] == "failed"
    assert "fault injection: corrupt FASTA read" in items["iso_001"]["error"]
    assert items["iso_000"]["status"] == items["iso_002"]["status"] == "done"
    for name in ("consensus_assembly.fasta", "input_assemblies.gfa"):
        assert (tmp_path / "port" / "iso_002" / name).read_bytes() == \
            (tmp_path / "jax" / "iso_002" / name).read_bytes()


def test_gfa_fault_fails_trim_with_error(tmp_path, monkeypatch, capsys):
    asm = make_assemblies(tmp_path / "asm", n_assemblies=3,
                          chromosome_len=2000, plasmid_len=400, seed=12)
    for module in (compress_mod, trim_mod):
        monkeypatch.setattr(module, "resolve_device",
                            lambda dev=None: torch.device("cpu"))
    from autocycler_tpu_torch.commands.cluster import cluster
    _quiet(compress_mod.compress, asm, tmp_path / "out", k_size=21,
           device="cpu")
    _quiet(cluster, tmp_path / "out", device="cpu")
    c = sorted((tmp_path / "out" / "clustering" / "qc_pass").iterdir())[0]
    monkeypatch.setenv("AUTOCYCLER_FAULTS", f"gfa:{c.name}/1_untrimmed")
    capsys.readouterr()
    assert cli.main(["trim", "-c", str(c)]) == 1
    err = capsys.readouterr().err
    assert "Error: fault injection: corrupt GFA read" in err
    assert not (c / "2_trimmed.gfa").exists()


@pytest.mark.parametrize("spec,reason", [
    ("stream_write:bin-::1",
     "OSError: fault injection: stream bin write failed"),
    ("stream_read:bin-::1",
     "SpillError: bin 0 quarantined: fault injection: forced corrupt bin "
     "read"),
    ("stream_format:bin-::1",
     "SpillError: bin 0 quarantined: unsupported spill record format -1")])
def test_stream_faults_degrade_to_in_memory_as_jax(tmp_path, monkeypatch,
                                                   spec, reason):
    from autocycler_tpu.commands.compress import compress as jax_compress
    asm = make_assemblies(tmp_path / "asm", n_assemblies=2,
                          chromosome_len=3000, plasmid_len=500, seed=14)
    monkeypatch.setenv("AUTOCYCLER_STREAM_KMERS", "on")
    monkeypatch.setenv("AUTOCYCLER_STREAM_BINS", "5")
    monkeypatch.setenv("AUTOCYCLER_STREAM_CHUNK", "1000")
    monkeypatch.setenv("AUTOCYCLER_FAULTS", spec)
    metrics_registry.reset()
    _quiet(compress_mod.compress, asm, tmp_path / "port", k_size=21,
           device="cpu")
    _quiet(jax_compress, asm, tmp_path / "jax", k_size=21)
    got = rz.degrade_events("stream-kmers")
    want = [e for e in jax_rz.degrade_events()
            if e["chain"] == "stream-kmers"]
    assert [(e["from"], e["to"]) for e in got] == \
        [(e["from"], e["to"]) for e in want] == [("stream", "in-memory")]
    assert got[0]["reason"].startswith(reason)
    assert want[0]["reason"].startswith(reason)
    quarantined = metrics_registry.registry().value(
        "autocycler_stream_quarantined_bins_total")
    assert quarantined == (0 if spec.startswith("stream_write") else 1)
    assert metrics_registry.registry().value(
        rz.FAULT_INJECTIONS_TOTAL, site=spec.split(":")[0], mode="fail") == 1
    for name in ("input_assemblies.gfa", "input_assemblies.yaml"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert not list((tmp_path / "port" / ".stream").iterdir())


def test_run_command_fault_injection_forces_failure_and_hang():
    rz.set_fault_plan(rz.FaultPlan.parse("subprocess:mycmd:fail:1"))
    with pytest.raises(rz.SubprocessError) as ei:
        # argv[0] "mycmd" does not exist: the injected command ran instead
        _quiet(rz.run_command, ["mycmd"])
    assert ei.value.returncode == 3
    assert "forced subprocess failure" in ei.value.stderr_tail

    rz.set_fault_plan(rz.FaultPlan.parse("subprocess::hang"))
    with pytest.raises(rz.SubprocessError) as ei:
        _quiet(rz.run_command, ["mycmd"], timeout=0.5)
    assert ei.value.returncode is None and "timed out" in str(ei.value)


def test_subprocess_fault_reaches_the_retry_path(tmp_path):
    """One forced failure, then the real command on the retry: run_command
    succeeds after one retry and writes the command's own output."""
    metrics_registry.reset()
    rz.set_fault_plan(rz.FaultPlan.parse(f"subprocess:{sys.executable}::1"))
    out = tmp_path / "out.txt"
    slept = []
    assert _quiet(rz.run_command, [sys.executable, "-c", "print('real')"],
                  stdout_file=out, retries=1, sleep=slept.append) == 0
    assert out.read_text() == "real\n" and len(slept) == 1
    name = os.path.basename(sys.executable)
    assert metrics_registry.registry().value(
        rz.SUBPROCESS_RETRIES_TOTAL, command=name) == 1


# ---------------------------------------------------------------------------
# the crash points, in real child processes
# ---------------------------------------------------------------------------

_CHILD = r"""
import sys, torch
from pathlib import Path
asm, out, point = sys.argv[1:4]
if point == "mid-fleet-shard":
    from autocycler_tpu_torch.commands.batch import batch
    sys.exit(batch(asm, out, k_size=21, fleet="on", device="cpu"))
if point == "pre-artifact-rename":
    from autocycler_tpu_torch import cli
    from autocycler_tpu_torch.commands import compress
    compress.resolve_device = lambda dev=None: torch.device("cpu")
    sys.exit(cli.main(["compress", "-i", asm, "-a", out, "--kmer", "21"]))
from autocycler_tpu_torch.commands.compress import compress
compress(asm, out, k_size=21, device="cpu")
"""


@pytest.mark.parametrize("point,how", [
    ("post-stage", "points"), ("mid-spill-write", "points"),
    ("mid-cache-store", "points"), ("pre-artifact-rename", "points"),
    ("mid-fleet-shard", "points"), ("mid-spill-write", "plan"),
    ("mid-spill-write", "second batch")])
def test_each_crash_point_kills_a_child(tmp_path, point, how):
    """Armed (by AUTOCYCLER_CRASH_POINTS, or by a plan rule at the site),
    each registered crash point kills a child process at its real call
    site, with exit 43 and the marker on stderr. The second-batch case
    tears the append of pass 1's second batch (one bin, a flush every
    chunk: one append a batch), and leaves a torn run dir that the orphan
    sweep removes."""
    if point == "mid-fleet-shard":
        asm = make_isolate_dirs(tmp_path / "isolates", 2, seed0=3, **TINY)
    else:
        asm = make_assemblies(tmp_path / "asm", n_assemblies=2,
                              chromosome_len=2000, plasmid_len=400, seed=13)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update({"AUTOCYCLER_STREAM_KMERS": "on",
                "AUTOCYCLER_ENCODE_CACHE": "1",
                "AUTOCYCLER_FLEET_DEVICES": "1",
                "AUTOCYCLER_TRACE_DIR": str(tmp_path / "run")})
    if how == "second batch":
        # 2 x 2 x (1,980 + 380) windows in plan chunks of 100: 96 chunks,
        # 3 batches of at most 32
        env.update({"AUTOCYCLER_STREAM_BINS": "1",
                    "AUTOCYCLER_STREAM_CHUNK": "100",
                    "AUTOCYCLER_STREAM_FLUSH": "1",
                    "AUTOCYCLER_CRASH_POINTS": f"{point}@2"})
    else:
        env["AUTOCYCLER_CRASH_POINTS" if how == "points"
            else "AUTOCYCLER_FAULTS"] = point
    child = subprocess.run(
        [sys.executable, "-c", _CHILD, str(asm), str(tmp_path / "out"),
         point], env=env, capture_output=True, text=True, timeout=300)
    assert child.returncode == rz.CRASH_EXIT, child.stderr[-2000:]
    assert f"autocycler crash injection: {point}" in child.stderr
    if how == "second batch":
        from autocycler_tpu_torch import stream as st
        root = tmp_path / "out" / ".stream"
        (torn,) = root.glob("run-*")
        assert json.loads((torn / "manifest.json").read_text())[
            "counts"] is None
        assert (torn / "bin-0000.u64").stat().st_size > 0
        with contextlib.redirect_stderr(io.StringIO()):
            assert st.sweep_orphan_spills(root) == 1
        assert not torn.exists()
