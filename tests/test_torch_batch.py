"""The port's `batch` on the CPU against the JAX package's: every file of
every isolate's out dir and the run manifest, serial and fleet; the
quarantine of a corrupt isolate and of an unreadable cluster GFA; resume
(also of a manifest the other package wrote); the mid-fleet-shard crash
cycle; `run_fleet_jobs`; trim's `alignments=`; and the CLI's exit codes.
The tolerance is 0: files compare byte for byte."""

import contextlib
import copy
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from autocycler_tpu.commands import batch as jax_batch_mod
from autocycler_tpu.utils import AutocyclerError as JaxAutocyclerError
from autocycler_tpu.utils import resilience as jax_rz
from autocycler_tpu_torch import cli, device
from autocycler_tpu_torch.commands import batch as batch_mod
from autocycler_tpu_torch.commands.trim import trim
from autocycler_tpu_torch.models import UnitigGraph
from autocycler_tpu_torch.utils import AutocyclerError
from autocycler_tpu_torch.utils import resilience as rz

from synthetic import make_isolate_dirs
from test_torch_trim_resolve import append_start_overlaps

TINY = dict(n_assemblies=3, chromosome_len=160, plasmid_len=70)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    jax_rz.set_fault_plan(None)
    yield
    jax_rz.set_fault_plan(None)


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def jax_batch(*args, **kwargs):
    return _quiet(jax_batch_mod.batch, *args, **kwargs)


def port_batch(*args, **kwargs):
    return _quiet(batch_mod.batch, *args, device="cpu", **kwargs)


def _isolates(root, n, seed0, overlaps=()):
    """n tiny isolates; those in ``overlaps`` carry start-end overlaps, so
    that trim's DP decodes alignments on the device."""
    parent = make_isolate_dirs(root / "isolates", n, seed0=seed0, **TINY)
    for i in overlaps:
        append_start_overlaps(parent / f"iso_{i:03d}",
                              np.random.default_rng(i), (30, 60), (25, 40))
    return parent


def _files(out_parent: Path):
    """Every file under each isolate's out dir, by path; a warm-start
    cache entry by name only (its zip members carry their write time)."""
    out = {}
    for iso in sorted(d for d in out_parent.iterdir() if d.is_dir()):
        for p in sorted(iso.rglob("*")):
            if p.is_file():
                rel = str(p.relative_to(out_parent))
                out[rel] = None if ".cache" in p.parts else p.read_bytes()
    return out


def _manifest(out_parent: Path):
    """The manifest's items, without write times and the out-parent
    prefix of the recorded output paths."""
    items = json.loads((out_parent / "batch_manifest.json").read_text())["items"]
    items = copy.deepcopy(items)
    prefix = str(out_parent) + "/"
    for entry in items.values():
        if entry.get("error"):
            entry["error"] = entry["error"].replace(prefix, "")
        for stage in (entry.get("stages") or {}).values():
            stage.pop("ts_epoch")
            stage["outputs"] = {path.replace(prefix, ""): digest
                                for path, digest in stage["outputs"].items()}
    return items


def _corrupt(parent, iso="iso_001"):
    """A FASTA record with no sequence (load_fasta rejects it); returns
    the good bytes."""
    bad = parent / iso / "assembly_1.fasta"
    good = bad.read_bytes()
    bad.write_text(">broken_record\n")
    return bad, good


def test_batch_files_and_manifest_equal_jax(tmp_path):
    parent = _isolates(tmp_path, 3, seed0=40, overlaps=(0,))
    device.reset_counts()
    assert port_batch(parent, tmp_path / "port", k_size=21) == 0
    assert jax_batch(parent, tmp_path / "jax", k_size=21) == 0
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    assert sum(name.endswith("consensus_assembly.fasta") for name in got) == 3
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")
    # one contraction for all isolates; the overlap isolate's DPs decode
    # on the device and its contigs are trimmed
    assert device.dp_summary("batch_membership_contraction")["dispatches"] == 1
    assert device.dp_summary("trim_overlap_dp")["dispatches"] >= 1
    lengths = (tmp_path / "port" / "iso_000" / "clustering" / "qc_pass" /
               "cluster_001" / "2_trimmed.yaml").read_text()
    assert "trimmed_cluster_median: 160" in lengths or \
        "trimmed_cluster_median: 70" in lengths


def test_fleet_equals_serial_and_jax(tmp_path, monkeypatch):
    parent = _isolates(tmp_path, 3, seed0=3, overlaps=(1,))
    assert port_batch(parent, tmp_path / "serial", k_size=21) == 0
    monkeypatch.setenv("AUTOCYCLER_FLEET_DEVICES", "2")
    device.reset_counts()
    assert port_batch(parent, tmp_path / "fleet", k_size=21,
                      fleet="on") == 0
    # 3 isolates in 3 size buckets, so 3 shards: one contraction a shard,
    # none serial
    assert device.dp_summary("fleet_membership_contraction")["dispatches"] == 3
    assert device.dp_summary("batch_membership_contraction")["dispatches"] == 0
    assert jax_batch(parent, tmp_path / "jax_fleet", k_size=21,
                     fleet="on") == 0
    serial = _files(tmp_path / "serial")
    assert len(serial) > 30
    assert _files(tmp_path / "fleet") == serial == _files(tmp_path / "jax_fleet")
    assert _manifest(tmp_path / "fleet") == _manifest(tmp_path / "jax_fleet")


def test_single_isolate_fleet_takes_serial_path(tmp_path):
    parent = _isolates(tmp_path, 1, seed0=9)
    assert port_batch(parent, tmp_path / "serial", k_size=21,
                      fleet="off") == 0
    device.reset_counts()
    assert port_batch(parent, tmp_path / "fleet", k_size=21,
                      fleet="on") == 0
    assert device.dp_summary("fleet_membership_contraction")["dispatches"] == 0
    assert device.dp_summary("batch_membership_contraction")["dispatches"] == 1
    assert _files(tmp_path / "fleet") == _files(tmp_path / "serial")


@pytest.mark.parametrize("fleet", ["off", "on"])
def test_corrupt_isolate_quarantined_and_resumed_as_jax(tmp_path,
                                                        monkeypatch, fleet):
    parent = _isolates(tmp_path, 3, seed0=40)
    bad, good = _corrupt(parent)
    monkeypatch.setenv("AUTOCYCLER_FLEET_DEVICES", "2")
    rc = port_batch(parent, tmp_path / "port", k_size=21, fleet=fleet)
    assert rc == jax_batch(parent, tmp_path / "jax", k_size=21,
                           fleet=fleet) == 2
    items = _manifest(tmp_path / "port")
    assert items == _manifest(tmp_path / "jax")
    assert items["iso_001"]["status"] == "failed"
    assert items["iso_001"]["stage"] == "compress"
    assert items["iso_001"]["attempts"] == 1
    assert "sequence" in items["iso_001"]["error"]   # load_fasta's diagnosis
    assert [items[i]["status"] for i in ("iso_000", "iso_002")] == ["done"] * 2

    # fix the input, resume: only the failed isolate is reprocessed
    bad.write_bytes(good)
    before = _files(tmp_path / "port")
    loaded = []
    real_load = batch_mod.load_sequences

    def spy_load(iso_dir, *args, **kwargs):
        loaded.append(Path(iso_dir).name)
        return real_load(iso_dir, *args, **kwargs)

    monkeypatch.setattr(batch_mod, "load_sequences", spy_load)
    rc = port_batch(parent, tmp_path / "port", k_size=21, fleet=fleet,
                    resume=True)
    assert rc == jax_batch(parent, tmp_path / "jax", k_size=21, fleet=fleet,
                           resume=True) == 0
    assert loaded == ["iso_001"]
    items = _manifest(tmp_path / "port")
    assert items == _manifest(tmp_path / "jax")
    assert items["iso_001"]["attempts"] == 2
    assert items["iso_000"]["attempts"] == 1
    after = _files(tmp_path / "port")
    assert {k: v for k, v in after.items() if not k.startswith("iso_001")} \
        == {k: v for k, v in before.items() if not k.startswith("iso_001")}
    assert after == _files(tmp_path / "jax")
    # everything done: a second resume is a no-op
    assert port_batch(parent, tmp_path / "port", k_size=21,
                      resume=True) == 0
    assert _manifest(tmp_path / "port")["iso_001"]["attempts"] == 2


def test_all_isolates_failed_raises(tmp_path):
    parent = _isolates(tmp_path, 2, seed0=60)
    for iso in ("iso_000", "iso_001"):
        _corrupt(parent, iso)
    with pytest.raises(AutocyclerError, match="failed during compress") as got:
        port_batch(parent, tmp_path / "port", k_size=21)
    with pytest.raises(JaxAutocyclerError) as want:
        jax_batch(parent, tmp_path / "jax", k_size=21)
    assert str(got.value).replace(str(tmp_path / "port"), "") == \
        str(want.value).replace(str(tmp_path / "jax"), "")
    items = _manifest(tmp_path / "port")
    assert items == _manifest(tmp_path / "jax")
    assert all(v["status"] == "failed" for v in items.values())


def _corrupting_cluster(module, monkeypatch, iso):
    """Wrap ``module``'s run_cluster so that iso's first cluster GFA is
    unreadable (gzip magic, then no valid header) once cluster has
    written it."""
    real = module.run_cluster

    def run(out_dir, *args, **kwargs):
        result = real(out_dir, *args, **kwargs)
        if Path(out_dir).name == iso:
            gfa = sorted(Path(out_dir).glob("clustering/qc_pass/*/"
                                            "1_untrimmed.gfa"))[0]
            gfa.write_bytes(b"\x1f\x8b" + bytes(20))
        return result

    monkeypatch.setattr(module, "run_cluster", run)


def test_unreadable_cluster_gfa_quarantined_at_trim(tmp_path, monkeypatch):
    parent = _isolates(tmp_path, 2, seed0=80)
    _corrupting_cluster(batch_mod, monkeypatch, "iso_000")
    _corrupting_cluster(jax_batch_mod, monkeypatch, "iso_000")
    rc = port_batch(parent, tmp_path / "port", k_size=21)
    assert rc == jax_batch(parent, tmp_path / "jax", k_size=21) == 2
    items = _manifest(tmp_path / "port")
    jax_items = _manifest(tmp_path / "jax")
    assert items["iso_000"]["status"] == "failed"
    assert items["iso_000"]["stage"] == "trim"
    assert items["iso_000"]["error"].startswith("failed to open file")
    # the cluster stage recorded the GFA before it was corrupted; the
    # error names the file under each run's own out dir
    assert items == jax_items
    assert items["iso_001"]["status"] == "done"
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


class _Crash(RuntimeError):
    """Stands in for the os._exit a real crash injection performs."""


def test_mid_fleet_shard_crash_then_resume_equals_serial(tmp_path,
                                                         monkeypatch):
    parent = _isolates(tmp_path, 2, seed0=4)
    assert port_batch(parent, tmp_path / "serial", k_size=21) == 0

    def _raise(code):
        raise _Crash(code)

    monkeypatch.setenv("AUTOCYCLER_FLEET_DEVICES", "1")
    monkeypatch.setenv("AUTOCYCLER_CRASH_POINTS", "mid-fleet-shard")
    monkeypatch.setattr(rz, "_exit", _raise)
    rz._reset_crash_hits_for_tests()
    try:
        with pytest.raises(_Crash) as crash:
            port_batch(parent, tmp_path / "fleet", k_size=21, fleet="on")
    finally:
        rz._reset_crash_hits_for_tests()
    assert crash.value.args == (rz.CRASH_EXIT,)
    items = _manifest(tmp_path / "fleet")
    # the first shard's isolate has its compress checkpoint and no cluster
    assert [sorted(e.get("stages", {})) for e in items.values()] in (
        [["compress"], []], [[], ["compress"]])
    monkeypatch.delenv("AUTOCYCLER_CRASH_POINTS")
    assert port_batch(parent, tmp_path / "fleet", k_size=21, fleet="on",
                      resume=True) == 0
    assert _files(tmp_path / "fleet") == _files(tmp_path / "serial")


def test_crash_points_parse_as_jax(monkeypatch):
    assert rz.CRASH_POINTS == jax_rz.CRASH_POINTS
    assert rz.CRASH_EXIT == jax_rz.CRASH_EXIT
    for spec in ("mid-fleet-shard", "post-stage@3, mid-fleet-shard@2", ""):
        assert rz._parse_crash_points(spec) == jax_rz._parse_crash_points(spec)
    for spec in ("nowhere", "post-stage@x"):
        with pytest.raises(jax_rz.InputError) as want:
            jax_rz._parse_crash_points(spec)
        with pytest.raises(rz.InputError) as got:
            rz._parse_crash_points(spec)
        assert str(got.value) == str(want.value)
    monkeypatch.setenv("AUTOCYCLER_CRASH_POINTS", "post-stage@2")
    rz._reset_crash_hits_for_tests()
    try:
        assert not rz.crash_armed("post-stage")
        rz.crash_point("post-stage")
        assert rz.crash_armed("post-stage")
        assert not rz.crash_armed("mid-fleet-shard")
    finally:
        rz._reset_crash_hits_for_tests()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_manifest_of_either_package_resumes_under_the_other(tmp_path, first):
    parent = _isolates(tmp_path, 3, seed0=40)
    bad, good = _corrupt(parent)
    runs = {"jax": jax_batch, "port": port_batch}
    second = "port" if first == "jax" else "jax"
    assert runs[first](parent, tmp_path / "out", k_size=21) == 2
    bad.write_bytes(good)
    assert runs[second](parent, tmp_path / "out", k_size=21,
                        resume=True) == 0
    items = _manifest(tmp_path / "out")
    assert [items[i]["attempts"] for i in sorted(items)] == [1, 2, 1]
    assert all(e["status"] == "done" for e in items.values())
    assert runs["port"](parent, tmp_path / "clean", k_size=21) == 0
    assert _files(tmp_path / "out") == {
        k: v for k, v in _files(tmp_path / "clean").items()}


def test_run_fleet_jobs_equals_jax(tmp_path, monkeypatch):
    parent = _isolates(tmp_path, 3, seed0=20)
    monkeypatch.setenv("AUTOCYCLER_FLEET_DEVICES", "2")

    def jobs(root, cls):
        return [cls(f"job{i}", parent / f"iso_{i:03d}", root / f"job{i}")
                for i in range(3)]

    rc = _quiet(batch_mod.run_fleet_jobs, jobs(tmp_path / "port",
                                               batch_mod.IsolateJob),
                k_size=21, manifest_path=tmp_path / "port" / "fleet.json",
                device="cpu")
    assert rc == _quiet(jax_batch_mod.run_fleet_jobs,
                        jobs(tmp_path / "jax", jax_batch_mod.IsolateJob),
                        k_size=21,
                        manifest_path=tmp_path / "jax" / "fleet.json") == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    # a resume of a finished run does nothing
    assert _quiet(batch_mod.run_fleet_jobs, jobs(tmp_path / "port",
                                                 batch_mod.IsolateJob),
                  k_size=21, manifest_path=tmp_path / "port" / "fleet.json",
                  resume=True, device="cpu") == 0


def test_trim_with_batch_alignments_equals_plain_trim(tmp_path):
    parent = _isolates(tmp_path, 1, seed0=7, overlaps=(0,))
    assert port_batch(parent, tmp_path / "out", k_size=21) == 0
    clusters = sorted((tmp_path / "out" / "iso_000" / "clustering" /
                       "qc_pass").iterdir())
    for cdir in clusters:
        plain = tmp_path / "plain" / cdir.name
        given = tmp_path / "given" / cdir.name
        for d in (plain, given):
            d.mkdir(parents=True)
            shutil.copy(cdir / "1_untrimmed.gfa", d / "1_untrimmed.gfa")
        graph_pair = UnitigGraph.from_gfa_file(given / "1_untrimmed.gfa")
        screens, _ = batch_mod._batched_trim_screens(
            [given], {given: graph_pair},
            batch_mod.batch_mesh(torch.device("cpu")))
        device.reset_counts()
        _quiet(trim, given, device="cpu", alignments=screens[given])
        with_alignments = device.dp_summary("trim_overlap_dp")["dispatches"]
        device.reset_counts()
        _quiet(trim, plain, device="cpu")
        assert device.dp_summary("trim_overlap_dp")["dispatches"] >= \
            with_alignments
        for name in ("2_trimmed.gfa", "2_trimmed.yaml"):
            assert (given / name).read_bytes() == (plain / name).read_bytes()
            assert (given / name).read_bytes() == (cdir / name).read_bytes()


def _cli(argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    return rc, err.getvalue()


def test_cli_exit_codes(tmp_path, monkeypatch):
    parent = _isolates(tmp_path, 2, seed0=30)
    monkeypatch.setattr(batch_mod, "resolve_device",
                        lambda dev=None: torch.device("cpu"))
    args = ["batch", "-i", parent, "-k", "21", "-t", "2"]
    assert _cli(args + ["-a", tmp_path / "ok"])[0] == 0
    bad, good = _corrupt(parent, "iso_000")
    assert _cli(args + ["-a", tmp_path / "partial"])[0] == 2
    _corrupt(parent, "iso_001")
    rc, err = _cli(args + ["-a", tmp_path / "none"])
    assert rc == 1 and "Error: all 2 isolate(s) failed" in err
    rc, err = _cli(["batch", "-i", tmp_path / "missing", "-a", tmp_path / "x"])
    assert rc == 1 and "Error: directory does not exist" in err
    rc, err = _cli(args + ["-a", tmp_path / "k", "-k", "20"])
    assert rc == 1 and "Error: --kmer must be an odd number" in err


def test_cli_without_cuda_fails_before_any_isolate(tmp_path, monkeypatch):
    parent = _isolates(tmp_path, 2, seed0=30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, err = _cli(["batch", "-i", parent, "-a", tmp_path / "out", "-k", "21"])
    assert rc == 1
    assert "Error: no CUDA device is available" in err
    assert not (tmp_path / "out").exists()
    assert "Compressing" not in err


def test_quarantine_lets_cuda_errors_through(tmp_path, monkeypatch):
    errs = rz.collect_errors()
    with errs.quarantine("a"):
        raise rz.InputError("bad input")
    with pytest.raises(RuntimeError, match="CUDA error"):
        with errs.quarantine("b"):
            raise RuntimeError("CUDA error: an illegal memory access")
    assert errs.failed("a") and not errs.failed("b") and len(errs) == 1
    parent = _isolates(tmp_path, 2, seed0=50)

    def failing_build(*args, **kwargs):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(batch_mod, "build_unitig_graph", failing_build)
    with pytest.raises(RuntimeError, match="CUDA error"):
        port_batch(parent, tmp_path / "out", k_size=21)
    items = _manifest(tmp_path / "out")
    assert items["iso_000"]["status"] == "running"
    assert items["iso_001"]["status"] == "pending"
