"""The port's `autocycler doctor` (autocycler_tpu_torch/commands/doctor.py),
case for case against the JAX package's tests/test_doctor.py: the --json
schema, no device bring-up, the recommended-actions rules over the port's
kinds, the negative-cache reader, the text and --watch renderings and the
CLI smoke on a host without a card. Then parity with the JAX package on the
same evidence: the report's keys and one action per case."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from autocycler_tpu.commands import doctor as jax_doctor
from autocycler_tpu.obs import sentinel as jax_sentinel
from autocycler_tpu_torch import device
from autocycler_tpu_torch.commands import doctor
from autocycler_tpu_torch.obs import sentinel

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_sentinel(monkeypatch):
    monkeypatch.delenv("AUTOCYCLER_TRACE_DIR", raising=False)
    monkeypatch.delenv("AUTOCYCLER_PROBE_WATCH", raising=False)
    for module in (sentinel, jax_sentinel):
        module._reset_for_tests()
    device._probe_reset()
    yield
    for module in (sentinel, jax_sentinel):
        module._reset_for_tests()
    device._probe_reset()


# ---------------- gather / --json schema ----------------

def test_gather_schema(tmp_path):
    report = doctor.gather(str(tmp_path))
    for key in ("env", "probe_state", "negative_cache", "probe_log",
                "async_probe", "actions"):
        assert key in report, key
    assert "cuda_visible_devices" in report["env"]
    assert "kind" in report["probe_state"]
    assert report["negative_cache"]["present"] is False
    assert report["probe_log"]["entries"] == []
    assert isinstance(report["actions"], list) and report["actions"]
    json.dumps(report)  # the --json payload must serialise


def test_gather_initiates_no_device_bring_up(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(sentinel, "subprocess_probe",
                        lambda deadline: pytest.fail("probe child"))
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: pytest.fail("CUDA call"))
    before = device.device_probe_report()["probes"]
    doctor.gather(str(tmp_path))
    assert device.device_probe_report()["probes"] == before
    assert device.probe_overlap_report()["state"] == "unstarted"


def test_gather_reads_run_dir_probe_log(tmp_path):
    sentinel.set_probe_log_dir(tmp_path)
    sentinel.record_outcome({"attached": False, "kind": "timeout",
                             "reason": "wedge", "seconds": 60.0})
    sentinel.set_probe_log_dir(None)
    report = doctor.gather(str(tmp_path))
    assert report["probe_log"]["entries"][0]["kind"] == "timeout"


# ---------------- negative cache reader ----------------

def test_negative_cache_state_fresh_and_stale(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_PROBE_NEG_TTL_S", "300")
    cache = tmp_path / ".cache"
    cache.mkdir()
    entry = {"kind": "timeout", "reason": "wedged", "at": time.time()}
    (cache / "device_probe.json").write_text(json.dumps(entry))
    state = doctor.negative_cache_state(str(tmp_path))
    assert state["present"] and state["fresh"] and state["kind"] == "timeout"

    entry["at"] = time.time() - 10_000
    (cache / "device_probe.json").write_text(json.dumps(entry))
    state = doctor.negative_cache_state(str(tmp_path))
    assert state["present"] and not state["fresh"]


# ---------------- recommended actions rules ----------------

def _env(devices=(), visible=None):
    return {"cuda_visible_devices": visible, "env": {},
            "accel_devices": list(devices)}


_NO_CACHE = {"present": False, "fresh": False}


def test_actions_timeout_diagnoses_wedged_card():
    actions = doctor.recommended_actions({"kind": "timeout"}, _NO_CACHE,
                                         _env(), [])
    text = " ".join(actions)
    assert "wedged driver or card" in text and "nvidia-smi" in text
    assert "AUTOCYCLER_PROBE_WATCH" in text


def test_actions_fresh_negative_cache_mentions_suppression():
    actions = doctor.recommended_actions(
        {"kind": None},
        {"present": True, "fresh": True, "kind": "timeout",
         "path": "x/device_probe.json", "age_s": 5.0, "ttl_s": 300.0},
        _env(), [])
    assert any("suppressing re-probes" in a for a in actions)


def test_actions_ok_and_pinned_and_unknown():
    ok = doctor.recommended_actions({"kind": "ok"}, _NO_CACHE, _env(), [])
    assert any("no action needed" in a for a in ok)
    pinned = doctor.recommended_actions({"kind": "pinned"}, _NO_CACHE,
                                        _env(visible="-1"), [])
    assert any("CUDA_VISIBLE_DEVICES='-1' hides every card" in a
               for a in pinned)
    unknown = doctor.recommended_actions({"kind": None}, _NO_CACHE,
                                         _env(), [])
    assert any("--probe" in a for a in unknown)


def test_actions_fall_back_to_probe_log_history():
    history = [{"attached": False, "kind": "timeout", "reason": "w",
                "seconds": 60.0},
               {"type": "capture", "capture": {}}]
    actions = doctor.recommended_actions({"kind": None}, _NO_CACHE, _env(),
                                         history)
    assert any("wedged driver or card" in a for a in actions)


def test_actions_no_cuda_host_only_vs_torch_without_cuda():
    host_only = doctor.recommended_actions({"kind": "no-cuda"}, _NO_CACHE,
                                           _env(), [])
    assert any("host without an NVIDIA card" in a for a in host_only)
    with_devices = doctor.recommended_actions(
        {"kind": "no-cuda"}, _NO_CACHE, _env(devices=["/dev/nvidia0"]), [])
    assert any("THIS interpreter" in a for a in with_devices)
    error = doctor.recommended_actions({"kind": "error"}, _NO_CACHE,
                                       _env(), [])
    assert any("driver or toolkit mismatch" in a for a in error)
    disabled = doctor.recommended_actions({"kind": "disabled"}, _NO_CACHE,
                                          _env(), [])
    assert any("attach CUDA directly" in a for a in disabled)


# ---------------- doctor() entry point ----------------

def test_doctor_json_stdout_is_one_report(tmp_path, capsys):
    assert doctor.doctor(str(tmp_path), as_json=True) == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"env", "probe_state", "negative_cache",
                           "probe_log", "async_probe", "lint", "actions"}


def test_doctor_text_render(tmp_path, capsys):
    sentinel.set_probe_log_dir(tmp_path)
    sentinel.record_outcome({"attached": False, "kind": "timeout",
                             "reason": "stub wedge", "seconds": 60.0})
    assert doctor.doctor(str(tmp_path), as_json=False) == 0
    out = capsys.readouterr().out
    assert "autocycler doctor" in out
    assert "CUDA_VISIBLE_DEVICES" in out
    assert "probe history" in out
    assert "recommended actions" in out
    assert "stub wedge" in out


def test_doctor_watch_cycles_print_jsonl(tmp_path, capsys, monkeypatch):
    outcomes = iter([{"attached": False, "kind": "timeout", "reason": "w",
                      "seconds": 0.0},
                     {"attached": True, "kind": "ok", "reason": "r",
                      "seconds": 0.0}])
    monkeypatch.setattr(sentinel, "subprocess_probe",
                        lambda deadline: next(outcomes))
    monkeypatch.setenv("AUTOCYCLER_RECOVERY_CAPTURE", "0")
    assert doctor.doctor(str(tmp_path), watch=True, interval=0.01,
                         cycles=2) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["kind"] for x in lines] == ["timeout", "ok"]
    kinds = [e.get("kind") for e in
             sentinel.read_probe_log(tmp_path / "probe_log.jsonl")]
    assert "timeout" in kinds and "ok" in kinds


# ---------------- CLI smoke: no device bring-up ----------------

def test_cli_doctor_json_smoke(tmp_path):
    """`python -m autocycler_tpu_torch doctor --json` on this host: one
    JSON report with the JAX report's keys, exit 0, no probe (probes 0, the
    background probe unstarted) and no jax loaded."""
    env = dict(os.environ, AUTOCYCLER_TRACE_DIR="", AUTOCYCLER_PROBE_WATCH="",
               PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['autocycler', 'doctor', '--json', "
         f"'-d', {str(tmp_path)!r}]\n"
         "try:\n"
         "    runpy.run_module('autocycler_tpu_torch', run_name='__main__')\n"
         "except SystemExit as e:\n"
         "    assert not e.code, e.code\n"
         "assert 'jax' not in sys.modules\n"
         "import torch\n"
         "assert not torch.cuda.is_initialized()\n"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert set(report) == set(jax_doctor.gather(str(tmp_path)))
    assert report["probe_state"]["probes"] == 0
    assert report["async_probe"]["state"] == "unstarted"
    assert report["actions"]


# ---------------- parity with the JAX package ----------------

def test_doctor_json_has_the_jax_report_keys(tmp_path):
    (tmp_path / "device_probe.json").write_text(json.dumps(
        {"kind": "timeout", "reason": "wedged", "at": time.time()}))
    got, want = doctor.gather(str(tmp_path)), jax_doctor.gather(str(tmp_path))
    assert set(got) == set(want)
    for key in ("probe_state", "async_probe", "negative_cache", "probe_log",
                "lint"):
        assert set(got[key]) == set(want[key]), key
    # the environment: CUDA_VISIBLE_DEVICES in place of JAX_PLATFORMS
    assert set(got["env"]) - {"cuda_visible_devices"} == \
        set(want["env"]) - {"jax_platforms"}
    assert got["actions"] == doctor.recommended_actions(
        got["probe_state"], got["negative_cache"], got["env"], [])


@pytest.mark.parametrize("port_kind,jax_kind,neg,history,devices", [
    ("timeout", "timeout", None, [], ()),
    ("error", "error", None, [], ()),
    ("pinned", "pinned", None, [], ()),
    ("no-cuda", "no-tpu", None, [], ()),
    ("no-cuda", "no-tpu", None, [], ("/dev/nvidia0",)),
    ("ok", "ok", None, [], ()),
    ("disabled", "disabled", None, [], ()),
    (None, None, None, [], ()),
    (None, None, "timeout", [], ()),
    (None, None, "error", [], ()),
    (None, None, None, [{"attached": False, "kind": "timeout"}], ()),
])
def test_recommended_actions_one_per_case_as_jax(port_kind, jax_kind, neg,
                                                 history, devices):
    cache = dict(_NO_CACHE)
    if neg:
        cache = {"present": True, "fresh": True, "kind": neg,
                 "path": "x/device_probe.json", "age_s": 1.0, "ttl_s": 300.0}
    got = doctor.recommended_actions({"kind": port_kind}, cache,
                                     _env(devices=devices), history)
    jax_devices = ["/dev/accel0"] if devices else []
    want = jax_doctor.recommended_actions(
        {"kind": jax_kind}, cache,
        {"jax_platforms": None, "env": {}, "accel_devices": jax_devices},
        history)
    assert len(got) == len(want)
    assert [("AUTOCYCLER_PROBE_WATCH" in a) for a in got] == \
        [("AUTOCYCLER_PROBE_WATCH" in a) for a in want]


def test_lint_state_has_no_baseline_until_lint_is_ported(tmp_path):
    """The port reads its own lint baseline, lint_baseline_torch.json (empty:
    the tree lints clean), never the JAX package's lint_baseline.json; a
    run dir's lint_report.json is read as the JAX package reads it."""
    assert (REPO / "lint_baseline.json").is_file()
    state = doctor.lint_state(str(tmp_path))
    assert state == {"baseline": str(REPO / "lint_baseline_torch.json"),
                     "baselined": 0, "report": None}
    (tmp_path / "lint_report.json").write_text(json.dumps(
        {"findings": [{}, {}], "files": 3, "wall_s": 0.5}))
    assert doctor.lint_state(str(tmp_path))["report"] == \
        jax_doctor.lint_state(str(tmp_path))["report"]


def test_doctor_watch_fires_the_recovery_capture(tmp_path, capsys,
                                                 monkeypatch):
    """--watch arms the recovery capture: a false -> true transition writes
    recovery_capture.json beside the probe log (both parts skipped on a
    host without a card)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    outcomes = iter([{"attached": False, "kind": "timeout", "reason": "w",
                      "seconds": 0.0},
                     {"attached": True, "kind": "ok", "reason": "r",
                      "seconds": 0.0}])
    monkeypatch.setattr(sentinel, "subprocess_probe",
                        lambda deadline: next(outcomes))
    assert doctor.doctor(str(tmp_path), watch=True, interval=0.01,
                         cycles=2) == 0
    capture = json.loads((tmp_path / "recovery_capture.json").read_text())
    assert capture["trigger"]["kind"] == "ok"
    assert capture["dotplot"] == {"skipped": "no CUDA device"}
    types = [e.get("type") for e in
             sentinel.read_probe_log(tmp_path / "probe_log.jsonl")]
    assert "recovery" in types and "capture" in types
    capsys.readouterr()
