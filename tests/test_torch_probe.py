"""The port's device probe gate (autocycler_tpu_torch/device.py), case for
case against the JAX package's tests/test_device_probe.py (the timed
synchronous probe, its TTL and negative cache) and tests/test_async_probe.py
(the background probe, its overlap report, retries before a negative is
persisted, and the readers that report it). Where the JAX case asserts a
fallback to the host, the port's asserts the ``Error:`` end: the port has
no host path, and no outcome of the probe moves work to the CPU.

This host has no /dev/nvidia*, which the gate answers ("no-cuda") without a
child; a test that needs the probe itself stubs ``device._short_circuit``
(as the JAX tests unpin JAX_PLATFORMS) and the attempt, the thread or the
child (``sentinel._probe_argv``)."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from autocycler_tpu_torch import device
from autocycler_tpu_torch.obs import sentinel
from autocycler_tpu_torch.utils import AutocyclerError, knobs, timing


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Reset the probe, the background probe, the gate and the sentinel
    around each test; the knobs the tests set are the test's own."""
    for name in ("AUTOCYCLER_PROBE_DEADLINE_S", "CUDA_VISIBLE_DEVICES",
                 "AUTOCYCLER_PROBE_WATCH", "AUTOCYCLER_TRACE_DIR"):
        monkeypatch.delenv(name, raising=False)
    device._probe_reset()
    sentinel._reset_for_tests()
    yield device
    # let an in-flight background runner resolve before the next test
    with device._PROBE_LOCK:
        event = device._bg_state.get("event")
    if event is not None:
        event.wait(10.0)
    device._probe_reset()
    sentinel._reset_for_tests()


def _unpinned(monkeypatch):
    """Reach the probe on this card-less host."""
    monkeypatch.setattr(device, "_short_circuit", lambda: None)


class _Hanging:
    """A threading.Thread whose target blocks, counting constructions."""

    def __init__(self):
        self.calls = []
        real = threading.Thread
        outer = self

        class HangingThread(real):
            def __init__(self, *a, **kw):
                outer.calls.append(1)
                kw["target"] = lambda: threading.Event().wait(5)
                super().__init__(*a, **kw)

        self.cls = HangingThread


def _hang(monkeypatch):
    h = _Hanging()
    monkeypatch.setattr(device.threading, "Thread", h.cls)
    return h


# ======== the synchronous probe (JAX tests/test_device_probe.py) ========

def test_pinned_cuda_visible_devices_short_circuits(monkeypatch):
    """CUDA_VISIBLE_DEVICES=-1 (or empty) hides every card: no probe
    thread, immediate False; without /dev/nvidia* the answer is no-cuda."""
    h = _hang(monkeypatch)
    for value in ("-1", ""):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", value)
        assert device._cuda_attached() is False
        assert device.device_probe_report()["kind"] == "pinned"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setattr(device.glob, "glob", lambda pattern: [])
    assert device._cuda_attached() is False
    assert device.device_probe_report()["kind"] == "no-cuda"
    assert h.calls == []


def test_kill_switch_skips_probe(monkeypatch):
    """A deadline <= 0 disables the probe: no thread, kind disabled."""
    _unpinned(monkeypatch)
    h = _hang(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "0")
    assert device._cuda_attached() is False
    assert device.device_probe_report()["kind"] == "disabled"
    assert h.calls == []


def test_malformed_timeout_warns_and_defaults(monkeypatch, capsys):
    """A malformed timeout warns and takes the 60 s default."""
    _unpinned(monkeypatch)
    seen = []
    monkeypatch.setattr(device, "_probe_attempt", lambda timeout: (
        seen.append(timeout) or (False, "stub", "no-cuda", {}, 0.0)))
    knobs._warned.discard("AUTOCYCLER_PROBE_DEADLINE_S")
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "banana")
    assert device._cuda_attached() is False
    assert seen == [60.0]
    assert "malformed" in capsys.readouterr().err


def test_unresponsive_probe_ends_with_message(monkeypatch, capsys):
    """A probe that never answers within the deadline is a timeout with a
    stderr note — the wedged-card case, simulated by a probe thread that
    blocks (a spawn that never returns) — and the gate then ends the
    command with Error: instead of falling back."""
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "0.05")
    _hang(monkeypatch)
    assert device._cuda_attached() is False
    assert "did not respond" in capsys.readouterr().err
    assert device.device_probe_report()["kind"] == "timeout"
    with pytest.raises(AutocyclerError, match=r"probe failed \(timeout\)"):
        device.resolve_device(None)


def test_probe_outcome_is_recorded_for_artifacts(monkeypatch):
    """Every probe resolution lands in device_probe_report()."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "-1")
    assert device._cuda_attached() is False
    report = device.device_probe_report()
    assert report["attached"] is False
    assert "hides every card" in report["reason"]


def test_probe_failure_is_kept_until_a_recovery(monkeypatch, capsys):
    """A failed probe is kept for the process (the gate has ended the
    command by then): no re-probe however long it waits, until a healthy
    outcome's recovery clears it and the next consult probes again
    (deadline 0.05 s against a hanging probe thread)."""
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "0.05")
    h = _hang(monkeypatch)
    assert device._cuda_attached() is False
    assert len(h.calls) == 1
    time.sleep(0.12)
    assert device._cuda_attached() is False     # cached: no new probe
    assert len(h.calls) == 1
    device.notify_probe_recovered()
    assert device._cuda_attached() is False     # cleared: probes again
    assert len(h.calls) == 2
    report = device.device_probe_report()
    assert report["probes"] == 2
    assert "did not respond" in report["reason"]
    capsys.readouterr()


def test_probe_success_is_kept_for_the_process(monkeypatch):
    """A healthy outcome is probed once and kept; a recovery notice leaves
    it alone."""
    _unpinned(monkeypatch)
    stub = _stub_attempt([(True, "ok")])
    monkeypatch.setattr(device, "_probe_attempt", stub)
    assert device._cuda_attached() is True
    device.notify_probe_recovered()
    assert device._cuda_attached() is True
    assert len(stub.calls) == 1
    assert device.device_probe_report()["probes"] == 1


def test_gate_answers_each_kind(monkeypatch, capsys):
    """What the gate does with each kind (the JAX case asks which kinds
    are safe for a host fallback): pinned and no-cuda give the error of a
    host without a card, timeout the probe's Error: naming doctor, and
    disabled attaches directly, with no child."""
    def cuda(value):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: value)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: "Card X")

    cuda(False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "-1")
    with pytest.raises(AutocyclerError, match="no CUDA device"):
        device.resolve_device(None)
    assert device.device_probe_report()["kind"] == "pinned"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")

    device._probe_reset()
    with pytest.raises(AutocyclerError, match="no CUDA device"):
        device.resolve_device(None)
    assert device.device_probe_report()["kind"] == "no-cuda"

    device._probe_reset()
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "0")
    monkeypatch.setattr(device, "_probe_attempt",
                        _stub_attempt([(False, "timeout")]))
    cuda(True)
    with pytest.raises(AutocyclerError, match="autocycler doctor"):
        device.resolve_device("cuda")
    assert device.device_probe_report()["kind"] == "timeout"
    monkeypatch.undo()

    device._probe_reset()
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "0")
    cuda(True)
    assert device.resolve_device(None).type == "cuda"
    report = device.probe_report()
    assert report["kind"] == "disabled" and report["state"] == "attached"
    assert report["name"] == "Card X"
    capsys.readouterr()


def test_probe_failure_moves_nothing_to_the_cpu(monkeypatch, capsys):
    """With the probe timed out, the distance product asked for CUDA ends
    with Error: (nothing runs on the CPU in its place), while an explicit
    CPU request stays exact."""
    from autocycler_tpu_torch.ops import distance

    rng = np.random.default_rng(0)
    M = (rng.random((6, 40)) < 0.4).astype(np.uint8)
    w = rng.integers(1, 50, size=40).astype(np.int64)
    inter = (M.astype(np.int64) * w[None, :]) @ M.astype(np.int64).T
    assert np.array_equal(distance.intersections(M, w, "cpu"), inter)
    calls = []
    monkeypatch.setattr(distance, "device_work",
                        lambda *a, **kw: calls.append(a) or pytest.fail())
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "0")
    monkeypatch.setattr(device, "_probe_attempt",
                        _stub_attempt([(False, "timeout")]))
    with pytest.raises(AutocyclerError, match=r"probe failed \(timeout\)"):
        distance.intersections(M, w)
    assert calls == []
    capsys.readouterr()


def test_probe_deadline_env_takes_precedence(monkeypatch, capsys):
    """AUTOCYCLER_PROBE_DEADLINE_S is the one deadline knob (the JAX
    package's second spelling is not read); <= 0 disables the probe; a
    malformed value warns and takes the default."""
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_DEVICE_PROBE_TIMEOUT", "0")
    seen = []
    monkeypatch.setattr(device, "_probe_attempt", lambda timeout: (
        seen.append(timeout) or (False, "stub", "no-cuda", {}, 0.0)))
    assert device._cuda_attached() is False
    assert seen == [60.0]
    monkeypatch.undo()

    device._probe_reset()
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "0")
    assert device._cuda_attached() is False
    assert device.device_probe_report()["kind"] == "disabled"

    device._probe_reset()
    seen = []
    monkeypatch.setattr(device, "_probe_attempt", lambda timeout: (
        seen.append(timeout) or (False, "stub", "no-cuda", {}, 0.0)))
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "pear")
    knobs._warned.discard("AUTOCYCLER_PROBE_DEADLINE_S")
    assert device._cuda_attached() is False
    assert seen == [60.0]
    err = capsys.readouterr().err
    assert "malformed float value 'pear' for AUTOCYCLER_PROBE_DEADLINE_S" \
        in err


def test_negative_probe_persists_across_processes(tmp_path, monkeypatch,
                                                  capsys):
    """A timed-out probe writes device_probe.json under the cache dir; a
    fresh probe state (the next process) adopts it without paying another
    deadline; an expired entry is ignored."""
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "0.05")
    h = _hang(monkeypatch)
    device.set_probe_cache_dir(tmp_path)
    assert device._cuda_attached() is False
    assert len(h.calls) == 1
    entry = json.loads((tmp_path / "device_probe.json").read_text())
    assert entry["kind"] == "timeout"

    device._probe_reset()                       # "next process"
    device.set_probe_cache_dir(tmp_path)
    assert device._cuda_attached() is False
    assert len(h.calls) == 1                    # adopted, no new thread
    report = device.device_probe_report()
    assert "persisted negative probe" in report["reason"]
    assert report["kind"] == "timeout"

    entry["at"] = time.time() - 10_000
    (tmp_path / "device_probe.json").write_text(json.dumps(entry))
    device._probe_reset()
    device.set_probe_cache_dir(tmp_path)
    assert device._cuda_attached() is False
    assert len(h.calls) == 2
    capsys.readouterr()


def test_disk_probe_negative_only_and_cleared_on_success(tmp_path,
                                                         monkeypatch):
    """Only timeout and error persist; any other outcome clears a stale
    negative; AUTOCYCLER_PROBE_NEG_TTL_S <= 0 disables adoption."""
    device.set_probe_cache_dir(tmp_path)
    device._disk_probe_store(False, "wedged", "timeout")
    assert (tmp_path / "device_probe.json").exists()
    assert device._disk_probe_load()["reason"] == "wedged"

    monkeypatch.setenv("AUTOCYCLER_PROBE_NEG_TTL_S", "0")
    assert device._disk_probe_load() is None
    monkeypatch.delenv("AUTOCYCLER_PROBE_NEG_TTL_S")

    device._disk_probe_store(False, "no card on host", "no-cuda")
    assert not (tmp_path / "device_probe.json").exists()
    device._disk_probe_store(False, "wedged", "timeout")
    device._disk_probe_store(True, "cuda:0 verified", "ok")
    assert not (tmp_path / "device_probe.json").exists()

    (tmp_path / "device_probe.json").write_text("{not json")
    assert device._disk_probe_load() is None


# ======== the background probe (JAX tests/test_async_probe.py) ========

def _stub_attempt(outcomes, delay=0.0):
    """A _probe_attempt stand-in yielding scripted (attached, kind)
    outcomes in order (the last repeats)."""
    calls = []

    def attempt(timeout):
        t0 = time.perf_counter()
        if delay:
            time.sleep(delay)
        attached, kind = outcomes[min(len(calls), len(outcomes) - 1)]
        calls.append(timeout)
        return attached, f"stub probe ({kind})", kind, {"stub": True}, \
            time.perf_counter() - t0

    attempt.calls = calls
    return attempt


def _final_logged(path, timeout=10.0, also=None):
    """The background probe's final outcome in the log at ``path`` (and an
    entry of type ``also``, which the same thread logs just after it): it
    is logged just after the probe resolves, from the probe's thread."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        entries = sentinel.read_probe_log(path)
        if any(e.get("source") == "background" for e in entries) and (
                also is None or any(e.get("type") == also for e in entries)):
            return entries
        time.sleep(0.01)
    pytest.fail("the background probe's outcome was never logged")


def _wait_resolved(timeout=10.0):
    with device._PROBE_LOCK:
        event = device._bg_state.get("event")
    assert event is not None
    assert event.wait(timeout), "background probe never resolved"


def test_pinned_short_circuits_without_thread(monkeypatch):
    """A pinned host resolves the background probe at once: no thread,
    failed/pinned, zero resolve time, idempotent."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "-1")
    assert device.start_background_probe() is False
    report = device.probe_overlap_report()
    assert report["state"] == "failed"
    assert report["kind"] == "pinned"
    assert report["resolve_s"] == 0.0
    assert device.device_attached() is False
    assert device.device_attached(wait=True) is False
    assert device.start_background_probe() is False


def test_unstarted_report_state():
    assert device.probe_overlap_report()["state"] == "unstarted"


def test_pending_peek_costs_no_wall_time(monkeypatch):
    """While the probe is pending, a consult without wait answers at once
    and is counted; the resolved probe then answers its outcome."""
    _unpinned(monkeypatch)
    monkeypatch.setattr(device, "_probe_attempt",
                        _stub_attempt([(True, "ok")], delay=0.4))
    assert device.start_background_probe() is True
    t0 = time.perf_counter()
    assert device.device_attached() is False
    assert device.device_attached() is False
    assert time.perf_counter() - t0 < 0.2, "peek must not block"
    assert device.probe_overlap_report()["state"] == "pending"
    assert device.probe_overlap_report()["pending_consults"] == 2
    _wait_resolved()
    assert device.device_attached() is True
    report = device.probe_overlap_report()
    assert report["state"] == "attached"
    assert report["kind"] == "ok"


def test_wait_blocks_and_accounts_device_wait(monkeypatch):
    """wait=True blocks on the probe; the blocked seconds land under the
    device-wait metric and span, not the device seconds, and
    overlap_saved_s is the probe time hidden behind host work."""
    _unpinned(monkeypatch)
    monkeypatch.setattr(device, "_probe_attempt",
                        _stub_attempt([(True, "ok")], delay=0.3))
    device_s0 = timing.device_seconds()
    wait_s0 = timing.device_wait_seconds()
    assert device.start_background_probe() is True
    time.sleep(0.2)
    assert device.device_attached(wait=True) is True
    report = device.probe_overlap_report()
    assert report["state"] == "attached"
    assert report["wait_s"] < report["resolve_s"]
    assert report["overlap_saved_s"] == pytest.approx(
        report["resolve_s"] - report["wait_s"], abs=0.02)
    assert report["overlap_saved_s"] > 0.1
    assert timing.device_wait_seconds() - wait_s0 >= report["wait_s"] - 0.02
    assert timing.device_seconds() == device_s0, \
        "probe wait must not inflate device seconds"


def test_retry_succeeds_without_persisting_negative(monkeypatch, tmp_path):
    """A first timeout and a successful retry leave no persisted
    negative: retries happen before the disk write."""
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "1")
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRY_BACKOFF_S", "0.01")
    device.set_probe_cache_dir(tmp_path)
    monkeypatch.setattr(device, "_probe_attempt",
                        _stub_attempt([(False, "timeout"), (True, "ok")]))
    assert device.start_background_probe() is True
    assert device.device_attached(wait=True) is True
    report = device.probe_overlap_report()
    assert report["state"] == "attached"
    assert report["attempts"] == 2
    assert not (tmp_path / "device_probe.json").exists()
    entries = _final_logged(tmp_path / "probe_log.jsonl", also="recovery")
    assert "background-retry" in [e.get("source") for e in entries]
    final = next(e for e in reversed(entries) if "attached" in e)
    assert final["source"] == "background"
    assert final["attached"] is True and final["attempts"] == 2
    assert any(e.get("type") == "recovery" for e in entries)


def test_retries_exhausted_persist_final_negative(monkeypatch, tmp_path):
    """Only after the retries does the negative reach memory and disk."""
    _unpinned(monkeypatch)
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "1")
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRY_BACKOFF_S", "0.01")
    device.set_probe_cache_dir(tmp_path)
    monkeypatch.setattr(device, "_probe_attempt",
                        _stub_attempt([(False, "timeout")]))
    assert device.start_background_probe() is True
    assert device.device_attached(wait=True) is False
    report = device.probe_overlap_report()
    assert report["state"] == "failed"
    assert report["kind"] == "timeout"
    assert report["attempts"] == 2
    entry = json.loads((tmp_path / "device_probe.json").read_text())
    assert entry["kind"] == "timeout"


def test_background_adopts_persisted_negative(monkeypatch, tmp_path):
    """A fresh persisted negative resolves the background probe without a
    single attempt."""
    _unpinned(monkeypatch)
    device.set_probe_cache_dir(tmp_path)
    (tmp_path / "device_probe.json").write_text(json.dumps(
        {"kind": "timeout", "reason": "wedged earlier", "at": time.time()}))
    stub = _stub_attempt([(True, "ok")])
    monkeypatch.setattr(device, "_probe_attempt", stub)
    assert device.start_background_probe() is True
    assert device.device_attached(wait=True) is False
    assert stub.calls == []
    report = device.device_probe_report()
    assert report["kind"] == "timeout"
    assert "persisted negative" in report["reason"]


def test_background_deadline_default_and_override(monkeypatch):
    """The background probe defaults to the lower 20 s deadline; the
    knobs win for both."""
    assert sentinel.probe_deadline() == 60.0
    assert sentinel.probe_deadline(background=True) == \
        sentinel.BACKGROUND_PROBE_DEADLINE_S == 20.0
    assert device._background_deadline() == 20.0
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "7.5")
    assert sentinel.probe_deadline(background=True) == 7.5
    assert device._background_deadline() == 7.5


def test_doctor_surfaces_async_probe(monkeypatch, tmp_path, capsys):
    """`doctor --json` carries the overlap report; the text names the
    background probe section."""
    from autocycler_tpu_torch.commands import doctor

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "-1")
    device.start_background_probe()
    report = doctor.gather(str(tmp_path))
    assert report["async_probe"]["state"] == "failed"
    assert report["async_probe"]["kind"] == "pinned"
    doctor._render_text(report)
    out = capsys.readouterr().out
    assert "background (async) probe" in out
    assert "state=failed" in out


def test_watch_renders_probe_state(tmp_path):
    """watch rebuilds the worker's probe state from probe_log.jsonl
    (pending until an outcome lands)."""
    from autocycler_tpu_torch.obs import watch

    run = [{"type": "run", "name": "compress", "t0_epoch": time.time()}]
    frame = watch.render_frame(tmp_path, run)
    assert "Async probe: pending" in frame
    (tmp_path / "probe_log.jsonl").write_text(
        json.dumps({"ts": 1.0, "source": "background-retry",
                    "attached": False, "kind": "timeout", "seconds": 20.0,
                    "reason": "wedged"}) + "\n"
        + json.dumps({"ts": 2.0, "source": "background", "attached": True,
                      "kind": "ok", "seconds": 3.2, "reason": "healthy"})
        + "\n")
    frame = watch.render_frame(tmp_path, run)
    assert "Async probe: attached kind=ok" in frame
    assert "1 retry" in frame


def test_mesh_fails_fast_on_timed_out_probe(monkeypatch):
    """A resolved timeout makes the mesh's device listing end with Error:
    at once, before any CUDA call."""
    from autocycler_tpu_torch.parallel import mesh

    _unpinned(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device_count",
                        lambda: pytest.fail("listed the devices"))
    with device._PROBE_LOCK:
        device._probe_state.update(cached=True, attached=False,
                                   kind="timeout", reason="wedged",
                                   seconds=60.0)
    t0 = time.perf_counter()
    with pytest.raises(AutocyclerError, match=r"probe failed \(timeout\)"):
        mesh.make_mesh()
    assert time.perf_counter() - t0 < 1.0


def test_mesh_consults_no_probe_for_explicit_devices(monkeypatch):
    """A mesh over given devices starts no probe and no thread; the
    default list on this host consults the probe, which answers without a
    thread, and finds no device."""
    from autocycler_tpu_torch.parallel import mesh

    h = _hang(monkeypatch)
    m = mesh.make_mesh(4, devices=["cpu"] * 4)
    assert m.shape == (2, 2)
    assert device.probe_overlap_report()["state"] == "unstarted"
    with pytest.raises(ValueError, match="no device"):
        mesh.make_mesh()
    assert device.probe_overlap_report()["kind"] == "no-cuda"
    assert h.calls == []


def test_ledger_and_timeseries_carry_the_probe_fields(monkeypatch,
                                                      tmp_path):
    """The run record's readers of the probe (the JAX case checks the
    bench helpers that read them): the ledger's caches.probe and every
    time-series tick's probe report."""
    from autocycler_tpu.ops.distance import probe_overlap_report as jax_rep
    from autocycler_tpu_torch.obs import ledger, timeseries, trace

    _unpinned(monkeypatch)
    monkeypatch.setattr(device, "_probe_attempt",
                        _stub_attempt([(False, "timeout")]))
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "0")
    monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", str(tmp_path / "run"))
    device.set_probe_cache_dir(tmp_path / "cache")
    assert trace.maybe_start_run(name="compress")
    try:
        device.start_background_probe()
        assert device.device_attached(wait=True) is False
        _final_logged(tmp_path / "run" / "probe_log.jsonl")
        probe = ledger.build_ledger(command="compress")["caches"]["probe"]
    finally:
        trace.abort_run()
    assert set(probe) == {"recoveries", "last", "negative_cache", "overlap"}
    assert probe["last"]["kind"] == "timeout"
    assert probe["last"]["source"] == "background"
    assert probe["negative_cache"] is False   # it sits in the cache dir
    assert set(probe["overlap"]) == set(jax_rep())
    assert probe["overlap"]["state"] == "failed"
    sampler = timeseries.TimeseriesSampler(tmp_path / "ts")
    sampler.sample()
    tick = timeseries.read_timeseries(tmp_path / "ts" / "timeseries.jsonl")
    assert set(tick[-1]["probe"]) == set(jax_rep())


def test_cli_wedged_probe_exits_1_before_any_cuda_call(tmp_path,
                                                       monkeypatch, capsys):
    """A wedged card, as a stub child that sleeps past its deadline: a
    device command through the CLI ends with Error: (the probe's reason,
    doctor named) and exit 1 without one CUDA call; device_probe.json is
    written, so the next "process" fails in well under a second from it;
    doctor shows the negative cache fresh."""
    import sys
    import textwrap

    from synthetic import make_assemblies

    from autocycler_tpu_torch import cli
    from autocycler_tpu_torch.commands import doctor

    asm = make_assemblies(tmp_path, n_assemblies=2, chromosome_len=3000,
                          plasmid_len=500)
    out = tmp_path / "out"
    _unpinned(monkeypatch)
    monkeypatch.setattr(sentinel, "_probe_argv", lambda: [
        sys.executable, "-c", textwrap.dedent("""
            import sys, time
            sys.stderr.write("cuInit: no answer from the driver\\n")
            sys.stderr.flush()
            time.sleep(60)
        """)])
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "1")
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "0")
    for name in ("is_available", "init", "get_device_name", "device_count",
                 "_lazy_init"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **kw: pytest.fail(_n))
    argv = ["compress", "-i", str(asm), "-a", str(out)]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert "Error: the device probe failed (timeout)" in err
    assert "autocycler doctor" in err
    assert not (out / "input_assemblies.gfa").exists()
    entry = json.loads((out / ".cache" / "device_probe.json").read_text())
    assert entry["kind"] == "timeout"
    log = _final_logged(out / ".cache" / "probe_log.jsonl")
    assert "cuInit: no answer" in log[-1]["stderr_tail"]

    device._probe_reset()                       # the next process
    sentinel._reset_for_tests()
    t0 = time.perf_counter()
    assert cli.main(argv) == 1
    assert time.perf_counter() - t0 < 1.0
    assert "persisted negative probe" in capsys.readouterr().err

    report = doctor.gather(str(out / ".cache"))
    assert report["negative_cache"]["fresh"] is True
    assert report["negative_cache"]["kind"] == "timeout"
    assert any("wedged driver or card" in a for a in report["actions"])


def test_cli_probe_error_exits_1(tmp_path, monkeypatch, capsys):
    """A probe child that reports a failed CUDA init (kind error) ends a
    device command with Error: as a timeout does."""
    import sys

    from autocycler_tpu_torch import cli

    _unpinned(monkeypatch)
    monkeypatch.setattr(sentinel, "_probe_argv", lambda: [
        sys.executable, "-c",
        "print('AUTOCYCLER_PROBE:{\"attached\": false, \"kind\": \"error\", "
        "\"reason\": \"device init failed: RuntimeError: CUDA driver "
        "version is insufficient\"}')"])
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "0")
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: pytest.fail("is_available"))
    (tmp_path / "c").mkdir()
    assert cli.main(["trim", "-c", str(tmp_path / "c")]) == 1
    err = capsys.readouterr().err
    assert "Error: the device probe failed (error)" in err
    assert "driver version is insufficient" in err


def test_a_probe_pending_past_its_budget_ends_with_error(tmp_path,
                                                         monkeypatch):
    """A stub child that outlives the consult's budget (cut to 0.3 s here;
    its deadline is 30 s): the gate does not go on to CUDA with the probe
    still pending, but ends the command with Error: as a timeout, and
    persists the negative for the next process."""
    import sys

    _unpinned(monkeypatch)
    monkeypatch.setattr(sentinel, "_probe_argv", lambda: [
        sys.executable, "-c", "import time; time.sleep(30)"])
    monkeypatch.setattr(device, "_wait_budget", lambda deadline: 0.3)
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "30")
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "0")
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: pytest.fail("is_available"))
    device.set_probe_cache_dir(tmp_path)
    assert device.start_background_probe() is True
    t0 = time.perf_counter()
    with pytest.raises(AutocyclerError,
                       match=r"probe failed \(timeout\).*budget"):
        device.resolve_device(None)
    assert time.perf_counter() - t0 < 5.0
    assert device.probe_overlap_report()["state"] == "pending"
    entry = json.loads((tmp_path / "device_probe.json").read_text())
    assert entry["kind"] == "timeout"
    sentinel._kill_children()
