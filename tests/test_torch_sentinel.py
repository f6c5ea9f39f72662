"""The port's probe sentinel (autocycler_tpu_torch/obs/sentinel.py), case
for case against the JAX package's tests/test_sentinel.py: subprocess probe
outcomes (ok, wedge, crash), the environment snapshot, the probe log's
schema and rotation, the false -> true recovery firing its hooks once, and
the negative caches cleared on recovery. Then what only the port has: the
recovery capture's file on a host without a card, the watch line both
packages render from a log the port wrote, and a pending child killed at
exit. The stub children import neither torch nor jax; one test runs the
real child, which answers no-cuda on a host without a card."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest
import torch

from autocycler_tpu_torch import device
from autocycler_tpu_torch.obs import metrics_registry, sentinel
from autocycler_tpu_torch.utils import knobs


@pytest.fixture(autouse=True)
def _clean_sentinel():
    sentinel._reset_for_tests()
    device._probe_reset()
    yield
    sentinel._reset_for_tests()
    device._probe_reset()


def _stub_probe_argv(monkeypatch, body: str):
    """Replace the probe child with a tiny torch-free script."""
    monkeypatch.setattr(sentinel, "_probe_argv",
                        lambda: [sys.executable, "-c",
                                 textwrap.dedent(body)])


# ---------------- environment snapshot ----------------

def test_environment_snapshot_shape(monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_PROBE_WATCH", "12")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("AUTOCYCLER_SERVE_TOKEN", "secret")
    snap = sentinel.environment_snapshot()
    for key in ("cuda_visible_devices", "env", "plugin_versions",
                "accel_devices", "python", "platform", "cpu_count", "pid"):
        assert key in snap, key
    assert snap["cuda_visible_devices"] == "0"
    assert snap["env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert snap["env"]["AUTOCYCLER_PROBE_WATCH"] == "12"
    assert snap["env"]["AUTOCYCLER_SERVE_TOKEN"] == "<redacted>"
    assert "torch" in snap["plugin_versions"]
    assert not any("jax" in name for name in snap["plugin_versions"])
    assert isinstance(snap["accel_devices"], list)
    assert all(d.startswith("/dev/nvidia") for d in snap["accel_devices"])
    json.dumps(snap)  # must be a JSON-serialisable artifact


# ---------------- subprocess probe ----------------

def test_subprocess_probe_parses_marker_outcome(monkeypatch):
    _stub_probe_argv(monkeypatch, """
        import json, sys
        print("noise before the marker")
        sys.stderr.write("CUDA init chatter\\n")
        print("AUTOCYCLER_PROBE:" + json.dumps(
            {"attached": True, "kind": "ok", "reason": "stub",
             "backend": "cuda", "device_count": 1, "name": "Card X",
             "capability": [9, 0], "seconds": 0.01}))
    """)
    out = sentinel.subprocess_probe(deadline=30)
    assert out["attached"] is True and out["kind"] == "ok"
    assert out["mode"] == "subprocess"
    assert out["backend"] == "cuda" and out["device_count"] == 1
    assert out["name"] == "Card X" and out["capability"] == [9, 0]
    assert "CUDA init chatter" in out["stderr_tail"]
    assert out["seconds"] >= 0


def test_subprocess_probe_kills_wedged_child_and_keeps_stderr(monkeypatch,
                                                               tmp_path):
    # the child starts a helper in its session: the kill takes both
    pids = tmp_path / "pids"
    _stub_probe_argv(monkeypatch, f"""
        import os, subprocess, sys, time
        helper = subprocess.Popen([sys.executable, "-c",
                                   "import time; time.sleep(60)"])
        open({str(pids)!r}, "w").write(f"{{os.getpid()}} {{helper.pid}}")
        sys.stderr.write("cuInit: waiting on the driver...\\n")
        sys.stderr.flush()
        time.sleep(60)
    """)
    out = sentinel.subprocess_probe(deadline=1.5)
    assert out["attached"] is False and out["kind"] == "timeout"
    assert "wedged driver or card" in out["reason"]
    assert "cuInit: waiting on the driver" in out.get("stderr_tail", "")
    assert out["seconds"] < 30  # killed at the deadline, not abandoned
    child, helper = (int(p) for p in pids.read_text().split())
    for pid in (child, helper):
        for _ in range(50):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            # a killed helper stays a zombie until init reaps it
            if Path(f"/proc/{pid}/stat").read_text().split()[2] == "Z":
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"probe process {pid} outlived the kill")
    assert sentinel._children == set()


def test_subprocess_probe_child_crash_is_diagnosed(monkeypatch):
    _stub_probe_argv(monkeypatch, "import sys; sys.exit(7)")
    out = sentinel.subprocess_probe(deadline=10)
    assert out["attached"] is False and out["kind"] == "error"
    assert "exited 7" in out["reason"]


def test_real_probe_child_answers_no_cuda_on_this_host():
    # the UNSTUBBED child, the only one the suite runs: a host without a
    # card (or without the CUDA driver) answers a clean no-cuda diagnosis,
    # asking the driver alone: it imports no torch, so it answers fast
    out = sentinel.subprocess_probe(deadline=120)
    if torch.cuda.is_available():
        assert out["kind"] == "ok" and out["attached"] is True
        assert out["torch_cuda"] == torch.version.cuda
    else:
        assert out["kind"] == "no-cuda" and out["attached"] is False
        assert "torch_cuda" not in out
    assert out["backend"] == "cuda"
    assert out["seconds"] < 10.0


# A stand-in for the CUDA driver: the entry points the probe child calls,
# with the driver's C signatures. STUB_CUDA_MODE 0 answers one healthy
# card, 1 no card (cuInit's CUDA_ERROR_NO_DEVICE), 2 a failed init.
_STUB_LIBCUDA = r"""
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
static int mode(void) {
    const char *m = getenv("STUB_CUDA_MODE");
    return m ? atoi(m) : 0;
}
int cuInit(unsigned flags) { return mode() == 1 ? 100 : mode() == 2 ? 999 : 0; }
int cuGetErrorName(int rc, const char **s) {
    *s = rc == 999 ? "CUDA_ERROR_UNKNOWN" : "CUDA_ERROR_OTHER";
    return 0;
}
int cuDriverGetVersion(int *v) { *v = 12080; return 0; }
int cuDeviceGetCount(int *n) { *n = 1; return 0; }
int cuDeviceGet(int *d, int i) { *d = i; return 0; }
int cuDeviceGetName(char *buf, int len, int d) {
    strncpy(buf, "Stub Card", len);
    return 0;
}
int cuDeviceGetAttribute(int *v, int attr, int d) {
    *v = attr == 75 ? 9 : attr == 76 ? 0 : -1;
    return 0;
}
int cuDeviceTotalMem_v2(size_t *b, int d) { *b = 85017493504ull; return 0; }
int cuDevicePrimaryCtxRetain(void **ctx, int d) { *ctx = (void *)0x1; return 0; }
int cuCtxSetCurrent(void *ctx) { return ctx == (void *)0x1 ? 0 : 201; }
static uint32_t cell;
int cuMemAlloc_v2(uint64_t *p, size_t n) {
    *p = (uint64_t)(uintptr_t)&cell;
    return n == 4 ? 0 : 2;
}
int cuMemsetD32_v2(uint64_t p, unsigned v, size_t n) {
    for (size_t i = 0; i < n; i++) ((uint32_t *)(uintptr_t)p)[i] = v;
    return 0;
}
int cuMemcpyDtoH_v2(void *dst, uint64_t src, size_t n) {
    memcpy(dst, (void *)(uintptr_t)src, n);
    return 0;
}
int cuMemFree_v2(uint64_t p) { return 0; }
"""


@pytest.mark.parametrize("mode,kind", [("0", "ok"), ("1", "no-cuda"),
                                       ("2", "error")])
def test_probe_child_asks_the_driver_through_libcuda(tmp_path, monkeypatch,
                                                     mode, kind):
    """The real child against a stand-in libcuda.so.1 (built here with the
    host's C compiler): a healthy card gives its name, capability, memory,
    the driver's CUDA version and the device count, with the 4-byte
    memset read back; no card gives no-cuda; a failed init names the
    driver's error."""
    import shutil
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler to build the stand-in driver")
    (tmp_path / "libcuda.c").write_text(_STUB_LIBCUDA)
    subprocess.run([cc, "-shared", "-fPIC", "-o",
                    str(tmp_path / "libcuda.so.1"),
                    str(tmp_path / "libcuda.c")], check=True)
    monkeypatch.setenv("LD_LIBRARY_PATH", str(tmp_path))
    monkeypatch.setenv("STUB_CUDA_MODE", mode)
    out = sentinel.subprocess_probe(deadline=60)
    assert out["kind"] == kind and out["attached"] is (kind == "ok")
    if kind == "ok":
        assert out["name"] == "Stub Card" and out["capability"] == [9, 0]
        assert out["total_memory"] == 85017493504
        assert out["cuda_version"] == "12.8" and out["device_count"] == 1
        assert out["torch_cuda"] == torch.version.cuda
        assert "tiny op round-tripped" in out["reason"]
    elif kind == "no-cuda":
        assert "CUDA_ERROR_NO_DEVICE" in out["reason"]
    else:
        assert "cuInit failed: CUDA_ERROR_UNKNOWN (999)" in out["reason"]


# ---------------- probe_log.jsonl ----------------

def test_record_outcome_appends_schema_lines(tmp_path):
    sentinel.set_probe_log_dir(tmp_path)
    sentinel.record_outcome({"attached": False, "kind": "timeout",
                             "reason": "stub wedge", "seconds": 1.0,
                             "stderr_tail": "x" * 5000}, source="gate")
    entries = sentinel.read_probe_log()
    assert len(entries) == 1
    e = entries[0]
    for key in ("ts", "source", "attached", "kind", "reason", "seconds"):
        assert key in e, key
    assert e["source"] == "gate"
    assert len(e["stderr_tail"]) == 2000  # tail truncated into the log


def test_probe_log_dir_precedence(tmp_path, monkeypatch):
    a, b, c = tmp_path / "explicit", tmp_path / "env", tmp_path / "fallback"
    monkeypatch.delenv("AUTOCYCLER_TRACE_DIR", raising=False)
    sentinel.set_probe_log_dir(c, fallback=True)
    assert sentinel.probe_log_path().parent == c
    monkeypatch.setenv("AUTOCYCLER_TRACE_DIR", str(b))
    assert sentinel.probe_log_path().parent == b
    sentinel.set_probe_log_dir(a)
    assert sentinel.probe_log_path().parent == a


def test_read_probe_log_skips_malformed_lines(tmp_path):
    path = tmp_path / "probe_log.jsonl"
    path.write_text('{"ok": 1}\nnot json\n\n{"ok": 2}\n')
    entries = sentinel.read_probe_log(path)
    assert [e["ok"] for e in entries] == [1, 2]
    assert sentinel.read_probe_log(path, limit=1) == [{"ok": 2}]


# ---------------- recovery transition ----------------

def _outcome(attached):
    return {"attached": attached,
            "kind": "ok" if attached else "timeout",
            "reason": "stub", "seconds": 0.0}


def test_false_to_true_transition_fires_hook_exactly_once(tmp_path):
    sentinel.set_probe_log_dir(tmp_path)
    fired = []
    sentinel.on_recovery(fired.append)
    before = metrics_registry.registry().value(
        "autocycler_probe_recoveries_total")
    seq = [False, False, True, True, False, True]
    watcher = sentinel.ProbeWatcher(
        interval=0.01, deadline=1.0,
        probe_fn=lambda deadline: _outcome(seq.pop(0)))
    for _ in range(6):
        watcher.cycle()
    assert len(fired) == 1
    assert fired[0]["kind"] == "ok"
    # the recovery event itself is logged and counted
    types = [e.get("type") for e in sentinel.read_probe_log()]
    assert types.count("recovery") == 1
    assert metrics_registry.registry().value(
        "autocycler_probe_recoveries_total") == before + 1


def test_true_first_probe_never_fires_hook(tmp_path):
    sentinel.set_probe_log_dir(tmp_path)
    fired = []
    sentinel.on_recovery(fired.append)
    for attached in (True, True):
        sentinel.record_outcome(_outcome(attached))
    assert fired == []


def test_recovery_clears_negative_probe_cache(tmp_path):
    # a persisted negative + failed in-memory state, as after a wedge
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "device_probe.json").write_text(
        json.dumps({"kind": "timeout", "reason": "wedged", "at": 0}))
    device.set_probe_cache_dir(cache)
    with device._PROBE_LOCK:
        device._probe_state.update(attached=False, cached=True,
                                   kind="timeout")
    sentinel.set_probe_log_dir(tmp_path)
    sentinel.record_outcome(_outcome(False))
    assert (cache / "device_probe.json").exists()
    sentinel.record_outcome(_outcome(True))
    assert not (cache / "device_probe.json").exists()
    with device._PROBE_LOCK:
        assert device._probe_state["cached"] is False


def test_hook_exception_does_not_kill_the_watcher(tmp_path, capsys):
    sentinel.set_probe_log_dir(tmp_path)
    good = []
    sentinel.on_recovery(lambda e: (_ for _ in ()).throw(RuntimeError("x")))
    sentinel.on_recovery(good.append)
    sentinel.record_outcome(_outcome(False))
    sentinel.record_outcome(_outcome(True))
    assert len(good) == 1
    assert "recovery hook failed" in capsys.readouterr().err


# ---------------- watcher config ----------------

def test_watch_interval_parsing(monkeypatch):
    monkeypatch.delenv("AUTOCYCLER_PROBE_WATCH", raising=False)
    assert sentinel.watch_interval() is None
    monkeypatch.setenv("AUTOCYCLER_PROBE_WATCH", "30")
    assert sentinel.watch_interval() == 30.0
    monkeypatch.setenv("AUTOCYCLER_PROBE_WATCH", "0")
    assert sentinel.watch_interval() is None
    monkeypatch.setenv("AUTOCYCLER_PROBE_WATCH", "banana")
    assert sentinel.watch_interval() is None


def test_maybe_start_watcher_disabled_without_env(monkeypatch):
    monkeypatch.delenv("AUTOCYCLER_PROBE_WATCH", raising=False)
    assert sentinel.maybe_start_watcher() is None


def test_probe_deadline_env_precedence(monkeypatch):
    """AUTOCYCLER_PROBE_DEADLINE_S, the one deadline knob, wins over both
    defaults; the JAX package's second spelling is not read."""
    monkeypatch.delenv("AUTOCYCLER_PROBE_DEADLINE_S", raising=False)
    assert sentinel.probe_deadline() == 60.0
    assert sentinel.probe_deadline(background=True) == 20.0
    monkeypatch.setenv("AUTOCYCLER_DEVICE_PROBE_TIMEOUT", "15")
    assert sentinel.probe_deadline() == 60.0
    monkeypatch.setenv("AUTOCYCLER_PROBE_DEADLINE_S", "5")
    assert sentinel.probe_deadline() == 5.0
    assert sentinel.probe_deadline(background=True) == 5.0


# ---------------- probe log rotation ----------------

def test_probe_log_rotates_to_newest_entries(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_PROBE_LOG_MAX", "5")
    sentinel.set_probe_log_dir(tmp_path)
    for i in range(12):
        sentinel.append_probe_log({"n": i})
    entries = sentinel.read_probe_log()
    # only the newest 5 survive, in order, and no tempfiles linger
    assert [e["n"] for e in entries] == [7, 8, 9, 10, 11]
    assert not list(tmp_path.glob("*.tmp*"))


def test_probe_log_rotation_disabled_with_zero(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTOCYCLER_PROBE_LOG_MAX", "0")
    sentinel.set_probe_log_dir(tmp_path)
    for i in range(10):
        sentinel.append_probe_log({"n": i})
    assert len(sentinel.read_probe_log()) == 10


def test_probe_log_max_default_and_garbage(monkeypatch):
    monkeypatch.delenv("AUTOCYCLER_PROBE_LOG_MAX", raising=False)
    assert sentinel.probe_log_max() == 500
    knobs._warned.discard("AUTOCYCLER_PROBE_LOG_MAX")
    monkeypatch.setenv("AUTOCYCLER_PROBE_LOG_MAX", "banana")
    assert sentinel.probe_log_max() == 500
    monkeypatch.setenv("AUTOCYCLER_PROBE_LOG_MAX", "-3")
    assert sentinel.probe_log_max() == 0


# ---------------- what only the port has ----------------

def test_recovery_capture_without_a_card_keeps_the_jax_keys(tmp_path,
                                                           monkeypatch):
    """On a host without a card both parts are skipped, not failed; the
    file carries the JAX package's top-level keys and is logged."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sentinel.set_probe_log_dir(tmp_path)
    result = sentinel.recovery_capture({"kind": "ok", "source": "watcher",
                                        "ts": 1.0, "reason": "stub"})
    on_disk = json.loads((tmp_path / "recovery_capture.json").read_text())
    assert on_disk == result
    assert set(result) == {"ts", "trigger", "backend", "dotplot",
                           "grouping", "seconds"}
    assert result["backend"] == "cpu"
    assert result["dotplot"] == {"skipped": "no CUDA device"}
    assert result["grouping"] == {"skipped": "no CUDA device"}
    assert result["trigger"]["kind"] == "ok"
    assert sentinel.read_probe_log()[-1]["type"] == "capture"


def test_port_probe_log_renders_the_same_watch_line_in_both_packages(
        tmp_path, monkeypatch):
    """A probe log the port's background probe wrote (a retry, then the
    final outcome) renders the same "Async probe" line in both packages'
    watch, and an unfinished run with no outcome yet renders pending."""
    from autocycler_tpu.obs import watch as jax_watch
    from autocycler_tpu_torch.obs import watch

    run = [{"type": "run", "name": "compress", "t0_epoch": time.time()}]
    assert "Async probe: pending" in watch.render_frame(tmp_path, run)
    assert "Async probe: pending" in jax_watch.render_frame(tmp_path, run)
    monkeypatch.setattr(device, "_short_circuit", lambda: None)
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRIES", "1")
    monkeypatch.setenv("AUTOCYCLER_PROBE_RETRY_BACKOFF_S", "0.01")
    outcomes = iter([(False, "timeout"), (True, "ok")])

    def attempt(timeout, mode=None):
        attached, kind = next(outcomes)
        return attached, f"stub ({kind})", kind, {}, 0.01

    monkeypatch.setattr(device, "_probe_attempt", attempt)
    device.set_probe_cache_dir(tmp_path)
    assert device.start_background_probe() is True
    assert device.device_attached(wait=True) is True
    for _ in range(1000):    # the outcome is logged just after it resolves
        if any(e.get("source") == "background"
               for e in sentinel.read_probe_log(tmp_path / "probe_log.jsonl")):
            break
        time.sleep(0.01)
    frames = [w.render_frame(tmp_path, run) for w in (watch, jax_watch)]
    lines = [next(x for x in f.splitlines() if x.startswith("Async probe"))
             for f in frames]
    assert lines[0] == lines[1]
    assert lines[0].startswith("Async probe: attached kind=ok")
    assert "1 retry" in lines[0]


def test_kill_children_ends_a_pending_probe(monkeypatch):
    """A process that exits before its probe answers leaves no child: the
    exit hook kills every pending probe's session."""
    _stub_probe_argv(monkeypatch, "import time; time.sleep(60)")
    out = {}
    t = threading.Thread(target=lambda: out.update(
        sentinel.subprocess_probe(deadline=60)))
    t.start()
    for _ in range(200):
        if sentinel._children:
            break
        time.sleep(0.01)
    assert sentinel._children
    t0 = time.perf_counter()
    sentinel._kill_children()
    t.join(30)
    assert not t.is_alive() and time.perf_counter() - t0 < 30
    assert out["kind"] == "error" and "exited -9" in out["reason"]


def test_sentinel_and_probe_child_import_no_jax(tmp_path):
    """The sentinel, doctor and mfu modules load no jax and nothing of the
    JAX package, and the probe child's snippet imports neither (nor
    torch: it asks the CUDA driver through ctypes)."""
    import re
    forbidden = re.compile(r"^\s*(?:import|from)\s+(?:jax|autocycler_tpu)"
                           r"(?:\.|\s|$)", re.MULTILINE)
    assert "libcuda.so.1" in sentinel._PROBE_SNIPPET
    assert not forbidden.search(sentinel._PROBE_SNIPPET)
    assert not re.search(r"^\s*(?:import|from)\s+torch",
                         sentinel._PROBE_SNIPPET, re.MULTILINE)
    code = ("import sys\n"
            "from autocycler_tpu_torch.obs import sentinel\n"
            "from autocycler_tpu_torch.commands import doctor\n"
            "from autocycler_tpu_torch.ops import mfu\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'autocycler_tpu'"
            " or m.startswith('autocycler_tpu.')]\n"
            "print('LOADED', bad)\n")
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(repo)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout
