"""Probe sentinel: device forensics for the CUDA probe, as the JAX
package's obs/sentinel.py keeps them for its TPU probe.

A card or driver that has wedged can block the first CUDA call of a
process with nothing killable around it and no diagnosis. This module
turns that into one:

- :func:`subprocess_probe` runs the device probe in a *child process*, so
  that a wedged CUDA init can be killed (a thread stuck in the driver can
  only be abandoned), and so that what the child printed on stderr before
  it stalled is kept in the outcome;
- :func:`environment_snapshot` records what the probe ran against:
  ``CUDA_VISIBLE_DEVICES``, the ``AUTOCYCLER_*`` knobs, the installed
  torch, triton and nvidia-* versions and the ``/dev/nvidia*`` device
  files, without a CUDA call;
- every real outcome is appended to ``probe_log.jsonl`` (one JSON object a
  line, rotated to the newest ``AUTOCYCLER_PROBE_LOG_MAX``), so that
  ``autocycler doctor`` renders a run dir's probe history;
- :class:`ProbeWatcher` probes again every ``AUTOCYCLER_PROBE_WATCH``
  seconds in a daemon thread; on the first ``false -> true`` transition it
  clears the negative caches (``device.notify_probe_recovered``) and fires
  the recovery hooks once, by default :func:`recovery_capture`: a bounded
  run of the word-compare and grouping kernels on the card, so that a
  recovery leaves device evidence even if nobody was watching.

The sentinel never raises into the pipeline: telemetry must not fail the
run it diagnoses. It imports no jax; the probe child imports neither jax
nor torch.
"""

from __future__ import annotations

import atexit
import glob
import json
import os
import platform
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional

from ..utils.knobs import knob_bool, knob_float, knob_int, knob_str

PROBE_LOG = "probe_log.jsonl"
RECOVERY_CAPTURE_FILE = "recovery_capture.json"
_MARKER = "AUTOCYCLER_PROBE:"
_STDERR_TAIL = 4000

_lock = threading.Lock()
_log_dir: Optional[str] = None          # explicit (set_probe_log_dir)
_fallback_dir: Optional[str] = None     # from device.set_probe_cache_dir
_hooks: List[Callable] = []
_last_attached: Optional[bool] = None
_recovery_fired = False
_watcher_thread: Optional[threading.Thread] = None
# probe children still running: killed with their session at exit, so that
# a process ending before its background probe leaves no child behind
_children: set = set()


@atexit.register
def _kill_children() -> None:
    for proc in list(_children):
        try:
            os.killpg(proc.pid, 9)
        except OSError:
            pass


# ---- environment forensics ----

def environment_snapshot() -> dict:
    """What a probe on this host runs against: the card pin
    (``CUDA_VISIBLE_DEVICES``), every AUTOCYCLER knob (tokens and secrets
    redacted), the torch, triton and nvidia-* package versions and the
    NVIDIA device files. Pure inspection: no CUDA call, so ``autocycler
    doctor`` is safe on a wedged host."""
    env_vars = {k: ("<redacted>" if ("TOKEN" in k or "SECRET" in k)
                    else os.environ[k])
                for k in sorted(os.environ)
                if k.startswith("AUTOCYCLER_")
                or k in ("CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
                         "NVIDIA_VISIBLE_DEVICES", "CUDA_LAUNCH_BLOCKING",
                         "PYTORCH_CUDA_ALLOC_CONF")}
    versions = {}
    try:
        from importlib import metadata
        for dist in metadata.distributions():
            name = (dist.metadata.get("Name") or "").lower()
            if name in ("torch", "triton") or name.startswith("nvidia-"):
                versions[name] = dist.version
    except Exception:  # noqa: BLE001 — forensics must not fail the caller
        pass
    return {
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "env": env_vars,
        "plugin_versions": dict(sorted(versions.items())),
        "accel_devices": sorted(glob.glob("/dev/nvidia*")),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "pid": os.getpid(),
    }


# ---- the subprocess probe ----

# The child asks the CUDA driver alone, through libcuda and ctypes: it
# imports no torch, so it answers in well under a second, where a child
# that imports torch and builds its context takes seconds. It initialises
# the driver, lists the cards, makes cuda:0's primary context current and
# round-trips one tiny op on the card (a 4-byte memset, read back: an init
# can succeed while execution stalls), then prints the outcome on a marker
# line on stdout: the card's name, compute capability and memory, the
# driver's CUDA version and the device count. What the driver prints lands
# on stderr, which the parent keeps as the diagnosis.
_PROBE_SNIPPET = """\
import ctypes, json, time
t0 = time.perf_counter()
out = {"backend": "cuda"}
try:
    cu = ctypes.CDLL("libcuda.so.1")
except OSError as e:
    cu = None
    out.update(attached=False, kind="no-cuda",
               reason="the CUDA driver (libcuda.so.1) does not load: %s" % e)


def name(rc):
    s = ctypes.c_char_p()
    cu.cuGetErrorName(rc, ctypes.byref(s))
    return (s.value or b"unknown").decode()


def check(rc, what):
    if rc != 0:
        raise RuntimeError("%s failed: %s (%d)" % (what, name(rc), rc))


if cu is not None:
    try:
        rc = cu.cuInit(0)
        if rc == 100:   # CUDA_ERROR_NO_DEVICE
            out.update(attached=False, kind="no-cuda",
                       reason="cuInit: CUDA_ERROR_NO_DEVICE (the driver "
                              "sees no card)")
        else:
            check(rc, "cuInit")
            v = ctypes.c_int()
            check(cu.cuDriverGetVersion(ctypes.byref(v)), "cuDriverGetVersion")
            out["cuda_version"] = "%d.%d" % (v.value // 1000,
                                             v.value % 1000 // 10)
            check(cu.cuDeviceGetCount(ctypes.byref(v)), "cuDeviceGetCount")
            out["device_count"] = v.value
            dev = ctypes.c_int()
            check(cu.cuDeviceGet(ctypes.byref(dev), 0), "cuDeviceGet")
            buf = ctypes.create_string_buffer(256)
            check(cu.cuDeviceGetName(buf, 256, dev), "cuDeviceGetName")
            cap = []
            for attr in (75, 76):   # compute capability major, minor
                check(cu.cuDeviceGetAttribute(ctypes.byref(v), attr, dev),
                      "cuDeviceGetAttribute")
                cap.append(v.value)
            mem = ctypes.c_size_t()
            check(cu.cuDeviceTotalMem_v2(ctypes.byref(mem), dev),
                  "cuDeviceTotalMem")
            ctx = ctypes.c_void_p()
            check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
            check(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
            ptr = ctypes.c_uint64()
            check(cu.cuMemAlloc_v2(ctypes.byref(ptr), ctypes.c_size_t(4)),
                  "cuMemAlloc")
            check(cu.cuMemsetD32_v2(ptr, ctypes.c_uint(0x5A17C0DE),
                                    ctypes.c_size_t(1)), "cuMemsetD32")
            host = ctypes.c_uint32(0)
            check(cu.cuMemcpyDtoH_v2(ctypes.byref(host), ptr,
                                     ctypes.c_size_t(4)), "cuMemcpyDtoH")
            cu.cuMemFree_v2(ptr)
            if host.value != 0x5A17C0DE:
                raise RuntimeError("the card wrote 0x%08x where 0x5a17c0de "
                                   "was set" % host.value)
            out.update(name=buf.value.decode(), capability=cap,
                       total_memory=mem.value, attached=True, kind="ok",
                       reason="cuda:0 verified (tiny op round-tripped in "
                              "probe subprocess)")
    except Exception as e:
        out.update(attached=False, kind="error",
                   reason="device init failed: %s: %s" % (type(e).__name__, e))
out["seconds"] = round(time.perf_counter() - t0, 3)
print("AUTOCYCLER_PROBE:" + json.dumps(out), flush=True)
"""


def _probe_argv() -> List[str]:
    """The probe child's argv: a seam, so that tests substitute a stub that
    answers canned outcomes (or wedges)."""
    return [sys.executable, "-c", _PROBE_SNIPPET]


def subprocess_probe(deadline: float) -> dict:
    """One device probe in a killable child. Returns the outcome ``{mode,
    kind, attached, reason, seconds, stderr_tail?, backend?, device_count?,
    name?, capability?, total_memory?, cuda_version? (the driver's),
    torch_cuda? (this torch's build)}``, ``kind`` one of
    ok, no-cuda, error, timeout. A child past ``deadline`` is killed with
    its whole session (a helper it started dies with it) and reported as a
    timeout, with whatever it printed on stderr before it stalled."""
    t0 = time.perf_counter()
    outcome: dict = {"mode": "subprocess"}
    err = ""
    try:
        proc = subprocess.Popen(_probe_argv(), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
    except OSError as e:
        return {"mode": "subprocess", "attached": False, "kind": "error",
                "reason": f"probe subprocess failed to start: {e}",
                "seconds": round(time.perf_counter() - t0, 3)}
    with _lock:
        _children.add(proc)
    try:
        out, err = proc.communicate(timeout=deadline)
        parsed = None
        for line in (out or "").splitlines():
            if line.startswith(_MARKER):
                try:
                    parsed = json.loads(line[len(_MARKER):])
                except ValueError:
                    parsed = None
        if parsed is not None:
            outcome.update(parsed)
            if parsed.get("attached"):
                import torch
                outcome["torch_cuda"] = torch.version.cuda
        elif proc.returncode != 0:
            outcome.update(attached=False, kind="error",
                           reason=f"probe subprocess exited "
                                  f"{proc.returncode} without an outcome")
        else:
            outcome.update(attached=False, kind="error",
                           reason="probe subprocess produced no outcome")
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, 9)
        except (OSError, ProcessLookupError):
            proc.kill()
        try:
            _, err = proc.communicate(timeout=2)
        except Exception:  # noqa: BLE001 — the tail is best-effort
            err = ""
        outcome.update(
            attached=False, kind="timeout",
            reason=(f"probe subprocess did not respond within "
                    f"{deadline:.0f}s (wedged driver or card) — killed; "
                    "init stderr captured"))
    finally:
        with _lock:
            _children.discard(proc)
    outcome["seconds"] = round(time.perf_counter() - t0, 3)
    if err:
        outcome["stderr_tail"] = err[-_STDERR_TAIL:]
    return outcome


# ---- probe_log.jsonl ----

def set_probe_log_dir(path, fallback: bool = False) -> None:
    """Point ``probe_log.jsonl`` at ``path`` (None clears). With
    ``fallback=True`` the dir applies only when nothing explicit and no
    ``AUTOCYCLER_TRACE_DIR`` is set: ``device.set_probe_cache_dir`` routes
    the probe cache dir here, so that a run logs beside its
    ``device_probe.json``."""
    global _log_dir, _fallback_dir
    with _lock:
        if fallback:
            _fallback_dir = None if path is None else str(path)
        else:
            _log_dir = None if path is None else str(path)


def probe_log_path() -> Optional[Path]:
    with _lock:
        explicit, fallback = _log_dir, _fallback_dir
    if explicit:
        return Path(explicit) / PROBE_LOG
    env = (knob_str("AUTOCYCLER_TRACE_DIR") or "").strip()
    if env:
        return Path(env) / PROBE_LOG
    if fallback:
        return Path(fallback) / PROBE_LOG
    return None


def probe_log_max() -> int:
    """The probe log's cap: the newest N entries (AUTOCYCLER_PROBE_LOG_MAX,
    default 500; 0 keeps every entry)."""
    return max(0, knob_int("AUTOCYCLER_PROBE_LOG_MAX"))


def append_probe_log(entry: dict) -> None:
    """Append one JSON line to the probe log (nothing without a dir; never
    raises), then rotate it to its newest ``probe_log_max()`` entries, so
    that a long-lived watcher cannot grow it without bound."""
    path = probe_log_path()
    if path is None:
        return
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(entry, default=str) + "\n")
        _rotate_probe_log(path)
    except OSError:
        pass


def _rotate_probe_log(path: Path) -> None:
    """Cut the log to its newest ``probe_log_max()`` lines through a
    tempfile and an atomic replace: a reader never sees a torn log."""
    cap = probe_log_max()
    if cap <= 0:
        return
    try:
        data = path.read_bytes()
    except OSError:
        return
    if data.count(b"\n") <= cap:
        return
    lines = data.splitlines(keepends=True)[-cap:]
    try:
        fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                   prefix=path.name + ".tmp")
        with os.fdopen(fd, "wb") as f:
            f.writelines(lines)
        os.replace(tmp, path)
    except OSError:
        pass


def read_probe_log(path=None, limit: Optional[int] = None) -> List[dict]:
    """A probe log's entries, most recent last; ``limit`` keeps the tail.
    Malformed lines are skipped; a missing file is an empty history."""
    path = Path(path) if path is not None else probe_log_path()
    if path is None or not path.exists():
        return []
    entries = []
    try:
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except ValueError:
                continue
    except OSError:
        return []
    return entries[-limit:] if limit else entries


# ---- recovery hooks and the transition ----

def on_recovery(hook: Callable[[dict], None]) -> None:
    """Register a callable fired once, with the recovering outcome, on the
    first ``false -> true`` transition this process sees."""
    with _lock:
        _hooks.append(hook)


def clear_recovery_hooks() -> None:
    with _lock:
        _hooks.clear()


def record_outcome(outcome: dict, source: str = "watcher") -> dict:
    """Log one probe outcome and keep the transition: appends to
    ``probe_log.jsonl``; a healthy outcome clears the negative caches; the
    first ``false -> true`` transition logs a recovery, counts it in
    ``autocycler_probe_recoveries_total`` and fires the hooks once."""
    global _last_attached, _recovery_fired
    entry = {"ts": round(time.time(), 3), "source": source}
    entry.update(outcome)
    tail = entry.get("stderr_tail")
    if isinstance(tail, str) and len(tail) > 2000:
        entry["stderr_tail"] = tail[-2000:]
    append_probe_log(entry)
    attached = bool(outcome.get("attached"))
    with _lock:
        prev = _last_attached
        _last_attached = attached
        fire = prev is False and attached and not _recovery_fired
        if fire:
            _recovery_fired = True
        hooks = list(_hooks)
    if attached:
        _clear_negative_caches()
    if fire:
        append_probe_log({"ts": round(time.time(), 3), "source": source,
                          "type": "recovery",
                          "note": "probe recovered (false -> true); firing "
                                  f"{len(hooks)} recovery hook(s)"})
        from . import metrics_registry
        metrics_registry.counter_inc(
            "autocycler_probe_recoveries_total", 1,
            help="false->true probe transitions observed by the sentinel")
        for hook in hooks:
            try:
                hook(entry)
            except Exception as e:  # noqa: BLE001 — a hook must not kill the watcher
                print(f"autocycler: probe recovery hook failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
    return entry


def _clear_negative_caches() -> None:
    """A healthy probe drops every cached negative: the failure in memory
    and the persisted ``device_probe.json`` (``device.py`` owns both)."""
    try:
        from .. import device
        device.notify_probe_recovered()
    except Exception:  # noqa: BLE001 — clearing is best-effort
        pass


def _reset_for_tests() -> None:
    global _last_attached, _recovery_fired, _log_dir, _fallback_dir
    with _lock:
        _last_attached = None
        _recovery_fired = False
        _log_dir = None
        _fallback_dir = None
        _hooks.clear()


# ---- the recovery capture ----

def recovery_capture(outcome: Optional[dict] = None, out_dir=None) -> dict:
    """A bounded run of the port's kernels the moment the card recovers,
    written to ``recovery_capture.json`` beside the probe log and
    returned, with the JAX package's top-level keys (ts, trigger, backend,
    dotplot, grouping, seconds):

    - ``dotplot``: the word-compare kernel's Gcells/s
      (``dotplot_grid.benchmark_gcells``, kernel "vpu") at
      AUTOCYCLER_RECOVERY_DOTPLOT_N squared, k 32, rated by
      ``ops.mfu.vpu_grid_mfu``;
    - ``grouping``: ``kmers.group_windows_full`` over
      AUTOCYCLER_RECOVERY_GROUPING_MBP of random bases at k 51, through the
      sortnet kernel on the card (``kernel_s``) and its plain version on
      CPU tensors (``plain_s``), ``kernel_exact`` when both agree. The JAX
      package's keys are ``native_s``, ``lsd_s`` and ``lsd_exact``: the
      port has neither a native nor an LSD path.

    Each part also records the launches it made. A part that fails to
    build or launch records its error: this is telemetry, never the main
    path."""
    import numpy as np
    import torch

    from .. import device

    result: dict = {"ts": round(time.time(), 3)}
    if outcome is not None:
        result["trigger"] = {k: outcome.get(k)
                             for k in ("ts", "kind", "reason", "source")}
    t0 = time.perf_counter()
    cuda = torch.cuda.is_available()
    result["backend"] = "cuda" if cuda else "cpu"
    try:
        if not cuda:
            raise LookupError("no CUDA device")
        from ..ops.dotplot_grid import KERNEL_WORDS, benchmark_gcells
        from ..ops.mfu import vpu_grid_mfu
        n = knob_int("AUTOCYCLER_RECOVERY_DOTPLOT_N")
        k = 32
        before = device.launches[KERNEL_WORDS]
        _, rate = benchmark_gcells(n_a=n, n_b=n, k=k, repeats=1,
                                   kernel="vpu")
        result["dotplot"] = {"kernel": "vpu", "grid": f"{n}x{n}", "k": k,
                             "gcells_per_s": round(rate, 2),
                             **vpu_grid_mfu(rate, k),
                             "launches": device.launches[KERNEL_WORDS]
                             - before}
    except LookupError as e:
        result["dotplot"] = {"skipped": str(e)}
    except Exception as e:  # noqa: BLE001 — partial evidence beats none
        result["dotplot"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        if not cuda:
            raise LookupError("no CUDA device")
        from ..ops.kmers import group_windows_full
        from ..ops.sortnet import KERNEL
        n = int(knob_float("AUTOCYCLER_RECOVERY_GROUPING_MBP") * 1e6)
        k = 51
        rng = np.random.default_rng(7)
        codes = rng.integers(1, 5, size=max(n, k + 2)).astype(np.uint8)
        starts = np.arange(0, len(codes) - k, dtype=np.int64)
        before = device.launches[KERNEL]
        t = time.perf_counter()
        gid, order = group_windows_full(codes, starts, k, device="cuda")
        kernel_s = time.perf_counter() - t
        launched = device.launches[KERNEL] - before
        t = time.perf_counter()
        gid_p, order_p = group_windows_full(codes, starts, k, device="cpu")
        plain_s = time.perf_counter() - t
        result["grouping"] = {
            "windows": len(starts), "k": k,
            "kernel_s": round(kernel_s, 3), "plain_s": round(plain_s, 3),
            "kernel_exact": bool(np.array_equal(gid, gid_p)
                                 and np.array_equal(order, order_p)),
            "launches": launched,
        }
    except LookupError as e:
        result["grouping"] = {"skipped": str(e)}
    except Exception as e:  # noqa: BLE001
        result["grouping"] = {"error": f"{type(e).__name__}: {e}"}
    result["seconds"] = round(time.perf_counter() - t0, 3)
    log_path = probe_log_path()
    target = Path(out_dir) if out_dir is not None else (
        log_path.parent if log_path else None)
    if target is not None:
        try:
            target.mkdir(parents=True, exist_ok=True)
            (target / RECOVERY_CAPTURE_FILE).write_text(
                json.dumps(result, indent=2, default=str) + "\n")
        except OSError:
            pass
    append_probe_log({"ts": round(time.time(), 3), "type": "capture",
                      "source": "recovery", "capture": result})
    return result


#: The background probe's default deadline, lower than the foreground
#: 60 s: the background probe runs beside host work from the command's
#: start, so its deadline bounds how late a slow card answers.
BACKGROUND_PROBE_DEADLINE_S = 20.0


def probe_deadline(background: bool = False) -> float:
    """The probe deadline shared with ``device.py``'s gate:
    AUTOCYCLER_PROBE_DEADLINE_S when it is set; else 60 s for a foreground
    probe (``doctor --probe``, the watcher, the synchronous gate) and
    :data:`BACKGROUND_PROBE_DEADLINE_S` for the background one."""
    value = knob_float("AUTOCYCLER_PROBE_DEADLINE_S")
    if value is None:       # unset, or malformed (with a warning)
        return BACKGROUND_PROBE_DEADLINE_S if background else 60.0
    return value


# ---- the watcher ----

class ProbeWatcher:
    """Probing on an interval, with the transition bookkeeping. ``cycle()``
    is the unit (probe once, record, return the logged entry), so tests
    and ``doctor --watch`` drive it in their own thread;
    :func:`maybe_start_watcher` runs it in a daemon thread."""

    def __init__(self, interval: float, deadline: Optional[float] = None,
                 probe_fn: Optional[Callable[[float], dict]] = None,
                 source: str = "watcher"):
        self.interval = max(float(interval), 0.01)
        self.deadline = probe_deadline() if deadline is None else deadline
        self.probe_fn = probe_fn or subprocess_probe
        self.source = source
        self.stop_event = threading.Event()
        self.cycles = 0

    def cycle(self) -> dict:
        outcome = self.probe_fn(self.deadline)
        self.cycles += 1
        return record_outcome(outcome, source=self.source)

    def run(self) -> None:
        while not self.stop_event.is_set():
            try:
                self.cycle()
            except Exception as e:  # noqa: BLE001 — the watcher must survive
                print(f"autocycler: probe watcher cycle failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
            if self.stop_event.wait(self.interval):
                break

    def stop(self) -> None:
        self.stop_event.set()


def watch_interval() -> Optional[float]:
    """AUTOCYCLER_PROBE_WATCH in seconds; unset, <= 0 or malformed: off."""
    interval = knob_float("AUTOCYCLER_PROBE_WATCH")
    if interval is None:
        return None
    return interval if interval > 0 else None


def maybe_start_watcher() -> Optional[threading.Thread]:
    """Start the watcher thread when AUTOCYCLER_PROBE_WATCH is set (once a
    process; returns the thread or None), with :func:`recovery_capture`
    as a recovery hook unless AUTOCYCLER_RECOVERY_CAPTURE=0."""
    global _watcher_thread
    interval = watch_interval()
    if interval is None:
        return None
    with _lock:
        if _watcher_thread is not None and _watcher_thread.is_alive():
            return _watcher_thread
    if knob_bool("AUTOCYCLER_RECOVERY_CAPTURE"):
        with _lock:
            if recovery_capture not in _hooks:
                _hooks.append(recovery_capture)
    watcher = ProbeWatcher(interval)
    t = threading.Thread(target=watcher.run, daemon=True,
                         name="autocycler-probe-sentinel")
    t.watcher = watcher  # type: ignore[attr-defined] — reachable for stop()
    t.start()
    with _lock:
        _watcher_thread = t
    return t
