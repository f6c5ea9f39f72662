"""`autocycler doctor`: device forensics for people and machines, as the
JAX package's commands/doctor.py renders them, for the CUDA probe.

Renders what the port knows of the device path: the environment snapshot,
the last probe outcome in this process, the background probe's overlap
report, the persisted negative-probe cache and the probe history
(``probe_log.jsonl``), then a rule-driven list of recommended actions. The
default run makes no CUDA call and starts no probe child: it only reads
state, so it is safe on a host whose card or driver has wedged (the case
it exists to diagnose). ``--probe`` runs one live subprocess probe;
``--watch`` runs the sentinel in the foreground.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

from ..obs import sentinel
from ..utils.knobs import knob_bool, knob_float


def negative_cache_state(run_dir: str = ".") -> dict:
    """The persisted negative-probe cache (``device_probe.json``) in
    ``run_dir`` or ``run_dir/.cache`` (where compress, batch and the daemon
    keep it), with its freshness against the active TTL: whether it still
    stops the next processes from probing."""
    ttl = knob_float("AUTOCYCLER_PROBE_NEG_TTL_S")
    for cand in (Path(run_dir) / "device_probe.json",
                 Path(run_dir) / ".cache" / "device_probe.json"):
        try:
            entry = json.loads(cand.read_text())
        except (OSError, ValueError):
            continue
        age = time.time() - float(entry.get("at", 0) or 0)
        return {"present": True, "path": str(cand),
                "kind": entry.get("kind"), "reason": entry.get("reason"),
                "age_s": round(age, 1), "ttl_s": ttl,
                "fresh": bool(ttl > 0 and age < ttl)}
    return {"present": False, "ttl_s": ttl, "fresh": False}


def recommended_actions(probe_state: dict, neg_cache: dict, env: dict,
                        history: list) -> list:
    """The rules from the gathered evidence to next steps, one action per
    case as the JAX package's. Pure: no side effect."""
    actions = []
    kind = probe_state.get("kind")
    fresh_neg = neg_cache.get("fresh")
    last_real = next((e for e in reversed(history)
                      if "attached" in e and "type" not in e), None)
    if kind is None and last_real is not None:
        kind = last_real.get("kind")

    if kind == "timeout" or (fresh_neg and neg_cache.get("kind") == "timeout"):
        actions.append(
            "wedged driver or card: the probe never answered. Inspect "
            "`stderr_tail` in probe_log.jsonl for what CUDA's init printed, "
            "then run `nvidia-smi`: a card it cannot read needs a driver "
            "reset or a reboot. Device commands end with `Error:` until a "
            "probe succeeds.")
        if fresh_neg:
            actions.append(
                f"a fresh negative cache ({neg_cache.get('path')}, age "
                f"{neg_cache.get('age_s')}s / ttl {neg_cache.get('ttl_s')}s) "
                "is suppressing re-probes; delete it or set "
                "AUTOCYCLER_PROBE_NEG_TTL_S=0 to force an immediate retry.")
        actions.append(
            "set AUTOCYCLER_PROBE_WATCH=<seconds> so the sentinel re-probes "
            "in the background and captures device evidence (the recovery "
            "capture) the moment the card answers again.")
    elif kind == "error" or (fresh_neg and neg_cache.get("kind") == "error"):
        actions.append(
            "CUDA init failed outright (kind=error): check the probe reason "
            "and `plugin_versions` above for a driver or toolkit mismatch "
            "(torch's CUDA version against the driver's, as `nvidia-smi` "
            "shows it), and `accel_devices` for missing /dev/nvidia* nodes.")
    elif kind == "pinned":
        actions.append(
            f"CUDA_VISIBLE_DEVICES={env.get('cuda_visible_devices')!r} hides "
            "every card, so device commands cannot run; unset it or name a "
            "card to let the probe try the device.")
    elif kind == "no-cuda":
        if env.get("accel_devices"):
            actions.append(
                "torch sees no CUDA device although /dev/nvidia* files exist "
                "— check that THIS interpreter's torch is a CUDA build "
                "(plugin_versions above) and that `nvidia-smi` lists the "
                "card.")
        else:
            actions.append(
                "host without an NVIDIA card (no /dev/nvidia*): device "
                "commands end with `Error:` here; run them on a machine with "
                "a card.")
    elif kind == "disabled":
        actions.append(
            "AUTOCYCLER_PROBE_DEADLINE_S <= 0 disables the probe: device "
            "commands attach CUDA directly, with no diagnosis if the card "
            "has wedged; set a positive deadline to turn it back on.")
    elif kind == "ok":
        actions.append("device probe healthy — no action needed.")
    else:
        actions.append(
            "no probe has run in this process and no probe history was "
            "found; run `autocycler doctor --probe` for a live diagnosis "
            "(subprocess probe, killable, captures init stderr).")

    if not any("AUTOCYCLER_PROBE_WATCH" in a for a in actions) \
            and kind not in ("ok", "pinned") \
            and not env.get("env", {}).get("AUTOCYCLER_PROBE_WATCH"):
        actions.append(
            "tip: AUTOCYCLER_PROBE_WATCH=<seconds> keeps a background "
            "sentinel watching for device recovery during long runs.")
    return actions


def lint_state(run_dir: str = ".") -> dict:
    """Static-analysis posture: the port's committed lint baseline
    (``lint_baseline_torch.json``, never the JAX package's
    ``lint_baseline.json``) and any ``lint_report.json`` in the run dir.
    Never raises: doctor must work anywhere."""
    out: dict = {"baseline": None, "baselined": 0, "report": None}
    try:
        from .lint import default_baseline
        baseline = default_baseline()
        if baseline.is_file():
            data = json.loads(baseline.read_text())
            out["baseline"] = str(baseline)
            out["baselined"] = len(data.get("findings") or [])
        report = Path(run_dir) / "lint_report.json"
        if report.is_file():
            data = json.loads(report.read_text())
            out["report"] = {
                "findings": len(data.get("findings") or []),
                "files": data.get("files"),
                "wall_s": data.get("wall_s"),
            }
    except Exception:  # noqa: BLE001
        pass
    return out


def gather(run_dir: str = ".") -> dict:
    """Everything doctor knows, as one dict (the ``--json`` payload)."""
    from ..device import device_probe_report, probe_overlap_report
    env = sentinel.environment_snapshot()
    probe_state = device_probe_report()
    neg_cache = negative_cache_state(run_dir)
    log_path = Path(run_dir) / sentinel.PROBE_LOG
    if not log_path.exists():
        fallback = sentinel.probe_log_path()
        log_path = fallback if fallback is not None else log_path
    history = sentinel.read_probe_log(log_path, limit=50)
    return {
        "env": env,
        "probe_state": probe_state,
        "async_probe": probe_overlap_report(),
        "negative_cache": neg_cache,
        "probe_log": {"path": str(log_path), "entries": history},
        "lint": lint_state(run_dir),
        "actions": recommended_actions(probe_state, neg_cache, env, history),
    }


def _render_text(report: dict) -> None:
    env = report["env"]
    print("autocycler doctor")
    print("=================")
    print(f"python {env['python']} on {env['platform']}  "
          f"(cpus: {env['cpu_count']})")
    print(f"CUDA_VISIBLE_DEVICES: {env['cuda_visible_devices']!r}")
    if env["plugin_versions"]:
        print("packages: " + ", ".join(f"{k}=={v}" for k, v
                                       in env["plugin_versions"].items()))
    else:
        print("packages: none (no torch/triton/nvidia-* packages found)")
    print("nvidia devices: " + (", ".join(env["accel_devices"]) or "none"))
    if env["env"]:
        print("knobs: " + ", ".join(f"{k}={v}" for k, v
                                    in sorted(env["env"].items())))
    lint = report.get("lint") or {}
    if lint.get("baseline"):
        line = (f"lint: baseline present "
                f"({lint.get('baselined', 0)} accepted finding(s))")
        rep = lint.get("report")
        if isinstance(rep, dict):
            line += (f"; last report: {rep.get('findings')} new across "
                     f"{rep.get('files')} files")
        print(line)

    ps = report["probe_state"]
    print("\nlast in-process probe")
    print("---------------------")
    if ps.get("attached") is None:
        print("no probe has run in this process (doctor does not initiate "
              "device bring-up; use --probe)")
    else:
        print(f"attached={ps['attached']} kind={ps.get('kind')} "
              f"seconds={ps.get('seconds')} probes={ps.get('probes')}")
        print(f"reason: {ps.get('reason')}")

    ap = report.get("async_probe") or {}
    print("\nbackground (async) probe")
    print("------------------------")
    state = ap.get("state", "unstarted")
    if state == "unstarted":
        print("not started in this process (commands start it at launch so "
              "the probe overlaps host work)")
    else:
        print(f"state={state} kind={ap.get('kind')} "
              f"attempts={ap.get('attempts')} "
              f"deadline_s={ap.get('deadline_s')}")
        if ap.get("resolve_s") is not None:
            print(f"resolved in {ap['resolve_s']:.2f}s; callers blocked "
                  f"{ap.get('wait_s', 0.0):.2f}s "
                  f"(overlap saved {ap.get('overlap_saved_s', 0.0):.2f}s, "
                  f"{ap.get('pending_consults', 0)} pending consult(s))")

    nc = report["negative_cache"]
    print("\nnegative cache")
    print("--------------")
    if nc.get("present"):
        state = "FRESH (suppressing probes)" if nc["fresh"] else "stale"
        print(f"{nc['path']}: kind={nc['kind']} age={nc['age_s']}s "
              f"ttl={nc['ttl_s']}s [{state}]")
        print(f"reason: {nc.get('reason')}")
    else:
        print("none persisted")

    entries = report["probe_log"]["entries"]
    print(f"\nprobe history ({report['probe_log']['path']})")
    print("-------------")
    if not entries:
        print("no probe log found")
    for e in entries[-10:]:
        if e.get("type"):
            print(f"  [{e.get('ts')}] {e['type']}: "
                  f"{e.get('note') or ''}".rstrip())
        else:
            print(f"  [{e.get('ts')}] {e.get('source')}: "
                  f"attached={e.get('attached')} kind={e.get('kind')} "
                  f"seconds={e.get('seconds')} — {e.get('reason')}")

    print("\nrecommended actions")
    print("-------------------")
    for i, action in enumerate(report["actions"], 1):
        print(f"{i}. {action}")


def doctor(run_dir: str = ".", as_json: bool = False, watch: bool = False,
           probe: bool = False, interval: float = None,
           cycles: int = None) -> int:
    """The subcommand. ``probe`` runs ONE live subprocess probe (recorded
    to the probe log) before reporting; ``watch`` runs the sentinel in the
    foreground (``cycles`` bounds it, else Ctrl-C), with the recovery
    capture armed."""
    sentinel.set_probe_log_dir(run_dir, fallback=True)
    if watch:
        if knob_bool("AUTOCYCLER_RECOVERY_CAPTURE"):
            sentinel.on_recovery(sentinel.recovery_capture)
        iv = interval if interval is not None else (
            sentinel.watch_interval() or 30.0)
        watcher = sentinel.ProbeWatcher(iv, source="doctor-watch")
        print(f"watching: probing every {iv:g}s "
              f"(deadline {watcher.deadline:g}s); Ctrl-C to stop",
              file=sys.stderr)
        try:
            while not watcher.stop_event.is_set():
                entry = watcher.cycle()
                print(json.dumps(entry, default=str), flush=True)
                if cycles is not None and watcher.cycles >= cycles:
                    break
                if watcher.stop_event.wait(iv):
                    break
        except KeyboardInterrupt:
            pass
        return 0
    if probe:
        outcome = sentinel.subprocess_probe(sentinel.probe_deadline())
        sentinel.record_outcome(outcome, source="doctor")
    report = gather(run_dir)
    if as_json:
        print(json.dumps(report, indent=2, default=str))
    else:
        _render_text(report)
    return 0
