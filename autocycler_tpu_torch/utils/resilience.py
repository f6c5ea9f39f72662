"""Failure handling, as the JAX package's utils/resilience.py has it: the
streamed grouping's failure kind and the visible record of a path that
gave way to another, the hardened subprocess runner of ``helper``, and
what ``batch`` needs to run many isolates: the error taxonomy, the
per-isolate quarantine, the knob-armed crash points and the resume
manifest.

A spill that cannot be trusted raises :class:`SpillError`; the k-mer index
catches it (and ``OSError``), records the degrade, and groups in memory.
Each degrade prints one line to stderr,
``autocycler backend degrade: <chain>: <from> -> <to> (<reason>)``, once
per (chain, from, to) in a process, and counts into
``autocycler_degrades_total``.

:func:`run_command` runs an external command with a timeout, bounded
retries with backoff, and the tail of its stderr in the
:class:`SubprocessError` it raises after the last failed attempt.

:func:`collect_errors` gives the quarantine ``batch`` wraps round each
isolate: an :class:`AutocyclerError` or ``OSError`` inside it is recorded
against the isolate, and the run goes on. Anything else, a CUDA error (a
``RuntimeError``) among them, propagates. :class:`RunManifest` writes
``batch_manifest.json`` in the JAX package's schema, so either package
resumes the other's run.

:class:`FaultPlan` is the deterministic fault injection of the JAX
package, parsed from ``AUTOCYCLER_FAULTS`` (or installed with
:func:`set_fault_plan`): rules ``site[:match[:mode[:times]]]`` that fire
at the instrumented sites of :data:`FAULT_SITES` (a FASTA or GFA read, a
stream bin's write, read or format, a subprocess, and the crash points),
so that every quarantine, degrade and retry path has a way in without
patching code. The crash points are armed by ``AUTOCYCLER_CRASH_POINTS``
or by a plan rule at their site.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import metrics_registry
from .env import env_float, env_int, env_str
from .misc import AutocyclerError

DEGRADES_TOTAL = "autocycler_degrades_total"
SUBPROCESS_RUNS_TOTAL = "autocycler_subprocess_runs_total"
SUBPROCESS_RETRIES_TOTAL = "autocycler_subprocess_retries_total"
SUBPROCESS_FAILURES_TOTAL = "autocycler_subprocess_failures_total"
QUARANTINED_TOTAL = "autocycler_quarantined_items_total"
FAULT_INJECTIONS_TOTAL = "autocycler_fault_injections_total"


class InputError(AutocyclerError):
    """Malformed or missing user input (corrupt FASTA/GFA, empty isolate,
    bad flag value)."""


class SpillError(AutocyclerError):
    """The streamed k-mer grouping's on-disk spill is unusable (torn or
    truncated bin, manifest/record mismatch, duplicate representatives
    across bins)."""


class IsolateError(AutocyclerError):
    """A per-isolate failure inside a multi-isolate batch: quarantined and
    recorded in the run manifest instead of killing the whole run."""

    def __init__(self, isolate: str, cause: BaseException):
        self.isolate = isolate
        self.cause = cause
        super().__init__(f"isolate {isolate}: {cause}")


class ErrorCollector:
    """Quarantines per-item failures: code inside :meth:`quarantine` that
    raises an :class:`AutocyclerError` (or OSError — malformed inputs often
    surface as file errors) records the failure against the item and
    continues, instead of aborting the run. Every other exception, a CUDA
    error among them, propagates."""

    def __init__(self):
        self.errors: Dict[str, IsolateError] = {}

    @contextlib.contextmanager
    def quarantine(self, item: str):
        try:
            yield
        except (AutocyclerError, OSError) as e:
            from . import log
            err = IsolateError(item, e)
            log.message(f"WARNING: {err} — skipping")
            self.errors[item] = err
            metrics_registry.counter_inc(
                QUARANTINED_TOTAL, 1,
                help="per-item failures quarantined instead of aborting")

    def failed(self, item: str) -> bool:
        return item in self.errors

    def __len__(self) -> int:
        return len(self.errors)


def collect_errors() -> ErrorCollector:
    """A fresh quarantine collector: ``with errs.quarantine(name): ...``."""
    return ErrorCollector()


_degrade_lock = threading.Lock()
_degrade_events: List[dict] = []
_degrade_seen: set = set()


def record_degrade(chain: str, from_tier: str, to_tier: str,
                   reason: str) -> bool:
    """Records a degrade and prints its line to stderr, once per (chain,
    from, to). Returns True when the event was newly recorded."""
    key = (chain, from_tier, to_tier)
    with _degrade_lock:
        if key in _degrade_seen:
            return False
        _degrade_seen.add(key)
        _degrade_events.append({"chain": chain, "from": from_tier,
                                "to": to_tier, "reason": reason})
    metrics_registry.counter_inc(
        DEGRADES_TOTAL, 1, help="backend degradation transitions",
        chain=chain, **{"from": from_tier, "to": to_tier})
    print(f"autocycler backend degrade: {chain}: {from_tier} -> {to_tier} "
          f"({reason})", file=sys.stderr)
    return True


def degrade_events(chain: Optional[str] = None) -> List[dict]:
    """The degrade events recorded so far, optionally of one chain."""
    with _degrade_lock:
        events = list(_degrade_events)
    if chain is not None:
        events = [e for e in events if e["chain"] == chain]
    return events


def reset_degrades() -> None:
    """Forgets every recorded degrade, so each is printed again."""
    with _degrade_lock:
        _degrade_events.clear()
        _degrade_seen.clear()


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM: alive but not ours
    return True


# ---------------------------------------------------------------------------
# Fault injection: the fault plan and the crash points (the chaos
# harness's kill switch)
# ---------------------------------------------------------------------------

# The registered crash points are also fault sites (their hooks call
# :func:`crash_point`); at a crash point a rule's default mode is "crash":
#   post-stage          a stage's artifacts are flushed but the manifest
#                       terminal flag has NOT been flipped yet
#   mid-spill-write     half a spill record written to a stream bin
#   mid-cache-store     cache payload written to its tmp file, not renamed
#   pre-artifact-rename manifest/ledger tmp written, os.replace pending
#   mid-fleet-shard     a fleet shard's compress checkpoints are durable but
#                       its cluster/finalise stages have not started
CRASH_POINTS = ("post-stage", "mid-spill-write", "mid-cache-store",
                "pre-artifact-rename", "mid-fleet-shard")
# the JAX package's sites but its native library's three, which the port
# does not have
FAULT_SITES = ("subprocess", "fasta", "gfa", "stream_write", "stream_read",
               "stream_format") + CRASH_POINTS

# the distinctive status a crash-injected process dies with, so a harness
# can tell an injected crash from a genuine failure
CRASH_EXIT = 43


@dataclass
class FaultRule:
    """One injection rule: fire at ``site`` when ``match`` is a substring of
    the hook's key, in ``mode`` ("fail", "hang" or "crash"), at most
    ``times`` times (-1 = unlimited)."""
    site: str
    match: str = ""
    mode: str = "fail"
    times: int = -1
    fired: int = 0

    def exhausted(self) -> bool:
        return 0 <= self.times <= self.fired


@dataclass
class FaultPlan:
    """An ordered set of :class:`FaultRule`, deterministic by construction:
    rules fire on exact site and substring matches with bounded counts, so
    an injected failure reproduces identically every run."""
    rules: List[FaultRule] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``AUTOCYCLER_FAULTS`` spec: comma-separated rules
        ``site[:match[:mode[:times]]]``, for example
        ``subprocess:flye:hang:1,fasta:iso_001,stream_read``. At a crash
        point the default mode is ``crash``, so ``post-stage:::1`` kills
        the process at the first post-stage boundary."""
        rules = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            site = fields[0]
            if site not in FAULT_SITES:
                raise InputError(
                    f"unknown fault-injection site {site!r} in "
                    f"AUTOCYCLER_FAULTS (choose from {', '.join(FAULT_SITES)})")
            match = fields[1] if len(fields) > 1 else ""
            default_mode = "crash" if site in CRASH_POINTS else "fail"
            mode = fields[2] if len(fields) > 2 and fields[2] \
                else default_mode
            if mode not in ("fail", "hang", "crash"):
                raise InputError(f"unknown fault mode {mode!r} "
                                 "(choose 'fail', 'hang' or 'crash')")
            times = int(fields[3]) if len(fields) > 3 and fields[3] else -1
            rules.append(FaultRule(site, match, mode, times))
        return cls(rules)

    def fire(self, site: str, key: str = "") -> Optional[FaultRule]:
        rule = self.peek(site, key)
        if rule is not None:
            rule.fired += 1
            metrics_registry.counter_inc(
                FAULT_INJECTIONS_TOTAL, 1,
                help="deterministic fault-injection rule firings",
                site=site, mode=rule.mode)
        return rule

    def peek(self, site: str, key: str = "") -> Optional[FaultRule]:
        """The rule :meth:`fire` would consume, without consuming it."""
        for rule in self.rules:
            if rule.site == site and not rule.exhausted() \
                    and rule.match in str(key):
                return rule
        return None


_fault_lock = threading.Lock()
_fault_plan: Optional[FaultPlan] = None
# (the spec it was parsed from, the plan)
_env_plan: Optional[Tuple[str, FaultPlan]] = None


def set_fault_plan(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) an explicit fault plan; it takes
    precedence over ``AUTOCYCLER_FAULTS``."""
    global _fault_plan
    with _fault_lock:
        _fault_plan = plan


def _active_plan_locked() -> Optional[FaultPlan]:
    """The plan in effect (explicit, else the knob's spec), cached. Call
    under ``_fault_lock``."""
    global _env_plan
    if _fault_plan is not None:
        return _fault_plan
    spec = env_str("AUTOCYCLER_FAULTS") or ""
    if not spec:
        _env_plan = None
        return None
    if _env_plan is None or _env_plan[0] != spec:
        _env_plan = (spec, FaultPlan.parse(spec))
    return _env_plan[1]


def fault_fire(site: str, key: str = "") -> Optional[FaultRule]:
    """The hook the instrumented sites call: the matching rule (one firing
    consumed) or None; cheap when no plan is active. A matched ``crash``
    rule never returns: the process dies with :data:`CRASH_EXIT` here."""
    with _fault_lock:
        plan = _active_plan_locked()
        rule = plan.fire(site, key) if plan is not None else None
    if rule is not None and rule.mode == "crash":
        _crash_exit(site, key)
    return rule


# Patchable seam so tests can observe a would-be crash instead of dying.
_exit = os._exit

# Per-point hit counters for AUTOCYCLER_CRASH_POINTS "point@n" arming;
# process-wide because a crash point is a process-lifetime event.
_crash_hits: Dict[str, int] = {}
_crash_spec_cache: Optional[Tuple[str, Dict[str, int]]] = None


def _crash_exit(point: str, key: str = "") -> None:
    suffix = f" ({key})" if key else ""
    sys.stderr.write(f"autocycler crash injection: {point}{suffix}\n")
    sys.stderr.flush()
    _exit(CRASH_EXIT)


def _parse_crash_points(spec: str) -> Dict[str, int]:
    """``point[@n]`` comma list -> {point: 1-based hit index to crash at}."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, nth = part.partition("@")
        if name not in CRASH_POINTS:
            raise InputError(
                f"unknown crash point {name!r} in AUTOCYCLER_CRASH_POINTS "
                f"(choose from: {', '.join(CRASH_POINTS)})")
        if nth:
            try:
                out[name] = max(1, int(nth))
            except ValueError:
                raise InputError(
                    f"bad crash-point hit index {nth!r} for {name!r} "
                    "(expected 'point' or 'point@N')")
        else:
            out[name] = 1
    return out


def _crash_due_locked(point: str, advance: bool) -> bool:
    """Whether the next hit of ``point`` is armed via AUTOCYCLER_CRASH_POINTS.
    Call under ``_fault_lock``; ``advance`` consumes one hit."""
    global _crash_spec_cache
    spec = env_str("AUTOCYCLER_CRASH_POINTS")
    targets: Dict[str, int] = {}
    if spec:
        if _crash_spec_cache is None or _crash_spec_cache[0] != spec:
            _crash_spec_cache = (spec, _parse_crash_points(spec))
        targets = _crash_spec_cache[1]
    hit = _crash_hits.get(point, 0) + 1
    if advance:
        _crash_hits[point] = hit
    return targets.get(point) == hit


def crash_armed(point: str, key: str = "") -> bool:
    """True when :func:`crash_point` called now would kill the process,
    WITHOUT consuming the hit. A site that simulates a torn write uses it
    to write a partial payload before the crash point fires."""
    with _fault_lock:
        if _crash_due_locked(point, advance=False):
            return True
        plan = _active_plan_locked()
        rule = plan.peek(point, key) if plan is not None else None
    return rule is not None and rule.mode == "crash"


def crash_point(point: str, key: str = "") -> None:
    """A registered crash point: deterministically ``_exit(CRASH_EXIT)``
    here when armed, else a no-op. Armed by ``AUTOCYCLER_CRASH_POINTS``
    (comma list of ``point[@n]``: the n-th hit of the point, default the
    first) or by a fault-plan rule at this site. Every call counts one
    hit for the ``@n`` bookkeeping."""
    with _fault_lock:
        due = _crash_due_locked(point, advance=True)
    if due:
        metrics_registry.counter_inc(
            FAULT_INJECTIONS_TOTAL, 1,
            help="deterministic fault-injection rule firings",
            site=point, mode="crash")
        _crash_exit(point, key)
    fault_fire(point, key)


def _reset_crash_hits_for_tests() -> None:
    global _crash_spec_cache
    with _fault_lock:
        _crash_hits.clear()
        _crash_spec_cache = None


# ---------------------------------------------------------------------------
# Hardened subprocess execution
# ---------------------------------------------------------------------------

_STDERR_TAIL_BYTES = 2000

# the commands a "subprocess" fault rule runs in place of the real one, so
# that an injected failure or hang goes through the real launch, wait and
# kill-on-timeout
_FAIL_CMD = [sys.executable, "-c",
             "import sys; sys.stderr.write('autocycler fault injection: "
             "forced subprocess failure\\n'); sys.exit(3)"]
_HANG_CMD = [sys.executable, "-c",
             "import sys, time; sys.stderr.write('autocycler fault "
             "injection: forced hang\\n'); sys.stderr.flush(); "
             "time.sleep(600)"]


class SubprocessError(AutocyclerError):
    """An external command failed or hung past its timeout, after any
    configured retries. Carries the command, the final returncode (None for
    a timeout kill), the attempt count and the tail of the captured stderr,
    all of which also appear in str(error) so logs are self-contained."""

    def __init__(self, cmd: List[str], returncode: Optional[int],
                 attempts: int, stderr_tail: str = "",
                 reason: str = "nonzero exit"):
        self.cmd = [str(c) for c in cmd]
        self.returncode = returncode
        self.attempts = attempts
        self.stderr_tail = stderr_tail
        self.reason = reason
        status = "timed out" if returncode is None \
            else f"exited with status {returncode}"
        text = (f"{self.cmd[0]} {status} after {attempts} "
                f"attempt{'s' if attempts != 1 else ''} ({reason})")
        if stderr_tail.strip():
            text += f"; stderr tail:\n{stderr_tail.rstrip()}"
        super().__init__(text)


# first retry waits about this long; each later one twice the last
_BACKOFF_SECONDS = 1.0


def backoff_delay(attempt: int, base: float, key: str = "") -> float:
    """Exponential backoff with deterministic jitter: base * 2^(attempt-1)
    * (1 + j), j in [0, 0.25) seeded from (key, attempt) — reproducible
    across runs, decorrelated across commands."""
    jitter = random.Random(f"{key}:{attempt}").random() * 0.25
    return base * (2.0 ** (attempt - 1)) * (1.0 + jitter)


def _tail(path: Path) -> str:
    try:
        size = path.stat().st_size
        with open(path, "rb") as f:
            if size > _STDERR_TAIL_BYTES:
                f.seek(-_STDERR_TAIL_BYTES, os.SEEK_END)
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def run_command(cmd: List[str], stdout_file=None, cwd=None,
                timeout: Optional[float] = None,
                retries: Optional[int] = None,
                sleep: Callable[[float], None] = time.sleep) -> int:
    """Run a subprocess with timeout, bounded retries and stderr capture.

    - ``timeout``/``retries`` default to ``AUTOCYCLER_SUBPROCESS_TIMEOUT``
      / ``AUTOCYCLER_SUBPROCESS_RETRIES``; timeout None = unlimited.
    - stderr is captured to a spool file (disk, not memory — assembler runs
      are long) and forwarded to our stderr afterwards; its last 2000 bytes
      ride in the raised :class:`SubprocessError`.
    - a hung command is killed at the timeout and counts as a failed
      attempt; retries wait ``backoff_delay`` between attempts.
    - a partial ``stdout_file`` is deleted on every failed attempt, so the
      caller never mistakes it for real output.
    - a fault rule at site ``subprocess`` (keyed by argv[0]) runs a forced
      failure or hang in place of the command.

    Returns 0 on success; raises :class:`SubprocessError` after the final
    failed attempt. FileNotFoundError (unlaunchable command) propagates —
    retrying cannot fix a missing binary."""
    if timeout is None:
        timeout = env_float("AUTOCYCLER_SUBPROCESS_TIMEOUT")
    if retries is None:
        retries = int(env_int("AUTOCYCLER_SUBPROCESS_RETRIES"))
    cmd = [str(c) for c in cmd]
    attempts = retries + 1
    name = os.path.basename(cmd[0])
    metrics_registry.counter_inc(
        SUBPROCESS_RUNS_TOTAL, 1, help="run_command invocations",
        command=name)
    from ..obs import trace
    last_error: Optional[SubprocessError] = None
    with trace.span(f"subprocess {name}", cat="subprocess", command=cmd[0]):
        for attempt in range(1, attempts + 1):
            run_cmd = cmd
            rule = fault_fire("subprocess", cmd[0])
            if rule is not None:
                run_cmd = _HANG_CMD if rule.mode == "hang" else _FAIL_CMD
            returncode, reason, tail = _attempt(run_cmd, stdout_file, cwd,
                                                timeout)
            if returncode == 0:
                return 0
            # failed attempt: never leave a partial stdout file behind
            if stdout_file is not None:
                with contextlib.suppress(OSError):
                    os.remove(stdout_file)
            last_error = SubprocessError(cmd, returncode, attempt, tail,
                                         reason)
            if attempt < attempts:
                metrics_registry.counter_inc(
                    SUBPROCESS_RETRIES_TOTAL, 1,
                    help="failed subprocess attempts that were retried",
                    command=name)
                delay = backoff_delay(attempt, _BACKOFF_SECONDS, key=cmd[0])
                from . import log
                log.message(f"{cmd[0]} attempt {attempt}/{attempts} failed "
                            f"({reason}); retrying in {delay:.2f}s")
                sleep(delay)
    metrics_registry.counter_inc(
        SUBPROCESS_FAILURES_TOTAL, 1,
        help="subprocess runs that failed after all attempts", command=name)
    raise last_error


def _attempt(cmd, stdout_file, cwd, timeout):
    """One launch: (returncode or None on a timeout, reason, stderr tail).
    The stderr tail is also forwarded to our stderr."""
    stdout = open(stdout_file, "w") if stdout_file is not None else None
    stderr_spool = tempfile.NamedTemporaryFile(
        prefix="autocycler_stderr_", suffix=".log", delete=False)
    stderr_path = Path(stderr_spool.name)
    try:
        try:
            proc = subprocess.run(cmd, stdout=stdout or None,
                                  stderr=stderr_spool,
                                  stdin=subprocess.DEVNULL, cwd=cwd,
                                  timeout=timeout)
            returncode: Optional[int] = proc.returncode
            reason = "nonzero exit"
        except subprocess.TimeoutExpired:
            returncode = None
            reason = f"killed after {timeout}s timeout"
        except FileNotFoundError:
            # an unlaunchable binary: clean up both spool files, then
            # propagate — a retry cannot conjure the executable
            if stdout_file is not None:
                with contextlib.suppress(OSError):
                    os.remove(stdout_file)
            with contextlib.suppress(OSError):
                os.remove(stderr_spool.name)
            raise
    finally:
        if stdout is not None:
            stdout.close()
        stderr_spool.close()
    tail = _tail(stderr_path)
    if tail:
        sys.stderr.write(tail if tail.endswith("\n") else tail + "\n")
    with contextlib.suppress(OSError):
        os.remove(stderr_path)
    return returncode, reason, tail


# ---------------------------------------------------------------------------
# Resume manifests
# ---------------------------------------------------------------------------

def sweep_stale_tmps(path) -> int:
    """Remove leftover ``<name>.<pid>.*.tmp`` siblings of ``path`` whose
    writing process is dead. Tmp names are pid-tagged exactly so two live
    writers sharing a root never delete each other's in-flight writes."""
    path = Path(path)
    removed = 0
    if not path.parent.is_dir():
        return removed
    for tmp in path.parent.glob(path.name + "*"):
        name = tmp.name
        if name == path.name or ".tmp" not in name or name.endswith(".bak"):
            continue
        pid_tok = name[len(path.name):].lstrip(".").split(".", 1)[0]
        if pid_tok.isdigit() and pid_alive(int(pid_tok)):
            continue
        with contextlib.suppress(OSError):
            tmp.unlink()
            removed += 1
    return removed


def read_manifest(path) -> dict:
    """Never-raise reader for run manifests. Parses ``path`` (falling back
    to ``<path>.bak``) to the last good state; a torn tail, garbage
    content, or a missing file yields an empty manifest, never an
    exception — a crash mid-write must not brick the next start-up."""
    path = Path(path)
    for candidate in (path, path.with_name(path.name + ".bak")):
        try:
            data = json.loads(candidate.read_text())
        except (OSError, ValueError):
            continue
        if isinstance(data, dict) and isinstance(data.get("items"), dict):
            return data
    return {"version": RunManifest.VERSION, "items": {}}


class RunManifest:
    """A JSON manifest of per-item status for a resumable multi-item run
    (`batch` writes ``batch_manifest.json``, the serve daemon
    ``serve_manifest.json``), in the JAX package's schema, so either
    package resumes the other's run.

    Schema (version 1)::

        {"version": 1,
         "items": {"<name>": {"status": "pending|running|failed|done",
                              "stage": "<last stage reached>" | null,
                              "error": "<message>" | null,
                              "attempts": <int>,
                              # optional, present once a stage checkpoints:
                              "stages": {"<stage>": {
                                  "done": true,
                                  "outputs": {"<path>": {"sha256", "bytes"}},
                                  "ts_epoch": <float>}},
                              # optional scheduler extras (job spec, ...)
                              ...}}}

    Every mutation rewrites the file atomically (pid-tagged tmp + rename,
    previous state kept as ``<name>.bak``), so a run killed at any point
    leaves a loadable manifest; loading never raises (torn/garbage files
    parse to the last good state via :func:`read_manifest`). Items still
    "running" at load time are interrupted and eligible for resume; their
    per-stage records say where to re-enter."""

    VERSION = 1

    def __init__(self, path):
        self.path = Path(path)
        self.items: Dict[str, dict] = {}
        # every mutate-then-save is atomic against concurrent writers
        self._mu = threading.RLock()

    @classmethod
    def load(cls, path) -> "RunManifest":
        manifest = cls(path)
        sweep_stale_tmps(Path(path))
        manifest.items = read_manifest(path).get("items", {})
        return manifest

    def _entry(self, name: str) -> dict:
        return self.items.setdefault(
            name, {"status": "pending", "stage": None, "error": None,
                   "attempts": 0})

    def status(self, name: str) -> Optional[str]:
        with self._mu:
            entry = self.items.get(name)
            return entry["status"] if entry else None

    def attempts(self, name: str) -> int:
        with self._mu:
            entry = self.items.get(name)
            return entry["attempts"] if entry else 0

    def pending(self, name: str) -> None:
        with self._mu:
            self._entry(name)
            self.save()

    def start(self, name: str) -> None:
        with self._mu:
            entry = self._entry(name)
            entry["status"] = "running"
            entry["attempts"] += 1
            entry["error"] = None
            self.save()

    def advance(self, name: str, stage: str) -> None:
        with self._mu:
            self._entry(name)["stage"] = stage
            self.save()

    def stage_done(self, name: str, stage: str, outputs=()) -> None:
        """Checkpoint ``stage`` of item ``name`` as complete, recording the
        content hash of each flushed output artifact. The ``post-stage``
        crash point sits between artifact flush and the manifest flip: a
        crash there re-runs the stage on resume, never skips it."""
        from ..obs.ledger import artifact_hash
        recorded = {}
        for path in outputs:
            info = artifact_hash(Path(path))
            if info is not None:
                recorded[str(path)] = info
        crash_point("post-stage", f"{name}/{stage}")
        with self._mu:
            entry = self._entry(name)
            entry["stage"] = stage
            entry.setdefault("stages", {})[stage] = {
                "done": True, "outputs": recorded, "ts_epoch": time.time()}
            self.save()

    def stage_complete(self, name: str, stage: str, verify: bool = True) -> bool:
        """True when ``stage`` of ``name`` checkpointed AND (with ``verify``)
        every recorded output still exists with its recorded hash — a
        deleted or doctored artifact demotes the stage to not-done, so
        resume re-runs rather than trusting a stale flag."""
        from ..obs.ledger import artifact_hash
        with self._mu:
            entry = self.items.get(name) or {}
            rec = dict((entry.get("stages") or {}).get(stage) or {})
            outputs = dict(rec.get("outputs") or {})
        if not rec.get("done"):
            return False
        if not verify:
            return True
        for path, want in outputs.items():
            have = artifact_hash(Path(path))
            if have is None or have.get("sha256") != (want or {}).get("sha256"):
                return False
        return True

    def stage_outputs(self, name: str, stage: str) -> Dict[str, dict]:
        with self._mu:
            entry = self.items.get(name) or {}
            rec = (entry.get("stages") or {}).get(stage) or {}
            return dict(rec.get("outputs") or {})

    def last_stage(self, name: str) -> Optional[str]:
        with self._mu:
            entry = self.items.get(name) or {}
            return entry.get("stage")

    def annotate(self, name: str, **extra) -> None:
        """Attach scheduler extras (job spec, out_dir, ...) to an entry."""
        with self._mu:
            self._entry(name).update(extra)
            self.save()

    def done(self, name: str) -> None:
        with self._mu:
            entry = self._entry(name)
            entry["status"] = "done"
            entry["error"] = None
            self.save()

    def fail(self, name: str, error: str, stage: Optional[str] = None) -> None:
        with self._mu:
            entry = self._entry(name)
            entry["status"] = "failed"
            entry["error"] = str(error)
            if stage is not None:
                entry["stage"] = stage
            self.save()

    def counts(self) -> Dict[str, int]:
        with self._mu:
            out: Dict[str, int] = {}
            for entry in self.items.values():
                out[entry["status"]] = out.get(entry["status"], 0) + 1
            return out

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._mu:
            payload = json.dumps({"version": self.VERSION,
                                  "items": self.items},
                                 indent=2, sort_keys=True)
            fd, tmp = tempfile.mkstemp(
                dir=self.path.parent,
                prefix=f"{self.path.name}.{os.getpid()}.",
                suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(payload + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                crash_point("pre-artifact-rename", str(self.path))
                # keep the previous good state reachable: a reader that
                # lands between the two renames falls back to the .bak
                if self.path.is_file():
                    with contextlib.suppress(OSError):
                        os.replace(
                            self.path,
                            self.path.with_name(self.path.name + ".bak"))
                os.replace(tmp, self.path)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.remove(tmp)
                raise
