"""Failure handling, as the JAX package's utils/resilience.py has it: the
streamed grouping's failure kind and the visible record of a path that
gave way to another, and the hardened subprocess runner of ``helper``.

A spill that cannot be trusted raises :class:`SpillError`; the k-mer index
catches it (and ``OSError``), records the degrade, and groups in memory.
Each degrade prints one line to stderr,
``autocycler backend degrade: <chain>: <from> -> <to> (<reason>)``, once
per (chain, from, to) in a process, and counts into
``autocycler_degrades_total``.

:func:`run_command` runs an external command with a timeout, bounded
retries with backoff, and the tail of its stderr in the
:class:`SubprocessError` it raises after the last failed attempt.
"""

from __future__ import annotations

import contextlib
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional

from ..obs import metrics_registry
from .env import env_float, env_int
from .misc import AutocyclerError

DEGRADES_TOTAL = "autocycler_degrades_total"
SUBPROCESS_RUNS_TOTAL = "autocycler_subprocess_runs_total"
SUBPROCESS_RETRIES_TOTAL = "autocycler_subprocess_retries_total"
SUBPROCESS_FAILURES_TOTAL = "autocycler_subprocess_failures_total"


class SpillError(AutocyclerError):
    """The streamed k-mer grouping's on-disk spill is unusable (torn or
    truncated bin, manifest/record mismatch, duplicate representatives
    across bins)."""


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
# Hardened subprocess execution
# ---------------------------------------------------------------------------

_STDERR_TAIL_BYTES = 2000


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
            returncode, reason, tail = _attempt(cmd, stdout_file, cwd,
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
