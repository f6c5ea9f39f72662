"""Small shared helpers: strand constants, revcomp, medians, formatting.

Behavioural parity targets (reference Autocycler sources, src/):
- strand constants        misc.rs:27-31
- quit_with_error         misc.rs:131-142 (raises in tests, exits in CLI)
- reverse_complement      misc.rs:350-368 ('.'→'.', unknown→'N')
- median / MAD            misc.rs:415-449
- duration/float formats  misc.rs:371-412
- signed-path helpers     misc.rs:469-485
"""

from __future__ import annotations

import sys

import numpy as np

FORWARD = True
REVERSE = False


class AutocyclerError(Exception):
    """A user-facing error (bad input, bad flag value, ...)."""


def quit_with_error(text: str):
    """Raise an AutocyclerError.

    The CLI entry point catches this and exits with status 1; under pytest it
    propagates so error paths are testable (same trick as the reference's
    cfg(test) panic, misc.rs:131-142).
    """
    raise AutocyclerError(text)


# Byte-level complement table: A<->T, C<->G, '.'->'.', everything else -> 'N'.
_COMPLEMENT = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in [("A", "T"), ("T", "A"), ("C", "G"), ("G", "C"), (".", ".")]:
    _COMPLEMENT[ord(_a)] = ord(_b)
_COMPLEMENT_TABLE = _COMPLEMENT.tobytes()  # same mapping for bytes.translate


def reverse_complement_bytes(seq: np.ndarray) -> np.ndarray:
    """Reverse-complement a uint8 sequence array.

    Small arrays (graphs hold tens of thousands of short unitigs) go through
    bytes.translate, which avoids numpy's per-call overhead; large arrays
    use the table gather."""
    if len(seq) < 4096:
        return np.frombuffer(
            seq.tobytes()[::-1].translate(_COMPLEMENT_TABLE),
            dtype=np.uint8).copy()
    return _COMPLEMENT[seq[::-1]]


def reverse_complement(seq: bytes) -> bytes:
    """Reverse-complement a bytes sequence ('.' maps to '.', unknown to 'N')."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return reverse_complement_bytes(arr).tobytes()


def median(values) -> int:
    """Integer median: mean of the two middle values for even-length input
    (integer division), 0 for empty input (reference: misc.rs:415-432)."""
    if len(values) == 0:
        return 0
    s = sorted(values)
    n = len(s)
    if n % 2 == 0:
        return (s[n // 2 - 1] + s[n // 2]) // 2
    return s[n // 2]


def mad(values) -> int:
    """Median absolute deviation using the integer median above
    (reference: misc.rs:434-449)."""
    if len(values) == 0:
        return 0
    m = median(values)
    return median([abs(v - m) for v in values])


def format_duration(seconds: float) -> str:
    """H:MM:SS.microseconds — e.g. 0:00:01.234567 (reference: misc.rs:371-377)."""
    micros = int(round(seconds * 1_000_000))
    us = micros % 1_000_000
    s = micros // 1_000_000 % 60
    m = micros // 1_000_000 // 60 % 60
    h = micros // 1_000_000 // 60 // 60
    return f"{h}:{m:02}:{s:02}.{us:06}"


def usize_division_rounded(dividend: int, divisor: int) -> int:
    """Integer division rounded to nearest (reference: misc.rs:385-391)."""
    if divisor == 0:
        raise ZeroDivisionError("Attempt to divide by zero")
    return (dividend + divisor // 2) // divisor


def format_float(num: float) -> str:
    """Up to six decimals with trailing zeros dropped (reference: misc.rs:394-402)."""
    formatted = f"{num:.6f}"
    if "." not in formatted:
        return formatted
    formatted = formatted.rstrip("0").rstrip(".")
    return formatted if formatted else "0"


def format_float_sigfigs(value: float, sigfigs: int) -> str:
    """Format with a number of significant figures (reference: misc.rs:405-418)."""
    import math

    if value == 0.0:
        return f"{0.0:.{sigfigs - 1}f}"
    decimals = sigfigs - int(math.floor(math.log10(abs(value)))) - 1
    factor = 10.0 ** decimals
    rounded = round(value * factor) / factor
    if decimals > 0:
        return f"{rounded:.{decimals}f}"
    return format_float(rounded)


def sign_at_end(num: int) -> str:
    """42 -> '42+', -42 -> '42-' (reference: misc.rs:469-476)."""
    return f"{abs(num)}{'+' if num >= 0 else '-'}"


def sign_at_end_vec(nums) -> str:
    return ",".join(sign_at_end(n) for n in nums)


def reverse_signed_path(path) -> list:
    """Reverse a signed-int unitig path, flipping strands (misc.rs:464-466)."""
    return [-n for n in reversed(path)]


def up_to_first_space(string: str) -> str:
    parts = string.split()
    return parts[0] if parts else ""


def after_first_space(string: str) -> str:
    parts = string.split(None, 1)
    return parts[1] if len(parts) > 1 else ""


def check_threads(threads: int) -> None:
    """--threads range validation (reference main.rs:145-146)."""
    if not 1 <= threads <= 100:
        quit_with_error("--threads must be between 1 and 100 (inclusive)")


import threading as _threading

# serialises spinner redraws with log writes (see log.py)
spinner_lock = _threading.Lock()
CLEAR_LINE = "\r\x1b[2K"


class Spinner:
    """Terminal progress spinner (reference misc.rs:452-466: the dots3
    animation from cli-spinners, 100 ms steady tick, cleared when done).
    Animates only on an interactive stderr — hidden under tests, pipes and
    log capture, like indicatif's auto-hidden bars. Log writes clear the
    spinner line under a shared lock (log.py), so logging inside a spinner
    scope never garbles the terminal."""

    TICKS = "⠋⠙⠚⠞⠖⠦⠴⠲⠳⠓"

    def __init__(self, message: str):
        import sys
        self.message = message
        self._stop = None
        self._thread = None
        if not sys.stderr.isatty():
            return
        import threading

        self._stop = threading.Event()

        def tick():
            i = 0
            while not self._stop.wait(0.1):
                with spinner_lock:
                    sys.stderr.write(
                        f"{CLEAR_LINE}{self.TICKS[i % len(self.TICKS)]} "
                        f"{self.message}")
                    sys.stderr.flush()
                i += 1

        self._thread = threading.Thread(target=tick, daemon=True)
        self._thread.start()

    def finish(self) -> None:
        if self._thread is not None:
            import sys
            self._stop.set()
            self._thread.join()
            with spinner_lock:
                sys.stderr.write(CLEAR_LINE)
                sys.stderr.flush()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False
