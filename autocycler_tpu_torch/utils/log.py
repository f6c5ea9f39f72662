"""stderr logging: timestamped section headers and dimmed explanations.

Parity target: reference log.rs:18-44 (bold/underline headers with timestamp,
wrapped dim explanation text). Colour control follows the informal standard:
suppressed when stderr is not a TTY, force-disabled by a non-empty
``NO_COLOR`` (https://no-color.org/), force-enabled by a non-empty
``FORCE_COLOR`` (NO_COLOR wins when both are set).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys
import textwrap

BOLD = "\033[1m"
UNDERLINE = "\033[4m"
DIM = "\033[2m"
RESET = "\033[0m"


def _colour_enabled() -> bool:
    if os.environ.get("NO_COLOR"):       # the no-color.org contract: any
        return False                     # non-empty value disables colour
    if os.environ.get("FORCE_COLOR"):
        return True
    return sys.stderr.isatty()


@contextlib.contextmanager
def _spinner_guard():
    """Clears any active Spinner line and holds its redraw lock, so log
    output never interleaves with a spinner tick (utils.misc.Spinner)."""
    from .misc import CLEAR_LINE, spinner_lock
    with spinner_lock:
        if sys.stderr.isatty():
            sys.stderr.write(CLEAR_LINE)
        yield


def section_header(text: str) -> None:
    timestamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    with _spinner_guard():
        if _colour_enabled():
            print(f"{DIM}{timestamp}{RESET}  {BOLD}{UNDERLINE}{text}{RESET}",
                  file=sys.stderr)
        else:
            print(f"{timestamp}  {text}", file=sys.stderr)


def explanation(text: str) -> None:
    wrapped = textwrap.fill(" ".join(text.split()), width=80)
    with _spinner_guard():
        if _colour_enabled():
            print(f"{DIM}{wrapped}{RESET}", file=sys.stderr)
        else:
            print(wrapped, file=sys.stderr)
        print(file=sys.stderr)


def message(text: str = "") -> None:
    with _spinner_guard():
        print(text, file=sys.stderr)
