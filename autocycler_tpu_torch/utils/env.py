"""Environment knobs, read as the JAX package reads them: an unset or blank
variable gives the default, a malformed integer gives the default with one
warning on stderr, and 0/false/no/off (any case) is a false boolean."""

from __future__ import annotations

import os
import sys

_FALSE_VALUES = ("0", "false", "no", "off")
_warned = set()


def env_str(name: str, default: str) -> str:
    raw = os.environ.get(name)
    return default if raw is None or not raw.strip() else raw.strip()


def env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in _FALSE_VALUES


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw.strip())
    except ValueError:
        if name not in _warned:
            _warned.add(name)
            print(f"Warning: ignoring malformed int value {raw!r} for {name}; "
                  f"using default {default!r}", file=sys.stderr)
        return default
