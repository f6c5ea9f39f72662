"""The streamed grouping's failure kinds and the visible record of a path
that gave way to another, as the JAX package's utils/resilience.py words
them.

A spill that cannot be trusted raises :class:`SpillError`; the k-mer index
catches it (and ``OSError``), records the degrade, and groups in memory.
Each degrade prints one line to stderr,
``autocycler backend degrade: <chain>: <from> -> <to> (<reason>)``, once
per (chain, from, to) in a process.
"""

from __future__ import annotations

import sys
import threading
from typing import List, Optional

from .misc import AutocyclerError


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
