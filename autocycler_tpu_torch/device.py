"""Device resolution and the per-kernel launch counters.

Entry points run on CUDA unless the caller asks for the CPU (the tests do).
There is no fallback: a request for CUDA on a machine without a card is an
error, never a silent CPU run.

Every hand-written kernel's wrapper calls :func:`record_launch` once per
launch of its kernel, with CUDA events around the launch, so a run can show
that its main path went through the kernels and how long they took.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .utils import quit_with_error

# kernel name -> launches since the last reset_counts()
launches: Dict[str, int] = {"sortnet_pack_rank": 0}
_events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {
    name: [] for name in launches}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises AutocyclerError when CUDA is asked for and
    absent, or for a device type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            quit_with_error("no CUDA device is available; the port runs its "
                            "device path on an NVIDIA GPU")
    elif dev.type != "cpu":
        quit_with_error(f"unsupported device {dev}: use cuda or cpu")
    return dev


def record_launch(name: str, start: torch.cuda.Event,
                  end: torch.cuda.Event) -> None:
    launches[name] += 1
    _events[name].append((start, end))


def reset_counts() -> None:
    for name in launches:
        launches[name] = 0
        _events[name].clear()


def kernel_ms(name: str) -> float:
    """Summed device time of the kernel's launches since the last reset,
    from their CUDA events (synchronises)."""
    if not _events[name]:
        return 0.0
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in _events[name])
