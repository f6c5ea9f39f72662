"""Fleet planning + bucketed device shapes for multi-isolate batch runs.

Parity target: the JAX package's parallel/fleet.py. The fleet runner
(commands/batch.py ``--fleet``) packs isolates into *shards* sized to the
device count; each shard's exact membership contraction is one dispatch
with the isolate axis split over the devices, and the host load of
upcoming isolates overlaps the current shard's device work.

- **Bucketed packing** (:func:`plan_fleet`): isolates are sorted by input
  cost, the order is split into a few contiguous size buckets, and shards
  form *within* a bucket, so a 6 Mbp isolate pads no shard of the lower
  buckets (KMC 2's fixed-size-bin idea, arXiv:1407.1507).
- **Bucketed device shapes** (:func:`bucket_dim` +
  :func:`fleet_membership_intersections`): each shard's [B, S, U]
  membership tensors are padded up a power-of-two ladder, as in the JAX
  package, so ``autocycler_fleet_pad_ratio`` reads what the JAX package's
  reads.

The contraction is a float64 ``torch.bmm`` (exact below 2**53, like the
single-isolate one in ops/distance.py), so every isolate's matrix is the
serial batch's bit for bit, and no isolate goes to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import dp_dispatch, resolve_device
from ..obs import metrics_registry
from ..utils.knobs import knob_int, knob_str
from ..utils.resilience import InputError
from .batch import _check_exact
from .mesh import place_leading_axis

# registry metric names, the JAX package's
FLEET_SHARDS_TOTAL = "autocycler_fleet_shards_total"
FLEET_ISOLATES_TOTAL = "autocycler_fleet_isolates_total"
FLEET_PAD_RATIO = "autocycler_fleet_pad_ratio"
FLEET_SHAPE_BUCKETS = "autocycler_fleet_shape_buckets"

# padding ladder floors: shapes below these round up to the floor, so tiny
# isolates share one shape instead of one per contig count
_PAD_FLOOR_S = 8
_PAD_FLOOR_U = 64

FLEET_MODES = ("off", "on", "auto")


def resolve_fleet_mode(cli_value: Optional[str] = None) -> str:
    """The effective fleet mode: the CLI --fleet flag when given, else the
    ``AUTOCYCLER_FLEET_MODE`` knob. Unknown values are an input error (the
    CLI argparse choices catch them first; this guards the knob path)."""
    mode = (cli_value or knob_str("AUTOCYCLER_FLEET_MODE") or "off")
    mode = mode.strip().lower()
    if mode not in FLEET_MODES:
        raise InputError(f"unknown fleet mode {mode!r} "
                         f"(choose from {', '.join(FLEET_MODES)})")
    return mode


def fleet_devices(device=None) -> int:
    """How many devices the fleet planner shards for:
    ``AUTOCYCLER_FLEET_DEVICES`` when > 0, else one for a run the caller
    put on the CPU, else ``torch.cuda.device_count()``."""
    forced = knob_int("AUTOCYCLER_FLEET_DEVICES")
    if forced > 0:
        return forced
    if device is not None and torch.device(device).type == "cpu":
        return 1
    return torch.cuda.device_count()


def fleet_device_list(n_devices: int, device=None) -> List[torch.device]:
    """The devices a shard's isolate axis is split over: cuda:0 … in turn
    for a CUDA run without an index (a forced count above the cards
    repeats them), else ``device`` n times."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [torch.device(f"cuda:{i % count}") for i in range(n_devices)]
    return [dev] * n_devices


def fleet_engaged(mode: str, n_isolates: int, device=None) -> bool:
    """Whether the fleet path runs: 'on' engages for any multi-isolate
    batch, 'auto' additionally requires >1 device (a one-device fleet only
    buys the prefetch overlap). A single isolate ALWAYS takes the serial
    path — there is nothing to pack, and bit-for-bit equivalence with the
    serial batch is then true by construction."""
    if n_isolates <= 1:
        return False
    if mode == "on":
        return True
    if mode == "auto":
        return fleet_devices(device) > 1
    return False


def isolate_cost(asm_dir) -> int:
    """The planner's cost proxy for one isolate: total bytes of its
    assembly files. Never raises — an unreadable dir costs 0 and fails
    later inside the per-isolate quarantine, where it is recorded."""
    from ..utils.io import _ASSEMBLY_EXTS

    total = 0
    try:
        for p in Path(asm_dir).iterdir():
            if p.is_file() and p.name.lower().endswith(_ASSEMBLY_EXTS):
                try:
                    total += p.stat().st_size
                except OSError:
                    continue
    except OSError:
        return 0
    return total


@dataclass(frozen=True)
class FleetShard:
    """One device dispatch's worth of isolates (≤ shard_size names, all
    from the same size bucket)."""
    index: int
    bucket: int
    names: Tuple[str, ...]


@dataclass
class FleetPlan:
    shards: List[FleetShard]
    shard_size: int
    n_buckets: int


def plan_fleet(costs: Dict[str, int], shard_size: int,
               n_buckets: int) -> FleetPlan:
    """Pack isolates into bucketed shards.

    Isolates are ordered by descending cost (name-tiebroken, so the plan
    is deterministic), the order is split into ``n_buckets`` contiguous
    near-equal-count groups (rank quantiles), and each group is chunked
    into shards of ``shard_size``. One 6 Mbp isolate among 50 kb ones lands
    in the top bucket, first, so only the top bucket's shards can pay its
    padding."""
    shard_size = max(1, int(shard_size))
    names = sorted(costs, key=lambda n: (-costs[n], n))
    n_buckets = max(1, min(int(n_buckets), len(names) or 1))
    bounds = np.linspace(0, len(names), n_buckets + 1).astype(int)
    shards: List[FleetShard] = []
    for b in range(n_buckets):
        group = names[bounds[b]:bounds[b + 1]]
        for i in range(0, len(group), shard_size):
            chunk = tuple(group[i:i + shard_size])
            if chunk:
                shards.append(FleetShard(len(shards), b, chunk))
    return FleetPlan(shards=shards, shard_size=shard_size,
                     n_buckets=n_buckets)


def bucket_dim(n: int, floor: int) -> int:
    """Round a dimension up the padding ladder: the smallest power-of-two
    multiple of ``floor`` that holds ``n``."""
    v = max(1, int(floor))
    n = max(1, int(n))
    while v < n:
        v <<= 1
    return v


def fleet_membership_intersections(M_list: List[np.ndarray],
                                   w_list: List[np.ndarray],
                                   devices: Optional[int] = None,
                                   device=None) -> List[np.ndarray]:
    """Exact per-isolate contig intersection matrices for one fleet shard.

    The contract of parallel.batch.batched_membership_intersections
    (per-isolate [S_i, S_i] int64 matrices), laid out for the fleet: the
    [B, S, U] tensors are padded up the bucket ladder (S, U) and to a
    multiple of ``devices`` (B, default :func:`fleet_devices`), the isolate
    axis is split into contiguous chunks over :func:`fleet_device_list`
    (on ``device``, CUDA unless the caller asks for the CPU), and each
    chunk contracts as one float64 ``torch.bmm``."""
    B = len(M_list)
    if B == 0:
        return []
    n_dev = int(devices) if devices else fleet_devices(device)
    S = bucket_dim(max(m.shape[0] for m in M_list), _PAD_FLOOR_S)
    U = bucket_dim(max(m.shape[1] for m in M_list), _PAD_FLOOR_U)
    Bp = -(-B // n_dev) * n_dev
    Mw = np.zeros((Bp, S, U), dtype=np.float64)
    Mp = np.zeros((Bp, S, U), dtype=np.float64)
    for i, (m, w) in enumerate(zip(M_list, w_list)):
        s, u = m.shape
        weighted = m.astype(np.int64) * w[None, :]
        _check_exact(weighted)
        Mp[i, :s, :u] = m
        Mw[i, :s, :u] = weighted
    real = sum(m.shape[0] * m.shape[1] for m in M_list)
    metrics_registry.gauge_set(
        FLEET_PAD_RATIO, round(Bp * S * U / max(1, real), 3),
        help="padded/real element ratio of the last fleet contraction")
    devs = fleet_device_list(n_dev, device)
    with dp_dispatch("fleet_membership_contraction", devs[0], isolates=B,
                     contigs=S, unitigs=U, devices=n_dev):
        chunks = [torch.bmm(a, b.transpose(1, 2)).cpu()
                  for a, b in zip(place_leading_axis(Mw, devs),
                                  place_leading_axis(Mp, devs))]
        inter = torch.cat(chunks).numpy().astype(np.int64)
    return [inter[i, :m.shape[0], :m.shape[0]]
            for i, m in enumerate(M_list)]


def record_shard_metrics(n_isolates: int, bucket: int) -> None:
    """Per-shard counters of the obs registry."""
    metrics_registry.counter_inc(
        FLEET_SHARDS_TOTAL, 1,
        help="fleet shards dispatched", bucket=str(bucket))
    metrics_registry.counter_inc(
        FLEET_ISOLATES_TOTAL, n_isolates,
        help="isolates processed through the fleet runner")
