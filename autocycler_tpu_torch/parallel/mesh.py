"""The device mesh of batched multi-isolate runs: one process holding a
2-D grid of torch devices.

The JAX package runs one controller process over its mesh, with XLA's
collectives between devices. The port keeps that shape: one process, a
(data, seq) grid of explicit ``torch.device``s, and each collective an
explicit copy (``Tensor.to``) between them; no ``torch.distributed``.

- axis ``data``: independent isolates (pure data parallelism, no
  cross-isolate communication);
- axis ``seq``: sequence length within an isolate (the k-mer windows that
  cross a shard boundary are completed by a ring halo, see
  parallel.batch).

A device list may repeat a device (``[cuda:0] * 4``, ``[cpu] * 8``), so a
one-card machine and the CPU run every shard of a larger mesh, with the
same results as distinct cards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def mesh_axis_sizes(n_devices: int, seq_parallel: Optional[int] = None) -> Tuple[int, int]:
    """Factorise a device count into (data, seq) axis sizes. Sequence
    parallelism defaults to 2 when the device count is even (halo exchange
    is cheap on ICI), otherwise 1."""
    if seq_parallel is None:
        seq_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if n_devices % seq_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by seq={seq_parallel}")
    return n_devices // seq_parallel, seq_parallel


class Mesh:
    """A (data, seq) grid of torch devices: ``devices`` is a 2-D object
    array, ``devices[i, j]`` the device of data shard i, seq shard j."""

    axis_names = ("data", "seq")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Tuple[int, int]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    def flat(self) -> List[torch.device]:
        """Every device, data-major (the flattened ('data', 'seq') axis)."""
        return list(self.devices.ravel())


def _device_list(n_devices: Optional[int], devices: Optional[Sequence]
                 ) -> List[torch.device]:
    """``devices`` as torch devices, else every CUDA device, listed after
    the device probe's consult (a probe that timed out or failed ends the
    run with ``Error:`` before any CUDA call, as the JAX package's mesh
    refuses to block on a wedged device); the first ``n_devices`` of
    them. Refuses to shrink: a request for more devices than there are
    raises."""
    if devices is None:
        from ..device import consult_probe
        consult_probe()
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devices)} "
                "device(s) are available; refusing to silently shrink the mesh "
                "(a 1-device mesh would 'pass' without exercising any collective)")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("no device for the mesh: no CUDA device is "
                         "available and none was given")
    return devices


def _grid(devices: List[torch.device], data: int, seq: int) -> np.ndarray:
    grid = np.empty((data, seq), dtype=object)
    for i, d in enumerate(devices):
        grid[i // seq, i % seq] = d
    return grid


def make_mesh(n_devices: Optional[int] = None,
              seq_parallel: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ('data', 'seq') mesh over ``devices`` (default: cuda:0 …
    cuda:{device_count-1}), data-major."""
    devices = _device_list(n_devices, devices)
    data, seq = mesh_axis_sizes(len(devices), seq_parallel)
    return Mesh(_grid(devices, data, seq))


def make_multihost_mesh(n_devices: Optional[int] = None,
                        n_hosts: int = 2,
                        seq_parallel: Optional[int] = None,
                        devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'seq') mesh laid out for a multi-host topology, with the
    JAX package's layout rule: the only collectives are over 'seq', so a
    'seq' group must never straddle a host boundary, while 'data' (no
    collectives) may span hosts. Devices are taken host-major and every
    'seq' row lives inside one host. In one process every device is host 0,
    as on the JAX package's single-process mesh, so what this checks is the
    layout math: the divisibility of devices by hosts and of a host's
    devices by the seq axis."""
    devices = _device_list(n_devices, devices)
    n = len(devices)
    if n % n_hosts != 0:
        raise ValueError(f"{n} devices not divisible by {n_hosts} hosts")
    per_host = n // n_hosts
    data, seq = mesh_axis_sizes(n, seq_parallel)
    if per_host % seq != 0:
        raise ValueError(
            f"seq={seq} does not fit within one host's {per_host} devices; "
            "the seq axis (ICI collectives) must not straddle hosts")
    grid = _grid(devices, data, seq)
    for row in grid:
        hosts = {getattr(d, "process_index", 0) for d in row}
        if len(hosts) > 1:
            raise ValueError(
                f"seq group {list(row)} spans processes {sorted(hosts)}; "
                "ICI collectives would ride DCN")
    return Mesh(grid)


def shard_leading_axis(replicated: torch.Tensor, *sharded: torch.Tensor,
                       devices: Sequence[torch.device]):
    """Lay bucket-stacked tensors across ``devices``, as the JAX package's
    radix-sharded grouping lays them across its mesh: each ``sharded``
    tensor's leading axis (one row per radix bucket) splits into
    contiguous blocks, block i on ``devices[i]``, and ``replicated`` (the
    codes every bucket gathers from) is copied once to each distinct
    device. Returns ``(replicas, *blocks)``, each a list with one tensor
    per entry of ``devices`` (a repeated device shares one replica).

    Raises where the JAX version degrades to unsharded: no device, or a
    leading axis that does not divide the device count. Every device gets
    its rows, or the copy raises."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("shard_leading_axis: no device")
    n = len(devices)
    rows = sharded[0].shape[0] if sharded else 0
    if any(a.shape[0] != rows for a in sharded) or rows % n:
        raise ValueError(f"shard_leading_axis: {rows} rows do not split "
                         f"over {n} devices")
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = replicated.to(dev)
    per = rows // n
    return ([copies[dev] for dev in devices],
            *([a[i * per:(i + 1) * per].to(dev)
               for i, dev in enumerate(devices)] for a in sharded))


def place_leading_axis(array, devices: Sequence[torch.device]
                       ) -> List[torch.Tensor]:
    """Split ``array``'s leading axis into contiguous chunks, one per
    device, after zero-padding it to a multiple of the device count:
    returns each chunk on its device, in order. It never degrades: every
    device gets its chunk, or the copy raises."""
    t = torch.as_tensor(array)
    n = len(devices)
    if n == 0:
        raise ValueError("place_leading_axis: no device")
    rows = t.shape[0]
    padded = -(-rows // n) * n
    if padded != rows:
        t = torch.cat([t, t.new_zeros((padded - rows,) + tuple(t.shape[1:]))])
    per = padded // n
    return [t[i * per:(i + 1) * per].to(dev) for i, dev in enumerate(devices)]
