"""Batched multi-isolate steps over a mesh of torch devices.

Parity target: the JAX package's parallel/batch.py. For a batch of
isolates, each with several assemblies:

- the hashed k-mer bucket sketch of every assembly and the per-isolate
  asymmetric distance matrix (:func:`multi_isolate_distance_step`, and
  :func:`sharded_multi_isolate_step` with the batch over 'data' and the
  length over 'seq': shard i completes its boundary windows with the first
  k-1 codes of shard (i+1) mod n, copied over from that shard's device,
  and the sketches are combined by a max on the row's first device);
- the exact per-isolate contig intersection matrices that `batch` clusters
  from (:func:`batched_membership_intersections`): the unitig axis split
  over 'seq', one float64 ``torch.bmm`` per shard, the partial sums added
  on one device;
- trim's overlap DP with traceback for every job of every isolate
  (:func:`sharded_overlap_tracebacks`), the jobs split over every device.

All are torch ops on the mesh's devices; the CPU runs the same ops on CPU
tensors.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import dp_dispatch, resolve_device
from ..ops.align import overlap_tracebacks_batch
from ..ops.distance import EXACT_FLOAT64
from ..ops.encode import encode_bytes
from ..utils.resilience import InputError

DEFAULT_K = 51
DEFAULT_BUCKETS = 4096

# multipliers for the word-mixing hash (arbitrary odd constants)
_MIX = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0x9E3779B9)
_MASK32 = 0xFFFFFFFF


def encode_batch(seq_strings: List[List[str]], length: Optional[int] = None) -> np.ndarray:
    """[isolate][assembly] sequence strings -> [B, S, L] uint8 code batch,
    zero-padded (code 0 = '.', which never matches a real k-mer hash
    bucket-for-bucket since dot windows are masked out)."""
    if not seq_strings:
        raise InputError("encode_batch: no isolates to encode "
                         "(empty isolate list)")
    empties = [b for b, iso in enumerate(seq_strings) if not iso]
    if empties:
        raise InputError(f"encode_batch: isolate(s) at index "
                         f"{', '.join(map(str, empties))} have no assemblies")
    B = len(seq_strings)
    S = max(len(iso) for iso in seq_strings)
    if length is None:
        length = max(len(s) for iso in seq_strings for s in iso)
        if length == 0:
            raise InputError("encode_batch: all assembly sequences are empty")
    out = np.zeros((B, S, length), dtype=np.uint8)
    for b, iso in enumerate(seq_strings):
        for s, seq in enumerate(iso):
            raw = np.frombuffer(seq[:length].encode(), dtype=np.uint8)
            out[b, s, :len(raw)] = encode_bytes(raw)
    return out


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 ``x`` in [0, 2**32): torch has no CUDA
    uint32 multiply, and x * m itself may pass 2**63, so m is split into
    16-bit halves; each partial product stays below 2**48."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _kmer_bucket_sketch(codes: torch.Tensor, k: int, buckets: int) -> torch.Tensor:
    """[..., L] codes -> [..., buckets] float32 presence sketch.

    Every window of k codes is hashed by mixing ceil(k/10) packed 3-bit
    words (the JAX package's uint32 hash, in int64 masked to 32 bits after
    every shift, OR and multiply); windows containing padding (code 0) are
    masked out. Shard-local."""
    c = codes.to(torch.int64)
    lead = tuple(c.shape[:-1])
    n = c.shape[-1] - k + 1
    W = (k + 9) // 10
    valid = torch.ones(lead + (n,), dtype=torch.bool, device=c.device)
    h = torch.zeros(lead + (n,), dtype=torch.int64, device=c.device)
    for w in range(W):
        word = torch.zeros_like(h)
        for t in range(10):
            idx = w * 10 + t
            if idx >= k:
                break
            sym = c[..., idx:idx + n]
            valid &= sym > 0
            word = ((word << 3) & _MASK32) | sym
        h = h ^ _mul32(word, _MIX[w % len(_MIX)])
    rows = int(np.prod(lead)) if lead else 1
    bucket = (h % buckets).reshape(rows, n)
    flat = bucket + torch.arange(rows, device=c.device)[:, None] * buckets
    ones = valid.to(torch.float32).reshape(rows, n)
    presence = torch.zeros(rows * buckets, dtype=torch.float32, device=c.device)
    presence.scatter_reduce_(0, flat.reshape(-1), ones.reshape(-1), "amax")
    return presence.reshape(lead + (buckets,))


def _sketch_distances(presence: torch.Tensor) -> torch.Tensor:
    """[B, S, K] presence -> [B, S, S] float32 1 - |A∩B| / |A|. The float32
    product of 0/1 sketches is exact (counts below 2**24)."""
    inter = torch.matmul(presence, presence.transpose(-1, -2))
    own = torch.clamp_min(presence.sum(dim=-1), 1.0)
    return 1.0 - inter / own[..., :, None]


def multi_isolate_distance_step(codes, k: int = DEFAULT_K,
                                buckets: int = DEFAULT_BUCKETS,
                                device=None) -> np.ndarray:
    """Single-device step: [B, S, L] codes -> [B, S, S] float32 asymmetric
    contig distance sketch (1 - |A∩B| / |A| over hashed k-mer buckets).
    A tensor runs on its own device; a numpy array on ``device`` (CUDA
    unless the caller asks for the CPU).

    K-mers are taken circularly (the sequence wraps around), making the
    sketch rotation-invariant, and bit-matching the seq-sharded version,
    whose ring halo wraps the same way."""
    t = codes if isinstance(codes, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(codes)).to(resolve_device(device))
    B, S, L = t.shape
    with dp_dispatch("batch_sketch_step", t.device, isolates=B, contigs=S,
                     length=L, devices=1):
        t = torch.cat([t, t[..., :k - 1]], dim=-1)
        return _sketch_distances(_kmer_bucket_sketch(t, k, buckets)).cpu().numpy()


def sharded_multi_isolate_step(mesh, codes: np.ndarray, k: int = DEFAULT_K,
                               buckets: int = DEFAULT_BUCKETS) -> np.ndarray:
    """The mesh-sharded step: batch over 'data', length over 'seq'.

    codes: [B, S, L] with B divisible by the data-axis size and L divisible
    by the seq-axis size. With more than one seq shard, shard j appends the
    first k-1 codes of shard (j+1) mod n (the ring halo: the last shard
    wraps to the first, adding the end-to-start windows); with one, no
    halo is added, as in the JAX package. Each row of the mesh combines
    its seq shards' sketches by a max on its first device and computes its
    isolates' distances there. Returns [B, S, S] float32."""
    data, seq = mesh.shape
    B, S, L = codes.shape
    if B % data or L % seq:
        raise ValueError(f"codes {tuple(codes.shape)} do not divide over a "
                         f"({data} data, {seq} seq) mesh")
    b_per, l_per = B // data, L // seq
    t = torch.from_numpy(np.ascontiguousarray(codes))
    out = []
    with dp_dispatch("batch_sketch_step", mesh.devices[0, 0], isolates=B,
                     contigs=S, length=L, devices=mesh.size):
        for i in range(data):
            rows = t[i * b_per:(i + 1) * b_per]
            shards = [rows[..., j * l_per:(j + 1) * l_per].to(mesh.devices[i, j])
                      for j in range(seq)]
            home = mesh.devices[i, 0]
            presence = None
            for j, local in enumerate(shards):
                if seq > 1:
                    halo = shards[(j + 1) % seq][..., :k - 1].to(local.device)
                    local = torch.cat([local, halo], dim=-1)
                part = _kmer_bucket_sketch(local, k, buckets).to(home)
                presence = part if presence is None else \
                    torch.maximum(presence, part)
            out.append(_sketch_distances(presence).cpu())
    return torch.cat(out).numpy()


def _check_exact(weighted: np.ndarray) -> None:
    """The float64 contraction is exact while every partial sum is an
    integer below 2**53; a contig's weighted path length bounds them."""
    if weighted.size and int(weighted.sum(axis=-1).max()) >= EXACT_FLOAT64:
        raise ValueError("a contig's weighted path length reaches 2**53: the "
                         "float64 distance contraction would not be exact")


def batched_membership_intersections(mesh, M_list: List[np.ndarray],
                                     w_list: List[np.ndarray]) -> List[np.ndarray]:
    """Exact per-isolate contig intersection matrices, batched over the mesh.

    The semantics of ops.distance.intersections (reference
    cluster.rs:132-157: |A∩B| weighted by unitig length) for MANY isolates
    at once: isolates ride the 'data' axis, the unitig axis is split over
    'seq', each shard contracts its part as one float64 ``torch.bmm``, and
    the partial matrices are added on the row's first device. Every term
    and partial sum is an integer below 2**53, so each isolate's matrix is
    the single-isolate one exactly, in any order of summation. Every
    isolate stays on the device: the JAX package's int32 accumulation sends
    an isolate past it to an int64 host product, which f64 does not need.

    M_list[i]: [S_i, U_i] uint8 membership; w_list[i]: [U_i] int64 unitig
    lengths. Returns per-isolate [S_i, S_i] int64 intersection matrices."""
    data, seq = mesh.shape
    B = len(M_list)
    if B == 0:
        return []
    S = max(m.shape[0] for m in M_list)
    U = max(m.shape[1] for m in M_list)
    U = -(-U // seq) * seq                    # pad unitig axis to seq shards
    Bp = -(-B // data) * data                 # pad batch to data shards
    Mw = np.zeros((Bp, S, U), dtype=np.float64)
    M = np.zeros((Bp, S, U), dtype=np.float64)
    for i, (m, w) in enumerate(zip(M_list, w_list)):
        s, u = m.shape
        weighted = m.astype(np.int64) * w[None, :]
        _check_exact(weighted)
        M[i, :s, :u] = m
        Mw[i, :s, :u] = weighted
    b_per, u_per = Bp // data, U // seq
    parts = []
    with dp_dispatch("batch_membership_contraction", mesh.devices[0, 0],
                     isolates=B, contigs=S, unitigs=U, devices=mesh.size):
        for i in range(data):
            home = mesh.devices[i, 0]
            acc = None
            for j in range(seq):
                dev = mesh.devices[i, j]
                rows, cols = slice(i * b_per, (i + 1) * b_per), \
                    slice(j * u_per, (j + 1) * u_per)
                a = torch.from_numpy(np.ascontiguousarray(Mw[rows, :, cols])).to(dev)
                b = torch.from_numpy(np.ascontiguousarray(M[rows, :, cols])).to(dev)
                part = torch.bmm(a, b.transpose(1, 2)).to(home)
                acc = part if acc is None else acc + part
            parts.append(acc.cpu())
        inter = torch.cat(parts).numpy().astype(np.int64)
    return [inter[i, :m.shape[0], :m.shape[0]] for i, m in enumerate(M_list)]


def sharded_overlap_tracebacks(mesh, jobs, max_unitigs: int,
                               min_identity: float) -> List[list]:
    """Trim's overlap DP with packed traceback for ``jobs`` over EVERY
    device of the mesh: the jobs are split into contiguous chunks over the
    flattened ('data', 'seq') devices, each chunk runs through
    ops.align.overlap_tracebacks_batch on its device (which splits a chunk
    further so that one dispatch's bits stay under its byte budget), and
    the decoded pieces come back in job order. Each job's result depends
    only on that job, so the split changes no byte."""
    devices = mesh.flat()
    per = -(-len(jobs) // len(devices)) if jobs else 0
    out: List[list] = []
    for i, dev in enumerate(devices):
        chunk = jobs[i * per:(i + 1) * per]
        if chunk:
            out.extend(overlap_tracebacks_batch(chunk, max_unitigs,
                                                min_identity, dev))
    return out
