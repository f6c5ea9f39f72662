"""Minimizer-sketch contig distances: bottom-s MinHash over windowed
minimizers, compared as one intersection grid on the device.

Parity target: the JAX package's ops/sketch.py, sketch for sketch and count
for count. The exact distances (ops.distance) scale with the unitig count;
a sketch reduces every contig to a fixed-size vector:

1. k-mers are taken over the 5-symbol code space (ops.encode, ``.ACGT`` →
   0..4) and base-5 packed into uint64 (exact for k ≤ 27), so no window
   holding a dot ever contributes;
2. each packed k-mer is mixed with splitmix64 and folded to uint32, and
   canonicalised as min(forward hash, aligned reverse-complement hash), so
   a contig and its reverse complement sketch identically;
3. a sliding window of ``w`` k-mer positions keeps each window's minimum
   (the minimizers), and the sorted distinct minimizers are cut to their
   ``s`` smallest (bottom-s), which makes a sketch at s' < s the first s'
   entries of the sketch at s.

The hashing runs as torch ops on the device (CUDA unless the caller asks
for the CPU): the uint64 arithmetic of the JAX package's numpy hashing runs
in int64, whose adds and multiplies wrap alike, with each logical right
shift masked, so every hash equals the JAX package's bit for bit. The
sketches stack into an ``(n_contigs, s)`` matrix of ascending rows padded with
:data:`SENTINEL`; the pairwise intersection counts are a batched
``torch.searchsorted`` of every row in every other on the device, and the
one float expression that turns counts into distances runs in numpy, so the
distances are bit-identical to the JAX package's. The distance is
asymmetric containment, ``d[a, b] = 1 - |sketch(a) ∩ sketch(b)| /
|sketch(a)|``, an estimate of the exact path's unitig-length containment.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import dp_dispatch, resolve_device
from ..utils.cache import content_hash
from ..utils.env import env_int
from .encode import encode_both_strands

# uint32 max is the pad value: a real hash equal to it is dropped while
# sketching, so a pad cell never matches a query
SENTINEL = np.uint32(0xFFFFFFFF)

MAX_K = 27      # 5**27 < 2**63: base-5 pack of a k-mer fits uint64 exactly

# the grid's targets go in chunks whose (chunk, n, s) int64 index tensor
# stays under this many bytes
GRID_CHUNK_BYTES = 1 << 30

# splitmix64's uint64 constants as the int64 values of the same bits: the
# hashing runs in int64, whose adds and multiplies wrap as uint64's do
_U64 = 1 << 64
_SPLITMIX_GAMMA = 0x9E3779B97F4A7C15 - _U64
_SPLITMIX_M1 = 0xBF58476D1CE4E5B9 - _U64
_SPLITMIX_M2 = 0x94D049BB133111EB - _U64


def sketch_params() -> Tuple[int, int, int]:
    """(k, w, s) from AUTOCYCLER_SKETCH_K, _W and _S (defaults 21, 11 and
    1024), with k clamped to [4, MAX_K] so the base-5 pack stays exact, and
    w and s to at least 1."""
    k = min(max(env_int("AUTOCYCLER_SKETCH_K"), 4), MAX_K)
    w = max(env_int("AUTOCYCLER_SKETCH_W"), 1)
    s = max(env_int("AUTOCYCLER_SKETCH_S"), 1)
    return k, w, s


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the 64 bits of an int64 tensor: torch's ``>>``
    is arithmetic, so the sign bits it brings in are masked off."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finaliser over int64 holding uint64 bits."""
    z = x + _SPLITMIX_GAMMA
    z = (z ^ _shr(z, 30)) * _SPLITMIX_M1
    z = (z ^ _shr(z, 27)) * _SPLITMIX_M2
    return z ^ _shr(z, 31)


def _pack_poly(codes: torch.Tensor, k: int,
               reverse: bool = False) -> torch.Tensor:
    """Base-5 pack (int64) of every k-mer of one code strand, in O(log k)
    tensor passes.

    ``reverse=False``: P[i] = sum_j codes[i+j] * 5**(k-1-j), the
    left-to-right pack. ``reverse=True``: R[i] = sum_j codes[i+j] * 5**j,
    the mirrored polynomial, which over complemented codes is the pack of
    the reverse-complement k-mer aligned to the forward position.

    Square-and-multiply over the concatenation monoid
    ``concat(A_a, B_b)[i] = A[i] * 5**b + B[i+a]`` (the coefficients swap
    sides when reversed); values stay below 5**MAX_K < 2**63, so int64
    arithmetic is exact."""
    base = codes.to(torch.int64)

    def _concat(A, a, B, b):
        m = A.shape[0] - b
        if reverse:
            return A[:m] + B[a:a + m] * 5 ** a
        return A[:m] * 5 ** b + B[a:a + m]

    acc, acc_len = None, 0
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = _concat(acc, acc_len, acc, acc_len)
            acc_len *= 2
        if bit == "1":
            if acc is None:
                acc, acc_len = base, 1
            else:
                acc = _concat(acc, acc_len, base, 1)
                acc_len += 1
    return acc


def _kmer_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The uint32 mixed hash of every k-mer start position of one code
    strand: the high 32 bits of splitmix64, kept in int64 so that
    comparisons and ``%`` keep the unsigned order."""
    return _shr(_splitmix64(_pack_poly(codes, k)), 32)


def _window_minima(vals: torch.Tensor, w: int) -> torch.Tensor:
    """Minimum over every window of ``w`` consecutive positions, in O(log w)
    tensor passes (``concat(A_a, B_b)[i] = min(A[i], B[i+a])`` is
    associative, as in _pack_poly)."""

    def _concat(A, a, B, b):
        m = A.shape[0] - b
        return torch.minimum(A[:m], B[a:a + m])

    acc, acc_len = None, 0
    for bit in bin(w)[2:]:
        if acc is not None:
            acc = _concat(acc, acc_len, acc, acc_len)
            acc_len *= 2
        if bit == "1":
            if acc is None:
                acc, acc_len = vals, 1
            else:
                acc = _concat(acc, acc_len, vals, 1)
                acc_len += 1
    return acc


def sketch_from_codes(fwd: torch.Tensor, rc: torch.Tensor, k: int, w: int,
                      s: int) -> Tuple[torch.Tensor, int]:
    """Bottom-s minimizer sketch of one contig from its code-space strands
    (forward, reverse complement, as ``Sequence.encoded_strands()`` gives
    them), as torch ops on the strands' device.

    Returns ``(sketch, m)``: a length-``s`` int64 tensor of uint32 values on
    that device, sorted ascending and padded with :data:`SENTINEL`, and the
    count ``m`` of real values.
    """
    n = fwd.shape[0]
    dev = fwd.device
    sketch = torch.full((s,), int(SENTINEL), dtype=torch.int64, device=dev)
    if n < k + w - 1:
        return sketch, 0
    hf = _kmer_hashes(fwd, k)
    # the rc k-mer at rc-position (n - k - i) is the reverse complement of
    # the fwd k-mer at i; its pack is the mirrored polynomial over the
    # complement strand at i, and rc reversed is that strand
    hr = _shr(_splitmix64(_pack_poly(torch.flip(rc, (0,)), k,
                                     reverse=True)), 32)
    canon = torch.minimum(hf, hr)
    # a window holding a dot (pad or separator, code 0) never contributes
    zeros = torch.nn.functional.pad(torch.cumsum(fwd == 0, 0), (1, 0))
    dotted = (zeros[k:] - zeros[:-k]) > 0
    canon.masked_fill_(dotted, int(SENTINEL))
    minima = _window_minima(canon, w)
    # collapsing runs of equal minima first shrinks the sort without
    # changing the set of values
    if minima.numel() > 1:
        keep = torch.nn.functional.pad(minima[1:] != minima[:-1], (1, 0),
                                       value=True)
        minima = minima[keep]
    minimizers = torch.unique(minima)
    minimizers = minimizers[minimizers != int(SENTINEL)][:s]
    m = int(minimizers.numel())
    sketch[:m] = minimizers
    return sketch, m


def _contig_forward_bytes(seq, recon) -> np.ndarray:
    """A contig's forward ASCII bytes: its strand where it holds one, else
    the bytes rebuilt from the graph (a GFA-loaded sequence has none)."""
    if seq.forward_seq.size:
        return seq.forward_seq
    return recon[seq.id]


def sketch_matrix(graph, sequences,
                  params: Optional[Tuple[int, int, int]] = None,
                  device=None, cache=None
                  ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """The stacked ``(n_contigs, s)`` uint32 sketch matrix, the count of
    real values in each row (int64) and the sequence ids, in ``sequences``
    order. Contigs loaded from a GFA are rebuilt from their graph paths and
    encoded on the host; each contig's strands are then hashed on ``device``
    (CUDA unless the caller asks for the CPU), and the matrix comes back in
    one copy.

    ``cache`` (a utils.cache.EncodeCache or None) keeps each contig's
    sketch under the sha256 of its forward bytes plus (k, w, s), as the JAX
    package's does: a hit skips the contig's hashing, and any byte or
    parameter change misses."""
    k, w, s = params if params is not None else sketch_params()
    dev = resolve_device(device)
    missing = [q.id for q in sequences if not q.forward_seq.size]
    recon = graph.get_sequences_for_ids(missing) if missing else {}
    rows = torch.empty((len(sequences), s), dtype=torch.int64, device=dev)
    valid = np.zeros(len(sequences), np.int64)
    ids: List[int] = []
    missed = {}          # row -> content key, for the rows to store
    for i, seq in enumerate(sequences):
        ids.append(seq.id)
        if cache is not None:
            key = content_hash(_contig_forward_bytes(seq, recon).tobytes())
            hit = cache.load_sketch(key, k, w, s)
            if hit is not None:
                rows[i] = torch.from_numpy(hit[0].astype(np.int64))
                valid[i] = hit[1]
                continue
            missed[i] = key
        if seq.forward_seq.size:
            fwd, rc = seq.encoded_strands()
        else:
            fwd, rc = encode_both_strands(_contig_forward_bytes(seq, recon))
        rows[i], valid[i] = sketch_from_codes(
            torch.from_numpy(np.ascontiguousarray(fwd)).to(dev),
            torch.from_numpy(np.ascontiguousarray(rc)).to(dev), k, w, s)
    S = rows.cpu().numpy().astype(np.uint32)
    if missed:
        cache.store_sketches(k, w, s, [(key, S[i], int(valid[i]))
                                       for i, key in missed.items()])
    return S, valid, ids


def sketch_intersections_host(S: np.ndarray) -> np.ndarray:
    """Pairwise intersection counts on the host, the grid's plain version
    by another algorithm: every value becomes a token (one np.unique), each
    target row's tokens are set in a lookup table, and every row is one
    gather from it."""
    n, s = S.shape
    real = S != SENTINEL
    uniq, tok = np.unique(S, return_inverse=True)
    T = tok.reshape(n, s)
    out = np.empty((n, n), np.int64)
    lut = np.zeros(uniq.size, bool)
    for b in range(n):
        tb = T[b][real[b]]
        lut[tb] = True
        out[:, b] = np.count_nonzero(lut[T] & real, axis=1)
        lut[tb] = False
    return out


def sketch_intersections(S: np.ndarray, device=None) -> np.ndarray:
    """The ``(n, n)`` int64 grid ``inter[a, b]``: how many real values of
    row a occur in row b, as torch ops on ``device`` (CUDA unless the caller
    asks for the CPU). Every query row is looked up in each target row by
    ``torch.searchsorted``, the index clamped to the last cell as the JAX
    grid clamps it, the target gathered there and compared; a pad query
    never counts, and a query above every real value of the target lands
    on a pad or a smaller value and does not match. The rows are widened
    to int64 (torch's searchsorted and comparisons on CUDA want a signed
    type); the sentinel, 4294967295, still sorts last."""
    dev = resolve_device(device)
    n, s = S.shape
    rows = torch.from_numpy(S.astype(np.int64)).to(dev)
    flat = rows.reshape(1, n * s)
    real = (flat != int(SENTINEL)).reshape(1, n, s)
    inter = torch.empty((n, n), dtype=torch.int64, device=dev)
    chunk = max(1, GRID_CHUNK_BYTES // max(1, 8 * n * s))
    with dp_dispatch("cluster_sketch_grid", dev, n=n, s=s, lookups=n * n * s):
        for b0 in range(0, n, chunk):
            targets = rows[b0:b0 + chunk]
            c = targets.shape[0]
            idx = torch.searchsorted(targets, flat.expand(c, n * s).contiguous())
            idx.clamp_(max=s - 1)
            hit = (torch.gather(targets, 1, idx) == flat).reshape(c, n, s)
            inter[:, b0:b0 + c] = (hit & real).sum(dim=2).T
    return inter.cpu().numpy()


def _containment_to_matrix(inter: np.ndarray, valid: np.ndarray
                           ) -> np.ndarray:
    """Integer intersection counts → asymmetric distance matrix, the JAX
    package's float expression. A row with an empty sketch (a contig
    shorter than k + w - 1) is at distance 1 from everything and 0 from
    itself."""
    a_len = valid.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        D = 1.0 - inter / a_len[:, None]
    empty = valid == 0
    if empty.any():
        D[empty, :] = 1.0
        idx = np.flatnonzero(empty)
        D[idx, idx] = 0.0
    return D


def sketch_distance_matrix(S: np.ndarray, valid: np.ndarray,
                           device=None) -> np.ndarray:
    """D[a, b] = 1 - inter(a, b) / |sketch(a)|, the grid on ``device``."""
    return _containment_to_matrix(sketch_intersections(S, device), valid)


def sketch_contig_distances(graph, sequences, device=None, cache=None
                            ) -> Dict[Tuple[int, int], float]:
    """Sketch distances keyed by (seq_a.id, seq_b.id), shaped as
    ops.distance.pairwise_contig_distances' dict; ``cache`` as
    :func:`sketch_matrix` takes it."""
    S, valid, ids = sketch_matrix(graph, sequences, device=device,
                                  cache=cache)
    D = sketch_distance_matrix(S, valid, device)
    return {(ids[a], ids[b]): float(D[a, b])
            for a in range(len(ids)) for b in range(len(ids))}
