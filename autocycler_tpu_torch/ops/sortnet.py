"""Pack + rank of k-windows: the bitonic sort-network kernel and its plain
version.

:func:`pack_rank` is the port of the JAX package's sort-network grouping
(ops/sortnet.py:_local_stages_kernel driven by run_network, reached through
ops/kmers.py:_pallas_rank_fn). For a CUDA tensor it launches the hand-written
kernel in csrc/sortnet.cu, which packs every window into base-5 int32 words
and sorts (words..., index) records through a bitonic network; the group ids
then come from adjacent differences of the sorted words. For a CPU tensor it
runs :func:`pack_rank_plain`, the same function in plain PyTorch (stable LSD
sorts, one per word, carrying the permutation).

Both return ``(order, gid_sorted)`` as int32: ``order`` is the stable
lexicographic permutation of the windows and ``gid_sorted[i]`` the dense rank
of window ``order[i]`` — exactly ``_pack_and_rank_numpy`` of the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from .. import device as _device

SYMS_PER_WORD = 13          # base 5: 5**13 < 2**31
INT32_MAX = 2**31 - 1
KERNEL = "sortnet_pack_rank"

# shared memory a block may use on Hopper (227 KB), and the largest block the
# kernel sorts there (2**13 records = 160 KB at k=51's 20-byte records)
SMEM_BYTES = 232448
MAX_LOG_BLOCK = 13


def num_words(k: int) -> int:
    return (k + SYMS_PER_WORD - 1) // SYMS_PER_WORD


def network_shape(n: int, k: int) -> Tuple[int, int, int]:
    """(N, rows, log_block): the padded power-of-two record count, the
    int32 rows per record (key words + index) and the log2 of the records a
    block sorts in shared memory."""
    N = 2
    while N < n:
        N <<= 1
    rows = num_words(k) + 1
    log_b = MAX_LOG_BLOCK
    while log_b > 1 and rows * 4 << log_b > SMEM_BYTES:
        log_b -= 1
    return N, rows, min(log_b, N.bit_length() - 1)


def _check(codes: torch.Tensor, starts: torch.Tensor, k: int) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise TypeError("codes must be a 1-D uint8 tensor")
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise TypeError("starts must be a 1-D int32 tensor")
    if codes.device != starts.device:
        raise ValueError(f"codes on {codes.device} but starts on "
                         f"{starts.device}")
    if not (codes.is_contiguous() and starts.is_contiguous()):
        raise ValueError("codes and starts must be contiguous")
    if len(codes) >= 2**31 or len(starts) >= 2**31:
        raise ValueError("pack_rank takes fewer than 2**31 codes and windows")
    if k < 1:
        raise ValueError(f"window length {k} < 1")
    if len(starts) and (int(starts.min()) < 0
                        or int(starts.max()) + k > len(codes)):
        raise ValueError("a window reaches outside codes")


def _gids(sorted_words: List[torch.Tensor]) -> torch.Tensor:
    """Dense ranks from lexicographically sorted word rows."""
    n = sorted_words[0].shape[0]
    new_group = torch.zeros(n, dtype=torch.bool, device=sorted_words[0].device)
    new_group[0] = True
    for w in sorted_words:
        new_group[1:] |= w[1:] != w[:-1]
    return (torch.cumsum(new_group, 0) - 1).to(torch.int32)


def pack_words_plain(codes: torch.Tensor, starts: torch.Tensor,
                     k: int) -> List[torch.Tensor]:
    """Base-5 packing: 13 symbols per int32 word, most significant first,
    zero-filled tail, so word-tuple order is byte-lexicographic order."""
    pos = starts.to(torch.int64)
    words = []
    for j in range(num_words(k)):
        w = torch.zeros(len(starts), dtype=torch.int32, device=starts.device)
        for t in range(SYMS_PER_WORD):
            idx = j * SYMS_PER_WORD + t
            w = w * 5
            if idx < k:
                w = w + codes[pos + idx].to(torch.int32)
        words.append(w)
    return words


def pack_rank_plain(codes: torch.Tensor, starts: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: pack, then one stable sort
    per word, least significant first, carrying the permutation."""
    _check(codes, starts, k)
    n = len(starts)
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=starts.device)
        return empty, empty.clone()
    words = pack_words_plain(codes, starts, k)
    order = torch.arange(n, device=starts.device)
    for w in reversed(words):
        _, perm = torch.sort(w[order], stable=True)
        order = order[perm]
    gid_sorted = _gids([w[order] for w in words])
    return order.to(torch.int32), gid_sorted


def _lib():
    from ._build import load
    lib = load("sortnet")
    fn = lib.sortnet_pack_sort
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pack_rank_cuda(codes: torch.Tensor, starts: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/sortnet.cu on the current stream. Raises on a tensor that
    is not on a CUDA device, and on any launch the CUDA runtime refuses."""
    _check(codes, starts, k)
    if not codes.is_cuda:
        raise ValueError("pack_rank_cuda needs CUDA tensors")
    n = len(starts)
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=starts.device)
        return empty, empty.clone()
    N, rows, log_b = network_shape(n, k)
    keys = torch.empty((rows, N), dtype=torch.int32, device=codes.device)
    fn = _lib()
    stream = torch.cuda.current_stream(codes.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    err = fn(codes.data_ptr(), starts.data_ptr(), n, k, keys.data_ptr(), N,
             rows, log_b, stream.cuda_stream)
    end.record(stream)
    if err != 0:
        raise RuntimeError(f"sortnet kernel launch failed: CUDA error {err}")
    _device.record_launch(KERNEL, start, end)
    order = keys[rows - 1, :n].clone()
    gid_sorted = _gids(list(keys[:rows - 1, :n]))
    return order, gid_sorted


def pack_rank(codes: torch.Tensor, starts: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, gid_sorted) of the length-k windows of ``codes`` at
    ``starts``: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if codes.is_cuda:
        return pack_rank_cuda(codes, starts, k)
    return pack_rank_plain(codes, starts, k)
