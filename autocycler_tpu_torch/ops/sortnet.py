"""Pack + rank of k-windows: the partition-sort kernels and their plain
version.

:func:`pack_rank` is the port of the JAX package's sort-network grouping
(ops/sortnet.py:_local_stages_kernel driven by run_network, reached through
ops/kmers.py:_pallas_rank_fn). For a CUDA tensor it launches the hand-written
kernels in csrc/sortnet.cu: a histogram of each window's leading base-5
symbols, a scatter of whole (words..., index) records into those buckets,
and one shared-memory sort per run of small buckets; buckets too large for
a block are partitioned again on later symbols first. The group ids come
from the sorted keys' adjacent differences. For a CPU tensor it runs
:func:`pack_rank_plain`, the same function in plain PyTorch (stable LSD
sorts, one per word, carrying the permutation).

Both return ``(order, gid_sorted)`` as int32: ``order`` is the stable
lexicographic permutation of the windows and ``gid_sorted[i]`` the dense rank
of window ``order[i]`` — exactly ``_pack_and_rank_numpy`` of the JAX package.

The partition's shape (digit widths, bucket counts, segment capacity, the
levels of re-partitioning) is planned here, in :class:`Plan`, and its
bookkeeping (offset scans, segment lists) runs as torch ops in
:func:`partition_rank`; the kernels take both as arguments.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .. import device as _device

SYMS_PER_WORD = 13          # base 5: 5**13 < 2**31
INT32_MAX = 2**31 - 1
KERNEL = "sortnet_pack_rank"

SMEM_BYTES = 232448         # shared memory a block may use on Hopper (227 KB)
SORT_SMEM_BYTES = 98304     # a sort block's budget: two blocks on each SM
MAX_CAP = 4096              # records a sort block takes: 256 threads of 16
MAX_PREFIX = 10             # the first partition: at most 5**10 buckets
LEVEL_SYMS = 4              # symbols per re-partition digit (625 bins) ...
LEVEL_BITS = 10             # ... then index bits, once the k symbols are spent
CHUNK = 4096                # records a block takes in a re-partition pass


def num_words(k: int) -> int:
    return (k + SYMS_PER_WORD - 1) // SYMS_PER_WORD


@dataclass(frozen=True)
class Level:
    """A re-partition digit: ``nsym`` base-5 symbols from ``sym_pos``, or
    (``nsym == 0``) ``width`` index bits from bit ``shift``."""
    sym_pos: int
    nsym: int
    shift: int
    width: int

    @property
    def bins(self) -> int:
        return 5 ** self.nsym if self.nsym else 1 << self.width


@dataclass(frozen=True)
class Plan:
    """The partition of n windows of length k.

    A record is the window's ``words`` key words and its index, padded to
    ``stride`` int32 in device memory. The first pass puts each record in
    one of ``buckets`` = 5**prefix buckets by its first ``prefix`` symbols;
    a sort block takes up to ``cap`` records (a power of two, ``smem_bytes``
    of shared memory), so buckets of at most ``small`` = cap / 4 records are
    sorted as they are, in runs of whole buckets whose offsets fall in one
    ``window`` of cap - small records, and larger ones are partitioned again
    by :meth:`level`."""
    n: int
    k: int
    words: int
    cap: int
    prefix: int

    @property
    def rec_words(self) -> int:
        return self.words + 1

    @property
    def stride(self) -> int:
        """int32 per record in device memory: 8 (one 32-byte sector) for the
        kernels' instantiations (words <= 5), words + 1 for the generic one."""
        return 8 if self.words <= 5 else self.rec_words

    @property
    def small(self) -> int:
        return self.cap // 4

    @property
    def window(self) -> int:
        return self.cap - self.small

    @property
    def buckets(self) -> int:
        return 5 ** self.prefix

    @property
    def smem_bytes(self) -> int:
        """A sort block's shared memory: rows of ``cap`` int32, padded by one
        word in 32 in the register sort (words <= 5)."""
        row = self.cap + self.cap // 32 if self.words <= 5 else self.cap
        return 4 * self.rec_words * row

    @property
    def index_bits(self) -> int:
        return max(1, (self.n - 1).bit_length())

    @property
    def symbol_levels(self) -> int:
        return -(-max(self.k - self.prefix, 0) // LEVEL_SYMS)

    @property
    def max_levels(self) -> int:
        """Re-partition levels at most: the symbols after the prefix, then
        the index bits (each bucket of the last level holds one record)."""
        return self.symbol_levels + -(-self.index_bits // LEVEL_BITS)

    def level(self, depth: int) -> Level:
        """The digit of re-partition level ``depth`` (1, 2, ...)."""
        if not 1 <= depth <= self.max_levels:
            raise ValueError(f"no re-partition level {depth}")
        if depth <= self.symbol_levels:
            pos = self.prefix + (depth - 1) * LEVEL_SYMS
            return Level(pos, min(LEVEL_SYMS, self.k - pos), 0, 0)
        left = self.index_bits - (depth - 1 - self.symbol_levels) * LEVEL_BITS
        width = min(LEVEL_BITS, left)
        return Level(0, 0, left - width, width)

    @property
    def scratch_bytes(self) -> int:
        """Device bytes besides the inputs and outputs, when a bucket has to
        be partitioned again (one record buffer less when none has): two
        record buffers, the first pass's counts and cursors, the flags."""
        return 2 * 4 * self.stride * self.n + 2 * 4 * self.buckets + self.n


def make_plan(n: int, k: int) -> Plan:
    """The smallest prefix whose live buckets (DNA fills 4**p of the 5**p)
    average at most a quarter of ``small``, up to min(k, MAX_PREFIX)."""
    words = num_words(k)
    cap = 4
    while cap < MAX_CAP and 4 * (words + 1) * cap * 2 <= SORT_SMEM_BYTES:
        cap *= 2
    if 4 * (words + 1) * cap > SMEM_BYTES:
        raise ValueError(f"window length {k} is too long for a sort block")
    prefix, top = 1, min(k, MAX_PREFIX)
    while prefix < top and 4 * n > 4 ** prefix * (cap // 4):
        prefix += 1
    return Plan(n, k, words, cap, prefix)


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
    if len(starts):
        first, last = torch.aminmax(starts)
        if int(first) < 0 or int(last) + k > len(codes):
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


def prefix_digits(codes: torch.Tensor, starts: torch.Tensor,
                  plan: Plan) -> torch.Tensor:
    """The first pass's bucket of each window (int64): the base-5 value of
    its first ``plan.prefix`` symbols, which is word 0 // 5**(13 - prefix),
    so bucket order is key order. The plain version of hist0_kernel's
    digit."""
    pos = starts.to(torch.int64)
    d = torch.zeros(len(starts), dtype=torch.int64, device=starts.device)
    for q in range(plan.prefix):
        d = d * 5
        if q < plan.k:
            d = d + codes[pos + q].to(torch.int64)
    return d


def level_digits(records: torch.Tensor, plan: Plan,
                 level: Level) -> torch.Tensor:
    """The digit of each record ([m, words + 1] int32) at a re-partition
    level (int64): the plain version of level_digit in csrc/sortnet.cu."""
    if level.nsym:
        d = torch.zeros(len(records), dtype=torch.int64, device=records.device)
        for q in range(level.sym_pos, level.sym_pos + level.nsym):
            w = records[:, q // SYMS_PER_WORD].to(torch.int64)
            d = d * 5 + (w // 5 ** (SYMS_PER_WORD - 1 - q % SYMS_PER_WORD)) % 5
        return d
    idx = records[:, plan.words].to(torch.int64)
    return (idx >> level.shift) & ((1 << level.width) - 1)


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


def _segments(cnt: torch.Tensor, off: torch.Tensor, bins: int, plan: Plan):
    """Split one partition's buckets (int64 counts and record offsets, in
    offset order, ``bins`` to a task) into sort segments and the next
    level's tasks.

    A segment is a run of non-empty buckets of at most ``plan.small``
    records, of one task, with no larger bucket between them, whose offsets
    fall in one window [j * window, (j + 1) * window): so it is contiguous
    and holds fewer than window + small = cap records. Returns (seg_lo,
    seg_hi) int32 and the larger buckets' (task_lo, task_hi) int64. Works
    on the non-empty buckets only: a scan over every bucket costs more."""
    large = cnt > plan.small
    lb = torch.nonzero(large).squeeze(1)
    tasks = (off[lb], off[lb] + cnt[lb])
    sb = torch.nonzero((cnt > 0) & ~large).squeeze(1)
    if len(sb) == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=cnt.device)
        return empty, empty.clone(), tasks
    key = torch.stack([sb // bins, off[sb] // plan.window,
                       torch.cumsum(large, 0)[sb]])
    first = torch.ones(len(sb), dtype=torch.bool, device=cnt.device)
    first[1:] = (key[:, 1:] != key[:, :-1]).any(0)
    heads = torch.nonzero(first).squeeze(1)
    tails = torch.roll(heads, -1) - 1
    tails[-1] = len(sb) - 1
    lo = off[sb[heads]]
    hi = off[sb[tails]] + cnt[sb[tails]]
    return lo.to(torch.int32), hi.to(torch.int32), tasks


def _chunks(task_lo: torch.Tensor, task_hi: torch.Tensor):
    """(task, lo, hi) int32 of blocks of at most CHUNK records that cover
    every task's range."""
    nch = (task_hi - task_lo + CHUNK - 1) // CHUNK
    task = torch.repeat_interleave(
        torch.arange(len(task_lo), device=task_lo.device), nch)
    first = torch.cumsum(nch, 0) - nch
    j = torch.arange(len(task), device=task_lo.device) - first[task]
    lo = task_lo[task] + j * CHUNK
    hi = torch.minimum(lo + CHUNK, task_hi[task])
    return task.to(torch.int32), lo.to(torch.int32), hi.to(torch.int32)


def partition_rank(codes: torch.Tensor, starts: torch.Tensor, k: int,
                   kern) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, gid_sorted) of n >= 1 windows through the partition kernels
    ``kern`` (:class:`CudaKernels`): the first partition into buckets, the
    re-partitions of buckets over ``plan.small`` records (record buffers
    alternate between levels), one sort launch per buffer over its
    segments, the segment boundaries, and the cumulative sum of the
    new-group flags."""
    n = len(starts)
    plan = make_plan(n, k)
    dev = codes.device
    recs: List[Optional[torch.Tensor]] = [
        torch.empty(n * plan.stride, dtype=torch.int32, device=dev), None]
    counts = torch.zeros(plan.buckets, dtype=torch.int32, device=dev)
    kern.hist0(codes, starts, plan, counts)
    cnt = counts.long()
    off = torch.cumsum(cnt, 0) - cnt
    kern.scatter0(codes, starts, plan, off.to(torch.int32), recs[0])
    lo, hi, (task_lo, task_hi) = _segments(cnt, off, plan.buckets, plan)
    segments = [[(lo, hi)], []]
    depth = 0
    while len(task_lo):
        depth += 1
        level = plan.level(depth)
        src, dst = (depth - 1) % 2, depth % 2
        if recs[1] is None:
            recs[1] = torch.empty_like(recs[0])
        if len(task_lo) * level.bins >= 2**31:
            raise ValueError(f"{len(task_lo)} buckets of {plan.small}+ "
                             "records to partition again: too many")
        chunks = _chunks(task_lo, task_hi)
        counts = torch.zeros(len(task_lo) * level.bins, dtype=torch.int32,
                             device=dev)
        kern.hist(recs[src], plan, chunks, level, counts)
        cnt = counts.long().view(len(task_lo), level.bins)
        off = (torch.cumsum(cnt, 1) - cnt + task_lo[:, None]).flatten()
        cnt = cnt.flatten()
        kern.scatter(recs[src], recs[dst], plan, chunks, level,
                     off.to(torch.int32))
        lo, hi, (task_lo, task_hi) = _segments(cnt, off, level.bins, plan)
        segments[dst].append((lo, hi))
    order = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    heads = []
    for buf, segs in enumerate(segments):
        if segs:
            lo, hi = (torch.cat(part) for part in zip(*segs))
            if len(lo):
                kern.sort(recs[buf], recs[0], plan, lo, hi, order, flags)
                heads.append(lo)
    kern.bounds(recs[0], plan, torch.cat(heads), flags)
    return order, torch.cumsum(flags, 0, dtype=torch.int32)


class CudaKernels:
    """The C entry points of csrc/sortnet.cu on one stream."""

    def __init__(self, stream: int):
        self.lib = _lib()
        self.stream = stream

    def _call(self, name: str, *args) -> None:
        _device.check(f"{KERNEL} ({name})",
                      getattr(self.lib, name)(*args, self.stream))

    def hist0(self, codes, starts, plan, counts):
        self._call("sortnet_hist0", codes.data_ptr(), starts.data_ptr(),
                   plan.n, plan.k, plan.prefix, counts.data_ptr())

    def scatter0(self, codes, starts, plan, cursor, recs):
        self._call("sortnet_scatter0", codes.data_ptr(), starts.data_ptr(),
                   plan.n, plan.k, plan.words, plan.prefix,
                   cursor.data_ptr(), recs.data_ptr())

    def hist(self, src, plan, chunks, level, counts):
        task, lo, hi = chunks
        self._call("sortnet_hist", src.data_ptr(), plan.words,
                   task.data_ptr(), lo.data_ptr(), hi.data_ptr(), len(task),
                   level.sym_pos, level.nsym, level.shift, level.width,
                   level.bins, counts.data_ptr())

    def scatter(self, src, dst, plan, chunks, level, cursor):
        task, lo, hi = chunks
        self._call("sortnet_scatter", src.data_ptr(), dst.data_ptr(),
                   plan.words, task.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                   len(task), level.sym_pos, level.nsym, level.shift,
                   level.width, level.bins, cursor.data_ptr())

    def sort(self, src, ends, plan, lo, hi, order, flags):
        self._call("sortnet_sort", src.data_ptr(), ends.data_ptr(),
                   plan.words, lo.data_ptr(), hi.data_ptr(), len(lo),
                   plan.cap, order.data_ptr(), flags.data_ptr())

    def bounds(self, recs, plan, lo, flags):
        self._call("sortnet_bounds", recs.data_ptr(), plan.words,
                   lo.data_ptr(), len(lo), flags.data_ptr())


_ARGTYPES = {
    "sortnet_hist0": "ppiiip",
    "sortnet_scatter0": "ppiiiipp",
    "sortnet_hist": "pipppiiiiiip",
    "sortnet_scatter": "ppipppiiiiiip",
    "sortnet_sort": "ppippiipp",
    "sortnet_bounds": "pipip",
}


def _lib():
    from ._build import load
    lib = load("sortnet")
    for name, sig in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                           for c in sig] + [ctypes.c_void_p]   # + the stream
            fn.restype = ctypes.c_int
    return lib


def pack_rank_cuda(codes: torch.Tensor, starts: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels of csrc/sortnet.cu on the current stream (one
    counted launch). Raises on a tensor that is not on a CUDA device, and on
    any launch the CUDA runtime refuses."""
    _check(codes, starts, k)
    if not codes.is_cuda:
        raise ValueError("pack_rank_cuda needs CUDA tensors")
    if len(starts) == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=starts.device)
        return empty, empty.clone()
    with _device.kernel_launch(KERNEL, codes.device) as stream:
        return partition_rank(codes, starts, k, CudaKernels(stream))


def pack_rank(codes: torch.Tensor, starts: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, gid_sorted) of the length-k windows of ``codes`` at
    ``starts``: the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors (a dispatch of the run record, not a launch)."""
    if codes.is_cuda:
        return pack_rank_cuda(codes, starts, k)
    with _device.device_work(KERNEL, codes.device):
        return pack_rank_plain(codes, starts, k)


def partition_stats(codes: torch.Tensor, starts: torch.Tensor,
                    k: int) -> dict:
    """The first partition of these windows, computed plainly: its prefix,
    bucket count, live buckets, largest bucket and the share of records in
    buckets over ``small`` (those partitioned again)."""
    plan = make_plan(len(starts), k)
    cnt = torch.bincount(prefix_digits(codes, starts, plan),
                         minlength=plan.buckets)
    over = cnt[cnt > plan.small].sum()
    return {"prefix": plan.prefix, "buckets": plan.buckets,
            "live_buckets": int((cnt > 0).sum()),
            "largest_bucket": int(cnt.max()) if len(starts) else 0,
            "cap": plan.cap, "small": plan.small,
            "over_small_share": float(over) / max(len(starts), 1)}
