"""The partition plan and bookkeeping of the port's k-mer grouping kernels
(autocycler_tpu_torch.ops.sortnet) on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against the
plain version there). Here the plan's digits are held against the orders of
the plain version and of the JAX package, and
:func:`sortnet.partition_rank` runs with the kernels' effects done in
torch, so its offset scans, segment lists and re-partition levels are
checked against the plain version exactly. Inputs are made from seeds with
numpy; every output is an integer, so every comparison is exact equality."""

import numpy as np
import pytest
import torch

from autocycler_tpu.ops import kmers as jax_kmers
from autocycler_tpu_torch.ops import sortnet


def _case(name, k, seed=0):
    """(codes, starts) of a named input: random codes with dots, a poly-A
    stretch, dotted ends, or all-equal windows."""
    rng = np.random.default_rng(seed)
    if name == "random":
        codes = rng.integers(0, 5, size=2500).astype(np.uint8)
        starts = rng.integers(0, len(codes) - k + 1, size=3001)
    elif name == "dna":                       # no dots: 4 of 5 codes
        codes = rng.integers(1, 5, size=6000).astype(np.uint8)
        starts = np.arange(len(codes) - k + 1)
    elif name == "poly_a":
        codes = rng.integers(1, 5, size=4000).astype(np.uint8)
        codes[1000:2500] = 1
        starts = np.arange(len(codes) - k + 1)
    elif name == "dots":
        codes = rng.integers(1, 5, size=3000).astype(np.uint8)
        codes[:k // 2] = 0
        codes[-(k // 2):] = 0
        codes[rng.integers(0, len(codes), size=40)] = 0
        starts = np.arange(len(codes) - k + 1)
    else:                                     # all-equal
        codes = np.full(k + 3000, 3, np.uint8)
        starts = np.arange(3001)
    return codes, starts.astype(np.int32)


def _tensors(codes, starts):
    return torch.from_numpy(codes), torch.from_numpy(starts)


CASES = ("random", "dna", "poly_a", "dots", "all_equal")
KS = (1, 12, 13, 14, 25, 32, 51, 80)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("k", KS)
def test_prefix_digit_is_monotone_in_key_order(name, k):
    """The first partition's digit never decreases along the plain version's
    order nor along the JAX package's, so bucket order is key order; it is
    word 0's high part."""
    codes, starts = _case(name, k)
    c, s = _tensors(codes, starts)
    plan = sortnet.make_plan(len(starts), k)
    digit = sortnet.prefix_digits(c, s, plan)
    w0 = sortnet.pack_words_plain(c, s, k)[0].long()
    assert torch.equal(digit, w0 // 5 ** (sortnet.SYMS_PER_WORD - plan.prefix))
    assert int(digit.max()) < plan.buckets
    order, _ = sortnet.pack_rank_plain(c, s, k)
    assert bool((digit[order.long()].diff() >= 0).all())
    jax_order, _ = jax_kmers._pack_and_rank_numpy(codes, starts.astype(np.int64), k)
    assert bool((digit[torch.from_numpy(jax_order)].diff() >= 0).all())


@pytest.mark.parametrize("name", ("random", "poly_a", "all_equal"))
@pytest.mark.parametrize("k", (14, 51, 80))
def test_level_digits_are_monotone_within_parent_buckets(name, k):
    """Along the sorted order, each re-partition digit never decreases
    among records that share every earlier digit."""
    codes, starts = _case(name, k, seed=1)
    c, s = _tensors(codes, starts)
    plan = sortnet.make_plan(len(starts), k)
    order, _ = sortnet.pack_rank_plain(c, s, k)
    words = sortnet.pack_words_plain(c, s, k)
    recs = torch.stack(words + [torch.arange(len(starts), dtype=torch.int32)],
                       1)[order.long()]
    parent = sortnet.prefix_digits(c, s, plan)[order.long()]
    for depth in range(1, plan.max_levels + 1):
        d = sortnet.level_digits(recs, plan, plan.level(depth))
        same = parent[1:] == parent[:-1]
        assert bool((d[1:][same] >= d[:-1][same]).all()), depth
        parent = parent * plan.level(depth).bins + d
    # after the last level every record is alone in its bucket
    assert len(torch.unique(parent)) == len(starts)


class EmulatedKernels:
    """What each kernel of csrc/sortnet.cu leaves in device memory, done in
    torch on the CPU: the same counts and record placement, with each
    bucket's records in a random order (the kernels' scatter is unordered),
    and checks of the kernels' preconditions."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.segments = []
        self.levels = 0

    def _place(self, recs, keys, cursor, dst, plan):
        perm = torch.randperm(len(keys), generator=self.gen)
        recs, keys = recs[perm], keys[perm]
        by_key = torch.sort(keys, stable=True).indices
        sorted_keys = keys[by_key]
        first = torch.searchsorted(sorted_keys, sorted_keys, right=False)
        slot = cursor.long()[sorted_keys] + torch.arange(len(keys)) - first
        dst.view(-1, plan.stride)[slot, :plan.rec_words] = recs[by_key]

    def hist0(self, codes, starts, plan, counts):
        counts += torch.bincount(sortnet.prefix_digits(codes, starts, plan),
                                 minlength=plan.buckets).to(torch.int32)

    def scatter0(self, codes, starts, plan, cursor, recs):
        words = sortnet.pack_words_plain(codes, starts, plan.k)
        idx = torch.arange(plan.n, dtype=torch.int32)
        self._place(torch.stack(words + [idx], 1),
                    sortnet.prefix_digits(codes, starts, plan), cursor, recs,
                    plan)

    def _chunk_records(self, src, plan, chunks, level):
        task, lo, hi = (t.long() for t in chunks)
        assert bool((hi - lo <= sortnet.CHUNK).all())
        pos = torch.cat([torch.arange(a, b) for a, b in zip(lo.tolist(),
                                                             hi.tolist())])
        owner = torch.repeat_interleave(task, hi - lo)
        recs = src.view(-1, plan.stride)[pos, :plan.rec_words]
        return recs, owner * level.bins + sortnet.level_digits(recs, plan, level)

    def hist(self, src, plan, chunks, level, counts):
        assert level.bins <= 1024
        self.levels += 1
        _, keys = self._chunk_records(src, plan, chunks, level)
        counts += torch.bincount(keys, minlength=len(counts)).to(torch.int32)

    def scatter(self, src, dst, plan, chunks, level, cursor):
        recs, keys = self._chunk_records(src, plan, chunks, level)
        self._place(recs, keys, cursor, dst, plan)

    def sort(self, src, ends, plan, lo, hi, order, flags):
        W = plan.words
        for a, b in zip(lo.tolist(), hi.tolist()):
            assert 0 < b - a <= plan.cap
            self.segments.append((a, b))
            recs = src.view(-1, plan.stride)[a:b, :plan.rec_words].numpy()
            recs = recs[np.lexsort(recs.T[::-1])]
            order[a:b] = torch.from_numpy(recs[:, W].copy())
            flags[a + 1:b] = torch.from_numpy(
                (recs[1:, :W] != recs[:-1, :W]).any(1).astype(np.uint8))
            out = ends.view(-1, plan.stride)
            out[a, :W] = torch.from_numpy(recs[0, :W].copy())
            out[b - 1, :W] = torch.from_numpy(recs[-1, :W].copy())

    def bounds(self, recs, plan, lo, flags):
        r = recs.view(-1, plan.stride)[:, :plan.words]
        for a in lo.tolist():
            flags[a] = 0 if a == 0 else int(bool((r[a] != r[a - 1]).any()))


def _emulated(codes, starts, k, seed=0):
    kern = EmulatedKernels(seed)
    c, s = _tensors(codes, starts)
    got = sortnet.partition_rank(c, s, k, kern)
    want = sortnet.pack_rank_plain(c, s, k)
    return kern, got, want


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("k", (1, 13, 14, 32, 51, 80))
@pytest.mark.parametrize("smem", (sortnet.SORT_SMEM_BYTES, 256))
def test_partition_rank_equals_plain(monkeypatch, name, k, smem):
    """partition_rank, with the kernels' effects emulated, equals the plain
    version bit for bit; its segments tile [0, n) once, each within a sort
    block. With 256 bytes a sort block, buckets go through the re-partition
    levels (all the way to the index bits for equal windows)."""
    monkeypatch.setattr(sortnet, "SORT_SMEM_BYTES", smem)
    codes, starts = _case(name, k, seed=k)
    kern, got, want = _emulated(codes, starts, k, seed=k)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    covered = np.zeros(len(starts), np.int64)
    for a, b in kern.segments:
        covered[a:b] += 1
    assert (covered == 1).all()
    if smem == 256 and name == "all_equal":
        plan = sortnet.make_plan(len(starts), k)
        assert plan.symbol_levels < kern.levels <= plan.max_levels


def test_partition_rank_of_one_window():
    codes, starts = _case("random", 25)
    kern, got, want = _emulated(codes, starts[:1], 25)
    assert got[0].tolist() == [0] and got[1].tolist() == [0]
    assert kern.segments == [(0, 1)]


def test_bucket_just_over_a_block(monkeypatch):
    """One first-partition bucket of small + 1 records, and one of cap + 1,
    both partitioned again, among random windows (the two buckets' prefixes
    start with a dot, which no random window holds)."""
    monkeypatch.setattr(sortnet, "SORT_SMEM_BYTES", 2048)
    k, rng = 20, np.random.default_rng(5)
    plan = sortnet.make_plan(4000, k)
    pieces, starts, pos = [], [], 0
    for size, last in ((plan.small + 1, 0), (plan.cap + 1, 1)):
        head = np.zeros(plan.prefix, np.uint8)    # dots: no random window's
        head[-1] = last
        for _ in range(size):
            pieces.append(np.concatenate([head, rng.integers(
                1, 5, size=k - plan.prefix).astype(np.uint8)]))
            starts.append(pos)
            pos += k
    tail = rng.integers(1, 5, size=4000 - len(starts) + k - 1).astype(np.uint8)
    starts += list(range(pos, pos + len(tail) - k + 1))
    codes = np.concatenate(pieces + [tail])
    starts = np.array(starts, np.int32)
    assert sortnet.make_plan(len(starts), k) == plan
    stats = sortnet.partition_stats(*_tensors(codes, starts), k)
    assert stats["largest_bucket"] == plan.cap + 1
    assert stats["over_small_share"] >= (plan.cap + plan.small + 2) / len(starts)
    kern, got, want = _emulated(codes, starts, k)
    assert kern.levels >= 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n, k", [(293_760_000, 51), (18_000_000, 32),
                                  (2**31 - 1, 51), (2**31 - 1, 200)])
def test_plan_fits_at_the_headline_shapes(n, k):
    """Bucket counts, offsets and counters within int32, the sort block
    within shared memory, two record buffers within the card's 80 GB, and
    live buckets averaging at most a quarter of ``small`` (or the widest
    prefix) at the headline shapes (compress at k=51, a chromosome-dotplot
    pair at k=32)."""
    plan = sortnet.make_plan(n, k)
    assert plan.buckets < 2**31 and n * 1 < 2**31
    assert plan.smem_bytes <= sortnet.SMEM_BYTES
    assert plan.cap & (plan.cap - 1) == 0 and plan.small >= 128
    assert plan.cap <= 2 * 1024 * 4    # sort_threads: at most 4 pairs a thread
    # re-partition counters: (n / small) tasks x the widest digit's bins
    assert n // plan.small * max(5 ** sortnet.LEVEL_SYMS,
                                 1 << sortnet.LEVEL_BITS) < 2**31 or k == 200
    assert plan.level(plan.max_levels).shift == 0
    assert (n / 4 ** plan.prefix <= plan.small / 4
            or plan.prefix == sortnet.MAX_PREFIX)
    assert plan.window + plan.small == plan.cap
    if n < 2**31 - 1:
        assert plan.scratch_bytes < 80e9
    if (n, k) == (293_760_000, 51):
        assert (plan.words, plan.stride, plan.cap, plan.prefix) == (4, 8, 4096, 10)
        assert plan.smem_bytes == 5 * 4 * (4096 + 128)
    if (n, k) == (18_000_000, 32):
        assert (plan.words, plan.stride, plan.cap, plan.prefix) == (3, 8, 4096, 9)


def test_plan_levels_spend_symbols_then_index_bits():
    plan = sortnet.make_plan(10_000, 51)
    levels = [plan.level(d) for d in range(1, plan.max_levels + 1)]
    syms = [lv for lv in levels if lv.nsym]
    assert syms[0].sym_pos == plan.prefix
    assert sum(lv.nsym for lv in syms) == 51 - plan.prefix
    bits = [lv for lv in levels if not lv.nsym]
    assert sum(lv.width for lv in bits) == plan.index_bits
    assert [lv.shift + lv.width for lv in bits][0] == plan.index_bits
    with pytest.raises(ValueError):
        plan.level(plan.max_levels + 1)


def test_pack_rank_cuda_raises_on_cpu_tensors():
    codes, starts = _tensors(*_case("random", 51))
    with pytest.raises(ValueError, match="CUDA"):
        sortnet.pack_rank_cuda(codes, starts, 51)
    # the wrapper takes the plain version only because the tensors are on the CPU
    got = sortnet.pack_rank(codes, starts, 51)
    want = sortnet.pack_rank_plain(codes, starts, 51)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
