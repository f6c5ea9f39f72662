"""The port's k-mer grouping (autocycler_tpu_torch.ops.sortnet / ops.kmers)
against the JAX package, on the CPU, where the port's wrapper runs the
kernel's plain PyTorch version. Inputs are made from seeds with numpy and
handed to both packages; every output is an integer or a byte, so every
comparison is exact equality."""

import numpy as np
import pytest
import torch

from autocycler_tpu.models import Sequence as JaxSequence
from autocycler_tpu.ops import kmers as jax_kmers
from autocycler_tpu.ops.sortnet import sortnet_reference
from autocycler_tpu_torch.models import Sequence
from autocycler_tpu_torch.ops import kmers, sortnet

KS = (11, 25, 50, 51)


def _windows(seed, k, n=3001, n_codes=2000, dots=True):
    """Random 5-symbol codes (0 = '.') and window starts with duplicates;
    n is not a power of two."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0 if dots else 1, 5, size=n_codes).astype(np.uint8)
    starts = rng.integers(0, n_codes - k + 1, size=n).astype(np.int64)
    return codes, starts


def _plain(codes, starts, k):
    order, gid_sorted = sortnet.pack_rank(torch.from_numpy(codes),
                                          torch.from_numpy(starts.astype(np.int32)), k)
    return order.numpy(), gid_sorted.numpy()


@pytest.mark.parametrize("k", KS)
def test_pack_rank_plain_matches_numpy_reference(k):
    codes, starts = _windows(k, k)
    order, gid_sorted = _plain(codes, starts, k)
    exp_order, exp_gid = jax_kmers._pack_and_rank_numpy(codes, starts, k)
    assert order.dtype == np.int32 and gid_sorted.dtype == np.int32
    assert np.array_equal(order, exp_order)
    assert np.array_equal(gid_sorted, exp_gid)


@pytest.mark.parametrize("k", KS)
def test_pack_rank_plain_matches_sortnet_reference(k):
    """The port's base-5 words equal the JAX package's traced packing, and
    the JAX package's bitonic network oracle over (words..., index) yields
    the port's order."""
    import jax.numpy as jnp

    codes, starts = _windows(100 + k, k, n=777)
    words = sortnet.pack_words_plain(torch.from_numpy(codes),
                                     torch.from_numpy(starts.astype(np.int32)), k)
    jax_words = jax_kmers._pack_words_traced(jnp.asarray(codes),
                                             jnp.asarray(starts.astype(np.int32)), k)
    assert len(words) == len(jax_words) == sortnet.num_words(k)
    for w, jw in zip(words, jax_words):
        assert np.array_equal(w.numpy(), np.asarray(jw))
    idx = np.arange(len(starts), dtype=np.int32)
    net = sortnet_reference([w.numpy() for w in words] + [idx])
    order, _ = _plain(codes, starts, k)
    assert np.array_equal(order, net[-1])


@pytest.mark.parametrize("k", (25, 51))
def test_pack_rank_plain_matches_pallas_interpret(monkeypatch, k):
    """The JAX package's Pallas sort-network grouping, run in interpret mode
    on a shrunk block, against the port at one tiny size."""
    monkeypatch.setattr(jax_kmers, "_PALLAS_BLOCK_ROWS", 8)
    codes, starts = _windows(200 + k, k, n=1500, n_codes=900)
    exp_order, exp_gid = jax_kmers._pack_and_rank_jax_pallas(codes, starts, k)
    order, gid_sorted = _plain(codes, starts, k)
    assert np.array_equal(order, exp_order)
    assert np.array_equal(gid_sorted, exp_gid)


@pytest.mark.parametrize("case", ["all_equal", "single", "tiny_codes"])
def test_pack_rank_plain_edge_cases(case):
    k = 11
    if case == "all_equal":
        codes = np.full(300, 3, np.uint8)
        starts = np.arange(0, 290, dtype=np.int64)
    elif case == "single":
        codes, starts = _windows(5, k, n=1)
    else:
        codes = np.array([1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1], np.uint8)
        starts = np.zeros(5, np.int64)
    order, gid_sorted = _plain(codes, starts, k)
    exp_order, exp_gid = jax_kmers._pack_and_rank_numpy(codes, starts, k)
    assert np.array_equal(order, exp_order)
    assert np.array_equal(gid_sorted, exp_gid)


def test_pack_rank_rejects_windows_outside_codes():
    codes = torch.zeros(20, dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside codes"):
        sortnet.pack_rank(codes, torch.tensor([0, 10], dtype=torch.int32), 11)
    with pytest.raises(TypeError):
        sortnet.pack_rank(codes, torch.tensor([0, 1]), 11)      # int64 starts


@pytest.mark.parametrize("k", (0, 11, 51))
def test_group_windows_stats_matches_jax(k):
    codes, starts = _windows(300 + k, max(k, 1), n=2500)
    exp = jax_kmers.group_windows_stats(codes, starts, k, use_jax=False,
                                        threads=1)
    got = kmers.group_windows_stats(codes, starts, k, device="cpu")
    for name, e, g in zip(("gid", "order", "depth", "first_occ"), exp, got):
        assert np.array_equal(np.asarray(e), g), name
    order, gid_sorted = kmers.group_windows(codes, starts, k, device="cpu")
    assert np.array_equal(order, got[1])
    assert np.array_equal(gid_sorted, got[0][order])
    gid, order_full = kmers.group_windows_full(codes, starts, k, device="cpu")
    assert np.array_equal(gid, got[0]) and np.array_equal(order_full, got[1])


def _sequences(seed, k, cls, n_seqs=4, length=900):
    """The same dot-padded contigs as each package's Sequence class: rotated
    copies of one genome (shared k-mers) and one unrelated contig."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=length))
    seqs = []
    for i in range(n_seqs - 1):
        r = int(rng.integers(0, length))
        seqs.append(genome[r:] + genome[:r])
    seqs.append("".join(rng.choice(list("ACGT"), size=length // 3)))
    return [cls.with_seq(i + 1, s, "a.fasta", f"c{i + 1}", k // 2)
            for i, s in enumerate(seqs)]


FIELDS = ("k", "half_k", "buf", "seq_ids", "seq_len", "fwd_byte_off",
          "rev_byte_off", "occ_off", "depth", "rep_byte", "rev_kid",
          "prefix_gid", "suffix_gid", "out_count", "in_count", "succ",
          "first_pos", "occ_kid", "first_occ", "occ_sorted", "group_start")


@pytest.mark.parametrize("k", (11, 51))
def test_build_kmer_index_matches_jax(k):
    exp = jax_kmers.build_kmer_index(_sequences(7, k, JaxSequence), k,
                                     use_jax=False, use_fused=False)
    got = kmers.build_kmer_index(_sequences(7, k, Sequence), k, device="cpu")
    for name in FIELDS:
        e, g = getattr(exp, name), getattr(got, name)
        assert np.array_equal(np.asarray(e), np.asarray(g)), name
    kids = np.arange(0, got.num_kmers, 7)
    e_flat = exp.positions_for_kmers_flat(kids)
    g_flat = got.positions_for_kmers_flat(kids)
    for e, g in zip(e_flat, g_flat):
        assert np.array_equal(e, g)


def _adjacency_cases():
    rng = np.random.default_rng(0)
    U, G = 5000, 3000
    cases = [("random", rng.integers(0, G, size=U), rng.integers(0, G, size=U), G)]
    ones = np.zeros(700, np.int64)
    cases.append(("all_same_gram", ones, ones.copy(), 1))
    asc = np.arange(700, dtype=np.int64)
    cases.append(("full_range_asc_desc", asc, asc[::-1].copy(), 700))
    dup = np.repeat(np.arange(7, dtype=np.int64), 100)
    cases.append(("heavy_duplicates", dup, dup[::-1].copy(), 7))
    cases.append(("single_kmer", np.zeros(1, np.int64), np.zeros(1, np.int64), 1))
    return cases


@pytest.mark.parametrize("case", _adjacency_cases(), ids=lambda c: c[0])
def test_adjacency_matches_jax(case):
    _, prefix, suffix, G = case
    exp = jax_kmers._adjacency(prefix, suffix, G, workers=1, use_jax=False)
    got = kmers.adjacency(torch.from_numpy(prefix), torch.from_numpy(suffix), G)
    for name, e, g in zip(("out_count", "in_count", "succ"), exp, got):
        assert np.array_equal(e, g.numpy()), name
