"""The port's chain following and unitig graph assembly, run on the JAX
package's own k-mer index (handed over with
autocycler_tpu_torch.convert.kmer_index_from_reference), against the JAX
package's stages on the same index. Exact equality."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from autocycler_tpu.commands.compress import load_sequences as jax_load_sequences
from autocycler_tpu.metrics import InputAssemblyMetrics
from autocycler_tpu.ops import debruijn as jax_debruijn
from autocycler_tpu.ops import graph_build as jax_graph_build
from autocycler_tpu.ops import kmers as jax_kmers
from autocycler_tpu_torch import convert
from autocycler_tpu_torch.ops import debruijn, graph_build

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synthetic import make_assemblies  # noqa: E402


def _reference_index(tmp_path, seed, n_snps, k):
    asm = make_assemblies(tmp_path, n_assemblies=3, chromosome_len=3000,
                          plasmid_len=600, n_snps=n_snps, seed=seed)
    sequences, _ = jax_load_sequences(asm, k, InputAssemblyMetrics(), 25, 1)
    return jax_kmers.build_kmer_index(sequences, k, use_jax=False,
                                      use_fused=False)


def _same_chains(a, b):
    assert np.array_equal(a.members, b.members)
    assert np.array_equal(a.chain_off, b.chain_off)
    assert np.array_equal(a.is_cycle, b.is_cycle)


@pytest.mark.parametrize("seed,n_snps,k", [(1, 0, 51), (2, 4, 51), (3, 4, 11)])
def test_chains_and_graph_on_reference_index(tmp_path, seed, n_snps, k):
    ref = _reference_index(tmp_path, seed, n_snps, k)
    port = convert.kmer_index_from_reference(vars(ref), device="cpu")
    assert np.array_equal(debruijn.internal_edges(port),
                          jax_debruijn.internal_edges(ref))
    exp_chains = jax_debruijn.build_chains(ref, use_jax=False)
    got_chains = debruijn.build_chains(port)
    _same_chains(exp_chains, got_chains)
    exp = jax_graph_build.unitig_graph_from_chains(ref, exp_chains)
    got = graph_build.unitig_graph_from_chains(port, got_chains)
    assert got.gfa_text([]) == exp.gfa_text([])


def test_convert_accepts_dataclass_fields(tmp_path):
    ref = _reference_index(tmp_path, 4, 0, 51)
    port = convert.kmer_index_from_reference(dataclasses.asdict(ref),
                                             device="cpu")
    assert port.device.type == "cpu"
    assert port.num_kmers == ref.num_kmers
    assert port.k == ref.k and isinstance(port.k, int)


def test_convert_rejects_fused_layout(tmp_path):
    ref = _reference_index(tmp_path, 5, 0, 51)
    fields = vars(ref).copy()
    fields["occ_sorted"] = None
    with pytest.raises(KeyError, match="per-occurrence"):
        convert.kmer_index_from_reference(fields, device="cpu")


def _synthetic_index(jax_cls):
    """A hand-made index holding every chain shape the emission handles: a
    self-mirror cycle (reverse complements run around the same cycle), a
    self-mirror path, a path with a separate mirror path, and singletons.
    Only the fields chain following reads are meaningful."""
    U = 16
    succ = np.full(U, -1, np.int64)
    rev = np.empty(U, np.int64)
    # self-mirror cycle 0..5: rev(a_i) = a_{(1 - i) mod 6}
    for i in range(6):
        succ[i] = (i + 1) % 6
        rev[i] = (1 - i) % 6
    # self-mirror path 6 -> 7 -> 8 -> 9: rev(b_i) = b_{3 - i}
    for i in range(4):
        if i < 3:
            succ[6 + i] = 7 + i
        rev[6 + i] = 9 - i
    # path 10 -> 11 -> 12 and its mirror 13 -> 14 -> 15
    succ[10], succ[11], succ[13], succ[14] = 11, 12, 14, 15
    for a, b in ((10, 15), (11, 14), (12, 13)):
        rev[a], rev[b] = b, a
    out_count = (succ >= 0).astype(np.int64)
    in_count = np.zeros(U, np.int64)
    in_count[succ[succ >= 0]] = 1
    z = np.zeros(U, np.int64)
    one = np.zeros(1, np.int64)
    fields = dict(
        k=11, half_k=5, buf=np.zeros(0, np.uint8), seq_ids=one.astype(np.int32),
        seq_len=one, fwd_byte_off=one, rev_byte_off=one, occ_off=one,
        depth=np.ones(U, np.int64), rep_byte=z, rev_kid=rev.astype(np.int32),
        prefix_gid=z, suffix_gid=z, out_count=out_count, in_count=in_count,
        succ=succ, first_pos=np.zeros(U, bool), occ_kid=z.astype(np.int32),
        first_occ=z, occ_sorted=z, group_start=np.arange(U + 1))
    return jax_cls(**fields), fields


def test_chains_self_mirror_cycle_matches_jax():
    ref, fields = _synthetic_index(jax_kmers.KmerIndex)
    port = convert.kmer_index_from_reference(fields, device="cpu")
    exp = jax_debruijn.build_chains(ref, use_jax=False)
    got = debruijn.build_chains(port)
    _same_chains(exp, got)
    # the cycle was walked (not emitted whole) and the mirror path halved
    assert not got.is_cycle.any()
    assert got.count == 3


@pytest.mark.parametrize("name,nxt", [
    ("one_cycle", np.roll(np.arange(17), -1)),
    ("two_cycles", np.arange(50) ^ 1),
    ("self_loops", np.arange(10)),
    ("path", np.append(np.arange(1, 101), -1)),
    ("isolated", np.full(100, -1)),
    ("random", None),
])
def test_chains_device_matches_jax(name, nxt):
    if nxt is None:
        rng = np.random.default_rng(0)
        perm = rng.permutation(5000)
        nxt = np.full(5000, -1, np.int64)
        mask = rng.random(5000) < 0.7
        nxt[mask] = perm[mask]
    nxt = np.asarray(nxt, np.int64)
    exp = jax_debruijn._chains_numpy(nxt.copy())
    got = debruijn.chains_device(nxt.copy(), "cpu")
    for e, g in zip(exp, got):
        assert np.array_equal(e, g), name
