"""The port's sequence-end repair (grouped h-gram scan on the device path)
against the JAX package's, on the CPU: the same dotted contigs, handed to
both packages, must come out repaired byte for byte alike."""

import random

import numpy as np
import pytest

from autocycler_tpu.models import Sequence as JaxSequence
from autocycler_tpu.ops import end_repair as jax_end_repair
from autocycler_tpu_torch.models import Sequence
from autocycler_tpu_torch.ops import end_repair

import synthetic


def _contigs(seed):
    """Rotated and reverse-complemented copies of one circular genome, with
    SNPs (ends repaired from other copies), plus a contig found nowhere else
    (its ends keep their dots) and a repeat-rich one (many candidates)."""
    rng = random.Random(seed)
    genome = synthetic.random_genome(rng, 1500)
    contigs = []
    for i in range(4):
        c = synthetic.rotate(genome, rng.randrange(len(genome)))
        if i % 2:
            c = synthetic.revcomp(c)
        contigs.append(synthetic.mutate(rng, c, 3))
    contigs.append(synthetic.random_genome(rng, 300))
    unit = synthetic.random_genome(rng, 40)
    contigs.append(unit * 12)
    return contigs


@pytest.mark.parametrize("seed,k", [(0, 51), (1, 51), (2, 11), (3, 25)])
def test_end_repair_matches_jax(seed, k):
    contigs = _contigs(seed)
    ref = [JaxSequence.with_seq(i + 1, c, "a.fasta", f"c{i}", k // 2)
           for i, c in enumerate(contigs)]
    port = [Sequence.with_seq(i + 1, c, "a.fasta", f"c{i}", k // 2)
            for i, c in enumerate(contigs)]
    jax_end_repair.sequence_end_repair(ref, k, threads=1)
    end_repair.sequence_end_repair(port, k, device="cpu")
    for r, p in zip(ref, port):
        assert r.forward_seq.tobytes() == p.forward_seq.tobytes()
        assert r.reverse_seq.tobytes() == p.reverse_seq.tobytes()
    assert port[0].forward_seq[0] != ord(".")
    if k >= 25:
        # the unique contig's end cores occur nowhere else: dots stay
        assert port[4].forward_seq[0] == ord(".")


@pytest.mark.parametrize("h", (5, 25))
def test_matches_by_query_matches_jax(h):
    rng = np.random.default_rng(h)
    text_len = rng.integers(h + 1, 400, size=9).astype(np.int64)
    text_off = np.concatenate([[0], np.cumsum(text_len)[:-1]]).astype(np.int64)
    codes = rng.integers(1, 3, size=int(text_len.sum())).astype(np.uint8)
    q_starts = np.concatenate([text_off + 1, text_off + text_len - h])
    exp = jax_end_repair._matches_by_query_grouped(codes, text_off, text_len,
                                                   h, q_starts, use_jax=False,
                                                   threads=1)
    got = end_repair._matches_by_query_grouped(codes, text_off, text_len, h,
                                               q_starts, device="cpu")
    assert len(exp) == len(got)
    for (et, ep), (gt, gp) in zip(exp, got):
        assert np.array_equal(et, gt) and np.array_equal(ep, gp)
