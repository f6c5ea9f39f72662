"""The minimizer hashing as torch ops (autocycler_tpu_torch/ops/sketch.py)
against the JAX package's numpy hashing (autocycler_tpu/ops/sketch.py), on
CPU tensors, with tolerance 0: the base-5 packs, splitmix64 in int64 with
two's-complement wrap and masked logical shifts, the uint32 fold, the
window minima and the bottom-s sketches are equal bit for bit, including
k = 27, dotted strands and strands shorter than one window."""

import numpy as np
import pytest
import torch

from autocycler_tpu.ops import encode as jax_encode
from autocycler_tpu.ops import sketch as jsk
from autocycler_tpu_torch.ops import encode
from autocycler_tpu_torch.ops import sketch as sk


def _codes(rng, n: int, dots: int = 0) -> np.ndarray:
    codes = rng.integers(1, 5, size=n).astype(np.uint8)
    if dots:
        codes[rng.integers(0, n, size=dots)] = 0
    return codes


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def test_shr_is_logical():
    z = torch.tensor([-1, -(1 << 63), 1 << 62, 12345], dtype=torch.int64)
    for s in (1, 27, 30, 31, 32, 63):
        want = [(int(v) % (1 << 64)) >> s for v in z]
        assert sk._shr(z, s).tolist() == want, s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splitmix64_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 63, size=50_000, dtype=np.int64).view(np.uint64)
    x[::2] |= np.uint64(1 << 63)          # the top bit set on half of them
    x[:4] = np.array([0, 1, 0xFFFFFFFFFFFFFFFF, 5 ** 27 - 1], np.uint64)
    want = jsk._splitmix64(x)
    got = sk._splitmix64(_t(x.view(np.int64)))
    assert got.dtype == torch.int64
    assert got.numpy().view(np.uint64).tobytes() == want.tobytes()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 11, 13, 21, 27])
def test_pack_poly_matches_jax(k, reverse):
    codes = _codes(np.random.default_rng(k), 4000, dots=50)
    codes[:30] = 4                         # the largest pack, TTT...T
    want = jsk._pack_poly(codes, k, reverse=reverse)
    got = sk._pack_poly(_t(codes), k, reverse=reverse)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) <= 5 ** k - 1


@pytest.mark.parametrize("k", [4, 11, 21, 27])
def test_kmer_hashes_match_jax(k):
    codes = _codes(np.random.default_rng(100 + k), 20_000, dots=300)
    want = jsk._kmer_hashes(codes, k)
    got = sk._kmer_hashes(_t(codes), k)
    assert got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("w", [1, 2, 3, 7, 11, 16, 17])
def test_window_minima_match_jax(w):
    vals = np.random.default_rng(w).integers(
        0, 1 << 32, size=5000, dtype=np.int64).astype(np.uint32)
    want = jsk._window_minima(vals, w)
    got = sk._window_minima(_t(vals.astype(np.int64)), w)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def _strands(rng, k: int, w: int):
    """ASCII contigs: random, dotted inside, dot-padded, one base short of
    a window of k + w - 1 bases, exactly one window, all dots and poly-A."""
    body = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=6000)]
    dotted = body.copy()
    dotted[rng.integers(0, len(dotted), size=60)] = ord(".")
    dot = np.full(k // 2, ord("."), np.uint8)
    window = k + w - 1
    return {"random": body, "dotted": dotted,
            "padded": np.concatenate([dot, body[:2000], dot]),
            "short": body[:window - 1], "one_window": body[:window],
            "dots": np.full(window + 10, ord("."), np.uint8),
            "poly_a": np.full(700, ord("A"), np.uint8)}


@pytest.mark.parametrize("w", [1, 11])
@pytest.mark.parametrize("k", [4, 11, 21, 27])
def test_sketch_from_codes_matches_jax(k, w):
    rng = np.random.default_rng(10 * k + w)
    for s in (1, 64, 1024):
        for name, seq in _strands(rng, k, w).items():
            fwd, rc = encode.encode_both_strands(seq)
            want, want_m = jsk.sketch_from_codes(
                *jax_encode.encode_both_strands(seq), k, w, s)
            got, m = sk.sketch_from_codes(_t(fwd), _t(rc), k, w, s)
            assert m == want_m, (name, s)
            assert got.dtype == torch.int64 and got.shape == (s,)
            assert got.numpy().astype(np.uint32).tobytes() == \
                want.tobytes(), (name, s)
            if name in ("short", "dots"):
                assert m == 0
