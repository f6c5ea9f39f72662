"""The port's match grids (ops/dotplot_grid.py) against the JAX package's
ops/dotplot_pallas.py on the CPU: the Pallas kernels in interpret mode, the
port's plain versions, the same numpy-seeded inputs. Outputs are integers,
so every comparison is exact."""

import numpy as np
import pytest
import torch

from autocycler_tpu.ops import dotplot_pallas as jgrid
from autocycler_tpu_torch import device
from autocycler_tpu_torch.ops import dotplot_grid as grid


def _codes(rng, n):
    return rng.integers(1, 5, size=n).astype(np.uint8)


def _shared_pair(seed, k, n_a=700, chunk=(100, 400), tail=120):
    """A random, and B sharing a chunk of A, so counts are non-zero."""
    rng = np.random.default_rng(seed)
    a = _codes(rng, n_a + k - 1)
    b = np.concatenate([_codes(rng, 300), a[chunk[0]:chunk[1]],
                        _codes(rng, tail + k - 1)])
    return a, b


def _t(words):
    return torch.from_numpy(words)


@pytest.mark.parametrize("k", [4, 5, 16, 17, 32, 55, 100])
def test_pack_2bit_words_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, 300 + k)
    np.testing.assert_array_equal(grid.pack_2bit_words(codes, k),
                                  jgrid.pack_2bit_words(codes, k))
    # int32 wraparound: a word of 16 Ts is -1, as in the JAX package
    assert grid.pack_2bit_words(np.full(16, 4, np.uint8), 16)[0, 0] == -1
    empty = grid.pack_2bit_words(codes[:k - 1], k)
    assert empty.shape == ((k + 15) // 16, 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("k,n_valid", [(5, None), (32, 300), (55, 17),
                                       (16, 0)])
def test_expand_pm1_words_matches_jax(k, n_valid, dtype):
    """Base extraction is an arithmetic shift then & 3 on int32 words,
    including negative (high-bit) words, in torch as in jnp."""
    rng = np.random.default_rng(k)
    words = grid.pack_2bit_words(_codes(rng, 400 + k), k)
    words[:, :5] = -1                                   # poly-T words
    want = np.asarray(jgrid.expand_pm1_words(words, k, n_valid, dtype),
                      dtype=np.float32)
    got = grid.expand_pm1_words(_t(words), k, n_valid, dtype)
    assert got.dtype == grid.IN_DTYPES[dtype]
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("tile", [(256, 256), (128, 512), (1024, 1024)])
def test_match_grid_matches_jax(tile):
    k = 21
    a, b = _shared_pair(1, k)
    aw, bw = grid.pack_2bit_words(a, k), grid.pack_2bit_words(b, k)
    want = np.asarray(jgrid.match_grid(aw, bw, tile_a=tile[0], tile_b=tile[1]))
    got = grid.match_grid(_t(aw), _t(bw), tile_a=tile[0], tile_b=tile[1])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, jgrid.match_grid_reference(aw, bw, tile[0], tile[1]))
    assert want.sum() >= 280


@pytest.mark.parametrize("in_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("k", [5, 32, 55, 1, 8, 64, 65])
def test_match_grid_mxu_matches_jax(k, in_dtype):
    """k = 1 and 8 pad int8 most on the card; k = 64 is the wgmma kernel's
    deepest, k = 65 the generic kernel's shallowest."""
    a, b = _shared_pair(7, k, n_a=500, chunk=(50, 350), tail=200)
    b = b[300:]
    aw, bw = grid.pack_2bit_words(a, k), grid.pack_2bit_words(b, k)
    for tile in (256, 128):
        want = np.asarray(jgrid.match_grid_mxu(aw, bw, k, tile=tile,
                                               in_dtype=in_dtype))
        got = grid.match_grid_mxu(_t(aw), _t(bw), k, tile=tile,
                                  in_dtype=in_dtype)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), grid.match_grid(_t(aw), _t(bw), tile, tile).numpy())
        assert want.sum() > 0


def test_poly_t_padding_never_counts():
    """An all-T k-mer packs to -1, the JAX package's A-pad value: partial
    edge tiles count only real cells in both formulations."""
    k, n = 16, 100
    words = grid.pack_2bit_words(np.full(n + k - 1, 4, np.uint8), k)
    want = np.asarray(jgrid.match_grid(words, words, tile_a=128, tile_b=128))
    assert want[0, 0] == n * n
    w = _t(words)
    np.testing.assert_array_equal(grid.match_grid(w, w, 128, 128).numpy(), want)
    for dtype in grid.IN_DTYPES:
        np.testing.assert_array_equal(
            grid.match_grid_mxu(w, w, k, tile=128, in_dtype=dtype).numpy(),
            want)


def test_zero_kmers_on_one_side_give_a_floor_grid():
    k = 20
    aw = grid.pack_2bit_words(_codes(np.random.default_rng(3), 900), k)
    empty = np.zeros((2, 0), np.int32)
    for a, b in ((aw, empty), (empty, aw), (empty, empty)):
        want = np.asarray(jgrid.match_grid(a, b, tile_a=256, tile_b=256))
        got = grid.match_grid(_t(a), _t(b), 256, 256)
        np.testing.assert_array_equal(got.numpy(), want)
        got = grid.match_grid_mxu(_t(a), _t(b), k, tile=256)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile", [128, 256, 512])
def test_match_tile_cells_matches_jax(tile):
    """The cells of the JAX package's tile bits, in tile then row-major
    order, less the pad cells past the ends (its refinement loop), including
    the spurious edge bits where a poly-T B word meets the A pad (-1)."""
    k = 16
    rng = np.random.default_rng(5)
    a = np.concatenate([_codes(rng, 300), np.full(40, 4, np.uint8)])
    b = np.concatenate([a[:200], np.full(60, 4, np.uint8), _codes(rng, 90)])
    aw, bw = grid.pack_2bit_words(a, k), grid.pack_2bit_words(b, k)
    tiles = np.asarray(jgrid.match_grid(aw, bw, tile_a=tile, tile_b=tile))
    pairs = [tuple(p) for p in np.argwhere(tiles >= 0)]
    bits = jgrid.match_tile_bits(aw, bw, pairs, tile_a=tile, tile_b=tile)
    ii, jj = grid.match_tile_cells(_t(aw), _t(bw), pairs, tile, tile)
    want_i, want_j = [], []
    for (ti, tj), tile_bits in zip(pairs, bits):
        i, j = np.nonzero(jgrid.unpack_tile_bits(tile_bits))
        keep = (i + ti * tile < aw.shape[1]) & (j + tj * tile < bw.shape[1])
        want_i.append(i[keep] + ti * tile)
        want_j.append(j[keep] + tj * tile)
    np.testing.assert_array_equal(ii.numpy(), np.concatenate(want_i))
    np.testing.assert_array_equal(jj.numpy(), np.concatenate(want_j))
    assert (ii.numpy() < aw.shape[1]).all() and len(ii) < int(
        np.unpackbits(bits.view(np.uint8)).sum())         # pads were dropped
    ii, jj = grid.match_tile_cells(_t(aw), _t(bw), [], tile, tile)
    assert ii.dtype == jj.dtype == torch.int64 and len(ii) == len(jj) == 0


@pytest.mark.parametrize("kernel", ["vpu", "mxu", "mxu8"])
def test_benchmark_gcells_runs_on_the_cpu_when_asked(kernel):
    device.reset_counts()
    best, rate = grid.benchmark_gcells(n_a=1024, n_b=512, k=32, repeats=1,
                                       tile=256, kernel=kernel, device="cpu")
    assert best > 0 and rate > 0
    assert sum(device.launches.values()) == 0   # the plain versions ran


def test_kernel_checks_reject_bad_inputs():
    w = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(TypeError):
        grid.match_grid(w.long(), w)
    with pytest.raises(ValueError, match="words per k-mer"):
        grid.match_grid(w, torch.zeros((3, 10), dtype=torch.int32))
    with pytest.raises(ValueError, match="k <= 256"):
        grid.match_grid_mxu(w, w, 257)
    with pytest.raises(ValueError, match="needs 1 words"):
        grid.match_grid_mxu(w, w, 12)
    with pytest.raises(ValueError, match="in_dtype"):
        grid.match_grid_mxu(w, w, 32, in_dtype=torch.float32)
