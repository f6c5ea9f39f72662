"""The +-1 product's wgmma path (ops/dotplot_grid.py, csrc/match_grid.cu) on
the CPU: the dtype-dependent depth padding, the core-matrix layout the bulk
copies read, and the work schedule and attribution of counts to output
tiles, held against the plain version. The schedule here is a model in
torch of pm1_wgmma_kernel's producer and consumer loops in
csrc/match_grid.cu (work unit u is band u % n_bands over chunk u // n_bands
of CHUNK_STAGES B stages); the kernel itself runs only on the card, where
chip_smoke.py's [kernels] phase holds it against the plain version. Outputs
are integers, so every comparison is exact."""

from typing import NamedTuple, Tuple

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from autocycler_tpu_torch.ops import dotplot_grid as grid

CHUNK_STAGES = 256      # B stages a work unit sweeps: CHUNK_STAGES in the .cu


def _words(rng, n, k):
    return torch.from_numpy(grid.pack_2bit_words(
        rng.integers(1, 5, size=n + k - 1).astype(np.uint8), k))


def _shared_words(seed, n_a, n_b, k):
    """Random A, and B repeating A's first k-mers, so counts are non-zero."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 5, size=n_a + k - 1).astype(np.uint8)
    b = rng.integers(1, 5, size=n_b + k - 1).astype(np.uint8)
    take = min(len(a), len(b), max(k, min(len(a), len(b)) // 2))
    b[len(b) - take:] = a[:take]
    return (torch.from_numpy(grid.pack_2bit_words(a, k)),
            torch.from_numpy(grid.pack_2bit_words(b, k)))


@pytest.mark.parametrize("k", [1, 5, 8, 16, 17, 32, 55, 64, 65, 100, 256])
def test_pm1_depth_pads_each_dtype_to_whole_steps(k):
    """wgmma steps 32 bytes of depth: 16 bf16 values but 32 int8 values;
    the generic kernel (k > 64) takes whole 16-deep fragments."""
    bf16, int8 = grid.pm1_depth(k, "bfloat16"), grid.pm1_depth(k, "int8")
    step = (16, 32) if k <= grid.WGMMA_MAX_K else (16, 16)
    assert (bf16 % step[0], int8 % step[1]) == (0, 0)
    assert 2 * k <= bf16 < 2 * k + step[0] and 2 * k <= int8 < 2 * k + step[1]
    if k <= grid.WGMMA_MAX_K:
        assert bf16 * 2 % grid.WGMMA_DEPTH_BYTES == 0
        assert int8 % grid.WGMMA_DEPTH_BYTES == 0 and int8 <= 128


@pytest.mark.parametrize("k", [1, 8, 17])
def test_zero_depth_padding_keeps_int8_dots_exact(k):
    """The zero columns that pad int8 rows to 32 add nothing: the padded
    dot is 2k exactly where the k-mers are equal."""
    rng = np.random.default_rng(k)
    w = _words(rng, 300, k)
    w[:, 7] = w[:, 3]
    pm = grid.expand_pm1_words(w, k, dtype="int8")
    padded = F.pad(pm, (0, grid.pm1_depth(k, "int8") - 2 * k))
    dots = padded.int() @ padded.int().T
    assert torch.equal(dots, pm.int() @ pm.int().T)
    assert dots[3, 7] == 2 * k and dots.diagonal().eq(2 * k).all()


def row_major(core, n):
    """The inverse of pm1_core_layout: the first n rows, [n, depth]."""
    groups, columns, _, per = core.shape
    return core.permute(0, 2, 1, 3).reshape(groups * 8, columns * per)[:n]


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("n,rows", [(1, 256), (7, 128), (8, 128), (255, 256),
                                    (256, 256), (257, 256), (391, 128)])
def test_core_layout_round_trip(n, rows, dtype):
    """The layout holds each 8-row group as [depth bytes / 16][8 rows][16
    bytes], zero rows pad n to whole bands or stages, and it reads back to
    the rows it was made from."""
    k = 21
    pm = F.pad(grid.expand_pm1_words(_words(np.random.default_rng(n), n, k),
                                     k, dtype=dtype),
               (0, grid.pm1_depth(k, dtype) - 2 * k))
    core = grid.pm1_core_layout(pm, rows)
    per = 16 // pm.element_size()
    n_pad = -(-n // rows) * rows
    assert core.shape == (n_pad // 8, pm.shape[1] // per, 8, per)
    assert core.is_contiguous() and core.dtype == pm.dtype
    assert torch.equal(row_major(core, n), pm)
    assert not row_major(core, n_pad)[n:].any()
    flat = core.reshape(-1)
    group_elems = 8 * pm.shape[1]
    for r in (0, n - 1):
        g, i = divmod(r, 8)
        for c in range(pm.shape[1] // per):
            at = g * group_elems + (c * 8 + i) * per
            assert torch.equal(flat[at:at + per], pm[r, c * per:(c + 1) * per])


def test_core_layout_rejects_a_partial_column():
    with pytest.raises(ValueError, match="core-matrix"):
        grid.pm1_core_layout(torch.zeros((8, 12), dtype=torch.bfloat16), 8)


class Plan(NamedTuple):
    """The kernel's work: A in n_bands bands of WGMMA_BAND rows, B in
    n_stages stages of WGMMA_STAGE rows; work unit u is band u % n_bands
    over the chunk_stages stages of chunk u // n_bands."""
    n_bands: int
    n_stages: int
    chunk_stages: int

    @property
    def units(self) -> int:
        return self.n_bands * -(-self.n_stages // self.chunk_stages)

    def unit(self, u: int) -> Tuple[int, range]:
        """(band, B stages) of work unit u."""
        s0 = (u // self.n_bands) * self.chunk_stages
        return u % self.n_bands, range(s0, min(s0 + self.chunk_stages,
                                               self.n_stages))


def pm1_plan(n_a, n_b, chunk_stages=CHUNK_STAGES):
    """The band and stage counts the wrapper passes to the kernel."""
    return Plan(max(1, -(-n_a // grid.WGMMA_BAND)),
                max(1, -(-n_b // grid.WGMMA_STAGE)), chunk_stages)


@pytest.mark.parametrize("chunk", [1, 3, 64])
@pytest.mark.parametrize("n_a,n_b", [(1, 1), (255, 129), (257, 1000),
                                     (1031, 385)])
def test_pm1_plan_covers_every_band_and_stage_once(n_a, n_b, chunk):
    plan = pm1_plan(n_a, n_b, chunk)
    assert plan.n_bands * grid.WGMMA_BAND >= n_a > (plan.n_bands - 1) * 256
    assert plan.n_stages * grid.WGMMA_STAGE >= n_b > (plan.n_stages - 1) * 128
    seen = [(band, s) for u in range(plan.units)
            for band, stages in [plan.unit(u)] for s in stages]
    assert sorted(seen) == [(band, s) for band in range(plan.n_bands)
                            for s in range(plan.n_stages)]
    for u in range(plan.units - 1):              # band-fastest, chunk by chunk
        (b0, s0), (b1, s1) = plan.unit(u), plan.unit(u + 1)
        assert b1 == (b0 + 1) % plan.n_bands
        assert s1.start == s0.start + (chunk if b1 == 0 else 0)


def emulate_wgmma_grid(a_words, b_words, k, tile_a, tile_b, dtype,
                       chunk_stages, blocks):
    """The wgmma kernel's loop in torch: `blocks` persistent blocks
    stride over the plan's work units; each of a block's two consumer
    warpgroups multiplies its 128 band rows by every 128-row stage of the
    unit from the core-matrix layout, keeps a count across the stages of one
    output tile and adds it to the tile when the tile changes and at the
    unit's end, skipping zero counts and rows past the grid."""
    n_a, n_b = a_words.shape[1], b_words.shape[1]
    ga, gb = -(-n_a // tile_a), -(-n_b // tile_b)
    depth = grid.pm1_depth(k, dtype)
    plan = pm1_plan(n_a, n_b, chunk_stages)
    a_core, b_core = (
        grid.pm1_core_layout(F.pad(grid.expand_pm1_words(w, k, dtype=dtype),
                                   (0, depth - 2 * k)), rows)
        for w, rows in ((a_words, grid.WGMMA_BAND), (b_words, grid.WGMMA_STAGE)))
    a = row_major(a_core, plan.n_bands * grid.WGMMA_BAND).float()
    b = row_major(b_core, plan.n_stages * grid.WGMMA_STAGE).float()
    out = torch.zeros((max(ga, 1), max(gb, 1)), dtype=torch.int32)
    adds = []

    def flush(count, ti, tj):
        if count and ti < ga:
            out[ti, tj] += count
            adds.append((ti, tj))

    for block in range(min(blocks, plan.units)):
        for u in range(block, plan.units, blocks):
            band, stages = plan.unit(u)
            for wg in range(2):
                row0 = band * grid.WGMMA_BAND + wg * 128
                ti = row0 // tile_a
                tj = stages.start * grid.WGMMA_STAGE // tile_b
                count = 0
                for s in stages:
                    stage_tj = s * grid.WGMMA_STAGE // tile_b
                    if stage_tj != tj:
                        flush(count, ti, tj)
                        count, tj = 0, stage_tj
                    dots = a[row0:row0 + 128] @ b[s * 128:(s + 1) * 128].T
                    count += int((dots == 2 * k).sum())
                flush(count, ti, tj)
    return out, adds


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("tiles,n_a,n_b,k", [
    ((128, 128), 1, 1, 8), ((128, 128), 255, 257, 16),
    ((128, 128), 3 * 256 + 7, 600, 1), ((128, 256), 3 * 256 + 7, 3 * 256 + 7, 17),
    ((128, 256), 256, 255, 64), ((256, 256), 257, 1000, 32),
    ((1024, 1024), 1023, 1025, 5), ((384, 640), 1000, 1300, 31)])
@pytest.mark.parametrize("chunk,blocks", [(1, 3), (2, 132), (64, 1)])
def test_wgmma_schedule_counts_each_output_tile(tiles, n_a, n_b, k, dtype,
                                                chunk, blocks):
    a, b = _shared_words(n_a + n_b + k, n_a, n_b, k)
    want = grid.match_grid_mxu_plain(a, b, k, tile_a=tiles[0], tile_b=tiles[1],
                                     in_dtype=dtype)
    got, adds = emulate_wgmma_grid(a, b, k, *tiles, dtype, chunk, blocks)
    assert torch.equal(got, want)
    assert want.sum() > 0
    # a warpgroup's count goes to one tile per run of stages in that tile
    tiles_b_per_chunk = -(-chunk * 128 // tiles[1]) + 1
    units = pm1_plan(n_a, n_b, chunk).units
    assert len(adds) <= units * 2 * tiles_b_per_chunk


def test_wgmma_schedule_counts_poly_t_only_inside_the_grid():
    """All-T k-mers pack to -1 words; the zero rows padding the last band
    and stage never reach 2k, so only real cells count."""
    k, n = 16, 3 * 128 + 7
    words = grid.pack_2bit_words(np.full(n + k - 1, 4, np.uint8), k)
    w = torch.from_numpy(words)
    for dtype in grid.IN_DTYPES:
        got, _ = emulate_wgmma_grid(w, w, k, 128, 128, dtype, 2, 3)
        assert torch.equal(got, grid.match_grid_plain(w, w, 128, 128))
        assert int(got.sum()) == n * n
