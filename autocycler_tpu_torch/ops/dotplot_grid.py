"""Tile-level k-mer match grids: the two match-grid kernels and their plain
versions.

The port of the JAX package's ops/dotplot_pallas.py. Every k-mer of A is
compared with every k-mer of B, an nA x nB cell grid, and the matches are
counted per tile pair: ``out[ti, tj]`` is the number of cells of rows
``ti*tile_a ...`` and columns ``tj*tile_b ...`` whose k-mers are equal. The
exact pixel-level dotplot uses the sort-join in commands/dotplot.py; this
grid serves ``dotplot --grid-mode device`` (coarse counts, then exact
per-tile refinement) and the Gcells/s benchmark.

Two formulations, each a hand-written kernel in csrc/match_grid.cu for CUDA
tensors and a plain PyTorch version for CPU tensors:

- :func:`match_grid` (JAX counterpart ``match_grid``, Pallas
  ``_grid_kernel``): k-mers packed 16 bases per int32 word, W = ceil(k/16)
  words per k-mer; a cell matches when all W words are equal.
- :func:`match_grid_mxu` (JAX ``match_grid_mxu``, Pallas ``_mxu_kernel``):
  each k-mer becomes a row of 2k values of +-1 (:func:`expand_pm1_words`)
  and a cell matches when its dot product equals 2k, a product on the
  tensor cores in bf16 (f32 sums) or int8 (int32 sums): a wgmma kernel fed
  by bulk copies for k <= 64, the generic wmma kernel above.

2-bit words have no out-of-band value (a poly-T word is -1), so tile edges
are masked by global index: the kernels and plain versions never see a pad.
Only the exact refinement of selected tiles (:func:`match_tile_cells`) pads
as the JAX package does (A with -1, B with -2), so edge cells past the ends
can match there and are dropped.
"""

from __future__ import annotations

import ctypes
import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as _device
from ..device import resolve_device

TILE_A = 512
TILE_B = 512
TILE_MXU = 1024
KERNEL_WORDS = "dotplot_match_grid"
KERNEL_PM1 = "dotplot_match_grid_mxu"
MAX_WORDS = 16              # the word kernel's largest k-mer: k <= 256
MXU_BLOCK = 128             # the product kernel's cell block; tiles are multiples
FRAGMENT_DEPTH = 16         # the generic (wmma) kernel's fragment depth
WGMMA_MAX_K = 64            # k up to which the wgmma kernel runs (depth <= 128)
WGMMA_DEPTH_BYTES = 32      # wgmma's depth step: 16 bf16 or 32 int8 values
WGMMA_BAND = 256            # A rows resident in a block of the wgmma kernel
WGMMA_STAGE = 128           # B rows of one stage of its ring (wgmma N)
CORE_ROWS = 8               # a core matrix: 8 rows x 16 bytes
IN_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}
# cells of one plain-version chunk, and bool cells of one refinement chunk
_PLAIN_CELLS = 1 << 28
_TILE_CELLS = 1 << 26


def pack_2bit_words(codes: np.ndarray, k: int) -> np.ndarray:
    """ACGT codes (1..4 from ops.encode) -> [W, n] int32 k-mer words,
    16 bases per word, zero-padded tail. n = len(codes) - k + 1."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(((k + 15) // 16, 0), dtype=np.int32)
    W = (k + 15) // 16
    base2 = (codes.astype(np.int32) - 1).clip(0, 3)
    words = np.zeros((W, n), dtype=np.int32)
    for w in range(W):
        acc = np.zeros(n, dtype=np.int32)
        for t in range(16):
            idx = w * 16 + t
            acc <<= 2
            if idx < k:
                acc |= base2[idx:idx + n]
        words[w] = acc
    return words


def _grid(n_a: int, n_b: int, tile_a: int, tile_b: int) -> Tuple[int, int]:
    return -(-n_a // tile_a), -(-n_b // tile_b)


def _zero_grid(ga: int, gb: int, device) -> torch.Tensor:
    """Zero k-mers on a side give a 1x-floor grid of zeros, the JAX
    package's shape convention (max(n, 1))."""
    return torch.zeros((max(ga, 1), max(gb, 1)), dtype=torch.int32,
                       device=device)


def _check_words(a_words: torch.Tensor, b_words: torch.Tensor) -> None:
    for name, t in (("a_words", a_words), ("b_words", b_words)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D int32 tensor [W, n]")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_words.shape[0] != b_words.shape[0]:
        raise ValueError(f"a_words has {a_words.shape[0]} words per k-mer, "
                         f"b_words {b_words.shape[0]}")
    if a_words.device != b_words.device:
        raise ValueError(f"a_words on {a_words.device} but b_words on "
                         f"{b_words.device}")


def _tile_sums(eq: torch.Tensor, tile_a: int, tile_b: int,
               gb: int) -> torch.Tensor:
    """[R, n_b] bool (R rows starting on a tile boundary) -> [ceil(R /
    tile_a), gb] int32 match counts."""
    R, n_b = eq.shape
    ra = -(-R // tile_a)
    padded = torch.zeros((ra * tile_a, gb * tile_b), dtype=torch.bool,
                         device=eq.device)
    padded[:R, :n_b] = eq
    return padded.view(ra, tile_a, gb, tile_b).sum(dim=(1, 3),
                                                   dtype=torch.int32)


def _row_chunk(tile_a: int, tile_b: int, gb: int) -> int:
    """Rows per plain-version chunk: whole tile rows, about _PLAIN_CELLS."""
    return tile_a * max(1, _PLAIN_CELLS // (tile_a * tile_b * gb))


def match_grid_plain(a_words: torch.Tensor, b_words: torch.Tensor,
                     tile_a: int = TILE_A, tile_b: int = TILE_B
                     ) -> torch.Tensor:
    """The plain PyTorch version of the word-compare kernel: broadcast
    equality of every word over row chunks of whole tiles, summed per
    tile."""
    _check_words(a_words, b_words)
    W, n_a = a_words.shape
    n_b = b_words.shape[1]
    ga, gb = _grid(n_a, n_b, tile_a, tile_b)
    out = _zero_grid(ga, gb, a_words.device)
    if ga == 0 or gb == 0:
        return out
    rows = _row_chunk(tile_a, tile_b, gb)
    for r0 in range(0, n_a, rows):
        a = a_words[:, r0:r0 + rows]
        eq = a[0][:, None] == b_words[0][None, :]
        for w in range(1, W):
            eq &= a[w][:, None] == b_words[w][None, :]
        sums = _tile_sums(eq, tile_a, tile_b, gb)
        out[r0 // tile_a:r0 // tile_a + len(sums)] = sums
    return out


def _lib():
    from ._build import load
    lib = load("match_grid")
    if lib.match_grid_words.argtypes is None:
        lib.match_grid_words.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.match_grid_words.restype = ctypes.c_int
        lib.match_grid_pm1.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.match_grid_pm1.restype = ctypes.c_int
        ll = ctypes.c_longlong
        lib.match_grid_pm1_wgmma.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ll, ll, ll, ll,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.match_grid_pm1_wgmma.restype = ctypes.c_int
        lib.match_grid_pm1_wgmma_shape.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.match_grid_pm1_wgmma_shape.restype = ctypes.c_int
    return lib


def match_grid_cuda(a_words: torch.Tensor, b_words: torch.Tensor,
                    tile_a: int = TILE_A, tile_b: int = TILE_B
                    ) -> torch.Tensor:
    """Launch the word-compare kernel of csrc/match_grid.cu. Raises on a
    tensor that is not on a CUDA device."""
    _check_words(a_words, b_words)
    if not a_words.is_cuda:
        raise ValueError("match_grid_cuda needs CUDA tensors")
    W, n_a = a_words.shape
    n_b = b_words.shape[1]
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"the word kernel takes 1..{MAX_WORDS} words per "
                         f"k-mer, not {W}")
    if tile_a < 1 or tile_b < 1:
        raise ValueError("tiles must be positive")
    ga, gb = _grid(n_a, n_b, tile_a, tile_b)
    out = _zero_grid(ga, gb, a_words.device)
    if ga and gb:
        _device.launch(KERNEL_WORDS, a_words.device, _lib().match_grid_words,
                       a_words.data_ptr(), n_a, b_words.data_ptr(), n_b, W,
                       tile_a, tile_b, out.data_ptr())
    return out


def match_grid(a_words: torch.Tensor, b_words: torch.Tensor,
               tile_a: int = TILE_A, tile_b: int = TILE_B) -> torch.Tensor:
    """[W, nA] x [W, nB] int32 k-mer words -> [ceil(nA/tile_a),
    ceil(nB/tile_b)] int32 match counts: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (a dispatch of the run record, not a
    launch)."""
    if a_words.is_cuda:
        return match_grid_cuda(a_words, b_words, tile_a, tile_b)
    with _device.device_work(KERNEL_WORDS, a_words.device):
        return match_grid_plain(a_words, b_words, tile_a, tile_b)


def _in_dtype(dtype) -> torch.dtype:
    """"bfloat16" / "int8" or the torch dtype itself; nothing else."""
    if dtype in IN_DTYPES.values():
        return dtype
    if dtype not in IN_DTYPES:
        raise ValueError(f"in_dtype must be one of {sorted(IN_DTYPES)}")
    return IN_DTYPES[dtype]


def expand_pm1_words(words: torch.Tensor, k: int, n_valid: int = None,
                     dtype="bfloat16") -> torch.Tensor:
    """Bit-antipodal expansion: [W, n] packed int32 words -> [n, 2k] where
    column 2*p + b is +1 if bit b of base p is set, else -1 (b = 0 the high
    bit). Two such rows dot to 2k - 2*hamming(bits), so two k-mers are equal
    iff their rows dot to exactly 2k. Rows at index >= n_valid are zero and
    dot to 0 against anything."""
    W, n = words.shape
    p = torch.arange(k, device=words.device)
    shift = (2 * (15 - p % 16)).to(torch.int32)[:, None]
    base = (words[p // 16] >> shift) & 3            # [k, n], arithmetic shift
    bits = torch.stack([base >> 1, base & 1], dim=1).reshape(2 * k, n)
    pm = (bits.to(torch.int8) * 2 - 1).T.to(_in_dtype(dtype))
    if n_valid is not None and n_valid < n:
        pm[n_valid:] = 0
    return pm.contiguous()


def _check_mxu(a_words, b_words, k, tile, tile_a, tile_b):
    _check_words(a_words, b_words)
    if not 1 <= k <= 256:
        raise ValueError("match_grid_mxu requires 1 <= k <= 256")
    if a_words.shape[0] != (k + 15) // 16:
        raise ValueError(f"k={k} needs {(k + 15) // 16} words per k-mer, "
                         f"not {a_words.shape[0]}")
    return (tile if tile_a is None else tile_a,
            tile if tile_b is None else tile_b)


def match_grid_mxu_plain(a_words: torch.Tensor, b_words: torch.Tensor, k: int,
                         tile: int = TILE_MXU, tile_a: int = None,
                         tile_b: int = None, in_dtype="bfloat16"
                         ) -> torch.Tensor:
    """The plain PyTorch version of the product kernel: the +-1 rows in the
    input type, multiplied in float32 (exact: |dot| <= 512) over row chunks
    of whole tiles, cells equal to 2k counted per tile."""
    tile_a, tile_b = _check_mxu(a_words, b_words, k, tile, tile_a, tile_b)
    n_a, n_b = a_words.shape[1], b_words.shape[1]
    ga, gb = _grid(n_a, n_b, tile_a, tile_b)
    out = _zero_grid(ga, gb, a_words.device)
    if ga == 0 or gb == 0:
        return out
    a_pm = expand_pm1_words(a_words, k, dtype=in_dtype).float()
    b_pm = expand_pm1_words(b_words, k, dtype=in_dtype).float()
    rows = _row_chunk(tile_a, tile_b, gb)
    for r0 in range(0, n_a, rows):
        eq = (a_pm[r0:r0 + rows] @ b_pm.T) == 2 * k
        sums = _tile_sums(eq, tile_a, tile_b, gb)
        out[r0 // tile_a:r0 // tile_a + len(sums)] = sums
    return out


def pm1_depth(k: int, dtype) -> int:
    """Columns the +-1 rows are zero-padded to: whole 32-byte wgmma depth
    steps (16 bf16 or 32 int8 values) for the wgmma kernel (k <= 64), whole
    16-deep fragments for the generic kernel. Zero columns add 0 to every
    dot."""
    step = (WGMMA_DEPTH_BYTES // _in_dtype(dtype).itemsize
            if k <= WGMMA_MAX_K else FRAGMENT_DEPTH)
    return -(-2 * k // step) * step


def pm1_core_layout(pm: torch.Tensor, rows: int) -> torch.Tensor:
    """[n, depth] +-1 rows -> the wgmma kernel's core-matrix layout: zero
    rows pad n to a multiple of ``rows`` (at least one), and each group of 8
    rows is stored as [depth bytes / 16][8 rows][16 bytes], so any run of
    whole groups is one contiguous copy. Returns [n_pad / 8, depth bytes /
    16, 8, 16 bytes] in pm's dtype."""
    n, depth = pm.shape
    per = 16 // pm.element_size()
    if depth % per:
        raise ValueError(f"depth {depth} is not a whole number of 16-byte "
                         "core-matrix columns")
    n_pad = max(1, -(-n // rows)) * rows
    padded = F.pad(pm, (0, 0, 0, n_pad - n))
    return padded.view(n_pad // CORE_ROWS, CORE_ROWS, depth // per,
                       per).permute(0, 2, 1, 3).contiguous()


def pm1_wgmma_shape(row_bytes: int) -> Tuple[int, int]:
    """(ring stages, dynamic shared memory bytes) of a wgmma-kernel block at
    ``row_bytes`` on the current CUDA device."""
    stages, smem = ctypes.c_int(), ctypes.c_int()
    _device.check(KERNEL_PM1, _lib().match_grid_pm1_wgmma_shape(
        row_bytes, ctypes.byref(stages), ctypes.byref(smem)))
    return stages.value, smem.value


def match_grid_mxu_cuda(a_words: torch.Tensor, b_words: torch.Tensor, k: int,
                        tile: int = TILE_MXU, tile_a: int = None,
                        tile_b: int = None, in_dtype="bfloat16"
                        ) -> torch.Tensor:
    """Expand both sides to +-1 rows on the card, zero-padded to
    :func:`pm1_depth`, and launch a tensor-core kernel of
    csrc/match_grid.cu: for k <= 64 the wgmma kernel on operands in
    core-matrix layout (:func:`pm1_core_layout`, A padded to whole bands, B
    to whole stages), above that the generic wmma kernel on row-major
    operands. Raises on a tensor that is not on a CUDA device and on tiles
    that are not multiples of 128."""
    tile_a, tile_b = _check_mxu(a_words, b_words, k, tile, tile_a, tile_b)
    if not a_words.is_cuda:
        raise ValueError("match_grid_mxu_cuda needs CUDA tensors")
    if tile_a % MXU_BLOCK or tile_b % MXU_BLOCK or tile_a < 1 or tile_b < 1:
        raise ValueError(f"the product kernel needs tiles that are positive "
                         f"multiples of {MXU_BLOCK}, not {tile_a}x{tile_b}")
    dtype = _in_dtype(in_dtype)
    n_a, n_b = a_words.shape[1], b_words.shape[1]
    ga, gb = _grid(n_a, n_b, tile_a, tile_b)
    depth = pm1_depth(k, dtype)
    out = _zero_grid(ga, gb, a_words.device)
    if not (ga and gb):
        return out
    a_pm = F.pad(expand_pm1_words(a_words, k, dtype=dtype), (0, depth - 2 * k))
    b_pm = F.pad(expand_pm1_words(b_words, k, dtype=dtype), (0, depth - 2 * k))
    is_int8 = int(dtype == torch.int8)
    if k <= WGMMA_MAX_K:
        a_core = pm1_core_layout(a_pm, WGMMA_BAND)
        b_core = pm1_core_layout(b_pm, WGMMA_STAGE)
        _device.launch(KERNEL_PM1, a_words.device,
                       _lib().match_grid_pm1_wgmma, a_core.data_ptr(),
                       b_core.data_ptr(), depth * dtype.itemsize, 2 * k,
                       is_int8, tile_a, tile_b, -(-n_a // WGMMA_BAND),
                       -(-n_b // WGMMA_STAGE), ga, gb, out.data_ptr())
    else:
        a_pm, b_pm = a_pm.contiguous(), b_pm.contiguous()
        _device.launch(KERNEL_PM1, a_words.device, _lib().match_grid_pm1,
                       a_pm.data_ptr(), n_a, b_pm.data_ptr(), n_b, depth,
                       2 * k, is_int8, tile_a, tile_b, out.data_ptr())
    return out


def match_grid_mxu(a_words: torch.Tensor, b_words: torch.Tensor, k: int,
                   tile: int = TILE_MXU, tile_a: int = None,
                   tile_b: int = None, in_dtype="bfloat16") -> torch.Tensor:
    """The product formulation of :func:`match_grid`, with the same tile
    counts: the tensor-core kernel for CUDA tensors, the plain version for
    CPU tensors. ``in_dtype`` is "bfloat16" (f32 sums) or "int8" (int32
    sums); both are exact for k <= 256."""
    if a_words.is_cuda:
        return match_grid_mxu_cuda(a_words, b_words, k, tile, tile_a, tile_b,
                                   in_dtype)
    with _device.device_work(KERNEL_PM1, a_words.device):
        return match_grid_mxu_plain(a_words, b_words, k, tile, tile_a,
                                    tile_b, in_dtype)


def _pad_words(words: torch.Tensor, tile: int, fill: int) -> torch.Tensor:
    W, n = words.shape
    padded = -(-n // tile) * tile
    if padded == n:
        return words
    out = torch.full((W, max(padded, tile)), fill, dtype=torch.int32,
                     device=words.device)
    out[:, :n] = words
    return out


def _tile_equality(a_pad: torch.Tensor, b_pad: torch.Tensor,
                   pairs: torch.Tensor, tile_a: int,
                   tile_b: int) -> torch.Tensor:
    """[t, tile_a, tile_b] bool equality matrices of the tile pairs
    ([t, 2]) of tile-padded words."""
    ra = torch.arange(tile_a, device=a_pad.device)
    rb = torch.arange(tile_b, device=a_pad.device)
    a = a_pad[:, pairs[:, 0, None] * tile_a + ra]           # [W, t, tile_a]
    b = b_pad[:, pairs[:, 1, None] * tile_b + rb]           # [W, t, tile_b]
    eq = a[0][:, :, None] == b[0][:, None, :]
    for w in range(1, a_pad.shape[0]):
        eq &= a[w][:, :, None] == b[w][:, None, :]
    return eq


def match_tile_cells(a_words: torch.Tensor, b_words: torch.Tensor, tile_pairs,
                     tile_a: int = TILE_A, tile_b: int = TILE_B
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact refinement of selected tiles (``tile_pairs``, [T, 2]): the
    matching cells as global (i, j) int64 indices, tile by tile in
    ``tile_pairs`` order and row-major within a tile, the order in which the
    JAX package unpacks its ``match_tile_bits``. As there, A is padded with
    -1 and B with -2, so edge-tile pad cells can match (a poly-T word is
    -1); cells past n_a, n_b are dropped. Computed in chunks of about
    _TILE_CELLS cells."""
    _check_words(a_words, b_words)
    pairs = torch.as_tensor(tile_pairs, dtype=torch.int64,
                            device=a_words.device).reshape(-1, 2)
    chunk = max(1, _TILE_CELLS // (tile_a * tile_b))
    a_pad = _pad_words(a_words, tile_a, -1)
    b_pad = _pad_words(b_words, tile_b, -2)
    n_a, n_b = a_words.shape[1], b_words.shape[1]
    iis, jjs = [], []
    for lo in range(0, len(pairs), chunk):
        p = pairs[lo:lo + chunk]
        t, ii, jj = torch.nonzero(
            _tile_equality(a_pad, b_pad, p, tile_a, tile_b), as_tuple=True)
        ii = ii + p[t, 0] * tile_a
        jj = jj + p[t, 1] * tile_b
        keep = (ii < n_a) & (jj < n_b)
        iis.append(ii[keep])
        jjs.append(jj[keep])
    if not iis:
        z = torch.zeros(0, dtype=torch.int64, device=a_words.device)
        return z, z
    return torch.cat(iis), torch.cat(jjs)


def benchmark_gcells(n_a: int = 524288, n_b: int = 524288, k: int = 32,
                     repeats: int = 3, tile: int = 2048, tile_b: int = None,
                     seed: int = 0, kernel: str = "vpu",
                     device=None) -> Tuple[float, float]:
    """Time the match grid; returns (best seconds, Gcells/s). kernel="vpu"
    is the word-compare kernel, "mxu" the +-1 product with bf16 inputs,
    "mxu8" the same with int8 inputs and int32 sums. The word kernel's B
    tile defaults to 2*tile; pass tile_b to measure other shapes. The
    product kernel uses square ``tile`` tiles.

    Every trial uses freshly generated inputs, uploaded inside the timed
    call, and the grid is reduced to a number on the host before the clock
    stops."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def fresh_words(n):
        return pack_2bit_words(
            rng.integers(1, 5, size=n + k - 1).astype(np.uint8), k)

    if tile_b is None:
        tb = 2 * tile if kernel == "vpu" else tile
    else:
        tb = tile_b

    def run(a_w, b_w):
        a = torch.from_numpy(a_w).to(dev)
        b = torch.from_numpy(b_w).to(dev)
        if kernel == "mxu":
            grid = match_grid_mxu(a, b, k, tile_a=tile, tile_b=tb)
        elif kernel == "mxu8":
            grid = match_grid_mxu(a, b, k, tile_a=tile, tile_b=tb,
                                  in_dtype="int8")
        else:
            grid = match_grid(a, b, tile_a=tile, tile_b=tb)
        return int(grid.sum(dtype=torch.int64))

    run(fresh_words(n_a), fresh_words(n_b))  # build + warm up
    best = float("inf")
    for _ in range(repeats):
        a_w, b_w = fresh_words(n_a), fresh_words(n_b)
        t0 = time.perf_counter()
        run(a_w, b_w)
        best = min(best, time.perf_counter() - t0)
    cells = float(n_a) * float(n_b)
    return best, cells / best / 1e9
