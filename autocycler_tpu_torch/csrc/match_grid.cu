// Tile-level k-mer match counts for Hopper: two kernels computing the same
// function, out[ti, tj] = the number of cells (i, j) of tile pair (ti, tj)
// whose k-mers are equal.
//
// 1. word_grid_kernel replaces the TPU kernel ops/dotplot_pallas.py:
//    _grid_kernel (the VPU word-compare grid behind match_grid) of the JAX
//    package. Inputs are k-mers packed 16 bases per int32 word, W words per
//    k-mer, as [W, n] arrays; a cell matches when all W words are equal.
//
//    What bounds it: operations. A cell needs at least W + 1 instructions
//    (W word compares chained through one predicate, then a predicated add)
//    and reads nothing new: at 524,288 x 524,288 and k = 32 (W = 2) that is
//    ~8.2e11 instructions against 4 MB of input, so instruction issue (132
//    SMs x 128 lanes x ~1.98 GHz, ~25 ms), not the memory, sets the floor.
//
//    What the design does about it: every thread keeps ROWS A k-mers in
//    registers and the block streams B k-mers through shared memory, where
//    all threads of a warp read the same word (a broadcast, no bank
//    conflicts), so the inner loop is compare-and-count on registers. One
//    block owns a slice of ROWS x THREADS rows of one tile pair and adds its
//    count with one int32 atomicAdd, which is exact in any order. Tile
//    padding does not exist here: rows and columns past n_a, n_b are masked
//    by global index (2-bit words have no out-of-band value: a poly-T word
//    is -1). The TPU's (8, 128) output sub-grid with one-hot deposits is a
//    TPU layout matter and is gone; the output is the [ga, gb] grid.
//
// 2. pm1_grid_kernel replaces ops/dotplot_pallas.py:_mxu_kernel (the MXU
//    +-1 product behind match_grid_mxu). Each k-mer is a row of 2k values,
//    +1 or -1 per bit, zero-padded to a depth that is a multiple of 16 (the
//    tensor-core fragment depth; zero columns add 0 to every dot). Two rows
//    dot to 2k exactly when all bits agree. Instantiated for bf16 inputs
//    with f32 accumulation and int8 inputs with int32 accumulation; both are
//    exact, since |dot| <= 2k <= 512.
//
//    What bounds it: operations, of two kinds. The product is 4k flops per
//    cell on the tensor cores (~3.5e13 at 524,288^2, k = 32: ~36 ms at
//    989 TFLOP/s bf16, ~18 ms at 1979 TOP/s int8), and the epilogue compares
//    every cell with 2k and counts it on the CUDA cores (~5.5e11 operations,
//    ~16 ms at the SMs' dispatch limit), which is as large as the int8 product:
//    on this card the epilogue is not noise.
//
//    What the design does about it: a block computes a 128 x 128 cell block
//    with mma.sync through nvcuda::wmma (8 warps, each 32 x 64 cells as 2 x 4
//    fragments of 16 x 16), staging 64-deep slices of both operands in
//    shared memory with 16-byte loads. The epilogue compares the accumulator
//    fragments in registers and never stores the product. Rows past the end
//    of an operand are zero-filled in shared memory and dot to 0, never 2k.
//    Tiles are multiples of 128, so a block lies in one output tile and adds
//    its count with one atomicAdd. wgmma and TMA are later work.

#include <algorithm>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;                       // A k-mers per thread
constexpr int SLICE = THREADS * ROWS;         // A rows per block
constexpr long long MAX_BLOCKS = 1LL << 30;   // grid-stride above this

__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------- words

template <int W>
__global__ void __launch_bounds__(THREADS)
word_grid_kernel(const int32_t* __restrict__ a, long long n_a,
                 const int32_t* __restrict__ b, long long n_b, int tile_a,
                 int tile_b, long long gb, long long slices, long long blocks,
                 int32_t* __restrict__ out) {
  constexpr int CB = W <= 4 ? 1024 : 512;     // B k-mers staged per round
  __shared__ uint32_t bs[W][CB];
  __shared__ int scratch[THREADS / 32];

  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long tj = blk % gb;
    const long long rest = blk / gb;
    const long long slice = rest % slices;
    const long long ti = rest / slices;
    const long long row0 = ti * tile_a + slice * SLICE;
    const long long row_end =
        min(min(row0 + SLICE, (ti + 1) * tile_a), n_a);
    if (row0 >= row_end) continue;              // uniform over the block
    const long long col0 = tj * tile_b;
    const long long col_end = min(col0 + tile_b, n_b);

    uint32_t av[ROWS][W];
    bool valid[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = row0 + threadIdx.x + r * THREADS;
      valid[r] = row < row_end;
#pragma unroll
      for (int w = 0; w < W; ++w)
        av[r][w] = valid[r] ? (uint32_t)a[w * n_a + row] : 0u;
    }
    int cnt[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) cnt[r] = 0;

    for (long long c0 = col0; c0 < col_end; c0 += CB) {
      const int len = (int)min((long long)CB, col_end - c0);
      __syncthreads();
#pragma unroll
      for (int w = 0; w < W; ++w)
        for (int i = threadIdx.x; i < len; i += THREADS)
          bs[w][i] = (uint32_t)b[w * n_b + c0 + i];
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < len; ++c) {
        uint32_t bw[W];
#pragma unroll
        for (int w = 0; w < W; ++w) bw[w] = bs[w][c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          uint32_t diff = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) diff |= av[r][w] ^ bw[w];
          cnt[r] += diff == 0u;
        }
      }
    }
    int total = 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) total += valid[r] ? cnt[r] : 0;
    total = block_sum(total, scratch);
    if (threadIdx.x == 0 && total != 0) atomicAdd(out + ti * gb + tj, total);
  }
}

template <int W>
cudaError_t launch_words(const int32_t* a, long long n_a, const int32_t* b,
                         long long n_b, int tile_a, int tile_b, int32_t* out,
                         cudaStream_t stream) {
  const long long ga = (n_a + tile_a - 1) / tile_a;
  const long long gb = (n_b + tile_b - 1) / tile_b;
  const long long slices = (tile_a + SLICE - 1) / SLICE;
  const long long blocks = ga * slices * gb;
  const unsigned grid = (unsigned)std::min(blocks, MAX_BLOCKS);
  word_grid_kernel<W><<<grid, THREADS, 0, stream>>>(
      a, n_a, b, n_b, tile_a, tile_b, gb, slices, blocks, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- +-1 product

namespace wmma = nvcuda::wmma;

constexpr int BM = 128;                       // cell block: rows (A) ...
constexpr int BN = 128;                       // ... and columns (B)
constexpr int KC = 64;                        // depth staged per round
constexpr int FRAG = 16;

template <typename T>
struct Pm1Acc;
template <>
struct Pm1Acc<__nv_bfloat16> { using type = float; };
template <>
struct Pm1Acc<signed char> { using type = int; };

// Shared memory holds a 64-deep slice of 128 rows as 16-deep panels,
// [panel][row][16]: every fragment then starts on a 32-byte boundary (as
// wmma requires) for both element widths, with ldm = 16.
// Copy rows [row0, row0 + 128) x depth [k0, k0 + kc) of a [n_rows, depth]
// row-major operand into the panels, zero-filling rows past n_rows.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long n_rows,
                                      int depth, long long row0, int k0,
                                      int kc) {
  constexpr int PER_VEC = 16 / sizeof(T);
  const int vecs = kc / PER_VEC;
  for (int idx = threadIdx.x; idx < BM * vecs; idx += blockDim.x) {
    const int r = idx / vecs;
    const int e = (idx - r * vecs) * PER_VEC;   // depth offset in the slice
    const long long row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows)
      val = *reinterpret_cast<const uint4*>(src + row * depth + k0 + e);
    *reinterpret_cast<uint4*>(dst + ((e / FRAG) * BM + r) * FRAG + e % FRAG) =
        val;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pm1_grid_kernel(const T* __restrict__ a, long long n_a,
                const T* __restrict__ b, long long n_b, int depth, int two_k,
                int tile_a, int tile_b, long long blocks_n, long long blocks,
                long long gb, int32_t* __restrict__ out) {
  using Acc = typename Pm1Acc<T>::type;
  __shared__ __align__(128) unsigned char smem[(KC * BM + KC * BN) * sizeof(T)];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = as + KC * BM;
  __shared__ int scratch[THREADS / 32];

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;                   // 4 warp rows of 32 cells
  const int wn = warp & 1;                    // 2 warp columns of 64 cells
  const Acc target = (Acc)two_k;

  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long row0 = (blk / blocks_n) * BM;
    const long long col0 = (blk % blocks_n) * BN;

    wmma::fragment<wmma::accumulator, FRAG, FRAG, FRAG, Acc> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], (Acc)0);

    for (int k0 = 0; k0 < depth; k0 += KC) {
      const int kc = min(KC, depth - k0);
      __syncthreads();
      stage<T>(as, a, n_a, depth, row0, k0, kc);
      stage<T>(bs, b, n_b, depth, col0, k0, kc);
      __syncthreads();
      for (int kk = 0; kk < kc; kk += FRAG) {
        wmma::fragment<wmma::matrix_a, FRAG, FRAG, FRAG, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, FRAG, FRAG, FRAG, T, wmma::col_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], as + ((kk / FRAG) * BM + wm * 32 + i * FRAG) * FRAG, FRAG);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(
              fb[j], bs + ((kk / FRAG) * BN + wn * 64 + j * FRAG) * FRAG, FRAG);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }

    // epilogue: count the cells whose dot is exactly 2k, in registers
    int count = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < acc[i][j].num_elements; ++e)
          count += acc[i][j].x[e] == target;
    count = block_sum(count, scratch);
    if (threadIdx.x == 0 && count != 0)
      atomicAdd(out + (row0 / tile_a) * gb + col0 / tile_b, count);
  }
}

template <typename T>
cudaError_t launch_pm1(const void* a, long long n_a, const void* b,
                       long long n_b, int depth, int two_k, int tile_a,
                       int tile_b, int32_t* out, cudaStream_t stream) {
  const long long gb = (n_b + tile_b - 1) / tile_b;
  const long long blocks_n = (n_b + BN - 1) / BN;
  const long long blocks = ((n_a + BM - 1) / BM) * blocks_n;
  const unsigned grid = (unsigned)std::min(blocks, MAX_BLOCKS);
  pm1_grid_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), n_a, static_cast<const T*>(b), n_b, depth,
      two_k, tile_a, tile_b, blocks_n, blocks, gb, out);
  return cudaGetLastError();
}

}  // namespace

// Tile counts of the word compare into out ([ceil(n_a / tile_a),
// ceil(n_b / tile_b)] int32, zeroed by the caller). a is [w, n_a] and b is
// [w, n_b] int32, row-major, 1 <= w <= 16; n_a, n_b >= 1. Returns the CUDA
// error of the launch, 0 when it was accepted.
extern "C" int match_grid_words(const int32_t* a, long long n_a,
                                const int32_t* b, long long n_b, int w,
                                int tile_a, int tile_b, int32_t* out,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
#define CASE(N) \
  case N: return (int)launch_words<N>(a, n_a, b, n_b, tile_a, tile_b, out, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// Tile counts of the +-1 product into out (as above). a is [n_a, depth] and
// b is [n_b, depth], row-major, bf16 (is_int8 = 0) or int8 (is_int8 = 1),
// depth a multiple of 16 holding the 2k +-1 columns and zeros after them;
// tile_a and tile_b are multiples of 128.
extern "C" int match_grid_pm1(const void* a, long long n_a, const void* b,
                              long long n_b, int depth, int two_k, int is_int8,
                              int tile_a, int tile_b, int32_t* out,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (depth % FRAG != 0 || tile_a % BM != 0 || tile_b % BN != 0)
    return (int)cudaErrorInvalidValue;
  if (is_int8)
    return (int)launch_pm1<signed char>(a, n_a, b, n_b, depth, two_k, tile_a,
                                        tile_b, out, st);
  return (int)launch_pm1<__nv_bfloat16>(a, n_a, b, n_b, depth, two_k, tile_a,
                                        tile_b, out, st);
}
