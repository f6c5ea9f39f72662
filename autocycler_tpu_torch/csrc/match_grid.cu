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
// 2. pm1_wgmma_kernel and pm1_grid_kernel replace ops/dotplot_pallas.py:
//    _mxu_kernel (line 219; the MXU +-1 product behind match_grid_mxu). Each
//    k-mer is a row of 2k values, +1 or -1 per bit, zero-padded in depth
//    (zero columns add 0 to every dot). Two rows dot to 2k exactly when all
//    bits agree. Instantiated for bf16 inputs with f32 accumulation and int8
//    inputs with int32 accumulation; both are exact, since |dot| <= 2k <= 512.
//
//    What bounds it: operations, of two kinds. The product is 4k flops per
//    cell on the tensor cores (~3.5e13 at 524,288^2, k = 32: ~36 ms at
//    989 TFLOP/s bf16, ~18 ms at 1979 TOP/s int8), and the epilogue compares
//    every cell with 2k and counts it on the CUDA cores (~5.5e11 operations,
//    ~16 ms at the SMs' dispatch limit), which is as large as the int8 product:
//    on this card the epilogue is not noise, and it has to run while the
//    tensor cores work. Staging is not a bound but was the old design's
//    limit: re-staging both operands for every 128 x 128 cell block moved
//    550 GB through shared memory at 524,288^2 in bf16.
//
//    What the design does about it (pm1_wgmma_kernel, depth <= 128 values,
//    i.e. k <= 64, which covers the k <= 55 of the reference's flag range):
//    - persistent blocks, one per SM, walk work units of (A band of 256 rows,
//      B chunk of CHUNK_STAGES x 128 rows), band-fastest, so the blocks
//      running at one time read the same B chunk and B comes from L2; the A
//      band stays resident in shared memory for its whole chunk, which halves
//      the L2 -> SM traffic for B against a 128-row band;
//    - one producer thread keeps a ring of up to 8 B stages in flight with
//      1-D cp.async.bulk copies completed on mbarriers. The wrapper stores
//      both operands in global memory already in wgmma's no-swizzle K-major
//      layout (8-row x 16-byte core matrices, each 8-row group contiguous),
//      zero rows padding A to the band and B to the stage, so a band or a
//      stage is one contiguous copy and needs no tensor map;
//    - two consumer warpgroups run wgmma (m64n128k16 bf16, m64n128k32 int8),
//      each over 128 A rows, with 128 accumulator registers a thread
//      (setmaxnreg: 232 for consumers, 40 for the producer). They issue
//      their products in turns (two named barriers), so the tensor cores run
//      one warpgroup's product while the other counts its cells; issued at
//      once, both products finished together and the counting did not
//      overlap them;
//    - the count reads the accumulators where wgmma left them: a tree of
//      three-input integer maxima finds whether any of a thread's 64 values
//      is 2k (dots are at most 2k), and only then are they counted one by
//      one. A compare, a select and an add per value in one running count was
//      a serial chain of three instructions a value;
//    - a stage is 128 B rows and tiles are multiples of 128, so a
//      warpgroup's 128 x 128 cells lie in one output tile. Each thread keeps
//      its count in a register across the B stages of one output tile, then
//      a warp reduction and one atomicAdd a warp per output tile.
//    pm1_grid_kernel, the generic path for depth > 128 (k > 64), keeps the
//    first design: a block computes a 128 x 128 cell block with mma.sync
//    through nvcuda::wmma (8 warps, each 32 x 64 cells as 2 x 4 fragments of
//    16 x 16), staging 64-deep slices of both operands in shared memory with
//    16-byte loads and zero-filling rows past the end, and adds its count
//    with one atomicAdd. The wrapper routes by k alone.

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

// ---------------------------------------------------------------- +-1 product, wgmma

constexpr int WG = 128;                       // threads of a warpgroup
constexpr int BAND = 256;                     // A rows resident in a block
constexpr int WG_ROWS = 128;                  // A rows of a consumer warpgroup
constexpr int STAGE = 128;                    // B rows of a ring stage (wgmma N)
constexpr int KSTEP_BYTES = 32;               // wgmma depth: 16 bf16, 32 int8
constexpr int MAX_STAGES = 8;
constexpr long long CHUNK_STAGES = 256;     // B stages a work unit sweeps
constexpr int BAR_BYTES = 1024;               // mbarriers, ahead of the operands
constexpr int PM1_THREADS = 3 * WG;           // 2 consumer warpgroups + producer
constexpr int CONSUMER_WARPS = 2 * WG / 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One contiguous global -> shared copy, completed on `bar` by its bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a no-swizzle K-major operand: core matrices of 8 rows
// x 16 bytes (128 contiguous bytes), `lbo` bytes apart along the depth and
// `sbo` bytes apart from one 8-row group to the next.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// The accumulators are registers the compiler does not know wgmma writes
// after the instruction issues: keep reads and writes of them on their side
// of the fence and wait instructions.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define PM1_D8(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), \
  c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define PM1_D64(c) PM1_D8(c, 0), PM1_D8(c, 8), PM1_D8(c, 16), PM1_D8(c, 24), \
  PM1_D8(c, 32), PM1_D8(c, 40), PM1_D8(c, 48), PM1_D8(c, 56)
#define PM1_F(x) "+f"(x)
#define PM1_R(x) "+r"(x)
#define PM1_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// d (64 rows x 128 columns, 64 values a thread) = or += A . B^T over one
// 32-byte depth step; both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PM1_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : PM1_D64(PM1_F)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PM1_REGS
      ", %64, %65, p;\n"
      "}\n"
      : PM1_D64(PM1_R)
      : "l"(da), "l"(db), "r"(accumulate));
}

// Issue d = A rows (64, from a_rows) . B stage (128 rows)^T over the
// depth, one wgmma a 32-byte step, as one commit group (the first step
// overwrites d).
template <typename Acc>
__device__ __forceinline__ void wgmma_rows(Acc (&d)[64],
                                           const unsigned char* a_rows,
                                           const unsigned char* b_rows,
                                           int ksteps, uint32_t sbo) {
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int ks = 0; ks < ksteps; ++ks)
    // a depth step is two 16-byte core-matrix columns, 128 bytes apart
    wgmma_step(d, gmma_desc(a_rows + ks * 256, 128, sbo),
               gmma_desc(b_rows + ks * 256, 128, sbo), ks > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(d);
}

// The consumer warpgroups issue their products in turns (named barriers 1
// and 2, 256 threads each): the tensor cores then run one warpgroup's
// product while the other counts cells, where products issued at once would
// finish together and leave both counting at the same time.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ int bits(float v) { return __float_as_int(v); }
__device__ __forceinline__ int bits(int v) { return v; }

// The values of d whose bits are target, the bits of 2k. Dots are at most
// 2k, and a float at most 2k has bits, read as a signed int, at most those
// of 2k, so the largest value tells whether any cell of the 64 matches: a
// tree of three-input integer maxima, one instruction for two values in four
// independent chains. Only a thread with a match counts its cells one by
// one; most have none.
template <typename Acc>
__device__ __forceinline__ int count_equal(const Acc (&d)[64], int target) {
  int m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = bits(d[j]);
#pragma unroll
  for (int i = 4; i < 64; i += 2)
    m[i / 2 % 4] = __vimax3_s32(m[i / 2 % 4], bits(d[i]), bits(d[i + 1]));
  if (max(__vimax3_s32(m[0], m[1], m[2]), m[3]) != target) return 0;
  int count = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) count += bits(d[i]) == target;
  return count;
}

// A warp's count of output tile (ti, tj): one reduction, one atomicAdd.
__device__ __forceinline__ void add_count(int32_t* out, int count,
                                          long long ti, long long tj,
                                          long long ga, long long gb,
                                          int lane) {
  const int total = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0 && total != 0 && ti < ga) atomicAdd(out + ti * gb + tj, total);
}

// a and b hold the +-1 rows in core-matrix layout (see match_grid_pm1_wgmma),
// row_bytes of depth each; a has n_bands * BAND rows and b n_stages * STAGE,
// zero rows past the ends. Work unit u is (band u % n_bands, chunk u /
// n_bands); a chunk is CHUNK_STAGES B stages.
template <typename T>
__global__ void __launch_bounds__(PM1_THREADS, 1)
pm1_wgmma_kernel(const unsigned char* __restrict__ a,
                 const unsigned char* __restrict__ b, int row_bytes,
                 int two_k, int tile_a, int tile_b, long long n_bands,
                 long long n_stages, int stages,
                 long long ga, long long gb, int32_t* __restrict__ out) {
  using Acc = typename Pm1Acc<T>::type;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* a_full = empty + MAX_STAGES;
  uint64_t* a_empty = a_full + 1;
  unsigned char* as = smem + BAR_BYTES;
  unsigned char* bs = as + BAND * row_bytes;
  const uint32_t a_bytes = BAND * row_bytes;
  const uint32_t b_bytes = STAGE * row_bytes;
  const long long n_chunks = (n_stages + CHUNK_STAGES - 1) / CHUNK_STAGES;
  const long long units = n_bands * n_chunks;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * WG) {
      int slot = 0;
      uint32_t ring_phase = 0, a_phase = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const long long band = u % n_bands;
        const long long s0 = (u / n_bands) * CHUNK_STAGES;
        const long long s1 = min(s0 + CHUNK_STAGES, n_stages);
        mbar_wait(a_empty, a_phase ^ 1);      // the last band is released
        mbar_expect_tx(a_full, a_bytes);
        bulk_load(as, a + band * a_bytes, a_bytes, a_full);
        a_phase ^= 1;
        for (long long s = s0; s < s1; ++s) {
          mbar_wait(empty + slot, ring_phase ^ 1);
          mbar_expect_tx(full + slot, b_bytes);
          bulk_load(bs + slot * b_bytes, b + s * b_bytes, b_bytes, full + slot);
          if (++slot == stages) { slot = 0; ring_phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns A rows [wg * 128, wg * 128 + 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int target = sizeof(T) == 1 ? two_k : __float_as_int((float)two_k);
    const uint32_t sbo = 8 * row_bytes;       // 8-row group to 8-row group
    const int ksteps = row_bytes / KSTEP_BYTES;
    Acc acc[2][64];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = (Acc)0;
    int slot = 0;
    bool first = true;
    uint32_t ring_phase = 0, a_phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const long long band = u % n_bands;
      const long long s0 = (u / n_bands) * CHUNK_STAGES;
      const long long s1 = min(s0 + CHUNK_STAGES, n_stages);
      const long long ti = (band * BAND + wg * WG_ROWS) / tile_a;
      const unsigned char* a_rows = as + wg * WG_ROWS * row_bytes;
      mbar_wait(a_full, a_phase);
      a_phase ^= 1;
      int count = 0;
      long long tj = (s0 * STAGE) / tile_b;
      for (long long s = s0; s < s1; ++s) {
        mbar_wait(full + slot, ring_phase);
        const unsigned char* b_rows = bs + slot * b_bytes;
        if (wg == 1 || !first) bar_sync(1 + wg);   // this warpgroup's turn
        first = false;
        wgmma_rows(acc[0], a_rows, b_rows, ksteps, sbo);
        wgmma_rows(acc[1], a_rows + 64 * row_bytes, b_rows, ksteps, sbo);
        bar_arrive(2 - wg);                   // the other warpgroup's turn
        wgmma_wait<0>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (lane == 0) mbar_arrive(empty + slot);   // the stage is read
        if (++slot == stages) { slot = 0; ring_phase ^= 1; }
        const long long stage_tj = (s * STAGE) / tile_b;
        if (stage_tj != tj) {                 // uniform over the warpgroup
          add_count(out, count, ti, tj, ga, gb, lane);
          count = 0;
          tj = stage_tj;
        }
        count += count_equal(acc[0], target) + count_equal(acc[1], target);
      }
      if (lane == 0) mbar_arrive(a_empty);    // the band is read
      add_count(out, count, ti, tj, ga, gb, lane);
    }
    if (wg == 0) bar_sync(1);                 // warpgroup 1's last turn
  }
}

// The ring's stages and the dynamic shared memory of a block at row_bytes
// (as many stages as fit beside the band, at most MAX_STAGES), and the SMs.
cudaError_t pm1_wgmma_shape(int row_bytes, int* stages, int* smem,
                            int* sms) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int fixed = BAR_BYTES + BAND * row_bytes;
  *stages = std::min(MAX_STAGES, (optin - fixed) / (STAGE * row_bytes));
  if (*stages < 2) return cudaErrorInvalidValue;
  *smem = fixed + *stages * STAGE * row_bytes;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_pm1_wgmma(const void* a, const void* b, int row_bytes,
                             int two_k, int tile_a, int tile_b,
                             long long n_bands, long long n_stages,
                             long long ga, long long gb, int32_t* out,
                             cudaStream_t stream) {
  int stages = 0, smem = 0, sms = 0;
  cudaError_t err = pm1_wgmma_shape(row_bytes, &stages, &smem, &sms);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(pm1_wgmma_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long units =
      n_bands * ((n_stages + CHUNK_STAGES - 1) / CHUNK_STAGES);
  const unsigned grid = (unsigned)std::min(units, (long long)sms);
  pm1_wgmma_kernel<T><<<grid, PM1_THREADS, smem, stream>>>(
      static_cast<const unsigned char*>(a), static_cast<const unsigned char*>(b),
      row_bytes, two_k, tile_a, tile_b, n_bands, n_stages, stages, ga, gb,
      out);
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

// Tile counts of the +-1 product through the wgmma kernel, into out
// ([ga, gb] int32, zeroed by the caller). a and b hold the +-1 rows, bf16
// (is_int8 = 0) or int8 (is_int8 = 1), row_bytes of depth each (a multiple
// of 32, at most 256: 2k values and zeros after them), in core-matrix
// layout: each group of 8 rows is 8 * row_bytes contiguous bytes ordered
// [row_bytes / 16][8 rows][16 bytes]. a has n_bands * 256 rows and b
// n_stages * 128, zero rows after the k-mers; a work unit sweeps one band
// over CHUNK_STAGES stages of b. tile_a and tile_b are multiples of 128.
extern "C" int match_grid_pm1_wgmma(const void* a, const void* b,
                                    int row_bytes, int two_k, int is_int8,
                                    int tile_a, int tile_b, long long n_bands,
                                    long long n_stages, long long ga,
                                    long long gb, int32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (row_bytes % KSTEP_BYTES != 0 || row_bytes < KSTEP_BYTES ||
      row_bytes > 256 || tile_a % WG_ROWS != 0 || tile_b % STAGE != 0 ||
      tile_a < 1 || tile_b < 1 || n_bands < 1 || n_stages < 1)
    return (int)cudaErrorInvalidValue;
  if (is_int8)
    return (int)launch_pm1_wgmma<signed char>(
        a, b, row_bytes, two_k, tile_a, tile_b, n_bands, n_stages, ga, gb,
        out, st);
  return (int)launch_pm1_wgmma<__nv_bfloat16>(
      a, b, row_bytes, two_k, tile_a, tile_b, n_bands, n_stages, ga, gb, out,
      st);
}

// The wgmma kernel's ring stages and dynamic shared memory per block at
// row_bytes on the current device, through the two pointers; returns the
// CUDA error, 0 on success.
extern "C" int match_grid_pm1_wgmma_shape(int row_bytes, int* stages,
                                          int* smem_bytes) {
  int sms = 0;
  return (int)pm1_wgmma_shape(row_bytes, stages, smem_bytes, &sms);
}
