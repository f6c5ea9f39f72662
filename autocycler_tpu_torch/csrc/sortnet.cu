// Exact k-mer grouping for Hopper: base-5 window packing fused into a
// bitonic sort network over (key words..., window index) records.
//
// Replaces the TPU kernel ops/sortnet.py:_local_stages_kernel (the fused
// block-local compare-exchanges, driven by run_network) together with the
// packing half of ops/kmers.py:_pallas_rank_fn in the JAX package. It
// computes the same function, not the same blocks: every window of `k`
// symbols starting at starts[i] is packed into W = ceil(k / 13) int32 words
// (13 base-5 symbols per word, most significant first, zero-filled tail), and
// the records (w_0, ..., w_{W-1}, i) are sorted lexicographically. The index
// makes every record distinct, so the result is the stable lexicographic
// order; pad records (i >= n) carry INT32_MAX in every key word and sort last
// (real words stay below 5^13 <= INT32_MAX).
//
// Layout: `keys` is W+1 int32 rows of N = 2^m elements each (structure of
// arrays; the last row is the index). Group ids are taken from the sorted
// rows by the caller (adjacent difference + cumulative sum).
//
// What bounds it: bytes. A compare-exchange is a handful of integer
// operations per 4(W+1)-byte record, so every pass over device memory is
// bandwidth-bound, and the network makes ~(m - L)(m - L + 3)/2 + 1 passes
// for blocks of 2^L records (153 passes at N = 2^29, L = 13).
//
// What the design does about it: every substage whose distance is below one
// block runs inside shared memory, so device memory is touched once per
// stage for all of them, and the packing happens in the first of those
// passes instead of a pass of its own. The block is sized from the record
// (2^13 records of 20 bytes = 160 KB at k = 51), the largest power of two that
// fits the 227 KB a block may hold. Substages at distance >= one block are
// one elementwise read + write pass each. A radix or merge design that makes
// fewer passes is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SYMS_PER_WORD = 13;
constexpr int32_t PAD_WORD = 2147483647;
constexpr int GLOBAL_THREADS = 256;

// Lexicographic a > b over the `nw` rows of a structure-of-arrays buffer.
template <int NW>
__device__ __forceinline__ bool lex_gt(const int32_t* rows, long long stride,
                                       long long a, long long b, int nw) {
  const int n = NW > 0 ? NW : nw;
#pragma unroll
  for (int w = 0; w < n; ++w) {
    const int32_t x = rows[w * stride + a];
    const int32_t y = rows[w * stride + b];
    if (x != y) return x > y;
  }
  return false;
}

template <int NW>
__device__ __forceinline__ void swap_records(int32_t* rows, long long stride,
                                             long long a, long long b, int nw) {
  const int n = NW > 0 ? NW : nw;
#pragma unroll
  for (int w = 0; w < n; ++w) {
    const int32_t t = rows[w * stride + a];
    rows[w * stride + a] = rows[w * stride + b];
    rows[w * stride + b] = t;
  }
}

// One block sorts 2^log_b consecutive records in shared memory through
// stages s_lo..s_hi of the network (for each stage, every distance below the
// block). With `codes` set it first packs the windows (stages 1..log_b, the
// initial pass); without, it loads the records from `keys` (the local tail
// of a stage whose larger distances ran in global_exchange_kernel).
template <int NW>
__global__ void local_stages_kernel(int32_t* keys, long long N, int nw,
                                    int log_b, int s_lo, int s_hi,
                                    const uint8_t* codes,
                                    const int32_t* starts, int n, int k) {
  extern __shared__ int32_t sm[];
  const int B = 1 << log_b;
  const int words = NW > 0 ? NW : nw;
  const long long base = (long long)blockIdx.x << log_b;

  if (codes != nullptr) {
    const int key_words = words - 1;
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const long long e = base + i;
      if (e < n) {
        const uint8_t* win = codes + starts[e];
        for (int j = 0; j < key_words; ++j) {
          int32_t w = 0;
          for (int t = 0; t < SYMS_PER_WORD; ++t) {
            const int idx = j * SYMS_PER_WORD + t;
            w *= 5;
            if (idx < k) w += win[idx];
          }
          sm[j * B + i] = w;
        }
      } else {
        for (int j = 0; j < key_words; ++j) sm[j * B + i] = PAD_WORD;
      }
      sm[key_words * B + i] = (int32_t)e;
    }
  } else {
    for (int w = 0; w < words; ++w)
      for (int i = threadIdx.x; i < B; i += blockDim.x)
        sm[w * B + i] = keys[w * N + base + i];
  }
  __syncthreads();

  for (int s = s_lo; s <= s_hi; ++s) {
    const int first = s - 1 < log_b - 1 ? s - 1 : log_b - 1;
    for (int t = first; t >= 0; --t) {
      const int d = 1 << t;
      for (int p = threadIdx.x; p < (B >> 1); p += blockDim.x) {
        const int lo = ((p & ~(d - 1)) << 1) | (p & (d - 1));
        const int hi = lo + d;
        // ascending runs alternate with bit s of the GLOBAL element index
        const bool asc = (((base + lo) >> s) & 1) == 0;
        if (lex_gt<NW>(sm, B, lo, hi, words) == asc)
          swap_records<NW>(sm, B, lo, hi, words);
      }
      __syncthreads();
    }
  }

  for (int w = 0; w < words; ++w)
    for (int i = threadIdx.x; i < B; i += blockDim.x)
      keys[w * N + base + i] = sm[w * B + i];
}

// One substage of stage s at distance 2^log_d >= one block: elementwise
// compare-exchange between the paired halves, one read + write pass.
template <int NW>
__global__ void global_exchange_kernel(int32_t* keys, long long N, int nw,
                                       int s, int log_d) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (N >> 1)) return;
  const long long d = 1LL << log_d;
  const long long lo = ((p >> log_d) << (log_d + 1)) | (p & (d - 1));
  const long long hi = lo + d;
  const bool asc = ((lo >> s) & 1) == 0;
  if (lex_gt<NW>(keys, N, lo, hi, nw) == asc)
    swap_records<NW>(keys, N, lo, hi, nw);
}

template <int NW>
cudaError_t run_network(const uint8_t* codes, const int32_t* starts, int n,
                        int k, int32_t* keys, long long N, int nw, int log_b,
                        cudaStream_t stream) {
  const int B = 1 << log_b;
  const size_t smem = (size_t)nw * B * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      local_stages_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int m = 0;
  while ((1LL << m) < N) ++m;
  const int local_threads = B / 2 < 1024 ? B / 2 : 1024;
  const unsigned local_blocks = (unsigned)(N >> log_b);
  const unsigned global_blocks =
      (unsigned)(((N >> 1) + GLOBAL_THREADS - 1) / GLOBAL_THREADS);

  local_stages_kernel<NW><<<local_blocks, local_threads, smem, stream>>>(
      keys, N, nw, log_b, 1, log_b, codes, starts, n, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int s = log_b + 1; s <= m; ++s) {
    for (int t = s - 1; t >= log_b; --t) {
      global_exchange_kernel<NW><<<global_blocks, GLOBAL_THREADS, 0, stream>>>(
          keys, N, nw, s, t);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    local_stages_kernel<NW><<<local_blocks, local_threads, smem, stream>>>(
        keys, N, nw, log_b, s, s, nullptr, nullptr, 0, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Packs the n windows (codes[starts[i] : starts[i] + k]) into keys, which
// holds nw = ceil(k / 13) + 1 rows of N = 2^m int32 each, pads the records
// n..N-1, and sorts all N records. Blocks hold 2^log_b records
// (log_b <= m, nw * 4 * 2^log_b bytes of shared memory). Returns the first
// CUDA error of the launches, 0 when all were accepted.
extern "C" int sortnet_pack_sort(const uint8_t* codes, const int32_t* starts,
                                 int n, int k, int32_t* keys, long long N,
                                 int nw, int log_b, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (nw) {
    case 2: return (int)run_network<2>(codes, starts, n, k, keys, N, nw, log_b, st);
    case 3: return (int)run_network<3>(codes, starts, n, k, keys, N, nw, log_b, st);
    case 4: return (int)run_network<4>(codes, starts, n, k, keys, N, nw, log_b, st);
    case 5: return (int)run_network<5>(codes, starts, n, k, keys, N, nw, log_b, st);
    default: return (int)run_network<0>(codes, starts, n, k, keys, N, nw, log_b, st);
  }
}
