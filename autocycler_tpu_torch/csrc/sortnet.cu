// Exact k-mer grouping for Hopper: base-5 window packing, one partition
// pass on a prefix of the key, then sorts of whole buckets in shared memory.
//
// Replaces the TPU kernel ops/sortnet.py:_local_stages_kernel (the bitonic
// network's fused block-local compare-exchanges, driven by run_network)
// together with the packing half of ops/kmers.py:_pallas_rank_fn in the JAX
// package. It computes the same function, not the same blocks: every window
// of `k` symbols starting at starts[i] is packed into W = ceil(k / 13) int32
// words (13 base-5 symbols per word, most significant first, zero-filled
// tail), and the records (w_0, ..., w_{W-1}, i) are put in lexicographic
// order. The index makes every record distinct, so that order is the stable
// lexicographic order of the windows, whatever order the records are moved
// in on the way.
//
// What bounds it: bytes. Every step is a few integer operations per record
// of 4(W+1) bytes, so the least time is the windows' starts and codes read
// once and the order and group ids written once. The TPU had no fast random
// scatter and so sorted with a network: about 153 passes over a power-of-two
// padded array at k=51. Hopper scatters well, so this design moves every
// record about three times:
//
//   1. hist0_kernel reads the starts, packs the first `prefix` symbols of each
//      window (its digit: the high part of w_0, so bucket order is key order)
//      and counts the buckets in device memory, one atomic per distinct digit
//      of a warp (dotted ends and low-complexity runs put many equal digits
//      in one warp).
//   2. The caller scans the counts into bucket offsets (bookkeeping).
//   3. scatter0_kernel packs again, rather than storing the words twice, and
//      writes each whole record to its bucket: an array of structures padded
//      to 32 bytes (one sector), written by two aligned vector stores (a
//      scattered 4-byte store is an L2 transaction of its own, and W + 1 of
//      them a record cost more than the pass's atomics and packing). The
//      order inside a bucket is arbitrary: the index, part of the key,
//      restores it.
//   4. sort_reg_kernel: one block sorts one segment (a run of whole small
//      buckets of at most `cap` = 4,096 records) by (w_0, ..., w_{W-1}, i)
//      with a bitonic network whose short-distance substages run in
//      registers and warp shuffles, writes the order and a new-group flag
//      per record, and leaves the segment's first and last keys for
//      boundary_kernel, which flags the first record of every segment. The
//      group ids are a cumulative sum of the flags (bookkeeping).
//
// Buckets larger than a quarter of a segment go through hist_kernel and
// scatter_kernel again, partitioned on the next few symbols (or, once all k
// symbols are spent and the keys are equal, on the next bits of the index)
// into the other record buffer, until every bucket fits; on random genomes
// there are few or none. No power-of-two padding: memory grows with n.
//
// What holds it above the bytes bound on an H100 (PERF.md): the scatter's
// random sector writes to about a million open buckets, and the
// compare-exchanges of the in-block sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SYMS_PER_WORD = 13;
constexpr int32_t PAD = 2147483647;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int MAX_GRID = 8192;
constexpr int MAX_BINS = 1024;

__constant__ int32_t POW5[SYMS_PER_WORD + 1] = {
    1, 5, 25, 125, 625, 3125, 15625, 78125, 390625, 1953125, 9765625,
    48828125, 244140625, 1220703125};

// Word j of the window at `win`: symbols 13j .. 13j+12, past k as 0.
__device__ __forceinline__ int32_t pack_word(const uint8_t* win, int j, int k) {
  int32_t w = 0;
  const int first = j * SYMS_PER_WORD;
#pragma unroll
  for (int t = 0; t < SYMS_PER_WORD; ++t) {
    w *= 5;
    if (first + t < k) w += win[first + t];
  }
  return w;
}

// Records are padded to 8 int32 (32 bytes, one sector) for W <= 5, so that
// two aligned vector stores write a whole record (a scattered 4-byte store
// is an L2 transaction of its own, and scattered half sectors were slower
// than whole ones); the generic instantiation (KW = 0) keeps W + 1.
constexpr int REC_STRIDE = 8;

template <int KW>
__device__ __forceinline__ int stride_of(int kw) {
  return KW > 0 ? REC_STRIDE : kw + 1;
}

__device__ __forceinline__ void store_rec(int32_t* dst, const int32_t* v) {
  reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void copy_rec(int32_t* dst, const int32_t* src) {
  reinterpret_cast<int4*>(dst)[0] = reinterpret_cast<const int4*>(src)[0];
  reinterpret_cast<int4*>(dst)[1] = reinterpret_cast<const int4*>(src)[1];
}

// Adds each lane's record to counters[key] with one atomic per distinct key
// of the warp and returns the lane's slot (the old count plus its rank among
// the lanes of equal key). Every lane of the warp calls it.
__device__ __forceinline__ int32_t warp_add(int32_t* counters, int32_t key,
                                            bool valid) {
  const unsigned active = __ballot_sync(FULL_MASK, valid);
  int32_t slot = 0;
  if (valid) {
    const unsigned peers = __match_any_sync(active, key);
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(peers) - 1;
    int32_t base = 0;
    if (lane == leader) base = atomicAdd(counters + key, __popc(peers));
    base = __shfl_sync(peers, base, leader);
    slot = base + __popc(peers & ((1u << lane) - 1u));
  }
  return slot;
}

__global__ void hist0_kernel(const uint8_t* codes, const int32_t* starts,
                             int n, int k, int prefix, int32_t* counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long wb = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       wb < n; wb += stride) {
    const long long i = wb + (threadIdx.x & 31);
    const bool valid = i < n;
    int32_t d = 0;
    if (valid) {
      const uint8_t* win = codes + starts[i];
      for (int q = 0; q < prefix; ++q) d = d * 5 + (q < k ? win[q] : 0);
    }
    warp_add(counts, d, valid);
  }
}

template <int KW>
__global__ void scatter0_kernel(const uint8_t* codes, const int32_t* starts,
                                int n, int k, int kw, int prefix,
                                int32_t* cursor, int32_t* recs) {
  const int32_t div = POW5[SYMS_PER_WORD - prefix];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long wb = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       wb < n; wb += stride) {
    const long long i = wb + (threadIdx.x & 31);
    const bool valid = i < n;
    const uint8_t* win = codes + (valid ? starts[i] : 0);
    const int32_t w0 = valid ? pack_word(win, 0, k) : 0;
    const int32_t slot = warp_add(cursor, w0 / div, valid);
    if (!valid) continue;
    if constexpr (KW > 0) {
      int32_t v[REC_STRIDE];
      v[0] = w0;
#pragma unroll
      for (int j = 1; j < KW; ++j) v[j] = pack_word(win, j, k);
      v[KW] = (int32_t)i;
#pragma unroll
      for (int j = KW + 1; j < REC_STRIDE; ++j) v[j] = 0;
      store_rec(recs + (long long)slot * REC_STRIDE, v);
    } else {
      int32_t* r = recs + (long long)slot * (kw + 1);
      r[0] = w0;
      for (int j = 1; j < kw; ++j) r[j] = pack_word(win, j, k);
      r[kw] = (int32_t)i;
    }
  }
}

// A record's digit at a re-partition level: with nsym > 0 the base-5 value
// of symbols sym_pos .. sym_pos + nsym - 1, else bits shift .. shift +
// width - 1 of its index.
__device__ __forceinline__ int32_t level_digit(const int32_t* r, int W,
                                               int sym_pos, int nsym,
                                               int shift, int width) {
  if (nsym > 0) {
    int32_t d = 0;
    for (int q = sym_pos; q < sym_pos + nsym; ++q) {
      const int32_t w = r[q / SYMS_PER_WORD];
      d = d * 5 + (w / POW5[SYMS_PER_WORD - 1 - q % SYMS_PER_WORD]) % 5;
    }
    return d;
  }
  return (r[W] >> shift) & ((1 << width) - 1);
}

// One block counts one chunk of a task's records into the task's `bins`
// counters, through a histogram in shared memory.
template <int KW>
__global__ void hist_kernel(const int32_t* src, int kw,
                            const int32_t* chunk_task, const int32_t* chunk_lo,
                            const int32_t* chunk_hi, int sym_pos, int nsym,
                            int shift, int width, int bins, int32_t* counts) {
  __shared__ int32_t h[MAX_BINS];
  const int W = KW > 0 ? KW : kw;
  const int RS = stride_of<KW>(kw);
  for (int b = threadIdx.x; b < bins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int hi = chunk_hi[blockIdx.x];
  for (int i = chunk_lo[blockIdx.x] + threadIdx.x; i < hi; i += blockDim.x)
    atomicAdd(h + level_digit(src + (long long)i * RS, W, sym_pos, nsym,
                              shift, width), 1);
  __syncthreads();
  int32_t* task_counts = counts + (long long)chunk_task[blockIdx.x] * bins;
  for (int b = threadIdx.x; b < bins; b += blockDim.x)
    if (h[b]) atomicAdd(task_counts + b, h[b]);
}

template <int KW>
__global__ void scatter_kernel(const int32_t* src, int32_t* dst, int kw,
                               const int32_t* chunk_task,
                               const int32_t* chunk_lo, const int32_t* chunk_hi,
                               int sym_pos, int nsym, int shift, int width,
                               int bins, int32_t* cursor) {
  const int W = KW > 0 ? KW : kw;
  const int RS = stride_of<KW>(kw);
  const int32_t key0 = chunk_task[blockIdx.x] * bins;
  const int hi = chunk_hi[blockIdx.x];
  for (int wb = chunk_lo[blockIdx.x] + (threadIdx.x & ~31); wb < hi;
       wb += blockDim.x) {
    const int i = wb + (threadIdx.x & 31);
    const bool valid = i < hi;
    const int32_t* r = src + (long long)(valid ? i : 0) * RS;
    const int32_t key =
        valid ? key0 + level_digit(r, W, sym_pos, nsym, shift, width) : 0;
    const int32_t slot = warp_add(cursor, key, valid);
    if (!valid) continue;
    int32_t* out = dst + (long long)slot * RS;
    if constexpr (KW > 0) {
      copy_rec(out, r);
    } else {
      for (int j = 0; j <= W; ++j) out[j] = r[j];
    }
  }
}

// The sort of segments for W > 5 (k > 65, off the main paths): the bitonic
// network in shared memory, one barrier a substage, over rows of cap int32.
// One block sorts one segment [seg_lo, seg_hi) of `src` (at most cap
// records) and writes order[i] and flags[i] = "key differs from record
// i-1" for every record but the segment's first; the first and last
// records' keys go to `ends` at the segment's own positions.
__global__ void __launch_bounds__(1024) sort_generic_kernel(
    const int32_t* src, int32_t* ends, int kw, const int32_t* seg_lo,
    const int32_t* seg_hi, int cap, int32_t* order, uint8_t* flags) {
  extern __shared__ int32_t sm[];
  const int RW = kw + 1;
  const int lo = seg_lo[blockIdx.x];
  const int m = seg_hi[blockIdx.x] - lo;
  int P = 1;
  while (P < m) P <<= 1;

  const int32_t* in = src + (long long)lo * RW;
  for (int e = threadIdx.x; e < m * RW; e += blockDim.x) {
    const int r = e / RW;
    sm[(e - r * RW) * cap + r] = in[e];
  }
  for (int r = m + threadIdx.x; r < P; r += blockDim.x)
    for (int c = 0; c < RW; ++c) sm[c * cap + r] = PAD;
  __syncthreads();

  for (int s = 1; (1 << s) <= P; ++s) {
    for (int t = s - 1; t >= 0; --t) {
      const int d = 1 << t;
      for (int q = threadIdx.x; q < (P >> 1); q += blockDim.x) {
        const int a = ((q & ~(d - 1)) << 1) | (q & (d - 1));
        const int b = a + d;
        const bool asc = ((a >> s) & 1) == 0;
        int c = 0;
        while (c < RW && sm[c * cap + a] == sm[c * cap + b]) ++c;
        if ((c < RW && sm[c * cap + a] > sm[c * cap + b]) == asc) {
          for (c = 0; c < RW; ++c) {
            const int32_t x = sm[c * cap + a];
            sm[c * cap + a] = sm[c * cap + b];
            sm[c * cap + b] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    order[lo + i] = sm[kw * cap + i];
    if (i > 0) {
      bool diff = false;
      for (int w = 0; w < kw; ++w) diff |= sm[w * cap + i] != sm[w * cap + i - 1];
      flags[lo + i] = diff;
    }
  }
  for (int w = threadIdx.x; w < kw; w += blockDim.x) {
    ends[(long long)lo * RW + w] = sm[w * cap];
    ends[(long long)(lo + m - 1) * RW + w] = sm[w * cap + m - 1];
  }
}

// The sort of segments for W <= 5 keeps E records a thread in registers:
// the network's substages at distances below E run inside a thread, those
// below 32 E through warp shuffles, and only the larger ones (6 of the 78
// substages at 4,096 records) through shared memory, with a barrier each.
// Two blocks share an SM (at most 128 registers a thread).
constexpr int LOG_E = 4;
constexpr int E = 1 << LOG_E;
constexpr int LOG_WARP_SPAN = LOG_E + 5;      // log2(32 * E)
constexpr int MAX_CAP = 4096;                 // records a sort block takes
constexpr int SORT_THREADS = MAX_CAP / E;

template <int RW>
__device__ __forceinline__ bool rec_gt(const int32_t* x, const int32_t* y) {
  bool gt = false, eq = true;
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    gt |= eq & (x[w] > y[w]);
    eq &= x[w] == y[w];
  }
  return gt;
}

// Compare-exchange of records e and e + D of this thread (global indices
// base + e), for stage s; D is a constant once the caller's loop unrolls.
template <int RW>
__device__ __forceinline__ void reg_substage(int32_t (&x)[E][RW], int base,
                                             int s, const int D) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e & D) continue;
    const bool asc = (((base + e) >> s) & 1) == 0;
    if (rec_gt<RW>(x[e], x[e + D]) == asc) {
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        const int32_t t = x[e][w];
        x[e][w] = x[e + D][w];
        x[e + D][w] = t;
      }
    }
  }
}

// Shared-memory rows of the register sort are padded by one word every 32,
// so that threads writing their E consecutive records hit distinct banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <int RW>
__device__ __forceinline__ void to_smem(int32_t* sm, int ld,
                                        const int32_t (&x)[E][RW], int base) {
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int w = 0; w < RW; ++w) sm[w * ld + padded(base + e)] = x[e][w];
}

template <int RW>
__device__ __forceinline__ void from_smem(const int32_t* sm, int ld,
                                          int32_t (&x)[E][RW], int base) {
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int w = 0; w < RW; ++w) x[e][w] = sm[w * ld + padded(base + e)];
}

template <int KW>
__global__ void __launch_bounds__(SORT_THREADS, 2) sort_reg_kernel(
    const int32_t* src, int32_t* ends, const int32_t* seg_lo,
    const int32_t* seg_hi, int cap, int32_t* order, uint8_t* flags) {
  constexpr int RW = KW + 1;
  extern __shared__ int32_t sm[];
  const int ld = cap + (cap >> 5);
  const int lo = seg_lo[blockIdx.x];
  const int m = seg_hi[blockIdx.x] - lo;
  int P = 32 * E;
  while (P < m) P <<= 1;
  const int L = __ffs(P) - 1;
  const int base = threadIdx.x * E;
  const bool active = base < P;          // whole warps: P / E is a multiple of 32
  const int lane = threadIdx.x & 31;

  int32_t x[E][RW];
  if (active) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (base + e < m) {
        const int4* r = reinterpret_cast<const int4*>(
            src + (long long)(lo + base + e) * REC_STRIDE);
        const int4 a = r[0];
        const int4 b = r[1];
        const int32_t v[REC_STRIDE] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int w = 0; w < RW; ++w) x[e][w] = v[w];
      } else {
#pragma unroll
        for (int w = 0; w < RW; ++w) x[e][w] = PAD;
      }
    }
  }

  for (int s = 1; s <= L; ++s) {
    if (s - 1 >= LOG_WARP_SPAN) {
      __syncthreads();
      if (active) to_smem<RW>(sm, ld, x, base);
      __syncthreads();
      for (int t = s - 1; t >= LOG_WARP_SPAN; --t) {
        const int d = 1 << t;
        for (int q = threadIdx.x; q < (P >> 1); q += blockDim.x) {
          const int a = ((q & ~(d - 1)) << 1) | (q & (d - 1));
          const int pa = padded(a), pb = padded(a + d);
          const bool asc = ((a >> s) & 1) == 0;
          bool gt = false, eq = true;
#pragma unroll
          for (int w = 0; w < RW; ++w) {
            const int32_t u = sm[w * ld + pa], v = sm[w * ld + pb];
            gt |= eq & (u > v);
            eq &= u == v;
          }
          if (gt == asc) {
#pragma unroll
            for (int w = 0; w < RW; ++w) {
              const int32_t y = sm[w * ld + pa];
              sm[w * ld + pa] = sm[w * ld + pb];
              sm[w * ld + pb] = y;
            }
          }
        }
        __syncthreads();
      }
      if (active) from_smem<RW>(sm, ld, x, base);
    }
    if (!active) continue;
    const int t_top = s - 1 < LOG_WARP_SPAN - 1 ? s - 1 : LOG_WARP_SPAN - 1;
    for (int t = t_top; t >= LOG_E; --t) {
      const int lane_mask = 1 << (t - LOG_E);
      const bool lower = (lane & lane_mask) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        int32_t y[RW];
#pragma unroll
        for (int w = 0; w < RW; ++w)
          y[w] = __shfl_xor_sync(FULL_MASK, x[e][w], lane_mask);
        const bool asc = (((base + e) >> s) & 1) == 0;
        // keep the smaller record where (lower == asc), else the larger
        if (rec_gt<RW>(x[e], y) == (lower == asc)) {
#pragma unroll
          for (int w = 0; w < RW; ++w) x[e][w] = y[w];
        }
      }
    }
#pragma unroll
    for (int t = LOG_E - 1; t >= 0; --t)
      if (t < s) reg_substage<RW>(x, base, s, 1 << t);
  }

  __syncthreads();
  if (active) to_smem<RW>(sm, ld, x, base);
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int pi = padded(i);
    order[lo + i] = sm[KW * ld + pi];
    if (i > 0) {
      const int pp = padded(i - 1);
      bool diff = false;
#pragma unroll
      for (int w = 0; w < KW; ++w) diff |= sm[w * ld + pi] != sm[w * ld + pp];
      flags[lo + i] = diff;
    }
  }
  if (threadIdx.x < KW) {
    ends[(long long)lo * REC_STRIDE + threadIdx.x] = sm[threadIdx.x * ld];
    ends[(long long)(lo + m - 1) * REC_STRIDE + threadIdx.x] =
        sm[threadIdx.x * ld + padded(m - 1)];
  }
}

// flags at each segment's first record: its key against the last key of
// the segment before it (every position ends exactly one segment's range).
template <int KW>
__global__ void boundary_kernel(const int32_t* recs, int kw,
                                const int32_t* seg_lo, int nseg,
                                uint8_t* flags) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  const int W = KW > 0 ? KW : kw;
  const int lo = seg_lo[s];
  if (lo == 0) {
    flags[0] = 0;
    return;
  }
  const int32_t* a = recs + (long long)lo * stride_of<KW>(kw);
  const int32_t* b = a - stride_of<KW>(kw);
  bool diff = false;
#pragma unroll
  for (int w = 0; w < W; ++w) diff |= a[w] != b[w];
  flags[lo] = diff;
}

inline unsigned grid_for(long long items) {
  long long g = (items + THREADS - 1) / THREADS;
  if (g < 1) g = 1;
  return (unsigned)(g < MAX_GRID ? g : MAX_GRID);
}

inline int sort_threads(int cap) {
  const int t = cap / 2;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <int KW>
cudaError_t run_scatter0(const uint8_t* codes, const int32_t* starts, int n, int k,
                     int kw, int prefix, int32_t* cursor, int32_t* recs,
                     cudaStream_t st) {
  scatter0_kernel<KW><<<grid_for(n), THREADS, 0, st>>>(codes, starts, n, k, kw,
                                                       prefix, cursor, recs);
  return cudaGetLastError();
}

template <int KW>
cudaError_t run_hist(const int32_t* src, int kw, const int32_t* ct,
                 const int32_t* clo, const int32_t* chi, int nchunks,
                 int sym_pos, int nsym, int shift, int width, int bins,
                 int32_t* counts, cudaStream_t st) {
  hist_kernel<KW><<<nchunks, THREADS, 0, st>>>(src, kw, ct, clo, chi, sym_pos,
                                               nsym, shift, width, bins, counts);
  return cudaGetLastError();
}

template <int KW>
cudaError_t run_scatter(const int32_t* src, int32_t* dst, int kw,
                    const int32_t* ct, const int32_t* clo, const int32_t* chi,
                    int nchunks, int sym_pos, int nsym, int shift, int width,
                    int bins, int32_t* cursor, cudaStream_t st) {
  scatter_kernel<KW><<<nchunks, THREADS, 0, st>>>(
      src, dst, kw, ct, clo, chi, sym_pos, nsym, shift, width, bins, cursor);
  return cudaGetLastError();
}

template <int KW>
cudaError_t run_sort(const int32_t* src, int32_t* ends, int kw,
                     const int32_t* seg_lo, const int32_t* seg_hi, int nseg,
                     int cap, int32_t* order, uint8_t* flags, cudaStream_t st) {
  cudaError_t err;
  if constexpr (KW > 0) {
    const size_t smem = (size_t)(KW + 1) * (cap + cap / 32) * sizeof(int32_t);
    err = cudaFuncSetAttribute(sort_reg_kernel<KW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    sort_reg_kernel<KW><<<nseg, cap / E, smem, st>>>(src, ends, seg_lo, seg_hi,
                                                     cap, order, flags);
  } else {
    const size_t smem = (size_t)(kw + 1) * cap * sizeof(int32_t);
    err = cudaFuncSetAttribute(sort_generic_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    sort_generic_kernel<<<nseg, sort_threads(cap), smem, st>>>(
        src, ends, kw, seg_lo, seg_hi, cap, order, flags);
  }
  return cudaGetLastError();
}

template <int KW>
cudaError_t run_bounds(const int32_t* recs, int kw, const int32_t* seg_lo,
                   int nseg, uint8_t* flags, cudaStream_t st) {
  boundary_kernel<KW><<<(nseg + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      recs, kw, seg_lo, nseg, flags);
  return cudaGetLastError();
}

}  // namespace

// Templated on the key words W (1..5, k <= 65); any other W runs the
// generic instantiation.
#define SORTNET_DISPATCH(kw, fn, ...)                 \
  switch (kw) {                                       \
    case 1: return (int)fn<1>(__VA_ARGS__);           \
    case 2: return (int)fn<2>(__VA_ARGS__);           \
    case 3: return (int)fn<3>(__VA_ARGS__);           \
    case 4: return (int)fn<4>(__VA_ARGS__);           \
    case 5: return (int)fn<5>(__VA_ARGS__);           \
    default: return (int)fn<0>(__VA_ARGS__);          \
  }

// Each entry point launches on `stream` and returns the first CUDA error of
// its launches, 0 when all were accepted. Record buffers hold n records of
// kw + 1 int32 (key words, then the window index), each padded to 8 int32
// for kw <= 5.

// counts[d] += windows whose first `prefix` symbols (prefix <= 13) have the
// base-5 value d.
extern "C" int sortnet_hist0(const uint8_t* codes, const int32_t* starts,
                             int n, int k, int prefix, int32_t* counts,
                             void* stream) {
  hist0_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      codes, starts, n, k, prefix, counts);
  return (int)cudaGetLastError();
}

// Packs every window and writes its record at cursor[digit]++.
extern "C" int sortnet_scatter0(const uint8_t* codes, const int32_t* starts,
                                int n, int k, int kw, int prefix,
                                int32_t* cursor, int32_t* recs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SORTNET_DISPATCH(kw, run_scatter0, codes, starts, n, k, kw, prefix, cursor, recs,
                   st)
}

// Re-partition counts: counts[task * bins + digit] over the chunks
// [chunk_lo, chunk_hi) of each chunk's task (bins <= 1024).
extern "C" int sortnet_hist(const int32_t* src, int kw,
                            const int32_t* chunk_task, const int32_t* chunk_lo,
                            const int32_t* chunk_hi, int nchunks, int sym_pos,
                            int nsym, int shift, int width, int bins,
                            int32_t* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SORTNET_DISPATCH(kw, run_hist, src, kw, chunk_task, chunk_lo, chunk_hi, nchunks,
                   sym_pos, nsym, shift, width, bins, counts, st)
}

// Re-partition: each record of the chunks goes from src to
// dst[cursor[task * bins + digit]++].
extern "C" int sortnet_scatter(const int32_t* src, int32_t* dst, int kw,
                               const int32_t* chunk_task,
                               const int32_t* chunk_lo,
                               const int32_t* chunk_hi, int nchunks,
                               int sym_pos, int nsym, int shift, int width,
                               int bins, int32_t* cursor, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SORTNET_DISPATCH(kw, run_scatter, src, dst, kw, chunk_task, chunk_lo, chunk_hi,
                   nchunks, sym_pos, nsym, shift, width, bins, cursor, st)
}

// Sorts each segment [seg_lo[s], seg_hi[s]) of src (at most cap records, cap
// a power of two from 128 to 4096; (kw + 1) * (cap + cap / 32) * 4 bytes of
// shared memory for kw <= 5, (kw + 1) * cap * 4 above).
extern "C" int sortnet_sort(const int32_t* src, int32_t* ends, int kw,
                            const int32_t* seg_lo, const int32_t* seg_hi,
                            int nseg, int cap, int32_t* order, uint8_t* flags,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SORTNET_DISPATCH(kw, run_sort, src, ends, kw, seg_lo, seg_hi, nseg, cap, order,
                   flags, st)
}

// The new-group flag of every segment's first record (flags[0] = 0).
extern "C" int sortnet_bounds(const int32_t* recs, int kw,
                              const int32_t* seg_lo, int nseg, uint8_t* flags,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SORTNET_DISPATCH(kw, run_bounds, recs, kw, seg_lo, nseg, flags, st)
}
