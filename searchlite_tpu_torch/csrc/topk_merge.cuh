// Row merge of 64-bit top-k candidate keys, for Hopper (sm_90a). Shared by
// fused_topk.cu and strip_topk.cu: both kernels leave per-tile candidate
// keys, and one block a row merges them here.
//
// A key is (ordered score bits << 32 | ~doc): a larger key ranks first by
// (score desc, doc asc), and keys of a row must be unique. Keys whose
// score is -inf are padding; they decode to the dead doc slot.
//
// merge_topk_kernel, per row of n keys (k <= n):
//   - n up to kSortAllKeys: every key is bitonic-sorted descending in
//     shared memory and the first k are decoded;
//   - wider: an 8-pass radix select (8-bit digits, eight shared
//     histograms summed per bin, a one-warp scan of the bins) finds the
//     k-th largest key T, the exactly k keys >= T are compacted and
//     bitonic-sorted (in shared memory up to kSortSmem keys, wider in a
//     global scratch row with the sub-chunk stages in shared memory), and
//     decoded.
// Optionally it also sums per-tile match counts into one count a row
// (integer sums: deterministic).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk_merge {

constexpr int kMergeThreads = 1024;
constexpr int kHistCopies = 8;     // digit histograms, one per 4 warps
constexpr int kSortSmem = 16384;    // keys sorted in shared memory (128 KB)
constexpr int kSortAllKeys = 4096;  // rows of at most this many keys skip
                                    // the radix select

__device__ __forceinline__ uint32_t ordered_bits(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned long long make_key(float s, int doc) {
  return (static_cast<unsigned long long>(ordered_bits(s)) << 32) |
         static_cast<unsigned long long>(~static_cast<uint32_t>(doc));
}

// A padding key: score -inf, unique by `id` within its row.
__device__ __forceinline__ unsigned long long pad_key(int id) {
  return make_key(-INFINITY, id);
}

// One compare-exchange stage (merge size kk, distance j) of a DESCENDING
// bitonic sort over the n keys of D, whose first key is global index base.
__device__ __forceinline__ void bitonic_stage_desc(unsigned long long* D,
                                                   int n, int base, int kk,
                                                   int j) {
  for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int ixj = i + j;
    const bool desc = ((base + i) & kk) == 0;
    const unsigned long long a = D[i];
    const unsigned long long b = D[ixj];
    if ((a < b) == desc) {
      D[i] = b;
      D[ixj] = a;
    }
  }
}

// Descending bitonic sort of n (a power of two) keys in shared memory.
__device__ __forceinline__ void bitonic_sort_desc(unsigned long long* D,
                                                  int n) {
  for (int kk = 2; kk <= n; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      bitonic_stage_desc(D, n, 0, kk, j);
      __syncthreads();
    }
  }
}

// cand [rows, n] keys; outputs ts [rows, k] f32, td [rows, k] int32 (-inf
// entries carry the dead doc: *dead_ptr when given, else `dead`). k2 is the
// next power of two >= k; scratch [rows, k2] when the radix path's k2 >
// kSortSmem. With tile_counts [rows, n_tiles] int32, counts[row] is their
// sum. Dynamic shared memory: merge_smem_bytes(n, k2).
__global__ void __launch_bounds__(kMergeThreads)
merge_topk_kernel(const unsigned long long* __restrict__ cand, int n, int k,
                  int k2, int dead, const int* __restrict__ dead_ptr,
                  float* __restrict__ ts, int* __restrict__ td,
                  unsigned long long* __restrict__ scratch,
                  const int* __restrict__ tile_counts, int n_tiles,
                  int* __restrict__ counts) {
  extern __shared__ unsigned long long sbuf[];
  __shared__ unsigned int hist[kHistCopies][256];
  __shared__ unsigned int tot[256];
  __shared__ unsigned long long s_prefix;
  __shared__ int s_remaining;
  __shared__ unsigned int s_count;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned long long* c = cand + static_cast<size_t>(row) * n;
  if (dead_ptr != nullptr) dead = *dead_ptr;

  if (tile_counts != nullptr && warp == 0) {
    const int* tc = tile_counts + static_cast<size_t>(row) * n_tiles;
    int total = 0;
    for (int i = lane; i < n_tiles; i += 32) total += tc[i];
    for (int o = 16; o > 0; o >>= 1) {
      total += __shfl_down_sync(0xffffffffu, total, o);
    }
    if (lane == 0) counts[row] = total;
  }

  unsigned long long* buf;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  if (n2 <= kSortAllKeys) {
    // small rows: sort every key
    for (int i = tid; i < n2; i += nthreads) sbuf[i] = i < n ? c[i] : 0ull;
    __syncthreads();
    bitonic_sort_desc(sbuf, n2);
    buf = sbuf;
  } else {
    // 1. radix select, most significant digit first: T = the k-th largest
    unsigned long long prefix = 0;
    unsigned long long mask = 0;
    int remaining = k;
    for (int d = 7; d >= 0; --d) {
      const int shift = 8 * d;
      for (int i = tid; i < kHistCopies * 256; i += nthreads) {
        (&hist[0][0])[i] = 0;
      }
      __syncthreads();
      for (int i = tid; i < n; i += nthreads) {
        const unsigned long long key = c[i];
        if ((key & mask) == prefix) {
          atomicAdd(&hist[warp & (kHistCopies - 1)][(key >> shift) & 255],
                    1u);
        }
      }
      __syncthreads();
      for (int b = tid; b < 256; b += nthreads) {
        unsigned int sum = 0;
        for (int h = 0; h < kHistCopies; ++h) sum += hist[h][b];
        tot[b] = sum;
      }
      __syncthreads();
      if (warp == 0) {
        // lane l sums bins 255-8l .. 248-8l (high bins first); the bin
        // where the running count from the top reaches `remaining` is the
        // digit
        unsigned int mine = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) mine += tot[255 - 8 * lane - e];
        unsigned int incl = mine;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned int up = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += up;
        }
        const unsigned int excl = incl - mine;
        const unsigned int hit = __ballot_sync(
            0xffffffffu, incl >= static_cast<unsigned int>(remaining));
        const int first = hit ? __ffs(hit) - 1 : 31;
        if (lane == first) {
          unsigned int cum = excl;
          int b = 255 - 8 * lane;
          for (int e = 0; e < 8; ++e, --b) {
            if (b == 0 ||
                cum + tot[b] >= static_cast<unsigned int>(remaining)) {
              break;
            }
            cum += tot[b];
          }
          s_prefix = prefix | (static_cast<unsigned long long>(b) << shift);
          s_remaining = remaining - static_cast<int>(cum);
        }
      }
      __syncthreads();
      prefix = s_prefix;
      remaining = s_remaining;
      mask |= 255ull << shift;
    }
    const unsigned long long T = prefix;

    // 2. the exactly k keys >= T (keys are unique), zero-padded to k2
    const bool in_smem = k2 <= kSortSmem;
    buf = in_smem ? sbuf : scratch + static_cast<size_t>(row) * k2;
    if (tid == 0) s_count = 0;
    __syncthreads();
    for (int i = tid; i < n; i += nthreads) {
      const unsigned long long key = c[i];
      if (key >= T) buf[atomicAdd(&s_count, 1u)] = key;
    }
    for (int i = k + tid; i < k2; i += nthreads) buf[i] = 0ull;
    __syncthreads();

    // 3. descending bitonic sort of the k2 keys
    if (in_smem) {
      bitonic_sort_desc(buf, k2);
    } else {
      const int C = kSortSmem;
      for (int c0 = 0; c0 < k2; c0 += C) {
        for (int i = tid; i < C; i += nthreads) sbuf[i] = buf[c0 + i];
        __syncthreads();
        for (int kk = 2; kk <= C; kk <<= 1) {
          for (int j = kk >> 1; j > 0; j >>= 1) {
            bitonic_stage_desc(sbuf, C, c0, kk, j);
            __syncthreads();
          }
        }
        for (int i = tid; i < C; i += nthreads) buf[c0 + i] = sbuf[i];
        __syncthreads();
      }
      for (int kk = 2 * C; kk <= k2; kk <<= 1) {
        for (int j = kk >> 1; j >= C; j >>= 1) {
          bitonic_stage_desc(buf, k2, 0, kk, j);
          __syncthreads();
        }
        for (int c0 = 0; c0 < k2; c0 += C) {
          for (int i = tid; i < C; i += nthreads) sbuf[i] = buf[c0 + i];
          __syncthreads();
          for (int j = C >> 1; j > 0; j >>= 1) {
            bitonic_stage_desc(sbuf, C, c0, kk, j);
            __syncthreads();
          }
          for (int i = tid; i < C; i += nthreads) buf[c0 + i] = sbuf[i];
          __syncthreads();
        }
      }
    }
  }

  // 4. decode
  float* ts_row = ts + static_cast<size_t>(row) * k;
  int* td_row = td + static_cast<size_t>(row) * k;
  for (int r = tid; r < k; r += nthreads) {
    const unsigned long long key = buf[r];
    const float s = from_ordered(static_cast<uint32_t>(key >> 32));
    ts_row[r] = s;
    td_row[r] = s == -INFINITY
                    ? dead
                    : static_cast<int>(~static_cast<uint32_t>(key));
  }
}

// Threads and dynamic shared memory of a merge launch over rows of n keys.
inline int merge_threads(int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  if (n2 > kSortAllKeys) return kMergeThreads;
  int t = n2 / 2;
  if (t < 64) t = 64;
  return t > kMergeThreads ? kMergeThreads : t;
}

inline size_t merge_smem_bytes(int n, int k2) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  const int keys = n2 <= kSortAllKeys ? n2 : (k2 < kSortSmem ? k2 : kSortSmem);
  return static_cast<size_t>(keys) * sizeof(unsigned long long);
}

// Launches merge_topk_kernel over `rows` rows on `stream`; returns the
// first cudaError.
inline int merge_topk_launch(const unsigned long long* cand, int rows, int n,
                             int k, int k2, int dead, const int* dead_ptr,
                             float* ts, int* td, unsigned long long* scratch,
                             const int* tile_counts, int n_tiles,
                             int* counts, cudaStream_t stream) {
  if (rows == 0) return 0;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  if (k < 1 || k > n || k2 < k) return cudaErrorInvalidValue;
  if (n2 > kSortAllKeys && k2 > kSortSmem && scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = merge_smem_bytes(n, k2);
  cudaError_t err = cudaFuncSetAttribute(
      merge_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_topk_kernel<<<rows, merge_threads(n), smem, stream>>>(
      cand, n, k, k2, dead, dead_ptr, ts, td, scratch, tile_counts, n_tiles,
      counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace topk_merge
