// Fused dense scoring + mask + top-k over the doc axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel searchlite_tpu/ops/pallas_topk.py::_kernel (entry
// make_fused_topk) and, in the port, the tail of the dense scorers
// (ops/impact.py::_score_m and make_split_impact_scorer): per query row q
//
//   score[q, n] = sum_r W1[q, r] * M1[r, n]  (+ sum_s W2[q, s] * M2[s, n])
//   ok          = score > 0 && !deleted[n] && (filter_rows[fidx[q], n])
//
// and the top-k of the ok scores by (score desc, doc asc), -inf past the
// row's matches (their ids are N-1, the dead doc slot). Exact at any k.
//
// Phase 0 (tile_rows_kernel): W is sparse -- a query weights a few terms
// -- so for each 64-query tile and operand pair, the ascending list of the
// K rows that any of its queries weights. Phase 1 visits only those rows:
// a skipped row would add fma(0, m, acc) = acc, so every sum is the one
// the full K loop gives, bit for bit, at a fraction of the FMAs and M
// loads (a b256 tile of the 100k-doc corpus weights a few hundred of its
// ~3,800 rows).
//
// Phase 1 (fused_score_kernel): one block per (64-query tile, 128-doc
// chunk). W and M tiles of BK listed rows are staged through shared
// memory and multiplied with f32 FMAs on the CUDA cores -- no tensor
// cores: TF32 would break the exact-f32 contract. The two operand pairs
// keep two accumulators, added at the end as the JAX scorer adds its two
// dots. The masked tile goes to shared memory and each (query, chunk)
// keeps its top-KC candidates, KC = min(128, max(16, k)): all of them when
// at most KC lanes are finite, else the finite lanes ranked by counting
// among themselves. A global top-k doc is inside its own chunk's top-KC,
// the Pallas kernel's exactness argument. Candidates are
// written as 64-bit keys (ordered score bits << 32 | ~doc), so a larger key
// ranks first and keys are unique.
//
// Phase 2 (topk_merge.cuh, shared with strip_topk.cu): one block per query
// row merges the row's n_chunks * KC keys (all sorted when they are few,
// else an 8-pass radix select for the k-th key and a bitonic sort of the k
// survivors) and decodes them. A second kernel rather than one block-wide
// reduction round per result: at k = 2,000 over 131,072 candidates those
// rounds would dominate the call.
//
// What bounds it on the card: phase 1 reads the listed M rows once per
// query tile (each staged element feeds 64 queries) and runs 2*64*N flops
// per listed row and tile; phase 2 reads each candidate key 9 times.
// Double-buffered loads (cp.async, TMA) and wgmma are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

using topk_merge::make_key;

constexpr int BM = 64;    // queries per tile
constexpr int BN = 128;   // docs per tile: the chunk C
constexpr int BK = 16;    // K step
constexpr int TM = 8;     // queries per thread
constexpr int TN = 4;     // docs per thread
constexpr int kThreads = 256;  // (BM / TM) * (BN / TN)
constexpr int ASTR = BM + 4;   // padded row of the transposed W tile

// One 64-query tile's list of the K rows of W any of its queries weights,
// ascending: rows_out[qt * K + i], count in counts[qt]. One block a tile.
__global__ void __launch_bounds__(kThreads)
tile_rows_kernel(const float* __restrict__ W, int K, int Q,
                 int* __restrict__ rows_out, int* __restrict__ counts) {
  __shared__ int warp_n[kThreads / 32];
  __shared__ int warp_off[kThreads / 32];
  __shared__ int s_total;
  const int qt = blockIdx.x;
  const int q0 = qt * BM;
  const int q1 = min(q0 + BM, Q);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* out = rows_out + static_cast<size_t>(qt) * K;
  int total = 0;
  for (int c0 = 0; c0 < K; c0 += kThreads) {
    const int col = c0 + tid;
    bool nz = false;
    if (col < K) {
      // no early exit: the loads are independent and issue together
      for (int q = q0; q < q1; ++q) {
        nz |= W[static_cast<size_t>(q) * K + col] != 0.0f;
      }
    }
    const unsigned int mask = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) warp_n[warp] = __popc(mask);
    __syncthreads();
    if (tid == 0) {
      int off = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        warp_off[w] = off;
        off += warp_n[w];
      }
      s_total = off;
    }
    __syncthreads();
    if (nz) {
      out[total + warp_off[warp] + __popc(mask & ((1u << lane) - 1u))] = col;
    }
    total += s_total;
    __syncthreads();
  }
  if (tid == 0) counts[qt] = total;
}

// acc += W[q0:q0+BM, rows] @ M[rows, n0:n0+BN] over the tile's n_rows
// listed rows, this thread's TM x TN share.
__device__ __forceinline__ void gemm_pass(const float* __restrict__ W,
                                          const float* __restrict__ M, int K,
                                          const int* __restrict__ rows,
                                          int n_rows, int Q, int N, int q0,
                                          int n0, float (&acc)[TM][TN],
                                          float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  for (int s0 = 0; s0 < n_rows; s0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int qq = idx / BK;
      const int kk = idx % BK;
      const int q = q0 + qq;
      const int kg = s0 + kk < n_rows ? rows[s0 + kk] : -1;
      As[kk * ASTR + qq] =
          (q < Q && kg >= 0) ? W[static_cast<size_t>(q) * K + kg] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx / BN;
      const int nn = idx % BN;
      const int kg = s0 + kk < n_rows ? rows[s0 + kk] : -1;
      const int n = n0 + nn;
      Bs[kk * BN + nn] =
          (kg >= 0 && n < N) ? M[static_cast<size_t>(kg) * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * ASTR + ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk * ASTR + ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * BN + tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
fused_score_kernel(const float* __restrict__ w1, const float* __restrict__ m1,
                   int K1, const float* __restrict__ w2,
                   const float* __restrict__ m2, int K2,
                   const int* __restrict__ rows1,
                   const int* __restrict__ rows2,
                   const int* __restrict__ n_rows,
                   const uint8_t* __restrict__ deleted,
                   const uint8_t* __restrict__ frows,
                   const int* __restrict__ fidx, int Q, int N, int q_tiles,
                   int n_chunks, int KC,
                   unsigned long long* __restrict__ cand) {
  __shared__ __align__(16) float As[BK * ASTR];
  __shared__ __align__(16) float Bs[BK * BN];
  __shared__ __align__(16) float St[BM * BN];

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int qt = blockIdx.x % q_tiles;  // query tiles of one chunk run
  const int chunk = blockIdx.x / q_tiles;  // together: M tiles hit L2
  const int q0 = qt * BM;
  const int n0 = chunk * BN;

  float acc1[TM][TN];
  float acc2[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc1[i][j] = 0.0f;
      acc2[i][j] = 0.0f;
    }
  }
  gemm_pass(w1, m1, K1, rows1 + static_cast<size_t>(qt) * K1, n_rows[qt],
            Q, N, q0, n0, acc1, As, Bs);
  if (K2 > 0) {
    gemm_pass(w2, m2, K2, rows2 + static_cast<size_t>(qt) * K2,
              n_rows[q_tiles + qt], Q, N, q0, n0, acc2, As, Bs);
  }

  // mask into the shared score tile
  bool live[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx * TN + j;
    live[j] = n < N && deleted[n] == 0;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qq = ty * TM + i;
    const int q = q0 + qq;
    const uint8_t* frow =
        (frows != nullptr && q < Q)
            ? frows + static_cast<size_t>(fidx[q]) * N
            : nullptr;
    float s[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      const float v = acc1[i][j] + acc2[i][j];
      bool ok = q < Q && live[j] && v > 0.0f;
      if (ok && frow != nullptr) ok = frow[n] != 0;
      s[j] = ok ? v : -INFINITY;
    }
    *reinterpret_cast<float4*>(&St[qq * BN + tx * TN]) =
        make_float4(s[0], s[1], s[2], s[3]);
  }
  __syncthreads();

  // per (query, chunk): a top-KC candidate set by (score desc, doc asc),
  // in any slot order (the merge sorts). With f <= KC finite lanes they
  // all go, -inf lanes fill the rest; otherwise the finite lanes are
  // compacted into a per-warp list (in Bs, free after the products) and
  // each is ranked by counting the finite lanes that rank before it.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned int below = (1u << lane) - 1u;
  float* list_s = Bs + warp * 2 * BN;
  int* list_i = reinterpret_cast<int*>(list_s + BN);
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int q = q0 + r;
    if (q >= Q) break;
    const float* srow = St + r * BN;
    unsigned long long* out =
        cand + (static_cast<size_t>(q) * n_chunks + chunk) * KC;
    float mine[BN / 32];
    int slot[BN / 32];
    int f = 0;
    int n_inf = 0;
#pragma unroll
    for (int e = 0; e < BN / 32; ++e) {
      mine[e] = srow[lane + 32 * e];
      const bool fin = mine[e] != -INFINITY;
      const unsigned int m = __ballot_sync(0xffffffffu, fin);
      slot[e] = fin ? f + __popc(m & below) : n_inf + __popc(~m & below);
      f += __popc(m);
      n_inf += 32 - __popc(m);
    }
    if (KC == BN || f <= KC) {
#pragma unroll
      for (int e = 0; e < BN / 32; ++e) {
        const int at = mine[e] != -INFINITY ? slot[e] : f + slot[e];
        if (at < KC) out[at] = make_key(mine[e], n0 + lane + 32 * e);
      }
      continue;
    }
#pragma unroll
    for (int e = 0; e < BN / 32; ++e) {
      if (mine[e] != -INFINITY) {
        list_s[slot[e]] = mine[e];
        list_i[slot[e]] = lane + 32 * e;
      }
    }
    __syncwarp();
    for (int c = lane; c < f; c += 32) {
      const float sc = list_s[c];
      const int ic = list_i[c];
      int rank = 0;
      for (int j = 0; j < f; ++j) {
        const float sj = list_s[j];
        rank += (sj > sc || (sj == sc && list_i[j] < ic)) ? 1 : 0;
      }
      if (rank < KC) out[rank] = make_key(sc, n0 + ic);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Tile geometry the wrapper sizes its buffers with.
int fused_topk_chunk() { return BN; }
int fused_topk_sort_smem_keys() { return topk_merge::kSortSmem; }

// w1 [Q, K1] f32, m1 [K1, N] f32; w2 [Q, K2], m2 [K2, N] (K2 = 0: absent);
// deleted [N] uint8; frows [F+1, N] uint8 + fidx [Q] int32, or both null;
// rows [q_tiles * (K1 + K2 + 2)] int32 scratch (q_tiles = ceil(Q / 64));
// cand [Q, n_chunks * KC] uint64 scratch; ts [Q, k] f32, td [Q, k] int32;
// sort_scratch [Q, k2] uint64 when k2 > fused_topk_sort_smem_keys(), else
// null. k2 is the next power of two >= k; 1 <= k <= N. Launches both
// phases on `stream` and returns the first cudaError.
int fused_topk_launch(const void* w1, const void* m1, int K1, const void* w2,
                      const void* m2, int K2, const void* deleted,
                      const void* frows, const void* fidx, int Q, int N,
                      int k, int k2, int KC, void* rows, void* cand, void* ts,
                      void* td, void* sort_scratch, void* stream) {
  if (Q == 0) return 0;
  if (k < 1 || k > N || KC < 1 || KC > BN || k2 < k) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q_tiles = (Q + BM - 1) / BM;
  const int n_chunks = (N + BN - 1) / BN;
  int* rows1 = static_cast<int*>(rows);
  int* rows2 = rows1 + static_cast<size_t>(q_tiles) * K1;
  int* n_rows = rows2 + static_cast<size_t>(q_tiles) * K2;
  tile_rows_kernel<<<q_tiles, kThreads, 0, s>>>(
      static_cast<const float*>(w1), K1, Q, rows1, n_rows);
  if (K2 > 0) {
    tile_rows_kernel<<<q_tiles, kThreads, 0, s>>>(
        static_cast<const float*>(w2), K2, Q, rows2, n_rows + q_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_score_kernel<<<q_tiles * n_chunks, kThreads, 0, s>>>(
      static_cast<const float*>(w1), static_cast<const float*>(m1), K1,
      static_cast<const float*>(w2), static_cast<const float*>(m2), K2,
      rows1, rows2, n_rows,
      static_cast<const uint8_t*>(deleted), static_cast<const uint8_t*>(frows),
      static_cast<const int*>(fidx), Q, N, q_tiles, n_chunks, KC,
      static_cast<unsigned long long*>(cand));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return topk_merge::merge_topk_launch(
      static_cast<const unsigned long long*>(cand), Q, n_chunks * KC, k, k2,
      N - 1, nullptr, static_cast<float*>(ts), static_cast<int*>(td),
      static_cast<unsigned long long*>(sort_scratch), nullptr, 0, nullptr, s);
}

}  // extern "C"
