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
// What bounds it: W is sparse (a query weights a handful of terms), so the
// work is 2 * nnz(W) * N FMAs and the bytes are the M rows some query
// weights, read once from HBM: the kernel is bound by those bytes. The
// design follows from that.
//
// Phase 1 (row_lists_kernel): per query and operand pair, the ascending
// list of the nonzero columns of W with their weights, compacted on the
// card. Each (query, doc) sum then runs fmaf over the query's own rows,
// ascending, from 0 -- the same f32 sum as a dense K loop bit for bit: a
// row whose weight is zero adds fma(0, m, acc) = acc (M >= 0 and finite).
// The two operand pairs keep two accumulators, added at the end as the
// JAX scorer adds its two dots.
//
// Phase 2 (score_chunks_kernel): one warp per query, eight queries a
// block, one block per (query group, 1,024-doc chunk), blocks ordered
// chunk-major so the referenced rows of one chunk stay in L2 while every
// query group reads them. Each lane reads its docs as float4 through the
// read-only path (16 docs a pass, two passes). A pass first reads the
// docs' deletion and filter bytes; where no doc of the warp can match (a
// filter that matches nothing there) it reads no M row. The masked finite
// scores go into the warp's shared list as 64-bit keys (ordered score bits
// << 32 | ~doc: a larger key ranks first, keys are unique), and the warp
// keeps the top KC = min(k, 1,024) of its list (a warp radix select over
// the keys when the list is longer) with their count. A global top-k doc
// is inside its own chunk's top-KC, the Pallas kernel's exactness
// argument; -inf lanes are never written.
//
// Phase 3 (select_lists_kernel): each row's chunk lists are cut down to
// the row's top-k set. With few rows the lists of one row are split over
// several blocks (a partial top-k each, then one more level), so a large k
// over a small batch still fills the card. The last level pads each row
// to k keys with -inf keys.
//
// Phase 4 (topk_merge.cuh, shared with strip_topk.cu, unchanged): one
// block a row sorts its k keys and decodes them.
//
// M1 and M2 each in f32 or bf16 (SEARCHLITE_PRECISION=bf16 stores the
// resident dense rows, M1 of the split scorer, in bf16 beside an f32 M2):
// the score kernel is templated on both types and on the lane's group of
// G consecutive docs. With two f32 operands G = 4 (one float4 a group, the
// f32 kernel as it was); with a bf16 operand G = 8, so a bf16 row is read
// as one 16-byte load of 8 docs (an f32 row beside it as two float4). Each
// bf16 element is widened to f32 where it is loaded (exact) and the sums
// run in f32 as before: W is bf16-rounded by the caller, so every product
// is exact in f32 and only the order of the sums differs from plain (D10).
// The 16-byte path needs N % G == 0 and 16-byte-aligned bases (the scan's
// shards have odd N); otherwise every element is loaded on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

using topk_merge::make_key;
using topk_merge::pad_key;

constexpr int kChunk = 1024;              // docs per (query, chunk)
constexpr int kPass = 512;                // docs per pass of one warp
constexpr int kDocsPerLane = kPass / 32;  // 16: kDocsPerLane / G groups
constexpr int kWarps = 8;                 // queries per score block
constexpr int kScoreThreads = kWarps * 32;
constexpr int kListThreads = 256;
constexpr int kSelectThreads = 512;
constexpr int kHistCopies = 8;
// blocks the select levels aim for: two per SM of an H100
constexpr int kTargetBlocks = 264;
// largest intermediate buffer of a split select level
constexpr long long kMidBytes = 64ll << 20;

// Per (query, operand): the ascending nonzero columns of W's row with
// their weights, as int2 {col, float bits}, and their count. Block (q, y):
// y = 0 for W1, 1 for W2.
__global__ void __launch_bounds__(kListThreads)
row_lists_kernel(const float* __restrict__ w1, int K1,
                 const float* __restrict__ w2, int K2, int Q,
                 int2* __restrict__ lists1, int2* __restrict__ lists2,
                 int* __restrict__ counts) {
  static_assert(kListThreads / 32 * 4 == 32, "one warp scans the counts");
  __shared__ int s_cnt[32];
  __shared__ int s_off[32];
  __shared__ int s_tot;
  const int q = blockIdx.x;
  const int op = blockIdx.y;
  const int K = op == 0 ? K1 : K2;
  const float* wrow = (op == 0 ? w1 : w2) + static_cast<size_t>(q) * K;
  int2* out = (op == 0 ? lists1 : lists2) + static_cast<size_t>(q) * K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int base = 0;
  for (int c0 = 0; c0 < K; c0 += 4 * kListThreads) {
    float v[4];
    unsigned int m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + j * kListThreads + tid;
      v[j] = col < K ? wrow[col] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = __ballot_sync(0xffffffffu, v[j] != 0.0f);
      if (lane == 0) s_cnt[j * (kListThreads / 32) + warp] = __popc(m[j]);
    }
    __syncthreads();
    if (warp == 0) {
      // columns ascend j-major, then by thread: scan the 32 warp counts
      const int x = s_cnt[lane];
      int incl = x;
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      s_off[lane] = incl - x;
      if (lane == 31) s_tot = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] != 0.0f) {
        const int at = base + s_off[j * (kListThreads / 32) + warp] +
                       __popc(m[j] & ((1u << lane) - 1u));
        out[at] = make_int2(c0 + j * kListThreads + tid, __float_as_int(v[j]));
      }
    }
    base += s_tot;
    __syncthreads();
  }
  if (tid == 0) counts[op * Q + q] = base;
}

// One element of M, widened to f32.
__device__ __forceinline__ float load_m(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_m(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// A 32-bit word of two bf16, widened: the element at the lower address is
// the low half (little-endian); a bf16 is the high 16 bits of its f32.
__device__ __forceinline__ void widen2(unsigned int u, float* x) {
  x[0] = __uint_as_float(u << 16);
  x[1] = __uint_as_float(u & 0xffff0000u);
}

// G consecutive elements of a row at p, 16-byte loads (kVec: p aligned to
// G elements of 4 bytes, or to 16 bytes for G = 8 bf16; 8 bytes for G = 4
// bf16).
template <int G>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
#pragma unroll
  for (int h = 0; h < G / 4; ++h) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + h);
    x[4 * h] = v.x;
    x[4 * h + 1] = v.y;
    x[4 * h + 2] = v.z;
    x[4 * h + 3] = v.w;
  }
}
template <int G>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* x) {
  if (G == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    widen2(v.x, x);
    widen2(v.y, x + 2);
    widen2(v.z, x + 4);
    widen2(v.w, x + 6);
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    widen2(v.x, x);
    widen2(v.y, x + 2);
  }
}

// The lane's 16 docs of one M row: kDocsPerLane / G groups of G
// consecutive docs, group g at nb + 32 * G * g (nb = the pass's first doc
// + G * lane). Docs past N read as 0 (they are masked).
template <typename T, int G, bool kVec>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int N,
                                         int nb, float (&x)[kDocsPerLane]) {
#pragma unroll
  for (int g = 0; g < kDocsPerLane / G; ++g) {
    const int n = nb + 32 * G * g;
    if (kVec) {
      if (n < N) {
        load_vec<G>(row + n, x + G * g);
      } else {
#pragma unroll
        for (int e = 0; e < G; ++e) x[G * g + e] = 0.0f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        x[G * g + e] = n + e < N ? load_m(row + n + e) : 0.0f;
      }
    }
  }
}

// acc += sum over the query's listed rows, ascending, one fmaf per row.
// Two rows are loaded before either is added, so their loads overlap.
template <typename T, int G, bool kVec>
__device__ __forceinline__ void accumulate(const T* __restrict__ m,
                                           const int2* __restrict__ lst,
                                           int c, int N, int nb,
                                           float (&acc)[kDocsPerLane]) {
  int i = 0;
  for (; i + 1 < c; i += 2) {
    const int2 e0 = lst[i];
    const int2 e1 = lst[i + 1];
    float a[kDocsPerLane];
    float b[kDocsPerLane];
    load_row<T, G, kVec>(m + static_cast<size_t>(e0.x) * N, N, nb, a);
    load_row<T, G, kVec>(m + static_cast<size_t>(e1.x) * N, N, nb, b);
    const float w0 = __int_as_float(e0.y);
    const float w1 = __int_as_float(e1.y);
#pragma unroll
    for (int t = 0; t < kDocsPerLane; ++t) acc[t] = fmaf(w0, a[t], acc[t]);
#pragma unroll
    for (int t = 0; t < kDocsPerLane; ++t) acc[t] = fmaf(w1, b[t], acc[t]);
  }
  if (i < c) {
    const int2 e0 = lst[i];
    float a[kDocsPerLane];
    load_row<T, G, kVec>(m + static_cast<size_t>(e0.x) * N, N, nb, a);
    const float w0 = __int_as_float(e0.y);
#pragma unroll
    for (int t = 0; t < kDocsPerLane; ++t) acc[t] = fmaf(w0, a[t], acc[t]);
  }
}

// One radix pass's digit over 256 bins (hist, high bins first): lane l of
// a warp sums bins 255-8l .. 248-8l, a scan finds the bin where the count
// from the top reaches `remaining`. Returns (digit, keys above the digit's
// bin) in every lane.
__device__ __forceinline__ int2 find_digit(const unsigned int* hist,
                                           int remaining) {
  const int lane = threadIdx.x & 31;
  unsigned int mine = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) mine += hist[255 - 8 * lane - e];
  unsigned int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  const unsigned int hit =
      __ballot_sync(0xffffffffu, incl >= static_cast<unsigned int>(remaining));
  const int first = hit ? __ffs(hit) - 1 : 31;
  int digit = 0;
  unsigned int cum = incl - mine;
  if (lane == first) {
    int b = 255 - 8 * lane;
    for (int e = 0; e < 8; ++e, --b) {
      if (b == 0 || cum + hist[b] >= static_cast<unsigned int>(remaining)) {
        break;
      }
      cum += hist[b];
    }
    digit = b;
  }
  digit = __shfl_sync(0xffffffffu, digit, first);
  cum = __shfl_sync(0xffffffffu, cum, first);
  return make_int2(digit, static_cast<int>(cum));
}

template <typename T1, typename T2, int G, bool kVec>
__global__ void __launch_bounds__(kScoreThreads, 2)
score_chunks_kernel(const T1* __restrict__ m1, int K1,
                    const int2* __restrict__ lists1,
                    const T2* __restrict__ m2, int K2,
                    const int2* __restrict__ lists2,
                    const int* __restrict__ counts,
                    const uint8_t* __restrict__ deleted,
                    const uint8_t* __restrict__ frows,
                    const int* __restrict__ fidx, int Q, int N, int q_groups,
                    int n_chunks, int KC, unsigned long long* __restrict__ cand,
                    int* __restrict__ cand_cnt) {
  extern __shared__ unsigned long long s_lists[];  // [kWarps][kChunk]
  __shared__ unsigned int s_hist[kWarps][256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  const int chunk = blockIdx.x / q_groups;  // query groups of one chunk run
  const int q = (blockIdx.x % q_groups) * kWarps + warp;  // together
  if (q >= Q) return;  // warps are independent: no block barrier follows
  const int n0 = chunk * kChunk;
  unsigned long long* list = s_lists + warp * kChunk;
  const int c1 = counts[q];
  const int c2 = K2 > 0 ? counts[Q + q] : 0;
  const int2* l1 = lists1 + static_cast<size_t>(q) * K1;
  const int2* l2 = c2 > 0 ? lists2 + static_cast<size_t>(q) * K2 : nullptr;
  const uint8_t* frow =
      frows != nullptr ? frows + static_cast<size_t>(fidx[q]) * N : nullptr;

  int f = 0;  // keys in the warp's list
#pragma unroll 1
  for (int p = 0; p < kChunk / kPass; ++p) {
    const int nb = n0 + p * kPass + G * lane;
    // bit G*g+e: doc nb+32*G*g+e is in range, live and passes the query's
    // filter
    unsigned int live = 0;
#pragma unroll
    for (int g = 0; g < kDocsPerLane / G; ++g) {
      const int ng = nb + 32 * G * g;
      if (kVec && ng < N) {
#pragma unroll
        for (int h = 0; h < G / 4; ++h) {
          const int b = G * g + 4 * h;
          const uchar4 d =
              *reinterpret_cast<const uchar4*>(deleted + ng + 4 * h);
          uchar4 fr = make_uchar4(1, 1, 1, 1);
          if (frow != nullptr) {
            fr = *reinterpret_cast<const uchar4*>(frow + ng + 4 * h);
          }
          live |= static_cast<unsigned int>(d.x == 0 && fr.x != 0) << b;
          live |= static_cast<unsigned int>(d.y == 0 && fr.y != 0) << (b + 1);
          live |= static_cast<unsigned int>(d.z == 0 && fr.z != 0) << (b + 2);
          live |= static_cast<unsigned int>(d.w == 0 && fr.w != 0) << (b + 3);
        }
      } else if (!kVec) {
#pragma unroll
        for (int e = 0; e < G; ++e) {
          const int n = ng + e;
          if (n < N && deleted[n] == 0 && (frow == nullptr || frow[n] != 0)) {
            live |= 1u << (G * g + e);
          }
        }
      }
    }
    // a pass where no doc of the warp can match (a filter that matches
    // nothing here, deleted docs, past N) reads no row: it has no key
    if (!__any_sync(0xffffffffu, live != 0)) continue;
    float acc1[kDocsPerLane];
    float acc2[kDocsPerLane];
#pragma unroll
    for (int t = 0; t < kDocsPerLane; ++t) {
      acc1[t] = 0.0f;
      acc2[t] = 0.0f;
    }
    accumulate<T1, G, kVec>(m1, l1, c1, N, nb, acc1);
    if (c2 > 0) accumulate<T2, G, kVec>(m2, l2, c2, N, nb, acc2);
#pragma unroll
    for (int t = 0; t < kDocsPerLane; ++t) {
      const int n = nb + 32 * G * (t / G) + (t % G);
      const float v = acc1[t] + acc2[t];
      const bool ok = ((live >> t) & 1u) != 0 && v > 0.0f;
      const unsigned int mk = __ballot_sync(0xffffffffu, ok);
      if (ok) list[f + __popc(mk & below)] = make_key(v, n);
      f += __popc(mk);
    }
  }
  __syncwarp();

  unsigned long long* out =
      cand + (static_cast<size_t>(q) * n_chunks + chunk) * KC;
  if (f <= KC) {
    for (int i = lane; i < f; i += 32) out[i] = list[i];
    if (lane == 0) cand_cnt[q * n_chunks + chunk] = f;
    return;
  }

  // warp radix select of the KC-th largest key, most significant digit
  // first; it stops at the first digit whose bin holds exactly the keys
  // still wanted, then keys with (key & mask) >= prefix are the top KC
  unsigned int* hist = s_hist[warp];
  unsigned long long prefix = 0;
  unsigned long long mask = 0;
  int remaining = KC;
  for (int d = 7; d >= 0; --d) {
    const int shift = 8 * d;
    for (int b = lane; b < 256; b += 32) hist[b] = 0;
    __syncwarp();
    for (int i = lane; i < f; i += 32) {
      const unsigned long long key = list[i];
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255], 1u);
    }
    __syncwarp();
    const int2 dc = find_digit(hist, remaining);
    const unsigned int in_bin = hist[dc.x];
    prefix |= static_cast<unsigned long long>(dc.x) << shift;
    mask |= 255ull << shift;
    remaining -= dc.y;
    __syncwarp();
    if (in_bin == static_cast<unsigned int>(remaining)) break;
  }
  int at = 0;
  for (int i0 = 0; i0 < f; i0 += 32) {
    const int i = i0 + lane;
    const unsigned long long key = i < f ? list[i] : 0ull;
    const bool take = i < f && (key & mask) >= prefix;
    const unsigned int mk = __ballot_sync(0xffffffffu, take);
    if (take) out[at + __popc(mk & below)] = key;
    at += __popc(mk);
  }
  if (lane == 0) cand_cnt[q * n_chunks + chunk] = KC;
}

// Rows of L key lists (capacity cap each, counts in_cnt [rows, L]) cut to
// each row's top-min(k, n) keys: block (row, part) takes lists
// [part * LP, part * LP + LP). With out_cnt, writes out [rows, P, k] and
// the counts; without (P = 1, the last level), pads each row of
// out [rows, k] to k keys with -inf keys.
__global__ void __launch_bounds__(kSelectThreads)
select_lists_kernel(const unsigned long long* __restrict__ in,
                    const int* __restrict__ in_cnt, int L, int cap, int LP,
                    int P, int k, unsigned long long* __restrict__ out,
                    int* __restrict__ out_cnt) {
  __shared__ unsigned int hist[kHistCopies][256];
  __shared__ unsigned int tot[256];
  __shared__ int s_n;
  __shared__ unsigned int s_pos;
  __shared__ int2 s_digit;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  const int row = blockIdx.x / P;
  const int part = blockIdx.x % P;
  const int l0 = part * LP;
  const int l1 = min(L, l0 + LP);
  const int* cnt = in_cnt + static_cast<size_t>(row) * L;
  const unsigned long long* base = in + static_cast<size_t>(row) * L * cap;
  unsigned long long* o = out + (static_cast<size_t>(row) * P + part) * k;

  if (tid == 0) {
    s_n = 0;
    s_pos = 0;
  }
  __syncthreads();
  int mine = 0;
  for (int l = l0 + tid; l < l1; l += blockDim.x) mine += cnt[l];
  for (int s = 16; s > 0; s >>= 1) {
    mine += __shfl_down_sync(0xffffffffu, mine, s);
  }
  if (lane == 0 && mine) atomicAdd(&s_n, mine);
  __syncthreads();
  const int n = s_n;

  unsigned long long prefix = 0;
  unsigned long long mask = 0;
  if (n > k) {
    int remaining = k;
    for (int d = 7; d >= 0; --d) {
      const int shift = 8 * d;
      for (int i = tid; i < kHistCopies * 256; i += blockDim.x) {
        (&hist[0][0])[i] = 0;
      }
      __syncthreads();
      for (int l = l0 + warp; l < l1; l += nwarps) {
        const int c = cnt[l];
        const unsigned long long* src = base + static_cast<size_t>(l) * cap;
        for (int i = lane; i < c; i += 32) {
          const unsigned long long key = src[i];
          if ((key & mask) == prefix) {
            atomicAdd(&hist[warp & (kHistCopies - 1)][(key >> shift) & 255],
                      1u);
          }
        }
      }
      __syncthreads();
      for (int b = tid; b < 256; b += blockDim.x) {
        unsigned int sum = 0;
        for (int h = 0; h < kHistCopies; ++h) sum += hist[h][b];
        tot[b] = sum;
      }
      __syncthreads();
      if (warp == 0) {
        const int2 dc = find_digit(tot, remaining);
        if (lane == 0) s_digit = dc;
      }
      __syncthreads();
      const int2 dc = s_digit;
      prefix |= static_cast<unsigned long long>(dc.x) << shift;
      mask |= 255ull << shift;
      remaining -= dc.y;
      const bool done = tot[dc.x] == static_cast<unsigned int>(remaining);
      __syncthreads();
      if (done) break;
    }
  }
  // keep keys with (key & mask) >= prefix: all n keys when n <= k (mask
  // 0), else exactly k; warp-aggregated slots
  for (int l = l0 + warp; l < l1; l += nwarps) {
    const int c = cnt[l];
    const unsigned long long* src = base + static_cast<size_t>(l) * cap;
    for (int i0 = 0; i0 < c; i0 += 32) {
      const int i = i0 + lane;
      const unsigned long long key = i < c ? src[i] : 0ull;
      const bool take = i < c && (key & mask) >= prefix;
      const unsigned int mk = __ballot_sync(0xffffffffu, take);
      unsigned int at = 0;
      if (lane == 0 && mk) at = atomicAdd(&s_pos, __popc(mk));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (take) o[at + __popc(mk & below)] = key;
    }
  }
  const int kept = n < k ? n : k;
  if (out_cnt != nullptr) {
    if (tid == 0) out_cnt[static_cast<size_t>(row) * P + part] = kept;
  } else {
    for (int i = kept + tid; i < k; i += blockDim.x) o[i] = pad_key(i);
  }
}

struct Plan {
  int n_chunks, KC, P, LP, k2;
  size_t off_lists2, off_counts, off_cand, off_cand_cnt, off_mid, off_mid_cnt,
      off_fin, off_scratch, bytes;
};

size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

Plan make_plan(int Q, int N, int K1, int K2, int k) {
  Plan p;
  p.n_chunks = (N + kChunk - 1) / kChunk;
  p.KC = k < kChunk ? k : kChunk;
  p.k2 = 1;
  while (p.k2 < k) p.k2 <<= 1;
  // parts per row of the first select level: enough blocks to fill the
  // card when rows are few, within the intermediate buffer's budget
  int P = Q > 0 ? kTargetBlocks / Q : 1;
  if (P > p.n_chunks) P = p.n_chunks;
  if (P < 1) P = 1;
  while (P > 1 && static_cast<long long>(Q) * P * k * 8 > kMidBytes) P >>= 1;
  p.LP = (p.n_chunks + P - 1) / P;
  p.P = (p.n_chunks + p.LP - 1) / p.LP;
  size_t o = align16(static_cast<size_t>(Q) * K1 * sizeof(int2));
  p.off_lists2 = o;
  o += align16(static_cast<size_t>(Q) * K2 * sizeof(int2));
  p.off_counts = o;
  o += align16(static_cast<size_t>(2) * Q * sizeof(int));
  p.off_cand = o;
  o += align16(static_cast<size_t>(Q) * p.n_chunks * p.KC * 8);
  p.off_cand_cnt = o;
  o += align16(static_cast<size_t>(Q) * p.n_chunks * sizeof(int));
  p.off_mid = o;
  if (p.P > 1) o += align16(static_cast<size_t>(Q) * p.P * k * 8);
  p.off_mid_cnt = o;
  if (p.P > 1) o += align16(static_cast<size_t>(Q) * p.P * sizeof(int));
  p.off_fin = o;
  o += align16(static_cast<size_t>(Q) * k * 8);
  p.off_scratch = o;
  if (p.k2 > topk_merge::kSortAllKeys && p.k2 > topk_merge::kSortSmem) {
    o += align16(static_cast<size_t>(Q) * p.k2 * 8);
  }
  p.bytes = o;
  return p;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The score kernel for these M types: G = 4 docs a group for two f32
// operands, 8 with a bf16 one; the 16-byte loads where N and the bases
// allow them.
template <typename T1, typename T2>
int launch_score(const void* m1, int K1, const int2* lists1, const void* m2,
                 int K2, const int2* lists2, const int* counts,
                 const void* deleted, const void* frows, const void* fidx,
                 int Q, int N, int n_chunks, int KC,
                 unsigned long long* cand, int* cand_cnt, cudaStream_t s) {
  constexpr int G = (sizeof(T1) == 2 || sizeof(T2) == 2) ? 8 : 4;
  // vector loads need N % G == 0, 16-byte-aligned M bases and 4-byte-
  // aligned mask bases (every row then starts aligned too)
  const bool vec = N % G == 0 && aligned16(m1) &&
                   (K2 == 0 || aligned16(m2)) &&
                   (reinterpret_cast<uintptr_t>(deleted) & 3) == 0 &&
                   (frows == nullptr ||
                    (reinterpret_cast<uintptr_t>(frows) & 3) == 0);
  const int q_groups = (Q + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * kChunk * 8;
  auto score = vec ? score_chunks_kernel<T1, T2, G, true>
                   : score_chunks_kernel<T1, T2, G, false>;
  cudaError_t err = cudaFuncSetAttribute(
      score, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  score<<<q_groups * n_chunks, kScoreThreads, smem, s>>>(
      static_cast<const T1*>(m1), K1, lists1, static_cast<const T2*>(m2), K2,
      lists2, counts, static_cast<const uint8_t*>(deleted),
      static_cast<const uint8_t*>(frows), static_cast<const int*>(fidx), Q, N,
      q_groups, n_chunks, KC, cand, cand_cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The doc chunk each (query, chunk) candidate list covers.
int fused_topk_chunk() { return kChunk; }

// Bytes of device workspace fused_topk_launch needs for these shapes.
long long fused_topk_workspace_bytes(int Q, int N, int K1, int K2, int k) {
  return static_cast<long long>(make_plan(Q, N, K1, K2, k).bytes);
}

// w1 [Q, K1] f32, m1 [K1, N] (bf16 when m1_bf16 is 1, else f32); w2 [Q,
// K2] f32, m2 [K2, N] (bf16 when m2_bf16 is 1; K2 = 0: absent); deleted
// [N] uint8; frows [F+1, N] uint8 + fidx [Q] int32, or both null; ws:
// fused_topk_workspace_bytes(...) bytes, 16-byte aligned; ts [Q, k] f32,
// td [Q, k] int32; 1 <= k <= N. Launches every phase on `stream` and
// returns the first cudaError.
int fused_topk_launch_typed(const void* w1, const void* m1, int K1,
                            const void* w2, const void* m2, int K2,
                            int m1_bf16, int m2_bf16, const void* deleted,
                            const void* frows, const void* fidx, int Q, int N,
                            int k, void* ws, long long ws_bytes, void* ts,
                            void* td, void* stream) {
  if (Q == 0) return 0;
  if (k < 1 || k > N || K1 < 0 || K2 < 0) return cudaErrorInvalidValue;
  const Plan p = make_plan(Q, N, K1, K2, k);
  if (ws == nullptr || static_cast<long long>(p.bytes) > ws_bytes ||
      !aligned16(ws)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(ws);
  int2* lists1 = reinterpret_cast<int2*>(base);
  int2* lists2 = reinterpret_cast<int2*>(base + p.off_lists2);
  int* counts = reinterpret_cast<int*>(base + p.off_counts);
  auto* cand = reinterpret_cast<unsigned long long*>(base + p.off_cand);
  int* cand_cnt = reinterpret_cast<int*>(base + p.off_cand_cnt);
  auto* mid = reinterpret_cast<unsigned long long*>(base + p.off_mid);
  int* mid_cnt = reinterpret_cast<int*>(base + p.off_mid_cnt);
  auto* fin = reinterpret_cast<unsigned long long*>(base + p.off_fin);
  auto* scratch = reinterpret_cast<unsigned long long*>(base + p.off_scratch);

  row_lists_kernel<<<dim3(Q, K2 > 0 ? 2 : 1), kListThreads, 0, s>>>(
      static_cast<const float*>(w1), K1, static_cast<const float*>(w2), K2,
      Q, lists1, lists2, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using bf16 = __nv_bfloat16;
  const int b1 = m1_bf16 ? 1 : 0;
  const int b2 = K2 > 0 && m2_bf16 ? 1 : 0;
  const int score_err =
      b1 && b2 ? launch_score<bf16, bf16>(m1, K1, lists1, m2, K2, lists2,
                                          counts, deleted, frows, fidx, Q, N,
                                          p.n_chunks, p.KC, cand, cand_cnt, s)
      : b1 ? launch_score<bf16, float>(m1, K1, lists1, m2, K2, lists2, counts,
                                       deleted, frows, fidx, Q, N, p.n_chunks,
                                       p.KC, cand, cand_cnt, s)
      : b2 ? launch_score<float, bf16>(m1, K1, lists1, m2, K2, lists2, counts,
                                       deleted, frows, fidx, Q, N, p.n_chunks,
                                       p.KC, cand, cand_cnt, s)
           : launch_score<float, float>(m1, K1, lists1, m2, K2, lists2,
                                        counts, deleted, frows, fidx, Q, N,
                                        p.n_chunks, p.KC, cand, cand_cnt, s);
  if (score_err != 0) return score_err;

  if (p.P > 1) {
    select_lists_kernel<<<Q * p.P, kSelectThreads, 0, s>>>(
        cand, cand_cnt, p.n_chunks, p.KC, p.LP, p.P, k, mid, mid_cnt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    select_lists_kernel<<<Q, kSelectThreads, 0, s>>>(
        mid, mid_cnt, p.P, k, p.P, 1, k, fin, nullptr);
  } else {
    select_lists_kernel<<<Q, kSelectThreads, 0, s>>>(
        cand, cand_cnt, p.n_chunks, p.KC, p.n_chunks, 1, k, fin, nullptr);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return topk_merge::merge_topk_launch(
      fin, Q, k, k, p.k2, N - 1, nullptr, static_cast<float*>(ts),
      static_cast<int*>(td), scratch, nullptr, 0, nullptr, s);
}

// fused_topk_launch_typed with m1 and m2 in f32.
int fused_topk_launch(const void* w1, const void* m1, int K1, const void* w2,
                      const void* m2, int K2, const void* deleted,
                      const void* frows, const void* fidx, int Q, int N,
                      int k, void* ws, long long ws_bytes, void* ts, void* td,
                      void* stream) {
  return fused_topk_launch_typed(w1, m1, K1, w2, m2, K2, 0, 0, deleted, frows,
                                 fidx, Q, N, k, ws, ws_bytes, ts, td, stream);
}

}  // extern "C"
