// Candidate-strip scoring read in place from the posting blocks: duplicate-
// doc combine + top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel searchlite_tpu/ops/pallas_strip.py::_strip_kernel
// (:157, entry pallas_strip_topk :210) together with the gather that feeds
// it, searchlite_tpu/ops/sparse.py::_strip_gather (:66), and the JAX default
// sort core of _candidate_core. The strip is never written: a row's virtual
// strip of nblk * 128 lanes is the concatenation of its term slots, slot t
// being block rows bstart[t] .. bstart[t] + bcnt[t] - 1 of block_docs /
// block_impacts (cut where the strip's nblk blocks end); lanes past the
// row's blocks are the sentinel n1-1 (sent[1]).
//
// Precondition (postings are doc-sorted per term, so real segments hold it
// by construction; tests/test_torch_strip_blocks.py checks it):
//   - each slot's lanes are doc-ascending;
//   - each live doc appears at most once in a slot;
//   - the sentinel n1-1 pads only the tail of a slot's last block.
//
// Per lane (slot t, doc d != sentinel), the rule the plain version (a
// stable sort by doc, log2_run Hillis-Steele shifted adds, run ends) gives:
//   - the lane OWNS d if d is absent from every later slot t' > t: equal
//     docs sort in slot order, so that lane is the run end;
//   - the owner's value sums v_s = impact * w[s] over the slots s <= t
//     holding d, in the shifted-add tree of the plain scan (the run's last
//     2^log2_run lanes, right-aligned leaves, pairs summed right + left):
//     (v2 + v1) + v0 for three slots, (v3 + v2) + (v1 + v0) for four;
//   - the lane is kept when it owns d and the sum is > 0.
// Products and sums use __fmul_rn / __fadd_rn: nvcc would otherwise fuse
// a product into the following add (--fmad=true) and break the bit
// identity with the plain version's separately rounded f32 ops.
//
// What bounds it on the card: each lane's (doc, impact) is read once
// (8 B), plus, per tile, the docs of the other slots that fall in the
// tile's doc range; the bitonic sort of every lane that this replaces
// (log2(L)^2 / 2 passes, one thread block a row) is gone. Wide rows are
// bound by those bytes; tiles of narrow rows by the latency of their few
// dependent steps (slot table, loads, searches, top-k), which the
// whole-row staging below shortens.
//
// Design. Grid (tile, row): a tile is up to 8 blocks (1,024 lanes) of ONE
// slot, 256 threads of 4 lanes, so a 4-row launch of wide rows still fills
// the card; tiles past a row's blocks only write padding keys. A tile
// reads its lanes. A row of at most 8,192 lanes is staged whole in shared
// memory with cp.async while the tile loads them, and every search runs
// there. In a wider row the tile takes its doc range [dlo, dhi], and a
// warp a slot finds the sub-range of each other slot's sorted run inside
// it (32-way sampled search). Per (tile, slot) it then either stages that
// sub-range with cp.async (double-buffered: the next slot loads while this
// one is searched) when it fits, or, when a rare-term tile spans a head
// term's run, searches the sub-range in place through L2. Later slots are
// visited first (ownership), then earlier ones in descending order, which
// feeds the sum tree its leaves right to left; a tile whose lanes all lost
// ownership skips the earlier slots. Each tile keeps its best
// KT = min(1024, max(16, k)) lanes as 64-bit keys (ordered score bits,
// ~doc): warp-level bitonic sorts for KT = 16, a block sort otherwise.
// The row merge (topk_merge.cuh, shared with fused_topk.cu) sorts or
// radix-selects each row's keys and sums the per-tile match counts.
// strip_lanes_blocks_launch runs the tile kernel alone at KT = 1,024 and
// writes every lane's (score, doc) instead of keys, for callers that read
// the whole strip.
//
// Impacts in f32 or bf16 (SEARCHLITE_PRECISION=bf16, ops/precision.py):
// the tile kernel is templated on the impact type. A bf16 block row is
// 256 bytes, so a thread's four lanes are one 8-byte load instead of 16;
// each impact is widened with __bfloat162float (exact) where it is loaded,
// and everything after the load is the f32 code. So the kernel on bf16
// operands is bit-identical to the plain version run on the impacts
// widened to f32, as the f32 kernel is to the plain version on f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

using topk_merge::make_key;
using topk_merge::pad_key;

constexpr int kThreads = 256;
constexpr int kLanesPerThread = 4;
constexpr int kTileLanes = kThreads * kLanesPerThread;  // 1,024
constexpr int kTileBlocks = kTileLanes / 128;           // 8
constexpr int kMaxSlots = 256;
constexpr int kStageDocs = 4096;  // docs per staging buffer; two buffers
constexpr int kWarpKT = 16;       // the warp-sort path's keys a tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool kGlobal>
__device__ __forceinline__ int load_doc(const int* a, int i) {
  return kGlobal ? __ldg(a + i) : a[i];
}

// One impact, widened to f32 (exact for bf16).
__device__ __forceinline__ float load_imp(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_imp(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Four consecutive impacts of a block row (p 16-byte aligned for f32,
// 8-byte for bf16), widened to f32.
__device__ __forceinline__ float4 load_imp4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_imp4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// A thread's four lower bounds (first index whose value is >= x[j]) in
// the sorted a[0, n), n >= 1, searched in lockstep without branches so the
// four loads of a step issue together.
template <bool kGlobal>
__device__ __forceinline__ void lower_bound4(const int* a, int n,
                                             const int (&x)[4], int (&p)[4]) {
  int base[4] = {0, 0, 0, 0};
  while (n > 1) {
    const int half = n >> 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      base[j] = load_doc<kGlobal>(a, base[j] + half) < x[j] ? base[j] + half
                                                            : base[j];
    }
    n -= half;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = base[j] + (load_doc<kGlobal>(a, base[j]) < x[j] ? 1 : 0);
  }
}

// lower_bound by one warp: each round 32 lanes sample the range and a
// ballot keeps the 1/32 that holds the answer, so a 131,072-lane run takes
// 4 dependent loads instead of 17. Every lane returns the index.
__device__ __forceinline__ int warp_lower_bound(const int* a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  while (n > 32) {
    const int step = (n + 31) >> 5;
    const int q = lane * step;
    const bool less = q < n && __ldg(a + base + q) < x;
    const int c = __popc(__ballot_sync(0xffffffffu, less));
    if (c == 0) return base;
    const int end = c * step < n ? c * step : n;
    base += (c - 1) * step + 1;
    n = end - (c - 1) * step - 1;
  }
  const bool less = lane < n && __ldg(a + base + lane) < x;
  return base + __popc(__ballot_sync(0xffffffffu, less));
}

// The plain scan's sum tree for one run end, fed leaves right to left:
// leaf positions count down from 2^L - 1; acc[l] holds a finished node of
// level l waiting for its left sibling (bit l of pend). A left child
// combines with the waiting right sibling at once; leaves past the
// window of 2^L lanes are dropped, as the scan drops them.
template <int LM>
struct SumTree {
  float acc[LM + 1];
  unsigned pend;
  int pos;

  __device__ __forceinline__ void init(int L) {
    pend = 0;
    pos = (1 << L) - 1;
  }

  __device__ __forceinline__ void add(float u, int L) {
    if (pos < 0) return;
    const int p = pos--;
    float cur = u;
    bool placed = false;  // no break: static indices keep acc in registers
#pragma unroll
    for (int l = 0; l <= LM; ++l) {
      if (!placed) {
        if (l == L || ((p >> l) & 1)) {
          acc[l] = cur;
          pend |= 1u << l;
          placed = true;
        } else {
          cur = __fadd_rn(acc[l], cur);
          pend &= ~(1u << l);
        }
      }
    }
  }

  // the root: waiting nodes combine upward, missing left siblings add
  // nothing (the scan's + 0.0)
  __device__ __forceinline__ float total() const {
    float r = 0.0f;
    bool has = false;
#pragma unroll
    for (int l = 0; l <= LM; ++l) {
      if ((pend >> l) & 1u) {
        r = has ? __fadd_rn(acc[l], r) : acc[l];
        has = true;
      }
    }
    return r;
  }
};

// Descending bitonic sort of a warp's 128 keys: key j of a lane is
// element j * 32 + lane.
__device__ __forceinline__ void warp_sort128_desc(unsigned long long (&k)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 2; kk <= 128; kk <<= 1) {
#pragma unroll
    for (int d = kk >> 1; d > 0; d >>= 1) {
      if (d >= 32) {
        const int jd = d >> 5;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((j & jd) == 0) {
            const bool desc = ((j * 32 + lane) & kk) == 0;
            const unsigned long long a = k[j];
            const unsigned long long b = k[j | jd];
            if ((a < b) == desc) {
              k[j] = b;
              k[j | jd] = a;
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, k[j], d);
          const bool desc = ((j * 32 + lane) & kk) == 0;
          const bool lower = (lane & d) == 0;
          const bool take_max = lower == desc;
          k[j] = take_max ? (k[j] > o ? k[j] : o) : (k[j] < o ? k[j] : o);
        }
      }
    }
  }
}

template <int LM, typename Imp>
__global__ void __launch_bounds__(kThreads, 4)
strip_tile_kernel(const int* __restrict__ bdocs,
                  const Imp* __restrict__ bimps,
                  const int* __restrict__ bstart, const int* __restrict__ bcnt,
                  const float* __restrict__ w, const int* __restrict__ sent,
                  int row0, int T, int nblk, int L, int n_tiles, int KT,
                  unsigned long long* __restrict__ cand,
                  int* __restrict__ tile_counts,
                  float* __restrict__ lane_scores,
                  int* __restrict__ lane_docs) {
  extern __shared__ __align__(16) int stage[];  // 2 x kStageDocs docs
  __shared__ long long s_start[kMaxSlots];      // slot's first lane in bdocs
  __shared__ int s_len[kMaxSlots];              // slot's lanes in the strip
  __shared__ float s_w[kMaxSlots];
  __shared__ int s_lo[kMaxSlots];  // sub-range [lo, hi) in [dlo, dhi]
  __shared__ int s_hi[kMaxSlots];
  __shared__ int s_act[kMaxSlots];  // slots to visit, in visiting order
  __shared__ int s_voff[kMaxSlots];  // slot's first lane in the row's strip
  __shared__ int s_nact, s_nown;
  __shared__ int s_t, s_b0, s_nb, s_row_lanes;
  __shared__ int s_dlo, s_dhi, s_count;
  __shared__ unsigned long long s_wtop[kThreads / 32 * kWarpKT];

  const int tile = blockIdx.x;
  const int row = row0 + blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dead = sent[1];
  const size_t tile_at = static_cast<size_t>(row) * n_tiles + tile;
  // all-lanes mode (lane_scores set): every lane's (score, doc), no keys
  const bool all_lanes = lane_scores != nullptr;
  unsigned long long* out = all_lanes ? nullptr : cand + tile_at * KT;

  // 1. the row's slot table and this tile's slot (warp 0, 32 slots a step)
  if (warp == 0) {
    if (lane == 0) {
      s_t = -1;
      s_dlo = INT_MAX;
      s_dhi = -1;
      s_count = 0;
    }
    __syncwarp();
    int begin_base = 0;
    int tile_base = 0;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      int c = 0;
      long long st = 0;
      float wt = 0.0f;
      if (t < T) {
        const size_t at = static_cast<size_t>(row) * T + t;
        c = bcnt[at];
        st = static_cast<long long>(bstart[at]) * 128;
        wt = w[at];
      }
      int inc = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += up;
      }
      const int begin = begin_base + inc - c;
      const int eff = max(0, min(c, nblk - begin));
      const int nt = (eff + kTileBlocks - 1) / kTileBlocks;
      int tinc = nt;
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, tinc, o);
        if (lane >= o) tinc += up;
      }
      const int tbeg = tile_base + tinc - nt;
      if (t < T) {
        s_start[t] = st;
        s_len[t] = eff * 128;
        s_voff[t] = min(begin, nblk) * 128;
        s_w[t] = wt;
        if (tile >= tbeg && tile < tbeg + nt) {
          s_t = t;
          s_b0 = (tile - tbeg) * kTileBlocks;
          s_nb = min(kTileBlocks, eff - (tile - tbeg) * kTileBlocks);
        }
      }
      begin_base += __shfl_sync(0xffffffffu, inc, 31);
      tile_base += __shfl_sync(0xffffffffu, tinc, 31);
    }
    if (lane == 0) s_row_lanes = min(begin_base, nblk) * 128;
  }
  __syncthreads();
  const int t = s_t;
  if (t < 0) {  // past the row's blocks: padding only
    for (int i = tid; i < KT; i += kThreads) {
      if (all_lanes) {
        lane_scores[tile_at * kTileLanes + i] = -INFINITY;
        lane_docs[tile_at * kTileLanes + i] = dead;
      } else {
        out[i] = pad_key(tile * kTileLanes + i);
      }
    }
    if (tid == 0) tile_counts[tile_at] = 0;
    return;
  }

  // a row of at most two staging buffers' lanes is staged whole, in strip
  // order, while the tile loads its own lanes: every search is then in
  // shared memory with no wait between slots
  const bool whole_row = s_row_lanes <= 2 * kStageDocs;
  if (whole_row) {
    for (int s = 0; s < T; ++s) {
      const int* src = bdocs + s_start[s];
      int* dst = stage + s_voff[s];
      for (int q = tid; q < (s_len[s] >> 2); q += kThreads) {
        cp_async16(dst + 4 * q, src + 4 * q);
      }
    }
    cp_async_commit();
  }

  // 2. this tile's lanes and their doc range
  const long long base = s_start[t] + static_cast<long long>(s_b0) * 128;
  const int nl = s_nb * 128;
  int d[kLanesPerThread];
  bool owner[kLanesPerThread];
  SumTree<LM> tree[kLanesPerThread];
  const float wt = s_w[t];
  int my_lo = INT_MAX;
  int my_hi = -1;
  // four consecutive lanes a thread: one 16-byte load of docs and one of
  // impacts (8 bytes in bf16); a tile starts on a block row, nl is a
  // multiple of 128
  int4 d4 = make_int4(dead, dead, dead, dead);
  float4 i4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid * kLanesPerThread < nl) {
    d4 = __ldg(reinterpret_cast<const int4*>(bdocs + base) + tid);
    i4 = load_imp4(bimps + base + tid * kLanesPerThread);
  }
  const int dl[kLanesPerThread] = {d4.x, d4.y, d4.z, d4.w};
  const float il[kLanesPerThread] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    d[j] = dl[j];
    const float imp = il[j];
    owner[j] = d[j] != dead;
    tree[j].init(L);
    tree[j].add(__fmul_rn(imp, wt), L);
    if (owner[j]) {
      my_lo = min(my_lo, d[j]);
      my_hi = max(my_hi, d[j]);
    }
  }
  if (whole_row) {
    // 3-4. later slots first (ownership), then earlier ones descending;
    // a thread whose lanes all lost ownership stops
    cp_async_wait<0>();
    __syncthreads();
    for (int s = T - 1; s >= 0; --s) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) any |= owner[j];
      if (!any) break;
      const int n = s_len[s];
      if (s == t || n == 0) continue;
      const int* arr = stage + s_voff[s];
      int p[kLanesPerThread];
      lower_bound4<false>(arr, n, d, p);
      const float ws = s_w[s];
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        if (!owner[j] || p[j] >= n || arr[p[j]] != d[j]) continue;
        if (s > t) {
          owner[j] = false;
        } else {
          const float imp = load_imp(bimps + s_start[s] + p[j]);
          tree[j].add(__fmul_rn(imp, ws), L);
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    my_lo = min(my_lo, __shfl_xor_sync(0xffffffffu, my_lo, o));
    my_hi = max(my_hi, __shfl_xor_sync(0xffffffffu, my_hi, o));
  }
  if (lane == 0 && my_hi >= 0) {
    atomicMin(&s_dlo, my_lo);
    atomicMax(&s_dhi, my_hi);
  }
  __syncthreads();
  const int dlo = s_dlo;
  const int dhi = s_dhi;

  if (!whole_row && dhi >= 0) {
    // 3. each other slot's sub-range inside [dlo, dhi] (a run that fits a
    // staging buffer is taken whole)
    for (int s = warp; s < T; s += kThreads / 32) {
      int lo = 0;
      int hi = 0;
      if (s != t && s_len[s] <= kStageDocs) {
        hi = s_len[s];  // a short run is staged whole: no search
      } else if (s != t) {
        const int* a = bdocs + s_start[s];
        lo = warp_lower_bound(a, s_len[s], dlo);
        hi = lo + warp_lower_bound(a + lo, s_len[s] - lo, dhi + 1);
      }
      if (lane == 0) {
        s_lo[s] = lo;
        s_hi[s] = hi;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int s = T - 1; s > t; --s) {
        if (s_hi[s] > s_lo[s]) s_act[n++] = s;
      }
      s_nown = n;
      for (int s = t - 1; s >= 0; --s) {
        if (s_hi[s] > s_lo[s]) s_act[n++] = s;
      }
      s_nact = n;
    }
    __syncthreads();
    const int nact = s_nact;
    const int nown = s_nown;

    // 4. visit the slots: stage a fitting sub-range (16-byte aligned: a
    // slot starts on a 512-byte block row) while the previous one is
    // searched, or search it in place
    auto issue = [&](int i) {
      if (i < nact) {
        const int s = s_act[i];
        const int lo4 = s_lo[s] & ~3;
        const int hi4 = min((s_hi[s] + 3) & ~3, s_len[s]);
        if (hi4 - lo4 <= kStageDocs) {
          const int* src = bdocs + s_start[s] + lo4;
          int* dst = stage + (i & 1) * kStageDocs;
          for (int q = tid; q < (hi4 - lo4) >> 2; q += kThreads) {
            cp_async16(dst + 4 * q, src + 4 * q);
          }
        }
      }
      cp_async_commit();
    };
    issue(0);
    for (int i = 0; i < nact; ++i) {
      if (i == nown && i > 0) {
        bool any = false;
#pragma unroll
        for (int j = 0; j < kLanesPerThread; ++j) any |= owner[j];
        if (!__syncthreads_or(any)) break;
      }
      issue(i + 1);
      cp_async_wait<1>();
      __syncthreads();
      const int s = s_act[i];
      const bool later = s > t;
      const int lo4 = s_lo[s] & ~3;
      const int hi4 = min((s_hi[s] + 3) & ~3, s_len[s]);
      const bool staged = hi4 - lo4 <= kStageDocs;
      const int off = staged ? lo4 : s_lo[s];
      const int n = staged ? hi4 - lo4 : s_hi[s] - s_lo[s];
      const int* arr = staged ? stage + (i & 1) * kStageDocs
                              : bdocs + s_start[s] + off;
      const float ws = s_w[s];
      bool mine = false;
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) mine |= owner[j];
      int p[kLanesPerThread] = {n, n, n, n};
      if (__any_sync(0xffffffffu, mine)) {  // else the warp's lanes are done
        if (staged) {
          lower_bound4<false>(arr, n, d, p);
        } else {
          lower_bound4<true>(arr, n, d, p);
        }
      }
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        if (!owner[j] || p[j] >= n) continue;
        if ((staged ? arr[p[j]] : __ldg(arr + p[j])) != d[j]) continue;
        if (later) {
          owner[j] = false;
        } else {
          const float imp = load_imp(bimps + s_start[s] + off + p[j]);
          tree[j].add(__fmul_rn(imp, ws), L);
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
  }

  // 5. scores, the tile's match count, its best KT keys (or, in the
  // all-lanes mode, every lane's score and doc)
  unsigned long long key[kLanesPerThread];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const float sc = owner[j] ? tree[j].total() : 0.0f;
    const bool ok = owner[j] && sc > 0.0f;
    cnt += ok ? 1 : 0;
    key[j] = ok ? make_key(sc, d[j])
                : pad_key(tile * kTileLanes + tid * kLanesPerThread + j);
    if (all_lanes) {
      const size_t at = tile_at * kTileLanes + tid * kLanesPerThread + j;
      lane_scores[at] = ok ? sc : -INFINITY;
      lane_docs[at] = ok ? d[j] : dead;
    }
  }
  // the warp's match count, in every lane
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (lane == 0 && cnt) atomicAdd(&s_count, cnt);
  __syncthreads();  // also: every staged read is done
  if (tid == 0) tile_counts[tile_at] = s_count;

  if (all_lanes) return;
  if (KT >= kTileLanes) {
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      out[tid * kLanesPerThread + j] = key[j];
    }
  } else if (KT == kWarpKT) {
    // a warp without a match keeps 16 of its (unique) padding keys
    if (cnt > 0) warp_sort128_desc(key);
    if (lane < kWarpKT) s_wtop[warp * kWarpKT + lane] = key[0];
    __syncthreads();
    if (warp == 0) {
      unsigned long long top[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) top[j] = s_wtop[j * 32 + lane];
      warp_sort128_desc(top);
      if (lane < kWarpKT) out[lane] = top[0];
    }
  } else {
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(stage);
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      keys[tid * kLanesPerThread + j] = key[j];
    }
    __syncthreads();
    topk_merge::bitonic_sort_desc(keys, kTileLanes);
    for (int i = tid; i < KT; i += kThreads) out[i] = keys[i];
  }
}

template <int LM, typename Imp>
int launch_tiles(const int* bdocs, const Imp* bimps, const int* bstart,
                 const int* bcnt, const float* w, const int* sent, int B,
                 int T, int nblk, int L, int n_tiles, int KT,
                 unsigned long long* cand, int* tile_counts,
                 float* lane_scores, int* lane_docs, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2) * kStageDocs * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      strip_tile_kernel<LM, Imp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int row0 = 0; row0 < B; row0 += 65535) {
    const int rows = B - row0 < 65535 ? B - row0 : 65535;
    strip_tile_kernel<LM, Imp>
        <<<dim3(n_tiles, rows), kThreads, smem, stream>>>(
        bdocs, bimps, bstart, bcnt, w, sent, row0, T, nblk, L, n_tiles, KT,
        cand, tile_counts, lane_scores, lane_docs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The tile kernel at the sum-tree depth that covers log2_run.
template <typename Imp>
int launch_tiles_any(const int* bdocs, const Imp* bimps, const int* bstart,
                     const int* bcnt, const float* w, const int* sent, int B,
                     int T, int nblk, int L, int n_tiles, int KT,
                     unsigned long long* cand, int* tile_counts,
                     float* lane_scores, int* lane_docs, cudaStream_t stream) {
  if (L <= 2) {
    return launch_tiles<2, Imp>(bdocs, bimps, bstart, bcnt, w, sent, B, T,
                                nblk, L, n_tiles, KT, cand, tile_counts,
                                lane_scores, lane_docs, stream);
  }
  if (L <= 4) {
    return launch_tiles<4, Imp>(bdocs, bimps, bstart, bcnt, w, sent, B, T,
                                nblk, L, n_tiles, KT, cand, tile_counts,
                                lane_scores, lane_docs, stream);
  }
  return launch_tiles<8, Imp>(bdocs, bimps, bstart, bcnt, w, sent, B, T,
                              nblk, L, n_tiles, KT, cand, tile_counts,
                              lane_scores, lane_docs, stream);
}

// Both impact types: imp_bf16 selects __nv_bfloat16, else f32.
int launch_tiles_typed(const int* bdocs, const void* bimps, int imp_bf16,
                       const int* bstart, const int* bcnt, const float* w,
                       const int* sent, int B, int T, int nblk, int L,
                       int n_tiles, int KT, unsigned long long* cand,
                       int* tile_counts, float* lane_scores, int* lane_docs,
                       cudaStream_t stream) {
  if (imp_bf16) {
    return launch_tiles_any(bdocs, static_cast<const __nv_bfloat16*>(bimps),
                            bstart, bcnt, w, sent, B, T, nblk, L, n_tiles,
                            KT, cand, tile_counts, lane_scores, lane_docs,
                            stream);
  }
  return launch_tiles_any(bdocs, static_cast<const float*>(bimps), bstart,
                          bcnt, w, sent, B, T, nblk, L, n_tiles, KT, cand,
                          tile_counts, lane_scores, lane_docs, stream);
}

}  // namespace

extern "C" {

// Geometry the wrapper sizes its buffers with.
int strip_topk_tile_lanes() { return kTileLanes; }
int strip_topk_max_slots() { return kMaxSlots; }
int strip_topk_sort_smem_keys() { return topk_merge::kSortSmem; }

// block_docs [R, 128] int32 and block_impacts [R, 128] f32, or bf16 when
// imp_bf16 is 1 (both 16-byte aligned); bstart, bcnt [B, T] int32, w [B,
// T] f32; sent [2] int32 on the
// device (sentinel block row, dead doc n1-1). Scratch: cand [B, n_tiles *
// KT] uint64, tile_counts [B, n_tiles] int32, merge_scratch [B, k2] uint64
// when k2 > strip_topk_sort_smem_keys() (else null). Outputs ts [B, k] f32,
// td [B, k] int32, counts [B] int32. KT = min(tile lanes, max(16, k));
// n_tiles >= ceil(nblk / 8) + T and n_tiles * KT >= k; k2 is the next power
// of two >= k; T <= strip_topk_max_slots(); log2_run <= 8. Launches the
// tile kernel and the row merge on `stream`; returns the first cudaError.
int strip_topk_blocks_launch(const void* block_docs, const void* block_impacts,
                             int imp_bf16, const void* bstart, const void* bcnt,
                             const void* w, const void* sent, int B, int T,
                             int nblk, int k, int k2, int log2_run, int KT,
                             int n_tiles, void* cand, void* tile_counts,
                             void* ts, void* td, void* counts,
                             void* merge_scratch, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || T > kMaxSlots || log2_run < 0 || log2_run > 8 || k < 1 ||
      KT != (k < kWarpKT ? kWarpKT : (k > kTileLanes ? kTileLanes : k)) ||
      n_tiles < 1 ||
      n_tiles > 65535 || static_cast<long long>(n_tiles) * KT < k) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(sent);
  unsigned long long* c = static_cast<unsigned long long*>(cand);
  int* tc = static_cast<int*>(tile_counts);
  const int err = launch_tiles_typed(
      static_cast<const int*>(block_docs), block_impacts, imp_bf16,
      static_cast<const int*>(bstart), static_cast<const int*>(bcnt),
      static_cast<const float*>(w), sp, B, T, nblk, log2_run, n_tiles, KT, c,
      tc, nullptr, nullptr, s);
  if (err != 0) return err;
  return topk_merge::merge_topk_launch(
      c, B, n_tiles * KT, k, k2, 0, sp + 1, static_cast<float*>(ts),
      static_cast<int*>(td), static_cast<unsigned long long*>(merge_scratch),
      tc, n_tiles, static_cast<int*>(counts), s);
}

// Every kept doc of each row's strip with its score, in lane order, for
// callers that read the whole strip (the single-query term split): the tile
// kernel alone at KT = 1,024, no keys and no row merge. lane_scores [B,
// n_tiles * strip_topk_tile_lanes()] f32 receives each kept lane's summed
// score and -inf elsewhere, lane_docs (same shape, int32) its doc (the dead
// doc elsewhere); tile_counts [B, n_tiles] int32 the kept lanes per tile.
// n_tiles >= ceil(nblk / 8) + T; the other operands as
// strip_topk_blocks_launch's.
int strip_lanes_blocks_launch(const void* block_docs, const void* block_impacts,
                              int imp_bf16, const void* bstart,
                              const void* bcnt, const void* w,
                              const void* sent, int B, int T,
                              int nblk, int log2_run, int n_tiles,
                              void* lane_scores, void* lane_docs,
                              void* tile_counts, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || T > kMaxSlots || log2_run < 0 || log2_run > 8 ||
      n_tiles < 1 || n_tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  return launch_tiles_typed(
      static_cast<const int*>(block_docs), block_impacts, imp_bf16,
      static_cast<const int*>(bstart), static_cast<const int*>(bcnt),
      static_cast<const float*>(w), static_cast<const int*>(sent), B, T, nblk,
      log2_run, n_tiles, kTileLanes, nullptr, static_cast<int*>(tile_counts),
      static_cast<float*>(lane_scores), static_cast<int*>(lane_docs),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
