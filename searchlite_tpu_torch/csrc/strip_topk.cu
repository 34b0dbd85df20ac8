// Strip sort + duplicate-doc combine + top-k over candidate strips, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel searchlite_tpu/ops/pallas_strip.py::_strip_kernel
// (entry pallas_strip_topk) and the JAX default sort core of
// searchlite_tpu/ops/sparse.py::_candidate_core. Per row of a [B, L] strip
// of (doc int32, weighted impact f32):
//   1. pad to L2 = next pow2 with (sentinel, 0) -- in place, while loading;
//   2. bitonic sort on the key (doc, original lane): equal docs keep strip
//      order, as a stable sort does, so every run sum below adds the same
//      values in the same order as the plain version (bit-identical);
//   3. inclusive segmented sum over equal-doc runs, log2_run Hillis-Steele
//      shifted adds (the run total lands on the run's last lane);
//   4. keep run ends whose doc is not the sentinel and whose value is > 0,
//      and count them;
//   5. top-k by (score desc, doc asc), -inf padded: k rounds of a
//      block-wide reduction for small k; for k >= kSortMinK on a row in
//      shared memory, a bitonic sort of every lane's 64-bit key (ordered
//      score bits << 32 | ~doc) and the first k -- the term-split scorer
//      asks for k = the strip width, where k rounds cost k passes.
//
// Layout: one thread block per strip row. A row of L2 <= 16384 lanes lives
// in dynamic shared memory (12 bytes a lane: doc, lane-then-value, second
// value buffer). Wider rows live in a global scratch buffer the caller
// allocates ([B, 3, L2] int32); they are sorted in 16384-lane chunks in
// shared memory, and only the merge stages whose distance spans chunks run
// over global memory.
//
// What bounds it on the card: the strip bytes moved through the sort, about
// log2(L2)^2 / 2 compare-exchange passes over 8 bytes a lane, plus k
// reduction passes over the survivors. Shared-memory rows keep every pass
// on chip; the global path keeps all passes with distance < 16384 on chip.
// Merging the <= t_pad pre-sorted term runs instead of a full sort, fusing
// the block gather and TMA loads are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLanes = 16384;
constexpr int kSortMinK = 64;  // from here a sort beats k reduction rounds

// (score desc, doc asc) as one unsigned key: larger ranks first
__device__ __forceinline__ unsigned long long score_key(float s, int doc) {
  const uint32_t u = __float_as_uint(s);
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) |
         static_cast<unsigned long long>(~static_cast<uint32_t>(doc));
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ bool key_greater(int da, int la, int db, int lb) {
  return da > db || (da == db && la > lb);
}

// One bitonic compare-exchange stage (merge size kk, distance j) over the n
// lanes of (D, Ln), whose first lane is global lane `base` of the row.
__device__ __forceinline__ void bitonic_stage(int* D, int* Ln, int n,
                                              int base, int kk, int j) {
  for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int ixj = i + j;
    const bool ascending = ((base + i) & kk) == 0;
    const int d0 = D[i], l0 = Ln[i], d1 = D[ixj], l1 = Ln[ixj];
    if (key_greater(d0, l0, d1, l1) == ascending) {
      D[i] = d1;
      Ln[i] = l1;
      D[ixj] = d0;
      Ln[ixj] = l0;
    }
  }
}

// (score desc, doc asc): true when (sa, da) ranks before (sb, db).
__device__ __forceinline__ bool ranks_before(float sa, int da, float sb,
                                             int db) {
  return sa > sb || (sa == sb && da < db);
}

__global__ void __launch_bounds__(kMaxThreads)
strip_topk_kernel(const int* __restrict__ d_in,
                  const float* __restrict__ v_in,
                  const int* __restrict__ sent_ptr, int L, int L2, int k,
                  int log2_run, float* __restrict__ ts,
                  int* __restrict__ td, int* __restrict__ counts,
                  int* __restrict__ scratch) {
  extern __shared__ __align__(16) int smem[];
  __shared__ float red_s[kMaxThreads / 32];
  __shared__ int red_d[kMaxThreads / 32];
  __shared__ int red_c[kMaxThreads / 32];
  __shared__ float best_s;
  __shared__ int best_d;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
  const int sent = *sent_ptr;
  const int C = L2 < kSmemLanes ? L2 : kSmemLanes;
  const bool in_smem = L2 <= kSmemLanes;
  const int* d_row = d_in + static_cast<size_t>(row) * L;
  const float* v_row = v_in + static_cast<size_t>(row) * L;

  int* sd = smem;
  int* sl = smem + C;
  int* D;
  int* LV;  // original lane during the sort, then the value's bits
  float* V2;
  if (in_smem) {
    D = sd;
    LV = sl;
    V2 = reinterpret_cast<float*>(smem + 2 * C);
  } else {
    int* base = scratch + static_cast<size_t>(row) * 3 * L2;
    D = base;
    LV = base + L2;
    V2 = reinterpret_cast<float*>(base + 2 * L2);
  }

  // 1-2a. load + pad each chunk, sort it in shared memory (the merge
  // direction of every stage comes from the GLOBAL lane index)
  for (int c0 = 0; c0 < L2; c0 += C) {
    for (int i = tid; i < C; i += nthreads) {
      const int g = c0 + i;
      sd[i] = g < L ? d_row[g] : sent;
      sl[i] = g;
    }
    __syncthreads();
    for (int kk = 2; kk <= C; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        bitonic_stage(sd, sl, C, c0, kk, j);
        __syncthreads();
      }
    }
    if (!in_smem) {
      for (int i = tid; i < C; i += nthreads) {
        D[c0 + i] = sd[i];
        LV[c0 + i] = sl[i];
      }
      __syncthreads();
    }
  }

  // 2b. merges wider than one chunk: cross-chunk distances in global
  // memory, the rest chunk by chunk in shared memory
  for (int kk = 2 * C; kk <= L2; kk <<= 1) {
    for (int j = kk >> 1; j >= C; j >>= 1) {
      bitonic_stage(D, LV, L2, 0, kk, j);
      __syncthreads();
    }
    for (int c0 = 0; c0 < L2; c0 += C) {
      for (int i = tid; i < C; i += nthreads) {
        sd[i] = D[c0 + i];
        sl[i] = LV[c0 + i];
      }
      __syncthreads();
      for (int j = C >> 1; j > 0; j >>= 1) {
        bitonic_stage(sd, sl, C, c0, kk, j);
        __syncthreads();
      }
      for (int i = tid; i < C; i += nthreads) {
        D[c0 + i] = sd[i];
        LV[c0 + i] = sl[i];
      }
      __syncthreads();
    }
  }

  // values follow their lanes (each thread rewrites only its own slots)
  for (int i = tid; i < L2; i += nthreads) {
    const int src = LV[i];
    LV[i] = __float_as_int(src < L ? v_row[src] : 0.0f);
  }
  __syncthreads();

  // 3. segmented sum: v[i] + (d[i] == d[i-off] ? v[i-off] : 0), ping-pong
  float* va = reinterpret_cast<float*>(LV);
  float* vb = V2;
  for (int s = 0, off = 1; s < log2_run; ++s, off <<= 1) {
    for (int i = tid; i < L2; i += nthreads) {
      vb[i] = i < off ? va[i]
                      : va[i] + (D[i] == D[i - off] ? va[i - off] : 0.0f);
    }
    __syncthreads();
    float* t = va;
    va = vb;
    vb = t;
  }

  // 4. run-end / sentinel / > 0 mask -> scores in vb, match count
  int cnt = 0;
  for (int i = tid; i < L2; i += nthreads) {
    const int dd = D[i];
    const bool run_end = i == L2 - 1 || D[i + 1] != dd;
    const bool ok = run_end && dd != sent && va[i] > 0.0f;
    vb[i] = ok ? va[i] : -INFINITY;
    cnt += ok ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if (lane == 0) red_c[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < nwarps; ++w) total += red_c[w];
    counts[row] = total;
  }

  float* ts_row = ts + static_cast<size_t>(row) * k;
  int* td_row = td + static_cast<size_t>(row) * k;

  // 5a. wide k on a shared-memory row: sort every lane by the key
  // (score desc, doc asc) and take the first k. Live docs hold one lane
  // each, so their keys are unique; -inf lanes come out as (-inf, sent).
  if (in_smem && k >= kSortMinK) {
    unsigned long long kreg[kSmemLanes / kMaxThreads];
#pragma unroll
    for (int j = 0; j < kSmemLanes / kMaxThreads; ++j) {
      const int i = tid + j * nthreads;
      if (i < L2) kreg[j] = score_key(vb[i], D[i]);
    }
    __syncthreads();  // the keys overwrite D and the value buffers
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
#pragma unroll
    for (int j = 0; j < kSmemLanes / kMaxThreads; ++j) {
      const int i = tid + j * nthreads;
      if (i < L2) keys[i] = kreg[j];
    }
    __syncthreads();
    for (int kk = 2; kk <= L2; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int p = tid; p < (L2 >> 1); p += nthreads) {
          const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          const bool desc = (i & kk) == 0;
          const unsigned long long a = keys[i];
          const unsigned long long b = keys[i + j];
          if ((a < b) == desc) {
            keys[i] = b;
            keys[i + j] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int r = tid; r < k; r += nthreads) {
      float s = -INFINITY;
      int dd = sent;
      if (r < L2) {
        const unsigned long long key = keys[r];
        s = key_score(key);
        if (s != -INFINITY) dd = static_cast<int>(~static_cast<uint32_t>(key));
      }
      ts_row[r] = s;
      td_row[r] = dd;
    }
    return;
  }

  // 5b. top-k: k rounds of a block-wide (max score, min doc) reduction over
  // the lanes ranked after the previous winner (each live doc holds one
  // lane, so (score, doc) pairs are unique)
  float prev_s = INFINITY;
  int prev_d = -1;
  for (int r = 0; r < k; ++r) {
    float bs = -INFINITY;
    int bd = INT32_MAX;
    for (int i = tid; i < L2; i += nthreads) {
      const float s = vb[i];
      const int dd = D[i];
      if (ranks_before(prev_s, prev_d, s, dd) && ranks_before(s, dd, bs, bd)) {
        bs = s;
        bd = dd;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, o);
      const int od = __shfl_down_sync(0xffffffffu, bd, o);
      if (ranks_before(os, od, bs, bd)) {
        bs = os;
        bd = od;
      }
    }
    if (lane == 0) {
      red_s[warp] = bs;
      red_d[warp] = bd;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nwarps; ++w) {
        if (ranks_before(red_s[w], red_d[w], bs, bd)) {
          bs = red_s[w];
          bd = red_d[w];
        }
      }
      best_s = bs;
      best_d = bd;
    }
    __syncthreads();
    bs = best_s;
    bd = best_d;
    if (bs == -INFINITY) {  // no live lane left: pad the row
      for (int r2 = r + tid; r2 < k; r2 += nthreads) {
        ts_row[r2] = -INFINITY;
        td_row[r2] = sent;
      }
      break;
    }
    if (tid == 0) {
      ts_row[r] = bs;
      td_row[r] = bd;
    }
    prev_s = bs;
    prev_d = bd;
  }
}

}  // namespace

extern "C" {

// Lanes a row may hold in shared memory; wider rows need `scratch`
// ([B, 3, L2] int32).
int strip_topk_smem_lanes() { return kSmemLanes; }

// d [B, L] int32, v [B, L] f32, sent: one int32 on the device (the dead doc
// slot n1-1); outputs ts [B, k] f32, td [B, k] int32, counts [B] int32.
// L2 is the next power of two >= L. Launches on `stream` and returns
// cudaGetLastError().
int strip_topk_launch(const void* d, const void* v, const void* sent, int B,
                      int L, int L2, int k, int log2_run, void* ts, void* td,
                      void* counts, void* scratch, void* stream) {
  if (B == 0) return 0;
  if (L2 > kSmemLanes && scratch == nullptr) return cudaErrorInvalidValue;
  const int C = L2 < kSmemLanes ? L2 : kSmemLanes;
  const size_t smem = static_cast<size_t>(L2 <= kSmemLanes ? 3 : 2) * C *
                      sizeof(int);
  int threads = L2 / 2;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  cudaError_t err = cudaFuncSetAttribute(
      strip_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  strip_topk_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(d), static_cast<const float*>(v),
      static_cast<const int*>(sent), L, L2, k, log2_run,
      static_cast<float*>(ts), static_cast<int*>(td),
      static_cast<int*>(counts), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
