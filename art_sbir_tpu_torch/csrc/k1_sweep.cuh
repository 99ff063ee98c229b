// K1's first pass, shared by K1 (fused_retrieval.cu) and its ablation probe
// P1 (fused_ablation.cu), so that each ablation level strips K1's own code
// and nothing else.
//
// sweep_partial<T, LEVEL>, grid (ceil(Q/32), S). Split s owns a contiguous
// range of 128-row gallery tiles. The block stages 32 queries and 128
// gallery rows in 32-deep chunks of D in shared memory, widened to float32
// (16-byte loads: 4 float32 or 8 bf16 values, neighbouring threads on
// neighbouring addresses); each thread owns 4 queries x 8 rows and
// accumulates every q.g with float32 FMAs in one fixed order over D (d = 0,
// 1, ..., D-1), so a (q, g) pair's value does not depend on the tiling and
// duplicated gallery rows tie exactly. A product of two bf16 values is exact
// in float32, so the bf16 form differs from a float32 sum of the widened
// values only in the order of the sum. No TF32, no tensor cores.
//
// LEVEL 3 is K1. LEVELs 0-2 are the probe's stripped forms (the levels of
// `_ablate_kernel`, scripts/probe_fused_overhead.py:36):
//   0  the cross term only: one float32 sum per query and tile, to part_m
//      (n_tiles, Q), so the products cannot be optimised away
//   1  + the euclidean distances and the rank hits against d2pos, to part_r
//   2  + the count of distances <= 1e-6, added to part_r, and each lane's
//      running minimum of those distances (over its columns of the tile),
//      folded into the count times 0 as the TPU level folds its `g1`
//   3  + the running top-k per warp (part_v, part_i); rank hits only when
//      with_ranks, against the positive's distance
// The epilogue applies the distance in the TPU kernel's op order
// (max(qq' + gg' - 2*cross, 0), or 1 - cross / max(qq*gg, 1e-8)) and counts
// rank hits as `_hit` does: strictly closer, or an exact tie at a smaller
// index, never the positive's own column.

#pragma once

#include <cuda_bf16.h>

#include "topk_select.cuh"

namespace k1 {

using topk::BIG;
using topk::FULL;

constexpr int TQ = 32;        // queries per block (must match ops/retrieval_fused.py)
constexpr int TN = 128;       // gallery rows per tile (must match ops/retrieval_fused.py)
constexpr int DK = 32;        // depth of one staged chunk of D
constexpr int THREADS = 128;  // 8 query groups x 16 row groups
constexpr int QPT = 4;        // queries per thread
constexpr int CPT = 8;        // gallery rows per thread
constexpr int LD = DK + 1;    // padded shared row: conflict-free column reads

// Elements of T in one 16-byte load.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// One 16-byte load of Vec<T>::N values, widened to float32 (exactly).
__device__ __forceinline__ void load_widen(const float* src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load_widen(const __nv_bfloat16* src, float* dst) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: the lower half comes first
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One column's distance from its cross term, in the TPU kernel's op order
// (explicit round-to-nearest intrinsics: no contraction into FMAs).
__device__ __forceinline__ float column_distance(int metric, float qv, float gv,
                                                 float cross) {
  if (metric == 0) {
    const float d = __fsub_rn(__fadd_rn(qv, gv), __fmul_rn(2.0f, cross));
    return d < 0.0f ? 0.0f : d;
  }
  float den = __fmul_rn(qv, gv);
  den = den < 1e-8f ? 1e-8f : den;
  return __fsub_rn(1.0f, __fdiv_rn(cross, den));
}

// Stage rows [row0, row0 + rows) of a (limit, D) matrix, depth [d0, d0 + DK),
// as float32 into dst (rows x LD). Rows past `limit` and depth past D are
// zero: an FMA of zeros leaves the running sum unchanged, so the order over
// D is kept. D must be a multiple of Vec<T>::N.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0, int rows,
                                      int limit, int D, int d0, float* __restrict__ dst) {
  constexpr int V = Vec<T>::N;
  for (int e = threadIdx.x; e < rows * (DK / V); e += THREADS) {
    const int r = e / (DK / V), c = (e % (DK / V)) * V;
    const int row = row0 + r, dd = d0 + c;
    float v[V];
    if (row < limit && dd < D) {
      load_widen(src + static_cast<size_t>(row) * D + dd, v);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.0f;
    }
    float* out = dst + r * LD + c;
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = v[i];
  }
}

// acc[i][j] = q[q0 + ty*QPT + i] . g[n0 + tx + 16*j], one FMA chain over D.
template <typename T>
__device__ __forceinline__ void cross_tile(const T* __restrict__ q, const T* __restrict__ g,
                                           int q0, int Q, int n0, int N, int D,
                                           float* __restrict__ qs, float* __restrict__ gs,
                                           float (&acc)[QPT][CPT]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += DK) {
    stage(q, q0, TQ, Q, D, d0, qs);
    stage(g, n0, TN, N, D, d0, gs);
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < DK; ++dd) {
      float a[QPT], b[CPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i) a[i] = qs[(ty * QPT + i) * LD + dd];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = gs[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Dynamic shared memory of sweep_partial for a top-k of k entries (0 below
// LEVEL 3).
inline size_t sweep_smem(int k) {
  return sizeof(float) * (TQ * LD + TN * LD + TQ * TN + TQ * k) +
         sizeof(int) * (TQ * k + TQ);
}

template <typename T, int LEVEL>
__global__ void __launch_bounds__(THREADS)
sweep_partial(const T* __restrict__ q, const float* __restrict__ qq,
              const int* __restrict__ pos, const T* __restrict__ g,
              const float* __restrict__ gg, const float* __restrict__ d2pos,
              int Q, int N, int D, int k, int metric, int with_ranks,
              float* __restrict__ part_v, int* __restrict__ part_i,
              int* __restrict__ part_r, float* __restrict__ part_m) {
  extern __shared__ float smem[];
  float* qs = smem;                  // TQ x LD   query chunk
  float* gs = qs + TQ * LD;          // TN x LD   gallery chunk
  float* ds = gs + TN * LD;          // TQ x TN   distances of the tile
  float* tv = ds + TQ * TN;          // TQ x k    running top-k values
  int* ti = reinterpret_cast<int*>(tv + TQ * k);  // TQ x k indices
  int* rs = ti + TQ * k;             // TQ        rank hits

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int S = gridDim.y, s = blockIdx.y;
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = static_cast<int>(static_cast<long long>(n_tiles) * s / S);
  const int t_end = static_cast<int>(static_cast<long long>(n_tiles) * (s + 1) / S);
  const bool ranks = LEVEL < 3 || with_ranks;

  if (LEVEL == 3)
    for (int e = tid; e < TQ * k; e += THREADS) { tv[e] = BIG; ti[e] = N; }
  for (int e = tid; e < TQ; e += THREADS) rs[e] = 0;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * TN;
    float acc[QPT][CPT];
    cross_tile(q, g, q0, Q, n0, N, D, qs, gs, acc);

    if constexpr (LEVEL == 0) {
      // one sum per query row and tile, over this thread's 8 columns and
      // then the 16 threads of the row group (half a warp)
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) sum += acc[i][j];
        for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
        const int qi = q0 + ty * QPT + i;
        if (tx == 0 && qi < Q) part_m[static_cast<size_t>(t) * Q + qi] = sum;
      }
    } else {
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qr = ty * QPT + i, qi = q0 + qr;
        const float qv = qi < Q ? qq[qi] : 0.0f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + 16 * j, n = n0 + c;
          const float gv = n < N ? gg[n] : 0.0f;
          ds[qr * TN + c] = column_distance(metric, qv, gv, acc[i][j]);
        }
      }
      __syncthreads();

      // rank hits (and the running top-k): warp w owns queries [8w, 8w + 8)
      for (int r = 0; r < TQ / 4; ++r) {
        const int qr = warp * (TQ / 4) + r, qi = q0 + qr;
        if (qi >= Q) break;  // warp-uniform
        const float d2p = ranks ? d2pos[qi] : 0.0f;
        const int pq = pos[qi];
        int hits = 0;
        float g1 = BIG;  // LEVEL 2: the lane's running minimum of the near columns
        for (int c0 = 0; c0 < TN; c0 += 32) {
          const int c = c0 + lane, n = n0 + c;
          const bool valid = n < N;
          const float v = ds[qr * TN + c];
          if (ranks) {
            const bool hit = valid && v < BIG && n != pq &&
                             (v < d2p || (v == d2p && n < pq));
            hits += __popc(__ballot_sync(FULL, hit));
          }
          if constexpr (LEVEL == 2) {
            const bool near = valid && v <= 1e-6f;
            hits += __popc(__ballot_sync(FULL, near));
            const float cand = near ? v : BIG;
            g1 = cand < g1 ? cand : g1;
          }
          if constexpr (LEVEL == 3) topk::warp_offer(tv + qr * k, ti + qr * k, k, v, n, valid);
        }
        // the TPU level folds its running minimum into the count times 0, so
        // that the bookkeeping is kept; a float product is not folded away
        // without fast math, and NaN or 0 converts to 0
        if constexpr (LEVEL == 2) hits += __float2int_rz(g1 * 0.0f);
        if (lane == 0) rs[qr] += hits;
      }
      __syncthreads();
    }
  }

  if constexpr (LEVEL == 3) {
    for (int e = tid; e < TQ * k; e += THREADS) {
      const int qr = e / k, j = e % k, qi = q0 + qr;
      if (qi < Q) {
        const size_t o = (static_cast<size_t>(qi) * S + s) * k + j;
        part_v[o] = tv[e];
        part_i[o] = ti[e];
      }
    }
  }
  if constexpr (LEVEL >= 1)
    for (int qr = tid; qr < TQ; qr += THREADS)
      if (q0 + qr < Q) part_r[static_cast<size_t>(q0 + qr) * S + s] = rs[qr];
}

}  // namespace k1
