// Exact top-k selection shared by the two-pass sweeps K1
// (fused_retrieval.cu) and K2 (quant_candidates.cu).
//
// Every candidate is keyed by (value, index) and compared with strict <, so
// the selection equals a stable sort's first k entries whatever order the
// blocks run in: among equal values the smaller gallery index wins.
//
//  * warp_offer: one warp offers 32 candidates, one per lane, to a running
//    top-k kept sorted in shared memory (the first pass, per split).
//  * merge_topk: one block takes the k smallest keys of a query's S*k
//    partial candidates in k rounds of a block-wide minimum (the second
//    pass).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr int KMAX = 128;
constexpr float BIG = 3.0e38f;  // sentinel value, with index N
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool key_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Offer lane's (v, n) to the running top-k tv/ti (k entries in shared
// memory, ascending by key). All 32 lanes of the warp call it together;
// `valid` is false for a lane with no candidate.
__device__ __forceinline__ void warp_offer(float* tv, int* ti, int k, float v,
                                           int n, bool valid) {
  const int lane = threadIdx.x & 31;
  unsigned m = __ballot_sync(FULL, valid && key_less(v, n, tv[k - 1], ti[k - 1]));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int ci = __shfl_sync(FULL, n, src);
    if (!key_less(cv, ci, tv[k - 1], ti[k - 1])) continue;
    int p = 0;  // insertion position: entries ordered before (cv, ci)
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      p += __popc(__ballot_sync(FULL, j < k && key_less(tv[j], ti[j], cv, ci)));
    }
    float nv[KMAX / 32];
    int ni[KMAX / 32];
#pragma unroll
    for (int u = 0; u < KMAX / 32; ++u) {
      const int j = lane + 32 * u;
      if (j < k && j > p) { nv[u] = tv[j - 1]; ni[u] = ti[j - 1]; }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < KMAX / 32; ++u) {
      const int j = lane + 32 * u;
      if (j < k && j > p) { tv[j] = nv[u]; ti[j] = ni[u]; }
      if (j == p) { tv[j] = cv; ti[j] = ci; }
    }
    __syncwarp();
  }
}

// The k smallest keys of the M candidates pv/pi, ascending, into vals/idx.
// Called by all THREADS threads of the block; (BIG, N) fills the slots
// when fewer than k candidates remain.
template <int THREADS>
__device__ void merge_topk(const float* pv, const int* pi, int M, int k, int N,
                           float* vals, int* idx) {
  __shared__ float wv[THREADS / 32];
  __shared__ int wi[THREADS / 32];
  __shared__ float prev_v;
  __shared__ int prev_i;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) { prev_v = -INFINITY; prev_i = INT32_MIN; }
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    const float lv = prev_v;
    const int li = prev_i;
    float bv = INFINITY;
    int bi = INT32_MAX;
    for (int e = tid; e < M; e += THREADS) {
      const float v = pv[e];
      const int i = pi[e];
      if (key_less(lv, li, v, i) && key_less(v, i, bv, bi)) { bv = v; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(FULL, bv, off);
      const int oi = __shfl_down_sync(FULL, bi, off);
      if (key_less(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { wv[warp] = bv; wi[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < THREADS / 32; ++w)
        if (key_less(wv[w], wi[w], bv, bi)) { bv = wv[w]; bi = wi[w]; }
      if (bi == INT32_MAX) { bv = BIG; bi = N; }  // only sentinels remain
      vals[j] = bv;
      idx[j] = bi;
      prev_v = bv;
      prev_i = bi;
    }
    __syncthreads();
  }
}

}  // namespace topk
