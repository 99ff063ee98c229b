// Exact top-k selection shared by the two-pass sweeps K1
// (fused_retrieval.cu, through k1_sweep.cuh) and K2 (quant_candidates.cu).
//
// Every candidate is keyed by (value, index) and compared with strict <, so
// the selection equals a stable sort's first k entries whatever order the
// blocks run in: among equal values the smaller gallery index wins.
//
//  * warp_sort: one warp sorts 32 * U keys held in its registers (a
//    bitonic network over shuffles), the first step of both sweeps'
//    buffer flushes.
//  * merge_runs: one block takes the k smallest keys of a query's S sorted
//    partial top-k runs by a tournament: k rounds, each a block-wide minimum
//    over the S run heads, after which the winning run's owner advances it
//    (the second pass). A round costs O(S / THREADS) compares and one
//    barrier, whatever k is.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr float BIG = 3.0e38f;  // sentinel value, with index N
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool key_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// One warp sorts 32 * U keys held in registers ascending (bitonic): key e
// is (v[e / 32], x[e / 32]) of lane e % 32.
template <int U>
__device__ __forceinline__ void warp_sort(float (&v)[U], int (&x)[U]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32 * U; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool up = (((u << 5) | lane) & k) == 0;
        if (j >= 32) {  // partner u ^ (j / 32) in the same lane
          const int w = u ^ (j >> 5);
          if (w > u && key_less(v[w], x[w], v[u], x[u]) == up) {
            const float tv = v[u]; v[u] = v[w]; v[w] = tv;
            const int tx = x[u]; x[u] = x[w]; x[w] = tx;
          }
        } else {  // partner lane ^ j; the lower of an ascending pair keeps the min
          const float ov = __shfl_xor_sync(FULL, v[u], j);
          const int ox = __shfl_xor_sync(FULL, x[u], j);
          if (key_less(ov, ox, v[u], x[u]) == (up == ((lane & j) == 0))) {
            v[u] = ov;
            x[u] = ox;
          }
        }
      }
}

// The k smallest keys of S runs, each sorted ascending by key and `len`
// long (run s at pv + s * stride, pi + s * stride), ascending, into
// vals/idx.
// Called by all THREADS threads of the block; S <= HEADS * THREADS. Thread t
// owns runs t, t + THREADS, ... and keeps each one's head and the entry
// after it in registers, so a run that wins twice in a row does not wait on
// memory. (BIG, N) fills the slots when fewer than k candidates remain.
template <int THREADS, int HEADS>
__device__ void merge_runs(const float* pv, const int* pi, int S, size_t stride, int len,
                           int k, int N, float* vals, int* idx) {
  __shared__ float wv[2][THREADS / 32];
  __shared__ int wi[2][THREADS / 32];
  __shared__ int ws[2][THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float hv[HEADS], nv[HEADS];
  int hi[HEADS], ni[HEADS], at[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    const int s = tid + h * THREADS;
    const size_t o = static_cast<size_t>(s) * stride;
    at[h] = 0;
    hv[h] = nv[h] = INFINITY;
    hi[h] = ni[h] = INT32_MAX;
    if (s < S) {
      hv[h] = pv[o];
      hi[h] = pi[o];
      if (len > 1) { nv[h] = pv[o + 1]; ni[h] = pi[o + 1]; }
    }
  }
  for (int j = 0; j < k; ++j) {
    float bv = INFINITY;
    int bi = INT32_MAX, bs = -1;
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
      if (key_less(hv[h], hi[h], bv, bi)) { bv = hv[h]; bi = hi[h]; bs = tid + h * THREADS; }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const int os = __shfl_xor_sync(FULL, bs, off);
      if (key_less(ov, oi, bv, bi)) { bv = ov; bi = oi; bs = os; }
    }
    const int buf = j & 1;  // two buffers: round j + 1 writes while j is read
    if (lane == 0) { wv[buf][warp] = bv; wi[buf][warp] = bi; ws[buf][warp] = bs; }
    __syncthreads();
    bv = wv[buf][0];
    bi = wi[buf][0];
    bs = ws[buf][0];
    for (int w = 1; w < THREADS / 32; ++w)
      if (key_less(wv[buf][w], wi[buf][w], bv, bi)) {
        bv = wv[buf][w]; bi = wi[buf][w]; bs = ws[buf][w];
      }
    if (tid == 0) {
      const bool none = bi == INT32_MAX;  // every run is spent
      vals[j] = none ? BIG : bv;
      idx[j] = none ? N : bi;
    }
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      if (tid + h * THREADS == bs) {
        hv[h] = nv[h];
        hi[h] = ni[h];
        ++at[h];
        nv[h] = INFINITY;
        ni[h] = INT32_MAX;
        if (at[h] + 1 < len) {
          const size_t o = static_cast<size_t>(bs) * stride + at[h] + 1;
          nv[h] = pv[o];
          ni[h] = pi[o];
        }
      }
    }
  }
}

}  // namespace topk
