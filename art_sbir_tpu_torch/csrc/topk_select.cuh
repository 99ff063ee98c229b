// Exact top-k selection shared by the two-pass sweeps K1
// (fused_retrieval.cu, through k1_sweep.cuh) and K2 (quant_candidates.cu).
//
// Every candidate is keyed by (value, index) and compared with strict <, so
// the selection equals a stable sort's first k entries whatever order the
// blocks run in: among equal values the smaller gallery index wins.
//
//  * warp_offer: one warp offers 32 candidates, one per lane, to a running
//    top-k of up to CAP entries kept sorted in shared memory (the first
//    pass, per split). The insertion position takes two ballots: one over
//    the last entries of the runs of 32, then one over the entries of the
//    first run not wholly before the key. The shift moves only the entries
//    behind that position, one run of 32 at a time.
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

constexpr int CAP = 1024;       // the largest running top-k warp_offer keeps
constexpr float BIG = 3.0e38f;  // sentinel value, with index N
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool key_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Offer lane's (v, n) to the running top-k tv/ti (k <= CAP entries in
// shared memory, ascending by key). All 32 lanes of the warp call it
// together; `valid` is false for a lane with no candidate.
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
    // insertion position p = the number of entries ordered before (cv, ci).
    // The list is sorted, so the runs of 32 wholly before the key form a
    // prefix: lane u tests the last entry of run u. Then the lanes test the
    // entries of the first run that is not wholly before it. (The k-th entry
    // is not before the key, so that run exists.)
    const int last = min(32 * lane + 31, k - 1);
    const int run = __popc(__ballot_sync(
        FULL, 32 * lane < k && key_less(tv[last], ti[last], cv, ci)));
    const int j0 = 32 * run + lane;
    const int p = 32 * run + __popc(__ballot_sync(
        FULL, j0 < k && key_less(tv[j0], ti[j0], cv, ci)));
    // shift entries [p, k - 1) up by one, from the top run down. Within a
    // run every lane reads before any lane writes; the entry a run's first
    // lane reads lies in the run below, which is written later.
    for (int base = (k - 1) & ~31; base + 31 > p; base -= 32) {
      const int j = base + lane;
      const bool move = j > p && j < k;
      float pv = 0.0f;
      int pi = 0;
      if (move) { pv = tv[j - 1]; pi = ti[j - 1]; }
      __syncwarp();
      if (move) { tv[j] = pv; ti[j] = pi; }
      __syncwarp();
    }
    if (lane == 0) { tv[p] = cv; ti[p] = ci; }
    __syncwarp();
  }
}

// The k smallest keys of S runs, each sorted ascending by key and `len`
// long (run s at pv + s * len, pi + s * len), ascending, into vals/idx.
// Called by all THREADS threads of the block; S <= HEADS * THREADS. Thread t
// owns runs t, t + THREADS, ... and keeps each one's head and the entry
// after it in registers, so a run that wins twice in a row does not wait on
// memory. (BIG, N) fills the slots when fewer than k candidates remain.
template <int THREADS, int HEADS>
__device__ void merge_runs(const float* pv, const int* pi, int S, int len, int k,
                           int N, float* vals, int* idx) {
  __shared__ float wv[2][THREADS / 32];
  __shared__ int wi[2][THREADS / 32];
  __shared__ int ws[2][THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float hv[HEADS], nv[HEADS];
  int hi[HEADS], ni[HEADS], at[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    const int s = tid + h * THREADS;
    const size_t o = static_cast<size_t>(s) * len;
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
          const size_t o = static_cast<size_t>(bs) * len + at[h] + 1;
          nv[h] = pv[o];
          ni[h] = pi[o];
        }
      }
    }
  }
}

}  // namespace topk
