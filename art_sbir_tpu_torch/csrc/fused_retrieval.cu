// K1: fused distance + rank-of-positive + top-k over a resident gallery.
//
// Replaces the TPU kernel `_kernel` in art_sbir_tpu/ops/retrieval_pallas.py
// (launched by `_sweep`, pl.pallas_call at retrieval_pallas.py:365), in its
// float32 precision='highest' single-device form.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s float32 FMA):
//  * At serving shapes (Q <= 32 queries per call) it is bound by the gallery
//    read, N*D*4 bytes: 409.6 MB at N = 100,000 and D = 1024, about 0.122 ms.
//    Every block holds all (up to 32) queries of its tile, so the gallery
//    streams from device memory once per call; the 50 MB L2 does not hold it.
//  * At Q >= ~512 (offline evaluation) it is bound by float32 FMA:
//    2*Q*N*D operations.
//  * This version is the simple, exact one. Speed with wgmma, TMA and
//    3xTF32 or bf16 operands is later work.
//
// Design. The TPU kernel's per-lane top-4 register file, 128-lane segment
// fold and sequential grid carry were shaped by the TPU's vector unit and
// its in-order grid; none of them is carried over. Two passes instead
// (after k1_positive, when ranks are asked for):
//
//  0. k1_positive, one thread per query: the positive's own distance with
//     the same FMA chain as its column in the sweep. (The TPU kernel takes
//     it from a separate elementwise sum, so a duplicate of the positive
//     can miss the tie by an ulp.)
//  1. k1_partial, grid (ceil(Q/32), S). Split s owns a contiguous range of
//     128-row gallery tiles. The block stages 32 queries and 128 gallery
//     rows in 32-deep chunks of D in shared memory; each thread owns 4
//     queries x 8 rows and accumulates every q.g with float32 FMAs in one
//     fixed order over D (d = 0, 1, ..., D-1), so a (q, g) pair's value does
//     not depend on the tiling and duplicated gallery rows tie exactly. No
//     TF32, no tensor cores. The epilogue applies the distance in the TPU
//     kernel's op order (max(qq' + gg' - 2*cross, 0), or
//     1 - cross / max(qq*gg, 1e-8)), counts rank hits as `_hit` does
//     against the positive's distance, and each warp keeps, per query, a
//     sorted running top-k in shared memory, ordered by (value, index) with
//     strict < (topk::warp_offer). The block writes a partial (Q, S, k)
//     top-k and (Q, S) rank counts.
//  2. k1_merge, one block per query: k rounds of a block-wide (value, index)
//     minimum over the S*k candidates (topk::merge_topk), plus the sum of
//     the rank partials. Both selections live in topk_select.cuh, shared
//     with K2.
//
// The result is exact by construction, so `exact` is 1 on every row.
// Sentinel: value 3e38 with index N, as on the TPU.

#include "topk_select.cuh"

namespace {

using topk::BIG;
using topk::FULL;
using topk::KMAX;

constexpr int TQ = 32;        // queries per block (must match ops/retrieval_fused.py)
constexpr int TN = 128;       // gallery rows per tile (must match ops/retrieval_fused.py)
constexpr int DK = 32;        // depth of one staged chunk of D
constexpr int THREADS = 128;  // 8 query groups x 16 row groups
constexpr int QPT = 4;        // queries per thread
constexpr int CPT = 8;        // gallery rows per thread
constexpr int LD = DK + 1;    // padded shared row: conflict-free column reads
constexpr int MERGE_THREADS = 256;

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

// The positive's own distance, with the same FMA chain over D as the sweep
// gives its column, so a duplicate of the positive ties with it exactly.
__global__ void k1_positive(const float* __restrict__ q, const float* __restrict__ qq,
                            const int* __restrict__ pos, const float* __restrict__ g,
                            const float* __restrict__ gg, int Q, int N, int D,
                            int metric, float* __restrict__ d2pos) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  const int p = min(max(pos[qi], 0), N - 1);
  const float* a = q + static_cast<size_t>(qi) * D;
  const float* b = g + static_cast<size_t>(p) * D;
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  d2pos[qi] = column_distance(metric, qq[qi], gg[p], acc);
}

__global__ void __launch_bounds__(THREADS)
k1_partial(const float* __restrict__ q, const float* __restrict__ qq,
           const int* __restrict__ pos, const float* __restrict__ g,
           const float* __restrict__ gg, const float* __restrict__ d2pos,
           int Q, int N, int D, int k, int metric, int with_ranks,
           float* __restrict__ part_v, int* __restrict__ part_i,
           int* __restrict__ part_r) {
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

  for (int e = tid; e < TQ * k; e += THREADS) { tv[e] = BIG; ti[e] = N; }
  for (int e = tid; e < TQ; e += THREADS) rs[e] = 0;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * TN;
    float acc[QPT][CPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      // stage: float4 loads, neighbouring threads on neighbouring addresses;
      // rows past Q or N and depth past D are zero (an FMA of zeros leaves
      // the running sum unchanged, so the order over D is kept)
      for (int e = tid; e < TQ * (DK / 4); e += THREADS) {
        const int r = e / (DK / 4), c = (e % (DK / 4)) * 4;
        const int qi = q0 + r, dd = d0 + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qi < Q && dd < D)
          v = __ldg(reinterpret_cast<const float4*>(q + static_cast<size_t>(qi) * D + dd));
        float* dst = qs + r * LD + c;
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
      for (int e = tid; e < TN * (DK / 4); e += THREADS) {
        const int r = e / (DK / 4), c = (e % (DK / 4)) * 4;
        const int n = n0 + r, dd = d0 + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < N && dd < D)
          v = __ldg(reinterpret_cast<const float4*>(g + static_cast<size_t>(n) * D + dd));
        float* dst = gs + r * LD + c;
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
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

    // rank hits and running top-k: warp w owns queries [8w, 8w + 8)
    for (int r = 0; r < TQ / 4; ++r) {
      const int qr = warp * (TQ / 4) + r, qi = q0 + qr;
      if (qi >= Q) break;  // warp-uniform
      const int base = qr * k;
      const float d2p = with_ranks ? d2pos[qi] : 0.0f;
      const int pq = pos[qi];
      int hits = 0;
      for (int c0 = 0; c0 < TN; c0 += 32) {
        const int c = c0 + lane, n = n0 + c;
        const bool valid = n < N;
        const float v = ds[qr * TN + c];
        if (with_ranks) {
          // strictly closer, or an exact tie at a smaller index; never the
          // positive's own column
          const bool hit = valid && v < BIG && n != pq &&
                           (v < d2p || (v == d2p && n < pq));
          hits += __popc(__ballot_sync(FULL, hit));
        }
        topk::warp_offer(tv + base, ti + base, k, v, n, valid);
      }
      if (lane == 0) rs[qr] += hits;
    }
    __syncthreads();
  }

  for (int e = tid; e < TQ * k; e += THREADS) {
    const int qr = e / k, j = e % k, qi = q0 + qr;
    if (qi < Q) {
      const size_t o = (static_cast<size_t>(qi) * S + s) * k + j;
      part_v[o] = tv[e];
      part_i[o] = ti[e];
    }
  }
  for (int qr = tid; qr < TQ; qr += THREADS)
    if (q0 + qr < Q) part_r[static_cast<size_t>(q0 + qr) * S + s] = rs[qr];
}

__global__ void __launch_bounds__(MERGE_THREADS)
k1_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
         const int* __restrict__ part_r, int S, int k, int N,
         int* __restrict__ ranks, float* __restrict__ vals,
         int* __restrict__ idx, int* __restrict__ exact) {
  __shared__ int wr[MERGE_THREADS / 32];

  const int qi = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  int r = 0;
  for (int e = tid; e < S; e += MERGE_THREADS) r += part_r[static_cast<size_t>(qi) * S + e];
  for (int off = 16; off > 0; off >>= 1) r += __shfl_down_sync(FULL, r, off);
  if (lane == 0) wr[warp] = r;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < MERGE_THREADS / 32; ++w) total += wr[w];
    ranks[qi] = total;
    exact[qi] = 1;
  }
  const size_t M = static_cast<size_t>(S) * k;
  topk::merge_topk<MERGE_THREADS>(part_v + qi * M, part_i + qi * M,
                                  static_cast<int>(M), k, N,
                                  vals + static_cast<size_t>(qi) * k,
                                  idx + static_cast<size_t>(qi) * k);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Shapes: q (Q, D), qq (Q,),
// pos (Q,) int32, g (N, D), gg (N,), all float32 unless noted, contiguous,
// 16-byte aligned, D % 4 == 0, 1 <= k <= 128. Scratch: d2pos (Q,),
// part_v (Q, S, k), part_i (Q, S, k), part_r (Q, S). Outputs: ranks (Q,),
// vals (Q, k), idx (Q, k), exact (Q,). Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int k1_fused_retrieval(
    const float* q, const float* qq, const int* pos, const float* g,
    const float* gg, int Q, int N, int D, int k, int metric, int with_ranks,
    int splits, float* d2pos, float* part_v, int* part_i, int* part_r,
    int* ranks, float* vals, int* idx, int* exact, void* stream) {
  if (Q < 1 || N < 1 || D < 4 || D % 4 || k < 1 || k > KMAX || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (TQ * LD + TN * LD + TQ * TN + TQ * k) +
                      sizeof(int) * (TQ * k + TQ);
  cudaError_t err = cudaFuncSetAttribute(
      k1_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (with_ranks) {
    k1_positive<<<(Q + 127) / 128, 128, 0, st>>>(q, qq, pos, g, gg, Q, N, D,
                                                 metric, d2pos);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Q + TQ - 1) / TQ, splits);
  k1_partial<<<grid, THREADS, smem, st>>>(q, qq, pos, g, gg, d2pos, Q, N, D, k,
                                          metric, with_ranks, part_v, part_i, part_r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_merge<<<Q, MERGE_THREADS, 0, st>>>(part_v, part_i, part_r, splits, k, N,
                                        ranks, vals, idx, exact);
  return static_cast<int>(cudaGetLastError());
}
