// K2: streaming int8 candidate scan over a resident int8 gallery.
//
// Replaces the TPU kernel `_quant_kernel` in art_sbir_tpu/ops/retrieval_pallas.py
// (launched by `_quant_jit`, pl.pallas_call at retrieval_pallas.py:704),
// behind `quant_candidates_fused`. For each query row it returns the r
// gallery rows with the smallest approximate score, r <= 128, ascending by
// (score, index), and a certificate that is 1 on every row.
//
// The score is `_quant_core`'s (art_sbir_tpu/ops/quant.py:95-104), in its
// float32 op order:
//   cross = q8 . g8                      (int8 x int8, exact int32 sum)
//   dot   = float(cross) * (s_q * g_scale)
//   score = g_sq - 2 * dot   (euclidean)   or   -dot   (cosine)
// with round-to-nearest intrinsics and no contraction into FMAs, so the
// candidates and their scores are bit-identical to the plain PyTorch
// version (ops/quant_fused.py::quant_candidates_reference) on the card.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 1,979 TOPS int8 dense):
//  * At the serving shape, Q = 32 queries, N = 1,000,000 rows, D = 1024,
//    the gallery read is N*D int8 bytes plus 8N bytes of scale and g_sq,
//    about 1.056 GB: 0.315 ms. The operations are 2*Q*N*D = 67.1 G, 0.034 ms
//    at the int8 tensor-core rate. So bytes set the bound.
//  * Every block holds all (up to 32) queries of its tile, so the gallery
//    streams from device memory once per call for Q <= 32.
//  * This version is the simple, exact one: the cross term runs on __dp4a
//    (four int8 products a lane per instruction, outside the tensor cores).
//    wgmma / IMMA tiles and TMA are later work.
//
// Design. The TPU kernel's per-lane top-`depth` file, 128-lane segment fold
// and certificate were shaped by the TPU's vector unit and its in-order
// grid; none is carried over. Two passes instead, as in K1:
//
//  1. k2_partial, grid (ceil(Q/32), S). Split s owns a contiguous range of
//     128-row gallery tiles. The block stages 32 query rows and 128 gallery
//     rows in 64-byte chunks of D in shared memory (16-byte loads,
//     neighbouring threads on neighbouring addresses); each thread owns 4
//     queries x 8 rows and sums their int8 products with __dp4a into int32,
//     exact in any order. The epilogue applies the score above, and each
//     warp keeps, per query, a sorted running top-r in shared memory keyed
//     by (score, index) with strict < (topk::warp_offer), so among equal
//     scores, such as duplicated gallery rows, the smaller index wins. The
//     block writes a partial (Q, S, r) top-r.
//  2. k2_merge, one block per query: r rounds of a block-wide (score, index)
//     minimum over the S*r candidates (topk::merge_topk).
//
// The result is exact by construction, so `exact` is 1 on every row.
// Sentinel: score 3e38 with index N.

#include "topk_select.cuh"

namespace {

using topk::BIG;
using topk::KMAX;

constexpr int TQ = 32;         // queries per block (must match ops/quant_fused.py)
constexpr int TN = 128;        // gallery rows per tile (must match ops/quant_fused.py)
constexpr int DKB = 64;        // bytes of D in one staged chunk
constexpr int DKW = DKB / 4;   // the same in 32-bit words of 4 int8
constexpr int LDW = DKW + 1;   // padded shared row: conflict-free column reads
constexpr int VEC = 16;        // bytes per staging load
constexpr int THREADS = 128;   // 8 query groups x 16 row groups
constexpr int QPT = 4;         // queries per thread
constexpr int CPT = 8;         // gallery rows per thread
constexpr int MERGE_THREADS = 256;

// `_quant_core`'s approximate score from the exact int32 cross term.
__device__ __forceinline__ float approx_score(int metric, float sq, float gsc,
                                              float gsq, int cross) {
  const float dot = __fmul_rn(__int2float_rn(cross), __fmul_rn(sq, gsc));
  return metric == 0 ? __fsub_rn(gsq, __fmul_rn(2.0f, dot)) : -dot;
}

// Stage rows [row0, row0 + rows) of a (limit, D) int8 matrix, bytes
// [d0, d0 + DKB), as 32-bit words into dst (rows x LDW). Rows past `limit`
// and bytes past D are zero: a zero product leaves the int32 sum unchanged.
__device__ __forceinline__ void stage(const int8_t* __restrict__ src, int row0,
                                      int rows, int limit, int D, int d0,
                                      int* __restrict__ dst) {
  for (int e = threadIdx.x; e < rows * (DKB / VEC); e += THREADS) {
    const int r = e / (DKB / VEC), c = (e % (DKB / VEC)) * VEC;
    const int row = row0 + r, dd = d0 + c;
    int4 v = make_int4(0, 0, 0, 0);
    if (row < limit && dd < D)
      v = __ldg(reinterpret_cast<const int4*>(src + static_cast<size_t>(row) * D + dd));
    int* w = dst + r * LDW + c / 4;
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
}

__global__ void __launch_bounds__(THREADS)
k2_partial(const int8_t* __restrict__ q8, const float* __restrict__ s_q,
           const int8_t* __restrict__ g8, const float* __restrict__ g_scale,
           const float* __restrict__ g_sq, int Q, int N, int D, int r,
           int metric, float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ int smem[];
  int* qs = smem;                                        // TQ x LDW  query chunk
  int* gs = qs + TQ * LDW;                               // TN x LDW  gallery chunk
  float* ds = reinterpret_cast<float*>(gs + TN * LDW);  // TQ x TN   scores of the tile
  float* tv = ds + TQ * TN;                              // TQ x r    running top-r scores
  int* ti = reinterpret_cast<int*>(tv + TQ * r);         // TQ x r    indices

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int S = gridDim.y, s = blockIdx.y;
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = static_cast<int>(static_cast<long long>(n_tiles) * s / S);
  const int t_end = static_cast<int>(static_cast<long long>(n_tiles) * (s + 1) / S);

  for (int e = tid; e < TQ * r; e += THREADS) { tv[e] = BIG; ti[e] = N; }
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * TN;
    int acc[QPT][CPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0;

    for (int d0 = 0; d0 < D; d0 += DKB) {
      stage(q8, q0, TQ, Q, D, d0, qs);
      stage(g8, n0, TN, N, D, d0, gs);
      __syncthreads();
#pragma unroll
      for (int w = 0; w < DKW; ++w) {
        int a[QPT], b[CPT];
#pragma unroll
        for (int i = 0; i < QPT; ++i) a[i] = qs[(ty * QPT + i) * LDW + w];
#pragma unroll
        for (int j = 0; j < CPT; ++j) b[j] = gs[(tx + 16 * j) * LDW + w];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int qr = ty * QPT + i, qi = q0 + qr;
      const float sq = qi < Q ? s_q[qi] : 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j, n = n0 + c;
        ds[qr * TN + c] = n < N ? approx_score(metric, sq, g_scale[n], g_sq[n], acc[i][j])
                                : BIG;
      }
    }
    __syncthreads();

    // running top-r: warp w owns queries [8w, 8w + 8)
    for (int rr = 0; rr < TQ / 4; ++rr) {
      const int qr = warp * (TQ / 4) + rr;
      if (q0 + qr >= Q) break;  // warp-uniform
      for (int c0 = 0; c0 < TN; c0 += 32) {
        const int c = c0 + lane, n = n0 + c;
        topk::warp_offer(tv + qr * r, ti + qr * r, r, ds[qr * TN + c], n, n < N);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < TQ * r; e += THREADS) {
    const int qr = e / r, j = e % r, qi = q0 + qr;
    if (qi < Q) {
      const size_t o = (static_cast<size_t>(qi) * S + s) * r + j;
      part_v[o] = tv[e];
      part_i[o] = ti[e];
    }
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
k2_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
         int S, int r, int N, float* __restrict__ vals, int* __restrict__ idx,
         int* __restrict__ exact) {
  const int qi = blockIdx.x;
  if (threadIdx.x == 0) exact[qi] = 1;
  const size_t M = static_cast<size_t>(S) * r;
  topk::merge_topk<MERGE_THREADS>(part_v + qi * M, part_i + qi * M,
                                  static_cast<int>(M), r, N,
                                  vals + static_cast<size_t>(qi) * r,
                                  idx + static_cast<size_t>(qi) * r);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Shapes: q8 (Q, D) int8, s_q (Q,),
// g8 (N, D) int8, g_scale (N,), g_sq (N,), float32 unless noted,
// contiguous, 16-byte aligned, D % 16 == 0, 1 <= r <= min(128, N).
// Scratch: part_v (Q, S, r), part_i (Q, S, r). Outputs: vals (Q, r),
// idx (Q, r) int32, exact (Q,) int32. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int k2_quant_candidates(
    const int8_t* q8, const float* s_q, const int8_t* g8, const float* g_scale,
    const float* g_sq, int Q, int N, int D, int r, int metric, int splits,
    float* part_v, int* part_i, float* vals, int* idx, int* exact,
    void* stream) {
  if (Q < 1 || N < 1 || D < VEC || D % VEC || r < 1 || r > KMAX || r > N ||
      splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int) * (TQ * LDW + TN * LDW) +
                      sizeof(float) * (TQ * TN + TQ * r) + sizeof(int) * TQ * r;
  cudaError_t err = cudaFuncSetAttribute(
      k2_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + TQ - 1) / TQ, splits);
  k2_partial<<<grid, THREADS, smem, st>>>(q8, s_q, g8, g_scale, g_sq, Q, N, D, r,
                                          metric, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2_merge<<<Q, MERGE_THREADS, 0, st>>>(part_v, part_i, splits, r, N, vals, idx,
                                        exact);
  return static_cast<int>(cudaGetLastError());
}
