// K2: streaming int8 candidate scan over a resident int8 gallery.
//
// Replaces the TPU kernel `_quant_kernel` in art_sbir_tpu/ops/retrieval_pallas.py
// (launched by `_quant_jit`, pl.pallas_call at retrieval_pallas.py:704),
// behind `quant_candidates_fused`. For each query row it returns the r
// gallery rows with the smallest approximate score, 1 <= r <= 1024 (the JAX
// default's depth * 128), ascending by (score, index), and a certificate
// that is 1 on every row.
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
//  * Every block holds all queries of its tile (32, or 16 for r > 512), so
//    the gallery streams from device memory once per call for Q <= 32
//    (twice for r > 512).
//  * This version is the simple, exact one: the cross term runs on __dp4a
//    (four int8 products a lane per instruction, outside the tensor cores).
//    wgmma / IMMA tiles and TMA are later work. For large r the running
//    top-r insertion dominates: about r * (1 + ln(rows per split / r))
//    insertions per query and split, each shifting half the list on average.
//
// Design. The TPU kernel's per-lane top-`depth` file, 128-lane segment fold
// and certificate were shaped by the TPU's vector unit and its in-order
// grid; none is carried over. Two passes instead, as in K1:
//
//  1. k2_partial<TQ>, grid (ceil(Q/TQ), S). Split s owns a contiguous range
//     of 128-row gallery tiles. The block stages TQ query rows and 128
//     gallery rows in 64-byte chunks of D in shared memory (16-byte loads,
//     neighbouring threads on neighbouring addresses); each thread owns
//     TQ/8 queries x 8 rows and sums their int8 products with __dp4a into
//     int32, exact in any order. The epilogue applies the score above, and
//     each warp keeps, per query, a sorted running top-r in shared memory
//     keyed by (score, index) with strict < (topk::warp_offer), so among
//     equal scores, such as duplicated gallery rows, the smaller index wins.
//     The block writes a partial (Q, S, r) top-r. The running lists take
//     TQ * r * 8 bytes of shared memory: TQ = 32 up to r = 512 (128 KB),
//     TQ = 16 above (128 KB at r = 1024), within the 227 KB a block may
//     have. k2_first_pass reports how many such blocks fit on an SM
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the wrapper
//     sizes S to the blocks that fit on the card at once.
//  2. k2_merge, one block per query: the r smallest of the S sorted partial
//     runs (topk::merge_runs).
//
// The result is exact by construction, so `exact` is 1 on every row.
// Sentinel: score 3e38 with index N.

#include "topk_select.cuh"

namespace {

using topk::BIG;

// The constants marked "must match" are repeated in ops/quant_fused.py.
constexpr int R_MAX = 1024;    // must match
constexpr int TQ_WIDE = 512;   // the largest r with 32 queries per block
constexpr int TN = 128;        // gallery rows per tile; must match
constexpr int DKB = 64;        // bytes of D in one staged chunk
constexpr int DKW = DKB / 4;   // the same in 32-bit words of 4 int8
constexpr int LDW = DKW + 1;   // padded shared row: conflict-free column reads
constexpr int VEC = 16;        // bytes per staging load
constexpr int THREADS = 128;   // 8 query groups x 16 row groups
constexpr int CPT = 8;         // gallery rows per thread
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_HEADS = 4;  // runs per merge thread: S <= 1024

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

template <int TQ>
size_t partial_smem(int r) {
  return sizeof(int) * (TQ * LDW + TN * LDW) + sizeof(float) * (TQ * TN + TQ * r) +
         sizeof(int) * TQ * r;
}

template <int TQ>
__global__ void __launch_bounds__(THREADS)
k2_partial(const int8_t* __restrict__ q8, const float* __restrict__ s_q,
           const int8_t* __restrict__ g8, const float* __restrict__ g_scale,
           const float* __restrict__ g_sq, int Q, int N, int D, int r,
           int metric, float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int QPT = TQ / 8;  // queries per thread
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

    // running top-r: warp w owns queries [w * TQ/4, (w + 1) * TQ/4)
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
  topk::merge_runs<MERGE_THREADS, MERGE_HEADS>(part_v + qi * M, part_i + qi * M, S, r, r, N,
                                               vals + static_cast<size_t>(qi) * r,
                                               idx + static_cast<size_t>(qi) * r);
}

// Let k2_partial<TQ> take the shared memory a budget of r needs.
template <int TQ>
cudaError_t allow_smem(int r) {
  return cudaFuncSetAttribute(k2_partial<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(partial_smem<TQ>(r)));
}

// How many blocks of k2_partial<TQ> fit on one SM of the current device at
// once for a budget of r (registers, threads and shared memory).
template <int TQ>
int occupancy(int r, int* blocks_per_sm) {
  const cudaError_t err = allow_smem<TQ>(r);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k2_partial<TQ>, THREADS, partial_smem<TQ>(r)));
}

template <int TQ>
int launch(const int8_t* q8, const float* s_q, const int8_t* g8, const float* g_scale,
           const float* g_sq, int Q, int N, int D, int r, int metric, int splits,
           float* part_v, int* part_i, cudaStream_t st) {
  const auto partial = k2_partial<TQ>;
  const size_t smem = partial_smem<TQ>(r);
  const cudaError_t err = allow_smem<TQ>(r);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + TQ - 1) / TQ, splits);
  partial<<<grid, THREADS, smem, st>>>(q8, s_q, g8, g_scale, g_sq, Q, N, D, r, metric,
                                       part_v, part_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The first pass's shape for a budget of r, 1 <= r <= 1024, on the current
// device: queries per block (*tq) and the blocks that fit on one SM at once
// (*blocks_per_sm), from which the wrapper sizes the gallery splits. Returns
// a CUDA error code.
extern "C" int k2_first_pass(int r, int* tq, int* blocks_per_sm) {
  if (r < 1 || r > R_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *tq = r <= TQ_WIDE ? 32 : 16;
  return r <= TQ_WIDE ? occupancy<32>(r, blocks_per_sm) : occupancy<16>(r, blocks_per_sm);
}

// Plain C entry point (loaded with ctypes). Shapes: q8 (Q, D) int8, s_q (Q,),
// g8 (N, D) int8, g_scale (N,), g_sq (N,), float32 unless noted,
// contiguous, 16-byte aligned, D % 16 == 0, 1 <= r <= min(1024, N),
// 1 <= splits <= 1024. Scratch: part_v (Q, S, r), part_i (Q, S, r).
// Outputs: vals (Q, r), idx (Q, r) int32, exact (Q,) int32. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int k2_quant_candidates(
    const int8_t* q8, const float* s_q, const int8_t* g8, const float* g_scale,
    const float* g_sq, int Q, int N, int D, int r, int metric, int splits,
    float* part_v, int* part_i, float* vals, int* idx, int* exact,
    void* stream) {
  if (Q < 1 || N < 1 || D < VEC || D % VEC || r < 1 || r > R_MAX || r > N ||
      r > topk::CAP || splits < 1 || splits > MERGE_HEADS * MERGE_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = r <= TQ_WIDE
      ? launch<32>(q8, s_q, g8, g_scale, g_sq, Q, N, D, r, metric, splits, part_v, part_i, st)
      : launch<16>(q8, s_q, g8, g_scale, g_sq, Q, N, D, r, metric, splits, part_v, part_i, st);
  if (err != cudaSuccess) return err;
  k2_merge<<<Q, MERGE_THREADS, 0, st>>>(part_v, part_i, splits, r, N, vals, idx, exact);
  return static_cast<int>(cudaGetLastError());
}
