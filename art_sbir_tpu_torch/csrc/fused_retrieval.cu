// K1: fused distance + rank-of-positive + top-k over a resident gallery.
//
// Replaces the TPU kernel `_kernel` in art_sbir_tpu/ops/retrieval_pallas.py
// (launched by `_sweep`, pl.pallas_call at retrieval_pallas.py:365), in its
// single-device forms: float32 operands (precision='highest') and bf16
// operands (precision='default', the bf16 gallery stream). In both forms
// the norms are float32 and the products are summed in float32.
//
// What bounds it on an H100 (SXM, 3.35 TB/s; 67 TFLOP/s float32 FMA, 989
// TFLOP/s bf16 on the tensor cores, dense):
//  * At serving shapes (Q <= 32 queries per call) it is bound by the gallery
//    read: N*D*4 bytes in float32, 409.6 MB at N = 100,000 and D = 1024,
//    about 0.122 ms; N*D*2 bytes in bf16, 204.8 MB, about 0.061 ms. A block
//    holds all the queries of its tile (up to 64), so at Q <= 64 the gallery
//    streams from device memory once per call; the 50 MB L2 does not hold
//    it. Above 64 queries the blocks of the query tiles over one split are
//    launched together (the query tile is the grid's fastest dimension), so
//    the L2 serves the repeats.
//  * The operations are 2*Q*N*D: 6.55 GFLOP at Q = 32, N = 100,000, which is
//    0.098 ms on float32 FMA and 0.0066 ms on the bf16 tensor cores. At
//    Q >= ~32 (float32) or ~300 (bf16) the operations set the bound.
//
// Design. The TPU kernel's per-lane top-4 register file, 128-lane segment
// fold and sequential grid carry were shaped by the TPU's vector unit and
// its in-order grid; none of them is carried over. Two passes instead
// (after k1_positive, when ranks are asked for):
//
//  0. The positive's own distance with the same arithmetic as its column
//     in the sweep: k1_positive (one thread a query, the FMA chain) in the
//     float32 form, k1_positive_bf16 (one warp for 8 queries, the same
//     mma.sync steps) in the bf16 form. (The TPU kernel takes it from a
//     separate elementwise sum of the float32 inputs, so a duplicate of
//     the positive can miss the tie by an ulp.) A shard of a row-sharded
//     gallery is given it instead (pos_given): the shard that owns the
//     positive computes it alone (k1_positive_distance), with its own
//     norms, and the result is given to every shard. The sweep's
//     arithmetic does not depend on a row's place, so the shards' columns
//     and the positive's distance have the bits of the unsharded sweep's.
//  1. k1::sweep_partial<T, TQ, 3> (k1_sweep.cuh, shared with the ablation
//     probe P1): a cp.async ring over the gallery, query tiles of 8 to 64
//     rows chosen from Q, the cross term (float32 FMA, or bf16 mma.sync),
//     and in registers the distances, the rank hits and a threshold filter
//     in front of each query's sorted top-k. The block writes a partial (Q, S, k) top-k and (Q, S) rank
//     counts. k1_first_pass reports the query tile and the blocks that fit
//     on an SM, from which the wrapper sizes the S gallery splits.
//  2. k1_merge, one block per query: the k smallest of the S sorted partial
//     runs (topk::merge_runs), plus the sum of the rank partials.
//
// The result is exact by construction, so `exact` is 1 on every row.
// Sentinel: value 3e38 with index N, as on the TPU.

#include "k1_sweep.cuh"

namespace {

constexpr int K_MAX = 128;  // the TPU kernel's bound on k
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_HEADS = 4;  // runs per merge thread: S <= 1024

// Whether query qi's positive is taken: always (owned = 0, its column
// clamped into the gallery), or only where it lies in this gallery (owned =
// 1: a shard of a row-sharded gallery, whose other shards own the rest).
__device__ __forceinline__ bool take_positive(const int* pos, int qi, int Q, int N, int owned) {
  return qi < Q && (!owned || (pos[qi] >= 0 && pos[qi] < N));
}

// The positive's own distance in the float32 form, with the same FMA chain
// over D as the sweep gives its column, so a duplicate of the positive ties
// with it exactly. One thread a query.
__global__ void k1_positive(const float* __restrict__ q, const float* __restrict__ qq,
                            const int* __restrict__ pos, const float* __restrict__ g,
                            const float* __restrict__ gg, int Q, int N, int D, int metric,
                            int owned, float* __restrict__ d2pos) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (!take_positive(pos, qi, Q, N, owned)) return;
  const int p = min(max(pos[qi], 0), N - 1);
  const float* a = q + static_cast<size_t>(qi) * D;
  const float* b = g + static_cast<size_t>(p) * D;
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  d2pos[qi] = k1::column_distance(metric, qq[qi], gg[p], acc);
}

// The positive's own distance in the bf16 form, from the sweep's own
// arithmetic: mma.sync m16n8k16 with float32 accumulators from 0, over the
// same k16 steps in the same order (whole 64-value chunks, the values past
// D zero). One warp takes 8 queries: row g of A is query g's positive row,
// column g of B the query, so lane (g, t) with t = g / 2 holds query g's
// own product. Rows 8-15 of A are zero, and so are the rows of queries not
// taken (the whole warp runs the mma.sync steps).
__global__ void k1_positive_bf16(const __nv_bfloat16* __restrict__ q,
                                 const float* __restrict__ qq, const int* __restrict__ pos,
                                 const __nv_bfloat16* __restrict__ g,
                                 const float* __restrict__ gg, int Q, int N, int D,
                                 int metric, int owned, float* __restrict__ d2pos) {
  const int lane = threadIdx.x, r = lane >> 2, t = lane & 3;
  const int qi = blockIdx.x * 8 + r;
  const bool in = take_positive(pos, qi, Q, N, owned);
  const int p = in ? min(max(pos[qi], 0), N - 1) : 0;
  // bf16 pairs as 32-bit words (D is a multiple of 8)
  const unsigned* a = reinterpret_cast<const unsigned*>(g + static_cast<size_t>(p) * D);
  const unsigned* b = reinterpret_cast<const unsigned*>(q + static_cast<size_t>(in ? qi : 0) * D);
  auto pair = [&](const unsigned* row, int d) { return in && d < D ? row[d >> 1] : 0u; };
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int steps = (D + 63) / 64 * 4;
  for (int s = 0; s < steps; ++s) {
    const int d = 16 * s + 2 * t;
    const unsigned af[4] = {pair(a, d), 0u, pair(a, d + 8), 0u};
    k1::mma_bf16(c, af, pair(b, d), pair(b, d + 8));
  }
  if (in && (r >> 1) == t) d2pos[qi] = k1::column_distance(metric, qq[qi], gg[p], c[r & 1]);
}

cudaError_t launch_positive(const float* q, const float* qq, const int* pos, const float* g,
                            const float* gg, int Q, int N, int D, int metric, int owned,
                            float* d2pos, cudaStream_t st) {
  k1_positive<<<(Q + 127) / 128, 128, 0, st>>>(q, qq, pos, g, gg, Q, N, D, metric, owned,
                                               d2pos);
  return cudaGetLastError();
}
cudaError_t launch_positive(const __nv_bfloat16* q, const float* qq, const int* pos,
                            const __nv_bfloat16* g, const float* gg, int Q, int N, int D,
                            int metric, int owned, float* d2pos, cudaStream_t st) {
  k1_positive_bf16<<<(Q + 7) / 8, 32, 0, st>>>(q, qq, pos, g, gg, Q, N, D, metric, owned,
                                               d2pos);
  return cudaGetLastError();
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
  for (int off = 16; off > 0; off >>= 1) r += __shfl_down_sync(topk::FULL, r, off);
  if (lane == 0) wr[warp] = r;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < MERGE_THREADS / 32; ++w) total += wr[w];
    ranks[qi] = total;
    exact[qi] = 1;
  }
  const size_t M = static_cast<size_t>(S) * k;
  topk::merge_runs<MERGE_THREADS, MERGE_HEADS>(part_v + qi * M, part_i + qi * M, S, k, k, N,
                                               vals + static_cast<size_t>(qi) * k,
                                               idx + static_cast<size_t>(qi) * k);
}

template <typename T>
int launch(const T* q, const float* qq, const int* pos, const T* g, const float* gg,
           int Q, int N, int D, int k, int metric, int with_ranks, int splits, int pos_given,
           float* d2pos, float* part_v, int* part_i, int* part_r, int* ranks,
           float* vals, int* idx, int* exact, cudaStream_t st) {
  if (with_ranks && !pos_given) {
    const cudaError_t err = launch_positive(q, qq, pos, g, gg, Q, N, D, metric, 0, d2pos, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = k1::sweep<T, 3, 8>(q, qq, pos, g, gg, d2pos, Q, N, D, k, metric,
                                          with_ranks, splits, part_v, part_i, part_r,
                                          nullptr, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_merge<<<Q, MERGE_THREADS, 0, st>>>(part_v, part_i, part_r, splits, k, N, ranks, vals,
                                        idx, exact);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The first pass's shape for Q queries and a top-k of k, 1 <= k <= 128, in
// the float32 (bf16 = 0) or bf16 form, on the current device: queries a
// block (*tq), gallery rows a tile (*tn) and the blocks that fit on one SM
// at once (*blocks_per_sm), from which the wrapper sizes the gallery
// splits. Returns a CUDA error code.
extern "C" int k1_first_pass(int Q, int k, int bf16, int* tq, int* tn, int* blocks_per_sm) {
  if (Q < 1 || k < 1 || k > K_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bf16 ? k1::first_pass<__nv_bfloat16, 3, 8>(Q, k, tq, tn, blocks_per_sm)
           : k1::first_pass<float, 3, 8>(Q, k, tq, tn, blocks_per_sm));
}

// Plain C entry point (loaded with ctypes). Shapes: q (Q, D), g (N, D),
// float32 (bf16 = 0) or bf16 (bf16 = 1); qq (Q,), gg (N,) float32; pos (Q,)
// int32; all contiguous, q and g 16-byte aligned, D a multiple of 4
// (float32) or 8 (bf16), 1 <= k <= 128, 1 <= splits <= 1024. d2pos (Q,):
// scratch for the positive's distance, or with pos_given = 1 that distance
// given (a shard of a row-sharded gallery: computed by the shard that owns
// the positive, k1_positive_distance); pos is then the positive's column in
// this gallery, -1 when it lies before it and N after it, and only
// compared. Scratch: part_v (Q, S, k), part_i (Q, S, k), part_r (Q, S).
// Outputs: ranks (Q,), vals (Q, k), idx (Q, k), exact (Q,). Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int k1_fused_retrieval(
    const void* q, const float* qq, const int* pos, const void* g,
    const float* gg, int Q, int N, int D, int k, int metric, int with_ranks,
    int bf16, int splits, int pos_given, float* d2pos, float* part_v,
    int* part_i, int* part_r, int* ranks, float* vals, int* idx, int* exact,
    void* stream) {
  const int vec = bf16 ? 8 : 4;
  if (Q < 1 || N < 1 || D < vec || D % vec || k < 1 || k > K_MAX || splits < 1 ||
      splits > MERGE_HEADS * MERGE_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(q), qq, pos,
                  static_cast<const __nv_bfloat16*>(g), gg, Q, N, D, k, metric, with_ranks,
                  splits, pos_given, d2pos, part_v, part_i, part_r, ranks, vals, idx, exact,
                  st);
  return launch(static_cast<const float*>(q), qq, pos, static_cast<const float*>(g), gg, Q,
                N, D, k, metric, with_ranks, splits, pos_given, d2pos, part_v, part_i, part_r,
                ranks, vals, idx, exact, st);
}

// The positive's distance alone, as k1_fused_retrieval computes it before
// its sweep, for the queries whose positive pos[qi] lies in this gallery
// (0 <= pos < N); d2pos of the other queries is left as it was. Shapes and
// forms as k1_fused_retrieval's. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int k1_positive_distance(const void* q, const float* qq, const int* pos,
                                    const void* g, const float* gg, int Q, int N, int D,
                                    int metric, int bf16, float* d2pos, void* stream) {
  const int vec = bf16 ? 8 : 4;
  if (Q < 1 || N < 1 || D < vec || D % vec) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_positive(static_cast<const __nv_bfloat16*>(q), qq, pos,
                             static_cast<const __nv_bfloat16*>(g), gg, Q, N, D, metric, 1,
                             d2pos, st)
           : launch_positive(static_cast<const float*>(q), qq, pos,
                             static_cast<const float*>(g), gg, Q, N, D, metric, 1, d2pos,
                             st));
}
