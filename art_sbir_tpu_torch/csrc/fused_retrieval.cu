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
//     the positive can miss the tie by an ulp.)
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
//
// The row-sharded gallery (sharded K1). Replaces the TPU kernel under
// `shard_map` (retrieve_fused_sharded_core, retrieval_pallas.py:746, the
// shard_map at :858): each device sweeps its shards, and the partials merge
// by (value, global index) with the rank partials summed and the
// certificates ANDed. Its bound is the bound of the sweep over the whole
// gallery (N*D bytes, 2*Q*N*D operations), plus the merge's S*Q*k entries
// read once. The design keeps the launches a call at what the unsharded
// sweep takes:
//  * the shards of one device are one launch of each kernel above, through
//    a table of shard pointers and first rows passed by value (k1::Shards):
//    k1_positive_shards, then k1_sweep_shards (the sweep over all of them,
//    C * S runs of global indices, and k1_merge over those runs), so 4
//    shards of one card cost about what the unsharded sweep costs;
//  * the positive's distance is computed by the shard that holds the
//    positive, with its own norms (0 on the devices that hold none of
//    them, so the devices' vectors sum to it); the sweep's arithmetic does
//    not depend on a row's place, so the shards' columns and the positive's
//    distance have the bits of the unsharded sweep's;
//  * over several devices, k1_merge_runs on the first device merges the
//    devices' runs (any run and query strides: it also merges the int8
//    route's per-shard runs, ops/quant.py), sums their rank partials and
//    ANDs their certificates: one launch instead of the stacks, sorts and
//    reductions of a library merge.

#include "k1_sweep.cuh"

namespace {

constexpr int K_MAX = 128;  // the TPU kernel's bound on k
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_HEADS = 4;  // runs per merge thread: S <= 1024

// The gallery of `sh` that holds global row p (N rows each), or -1: the
// positive's own gallery, or none on a device that holds other shards.
template <typename T>
__device__ __forceinline__ int gallery_of(const k1::Shards<T>& sh, int p, int N) {
  for (int c = 0; c < sh.count; ++c)
    if (p >= sh.row0[c] && p - sh.row0[c] < N) return c;
  return -1;
}

// The positive's own distance in the float32 form, with the same FMA chain
// over D as the sweep gives its column, so a duplicate of the positive ties
// with it exactly. One thread a query; the positive's row is clamped into
// [0, n_out), and a query whose positive lies in none of the galleries gets
// 0.
__global__ void k1_positive(const float* __restrict__ q, const float* __restrict__ qq,
                            const int* __restrict__ pos, const k1::Shards<float> sh, int Q,
                            int N, int D, int metric, float* __restrict__ d2pos) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  const int p = min(max(pos[qi], 0), sh.n_out - 1);
  const int c = gallery_of(sh, p, N);
  if (c < 0) {
    d2pos[qi] = 0.0f;
    return;
  }
  const int row = p - sh.row0[c];
  const float* a = q + static_cast<size_t>(qi) * D;
  const float* b = sh.g[c] + static_cast<size_t>(row) * D;
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  d2pos[qi] = k1::column_distance(metric, qq[qi], sh.gg[c][row], acc);
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
                                 const k1::Shards<__nv_bfloat16> sh, int Q, int N, int D,
                                 int metric, float* __restrict__ d2pos) {
  const int lane = threadIdx.x, r = lane >> 2, t = lane & 3;
  const int qi = blockIdx.x * 8 + r;
  const int p = qi < Q ? min(max(pos[qi], 0), sh.n_out - 1) : 0;
  const int c = qi < Q ? gallery_of(sh, p, N) : -1;
  const bool in = c >= 0;
  const int row = in ? p - sh.row0[c] : 0;
  // bf16 pairs as 32-bit words (D is a multiple of 8)
  const unsigned* a =
      reinterpret_cast<const unsigned*>(sh.g[in ? c : 0] + static_cast<size_t>(row) * D);
  const unsigned* b = reinterpret_cast<const unsigned*>(q + static_cast<size_t>(in ? qi : 0) * D);
  auto pair = [&](const unsigned* v, int d) { return in && d < D ? v[d >> 1] : 0u; };
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int steps = (D + 63) / 64 * 4;
  for (int s = 0; s < steps; ++s) {
    const int d = 16 * s + 2 * t;
    const unsigned af[4] = {pair(a, d), 0u, pair(a, d + 8), 0u};
    k1::mma_bf16(acc, af, pair(b, d), pair(b, d + 8));
  }
  if (qi < Q && (r >> 1) == t)
    d2pos[qi] = in ? k1::column_distance(metric, qq[qi], sh.gg[c][row], acc[r & 1]) : 0.0f;
}

cudaError_t launch_positive(const float* q, const float* qq, const int* pos,
                            const k1::Shards<float>& sh, int Q, int N, int D, int metric,
                            float* d2pos, cudaStream_t st) {
  k1_positive<<<(Q + 127) / 128, 128, 0, st>>>(q, qq, pos, sh, Q, N, D, metric, d2pos);
  return cudaGetLastError();
}
cudaError_t launch_positive(const __nv_bfloat16* q, const float* qq, const int* pos,
                            const k1::Shards<__nv_bfloat16>& sh, int Q, int N, int D,
                            int metric, float* d2pos, cudaStream_t st) {
  k1_positive_bf16<<<(Q + 7) / 8, 32, 0, st>>>(q, qq, pos, sh, Q, N, D, metric, d2pos);
  return cudaGetLastError();
}

// A query's S sorted runs: run s of query q at v + q * vq + s * vs (values)
// and i + q * vq + s * vs (global indices), `len` entries each; its rank
// partial and certificate at r + q * rq + s * rs and e + q * rq + s * rs
// (r or e may be null: no ranks, or certificates all 1).
struct Runs {
  const float* v;
  const int* i;
  const int* r;
  const int* e;
  long long vq, vs, rq, rs;
  int count, len;
};

// One block a query: the k smallest (value, index) keys of its runs
// (topk::merge_runs), the sum of its rank partials (into ranks, unless
// null) and the AND of its certificates.
__global__ void __launch_bounds__(MERGE_THREADS)
k1_merge(const Runs runs, int k, int N, int* __restrict__ ranks, float* __restrict__ vals,
         int* __restrict__ idx, int* __restrict__ exact) {
  __shared__ int wr[MERGE_THREADS / 32];
  __shared__ int we[MERGE_THREADS / 32];

  const int qi = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  int r = 0, e = 1;
  for (int s = tid; s < runs.count; s += MERGE_THREADS) {
    const long long o = qi * runs.rq + s * runs.rs;
    if (runs.r) r += runs.r[o];
    if (runs.e) e &= runs.e[o] != 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    r += __shfl_down_sync(topk::FULL, r, off);
    e &= __shfl_down_sync(topk::FULL, e, off);
  }
  if (lane == 0) { wr[warp] = r; we[warp] = e; }
  __syncthreads();
  if (tid == 0) {
    int total = 0, all = 1;
    for (int w = 0; w < MERGE_THREADS / 32; ++w) { total += wr[w]; all &= we[w]; }
    if (ranks) ranks[qi] = total;
    exact[qi] = all;
  }
  topk::merge_runs<MERGE_THREADS, MERGE_HEADS>(runs.v + qi * runs.vq, runs.i + qi * runs.vq,
                                               runs.count, runs.vs, runs.len, k, N,
                                               vals + static_cast<size_t>(qi) * k,
                                               idx + static_cast<size_t>(qi) * k);
}

// The sweep's C * S runs of each query, laid out (Q, C * S, k) and (Q, C * S).
Runs sweep_runs(const float* part_v, const int* part_i, const int* part_r, int runs, int k) {
  return Runs{part_v, part_i, part_r, nullptr, static_cast<long long>(runs) * k, k, runs, 1,
              runs, k};
}

// K1 over one gallery (single = 1: the positive's distance first, then the
// sweep of kernel parameters) or over the shards of a device's table
// (single = 0: the positive's distance given).
template <typename T>
int launch(const T* q, const float* qq, const int* pos, const k1::Shards<T>& sh, int Q, int N,
           int D, int k, int metric, int with_ranks, int splits, int single, float* d2pos,
           float* part_v, int* part_i, int* part_r, int* ranks, float* vals, int* idx,
           int* exact, cudaStream_t st) {
  if (with_ranks && single) {
    const cudaError_t err = launch_positive(q, qq, pos, sh, Q, N, D, metric, d2pos, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err =
      single ? k1::sweep<T, 3, 8>(q, qq, pos, sh.g[0], sh.gg[0], d2pos, Q, N, D, k, metric,
                                  with_ranks, splits, part_v, part_i, part_r, nullptr, st)
             : k1::sweep_shards<T, 3, 8>(q, qq, pos, sh, d2pos, Q, N, D, k, metric,
                                         with_ranks, splits, part_v, part_i, part_r,
                                         nullptr, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_merge<<<Q, MERGE_THREADS, 0, st>>>(
      sweep_runs(part_v, part_i, part_r, splits * sh.count, k), k, sh.n_out, ranks, vals, idx,
      exact);
  return static_cast<int>(cudaGetLastError());
}

// The table of `count` galleries of N rows: pointers g[c], gg[c] and first
// rows row0[c] (host arrays), the global sentinel n_out.
template <typename T>
bool make_table(const void* const* g, const void* const* gg, const int* row0, int count, int N,
                int n_out, k1::Shards<T>* sh) {
  if (count < 1 || count > k1::MAX_SHARDS) return false;
  *sh = k1::Shards<T>{};
  for (int c = 0; c < count; ++c) {
    sh->g[c] = static_cast<const T*>(g[c]);
    sh->gg[c] = static_cast<const float*>(gg[c]);
    sh->row0[c] = row0[c];
    if (row0[c] < 0 || row0[c] > n_out - N) return false;
  }
  sh->count = count;
  sh->n_out = n_out;
  return true;
}

bool shapes_ok(int Q, int N, int D, int bf16) {
  const int vec = bf16 ? 8 : 4;
  return Q >= 1 && N >= 1 && D >= vec && D % vec == 0;
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
// scratch for the positive's distance. Scratch: part_v (Q, S, k), part_i
// (Q, S, k), part_r (Q, S). Outputs: ranks (Q,), vals (Q, k), idx (Q, k),
// exact (Q,). Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int k1_fused_retrieval(
    const void* q, const float* qq, const int* pos, const void* g,
    const float* gg, int Q, int N, int D, int k, int metric, int with_ranks,
    int bf16, int splits, float* d2pos, float* part_v, int* part_i, int* part_r,
    int* ranks, float* vals, int* idx, int* exact, void* stream) {
  if (!shapes_ok(Q, N, D, bf16) || k < 1 || k > K_MAX || splits < 1 ||
      splits > MERGE_HEADS * MERGE_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(q), qq, pos,
                  k1::one_gallery(static_cast<const __nv_bfloat16*>(g), gg, N), Q, N, D, k,
                  metric, with_ranks, splits, 1, d2pos, part_v, part_i, part_r, ranks, vals,
                  idx, exact, st);
  return launch(static_cast<const float*>(q), qq, pos,
                k1::one_gallery(static_cast<const float*>(g), gg, N), Q, N, D, k, metric,
                with_ranks, splits, 1, d2pos, part_v, part_i, part_r, ranks, vals, idx, exact,
                st);
}

// The positive's distance over the `count` shards of one device, N rows
// each: g[c] (N, D) and gg[c] (N,) on the device, first global rows row0[c]
// (host arrays), n_out the rows of the whole gallery. d2pos[qi] becomes
// query qi's distance to its positive, the global row pos[qi] clamped into
// [0, n_out), where one of these shards holds it, and 0 where none does.
// Other shapes as k1_fused_retrieval's. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int k1_positive_shards(const void* q, const float* qq, const int* pos,
                                  const void* const* g, const void* const* gg, const int* row0,
                                  int count, int n_out, int Q, int N, int D, int metric,
                                  int bf16, float* d2pos, void* stream) {
  if (!shapes_ok(Q, N, D, bf16)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    k1::Shards<__nv_bfloat16> sh;
    if (!make_table(g, gg, row0, count, N, n_out, &sh)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_positive(static_cast<const __nv_bfloat16*>(q), qq, pos, sh,
                                            Q, N, D, metric, d2pos, st));
  }
  k1::Shards<float> sh;
  if (!make_table(g, gg, row0, count, N, n_out, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_positive(static_cast<const float*>(q), qq, pos, sh, Q, N, D, metric, d2pos, st));
}

// K1 over the `count` shards of one device (tables as k1_positive_shards'),
// `splits` gallery splits each (count * splits <= 1024), given the
// positive's distance d2pos (Q,) and the positive's global row pos (Q,):
// the sweep of every shard in one launch, then the merge of all their runs
// by (value, global index) with the rank partials summed. Scratch: part_v,
// part_i (Q, count * splits, k), part_r (Q, count * splits). Outputs as
// k1_fused_retrieval's, with global indices (sentinel n_out). Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int k1_sweep_shards(const void* q, const float* qq, const int* pos,
                               const void* const* g, const void* const* gg, const int* row0,
                               int count, int n_out, int Q, int N, int D, int k, int metric,
                               int with_ranks, int bf16, int splits, const float* d2pos,
                               float* part_v, int* part_i, int* part_r, int* ranks,
                               float* vals, int* idx, int* exact, void* stream) {
  if (!shapes_ok(Q, N, D, bf16) || k < 1 || k > K_MAX || k > N || splits < 1 ||
      count * splits > MERGE_HEADS * MERGE_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d2 = const_cast<float*>(d2pos);  // read only: the positive is not launched
  if (bf16) {
    k1::Shards<__nv_bfloat16> sh;
    if (!make_table(g, gg, row0, count, N, n_out, &sh)) return static_cast<int>(cudaErrorInvalidValue);
    return launch(static_cast<const __nv_bfloat16*>(q), qq, pos, sh, Q, N, D, k, metric,
                  with_ranks, splits, 0, d2, part_v, part_i, part_r, ranks, vals, idx, exact,
                  st);
  }
  k1::Shards<float> sh;
  if (!make_table(g, gg, row0, count, N, n_out, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(q), qq, pos, sh, Q, N, D, k, metric, with_ranks,
                splits, 0, d2, part_v, part_i, part_r, ranks, vals, idx, exact, st);
}

// The cross-shard merge: for each of Q queries, the k smallest (value,
// global index) keys of its `count` sorted runs of `len` entries (run s of
// query q at v + q * vq + s * vs and i + q * vq + s * vs, in elements), the
// sum of its rank partials at r + q * rq + s * rs into ranks (both may be
// null) and the AND of its certificates at e + q * rq + s * rs into exact
// (e null: all 1). 1 <= k <= count * len, count <= 1024; n_out fills slots
// past every run. Outputs vals, idx (Q, k), exact (Q,). Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int k1_merge_runs(const float* v, const int* i, const int* r, const int* e,
                             long long vq, long long vs, long long rq, long long rs, int count,
                             int len, int Q, int k, int n_out, int* ranks, float* vals,
                             int* idx, int* exact, void* stream) {
  if (Q < 1 || count < 1 || count > MERGE_HEADS * MERGE_THREADS || len < 1 || k < 1 ||
      k > len * count)
    return static_cast<int>(cudaErrorInvalidValue);
  k1_merge<<<Q, MERGE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      Runs{v, i, r, e, vq, vs, rq, rs, count, len}, k, n_out, ranks, vals, idx, exact);
  return static_cast<int>(cudaGetLastError());
}
