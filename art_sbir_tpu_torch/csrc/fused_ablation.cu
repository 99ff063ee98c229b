// P1: the ablation probe's stripped forms of K1's bf16 sweep.
//
// Replaces the TPU kernel `_ablate_kernel` in scripts/probe_fused_overhead.py
// (launched by `run_ablate`, pl.pallas_call at probe_fused_overhead.py:88),
// whose levels strip the TPU's K1 to measure where its time goes. Here each
// level strips the port's own K1: the first pass is K1's, k1::sweep_partial
// (k1_sweep.cuh) with bf16 operands, the same query tiles, ring and
// tensor-core products (mma.sync m16n8k16), and only the epilogue cut
// back (query tiles of 32 and 64 only: P1_MIN_TQ); p1_first_pass reports the tile
// and the blocks that fit on an SM, from which the wrapper sizes the
// splits. Per query row, into out (Q,) int32:
//   level 0  the cross term only: the sum over tile_n-column tiles of
//            int32(the tile's float32 row sum of cross terms), truncated
//            toward zero as astype(int32) does
//   level 1  + the euclidean distances max(qq + gg - 2 cross, 0) and the rank
//            hits against d2pos (`_hit`'s rule)
//   level 2  + the count of distances <= 1e-6, and a per-lane running minimum
//            of those distances folded in times 0 (the TPU level's `g1`)
// Level 3 would be K1 itself (fused_retrieval.cu).
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): the
// gallery read, N*D*2 bytes, at serving shapes (Q <= 32); the 2*Q*N*D
// operations at Q >= ~300.
//
// Two small kernels, one warp per query, finish the levels: p1_finish_tiles
// sums each query's tile_n / 128 partial row sums per tile in float32 and
// adds the truncated tile sums; p1_finish_counts adds the (Q, S) partial
// counts. Integer sums are exact in any order; the float32 tile sums differ
// from another order of summation by rounding only, so level 0 may differ
// from another implementation by one per tile.

#include "k1_sweep.cuh"

// P1's smallest query tile. The probe runs Q = 32 and Q = 512 (tiles 32 and
// 64), so only those two tiles are built, each at three levels; a smaller Q
// runs on the tile of 32.
constexpr int P1_MIN_TQ = 32;

namespace {

// One warp per query (block): lane l takes the tiles l, l + 32, ...
__global__ void p1_finish_tiles(const float* __restrict__ part_m, int Q, int n_tiles,
                                int sub, int* __restrict__ out) {
  const int qi = blockIdx.x, lane = threadIdx.x;
  int total = 0;
  for (int t0 = lane * sub; t0 < n_tiles; t0 += 32 * sub) {
    float sum = 0.0f;
    for (int u = 0; u < sub; ++u) sum += part_m[static_cast<size_t>(t0 + u) * Q + qi];
    total += static_cast<int>(sum);
  }
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(k1::FULL, total, off);
  if (lane == 0) out[qi] = total;
}

__global__ void p1_finish_counts(const int* __restrict__ part_r, int S,
                                 int* __restrict__ out) {
  const int qi = blockIdx.x, lane = threadIdx.x;
  int total = 0;
  for (int s = lane; s < S; s += 32) total += part_r[static_cast<size_t>(qi) * S + s];
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(k1::FULL, total, off);
  if (lane == 0) out[qi] = total;
}

}  // namespace

// The first pass's shape at a level (0, 1 or 2) for Q queries on the
// current device: queries a block (*tq), gallery rows a tile (*tn) and the
// blocks that fit on one SM at once (*blocks_per_sm). Returns a CUDA error
// code.
extern "C" int p1_first_pass(int Q, int level, int* tq, int* tn, int* blocks_per_sm) {
  if (Q < 1 || level < 0 || level > 2) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  return static_cast<int>(
      level == 0   ? k1::first_pass<bf16, 0, P1_MIN_TQ>(Q, 0, tq, tn, blocks_per_sm)
      : level == 1 ? k1::first_pass<bf16, 1, P1_MIN_TQ>(Q, 0, tq, tn, blocks_per_sm)
                   : k1::first_pass<bf16, 2, P1_MIN_TQ>(Q, 0, tq, tn, blocks_per_sm));
}

// Plain C entry point (loaded with ctypes). Shapes: q (Q, D) and g (N, D)
// bf16, contiguous, 16-byte aligned, D % 8 == 0; qq (Q,), d2pos (Q,), gg
// (N,) float32; pos (Q,) int32; N a multiple of tile_n, tile_n a multiple of
// 128; level 0, 1 or 2. Scratch: part_m (N / 128, Q) float32 (level 0) or
// part_r (Q, S) int32 (levels 1 and 2). Output: out (Q,) int32. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int p1_fused_ablation(
    const void* q, const float* qq, const float* d2pos, const int* pos,
    const void* g, const float* gg, int Q, int N, int D, int level, int tile_n,
    int splits, float* part_m, int* part_r, int* out, void* stream) {
  if (Q < 1 || N < 1 || D < 8 || D % 8 || tile_n < k1::TN || tile_n % k1::TN ||
      N % tile_n || level < 0 || level > 2 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  cudaError_t err;
  if (level == 0)
    err = k1::sweep<__nv_bfloat16, 0, P1_MIN_TQ>(qb, qq, pos, gb, gg, d2pos, Q, N, D, 0, 0, 1, splits,
                                      nullptr, nullptr, part_r, part_m, st);
  else if (level == 1)
    err = k1::sweep<__nv_bfloat16, 1, P1_MIN_TQ>(qb, qq, pos, gb, gg, d2pos, Q, N, D, 0, 0, 1, splits,
                                      nullptr, nullptr, part_r, part_m, st);
  else
    err = k1::sweep<__nv_bfloat16, 2, P1_MIN_TQ>(qb, qq, pos, gb, gg, d2pos, Q, N, D, 0, 0, 1, splits,
                                      nullptr, nullptr, part_r, part_m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (level == 0)
    p1_finish_tiles<<<Q, 32, 0, st>>>(part_m, Q, N / k1::TN, tile_n / k1::TN, out);
  else
    p1_finish_counts<<<Q, 32, 0, st>>>(part_r, splits, out);
  return static_cast<int>(cudaGetLastError());
}
