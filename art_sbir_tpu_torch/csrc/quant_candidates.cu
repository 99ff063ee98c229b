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
//    at the int8 tensor-core rate. So bytes set the bound: the kernel must
//    keep enough of the gallery in flight while it multiplies and selects.
//  * The selection. Split into S parts, a running top-r admits about
//    r * (1 + ln(rows per split / r)) keys per query and split (249,000 per
//    query over the 66 splits of r = 1024), and a top-r kept sorted by
//    insertion shifts half its list for each. That, not the bytes, set the
//    time at large r, and its block barriers stalled the products.
//
// Design. The TPU kernel's per-lane top-`depth` file, 128-lane segment fold
// and certificate were shaped by the TPU's vector unit and its in-order
// grid; none is carried over. Two passes:
//
//  1. k2_partial<TQ, ST>, grid (ceil(Q/TQ), S), 8 warps. Split s owns a
//     contiguous range of 128-row gallery tiles and walks them in 128-byte
//     chunks of D (whole cache lines of each row). A ring of ST shared-
//     memory stages is filled by 16-byte cp.async copies (rows past Q or N
//     and bytes past D are zero-filled, which leaves the int32 sums
//     unchanged), and the L2 is asked for each row's line PREFETCH chunks
//     ahead (and for the tile's scales and squared norms), so the stream
//     stays in flight while a chunk is multiplied.
//     Each warp owns a TQ x 16 sub-tile of the TQ x 128 output and runs
//     mma.sync.m16n8k32 s8.s8.s32 on it: fragments are plain 32-bit shared
//     loads from rows padded to 144 bytes (conflict-free), and the int32
//     sums are exact in any order (1024 * 127^2 < 2^31, no .satfinite).
//     After a tile's last chunk the epilogue writes the TQ x 128 scores to
//     shared memory.
//     Selection, per tile: warp w owns queries [w * TQ/8, (w + 1) * TQ/8).
//     Each query keeps its kept keys sorted and an unsorted buffer of B
//     entries (64, or 128 above r = 512). Per 32
//     scores the warp ballots key < tau; the lanes that pass append at
//     base + popc(ballot & lanes below): one store each, nothing moves.
//     When an append would overflow the buffer, the warp flushes: it sorts
//     the buffer in registers (a bitonic network over shuffles), merges it
//     with the kept keys by rank (a key's place is its index plus its count
//     of smaller keys in the other list; the binary searches run eight at a
//     time, and kept keys move down from the top, so the merge is in
//     place) and keeps the r smallest. A pad word every 32 entries keeps
//     the searches' strided probes on distinct banks.
//     tau is the smaller of two bounds: the query's own r-th kept key, and
//     a bound the splits share. Split s publishes its m-th smallest kept
//     key, m = ceil(r / S), in a slot of device memory; once every split
//     has published, the largest slot has S * m >= r keys at or below it,
//     and atomicMin keeps the smallest such maximum. Either way a key at or
//     above tau has r smaller keys and cannot be among the r best, and keys
//     are unique, so strict < is exact, and kept keys above tau are
//     dropped, which keeps the flushes short. At r = 1024 the keys admitted
//     per query fall from about 249,000 (the estimate above) to about
//     39,000 (scripts/probe_k2_parts.py), the fill of each split's first
//     r keys included. All comparisons are
//     (score, index), so among equal scores, such as duplicated rows, the
//     smaller index wins.
//  2. k2_merge, one block per query, over the S sorted partial runs: it
//     gathers the entries at or below the final shared bound (a superset
//     of the r best, a few times r), sorts them (bitonic, shared memory)
//     and writes the first r. Where they do not fit, the tournament merge
//     of the runs (topk::merge_runs) takes over. Both are exact, so `exact`
//     is 1 on every row.
//
// Shared memory of a block: ST * (TQ + 128) * 144 bytes of staging,
// TQ * 132 * 4 of scores and TQ * (r + B) * 8 (plus pads) of selection.
// TQ = 32 up to r = 512, 16 above. ST = 3 where two blocks still fit on an
// SM (111 KB at r = 40), 2 where only two stages let two fit (111 KB at
// r = 128), else 3 where one block holds them: 167 KB at r = 256, 218 KB
// at r = 1024; r = 512 takes two stages, 210 KB. A block may have 227 KB.
// k2_first_pass reports how many blocks fit on an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the wrapper sizes S
// to the blocks that fit on the card at once, so every split runs in the
// first wave and publishes.
//
// Sentinel: score 3e38 with index N.
//
// The row-sharded gallery (the int8 route's sharded form). Replaces K2
// under `shard_map` (`_quant_sharded_jit`, art_sbir_tpu/ops/quant.py:348,
// the shard_map at :380): each shard's own top r, then a local exact
// rerank and a merge (ops/quant.py). k2_quant_candidates_shards takes the
// C shards of one device in one launch, through a table of their pointers
// and first rows passed by value (G8Shards): the first pass runs C * S
// splits (split s of shard c keeps its own bounds), and the merge one block
// a (query, shard). Given `by_index`, the merge emits each (query, shard)'s
// r candidates in index order, as global rows (the shard's first row plus
// the local one), which is the order the rerank wants, so no sort follows.
// Its bound is the scan's over the whole gallery.

#include "async_copy.cuh"
#include "topk_select.cuh"

namespace {

using topk::BIG;
using topk::FULL;
using topk::key_less;
using topk::warp_sort;

// The constants marked "must match" are repeated in ops/quant_fused.py.
constexpr int R_MAX = 1024;      // must match
constexpr int MAX_SHARDS = 16;   // shards of one launch; must match
constexpr int TQ_WIDE = 512;     // the largest r with 32 queries per block
constexpr int TN = 128;          // gallery rows per tile; must match
constexpr int DK = 128;          // bytes of D in one staged chunk (four k32 steps)
constexpr int LDW = DK / 4 + 4;  // padded shared row in 32-bit words (144 bytes)
constexpr int LDD = TN + 4;      // padded row of the score tile, in floats
constexpr int VEC = 16;          // bytes per cp.async copy
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;  // each warp a TQ x 16 sub-tile
constexpr int WN = TN / WARPS;       // gallery rows of a warp's sub-tile
constexpr int PREFETCH = 4;          // chunks ahead that the L2 is asked for
constexpr int GROUP = 8;             // runs of kept keys a flush moves at once
constexpr size_t TWO_BLOCKS = 113 * 1024;  // the most two blocks of an SM may each take
constexpr size_t ONE_BLOCK = 227 * 1024;   // the most one block may take
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_HEADS = 4;   // runs per merge thread: S <= 1024
constexpr int MERGE_CAP = 4096;  // keys the merge gathers and sorts in shared memory
constexpr unsigned long long NONE = ~0ull;  // no bound yet

// `_quant_core`'s approximate score from the exact int32 cross term.
__device__ __forceinline__ float approx_score(int metric, float sq, float gsc,
                                              float gsq, int cross) {
  const float dot = __fmul_rn(__int2float_rn(cross), __fmul_rn(sq, gsc));
  return metric == 0 ? __fsub_rn(gsq, __fmul_rn(2.0f, dot)) : -dot;
}

// The selection buffer per query for a budget of r: 64 keys, 128 above
// r = 512 (a power of two: the flush sorts it in registers).
__host__ __device__ inline int buffer_len(int r) { return r > TQ_WIDE ? 128 : 64; }

// Element e of a query's key list lives at word e + e / 32: a pad word
// every 32 keeps the strided probes of a binary search on distinct banks.
__host__ __device__ inline int at(int e) { return e + (e >> 5); }

// Words of one query's key list: r kept keys, then the buffer.
__host__ __device__ inline int list_words(int r) { return at(r + buffer_len(r) - 1) + 1; }

// The int8 galleries of one launch: `count` shards of N rows, shard c the
// global rows [row0[c], row0[c] + N) (one shard at row 0 unsharded).
struct G8Shards {
  const int8_t* g8[MAX_SHARDS];
  const float* scale[MAX_SHARDS];
  const float* sq[MAX_SHARDS];
  int row0[MAX_SHARDS];
  int count;
};

template <int TQ, int ST>
size_t partial_smem(int r) {
  return sizeof(int) * ST * (TQ + TN) * LDW + sizeof(float) * TQ * LDD +
         (sizeof(float) + sizeof(int)) * TQ * list_words(r) +
         (sizeof(unsigned long long) + 2 * sizeof(int)) * TQ;
}

// (score, index) as one integer in the same order (-0.0 as +0.0, as the
// float compare has it), for the bounds the splits share.
__device__ __forceinline__ unsigned long long pack_key(float v, int n) {
  unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(n);
}

__device__ __forceinline__ unsigned long long load_l2(const unsigned long long* p) {
  return static_cast<unsigned long long>(__ldcg(reinterpret_cast<const long long*>(p)));
}

// c += a . b over one 16 x 8 x 32 int8 tile (a row-major, b column-major).
__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Start the copy of rows [row0, row0 + rows) of a (limit, D) int8 matrix,
// bytes [d0, d0 + DK), into dst (rows x LDW words). Rows past `limit` and
// bytes past D are zero-filled (a copy of 0 source bytes).
__device__ __forceinline__ void stage_async(const int8_t* __restrict__ src, int row0,
                                            int rows, int limit, int D, int d0,
                                            int* __restrict__ dst) {
  for (int e = threadIdx.x; e < rows * (DK / VEC); e += THREADS) {
    const int r = e / (DK / VEC), c = (e % (DK / VEC)) * VEC;
    const int row = row0 + r, dd = d0 + c;
    const bool in = row < limit && dd < D;
    cp_async16(dst + r * LDW + c / 4,
               in ? src + static_cast<size_t>(row) * D + dd : src, in ? VEC : 0);
  }
}

// pos[m] = the number of keys of the sorted elements [e0, e0 + n) below
// (kv[m], kx[m]); the M binary searches advance together.
template <int M>
__device__ __forceinline__ void count_less(const float* v, const int* x, int e0, int n,
                                           const float (&kv)[M], const int (&kx)[M],
                                           int (&pos)[M]) {
#pragma unroll
  for (int m = 0; m < M; ++m) pos[m] = 0;
  for (int s = n ? 1 << (31 - __clz(n)) : 0; s; s >>= 1)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = pos[m] + s;
      if (q <= n) {
        const int a = at(e0 + q - 1);
        if (key_less(v[a], x[a], kv[m], kx[m])) pos[m] = q;
      }
    }
}

// One warp folds a query's nb buffered keys (elements [r, r + nb)) into
// its nk kept keys (elements [0, nk), sorted); B = 32 * U. Keeps the
// min(r, nk + nb) smallest, sorted, in elements [0, r) and returns their
// count.
template <int U>
__device__ int warp_flush(float* v, int* x, int r, int nk, int nb) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float bv[U];
  int bx[U], pp[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = 32 * u + lane;
    bv[u] = j < nb ? v[at(r + j)] : INFINITY;
    bx[u] = j < nb ? x[at(r + j)] : INT32_MAX;
  }
  warp_sort<U>(bv, bx);
#pragma unroll
  for (int u = 0; u < U; ++u) { v[at(r + 32 * u + lane)] = bv[u]; x[at(r + 32 * u + lane)] = bx[u]; }
  // each buffered key's place in the merged list: its rank plus the kept
  // keys below it, found while the kept list is intact
  count_less<U>(v, x, 0, nk, bv, bx, pp);
#pragma unroll
  for (int u = 0; u < U; ++u) pp[u] = 32 * u + lane < nb ? pp[u] + 32 * u + lane : r;
  __syncwarp();  // the sorted buffer is written, every search of the kept list done
  // kept keys below the smallest buffered key stay; the others move down
  // to index + (buffered keys below them), GROUP runs of 32 at a time from
  // the top, each group read before it is written, so every move lands on
  // a slot already read
  const int first = __shfl_sync(FULL, pp[0], 0);
  for (int top = (nk - 1) >> 5; top >= 0 && top >= first >> 5; top -= GROUP) {
    float kv[GROUP];
    int kx[GROUP], kp[GROUP];
#pragma unroll
    for (int m = 0; m < GROUP; ++m) {
      const int i = 32 * (top - m) + lane;
      const bool moves = i >= first && i < nk;  // false below run 0 too
      kv[m] = moves ? v[at(i)] : INFINITY;
      kx[m] = moves ? x[at(i)] : INT32_MAX;
    }
    count_less<GROUP>(v, x, r, nb, kv, kx, kp);
    __syncwarp();
#pragma unroll
    for (int m = 0; m < GROUP; ++m) {
      const int i = 32 * (top - m) + lane, p = i + kp[m];
      if (i >= first && i < nk && p < r) { v[at(p)] = kv[m]; x[at(p)] = kx[m]; }
    }
    __syncwarp();
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (pp[u] < r) { v[at(pp[u])] = bv[u]; x[at(pp[u])] = bx[u]; }
  __syncwarp();
  return min(r, nk + nb);
}

__device__ __forceinline__ int flush(float* v, int* x, int r, int B, int nk, int nb) {
  return B == 64 ? warp_flush<2>(v, x, r, nk, nb) : warp_flush<4>(v, x, r, nk, nb);
}

// The number of the nk sorted kept keys at or below t: the keys above it
// have r smaller ones elsewhere and can go. Called by the whole warp.
__device__ __forceinline__ int drop_above(const float* v, const int* x, int nk,
                                          unsigned long long t) {
  if (nk == 0 || pack_key(v[at(nk - 1)], x[at(nk - 1)]) <= t) return nk;  // warp-uniform
  int pos = 0;
  for (int s = 1 << (31 - __clz(nk)); s; s >>= 1)
    if (pos + s <= nk && pack_key(v[at(pos + s - 1)], x[at(pos + s - 1)]) <= t) pos += s;
  return pos;
}

// After a flush that left at least m kept keys: publish the query's m-th
// smallest key in this split's slot if it fell, take the largest slot (a
// bound once every split has published: S * m >= r keys lie at or below
// it), keep the smallest such bound in *bound, and lower t to it. Called
// by the whole warp.
__device__ void publish(const float* v, const int* x, int m, unsigned long long* mine,
                        unsigned long long* slots, int s, int S,
                        unsigned long long* bound, unsigned long long& t) {
  const int lane = threadIdx.x & 31;
  const unsigned long long key = pack_key(v[at(m - 1)], x[at(m - 1)]);
  if (key >= *mine) return;  // warp-uniform
  __syncwarp();
  if (lane == 0) {
    *mine = key;
    __stcg(reinterpret_cast<long long*>(slots + s), static_cast<long long>(key));
  }
  unsigned long long top = 0;
  for (int i = lane; i < S; i += 32) top = max(top, i == s ? key : load_l2(slots + i));
  for (int off = 16; off > 0; off >>= 1) top = max(top, __shfl_xor_sync(FULL, top, off));
  if (top == NONE) return;  // a split has not published yet
  if (lane == 0) atomicMin(bound, top);
  t = min(t, top);
}

template <int TQ, int ST>
__global__ void __launch_bounds__(THREADS)
k2_partial(const int8_t* __restrict__ q8, const float* __restrict__ s_q,
           const G8Shards sh, int Q, int N, int D, int r, int metric,
           float* __restrict__ part_v, int* __restrict__ part_i,
           unsigned long long* __restrict__ all_bounds) {
  constexpr int MT = TQ / 16;      // m16 tiles of a warp
  constexpr int NT = WN / 8;       // n8 tiles of a warp
  constexpr int QPW = TQ / WARPS;  // queries a warp selects for
  constexpr int STAGE = (TQ + TN) * LDW;
  extern __shared__ int smem[];
  float* ds = reinterpret_cast<float*>(smem + ST * STAGE);  // TQ x LDD scores
  const int B = buffer_len(r), C = list_words(r);
  float* sv = ds + TQ * LDD;                          // TQ x C  kept + buffer keys
  int* sx = reinterpret_cast<int*>(sv + TQ * C);      // TQ x C  their indices
  auto* slot = reinterpret_cast<unsigned long long*>(sx + TQ * C);  // TQ published keys
  int* n_kept = reinterpret_cast<int*>(slot + TQ);
  int* n_buf = n_kept + TQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const int runs = gridDim.y, run = blockIdx.y;  // a query's partial runs, this block's
  const int S = runs / sh.count, c = run / S, s = run % S;  // splits a shard; shard, split
  const int8_t* __restrict__ g8 = sh.g8[c];
  const float* __restrict__ g_scale = sh.scale[c];
  const float* __restrict__ g_sq = sh.sq[c];
  const int m = (r + S - 1) / S;  // the rank each split publishes
  // the shard's bounds: Q shared bounds, then (Q, S) slots
  unsigned long long* bounds = all_bounds + static_cast<size_t>(c) * Q * (S + 1);
  unsigned long long* slots = bounds + Q;
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = static_cast<int>(static_cast<long long>(n_tiles) * s / S);
  const int t_end = static_cast<int>(static_cast<long long>(n_tiles) * (s + 1) / S);
  const int kc = (D + DK - 1) / DK;  // chunks per tile
  const int total = (t_end - t_begin) * kc;

  if (tid < TQ) {
    slot[tid] = NONE;
    n_kept[tid] = 0; n_buf[tid] = 0;
  }

  // the next chunk to stage and the next to prefetch, as (tile, byte of D)
  int ld_t = t_begin, ld_d = 0, pf_t = t_begin, pf_d = 0;
  auto advance = [&](int& t, int& d) {
    if ((d += DK) >= D) { d = 0; ++t; }
  };
  auto load = [&](int c) {
    if (ld_t < t_end) {
      int* st = smem + (c % ST) * STAGE;
      stage_async(q8, q0, TQ, Q, D, ld_d, st);
      stage_async(g8, ld_t * TN, TN, N, D, ld_d, st + TQ * LDW);
      advance(ld_t, ld_d);
    }
    cp_async_commit();  // an empty group keeps the count in step
  };
  for (int c = 0; c < PREFETCH; ++c) advance(pf_t, pf_d);

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int c = 0; c < ST - 1; ++c) load(c);

  for (int c = 0; c < total; ++c) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1's stage is free
    load(c + ST - 1);
    if (pf_t < t_end) {  // each gallery row's line, PREFETCH chunks ahead
      const int row = pf_t * TN + tid;
      if (tid < TN && row < N)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(g8 + static_cast<size_t>(row) * D +
                                                       pf_d));
      // and the tile's scales and squared norms for its epilogue
      const int n = pf_t * TN + 32 * (tid & 3);
      if (pf_d == 0 && tid >= TN && tid < TN + 8 && n < N)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"((tid & 4 ? g_sq : g_scale) + n));
      advance(pf_t, pf_d);
    }
    const int* qs = smem + (c % ST) * STAGE;
    const int* gs = qs + TQ * LDW + (warp * WN + g) * LDW + tig;
#pragma unroll
    for (int kw = 0; kw < DK / 4; kw += 8) {
      int a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int* qa = qs + (i * 16 + g) * LDW + kw + tig;
        a[i][0] = qa[0];
        a[i][1] = qa[8 * LDW];
        a[i][2] = qa[4];
        a[i][3] = qa[8 * LDW + 4];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b[j][0] = gs[j * 8 * LDW + kw];
        b[j][1] = gs[j * 8 * LDW + kw + 4];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    if (c % kc != kc - 1) continue;

    // epilogue of the tile: scores to shared memory, then the selection.
    // Lane u < TQ/8 fetches the bound the splits share for the warp's
    // query u.
    const int n0 = (t_begin + c / kc) * TN;
    const int q_lane = q0 + warp * QPW + lane;
    const unsigned long long shared_bound =
        lane < QPW && q_lane < Q ? load_l2(bounds + q_lane) : NONE;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = warp * WN + j * 8 + 2 * tig;
      float gsc[2], gsq[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + col + e;
        gsc[e] = n < N ? g_scale[n] : 0.0f;
        gsq[e] = n < N ? g_sq[n] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = i * 16 + g + 8 * h, qi = q0 + row;
          const float sq = qi < Q ? s_q[qi] : 0.0f;
          float2 out;
          out.x = n0 + col < N ? approx_score(metric, sq, gsc[0], gsq[0], acc[i][j][2 * h])
                               : BIG;
          out.y = n0 + col + 1 < N
                      ? approx_score(metric, sq, gsc[1], gsq[1], acc[i][j][2 * h + 1])
                      : BIG;
          *reinterpret_cast<float2*>(ds + row * LDD + col) = out;
          acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0;
        }
    }
    __syncthreads();

    const unsigned below = (1u << lane) - 1;
#pragma unroll 1
    for (int u = 0; u < QPW; ++u) {
      const int qr = warp * QPW + u, qi = q0 + qr;
      if (qi >= Q) break;  // warp-uniform
      int nk = n_kept[qr], nb = n_buf[qr];
      float* v = sv + qr * C;
      int* x = sx + qr * C;
      unsigned long long t = __shfl_sync(FULL, shared_bound, u);
      if (nk == r) t = min(t, pack_key(v[at(r - 1)], x[at(r - 1)]));
      nk = drop_above(v, x, nk, t);
#pragma unroll 1
      for (int c0 = 0; c0 < TN; c0 += 32) {
        const int n = n0 + c0 + lane;
        const float sc = ds[qr * LDD + c0 + lane];
        const unsigned long long key = pack_key(sc, n);
        bool admit = n < N && key < t;
        unsigned adm = __ballot_sync(FULL, admit);
        if (!adm) continue;
        if (nb + __popc(adm) > B) {
          nk = flush(v, x, r, B, nk, nb);
          nb = 0;
          if (nk == r) t = min(t, pack_key(v[at(r - 1)], x[at(r - 1)]));
          if (nk >= m)
            publish(v, x, m, slot + qr, slots + static_cast<size_t>(qi) * S, s, S,
                    bounds + qi, t);
          nk = drop_above(v, x, nk, t);
          admit = admit && key < t;
          adm = __ballot_sync(FULL, admit);
        }
        if (admit) {
          const int a = at(r + nb + __popc(adm & below));
          v[a] = sc;
          x[a] = n;
        }
        nb += __popc(adm);
      }
      if (lane == 0) { n_kept[qr] = nk; n_buf[qr] = nb; }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the per-query counts, also where the split is empty

  // the split's sorted run of r, padded with (BIG, N)
#pragma unroll 1
  for (int u = 0; u < QPW; ++u) {
    const int qr = warp * QPW + u, qi = q0 + qr;
    if (qi >= Q) break;  // warp-uniform
    float* v = sv + qr * C;
    int* x = sx + qr * C;
    int nk = n_kept[qr];
    const int nb = n_buf[qr];
    if (nb) {
      nk = flush(v, x, r, B, nk, nb);
      unsigned long long t = NONE;
      if (nk >= m)
        publish(v, x, m, slot + qr, slots + static_cast<size_t>(qi) * S, s, S, bounds + qi,
                t);
    }
    const size_t o = (static_cast<size_t>(qi) * runs + run) * r;
    for (int j = lane; j < r; j += 32) {
      part_v[o + j] = j < nk ? v[at(j)] : BIG;
      part_i[o + j] = j < nk ? x[at(j)] : N;
    }
  }
}

// Sort P (a power of two) entries of shared memory ascending, by (value,
// index) or by index alone (bitonic; the indices are distinct, padding
// aside). Called by the whole block.
__device__ void sort_shared(float* cv, int* cx, int P, bool by_index) {
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += MERGE_THREADS) {
        const int i = 2 * t - (t & (j - 1)), p = i + j;
        const float a = cv[i], b = cv[p];
        const int xa = cx[i], xb = cx[p];
        if ((by_index ? xb < xa : key_less(b, xb, a, xa)) == ((i & k) == 0)) {
          cv[i] = b; cx[i] = xb;
          cv[p] = a; cx[p] = xa;
        }
      }
      __syncthreads();
    }
}

// The r best of a (query, shard)'s S sorted partial runs, one block each
// (grid Q x C). The entries at or below the shared bound hold the r best;
// where they fit in MERGE_CAP they are sorted in shared memory, else the
// runs are merged by a tournament. Ascending by (score, index), or with
// `by_index` in index order as global rows (r <= N: every slot holds a
// row). Outputs at (query * C + shard) * r; the certificate at shard * Q +
// query.
__global__ void __launch_bounds__(MERGE_THREADS)
k2_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
         int S, int r, int N, const G8Shards sh, int by_index,
         const unsigned long long* __restrict__ all_bounds,
         float* __restrict__ vals, int* __restrict__ idx, int* __restrict__ exact) {
  __shared__ float cv[MERGE_CAP];
  __shared__ int cx[MERGE_CAP];
  __shared__ int count;
  const int qi = blockIdx.x, c = blockIdx.y, C = gridDim.y, Q = gridDim.x, tid = threadIdx.x;
  const size_t M = static_cast<size_t>(S) * r;
  const float* pv = part_v + (static_cast<size_t>(qi) * C + c) * M;
  const int* pi = part_i + (static_cast<size_t>(qi) * C + c) * M;
  float* out_v = vals + (static_cast<size_t>(qi) * C + c) * r;
  int* out_i = idx + (static_cast<size_t>(qi) * C + c) * r;
  if (tid == 0) { exact[c * Q + qi] = 1; count = 0; }
  __syncthreads();
  const unsigned long long bound = all_bounds[static_cast<size_t>(c) * Q * (S + 1) + qi];
  if (bound != NONE)
    for (int run = tid; run < S; run += MERGE_THREADS) {
      const size_t o = static_cast<size_t>(run) * r;
      int len = 0;  // the run is sorted: its entries at or below the bound lead it
      while (len < r && pi[o + len] < N && pack_key(pv[o + len], pi[o + len]) <= bound) ++len;
      const int a = atomicAdd(&count, len);
      for (int j = 0; j < len && a + j < MERGE_CAP; ++j) {
        cv[a + j] = pv[o + j];
        cx[a + j] = pi[o + j];
      }
    }
  __syncthreads();
  const int n = count;
  if (bound == NONE || n > MERGE_CAP || n < r) {  // block-uniform
    topk::merge_runs<MERGE_THREADS, MERGE_HEADS>(pv, pi, S, r, r, r, N, out_v, out_i);
    if (!by_index) return;
    __syncthreads();  // thread 0 wrote the r best
    for (int j = tid; j < r; j += MERGE_THREADS) { cv[j] = out_v[j]; cx[j] = out_i[j]; }
  } else {
    int P = 1;
    while (P < n) P <<= 1;
    for (int i = n + tid; i < P; i += MERGE_THREADS) { cv[i] = INFINITY; cx[i] = INT32_MAX; }
    __syncthreads();
    sort_shared(cv, cx, P, false);
    if (!by_index) {
      for (int j = tid; j < r; j += MERGE_THREADS) { out_v[j] = cv[j]; out_i[j] = cx[j]; }
      return;
    }
  }
  // the r best (cv, cx)[0, r) in index order, as global rows
  int P = 1;
  while (P < r) P <<= 1;
  for (int i = r + tid; i < P; i += MERGE_THREADS) { cv[i] = INFINITY; cx[i] = INT32_MAX; }
  __syncthreads();
  sort_shared(cv, cx, P, true);
  const int first = sh.row0[c];
  for (int j = tid; j < r; j += MERGE_THREADS) { out_v[j] = cv[j]; out_i[j] = first + cx[j]; }
}

// Whether the first pass for 32 queries a block and a budget of r takes
// three stages: where two blocks still fit on an SM, or where two stages
// leave one block an SM anyway and three fit.
bool three_stages(int r) {
  return partial_smem<32, 3>(r) <= TWO_BLOCKS ||
         (partial_smem<32, 2>(r) > TWO_BLOCKS && partial_smem<32, 3>(r) <= ONE_BLOCK);
}

// Let k2_partial<TQ, ST> take the shared memory a budget of r needs.
template <int TQ, int ST>
cudaError_t allow_smem(int r) {
  return cudaFuncSetAttribute(k2_partial<TQ, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(partial_smem<TQ, ST>(r)));
}

// How many blocks of k2_partial<TQ, ST> fit on one SM of the current device
// at once for a budget of r (registers, threads and shared memory).
template <int TQ, int ST>
int occupancy(int r, int* blocks_per_sm) {
  const cudaError_t err = allow_smem<TQ, ST>(r);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k2_partial<TQ, ST>, THREADS, partial_smem<TQ, ST>(r)));
}

template <int TQ, int ST>
int launch_partial(const int8_t* q8, const float* s_q, const G8Shards& sh, int Q, int N, int D,
                   int r, int metric, int splits, float* part_v, int* part_i,
                   unsigned long long* bounds, cudaStream_t st) {
  const cudaError_t err = allow_smem<TQ, ST>(r);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + TQ - 1) / TQ, splits * sh.count);
  k2_partial<TQ, ST><<<grid, THREADS, partial_smem<TQ, ST>(r), st>>>(
      q8, s_q, sh, Q, N, D, r, metric, part_v, part_i, bounds);
  return static_cast<int>(cudaGetLastError());
}

// Both passes over the shards of `sh`, `splits` splits each.
int launch(const int8_t* q8, const float* s_q, const G8Shards& sh, int Q,
           int N, int D, int r, int metric, int splits, int by_index, float* part_v,
           int* part_i, unsigned long long* b, float* vals, int* idx, int* exact,
           cudaStream_t st) {
  const cudaError_t set = cudaMemsetAsync(
      b, 0xff, sizeof(*b) * sh.count * Q * (static_cast<size_t>(splits) + 1), st);
  if (set != cudaSuccess) return static_cast<int>(set);
  int err;
  if (r > TQ_WIDE)
    err = launch_partial<16, 3>(q8, s_q, sh, Q, N, D, r, metric, splits, part_v, part_i, b, st);
  else if (three_stages(r))
    err = launch_partial<32, 3>(q8, s_q, sh, Q, N, D, r, metric, splits, part_v, part_i, b, st);
  else
    err = launch_partial<32, 2>(q8, s_q, sh, Q, N, D, r, metric, splits, part_v, part_i, b, st);
  if (err != cudaSuccess) return err;
  k2_merge<<<dim3(Q, sh.count), MERGE_THREADS, 0, st>>>(part_v, part_i, splits, r, N, sh,
                                                        by_index, b, vals, idx, exact);
  return static_cast<int>(cudaGetLastError());
}

bool args_ok(int Q, int N, int D, int r, int splits) {
  return Q >= 1 && N >= 1 && D >= VEC && D % VEC == 0 && r >= 1 && r <= R_MAX && r <= N &&
         splits >= 1 && splits <= MERGE_HEADS * MERGE_THREADS;
}

}  // namespace

// The first pass's shape for a budget of r, 1 <= r <= 1024, on the current
// device: queries per block (*tq) and the blocks that fit on one SM at once
// (*blocks_per_sm), from which the wrapper sizes the gallery splits. Returns
// a CUDA error code.
extern "C" int k2_first_pass(int r, int* tq, int* blocks_per_sm) {
  if (r < 1 || r > R_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *tq = r <= TQ_WIDE ? 32 : 16;
  if (r > TQ_WIDE) return occupancy<16, 3>(r, blocks_per_sm);
  return three_stages(r) ? occupancy<32, 3>(r, blocks_per_sm)
                         : occupancy<32, 2>(r, blocks_per_sm);
}

// Plain C entry point (loaded with ctypes). Shapes: q8 (Q, D) int8, s_q (Q,),
// g8 (N, D) int8, g_scale (N,), g_sq (N,), float32 unless noted,
// contiguous, 16-byte aligned, D % 16 == 0, 1 <= r <= min(1024, N),
// 1 <= splits <= 1024. Scratch: part_v (Q, S, r), part_i (Q, S, r),
// bounds (Q * (S + 1),) 64-bit, set here. Outputs: vals (Q, r), idx (Q, r)
// int32, exact (Q,) int32. Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int k2_quant_candidates(
    const int8_t* q8, const float* s_q, const int8_t* g8, const float* g_scale,
    const float* g_sq, int Q, int N, int D, int r, int metric, int splits,
    float* part_v, int* part_i, void* bounds, float* vals, int* idx,
    int* exact, void* stream) {
  if (!args_ok(Q, N, D, r, splits)) return static_cast<int>(cudaErrorInvalidValue);
  G8Shards sh{};
  sh.g8[0] = g8;
  sh.scale[0] = g_scale;
  sh.sq[0] = g_sq;
  sh.count = 1;
  return launch(q8, s_q, sh, Q, N, D, r, metric, splits, 0, part_v, part_i,
                static_cast<unsigned long long*>(bounds), vals, idx, exact,
                static_cast<cudaStream_t>(stream));
}

// K2 over the `count` shards of one device, N rows each, `splits` splits
// each: g8[c] (N, D) int8, scale[c] and sq[c] (N,) float32 on the device
// (host arrays of pointers), row0[c] the shards' first global rows (a host
// array). Scratch: part_v, part_i (Q, count * splits, r), bounds
// (count * Q * (splits + 1),) 64-bit. Outputs vals, idx (Q, count, r),
// exact (count, Q): each shard's r best ascending by (score, index), or
// with by_index = 1 in index order as global rows. Other shapes as
// k2_quant_candidates'. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int k2_quant_candidates_shards(
    const int8_t* q8, const float* s_q, const void* const* g8, const void* const* scale,
    const void* const* sq, const int* row0, int count, int Q, int N, int D, int r, int metric,
    int splits, int by_index, float* part_v, int* part_i, void* bounds, float* vals, int* idx,
    int* exact, void* stream) {
  if (!args_ok(Q, N, D, r, splits) || count < 1 || count > MAX_SHARDS ||
      static_cast<long long>(count) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  G8Shards sh{};
  for (int c = 0; c < count; ++c) {
    sh.g8[c] = static_cast<const int8_t*>(g8[c]);
    sh.scale[c] = static_cast<const float*>(scale[c]);
    sh.sq[c] = static_cast<const float*>(sq[c]);
    sh.row0[c] = row0[c];
  }
  sh.count = count;
  return launch(q8, s_q, sh, Q, N, D, r, metric, splits, by_index, part_v, part_i,
                static_cast<unsigned long long*>(bounds), vals, idx, exact,
                static_cast<cudaStream_t>(stream));
}
