// K1's first pass, shared by K1 (fused_retrieval.cu) and its ablation probe
// P1 (fused_ablation.cu), so that each ablation level strips K1's own code
// and nothing else.
//
// sweep_partial<T, TQ, LEVEL>, grid (ceil(Q / TQ), C * S), 4 or 8 warps,
// over a table of C galleries of N rows each (Shards: one for K1 and P1,
// the shards of a row-sharded gallery that share a device for sharded K1),
// S splits each. Split s of gallery c owns a contiguous range of its
// 128-row tiles (TN); it writes run c * S + s of each query, with the
// gallery's global indices (its first row plus the local one) and an
// unfilled slot at the global sentinel. TQ, the queries
// of a block, is 8, 16, 32 or 64, chosen from Q (choose_tq), so that a
// block computes no more padded query rows than the smallest tile needs
// (K1 builds all four tiles; P1 only 32 and 64, the probe's).
// Above 64 queries the blocks of the query tiles over one split run
// together (the grid's fastest dimension), so the L2 serves their repeats.
//
// The stream. A ring of `stages` shared-memory stages (3 or 4 where three
// or two blocks share an SM, else 2 to 4 in one: choose_stages) is
// filled by 16-byte cp.async copies: each stage holds one 128-byte chunk
// (a cache line) of each of the TQ query rows and TN gallery rows, as the
// rows lie in device memory (32 float32 or 64 bf16 values), rows past Q or
// N and bytes past D zero-filled. The 16-byte unit u of staged row r lives
// at unit u ^ (r & 7), so eight consecutive rows read at the same unit fall
// on distinct banks: 16-byte shared reads without conflicts, and no padding.
// The L2 is asked for each gallery row's line a few chunks ahead of the
// copies. The gallery splits fill the card once (k1_first_pass reports
// the blocks an SM holds), so no block runs alone in a second wave.
//
// The products. The float32 form (FmaTile): each thread owns TQ / 8 (64
// queries: TQ / 16, over 8 warps) queries x 8 gallery rows and accumulates
// every q.g with float32 FMAs in one fixed order over D (d = 0, 1, ...,
// D-1), so a (q, g) pair's value does not depend on where the row or the
// query sits in a tile, and duplicated gallery rows tie exactly; the
// positive's distance (k1_positive) takes the same chain. The bf16 form
// (MmaTile): mma.sync m16n8k16 on the tensor cores, the gallery rows as the
// M side (16 an instruction) and the queries as N (8 an instruction; a
// tile of 8 for Q < 8), bf16 operands from the ring by ldmatrix, float32
// accumulators from 0 over the k16 steps of D in order. A product of two
// bf16 values is exact in float32, so the form differs from a float32 sum
// of the widened values only in the order and rounding of the sum inside
// an instruction, which is the hardware's; the positive's distance
// (k1_positive_bf16) runs the same instruction over the same steps, and a
// row's value is the same at every offset of a tile, as M or N operand
// (chip_smoke.py holds copies at every offset mod 128).
//
// The epilogue, in registers, after a tile's last chunk. Each accumulator
// becomes its distance in the TPU kernel's op order (column_distance); the
// rank hits are counted from it; and it is tested against its query's
// current k-th key (value, index), tau. The lanes that hold one query ballot
// their survivors into the query's buffer of 32 slots (one shared atomic
// per group of lanes). Then one warp a query sorts the buffer in registers
// and merges it with the query's sorted kept keys (merge path: output p
// takes the p-th smallest of the two lists), keeping the k smallest, and
// lowers tau. A key that finds the buffer full stays pending in a bit of
// its thread and is tested again, against the lowered tau, after the
// flush: on random rows only a split's first tile (all admitted) and the
// next few overflow, and a tile with no survivor costs one barrier. A
// query admits about k / t keys of its t-th tile.
//
// LEVEL 3 is K1. LEVELs 0-2 are the probe's stripped forms (the levels of
// `_ablate_kernel`, scripts/probe_fused_overhead.py:36):
//   0  the cross term only: one float32 sum per query and tile, to part_m
//      (n_tiles, Q), so the products cannot be optimised away
//   1  + the euclidean distances and the rank hits against d2pos, to part_r
//   2  + the count of distances <= 1e-6, added to part_r, and each lane's
//      running minimum of those distances, folded into the count times 0 as
//      the TPU level folds its `g1`
//   3  + the filtered running top-k (part_v, part_i); rank hits only when
//      with_ranks, against the positive's distance
// The distance is max(qq' + gg' - 2*cross, 0), or 1 - cross / max(qq*gg,
// 1e-8), and rank hits follow `_hit`: strictly closer, or an exact tie at a
// smaller index, never the positive's own column. Keys compare (value,
// index) with strict <, so the earlier column wins ties.

#pragma once

#include <cuda_bf16.h>

#include "async_copy.cuh"
#include "topk_select.cuh"

namespace k1 {

using topk::BIG;
using topk::FULL;
using topk::key_less;

constexpr int TN = 128;                // gallery rows per tile
constexpr int CHUNK = 128;             // bytes of a row in one stage: a cache line
constexpr int UNITS = CHUNK / 16;      // 16-byte units of a staged row
constexpr int BUF = 32;                // buffered keys a query: one word a lane
constexpr int PREFETCH = 3;            // chunks past the copies that the L2 is asked for
constexpr size_t SM_SMEM = 228 * 1024;  // shared memory of an SM

constexpr int MAX_SHARDS = 16;          // galleries of one launch

// The galleries a sweep reads: `count` of N rows each, gallery c holding
// the global rows [row0[c], row0[c] + N) (one gallery at row 0 when the
// gallery is not sharded). Passed by value as a kernel parameter.
template <typename T>
struct Shards {
  const T* g[MAX_SHARDS];       // (N, D) rows
  const float* gg[MAX_SHARDS];  // (N,) norms
  int row0[MAX_SHARDS];         // each one's first global row
  int count;
  int n_out;                    // the global sentinel index: the rows of every shard
};

template <typename T>
Shards<T> one_gallery(const T* g, const float* gg, int N) {
  Shards<T> sh{};
  sh.g[0] = g;
  sh.gg[0] = gg;
  sh.count = 1;
  sh.n_out = N;
  return sh;
}

// The queries of a block for Q queries: the smallest tile of at least
// min_tq that holds them, 64 beyond 32.
inline int choose_tq(int Q, int min_tq) {
  const int tq = Q <= 8 ? 8 : Q <= 16 ? 16 : Q <= 32 ? 32 : 64;
  return tq < min_tq ? min_tq : tq;
}

// Dynamic shared memory of sweep_partial: the ring, the per-query words
// (8, and one tile sum a warp), and at LEVEL 3 each query's kept keys (k)
// and buffer (BUF).
inline size_t sweep_smem(int tq, int warps, int k, int stages, bool topk) {
  return static_cast<size_t>(stages) * (tq + TN) * CHUNK +
         sizeof(float) * (8 + warps) * tq + (topk ? 8ull * tq * (k + BUF) : 0ull);
}

// Ring stages: the most (of 4 and 3) with which three blocks share an SM,
// else two, else the most (of 4, 3 and 2) that fit one block; 0 where not
// even two fit. An SM has 228 KB, of which a block reserves 1 KB.
inline int choose_stages(int tq, int warps, int k, bool topk) {
  for (int blocks = 3; blocks >= 1; --blocks)
    for (int st = 4; st >= (blocks == 1 ? 2 : 3); --st)
      if (sweep_smem(tq, warps, k, st, topk) <= SM_SMEM / blocks - 1024) return st;
  return 0;
}

// Staged row r's 16-byte unit u (swizzled, see the note above).
__device__ __forceinline__ int swz(int r, int u) { return r * UNITS + (u ^ (r & 7)); }

template <typename T> struct Elems;
template <> struct Elems<float> { static constexpr int N = 4; };          // a unit's values
template <> struct Elems<__nv_bfloat16> { static constexpr int N = 8; };

// Value e of a 16-byte unit of float32 values.
__device__ __forceinline__ float elem(const uint4& v, int e) {
  return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
}

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

// Start the copies of one chunk: bytes [d0, d0 + CHUNK) of query rows
// [q0, q0 + TQ) and gallery rows [n0, n0 + TN), into the stage `dst`
// (queries first). Rows past Q or N and bytes past D are zero-filled.
template <typename T, int TQ, int THREADS>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ q, int q0, int Q,
                                            const T* __restrict__ g, int n0, int N,
                                            int D, int d0, uint4* __restrict__ dst) {
  constexpr int V = Elems<T>::N;
  for (int e = threadIdx.x; e < (TQ + TN) * UNITS; e += THREADS) {
    const int r = e / UNITS, u = e % UNITS;
    const bool is_q = r < TQ;
    const int row = is_q ? q0 + r : n0 + r - TQ;
    const T* base = is_q ? q : g;
    const int dd = d0 + u * V;
    const bool in = row < (is_q ? Q : N) && dd < D;
    cp_async16(dst + swz(r, u), in ? base + static_cast<size_t>(row) * D + dd : base,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ void wait_ring(int stages) {  // chunk c has landed
  if (stages == 2) cp_async_wait<0>();
  else if (stages == 3) cp_async_wait<1>();
  else cp_async_wait<2>();
}

// The FMA tile (the float32 form): thread (tx, ty) owns queries ty + TY s
// and gallery rows tx + 16 j (j < 8), TY = 2 * WARPS query groups: 4 warps,
// 8 warps for 64 queries (4 x 8 a thread, and two warps a scheduler). A
// warp holds 4 query groups x 8 row groups, so its 16-byte reads touch 4
// query rows and 8 consecutive gallery rows: no bank conflicts after the
// swizzle.
template <int TQ>
struct FmaTile {
  static constexpr int WARPS = TQ == 64 ? 8 : 4;
  static constexpr int TY = 2 * WARPS;  // query groups
  static constexpr int NQ = TQ / TY;    // queries a thread holds
  static constexpr int NC = 8;          // gallery rows a thread holds
  float acc[NQ][NC];
  int tx, ty;

  __device__ FmaTile() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    tx = (warp & 1) * 8 + (lane & 7);
    ty = (warp >> 1) * 4 + (lane >> 3);
  }
  __device__ int query(int s) const { return ty + TY * s; }
  __device__ int col(int j) const { return tx + 16 * j; }
  __device__ float value(int s, int j) const { return acc[s][j]; }
  // the lanes of the warp that hold the same queries
  __device__ unsigned group() const { return 0xffu << (threadIdx.x & 24); }
  // sum over the lanes that hold the same queries; the first of them returns true
  __device__ bool reduce_cols(float& x) const {
    for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(FULL, x, off);
    return (threadIdx.x & 7) == 0;
  }
  __device__ void zero() {
#pragma unroll
    for (int s = 0; s < NQ; ++s)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[s][j] = 0.0f;
  }
  __device__ void multiply(const uint4* __restrict__ st) {  // float32 rows
    constexpr int V = Elems<float>::N;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      uint4 a[NQ], b[NC];
#pragma unroll
      for (int s = 0; s < NQ; ++s) a[s] = st[swz(query(s), u)];
#pragma unroll
      for (int j = 0; j < NC; ++j) b[j] = st[swz(TQ + col(j), u)];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float bv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) bv[j] = elem(b[j], e);
#pragma unroll
        for (int s = 0; s < NQ; ++s) {
          const float av = elem(a[s], e);
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[s][j] = fmaf(av, bv[j], acc[s][j]);
        }
      }
    }
  }
};

// bf16 products on the tensor cores.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const uint4* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const uint4* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
// c += a . b over one 16 x 8 x 16 bf16 tile (a row-major, b column-major),
// float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor-core tile of the bf16 form: warp w owns gallery rows
// [32 w, 32 w + 32) (two m16 tiles, the M side) against all TQ queries
// (TQ / 8 n8 tiles, the N side), and runs mma.sync m16n8k16 on bf16
// operands with float32 accumulators, four k16 steps a chunk in order over
// D. Fragments come from the ring by ldmatrix: eight consecutive staged
// rows at one 16-byte unit each, conflict-free after the swizzle. Lane
// (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of each m16 tile
// against queries 2t and 2t + 1 of each n8 tile. The summation inside one
// instruction is the hardware's; a row's value does not depend on where it
// sits in the tile (chip_smoke.py holds copies at every offset).
template <int TQ>
struct MmaTile {
  static constexpr int WARPS = 4;
  static constexpr int MT = 2;       // m16 tiles of a warp
  static constexpr int NT = TQ / 8;  // n8 tiles
  static constexpr int NQ = 2 * NT;  // queries a thread holds
  static constexpr int NC = 2 * MT;  // gallery rows a thread holds
  float acc[MT][NT][4];
  int lane, warp;

  __device__ MmaTile() : lane(threadIdx.x & 31), warp(threadIdx.x >> 5) {}
  __device__ int query(int s) const { return (s >> 1) * 8 + 2 * (lane & 3) + (s & 1); }
  __device__ int col(int j) const { return warp * 32 + (j >> 1) * 16 + (lane >> 2) + 8 * (j & 1); }
  __device__ float value(int s, int j) const { return acc[j >> 1][s >> 1][(j & 1) * 2 + (s & 1)]; }
  __device__ unsigned group() const { return 0x11111111u << (lane & 3); }
  __device__ bool reduce_cols(float& x) const {
    for (int off = 4; off < 32; off <<= 1) x += __shfl_xor_sync(FULL, x, off);
    return lane < 4;
  }
  __device__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  }
  __device__ void multiply(const uint4* __restrict__ st) {  // bf16 rows
#pragma unroll
    for (int ks = 0; ks < UNITS / 2; ++ks) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)  // rows 0-7 and 8-15, values 0-7 and 8-15
        ldmatrix_x4(a[mt], st + swz(TQ + warp * 32 + mt * 16 + (lane & 7) + (lane & 8),
                                    2 * ks + (lane >> 4)));
      if constexpr (NT == 1) {
        ldmatrix_x2(b[0], st + swz(lane & 7, 2 * ks + ((lane >> 3) & 1)));
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {  // queries 0-7 and 8-15 of a pair of n8 tiles
          unsigned r[4];
          ldmatrix_x4(r, st + swz(p * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * ks + ((lane >> 3) & 1)));
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
};

template <typename T, int TQ> struct TileOf { using type = FmaTile<TQ>; };
template <int TQ> struct TileOf<__nv_bfloat16, TQ> { using type = MmaTile<TQ>; };

// The per-query state of a block in shared memory.
struct Block {
  float* tau_v;  // TQ: the k-th kept key, or (BIG, -1) while fewer are kept
  int* tau_i;
  int* nk;       // TQ: kept keys
  int* nb;       // TQ: buffered keys
  int* hits;     // TQ: rank hits
  float* qq;     // TQ: query norms
  float* d2p;    // TQ: the positive's distance
  int* pos;      // TQ: the positive's column
  float* sums;   // WARPS x TQ: LEVEL 0's tile sums, one row a warp
  float* kv;     // TQ x k: kept keys, ascending
  int* ki;
  float* bv;     // TQ x BUF: buffered keys, unsorted
  int* bi;
};

// Append the lanes' admitted keys to their queries' buffers: one ballot,
// one shared atomic per group of lanes that hold the same query. Called by
// the whole warp. Returns false for an admitted key that found the buffer
// full (the count still grows, and the flush takes the first BUF), else
// true.
__device__ __forceinline__ bool append(bool admit, int qr, float v, int n, unsigned group,
                                       const Block& b) {
  const unsigned ball = __ballot_sync(FULL, admit);
  if (!ball) return true;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const unsigned m = ball & group;
  const int leader = m ? __ffs(m) - 1 : lane;
  int base = 0;
  if (m && lane == leader) base = atomicAdd(b.nb + qr, __popc(m));
  base = __shfl_sync(FULL, base, leader);
  const int slot = base + __popc(m & ((1u << lane) - 1));
  if (!admit || slot >= BUF) return !admit;
  b.bv[qr * BUF + slot] = v;
  b.bi[qr * BUF + slot] = n;
  return true;
}

// One warp folds query qr's buffered keys (the first BUF of its count)
// into its kept keys, keeping the k smallest, and lowers its tau.
__device__ void flush_query(const Block& b, int qr, int k) {
  const int lane = threadIdx.x & 31;
  const int nb = min(b.nb[qr], BUF), nk = b.nk[qr];
  float* bv = b.bv + qr * BUF;
  int* bi = b.bi + qr * BUF;
  const float* kv = b.kv + qr * k;
  const int* ki = b.ki + qr * k;
  float v[1] = {lane < nb ? bv[lane] : INFINITY};
  int x[1] = {lane < nb ? bi[lane] : INT32_MAX};
  topk::warp_sort<1>(v, x);
  __syncwarp();
  if (lane < nb) { bv[lane] = v[0]; bi[lane] = x[0]; }
  __syncwarp();
  // merge path: output p takes i kept and p - i buffered keys, i the
  // smallest with kept[i] not before buffered[p - 1 - i]
  const int out = min(k, nk + nb);
  float ov[4];
  int ox[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int p = 32 * u + lane;
    if (p < out) {
      int lo = max(0, p - nb), hi = min(p, nk);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_less(kv[mid], ki[mid], bv[p - 1 - mid], bi[p - 1 - mid])) lo = mid + 1;
        else hi = mid;
      }
      const int j = p - lo;
      const bool kept = lo < nk && (j >= nb || key_less(kv[lo], ki[lo], bv[j], bi[j]));
      ov[u] = kept ? kv[lo] : bv[j];
      ox[u] = kept ? ki[lo] : bi[j];
    }
  }
  __syncwarp();  // every search has read the kept keys
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int p = 32 * u + lane;
    if (p < out) {
      b.kv[qr * k + p] = ov[u];
      b.ki[qr * k + p] = ox[u];
      if (p == k - 1) { b.tau_v[qr] = ov[u]; b.tau_i[qr] = ox[u]; }
    }
  }
  if (lane == 0) { b.nk[qr] = out; b.nb[qr] = 0; }
  __syncwarp();
}

// TABLE: whether the galleries come from the table (the shards of a
// device); without it the one gallery at row 0 is read as plain kernel
// parameters, which is K1's and P1's code as it was before the table.
template <typename T, int TQ, int LEVEL, bool TABLE>
__global__ void __launch_bounds__(32 * TileOf<T, TQ>::type::WARPS, 2)
sweep_partial(const T* __restrict__ q, const float* __restrict__ qq,
              const int* __restrict__ pos, const Shards<T> sh,
              const float* __restrict__ d2pos, int Q, int N, int D, int k, int metric,
              int with_ranks, int stages, float* __restrict__ part_v,
              int* __restrict__ part_i, int* __restrict__ part_r,
              float* __restrict__ part_m) {
  using Tile = typename TileOf<T, TQ>::type;
  constexpr int WARPS = Tile::WARPS, THREADS = 32 * WARPS;
  constexpr int STAGE = (TQ + TN) * UNITS;  // uint4 of a stage
  constexpr int DK = UNITS * Elems<T>::N;   // values of a row in a chunk
  extern __shared__ uint4 smem[];
  Block b;
  b.tau_v = reinterpret_cast<float*>(smem + stages * STAGE);
  b.tau_i = reinterpret_cast<int*>(b.tau_v + TQ);
  b.nk = b.tau_i + TQ;
  b.nb = b.nk + TQ;
  b.hits = b.nb + TQ;
  b.qq = reinterpret_cast<float*>(b.hits + TQ);
  b.d2p = b.qq + TQ;
  b.pos = reinterpret_cast<int*>(b.d2p + TQ);
  b.sums = reinterpret_cast<float*>(b.pos + TQ);
  b.kv = b.sums + WARPS * TQ;
  b.ki = reinterpret_cast<int*>(b.kv + TQ * k);
  b.bv = reinterpret_cast<float*>(b.ki + TQ * k);
  b.bi = reinterpret_cast<int*>(b.bv + TQ * BUF);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int S = TABLE ? gridDim.y / sh.count : gridDim.y;  // splits a gallery
  const int s = TABLE ? blockIdx.y % S : blockIdx.y;       // this block's split
  // With the table, this block's gallery is read back from shared memory
  // where it is used: a pointer picked by a register index would otherwise
  // hold registers through the products (the FMA tile of 64 queries spills
  // at its 128). Its first row is looked up where it is used.
  __shared__ const T* block_g;
  __shared__ const float* block_gg;
  if (TABLE && tid == 0) {
    block_g = sh.g[blockIdx.y / S];
    block_gg = sh.gg[blockIdx.y / S];
  }
  auto gallery = [&]() -> const T* {
    if constexpr (TABLE) return block_g;
    return sh.g[0];
  };
  auto norms = [&]() -> const float* {
    if constexpr (TABLE) return block_gg;
    return sh.gg[0];
  };
  auto first_row = [&]() -> int {
    if constexpr (TABLE) return sh.row0[blockIdx.y / S];
    return 0;
  };
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = static_cast<int>(static_cast<long long>(n_tiles) * s / S);
  const int t_end = static_cast<int>(static_cast<long long>(n_tiles) * (s + 1) / S);
  const bool ranks = LEVEL < 3 || with_ranks;
  const int kc = (D + DK - 1) / DK;  // chunks a tile
  const int total = (t_end - t_begin) * kc;

  for (int e = tid; e < TQ; e += THREADS) {
    const int qi = q0 + e;
    b.tau_v[e] = BIG;  // admits every value below the sentinel
    b.tau_i[e] = -1;
    b.nk[e] = b.nb[e] = b.hits[e] = 0;
    b.qq[e] = qi < Q ? qq[qi] : 0.0f;
    b.d2p[e] = ranks && qi < Q ? d2pos[qi] : 0.0f;
    // the positive's column in this gallery (with the table: -1 before
    // it, N after it)
    b.pos[e] = ranks && qi < Q ? (TABLE ? min(max(pos[qi] - first_row(), -1), N) : pos[qi]) : -1;
  }
  for (int e = tid; e < WARPS * TQ; e += THREADS) b.sums[e] = 0.0f;
  if constexpr (TABLE) __syncthreads();  // block_g

  // the next chunk to copy and the next to prefetch, as (tile, value of D)
  int ld_t = t_begin, ld_d = 0, pf_t = t_begin, pf_d = 0;
  auto advance = [&](int& t, int& d) {
    if ((d += DK) >= D) { d = 0; ++t; }
  };
  auto load = [&](int c) {
    if (ld_t < t_end) {
      stage_chunk<T, TQ, THREADS>(q, q0, Q, gallery(), ld_t * TN, N, D, ld_d,
                                  smem + (c % stages) * STAGE);
      advance(ld_t, ld_d);
    }
    cp_async_commit();  // an empty group keeps the count in step
  };
  for (int c = 0; c < stages - 1 + PREFETCH; ++c) advance(pf_t, pf_d);
  for (int c = 0; c < stages - 1; ++c) load(c);

  Tile tile;
  tile.zero();
  int hits[Tile::NQ];
#pragma unroll
  for (int i = 0; i < Tile::NQ; ++i) hits[i] = 0;
  float g1 = BIG;  // LEVEL 2: the lane's running minimum of the near columns

  for (int c = 0; c < total; ++c) {
    wait_ring(stages);
    __syncthreads();  // chunk c has landed; chunk c - 1's stage is free
    load(c + stages - 1);
    if (pf_t < t_end) {  // each gallery row's line, PREFETCH chunks past the copies
      const int row = pf_t * TN + tid;
      if (tid < TN && row < N)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gallery() + static_cast<size_t>(row) * D + pf_d));
      advance(pf_t, pf_d);
    }
    tile.multiply(smem + (c % stages) * STAGE);
    if (c % kc != kc - 1) continue;

    // the tile's epilogue, from the accumulators
    const int t = t_begin + c / kc, n0 = t * TN;
    if constexpr (LEVEL == 0) {
#pragma unroll
      for (int i = 0; i < Tile::NQ; ++i) {
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < Tile::NC; ++j) sum += tile.value(i, j);
        if (tile.reduce_cols(sum)) b.sums[warp * TQ + tile.query(i)] = sum;
      }
      __syncthreads();
      for (int qr = tid; qr < TQ; qr += THREADS) {
        float sum = 0.0f;
        for (int w = 0; w < WARPS; ++w) sum += b.sums[w * TQ + qr];
        if (q0 + qr < Q) part_m[static_cast<size_t>(t) * Q + q0 + qr] = sum;
      }
    } else {
      float gv[Tile::NC];
#pragma unroll
      for (int j = 0; j < Tile::NC; ++j) {
        const int n = n0 + tile.col(j);
        gv[j] = n < N ? __ldg(norms() + n) : 0.0f;
      }
      // one pass: distances, rank hits and the filter; an admitted key
      // that finds its query's buffer full stays pending
      bool appended = false;
      unsigned long long pending = 0;  // bit i * NC + j
#pragma unroll
      for (int i = 0; i < Tile::NQ; ++i) {
        const int qr = tile.query(i), qi = q0 + qr;
        const float qv = b.qq[qr], d2p = b.d2p[qr];
        const int pq = b.pos[qr];
        float tv = BIG;
        int ti = -1;
        if constexpr (LEVEL == 3) { tv = b.tau_v[qr]; ti = b.tau_i[qr]; }
#pragma unroll
        for (int j = 0; j < Tile::NC; ++j) {
          const int n = n0 + tile.col(j);
          const bool valid = qi < Q && n < N;
          const float v = column_distance(metric, qv, gv[j], tile.value(i, j));
          if (ranks)
            hits[i] += valid && v < BIG && n != pq && (v < d2p || (v == d2p && n < pq));
          if constexpr (LEVEL == 2) {
            const bool near = valid && v <= 1e-6f;
            hits[i] += near;
            g1 = near && v < g1 ? v : g1;
          }
          if constexpr (LEVEL == 3) {
            const bool admit = valid && key_less(v, n, tv, ti);
            appended |= admit;
            if (!append(admit, qr, v, n, tile.group(), b))  // the whole warp calls it
              pending |= 1ull << (i * Tile::NC + j);
          }
        }
      }
      if constexpr (LEVEL == 3) {
        // flush the buffers; retry the pending keys against the lowered
        // taus, until none is left (only a split's first tiles overflow)
        while (__syncthreads_or(appended || pending != 0)) {  // every buffer is written
          for (int qr = warp; qr < TQ; qr += WARPS)
            if (b.nb[qr]) flush_query(b, qr, k);  // warp-uniform
          __syncthreads();  // the new keys and taus
          appended = false;
          if (!__any_sync(FULL, pending != 0)) continue;  // warp-uniform
#pragma unroll
          for (int i = 0; i < Tile::NQ; ++i) {
            const int qr = tile.query(i);
            const float tv = b.tau_v[qr], qv = b.qq[qr];
            const int ti = b.tau_i[qr];
#pragma unroll
            for (int j = 0; j < Tile::NC; ++j) {
              const unsigned long long bit = 1ull << (i * Tile::NC + j);
              const int n = n0 + tile.col(j);
              const float v = column_distance(metric, qv, gv[j], tile.value(i, j));
              const bool admit = (pending & bit) && key_less(v, n, tv, ti);
              pending &= ~bit;
              appended |= admit;
              if (!append(admit, qr, v, n, tile.group(), b)) pending |= bit;
            }
          }
        }
      }
    }
    tile.zero();
  }
  cp_async_wait<0>();

  if constexpr (LEVEL >= 1) {
    // the TPU level folds its running minimum into the count times 0, so
    // that the bookkeeping is kept; a float product is not folded away
    // without fast math, and NaN or 0 converts to 0
    if constexpr (LEVEL == 2) hits[0] += __float2int_rz(g1 * 0.0f);
#pragma unroll
    for (int i = 0; i < Tile::NQ; ++i)
      if (hits[i]) atomicAdd(b.hits + tile.query(i), hits[i]);
  }
  __syncthreads();
  if constexpr (LEVEL == 3) {
    const int row0 = first_row();
    for (int e = tid; e < TQ * k; e += THREADS) {
      const int qr = e / k, j = e % k, qi = q0 + qr;
      if (qi < Q) {
        const size_t o = (static_cast<size_t>(qi) * gridDim.y + blockIdx.y) * k + j;
        const bool kept = j < b.nk[qr];
        part_v[o] = kept ? b.kv[e] : BIG;
        part_i[o] = kept ? row0 + b.ki[e] : sh.n_out;
      }
    }
  }
  if constexpr (LEVEL >= 1)
    for (int qr = tid; qr < TQ; qr += THREADS)
      if (q0 + qr < Q) part_r[static_cast<size_t>(q0 + qr) * gridDim.y + blockIdx.y] = b.hits[qr];
}

// Let sweep_partial<T, TQ, LEVEL> take the shared memory it needs for a
// top-k of k (0 below LEVEL 3) with `stages` stages, and report how many of
// its blocks fit on an SM of the current device (blocks_per_sm may be null).
template <typename T, int TQ>
constexpr int warps_of = TileOf<T, TQ>::type::WARPS;

template <typename T, int TQ, int LEVEL, bool TABLE>
cudaError_t prepare(int k, int stages, int* blocks_per_sm) {
  const auto kernel = sweep_partial<T, TQ, LEVEL, TABLE>;
  const size_t smem = sweep_smem(TQ, warps_of<T, TQ>, k, stages, LEVEL == 3);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess || !blocks_per_sm) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       32 * warps_of<T, TQ>, smem);
}

template <typename T, int TQ, int LEVEL, bool TABLE>
cudaError_t launch_sweep(const T* q, const float* qq, const int* pos, const Shards<T>& sh,
                         const float* d2pos, int Q, int N, int D, int k, int metric,
                         int with_ranks, int splits, float* part_v, int* part_i,
                         int* part_r, float* part_m, cudaStream_t st) {
  constexpr int WARPS = warps_of<T, TQ>;
  const int stages = choose_stages(TQ, WARPS, k, LEVEL == 3);
  if (!stages) return cudaErrorInvalidConfiguration;
  const cudaError_t err = prepare<T, TQ, LEVEL, TABLE>(k, stages, nullptr);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + TQ - 1) / TQ, splits * sh.count);
  const size_t smem = sweep_smem(TQ, WARPS, k, stages, LEVEL == 3);
  sweep_partial<T, TQ, LEVEL, TABLE><<<grid, 32 * WARPS, smem, st>>>(
      q, qq, pos, sh, d2pos, Q, N, D, k, metric, with_ranks, stages, part_v, part_i,
      part_r, part_m);
  return cudaGetLastError();
}

template <typename T, int TQ, int LEVEL>
cudaError_t occupancy(int k, int* blocks_per_sm) {
  const int stages = choose_stages(TQ, warps_of<T, TQ>, k, LEVEL == 3);
  if (!stages) return cudaErrorInvalidConfiguration;
  return prepare<T, TQ, LEVEL, false>(k, stages, blocks_per_sm);
}

// The first pass's shape for Q queries and a top-k of k (0 below LEVEL 3)
// on the current device: queries a block (*tq), gallery rows a tile (*tn)
// and blocks that fit on an SM at once (*blocks_per_sm). Query tiles below
// MIN_TQ (8, 16 or 32) are not instantiated: Q takes the tile of MIN_TQ.
template <typename T, int LEVEL, int MIN_TQ>
cudaError_t first_pass(int Q, int k, int* tq, int* tn, int* blocks_per_sm) {
  *tq = choose_tq(Q, MIN_TQ);
  *tn = TN;
  if constexpr (MIN_TQ <= 8)
    if (*tq == 8) return occupancy<T, 8, LEVEL>(k, blocks_per_sm);
  if constexpr (MIN_TQ <= 16)
    if (*tq == 16) return occupancy<T, 16, LEVEL>(k, blocks_per_sm);
  if (*tq == 32) return occupancy<T, 32, LEVEL>(k, blocks_per_sm);
  return occupancy<T, 64, LEVEL>(k, blocks_per_sm);
}

// The first pass on the query tile chosen for Q (see first_pass), over the
// galleries of `sh` (from the table where TABLE), `splits` splits each.
template <typename T, int LEVEL, int MIN_TQ, bool TABLE>
cudaError_t sweep_tiles(const T* q, const float* qq, const int* pos, const Shards<T>& sh,
                        const float* d2pos, int Q, int N, int D, int k, int metric,
                        int with_ranks, int splits, float* part_v, int* part_i,
                        int* part_r, float* part_m, cudaStream_t st) {
#define K1_SWEEP(TQ)                                                                         \
  launch_sweep<T, TQ, LEVEL, TABLE>(q, qq, pos, sh, d2pos, Q, N, D, k, metric, with_ranks, \
                                    splits, part_v, part_i, part_r, part_m, st)
  const int tq = choose_tq(Q, MIN_TQ);
  if constexpr (MIN_TQ <= 8)
    if (tq == 8) return K1_SWEEP(8);
  if constexpr (MIN_TQ <= 16)
    if (tq == 16) return K1_SWEEP(16);
  if (tq == 32) return K1_SWEEP(32);
  return K1_SWEEP(64);
#undef K1_SWEEP
}

// The first pass over the galleries of the table `sh`.
template <typename T, int LEVEL, int MIN_TQ>
cudaError_t sweep_shards(const T* q, const float* qq, const int* pos, const Shards<T>& sh,
                         const float* d2pos, int Q, int N, int D, int k, int metric,
                         int with_ranks, int splits, float* part_v, int* part_i,
                         int* part_r, float* part_m, cudaStream_t st) {
  return sweep_tiles<T, LEVEL, MIN_TQ, true>(q, qq, pos, sh, d2pos, Q, N, D, k, metric,
                                             with_ranks, splits, part_v, part_i, part_r,
                                             part_m, st);
}

// The first pass over one gallery of N rows.
template <typename T, int LEVEL, int MIN_TQ>
cudaError_t sweep(const T* q, const float* qq, const int* pos, const T* g, const float* gg,
                  const float* d2pos, int Q, int N, int D, int k, int metric,
                  int with_ranks, int splits, float* part_v, int* part_i, int* part_r,
                  float* part_m, cudaStream_t st) {
  return sweep_tiles<T, LEVEL, MIN_TQ, false>(q, qq, pos, one_gallery(g, gg, N), d2pos, Q, N,
                                              D, k, metric, with_ranks, splits, part_v,
                                              part_i, part_r, part_m, st);
}

}  // namespace k1
