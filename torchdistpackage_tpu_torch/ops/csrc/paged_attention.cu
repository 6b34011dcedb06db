// Paged attention for Hopper (sm_90a): the query rows of each slot attend
// against that slot's KV, walking its block table inside the kernel.
//
// Two TPU kernels of torchdistpackage_tpu/ops/paged_attention.py share
// this file and its two kernel bodies:
//   K1  paged_decode_attention (:214, body `_kernel` :136): acc / l in q's
//       dtype, over the whole pool;
//   K2  paged_carry_attention (:509, body `_cp_kernel` :332): one hop of
//       the context-parallel ring over ONE rank's pool slice, reached
//       through a table re-based by the slice's first block; it returns
//       the raw online-softmax carry (acc [R, hd], m [R], l [R] per (slot,
//       KV head), f32), seeded from the incoming carry, and the ring
//       divides acc / l once at the end.
// Each body is one template; K1 and K2 are its CARRY = false / true
// instantiations, and differ only in the carry in and out, in skipping
// another rank's blocks (a re-based entry outside [0, nb)), and in K1's
// final acc / l.  Both serve every serving shape: S_in = 1 (decode),
// S_in = chunk (chunked prefill), GQA (query heads grouped per KV head,
// group-major rows r = g*S_in + s), a sliding window, and (K1 only) int8
// pools whose per-vector f32 scales fold into the scores (k) and the
// probabilities (v).
//
// What bounds them on an H100 depends on the shape.
// - Decode rows (R = G * S_in <= DEC_ROWS = 16 rows a (slot, KV head):
//   decode, and small multi-row steps such as a 3-token verify) are
//   bound by bytes: each slot's live KV is read once (bf16: 2 *
//   live_tokens * Hkv * hd * 2 bytes a layer) at 3.35 TB/s, for one or
//   two operations a byte.  One CTA a (slot, KV head) walking the slot's
//   whole context (64 CTAs for 132 SMs at B 8 x Hkv 8) lasts as long as
//   the longest slot's walk, whatever the total bytes; so they run
//   split-KV (flash-decoding).  The grid is (B * Hkv, nsplit): CTA s
//   takes the s-th of nsplit near-equal shares of its slot's visible
//   blocks (`split_share`), so a long slot is spread over many SMs and
//   a short one costs little.  The host picks nsplit from B * Hkv, the
//   table width and the SM count alone (`decode_splits` in
//   ops/paged_attention.py: about four CTAs an SM — two waves of the
//   two that fit — and no split cut below 4 blocks), never from the
//   offsets, so the step reads nothing back and a CUDA graph can hold
//   it.  On bf16 pools (`paged_split_kernel`) the R rows are one m16
//   tile that every warp holds as mma A fragments; the share's blocks
//   stream through a ring of 3 cp.async stages of 4 blocks (one a warp; K2:
//   the next 4 blocks it owns), rows padded for conflict-free ldmatrix;
//   each warp runs S = Q K^T, the online softmax on the accumulator
//   fragments and O += P V on mma.sync m16n8k16 over its blocks, and the
//   4 warps' states merge in warp order.  Up to DECODE_ORDER_MAX_SLOTS
//   (128) slots the grid hands its items out longest slot first
//   (`decode_item`); above, each CTA's ranking of the slots costs more
//   than the shorter tail saves.  f32 and int8 pools keep the walk's
//   CUDA-core arithmetic (`paged_walk_kernel`) on the same grid.
//   Each split writes its raw state (acc, m, l; f32) to a workspace the
//   wrapper takes from PyTorch's caching allocator; `paged_merge_kernel`
//   merges a row's partials in split order after K2's incoming carry,
//   which enters there exactly once.  No atomics: the output is the
//   same bits run to run, and K1 and K2 take one plan and one order, so
//   K2 at cp 1, finished, equals K1 bit for bit.  Measured on an NVIDIA
//   H100 80GB HBM3 at 700 W (chip_smoke.py's kernel phase): B 8, G 4,
//   Hkv 8, hd 128, contexts up to 4608 under a window of 4096, 0.036 ms
//   replayed from a CUDA graph, 0.49 of the 0.0178 ms byte bound (0.042
//   in the grid's own order); launched eagerly 0.04-0.09 ms, which is
//   the wrapper's host time (the walk took 0.2024 eagerly, SDPA 0.207);
//   4 slots of up to 32768 positions without a window, 0.131 ms from a
//   graph and 0.135 eagerly (bound 0.100; SDPA 0.69).  What holds the
//   device time at 0.49 of the bound at 4096: each CTA's fixed cost (the
//   first stage's latency, the merge of the warps) against a share of a
//   few stages, the ramp and the tail of a grid of ~4 CTAs an SM, and
//   the merge's second launch.
// - A prefill chunk (R = G * chunk rows) is bound by operations: 4 * hd
//   FLOP a visible (row, key) pair, ~167 GFLOP a layer for 8 slots of
//   512 rows at Mistral's widths — 0.17 ms at the tensor cores' 989
//   TFLOP/s.  With bf16 pools it runs on the tensor cores
//   (`paged_tc_kernel`): a CTA owns 64 query rows of one (slot, KV head),
//   16 a warp, Q held as mma A fragments in registers; the key side is
//   walked in tiles of 4 pool blocks (64 keys) through the table, with a
//   cp.async double buffer of padded rows that ldmatrix reads without
//   bank conflicts; S = Q K^T and O += P V are mma.sync m16n8k16 (bf16
//   in, f32 accumulate); the online softmax runs on the accumulator
//   fragments (row max and sum over the quad), and P is re-packed in
//   registers as the bf16 A fragment of P V (no shared-memory round
//   trip).  Only a tile that crosses the causal diagonal, the window edge
//   or the table's end builds per-element masks.  K2 packs each tile
//   with the next 4 OWNED blocks of the range, so a hop over a quarter
//   slice does a quarter of the products and a tile never holds another
//   rank's block.  What bounds it now (~1.0 ms for that chunk on an H100
//   80GB HBM3 at 700 W, about a sixth of the dense bf16 rate): mma.sync
//   rather than wgmma with TMA and a warp-specialised pipeline (later
//   work), and each KV block read again from L2 by every 64-row tile.
// - f32 pools (checks hold f32 within 2e-5, which TF32 cannot give) and
//   int8 pools (the reference keeps int8 p * v_scale in f32) take the
//   walk on the CUDA cores: in split mode (R <= 4) every warp holds all
//   rows and takes a quarter of each stage's blocks; in row mode a warp
//   takes one query row at a time, 16 rows a CTA.
//
// Grid: (B * Hkv, nsplit) for decode rows, then (B * Hkv, R) for the
// merge; (B * Hkv, ceil(R / 64)) for prefill rows on the tensor cores,
// deep row tiles first; (B * Hkv, ceil(R / 16)) for the walk's prefill
// row mode.  The scalar-prefetched block table of the TPU kernels
// becomes a load of tables[b, j] per copied block; their v5e tuning knobs
// (fetch_width, q_pad_to) have no counterpart here.
//
// Shared by both kernels and both bodies, as the TPU kernels do:
// - a finite NEG_INF; a masked key adds exactly 0 to l and acc, so a row
//   that has met no (owned) key keeps (0, NEG_INF, 0) — K2 returns such a
//   row as it came in, K1 writes 0 for it (a padded row past the table);
//   a merge skips such a state (a split that owns no block adds nothing);
// - P is rounded to the pool dtype before P V (`_cp_kernel` :394,
//   `_kernel` likewise), and l sums the unrounded P;
// - per-CTA block bounds: causal above (the block of the CTA's last
//   position), the window below (the first block its earliest row sees).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_counts.cuh"

// A check's variants of this file plant one fault each (1: one split's
// partial dropped by the merge; 2: a split boundary one block late; 3:
// K2's carry seeded in every split instead of once in the merge; 4: the
// merge scaling each split by the next split's m); 0 builds the kernels.
#ifndef TDP_PAGED_FAULT
#define TDP_PAGED_FAULT 0
#endif

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int DEC_ROWS = 16;        // decode rows: R <= one m16 tile
constexpr int RPW = 4;              // rows per warp in the walk
constexpr int ROWS = NWARPS * RPW;  // rows per CTA in the walk's row mode
constexpr int BS = 16;              // pool block size (positions)
constexpr int LPK = 32 / BS;        // lanes per key in the walk's scores
constexpr int PAD = 16 * LPK;       // bytes after each key row: the LPK
                                    // lanes of 4 keys hit distinct banks
// finite "minus infinity" (the TPU kernel's NEG_INF): a row never sees
// (-inf) - (-inf), so no row ever gives NaN
constexpr float NEG_INF = -1e30f;

// dtype tag -> (q type, pool type, int8 pool)
template <int TAG>
struct Dt;
template <>
struct Dt<0> {
  using Q = __nv_bfloat16;
  using KV = __nv_bfloat16;
  static constexpr bool QUANT = false;
};
template <>
struct Dt<1> {
  using Q = float;
  using KV = float;
  static constexpr bool QUANT = false;
};
template <>
struct Dt<2> {
  using Q = __nv_bfloat16;
  using KV = int8_t;
  static constexpr bool QUANT = true;
};
template <>
struct Dt<3> {
  using Q = float;
  using KV = int8_t;
  static constexpr bool QUANT = true;
};

// Everything a launch passes; K1 leaves the carry pointers null, K2 the
// scales and out.
struct Args {
  const void* q;  // [B, Hkv, R, hd] (= [B, H, S_in, hd])
  const void* k_pool;
  const void* v_pool;            // [nb, Hkv, BS, hd]
  const float* k_scale;          // int8 pools: [nb, Hkv, BS]
  const float* v_scale;
  const int* tables;             // [B, table_stride]
  const int* offsets;            // [B]
  void* out;                     // K1: [B, Hkv, R, hd] in q's dtype
  const float* acc_in;           // K2: the incoming carry, or all null
  const float* m_in;
  const float* l_in;
  float* acc_out;                // K2: the outgoing carry
  float* m_out;
  float* l_out;
  float* ws_acc;                 // decode rows: each split's partial state
  float* ws_m;                   // ([B*Hkv, nsplit, R, hd], [.., R], [.., R])
  float* ws_l;
  int nsplit;
  int order;                     // decode rows: 1 = longest slot first
  long long pool_block_stride;   // elements between pool blocks
  int B, Hkv, R, S_in, nb, mb, table_stride, window;
  float sm_scale;
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// probabilities enter P.V in the pool's dtype, as the TPU kernel's
// p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_like(float x) { return x; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// N consecutive elements of T at p (aligned to their size) -> f32
template <typename T, int N>
__device__ __forceinline__ void load_f(const unsigned char* p, float* out) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int u = 0; u < N; ++u) out[u] = to_f(x.v[u]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
// 16 bytes from gmem, or 16 zero bytes when !fill (nothing is read)
__device__ __forceinline__ void cp_async16_or_zero(void* smem,
                                                   const void* gmem,
                                                   bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The KV blocks a CTA walks and the positions its rows hold: rows r0 ..
// r0 + rows - 1 (those below R) of one (slot, KV head) sit at positions
// off + r % S_in; causal bounds the blocks above (the block of the
// latest position), the window below (the first block the earliest
// position still sees).
struct Bounds {
  int lo, hi;      // blocks [lo, hi) of the table
  int qmin, qmax;  // earliest and latest position of the CTA's rows
};

__device__ __forceinline__ Bounds cta_bounds(const Args& a, int r0, int rows,
                                             int off) {
  const int r1 = min(r0 + rows, a.R);
  const int s0 = r0 % a.S_in;
  const int s1 = (r1 - 1) % a.S_in;
  const bool wraps = r1 - r0 > a.S_in || s1 < s0;  // rows of two heads
  Bounds bd;
  bd.qmin = off + (wraps ? 0 : s0);
  bd.qmax = off + (wraps ? a.S_in - 1 : s1);
  bd.hi = min(bd.qmax / BS + 1, a.mb);
  bd.lo = a.window > 0 ? max(0, bd.qmin - a.window + 1) / BS : 0;
  return bd;
}

__device__ __forceinline__ bool owned(int raw, int nb) {
  return raw >= 0 && raw < nb;
}

// The split plan of decode rows: split s of ns takes the s-th of ns
// near-equal shares of the blocks [lo, hi), [lo + n s / ns, lo + n (s+1)
// / ns) with n = hi - lo, so every block falls in exactly one share (an
// empty one when n < ns).  K1 and K2 take the same plan; the plain
// helper paged_decode_split_reference mirrors it.
__device__ __forceinline__ void split_share(int& lo, int& hi, int s,
                                            int ns) {
  const long long n = max(hi - lo, 0);
  const int a0 = lo + static_cast<int>(n * s / ns);
  int a1 = lo + static_cast<int>(n * (s + 1) / ns);
#if TDP_PAGED_FAULT == 2  // planted: a split boundary one block late
  if (s + 1 < ns) a1 = min(a1 + 1, hi);
#endif
  lo = a0;
  hi = a1;
}

// The workspace index of row r of split s's partial state.
__device__ __forceinline__ long long partial_row(const Args& a, int bh,
                                                 int s, int r) {
  return (static_cast<long long>(bh) * a.nsplit + s) * a.R + r;
}

// ============================================== the walk (CUDA cores)

// Shared-memory tile geometry of one pool dtype and head dim.
template <typename TKV, int HD>
struct Tile {
  static constexpr int NSTAGE = sizeof(TKV) == 4 ? 4 : 8;  // blocks a stage
  static constexpr int ROW = HD * sizeof(TKV) + PAD;       // bytes a key row
  static constexpr int CHUNKS = HD * sizeof(TKV) / 16;     // 16 B chunks a row
  static constexpr int EPC = 16 / sizeof(TKV);             // elements a chunk
  static constexpr int DPL = HD / 32;                      // P.V dims a lane
  static constexpr int STAGE = NSTAGE * BS * ROW;          // bytes of K (or V)
  static constexpr int SCALES = NSTAGE * BS;               // floats of ks (vs)
};

// Copy the stage of pool blocks j0 .. j0 + NSTAGE - 1 (those below hi) of
// KV head h into shared memory, asynchronously; the caller commits.
// OWNED_ONLY (K2): another rank's block is not copied at all (its slot
// keeps stale bytes the walk never reads); otherwise (K1) entries clamp
// into the pool.
template <typename TKV, int HD, bool QUANT, bool OWNED_ONLY>
__device__ __forceinline__ void copy_stage(
    unsigned char* kdst, unsigned char* vdst, float* ksdst, float* vsdst,
    const Args& a, const int* __restrict__ table_row, int j0, int hi,
    int h) {
  using L = Tile<TKV, HD>;
  const TKV* k_pool = static_cast<const TKV*>(a.k_pool);
  const TKV* v_pool = static_cast<const TKV*>(a.v_pool);
  constexpr int PER_BLOCK = BS * L::CHUNKS;
  for (int ci = threadIdx.x; ci < L::NSTAGE * PER_BLOCK; ci += NTHREADS) {
    const int s = ci / PER_BLOCK;
    const int j = j0 + s;
    if (j >= hi) break;  // ci grows with s: the rest of the stage is past hi
    const int raw = table_row[j];
    if (OWNED_ONLY && !owned(raw, a.nb)) continue;
    const int blk = min(max(raw, 0), a.nb - 1);
    const int key = (ci % PER_BLOCK) / L::CHUNKS;
    const int c = ci % L::CHUNKS;
    const long long src = static_cast<long long>(blk) * a.pool_block_stride +
                          static_cast<long long>(h) * BS * HD + key * HD +
                          c * L::EPC;
    const int dst = (s * BS + key) * L::ROW + c * 16;
    cp_async16(kdst + dst, k_pool + src);
    cp_async16(vdst + dst, v_pool + src);
  }
  if (QUANT) {
    for (int t = threadIdx.x; t < L::SCALES; t += NTHREADS) {
      const int j = j0 + t / BS;
      if (j >= hi) break;
      const int blk = min(max(table_row[j], 0), a.nb - 1);
      const long long si =
          (static_cast<long long>(blk) * a.Hkv + h) * BS + t % BS;
      cp_async4(ksdst + t, a.k_scale + si);
      cp_async4(vsdst + t, a.v_scale + si);
    }
  }
}

// The walk: the decode rows of f32 and int8 pools, and the prefill row
// mode of those pools.  Decode rows (R <= DEC_ROWS, a workspace given)
// run on the split grid: blockIdx.y is the split, the CTA walks its
// share of the blocks and writes its raw state as that split's partial,
// and the merge kernel seeds K2's carry and finishes.  Split mode
// (decode rows with R <= RPW): every warp holds all R rows and takes its
// share of each stage's blocks; row mode: warps hold different rows, a
// warp one query row at a time against each block.
template <int TAG, int HD, bool CARRY>
__global__ void __launch_bounds__(NTHREADS)
paged_walk_kernel(const Args a) {
  using TQ = typename Dt<TAG>::Q;
  using TKV = typename Dt<TAG>::KV;
  constexpr bool QUANT = Dt<TAG>::QUANT;
  using L = Tile<TKV, HD>;
  constexpr int NSCALE = QUANT ? 2 * L::SCALES : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_buf = smem;                  // 2 stages
  unsigned char* v_buf = k_buf + 2 * L::STAGE;  // 2 stages
  float* ks_buf = reinterpret_cast<float*>(v_buf + 2 * L::STAGE);
  float* vs_buf = ks_buf + NSCALE;
  float* q_s = vs_buf + NSCALE;  // [ROWS][HD]
  float* p_s = q_s + ROWS * HD;  // [NWARPS][32]

  const int bh = blockIdx.x;
  const int b = bh / a.Hkv;
  const int h = bh % a.Hkv;
  const int R = a.R;
  const bool partial = a.ws_acc != nullptr;  // decode rows: a split's share
  const bool split = partial && R <= RPW;
  const int r0 = partial ? 0 : blockIdx.y * ROWS;
  const int cta_rows = split ? R : ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int off = a.offsets[b];
  const long long row0 = static_cast<long long>(bh) * R;

  const Bounds bd = cta_bounds(a, r0, cta_rows, off);
  int lo = bd.lo, hi = bd.hi;
  if (partial) split_share(lo, hi, blockIdx.y, a.nsplit);
  const int nstages = hi > lo ? (hi - lo + L::NSTAGE - 1) / L::NSTAGE : 0;
  const int* table_row = a.tables + static_cast<long long>(b) * a.table_stride;

  if (nstages > 0) {
    copy_stage<TKV, HD, QUANT, CARRY>(k_buf, v_buf, ks_buf, vs_buf, a,
                                      table_row, lo, hi, h);
    cp_async_commit();
  }

  const TQ* qb = static_cast<const TQ*>(a.q) + row0 * HD;
  for (int e = threadIdx.x; e < cta_rows * HD; e += NTHREADS) {
    const int r = r0 + e / HD;
    q_s[e] = r < R ? to_f(qb[static_cast<long long>(r) * HD + e % HD]) : 0.f;
  }

  // K2's carry enters every row once: on the split grid in the merge
  // kernel, else (prefill rows) here
  float m[RPW], l[RPW], acc[RPW][L::DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = split ? i : r0 + warp + NWARPS * i;
    const bool seed = CARRY && a.acc_in != nullptr && r < R &&
                      (!partial || TDP_PAGED_FAULT == 3);
    m[i] = seed ? a.m_in[row0 + r] : NEG_INF;
    l[i] = seed ? a.l_in[row0 + r] : 0.f;
#pragma unroll
    for (int u = 0; u < L::DPL; ++u)
      acc[i][u] = seed ? a.acc_in[(row0 + r) * HD + lane * L::DPL + u] : 0.f;
  }
  const int key = lane / LPK;
  const int part = lane % LPK;

  for (int st = 0; st < nstages; ++st) {
    const int cur = st & 1;
    if (st + 1 < nstages) {  // prefetch the next stage into the other buffer
      const int nxt = cur ^ 1;
      copy_stage<TKV, HD, QUANT, CARRY>(
          k_buf + nxt * L::STAGE, v_buf + nxt * L::STAGE,
          ks_buf + nxt * L::SCALES, vs_buf + nxt * L::SCALES, a, table_row,
          lo + (st + 1) * L::NSTAGE, hi, h);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kt = k_buf + cur * L::STAGE;
    const unsigned char* vt = v_buf + cur * L::STAGE;
    const float* kss = ks_buf + cur * L::SCALES;
    const float* vss = vs_buf + cur * L::SCALES;

    for (int s = split ? warp : 0; s < L::NSTAGE; s += split ? NWARPS : 1) {
      const int j = lo + st * L::NSTAGE + s;
      if (j >= hi) break;
      if (CARRY && !owned(table_row[j], a.nb)) continue;  // another rank's
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rl = split ? i : warp + NWARPS * i;
        const int r = r0 + rl;
        if (r >= R) break;  // warp-uniform
        const int qpos = off + r % a.S_in;

        const float* qr = q_s + rl * HD;
        const unsigned char* kr = kt + (s * BS + key) * L::ROW;
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < L::CHUNKS / LPK; ++t) {
          const int c = part + LPK * t;
          float kv[L::EPC];
          load_f<TKV, L::EPC>(kr + c * 16, kv);
#pragma unroll
          for (int u = 0; u < L::EPC; ++u) dot += qr[c * L::EPC + u] * kv[u];
        }
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (QUANT) dot *= kss[s * BS + key];
        const int kpos = j * BS + key;
        bool keep = kpos <= qpos;
        if (a.window > 0) keep = keep && kpos > qpos - a.window;
        const float sc = keep ? dot * a.sm_scale : NEG_INF;

        float mx = sc;
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float p = keep ? expf(sc - m_new) : 0.f;
        const float corr = expf(m[i] - m_new);
        float ps = part == 0 ? p : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l[i] = l[i] * corr + ps;

        if (part == 0)
          p_s[warp * 32 + key] =
              QUANT ? p * vss[s * BS + key] : round_like<TKV>(p);
        __syncwarp();
        float acc_new[L::DPL];
#pragma unroll
        for (int u = 0; u < L::DPL; ++u) acc_new[u] = acc[i][u] * corr;
#pragma unroll
        for (int k = 0; k < BS; ++k) {
          const float pk = p_s[warp * 32 + k];
          float vv[L::DPL];
          load_f<TKV, L::DPL>(
              vt + (s * BS + k) * L::ROW + lane * L::DPL * sizeof(TKV), vv);
#pragma unroll
          for (int u = 0; u < L::DPL; ++u) acc_new[u] += pk * vv[u];
        }
#pragma unroll
        for (int u = 0; u < L::DPL; ++u) acc[i][u] = acc_new[u];
        __syncwarp();
        m[i] = m_new;
      }
    }
    __syncthreads();  // the buffer is refilled two stages on
  }

  if (split) {
    // merge the warps' online-softmax states row by row, in the K buffers
    // (no copy is in flight any more); warp i then owns row i
    constexpr int CW = HD + 2;
    float* comb = reinterpret_cast<float*>(k_buf);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (i >= R) break;
      float* c = comb + (warp * RPW + i) * CW;
      if (lane == 0) {
        c[0] = m[i];
        c[1] = l[i];
      }
#pragma unroll
      for (int u = 0; u < L::DPL; ++u) c[2 + lane * L::DPL + u] = acc[i][u];
    }
    __syncthreads();
    if (warp >= R) return;
    const int i = warp;
    float mm = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, comb[(w * RPW + i) * CW]);
    float ll = 0.f;
    float merged[L::DPL];
#pragma unroll
    for (int u = 0; u < L::DPL; ++u) merged[u] = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float* c = comb + (w * RPW + i) * CW;
      const float f = expf(c[0] - mm);
      ll += c[1] * f;
#pragma unroll
      for (int u = 0; u < L::DPL; ++u) merged[u] += c[2 + lane * L::DPL + u] * f;
    }
    // the state of row `warp`, in slot 0 of this thread's arrays
    m[0] = mm;
    l[0] = ll;
#pragma unroll
    for (int u = 0; u < L::DPL; ++u) acc[0][u] = merged[u];
  }

  // a split writes its raw state; K2 the raw carry; K1 acc / l (l > 0
  // for every row whose own position lies inside the table; a padded row
  // past it writes 0)
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (split && i > 0) break;
    const int r = split ? warp : r0 + warp + NWARPS * i;
    if (r >= R) break;
    if (partial) {
      const long long pr = partial_row(a, bh, blockIdx.y, r);
      float* o = a.ws_acc + pr * HD + lane * L::DPL;
#pragma unroll
      for (int u = 0; u < L::DPL; ++u) o[u] = acc[i][u];
      if (lane == 0) {
        a.ws_m[pr] = m[i];
        a.ws_l[pr] = l[i];
      }
    } else if (CARRY) {
      float* o = a.acc_out + (row0 + r) * HD + lane * L::DPL;
#pragma unroll
      for (int u = 0; u < L::DPL; ++u) o[u] = acc[i][u];
      if (lane == 0) {
        a.m_out[row0 + r] = m[i];
        a.l_out[row0 + r] = l[i];
      }
    } else {
      TQ* o = static_cast<TQ*>(a.out) + (row0 + r) * HD + lane * L::DPL;
#pragma unroll
      for (int u = 0; u < L::DPL; ++u)
        o[u] = from_f<TQ>(l[i] > 0.f ? acc[i][u] / l[i] : 0.f);
    }
  }
}

// dynamic shared memory of one walk CTA: two stages of K and V tiles,
// their scales (int8 pools), the q rows and the per-warp probabilities
template <int TAG, int HD>
constexpr size_t walk_smem_bytes() {
  using L = Tile<typename Dt<TAG>::KV, HD>;
  return 4 * L::STAGE +
         sizeof(float) * ((Dt<TAG>::QUANT ? 4 * L::SCALES : 0) + ROWS * HD +
                          NWARPS * 32);
}

// ==================================== the tensor-core row mode (bf16)

using bf16 = __nv_bfloat16;

// Geometry: 64 query rows a CTA (16 a warp), key tiles of SLOTS pool
// blocks (64 keys), rows padded by 16 bytes so the 8 row addresses of an
// ldmatrix fall in 8 distinct 16-byte bank groups.
template <int HD>
struct Tc {
  static constexpr int BM = NWARPS * 16;  // query rows a CTA
  static constexpr int SLOTS = 4;         // pool blocks a key tile
  static constexpr int BN = SLOTS * BS;   // keys a tile
  static constexpr int LD = HD + 8;       // elements a shared row
  static constexpr int CH = HD / 8;       // 16-byte chunks a row
  static constexpr int TILE = BN * LD;    // elements of one K (or V) tile
  static constexpr size_t SMEM = sizeof(bf16) * (BM * LD + 4 * TILE);
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += A[16 x 16] . B[16 x 8], bf16 in, f32 accumulate; the m16n8 layout
// (lane = 4g + t holds rows g and g + 8, columns 2t and 2t + 1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even), the lower one first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The table entries of one key tile, ascending; -1 past the range.
struct KeyTile {
  int j[4];
  int n;
};

// The next key tile from `cursor` on, below hi.  K1 takes the next 4
// blocks in order; K2 (OWNED_ONLY) the next 4 blocks this rank owns,
// found a warp at a time by ballot over 32 table entries, so a tile
// never holds another rank's block.  At cp 1 (every block owned) both
// give the same tiles.  Every thread computes the same tile.
template <bool OWNED_ONLY>
__device__ __forceinline__ KeyTile next_tile(const int* __restrict__ table_row,
                                             int& cursor, int hi, int nb) {
  KeyTile t;
  t.n = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) t.j[s] = -1;
  if (!OWNED_ONLY) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (cursor + s < hi) {
        t.j[s] = cursor + s;
        t.n = s + 1;
      }
    cursor = min(cursor + 4, hi);
    return t;
  }
  const int lane = threadIdx.x % 32;
  while (t.n < 4 && cursor < hi) {
    const int jj = cursor + lane;
    const bool own = jj < hi && owned(table_row[jj], nb);
    unsigned mask = __ballot_sync(0xffffffffu, own);
    int next = min(cursor + 32, hi);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s >= t.n && mask != 0u) {
        const int j = cursor + __ffs(mask) - 1;
        mask &= mask - 1;
        t.j[s] = j;
        t.n = s + 1;
        if (s == 3) next = j + 1;
      }
    cursor = next;
  }
  return t;
}

// Copy a key tile's K and V blocks (KV head h) into shared memory,
// asynchronously; an empty slot (past the range) is zero-filled, since
// its rows still enter the products (p = 0 there, and 0 x stale NaN would
// be NaN).  The caller commits.
template <int HD, bool OWNED_ONLY>
__device__ __forceinline__ void copy_tile(bf16* kdst, bf16* vdst,
                                          const Args& a,
                                          const int* __restrict__ table_row,
                                          const KeyTile& t, int h) {
  using C = Tc<HD>;
  constexpr int PER_SLOT = BS * C::CH;
  static_assert(PER_SLOT % NTHREADS == 0, "a slot is whole passes");
  const bf16* k_pool = static_cast<const bf16*>(a.k_pool);
  const bf16* v_pool = static_cast<const bf16*>(a.v_pool);
#pragma unroll
  for (int s = 0; s < C::SLOTS; ++s) {
    const bool have = t.j[s] >= 0;
    const int raw = have ? table_row[t.j[s]] : 0;
    const int blk = OWNED_ONLY ? raw : min(max(raw, 0), a.nb - 1);
    const long long base =
        have ? static_cast<long long>(blk) * a.pool_block_stride +
                   static_cast<long long>(h) * BS * HD
             : 0;
#pragma unroll
    for (int it = 0; it < PER_SLOT / NTHREADS; ++it) {
      const int idx = it * NTHREADS + threadIdx.x;
      const int key = idx / C::CH;
      const int c = idx % C::CH;
      const long long src = base + key * HD + c * 8;
      const int dst = (s * BS + key) * C::LD + c * 8;
      cp_async16_or_zero(kdst + dst, k_pool + src, have);
      cp_async16_or_zero(vdst + dst, v_pool + src, have);
    }
  }
}

// Prefill rows of bf16 pools on the tensor cores (see the header).
template <int TAG, int HD, bool CARRY>
__global__ void __launch_bounds__(NTHREADS, 2)
paged_tc_kernel(const Args a) {
  static_assert(TAG == 0, "the tensor-core mode takes bf16 q and pools");
  using C = Tc<HD>;
  constexpr int LD = C::LD;
  constexpr int NT = C::BN / 8;  // 8-key column tiles of S
  constexpr int DT = HD / 8;     // 8-dim column tiles of the output
  constexpr int KQ = HD / 16;    // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* ks = qs + C::BM * LD;                    // 2 stages of [BN][LD]
  bf16* vs = ks + 2 * C::TILE;                   // 2 stages of [BN][LD]

  const int bh = blockIdx.x;
  const int b = bh / a.Hkv;
  const int h = bh % a.Hkv;
  const int R = a.R;
  // deep row tiles first, so the causal tail does not finish last
  const int r0 = (gridDim.y - 1 - blockIdx.y) * C::BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = a.offsets[b];
  const long long row0 = static_cast<long long>(bh) * R;
  const Bounds bd = cta_bounds(a, r0, C::BM, off);
  const int* table_row = a.tables + static_cast<long long>(b) * a.table_stride;

  // this thread's rows: ra (accumulator elements 0, 1) and ra + 8 (2, 3)
  const int ra = r0 + warp * 16 + g;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = off + (ra + 8 * i) % a.S_in;

  float m[2], l[2], acc[DT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    const bool seed = CARRY && a.acc_in != nullptr && r < R;
    m[i] = seed ? a.m_in[row0 + r] : NEG_INF;
    l[i] = seed ? a.l_in[row0 + r] : 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float2 v = make_float2(0.f, 0.f);
      if (seed)
        v = *reinterpret_cast<const float2*>(a.acc_in + (row0 + r) * HD +
                                             dt * 8 + 2 * t);
      acc[dt][2 * i] = v.x;
      acc[dt][2 * i + 1] = v.y;
    }
  }

  int cursor = bd.lo;
  KeyTile cur = next_tile<CARRY>(table_row, cursor, bd.hi, a.nb);
  if (cur.n > 0) {  // the Q rows and the first key tile: one group
    const bf16* qb = static_cast<const bf16*>(a.q) + row0 * HD;
    for (int idx = threadIdx.x; idx < C::BM * C::CH; idx += NTHREADS) {
      const int rl = idx / C::CH;
      const int c = idx % C::CH;
      const bool in = r0 + rl < R;
      cp_async16_or_zero(qs + rl * LD + c * 8,
                         qb + (in ? static_cast<long long>(r0 + rl) * HD +
                                        c * 8
                                  : 0),
                         in);
    }
    copy_tile<HD, CARRY>(ks, vs, a, table_row, cur, h);
    cp_async_commit();
  }

  uint32_t qf[KQ][4];  // Q as mma A fragments, loaded once
  int stage = 0;
  bool first = true;
  while (cur.n > 0) {
    const KeyTile nxt = next_tile<CARRY>(table_row, cursor, bd.hi, a.nb);
    if (nxt.n > 0) {  // prefetch the next tile into the other buffer
      copy_tile<HD, CARRY>(ks + (stage ^ 1) * C::TILE,
                           vs + (stage ^ 1) * C::TILE, a, table_row, nxt, h);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD + kk * 16 + (lane >> 4) * 8);
      first = false;
    }
    const bf16* kt = ks + stage * C::TILE;
    const bf16* vt = vs + stage * C::TILE;

    // S = Q K^T: one ldmatrix.x4 gives the B fragments of two 8-key
    // column tiles (one pool block) at one 16-dim k-step
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // scale; mask only a tile that crosses the diagonal, the window edge
    // or the range's end (a masked score is -inf: exp gives exactly 0
    // whatever the row's max, and the max starts at the finite NEG_INF)
    const bool interior =
        cur.n == 4 && cur.j[3] * BS + BS - 1 <= bd.qmin &&
        (a.window <= 0 || cur.j[0] * BS > bd.qmax - a.window);
    int kbase[4];
#pragma unroll
    for (int sl = 0; sl < 4; ++sl)
      kbase[sl] = cur.j[sl] >= 0 ? cur.j[sl] * BS : (1 << 30);  // > any qpos
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[nt][e] * a.sm_scale;
        if (!interior) {
          const int kpos = kbase[nt >> 1] + (nt & 1) * 8 + 2 * t + (e & 1);
          const bool keep =
              kpos <= qpos[i] && (a.window <= 0 || kpos > qpos[i] - a.window);
          x = keep ? x : -INFINITY;
        }
        s[nt][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    // P: l sums it unrounded; rounded to bf16 it becomes the A fragments
    // of P V (16 keys = one pool block a k-step) without leaving registers
    uint32_t pf[NT / 2][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(s[nt][0] - m[0]);
      const float p1 = expf(s[nt][1] - m[0]);
      const float p2 = expf(s[nt][2] - m[1]);
      const float p3 = expf(s[nt][3] - m[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
    // O += P V: ldmatrix.trans gives the B fragments of two 8-dim column
    // tiles at one 16-key k-step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    __syncthreads();  // every warp is done with this buffer
    cur = nxt;
    stage ^= 1;
  }

  // K2 writes the raw carry; K1 writes acc / l (0 for a row that met no
  // key: a padded row past the table)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (r >= R) continue;
    if (CARRY) {
      float* o = a.acc_out + (row0 + r) * HD + 2 * t;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(o + dt * 8) =
            make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
      if (t == 0) {
        a.m_out[row0 + r] = m[i];
        a.l_out[row0 + r] = l[i];
      }
    } else {
      bf16* o = static_cast<bf16*>(a.out) + (row0 + r) * HD + 2 * t;
      const float li = l[i];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(o + dt * 8) =
            pack_bf16(li > 0.f ? acc[dt][2 * i] / li : 0.f,
                      li > 0.f ? acc[dt][2 * i + 1] / li : 0.f);
    }
  }
}

// ========================== decode rows on the tensor cores (split-KV)

// Geometry of the split-KV decode body: the R <= DEC_ROWS rows of one
// (slot, KV head) padded to one m16 tile that every warp holds as mma A
// fragments; a stage is NWARPS pool blocks, one a warp, K then V, rows
// padded by 16 bytes as in Tc; STAGES stages in a cp.async ring.
template <int HD>
struct Dec {
  static constexpr int STAGES = 3;
  static constexpr int LD = HD + 8;           // elements a shared row
  static constexpr int CH = HD / 8;           // 16-byte chunks a row
  static constexpr int SLAB = BS * LD;        // one block's K (or V)
  static constexpr int STAGE = 2 * NWARPS * SLAB;
  static constexpr size_t STAGES_BYTES = sizeof(bf16) * STAGES * STAGE;
  // then, when the grid orders its slots, the order's scratch (2 B ints)
  static size_t smem(const Args& a) {
    return STAGES_BYTES + (a.order ? sizeof(int) * 2 * a.B : 0);
  }
  // the warps' states, merged at the end, reuse the stage buffers
  static_assert(sizeof(float) * NWARPS * DEC_ROWS * (HD + 2) <= STAGES_BYTES,
                "the in-CTA merge fits in the stages");
};

// Copy a key tile's blocks (KeyTile: one a warp, K2's all owned) of KV
// head h into one stage, asynchronously; the caller commits.  A slot past
// the tile's end is left as it is: its warp skips the stage.  Entries
// clamp into the pool.
template <int HD>
__device__ __forceinline__ void copy_dec_stage(
    bf16* buf, const Args& a, const int* __restrict__ table_row,
    const KeyTile& t, int h) {
  using D = Dec<HD>;
  constexpr int PER_BLOCK = BS * D::CH;
  static_assert(NWARPS == 4, "a key tile holds a block a warp");
  const bf16* k_pool = static_cast<const bf16*>(a.k_pool);
  const bf16* v_pool = static_cast<const bf16*>(a.v_pool);
  for (int ci = threadIdx.x; ci < NWARPS * PER_BLOCK; ci += NTHREADS) {
    const int s = ci / PER_BLOCK;
    if (s >= t.n) break;  // ci grows with s: the rest is past the tile
    const int blk = min(max(table_row[t.j[s]], 0), a.nb - 1);
    const int key = (ci % PER_BLOCK) / D::CH;
    const int c = ci % D::CH;
    const long long src = static_cast<long long>(blk) * a.pool_block_stride +
                          static_cast<long long>(h) * BS * HD + key * HD +
                          c * 8;
    const int dst = s * D::SLAB + key * D::LD + c * 8;
    cp_async16(buf + dst, k_pool + src);
    cp_async16(buf + NWARPS * D::SLAB + dst, v_pool + src);
  }
}

// Longest first: the decode grid's work items (slot, KV head, split),
// slot-major, the slots in order of decreasing visible blocks (ties by
// index), handed out by the CTA's linear index — the order in which the
// hardware starts CTAs — so the longest shares start first and the short
// ones fill the tail.  Every CTA computes the same order in `scratch`
// (2 B ints of shared memory), B^2 / NTHREADS compares a thread; the
// host asks for it (a.order) up to DECODE_ORDER_MAX_SLOTS slots
// (ops/paged_attention.py), above which the grid keeps its own order.
// Returns (bh, split) through the references.
__device__ __forceinline__ void decode_item(const Args& a, int* scratch,
                                            int& bh, int& split) {
  if (!a.order) {
    bh = blockIdx.x;
    split = blockIdx.y;
    return;
  }
  int* len = scratch;           // [B] visible blocks
  int* order = scratch + a.B;   // [B] slots, longest first
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    const Bounds bd = cta_bounds(a, 0, a.R, a.offsets[b]);
    len[b] = max(bd.hi - bd.lo, 0);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    int rank = 0;
    for (int o = 0; o < a.B; ++o)
      rank += len[o] > len[b] || (len[o] == len[b] && o < b);
    order[rank] = b;
  }
  __syncthreads();
  const int item = blockIdx.x + blockIdx.y * gridDim.x;
  const int per_slot = a.Hkv * a.nsplit;
  bh = order[item / per_slot] * a.Hkv + item % per_slot / a.nsplit;
  split = item % a.nsplit;
}

// Decode rows of bf16 pools (see the header).  Grid (B * Hkv, nsplit):
// the CTA takes its split's share of the (slot, KV head)'s blocks as key
// tiles of NWARPS blocks (K2: the next NWARPS blocks it owns, so a hop
// over a quarter slice keeps as many bytes in flight), warp w block w of
// each tile with its own online-softmax state on the mma accumulator
// fragments; the warps' states are merged in warp order and written as
// the split's partial.
template <int TAG, int HD, bool CARRY>
__global__ void __launch_bounds__(NTHREADS, 2)
paged_split_kernel(const Args a) {
  static_assert(TAG == 0, "the tensor-core mode takes bf16 q and pools");
  using D = Dec<HD>;
  constexpr int LD = D::LD;
  constexpr int DT = HD / 8;   // 8-dim column tiles of the output
  constexpr int KQ = HD / 16;  // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);

  int bh, split;
  decode_item(a, reinterpret_cast<int*>(smem_raw + D::STAGES_BYTES), bh,
              split);
  const int b = bh / a.Hkv;
  const int h = bh % a.Hkv;
  const int R = a.R;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = a.offsets[b];
  const long long row0 = static_cast<long long>(bh) * R;
  const Bounds bd = cta_bounds(a, 0, R, off);
  int lo = bd.lo, hi = bd.hi;
  split_share(lo, hi, split, a.nsplit);
  if (hi <= lo && TDP_PAGED_FAULT != 3) {  // an empty share: the neutral
    const long long pr = partial_row(a, bh, split, 0);  // partial, at once
    for (int i = threadIdx.x; i < R * HD; i += NTHREADS)
      a.ws_acc[pr * HD + i] = 0.f;
    for (int r = threadIdx.x; r < R; r += NTHREADS) {
      a.ws_m[pr + r] = NEG_INF;
      a.ws_l[pr + r] = 0.f;
    }
    return;
  }

  // Q as mma A fragments straight from device memory (rows >= R are 0):
  // register e holds row g + 8 (e & 1), dims 2t, 2t + 1 (+ 8 for e >= 2)
  // of k-step kk
  uint32_t qf[KQ][4];
  const bf16* qb = static_cast<const bf16*>(a.q) + row0 * HD;
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e & 1);
      const int c = kk * 16 + 2 * t + 8 * (e >> 1);
      qf[kk][e] = r < R ? *reinterpret_cast<const uint32_t*>(
                              qb + static_cast<long long>(r) * HD + c)
                        : 0u;
    }

  const int* table_row = a.tables + static_cast<long long>(b) * a.table_stride;

  // the key tiles of stages st .. st + STAGES - 1 (every thread computes
  // the same ones); the first STAGES - 1 go in flight now
  int cursor = lo;
  KeyTile ring[D::STAGES];
#pragma unroll
  for (int p = 0; p < D::STAGES - 1; ++p) {
    ring[p] = next_tile<CARRY>(table_row, cursor, hi, a.nb);
    if (ring[p].n > 0)
      copy_dec_stage<HD>(stages + p * D::STAGE, a, table_row, ring[p], h);
    cp_async_commit();
  }

  // this thread's rows: g (accumulator elements 0, 1) and g + 8 (2, 3)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = off + (g + 8 * i) % a.S_in;

  float m[2], l[2], acc[DT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    // K2's carry enters once, in the merge kernel (planted fault 3: here,
    // through warp 0 of every split)
    const bool seed = TDP_PAGED_FAULT == 3 && CARRY && a.acc_in != nullptr &&
                      warp == 0 && r < R;
    m[i] = seed ? a.m_in[row0 + r] : NEG_INF;
    l[i] = seed ? a.l_in[row0 + r] : 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float2 v = make_float2(0.f, 0.f);
      if (seed)
        v = *reinterpret_cast<const float2*>(a.acc_in + (row0 + r) * HD +
                                             dt * 8 + 2 * t);
      acc[dt][2 * i] = v.x;
      acc[dt][2 * i + 1] = v.y;
    }
  }

  for (int st = 0; ring[0].n > 0; ++st) {
    ring[D::STAGES - 1] = next_tile<CARRY>(table_row, cursor, hi, a.nb);
    if (ring[D::STAGES - 1].n > 0)
      copy_dec_stage<HD>(
          stages + ((st + D::STAGES - 1) % D::STAGES) * D::STAGE, a,
          table_row, ring[D::STAGES - 1], h);
    cp_async_commit();
    cp_async_wait<D::STAGES - 1>();
    __syncthreads();
    // this warp's block (-1 past the tile's end)
    const KeyTile& cur = ring[0];
    const int j = warp == 0 ? cur.j[0]
                  : warp == 1 ? cur.j[1]
                  : warp == 2 ? cur.j[2]
                              : cur.j[3];
    if (j >= 0) {
      const bf16* kt = stages + (st % D::STAGES) * D::STAGE + warp * D::SLAB;
      const bf16* vt = kt + NWARPS * D::SLAB;
      // S = Q K^T over the block's 16 keys: one ldmatrix.x4 a k-step
      // gives the B fragments of both 8-key column tiles
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + ((lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qf[kk], kf[0], kf[1]);
        mma_bf16(s[1], qf[kk], kf[2], kf[3]);
      }
      // scale; per-element masks only on a block that crosses the
      // diagonal or the window edge (masked: -inf, exp gives exactly 0)
      const bool interior =
          j * BS + BS - 1 <= bd.qmin &&
          (a.window <= 0 || j * BS > bd.qmax - a.window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float x = s[nt][e] * a.sm_scale;
          if (!interior) {
            const int kpos = j * BS + nt * 8 + 2 * t + (e & 1);
            const bool keep = kpos <= qpos[i] &&
                              (a.window <= 0 || kpos > qpos[i] - a.window);
            x = keep ? x : -INFINITY;
          }
          s[nt][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
      // P: l sums it unrounded; rounded to bf16 it is the A fragment of
      // P V (the block's 16 keys are one k-step)
      uint32_t pf[4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float p0 = expf(s[nt][0] - m[0]);
        const float p1 = expf(s[nt][1] - m[0]);
        const float p2 = expf(s[nt][2] - m[1]);
        const float p3 = expf(s[nt][3] - m[1]);
        sum[0] += p0 + p1;
        sum[1] += p2 + p3;
        pf[2 * nt] = pack_bf16(p0, p1);
        pf[2 * nt + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * corr[i] + sum[i];
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][0] *= corr[0];
        acc[dt][1] *= corr[0];
        acc[dt][2] *= corr[1];
        acc[dt][3] *= corr[1];
      }
      // O += P V: ldmatrix.trans gives the B fragments of two 8-dim
      // column tiles
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage's buffer
#pragma unroll
    for (int p = 0; p + 1 < D::STAGES; ++p) ring[p] = ring[p + 1];
  }
  cp_async_wait<0>();  // only empty groups can be left; the buffers are free

  // the warps' states through shared memory, merged in warp order
  float* st_m = reinterpret_cast<float*>(smem_raw);  // [NWARPS][DEC_ROWS]
  float* st_l = st_m + NWARPS * DEC_ROWS;
  float* st_acc = st_l + NWARPS * DEC_ROWS;  // [NWARPS][DEC_ROWS][HD]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * DEC_ROWS + g + 8 * i;
    if (t == 0) {
      st_m[r] = m[i];
      st_l[r] = l[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(st_acc + r * HD + dt * 8 + 2 * t) =
          make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * HD; idx += NTHREADS) {
    const int r = idx / HD;
    const int d = idx % HD;
    float mm = NEG_INF;
    for (int w = 0; w < NWARPS; ++w)
      if (st_l[w * DEC_ROWS + r] > 0.f) mm = fmaxf(mm, st_m[w * DEC_ROWS + r]);
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const int wr = w * DEC_ROWS + r;
      if (!(st_l[wr] > 0.f)) continue;  // met no key: adds nothing
      const float f = expf(st_m[wr] - mm);
      ll += st_l[wr] * f;
      aa += st_acc[wr * HD + d] * f;
    }
    const long long pr = partial_row(a, bh, split, r);
    a.ws_acc[pr * HD + d] = aa;
    if (d == 0) {
      a.ws_m[pr] = mm;
      a.ws_l[pr] = ll;
    }
  }
}

// Finish decode rows: merge each row's nsplit partials in split order —
// the max over the partials that met a key, then each rescaled to it and
// added — after K2's incoming carry, which enters here exactly once.  K1
// writes acc / l in q's dtype (0 for a row that met no key), K2 the raw
// carry.  Grid (B * Hkv, R), HD threads: one row a CTA, a thread a dim.
// The partials' m and l, and their weights, go through shared memory
// (nsplit floats each) so that the loads of every split are in flight
// at once.
template <int TAG, int HD, bool CARRY>
__global__ void __launch_bounds__(HD)
paged_merge_kernel(const Args a) {
  using TQ = typename Dt<TAG>::Q;
  extern __shared__ float msm[];  // [nsplit] l, then [nsplit] weights
  float* sl = msm;
  float* sw = msm + a.nsplit;
  __shared__ float wmax[HD / 32];
  const int ns = a.nsplit;
  const int bh = blockIdx.x;
  const int r = blockIdx.y;
  const int d = threadIdx.x;
  const long long row = static_cast<long long>(bh) * a.R + r;
  const long long p0 = partial_row(a, bh, 0, r);  // split s: p0 + s R
  float m = NEG_INF, l = 0.f, acc = 0.f;
  if (CARRY && a.acc_in != nullptr && TDP_PAGED_FAULT != 3) {
    m = a.m_in[row];
    l = a.l_in[row];
    acc = a.acc_in[row * HD + d];
  }
  // the max over the carry and the splits that met a key (max is exact:
  // any order gives the same bits)
  float mm = m;
  for (int s = d; s < ns; s += HD) {
    const long long ps = p0 + static_cast<long long>(s) * a.R;
    sl[s] = a.ws_l[ps];
    sw[s] = a.ws_m[ps];
    if (sl[s] > 0.f) mm = fmaxf(mm, sw[s]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
  if (d % 32 == 0) wmax[d / 32] = mm;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < HD / 32; ++w) mm = fmaxf(mm, wmax[w]);
  for (int s = d; s < ns; s += HD) {  // this thread's splits: m -> weight
#if TDP_PAGED_FAULT == 4  // planted: the next split's m
    const float ms = a.ws_m[p0 + static_cast<long long>((s + 1) % ns) * a.R];
#else
    const float ms = sw[s];
#endif
    sw[s] = expf(ms - mm);
#if TDP_PAGED_FAULT == 1  // planted: one split's partial dropped
    if (s == 1) sl[s] = 0.f;
#endif
  }
  __syncthreads();
  const float f0 = expf(m - mm);
  acc *= f0;
  l *= f0;
  constexpr int U = 8;  // splits whose acc loads are in flight together
  for (int s0 = 0; s0 < ns; s0 += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      v[u] = s < ns && sl[s] > 0.f
                 ? a.ws_acc[(p0 + static_cast<long long>(s) * a.R) * HD + d]
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      if (s < ns && sl[s] > 0.f) {  // an empty split adds nothing
        l += sl[s] * sw[s];
        acc += v[u] * sw[s];
      }
    }
  }
  if (CARRY) {
    a.acc_out[row * HD + d] = acc;
    if (d == 0) {
      a.m_out[row] = mm;
      a.l_out[row] = l;
    }
  } else {
    static_cast<TQ*>(a.out)[row * HD + d] = from_f<TQ>(l > 0.f ? acc / l
                                                                : 0.f);
  }
}

// ================================================================ launch

// the tensor-core prefill mode takes bf16 q and pools above the decode
// rows
__host__ __device__ constexpr bool tensor_core_mode(int tag, int R) {
  return tag == 0 && R > DEC_ROWS;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int TAG, int HD, bool CARRY>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using L = Tile<typename Dt<TAG>::KV, HD>;
  static_assert(2 * L::STAGE >= NWARPS * RPW * (HD + 2) * sizeof(float),
                "the split-mode merge fits in the K buffers");
  const int bh = B * a.Hkv;
  cudaError_t err;
  if (a.R <= DEC_ROWS) {  // decode rows: the split grid, then the merge
    if (a.ws_acc == nullptr || a.nsplit < 1) return cudaErrorInvalidValue;
    const dim3 grid(bh, a.nsplit);
    if constexpr (TAG == 0) {
      auto kernel = paged_split_kernel<TAG, HD, CARRY>;
      const size_t smem = Dec<HD>::smem(a);
      if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
      TDP_NOTE("paged_split_kernel");
      kernel<<<grid, NTHREADS, smem, stream>>>(a);
    } else {
      auto kernel = paged_walk_kernel<TAG, HD, CARRY>;
      const size_t smem = walk_smem_bytes<TAG, HD>();
      if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
      TDP_NOTE("paged_walk_kernel");
      kernel<<<grid, NTHREADS, smem, stream>>>(a);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t msmem = 2 * sizeof(float) * a.nsplit;
    auto merge = paged_merge_kernel<TAG, HD, CARRY>;
    if (msmem > 48 * 1024 && (err = set_smem(merge, msmem)) != cudaSuccess)
      return err;  // above the default only for a very large nsplit
    TDP_NOTE("paged_merge_kernel");
    merge<<<dim3(bh, a.R), HD, msmem, stream>>>(a);
    return cudaGetLastError();
  }
  if constexpr (TAG == 0) {
    auto kernel = paged_tc_kernel<TAG, HD, CARRY>;
    if ((err = set_smem(kernel, Tc<HD>::SMEM)) != cudaSuccess) return err;
    const dim3 grid(bh, (a.R + Tc<HD>::BM - 1) / Tc<HD>::BM);
    TDP_NOTE("paged_tc_kernel");
    kernel<<<grid, NTHREADS, Tc<HD>::SMEM, stream>>>(a);
  } else {  // f32 and int8 prefill rows: the walk's row mode
    Args rows = a;
    rows.ws_acc = rows.ws_m = rows.ws_l = nullptr;
    auto kernel = paged_walk_kernel<TAG, HD, CARRY>;
    const size_t smem = walk_smem_bytes<TAG, HD>();
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    const dim3 grid(bh, (a.R + ROWS - 1) / ROWS);
    TDP_NOTE("paged_walk_kernel");
    kernel<<<grid, NTHREADS, smem, stream>>>(rows);
  }
  return cudaGetLastError();
}

template <bool CARRY>
cudaError_t dispatch(const Args& a, int B, int hd, int dtype_tag,
                     cudaStream_t st) {
  switch (dtype_tag * 2 + (hd == 128 ? 1 : 0)) {
    case 0: return launch<0, 64, CARRY>(a, B, st);
    case 1: return launch<0, 128, CARRY>(a, B, st);
    case 2: return launch<1, 64, CARRY>(a, B, st);
    case 3: return launch<1, 128, CARRY>(a, B, st);
    default: break;
  }
  if constexpr (!CARRY) {  // int8 pools: K1 only, as the TPU kernels
    switch (dtype_tag * 2 + (hd == 128 ? 1 : 0)) {
      case 4: return launch<2, 64, false>(a, B, st);
      case 5: return launch<2, 128, false>(a, B, st);
      case 6: return launch<3, 64, false>(a, B, st);
      case 7: return launch<3, 128, false>(a, B, st);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

bool shape_ok(int B, int Hkv, int R, int S_in, int hd, int nb, int bs,
              int mb) {
  return bs == BS && (hd == 64 || hd == 128) && B >= 1 && Hkv >= 1 &&
         R >= 1 && S_in >= 1 && nb >= 1 && mb >= 1;
}

// The decode rows' workspace: nsplit partial states of every (slot, KV
// head)'s R rows, f32, acc first, then m, then l ([B*Hkv, nsplit, R,
// hd], [.., R], [.., R]); null above DEC_ROWS rows.
void set_workspace(Args& a, void* ws, int nsplit, int order, int B,
                   int hd) {
  a.nsplit = nsplit;
  a.order = order;
  if (ws == nullptr) return;
  const long long rows = static_cast<long long>(B) * a.Hkv * nsplit * a.R;
  a.ws_acc = static_cast<float*>(ws);
  a.ws_m = a.ws_acc + rows * hd;
  a.ws_l = a.ws_m + rows;
}

}  // namespace

// K1.  dtype_tag: 0 = bf16 q / bf16 pool, 1 = f32 q / f32 pool,
//      2 = bf16 q / int8 pool, 3 = f32 q / int8 pool (f32 scales).
// window <= 0 means no sliding window.  Decode rows (R <= 16) take
// nsplit >= 1, a workspace of B * Hkv * nsplit * R * (hd + 2) floats and
// order (1: the bf16 grid starts the longest slots first, `decode_item`);
// others pass null and 0.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape the kernel does
// not take).
extern "C" int tdp_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* offsets, void* out, void* ws, int B, int Hkv, int R,
    int S_in, int hd, int nb, int bs, int mb, int nsplit, int order,
    long long pool_block_stride, int table_stride, int window,
    float sm_scale, int dtype_tag, void* stream) {
  if (!shape_ok(B, Hkv, R, S_in, hd, nb, bs, mb))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.offsets = static_cast<const int*>(offsets);
  a.out = out;
  a.pool_block_stride = pool_block_stride;
  a.B = B;
  a.Hkv = Hkv;
  a.R = R;
  a.S_in = S_in;
  a.nb = nb;
  a.mb = mb;
  a.table_stride = table_stride;
  a.window = window;
  a.sm_scale = sm_scale;
  set_workspace(a, ws, nsplit, order, B, hd);
  return static_cast<int>(dispatch<false>(a, B, hd, dtype_tag,
                                          static_cast<cudaStream_t>(stream)));
}

// K2, one ring hop.  dtype_tag: 0 = bf16 q / bf16 pool, 1 = f32 q / f32
// pool.  acc_in / m_in / l_in: the incoming carry ([B, Hkv, R, hd],
// [B, Hkv, R], [B, Hkv, R] f32), all null for the first hop; the outputs
// are distinct buffers of the same shapes.  tables hold re-based ids:
// entries outside [0, nb) are another rank's blocks.  window <= 0 means
// no sliding window.  ws, nsplit and order as for K1.  Returns
// cudaGetLastError() after the launch.
extern "C" int tdp_paged_carry_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* offsets, const void* acc_in,
    const void* m_in, const void* l_in, void* acc_out, void* m_out,
    void* l_out, void* ws, int B, int Hkv, int R, int S_in, int hd, int nb,
    int bs, int mb, int nsplit, int order, long long pool_block_stride,
    int table_stride, int window, float sm_scale, int dtype_tag,
    void* stream) {
  if (!shape_ok(B, Hkv, R, S_in, hd, nb, bs, mb) ||
      ((acc_in == nullptr) != (m_in == nullptr)) ||
      ((acc_in == nullptr) != (l_in == nullptr)) || dtype_tag > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.tables = static_cast<const int*>(tables);
  a.offsets = static_cast<const int*>(offsets);
  a.acc_in = static_cast<const float*>(acc_in);
  a.m_in = static_cast<const float*>(m_in);
  a.l_in = static_cast<const float*>(l_in);
  a.acc_out = static_cast<float*>(acc_out);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.pool_block_stride = pool_block_stride;
  a.B = B;
  a.Hkv = Hkv;
  a.R = R;
  a.S_in = S_in;
  a.nb = nb;
  a.mb = mb;
  a.table_stride = table_stride;
  a.window = window;
  a.sm_scale = sm_scale;
  set_workspace(a, ws, nsplit, order, B, hd);
  return static_cast<int>(dispatch<true>(a, B, hd, dtype_tag,
                                         static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of the CTA that K1 and K2 launch for a dtype tag,
// head dim and row count R (the split-KV decode body — plus 8 B a slot
// when its grid orders the slots —, the tensor-core prefill mode or the
// walk); -1 if unknown.  Reported beside ptxas'
// registers by the build check.
extern "C" int tdp_paged_smem_bytes(int dtype_tag, int hd, int R) {
  if (hd != 64 && hd != 128) return -1;
  const bool h128 = hd == 128;
  if (dtype_tag == 0 && R <= DEC_ROWS)
    return static_cast<int>(h128 ? Dec<128>::STAGES_BYTES
                                 : Dec<64>::STAGES_BYTES);
  if (tensor_core_mode(dtype_tag, R))
    return static_cast<int>(h128 ? Tc<128>::SMEM : Tc<64>::SMEM);
  switch (dtype_tag) {
    case 1: return static_cast<int>(h128 ? walk_smem_bytes<1, 128>()
                                         : walk_smem_bytes<1, 64>());
    case 2:
    case 3: return static_cast<int>(h128 ? walk_smem_bytes<2, 128>()
                                         : walk_smem_bytes<2, 64>());
    default: return -1;
  }
}
