// Paged attention for Hopper (sm_90a): the query rows of each slot attend
// against that slot's KV, walking its block table inside the kernel.
//
// Replaces the TPU kernel `paged_decode_attention`
// (torchdistpackage_tpu/ops/paged_attention.py:214, body `_kernel` :136).
// One kernel serves every serving shape: S_in = 1 (decode), S_in = chunk
// (chunked prefill), GQA (query heads grouped per KV head, group-major rows
// r = g*S_in + s), a sliding window, and int8 pools whose per-vector f32
// scales fold into the scores (k) and the probabilities (v).
//
// What bounds it on an H100: bytes.  A decode step reads each slot's live
// KV once (bf16: 2 * live_tokens * Hkv * hd * 2 bytes per layer) at
// 3.35 TB/s, against ~4 * G * live_tokens * hd operations per KV head —
// one or two operations per byte, far below the ~295 the tensor cores
// need to be the limit.  So the design reads every live KV block once per
// CTA and only the blocks a CTA's rows can see (causal and window bounds
// per CTA, which also halves a prefill chunk's work), never builds a
// gathered view, keeps int8 bytes int8 until registers, and keeps many
// bytes in flight: a stage of NSTAGE pool blocks is copied with cp.async
// into shared memory while the previous stage is consumed (two buffers).
// A decode step (R = G rows) spreads the stage's blocks over the CTA's
// warps, each with its own online-softmax state, merged once at the end.
// A prefill chunk (R = G * 512 rows) tiles rows over CTAs instead and is
// compute-heavy; there this kernel still runs on the CUDA cores in f32.
// Moving the products onto mma/wgmma, TMA loads, and splitting a long
// context over several CTAs are later work.
//
// Grid: (B * Hkv, ceil(R / ROWS)) in row mode; (B * Hkv, 1) in split mode
// (R <= RPW).  The scalar-prefetched block table of the TPU kernel becomes
// a load of tables[b, j] per copied chunk; its v5e tuning knobs
// (fetch_width, q_pad_to) have no counterpart here.
//
// The same file holds K2 (`paged_carry_kernel`, below): one hop of the
// context-parallel ring, K1's walk over one rank's pool slice returning
// the raw online-softmax carry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = 4;              // rows per warp
constexpr int ROWS = NWARPS * RPW;  // rows per CTA in row mode
constexpr int BS = 16;              // pool block size (positions)
constexpr int LPK = 32 / BS;        // lanes per key in the score product
constexpr int PAD = 16 * LPK;       // bytes after each key row: the LPK
                                    // lanes of 4 keys hit distinct banks
// finite "minus infinity" (the TPU kernel's NEG_INF): a row never sees
// (-inf) - (-inf), so no row ever gives NaN
constexpr float NEG_INF = -1e30f;

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
// OWNED_ONLY (K2): a table entry outside [0, nb) names another rank's
// block and is not copied at all (its slot keeps stale bytes the walk
// never reads); otherwise (K1) entries clamp into the pool.
template <typename TKV, int HD, bool QUANT, bool OWNED_ONLY = false>
__device__ __forceinline__ void copy_stage(
    unsigned char* kdst, unsigned char* vdst, float* ksdst, float* vsdst,
    const TKV* __restrict__ k_pool, const TKV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ table_row, int j0, int hi, int nb, int Hkv,
    int h, long long pool_block_stride) {
  using L = Tile<TKV, HD>;
  constexpr int PER_BLOCK = BS * L::CHUNKS;
  for (int ci = threadIdx.x; ci < L::NSTAGE * PER_BLOCK; ci += NTHREADS) {
    const int s = ci / PER_BLOCK;
    const int j = j0 + s;
    if (j >= hi) break;  // ci grows with s: the rest of the stage is past hi
    const int raw = table_row[j];
    if (OWNED_ONLY && (raw < 0 || raw >= nb)) continue;
    const int blk = min(max(raw, 0), nb - 1);
    const int key = (ci % PER_BLOCK) / L::CHUNKS;
    const int c = ci % L::CHUNKS;
    const long long src = static_cast<long long>(blk) * pool_block_stride +
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
      const int blk = min(max(table_row[j], 0), nb - 1);
      const long long si = (static_cast<long long>(blk) * Hkv + h) * BS + t % BS;
      cp_async4(ksdst + t, k_scale + si);
      cp_async4(vsdst + t, v_scale + si);
    }
  }
}

template <typename TQ, typename TKV, bool QUANT, int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ offsets, TQ* __restrict__ out,
                       int Hkv, int R, int S_in, int nb, int mb,
                       long long pool_block_stride, int table_stride,
                       int window, float sm_scale, int split) {
  using L = Tile<TKV, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_buf = smem;                    // 2 stages
  unsigned char* v_buf = k_buf + 2 * L::STAGE;    // 2 stages
  float* ks_buf = reinterpret_cast<float*>(v_buf + 2 * L::STAGE);
  float* vs_buf = ks_buf + 2 * L::SCALES;
  float* q_s = vs_buf + 2 * L::SCALES;            // [ROWS][HD]
  float* p_s = q_s + ROWS * HD;                   // [NWARPS][32]

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  // split mode: every warp holds all R (<= RPW) rows and takes its share
  // of each stage's blocks; row mode: warps hold different rows
  const int r0 = split ? 0 : blockIdx.y * ROWS;
  const int cta_rows = split ? R : ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int off = offsets[b];

  // the positions this CTA's rows hold bound the KV blocks it walks:
  // causal above (the block of the last row's own position), the window
  // below (the first block the earliest row can still see)
  int s_min = S_in;
  int s_max = -1;
  for (int i = 0; i < cta_rows && r0 + i < R; ++i) {
    const int s = (r0 + i) % S_in;
    s_min = min(s_min, s);
    s_max = max(s_max, s);
  }
  const int hi = min((off + s_max) / BS + 1, mb);
  const int lo = window > 0 ? max(0, off + s_min - window + 1) / BS : 0;
  const int nstages = hi > lo ? (hi - lo + L::NSTAGE - 1) / L::NSTAGE : 0;
  const int* table_row = tables + static_cast<long long>(b) * table_stride;

  if (nstages > 0) {
    copy_stage<TKV, HD, QUANT>(k_buf, v_buf, ks_buf, vs_buf, k_pool, v_pool,
                                k_scale, v_scale, table_row, lo, hi, nb, Hkv,
                                h, pool_block_stride);
    cp_async_commit();
  }

  const TQ* qb = q + static_cast<long long>(bh) * R * HD;
  for (int e = threadIdx.x; e < cta_rows * HD; e += NTHREADS) {
    const int r = r0 + e / HD;
    q_s[e] = r < R ? to_f(qb[static_cast<long long>(r) * HD + e % HD]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][L::DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < L::DPL; ++u) acc[i][u] = 0.f;
  }
  const int key = lane / LPK;
  const int part = lane % LPK;

  for (int st = 0; st < nstages; ++st) {
    const int cur = st & 1;
    if (st + 1 < nstages) {  // prefetch the next stage into the other buffer
      const int nxt = cur ^ 1;
      copy_stage<TKV, HD, QUANT>(
          k_buf + nxt * L::STAGE, v_buf + nxt * L::STAGE,
          ks_buf + nxt * L::SCALES, vs_buf + nxt * L::SCALES, k_pool, v_pool,
          k_scale, v_scale, table_row, lo + (st + 1) * L::NSTAGE, hi, nb,
          Hkv, h, pool_block_stride);
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
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rl = split ? i : warp + NWARPS * i;
        const int r = r0 + rl;
        if (r >= R) break;  // warp-uniform
        const int qpos = off + r % S_in;

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
        float sc = dot;
        if (QUANT) sc *= kss[s * BS + key];
        sc *= sm_scale;
        const int kpos = j * BS + key;
        bool keep = kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        sc = keep ? sc : NEG_INF;

        float mx = sc;
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float p = expf(sc - m_new);
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
        float a[L::DPL];
#pragma unroll
        for (int u = 0; u < L::DPL; ++u) a[u] = acc[i][u] * corr;
#pragma unroll
        for (int k = 0; k < BS; ++k) {
          const float pk = p_s[warp * 32 + k];
          float vv[L::DPL];
          load_f<TKV, L::DPL>(
              vt + (s * BS + k) * L::ROW + lane * L::DPL * sizeof(TKV), vv);
#pragma unroll
          for (int u = 0; u < L::DPL; ++u) a[u] += pk * vv[u];
        }
#pragma unroll
        for (int u = 0; u < L::DPL; ++u) acc[i][u] = a[u];
        __syncwarp();
        m[i] = m_new;
      }
    }
    __syncthreads();  // the buffer is refilled two stages on
  }

  // l > 0 for every row whose own position lies inside the table; a
  // padded row past it writes zeros rather than dividing by zero
  if (!split) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = r0 + warp + NWARPS * i;
      if (r >= R) break;
      TQ* o = out + (static_cast<long long>(bh) * R + r) * HD + lane * L::DPL;
#pragma unroll
      for (int u = 0; u < L::DPL; ++u)
        o[u] = from_f<TQ>(l[i] > 0.f ? acc[i][u] / l[i] : 0.f);
    }
    return;
  }
  // split mode: merge the warps' online-softmax states row by row, in the
  // K buffers (no copy is in flight any more)
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
  if (warp < R) {
    const int i = warp;
    float mm = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, comb[(w * RPW + i) * CW]);
    float ll = 0.f;
    float a[L::DPL];
#pragma unroll
    for (int u = 0; u < L::DPL; ++u) a[u] = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float* c = comb + (w * RPW + i) * CW;
      const float f = expf(c[0] - mm);
      ll += c[1] * f;
#pragma unroll
      for (int u = 0; u < L::DPL; ++u) a[u] += c[2 + lane * L::DPL + u] * f;
    }
    TQ* o = out + (static_cast<long long>(bh) * R + i) * HD + lane * L::DPL;
#pragma unroll
    for (int u = 0; u < L::DPL; ++u)
      o[u] = from_f<TQ>(ll > 0.f ? a[u] / ll : 0.f);
  }
}

// dynamic shared memory of one CTA: two stages of K and V tiles, their
// scales, the q rows and the per-warp probabilities
template <typename TKV, int HD>
constexpr size_t smem_bytes() {
  using L = Tile<TKV, HD>;
  return 4 * L::STAGE +
         sizeof(float) * (4 * L::SCALES + ROWS * HD + NWARPS * 32);
}

template <typename TQ, typename TKV, bool QUANT, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* offsets, void* out, int B,
                   int Hkv, int R, int S_in, int nb, int mb,
                   long long pool_block_stride, int table_stride, int window,
                   float sm_scale, cudaStream_t stream) {
  using L = Tile<TKV, HD>;
  static_assert(2 * L::STAGE >= NWARPS * RPW * (HD + 2) * sizeof(float),
                "the split-mode merge fits in the K buffers");
  const size_t smem = smem_bytes<TKV, HD>();
  auto kernel = paged_attention_kernel<TQ, TKV, QUANT, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int split = R <= RPW ? 1 : 0;
  const dim3 grid(B * Hkv, split ? 1 : (R + ROWS - 1) / ROWS);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(offsets), static_cast<TQ*>(out), Hkv, R, S_in,
      nb, mb, pool_block_stride, table_stride, window, sm_scale, split);
  return cudaGetLastError();
}


// ------------------------------------------------------------------ K2
//
// One ring hop of context-parallel paged attention.  Replaces the TPU
// kernel `paged_carry_attention` (torchdistpackage_tpu/ops/
// paged_attention.py:509, body `_cp_kernel` :332).  It is K1's walk —
// the same grid, stages, per-CTA block bounds (causal `hi`, window `lo`),
// split and row modes — over ONE rank's pool slice [nb, Hkv, BS, hd],
// reached through a table re-based by that slice's first global block,
// and it returns the raw online-softmax carry (acc [R, hd], m [R], l [R]
// per (slot, KV head), f32) instead of the normalised output.  The ring
// passes the carry from hop to hop and divides acc / l once at the end.
//
// What differs from K1, and why:
// - Ownership.  A re-based entry outside [0, nb) names another rank's
//   block.  It is neither copied (reading it would run out of the slice,
//   and skipping it saves its bytes) nor scored: the walk skips the block,
//   which is exactly a mask whose probabilities are 0.
// - The carry.  Rows start from (acc_in, m_in, l_in) when given, else
//   from (0, NEG_INF, 0).  In split mode (R <= RPW rows, blocks spread
//   over the warps) only warp 0 starts from it, so the carry enters the
//   final merge of the warps' states once.
// - No normalisation and no `l > 0` guard: a row that has met no owned
//   key keeps l = 0 and m = NEG_INF, and a masked key adds exactly 0 to l
//   and acc (p = 0 where the key is masked), so such a row leaves the hop
//   as it came in.  Only the finish divides.
// - P is rounded to the pool dtype before P.V, as `_cp_kernel` :394
//   does (and K1); l sums the unrounded P.
// - No int8 pools (the TPU kernel refuses them too).
//
// What bounds it on an H100: as K1 — the bytes of the slice's live owned
// blocks at decode, the f32 products on the CUDA cores for a prefill
// chunk.  Making it fast (tensor cores for the chunk, splitting a long
// context over CTAs for decode) is shared with K1 and later work.
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
paged_carry_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ tables,
                   const int* __restrict__ offsets,
                   const float* __restrict__ acc_in,
                   const float* __restrict__ m_in,
                   const float* __restrict__ l_in,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int Hkv, int R, int S_in,
                   int nb, int mb, long long pool_block_stride,
                   int table_stride, int window, float sm_scale,
                   int split) {
  using L = Tile<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_buf = smem;                    // 2 stages
  unsigned char* v_buf = k_buf + 2 * L::STAGE;    // 2 stages
  float* q_s = reinterpret_cast<float*>(v_buf + 2 * L::STAGE);  // [ROWS][HD]
  float* p_s = q_s + ROWS * HD;                   // [NWARPS][32]

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int r0 = split ? 0 : blockIdx.y * ROWS;
  const int cta_rows = split ? R : ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int off = offsets[b];
  const long long row0 = static_cast<long long>(bh) * R;

  int s_min = S_in;
  int s_max = -1;
  for (int i = 0; i < cta_rows && r0 + i < R; ++i) {
    const int s = (r0 + i) % S_in;
    s_min = min(s_min, s);
    s_max = max(s_max, s);
  }
  const int hi = min((off + s_max) / BS + 1, mb);
  const int lo = window > 0 ? max(0, off + s_min - window + 1) / BS : 0;
  const int nstages = hi > lo ? (hi - lo + L::NSTAGE - 1) / L::NSTAGE : 0;
  const int* table_row = tables + static_cast<long long>(b) * table_stride;

  if (nstages > 0) {
    copy_stage<T, HD, false, true>(k_buf, v_buf, nullptr, nullptr, k_pool,
                                   v_pool, nullptr, nullptr, table_row, lo,
                                   hi, nb, Hkv, h, pool_block_stride);
    cp_async_commit();
  }

  const T* qb = q + row0 * HD;
  for (int e = threadIdx.x; e < cta_rows * HD; e += NTHREADS) {
    const int r = r0 + e / HD;
    q_s[e] = r < R ? to_f(qb[static_cast<long long>(r) * HD + e % HD]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][L::DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = split ? i : r0 + warp + NWARPS * i;
    const bool seed = acc_in != nullptr && r < R && (!split || warp == 0);
    m[i] = seed ? m_in[row0 + r] : NEG_INF;
    l[i] = seed ? l_in[row0 + r] : 0.f;
#pragma unroll
    for (int u = 0; u < L::DPL; ++u)
      acc[i][u] = seed ? acc_in[(row0 + r) * HD + lane * L::DPL + u] : 0.f;
  }
  const int key = lane / LPK;
  const int part = lane % LPK;

  for (int st = 0; st < nstages; ++st) {
    const int cur = st & 1;
    if (st + 1 < nstages) {  // prefetch the next stage into the other buffer
      const int nxt = cur ^ 1;
      copy_stage<T, HD, false, true>(
          k_buf + nxt * L::STAGE, v_buf + nxt * L::STAGE, nullptr, nullptr,
          k_pool, v_pool, nullptr, nullptr, table_row,
          lo + (st + 1) * L::NSTAGE, hi, nb, Hkv, h, pool_block_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kt = k_buf + cur * L::STAGE;
    const unsigned char* vt = v_buf + cur * L::STAGE;

    for (int s = split ? warp : 0; s < L::NSTAGE; s += split ? NWARPS : 1) {
      const int j = lo + st * L::NSTAGE + s;
      if (j >= hi) break;
      const int raw = table_row[j];
      if (raw < 0 || raw >= nb) continue;  // another rank's block
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rl = split ? i : warp + NWARPS * i;
        const int r = r0 + rl;
        if (r >= R) break;  // warp-uniform
        const int qpos = off + r % S_in;

        const float* qr = q_s + rl * HD;
        const unsigned char* kr = kt + (s * BS + key) * L::ROW;
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < L::CHUNKS / LPK; ++t) {
          const int c = part + LPK * t;
          float kv[L::EPC];
          load_f<T, L::EPC>(kr + c * 16, kv);
#pragma unroll
          for (int u = 0; u < L::EPC; ++u) dot += qr[c * L::EPC + u] * kv[u];
        }
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const int kpos = j * BS + key;
        bool keep = kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        const float sc = keep ? dot * sm_scale : NEG_INF;

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

        if (part == 0) p_s[warp * 32 + key] = round_like<T>(p);
        __syncwarp();
        float a[L::DPL];
#pragma unroll
        for (int u = 0; u < L::DPL; ++u) a[u] = acc[i][u] * corr;
#pragma unroll
        for (int k = 0; k < BS; ++k) {
          const float pk = p_s[warp * 32 + k];
          float vv[L::DPL];
          load_f<T, L::DPL>(
              vt + (s * BS + k) * L::ROW + lane * L::DPL * sizeof(T), vv);
#pragma unroll
          for (int u = 0; u < L::DPL; ++u) a[u] += pk * vv[u];
        }
#pragma unroll
        for (int u = 0; u < L::DPL; ++u) acc[i][u] = a[u];
        __syncwarp();
        m[i] = m_new;
      }
    }
    __syncthreads();  // the buffer is refilled two stages on
  }

  if (!split) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = r0 + warp + NWARPS * i;
      if (r >= R) break;
      float* o = acc_out + (row0 + r) * HD + lane * L::DPL;
#pragma unroll
      for (int u = 0; u < L::DPL; ++u) o[u] = acc[i][u];
      if (lane == 0) {
        m_out[row0 + r] = m[i];
        l_out[row0 + r] = l[i];
      }
    }
    return;
  }
  // split mode: merge the warps' states row by row, in the K buffers (no
  // copy is in flight any more); the carry came in through warp 0 alone
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
  if (warp < R) {
    const int i = warp;
    float mm = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, comb[(w * RPW + i) * CW]);
    float ll = 0.f;
    float a[L::DPL];
#pragma unroll
    for (int u = 0; u < L::DPL; ++u) a[u] = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float* c = comb + (w * RPW + i) * CW;
      const float f = expf(c[0] - mm);
      ll += c[1] * f;
#pragma unroll
      for (int u = 0; u < L::DPL; ++u) a[u] += c[2 + lane * L::DPL + u] * f;
    }
    float* o = acc_out + (row0 + i) * HD + lane * L::DPL;
#pragma unroll
    for (int u = 0; u < L::DPL; ++u) o[u] = a[u];
    if (lane == 0) {
      m_out[row0 + i] = mm;
      l_out[row0 + i] = ll;
    }
  }
}

// dynamic shared memory of one K2 CTA: two stages of K and V tiles, the q
// rows and the per-warp probabilities
template <typename T, int HD>
constexpr size_t carry_smem_bytes() {
  using L = Tile<T, HD>;
  return 4 * L::STAGE + sizeof(float) * (ROWS * HD + NWARPS * 32);
}

template <typename T, int HD>
cudaError_t launch_carry(const void* q, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* offsets, const void* acc_in,
                         const void* m_in, const void* l_in, void* acc_out,
                         void* m_out, void* l_out, int B, int Hkv, int R,
                         int S_in, int nb, int mb,
                         long long pool_block_stride, int table_stride,
                         int window, float sm_scale, cudaStream_t stream) {
  using L = Tile<T, HD>;
  static_assert(2 * L::STAGE >= NWARPS * RPW * (HD + 2) * sizeof(float),
                "the split-mode merge fits in the K buffers");
  const size_t smem = carry_smem_bytes<T, HD>();
  auto kernel = paged_carry_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int split = R <= RPW ? 1 : 0;
  const dim3 grid(B * Hkv, split ? 1 : (R + ROWS - 1) / ROWS);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(offsets), static_cast<const float*>(acc_in),
      static_cast<const float*>(m_in), static_cast<const float*>(l_in),
      static_cast<float*>(acc_out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), Hkv, R, S_in, nb, mb, pool_block_stride,
      table_stride, window, sm_scale, split);
  return cudaGetLastError();
}

}  // namespace

// dtype_tag: 0 = bf16 q / bf16 pool, 1 = f32 q / f32 pool,
//            2 = bf16 q / int8 pool, 3 = f32 q / int8 pool (f32 scales).
// window <= 0 means no sliding window.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int tdp_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* offsets, void* out, int B, int Hkv, int R, int S_in, int hd,
    int nb, int bs, int mb, long long pool_block_stride, int table_stride,
    int window, float sm_scale, int dtype_tag, void* stream) {
  if (bs != BS || (hd != 64 && hd != 128) || B < 1 || Hkv < 1 || R < 1 ||
      S_in < 1 || nb < 1 || mb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TDP_LAUNCH(TQ, TKV, QUANT, HD)                                      \
  launch<TQ, TKV, QUANT, HD>(q, k_pool, v_pool, k_scale, v_scale, tables,   \
                             offsets, out, B, Hkv, R, S_in, nb, mb,         \
                             pool_block_stride, table_stride, window,       \
                             sm_scale, st)
  cudaError_t err;
  switch (dtype_tag * 2 + (hd == 128 ? 1 : 0)) {
    case 0: err = TDP_LAUNCH(__nv_bfloat16, __nv_bfloat16, false, 64); break;
    case 1: err = TDP_LAUNCH(__nv_bfloat16, __nv_bfloat16, false, 128); break;
    case 2: err = TDP_LAUNCH(float, float, false, 64); break;
    case 3: err = TDP_LAUNCH(float, float, false, 128); break;
    case 4: err = TDP_LAUNCH(__nv_bfloat16, int8_t, true, 64); break;
    case 5: err = TDP_LAUNCH(__nv_bfloat16, int8_t, true, 128); break;
    case 6: err = TDP_LAUNCH(float, int8_t, true, 64); break;
    case 7: err = TDP_LAUNCH(float, int8_t, true, 128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TDP_LAUNCH
  return static_cast<int>(err);
}

// Dynamic shared memory a CTA of the given dtype tag and head dim uses
// (reported beside ptxas' registers by the build check); -1 if unknown.
extern "C" int tdp_paged_attention_smem_bytes(int dtype_tag, int hd) {
  if (hd != 64 && hd != 128) return -1;
  const bool h128 = hd == 128;
  switch (dtype_tag) {
    case 0: return static_cast<int>(h128 ? smem_bytes<__nv_bfloat16, 128>()
                                         : smem_bytes<__nv_bfloat16, 64>());
    case 1: return static_cast<int>(h128 ? smem_bytes<float, 128>()
                                         : smem_bytes<float, 64>());
    case 2:
    case 3: return static_cast<int>(h128 ? smem_bytes<int8_t, 128>()
                                         : smem_bytes<int8_t, 64>());
    default: return -1;
  }
}

// K2, one ring hop.  dtype_tag: 0 = bf16 q / bf16 pool, 1 = f32 q / f32
// pool.  acc_in / m_in / l_in: the incoming carry ([B, Hkv, R, hd],
// [B, Hkv, R], [B, Hkv, R] f32), all null for the first hop; the outputs
// are distinct buffers of the same shapes.  tables hold re-based ids:
// entries outside [0, nb) are another rank's blocks.  window <= 0 means
// no sliding window.  Returns cudaGetLastError() after the launch.
extern "C" int tdp_paged_carry_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* offsets, const void* acc_in,
    const void* m_in, const void* l_in, void* acc_out, void* m_out,
    void* l_out, int B, int Hkv, int R, int S_in, int hd, int nb, int bs,
    int mb, long long pool_block_stride, int table_stride, int window,
    float sm_scale, int dtype_tag, void* stream) {
  if (bs != BS || (hd != 64 && hd != 128) || B < 1 || Hkv < 1 || R < 1 ||
      S_in < 1 || nb < 1 || mb < 1 ||
      ((acc_in == nullptr) != (m_in == nullptr)) ||
      ((acc_in == nullptr) != (l_in == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TDP_LAUNCH(T, HD)                                                   \
  launch_carry<T, HD>(q, k_pool, v_pool, tables, offsets, acc_in, m_in,     \
                      l_in, acc_out, m_out, l_out, B, Hkv, R, S_in, nb, mb, \
                      pool_block_stride, table_stride, window, sm_scale, st)
  cudaError_t err;
  switch (dtype_tag * 2 + (hd == 128 ? 1 : 0)) {
    case 0: err = TDP_LAUNCH(__nv_bfloat16, 64); break;
    case 1: err = TDP_LAUNCH(__nv_bfloat16, 128); break;
    case 2: err = TDP_LAUNCH(float, 64); break;
    case 3: err = TDP_LAUNCH(float, 128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TDP_LAUNCH
  return static_cast<int>(err);
}

// Dynamic shared memory a K2 CTA of the given dtype tag and head dim uses;
// -1 if unknown.
extern "C" int tdp_paged_carry_attention_smem_bytes(int dtype_tag, int hd) {
  if (hd != 64 && hd != 128) return -1;
  const bool h128 = hd == 128;
  switch (dtype_tag) {
    case 0: return static_cast<int>(
        h128 ? carry_smem_bytes<__nv_bfloat16, 128>()
             : carry_smem_bytes<__nv_bfloat16, 64>());
    case 1: return static_cast<int>(h128 ? carry_smem_bytes<float, 128>()
                                         : carry_smem_bytes<float, 64>());
    default: return -1;
  }
}
