// Fused MoE expert dispatch for Hopper (sm_90a): gather token rows through
// the [E, C] slot maps, run each expert's FFN, and add the gate-weighted
// result back into the [T, D] output — one launch a layer, with no
// [T, E, C] dispatch tensor and no gathered [E, C, D] slot view in device
// memory.  Two variants: float expert weights and int8 weight-only
// experts, each in three bodies (decode rows: moe_ffn_up_decode_kernel,
// moe_ffn_down_decode_kernel, then moe_ffn_merge_kernel; chunk rows:
// moe_ffn_up_wgmma_kernel then moe_ffn_down_wgmma_kernel; f32 tokens: the
// walk, moe_ffn_kernel / moe_ffn_int8_kernel).
//
// Replaces the TPU kernel K6 of torchdistpackage_tpu/ops/moe_dispatch.py:
// _pallas_moe_ffn (:289, body _kernel :202), and its quantized branch
// (_kernel :253-258, the (q8, scale) leaves of quantize_moe_experts).
//
// y[t] = sum over filled slots (e, c) with idx[e, c] = t and g = comb[e, c]
//        of g * FFN_e(x[t]),
// FFN_e(x) = (silu(x.W1[e,0] + b1[e,0]) * (x.W1[e,1] + b1[e,1])).W2[e] + b2[e]
// (SwiGLU, w1 [E, 2, D, F]) or gelu_tanh(x.W1[e] + b1[e]).W2[e] + b2[e]
// (GELU, w1 [E, D, F]); y is f32 and must be zeroed by the caller.  In the
// int8 variant W1[e, j][d, f] = q1[e, j][d, f] * s1[e, j][f] and
// W2[e][f, d] = q2[e][f, d] * s2[e][d] (one f32 scale per output column).
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16):
// - decode (T = 8 rows, top-2 of 8 experts): the bytes of every expert hit,
//   3 D F x 2 B = 352 MB an expert at Mixtral widths (D 4096, F 14336) for
//   bf16 weights, 3 D F x 1 B = 176 MB (plus 42 KB of scales) for int8; up
//   to 2.8 / 1.4 GB a layer against ~1e9 FLOP — bytes.
// - a 512-row prefill chunk of 8 slots (T = 4096): 2 (T k) 3 D F = 2.9e12
//   FLOP — operations, for either weight type.
// Three bodies, chosen by the wrapper (ops/moe_dispatch.py moe_ffn_body)
// from the capacity and the tokens' type:
// - bf16 tokens at decode's few slots: the swap-AB decode body further
//   down (its K6 mode), which streams the hit experts' weights once at
//   one CTA an SM through deep TMA stages, gathers the token rows inside
//   pass 1 and merges pass 2's partial sums in a fixed order: the output
//   is the same bits from run to run.  The walk it replaced read the
//   weights at 0.40 (int8) and 0.78 (bf16) of the byte bound: two
//   cp.async stages of 4 KB a CTA, the pipeline drained between its two
//   phases, 56 of 64 slot rows empty, and 14.7 M f32 atomics a call;
// - bf16 tokens at a chunk's capacity: the two-pass warpgroup GEMM (its
//   K6 mode), the walk's costs being what bounds a chunk: each filled
//   row's [D] output arrived as F / 64 f32 partial sums by atomics (7.5e9
//   adds at the chunk), every F tile gathered its token rows again over
//   the whole of D, and the products ran on 64 x 64 mma.sync tiles;
// - f32 tokens (a check path; no engine drives it): the walk below.
//
// The walk, against the TPU kernel:
// - The TPU kernel loads one expert's whole W1/W2 per grid step (BlockSpec
//   over everything but the expert dim).  At Mixtral widths one expert's W1
//   is 235 MB, so here a CTA owns 64 capacity slots of one expert and one
//   64-column tile of F: phase 1 walks D in 64-deep stages (gathered token
//   rows and the W1 tile double-buffered with cp.async) into the gate/up
//   accumulators, applies bias and activation in registers and keeps the
//   [64, 64] activation in shared memory; phase 2 walks D in 64-column
//   stages of W2, each a [64, 64] . [64, 64] product on the tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 accumulate); the f32 instantiations
//   compute the same tiles on the CUDA cores (exact f32, for checks).
// - The TPU grid runs in order, so it zeroes the output at its first step
//   and read-modify-writes rows.  CTAs run in parallel in no order: the
//   wrapper allocates y with torch.zeros, and each CTA adds g x its partial
//   product with f32 atomicAdd (red.global.add.f32), staged per warp
//   through shared memory so one warp instruction covers 128 contiguous
//   bytes of one token row.  The partial sums over F tiles therefore meet
//   in y in an order that changes from run to run (f32 summation order
//   only).  b2 is added once, by the CTAs of the first F tile.
// - Scalar-prefetched idx: each CTA loads its own 64 entries of idx / comb.
// - The empty-tile skip (:239) stays: a CTA whose 64 comb values are all 0
//   exits before any load, and a warp whose 16 rows are all empty skips
//   its products, so the weights are read only for the experts that were
//   hit.
// - int8: the TPU kernel dequantises the whole weight block in f32 before
//   its products.  Here the int8 tiles stay int8 in shared memory (a
//   [64 d x 64 f] stage is 4 KB, 16 weights a 16-byte cp.async) and each
//   value becomes bf16 as the mma B fragment is assembled — exact, since
//   |q| <= 127 fits bf16's 8 significant bits — or f32 on the CUDA cores
//   for f32 tokens.  The scale, one per output column, multiplies the f32
//   product once the walk over D ends: gate[f] *= s1[e,0,f] and up[f] *=
//   s1[e,1,f] (s1[e,f] for GELU) before bias and activation, partial[d] *=
//   s2[e,d] before g x and the atomic add.  That equals dequantise-then-
//   multiply in exact arithmetic (f32 rounding only) and keeps the weight
//   stream at 1 byte an element.
// - Rounding: for bf16 the activation is rounded to bf16 before the second
//   tensor-core product; the TPU kernel keeps it in f32.  Every accumulator
//   stays f32.  Fragments are assembled with 8/16/32-bit shared loads.
//
// K7, the expert FFN of expert-parallel (EP) layers: expert_ffn_kernel and
// expert_ffn_int8_kernel replace _pallas_expert_ffn (:479, pallas_call
// :506, body _ep_kernel :418) and its int8 branch (:434-439).  Under EP the
// all-to-all exchange needs the grouped [e_loc, G, D] layout in device
// memory (it is the wire payload), so only the FFN fuses:
//   y[e, g] = FFN_e(x[e, g]) for every g < G — every row, as on the TPU:
//   a pad row (an empty capacity slot, zeros) gives act(b1).W2 + b2, which
//   the combine discards.
// Bound on an H100: at decode (ep 1, [8, 8, 4096], F 14336) the bytes of
// all e_loc experts' weights, 2.8 GB bf16 -> 0.84 ms, 1.4 GB int8 -> 0.42
// ms; at a 512-row chunk of 8 slots ([8, 4096, 4096]) the operations,
// 2 e_loc G 3 D F = 1.15e13 FLOP -> 11.7 ms — E / k = 4x K6's work on the
// same chunk, the padded-compute tax of C = T that the reference's EP path
// pays by its semantics.  bf16 rounds the activation to bf16 before the
// second product, as K6 does.  Three bodies, chosen by the wrapper from
// the rows' count and type (ops/moe_dispatch.py expert_ffn_body):
// - f32 rows: the walk with the identity slot map (IDENT): slot c of
//   expert e is row e G + c of x and of y, weight 1, so there is no
//   empty-tile skip (the TPU kernel computes every row too).  Grid
//   (ceil(G / 64), F / 64, e_loc); F-tile partials meet in the zeroed f32
//   y by atomicAdd (their order varies from run to run), b2 is added by
//   the first F tile, and the wrapper casts y to x's type.
// - bf16 chunk rows (G >= 64): expert_ffn_up_wgmma_kernel and
//   expert_ffn_down_wgmma_kernel, the two-pass grouped GEMM on the
//   warpgroup MMA (described where they are defined): no atomics, no f32
//   y, output in x's type, the same bits from run to run.
// - bf16 decode rows: expert_ffn_up_decode_kernel and
//   expert_ffn_down_decode_kernel, the same two passes with A and B
//   swapped (the weight the 64-row side of wgmma, the rows the narrow
//   side), one CTA an SM streaming the weights, then
//   expert_ffn_merge_kernel, which adds pass 2's partial sums in a fixed
//   order into y in x's type: the same bits from run to run (described
//   where they are defined).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BM = NWARPS * 16;  // capacity slots a CTA owns
constexpr int BF = 64;           // columns of F a CTA owns
constexpr int BK = 64;           // depth of D a phase-1 stage
constexpr int BN = 64;           // columns of D a phase-2 stage

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// a B-fragment value as bf16: int8 converts exactly (|q| <= 127 needs 7
// significant bits of bf16's 8)
__device__ __forceinline__ __nv_bfloat16 to_bf(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_bf(int8_t x) {
  return __float2bfloat16_rn(static_cast<float>(x));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// an arrival on `bar` once every cp.async this thread has issued so far
// has landed; the barrier's count includes it (.noinc)
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(bar)))
               : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: c[j] += A[16 x K] . B[K x 8j..8j+7] for j < NT8, in the m16n8
// accumulator layout (lane = 4g + t holds rows g and g + 8, columns 2t and
// 2t + 1 of each 8-column tile).  A(m, k) = a[m * lda + k] and
// B(k, n) = b[k * ldb + n], both row-major in shared memory.  A is the
// tokens' type (bf16 or f32); B that type or int8 (converted on the way
// into the product).
template <typename TA, typename TB, int K, int NT8>
__device__ __forceinline__ void warp_gemm(float (&c)[NT8][4], const TA* a,
                                          int lda, const TB* b, int ldb) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (std::is_same<TA, __nv_bfloat16>::value) {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4];
      af[0] = ld32(a + g * lda + k0 + 2 * t);
      af[1] = ld32(a + (g + 8) * lda + k0 + 2 * t);
      af[2] = ld32(a + g * lda + k0 + 2 * t + 8);
      af[3] = ld32(a + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = j * 8 + g;
        uint32_t bf[2];
        bf[0] = pack2(to_bf(b[(k0 + 2 * t) * ldb + n]),
                      to_bf(b[(k0 + 2 * t + 1) * ldb + n]));
        bf[1] = pack2(to_bf(b[(k0 + 2 * t + 8) * ldb + n]),
                      to_bf(b[(k0 + 2 * t + 9) * ldb + n]));
        mma_bf16(c[j], af, bf);
      }
    }
  } else {
    // f32: the same layout, exact products on the CUDA cores
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = to_f(a[g * lda + k]);
      const float a1 = to_f(a[(g + 8) * lda + k]);
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = j * 8 + 2 * t;
        const float b0 = to_f(b[k * ldb + n]);
        const float b1 = to_f(b[k * ldb + n + 1]);
        c[j][0] += a0 * b0;
        c[j][1] += a0 * b1;
        c[j][2] += a1 * b0;
        c[j][3] += a1 * b1;
      }
    }
  }
}

template <int NT8>
__device__ __forceinline__ void zero(float (&c)[NT8][4]) {
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// rows x (COLS elements) from device memory (row r at src + r * stride)
// into a shared tile whose rows are LD elements apart
template <typename T, int COLS, int LD>
__device__ __forceinline__ void copy_tile(T* dst, const T* src,
                                          long long stride, int rows) {
  constexpr int CH = COLS * sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = i % CH;
    cp_async16(reinterpret_cast<unsigned char*>(dst + r * LD) + c * 16,
               reinterpret_cast<const unsigned char*>(src + r * stride) +
                   c * 16);
  }
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }
// jax.nn.gelu's default (approximate=True), as the port's dense MLP
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// Shared memory of one CTA, in bytes: T is the tokens' type, W the
// weights' (T, or int8_t).  Every row of a tile is followed by 16 bytes of
// padding, so the fragment loads of neighbouring rows fall in other banks.
template <typename T, typename W, bool SWIGLU>
struct Cfg {
  static constexpr bool Q = std::is_same<W, int8_t>::value;
  static constexpr int NW1 = SWIGLU ? 2 : 1;        // W1 tiles a stage
  static constexpr int LDX = BK + 16 / sizeof(T);   // gathered token rows
  static constexpr int LDW = BF + 16 / sizeof(W);   // W1 tiles, W2 tiles
  static constexpr int LDH = BF + 16 / sizeof(T);   // activation
  static constexpr int LDO = BN + 4;                // f32 partials, per warp
  static constexpr size_t X_BYTES = sizeof(T) * BM * LDX;
  static constexpr size_t W_BYTES = sizeof(W) * BK * LDW;  // BK == BF rows
  static constexpr size_t STAGE1 = X_BYTES + NW1 * W_BYTES;
  static constexpr size_t STAGE2 = W_BYTES;
  static constexpr size_t HEAD = 3 * BM * sizeof(int);  // idx, dst, comb
  static constexpr size_t H_BYTES = sizeof(T) * BM * LDH;
  static constexpr size_t P1 = 2 * STAGE1;
  static constexpr size_t P2 = 2 * STAGE2 + sizeof(float) * BM * LDO;
  static constexpr size_t SMEM = HEAD + H_BYTES + (P1 > P2 ? P1 : P2);
};

// One CTA of either variant.  Grid (C / 64 capacity tiles, F / 64 F tiles,
// E experts), 128 threads.  dst: the token each slot's result is added to
// (the wrapper passes idx).  s1 / s2: the int8 variant's scales (unused,
// null, for float weights).  IDENT (K7): no maps (idx, comb and dst are
// null); slot c < C of expert e reads row e C + c of x and adds into the
// same row of y with weight 1.
template <typename T, typename W, bool SWIGLU, bool IDENT = false>
__device__ __forceinline__ void moe_ffn_body(
    const T* __restrict__ x, const int* __restrict__ idx,
    const float* __restrict__ comb, const int* __restrict__ dst,
    const W* __restrict__ w1, const float* __restrict__ s1,
    const T* __restrict__ b1, const W* __restrict__ w2,
    const float* __restrict__ s2, const T* __restrict__ b2,
    float* __restrict__ y, int D, int F, int C) {
  using G = Cfg<T, W, SWIGLU>;
  constexpr int LDX = G::LDX, LDW = G::LDW, LDH = G::LDH, LDO = G::LDO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* idx_s = reinterpret_cast<int*>(smem_raw);
  int* dst_s = idx_s + BM;
  float* comb_s = reinterpret_cast<float*>(dst_s + BM);
  T* hs = reinterpret_cast<T*>(smem_raw + G::HEAD);
  unsigned char* buf = smem_raw + G::HEAD + G::H_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BF;
  const int e = blockIdx.z;

  // this CTA's slots; a tile with no filled slot exits before any load
  float gv = 0.f;
  if (tid < BM) {
    const int c = c0 + tid;
    const long long s = static_cast<long long>(e) * C + c;
    const bool in = c < C;
    if constexpr (IDENT) {
      gv = in ? 1.f : 0.f;
      idx_s[tid] = in ? static_cast<int>(s) : 0;
      dst_s[tid] = idx_s[tid];
    } else {
      gv = in ? comb[s] : 0.f;
      idx_s[tid] = in ? idx[s] : 0;
      dst_s[tid] = in ? dst[s] : 0;
    }
    comb_s[tid] = gv;
  }
  if (!__syncthreads_or(gv != 0.f)) return;
  // a warp whose 16 rows are all empty skips its products and its adds
  const bool live = __any_sync(0xffffffffu,
                               lane < 16 && comb_s[warp * 16 + lane] != 0.f);

  // ---- phase 1: gate (and up) = X[64, D] . W1[e][D, f0:f0+64]
  const long long wstride = static_cast<long long>(D) * F;
  const W* wg = w1 + static_cast<long long>(e) * G::NW1 * wstride + f0;
  const W* wu = wg + wstride;  // SwiGLU's up projection
  auto xs_at = [&](int stage) {
    return reinterpret_cast<T*>(buf + stage * G::STAGE1);
  };
  auto ws_at = [&](int stage) {
    return reinterpret_cast<W*>(buf + stage * G::STAGE1 + G::X_BYTES);
  };
  auto fetch1 = [&](int k0, int stage) {
    T* xs = xs_at(stage);
    W* ws = ws_at(stage);
    constexpr int CH = BK * sizeof(T) / 16;
    for (int i = tid; i < BM * CH; i += NTHREADS) {
      const int r = i / CH;
      const int c = i % CH;
      const bool filled = comb_s[r] != 0.f;
      const T* src = x + static_cast<long long>(filled ? idx_s[r] : 0) * D +
                     k0;
      cp_async16(reinterpret_cast<unsigned char*>(xs + r * LDX) + c * 16,
                 reinterpret_cast<const unsigned char*>(src) + c * 16,
                 filled ? 16 : 0);
    }
    copy_tile<W, BF, LDW>(ws, wg + static_cast<long long>(k0) * F, F, BK);
    if (SWIGLU)
      copy_tile<W, BF, LDW>(ws + BK * LDW, wu + static_cast<long long>(k0) * F,
                            F, BK);
  };

  float gate[BF / 8][4], up[BF / 8][4];
  zero(gate);
  zero(up);
  const int nk = D / BK;
  fetch1(0, 0);
  cp_async_commit();
  for (int kk = 0; kk < nk; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < nk) {
      fetch1((kk + 1) * BK, cur ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const T* xs = xs_at(cur) + warp * 16 * LDX;
      const W* ws = ws_at(cur);
      warp_gemm<T, W, BK, BF / 8>(gate, xs, LDX, ws, LDW);
      if (SWIGLU)
        warp_gemm<T, W, BK, BF / 8>(up, xs, LDX, ws + BK * LDW, LDW);
    }
    __syncthreads();  // every warp is done with this stage
  }

  // (int8: each column's scale,) bias and activation in registers; the
  // activation in T (bf16: rounded before the second product)
  if (live) {
    const long long row1 = static_cast<long long>(e) * G::NW1 * F + f0;
    const T* bg = b1 + row1;
#pragma unroll
    for (int jj = 0; jj < BF / 8; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = warp * 16 + g + (q >> 1) * 8;
        const int col = jj * 8 + 2 * t + (q & 1);
        float a = gate[jj][q], u = up[jj][q];
        if constexpr (G::Q) {
          a *= s1[row1 + col];
          if (SWIGLU) u *= s1[row1 + F + col];
        }
        float h;
        if (SWIGLU)
          h = silu(a + to_f(bg[col])) * (u + to_f(bg[F + col]));
        else
          h = gelu_tanh(a + to_f(bg[col]));
        hs[row * LDH + col] = from_f<T>(h);
      }
  }

  // ---- phase 2: y[dst] += g * (H[64, 64] . W2[e][f0:f0+64, d0:d0+64] + b2)
  const W* w2e = w2 + (static_cast<long long>(e) * F + f0) * D;
  const T* b2e = b2 + static_cast<long long>(e) * D;
  const float* s2e = G::Q ? s2 + static_cast<long long>(e) * D : nullptr;
  auto w2_at = [&](int stage) {
    return reinterpret_cast<W*>(buf + stage * G::STAGE2);
  };
  float* os = reinterpret_cast<float*>(buf + 2 * G::STAGE2) +
              warp * 16 * LDO;
  const bool first_tile = blockIdx.y == 0;
  const int nd = D / BN;
  copy_tile<W, BN, LDW>(w2_at(0), w2e, D, BF);
  cp_async_commit();
  for (int dd = 0; dd < nd; ++dd) {
    const int cur = dd & 1;
    if (dd + 1 < nd) {
      copy_tile<W, BN, LDW>(w2_at(cur ^ 1), w2e + (dd + 1) * BN, D, BF);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the stage has landed (and, at dd 0, every h row)
    if (live) {
      const int d0 = dd * BN;
      float acc[BN / 8][4];
      zero(acc);
      warp_gemm<T, W, BF, BN / 8>(acc, hs + warp * 16 * LDH, LDH, w2_at(cur),
                                  LDW);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = jj * 8 + 2 * t + (q & 1);
          float v = acc[jj][q];
          if constexpr (G::Q) v *= s2e[d0 + col];
          os[(g + (q >> 1) * 8) * LDO + col] =
              v + (first_tile ? to_f(b2e[d0 + col]) : 0.f);
        }
      __syncwarp();
      // one row at a time: 32 lanes on 32 contiguous floats of one token
      for (int r = 0; r < 16; ++r) {
        const float w = comb_s[warp * 16 + r];
        if (w == 0.f) continue;
        float* yr = y + static_cast<long long>(dst_s[warp * 16 + r]) * D + d0;
        atomicAdd(yr + lane, w * os[r * LDO + lane]);
        atomicAdd(yr + lane + 32, w * os[r * LDO + lane + 32]);
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this stage
  }
}

template <typename T, bool SWIGLU>
__global__ void __launch_bounds__(NTHREADS)
moe_ffn_kernel(const T* __restrict__ x, const int* __restrict__ idx,
               const float* __restrict__ comb, const int* __restrict__ dst,
               const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ b2,
               float* __restrict__ y, int D, int F, int C) {
  moe_ffn_body<T, T, SWIGLU>(x, idx, comb, dst, w1, nullptr, b1, w2, nullptr,
                             b2, y, D, F, C);
}

template <typename T, bool SWIGLU>
__global__ void __launch_bounds__(NTHREADS)
moe_ffn_int8_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    const float* __restrict__ comb,
                    const int* __restrict__ dst,
                    const int8_t* __restrict__ q1,
                    const float* __restrict__ s1, const T* __restrict__ b1,
                    const int8_t* __restrict__ q2,
                    const float* __restrict__ s2, const T* __restrict__ b2,
                    float* __restrict__ y, int D, int F, int C) {
  moe_ffn_body<T, int8_t, SWIGLU>(x, idx, comb, dst, q1, s1, b1, q2, s2, b2,
                                  y, D, F, C);
}

template <typename T, bool SWIGLU>
cudaError_t launch(const void* x, const void* idx, const void* comb,
                   const void* dst, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y, int D, int F,
                   int E, int C, cudaStream_t st) {
  using G = Cfg<T, T, SWIGLU>;
  auto kernel = moe_ffn_kernel<T, SWIGLU>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((C + BM - 1) / BM, F / BF, E);
  kernel<<<grid, NTHREADS, G::SMEM, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(comb), static_cast<const int*>(dst),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<float*>(y), D, F, C);
  return cudaGetLastError();
}

template <typename T, bool SWIGLU>
cudaError_t launch_int8(const void* x, const void* idx, const void* comb,
                        const void* dst, const void* q1, const void* s1,
                        const void* b1, const void* q2, const void* s2,
                        const void* b2, void* y, int D, int F, int E, int C,
                        cudaStream_t st) {
  using G = Cfg<T, int8_t, SWIGLU>;
  auto kernel = moe_ffn_int8_kernel<T, SWIGLU>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((C + BM - 1) / BM, F / BF, E);
  kernel<<<grid, NTHREADS, G::SMEM, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(comb), static_cast<const int*>(dst),
      static_cast<const int8_t*>(q1), static_cast<const float*>(s1),
      static_cast<const T*>(b1), static_cast<const int8_t*>(q2),
      static_cast<const float*>(s2), static_cast<const T*>(b2),
      static_cast<float*>(y), D, F, C);
  return cudaGetLastError();
}

bool bad_shape(int T, int D, int F, int E, int C) {
  return T < 1 || E < 1 || C < 1 || D < BK || F < BF || D % BK != 0 ||
         F % BF != 0 || E > 65535 || F / BF > 65535;
}

// K7: x [e_loc, G, D] -> y [e_loc, G, D] f32, the identity slot map
template <typename T, bool SWIGLU>
__global__ void __launch_bounds__(NTHREADS)
expert_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ b2, float* __restrict__ y, int D,
                  int F, int G) {
  moe_ffn_body<T, T, SWIGLU, true>(x, nullptr, nullptr, nullptr, w1, nullptr,
                                   b1, w2, nullptr, b2, y, D, F, G);
}

template <typename T, bool SWIGLU>
__global__ void __launch_bounds__(NTHREADS)
expert_ffn_int8_kernel(const T* __restrict__ x,
                       const int8_t* __restrict__ q1,
                       const float* __restrict__ s1, const T* __restrict__ b1,
                       const int8_t* __restrict__ q2,
                       const float* __restrict__ s2, const T* __restrict__ b2,
                       float* __restrict__ y, int D, int F, int G) {
  moe_ffn_body<T, int8_t, SWIGLU, true>(x, nullptr, nullptr, nullptr, q1, s1,
                                        b1, q2, s2, b2, y, D, F, G);
}

// K7's launch, either variant: W is T (float weights) or int8_t
template <typename T, typename W, bool SWIGLU>
cudaError_t launch_expert(const void* x, const void* w1, const void* s1,
                          const void* b1, const void* w2, const void* s2,
                          const void* b2, void* y, int D, int F, int E,
                          int G, cudaStream_t st) {
  using Gc = Cfg<T, W, SWIGLU>;
  const dim3 grid((G + BM - 1) / BM, F / BF, E);
  cudaError_t err;
  if constexpr (std::is_same<W, int8_t>::value) {
    auto kernel = expert_ffn_int8_kernel<T, SWIGLU>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Gc::SMEM));
    if (err != cudaSuccess) return err;
    kernel<<<grid, NTHREADS, Gc::SMEM, st>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w1),
        static_cast<const float*>(s1), static_cast<const T*>(b1),
        static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
        static_cast<const T*>(b2), static_cast<float*>(y), D, F, G);
  } else {
    auto kernel = expert_ffn_kernel<T, SWIGLU>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Gc::SMEM));
    if (err != cudaSuccess) return err;
    kernel<<<grid, NTHREADS, Gc::SMEM, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<float*>(y), D, F, G);
  }
  return cudaGetLastError();
}

// Q: int8 weights; otherwise the weights are of the tokens' type
template <bool Q>
cudaError_t dispatch_expert(const void* x, const void* w1, const void* s1,
                            const void* b1, const void* w2, const void* s2,
                            const void* b2, void* y, int E, int G, int D,
                            int F, int swiglu, int dtype_tag,
                            cudaStream_t st) {
  using BF16 = __nv_bfloat16;
  using WB = std::conditional_t<Q, int8_t, BF16>;
  using WF = std::conditional_t<Q, int8_t, float>;
  switch (dtype_tag * 2 + (swiglu ? 1 : 0)) {
    case 0:
      return launch_expert<BF16, WB, false>(x, w1, s1, b1, w2, s2, b2, y, D,
                                            F, E, G, st);
    case 1:
      return launch_expert<BF16, WB, true>(x, w1, s1, b1, w2, s2, b2, y, D,
                                           F, E, G, st);
    case 2:
      return launch_expert<float, WF, false>(x, w1, s1, b1, w2, s2, b2, y, D,
                                             F, E, G, st);
    case 3:
      return launch_expert<float, WF, true>(x, w1, s1, b1, w2, s2, b2, y, D,
                                            F, E, G, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// K7's rows are addressed as int (e G + c), its grid is (G/64, F/64, E)
bool bad_expert_shape(int E, int G, int D, int F) {
  return G < 1 || bad_shape(1, D, F, E, 1) ||
         static_cast<long long>(E) * G > 0x7fffffffLL;
}

// ------------------------------- chunk rows (K7 and K6) on the warpgroup MMA
//
// A two-pass grouped GEMM for bf16 rows, one body templated on the weight
// type (bf16, or int8 converted to bf16 in shared memory) and on where the
// rows come from (SLOTS):
//   pass 1 (up):   H = act(X . W1[e] + b1[e])  -> bf16
//   pass 2 (down): Y = H . W2[e] + b2[e]
// - A CTA owns 128 rows of one expert (two consumer warpgroups of 64) and
//   N output columns (pass 1: 128 of F, the gate and up accumulators side
//   by side for SwiGLU; pass 2: 256 of D), and walks the whole reduction
//   (D or F) in 64-deep stages, so every sum stays in registers.  H (bf16,
//   rounded once as the walk body rounds it) lives in device memory
//   between the passes.
// - One thread of a producer warpgroup streams the stages through TMA:
//   the rows K-major, the weight tile [64 k][N] with N contiguous, read
//   MN-major by the transpose bit (no transposed weight copy); the
//   producer hands its registers to the consumers (setmaxnreg), whose
//   accumulators take 128 a thread.  Each stage's products stay in flight
//   while the next stage's are issued (wgmma wait 1).
// - int8 weights: TMA brings the int8 tile (1 byte an element, half the
//   bf16 bytes) into a staging buffer, and the consumer warpgroups turn it
//   into the bf16 tile in the swizzled layout wgmma reads while the
//   previous stage's products run: exact (|q| <= 127 fits bf16), by
//   integer ops and one bf16x2 FMA a pair (no int-to-float conversion,
//   which runs at a sixteenth of the rate).  The conversion is in shared
//   memory, not in registers with the weight as the A operand, because A
//   from registers needs the weight K-major per row of the product and it
//   is stored N-major; every CTA converts the tiles it reads, amortised
//   over its 128 rows; three producer warps alone converted too slowly
//   to keep up with the products.  The per-column scales multiply the f32
//   sums in the epilogue, as in the walk body.
// K7 (SLOTS false): X is the exchanged [E, G, D] groups, one CTA a
// (128-row tile, column tile, expert) of the grid, H [E, G, F], output
// bf16 [E, G, D] stored once: no atomics, no f32 output, the same result
// from run to run.  K6 (SLOTS true), the slot maps of a prefill chunk:
// - The gather: TMA has no row gather on sm_90, so in pass 1 the whole
//   producer warpgroup gathers the rows: 16-byte cp.async copies, 8
//   threads a 128-byte row (one line a row per instruction), each chunk c
//   of row r placed by hand at c ^ r % 8 (the 128-byte swizzle desc_k
//   reads); an empty slot's row is zero-filled (src-size 0), as the
//   reference's where(filled, ..., 0).  Each thread's copies arrive on
//   the stage's full barrier by themselves once landed
//   (cp.async.mbarrier.arrive.noinc: 128 arrivals beside the weight
//   TMA's expect-tx), so the producers run as far ahead as the stages
//   allow; the consumers fence the async proxy after their wait, before
//   wgmma reads what the generic proxy wrote.  The weight tiles keep TMA.
// - The skip: only the non-empty 128-slot tiles are listed (a device-side
//   list, by expert, and each expert's start in it, built by the wrapper
//   with no host sync), and a grid of one CTA an SM walks (listed tile,
//   column tile) items in the K7 grid's order, so an empty tile costs
//   nothing; H is indexed by list position.
// - The combine: pass 2 keeps the whole F reduction in registers and adds
//   g (H . W2 + b2) of each filled slot into the zeroed f32 y[dst] by
//   8-byte vector atomics (red.global.add.v2.f32): one add per output
//   element and routed choice (2 at top-2, against F / 64 partial sums in
//   the walk), so at k <= 2 the sum is the same bits from run to run
//   (0 + a + b = 0 + b + a).

constexpr int FFN_BM = 128;  // rows a CTA
constexpr int FFN_BK = 64;   // reduction depth a stage
constexpr int FFN_CONSUMERS = 256;  // two warpgroups
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block can use

template <bool UP, bool Q, bool SWIGLU>
struct FfnWg {
  static constexpr int N = UP ? 128 : 256;          // output columns a CTA
  static constexpr int NW = UP && SWIGLU ? 2 : 1;   // weight tiles a stage
  static constexpr int NS = Q ? 3 : 4;              // stages
  static constexpr int THREADS = 3 * 128;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int A_BYTES = FFN_BM * FFN_BK * 2;  // X or H rows
  static constexpr int W_BYTES = FFN_BK * N * 2;       // one bf16 weight tile
  static constexpr int RAW_BYTES = Q ? FFN_BK * N : 0;  // one int8 tile
  static constexpr int STAGE = A_BYTES + NW * (W_BYTES + RAW_BYTES);
  static constexpr int BAR_BYTES = 8 * 2 * NS;
  static constexpr int TOK_BYTES = 2 * FFN_BM * 4;  // K6's gathered rows
  static constexpr size_t SMEM = 1024 + NS * STAGE + BAR_BYTES + TOK_BYTES;
};

// Two int8 weights of `word` (bytes 2 half, 2 half + 1) as a bf16x2,
// exactly, with integer ops and one bf16x2 FMA (no int -> float
// conversions, which run at a sixteenth of the rate): a byte b is -128 s +
// k (s its sign bit, k its low 7 bits), the bf16 0x4300 | k is 128 + k and
// 0x4300 | (b & 0x80) is 128 + 128 s, so b is their difference.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t word, int half) {
  const uint32_t two = __byte_perm(word, 0, half ? 0x4342 : 0x4140);
  const uint32_t v = (two & 0x007F007Fu) | 0x43004300u;
  const uint32_t neg_c = (two & 0x00800080u) | 0xC300C300u;  // -(128 + 128 s)
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(neg_c));
  return d;
}

// Threads tid < THREADS turn COLS columns of an int8 tile [64 k][LD bytes]
// (raw: its first column) into the bf16 tile wgmma reads: COLS / 64 boxes
// of [64 k][64] under the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ r % 8).
template <int COLS, int LD, int THREADS>
__device__ __forceinline__ void s8_tile_to_bf16(const unsigned char* raw,
                                                unsigned char* dst, int tid) {
  constexpr int STEPS = FFN_BK * COLS / 16;  // 16 weights a step
  static_assert(STEPS % THREADS == 0, "whole steps a thread");
#pragma unroll
  for (int j = 0; j < STEPS / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / (COLS / 16);
    const int c8 = 2 * (i % (COLS / 16));  // first 8-weight chunk
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * LD + c8 * 8);
    const uint4 lo = {s8x2_to_bf16x2(v.x, 0), s8x2_to_bf16x2(v.x, 1),
                      s8x2_to_bf16x2(v.y, 0), s8x2_to_bf16x2(v.y, 1)};
    const uint4 hi = {s8x2_to_bf16x2(v.z, 0), s8x2_to_bf16x2(v.z, 1),
                      s8x2_to_bf16x2(v.w, 0), s8x2_to_bf16x2(v.w, 1)};
    unsigned char* row = dst + (c8 / 8) * FFN_BK * 128 + r * 128;
    *reinterpret_cast<uint4*>(row + ((c8 % 8) ^ (r % 8)) * 16) = lo;
    *reinterpret_cast<uint4*>(row + (((c8 + 1) % 8) ^ (r % 8)) * 16) = hi;
  }
}

// K6's slot maps, for the warpgroup body's SLOTS mode (zeros for K7)
struct SlotMaps {
  const __nv_bfloat16* x;  // tokens [T, D]
  const int* idx;          // [E, C]: the token in each slot
  const float* comb;       // [E, C]: its gate weight, 0 where empty
  const int* dst;          // [E, C]: the token its result is added to
  const int* tiles;        // the non-empty 128-slot tiles (e ceil(C/128) + t)
  const int* offs;         // [E + 1]: listed tiles before expert e
  float* y;                // [T, D] f32, zeroed
  int C, E;
};

// One work item of the warpgroup body: expert e; its first row m0 (K7:
// of the group, K6: the slot); first output column n0; K6: i, the tile's
// position in the list (its block of H)
struct FfnItem {
  int e, m0, n0, i;
};

// One CTA of either pass.  ta: the rows (K7: X [E, G, D] or H [E, G, F];
// K6 pass 2: H [n, 128, F]; K6 pass 1 gathers them instead), bf16 boxes of
// 64 x 128 under the 128-byte swizzle.  tw: the weights viewed [E NW, K,
// NT] (W1 [E, 2, D, F] or [E, D, F]; W2 [E, F, D]) — bf16 boxes of 64 x 64
// under the swizzle, or int8 boxes of N x 64 with no swizzle that the
// consumers turn into the bf16 layout.  s: the int8 column scales ([E NW,
// NT], null for bf16 weights), b: the bias ([E NW, NT]), out: bf16 [E, G,
// NT] (K7) or [n, 128, F] (K6 pass 1; K6 pass 2 adds into sm.y).  K is
// the reduction's length (D or F), NT the output's width (F or D).
template <bool UP, bool Q, bool SWIGLU, bool SLOTS>
__device__ __forceinline__ void ffn_wgmma_body(
    const CUtensorMap& ta, const CUtensorMap& tw,
    const float* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    __nv_bfloat16* __restrict__ out, int G, int K, int NT,
    const SlotMaps& sm) {
  using C = FfnWg<UP, Q, SWIGLU>;
  constexpr int N = C::N, NW = C::NW, NS = C::NS, NBOX = N / 64;
  constexpr bool GATHER = SLOTS && UP;  // the producers gather the rows
  extern __shared__ unsigned char smem_raw[];
  // stage s: the A rows, NW weight tiles, (int8) NW raw tiles
  unsigned char* st0 = hopper::align1024(smem_raw);
  uint64_t* bar_f = reinterpret_cast<uint64_t*>(st0 + NS * C::STAGE);
  uint64_t* bar_e = bar_f + NS;  // a stage is free again
  // gathered rows: each row's token (-1: a zero row), for two items
  int* row_tok = reinterpret_cast<int*>(bar_e + NS);

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int nk = K / FFN_BK;
  // K7: the grid's one item.  K6: (listed tile, column tile) items in
  // K7's grid order — expert by expert, then column tile, the expert's
  // tiles fastest — so the CTAs in flight share one expert's weight
  // columns and rows in L2
  const int nn = (NT + N - 1) / N;  // column tiles
  const int ntc = SLOTS ? (sm.C + FFN_BM - 1) / FFN_BM : 1;
  const int n_items = SLOTS ? sm.offs[sm.E] * nn : 1;
  const int w0 = SLOTS ? blockIdx.x : 0;
  const int dw = SLOTS ? gridDim.x : 1;
  auto item = [&](int w) {
    FfnItem t;
    if constexpr (SLOTS) {
      // w / nn is a list position inside expert e's run of the list
      t.e = sm.tiles[w / nn] / ntc;
      const int o = sm.offs[t.e];
      const int ne = sm.offs[t.e + 1] - o;
      const int j = w - o * nn;
      t.n0 = (j / ne) * N;
      t.i = o + j % ne;
      t.m0 = (sm.tiles[t.i] - t.e * ntc) * FFN_BM;
    } else {
      t.e = blockIdx.z;
      t.m0 = blockIdx.x * FFN_BM;
      t.n0 = blockIdx.y * N;
      t.i = 0;
    }
    return t;
  };
  auto w_at = [&](int st, int w) {
    return st0 + st * C::STAGE + C::A_BYTES + w * C::W_BYTES;
  };
  auto raw_at = [&](int st, int w) {
    return st0 + st * C::STAGE + C::A_BYTES + NW * C::W_BYTES +
           w * C::RAW_BYTES;
  };
  // one stage's weight tiles by TMA (one thread)
  auto load_w = [&](int st, int k0, const FfnItem& t) {
    for (int w = 0; w < NW; ++w) {
      if constexpr (Q) {
        hopper::tma_load_3d(raw_at(st, w), &tw, bar_f + st, t.n0, k0,
                            t.e * NW + w);
      } else {
        for (int nb = 0; nb < NBOX; ++nb)
          hopper::tma_load_3d(w_at(st, w) + nb * FFN_BK * 128, &tw,
                              bar_f + st, t.n0 + nb * 64, k0, t.e * NW + w);
      }
    }
  };
  constexpr uint32_t W_TX = NW * (Q ? C::RAW_BYTES : C::W_BYTES);

  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      // gathered rows: the weight TMA's expect-tx and 128 copy arrivals
      hopper::mbar_init(bar_f + st, GATHER ? 1 + 128 : 1);
      hopper::mbar_init(bar_e + st, FFN_CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if constexpr (GATHER) {
      const int p = threadIdx.x - FFN_CONSUMERS;
      const int ch = p % 8;  // this thread's 16-byte chunk of its rows
      const int rb = p / 8;  // and its first row; the others 16 apart
      int it = 0, n = 0;
      for (int w = w0; w < n_items; w += dw, ++n) {
        const FfnItem t = item(w);
        // row p's token into this item's half of the table; the barrier
        // also tells every producer thread is done with item n - 2's half
        int* tok = row_tok + (n % 2) * FFN_BM;
        {
          const int c = t.m0 + p;
          const long long sl = static_cast<long long>(t.e) * sm.C + c;
          tok[p] = c < sm.C && sm.comb[sl] != 0.f ? sm.idx[sl] : -1;
        }
        asm volatile("bar.sync 2, 128;\n" ::: "memory");
        for (int kk = 0; kk < nk; ++kk, ++it) {
          const int st = it % NS;
          if (it >= NS) hopper::mbar_wait(bar_e + st, ((it / NS) - 1) & 1);
          const int k0 = kk * FFN_BK;
          if (p == 0) {
            hopper::mbar_expect_tx(bar_f + st, W_TX);
            load_w(st, k0, t);
          }
          unsigned char* a = st0 + st * C::STAGE;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int row = rb + 16 * j;
            const int tk = tok[row];
            const __nv_bfloat16* src =
                sm.x + (tk < 0 ? 0 : static_cast<long long>(tk) * K + k0 +
                                         ch * 8);
            cp_async16(a + row * 128 + ((ch ^ (row % 8)) << 4), src,
                       tk < 0 ? 0 : 16);
          }
          // arrives on its own once this thread's copies have landed
          cp_async_arrive_noinc(bar_f + st);
        }
      }
    } else if (warp == 8 && lane == 0) {
      int it = 0;
      for (int w = w0; w < n_items; w += dw) {
        const FfnItem t = item(w);
        for (int kk = 0; kk < nk; ++kk, ++it) {
          const int st = it % NS;
          if (it >= NS) hopper::mbar_wait(bar_e + st, ((it / NS) - 1) & 1);
          const int k0 = kk * FFN_BK;
          hopper::mbar_expect_tx(bar_f + st, C::A_BYTES + W_TX);
          if constexpr (SLOTS)
            hopper::tma_load_3d(st0 + st * C::STAGE, &ta, bar_f + st, k0, 0,
                                t.i);
          else
            hopper::tma_load_3d(st0 + st * C::STAGE, &ta, bar_f + st, k0,
                                t.m0, t.e);
          load_w(st, k0, t);
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<C::CONSUMER_REGS>();

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float acc[NW][N / 2];
  int it = 0;
  for (int w = w0; w < n_items; w += dw) {
    const FfnItem t = item(w);
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[v][i] = 0.f;

    for (int kk = 0; kk < nk; ++kk, ++it) {
      const int st = it % NS;
      hopper::mbar_wait(bar_f + st, (it / NS) & 1);
      // the gathered rows were written by cp.async (the generic proxy):
      // order them before this thread's wgmma reads (the async proxy)
      if constexpr (GATHER) hopper::fence_proxy_async();
      if constexpr (Q) {
        // both warpgroups convert this stage's int8 tiles while the
        // previous stage's products run, then meet before this stage's
#pragma unroll
        for (int v = 0; v < NW; ++v)
          s8_tile_to_bf16<N, N, FFN_CONSUMERS>(raw_at(st, v), w_at(st, v),
                                               threadIdx.x);
        hopper::fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(FFN_CONSUMERS) : "memory");
      }
      const uint32_t aa =
          hopper::smem_u32(st0 + st * C::STAGE) + wg * 64 * 128;
#pragma unroll
      for (int v = 0; v < NW; ++v) hopper::fence_regs(acc[v]);
      hopper::wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < FFN_BK / 16; ++k16)
#pragma unroll
        for (int v = 0; v < NW; ++v)
          hopper::Wgmma<N>::template ss<1>(
              acc[v], hopper::desc_k(aa + k16 * 32),
              hopper::desc_mn(hopper::smem_u32(w_at(st, v)) + k16 * 16 * 128,
                              FFN_BK * 128),
              1);
      hopper::wgmma_commit();
      // keep this stage's products in flight; the previous stage's are done
      hopper::wgmma_wait<1>();
#pragma unroll
      for (int v = 0; v < NW; ++v) hopper::fence_regs(acc[v]);
      if (kk > 0) hopper::mbar_arrive(bar_e + (it - 1) % NS);
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < NW; ++v) hopper::fence_regs(acc[v]);
    hopper::mbar_arrive(bar_e + (it - 1) % NS);

    // epilogue: (int8: each column's scale,) bias, (pass 1: activation,
    // rounded to bf16 once, as the walk body does,) then the bf16 store —
    // or, K6's pass 2, g x the row added into y at the slot's token
    const float* se = Q ? s + static_cast<long long>(t.e) * NW * NT : nullptr;
    const __nv_bfloat16* be = b + static_cast<long long>(t.e) * NW * NT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + (warp % 4) * 16 + g + h * 8;  // tile row
      float gv = 1.f;
      float* yrow = nullptr;
      __nv_bfloat16* orow = nullptr;
      if constexpr (SLOTS && !UP) {
        const int c = t.m0 + r;
        if (c >= sm.C) continue;
        const long long sl = static_cast<long long>(t.e) * sm.C + c;
        gv = sm.comb[sl];
        if (gv == 0.f) continue;
        yrow = sm.y + static_cast<long long>(sm.dst[sl]) * NT;
      } else if constexpr (SLOTS) {
        orow = out + (static_cast<long long>(t.i) * FFN_BM + r) * NT;
      } else {
        if (t.m0 + r >= G) continue;
        orow = out + (static_cast<long long>(t.e) * G + t.m0 + r) * NT;
      }
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = t.n0 + j * 8 + 2 * t4;  // NT is even: col + 1 < NT too
        if (col >= NT) continue;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float a = acc[0][4 * j + 2 * h + q];
          if constexpr (Q) a *= se[col + q];
          a += __bfloat162float(be[col + q]);
          if constexpr (UP && SWIGLU) {
            float u = acc[NW - 1][4 * j + 2 * h + q];
            if constexpr (Q) u *= se[NT + col + q];
            a = silu(a) * (u + __bfloat162float(be[NT + col + q]));
          } else if constexpr (UP) {
            a = gelu_tanh(a);
          }
          v[q] = a;
        }
        if constexpr (SLOTS && !UP) {  // one 8-byte vector add (sm_90)
          atomicAdd(reinterpret_cast<float2*>(yrow + col),
                    make_float2(gv * v[0], gv * v[1]));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  }
}

template <bool Q, bool SWIGLU>
__global__ void __launch_bounds__(3 * 128, 1)
expert_ffn_up_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw1,
                           const float* __restrict__ s1,
                           const __nv_bfloat16* __restrict__ b1,
                           __nv_bfloat16* __restrict__ h, int G, int D,
                           int F) {
  ffn_wgmma_body<true, Q, SWIGLU, false>(tx, tw1, s1, b1, h, G, D, F,
                                         SlotMaps{});
}

template <bool Q>
__global__ void __launch_bounds__(3 * 128, 1)
expert_ffn_down_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                             const __grid_constant__ CUtensorMap tw2,
                             const float* __restrict__ s2,
                             const __nv_bfloat16* __restrict__ b2,
                             __nv_bfloat16* __restrict__ y, int G, int D,
                             int F) {
  ffn_wgmma_body<false, Q, false, false>(th, tw2, s2, b2, y, G, F, D,
                                         SlotMaps{});
}

// K6's passes: one CTA an SM walks the listed tiles.  Pass 1 gathers its
// rows through the maps (there is no row map: tw1 stands in for it).
template <bool Q, bool SWIGLU>
__global__ void __launch_bounds__(3 * 128, 1)
moe_ffn_up_wgmma_kernel(const __grid_constant__ CUtensorMap tw1,
                        const float* __restrict__ s1,
                        const __nv_bfloat16* __restrict__ b1,
                        __nv_bfloat16* __restrict__ h, int D, int F,
                        const __grid_constant__ SlotMaps sm) {
  ffn_wgmma_body<true, Q, SWIGLU, true>(tw1, tw1, s1, b1, h, FFN_BM, D, F,
                                        sm);
}

template <bool Q>
__global__ void __launch_bounds__(3 * 128, 1)
moe_ffn_down_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                          const __grid_constant__ CUtensorMap tw2,
                          const float* __restrict__ s2,
                          const __nv_bfloat16* __restrict__ b2, int D, int F,
                          const __grid_constant__ SlotMaps sm) {
  ffn_wgmma_body<false, Q, false, true>(th, tw2, s2, b2, nullptr, FFN_BM, F,
                                        D, sm);
}

// A weight map: bf16 boxes of 64 x 64 under the swizzle, or int8 boxes of
// box_cols x 64 unswizzled
template <bool Q>
bool weight_map(CUtensorMap* map, const void* w, int outer, int rows,
                int cols, int box_cols) {
  if constexpr (Q)
    return encode_map(map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, outer, rows,
                      cols, box_cols, FFN_BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    return encode_tile_map(map, w, outer, rows, cols, FFN_BK);
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// the SMs of the current device: the persistent grids' width
cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <bool Q, bool SWIGLU>
cudaError_t launch_expert_wgmma(const void* x, const void* w1,
                                const void* s1, const void* b1,
                                const void* w2, const void* s2,
                                const void* b2, void* h, void* y, int E,
                                int G, int D, int F, cudaStream_t st) {
  using Up = FfnWg<true, Q, SWIGLU>;
  using Down = FfnWg<false, Q, false>;
  constexpr int NW = Up::NW;
  CUtensorMap tx, tw1, th, tw2;
  if (!encode_tile_map(&tx, x, E, G, D, FFN_BM) ||
      !weight_map<Q>(&tw1, w1, E * NW, D, F, Up::N) ||
      !encode_tile_map(&th, h, E, G, F, FFN_BM) ||
      !weight_map<Q>(&tw2, w2, E, F, D, Down::N))
    return cudaErrorNotSupported;
  using BF16 = __nv_bfloat16;
  auto up = expert_ffn_up_wgmma_kernel<Q, SWIGLU>;
  auto down = expert_ffn_down_wgmma_kernel<Q>;
  cudaError_t err = allow_smem(up, Up::SMEM);
  if (err == cudaSuccess) err = allow_smem(down, Down::SMEM);
  if (err != cudaSuccess) return err;
  const int mt = (G + FFN_BM - 1) / FFN_BM;
  up<<<dim3(mt, (F + Up::N - 1) / Up::N, E), Up::THREADS, Up::SMEM, st>>>(
      tx, tw1, static_cast<const float*>(s1), static_cast<const BF16*>(b1),
      static_cast<BF16*>(h), G, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  down<<<dim3(mt, (D + Down::N - 1) / Down::N, E), Down::THREADS, Down::SMEM,
         st>>>(th, tw2, static_cast<const float*>(s2),
               static_cast<const BF16*>(b2), static_cast<BF16*>(y), G, D, F);
  return cudaGetLastError();
}

template <bool Q, bool SWIGLU>
cudaError_t launch_moe_wgmma(const SlotMaps& sm, const void* w1,
                             const void* s1, const void* b1, const void* w2,
                             const void* s2, const void* b2, void* h, int D,
                             int F, cudaStream_t st) {
  using Up = FfnWg<true, Q, SWIGLU>;
  using Down = FfnWg<false, Q, false>;
  const int n_max = sm.E * ((sm.C + FFN_BM - 1) / FFN_BM);  // H's tiles
  CUtensorMap tw1, th, tw2;
  if (!weight_map<Q>(&tw1, w1, sm.E * Up::NW, D, F, Up::N) ||
      !encode_tile_map(&th, h, n_max, FFN_BM, F, FFN_BM) ||
      !weight_map<Q>(&tw2, w2, sm.E, F, D, Down::N))
    return cudaErrorNotSupported;
  using BF16 = __nv_bfloat16;
  auto up = moe_ffn_up_wgmma_kernel<Q, SWIGLU>;
  auto down = moe_ffn_down_wgmma_kernel<Q>;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) err = allow_smem(up, Up::SMEM);
  if (err == cudaSuccess) err = allow_smem(down, Down::SMEM);
  if (err != cudaSuccess) return err;
  // one CTA an SM, fewer where even a full list has fewer items
  const long long i1 = static_cast<long long>(n_max) * ((F + Up::N - 1) /
                                                        Up::N);
  const long long i2 = static_cast<long long>(n_max) * ((D + Down::N - 1) /
                                                        Down::N);
  up<<<static_cast<int>(i1 < sms ? i1 : sms), Up::THREADS, Up::SMEM, st>>>(
      tw1, static_cast<const float*>(s1), static_cast<const BF16*>(b1),
      static_cast<BF16*>(h), D, F, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  down<<<static_cast<int>(i2 < sms ? i2 : sms), Down::THREADS, Down::SMEM,
         st>>>(th, tw2, static_cast<const float*>(s2),
               static_cast<const BF16*>(b2), D, F, sm);
  return cudaGetLastError();
}

// ------------------------- decode rows (K7 and K6): swap A and B, stream K
//
// At decode the rows are few (K7: e_loc 8 experts of G 8 at EP 1; K6: 8
// tokens' 16 routed choices over the experts they hit) and every weight
// byte is read once: 2.8 GB bf16 / 1.4 GB int8 a layer for all 8
// experts, a bound set by bytes.  The warpgroup body above would waste
// 15/16 of each 128-row tile, so this body swaps the operands: H^T [F, G]
// = W1^T . X^T and Y^T [D, G] = W2^T . H^T, the weight tile the A operand
// (64 of its columns a consumer warpgroup, read MN-major by the transpose
// bit on A, no transposed copy) and the rows the N side (NR: 16, 32 or
// 64 for K7, 16 for K6).
// - The weight stream is the work: one thread of the producer warpgroup
//   keeps as many stages in flight as shared memory holds (3-16), one CTA
//   an SM; a pass that streams one weight (pass 2, GELU's pass 1) takes
//   its stages 128 deep, which halves their fixed costs.  Pass 1 gives
//   each CTA a contiguous run of whole (rows, 128 F columns) units, since
//   the activation needs each whole D sum; pass 2 cuts the (rows, 128 D
//   columns) units x F stages evenly between the CTAs (stream-K), so
//   every SM streams the same bytes.
// - Pass 2 uses no atomics: each CTA writes the f32 partial sum of each
//   unit its run meets into its own slots of a scratch the host sizes
//   from the grid ([grid, segs, NR, 128]), and a merge launch adds, for
//   each output element, the runs that met its unit in run order, then
//   the int8 scale and b2 (K7: stored in x's type; K6: each routed choice
//   of the token in (expert, slot) order, scaled by its gate weight, into
//   f32 y).  The order is fixed, so the output is the same bits from run
//   to run.
// - int8: each weight tile is read and converted exactly once in the
//   whole call.  TMA writes the int8 tiles under the 128-byte swizzle,
//   and each consumer thread turns its own wgmma A fragments into bf16
//   registers (s8_frag: 16-bit loads, a byte_perm and s8x2_to_bf16x2,
//   exact), which the products read in place of a converted tile: no
//   bf16 copy of the weights is written to or read from shared memory
//   (the chunk body's conversion costs three times the int8 tile's
//   bytes of shared-memory traffic), no barrier joins the warps, and a
//   stage holds only the int8 tiles and the rows, so more of them fit.
// - K7 (SLOTS false): the rows are X [E, G, D], every row computed, pad
//   rows included; H (bf16, rounded once) [E, G, F] sits in device memory
//   between the passes.
// - K6 (SLOTS true), the slot maps of a decode step: the units are the
//   16-slot tiles that hold a filled slot, listed on the device by
//   chunk_tiles (at C <= 16 one tile an expert: the experts that were
//   hit), expert by expert; each CTA derives its share from the list's
//   length, so the call needs no host sync and keeps a fixed grid.  Pass
//   1's producer warpgroup gathers each tile's token rows through idx by
//   16-byte cp.async into the swizzled [16 rows][64] layout wgmma reads
//   (an empty slot's row zero-filled; the weight tiles keep TMA), and H
//   [listed tile, 16, F] is indexed by list position.  No gathered
//   [E, C, D] view is written.

constexpr int DEC_M = 128;    // weight columns a CTA: 64 a consumer warpgroup
constexpr int DEC_ROWS = 16;  // K6's slot tile on the decode body
constexpr int MERGE_THREADS = 128;  // 4 output columns a thread

template <bool UP, bool Q, bool SWIGLU, int NR>
struct DecWg {
  static constexpr int NW = UP && SWIGLU ? 2 : 1;   // weight tiles a stage
  static constexpr int THREADS = 3 * 128;
  static constexpr int W_BYTES = FFN_BK * DEC_M * 2;  // bf16 [64 k][128]
  static constexpr int RAW_BYTES = FFN_BK * DEC_M;    // int8 [64 k][128]
  static constexpr int B_BYTES = NR * 128;            // rows [NR][64 k]
  // 64-deep boxes a stage: two where one weight is streamed (pass 2,
  // GELU's pass 1), which halves the stages' fixed costs
  static constexpr int KB = NW == 1 ? 2 : 1;
  static constexpr int BK = FFN_BK * KB;  // reduction depth a stage
  static constexpr int NT = KB * NW;      // weight tiles a stage (k box b,
                                          // weight w: tile b NW + w)
  // a stage as it is filled: the weight tiles (int8: raw), then the rows
  static constexpr int W_STAGE = NT * (Q ? RAW_BYTES : W_BYTES);
  static constexpr int STAGE = W_STAGE + KB * B_BYTES;
  static constexpr int NS_FIT = (SMEM_MAX - 1024 - 16 * 16) / STAGE;
  static constexpr int NS = NS_FIT < 16 ? NS_FIT : 16;
  static constexpr size_t SMEM = 1024 + NS * STAGE + 16 * NS;
  static_assert(NS >= 3, "too few stages");
  static_assert(STAGE % 1024 == 0, "1024-byte tiles");
};

// This thread's wgmma A fragment, as bf16, of k16 step s of an int8 weight
// tile [64 k][128 columns] that TMA wrote under the 128-byte swizzle (the
// 16-byte chunk c of row k at chunk c ^ k % 8).  The swap-AB product is
// free to order the weight columns along A's 64 rows, so A-rows g and
// g + 8 of warp w are the adjacent columns 2 g and 2 g + 1 of the warp's
// 16-byte chunk `chunk`: each (k, row pair) is one 16-bit load, and two
// loads of neighbouring k make two fragment registers (one byte_perm, then
// s8x2_to_bf16x2, exact).  The loads of a warp fall on 4 rows whose chunks
// the swizzle puts in different banks.
__device__ __forceinline__ void s8_frag(const unsigned char* raw, int chunk,
                                        int g, int t4, int s,
                                        uint32_t (&a)[4]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 16 * s + 2 * t4 + (i & 1) + (i >> 1) * 8;
    w[i] = *reinterpret_cast<const uint16_t*>(
        raw + k * 128 + ((chunk ^ (k & 7)) << 4) + 2 * g);
  }
  // bytes (k, 2g), (k + 1, 2g), (k, 2g + 1), (k + 1, 2g + 1)
  const uint32_t lo = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi = __byte_perm(w[2], w[3], 0x5140);
  a[0] = s8x2_to_bf16x2(lo, 0);  // A-row g, k and k + 1
  a[1] = s8x2_to_bf16x2(lo, 1);  // A-row g + 8
  a[2] = s8x2_to_bf16x2(hi, 0);  // A-row g, k + 8 and k + 9
  a[3] = s8x2_to_bf16x2(hi, 1);  // A-row g + 8
}

// One CTA of either decode pass.  ta: the rows (K7: X [E, G, D] or H [E,
// G, F]; K6 pass 2: H [listed tile, 16, F]; K6 pass 1 gathers them
// instead) in bf16 boxes of 64 x NR under the swizzle; tw: the weights
// viewed [E NW, K, MT] (bf16 boxes of 64 x 64 under the swizzle, int8
// boxes of 128 x 64 unswizzled); s / b (pass 1) as in the warpgroup body.
// UP: out is H, bf16; otherwise the f32 partial sums [gridDim.x, segs,
// NR, 128], segs a CTA.  K is the reduction's length, MT the weight's
// width (F or D).
template <bool UP, bool Q, bool SWIGLU, int NR, bool SLOTS>
__device__ __forceinline__ void ffn_decode_body(
    const CUtensorMap& ta, const CUtensorMap& tw,
    const float* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    void* __restrict__ out, int E, int G, int K, int MT, int segs,
    const SlotMaps& sm) {
  using C = DecWg<UP, Q, SWIGLU, NR>;
  constexpr int NW = C::NW, NS = C::NS, KB = C::KB, NT = C::NT;
  constexpr bool GATHER = SLOTS && UP;  // the producers gather the rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* st0 = hopper::align1024(smem_raw);
  uint64_t* bar_f = reinterpret_cast<uint64_t*>(st0 + NS * C::STAGE);
  uint64_t* bar_e = bar_f + NS;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int nk = (K + C::BK - 1) / C::BK;  // a last half stage reads zeros
  const int mt = (MT + DEC_M - 1) / DEC_M;
  const int gt = (G + NR - 1) / NR;
  const int ntc = SLOTS ? (sm.C + NR - 1) / NR : 1;
  const long long units =
      SLOTS ? static_cast<long long>(sm.offs[sm.E]) * mt
            : static_cast<long long>(E) * mt * gt;
  // this CTA's run of stages: whole units in pass 1, any run in pass 2
  long long beg, end;
  if constexpr (UP) {
    beg = units * blockIdx.x / gridDim.x * nk;
    end = units * (blockIdx.x + 1) / gridDim.x * nk;
  } else {
    beg = units * nk * blockIdx.x / gridDim.x;
    end = units * nk * (blockIdx.x + 1) / gridDim.x;
  }
  // Unit u -> its expert e, weight-column tile m0 and first row g0 (K6:
  // first slot), and where its rows sit in ta and out: (row gr, outer
  // ti).  K7: row tile fastest (the CTAs that share a weight tile run side
  // by side), then the column tile, then the expert.  K6: the same order
  // over the list, whose run for expert e holds its ne tiles from
  // position offs[e] on.
  struct Unit {
    int e, m0, g0, gr, ti;
  };
  auto unit = [&](long long u) {
    Unit t;
    if constexpr (SLOTS) {
      const int w = static_cast<int>(u);
      t.e = sm.tiles[w / mt] / ntc;
      const int o = sm.offs[t.e];
      const int ne = sm.offs[t.e + 1] - o;
      const int j = w - o * mt;
      t.m0 = (j / ne) * DEC_M;
      t.ti = o + j % ne;
      t.g0 = (sm.tiles[t.ti] - t.e * ntc) * NR;
      t.gr = 0;
    } else {
      t.g0 = static_cast<int>(u % gt) * NR;
      t.m0 = static_cast<int>((u / gt) % mt) * DEC_M;
      t.e = static_cast<int>(u / (static_cast<long long>(gt) * mt));
      t.gr = t.g0;
      t.ti = t.e;
    }
    return t;
  };
  // one stage's weight tiles by TMA (one thread)
  auto load_w = [&](int st, int kk, const Unit& t) {
    unsigned char* sp = st0 + st * C::STAGE;
    for (int box = 0; box < KB; ++box) {
      const int k0 = kk * C::BK + box * FFN_BK;
      for (int w = 0; w < NW; ++w) {
        const int ti = box * NW + w;
        if constexpr (Q) {
          hopper::tma_load_3d(sp + ti * C::RAW_BYTES, &tw, bar_f + st, t.m0,
                              k0, t.e * NW + w);
        } else {
          for (int nb = 0; nb < DEC_M / 64; ++nb)
            hopper::tma_load_3d(sp + ti * C::W_BYTES + nb * FFN_BK * 128,
                                &tw, bar_f + st, t.m0 + nb * 64, k0,
                                t.e * NW + w);
        }
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      // gathered rows: the weight TMA's expect-tx and 128 copy arrivals
      hopper::mbar_init(bar_f + st, GATHER ? 1 + 128 : 1);
      hopper::mbar_init(bar_e + st, FFN_CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    if constexpr (GATHER) {
      // every producer thread copies chunk ch of rows rb + 16 j (8
      // threads a 128-byte row) and arrives once its copies have landed;
      // thread 0 also streams the weight tiles
      constexpr int RJ = NR / 16;
      const int p = threadIdx.x - FFN_CONSUMERS;
      const int ch = p % 8;
      const int rb = p / 8;
      int it = 0;
      for (long long pos = beg; pos < end; pos += nk) {
        const Unit t = unit(pos / nk);
        int tok[RJ];
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int c = t.g0 + rb + 16 * j;
          const long long sl = static_cast<long long>(t.e) * sm.C + c;
          tok[j] = c < sm.C && sm.comb[sl] != 0.f ? sm.idx[sl] : -1;
        }
        for (int kk = 0; kk < nk; ++kk, ++it) {
          const int st = it % NS;
          if (it >= NS) hopper::mbar_wait(bar_e + st, ((it / NS) - 1) & 1);
          if (p == 0) {
            hopper::mbar_expect_tx(bar_f + st, C::W_STAGE);
            load_w(st, kk, t);
          }
          unsigned char* rows = st0 + st * C::STAGE + C::W_STAGE;
#pragma unroll
          for (int box = 0; box < KB; ++box) {
            const int k0 = kk * C::BK + box * FFN_BK;
#pragma unroll
            for (int j = 0; j < RJ; ++j) {
              const int row = rb + 16 * j;
              const bool on = tok[j] >= 0 && k0 < K;
              const __nv_bfloat16* src =
                  sm.x + (on ? static_cast<long long>(tok[j]) * K + k0 +
                                   ch * 8
                             : 0);
              cp_async16(rows + box * C::B_BYTES + row * 128 +
                             ((ch ^ (row % 8)) << 4),
                         src, on ? 16 : 0);
            }
          }
          cp_async_arrive_noinc(bar_f + st);
        }
      }
    } else if (warp == 8 && lane == 0) {
      int it = 0;
      for (long long pos = beg; pos < end;) {
        const long long u = pos / nk;
        const int kb = static_cast<int>(pos % nk);
        const int ke = static_cast<int>(
            nk < kb + (end - pos) ? nk : kb + (end - pos));
        const Unit t = unit(u);
        for (int kk = kb; kk < ke; ++kk, ++it) {
          const int st = it % NS;
          if (it >= NS) hopper::mbar_wait(bar_e + st, ((it / NS) - 1) & 1);
          unsigned char* rows = st0 + st * C::STAGE + C::W_STAGE;
          hopper::mbar_expect_tx(bar_f + st, C::STAGE);
          load_w(st, kk, t);
          for (int box = 0; box < KB; ++box)
            hopper::tma_load_3d(rows + box * C::B_BYTES, &ta, bar_f + st,
                                kk * C::BK + box * FFN_BK, t.gr, t.ti);
        }
        pos += ke - kb;
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float acc[NW][NR / 2];
  int it = 0;
  for (long long pos = beg; pos < end;) {
    const long long u = pos / nk;
    const int kb = static_cast<int>(pos % nk);
    const int ke =
        static_cast<int>(nk < kb + (end - pos) ? nk : kb + (end - pos));
    const Unit t = unit(u);
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int i = 0; i < NR / 2; ++i) acc[v][i] = 0.f;
    for (int kk = kb; kk < ke; ++kk, ++it) {
      const int st = it % NS;
      hopper::mbar_wait(bar_f + st, (it / NS) & 1);
      // the gathered rows were written by cp.async (the generic proxy):
      // order them before this thread's wgmma reads (the async proxy)
      if constexpr (GATHER) hopper::fence_proxy_async();
      const unsigned char* sp = st0 + st * C::STAGE;  // the weight tiles
      const unsigned char* bt = sp + C::W_STAGE;       // the rows
      if constexpr (Q) {
        // int8: each thread turns its A fragments of the stage into bf16
        // registers (s8_frag) and the products read A from them, so no
        // converted tile is written to or read from shared memory; the
        // stage is free once its products are done
        uint32_t a[KB * 4][NW][4];
#pragma unroll
        for (int box = 0; box < KB; ++box)
#pragma unroll
          for (int k16 = 0; k16 < FFN_BK / 16; ++k16)
#pragma unroll
            for (int v = 0; v < NW; ++v)
              s8_frag(sp + (box * NW + v) * C::RAW_BYTES, wg * 4 + warp % 4,
                      g, t4, k16, a[box * 4 + k16][v]);
#pragma unroll
        for (int v = 0; v < NW; ++v) hopper::fence_regs(acc[v]);
        hopper::wgmma_fence();
#pragma unroll
        for (int box = 0; box < KB; ++box)
#pragma unroll
          for (int k16 = 0; k16 < FFN_BK / 16; ++k16)
#pragma unroll
            for (int v = 0; v < NW; ++v)
              hopper::WgmmaT<NR>::rs(
                  acc[v], a[box * 4 + k16][v],
                  hopper::desc_k(hopper::smem_u32(bt + box * C::B_BYTES) +
                                 k16 * 32),
                  1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int v = 0; v < NW; ++v) hopper::fence_regs(acc[v]);
        hopper::mbar_arrive(bar_e + st);
      } else {
#pragma unroll
        for (int v = 0; v < NW; ++v) hopper::fence_regs(acc[v]);
        hopper::wgmma_fence();
#pragma unroll
        for (int box = 0; box < KB; ++box)
#pragma unroll
          for (int k16 = 0; k16 < FFN_BK / 16; ++k16)
#pragma unroll
            for (int v = 0; v < NW; ++v)
              hopper::WgmmaT<NR>::ss(
                  acc[v],
                  hopper::desc_mn(
                      hopper::smem_u32(sp + (box * NW + v) * C::W_BYTES +
                                       wg * FFN_BK * 128) +
                          k16 * 16 * 128,
                      FFN_BK * 128),
                  hopper::desc_k(hopper::smem_u32(bt + box * C::B_BYTES) +
                                 k16 * 32),
                  1);
        hopper::wgmma_commit();
        // keep this stage's products in flight; free the previous stage
        hopper::wgmma_wait<1>();
#pragma unroll
        for (int v = 0; v < NW; ++v) hopper::fence_regs(acc[v]);
        if (kk > kb) hopper::mbar_arrive(bar_e + (it - 1) % NS);
      }
    }
    if constexpr (!Q) {
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int v = 0; v < NW; ++v) hopper::fence_regs(acc[v]);
      hopper::mbar_arrive(bar_e + (it - 1) % NS);
    }

    // epilogue: accumulator (column ml of the weight tile, row r of the
    // rows' tile).  Pass 1: int8 scale, bias and activation, H rounded to
    // bf16 once.  Pass 2: the run's partial sum of this unit, as it is.
    float* part = nullptr;
    if constexpr (!UP)
      part = static_cast<float*>(out) +
             (static_cast<long long>(blockIdx.x) * segs + (u - beg / nk)) *
                 NR * DEC_M;
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // the weight column of accumulator row g + 8 (q / 2) (s8_frag's
        // order for int8)
        const int ml = wg * 64 + (warp % 4) * 16 +
                       (Q ? 2 * g + q / 2 : g + (q / 2) * 8);
        const int r = j * 8 + 2 * t4 + q % 2;
        float a = acc[0][4 * j + q];
        if constexpr (UP) {
          const int m = t.m0 + ml;
          const int row = t.g0 + r;
          if (m >= MT || (!SLOTS && row >= G)) continue;
          const long long rw = static_cast<long long>(t.e) * NW * MT;
          if constexpr (Q) a *= s[rw + m];
          a += __bfloat162float(b[rw + m]);
          if constexpr (SWIGLU) {
            float up = acc[NW - 1][4 * j + q];
            if constexpr (Q) up *= s[rw + MT + m];
            a = silu(a) * (up + __bfloat162float(b[rw + MT + m]));
          } else {
            a = gelu_tanh(a);
          }
          const long long o =
              SLOTS ? (static_cast<long long>(t.ti) * NR + r) * MT + m
                    : (static_cast<long long>(t.e) * G + row) * MT + m;
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(a);
        } else {
          part[r * DEC_M + ml] = a;
        }
      }
    pos += ke - kb;
  }
}

// The decode body's weight map: bf16 boxes of 64 x 64 under the swizzle,
// or int8 boxes of 128 x 64 under the 128-byte swizzle (read by s8_frag)
template <bool Q>
bool decode_weight_map(CUtensorMap* map, const void* w, int outer, int rows,
                       int cols) {
  if constexpr (Q)
    return encode_map(map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, outer, rows,
                      cols, DEC_M, FFN_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  else
    return encode_tile_map(map, w, outer, rows, cols, FFN_BK);
}

// The f32 sum over F of pass-2 unit u at row r of its rows' tile and
// columns col..col+3 of its 128: the partial sums of the CTAs whose runs
// [total b / grid, total (b + 1) / grid) met the unit's nk stages, added
// in run order (the first such CTA is the last whose run starts at or
// before the unit's first stage).
__device__ __forceinline__ float4 run_sum(const float* __restrict__ part,
                                          long long u, int nk,
                                          long long total, int grid,
                                          int segs, int nr, int r, int col) {
  const long long s0 = u * nk;
  const int b0 = static_cast<int>(((s0 + 1) * grid - 1) / total);
  const int b1 = static_cast<int>(((s0 + nk) * grid - 1) / total);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cta = b0; cta <= b1; ++cta) {
    const long long beg = total * cta / grid;
    if (beg >= total * (cta + 1) / grid) continue;  // an empty run
#if defined(TDP_MOE_FAULT) && TDP_MOE_FAULT == 1
    if (cta == b1 && b1 > b0) continue;  // planted: a run dropped
#endif
    const float4 p = *reinterpret_cast<const float4*>(
        part + ((static_cast<long long>(cta) * segs + (u - beg / nk)) * nr +
                r) * DEC_M + col);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  return v;
}

// A unit's sum, then (int8) w2's column scales and b2 of expert e, at
// columns d..d+3
template <bool Q>
__device__ __forceinline__ float4 finish(float4 v,
                                         const float* __restrict__ s2,
                                         const __nv_bfloat16* __restrict__ b2,
                                         long long o) {
  if constexpr (Q) {
    const float4 sc = *reinterpret_cast<const float4*>(s2 + o);
    v.x *= sc.x;
    v.y *= sc.y;
    v.z *= sc.z;
    v.w *= sc.w;
  }
  const uint2 bb = *reinterpret_cast<const uint2*>(b2 + o);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&bb.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&bb.y));
  v.x += lo.x;
  v.y += lo.y;
  v.z += hi.x;
  v.w += hi.y;
  return v;
}

template <bool Q, bool SWIGLU, int NR>
__global__ void __launch_bounds__(3 * 128, 1)
expert_ffn_up_decode_kernel(const __grid_constant__ CUtensorMap tx,
                            const __grid_constant__ CUtensorMap tw1,
                            const float* __restrict__ s1,
                            const __nv_bfloat16* __restrict__ b1,
                            __nv_bfloat16* __restrict__ h, int E, int G,
                            int D, int F) {
  ffn_decode_body<true, Q, SWIGLU, NR, false>(tx, tw1, s1, b1, h, E, G, D,
                                              F, 0, SlotMaps{});
}

template <bool Q, int NR>
__global__ void __launch_bounds__(3 * 128, 1)
expert_ffn_down_decode_kernel(const __grid_constant__ CUtensorMap th,
                              const __grid_constant__ CUtensorMap tw2,
                              float* __restrict__ part, int E, int G, int D,
                              int F, int segs) {
  ffn_decode_body<false, Q, false, NR, false>(th, tw2, nullptr, nullptr,
                                              part, E, G, F, D, segs,
                                              SlotMaps{});
}

// K7's merge: y [E, G, D] in bf16, one row (e, g) a block row, 4 columns
// a thread
template <bool Q>
__global__ void __launch_bounds__(MERGE_THREADS)
expert_ffn_merge_kernel(const float* __restrict__ part,
                        const float* __restrict__ s2,
                        const __nv_bfloat16* __restrict__ b2,
                        __nv_bfloat16* __restrict__ y, int E, int G, int D,
                        int F, int nr, int grid, int segs) {
  const int d = (blockIdx.y * MERGE_THREADS + threadIdx.x) * 4;
  if (d >= D) return;
  const int e = blockIdx.x / G;
  const int row = blockIdx.x % G;
  const int mt = (D + DEC_M - 1) / DEC_M;
  const int nk = (F + 2 * FFN_BK - 1) / (2 * FFN_BK);  // pass 2's stages
  const int gt = (G + nr - 1) / nr;
  const long long total = static_cast<long long>(E) * mt * gt * nk;
  const long long u =
      (static_cast<long long>(e) * mt + d / DEC_M) * gt + row / nr;
  const float4 v = finish<Q>(
      run_sum(part, u, nk, total, grid, segs, nr, row % nr, d % DEC_M), s2,
      b2, static_cast<long long>(e) * D + d);
  uint2 o;
  *reinterpret_cast<__nv_bfloat162*>(&o.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&o.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(y + static_cast<long long>(blockIdx.x) * D + d) =
      o;
}

// K6's decode passes on the slot maps (there is no row map for pass 1:
// tw1 stands in for it)
template <bool Q, bool SWIGLU>
__global__ void __launch_bounds__(3 * 128, 1)
moe_ffn_up_decode_kernel(const __grid_constant__ CUtensorMap tw1,
                         const float* __restrict__ s1,
                         const __nv_bfloat16* __restrict__ b1,
                         __nv_bfloat16* __restrict__ h, int D, int F,
                         const __grid_constant__ SlotMaps sm) {
  ffn_decode_body<true, Q, SWIGLU, DEC_ROWS, true>(
      tw1, tw1, s1, b1, h, sm.E, DEC_ROWS, D, F, 0, sm);
}

template <bool Q>
__global__ void __launch_bounds__(3 * 128, 1)
moe_ffn_down_decode_kernel(const __grid_constant__ CUtensorMap th,
                           const __grid_constant__ CUtensorMap tw2,
                           float* __restrict__ part, int D, int F, int segs,
                           const __grid_constant__ SlotMaps sm) {
  ffn_decode_body<false, Q, false, DEC_ROWS, true>(
      th, tw2, nullptr, nullptr, part, sm.E, DEC_ROWS, F, D, segs, sm);
}

// K6's merge: y [T, D] f32, every element written — token t (a block row)
// takes its routed choices in (expert, slot) order, each choice's unit sum
// (finish) scaled by its gate weight.  The block stages the slots' gate
// weights and tokens in shared memory, MERGE_SLOTS at a time, and every
// thread scans them (at decode all E C <= 120 slots at once), so no
// inverse map is needed; a choice's list position is counted on the way
// (one more for each earlier filled tile of its expert).
constexpr int MERGE_SLOTS = 1024;

template <bool Q>
__global__ void __launch_bounds__(MERGE_THREADS)
moe_ffn_merge_kernel(const float* __restrict__ part,
                     const float* __restrict__ comb,
                     const int* __restrict__ dst,
                     const int* __restrict__ offs,
                     const float* __restrict__ s2,
                     const __nv_bfloat16* __restrict__ b2,
                     float* __restrict__ y, int D, int F, int E, int C,
                     int grid, int segs) {
  __shared__ float comb_s[MERGE_SLOTS];
  __shared__ int dst_s[MERGE_SLOTS];
  const int d = (blockIdx.y * MERGE_THREADS + threadIdx.x) * 4;
  const bool on = d < D;  // no early exit: every thread meets the barriers
  const int tok = blockIdx.x;
  const int mt = (D + DEC_M - 1) / DEC_M;
  const int nk = (F + 2 * FFN_BK - 1) / (2 * FFN_BK);  // pass 2's stages
  const long long total = static_cast<long long>(offs[E]) * mt * nk;
  const long long slots = static_cast<long long>(E) * C;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int e = 0, c = 0, o = 0, ne = 0, i = 0;  // i: slot c's list position
  bool busy = false;
  for (long long base = 0; base < slots; base += MERGE_SLOTS) {
    const int n = static_cast<int>(
        slots - base < MERGE_SLOTS ? slots - base : MERGE_SLOTS);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += MERGE_THREADS) {
      comb_s[j] = comb[base + j];
      dst_s[j] = dst[base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j, ++c) {
      if (c == C) {
        c = 0;
        ++e;
      }
      if (c == 0) {
        o = offs[e];
        ne = offs[e + 1] - o;
        i = o;
        busy = false;
      } else if (c % DEC_ROWS == 0 && busy) {
        ++i;
        busy = false;
      }
      const float gv = comb_s[j];
      if (gv == 0.f) continue;
      busy = true;
      if (!on || dst_s[j] != tok) continue;
      const long long u = static_cast<long long>(o) * mt +
                          static_cast<long long>(d / DEC_M) * ne + (i - o);
      const float4 v = finish<Q>(
          run_sum(part, u, nk, total, grid, segs, DEC_ROWS, c % DEC_ROWS,
                  d % DEC_M),
          s2, b2, static_cast<long long>(e) * D + d);
      acc.x += gv * v.x;
      acc.y += gv * v.y;
      acc.z += gv * v.z;
      acc.w += gv * v.w;
    }
  }
  if (on)
    *reinterpret_cast<float4*>(y + static_cast<long long>(tok) * D + d) =
        acc;
}

// K6's tile list for the decode body in one launch, chunk_tiles' rule
// (ops/moe_dispatch.py): the [E, C] slots in tiles of `rows` a expert (the
// last ragged), tile t of expert e named e ntc + t; tiles holds those with
// a filled slot (comb != 0) first, in order, then the others, and offs[e]
// how many listed tiles come before expert e (offs[E]: all of them).  One
// CTA of 1024 threads scans the tiles 1024 at a time (a ballot a warp,
// then the warps' counts), twice: the listed count first, since the
// unlisted tiles follow them.
constexpr int TILES_THREADS = 1024;

__global__ void __launch_bounds__(TILES_THREADS)
moe_tiles_kernel(const float* __restrict__ comb, int* __restrict__ tiles,
                 int* __restrict__ offs, int E, int C, int rows) {
  __shared__ int wsum[TILES_THREADS / 32];
  const int ntc = (C + rows - 1) / rows;
  const int n = E * ntc;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  auto busy = [&](int t) {
    if (t >= n) return false;
    const int e = t / ntc;
    const int c0 = (t % ntc) * rows;
    const int c1 = C < c0 + rows ? C : c0 + rows;
    bool b = false;
    for (int c = c0; c < c1; ++c)
      b |= comb[static_cast<long long>(e) * C + c] != 0.f;
    return b;
  };
  // the flags of one chunk: busy tiles before this thread's, and in all
  auto scan = [&](bool f, int& before, int& total) {
    const unsigned m = __ballot_sync(0xffffffffu, f);
    const int mine = __popc(m & ((1u << lane) - 1u));
    if (lane == 0) wsum[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      int v = wsum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += x;
      }
      wsum[lane] = v;  // inclusive
    }
    __syncthreads();
    before = (warp ? wsum[warp - 1] : 0) + mine;
    total = wsum[31];
    __syncthreads();  // wsum is reused by the next chunk
  };
  int listed = 0;
  for (int t0 = 0; t0 < n; t0 += TILES_THREADS) {
    int before, total;
    scan(busy(t0 + threadIdx.x), before, total);
    listed += total;
  }
  int nb = 0, nf = 0;  // listed / unlisted tiles before this chunk
  for (int t0 = 0; t0 < n; t0 += TILES_THREADS) {
    const int t = t0 + threadIdx.x;
    const bool b = busy(t);
    int before, total;
    scan(b, before, total);
    if (t < n) {
      tiles[b ? nb + before : listed + nf + (t - t0 - before)] = t;
      if (t % ntc == 0) offs[t / ntc] = nb + before;
    }
    nb += total;
    nf += (n - t0 < TILES_THREADS ? n - t0 : TILES_THREADS) - total;
  }
  if (threadIdx.x == 0) offs[E] = listed;
}

dim3 merge_grid(long long rows, int D) {
  return dim3(static_cast<unsigned>(rows),
              (D + 4 * MERGE_THREADS - 1) / (4 * MERGE_THREADS));
}

template <bool Q, bool SWIGLU, int NR>
cudaError_t launch_expert_decode(const void* x, const void* w1,
                                 const void* s1, const void* b1,
                                 const void* w2, const void* s2,
                                 const void* b2, void* h, void* part,
                                 void* y, int E, int G, int D, int F,
                                 int grid1, int grid2, int segs,
                                 cudaStream_t st) {
  using Up = DecWg<true, Q, SWIGLU, NR>;
  using Down = DecWg<false, Q, false, NR>;
  CUtensorMap tx, tw1, th, tw2;
  if (!encode_tile_map(&tx, x, E, G, D, NR) ||
      !decode_weight_map<Q>(&tw1, w1, E * Up::NW, D, F) ||
      !encode_tile_map(&th, h, E, G, F, NR) ||
      !decode_weight_map<Q>(&tw2, w2, E, F, D))
    return cudaErrorNotSupported;
  using BF16 = __nv_bfloat16;
  auto up = expert_ffn_up_decode_kernel<Q, SWIGLU, NR>;
  auto down = expert_ffn_down_decode_kernel<Q, NR>;
  cudaError_t err = allow_smem(up, Up::SMEM);
  if (err == cudaSuccess) err = allow_smem(down, Down::SMEM);
  if (err != cudaSuccess) return err;
  up<<<grid1, Up::THREADS, Up::SMEM, st>>>(
      tx, tw1, static_cast<const float*>(s1), static_cast<const BF16*>(b1),
      static_cast<BF16*>(h), E, G, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  down<<<grid2, Down::THREADS, Down::SMEM, st>>>(
      th, tw2, static_cast<float*>(part), E, G, D, F, segs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  expert_ffn_merge_kernel<Q><<<merge_grid(static_cast<long long>(E) * G, D),
                               MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(s2),
      static_cast<const BF16*>(b2), static_cast<BF16*>(y), E, G, D, F, NR,
      grid2, segs);
  return cudaGetLastError();
}

template <bool Q, bool SWIGLU>
cudaError_t dispatch_decode(const void* x, const void* w1, const void* s1,
                            const void* b1, const void* w2, const void* s2,
                            const void* b2, void* h, void* part, void* y,
                            int E, int G, int D, int F, int nr, int grid1,
                            int grid2, int segs, cudaStream_t st) {
  switch (nr) {
    case 16:
      return launch_expert_decode<Q, SWIGLU, 16>(
          x, w1, s1, b1, w2, s2, b2, h, part, y, E, G, D, F, grid1, grid2,
          segs, st);
    case 32:
      return launch_expert_decode<Q, SWIGLU, 32>(
          x, w1, s1, b1, w2, s2, b2, h, part, y, E, G, D, F, grid1, grid2,
          segs, st);
    case 64:
      return launch_expert_decode<Q, SWIGLU, 64>(
          x, w1, s1, b1, w2, s2, b2, h, part, y, E, G, D, F, grid1, grid2,
          segs, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool Q, bool SWIGLU>
cudaError_t launch_moe_decode(const SlotMaps& sm, const void* w1,
                              const void* s1, const void* b1, const void* w2,
                              const void* s2, const void* b2, void* h,
                              void* part, int T, int D, int F, int grid1,
                              int grid2, int segs, cudaStream_t st) {
  using Up = DecWg<true, Q, SWIGLU, DEC_ROWS>;
  using Down = DecWg<false, Q, false, DEC_ROWS>;
  const int n_max = sm.E * ((sm.C + DEC_ROWS - 1) / DEC_ROWS);  // H's tiles
  CUtensorMap tw1, th, tw2;
  if (!decode_weight_map<Q>(&tw1, w1, sm.E * Up::NW, D, F) ||
      !encode_tile_map(&th, h, n_max, DEC_ROWS, F, DEC_ROWS) ||
      !decode_weight_map<Q>(&tw2, w2, sm.E, F, D))
    return cudaErrorNotSupported;
  using BF16 = __nv_bfloat16;
  auto up = moe_ffn_up_decode_kernel<Q, SWIGLU>;
  auto down = moe_ffn_down_decode_kernel<Q>;
  cudaError_t err = allow_smem(up, Up::SMEM);
  if (err == cudaSuccess) err = allow_smem(down, Down::SMEM);
  if (err != cudaSuccess) return err;
  up<<<grid1, Up::THREADS, Up::SMEM, st>>>(
      tw1, static_cast<const float*>(s1), static_cast<const BF16*>(b1),
      static_cast<BF16*>(h), D, F, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  down<<<grid2, Down::THREADS, Down::SMEM, st>>>(
      th, tw2, static_cast<float*>(part), D, F, segs, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_ffn_merge_kernel<Q><<<merge_grid(T, D), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(part), sm.comb, sm.dst, sm.offs,
      static_cast<const float*>(s2), static_cast<const BF16*>(b2), sm.y, D,
      F, sm.E, sm.C, grid2, segs);
  return cudaGetLastError();
}

}  // namespace

// x [T, D]; idx / dst int32 [E, C]; comb f32 [E, C]; w1 [E, 2, D, F]
// (swiglu 1) or [E, D, F] (swiglu 0); b1 [E, 2, F] or [E, F]; w2 [E, F, D];
// b2 [E, D]; y f32 [T, D], zeroed.  All contiguous and 16-byte aligned, D
// and F multiples of 64; dtype_tag 0 = bf16, 1 = f32 (x and every weight).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int tdp_moe_ffn(const void* x, const void* idx, const void* comb,
                           const void* dst, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* y, int T,
                           int D, int F, int E, int C, int swiglu,
                           int dtype_tag, void* stream) {
  if (bad_shape(T, D, F, E, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype_tag * 2 + (swiglu ? 1 : 0)) {
    case 0:
      err = launch<__nv_bfloat16, false>(x, idx, comb, dst, w1, b1, w2, b2, y,
                                         D, F, E, C, st);
      break;
    case 1:
      err = launch<__nv_bfloat16, true>(x, idx, comb, dst, w1, b1, w2, b2, y,
                                        D, F, E, C, st);
      break;
    case 2:
      err = launch<float, false>(x, idx, comb, dst, w1, b1, w2, b2, y, D, F, E,
                                 C, st);
      break;
    case 3:
      err = launch<float, true>(x, idx, comb, dst, w1, b1, w2, b2, y, D, F, E,
                                C, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The int8 variant: as tdp_moe_ffn, with q1 / q2 int8 in w1's / w2's
// layout, s1 f32 [E, 2, F] (swiglu 1) or [E, F], s2 f32 [E, D]; x, b1 and
// b2 of dtype_tag (0 = bf16, 1 = f32).
extern "C" int tdp_moe_ffn_int8(const void* x, const void* idx,
                                const void* comb, const void* dst,
                                const void* q1, const void* s1,
                                const void* b1, const void* q2,
                                const void* s2, const void* b2, void* y,
                                int T, int D, int F, int E, int C, int swiglu,
                                int dtype_tag, void* stream) {
  if (bad_shape(T, D, F, E, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype_tag * 2 + (swiglu ? 1 : 0)) {
    case 0:
      err = launch_int8<__nv_bfloat16, false>(x, idx, comb, dst, q1, s1, b1,
                                              q2, s2, b2, y, D, F, E, C, st);
      break;
    case 1:
      err = launch_int8<__nv_bfloat16, true>(x, idx, comb, dst, q1, s1, b1,
                                             q2, s2, b2, y, D, F, E, C, st);
      break;
    case 2:
      err = launch_int8<float, false>(x, idx, comb, dst, q1, s1, b1, q2, s2,
                                      b2, y, D, F, E, C, st);
      break;
    case 3:
      err = launch_int8<float, true>(x, idx, comb, dst, q1, s1, b1, q2, s2,
                                     b2, y, D, F, E, C, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// K7, the EP expert FFN: x [E, G, D] (E the local experts); w1 [E, 2, D,
// F] (swiglu 1) or [E, D, F]; b1 [E, 2, F] or [E, F]; w2 [E, F, D]; b2
// [E, D]; y f32 [E, G, D], zeroed.  All contiguous and 16-byte aligned, D
// and F multiples of 64; dtype_tag 0 = bf16, 1 = f32 (x and every weight).
// Returns cudaGetLastError() after the launch.
extern "C" int tdp_expert_ffn(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* y, int E,
                              int G, int D, int F, int swiglu, int dtype_tag,
                              void* stream) {
  if (bad_expert_shape(E, G, D, F))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_expert<false>(
      x, w1, nullptr, b1, w2, nullptr, b2, y, E, G, D, F, swiglu, dtype_tag,
      static_cast<cudaStream_t>(stream)));
}

// K7's int8 variant: as tdp_expert_ffn, with q1 / q2 int8 in w1's / w2's
// layout, s1 f32 [E, 2, F] (swiglu 1) or [E, F], s2 f32 [E, D]; x, b1 and
// b2 of dtype_tag (0 = bf16, 1 = f32).
extern "C" int tdp_expert_ffn_int8(const void* x, const void* q1,
                                   const void* s1, const void* b1,
                                   const void* q2, const void* s2,
                                   const void* b2, void* y, int E, int G,
                                   int D, int F, int swiglu, int dtype_tag,
                                   void* stream) {
  if (bad_expert_shape(E, G, D, F))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_expert<true>(
      x, q1, s1, b1, q2, s2, b2, y, E, G, D, F, swiglu, dtype_tag,
      static_cast<cudaStream_t>(stream)));
}

// K7's chunk rows on the warpgroup body: bf16 x [E, G, D]; w1 / w2 bf16 or
// (quantized 1) int8 in the layouts above, with s1 / s2 their f32 scales
// (null for bf16); b1, b2 bf16; h bf16 [E, G, F] scratch between the
// passes; y bf16 [E, G, D], every element written.  Two launches (up,
// down) on the stream; returns the first error.
extern "C" int tdp_expert_ffn_wgmma(const void* x, const void* w1,
                                    const void* s1, const void* b1,
                                    const void* w2, const void* s2,
                                    const void* b2, void* h, void* y, int E,
                                    int G, int D, int F, int swiglu,
                                    int quantized, void* stream) {
  if (bad_expert_shape(E, G, D, F))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (quantized * 2 + (swiglu ? 1 : 0)) {
    case 0:
      err = launch_expert_wgmma<false, false>(x, w1, s1, b1, w2, s2, b2, h,
                                              y, E, G, D, F, st);
      break;
    case 1:
      err = launch_expert_wgmma<false, true>(x, w1, s1, b1, w2, s2, b2, h, y,
                                             E, G, D, F, st);
      break;
    case 2:
      err = launch_expert_wgmma<true, false>(x, w1, s1, b1, w2, s2, b2, h, y,
                                             E, G, D, F, st);
      break;
    case 3:
      err = launch_expert_wgmma<true, true>(x, w1, s1, b1, w2, s2, b2, h, y,
                                            E, G, D, F, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// K7's decode rows on the swap-AB body: the arguments of
// tdp_expert_ffn_wgmma, with h bf16 [E, G, F] scratch, part f32 [grid2,
// segs, nr, 128] scratch for pass 2's partial sums and y bf16 [E, G, D],
// every element written; nr the row tile (16, 32 or 64), grid1 / grid2
// the passes' CTAs and segs the units a pass-2 run may meet (the
// wrapper's decode_grid).  Three launches (up, down, merge); returns the
// first error.
extern "C" int tdp_expert_ffn_decode(const void* x, const void* w1,
                                     const void* s1, const void* b1,
                                     const void* w2, const void* s2,
                                     const void* b2, void* h, void* part,
                                     void* y, int E, int G, int D, int F,
                                     int swiglu, int quantized, int nr,
                                     int grid1, int grid2, int segs,
                                     void* stream) {
  if (bad_expert_shape(E, G, D, F) || grid1 < 1 || grid2 < 1 || segs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (quantized * 2 + (swiglu ? 1 : 0)) {
    case 0:
      err = dispatch_decode<false, false>(x, w1, s1, b1, w2, s2, b2, h, part,
                                          y, E, G, D, F, nr, grid1, grid2,
                                          segs, st);
      break;
    case 1:
      err = dispatch_decode<false, true>(x, w1, s1, b1, w2, s2, b2, h, part,
                                         y, E, G, D, F, nr, grid1, grid2,
                                         segs, st);
      break;
    case 2:
      err = dispatch_decode<true, false>(x, w1, s1, b1, w2, s2, b2, h, part,
                                         y, E, G, D, F, nr, grid1, grid2,
                                         segs, st);
      break;
    case 3:
      err = dispatch_decode<true, true>(x, w1, s1, b1, w2, s2, b2, h, part,
                                        y, E, G, D, F, nr, grid1, grid2,
                                        segs, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// K6's chunk rows on the warpgroup body: bf16 x [T, D]; idx / dst int32
// and comb f32 [E, C]; tiles int32 [E ceil(C / 128)] listing the
// non-empty 128-slot tiles first, by expert, and offs int32 [E + 1] how
// many of them come before expert e (offs[E]: all of them); w1 /
// w2 bf16 or (quantized 1) int8 in tdp_moe_ffn's layouts with s1 / s2
// their f32 scales (null for bf16); b1, b2 bf16; h bf16 [E ceil(C / 128),
// 128, F] scratch between the passes; y f32 [T, D], zeroed.  Two launches
// on the stream; returns the first error.
extern "C" int tdp_moe_ffn_wgmma(const void* x, const void* idx,
                                 const void* comb, const void* dst,
                                 const void* tiles, const void* offs,
                                 const void* w1, const void* s1,
                                 const void* b1, const void* w2,
                                 const void* s2, const void* b2, void* h,
                                 void* y, int T, int D, int F, int E, int C,
                                 int swiglu, int quantized, void* stream) {
  if (bad_shape(T, D, F, E, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SlotMaps sm{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const int*>(idx),
                    static_cast<const float*>(comb),
                    static_cast<const int*>(dst),
                    static_cast<const int*>(tiles),
                    static_cast<const int*>(offs), static_cast<float*>(y), C,
                    E};
  cudaError_t err;
  switch (quantized * 2 + (swiglu ? 1 : 0)) {
    case 0:
      err = launch_moe_wgmma<false, false>(sm, w1, s1, b1, w2, s2, b2, h,
                                           D, F, st);
      break;
    case 1:
      err = launch_moe_wgmma<false, true>(sm, w1, s1, b1, w2, s2, b2, h, D,
                                          F, st);
      break;
    case 2:
      err = launch_moe_wgmma<true, false>(sm, w1, s1, b1, w2, s2, b2, h, D,
                                          F, st);
      break;
    case 3:
      err = launch_moe_wgmma<true, true>(sm, w1, s1, b1, w2, s2, b2, h, D,
                                         F, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// K6's decode tile list alone (the first launch of tdp_moe_ffn_decode):
// comb f32 [E, C] -> tiles int32 [E ceil(C / rows)], offs int32 [E + 1].
extern "C" int tdp_moe_tiles(const void* comb, void* tiles, void* offs,
                             int E, int C, int rows, void* stream) {
  if (E < 1 || C < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_tiles_kernel<<<1, TILES_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(comb), static_cast<int*>(tiles),
      static_cast<int*>(offs), E, C, rows);
  return static_cast<int>(cudaGetLastError());
}

// K6's decode rows on the decode body: the arguments of
// tdp_moe_ffn_wgmma, with tiles int32 [E ceil(C / 16)] / offs int32 [E +
// 1] scratch into which the first launch lists the non-empty 16-slot
// tiles (chunk_tiles' rule at 16 rows), h bf16 [E ceil(C / 16), 16, F]
// scratch, part f32 [grid2, segs, 16, 128] scratch for pass 2's partial
// sums and y f32 [T, D], every element written; grid1 / grid2 / segs as
// for tdp_expert_ffn_decode.  Four launches (tiles, up, down, merge);
// returns the first error.
extern "C" int tdp_moe_ffn_decode(const void* x, const void* idx,
                                  const void* comb, const void* dst,
                                  void* tiles, void* offs,
                                  const void* w1, const void* s1,
                                  const void* b1, const void* w2,
                                  const void* s2, const void* b2, void* h,
                                  void* part, void* y, int T, int D, int F,
                                  int E, int C, int swiglu, int quantized,
                                  int grid1, int grid2, int segs,
                                  void* stream) {
  if (bad_shape(T, D, F, E, C) || grid1 < 1 || grid2 < 1 || segs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err_tiles = tdp_moe_tiles(comb, tiles, offs, E, C, DEC_ROWS,
                                      stream);
  if (err_tiles != 0) return err_tiles;
  const SlotMaps sm{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const int*>(idx),
                    static_cast<const float*>(comb),
                    static_cast<const int*>(dst),
                    static_cast<const int*>(tiles),
                    static_cast<const int*>(offs), static_cast<float*>(y), C,
                    E};
  cudaError_t err;
  switch (quantized * 2 + (swiglu ? 1 : 0)) {
    case 0:
      err = launch_moe_decode<false, false>(sm, w1, s1, b1, w2, s2, b2, h,
                                            part, T, D, F, grid1, grid2,
                                            segs, st);
      break;
    case 1:
      err = launch_moe_decode<false, true>(sm, w1, s1, b1, w2, s2, b2, h,
                                           part, T, D, F, grid1, grid2, segs,
                                           st);
      break;
    case 2:
      err = launch_moe_decode<true, false>(sm, w1, s1, b1, w2, s2, b2, h,
                                           part, T, D, F, grid1, grid2, segs,
                                           st);
      break;
    case 3:
      err = launch_moe_decode<true, true>(sm, w1, s1, b1, w2, s2, b2, h,
                                          part, T, D, F, grid1, grid2, segs,
                                          st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory a CTA of the decode body uses (up 1: pass 1; nr:
// its row tile, 16, 32 or 64), for the build report; -1 if unknown.
template <int NR>
int decode_smem(int key) {
  switch (key) {
    case 0: return static_cast<int>(DecWg<false, false, false, NR>::SMEM);
    case 2: return static_cast<int>(DecWg<false, true, false, NR>::SMEM);
    case 4: return static_cast<int>(DecWg<true, false, false, NR>::SMEM);
    case 5: return static_cast<int>(DecWg<true, false, true, NR>::SMEM);
    case 6: return static_cast<int>(DecWg<true, true, false, NR>::SMEM);
    case 7: return static_cast<int>(DecWg<true, true, true, NR>::SMEM);
    default: return -1;
  }
}

extern "C" int tdp_expert_ffn_decode_smem_bytes(int up, int quantized,
                                                int swiglu, int nr) {
  const int key = up * 4 + quantized * 2 + (swiglu && up ? 1 : 0);
  switch (nr) {
    case 16: return decode_smem<16>(key);
    case 32: return decode_smem<32>(key);
    case 64: return decode_smem<64>(key);
    default: return -1;
  }
}

// Dynamic shared memory a CTA of the warpgroup body uses (up 1: pass 1),
// for the build report.
extern "C" int tdp_expert_ffn_wgmma_smem_bytes(int up, int quantized,
                                               int swiglu) {
  switch (up * 4 + quantized * 2 + (swiglu ? 1 : 0)) {
    case 0: case 1: return static_cast<int>(FfnWg<false, false, false>::SMEM);
    case 2: case 3: return static_cast<int>(FfnWg<false, true, false>::SMEM);
    case 4: return static_cast<int>(FfnWg<true, false, false>::SMEM);
    case 5: return static_cast<int>(FfnWg<true, false, true>::SMEM);
    case 6: return static_cast<int>(FfnWg<true, true, false>::SMEM);
    case 7: return static_cast<int>(FfnWg<true, true, true>::SMEM);
    default: return -1;
  }
}

// Dynamic shared memory a CTA uses, for the build report; -1 if unknown.
// dtype_tag: 0 bf16, 1 f32 (float weights); 2 bf16, 3 f32 tokens with int8
// weights.
extern "C" int tdp_moe_ffn_smem_bytes(int dtype_tag, int swiglu) {
  using BF16 = __nv_bfloat16;
  switch (dtype_tag * 2 + (swiglu ? 1 : 0)) {
    case 0: return static_cast<int>(Cfg<BF16, BF16, false>::SMEM);
    case 1: return static_cast<int>(Cfg<BF16, BF16, true>::SMEM);
    case 2: return static_cast<int>(Cfg<float, float, false>::SMEM);
    case 3: return static_cast<int>(Cfg<float, float, true>::SMEM);
    case 4: return static_cast<int>(Cfg<BF16, int8_t, false>::SMEM);
    case 5: return static_cast<int>(Cfg<BF16, int8_t, true>::SMEM);
    case 6: return static_cast<int>(Cfg<float, int8_t, false>::SMEM);
    case 7: return static_cast<int>(Cfg<float, int8_t, true>::SMEM);
    default: return -1;
  }
}
