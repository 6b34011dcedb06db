// Fused MoE expert dispatch for Hopper (sm_90a): gather token rows through
// the [E, C] slot maps, run each expert's FFN, and add the gate-weighted
// result back into the [T, D] output — one launch a layer, with no
// [T, E, C] dispatch tensor and no gathered [E, C, D] slot view in device
// memory.  Two variants: float expert weights (moe_ffn_kernel) and int8
// weight-only experts (moe_ffn_int8_kernel).
//
// Replaces the TPU kernel K6 of torchdistpackage_tpu/ops/moe_dispatch.py:
// _pallas_moe_ffn (:289, body _kernel :202) -> moe_ffn_kernel, and its
// quantized branch (_kernel :253-258, the (q8, scale) leaves of
// quantize_moe_experts) -> moe_ffn_int8_kernel.
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
//   to 2.8 / 1.4 GB a layer against ~1e9 FLOP — bytes.  Every CTA streams
//   its slice of W1 and W2 once through shared memory, and a warp whose 16
//   rows are all empty skips its products, so the weights are read once a
//   layer and only for the experts that were hit.
// - a 512-row prefill chunk of 8 slots (T = 4096): 2 (T k) 3 D F = 2.9e12
//   FLOP — operations, for either weight type.  The products run on the
//   tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate); the f32
//   instantiations compute the same tiles on the CUDA cores (exact f32, for
//   checks).
//
// Design, against the TPU kernel:
// - The TPU kernel loads one expert's whole W1/W2 per grid step (BlockSpec
//   over everything but the expert dim).  At Mixtral widths one expert's W1
//   is 235 MB, so here a CTA owns 64 capacity slots of one expert and one
//   64-column tile of F: phase 1 walks D in 64-deep stages (gathered token
//   rows and the W1 tile double-buffered with cp.async) into the gate/up
//   accumulators, applies bias and activation in registers and keeps the
//   [64, 64] activation in shared memory; phase 2 walks D in 64-column
//   stages of W2, each a [64, 64] . [64, 64] product.
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
//   exits before any load.  At the serving capacity C = T only T k of the
//   E T slots are filled, from slot 0 upward, so the trailing tiles of every
//   expert exit at once and the E / k padded-compute tax never runs.
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
//   stays f32.
// Fragments are assembled with 8/16/32-bit shared loads.  K6 still runs
// this body at every row count; K7's chunk rows run the two-pass
// warpgroup GEMM below, which K6's prefill rows are to move onto next.
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
// second product, as K6 does.  Two bodies, chosen by the wrapper from the
// rows' count and type (ops/moe_dispatch.py expert_ffn_body):
// - decode's few rows and f32 rows: the body above with the identity slot
//   map (IDENT): slot c of expert e is row e G + c of x and of y, weight
//   1, so there is no empty-tile skip (the TPU kernel computes every row
//   too).  Grid (ceil(G / 64), F / 64, e_loc); F-tile partials meet in
//   the zeroed f32 y by atomicAdd (their order varies from run to run), b2
//   is added by the first F tile, and the wrapper casts y to x's type.
// - bf16 chunk rows (G >= 64): expert_ffn_up_wgmma_kernel and
//   expert_ffn_down_wgmma_kernel, a two-pass grouped GEMM on the warpgroup
//   MMA (described where they are defined): no atomics, no f32 y, output
//   in x's type, the same bits from run to run.

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

// ----------------------------------------- K7 chunk rows on the warpgroup MMA
//
// A two-pass grouped GEMM for bf16 rows, one body templated on the weight
// type (bf16, or int8 converted to bf16 in shared memory):
//   pass 1 (up):   H[e] = act(X[e] . W1[e] + b1[e])  -> bf16 [E, G, F]
//   pass 2 (down): Y[e] = H[e] . W2[e] + b2[e]       -> bf16 [E, G, D]
// - A CTA owns 128 rows of one expert (two consumer warpgroups of 64) and
//   N output columns (pass 1: 128 of F, the gate and up accumulators side
//   by side for SwiGLU; pass 2: 256 of D), and walks the whole reduction
//   (D or F) in 64-deep stages, so every sum stays in registers: no
//   atomics, no f32 output, no cast, the same result from run to run.  H
//   (bf16, rounded once as the walk body rounds it) lives in device memory
//   between the passes: 0.94 GB at [8, 4096, 4096], F 14336.
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

constexpr int FFN_BM = 128;  // rows a CTA
constexpr int FFN_BK = 64;   // reduction depth a stage
constexpr int FFN_CONSUMERS = 256;  // two warpgroups

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
  static constexpr size_t SMEM = 1024 + NS * STAGE + BAR_BYTES;
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

// One CTA of either pass.  ta: the rows (X [E, G, D] or H [E, G, F]),
// bf16 boxes of 64 x 128 under the 128-byte swizzle.  tw: the weights
// viewed [E NW, K, NT] (W1 [E, 2, D, F] or [E, D, F]; W2 [E, F, D]) —
// bf16 boxes of 64 x 64 under the swizzle, or int8 boxes of N x 64 with
// no swizzle that the consumers turn into the bf16 layout.  s: the
// int8 column scales ([E NW, NT], null for bf16 weights), b: the bias
// ([E NW, NT]), out: [E, G, NT] bf16.  K is the reduction's length (D or
// F), NT the output's width (F or D).
template <bool UP, bool Q, bool SWIGLU>
__device__ __forceinline__ void ffn_wgmma_body(
    const CUtensorMap& ta, const CUtensorMap& tw,
    const float* __restrict__ s, const __nv_bfloat16* __restrict__ b,
    __nv_bfloat16* __restrict__ out, int G, int K, int NT) {
  using C = FfnWg<UP, Q, SWIGLU>;
  constexpr int N = C::N, NW = C::NW, NS = C::NS, NBOX = N / 64;
  extern __shared__ unsigned char smem_raw[];
  // stage s: the A rows, NW weight tiles, (int8) NW raw tiles
  unsigned char* st0 = hopper::align1024(smem_raw);
  uint64_t* bar_f = reinterpret_cast<uint64_t*>(st0 + NS * C::STAGE);
  uint64_t* bar_e = bar_f + NS;  // a stage is free again

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * FFN_BM;
  const int n0 = blockIdx.y * N;
  const int e = blockIdx.z;
  const int nk = K / FFN_BK;
  auto w_at = [&](int st, int w) {
    return st0 + st * C::STAGE + C::A_BYTES + w * C::W_BYTES;
  };
  auto raw_at = [&](int st, int w) {
    return st0 + st * C::STAGE + C::A_BYTES + NW * C::W_BYTES +
           w * C::RAW_BYTES;
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      hopper::mbar_init(bar_f + st, 1);
      hopper::mbar_init(bar_e + st, FFN_CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int st = it % NS;
        if (it >= NS) hopper::mbar_wait(bar_e + st, ((it / NS) - 1) & 1);
        const int k0 = it * FFN_BK;
        hopper::mbar_expect_tx(
            bar_f + st, C::A_BYTES + NW * (Q ? C::RAW_BYTES : C::W_BYTES));
        hopper::tma_load_3d(st0 + st * C::STAGE, &ta, bar_f + st, k0, m0, e);
        for (int w = 0; w < NW; ++w) {
          if constexpr (Q) {
            hopper::tma_load_3d(raw_at(st, w), &tw, bar_f + st, n0, k0,
                                e * NW + w);
          } else {
            for (int nb = 0; nb < NBOX; ++nb)
              hopper::tma_load_3d(w_at(st, w) + nb * FFN_BK * 128, &tw,
                                  bar_f + st, n0 + nb * 64, k0, e * NW + w);
          }
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<C::CONSUMER_REGS>();

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[NW][N / 2];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[w][i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int st = it % NS;
    hopper::mbar_wait(bar_f + st, (it / NS) & 1);
    if constexpr (Q) {
      // Both warpgroups turn each int8 tile [64 k][N] (row-major, N bytes
      // a row) into the bf16 tile wgmma reads — NBOX boxes of [64 k][64]
      // under the 128-byte swizzle (16-byte chunk c of row r at chunk c ^
      // r % 8) — while the previous stage's products run, then meet on a
      // named barrier before this stage's
      constexpr int STEPS = FFN_BK * N / 16;  // 16 weights a step
      static_assert(STEPS % FFN_CONSUMERS == 0, "whole steps a thread");
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const unsigned char* raw = raw_at(st, w);
        unsigned char* dst = w_at(st, w);
#pragma unroll
        for (int j = 0; j < STEPS / FFN_CONSUMERS; ++j) {
          const int i = threadIdx.x + j * FFN_CONSUMERS;
          const int r = i / (N / 16);
          const int c8 = 2 * (i % (N / 16));  // first 8-weight chunk
          const uint4 v =
              *reinterpret_cast<const uint4*>(raw + r * N + c8 * 8);
          const uint4 lo = {s8x2_to_bf16x2(v.x, 0), s8x2_to_bf16x2(v.x, 1),
                            s8x2_to_bf16x2(v.y, 0), s8x2_to_bf16x2(v.y, 1)};
          const uint4 hi = {s8x2_to_bf16x2(v.z, 0), s8x2_to_bf16x2(v.z, 1),
                            s8x2_to_bf16x2(v.w, 0), s8x2_to_bf16x2(v.w, 1)};
          unsigned char* row = dst + (c8 / 8) * FFN_BK * 128 + r * 128;
          *reinterpret_cast<uint4*>(row + ((c8 % 8) ^ (r % 8)) * 16) = lo;
          *reinterpret_cast<uint4*>(row + (((c8 + 1) % 8) ^ (r % 8)) * 16) =
              hi;
        }
      }
      hopper::fence_proxy_async();
      asm volatile("bar.sync 1, %0;\n" ::"n"(FFN_CONSUMERS) : "memory");
    }
    const uint32_t aa = hopper::smem_u32(st0 + st * C::STAGE) + wg * 64 * 128;
#pragma unroll
    for (int w = 0; w < NW; ++w) hopper::fence_regs(acc[w]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FFN_BK / 16; ++kk)
#pragma unroll
      for (int w = 0; w < NW; ++w)
        hopper::Wgmma<N>::template ss<1>(
            acc[w], hopper::desc_k(aa + kk * 32),
            hopper::desc_mn(hopper::smem_u32(w_at(st, w)) + kk * 16 * 128,
                            FFN_BK * 128),
            1);
    hopper::wgmma_commit();
    // keep this stage's products in flight; the previous stage's are done
    hopper::wgmma_wait<1>();
#pragma unroll
    for (int w = 0; w < NW; ++w) hopper::fence_regs(acc[w]);
    if (it > 0) hopper::mbar_arrive(bar_e + (it - 1) % NS);
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int w = 0; w < NW; ++w) hopper::fence_regs(acc[w]);

  // epilogue: (int8: each column's scale,) bias, (pass 1: activation,
  // rounded to bf16 once, as the walk body does,) then the bf16 store
  const float* se = Q ? s + static_cast<long long>(e) * NW * NT : nullptr;
  const __nv_bfloat16* be = b + static_cast<long long>(e) * NW * NT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + (warp % 4) * 16 + g + h * 8;
    if (row >= G) continue;
    __nv_bfloat16* orow = out + (static_cast<long long>(e) * G + row) * NT;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;  // NT is even: col + 1 < NT too
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
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(v[0], v[1]);
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
  ffn_wgmma_body<true, Q, SWIGLU>(tx, tw1, s1, b1, h, G, D, F);
}

template <bool Q>
__global__ void __launch_bounds__(3 * 128, 1)
expert_ffn_down_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                             const __grid_constant__ CUtensorMap tw2,
                             const float* __restrict__ s2,
                             const __nv_bfloat16* __restrict__ b2,
                             __nv_bfloat16* __restrict__ y, int G, int D,
                             int F) {
  ffn_wgmma_body<false, Q, false>(th, tw2, s2, b2, y, G, F, D);
}

// the weight map of one pass: bf16 boxes of 64 x 64 under the swizzle, or
// int8 boxes of N x 64 unswizzled
template <bool UP, bool Q, bool SWIGLU>
bool weight_map(CUtensorMap* map, const void* w, int outer, int rows,
                int cols) {
  constexpr int N = FfnWg<UP, Q, SWIGLU>::N;
  if constexpr (Q)
    return encode_map(map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, outer, rows,
                      cols, N, FFN_BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    return encode_tile_map(map, w, outer, rows, cols, FFN_BK);
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
      !weight_map<true, Q, SWIGLU>(&tw1, w1, E * NW, D, F) ||
      !encode_tile_map(&th, h, E, G, F, FFN_BM) ||
      !weight_map<false, Q, false>(&tw2, w2, E, F, D))
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
