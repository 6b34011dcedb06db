// Flash attention for Hopper (sm_90a): forward (o, lse), backward dq, and
// backward dk/dv — causal, sliding-window and grouped-query attention that
// never forms the [S, S] score matrix in device memory.
//
// Replaces three TPU kernels of torchdistpackage_tpu/ops/flash_attention.py:
//   K3  _fwd (:220, body _fwd_kernel :174)
//       -> flash_fwd_wgmma_kernel (bf16), flash_fwd_kernel (f32)
//   K4  _bwd dq (:369, body _bwd_dq_kernel :262)
//       -> flash_bwd_dq_wgmma_kernel (bf16), flash_bwd_dq_kernel (f32)
//   K5  _bwd dkv (:395, body _bwd_dkv_kernel :301)
//       -> flash_bwd_dkv_wgmma_kernel (bf16), flash_bwd_dkv_kernel (f32)
//
// What bounds them on an H100 at training shapes: operations.  A causal
// forward at B 16, H 12, S 2048, hd 64 does ~1.03e11 FLOP on ~50 MB of
// q, k, v, o (~2000 FLOP a byte, far above the ~295 where the tensor cores
// set the pace); dq does 1.5x and dk/dv 2x that work.  At hd 64 the
// softmax's exponentials (on the special-function unit, 16 a clock an SM)
// take about as long as the products, so they matter as much.
//
// bf16 K3, K4 and K5, the training path, run on the warpgroup MMA
// (hopper.cuh):
// - Every product is wgmma m64nNk16, bf16 in, f32 accumulate; a CTA has
//   two consumer warpgroups of 64 rows.  Tiles come in by TMA under the
//   128-byte swizzle, completed on mbarriers, from 3-D maps [B*H, S, hd]
//   (a row tile past S is zero-filled, never the next head's rows).  An
//   operand not stored K-major (V for P.V; K for dS.K; dO and Q for dV and
//   dK) is read MN-major with wgmma's transpose bit: no transposed copy.
// - P (K3), dS (K4), P^T and dS^T (K5) go from the f32 accumulator
//   straight into bf16 A fragments in registers (for 16-bit A the
//   accumulator layout is the next product's A layout): no shared-memory
//   round trip.  A masked P or dS is selected to 0 (K4, K5), not
//   multiplied.
// - exp2 on the special-function unit with the scale and log2(e) folded
//   into one FMA; per-element masks only on tiles that cross the diagonal,
//   the window edge or the end of the keys (queries).  A masked score is
//   -inf and a row with no visible key yet keeps max -inf, scaled by 0.
// - K3: 128 query rows a CTA and one producer warp; Q loaded once, K and
//   V tiles of 128 keys through 2 stages on separate barriers.
// - K4: 128 query rows a CTA, Q and dO loaded once, K and V tiles of 128
//   keys through 3 stages at hd 64 and 2 at hd 128 on one barrier a stage;
//   lse and delta of a thread's two rows in registers.  S, dP and dq (and
//   the dS fragments) need ~200 registers a thread at hd 128, so it hands
//   registers over as K5 does.  64-key tiles (4 / 3 stages), which would
//   fit without the hand-over, measured slower at both the training shape
//   and Mistral's, and were not kept.
// - K5: 128 keys of one KV head a CTA, walking (query head of the group,
//   query tile) pairs so the GQA sum stays in registers; query tiles of 64
//   rows at hd 128 and 128 at hd 64, 3 stages; lse and delta by bulk copy
//   on the stage's barrier.  dK, dV, S^T and dP^T need ~240 registers a
//   thread at hd 128, and a CTA of 12 warps gets 168 (one of the SM's four
//   register-file partitions holds 3 of them), so the producer warpgroup
//   gives its registers to the consumers with setmaxnreg.
// - ptxas serialises every wgmma it finds on a path it thinks divergent
//   (advisory C7520), and setmaxnreg took effect only once no such path
//   was left: so the role index is made provably warp-uniform
//   (__shfl_sync), the barrier waits are one asm loop each (hopper.cuh),
//   and every consumer thread arrives on a stage's barrier rather than one
//   lane of each warp.
// - Not done yet: overlapping a K3 warpgroup's softmax with its own or the
//   other warpgroup's products (an FA3-style intra-warpgroup overlap and a
//   two-warpgroup ping-pong on named barriers, unserialised, both measured
//   no faster than this body at hd 64), and the same in K4 and K5.
//
// The f32 instantiations keep the first body's layout on the CUDA cores —
// exact f32 for checks; wgmma has no f32: the m16n8 accumulator layout,
// one warp per 16 rows, four warps (64 rows) a CTA, the other side's tiles
// through a cp.async double buffer, P and dS through a per-warp
// shared-memory tile.
//
// Common to both bodies, against the TPU kernels' sequential grid:
// - The TPU grid carries (acc, m, l) across its innermost KV grid dimension.
//   Here one CTA owns a row tile of one (batch, head) and walks the tiles of
//   the other side in a loop inside the block.
// - The causal and window bounds cut that loop (the TPU kernel's
//   _causal_hi / _window_lo, and the dkv kernel's bounds at :313-319).
//   Causal alignment is top-left (query i sees keys <= i), as the kernel's
//   _window_mask; the wrapper only sends Sq == Sk when causal.
// - GQA: the dk/dv CTA owns one KV head's keys and loops over the G query
//   heads of its group, so the group sum happens in registers and no
//   [B*Hq, S, hd] f32 partials are written (the TPU sums them outside).
// - Rounding as the TPU kernel: P is rounded to v's dtype before P.V (:207),
//   dS to k's dtype before dS.K (:291), P^T and dS^T to the inputs' dtype
//   before the dk/dv products (:339, :342); lse, delta and every
//   accumulator stay f32.
// - The f32 body uses the finite NEG_INF (-1e30) of the reference: a
//   row whose keys in a tile are all masked is wiped by the later
//   correction, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BM = NWARPS * 16;  // rows a CTA owns
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Geo {
  static constexpr int PAD = 16 / sizeof(T);  // 16 bytes after each row
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x D elements, rows contiguous in device memory, into a shared tile
// whose rows are LD elements apart; 16-byte chunks spread over the CTA
template <typename T, int D, int LD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows) {
  constexpr int CH = D * sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = i % CH;
    cp_async16(reinterpret_cast<unsigned char*>(dst + r * LD) + c * 16,
               reinterpret_cast<const unsigned char*>(src + r * D) + c * 16);
  }
}

// n f32 values (n a multiple of 4) into shared memory
__device__ __forceinline__ void copy_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += NTHREADS)
    cp_async16(dst + 4 * i, src + 4 * i);
}

// One warp: c[j] (+)= A[16 x K] . B[K x 8j..8j+7] for j < NT8, exact f32
// products on the CUDA cores in the m16n8 accumulator layout (lane = 4g +
// t holds rows g and g + 8, columns 2t and 2t + 1 of each 8-column tile).
// A is row-major in shared memory (A(m, k) = a[m * lda + k]); B(k, n) =
// b[n * ldb + k] when BT ("stored transposed", e.g. K for Q.Kᵀ), else
// b[k * ldb + n].
template <typename T, bool BT, int K, int NT8>
__device__ __forceinline__ void warp_gemm(float (&c)[NT8][4], const T* a,
                                          int lda, const T* b, int ldb) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = to_f(a[g * lda + k]);
    const float a1 = to_f(a[(g + 8) * lda + k]);
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int n = j * 8 + 2 * t;
      const float b0 = to_f(BT ? b[n * ldb + k] : b[k * ldb + n]);
      const float b1 = to_f(BT ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1]);
      c[j][0] += a0 * b0;
      c[j][1] += a0 * b1;
      c[j][2] += a1 * b0;
      c[j][3] += a1 * b1;
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

// key kpos is visible to query qpos: causal (kpos <= qpos) and inside the
// window (kpos > qpos - window) when there is one
__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// ------------------------------------------------------------- forward (K3)

template <typename T, int D>
struct FwdCfg {
  static constexpr int BN = 64;  // keys a tile
  static constexpr int LD = D + Geo<T>::PAD;
  static constexpr int LP = BN + Geo<T>::PAD;
  static constexpr int TILE = BN * LD;  // elements of one K (or V) tile
  static constexpr size_t SMEM =
      sizeof(T) * (BM * LD + 4 * TILE + NWARPS * 16 * LP);
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int G, int Sq, int Sk,
                 int causal, int window, float scale) {
  static_assert(std::is_same<T, float>::value,
                "bf16 runs flash_fwd_wgmma_kernel");
  using C = FwdCfg<T, D>;
  constexpr int BN = C::BN, LD = C::LD, LP = C::LP, NT8 = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BM * LD;     // 2 stages
  T* vs = ks + 2 * C::TILE;  // 2 stages
  T* ps = vs + 2 * C::TILE;  // [NWARPS][16][LP]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // heavy (late, causal) row tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int bkv = b * (H / G) + (bh % H) / G;
  const T* qb = q + (static_cast<long long>(bh) * Sq + q0) * D;
  const T* kb = k + static_cast<long long>(bkv) * Sk * D;
  const T* vb = v + static_cast<long long>(bkv) * Sk * D;

  const int hi = causal ? min(Sk, q0 + BM) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int jlo = lo / BN;
  const int jhi = (hi + BN - 1) / BN;

  copy_rows<T, D, LD>(qs, qb, BM);
  copy_rows<T, D, LD>(ks, kb + static_cast<long long>(jlo) * BN * D, BN);
  copy_rows<T, D, LD>(vs, vb + static_cast<long long>(jlo) * BN * D, BN);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);
  T* pw = ps + warp * 16 * LP;

  for (int j = jlo; j < jhi; ++j) {
    const int cur = (j - jlo) & 1;
    if (j + 1 < jhi) {
      const long long off = static_cast<long long>(j + 1) * BN * D;
      copy_rows<T, D, LD>(ks + (cur ^ 1) * C::TILE, kb + off, BN);
      copy_rows<T, D, LD>(vs + (cur ^ 1) * C::TILE, vb + off, BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + cur * C::TILE;
    const T* vt = vs + cur * C::TILE;

    float s[NT8][4];
    zero(s);
    warp_gemm<T, true, D, NT8>(s, qs + warp * 16 * LD, LD, kt, LD);

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int jj = 0; jj < NT8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int col = j * BN + jj * 8 + 2 * t + (e & 1);
        float x = s[jj][e] * scale;
        if (causal && !visible(row, col, window)) x = NEG_INF;
        s[jj][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < NT8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[jj][e] - m[e >> 1]);
        sum[e >> 1] += p;
        pw[((e >> 1) * 8 + g) * LP + jj * 8 + 2 * t + (e & 1)] = from_f<T>(p);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      acc[jj][0] *= corr[0];
      acc[jj][1] *= corr[0];
      acc[jj][2] *= corr[1];
      acc[jj][3] *= corr[1];
    }
    __syncwarp();
    warp_gemm<T, false, BN, D / 8>(acc, pw, LP, vt, LD);
    __syncthreads();  // every warp is done with this stage and its P tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    T* orow = o + (static_cast<long long>(bh) * Sq + row) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      orow[jj * 8 + 2 * t] = from_f<T>(acc[jj][2 * i] / l[i]);
      orow[jj * 8 + 2 * t + 1] = from_f<T>(acc[jj][2 * i + 1] / l[i]);
    }
    if (t == 0) lse[static_cast<long long>(bh) * Sq + row] = m[i] + logf(l[i]);
  }
}

// ----------------------------------------------------------- backward dq (K4)

template <typename T, int D>
struct DqCfg {
  static constexpr int BN = 64;
  static constexpr int LD = D + Geo<T>::PAD;
  static constexpr int LP = BN + Geo<T>::PAD;
  static constexpr int TILE = BN * LD;
  static constexpr size_t SMEM =
      sizeof(T) * (2 * BM * LD + 4 * TILE + NWARPS * 16 * LP);
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int G, int Sq, int Sk, int causal, int window,
                    float scale) {
  static_assert(std::is_same<T, float>::value,
                "bf16 runs flash_bwd_dq_wgmma_kernel");
  using C = DqCfg<T, D>;
  constexpr int BN = C::BN, LD = C::LD, LP = C::LP, NT8 = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + BM * LD;
  T* ks = dos + BM * LD;     // 2 stages
  T* vs = ks + 2 * C::TILE;  // 2 stages
  T* dss = vs + 2 * C::TILE;  // [NWARPS][16][LP]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int bkv = b * (H / G) + (bh % H) / G;
  const long long qoff = (static_cast<long long>(bh) * Sq + q0) * D;
  const T* kb = k + static_cast<long long>(bkv) * Sk * D;
  const T* vb = v + static_cast<long long>(bkv) * Sk * D;

  const int hi = causal ? min(Sk, q0 + BM) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int jlo = lo / BN;
  const int jhi = (hi + BN - 1) / BN;

  copy_rows<T, D, LD>(qs, q + qoff, BM);
  copy_rows<T, D, LD>(dos, dout + qoff, BM);
  copy_rows<T, D, LD>(ks, kb + static_cast<long long>(jlo) * BN * D, BN);
  copy_rows<T, D, LD>(vs, vb + static_cast<long long>(jlo) * BN * D, BN);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;
  const long long rb = static_cast<long long>(bh) * Sq;
  const float lse_r[2] = {lse[rb + r0], lse[rb + r0 + 8]};
  const float dlt_r[2] = {delta[rb + r0], delta[rb + r0 + 8]};
  float acc[D / 8][4];
  zero(acc);
  T* dsw = dss + warp * 16 * LP;

  for (int j = jlo; j < jhi; ++j) {
    const int cur = (j - jlo) & 1;
    if (j + 1 < jhi) {
      const long long off = static_cast<long long>(j + 1) * BN * D;
      copy_rows<T, D, LD>(ks + (cur ^ 1) * C::TILE, kb + off, BN);
      copy_rows<T, D, LD>(vs + (cur ^ 1) * C::TILE, vb + off, BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + cur * C::TILE;
    const T* vt = vs + cur * C::TILE;

    float s[NT8][4], dp[NT8][4];
    zero(s);
    zero(dp);
    warp_gemm<T, true, D, NT8>(s, qs + warp * 16 * LD, LD, kt, LD);
    warp_gemm<T, true, D, NT8>(dp, dos + warp * 16 * LD, LD, vt, LD);
#pragma unroll
    for (int jj = 0; jj < NT8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = r0 + i * 8;
        const int col = j * BN + jj * 8 + 2 * t + (e & 1);
        float x = s[jj][e] * scale;
        if (causal && !visible(row, col, window)) x = NEG_INF;
        const float p = expf(x - lse_r[i]);
        dsw[(i * 8 + g) * LP + jj * 8 + 2 * t + (e & 1)] =
            from_f<T>(p * (dp[jj][e] - dlt_r[i]));
      }
    __syncwarp();
    warp_gemm<T, false, BN, D / 8>(acc, dsw, LP, kt, LD);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* drow = dq + (rb + r0 + i * 8) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      drow[jj * 8 + 2 * t] = from_f<T>(acc[jj][2 * i] * scale);
      drow[jj * 8 + 2 * t + 1] = from_f<T>(acc[jj][2 * i + 1] * scale);
    }
  }
}

// ------------------------------------------------------ backward dk/dv (K5)

template <typename T, int D>
struct DkvCfg {
  static constexpr int BN = D == 128 ? 32 : 64;  // queries a tile
  static constexpr int LD = D + Geo<T>::PAD;
  static constexpr int LP = BN + Geo<T>::PAD;
  static constexpr int TILE = BN * LD;
  static constexpr size_t SMEM =
      sizeof(T) * (2 * BM * LD + 4 * TILE + 2 * NWARPS * 16 * LP) +
      sizeof(float) * 4 * BN;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int G, int Sq, int Sk,
                     int causal, int window, float scale) {
  static_assert(std::is_same<T, float>::value,
                "bf16 runs flash_bwd_dkv_wgmma_kernel");
  using C = DkvCfg<T, D>;
  constexpr int BN = C::BN, LD = C::LD, LP = C::LP, NT8 = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BM * LD;
  T* qs = vs + BM * LD;       // 2 stages
  T* dos = qs + 2 * C::TILE;  // 2 stages
  T* ps = dos + 2 * C::TILE;  // [NWARPS][16][LP], Pᵀ
  T* dss = ps + NWARPS * 16 * LP;  // [NWARPS][16][LP], dSᵀ
  float* lse_s = reinterpret_cast<float*>(dss + NWARPS * 16 * LP);  // 2 x BN
  float* dlt_s = lse_s + 2 * BN;                                    // 2 x BN

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * BM;
  const int bkv = blockIdx.y;  // b * Hkv + kv head
  const int Hkv = H / G;
  const int b = bkv / Hkv;
  const int hq0 = (bkv % Hkv) * G;  // the group's first query head
  const long long koff = (static_cast<long long>(bkv) * Sk + k0) * D;

  // queries that can see one of this CTA's keys: from the first key on
  // (causal) up to the last key + window - 1 (window)
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(Sq, k0 + BM + window - 1) : Sq;
  const int ilo = lo / BN;
  const int nq = (hi + BN - 1) / BN - ilo;
  const int n_it = G * nq;  // (query head, query tile) pairs

  copy_rows<T, D, LD>(ks, k + koff, BM);
  copy_rows<T, D, LD>(vs, v + koff, BM);
  auto fetch = [&](int it, int stage) {
    const int hq = hq0 + it / nq;
    const int i = ilo + it % nq;
    const long long row = static_cast<long long>(b * H + hq) * Sq + i * BN;
    copy_rows<T, D, LD>(qs + stage * C::TILE, q + row * D, BN);
    copy_rows<T, D, LD>(dos + stage * C::TILE, dout + row * D, BN);
    copy_f32(lse_s + stage * BN, lse + row, BN);
    copy_f32(dlt_s + stage * BN, delta + row, BN);
  };
  fetch(0, 0);
  cp_async_commit();

  const int kr0 = k0 + warp * 16 + g;  // this thread's keys: kr0, kr0 + 8
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  T* pw = ps + warp * 16 * LP;
  T* dsw = dss + warp * 16 * LP;

  for (int it = 0; it < n_it; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_it) {
      fetch(it + 1, cur ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qt = qs + cur * C::TILE;
    const T* dot = dos + cur * C::TILE;
    const float* lt = lse_s + cur * BN;
    const float* dt = dlt_s + cur * BN;
    const int qbase = (ilo + it % nq) * BN;

    float st[NT8][4], dpt[NT8][4];
    zero(st);
    zero(dpt);
    warp_gemm<T, true, D, NT8>(st, ks + warp * 16 * LD, LD, qt, LD);
    warp_gemm<T, true, D, NT8>(dpt, vs + warp * 16 * LD, LD, dot, LD);
#pragma unroll
    for (int jj = 0; jj < NT8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = kr0 + i * 8;
        const int c = jj * 8 + 2 * t + (e & 1);
        float x = st[jj][e] * scale;
        if (causal && !visible(qbase + c, key, window)) x = NEG_INF;
        const float p = expf(x - lt[c]);
        pw[(i * 8 + g) * LP + c] = from_f<T>(p);
        dsw[(i * 8 + g) * LP + c] = from_f<T>(p * (dpt[jj][e] - dt[c]));
      }
    __syncwarp();
    warp_gemm<T, false, BN, D / 8>(dv_acc, pw, LP, dot, LD);
    warp_gemm<T, false, BN, D / 8>(dk_acc, dsw, LP, qt, LD);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = static_cast<long long>(bkv) * Sk + kr0 + i * 8;
    T* krow = dk + row * D;
    T* vrow = dv + row * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      krow[jj * 8 + 2 * t] = from_f<T>(dk_acc[jj][2 * i] * scale);
      krow[jj * 8 + 2 * t + 1] = from_f<T>(dk_acc[jj][2 * i + 1] * scale);
      vrow[jj * 8 + 2 * t] = from_f<T>(dv_acc[jj][2 * i]);
      vrow[jj * 8 + 2 * t + 1] = from_f<T>(dv_acc[jj][2 * i + 1]);
    }
  }
}

// ------------------------------------------- bf16 on the warpgroup MMA
//
// K3 and K5 in bf16: wgmma on TMA-fed tiles.  Tiles are [box][rows][64]
// in shared memory under the 128-byte swizzle (hopper.cuh); the CTA's
// barriers follow its tiles.

constexpr float LOG2E = 1.4426950408889634f;
constexpr int CONSUMER_WARPS = 8;  // two consumer warpgroups of 64 rows

// quad (4 lanes = one accumulator row) reductions
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit (the scale and log2(e) are folded into
// the argument by one FMA); -inf gives 0
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct FwdWg {
  static constexpr int BM = 128;  // query rows a CTA
  static constexpr int BN = 128;  // keys a tile
  static constexpr int NS = 2;    // K/V stages
  static constexpr int THREADS = CONSUMER_WARPS * 32 + 32;  // + producer
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one K (or V) tile
  static constexpr int BAR_BYTES = 8 * (1 + 3 * NS);
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * NS * KV_BYTES + BAR_BYTES;
};

// K3 in bf16.  One CTA: 128 query rows of one (batch, head) — consumer
// warpgroup w owns rows 64w..64w+63 — and one producer warp that loads Q
// once and streams K and V tiles through an NS-stage ring (K and V on
// separate barriers, so S = Q.K^T starts before V lands).  Per key tile:
// S by wgmma (A = Q, B = K, both K-major in shared memory), the online
// softmax in registers in exp2 form, P rounded to bf16 straight from the
// accumulator into A fragments, O += P.V by wgmma with A from registers
// and B = V read MN-major (transpose bit).
template <int D>
__global__ void __launch_bounds__(FwdWg<D>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int G, int Sq, int Sk,
                       int causal, int window, float scale) {
  using C = FwdWg<D>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::NS, NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::align1024(smem_raw);
  unsigned char* ks = qs + C::Q_BYTES;
  unsigned char* vs = ks + NS * C::KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(vs + NS * C::KV_BYTES);
  uint64_t* bar_k = bar_q + 1;
  uint64_t* bar_v = bar_k + NS;
  uint64_t* bar_e = bar_v + NS;  // a stage is free again

  // warp-uniform as far as the compiler can see: no wgmma on a path it
  // thinks divergent (ptxas would serialise them)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  // heavy (late, causal) row tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int bkv = b * (H / G) + (bh % H) / G;
  const int hi = causal ? min(Sk, q0 + BM) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int jlo = lo / BN;
  const int n = (hi + BN - 1) / BN - jlo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(bar_k + s, 1);
      hopper::mbar_init(bar_v + s, 1);
      hopper::mbar_init(bar_e + s, CONSUMER_WARPS * 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // producer
    if (lane == 0) {
      hopper::mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int nb = 0; nb < NB; ++nb)
        hopper::tma_load_3d(qs + nb * BM * 128, &tq, bar_q, nb * 64, q0, bh);
      for (int it = 0; it < n; ++it) {
        const int s = it % NS;
        if (it >= NS) hopper::mbar_wait(bar_e + s, ((it / NS) - 1) & 1);
        const int row = (jlo + it) * BN;
        hopper::mbar_expect_tx(bar_k + s, C::KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          hopper::tma_load_3d(ks + s * C::KV_BYTES + nb * BN * 128, &tk,
                              bar_k + s, nb * 64, row, bkv);
        hopper::mbar_expect_tx(bar_v + s, C::KV_BYTES);
        for (int nb = 0; nb < NB; ++nb)
          hopper::tma_load_3d(vs + s * C::KV_BYTES + nb * BN * 128, &tv,
                              bar_v + s, nb * 64, row, bkv);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + wg * 64;                 // this warpgroup's rows
  const int r0 = w0 + (warp % 4) * 16 + g;     // this thread's: r0, r0 + 8
  const float c = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  hopper::mbar_wait(bar_q, 0);
  const uint32_t qa = hopper::smem_u32(qs) + wg * 64 * 128;
  for (int it = 0; it < n; ++it) {
    const int s = it % NS;
    const int par = (it / NS) & 1;
    const int kt0 = (jlo + it) * BN;
    const uint32_t ka = hopper::smem_u32(ks + s * C::KV_BYTES);
    const uint32_t va = hopper::smem_u32(vs + s * C::KV_BYTES);

    float sc[BN / 2];
    hopper::mbar_wait(bar_k + s, par);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<BN>::template ss<0>(
          sc, hopper::desc_k(qa + (kk / 4) * BM * 128 + (kk % 4) * 32),
          hopper::desc_k(ka + (kk / 4) * BN * 128 + (kk % 4) * 32), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // per-element masks only on tiles that cross the diagonal, the window
    // edge or the end of the keys
    const bool edge = kt0 + BN > Sk ||
                      (causal && kt0 + BN - 1 > w0) ||
                      (window > 0 && kt0 <= w0 + 63 - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int row = r0 + ((i >> 1) & 1) * 8;
        const int col = kt0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (col >= Sk || (causal && !visible(row, col, window)))
          sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float mc[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      // a row with no visible key yet keeps max -inf: scale by 0 there
      mc[h] = mx[h] == -INFINITY ? 0.f : mx[h] * c;
      corr[h] = exp2_(m[h] * c - mc[h]);
      m[h] = mx[h];
    }
    uint32_t pf[BN / 16][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2_(fmaf(sc[i], c, -mc[h]));
      const float p1 = exp2_(fmaf(sc[i + 1], c, -mc[h]));
      sum[h] += p0 + p1;
      // accumulator pair (i, i + 1) -> A fragment of k step i / 8,
      // register (i / 2) % 4; P rounded to bf16 as the TPU kernel rounds
      // it to v's dtype
      pf[i / 8][(i / 2) % 4] = hopper::pack_bf16(p0, p1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    hopper::mbar_wait(bar_v + s, par);
    hopper::fence_regs(acc);
    hopper::fence_regs(pf);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hopper::Wgmma<D>::template rs<1>(
          acc, pf[kk], hopper::desc_mn(va + kk * 16 * 128, BN * 128), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(bar_e + s);  // every consumer thread
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + h * 8;
    const float lt = quad_sum(l[h]);
    if (row >= Sq) continue;
    const float inv = 1.f / lt;
    __nv_bfloat16* orow = o + (static_cast<long long>(bh) * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                acc[4 * j + 2 * h + 1] * inv);
    }
    if (t == 0)
      lse[static_cast<long long>(bh) * Sq + row] = m[h] * scale + logf(lt);
  }
}

template <int D>
struct DkvWg {
  static constexpr int BK = 128;  // keys a CTA
  static constexpr int BQ = D == 128 ? 64 : 128;  // queries a tile
  static constexpr int NS = 3;  // Q / dO / lse / delta stages
  // two consumer warpgroups and a producer warpgroup, which hands its
  // registers over: 240 a consumer thread, 24 a producer thread (the
  // launch budget is 168 a thread)
  static constexpr int THREADS = 3 * 128;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int KV_BYTES = BK * D * 2;  // K (or V) of the CTA
  static constexpr int T_BYTES = BQ * D * 2;   // one Q (or dO) tile
  // Q, dO, lse, delta; each stage's tiles start 1024-byte aligned
  static constexpr int STAGE =
      (2 * T_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS);
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + NS * STAGE + BAR_BYTES;
};

// K5 in bf16.  One CTA: 128 keys of one KV head (consumer warpgroup w owns
// keys 64w..64w+63, K and V loaded once) walking the (query head of the
// group, query tile) pairs that can see them, so the GQA sum stays in
// registers.  One thread of the producer warpgroup streams Q, dO, lse and
// delta tiles through an NS-stage ring (TMA for Q and dO, bulk copies for
// lse and delta, one barrier a stage) and the warpgroup gives its
// registers to the consumers (setmaxnreg), which hold dK, dV, S^T and dP^T
// in ~240 a thread at hd 128.  Per tile: S^T = K.Q^T and dP^T = V.dO^T by wgmma (A = K or V, B =
// the Q or dO tile, K-major); P^T and dS^T in registers, rounded to bf16
// as A fragments; dV += P^T.dO and dK += dS^T.Q by wgmma with A from
// registers and B = the dO or Q tile read MN-major (transpose bit).
template <int D>
__global__ void __launch_bounds__(DkvWg<D>::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int G,
                           int Sq, int Sk, int causal, int window,
                           float scale) {
  using C = DkvWg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, NS = C::NS, NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = hopper::align1024(smem_raw);
  unsigned char* vs = ks + C::KV_BYTES;
  unsigned char* st0 = vs + C::KV_BYTES;  // stage s: Q, dO, lse, delta
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(st0 + NS * C::STAGE);
  uint64_t* bar_f = bar_kv + 1;  // a stage has landed
  uint64_t* bar_e = bar_f + NS;  // a stage is free again

  // warp-uniform as far as the compiler can see (see flash_fwd_wgmma_kernel;
  // setmaxnreg needs it too)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y;  // b * Hkv + kv head
  const int Hkv = H / G;
  const int b = bkv / Hkv;
  const int hq0 = (bkv % Hkv) * G;  // the group's first query head
  // queries that can see one of this CTA's keys
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(Sq, k0 + BK + window - 1) : Sq;
  const int ilo = lo / BQ;
  const int nq = (hi + BQ - 1) / BQ - ilo;
  const int n_it = G * nq;

  auto load_stage = [&](int it) {
    const int s = it % NS;
    const int bhq = b * H + hq0 + it / nq;
    const int row = (ilo + it % nq) * BQ;
    const uint32_t rbytes = min(BQ, Sq - row) * 4;  // no read past Sq
    unsigned char* st = st0 + s * C::STAGE;
    hopper::mbar_expect_tx(bar_f + s, 2 * C::T_BYTES + 2 * rbytes);
    for (int nb = 0; nb < NB; ++nb) {
      hopper::tma_load_3d(st + nb * BQ * 128, &tq, bar_f + s, nb * 64, row,
                          bhq);
      hopper::tma_load_3d(st + C::T_BYTES + nb * BQ * 128, &tdo, bar_f + s,
                          nb * 64, row, bhq);
    }
    const long long r = static_cast<long long>(bhq) * Sq + row;
    hopper::bulk_load(st + 2 * C::T_BYTES, lse + r, rbytes, bar_f + s);
    hopper::bulk_load(st + 2 * C::T_BYTES + BQ * 4, delta + r, rbytes,
                      bar_f + s);
  };
  auto load_kv = [&] {
    hopper::mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
    for (int nb = 0; nb < NB; ++nb) {
      hopper::tma_load_3d(ks + nb * BK * 128, &tk, bar_kv, nb * 64, k0, bkv);
      hopper::tma_load_3d(vs + nb * BK * 128, &tv, bar_kv, nb * 64, k0, bkv);
    }
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_kv, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(bar_f + s, 1);
      hopper::mbar_init(bar_e + s, CONSUMER_WARPS * 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (warp >= CONSUMER_WARPS) {  // producer warpgroup
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      load_kv();
      for (int it = 0; it < n_it; ++it) {
        if (it >= NS) hopper::mbar_wait(bar_e + it % NS, ((it / NS) - 1) & 1);
        load_stage(it);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<C::CONSUMER_REGS>();

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw0 = k0 + wg * 64;              // this warpgroup's keys
  const int kr0 = kw0 + (warp % 4) * 16 + g;  // this thread's: kr0, kr0 + 8
  const float c = scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(bar_kv, 0);
  const uint32_t ka = hopper::smem_u32(ks) + wg * 64 * 128;
  const uint32_t va = hopper::smem_u32(vs) + wg * 64 * 128;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % NS;
    const int qt0 = (ilo + it % nq) * BQ;
    // wait even on a tile it skips: an arrival on bar_e must not run ahead
    // of the stage's current round
    hopper::mbar_wait(bar_f + s, (it / NS) & 1);
    // a tile none of whose (query, key) pairs this warpgroup sees adds 0
    const bool dark = kw0 >= Sk || (causal && qt0 + BQ - 1 < kw0) ||
                      (window > 0 && qt0 - (kw0 + 63) >= window);
    if (dark) {
      hopper::mbar_arrive(bar_e + s);  // every consumer thread
      continue;
    }
    unsigned char* st = st0 + s * C::STAGE;
    const uint32_t qa = hopper::smem_u32(st);
    const uint32_t da = qa + C::T_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * C::T_BYTES);
    const float* dlt_s = lse_s + BQ;

    float sT[BQ / 2], dpT[BQ / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<BQ>::template ss<0>(
          sT, hopper::desc_k(ka + (kk / 4) * BK * 128 + (kk % 4) * 32),
          hopper::desc_k(qa + (kk / 4) * BQ * 128 + (kk % 4) * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<BQ>::template ss<0>(
          dpT, hopper::desc_k(va + (kk / 4) * BK * 128 + (kk % 4) * 32),
          hopper::desc_k(da + (kk / 4) * BQ * 128 + (kk % 4) * 32), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sT);
    hopper::fence_regs(dpT);

    const bool edge = qt0 + BQ > Sq || (causal && qt0 < kw0 + 63) ||
                      (window > 0 && qt0 + BQ - 1 - kw0 >= window);
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {
      const int key = kr0 + ((i >> 1) & 1) * 8;
      const int col = (i >> 2) * 8 + 2 * t;  // query qt0 + col, col + 1
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 dl = *reinterpret_cast<const float2*>(dlt_s + col);
      float p0 = exp2_(fmaf(sT[i], c, -ls.x * LOG2E));
      float p1 = exp2_(fmaf(sT[i + 1], c, -ls.y * LOG2E));
      float d0 = p0 * (dpT[i] - dl.x);
      float d1 = p1 * (dpT[i + 1] - dl.y);
      if (edge) {
        // select, not multiply: lse / delta past Sq are stale
        const int q = qt0 + col;
        if (q >= Sq || (causal && !visible(q, key, window))) p0 = d0 = 0.f;
        if (q + 1 >= Sq || (causal && !visible(q + 1, key, window)))
          p1 = d1 = 0.f;
      }
      // P^T and dS^T rounded to bf16 as the TPU kernel rounds them to the
      // inputs' dtype; accumulator pair (i, i + 1) -> A fragment of k step
      // i / 8, register (i / 2) % 4
      pf[i / 8][(i / 2) % 4] = hopper::pack_bf16(p0, p1);
      dsf[i / 8][(i / 2) % 4] = hopper::pack_bf16(d0, d1);
    }

    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(pf);
    hopper::fence_regs(dsf);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::Wgmma<D>::template rs<1>(
          dv_acc, pf[kk], hopper::desc_mn(da + kk * 16 * 128, BQ * 128), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::Wgmma<D>::template rs<1>(
          dk_acc, dsf[kk], hopper::desc_mn(qa + kk * 16 * 128, BQ * 128), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::mbar_arrive(bar_e + s);  // every consumer thread
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr0 + h * 8;
    if (key >= Sk) continue;
    const long long row = static_cast<long long>(bkv) * Sk + key;
    __nv_bfloat16* krow = dk + row * D;
    __nv_bfloat16* vrow = dv + row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * h] * scale,
                                dk_acc[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * h],
                                dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
struct DqWg {
  static constexpr int BM = 128;  // query rows a CTA
  static constexpr int BK = 128;  // keys a tile
  static constexpr int NS = D == 64 ? 3 : 2;  // K/V stages
  // two consumer warpgroups and a producer warpgroup, which hands its
  // registers over as K5's does: S, dP, dq and the dS fragments take ~200
  // a consumer thread at hd 128
  static constexpr int THREADS = 3 * 128;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int Q_BYTES = BM * D * 2;   // Q (or dO) of the CTA
  static constexpr int KV_BYTES = BK * D * 2;  // one K (or V) tile
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS);
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + 2 * NS * KV_BYTES + BAR_BYTES;
};

// K4 in bf16.  One CTA: 128 query rows of one (batch, head) — consumer
// warpgroup w owns rows 64w..64w+63 — and a producer warpgroup, one thread
// of which loads Q and dO once and streams K and V tiles of BK keys
// through an NS-stage ring (one barrier a stage).  Per key tile: S = Q.K^T
// and dP = dO.V^T by wgmma (A = the Q or dO rows, B = the K or V tile,
// both K-major); P = exp2(S c - lse log2 e) and dS = P (dP - delta) in
// registers, rounded to bf16 straight into A fragments; dq += dS.K by
// wgmma with A from registers and B = the K tile read MN-major (transpose
// bit).  lse and delta of the thread's two rows live in registers.
template <int D>
__global__ void __launch_bounds__(DqWg<D>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int H, int G,
                          int Sq, int Sk, int causal, int window,
                          float scale) {
  using C = DqWg<D>;
  constexpr int BM = C::BM, BK = C::BK, NS = C::NS, NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::align1024(smem_raw);
  unsigned char* dos = qs + C::Q_BYTES;
  unsigned char* ks = dos + C::Q_BYTES;
  unsigned char* vs = ks + NS * C::KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(vs + NS * C::KV_BYTES);
  uint64_t* bar_f = bar_q + 1;   // a stage has landed
  uint64_t* bar_e = bar_f + NS;  // a stage is free again

  // warp-uniform as far as the compiler can see (see flash_fwd_wgmma_kernel;
  // setmaxnreg needs it too)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  // heavy (late, causal) row tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int bkv = b * (H / G) + (bh % H) / G;
  const int hi = causal ? min(Sk, q0 + BM) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int jlo = lo / BK;
  const int n = (hi + BK - 1) / BK - jlo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(bar_f + s, 1);
      hopper::mbar_init(bar_e + s, CONSUMER_WARPS * 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (warp >= CONSUMER_WARPS) {  // producer warpgroup
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      hopper::mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
      for (int nb = 0; nb < NB; ++nb) {
        hopper::tma_load_3d(qs + nb * BM * 128, &tq, bar_q, nb * 64, q0, bh);
        hopper::tma_load_3d(dos + nb * BM * 128, &tdo, bar_q, nb * 64, q0,
                            bh);
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % NS;
        if (it >= NS) hopper::mbar_wait(bar_e + s, ((it / NS) - 1) & 1);
        const int row = (jlo + it) * BK;
        hopper::mbar_expect_tx(bar_f + s, 2 * C::KV_BYTES);
        for (int nb = 0; nb < NB; ++nb) {
          hopper::tma_load_3d(ks + s * C::KV_BYTES + nb * BK * 128, &tk,
                              bar_f + s, nb * 64, row, bkv);
          hopper::tma_load_3d(vs + s * C::KV_BYTES + nb * BK * 128, &tv,
                              bar_f + s, nb * 64, row, bkv);
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<C::CONSUMER_REGS>();

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + wg * 64;              // this warpgroup's rows
  const int r0 = w0 + (warp % 4) * 16 + g;  // this thread's: r0, r0 + 8
  const float c = scale * LOG2E;
  float lse2[2], dlt[2];  // lse log2(e) and delta of the thread's rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + h * 8;
    const long long r = static_cast<long long>(bh) * Sq + row;
    lse2[h] = row < Sq ? lse[r] * LOG2E : 0.f;
    dlt[h] = row < Sq ? delta[r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(bar_q, 0);
  const uint32_t qa = hopper::smem_u32(qs) + wg * 64 * 128;
  const uint32_t da = hopper::smem_u32(dos) + wg * 64 * 128;
  for (int it = 0; it < n; ++it) {
    const int s = it % NS;
    const int kt0 = (jlo + it) * BK;
    // wait even on a tile it skips: an arrival on bar_e must not run ahead
    // of the stage's current round
    hopper::mbar_wait(bar_f + s, (it / NS) & 1);
    // a tile none of whose (query, key) pairs this warpgroup sees adds 0
    const bool dark = w0 >= Sq || (causal && kt0 > w0 + 63) ||
                      (window > 0 && kt0 + BK - 1 <= w0 - window);
    if (dark) {
      hopper::mbar_arrive(bar_e + s);  // every consumer thread
      continue;
    }
    const uint32_t ka = hopper::smem_u32(ks + s * C::KV_BYTES);
    const uint32_t va = hopper::smem_u32(vs + s * C::KV_BYTES);

    float sc[BK / 2], dp[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<BK>::template ss<0>(
          sc, hopper::desc_k(qa + (kk / 4) * BM * 128 + (kk % 4) * 32),
          hopper::desc_k(ka + (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<BK>::template ss<0>(
          dp, hopper::desc_k(da + (kk / 4) * BM * 128 + (kk % 4) * 32),
          hopper::desc_k(va + (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // per-element masks only on tiles that cross the diagonal, the window
    // edge, the end of the keys or the end of the queries
    const bool edge = kt0 + BK > Sk || w0 + 63 >= Sq ||
                      (causal && kt0 + BK - 1 > w0) ||
                      (window > 0 && kt0 <= w0 + 63 - window);
    uint32_t dsf[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2_(fmaf(sc[i], c, -lse2[h]));
      const float p1 = exp2_(fmaf(sc[i + 1], c, -lse2[h]));
      float d0 = p0 * (dp[i] - dlt[h]);
      float d1 = p1 * (dp[i + 1] - dlt[h]);
      if (edge) {
        // select, not multiply: a masked score's P is not 0 by itself
        const int row = r0 + h * 8;
        const int col = kt0 + (i >> 2) * 8 + 2 * t;
        if (row >= Sq || col >= Sk || (causal && !visible(row, col, window)))
          d0 = 0.f;
        if (row >= Sq || col + 1 >= Sk ||
            (causal && !visible(row, col + 1, window)))
          d1 = 0.f;
      }
      // dS rounded to bf16 as the TPU kernel rounds it to k's dtype;
      // accumulator pair (i, i + 1) -> A fragment of k step i / 8, register
      // (i / 2) % 4
      dsf[i / 8][(i / 2) % 4] = hopper::pack_bf16(d0, d1);
    }

    hopper::fence_regs(acc);
    hopper::fence_regs(dsf);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::Wgmma<D>::template rs<1>(
          acc, dsf[kk], hopper::desc_mn(ka + kk * 16 * 128, BK * 128), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(bar_e + s);  // every consumer thread
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + h * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* drow = dq + (static_cast<long long>(bh) * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(drow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale,
                                acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Shape {
  int B, H, Hkv, Sq, Sk, hd, causal, window;
  float scale;
};

bool bad(const Shape& s) {
  return s.B < 1 || s.Hkv < 1 || s.H % s.Hkv != 0 ||
         (s.hd != 64 && s.hd != 128) || s.Sq < BM || s.Sk < BM ||
         s.Sq % BM != 0 || s.Sk % BM != 0 || (s.causal && s.Sq != s.Sk) ||
         (s.window > 0 && !s.causal);
}

template <int D>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                      void* lse, const Shape& s, cudaStream_t st) {
  using C = FwdWg<D>;
  CUtensorMap tq, tk, tv;
  if (!encode_tile_map(&tq, q, s.B * s.H, s.Sq, D, C::BM) ||
      !encode_tile_map(&tk, k, s.B * s.Hkv, s.Sk, D, C::BN) ||
      !encode_tile_map(&tv, v, s.B * s.Hkv, s.Sk, D, C::BN))
    return cudaErrorNotSupported;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = prepare(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((s.Sq + C::BM - 1) / C::BM, s.B * s.H), C::THREADS, C::SMEM,
           st>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                 static_cast<float*>(lse), s.H, s.H / s.Hkv, s.Sq, s.Sk,
                 s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          const Shape& s, cudaStream_t st) {
  using C = DkvWg<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_tile_map(&tq, q, s.B * s.H, s.Sq, D, C::BQ) ||
      !encode_tile_map(&tdo, dout, s.B * s.H, s.Sq, D, C::BQ) ||
      !encode_tile_map(&tk, k, s.B * s.Hkv, s.Sk, D, C::BK) ||
      !encode_tile_map(&tv, v, s.B * s.Hkv, s.Sk, D, C::BK))
    return cudaErrorNotSupported;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  cudaError_t err = prepare(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((s.Sk + C::BK - 1) / C::BK, s.B * s.Hkv), C::THREADS, C::SMEM,
           st>>>(tq, tk, tv, tdo, static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), s.H, s.H / s.Hkv, s.Sq,
                 s.Sk, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

// bf16 K3, K4 and K5 run the warpgroup bodies; f32 the CUDA-core ones
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Shape& s, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return fwd_wgmma<D>(q, k, v, o, lse, s, st);
  } else {
    const size_t smem = FwdCfg<T, D>::SMEM;
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(s.Sq / BM, s.B * s.H), NTHREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), s.H, s.H / s.Hkv, s.Sq, s.Sk, s.causal,
        s.window, s.scale);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t bwd_dq_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dq, const Shape& s,
                         cudaStream_t st) {
  using C = DqWg<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_tile_map(&tq, q, s.B * s.H, s.Sq, D, C::BM) ||
      !encode_tile_map(&tdo, dout, s.B * s.H, s.Sq, D, C::BM) ||
      !encode_tile_map(&tk, k, s.B * s.Hkv, s.Sk, D, C::BK) ||
      !encode_tile_map(&tv, v, s.B * s.Hkv, s.Sk, D, C::BK))
    return cudaErrorNotSupported;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  cudaError_t err = prepare(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((s.Sq + C::BM - 1) / C::BM, s.B * s.H), C::THREADS, C::SMEM,
           st>>>(tq, tk, tv, tdo, static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<__nv_bfloat16*>(dq), s.H, s.H / s.Hkv, s.Sq,
                 s.Sk, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Shape& s, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return bwd_dq_wgmma<D>(q, k, v, dout, lse, delta, dq, s, st);
  } else {
    const size_t smem = DqCfg<T, D>::SMEM;
    auto kernel = flash_bwd_dq_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(s.Sq / BM, s.B * s.H), NTHREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), s.H, s.H / s.Hkv, s.Sq, s.Sk, s.causal,
        s.window, s.scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Shape& s, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return bwd_dkv_wgmma<D>(q, k, v, dout, lse, delta, dk, dv, s, st);
  } else {
    const size_t smem = DkvCfg<T, D>::SMEM;
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(s.Sk / BM, s.B * s.Hkv), NTHREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), s.H, s.H / s.Hkv, s.Sq,
        s.Sk, s.causal, s.window, s.scale);
    return cudaGetLastError();
  }
}

}  // namespace

// Every entry point: q [B*H, Sq, hd], k/v [B*Hkv, Sk, hd] (query heads of
// a GQA group consecutive), lse/delta [B*H, Sq] f32, all contiguous and
// 16-byte aligned; dtype_tag 0 = bf16, 1 = f32; window <= 0 means none.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernels do not take).

#define TDP_DISPATCH(CALL)                                                  \
  Shape s{B, H, Hkv, Sq, Sk, hd, causal, window, sm_scale};                 \
  if (bad(s)) return static_cast<int>(cudaErrorInvalidValue);               \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                      \
  cudaError_t err;                                                          \
  switch (dtype_tag * 2 + (hd == 128 ? 1 : 0)) {                            \
    case 0: { using T = __nv_bfloat16; constexpr int D = 64; err = CALL; }  \
      break;                                                                \
    case 1: { using T = __nv_bfloat16; constexpr int D = 128; err = CALL; } \
      break;                                                                \
    case 2: { using T = float; constexpr int D = 64; err = CALL; } break;    \
    case 3: { using T = float; constexpr int D = 128; err = CALL; } break;   \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }                                                                         \
  return static_cast<int>(err);

extern "C" int tdp_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Hkv,
                             int Sq, int Sk, int hd, int causal, int window,
                             float sm_scale, int dtype_tag, void* stream) {
  TDP_DISPATCH((fwd<T, D>(q, k, v, o, lse, s, st)))
}

extern "C" int tdp_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Hkv, int Sq, int Sk, int hd, int causal,
                                int window, float sm_scale, int dtype_tag,
                                void* stream) {
  TDP_DISPATCH((bwd_dq<T, D>(q, k, v, dout, lse, delta, dq, s, st)))
}

extern "C" int tdp_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int Hkv, int Sq, int Sk, int hd,
                                 int causal, int window, float sm_scale,
                                 int dtype_tag, void* stream) {
  TDP_DISPATCH((bwd_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, s, st)))
}

// Dynamic shared memory a CTA of each kernel uses (kernel 0 fwd, 1 dq,
// 2 dkv), for the build report; -1 if unknown.
extern "C" int tdp_flash_smem_bytes(int kernel, int dtype_tag, int hd) {
  if (hd != 64 && hd != 128) return -1;
  const bool h = hd == 128;
  size_t n = 0;
  if (dtype_tag == 0) {
    n = kernel == 0 ? (h ? FwdWg<128>::SMEM : FwdWg<64>::SMEM)
        : kernel == 1 ? (h ? DqWg<128>::SMEM : DqWg<64>::SMEM)
                      : (h ? DkvWg<128>::SMEM : DkvWg<64>::SMEM);
  } else if (dtype_tag == 1) {
    using T = float;
    n = kernel == 0 ? (h ? FwdCfg<T, 128>::SMEM : FwdCfg<T, 64>::SMEM)
        : kernel == 1 ? (h ? DqCfg<T, 128>::SMEM : DqCfg<T, 64>::SMEM)
                      : (h ? DkvCfg<T, 128>::SMEM : DkvCfg<T, 64>::SMEM);
  } else {
    return -1;
  }
  return kernel < 0 || kernel > 2 ? -1 : static_cast<int>(n);
}
