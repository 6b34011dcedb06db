// Flash attention for Hopper (sm_90a): forward (o, lse), backward dq, and
// backward dk/dv — causal, sliding-window and grouped-query attention that
// never forms the [S, S] score matrix in device memory.
//
// Replaces three TPU kernels of torchdistpackage_tpu/ops/flash_attention.py:
//   K3  _fwd (:220, body _fwd_kernel :174)         -> flash_fwd_kernel
//   K4  _bwd dq (:369, body _bwd_dq_kernel :262)   -> flash_bwd_dq_kernel
//   K5  _bwd dkv (:395, body _bwd_dkv_kernel :301) -> flash_bwd_dkv_kernel
//
// What bounds them on an H100 at training shapes: operations.  A causal
// forward at B 16, H 12, S 2048, hd 64 does ~1.03e11 FLOP on ~50 MB of
// q, k, v, o (~2000 FLOP a byte, far above the ~295 where the tensor cores
// set the pace); dq does 1.5x and dk/dv 2x that work.  So every product runs
// on the tensor cores: mma.sync m16n8k16, bf16 in, f32 accumulate, one warp
// per 16 rows, four warps (64 rows) a CTA.  f32 inputs take the same code
// with each warp's product done on the CUDA cores in the mma's register
// layout (exact f32, for checks; the training path is bf16).
//
// Design, against the TPU kernels' sequential grid:
// - The TPU grid carries (acc, m, l) across its innermost KV grid dimension.
//   Here one CTA owns 64 rows of one (batch, head) and walks the tiles of
//   the other side in a loop inside the block; the next tile is copied with
//   cp.async into the second of two shared-memory buffers while the current
//   one is consumed.
// - The causal and window bounds cut that loop (the TPU kernel's
//   _causal_hi / _window_lo, and the dkv kernel's bounds at :313-319).
//   Causal alignment is top-left (query i sees keys <= i), as the kernel's
//   _window_mask; the wrapper only sends Sq == Sk when causal.
// - GQA: the dk/dv CTA owns one KV head's 64 keys and loops over the G
//   query heads of its group, so the group sum happens in registers and no
//   [B*Hq, S, hd] f32 partials are written (the TPU sums them outside).
// - Finite NEG_INF (-1e30), as in the reference: a row whose keys in a
//   tile are all masked is wiped by the later correction, never NaN.
// - Rounding as the TPU kernel: P is rounded to v's dtype before P.V (:207),
//   dS to k's dtype before dS.K (:291), Pᵀ and dSᵀ to the inputs' dtype
//   before the dk/dv products (:339, :342); lse, delta and every
//   accumulator stay f32.
// P and dS pass through a per-warp shared-memory tile between the two
// products, and fragments are assembled with 32-bit shared loads rather
// than ldmatrix.  A faster version would keep P in registers, use wgmma
// with 64-row warpgroup tiles fed by TMA, and overlap softmax with the next
// tile's products (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// One warp: c[j] (+)= A[16 x K] . B[K x 8j..8j+7] for j < NT8, in the
// m16n8 accumulator layout (lane = 4g + t holds rows g and g + 8, columns
// 2t and 2t + 1 of each 8-column tile).  A is row-major in shared memory
// (A(m, k) = a[m * lda + k]); B(k, n) = b[n * ldb + k] when BT ("stored
// transposed", e.g. K for Q.Kᵀ), else b[k * ldb + n].
template <typename T, bool BT, int K, int NT8>
__device__ __forceinline__ void warp_gemm(float (&c)[NT8][4], const T* a,
                                          int lda, const T* b, int ldb) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
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
        if (BT) {
          bf[0] = ld32(b + n * ldb + k0 + 2 * t);
          bf[1] = ld32(b + n * ldb + k0 + 2 * t + 8);
        } else {
          bf[0] = pack2(b[(k0 + 2 * t) * ldb + n], b[(k0 + 2 * t + 1) * ldb + n]);
          bf[1] = pack2(b[(k0 + 2 * t + 8) * ldb + n],
                        b[(k0 + 2 * t + 9) * ldb + n]);
        }
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
        const float b0 = to_f(BT ? b[n * ldb + k] : b[k * ldb + n]);
        const float b1 = to_f(BT ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1]);
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

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Shape& s, cudaStream_t st) {
  const size_t smem = FwdCfg<T, D>::SMEM;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(s.Sq / BM, s.B * s.H), NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s.H, s.H / s.Hkv, s.Sq, s.Sk, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Shape& s, cudaStream_t st) {
  const size_t smem = DqCfg<T, D>::SMEM;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(s.Sq / BM, s.B * s.H), NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s.H, s.H / s.Hkv, s.Sq, s.Sk, s.causal, s.window,
      s.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Shape& s, cudaStream_t st) {
  const size_t smem = DkvCfg<T, D>::SMEM;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(s.Sk / BM, s.B * s.Hkv), NTHREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s.H, s.H / s.Hkv, s.Sq, s.Sk,
      s.causal, s.window, s.scale);
  return cudaGetLastError();
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
    using T = __nv_bfloat16;
    n = kernel == 0 ? (h ? FwdCfg<T, 128>::SMEM : FwdCfg<T, 64>::SMEM)
        : kernel == 1 ? (h ? DqCfg<T, 128>::SMEM : DqCfg<T, 64>::SMEM)
                      : (h ? DkvCfg<T, 128>::SMEM : DkvCfg<T, 64>::SMEM);
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
