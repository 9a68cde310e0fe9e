// flash_mha_bwd — the gradient of flash_mha (dQ, dK, dV) for NVIDIA Hopper
// (sm_90a): causal or not, with or without a sliding window, sq != sk.
//
// Replaces: no Pallas kernel.  The TPU kernel src/repro/kernels/flash.py:81
// has no backward; the function this pair of kernels differentiates is the
// reference's XLA flash_attend (src/repro/models/transformer.py:122-179),
// which jax.grad differentiates through its scan when an LM trains past
// FLASH_THRESHOLD keys.  csrc/flash_mha.cu stands in for that scan on the
// card, so its gradient is a kernel too (the port keeps no plain PyTorch on
// the card's path).
//
// Math (FA2): with lse2 the forward's row log-sum-exp in the log2 domain
// (flash_mha.cu writes it beside o), s = q kᵀ · scale, and
//   p  = 2^(s · scale·log2 e − lse2)      (the forward's softmax, recomputed)
//   dV = pᵀ dO                             (p rounded to v's type first, as
//                                           the forward rounds it before p v)
//   dP = dO vᵀ,  δ = rowsum(dO ∘ o),  dS = p ∘ (dP − δ)
//   dQ = dS k · scale,  dK = dSᵀ q · scale
// in f32 throughout, inputs and outputs f32 or bf16.  The masks are the
// forward's: j <= i when causal, i - j < w with a window, rows counted from
// 0 on both axes, ragged ends masked.  A row with no live key (window, no
// causal mask or sq > sk, i >= sk - 1 + w) has lse2 = -inf and o = 0 from
// the forward; its p is taken as 0, so it adds nothing anywhere and its dQ
// is 0 (never NaN).
//
// Two kernels and no atomics (the port's reductions are fixed-order):
//   (b) dq_kernel: one CTA per (bh, 64-row query tile), launched first.  It
//       computes δ for its rows (written for (a)) and sweeps the key tiles
//       holding live pairs of its rows: dQ += dS k.
//   (a) dkv_kernel: one CTA per (bh, 64-key tile).  It sweeps the query
//       tiles holding live pairs of its keys (i >= j when causal, i - j < w
//       with a window): dV += pᵀ dO, dK += dSᵀ q.
// Each recomputes s and dP, so the pair does 7 products where the bound
// counts 5.  Every long sum (dQ over key tiles, dK and dV over query tiles)
// takes one tile's 64-term partial at a time in a fresh register and adds
// it to the running sum: the error grows with the tile count, not the key
// count.
//
// What bounds it on this card: operations.  10 · hd flops per live (i, j)
// pair (five products) against q, k, v, o, dO read once and dq, dk, dv
// written once (~1% of the flop time at s = 16384).  This first kernel runs
// f32 on the FMA units (67 TFLOP/s), bf16 too (loaded and widened to f32 in
// shared memory): every operand tile is f32 in shared memory, each thread
// computes a 4 × 4 block of s / dP (rows ty + 16i, keys tx + 16j: a 16-byte
// shared load per row and 4 dims, conflict-free with rows padded to ≡ 4
// words mod 32) and 4 rows × hd/16 dims of the d-side products.  Tensor
// cores (mma.sync / wgmma, split TF32 for f32) are the later redesign.
// Shared memory (dynamic, opted in): (a) 170 KB at hd = 128, 105 KB at
// hd = 64; (b) 153 KB and 88 KB.  Tiles load synchronously (no cp.async
// ring): loads and compute overlap only across the CTAs an SM holds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;          // 16 × 16 threads
constexpr int BQ = 64;                 // query rows a tile
constexpr int BKV = 64;                // keys a tile
constexpr int kPad = 4;                // row padding, words
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int stride = HD + kPad;   // Q, dO, K, V rows (floats)
  static constexpr int pstride = BKV + kPad; // P, dS rows (a), dSᵀ rows (b)
  static constexpr int DPT = HD / 16;        // dims a thread owns
  static constexpr int VW = DPT < 4 ? DPT : 4;   // ... loaded VW at a time
  static constexpr int NG = DPT / VW;        // groups of VW dims
  static constexpr int min_blocks = HD <= 64 ? 2 : 1;
  static constexpr size_t tile = sizeof(float) * BQ * stride;
  static constexpr size_t ptile = sizeof(float) * BQ * pstride;
  static constexpr size_t rows = sizeof(float) * BQ;
  // (a): K, V, Q, dO, P, dS, lse, δ;  (b): Q, dO, K, V, dSᵀ, lse, δ
  static constexpr size_t smem_dkv = 4 * tile + 2 * ptile + 2 * rows;
  static constexpr size_t smem_dq = 4 * tile + ptile + 2 * rows;
};

static_assert(BQ == BKV, "the 16 × 16 thread grid tiles both axes alike");

// 2^x on the special-function unit (flash_mha.cu's ex2); -inf gives +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x as the type T holds it (p before pᵀ dO, as the forward rounds p)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __bfloat162float(__float2bfloat16(x));
}

// rows [r0, r0 + 64) of a row-major [n, HD] matrix into dst [64][stride]
// as f32, rows at or past n as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));  // a 16-byte piece
  constexpr int CH = HD / PER;                           // pieces a row
  for (int e = threadIdx.x; e < BQ * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e % CH) * PER;
    float* d = dst + r * Cfg<HD>::stride + c;
    if (r0 + r < n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r0 + r) * HD + c);
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(&raw);
      } else {
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          *reinterpret_cast<float2*>(d + 2 * i) = f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) d[i] = 0.f;
    }
  }
}

// acc[i][j] = Σ_d A[ty + 16i][d] · B[tx + 16j][d], d ascending
template <int HD>
__device__ __forceinline__ void rows_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int S = Cfg<HD>::stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// the dims a thread owns in the d-side products: g·16·VW + tx·VW + c
template <int HD>
__device__ __forceinline__ int dim_of(int g, int tx) {
  return g * 16 * Cfg<HD>::VW + tx * Cfg<HD>::VW;
}

template <int HD>
__device__ __forceinline__ void load_dims(float* v, const float* row,
                                          int tx) {
  constexpr int VW = Cfg<HD>::VW;
#pragma unroll
  for (int g = 0; g < Cfg<HD>::NG; ++g) {
    const float* p = row + dim_of<HD>(g, tx);
    if constexpr (VW == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      v[4 * g] = x.x;
      v[4 * g + 1] = x.y;
      v[4 * g + 2] = x.z;
      v[4 * g + 3] = x.w;
    } else if constexpr (VW == 2) {
      const float2 x = *reinterpret_cast<const float2*>(p);
      v[2 * g] = x.x;
      v[2 * g + 1] = x.y;
    } else {
      v[g] = p[0];
    }
  }
}

// part[i][·] = Σ_r W[r][4ty + i] · X[r][dims], r over the 64 rows of the
// tile in order (W: [64][pstride], X: [64][stride]); then acc += part
template <int HD>
__device__ __forceinline__ void cols_dot(float (&acc)[4][HD / 16],
                                         const float* W, const float* X,
                                         int ty, int tx) {
  constexpr int DPT = HD / 16;
  float part[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) part[i][c] = 0.f;
#pragma unroll 4
  for (int r = 0; r < BQ; ++r) {
    const float4 w =
        *reinterpret_cast<const float4*>(W + r * Cfg<HD>::pstride + 4 * ty);
    float x[DPT];
    load_dims<HD>(x, X + r * Cfg<HD>::stride, tx);
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) part[i][c] = fmaf(wv[i], x[c], part[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] += part[i][c];
}

// rows 4ty + i of a [64 × HD] f32 block, times scale, to out rows r0 + ...
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[4][HD / 16],
                                           int r0, int n, float scale,
                                           int ty, int tx) {
  constexpr int VW = Cfg<HD>::VW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= n) continue;
    T* row = out + static_cast<size_t>(r) * HD;
#pragma unroll
    for (int g = 0; g < Cfg<HD>::NG; ++g)
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        const float x = acc[i][g * VW + c] * scale;
        if constexpr (std::is_same<T, float>::value)
          row[dim_of<HD>(g, tx) + c] = x;
        else
          row[dim_of<HD>(g, tx) + c] = __float2bfloat16(x);
      }
  }
}

// the live mask of flash_mha (window 0: none)
__device__ __forceinline__ bool live(int row, int col, int sq, int sk,
                                     int causal, int window) {
  return row < sq && col < sk && (!causal || col <= row) &&
         (window == 0 || row - col < window);
}

// lse2 of rows [r0, r0 + 64) into ls (a row with no live key, or past sq:
// +inf, so 2^(s - lse2) is 0)
__device__ __forceinline__ void load_lse(float* ls, const float* lse, int r0,
                                         int sq) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const float x = r0 + r < sq ? lse[r0 + r] : -CUDART_INF_F;
    ls[r] = x == -CUDART_INF_F ? CUDART_INF_F : x;
  }
}

// (b): dQ, and δ for (a)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, (Cfg<HD>::min_blocks))
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const float* __restrict__ lse, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ delta, int bh, int sq,
          int sk, int causal, int window, float scale) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * C::stride;
  float* Ks = dOs + BQ * C::stride;
  float* Vs = Ks + BKV * C::stride;
  float* dSt = Vs + BKV * C::stride;      // [key][query]
  float* ls = dSt + BKV * C::pstride;
  float* dl = ls + BQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int nq = (sq + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh);  // heavy first
  const int b = static_cast<int>(blockIdx.x % bh);
  const int q0 = qt * BQ;
  const size_t qoff = static_cast<size_t>(b) * sq;
  const size_t koff = static_cast<size_t>(b) * sk;
  const float scale_log2 = scale * kLog2e;

  load_tile<T, HD>(Qs, q + qoff * HD, q0, sq);
  load_tile<T, HD>(dOs, dout + qoff * HD, q0, sq);
  load_lse(ls, lse + qoff, q0, sq);
  __syncthreads();
  {  // δ = rowsum(dO ∘ o): 4 threads a row, a quarter of the dims each
    const int r = tid >> 2;
    const int part = tid & 3;
    float s = 0.f;
    if (q0 + r < sq) {
      const T* orow = o + (qoff + q0 + r) * HD;
      const float* drow = dOs + r * C::stride;
      for (int d = part * (HD / 4); d < (part + 1) * (HD / 4); ++d) {
        float ov;
        if constexpr (std::is_same<T, float>::value)
          ov = orow[d];
        else
          ov = __bfloat162float(orow[d]);
        s = fmaf(drow[d], ov, s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) {
      dl[r] = s;
      if (q0 + r < sq) delta[qoff + q0 + r] = s;
    }
  }

  // key tiles holding a live pair of rows [q0, q_last]
  const int q_last = min(q0 + BQ, sq) - 1;
  const int nk = (sk + BKV - 1) / BKV;
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BKV : 0;
  const int kt1 = causal ? min(nk, q_last / BKV + 1) : nk;

  float acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();                   // the last tile's K, V, dSᵀ are free
    load_tile<T, HD>(Ks, k + koff * HD, k0, sk);
    load_tile<T, HD>(Vs, v + koff * HD, k0, sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot<HD>(s, Qs, Ks, ty, tx);
    rows_dot<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const float m = ls[rl];
      const float dd = dl[rl];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const float p = live(q0 + rl, k0 + cl, sq, sk, causal, window)
                            ? ex2(fmaf(s[i][j], scale_log2, -m))
                            : 0.f;
        dSt[cl * C::pstride + rl] = p * (dp[i][j] - dd);
      }
    }
    __syncthreads();
    cols_dot<HD>(acc, dSt, Ks, ty, tx);     // dQ += dS k
  }
  store_rows<T, HD>(dq + qoff * HD, acc, q0, sq, scale, ty, tx);
}

// (a): dK, dV
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, (Cfg<HD>::min_blocks))
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ lse,
           const T* __restrict__ dout, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int bh, int sq, int sk,
           int causal, int window, float scale) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BKV * C::stride;
  float* Qs = Vs + BKV * C::stride;
  float* dOs = Qs + BQ * C::stride;
  float* Ps = dOs + BQ * C::stride;       // [query][key]
  float* dSs = Ps + BQ * C::pstride;
  float* ls = dSs + BQ * C::pstride;
  float* dl = ls + BQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int kt = static_cast<int>(blockIdx.x / bh);   // causal: heavy first
  const int b = static_cast<int>(blockIdx.x % bh);
  const int k0 = kt * BKV;
  const size_t qoff = static_cast<size_t>(b) * sq;
  const size_t koff = static_cast<size_t>(b) * sk;
  const float scale_log2 = scale * kLog2e;

  load_tile<T, HD>(Ks, k + koff * HD, k0, sk);
  load_tile<T, HD>(Vs, v + koff * HD, k0, sk);

  // query tiles holding a live pair of keys [k0, k_last]
  const int k_last = min(k0 + BKV, sk) - 1;
  const int nq = (sq + BQ - 1) / BQ;
  const int qt0 = causal ? min(nq, k0 / BQ) : 0;
  const int qt1 =
      window > 0
          ? min(nq, static_cast<int>(
                        (static_cast<long long>(k_last) + window - 1) / BQ) +
                        1)
          : nq;

  float adk[4][HD / 16], adv[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();                   // the last tile's Q, dO, P, dS are free
    load_tile<T, HD>(Qs, q + qoff * HD, q0, sq);
    load_tile<T, HD>(dOs, dout + qoff * HD, q0, sq);
    load_lse(ls, lse + qoff, q0, sq);
    for (int r = tid; r < BQ; r += kThreads)
      dl[r] = q0 + r < sq ? delta[qoff + q0 + r] : 0.f;
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot<HD>(s, Qs, Ks, ty, tx);
    rows_dot<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const float m = ls[rl];
      const float dd = dl[rl];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const float p = live(q0 + rl, k0 + cl, sq, sk, causal, window)
                            ? ex2(fmaf(s[i][j], scale_log2, -m))
                            : 0.f;
        Ps[rl * C::pstride + cl] = round_to<T>(p);
        dSs[rl * C::pstride + cl] = p * (dp[i][j] - dd);
      }
    }
    __syncthreads();
    cols_dot<HD>(adv, Ps, dOs, ty, tx);     // dV += pᵀ dO
    cols_dot<HD>(adk, dSs, Qs, ty, tx);     // dK += dSᵀ q
  }
  store_rows<T, HD>(dv + koff * HD, adv, k0, sk, 1.f, ty, tx);
  store_rows<T, HD>(dk + koff * HD, adk, k0, sk, scale, ty, tx);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int bh, int sq, int sk, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  auto kq = dq_kernel<T, HD>;
  auto kkv = dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long q_ctas = static_cast<long long>((sq + BQ - 1) / BQ) * bh;
  const long long k_ctas = static_cast<long long>((sk + BKV - 1) / BKV) * bh;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if (q_ctas > 0) {
    kq<<<static_cast<unsigned>(q_ctas), kThreads, C::smem_dq, stream>>>(
        tq, tk, tv, static_cast<const T*>(o), lse, tdo, static_cast<T*>(dq),
        delta, bh, sq, sk, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (k_ctas > 0) {
    kkv<<<static_cast<unsigned>(k_ctas), kThreads, C::smem_dkv, stream>>>(
        tq, tk, tv, lse, tdo, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        bh, sq, sk, causal, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, void* dq, void* dk, void* dv,
             float* delta, int bh, int sq, int sk, int hd, int causal,
             int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, sq,
                           sk, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, sq,
                           sk, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, sq,
                           sk, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, sq,
                            sk, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq: [bh, sq, hd]; k, v, dk, dv: [bh, sk, hd]; lse, delta
// (scratch, written here): f32 [bh, sq]; all contiguous and 16-byte
// aligned, q..dv of one type (bf16 != 0: __nv_bfloat16, else float); hd in
// {16, 32, 64, 128}; window 0 for none, else the band width w >= 1.  Two
// launches on `stream`: dq_kernel, then dkv_kernel (which reads δ).
extern "C" int flash_mha_bwd_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* delta,
                                    int bh, int sq, int sk, int hd, int bf16,
                                    int causal, int window, float scale,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, dout, dq, dk, dv, dl, bh,
                                   sq, sk, hd, causal, window, scale, s);
  return dispatch<float>(q, k, v, o, l, dout, dq, dk, dv, dl, bh, sq, sk, hd,
                         causal, window, scale, s);
}
