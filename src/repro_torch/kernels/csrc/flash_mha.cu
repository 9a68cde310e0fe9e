// flash_mha — causal or full softmax attention with an online softmax, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash.py:81 (flash_mha, body _flash_kernel at
// :36).  o = softmax(q kᵀ / √hd) v over q [bh, sq, hd], k/v [bh, sk, hd]
// (heads flattened into the leading dimension; the GQA repeat is the
// caller's), f32 or bf16 inputs, f32 logits and accumulator, p rounded to
// v's type before p @ v, the output in q's type.  The causal mask is
// j <= i counted from 0 on both axes (no sk - sq offset), as in the TPU
// kernel.  In the port it is the prefill attention of the dense transformer
// once the KV length passes FLASH_THRESHOLD (models/transformer.py).
//
// What bounds it on this card: the flops.  A causal call does
// 4 · bh · hd · s(s+1)/2 flops (a multiply-add in q kᵀ and one in p v for
// each live (i, j) pair), against the 67 TFLOP/s f32 rate outside the
// tensor cores (f32 inputs keep f32 products: TF32 would round q and k to
// 10 mantissa bits); the bytes
// (q, k, v read once, o written once) are ~1% of that time at s = 16384.
//
// Design.  One 256-thread CTA per (bh, 64-row query tile); the grid lists
// the last (most expensive, causal) query tiles first so the tail of the
// launch is the cheap tiles.  The CTA stages its Q tile once, transposed,
// in shared memory, then sweeps 64-key tiles of K (transposed) and V
// (row-major) through shared memory.  Each thread holds a 4 x 4 block of
// the score tile (rows 4·ty.., keys 4·tx..) and a 4 x hd/16 block of the
// output accumulator for the same 4 rows, so the running max m, sum l and
// the rescale of acc stay in registers; row max and row sum are reduced
// over the 16 lanes that share the rows with shuffles.  p (rounded to v's
// type) goes through shared memory for the p @ v product.  Causal: key
// tiles strictly above the query tile's last row are never loaded, and
// only tiles that cross the diagonal (or the ragged end of sk) evaluate
// the mask.  The first key tile holds key 0, which every row may attend,
// so m is finite after it and exp(finfo.min - m) is 0, never NaN.  The
// CUDA tile (64 x 64) is this kernel's own; the API's q_block / k_block
// are only the reference's divisibility contract, and ragged sq / sk are
// masked here.  Shared memory: 120 KB at hd = 128 (dynamic, opted in with
// cudaFuncSetAttribute), 69 KB at hd = 64.
// Later work: wgmma on bf16, TMA-fed double-buffered K/V tiles, a
// warp-specialized producer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int BQ = 64;                 // query rows per CTA
constexpr int BK = 64;                 // keys per tile
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kPad = 4;                // keeps float4 rows 16-byte aligned
constexpr int QS = BQ + kPad;          // row stride of the transposed Q tile
constexpr int KS = BK + kPad;          // row stride of the transposed K tile
constexpr int PS = BK + kPad;          // row stride of the p tile
constexpr float kNeg = -FLT_MAX;       // finfo(float32).min, the reference's

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// CN consecutive floats from shared memory (16-byte aligned when CN >= 4)
template <int CN>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (CN % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CN; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      out[c] = t.x; out[c + 1] = t.y; out[c + 2] = t.z; out[c + 3] = t.w;
    }
  } else if constexpr (CN == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < CN; ++c) out[c] = p[c];
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(HD) * QS + static_cast<size_t>(HD) * KS +
          static_cast<size_t>(BK) * HD + static_cast<size_t>(BQ) * PS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int bh, int sq,
                 int sk, int causal, float scale) {
  constexpr int CN = HD / 16;          // output columns per thread
  constexpr int V4 = HD / 4;           // float4 pieces per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [HD][QS], Q transposed
  float* Ks = Qs + HD * QS;                      // [HD][KS], K transposed
  float* Vs = Ks + HD * KS;                      // [BK][HD]
  float* Ps = Vs + BK * HD;                      // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (sq + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh);
  const int b = static_cast<int>(blockIdx.x % bh);
  const int q0 = qt * BQ;
  const T* qb = q + static_cast<size_t>(b) * sq * HD;
  const T* kb = k + static_cast<size_t>(b) * sk * HD;
  const T* vb = v + static_cast<size_t>(b) * sk * HD;

  for (int e = tid; e < BQ * V4; e += kThreads) {
    const int r = e / V4;
    const int d = (e % V4) * 4;
    const float4 x = (q0 + r < sq)
        ? load4(qb + static_cast<size_t>(q0 + r) * HD + d)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    Qs[(d + 0) * QS + r] = x.x;
    Qs[(d + 1) * QS + r] = x.y;
    Qs[(d + 2) * QS + r] = x.z;
    Qs[(d + 3) * QS + r] = x.w;
  }

  float m[4], l[4], acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, sq) - 1;
  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, q_last / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // last tile's readers are done
    for (int e = tid; e < BK * V4; e += kThreads) {
      const int r = e / V4;
      const int d = (e % V4) * 4;
      const bool in = k0 + r < sk;
      const size_t off = static_cast<size_t>(k0 + r) * HD + d;
      const float4 kx = in ? load4(kb + off) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vx = in ? load4(vb + off) : make_float4(0.f, 0.f, 0.f, 0.f);
      Ks[(d + 0) * KS + r] = kx.x;
      Ks[(d + 1) * KS + r] = kx.y;
      Ks[(d + 2) * KS + r] = kx.z;
      Ks[(d + 3) * KS + r] = kx.w;
      *reinterpret_cast<float4*>(Vs + r * HD + d) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + d * QS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Ks + d * KS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > sk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (edge && (col >= sk || (causal && col > row))) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        s[i][j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * PS + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PS + kk);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CN];
        load_cols<CN>(Vs + (kk + u) * HD + tx * CN, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CN; ++c)
            acc[i][c] = fmaf(pr[i][u], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = o + (static_cast<size_t>(b) * sq + row) * HD + tx * CN;
#pragma unroll
    for (int c = 0; c < CN; ++c) store(dst + c, acc[i][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_mha_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((sq + BQ - 1) / BQ) * static_cast<long long>(bh);
  if (tiles > 0) {
    kern<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), bh, sq, sk, causal,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int sk, int hd, int causal, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, bh, sq, sk, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, sq, sk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, sq, sk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, sq, sk, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: [bh, sq, hd]; k, v: [bh, sk, hd]; all contiguous, of one type
// (bf16 != 0: __nv_bfloat16, else float); hd in {16, 32, 64, 128}.
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v,
                                void* o, int bh, int sq, int sk, int hd,
                                int bf16, int causal, float scale,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, hd, causal, scale, s);
  return dispatch<float>(q, k, v, o, bh, sq, sk, hd, causal, scale, s);
}
