// gemm — tiled fp32 SIMT matrix product with a fused bias/ReLU epilogue,
// for NVIDIA Hopper (sm_90a).
//
// Replaces: the Pallas kernel repro/kernels/gemm.py::gemm (body _gemm_kernel),
// out = relu(x @ w + bias), x [M, K], w [K, N], bias [N] (optional), all fp32
// row-major, fp32 accumulation.  In the port it carries the combination
// x @ w of every served GCN layer.
//
// What bounds it on this card: at the serving shapes (K = 602 or 256,
// N = 256 or 41, M up to 16384) the flops, 2 * M * N * K, over the 67 TFLOP/s
// fp32 (non-tensor-core) rate; at small M the bytes of w and x, and the
// launch.  TF32 tensor cores would be faster but round the inputs to 10
// mantissa bits, which breaks parity with the fp32 reference (and 3xTF32
// changes the bits), so this kernel stays on the fp32 FMA units: the most
// it can do is keep them busy.
//
// Design.  A 256-thread CTA computes a 128 x 128 output tile, each thread an
// 8 x 8 register micro-tile (rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
// columns likewise with tx), so each k costs 4 float4 shared-memory reads
// for 64 FMAs: the FMA units, not shared memory, set the pace.  Where
// 128 x 128 tiles would not fill the card once (M * N small: the logits
// layer, [1024, 256] @ [256, 41]) it takes 64 x 64 tiles of 4 x 4
// micro-tiles instead.  The K loop runs over BK = 16 slices through a
// 3-stage cp.async ring in dynamic shared memory (50 KB for the large tile,
// above the 48 KB default): the loads of slices k+1 and k+2 are in flight
// while slice k is multiplied.  The x slice is stored k-major (transposed
// on the way in by 4-byte copies, since x's rows need not be 16-byte
// aligned: K = 602), rows padded to BM + 4 floats so micro-tile reads are
// aligned float4; the w slice goes in by 16-byte copies when N % 4 == 0,
// else by 4-byte ones.  Ragged K (602 = 37 * 16 + 10), M and N edges are
// zero-filled in shared memory by the copies themselves.  The epilogue adds
// the bias, applies the ReLU and stores float4 where N % 4 == 0, masked
// scalars elsewhere.  M runs on grid.x, so any M fits.
//
// Bits.  There is no split over K and the K order is fixed: every output
// element is one fused multiply-add per k, ascending from k = 0 on a zero
// accumulator, over the same zero-padded K for both tile sizes.  So an
// element's rounding depends only on its row of x and its column of w, never
// on M, on the row's position or on the tile size: the same vertex gets the
// same bits in every power-of-two bucket of the serving path, which is what
// makes incremental logits equal a cold recompute on the card (a library
// GEMM picks its algorithm, and may split K, by shape).  The previous
// kernel (64 x 64 tiles, 4 x 4 micro-tiles, no pipelining) ran the same
// chain, so the bits are its bits.
// Later work: warp-level tiles and double-buffered register fragments, to
// close the gap to cuBLAS's fp32 kernel at the served shapes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 16;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kSms = 132;             // fallback when the query fails

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0 .. size) from src, the rest of `size` zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <int BM, int BN>
struct Tile {
  static constexpr int TM = BM / 16;            // micro-tile rows (8 or 4)
  static constexpr int TN = BN / 16;
  static constexpr int LDX = BM + 4;            // xs row: k-major, padded
  static constexpr int XS = BK * LDX;           // floats per x stage
  static constexpr int WS = BK * BN;            // floats per w stage
  static constexpr int kSmem = kStages * (XS + WS) * 4;
};

// Where one thread's copies of a K-slice come from, fixed for the whole
// K loop: its x rows (k fastest across threads, so reads coalesce) and its
// w row and columns.  Slice kt moves each source by kt * BK along K.
template <int BM, int BN>
struct Loader {
  using T = Tile<BM, BN>;
  static constexpr int kXRows = kThreads / BK;        // x rows per pass
  static constexpr int kXPass = BM / kXRows;          // 8 or 4
  static constexpr int kWChunks = BN / 4;             // 16 B chunks per row
  static constexpr int kWVecPass = BK * kWChunks / kThreads;
  static constexpr int kWPass = BK * BN / kThreads;

  const float* x;      // x[row0 + xm][xk]
  const float* w;      // w[wk][col0 + wn]
  int xm, xk, wk, wn;  // this thread's offsets in the tile
  int x_rows;          // rows of the tile that exist (M - row0)
  int w_cols;          // columns of the tile that exist (N - col0)
  int K, N;

  __device__ Loader(const float* x_, const float* w_, int M, int N_, int K_,
                    int row0, int col0, bool vec_w) {
    const int tid = threadIdx.x;
    K = K_;
    N = N_;
    xm = tid / BK;
    xk = tid % BK;
    x_rows = M - row0;
    w_cols = N - col0;
    if (vec_w) {
      wk = tid / kWChunks;
      wn = 4 * (tid % kWChunks);
    } else {
      wk = tid / BN;
      wn = tid % BN;
    }
    x = x_ + static_cast<long long>(row0 + xm) * K + xk;
    w = w_ + static_cast<long long>(wk) * N + col0 + wn;
  }

  // Copy K-slice kt into one ring slot; zero-fill past the edges.
  __device__ __forceinline__ void load(float* xs, float* ws, int kt,
                                       bool vec_w) const {
    const int k0 = kt * BK;
    const bool xk_in = k0 + xk < K;
#pragma unroll
    for (int l = 0; l < kXPass; ++l) {
      const int m = xm + l * kXRows;
      const bool in = xk_in && m < x_rows;
      cp_async4(&xs[xk * T::LDX + m],
                in ? x + static_cast<long long>(l * kXRows) * K + k0 : x,
                in ? 4 : 0);
    }
    if (vec_w) {
#pragma unroll
      for (int l = 0; l < kWVecPass; ++l) {
        const int kk = wk + l * (kThreads / kWChunks);
        const int bytes = k0 + kk < K ? 4 * max(0, min(4, w_cols - wn)) : 0;
        cp_async16(&ws[kk * BN + wn],
                   bytes ? w + static_cast<long long>(k0 + kk - wk) * N : w,
                   bytes);
      }
    } else {
#pragma unroll
      for (int l = 0; l < kWPass; ++l) {
        const int kk = wk + l * (kThreads / BN);
        const bool in = k0 + kk < K && wn < w_cols;
        cp_async4(&ws[kk * BN + wn],
                  in ? w + static_cast<long long>(k0 + kk - wk) * N : w,
                  in ? 4 : 0);
      }
    }
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int M,
            int N, int K, int relu, int vec_w, int vec_out) {
  using T = Tile<BM, BN>;
  constexpr int TM = T::TM;
  constexpr int TN = T::TN;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                         // [kStages][BK][LDX]
  float* ws = smem + kStages * T::XS;       // [kStages][BK][BN]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int n_k = (K + BK - 1) / BK;
  const Loader<BM, BN> ld(x, w, M, N, K, row0, col0, vec_w);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) ld.load(xs + s * T::XS, ws + s * T::WS, s, vec_w);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int ahead = kt + kStages - 1;     // its slot was freed at kt - 1
    if (ahead < n_k) {
      const int slot = ahead % kStages;
      ld.load(xs + slot * T::XS, ws + slot * T::WS, ahead, vec_w);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // slice kt has landed
    __syncthreads();
    const float* xk = xs + (kt % kStages) * T::XS;
    const float* wk = ws + (kt % kStages) * T::WS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            xk + kk * T::LDX + q * (BM / 2) + ty * 4);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            wk + kk * BN + q * (BN / 2) + tx * 4);
        b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();                        // the slot may be refilled
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + (i / 4) * (BM / 2) + ty * 4 + (i % 4);
    if (gr >= M) continue;
    float* orow = out + static_cast<long long>(gr) * N;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int gc = col0 + q * (BN / 2) + tx * 4;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = acc[i][4 * q + u];
        if (bias != nullptr && gc + u < N) v[u] = __fadd_rn(v[u], bias[gc + u]);
        if (relu && v[u] < 0.f) v[u] = 0.f;
      }
      if (vec_out) {                        // N % 4 == 0: gc < N => gc + 3 < N
        if (gc < N)
          *reinterpret_cast<float4*>(orow + gc) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (gc + u < N) orow[gc + u] = v[u];
      }
    }
  }
}

template <int BM, int BN>
int run(const float* x, const float* w, const float* bias, float* out, int M,
        int N, int K, int relu, bool vec_w, bool vec_out,
        cudaStream_t stream) {
  constexpr int smem = Tile<BM, BN>::kSmem;
  static bool configured = false;           // the attribute, once per tile
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_kernel<BM, BN><<<grid, kThreads, smem, stream>>>(
      x, w, bias, out, M, N, K, relu, vec_w, vec_out);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = kSms;
  }
  return sms;
}

}  // namespace

extern "C" int gemm_launch(const void* x, const void* w, const void* bias,
                           void* out, int M, int N, int K, int relu,
                           void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec_w =
      N % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool vec_out =
      N % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  const long long big = static_cast<long long>((M + 127) / 128) *
                        ((N + 127) / 128);
  if (big >= sm_count())                    // 128 x 128 tiles fill the card
    return run<128, 128>(xf, wf, bf, of, M, N, K, relu, vec_w, vec_out, st);
  return run<64, 64>(xf, wf, bf, of, M, N, K, relu, vec_w, vec_out, st);
}
