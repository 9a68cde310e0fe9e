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
// fp32 (non-tensor-core) rate; at small M the bytes of w and x dominate.
// TF32 tensor cores would be faster but round the inputs to 10 mantissa
// bits, which breaks parity with the fp32 reference, so this kernel stays on
// the fp32 FMA units.
//
// Design.  A 256-thread CTA computes a 64 x 64 output tile; each thread
// holds a 4 x 4 register micro-tile (rows ty + 16 i, columns tx + 16 j, so
// shared-memory reads are broadcasts or conflict-free).  The K loop stages a
// 64 x 16 tile of x (stored k-major) and a 16 x 64 tile of w in shared memory
// per step, zero-filled past the ragged edges (K = 602, N = 41, any M).
// There is no split over K and the K order is fixed (ascending, one fused
// multiply-add per k), so an output element's rounding depends only on its
// row of x and its column of w, never on M or on the row's position: the
// same vertex gets the same bits in every power-of-two bucket of the serving
// path.  That is the property that makes incremental logits equal a cold
// recompute on the card (a library GEMM picks its algorithm, and may split
// K, by shape).
// Later work: wider micro-tiles, vector loads, cp.async double buffering.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
            int M, int N, int K, int relu) {
  __shared__ float xs[BK][BM];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);        // 0..15
  const int ty = tid / (BN / TN);        // 0..15
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 64 rows x 16 k; thread loads 4 elements, k fastest
#pragma unroll
    for (int l = 0; l < (BM * BK) / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e % BK;
      const int mm = e / BK;
      const int gr = row0 + mm;
      const int gk = k0 + kk;
      xs[kk][mm] = (gr < M && gk < K) ? x[static_cast<size_t>(gr) * K + gk]
                                      : 0.f;
    }
    // w tile: 16 k x 64 columns; thread loads 4 elements, column fastest
#pragma unroll
    for (int l = 0; l < (BK * BN) / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int nn = e % BN;
      const int kk = e / BN;
      const int gk = k0 + kk;
      const int gc = col0 + nn;
      ws[kk][nn] = (gk < K && gc < N) ? w[static_cast<size_t>(gk) * N + gc]
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v = __fadd_rn(v, bias[gc]);
      if (relu && v < 0.f) v = 0.f;
      out[static_cast<size_t>(gr) * N + gc] = v;
    }
  }
}

}  // namespace

extern "C" int gemm_launch(const void* x, const void* w, const void* bias,
                           void* out, int M, int N, int K, int relu,
                           void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K,
        relu);
  }
  return static_cast<int>(cudaGetLastError());
}
