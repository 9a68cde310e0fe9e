// spmm_ell — pre-reduced ELL gather-accumulate for NVIDIA Hopper (sm_90a).
//
// Replaces: the Pallas kernel repro/kernels/spmm.py::spmm_ell (body
// _spmm_ell_kernel) and its XLA twin repro/kernels/ops.py::_ell_walk.
// Computes, over one degree bucket of an EllTables plan,
//     y[r, :] = sum_{k=0}^{K-1} vals[r, k] * x[cols[r, k], :]
// with cols [nb, K] int32, vals [nb, K] fp32, x [n_src, d] fp32, y [nb, d].
// A column outside [0, n_src) is padding (the plan pads with n_src) and
// contributes nothing; the reference appends a zero row to x instead.
//
// What bounds it on this card: bytes.  Each real entry moves one row of x
// (d * 4 bytes) for 2 * d flops, far below the ~20 flop/byte that would make
// fp32 compute the limit; the tables add 8 bytes per padded entry.
//
// Design.  The TPU kernel densified each (row tile, source tile) into a
// one-hot merge matrix for the MXU, at n_rows * n_src * d flops; here the
// gather is direct, so the cost scales with padded nnz * d.  One warp owns
// one row and a 128-wide feature tile (4 features per lane, lanes on
// neighbouring addresses, so each x row is read in coalesced 128-byte
// pieces); the CTA holds 4 rows.  A warp loads 32 (col, val) pairs at a time
// with one coalesced read and broadcasts them with shuffles, then gathers
// kUnroll entries' rows at once (independent loads in flight, which is what
// hub rows with K in the thousands need) before adding them in order.  The
// K loop runs in ascending k with one fp32 register accumulator per feature
// and no atomics, no split over K: a row's value depends only on its own
// entries, never on which rows share the launch.  That is what keeps the
// serving path's incremental logits bit-equal to a cold recompute.  Products and
// sums are rounded separately (no FMA contraction), in the order of the
// plain PyTorch version, so the two agree bit for bit.
// Ragged widths (d = 41 on the logits layer) are masked per lane; K = 1
// buckets and hub buckets (K in the thousands, 1-2 rows) run the same loop;
// the wrapper never launches an empty (nb = 0) bucket.
// Later work: more rows in flight for hub buckets, cp.async staging.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kVec = 4;                       // features per lane
constexpr int kFeatTile = 32 * kVec;          // features per warp
constexpr int kUnroll = 8;                    // entries gathered at once

__global__ void spmm_ell_kernel(const int* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ x,
                                float* __restrict__ out,
                                int nb, int K, int n_src, int d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= nb) return;                        // uniform across the warp
  const int f0 = blockIdx.y * kFeatTile + lane;
  const int* crow = cols + static_cast<size_t>(r) * K;
  const float* vrow = vals + static_cast<size_t>(r) * K;

  float acc[kVec];
  bool started = false;
#pragma unroll
  for (int t = 0; t < kVec; ++t) acc[t] = 0.f;

  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kk = k0 + lane;
    const int c_lane = kk < K ? crow[kk] : -1;
    const float v_lane = kk < K ? vrow[kk] : 0.f;
    const int n = min(32, K - k0);
    for (int j0 = 0; j0 < n; j0 += kUnroll) {
      float p[kUnroll][kVec];
      bool real[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {     // gather: loads independent
        const int c = __shfl_sync(0xffffffffu, c_lane, j0 + u);
        const float v = __shfl_sync(0xffffffffu, v_lane, j0 + u);
        real[u] = c >= 0 && c < n_src;        // padding (or k >= K): nothing
        const float* xr = x + static_cast<size_t>(real[u] ? c : 0) * d;
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          const int f = f0 + 32 * t;
          p[u][t] = (real[u] && f < d) ? __fmul_rn(__ldg(xr + f), v) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {     // accumulate: ascending k
        if (!real[u]) continue;
#pragma unroll
        for (int t = 0; t < kVec; ++t)
          acc[t] = started ? __fadd_rn(acc[t], p[u][t]) : p[u][t];
        started = true;
      }
    }
  }
  float* orow = out + static_cast<size_t>(r) * d;
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    const int f = f0 + 32 * t;
    if (f < d) orow[f] = acc[t];
  }
}

}  // namespace

extern "C" int spmm_ell_launch(const void* cols, const void* vals,
                               const void* x, void* out, int nb, int K,
                               int n_src, int d, void* stream) {
  if (nb > 0 && d > 0) {
    dim3 grid((nb + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (d + kFeatTile - 1) / kFeatTile);
    dim3 block(32 * kWarpsPerBlock);
    spmm_ell_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(out), nb, K, n_src,
        d);
  }
  return static_cast<int>(cudaGetLastError());
}
