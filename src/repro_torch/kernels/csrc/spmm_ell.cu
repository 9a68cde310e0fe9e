// spmm_ell — pre-reduced ELL gather-accumulate for NVIDIA Hopper (sm_90a).
//
// Replaces: the Pallas kernel repro/kernels/spmm.py::spmm_ell (body
// _spmm_ell_kernel), its transpose walk repro/kernels/spmm.py::spmm_ell_t
// (the same pallas_call over the plan's column-major t_* tables), and their
// XLA twin repro/kernels/ops.py::_ell_walk.  Computes, over one degree
// bucket of an EllTables plan,
//     y[r, :] = sum_{k=0}^{K-1} vals[r, k] * x[cols[r, k], :]
// with cols [nb, K] int32, vals [nb, K] fp32, x [n_src, d] fp32, y [nb, d];
// the transpose walk is the same sum with the t_* tables and the error rows
// as x.  A column outside [0, n_src) is padding (the plan pads with n_src)
// and contributes nothing; the reference appends a zero row to x instead.
//
// Stacked cores.  The distributed path stacks every sender core's bucket
// shape-aligned: cols/vals [P, nb, K], x [P, n_src, d], y [P, nb, d].  One
// launch walks the bucket for all P cores (grid.z = core): core p reads
// x + p * x_core and writes out + p * out_core.  x_core may be 0 (every
// core reads one shared x: the backward's all-gathered error rows), and
// rows may be strided (a feature wave of x, or a bucket's slice of the
// walk's output buffer), so the kernel takes core and row strides for x and
// out; the last axis is unit-stride.  The 2-D call is P = 1 with unit rows.
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
// entries, never on which rows (or cores) share the launch.  That is what
// keeps the serving path's incremental logits bit-equal to a cold
// recompute.  Products and sums are rounded separately (no FMA
// contraction), in the order of the plain PyTorch version, so the two agree
// bit for bit.
// Ragged widths (d = 41 on the logits layer) are masked per lane; K = 1
// buckets and hub buckets (K in the thousands, 1-2 rows) run the same loop;
// the wrapper never launches an empty (nb = 0) bucket.  The transpose
// walk's hub rows (a source many batch rows sampled) are the long buckets
// of the backward.
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
                                int nb, int K, int n_src, int d,
                                long long x_core, long long x_row,
                                long long out_core, long long out_row) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= nb) return;                        // uniform across the warp
  const int core = blockIdx.z;
  const int f0 = blockIdx.y * kFeatTile + lane;
  const size_t row = static_cast<size_t>(core) * nb + r;
  const int* crow = cols + row * K;
  const float* vrow = vals + row * K;
  x += core * x_core;

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
        const float* xr = x + (real[u] ? c : 0) * x_row;
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
  float* orow = out + core * out_core + r * out_row;
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    const int f = f0 + 32 * t;
    if (f < d) orow[f] = acc[t];
  }
}

void launch(const void* cols, const void* vals, const void* x, void* out,
            int P, int nb, int K, int n_src, int d, long long x_core,
            long long x_row, long long out_core, long long out_row,
            void* stream) {
  if (P > 0 && nb > 0 && d > 0) {
    dim3 grid((nb + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (d + kFeatTile - 1) / kFeatTile, P);
    dim3 block(32 * kWarpsPerBlock);
    spmm_ell_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(out), nb, K, n_src,
        d, x_core, x_row, out_core, out_row);
  }
}

}  // namespace

// One bucket, one core: cols/vals [nb, K], x [n_src, d], out [nb, d], all
// contiguous (the serving path's call).
extern "C" int spmm_ell_launch(const void* cols, const void* vals,
                               const void* x, void* out, int nb, int K,
                               int n_src, int d, void* stream) {
  launch(cols, vals, x, out, 1, nb, K, n_src, d, 0, d, 0, d, stream);
  return static_cast<int>(cudaGetLastError());
}

// One bucket for P stacked cores: cols/vals [P, nb, K] contiguous; x and
// out addressed through the given core and row strides (in elements).
extern "C" int spmm_ell_cores_launch(const void* cols, const void* vals,
                                     const void* x, void* out, int P, int nb,
                                     int K, int n_src, int d,
                                     long long x_core, long long x_row,
                                     long long out_core, long long out_row,
                                     void* stream) {
  launch(cols, vals, x, out, P, nb, K, n_src, d, x_core, x_row, out_core,
         out_row, stream);
  return static_cast<int>(cudaGetLastError());
}
