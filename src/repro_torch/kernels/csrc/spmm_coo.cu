// spmm_coo — row-grouped COO gather walk for NVIDIA Hopper (sm_90a).
//
// Replaces: the Pallas kernels repro/kernels/spmm.py::spmm_block (the
// Block-Message layout, body _spmm_coo_kernel with edge_axis=2) and
// repro/kernels/spmm.py::spmm (the flat COO layout, edge_axis=1), and
// their XLA twins (repro/core/gcn.py::_spmm_t_blocked,
// repro/distributed/aggregate.py::_local_partials_blocked, the coo
// segment sums).  Both compute
//     y[r, :] = sum_{e : row(e) = r} vals[e] * x[cols[e], :]
// with row(e) = rows[e] for the flat layout and row(e) = b * dpc + rows[b, e]
// for Block-Message tiles ([n_blocks, e_blk] with block-local rows).  The
// transpose walk A^T e is the same sum with the roles of rows and cols
// swapped.  A column outside [0, n_src) is padding and gathers nothing.
//
// The grouping.  The kernel never reads rows: the host groups the entries
// by output row once per layout (repro_torch.kernels.ref.row_grouping, a
// stable sort) into perm [n_ent] and ptr [n_out + 1] — row r's entries are
// perm[ptr[r] : ptr[r + 1]], in their order in the edge list.  That order
// is block_partition's (row, col) order for both layouts, so the tiles and
// the flat list add every row's terms in the same order and the block and
// coo aggregates agree bit for bit.  Entries that add nothing (weight 0,
// column out of range) are left out of the grouping.
//
// Stacked cores.  The distributed path stacks every sender core's entries
// shape-aligned: perm/cols/vals [P, n_ent], ptr [P, n_out + 1],
// x [P, n_src, d], y [P, n_out, d].  One launch walks all P cores
// (grid.z = core): core p reads x + p * x_core and writes out + p *
// out_core.  x_core may be 0 (every core reads the one all-gathered error
// of the backward), and rows may be strided (a feature wave of x), so the
// kernel takes core and row strides for x and out; features are
// unit-stride.  The 2-D call is P = 1.
//
// What bounds it on this card: bytes.  Each entry moves one row of x
// (d * 4 bytes) for 2 * d flops, far below the ~20 flop/byte at which fp32
// compute would be the limit; the grouping adds 4 bytes and the entry 8.
//
// Design.  The TPU kernel densified each edge chunk into two one-hot MXU
// products (gather [be, n_src] @ x, scatter [n_rows, be] @ g), e * n_src * d
// work; here the gather is direct and there is no scatter: one warp owns
// one output row and a 128-wide feature tile (4 features per lane, lanes on
// neighbouring addresses, so each x row is read in coalesced 128-byte
// pieces); the CTA holds 4 rows.  A warp loads 32 grouped entries at a time
// (perm coalesced, then the entry's column and weight) and broadcasts them
// with shuffles, then gathers kUnroll entries' rows at once (independent
// loads in flight) before adding them in order.  The accumulator starts at
// 0 and adds the products in grouping order, each product and each sum
// rounded on its own (no FMA contraction): the order of the plain PyTorch
// version (ref.grouped_walk_ref, index_add_ into zeros), so the two agree
// bit for bit.  No atomics and no split of a row: a row's value depends
// only on its own entries, never on which rows or cores share the launch,
// so the walk is deterministic run to run.  Every row is written, so an
// empty row (or empty tile) is 0; ragged widths (d = 41, d = 1) are masked
// per lane.
// Later work: hub rows (the transpose walk's sources sampled by many rows)
// run one warp serially; split them or give them more warps in flight.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kVec = 4;                       // features per lane
constexpr int kFeatTile = 32 * kVec;          // features per warp
constexpr int kUnroll = 8;                    // entries gathered at once

__global__ void spmm_coo_kernel(const int* __restrict__ perm,
                                const int* __restrict__ ptr,
                                const int* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ x,
                                float* __restrict__ out,
                                int n_out, int n_ent, int n_src, int d,
                                long long x_core, long long x_row,
                                long long out_core, long long out_row) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= n_out) return;                     // uniform across the warp
  const int core = blockIdx.z;
  const int f0 = blockIdx.y * kFeatTile + lane;
  const size_t ent0 = static_cast<size_t>(core) * n_ent;
  const int* cperm = perm + ent0;
  const int* ccols = cols + ent0;
  const float* cvals = vals + ent0;
  const int* cptr = ptr + static_cast<size_t>(core) * (n_out + 1);
  x += core * x_core;
  const int start = cptr[r];
  const int end = cptr[r + 1];

  float acc[kVec];
#pragma unroll
  for (int t = 0; t < kVec; ++t) acc[t] = 0.f;

  for (int k0 = start; k0 < end; k0 += 32) {
    const int kk = k0 + lane;
    int c_lane = -1;
    float v_lane = 0.f;
    if (kk < end) {
      const int e = cperm[kk];
      c_lane = ccols[e];
      v_lane = cvals[e];
    }
    const int n = min(32, end - k0);
    for (int j0 = 0; j0 < n; j0 += kUnroll) {
      float p[kUnroll][kVec];
      bool real[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {     // gather: loads independent
        const int c = __shfl_sync(0xffffffffu, c_lane, j0 + u);
        const float v = __shfl_sync(0xffffffffu, v_lane, j0 + u);
        real[u] = c >= 0 && c < n_src;        // padding (or past the row)
        const float* xr = x + (real[u] ? c : 0) * x_row;
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          const int f = f0 + 32 * t;
          p[u][t] = (real[u] && f < d) ? __fmul_rn(__ldg(xr + f), v) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {     // accumulate: grouping order
        if (!real[u]) continue;
#pragma unroll
        for (int t = 0; t < kVec; ++t) acc[t] = __fadd_rn(acc[t], p[u][t]);
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

}  // namespace

// The walk for P stacked cores (P = 1: one core, x_core = out_core = 0):
// perm/cols/vals [P, n_ent] int32/int32/fp32 and ptr [P, n_out + 1] int32,
// contiguous; x and out addressed through the given core and row strides
// (in elements), features unit-stride.  Called for the flat layout (spmm)
// and for Block-Message tiles (spmm_block, n_out = n_blocks * dpc, the
// tiles flattened).  Returns the launch's CUDA error code.
extern "C" int spmm_coo_launch(const void* perm, const void* ptr,
                               const void* cols, const void* vals,
                               const void* x, void* out, int P, int n_out,
                               int n_ent, int n_src, int d, long long x_core,
                               long long x_row, long long out_core,
                               long long out_row, void* stream) {
  if (P > 0 && n_out > 0 && d > 0) {
    dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (d + kFeatTile - 1) / kFeatTile, P);
    dim3 block(32 * kWarpsPerBlock);
    spmm_coo_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(perm), static_cast<const int*>(ptr),
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(out), n_out, n_ent,
        n_src, d, x_core, x_row, out_core, out_row);
  }
  return static_cast<int>(cudaGetLastError());
}
