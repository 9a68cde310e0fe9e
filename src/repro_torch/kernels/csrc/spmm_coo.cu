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
// x [P, n_src, d], y [P, n_out, d].  One launch walks all P cores: core p
// reads x + p * x_core and writes out + p * out_core.  x_core may be 0
// (every core reads the one all-gathered error of the backward), and rows
// may be strided (a feature wave of x, a slice of a larger out whose
// neighbours stay untouched), so the kernel takes core and row strides for
// x and out; features are unit-stride.  The 2-D call is P = 1.
//
// What bounds it on this card.  Bytes in theory: each entry moves one row
// of x (d * 4 bytes) for 2 * d flops, and every output row is written.  In
// practice, loads in flight: the rows come from random places, and each
// entry sits at the end of a chain of dependent loads (ptr -> perm ->
// cols/vals -> x).  The training walks hold ~2 entries per output row and
// a quarter of their rows are empty, so a design that gives each row a
// warp (the first port's) spends its time walking that chain once per row
// and per 128-feature tile, with a handful of gathers in flight.
//
// Design.
// * Work by entries and rows together.  Warp k of a core owns the rows r
//   whose diagonal r + ptr[r] lies in [k * kBudget, (k + 1) * kBudget):
//   a run of consecutive rows that holds about kBudget rows plus entries,
//   so empty rows and rows of 1-2 entries share a warp.  A row that starts
//   in the range is walked whole by its warp, in order; a long row (a hub)
//   simply makes the warps whose ranges it covers own nothing.  The warp
//   finds its first and last row itself, with a 32-way search of ptr (32
//   probes per round, both ends at once, ~3 rounds for 10^4 rows, the
//   last round's probes giving the run's first and last entry), so no
//   work list is built on the host or kept beside the tables.  The grid is
//   an upper bound: (n_out + n_ent) / kBudget warps per core; a warp past
//   its core's rows and entries returns after one round.  kBudget = 32
//   rows plus entries: on the H100 it beat 16, 64 and 128 on every
//   training and serving walk, small runs keeping even a walk of ~2 k
//   rows a core spread over the card.
// * One warp covers 256 features (grid.y tiles wider rows): two float4 per
//   lane at d = 256, so the index chain is read once per row, not once per
//   128-feature tile.  Ragged or misaligned widths (d = 41, d = 1, a
//   feature-wave slice off a 16-byte boundary) take 1, 2, 4 or 8 scalar
//   features per lane, spaced 32 apart.
// * The warp's entries are one contiguous range of perm.  Lanes load 32
//   of them at a time (perm coalesced, three chunks ahead; then cols and
//   vals, two chunks ahead) and broadcast them by shuffles.  A register
//   ring keeps the next R entries' x rows in flight across row
//   boundaries (64 floats per lane: R = 8 at two float4 per lane, 16 at
//   one, 32 for narrow rows), ahead of the in-order adds; the ends of the
//   next 64 rows ride in lane registers.  A larger ring (128 floats) was
//   no faster on the H100 and spilled registers on the scalar path.
// * Loads are unconditional volatile loads, so the compiler keeps them
//   ahead of their use: padding and features past d read a block of zeros
//   with weight -0.0, and entries past the warp's range are never added.
// * The bit contract.  Each row's accumulator starts at +0.0 and adds its
//   entries' products in grouping order, every product and every sum
//   rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction): the
//   order of the plain PyTorch version (ref.grouped_walk_ref, index_add_
//   into zeros), so the two agree bit for bit.  A sum that starts at +0.0
//   is never -0.0, so a padding entry's signed-zero product changes no
//   bit.  No atomics and no split of a row over its entries: a row's value
//   depends only on its own entries, never on which rows, cores or
//   feature tiles share the launch or a warp, so the walk is deterministic
//   run to run.  Every row is written, so an empty row (or an empty tile,
//   or a core with no entries) is 0, stored as wide as the row's loads.
// Later work: a hub row (the served block layer holds rows of 10^3
// entries) is one warp's chain of R gathers at a time; the 4 warps of a
// block could split its 256 features instead, as the ELL walk's long rows
// do.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;     // warps per block
constexpr int kTile = 256;    // features one warp walks
constexpr int kChunk = 32;    // grouped entries loaded at once, one per lane
constexpr int kRing = 64;     // floats per lane in the gather ring
constexpr int kBudget = 32;   // rows plus entries one warp's range spans

// Zeros that padding entries and features past d load instead of x.
__device__ __align__(16) float kZeros[128];

// Volatile, unconditional loads: the compiler keeps them where they are
// written, ahead of their use, instead of sinking them next to it.
__device__ __forceinline__ float4 ld4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld1(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int ldi(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// The run of rows a warp owns: rows [r0, r1) and their entries
// [e0, e1) = [ptr[r0], ptr[r1]).
struct Run {
  int r0, r1, e0, e1;
};

// r0 (r1) is the smallest r in [0, n) with r + ptr[r] >= t0 (t1), or n if
// there is none; both searches run at once.  r + ptr[r] rises strictly
// with r, so each round's 32 probes (lane i at the end of the i-th of 32
// equal parts of the range) narrow the range to one part, whose end was
// probed and holds: the answer's ptr comes with it, no load after.
__device__ __forceinline__ Run find_run(const int* ptr, int n, long long t0,
                                        long long t1, int lane) {
  const int ptr_n = __ldg(ptr + n);
  int lo[2] = {0, 0}, hi[2] = {n, n}, at_hi[2] = {ptr_n, ptr_n};
  const long long t[2] = {t0, t1};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int step[2], q[2], v[2];
    bool hit[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      step[s] = (hi[s] - lo[s] + 31) / 32;
      q[s] = min(lo[s] + (lane + 1) * step[s] - 1, hi[s] - 1);
      v[s] = lo[s] < hi[s] ? __ldg(ptr + q[s]) : 0;
      hit[s] = lo[s] < hi[s] && q[s] + static_cast<long long>(v[s]) >= t[s];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const unsigned m = __ballot_sync(0xffffffffu, hit[s]);
      if (lo[s] >= hi[s]) continue;           // uniform across the warp
      if (m == 0) {
        lo[s] = hi[s];
      } else {
        const int j = __ffs(m) - 1;
        at_hi[s] = __shfl_sync(0xffffffffu, v[s], j);
        hi[s] = min(lo[s] + (j + 1) * step[s] - 1, hi[s] - 1);
        lo[s] += j * step[s];
      }
    }
  }
  return {lo[0], lo[1], at_hi[0], at_hi[1]};
}

// Gather entry c (-1: padding) for this lane's features: kN float4 at
// f0 + 128 q + 4 lane (kVec), or kN floats at f0 + 32 q + lane.
template <bool kVec, int kN>
__device__ __forceinline__ void gather(float* p, const float* xc, int c,
                                       long long x_row, int f0, int lane,
                                       int d) {
  const float* xr = xc + static_cast<long long>(c) * x_row;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const int f = f0 + 128 * q + 4 * lane;
      const float4 v = ld4(c >= 0 && f < d ? xr + f : kZeros + 4 * lane);
      p[4 * q] = v.x;
      p[4 * q + 1] = v.y;
      p[4 * q + 2] = v.z;
      p[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const int f = f0 + 32 * q + lane;
      p[q] = ld1(c >= 0 && f < d ? xr + f : kZeros + lane);
    }
  }
}

template <bool kVec, int kN>
__global__ void __launch_bounds__(32 * kWarps)
spmm_coo_kernel(const int* __restrict__ perm, const int* __restrict__ ptr,
                const int* __restrict__ cols,
                const float* __restrict__ vals,
                const float* __restrict__ x, float* __restrict__ out, int P,
                int n_out, int n_ent, int n_src, int d, long long x_core,
                long long x_row, long long out_core, long long out_row,
                int warps_per_core) {
  constexpr int W = kVec ? 4 * kN : kN;           // floats per lane per row
  constexpr int R = kRing / W < kChunk ? kRing / W : kChunk;  // ring rows
  static_assert(kChunk % R == 0, "a chunk holds whole rings");
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  if (gw >= static_cast<long long>(P) * warps_per_core) return;
  const int core = static_cast<int>(gw / warps_per_core);
  const long long lo = (gw - static_cast<long long>(core) * warps_per_core) *
                       kBudget;
  const int* cptr = ptr + static_cast<size_t>(core) * (n_out + 1);
  // A warp past its core's rows and entries finds r0 = r1 = n_out in one
  // round; one inside a row begun by an earlier warp finds r0 = r1.
  const Run run = find_run(cptr, n_out, lo, lo + kBudget, lane);
  const int r0 = run.r0, r1 = run.r1, e0 = run.e0, e1 = run.e1;
  if (r0 >= r1) return;
  const size_t base = static_cast<size_t>(core) * n_ent;
  const int* cperm = perm + base;
  const int* ccols = cols + base;
  const float* cvals = vals + base;
  const float* xc = x + core * x_core;
  float* orows = out + core * out_core;
  const int f0 = blockIdx.y * kTile;

  // Row ends: lane i holds ptr[rb + 1 + i], the end of row rb + i; the
  // next 32 rows' ends are loaded one window ahead.
  auto load_ends = [&](int b) { return ldi(cptr + min(b + 1 + lane, r1)); };
  int rb = r0;
  int ends = load_ends(rb);
  int ends_nxt = load_ends(rb + 32);
  int r = r0;
  int row_end = __shfl_sync(0xffffffffu, ends, 0);
  float acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;

  // Write row r (its sum, or +0.0 for an empty row) and move to row r + 1.
  auto write_row = [&]() {
    float* orow = orows + static_cast<long long>(r) * out_row;
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        const int f = f0 + 128 * q + 4 * lane;
        if (f < d)
          *reinterpret_cast<float4*>(orow + f) = make_float4(
              acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        const int f = f0 + 32 * q + lane;
        if (f < d) orow[f] = acc[q];
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = 0.f;
    ++r;
    if (r - rb == 32) {
      rb = r;
      ends = ends_nxt;
      ends_nxt = load_ends(rb + 32);
    }
    row_end = __shfl_sync(0xffffffffu, ends, r - rb);
  };
  // Every row of the run that ends at entry position pos.
  auto flush = [&](int pos) {
    while (r < r1 && row_end == pos) write_row();
  };

  const int last = e1 - 1;
  auto load_perm = [&](int kb) { return ldi(cperm + min(kb + lane, last)); };
  int p0 = 0, p1 = 0, p2 = 0;
  if (e0 < e1) {                 // in flight with the row ends, before flush
    p0 = load_perm(e0);
    p1 = load_perm(e0 + kChunk);
    p2 = load_perm(e0 + 2 * kChunk);
  }
  flush(e0);                                  // leading empty rows
  if (e0 < e1) {
    // Padding (a column outside [0, n_src)) and lanes past the run gather
    // zeros with weight -0.0.
    auto mark = [&](int kb, int& c, float& v) {
      if (kb + lane > last ||
          static_cast<unsigned>(c) >= static_cast<unsigned>(n_src)) {
        c = -1;
        v = -0.0f;
      }
    };
    int c_cur = ldi(ccols + p0);
    float v_cur = ld1(cvals + p0);
    int c_nxt = ldi(ccols + p1);
    float v_nxt = ld1(cvals + p1);
    mark(e0, c_cur, v_cur);
    mark(e0 + kChunk, c_nxt, v_nxt);
    float buf[R][W];
#pragma unroll
    for (int j = 0; j < R; ++j)
      gather<kVec, kN>(buf[j], xc, __shfl_sync(0xffffffffu, c_cur, j),
                       x_row, f0, lane, d);
    for (int kb = e0; kb <= last; kb += kChunk) {
      int c_nn = ldi(ccols + p2);             // chunk + 2
      float v_nn = ld1(cvals + p2);
      p2 = load_perm(kb + 3 * kChunk);        // chunk + 3
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (kb + j > last) break;
        const float w = __shfl_sync(0xffffffffu, v_cur, j);
#pragma unroll
        for (int i = 0; i < W; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(buf[j % R][i], w));
        const int cn = j + R < kChunk
                           ? __shfl_sync(0xffffffffu, c_cur, j + R)
                           : __shfl_sync(0xffffffffu, c_nxt, j + R - kChunk);
        gather<kVec, kN>(buf[j % R], xc, cn, x_row, f0, lane, d);
        if (kb + j + 1 == row_end) flush(kb + j + 1);
      }
      mark(kb + 2 * kChunk, c_nn, v_nn);
      c_cur = c_nxt;
      v_cur = v_nxt;
      c_nxt = c_nn;
      v_nxt = v_nn;
    }
  }
}

template <bool kVec, int kN>
void launch_kernel(dim3 grid, cudaStream_t stream, const void* perm,
                   const void* ptr, const void* cols, const void* vals,
                   const void* x, void* out, int P, int n_out, int n_ent,
                   int n_src, int d, long long x_core, long long x_row,
                   long long out_core, long long out_row,
                   int warps_per_core) {
  spmm_coo_kernel<kVec, kN><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const int*>(perm), static_cast<const int*>(ptr),
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(out), P, n_out,
      n_ent, n_src, d, x_core, x_row, out_core, out_row, warps_per_core);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  if (P <= 0 || n_out <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  if (n_ent < 0 || n_ent > INT_MAX - 4 * kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long wpc =
      (static_cast<long long>(n_out) + n_ent + kBudget - 1) / kBudget;
  const long long blocks = (wpc * P + kWarps - 1) / kWarps;
  if (wpc > INT_MAX || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), (d + kTile - 1) / kTile);
  const auto s = static_cast<cudaStream_t>(stream);
  // float4 loads and stores need every lane's features 16-byte aligned
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(out) &&
                   x_row % 4 == 0 && out_row % 4 == 0 &&
                   (P == 1 || (x_core % 4 == 0 && out_core % 4 == 0));
  const int width = d < kTile ? d : kTile;
  const int w = static_cast<int>(wpc);
#define SPMM_COO_LAUNCH(V, N)                                              \
  launch_kernel<V, N>(grid, s, perm, ptr, cols, vals, x, out, P, n_out,    \
                      n_ent, n_src, d, x_core, x_row, out_core, out_row, w)
  if (vec) {
    if (width <= 128) SPMM_COO_LAUNCH(true, 1);
    else SPMM_COO_LAUNCH(true, 2);
  } else if (width <= 32) {
    SPMM_COO_LAUNCH(false, 1);
  } else if (width <= 64) {
    SPMM_COO_LAUNCH(false, 2);
  } else if (width <= 128) {
    SPMM_COO_LAUNCH(false, 4);
  } else {
    SPMM_COO_LAUNCH(false, 8);
  }
#undef SPMM_COO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
