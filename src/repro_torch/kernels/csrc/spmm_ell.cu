// spmm_ell — pre-reduced ELL gather-accumulate for NVIDIA Hopper (sm_90a),
// one launch per walk over every degree bucket of a plan.
//
// Replaces: the Pallas kernel repro/kernels/spmm.py::spmm_ell (body
// _spmm_ell_kernel), its transpose walk repro/kernels/spmm.py::spmm_ell_t
// (the same pallas_call over the plan's column-major t_* tables), and their
// XLA twin repro/kernels/ops.py::_ell_walk.  Computes, for every bucket of
// an EllTables plan,
//     y[r, :] = sum_{k=0}^{K-1} vals[r, k] * x[cols[r, k], :]
// with cols [nb, K] int32, vals [nb, K] fp32, x [n_src, d] fp32, y [nb, d];
// the transpose walk is the same sum with the t_* tables and the error rows
// as x.  A column outside [0, n_src) is padding (the plan pads with n_src):
// it adds nothing and gathers from x nothing; the reference appends a zero
// row to x instead.
//
// Stacked cores.  The distributed path stacks every sender core's bucket
// shape-aligned: cols/vals [P, nb, K], x [P, n_src, d], y [P, nb, d].  Core
// p reads x + p * x_core and writes out + p * out_core; x_core may be 0
// (every core reads one shared x: the backward's all-gathered error rows),
// and rows may be strided (a feature wave of x, a slice of the walk's
// output buffer).  The last axis is unit-stride.
//
// What bounds it on this card.  Bytes in theory: each real entry moves one
// row of x (d * 4 bytes) for 2 * d flops.  In practice, gathers in flight:
// the rows come from random places (from L2 for the served walk's 16 MB x),
// so the rate is the loads in flight over their latency.  Two limits shape
// the design: a warp keeps only a few dozen loads in flight, and cp.async's
// 16-byte copies (and bulk copies of one row slice each) fed a gather more
// slowly on the H100 than plain loads staged through registers.  And a
// row's K adds are a dependent chain in a fixed order (below), so a hub
// row (K in the thousands) cannot be split over K: its time is its K
// gathers at the in-flight rate of the threads that walk it.  The old design (a warp per row, a launch per bucket, 8 loads in
// flight) left a K = 2048 bucket of 7 rows on 14 warps and paid one host
// call per bucket.
//
// Design.
// * One launch per walk.  A descriptor built once per table set (host side,
//   copied to the card with the tables) holds one record per bucket (table
//   pointers, nb, K, core stride, first output row) and a work list of
//   (bucket, first row) items, each one row when K >= 256 ("long") and
//   256 / K whole rows otherwise ("short"), longest K first, so hub rows
//   start before the short ones fill the card behind them.
// * Long items: a 64-thread block per (row, core, 64-feature slice).  It
//   stages the row's (col, val) pairs in shared memory 1024 at a time, with
//   a bitmask of the real entries per 32, then runs stages of 32 entries:
//   every thread loads 8 float4 of a stage into registers two stages ahead
//   (both warps gather, 64 entries in flight), stores them into a
//   double-buffered shared slot, and adds its own feature of the stage.
// * Short items: a warp per (item, core, 128-feature slice), 4 features
//   per lane (a float4).  Lanes hold one (col, val) of a 32-entry chunk and
//   broadcast them by shuffles; the next chunk's 32 rows are gathered into
//   registers while this chunk's are added; columns are loaded two chunks
//   ahead.
// * Loads are unconditional volatile loads, so the compiler keeps them
//   ahead of their use: padding and features past d read a block of zeros.
// * Each thread adds its features' products in ascending k, every product
//   and every sum rounded on its own (__fmul_rn/__fadd_rn, no FMA
//   contraction), starting from the first real product: the accumulator
//   starts at -0.0, the identity of addition, a padding entry adds
//   0 * -0.0 = -0.0, and a row with no real entry writes +0.0.  No atomics,
//   no split over K: a row's value depends only on its own entries, never
//   on which rows, buckets or cores share the launch.  That keeps the plain
//   PyTorch version (the same order) bit-equal and the serving path's
//   incremental logits equal to a cold recompute.
// Ragged widths (d = 41 on the logits layer, or rows not 16-byte aligned)
// take scalar loads, each thread or lane on features spaced 32 apart;
// empty buckets have no items and a walk with no items makes no launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;        // threads per block: 2 warps
constexpr int kItemEntries = 256;   // an item walks >= this many, or a row
// long rows: a block per (row, 64-feature slice), one thread per feature
constexpr int kLongFeat = kThreads;
constexpr int kStage = 32;          // entries per stage
constexpr int kAhead = 2;           // stages in flight in registers
constexpr int kSeg = 1024;          // (col, val) pairs staged at once
// short rows: a warp per (item, 128-feature slice), 4 features per lane
constexpr int kShortFeat = 128;
constexpr int kChunk = 32;          // entries in flight per warp

// One bucket of the walk, as the descriptor stores it (40 bytes; the
// Python side packs the same layout).
struct Bucket {
  const int* cols;
  const float* vals;
  long long tab_core;   // elements between two cores' tables (nb * K)
  int nb;
  int K;
  int out_base;         // the bucket's first row in the output
  int rows;             // rows per work item
};

__host__ __device__ inline int rows_per_item(int K) {
  return K >= kItemEntries ? 1 : kItemEntries / (K > 0 ? K : 1);
}

// What one block or warp walks: bucket rows [row0, row1) of one core's
// tables, features [f0, f0 + width) of x and out.
struct Unit {
  const int* cols;
  const float* vals;
  const float* xc;      // this core's x
  float* orow;          // this core's row 0 of the bucket in out
  int row0, row1, K, f0;
};

// Zeros that padding entries and features past d load instead of x.
__device__ __align__(16) float kZeros[kShortFeat];

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

// ---------------------------------------------------------------------------
// Long rows.
// ---------------------------------------------------------------------------
struct LongSmem {
  float ring[2][kStage][kLongFeat];
  int scol[kSeg];
  alignas(16) float sval[kSeg];    // -0.0 for padding
  unsigned smask[kSeg / kStage];   // bit j: entry j of the stage is real
};

// This thread's share of stage s (segment-local entries s*kStage ...) in
// registers: real entries' x-row slices, zeros for padding, entries past
// the segment and features >= d.  kVec: 8 float4 chunks, a warp's load
// covering two entries' 64 features; otherwise the thread's own feature of
// each of the 32 entries.
template <bool kVec>
struct Stage {
  static constexpr int N = kVec ? kStage * kLongFeat / 4 / kThreads : kStage;
  float4 v4[kVec ? N : 1];
  float v1[kVec ? 1 : N];

  __device__ __forceinline__ void load(const LongSmem& sm, int s,
                                       const Unit& u, long long x_row,
                                       int d) {
    const int t = threadIdx.x;
    const unsigned m = sm.smask[s];
    if (kVec) {
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int idx = t + q * kThreads;
        const int j = idx / (kLongFeat / 4);
        const int c = 4 * (idx % (kLongFeat / 4));
        const bool real = ((m >> j) & 1u) && u.f0 + c < d;
        v4[q] = ld4(real ? u.xc + sm.scol[s * kStage + j] * x_row + u.f0 + c
                         : kZeros + c);
      }
    } else {
      const int f = u.f0 + t;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const bool real = ((m >> j) & 1u) && f < d;
        v1[j] = ld1(real ? u.xc + sm.scol[s * kStage + j] * x_row + f
                         : kZeros + t);
      }
    }
  }

  __device__ __forceinline__ void store(float (*slot)[kLongFeat]) const {
    const int t = threadIdx.x;
    if (kVec) {
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int idx = t + q * kThreads;
        *reinterpret_cast<float4*>(
            &slot[idx / (kLongFeat / 4)][4 * (idx % (kLongFeat / 4))]) = v4[q];
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) slot[j][t] = v1[j];
    }
  }
};

// One long row (K >= kItemEntries): the block gathers, every thread adds
// its own feature.
template <bool kVec>
__device__ __forceinline__ void walk_long(LongSmem& sm, const Unit& u,
                                          int n_src, int d,
                                          long long x_row,
                                          long long out_row) {
  const int t = threadIdx.x;
  const int f = u.f0 + t;
  const long long e0 = static_cast<long long>(u.row0) * u.K;
  const long long e1 = static_cast<long long>(u.row1) * u.K;
  // acc starts at -0.0, the identity of addition, and a skipped entry adds
  // -0.0 (its slot is zero, its weight -0.0): acc + -0.0 == acc for every
  // acc, so the sum is the real products' sum in ascending k, bit for bit.
  float acc = -0.0f;
  bool started = false;                       // row r has a real entry
  int r = u.row0;
  long long row_end = e0 + u.K;               // entry index ending row r
  Stage<kVec> st[kAhead];

  for (long long s0 = e0; s0 < e1; s0 += kSeg) {
    const int n = static_cast<int>(min(static_cast<long long>(kSeg),
                                       e1 - s0));
    const int n_pad = (n + kThreads - 1) / kThreads * kThreads;
#pragma unroll 16
    for (int i = t; i < n_pad; i += kThreads) {   // stage (col, val) pairs
      const bool in = i < n;
      const int c = in ? __ldg(u.cols + s0 + i) : -1;
      const float v = in ? __ldg(u.vals + s0 + i) : 0.f;
      const bool real = static_cast<unsigned>(c) <
                        static_cast<unsigned>(n_src);
      sm.scol[i] = c;
      sm.sval[i] = real ? v : -0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, real);
      if ((t & 31) == 0) sm.smask[i / kStage] = m;   // a warp: a stage
    }
    __syncthreads();
    const int n_st = (n + kStage - 1) / kStage;
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i < n_st) st[i].load(sm, i, u, x_row, d);
    for (int s_base = 0; s_base < n_st; s_base += kAhead) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int s = s_base + i;
        if (s >= n_st) break;
        float(*slot)[kLongFeat] = sm.ring[s & 1];   // read two stages ago
        st[i].store(slot);
        if (s + kAhead < n_st) st[i].load(sm, s + kAhead, u, x_row, d);
        __syncthreads();                      // the stage is in the slot
        const float* sv = sm.sval + s * kStage;
        const unsigned m = sm.smask[s];
        const long long left = row_end - (s0 + s * kStage);
        if (left > kStage) {                  // the stage lies inside row r
#pragma unroll
          for (int j = 0; j < kStage; j += 4) {
            const float4 w = *reinterpret_cast<const float4*>(sv + j);
            acc = __fadd_rn(acc, __fmul_rn(slot[j][t], w.x));
            acc = __fadd_rn(acc, __fmul_rn(slot[j + 1][t], w.y));
            acc = __fadd_rn(acc, __fmul_rn(slot[j + 2][t], w.z));
            acc = __fadd_rn(acc, __fmul_rn(slot[j + 3][t], w.w));
          }
          started |= m != 0;
        } else {                              // row r ends here
          const int end = static_cast<int>(left);
#pragma unroll
          for (int j = 0; j < kStage; ++j)
            if (j < end) acc = __fadd_rn(acc, __fmul_rn(slot[j][t], sv[j]));
          started |= (m << (32 - end)) != 0;  // bits 0 .. end-1
          if (f < d) u.orow[r * out_row + f] = started ? acc : 0.f;
          ++r;
          row_end += u.K;
        }
      }
    }
    __syncthreads();              // scol, sval, smask and the ring are free
  }
}

// ---------------------------------------------------------------------------
// Short rows.
// ---------------------------------------------------------------------------
// Lane-owned features: 4 consecutive ones (kVec) or 4 spaced 32 apart.
template <bool kVec>
__device__ __forceinline__ int feat(int f0, int lane, int q) {
  return kVec ? f0 + 4 * lane + q : f0 + lane + 32 * q;
}

// Gather entry c (-1: padding) for this lane's features.
template <bool kVec>
__device__ __forceinline__ float4 gather(const float* xc, int c,
                                         long long x_row, int f0, int lane,
                                         int d) {
  const float* xr = xc + c * x_row;
  if (kVec) {
    const int f = f0 + 4 * lane;
    return ld4(c >= 0 && f < d ? xr + f : kZeros + 4 * lane);
  }
  const int f = f0 + lane;
  const float* z = kZeros + lane;
  return make_float4(ld1(c >= 0 && f < d ? xr + f : z),
                     ld1(c >= 0 && f + 32 < d ? xr + f + 32 : z),
                     ld1(c >= 0 && f + 64 < d ? xr + f + 64 : z),
                     ld1(c >= 0 && f + 96 < d ? xr + f + 96 : z));
}

// The rows of one short item (K < kItemEntries): the warp walks them in
// chunks of 32 entries, one (col, val) per lane broadcast by shuffles, the
// next chunk's rows gathered while this chunk's are added.
template <bool kVec>
__device__ __forceinline__ void walk_short(const Unit& u, int n_src, int d,
                                           long long x_row,
                                           long long out_row) {
  const int lane = threadIdx.x & 31;
  const int K = u.K;
  const long long e0 = static_cast<long long>(u.row0) * K;
  const long long e1 = static_cast<long long>(u.row1) * K;
  // A lane holds one entry of a chunk: its column and weight.  `mark`,
  // a chunk after the load, sets padding (a column outside [0, n_src), or
  // past the item) to column -1 and weight -0.0.
  auto load_chunk = [&](long long k0, int& c, float& v) {
    const long long k = k0 + lane;
    c = k < e1 ? __ldg(u.cols + k) : -1;
    v = k < e1 ? __ldg(u.vals + k) : 0.f;
  };
  auto mark = [&](int& c, float& v) {
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(n_src)) {
      c = -1;
      v = -0.0f;
    }
  };
  float acc[4] = {-0.0f, -0.0f, -0.0f, -0.0f};   // as in walk_long
  bool started = false;
  int r = u.row0;
  auto write_row = [&]() {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = feat<kVec>(u.f0, lane, q);
      if (f < d) u.orow[r * out_row + f] = started ? acc[q] : 0.f;
      acc[q] = -0.0f;
    }
    started = false;
    ++r;
  };
  if (K == 0) {                               // no entries: rows of zeros
    while (r < u.row1) write_row();
    return;
  }
  int c_cur, c_nxt, c_nn;
  float v_cur, v_nxt, v_nn;
  load_chunk(e0, c_cur, v_cur);
  load_chunk(e0 + kChunk, c_nxt, v_nxt);
  mark(c_cur, v_cur);
  mark(c_nxt, v_nxt);
  float4 buf[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    buf[j] = gather<kVec>(u.xc, __shfl_sync(0xffffffffu, c_cur, j), x_row,
                          u.f0, lane, d);
  long long row_end = e0 + K;                 // entry index ending row r
  for (long long k0 = e0; k0 < e1; k0 += kChunk) {
    load_chunk(k0 + 2 * kChunk, c_nn, v_nn);
    const unsigned m = __ballot_sync(0xffffffffu, c_cur >= 0);
    int end = static_cast<int>(min(row_end - k0,
                                   static_cast<long long>(2 * kChunk)));
    int start = 0;                            // row r's first entry here
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float w = __shfl_sync(0xffffffffu, v_cur, j);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(buf[j].x, w));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(buf[j].y, w));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(buf[j].z, w));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(buf[j].w, w));
      buf[j] = gather<kVec>(u.xc, __shfl_sync(0xffffffffu, c_nxt, j), x_row,
                            u.f0, lane, d);
      if (j + 1 == end) {                     // row r is complete
        started |= ((m << (31 - j)) >> (31 - j + start)) != 0;
        write_row();
        row_end += K;
        end = r < u.row1 ? end + K : 2 * kChunk;
        start = j + 1;
      }
    }
    if (start < kChunk) started |= (m >> start) != 0;
    mark(c_nn, v_nn);
    c_cur = c_nxt;
    v_cur = v_nxt;
    c_nxt = c_nn;
    v_nxt = v_nn;
  }
}

// ---------------------------------------------------------------------------
// The walk: blocks [0, n_long_blocks) take the long items, one per (item,
// core, 64-feature slice); the rest hold two warps each, one per (short
// item, core, 128-feature slice).  Items are longest first, so the long
// ones lead the list.
// ---------------------------------------------------------------------------
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ell_walk_kernel(const Bucket* __restrict__ buckets,
                const int2* __restrict__ items, Bucket one, int n_long,
                int n_short_units, int P, int n_src, int d,
                const float* __restrict__ x, float* __restrict__ out,
                long long x_core, long long x_row, long long out_core,
                long long out_row) {
  __shared__ __align__(16) LongSmem sm;
  const int nfs_long = (d + kLongFeat - 1) / kLongFeat;
  const int nfs_short = (d + kShortFeat - 1) / kShortFeat;
  const int n_long_blocks = n_long * P * nfs_long;
  const bool is_long = static_cast<int>(blockIdx.x) < n_long_blocks;
  int item, rest, nfs, width;
  if (is_long) {
    item = blockIdx.x / (P * nfs_long);
    rest = blockIdx.x - item * (P * nfs_long);
    nfs = nfs_long;
    width = kLongFeat;
  } else {
    const int unit = (blockIdx.x - n_long_blocks) * 2 + (threadIdx.x >> 5);
    if (unit >= n_short_units) return;        // whole warps only
    item = n_long + unit / (P * nfs_short);
    rest = unit - (item - n_long) * (P * nfs_short);
    nfs = nfs_short;
    width = kShortFeat;
  }
  const int core = rest / nfs;
  Bucket bk;
  int row0;
  if (items != nullptr) {
    const int2 it = items[item];
    bk = buckets[it.x];
    row0 = it.y;
  } else {
    bk = one;
    row0 = item * one.rows;
  }
  Unit u;
  u.cols = bk.cols + core * bk.tab_core;
  u.vals = bk.vals + core * bk.tab_core;
  u.xc = x + core * x_core;
  u.orow = out + core * out_core + bk.out_base * out_row;
  u.row0 = row0;
  u.row1 = min(row0 + bk.rows, bk.nb);
  u.K = bk.K;
  u.f0 = (rest - core * nfs) * width;
  if (is_long)
    walk_long<kVec>(sm, u, n_src, d, x_row, out_row);
  else
    walk_short<kVec>(u, n_src, d, x_row, out_row);
}

int launch(const Bucket* buckets, const int2* items, const Bucket& one,
           int n_items, int n_long, int P, const void* x, void* out,
           int n_src, int d, long long x_core, long long x_row,
           long long out_core, long long out_row, void* stream) {
  if (n_items <= 0 || P <= 0 || d <= 0)
    return static_cast<int>(cudaGetLastError());
  const long long long_blocks = static_cast<long long>(n_long) * P *
                                ((d + kLongFeat - 1) / kLongFeat);
  const long long short_units = static_cast<long long>(n_items - n_long) *
                                P * ((d + kShortFeat - 1) / kShortFeat);
  const long long blocks = long_blocks + (short_units + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // float4 gathers need every thread's chunks 16-byte aligned
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && d % 4 == 0 &&
                   x_row % 4 == 0 && (P == 1 || x_core % 4 == 0);
  auto* kernel = vec ? ell_walk_kernel<true> : ell_walk_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      buckets, items, one, n_long, static_cast<int>(short_units), P, n_src,
      d, static_cast<const float*>(x), static_cast<float*>(out), x_core,
      x_row, out_core, out_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A whole walk in one launch.  `desc` (device memory) holds n_buckets
// Bucket records followed by n_items (bucket, first row) int32 pairs, the
// n_long items of buckets with K >= 256 first.
extern "C" int spmm_ell_walk_launch(const void* desc, int n_buckets,
                                    int n_items, int n_long, int P,
                                    const void* x, void* out, int n_src,
                                    int d, long long x_core, long long x_row,
                                    long long out_core, long long out_row,
                                    void* stream) {
  const auto* buckets = static_cast<const Bucket*>(desc);
  const auto* items = reinterpret_cast<const int2*>(buckets + n_buckets);
  return launch(buckets, items, Bucket{}, n_items, n_long, P, x, out, n_src,
                d, x_core, x_row, out_core, out_row, stream);
}

// One bucket (P stacked cores; P = 1 for a 2-D bucket): cols/vals
// [P, nb, K] contiguous; x and out addressed through the given core and
// row strides (in elements).
extern "C" int spmm_ell_launch(const void* cols, const void* vals,
                               const void* x, void* out, int P, int nb,
                               int K, int n_src, int d, long long x_core,
                               long long x_row, long long out_core,
                               long long out_row, void* stream) {
  const Bucket one{static_cast<const int*>(cols),
                   static_cast<const float*>(vals),
                   static_cast<long long>(nb) * K, nb, K, 0,
                   rows_per_item(K)};
  const int n_items = nb > 0 ? (nb + one.rows - 1) / one.rows : 0;
  return launch(nullptr, nullptr, one, n_items,
                K >= kItemEntries ? n_items : 0, P, x, out, n_src, d, x_core,
                x_row, out_core, out_row, stream);
}

// The descriptor's record size, so the Python side can check its packing.
extern "C" int spmm_ell_bucket_bytes() {
  return static_cast<int>(sizeof(Bucket));
}
