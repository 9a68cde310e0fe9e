// flash_mha — causal or full softmax attention with an online softmax and an
// optional sliding window, for NVIDIA Hopper (sm_90a), on the tensor cores.
//
// Replaces: src/repro/kernels/flash.py:81 (flash_mha, body _flash_kernel at
// :36), and the sliding window of the reference's XLA flash_attend
// (src/repro/models/transformer.py:122-158, mask i - j < w_eff).
// o = softmax(q kᵀ / √hd) v over q [bh, sq, hd], k/v [bh, sk, hd]
// (heads flattened into the leading dimension; the GQA repeat is the
// caller's), f32 or bf16 inputs, f32 logits and accumulator, p rounded to
// v's type before p @ v, the output in q's type.  The causal mask is
// j <= i counted from 0 on both axes (no sk - sq offset), as in the TPU
// kernel.  A window w > 0 also masks i - j >= w (rows counted the same
// way), with or without the causal mask.  In the port it is the prefill
// attention of every LM family once the KV length passes FLASH_THRESHOLD
// (models/transformer.py), gemma3's sliding layers with the window.
//
// What bounds it on this card: the tensor cores.  A causal call does
// 4 · bh · hd · s(s+1)/2 flops (a multiply-add in q kᵀ and one in p v for
// each live (i, j) pair); the bytes (q, k, v read once, o written once)
// are ~2% of the flop time at s = 16384.
// - f32: one TF32 product keeps 11 significant bits of q and k, which is
//   ~1e-4 off on attention and fails the port's 1e-5 gate.  So each f32
//   operand is split, a = hi + lo with hi = tf32(a) and lo = tf32(a - hi),
//   both rounded as cvt.rna.tf32.f32 rounds, and every product is
//   lo·hi' + hi·lo' + hi·hi' (lo·lo', ~2^-22 relative, is dropped): three
//   TF32 mma per f32 one, so the bound is 3 × the flops at the dense TF32
//   rate (495 TFLOP/s on H100 SXM), 0.41× that of plain f32 on the FMA
//   units (67 TFLOP/s).  mma.sync does not reach that rate (wgmma does):
//   the count of TF32 mma sets most of this kernel's time, the split
//   arithmetic the rest.
// - bf16: one bf16 mma per product at the dense bf16 rate (989 TFLOP/s);
//   there the softmax's exp2 (one per live pair, on the 16-a-clock
//   special-function unit) and its ~5 other instructions per pair cost
//   about as much issue time as the mma.
// The tensor cores add each mma into its accumulator rounding toward zero
// (up to an ulp of the running sum, always of one sign).  Over a long key
// sweep that alone put the output several times further from a float64
// attention than plain f32 is, so no long sum takes tensor-core adds: each
// k step of s, and each key tile of p v, sums its three products in a
// fresh fragment, and those join s and the output accumulator in
// round-to-nearest f32 adds.
//
// Design (FA2-style).  One 256-thread CTA (8 warps) per (bh, 128-row query
// tile); the grid lists the last (most expensive, causal) query tiles first
// so the tail of the launch is the cheap tiles.  Warp w owns query rows
// 16w..16w+15 of the tile for the whole key sweep: its score tile (16 × 64
// keys) and its output accumulator (16 × hd) live in mma.sync C fragments,
// and its row max m and row sum l stay in registers (row max reduced over
// the 4 lanes that share a row with shuffles, l reduced once at the end).
//   f32:  mma.sync m16n8k8 tf32 (f32 accumulate), three per split pair.
//         Q (staged once), K and V stay f32 in shared memory and are split
//         at fragment load; so the kernel fits 128 registers a thread and,
//         up to hd = 64, 2 CTAs (16 warps) an SM.  The k order of both
//         products is permuted to suit the fragments: in q kᵀ slot t / t+4
//         of an 8-wide k step is dim 2t / 2t+1 (one 8-byte load per pair),
//         and in p v slot t / t+4 is key 2t / 2t+1, so the C fragment of s
//         is the A fragment of p as it stands, with no shuffle or shared
//         memory.
//   bf16: mma.sync m16n8k16 bf16 (f32 accumulate); Q fragments in
//         registers, K fragments by ldmatrix, V fragments by ldmatrix.trans;
//         the C fragment of s, rounded to bf16 pairs, is the A fragment of p.
// K and V tiles of 64 keys move through a cp.async ring (f32 2 stages,
// bf16 3), so the next tile loads while this one computes; one
// __syncthreads per key tile.  Row strides are padded so that every
// fragment load is free of bank conflicts.  exp is ex2.approx (exp2), with
// log2 e folded into the logit scale: p = 2^(s·scale·log2 e - m) in one
// fma, m kept in the log2 domain.  Causal: key tiles strictly above the
// query tile's last row are never loaded, a warp skips a tile above its own
// last row, and only tiles that cross the diagonal (or the ragged end of
// sk) evaluate the mask.  The first key tile holds key 0, which every row
// may attend, so m is finite after it and 2^(finfo.min - m) is 0, never
// NaN.  Masked logits are -FLT_MAX (finfo.min).
// Window w: a CTA's sweep starts at the key tile holding its first row's
// first live key, (q0 - w + 1) / BK, so the tiles wholly below the band
// are never loaded; a warp skips a tile below its own first row's band,
// and tiles that cross the band's lower edge evaluate the mask too.  There
// a row can have no live key in a tile the warp computes (w smaller than a
// tile, the first rows of a band), so with a window every masked logit is
// -inf instead: its p is exactly 0, so such a row's l and acc stay 0
// until its first live key, whose tile scales them by ex2(m_old - m) = 0.
// Masking with -inf changes no bit where a row's tile holds a live key (p
// was 0 already), so a window covering every key gives the causal call's
// bits.  (A row left with no live key at all, which needs sq > sk or no
// causal mask, comes out 0; the reference averages v there.)  The CUDA
// tiles (128 × 64) are this kernel's own; the API's q_block / k_block are
// only the reference's divisibility contract, and ragged sq / sk are
// masked here (rows past sq or sk load as zeros).  Shared memory
// (dynamic, opted in with cudaFuncSetAttribute): f32 106 KB at hd = 64,
// 202 KB at hd = 128; bf16 54 KB at hd = 64, 102 KB at hd = 128.
// With a non-null lse the kernel also writes each row's log-sum-exp in
// the log2 domain it keeps m and l in, lse = m + log2(l) (-inf for a row
// with no live key), for flash_mha_bwd.cu; o is the same bits either way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;        // query rows per CTA, 16 per warp
constexpr int BK = 64;                 // keys per tile
constexpr float kNeg = -FLT_MAX;       // finfo(float32).min, the reference's
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct Cfg {
  static constexpr bool f32 = std::is_same<T, float>::value;
  static constexpr int stages = f32 ? 2 : 3;
  static constexpr int min_blocks = HD <= 64 ? 2 : 1;   // CTAs an SM
  // row strides in elements: f32 K and Q rows ≡ 8 words mod 32 (8-byte
  // loads of a quad's row), f32 V rows ≡ 4 mod 16 (rows 2t, 2t+1); bf16
  // rows of (hd + 8) halves, 16-byte aligned for ldmatrix
  static constexpr int k_stride = HD + 8;
  static constexpr int v_stride = f32 ? HD + 4 : HD + 8;
  static constexpr int q_stride = HD + 8;
  static constexpr size_t k_tile = sizeof(T) * BK * k_stride;
  static constexpr size_t v_tile = sizeof(T) * BK * v_stride;
  static constexpr size_t q_bytes = f32 ? sizeof(float) * BQ * q_stride : 0;
  static constexpr size_t smem = q_bytes + stages * (k_tile + v_tile);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in (src must stay valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (the low 13 bits cleared), to nearest with ties away
// from zero: for finite x the bits that cvt.rna.tf32.f32 gives, in two
// integer ops (the cvt lowers to a longer sequence that also screens NaN);
// a magnitude past the largest TF32 rounds to inf, as the cvt does
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32; a - hi is exact in f32
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// two f32 -> one bf16x2 register, x in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment coordinates (lane = 4g + t): an mma C fragment holds rows g and
// g + 8, columns 2t and 2t + 1 of its 16 × 8 tile, as c[0..3] = (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, (Cfg<T, HD>::min_blocks))
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int bh, int sq, int sk, int causal,
                 int window, float scale_log2) {
  using C = Cfg<T, HD>;
  constexpr int NT = BK / 8;           // 8-key column tiles of s
  constexpr int NO = HD / 8;           // 8-dim column tiles of o
  constexpr int QK = C::f32 ? HD / 8 : HD / 16;   // k steps of q kᵀ
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [BQ][q_stride], f32

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nq = (sq + BQ - 1) / BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh);
  const int b = static_cast<int>(blockIdx.x % bh);
  const int q0 = qt * BQ;
  const int w0 = q0 + 16 * warp;       // the warp's first row
  const int w_last = min(w0 + 15, sq - 1);   // < w0: the warp has no rows
  const T* qb = q + static_cast<size_t>(b) * sq * HD;
  const T* kb = k + static_cast<size_t>(b) * sk * HD;
  const T* vb = v + static_cast<size_t>(b) * sk * HD;

  const int q_last = min(q0 + BQ, sq) - 1;
  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, q_last / BK + 1);
  // window: the first key tile holding a live key of the CTA's first row
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const float masked = window > 0 ? -CUDART_INF_F : kNeg;

  unsigned char* const ring = smem + C::q_bytes;  // stage: K tile, V tile
  auto k_tile = [=](int st) {
    return reinterpret_cast<T*>(ring + st * (C::k_tile + C::v_tile));
  };
  auto v_tile = [=](int st) {
    return reinterpret_cast<T*>(ring + st * (C::k_tile + C::v_tile) +
                                C::k_tile);
  };
  auto load_tile = [&](int kt, int st) {
    constexpr int CH = HD * static_cast<int>(sizeof(T)) / 16;  // per row
    constexpr int PER = 16 / static_cast<int>(sizeof(T));
    T* Kd = k_tile(st);
    T* Vd = v_tile(st);
    const int k0 = kt * BK;
    for (int e = tid; e < BK * CH; e += kThreads) {
      const int r = e / CH;
      const int c = (e % CH) * PER;
      const bool in = k0 + r < sk;
      const size_t off = static_cast<size_t>(in ? k0 + r : 0) * HD + c;
      cp_async16(Kd + r * C::k_stride + c, kb + off, in);
      cp_async16(Vd + r * C::v_stride + c, vb + off, in);
    }
  };

  if constexpr (C::f32) {             // Q joins the first tile's group
    constexpr int CH = HD / 4;
    for (int e = tid; e < BQ * CH; e += kThreads) {
      const int r = e / CH;
      const int c = (e % CH) * 4;
      const bool in = q0 + r < sq;
      cp_async16(Qs + r * C::q_stride + c,
                 qb + static_cast<size_t>(in ? q0 + r : 0) * HD + c, in);
    }
  }
#pragma unroll
  for (int s = 0; s < C::stages - 1; ++s) {
    if (kt0 + s < n_kt) load_tile(kt0 + s, s);
    cp_commit();
  }

  // bf16: Q fragments in registers, k step ks covering dims 16ks..16ks+15,
  // a[0..3] = (g, 2t..), (g+8, 2t..), (g, 8+2t..), (g+8, 8+2t..) as bf16
  // pairs.  (f32 reads its Q fragments from Qs at each k step.)
  constexpr int QR = C::f32 ? 1 : QK;
  uint32_t qa[QR][4];
  if constexpr (!C::f32) {
#pragma unroll
    for (int ks = 0; ks < QK; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = w0 + g + 8 * (i & 1);
        const int d = 16 * ks + 8 * (i >> 1) + 2 * t;
        qa[ks][i] = r < sq ? *reinterpret_cast<const uint32_t*>(
                                 qb + static_cast<size_t>(r) * HD + d)
                           : 0u;
      }
    }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};             // this lane's columns; summed at the end

  for (int kt = kt0; kt < n_kt; ++kt) {
    cp_wait<C::stages - 2>();          // tile kt has landed (this thread's)
    __syncthreads();                   // ... everyone's; tile kt-1 is free
    {
      const int nx = kt + C::stages - 1;
      if (nx < n_kt) load_tile(nx, (nx - kt0) % C::stages);
      cp_commit();
    }
    const int k0 = kt * BK;
    if (w_last < w0 || (causal && k0 > w_last) ||
        (window > 0 && k0 + BK - 1 < w0 - window + 1))
      continue;                        // nothing live for the warp
    const int st = (kt - kt0) % C::stages;
    const T* Kt = k_tile(st);
    const T* Vt = v_tile(st);

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

    // s = q kᵀ
    if constexpr (C::f32) {
      // The tensor cores add each mma into C rounding toward zero: up to an
      // ulp of the running sum per mma, always of one sign.  So each k step
      // sums its three products (small ones first) in a fresh fragment c,
      // whose error is an ulp of an 8-term partial, and s takes c in a
      // round-to-nearest f32 add.
#pragma unroll
      for (int ks = 0; ks < QK; ++ks) {
        // k step ks: dims 8ks..8ks+7, slot t / t+4 = dim 2t / 2t+1
        uint32_t ah[4], al[4];
        const float* qr = Qs + (16 * warp + g) * C::q_stride + 8 * ks + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(qr);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qr + 8 * C::q_stride);
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
        const float* kr = Kt + g * C::k_stride + 8 * ks + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 x =
              *reinterpret_cast<const float2*>(kr + 8 * j * C::k_stride);
          uint32_t bh[2], bl[2];
          split(x.x, bh[0], bl[0]);
          split(x.y, bh[1], bl[1]);
          float c[4] = {};
          mma_tf32(c, al, bh);
          mma_tf32(c, ah, bl);
          mma_tf32(c, ah, bh);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += c[e];
        }
      }
    } else {
      // ldmatrix: lanes 8m..8m+7 address rows of matrix m = (column tile
      // 2jj + m/2, dims +8·(m&1)), giving b0, b1 of tile 2jj, then 2jj+1
      const T* kr = Kt + (8 * (lane >> 4) + (lane & 7)) * C::k_stride +
                    8 * ((lane >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < QK; ++ks) {
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t bb[4];
          ldsm_x4(bb, kr + 16 * jj * C::k_stride + 16 * ks);
          mma_bf16(s[2 * jj], qa[ks], bb);
          mma_bf16(s[2 * jj + 1], qa[ks], bb + 2);
        }
      }
    }

    // online softmax over this tile; m is kept in the log2 domain (the
    // logit times log2 e), p = 2^(s·scale·log2 e - m) in one fma and ex2
    const bool edge = (causal && k0 + BK - 1 > w0) || k0 + BK > sk ||
                      (window > 0 && w0 + 15 - window + 1 > k0);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int row = w0 + g + 8 * (e >> 1);
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if (col >= sk || (causal && col > row) ||
              (window > 0 && row - col >= window))
            s[j][e] = masked;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2], neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]) * scale_log2);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      neg_m[h] = -m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[j][e], scale_log2, neg_m[e >> 1]));
        l[e >> 1] += p;                // the sum takes p before rounding
        s[j][e] = p;
      }
    }
    // acc = acc · corr + p v
    if constexpr (C::f32) {
      // This tile's p v sums in fresh fragments (the small products in ts,
      // hi·hi in tb), one output column tile at a time, and joins acc in
      // one f32 fma: acc itself never takes a tensor-core add.  p's
      // fragments, hi and lo, for the whole tile: slot t = key 8j+2t,
      // slot t+4 = key 8j+2t+1, which is s's C fragment as it stands.
      uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split(s[j][0], ph[j][0], pl[j][0]);
        split(s[j][2], ph[j][1], pl[j][1]);
        split(s[j][1], ph[j][2], pl[j][2]);
        split(s[j][3], ph[j][3], pl[j][3]);
      }
      const float* vr = Vt + 2 * t * C::v_stride + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        float tb[4] = {}, ts[4] = {};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* v0 = vr + 8 * j * C::v_stride + 8 * n;
          uint32_t bh[2], bl[2];
          split(v0[0], bh[0], bl[0]);
          split(v0[C::v_stride], bh[1], bl[1]);
          mma_tf32(ts, pl[j], bh);
          mma_tf32(ts, ph[j], bl);
          mma_tf32(tb, ph[j], bh);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], corr[e >> 1], tb[e] + ts[e]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      // ldmatrix.trans: matrix m = (keys +8·(m&1), dims 8·(2nn + m/2))
      const T* vr = Vt + (8 * ((lane >> 3) & 1) + (lane & 7)) * C::v_stride +
                    8 * (lane >> 4);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nn = 0; nn < NO / 2; ++nn) {
          uint32_t bb[4];
          ldsm_x4_t(bb, vr + 16 * kk * C::v_stride + 16 * nn);
          mma_bf16(acc[2 * nn], a, bb);
          mma_bf16(acc[2 * nn + 1], a, bb + 2);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    const float den = fmaxf(sum, 1e-30f);
    const int row = w0 + g + 8 * h;
    if (row >= sq) continue;
    // the row's log-sum-exp in the log2 domain of m (flash_mha_bwd.cu
    // recomputes p = 2^(s·scale·log2 e - lse) from it); -inf for a row
    // with no live key, whose o is 0
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(b) * sq + row] =
          sum > 0.f ? m[h] + log2f(sum) : -CUDART_INF_F;
    T* dst = o + (static_cast<size_t>(b) * sq + row) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(dst + 8 * n, acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Cfg<T, HD>::smem;
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
        static_cast<const T*>(v), static_cast<T*>(o), lse, bh, sq, sk,
        causal, window, scale * kLog2e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int sq, int sk, int hd, int causal,
             int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, bh, sq, sk, causal, window,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, sq, sk, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, causal, window,
                            scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: [bh, sq, hd]; k, v: [bh, sk, hd]; all contiguous and 16-byte
// aligned, of one type (bf16 != 0: __nv_bfloat16, else float); hd in
// {16, 32, 64, 128}; window 0 for none, else the band width w >= 1; lse
// null, or f32 [bh, sq] for the rows' log-sum-exp (log2 domain).
extern "C" int flash_mha_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int sq, int sk,
                                int hd, int bf16, int causal, int window,
                                float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, bh, sq, sk, hd, causal,
                                   window, scale, s);
  return dispatch<float>(q, k, v, o, l, bh, sq, sk, hd, causal, window, scale,
                         s);
}
