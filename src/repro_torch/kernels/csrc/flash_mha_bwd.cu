// flash_mha_bwd — the gradient of flash_mha (dQ, dK, dV) for NVIDIA Hopper
// (sm_90a) on the tensor cores: causal or not, with or without a sliding
// window, sq != sk.
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
// with f32 logits, probabilities and sums, inputs and outputs f32 or bf16.
// The masks are the forward's: j <= i when causal, i - j < w with a window,
// rows counted from 0 on both axes, ragged ends masked.  A row with no live
// key (window, no causal mask or sq > sk, i >= sk - 1 + w) has lse2 = -inf
// and o = mean(v) from the forward, as the reference's flash_attend gives
// it (every logit masked to one finite floor, so each key weighs 1 / sk):
// its p is taken as 0 in the sweeps, so its dQ is 0 (never NaN) and it adds
// nothing to dK, and dead_dv_kernel gives every key's dV 1 / sk of its dO.
//
// Kernels, and no atomics (the port's reductions are fixed-order, so two
// calls give the same bits):
//   delta_kernel (f32): δ for each row on the tensor cores, as dq_kernel's
//     and dkv_kernel's dP take their products (below, at the kernel).
//   dead_dv_kernel: only where a window leaves rows with no live key.
//   dq_kernel: one CTA per (bh, tile of 64 · NC query rows).  In bf16 it
//     computes δ for its rows (written for dkv_kernel); it sweeps the key
//     tiles holding live pairs of its rows: S = Q Kᵀ, dP = dO Vᵀ, then
//     dQ += dS K.
//   dkv_kernel: one CTA per (bh, tile of 64 · NC keys).  It sweeps the
//     query tiles holding live pairs of its keys (i >= j when causal,
//     i - j < w with a window): Sᵀ = K Qᵀ, dPᵀ = V dOᵀ, then dV += Pᵀ dO
//     and dK += dSᵀ Q.
// Each recomputes S and dP, so the pair does 7 products where the bound
// counts 5.  Both launch their heavy tiles first (causal: dq_kernel's last
// query tiles, dkv_kernel's first key tiles).
//
// What bounds it on this card: operations.  10 · hd flops per live (i, j)
// pair (five products) against q, k, v, o, dO read once and dq, dk, dv
// written once (~1% of the flop time at s = 16384).  Every product is a
// warpgroup MMA (wgmma, sm_90a's only path to the full tensor-core rate):
//   f32:  each operand split a = hi + lo, both TF32 rounded as cvt.rna
//         rounds, and every product lo·hi' + hi·lo' + hi·hi' (lo·lo',
//         ~2^-22 relative, dropped): three m64nNk8 tf32 wgmma per product,
//         as flash_mha.cu does it on mma.sync.
//   bf16: one m64nNk16 bf16 wgmma per product for S, dP and dV (p is
//         rounded to bf16 as the forward rounds it); dS is split into two
//         bf16 terms, hi + lo (16 significant bits, within 2^-17 of the
//         f32 dS the plain version uses), so dQ and dK take two each.
// Roles (warp specialisation): a CTA is one producer warpgroup and NC
// consumer warpgroups (two; one past hd = 64), each consumer owning 64
// fixed rows (Q, dO in dq_kernel; K, V in dkv_kernel, staged once) and
// its accumulators in registers.  The producer's warp 0 streams the swept
// tiles (K, V; or Q, dO, lse, δ) with cp.async into a ring of shared-
// memory stages, each arrival counted on an mbarrier; in f32 the whole
// producer warpgroup then converts each landed tile into the consumers'
// TF32 operand planes (below), a second ring, so conversion overlaps the
// consumers' wgmma; in bf16 the consumers read the landed tiles as they
// are.  The consumers share every swept tile, so each is loaded and
// converted once for 128 fixed rows, and a consumer works on without
// waiting for the other.
//
// Shared-memory operands use the unswizzled core-matrix layout: a tile is
// stored chunk-major, [16-byte column chunk][row][16 bytes], so 8 rows of
// one chunk are a contiguous 128-byte core matrix; as a K-major operand
// (rows M or N, chunks along K) its descriptor has SBO = 128 and LBO = the
// chunk stride, and bf16 reads the same tile MN-major (rows along K) with
// LBO = 128, SBO = the chunk stride.  Chunk strides are padded by 64 bytes
// so the 4-row × 2-chunk cp.async groups hit distinct banks.
//   A operands: S and dP (bf16) read Q / dO (dq_kernel) or K / V
//   (dkv_kernel) from shared memory; f32 loads and splits them into
//   registers a group of k steps at a time (TF32 A from shared memory must
//   be K-major too, and hi / lo planes of the fixed rows do not fit beside
//   the rings).  p and dS (dV, dK, dQ) come from the S / dP accumulators.
//   B operands: bf16 takes the ring's tiles as they land, K-major for S and
//   dP, MN-major for the d-side products.  TF32 wgmma takes K-major B only,
//   so f32 converts each landed tile into hi and lo planes: as it lies
//   (S, dP), and transposed (dQ's K, dK's Q, dV's dO: the reduction axis,
//   keys or queries, contiguous).  The accumulator of S holds columns
//   2t, 2t+1 of each 8-column block, which the tf32 A fragment wants in k
//   slots t and t+4; the transposed planes are written with that order
//   (slot t / t+4 = row 2t / 2t+1 of the block), so the accumulator is the
//   A fragment as it stands and no register moves between lanes.  The
//   transposed planes pad their rows (8 dims a core-matrix group, 144
//   bytes apart) so the scattered 4-byte stores are conflict-free.  Past
//   hd = 64 the transposed planes take the space of the others once S
//   and dP are done (the producer hands a tile's planes over twice).
// No long sum takes tensor-core adds (which round toward zero, flash_mha.cu
// found: several times further from float64 over a long sweep): each
// swept tile's partial of dQ, dK and dV starts in a fresh accumulator and
// joins the running sum in a round-to-nearest f32 add; in f32 even S and
// dP sum each pair of k steps in a fresh fragment (qk2_f32).
// Tiles: the swept tile is 32 rows in f32 (two stages of planes fit beside
// 128 fixed rows) and 64 in bf16; past hd = 64 32 rows and one consumer
// (64 fixed rows), whose accumulators may take up to 255 registers a
// thread.  At hd = 128 its d-side products run in two halves of 64 dims so
// that one half's partial is live at a time (dK, dV and a partial take ~190
// registers a thread); at hd = 80 (stablelm-3b) one m64n80 product each.
// Where the time goes (f32): S and dP are narrow (m64n32k8) wgmma taking
// A from registers split a group at a time, and the element-wise pass
// runs between them and the d-side products; the producer's conversion
// overlaps them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWG = 128;               // threads a warpgroup
constexpr int BQ = 64;                 // fixed rows a consumer warpgroup
constexpr int kTSBO = 144;             // transposed planes: 8-dim group stride
constexpr float kLog2e = 1.4426950408889634f;

constexpr int max_of(int a, int b) { return a > b ? a : b; }

template <typename T, int HD>
struct Cfg {
  static constexpr bool f32 = std::is_same<T, float>::value;
  static constexpr int esz = static_cast<int>(sizeof(T));
  // consumer warpgroups, each BQ fixed rows (one past hd = 64, whose
  // accumulators need more than the 168 registers a thread of three
  // warpgroups can have)
  static constexpr int NC = HD > 64 ? 1 : 2;
  static constexpr int threads = kWG * (NC + 1);   // + the producer's
  static constexpr int ROWS = BQ * NC;           // fixed rows a CTA
  // rows of a swept tile: keys in dq_kernel, queries in dkv_kernel
  static constexpr int BN = f32 || HD > 64 ? 32 : 64;
  static constexpr int NH = HD == 128 ? 2 : 1;   // halves of the d-side N
  static constexpr int ND = HD / NH;             // ... their N
  // f32 past hd = 64: the transposed planes take the space of the others
  // once S and dP are done (two hand-overs a tile; two stages of both at
  // once would need 258 KB in dkv_kernel at hd = 80); else both at once
  static constexpr bool PHASED = f32 && HD > 64;
  static constexpr int H = PHASED ? 2 : 1;
  // stages of the cp.async ring and (f32) of the converted planes
  static constexpr int RSQ = 2;                                 // dq_kernel
  // dkv_kernel (f32 at hd = 64: one, for shared memory)
  static constexpr int RSKV = f32 && HD == 64 ? 1 : RSQ;
  static constexpr int PS = f32 ? (PHASED ? 1 : 2) : 0;
  static constexpr int CH = HD * esz / 16;       // 16-byte chunks a row
  // chunk strides (bytes) of the cp.async'd tiles, padded by 64
  static constexpr int fcs = ROWS * 16 + 64;     // the fixed rows
  static constexpr int rcs = BN * 16 + 64;       // a swept tile
  static constexpr int fixed = CH * fcs;         // bytes of a fixed tile
  static constexpr int raw = CH * rcs;           // ... of a swept tile
  // f32 planes: as the tile lies (chunk stride BN·16, unpadded) and
  // transposed (rows = dims in groups of 8 kTSBO apart, k chunks of 4
  // swept rows tlbo apart, tlbo ≡ 32 mod 64 for conflict-free stores)
  static constexpr int pcs = BN * 16;
  static constexpr int plane = (HD / 4) * pcs;
  static constexpr int tlbo0 = (HD / 8) * kTSBO;
  static constexpr int tlbo = tlbo0 + (96 - tlbo0 % 64) % 64;
  static constexpr int tplane = (BN / 4) * tlbo;
  static constexpr int toff = PHASED ? 0 : 4 * plane;   // transposed planes
  // a stage: dq_kernel K, V (raw) → K, V, Kᵀ hi and lo (planes);
  // dkv_kernel Q, dO, lse, δ → Q, dO, Qᵀ, dOᵀ hi and lo, lse, δ
  static constexpr int dq_raw = 2 * raw;
  static constexpr int dkv_raw = 2 * raw + 2 * BN * 4;
  static constexpr int dq_planes = f32 ? max_of(4 * plane, toff + 2 * tplane)
                                       : 0;
  static constexpr int lse_off = max_of(4 * plane, toff + 4 * tplane);
  static constexpr int dkv_planes = f32 ? lse_off + 2 * BN * 4 : 0;
  static constexpr size_t smem_dq = 2 * fixed + RSQ * dq_raw +
                                    PS * dq_planes + ROWS * 4 +
                                    2 * (RSQ + PS) * 8;
  static constexpr size_t smem_dkv = 2 * fixed + RSKV * dkv_raw +
                                     PS * dkv_planes + 2 * (RSKV + PS) * 8;
  static_assert(smem_dq <= 232448 && smem_dkv <= 232448,
                "a CTA's shared memory");
};

// ---------------------------------------------------------------------------
// primitives
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in (src must stay valid)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// the barrier's phase also waits for this thread's cp.async so far
__device__ __forceinline__ void cp_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// warpgroup `wg` alone (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWG) : "memory");
}

// generic-proxy shared-memory writes before wgmma (async proxy) reads them
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x rounded to TF32 (the low 13 bits cleared), to nearest with ties away
// from zero: the bits cvt.rna.tf32.f32 gives for finite x (flash_mha.cu's)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32; a - hi is exact in f32
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// 2^x on the special-function unit; -inf gives +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one bf16x2 register, x in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __bfloat162float(x);
}

// wgmma shared-memory matrix descriptor, no swizzle: start, LBO, SBO
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// a descriptor moved `bytes` further (the start field cannot overflow:
// shared addresses stay below 2^18)
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N committed wgmma groups still run
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (m64 × N f32, R = N / 2 registers a thread) += A B.  Accumulator
// layout, warp w of the warpgroup, lane 4g + t: d[4j + e] is row
// 16w + g + 8(e / 2), column 8j + 2t + (e % 2).  `acc` 0 overwrites D.
//   wg_tf32:    A tf32 in registers (a[0..3] = rows g, g + 8 at k slot t,
//               then at slot t + 4), B K-major in shared memory
//   wg_bf16_rs: A bf16 pairs in registers (rows g, g + 8 at k 2t, 2t + 1,
//               then at k 8 + 2t, 9 + 2t), B MN-major in shared memory
//   wg_bf16_ss: A and B K-major in shared memory
template <int N>
__device__ void wg_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                        int acc);
template <int N>
__device__ void wg_bf16_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                           uint64_t b, int acc);
template <int N>
__device__ void wg_bf16_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                           int acc);

template <>
__device__ __forceinline__ void wg_tf32<16>(float (&d)[8],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_bf16_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_tf32<32>(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_bf16_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_bf16_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_tf32<64>(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_bf16_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_bf16_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_tf32<80>(float (&d)[40],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_bf16_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------
// rows [r0, r0 + ROWS) of a row-major [n, HD] matrix into the chunk-major
// tile at dst (chunk stride CS), rows at or past n as zeros; NT threads,
// this one `tid`.  Each 8 consecutive threads copy 4 rows × 2 chunks (a
// 32-byte sector of each row; distinct banks with CS ≡ 64 mod 128).
template <typename T, int HD, int ROWS, int CS, int NT>
__device__ __forceinline__ void load_cm(uint32_t dst, const T* src, int r0,
                                        int n, int tid) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = HD / PER;
  static_assert(CH % 2 == 0 && ROWS % 4 == 0 && (ROWS * CH) % NT == 0,
                "whole 4-row × 2-chunk groups a pass");
#pragma unroll
  for (int p = tid; p < ROWS * CH; p += NT) {
    const int blk = p >> 3;
    const int r = 4 * (blk % (ROWS / 4)) + ((p >> 1) & 3);
    const int c = 2 * (blk / (ROWS / 4)) + (p & 1);
    const bool in = r0 + r < n;
    cp_async16(dst + c * CS + r * 16,
               src + static_cast<size_t>(in ? r0 + r : 0) * HD + c * PER, in);
  }
}

// f32: a landed tile (chunk stride RCS) as hi and lo planes laid out alike
// but unpadded (chunk stride BN · 16)
template <int HD, int BN, int RCS>
__device__ __forceinline__ void planes_same(const unsigned char* raw,
                                            unsigned char* hi,
                                            unsigned char* lo, int tid) {
  static_assert((BN * HD / 4) % kWG == 0, "whole passes");
#pragma unroll
  for (int e = tid; e < BN * HD / 4; e += kWG) {
    const int c = e / BN;
    const int r = e % BN;
    const float4 x =
        *reinterpret_cast<const float4*>(raw + c * RCS + r * 16);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + e * 16) = h;
    *reinterpret_cast<uint4*>(lo + e * 16) = l;
  }
}

// f32: a landed tile [BN rows][HD] transposed into hi and lo planes, K-major
// with the tile's rows along K: dim d at (d / 8) · kTSBO + (d % 8) · 16,
// row 8j + u in k chunk 2j + u % 2 (TLBO apart) at slot u / 2, so k slots
// t and t + 4 of k step j are rows 8j + 2t and 8j + 2t + 1.  A warp takes
// 8 rows × 4 chunks at a time: lane (u, c) reads row u's chunk c and
// stores its 4 dims (conflict-free with kTSBO ≡ 16 mod 128 and
// TLBO ≡ 32 mod 64).
template <int HD, int BN, int RCS, int TLBO>
__device__ __forceinline__ void planes_t(const unsigned char* raw,
                                         unsigned char* hi, unsigned char* lo,
                                         int warp, int lane) {
  constexpr int BLOCKS = (BN / 8) * (HD / 16);
  static_assert(BLOCKS % 4 == 0, "whole passes of the four warps");
  const int u = lane & 7;
  const int dcl = lane >> 3;
#pragma unroll
  for (int blk = warp; blk < BLOCKS; blk += 4) {
    const int j = blk % (BN / 8);
    const int dc = 4 * (blk / (BN / 8)) + dcl;
    const int row = 8 * j + u;
    const float4 x =
        *reinterpret_cast<const float4*>(raw + dc * RCS + row * 16);
    const float v[4] = {x.x, x.y, x.z, x.w};
    const int base = (2 * j + (u & 1)) * TLBO + (u >> 1) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * dc + i;
      const int off = base + (d >> 3) * kTSBO + (d & 7) * 16;
      uint32_t h, l;
      split(v[i], h, l);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    }
  }
}

// ---------------------------------------------------------------------------
// products (one warpgroup; w the warp, lane 4g + t)
// ---------------------------------------------------------------------------
// fragment m of qk2_f32's chain (product m / NG) joins s1 or s2
template <int NG, int R>
__device__ __forceinline__ void take_frag(float (&f)[2][R], float (&s1)[R],
                                          float (&s2)[R], int m) {
  float(&last)[R] = f[m & 1];
  fence_regs(last);
  if (m < NG) {
#pragma unroll
    for (int i = 0; i < R; ++i) s1[i] = m == 0 ? last[i] : s1[i] + last[i];
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) s2[i] = m == NG ? last[i] : s2[i] + last[i];
  }
}

// f32: s1 = A1 B1ᵀ, then s2 = A2 B2ᵀ (m64 × BN, reduced over HD).  A1,
// A2: fixed 64-row tiles (chunk stride FCS), loaded and split here two k
// steps at a time; B1, B2: hi / lo plane descriptors (chunk stride BN · 16).  Each
// group of two k steps sums its six products in a fresh fragment, and s1
// or s2 takes the fragment in a round-to-nearest f32 add.  Two fragments
// alternate, a wgmma group each, so one group runs while the last is
// added; the chain runs on from s1 into s2 without draining.  (With one
// accumulator taking all 48 tensor-core adds at hd = 128, the numpy model
// in tests/test_torch_flash_tiles.py puts dQ and dK up to 6.9× as far from
// float64 as the plain f32 version, where chip_smoke allows 2×; with
// fragments of two k steps, 1.4×.)
template <int HD, int BN, int FCS>
__device__ __forceinline__ void qk2_f32(float (&s1)[BN / 2],
                                        float (&s2)[BN / 2],
                                        const unsigned char* A1,
                                        const unsigned char* A2, uint64_t b1h,
                                        uint64_t b1l, uint64_t b2h,
                                        uint64_t b2l, int w, int g, int t) {
  constexpr int PCS = BN * 16;
  constexpr int G = HD / 8 < 2 ? HD / 8 : 2;   // k steps a fragment
  constexpr int NG = HD / 8 / G;               // fragments a product
  const int row = (16 * w + g) * 16 + 4 * t;
  float f[2][BN / 2];
  // fragment n of 2 NG: product n / NG, k steps from G (n % NG)
#pragma unroll
  for (int n = 0; n < 2 * NG; ++n) {
    const unsigned char* A = n < NG ? A1 : A2;
    const uint64_t bh = n < NG ? b1h : b2h;
    const uint64_t bl = n < NG ? b1l : b2l;
    // the group's A fragments, then one fence for its wgmma
    uint32_t hi[G][4], lo[G][4];
#pragma unroll
    for (int kq = 0; kq < G; ++kq) {
      const int kk = (n % NG) * G + kq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a[i]: row g + 8 (i % 2), k slot t + 4 (i / 2): chunk 2kk + i / 2
        const int off = (2 * kk + (i >> 1)) * FCS + row + (i & 1) * 128;
        split(*reinterpret_cast<const float*>(A + off), hi[kq][i],
              lo[kq][i]);
      }
    }
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < G; ++kq) {
      const uint32_t at = 2 * ((n % NG) * G + kq) * PCS;
      wg_tf32<BN>(f[n & 1], lo[kq], desc_at(bh, at), kq > 0);
      wg_tf32<BN>(f[n & 1], hi[kq], desc_at(bl, at), 1);
      wg_tf32<BN>(f[n & 1], hi[kq], desc_at(bh, at), 1);
    }
    wg_commit();
    if (n > 0) {
      wg_wait<1>();                  // fragment n - 1 is done
      take_frag<NG>(f, s1, s2, n - 1);
    }
  }
  wg_wait<0>();
  take_frag<NG>(f, s1, s2, 2 * NG - 1);
}

// bf16: the same from shared memory (A1, A2 chunk stride FCS; B1, B2 the
// landed tiles, chunk stride RCS), descriptors at k 0
template <int HD, int BN, int FCS, int RCS>
__device__ __forceinline__ void qk2_bf16(float (&s1)[BN / 2],
                                         float (&s2)[BN / 2], uint64_t a1,
                                         uint64_t a2, uint64_t b1,
                                         uint64_t b2) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wg_bf16_ss<BN>(s1, desc_at(a1, 2 * kk * FCS), desc_at(b1, 2 * kk * RCS),
                   kk > 0);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wg_bf16_ss<BN>(s2, desc_at(a2, 2 * kk * FCS), desc_at(b2, 2 * kk * RCS),
                   kk > 0);
  wg_commit();
  wg_wait<0>();
  fence_regs(s1);
  fence_regs(s2);
}

// part (m64 × ND, fresh) = X B, reduced over the BN swept rows.  X: an
// m64 × BN accumulator (p or dS), its column 8kk + 2t + e in k slot
// t + 4e of k step kk.
//   f32: X split here, B the transposed hi / lo planes (TLBO, kTSBO)
//   bf16: X rounded to bf16 pairs (SPLIT: X = hi + lo, two bf16 terms,
//         lo's product first), B the landed tile read MN-major
template <int BN, int ND, int TLBO>
__device__ __forceinline__ void pv_f32(float (&part)[ND / 2],
                                       const float (&x)[BN / 2], uint64_t bh,
                                       uint64_t bl) {
  uint32_t hi[BN / 8][4], lo[BN / 8][4];
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    split(x[4 * kk], hi[kk][0], lo[kk][0]);
    split(x[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split(x[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split(x[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    const uint32_t at = 2 * kk * TLBO;
    wg_tf32<ND>(part, lo[kk], desc_at(bh, at), kk > 0);
    wg_tf32<ND>(part, hi[kk], desc_at(bl, at), 1);
    wg_tf32<ND>(part, hi[kk], desc_at(bh, at), 1);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(part);
}

template <int BN, int ND, bool SPLIT>
__device__ __forceinline__ void pv_bf16(float (&part)[ND / 2],
                                        const float (&x)[BN / 2],
                                        uint64_t b) {
  uint32_t a[BN / 16][4], l[SPLIT ? BN / 16 : 1][4];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = x[8 * kk + 2 * i];
      const float x1 = x[8 * kk + 2 * i + 1];
      a[kk][i] = pack_bf16(x0, x1);
      if constexpr (SPLIT)
        l[kk][i] = pack_bf16(x0 - __uint_as_float(a[kk][i] << 16),
                             x1 - __uint_as_float(a[kk][i] & 0xffff0000u));
    }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (SPLIT) {
      wg_bf16_rs<ND>(part, l[kk], desc_at(b, kk * 256), kk > 0);
      wg_bf16_rs<ND>(part, a[kk], desc_at(b, kk * 256), 1);
    } else {
      wg_bf16_rs<ND>(part, a[kk], desc_at(b, kk * 256), kk > 0);
    }
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(part);
}

// acc += part, to nearest
template <int R>
__device__ __forceinline__ void add_to(float (&acc)[R],
                                       const float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += part[i];
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// rows r0 + 16w + g (+ 8) of an m64 × HD block held as NH halves of
// accumulators, times scale, into out (rows at or past n skipped)
template <typename T, int HD, int NH>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[NH][HD / NH / 2],
                                           int r0, int n, float scale, int w,
                                           int g, int t) {
  constexpr int ND = HD / NH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 16 * w + g + 8 * hh;
    if (r >= n) continue;
    T* row = out + static_cast<size_t>(r) * HD;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < ND / 8; ++j)
        store2(row + h * ND + 8 * j + 2 * t,
               acc[h][4 * j + 2 * hh] * scale,
               acc[h][4 * j + 2 * hh + 1] * scale);
  }
}

// the live mask of flash_mha (window 0: none)
__device__ __forceinline__ bool live(int row, int col, int sq, int sk,
                                     int causal, int window) {
  return row < sq && col < sk && (!causal || col <= row) &&
         (window == 0 || row - col < window);
}

// lse2 as the exponent's offset: a row with no live key (-inf) gives
// +inf, so 2^(s - lse2) is 0
__device__ __forceinline__ float lse_offset(float x) {
  return x == -CUDART_INF_F ? CUDART_INF_F : x;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------
// Warpgroup 0 is the producer, 1..NC the consumers.  Barriers of each ring
// stage: raw_full (the producer's 32 cp.async lanes), raw_empty (f32: the
// producer's 128 threads once they have converted the tile; bf16: the
// consumers, whose wgmma read it), plane_full (the producer's 128
// threads), plane_empty (the consumers).  A tile hands its planes over H
// times (f32 past hd = 64: the planes as they lie, then the transposed
// ones in the same space).  A consumer with nothing live in a tile still
// waits for each fill before its release, so the release counts toward
// that fill's phase.

// the handover parity of tile i's h-th hand-over of stage i % S
template <int S, int H>
__device__ __forceinline__ int parity(int i, int h) {
  return ((i / S) * H + h) & 1;
}

// dQ, and δ for dkv_kernel
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::threads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const float* __restrict__ lse, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ delta, int bh, int sq,
          int sk, int causal, int window, float scale) {
  using C = Cfg<T, HD>;
  constexpr int BN = C::BN;
  constexpr int ND = C::ND;
  constexpr int RS = C::RSQ;
  constexpr int PS = C::PS > 0 ? C::PS : 1;
  constexpr int H = C::H;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const Qs = smem;
  unsigned char* const dOs = Qs + C::fixed;
  unsigned char* const raws = dOs + C::fixed;         // stage: K, V
  unsigned char* const planes = raws + RS * C::dq_raw;
  float* const dl = reinterpret_cast<float*>(planes + C::PS * C::dq_planes);
  const uint32_t raw_full = smem_u32(dl + C::ROWS);
  const uint32_t raw_empty = raw_full + 8 * RS;
  const uint32_t plane_full = raw_empty + 8 * RS;
  const uint32_t plane_empty = plane_full + 8 * C::PS;

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int ltid = tid % kWG;
  const int warp = ltid >> 5;
  const int lane = tid & 31;
  const int nq = (sq + C::ROWS - 1) / C::ROWS;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh);  // heavy first
  const int b = static_cast<int>(blockIdx.x % bh);
  const int q0 = qt * C::ROWS;
  const size_t qoff = static_cast<size_t>(b) * sq;
  const size_t koff = static_cast<size_t>(b) * sk;

  // key tiles holding a live pair of rows [q0, q_last]
  const int q_last = min(q0 + C::ROWS, sq) - 1;
  const int nk = (sk + BN - 1) / BN;
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / BN : 0;
  const int kt1 = causal ? min(nk, q_last / BN + 1) : nk;
  const int tiles = max(0, kt1 - kt0);

  if (tid == 0) {
    for (int s = 0; s < RS; ++s) {
      mbar_init(raw_full + 8 * s, 32);
      mbar_init(raw_empty + 8 * s, C::f32 ? kWG : C::NC * kWG);
    }
    for (int s = 0; s < C::PS; ++s) {
      mbar_init(plane_full + 8 * s, kWG);
      mbar_init(plane_empty + 8 * s, C::NC * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                       // the producer
    auto load = [&](int i) {           // warp 0: tile i's K and V
      const int s = i % RS;
      mbar_wait(raw_empty + 8 * s, parity<RS, 1>(i, 0) ^ 1);
      const uint32_t st = smem_u32(raws + s * C::dq_raw);
      const int k0 = (kt0 + i) * BN;
      load_cm<T, HD, BN, C::rcs, 32>(st, k + koff * HD, k0, sk, lane);
      load_cm<T, HD, BN, C::rcs, 32>(st + C::raw, v + koff * HD, k0, sk,
                                     lane);
      cp_mbar_arrive(raw_full + 8 * s);
    };
    if constexpr (C::f32) {
      if (warp == 0)
        for (int i = 0; i < min(RS, tiles); ++i) load(i);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % RS;
        const int ps = i % PS;
        const unsigned char* st = raws + s * C::dq_raw;
        unsigned char* pl = planes + ps * C::dq_planes;
        mbar_wait(raw_full + 8 * s, parity<RS, 1>(i, 0));
#pragma unroll
        for (int h = 0; h < H; ++h) {
          mbar_wait(plane_empty + 8 * ps, parity<PS, H>(i, h) ^ 1);
          if (h == 0) {
            planes_same<HD, BN, C::rcs>(st, pl, pl + C::plane, ltid);
            planes_same<HD, BN, C::rcs>(st + C::raw, pl + 2 * C::plane,
                                        pl + 3 * C::plane, ltid);
          }
          if (h == H - 1)
            planes_t<HD, BN, C::rcs, C::tlbo>(st, pl + C::toff,
                                              pl + C::toff + C::tplane,
                                              warp, lane);
          fence_async();
          mbar_arrive(plane_full + 8 * ps);
        }
        mbar_arrive(raw_empty + 8 * s);
        if (warp == 0 && i + RS < tiles) load(i + RS);
      }
    } else if (warp == 0) {
      for (int i = 0; i < tiles; ++i) load(i);
    }
    cp_wait_all();
    return;
  }

  const int c = wg - 1;                // this consumer's rows: rb + [0, 64)
  const int rb = BQ * c;
  const int r0 = q0 + rb;
  const int w = warp;
  const int g = lane >> 2;
  const int t = lane & 3;
  load_cm<T, HD, BQ, C::fcs, kWG>(smem_u32(Qs) + rb * 16, q + qoff * HD, r0,
                                  sq, ltid);
  load_cm<T, HD, BQ, C::fcs, kWG>(smem_u32(dOs) + rb * 16, dout + qoff * HD,
                                  r0, sq, ltid);
  cp_wait_all();
  fence_async();
  wg_sync(wg);
  if constexpr (C::f32) {  // δ as dP's products give it (delta_kernel)
    if (ltid < BQ) dl[rb + ltid] = r0 + ltid < sq ? delta[qoff + r0 + ltid]
                                                  : 0.f;
  } else {  // δ = rowsum(dO ∘ o): 2 threads a row, half the dims each
    constexpr int PER = 16 / C::esz;
    const int r = ltid >> 1;
    const int half = ltid & 1;
    float s = 0.f;
    if (r0 + r < sq) {
      const T* orow = o + (qoff + r0 + r) * HD;
#pragma unroll
      for (int ch = half * (C::CH / 2); ch < (half + 1) * (C::CH / 2); ++ch) {
        const T* d = reinterpret_cast<const T*>(dOs + ch * C::fcs +
                                                (rb + r) * 16);
#pragma unroll
        for (int e = 0; e < PER; ++e)
          s = fmaf(to_f32(d[e]), to_f32(orow[ch * PER + e]), s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) {
      dl[rb + r] = s;
      if (r0 + r < sq) delta[qoff + r0 + r] = s;
    }
  }
  wg_sync(wg);
  float m[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * w + g + 8 * hh;
    m[hh] = r0 + r < sq ? lse_offset(lse[qoff + r0 + r]) : CUDART_INF_F;
    dd[hh] = dl[rb + r];
  }
  const float scale_log2 = scale * kLog2e;
  const unsigned char* const Qa = Qs + rb * 16;     // this consumer's rows
  const unsigned char* const dOa = dOs + rb * 16;

  float acc[C::NH][ND / 2];
#pragma unroll
  for (int h = 0; h < C::NH; ++h)
#pragma unroll
    for (int i = 0; i < ND / 2; ++i) acc[h][i] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    const int k0 = (kt0 + i) * BN;
    const bool idle = r0 >= sq || (causal && k0 > r0 + BQ - 1) ||
                      (window > 0 && r0 - (k0 + BN - 1) >= window);
    const int s = i % RS;
    const int ps = i % PS;
    const uint32_t ka = smem_u32(raws + s * C::dq_raw);
    const uint32_t pa = smem_u32(planes + ps * C::dq_planes);
    float sc[BN / 2], dp[BN / 2];
    if constexpr (C::f32) {
      mbar_wait(plane_full + 8 * ps, parity<PS, H>(i, 0));
      if (!idle)
        qk2_f32<HD, BN, C::fcs>(
            sc, dp, Qa, dOa, make_desc(pa, C::pcs, 128),
            make_desc(pa + C::plane, C::pcs, 128),
            make_desc(pa + 2 * C::plane, C::pcs, 128),
            make_desc(pa + 3 * C::plane, C::pcs, 128), w, g, t);
      if (H == 2) {                    // the transposed planes replace them
        mbar_arrive(plane_empty + 8 * ps);
        mbar_wait(plane_full + 8 * ps, parity<PS, H>(i, H - 1));
      }
    } else {
      mbar_wait(raw_full + 8 * s, parity<RS, 1>(i, 0));
      fence_async();
      if (!idle)
        qk2_bf16<HD, BN, C::fcs, C::rcs>(
            sc, dp, make_desc(smem_u32(Qa), C::fcs, 128),
            make_desc(smem_u32(dOa), C::fcs, 128), make_desc(ka, C::rcs, 128),
            make_desc(ka + C::raw, C::rcs, 128));
    }
    if (!idle) {
      // dS = p ∘ (dP − δ), in place of s
      const bool whole = r0 + BQ <= sq && k0 + BN <= sk &&
                         (!causal || k0 + BN - 1 <= r0) &&
                         (window == 0 || r0 + BQ - 1 - k0 < window);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          float p = ex2(fmaf(sc[4 * j + e], scale_log2, -m[hh]));
          if (!whole && !live(r0 + 16 * w + g + 8 * hh,
                              k0 + 8 * j + 2 * t + (e & 1), sq, sk, causal,
                              window))
            p = 0.f;
          sc[4 * j + e] = p * (dp[4 * j + e] - dd[hh]);
        }
      // dQ += dS K, a fresh partial per half
#pragma unroll
      for (int h = 0; h < C::NH; ++h) {
        float part[ND / 2];
        if constexpr (C::f32) {
          const uint32_t at = pa + C::toff + h * (ND / 8) * kTSBO;
          pv_f32<BN, ND, C::tlbo>(part, sc, make_desc(at, C::tlbo, kTSBO),
                                  make_desc(at + C::tplane, C::tlbo, kTSBO));
        } else {
          pv_bf16<BN, ND, true>(part, sc,
                                make_desc(ka + h * (ND / 8) * C::rcs, 128,
                                          C::rcs));
        }
        add_to(acc[h], part);
      }
    }
    mbar_arrive(C::f32 ? plane_empty + 8 * ps : raw_empty + 8 * s);
  }
  store_rows<T, HD, C::NH>(dq + qoff * HD, acc, r0, sq, scale, w, g, t);
}

// dK, dV
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::threads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ lse,
           const T* __restrict__ dout, const float* __restrict__ delta,
           const float* __restrict__ dead, T* __restrict__ dk,
           T* __restrict__ dv, int bh, int sq, int sk, int causal, int window,
           float scale) {
  using C = Cfg<T, HD>;
  constexpr int BN = C::BN;
  constexpr int ND = C::ND;
  constexpr int RS = C::RSKV;
  constexpr int PS = C::PS > 0 ? C::PS : 1;
  constexpr int H = C::H;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const Ks = smem;
  unsigned char* const Vs = Ks + C::fixed;
  unsigned char* const raws = Vs + C::fixed;          // stage: Q, dO, lse, δ
  unsigned char* const planes = raws + RS * C::dkv_raw;
  const uint32_t raw_full = smem_u32(planes + C::PS * C::dkv_planes);
  const uint32_t raw_empty = raw_full + 8 * RS;
  const uint32_t plane_full = raw_empty + 8 * RS;
  const uint32_t plane_empty = plane_full + 8 * C::PS;

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int ltid = tid % kWG;
  const int warp = ltid >> 5;
  const int lane = tid & 31;
  const int kt = static_cast<int>(blockIdx.x / bh);   // causal: heavy first
  const int b = static_cast<int>(blockIdx.x % bh);
  const int k0 = kt * C::ROWS;
  const size_t qoff = static_cast<size_t>(b) * sq;
  const size_t koff = static_cast<size_t>(b) * sk;

  // query tiles holding a live pair of keys [k0, k_last]
  const int k_last = min(k0 + C::ROWS, sk) - 1;
  const int nq = (sq + BN - 1) / BN;
  const int qt0 = causal ? min(nq, k0 / BN) : 0;
  const int qt1 =
      window > 0
          ? min(nq, static_cast<int>(
                        (static_cast<long long>(k_last) + window - 1) / BN) +
                        1)
          : nq;
  const int tiles = max(0, qt1 - qt0);

  if (tid == 0) {
    for (int s = 0; s < RS; ++s) {
      mbar_init(raw_full + 8 * s, 32);
      mbar_init(raw_empty + 8 * s, C::f32 ? kWG : C::NC * kWG);
    }
    for (int s = 0; s < C::PS; ++s) {
      mbar_init(plane_full + 8 * s, kWG);
      mbar_init(plane_empty + 8 * s, C::NC * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                       // the producer
    auto load = [&](int i) {           // warp 0: tile i's Q, dO, lse, δ
      const int s = i % RS;
      mbar_wait(raw_empty + 8 * s, parity<RS, 1>(i, 0) ^ 1);
      const uint32_t st = smem_u32(raws + s * C::dkv_raw);
      const int i0 = (qt0 + i) * BN;
      load_cm<T, HD, BN, C::rcs, 32>(st, q + qoff * HD, i0, sq, lane);
      load_cm<T, HD, BN, C::rcs, 32>(st + C::raw, dout + qoff * HD, i0, sq,
                                     lane);
#pragma unroll
      for (int r = lane; r < BN; r += 32) {
        const bool in = i0 + r < sq;
        const size_t at = qoff + (in ? i0 + r : 0);
        cp_async4(st + 2 * C::raw + 4 * r, lse + at, in);
        cp_async4(st + 2 * C::raw + 4 * (BN + r), delta + at, in);
      }
      cp_mbar_arrive(raw_full + 8 * s);
    };
    if constexpr (C::f32) {
      if (warp == 0)
        for (int i = 0; i < min(RS, tiles); ++i) load(i);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % RS;
        const int ps = i % PS;
        const unsigned char* st = raws + s * C::dkv_raw;
        unsigned char* pl = planes + ps * C::dkv_planes;
        mbar_wait(raw_full + 8 * s, parity<RS, 1>(i, 0));
#pragma unroll
        for (int h = 0; h < H; ++h) {
          mbar_wait(plane_empty + 8 * ps, parity<PS, H>(i, h) ^ 1);
          if (h == 0) {
            planes_same<HD, BN, C::rcs>(st, pl, pl + C::plane, ltid);
            planes_same<HD, BN, C::rcs>(st + C::raw, pl + 2 * C::plane,
                                        pl + 3 * C::plane, ltid);
            if (ltid < 2 * BN)         // lse and δ ride with the planes
              reinterpret_cast<float*>(pl + C::lse_off)[ltid] =
                  reinterpret_cast<const float*>(st + 2 * C::raw)[ltid];
          }
          if (h == H - 1) {
            planes_t<HD, BN, C::rcs, C::tlbo>(st, pl + C::toff,
                                              pl + C::toff + C::tplane,
                                              warp, lane);
            planes_t<HD, BN, C::rcs, C::tlbo>(
                st + C::raw, pl + C::toff + 2 * C::tplane,
                pl + C::toff + 3 * C::tplane, warp, lane);
          }
          fence_async();
          mbar_arrive(plane_full + 8 * ps);
        }
        mbar_arrive(raw_empty + 8 * s);
        if (warp == 0 && i + RS < tiles) load(i + RS);
      }
    } else if (warp == 0) {
      for (int i = 0; i < tiles; ++i) load(i);
    }
    cp_wait_all();
    return;
  }

  const int c = wg - 1;                // this consumer's keys: kb + [0, 64)
  const int kb = BQ * c;
  const int kc0 = k0 + kb;
  const int w = warp;
  const int g = lane >> 2;
  const int t = lane & 3;
  load_cm<T, HD, BQ, C::fcs, kWG>(smem_u32(Ks) + kb * 16, k + koff * HD, kc0,
                                  sk, ltid);
  load_cm<T, HD, BQ, C::fcs, kWG>(smem_u32(Vs) + kb * 16, v + koff * HD, kc0,
                                  sk, ltid);
  cp_wait_all();
  fence_async();
  wg_sync(wg);
  const float scale_log2 = scale * kLog2e;
  const unsigned char* const Ka = Ks + kb * 16;     // this consumer's keys
  const unsigned char* const Va = Vs + kb * 16;

  float adk[C::NH][ND / 2], adv[C::NH][ND / 2];
#pragma unroll
  for (int h = 0; h < C::NH; ++h)
#pragma unroll
    for (int i = 0; i < ND / 2; ++i) adk[h][i] = adv[h][i] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    const int i0 = (qt0 + i) * BN;
    const bool idle = kc0 >= sk || (causal && i0 + BN - 1 < kc0) ||
                      (window > 0 && i0 - (kc0 + BQ - 1) >= window);
    const int s = i % RS;
    const int ps = i % PS;
    const uint32_t qa = smem_u32(raws + s * C::dkv_raw);
    const uint32_t pa = smem_u32(planes + ps * C::dkv_planes);
    const float* ls;                   // the tile's lse, then δ
    float sc[BN / 2], dp[BN / 2];      // Sᵀ, dPᵀ: keys × queries
    if constexpr (C::f32) {
      ls = reinterpret_cast<const float*>(planes + ps * C::dkv_planes +
                                          C::lse_off);
      mbar_wait(plane_full + 8 * ps, parity<PS, H>(i, 0));
      if (!idle)
        qk2_f32<HD, BN, C::fcs>(
            sc, dp, Ka, Va, make_desc(pa, C::pcs, 128),
            make_desc(pa + C::plane, C::pcs, 128),
            make_desc(pa + 2 * C::plane, C::pcs, 128),
            make_desc(pa + 3 * C::plane, C::pcs, 128), w, g, t);
    } else {
      ls = reinterpret_cast<const float*>(raws + s * C::dkv_raw +
                                          2 * C::raw);
      mbar_wait(raw_full + 8 * s, parity<RS, 1>(i, 0));
      fence_async();
      if (!idle)
        qk2_bf16<HD, BN, C::fcs, C::rcs>(
            sc, dp, make_desc(smem_u32(Ka), C::fcs, 128),
            make_desc(smem_u32(Va), C::fcs, 128), make_desc(qa, C::rcs, 128),
            make_desc(qa + C::raw, C::rcs, 128));
    }
    if (!idle) {
      // pᵀ in place of sᵀ, dSᵀ = pᵀ ∘ (dPᵀ − δ) in place of dPᵀ
      const bool whole = i0 + BN <= sq && kc0 + BQ <= sk &&
                         (!causal || kc0 + BQ - 1 <= i0) &&
                         (window == 0 || i0 + BN - 1 - kc0 < window);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(ls + BN + 8 * j + 2 * t);
        const float mm[2] = {lse_offset(l2.x), lse_offset(l2.y)};
        const float de[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = e & 1;
          float p = ex2(fmaf(sc[4 * j + e], scale_log2, -mm[cc]));
          if (!whole && !live(i0 + 8 * j + 2 * t + cc,
                              kc0 + 16 * w + g + 8 * (e >> 1), sq, sk,
                              causal, window))
            p = 0.f;
          sc[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - de[cc]);
        }
      }
    }
    if constexpr (C::f32) {
      if (H == 2) {                    // the transposed planes replace them
        mbar_arrive(plane_empty + 8 * ps);
        mbar_wait(plane_full + 8 * ps, parity<PS, H>(i, H - 1));
      }
    }
    if (!idle) {
      // dV += pᵀ dO, dK += dSᵀ Q, a fresh partial per half
#pragma unroll
      for (int h = 0; h < C::NH; ++h) {
        float part[ND / 2];
        if constexpr (C::f32) {
          const uint32_t at = pa + C::toff + h * (ND / 8) * kTSBO;
          pv_f32<BN, ND, C::tlbo>(
              part, sc, make_desc(at + 2 * C::tplane, C::tlbo, kTSBO),
              make_desc(at + 3 * C::tplane, C::tlbo, kTSBO));
        } else {
          pv_bf16<BN, ND, false>(part, sc,
                                 make_desc(qa + C::raw + h * (ND / 8) * C::rcs,
                                           128, C::rcs));
        }
        add_to(adv[h], part);
      }
#pragma unroll
      for (int h = 0; h < C::NH; ++h) {
        float part[ND / 2];
        if constexpr (C::f32) {
          const uint32_t at = pa + C::toff + h * (ND / 8) * kTSBO;
          pv_f32<BN, ND, C::tlbo>(part, dp, make_desc(at, C::tlbo, kTSBO),
                                  make_desc(at + C::tplane, C::tlbo, kTSBO));
        } else {
          pv_bf16<BN, ND, true>(part, dp,
                                make_desc(qa + h * (ND / 8) * C::rcs, 128,
                                          C::rcs));
        }
        add_to(adk[h], part);
      }
    }
    mbar_arrive(C::f32 ? plane_empty + 8 * ps : raw_empty + 8 * s);
  }
  if (dead != nullptr) {               // each key's 1 / sk of dead rows' dO
    const float* u = dead + static_cast<size_t>(b) * HD;
#pragma unroll
    for (int h = 0; h < C::NH; ++h)
#pragma unroll
      for (int j = 0; j < ND / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          adv[h][4 * j + e] += u[h * ND + 8 * j + 2 * t + (e & 1)];
  }
  store_rows<T, HD, C::NH>(dv + koff * HD, adv, kc0, sk, 1.f, w, g, t);
  store_rows<T, HD, C::NH>(dk + koff * HD, adk, kc0, sk, scale, w, g, t);
}

// f32: δ = rowsum(dO ∘ o) on the tensor cores, twice, through qk2_f32:
// as dq_kernel's dP = dO Vᵀ takes its products (A = dO, B = o; δ_q) and as
// dkv_kernel's dPᵀ = V dOᵀ does (A = o, B = dO; δ_kv), the same split and
// the same k-step fragments and adds.  Where a row's key has o's bits in
// v's split (sk = 1: p = 1, o = v_hi + v_lo), dP − δ is then 0 exactly, as
// in exact arithmetic, where plain f32 FMA left the two roundings'
// residue for dK to sum over every query row.  One warpgroup a 64-row
// tile; a row's δ is on the diagonal of a 64 × 32 product, taken a half
// tile at a time.  delta: δ_q [bh, sq], then δ_kv [bh, sq].
template <int HD>
__global__ void __launch_bounds__(kWG, 1)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ delta, int bh, int sq) {
  constexpr int BN = 32;
  constexpr int FCS = BQ * 16 + 64;
  constexpr int PCS = BN * 16;
  constexpr int PLANE = (HD / 4) * PCS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const Os = smem;
  unsigned char* const dOs = Os + (HD / 4) * FCS;
  unsigned char* const pl = dOs + (HD / 4) * FCS;   // o hi, lo; dO hi, lo
  const int ltid = threadIdx.x;
  const int w = ltid >> 5;
  const int g = (ltid & 31) >> 2;
  const int t = ltid & 3;
  const int b = static_cast<int>(blockIdx.x % bh);
  const int r0 = static_cast<int>(blockIdx.x / bh) * BQ;
  const size_t qoff = static_cast<size_t>(b) * sq;
  load_cm<float, HD, BQ, FCS, kWG>(smem_u32(Os), o + qoff * HD, r0, sq, ltid);
  load_cm<float, HD, BQ, FCS, kWG>(smem_u32(dOs), dout + qoff * HD, r0, sq,
                                   ltid);
  cp_wait_all();
  __syncthreads();
  const uint32_t pa = smem_u32(pl);
#pragma unroll 1
  for (int h = 0; h < BQ / BN; ++h) {
    planes_same<HD, BN, FCS>(Os + h * BN * 16, pl, pl + PLANE, ltid);
    planes_same<HD, BN, FCS>(dOs + h * BN * 16, pl + 2 * PLANE,
                             pl + 3 * PLANE, ltid);
    fence_async();
    __syncthreads();
    float dq_d[BN / 2], dkv_d[BN / 2];
    qk2_f32<HD, BN, FCS>(dq_d, dkv_d, dOs, Os, make_desc(pa, PCS, 128),
                         make_desc(pa + PLANE, PCS, 128),
                         make_desc(pa + 2 * PLANE, PCS, 128),
                         make_desc(pa + 3 * PLANE, PCS, 128), w, g, t);
    // d[4j + e]: row 16w + g + 8(e / 2), column 8j + 2t + e % 2
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * w + g + 8 * (e >> 1);
        if (row == h * BN + 8 * j + 2 * t + (e & 1) && r0 + row < sq) {
          delta[qoff + r0 + row] = dq_d[4 * j + e];
          delta[static_cast<size_t>(bh) * sq + qoff + r0 + row] =
              dkv_d[4 * j + e];
        }
      }
    __syncthreads();                   // the planes are rewritten
  }
}

// rows with no live key (a window, and no causal mask or sq > sk: rows
// i >= d0 = sk - 1 + w): the reference averages v over all sk keys there
// (flash_mha.cu's dead_rows_kernel), so each key's dv takes 1 / sk of
// their dO, and dq and dk take nothing.  dead[b, d] = Σ_{i >= d0} dO[b, i,
// d] / sk, rows summed in order in f32; dkv_kernel adds it to every key.
template <typename T>
__global__ void dead_dv_kernel(const T* __restrict__ dout,
                               float* __restrict__ dead, int sq, int sk,
                               int hd, int d0) {
  const size_t b = blockIdx.x;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float s = 0.f;
    for (int i = d0; i < sq; ++i)
      s += to_f32(dout[(b * sq + i) * hd + d]);
    dead[b * hd + d] = s / static_cast<float>(sk);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int bh, int sq, int sk, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kq = dq_kernel<T, HD>;
  auto kkv = dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long q_ctas =
      static_cast<long long>((sq + C::ROWS - 1) / C::ROWS) * bh;
  const long long k_ctas =
      static_cast<long long>((sk + C::ROWS - 1) / C::ROWS) * bh;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if constexpr (C::f32) {
    constexpr size_t smem_d =
        2 * (HD / 4) * (BQ * 16 + 64) + 4 * (HD / 4) * 512;
    err = cudaFuncSetAttribute(delta_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_d));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long d_ctas = static_cast<long long>((sq + BQ - 1) / BQ) * bh;
    if (d_ctas > 0) {
      delta_kernel<HD><<<static_cast<unsigned>(d_ctas), kWG, smem_d,
                         stream>>>(static_cast<const float*>(o),
                                   static_cast<const float*>(dout), delta,
                                   bh, sq);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  // dead rows (none without a window): their dv share, in the scratch
  // past the two δ
  const long long d0 = window > 0 ? static_cast<long long>(sk) - 1 + window
                                  : sq;
  float* dead = nullptr;
  if (bh > 0 && sk > 0 && d0 < sq) {
    dead = delta + 2 * static_cast<size_t>(bh) * sq;
    dead_dv_kernel<T><<<static_cast<unsigned>(bh), HD, 0, stream>>>(
        tdo, dead, sq, sk, HD, static_cast<int>(d0 > 0 ? d0 : 0));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (q_ctas > 0) {
    kq<<<static_cast<unsigned>(q_ctas), C::threads, C::smem_dq, stream>>>(
        tq, tk, tv, static_cast<const T*>(o), lse, tdo, static_cast<T*>(dq),
        delta, bh, sq, sk, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (k_ctas > 0) {
    kkv<<<static_cast<unsigned>(k_ctas), C::threads, C::smem_dkv, stream>>>(
        tq, tk, tv, lse, tdo,
        C::f32 ? delta + static_cast<size_t>(bh) * sq : delta, dead,
        static_cast<T*>(dk), static_cast<T*>(dv), bh, sq, sk, causal, window,
        scale);
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
    case 80:
      return launch<T, 80>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, sq,
                           sk, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, sq,
                            sk, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq: [bh, sq, hd]; k, v, dk, dv: [bh, sk, hd]; lse: f32
// [bh, sq]; delta (scratch, written here): f32, 2 · bh · sq + bh · hd; all
// contiguous and 16-byte aligned, q..dv of one type (bf16 != 0:
// __nv_bfloat16, else float); hd in {16, 32, 64, 80, 128}; window 0 for
// none, else the band width w >= 1.  Launches on `stream`: f32's
// delta_kernel, dead_dv_kernel where a window leaves rows with no live key,
// dq_kernel (bf16: writes δ), then dkv_kernel (reads δ).
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
