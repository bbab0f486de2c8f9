// Hand-written Hopper (sm_90a) flash-attention forward for bf16.
//
// flash_fwd_sm90_kernel — replaces the Pallas TPU kernel
//   `flash_attention_fwd` (src/repro/kernels/flash_attention.py, body
//   `_flash_fwd_kernel`) for bf16 inputs; fp32 inputs take
//   `flash_fwd_f32_sm90_kernel` (flash_fwd_f32_sm90.cu). For
//   q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, d),
//   d in {64, 128, 256}, q head h reading kv head h / (Hq / Hkv):
//     out = softmax(mask(q k^T * d^-0.5)) v   in bf16, and
//     lse = log-sum-exp of each masked score row in fp32, -inf where the
//           whole row is masked,
//   under a causal mask (key <= query) and/or a sliding window
//   (query - key < window). The arithmetic is the Pallas kernel's: masked
//   scores contribute p = 0, the running-max correction is 0 while the
//   running max is still -1e30, out = acc / max(l, 1e-30) and
//   lse = m + log(l) where l > 0. Key tiles that the causal triangle or
//   the window masks whole are skipped (the Pallas kernel's `pl.when`).
//
//   Bound on the H100: operations. At the serving prefill shape (B=4,
//   Hq=32, Hkv=8, S=2048, d=128, causal) the unmasked (q, k) pairs need
//   137.5 GFLOP against 75 MB of q, k, v, out and lse (some 1,800
//   operations per byte; bf16 tensor cores bind above ~295), so the
//   design keeps the tensor cores fed and everything else off their path:
//
//   - Tiles and roles. A persistent grid, one CTA of 3 warpgroups per SM,
//     walks q tiles of 128 rows of one (batch x q head), longest first (the
//     causal triangle's last rows first, then across heads, so CTAs
//     resident together share kv heads in L2); key tiles are 128 wide at
//     d = 64 and 128, 64 wide at d = 256 (`Tile<D>`).
//     Warpgroup 0 is the producer: it drops to 24 registers
//     (`setmaxnreg.dec`) and one thread keeps Q and the K/V ring loaded
//     with TMA, running ahead into the CTA's next q tile while the
//     consumers finish the last one. Warpgroups 1 and 2 are the consumers,
//     64 query rows each, at 240 registers (`setmaxnreg.inc`);
//     24 x 128 + 240 x 256 = 64,512 of the SM's 65,536 registers.
//   - TMA. Q, K and V arrive by `cp.async.bulk.tensor` through 3-D tensor
//     maps (d, S, B*H), so rows past Sq or Skv are zero-filled per head by
//     the hardware rather than read from the next head. A 128-byte
//     swizzle box holds 64 bf16 columns, so a d=128 tile is two boxes of
//     128 rows x 128 B (Q's boxes are 128 rows high, K's and V's a key
//     tile high, each through its own tensor map). The ring has 3 stages
//     of K and V (2 at d = 256), each with its own `mbarrier`s (full K,
//     full V: the producer's expect-tx; empty: 256 consumer arrivals); Q
//     has a full and an empty barrier.
//   - wgmma. S = Q K^T with both operands K-major in shared memory, fp32
//     accumulators in registers (m64n128k16, or m64n64k16 at d = 256;
//     d/16 steps). Softmax runs on the accumulator fragment: each thread
//     holds 2 rows x 32 columns (16 at d = 256),
//     the row max is reduced over the quad with two shuffles, m and a
//     per-thread partial l stay in registers (l is reduced once, at the
//     end). O += P V uses the register-A form: the S accumulator of 16
//     keys, packed to bf16x2 pairs, is exactly the A fragment; V is the
//     MN-major B operand (transpose bit); at d = 256 each key step is two
//     m64n128k16 products, one per half of O. The O accumulator stays in
//     registers until the epilogue.
//   - Ping-pong and overlap. The two consumers take turns on the tensor
//     cores through two named barriers. In its turn t a warpgroup issues
//     QK^T of tile t and PV of tile t - 1 back to back, hands over, and
//     runs the softmax of tile t while its own PV and the other
//     warpgroup's products run; O is rescaled and P(t) split once that PV
//     has landed. No branch sits between a wgmma's issue and its wait
//     (each kind of turn is its own instantiation), or ptxas would
//     serialise the wgmmas. A stage is released when both consumers have
//     finished its PV; with 3 stages the producer refills a stage a whole
//     turn before it is needed.
//   - Numerics kept from the Pallas kernel: P enters PV at fp32
//     precision, as `p` and `v` are fp32 there. P is split into
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), two RS wgmmas into the
//     same accumulator, which carries P to about 16 significant bits.
//     This costs 1.5x the tensor-core work of the function
//     (QK^T + 2 x PV; the P_lo product is a third of it); the bound stays
//     the function's own.
//   Shared memory at d=128: Q 32,768 B + 3 stages x (K 32,768 + V 32,768)
//   = 229,376 B, 11 barriers 88 B, 1,024 B of slack to align the base to
//   the swizzle's 1,024-byte period: 230,488 B of the 232,448 a block may
//   have, one CTA per SM. At d=64 every tile is one box: 115,800 B.
//   - d = 256 (recurrentgemma's local attention). A 128-row tile is
//     64 KiB there, so Q and three 128-key stages would need 448 KiB: the
//     key tile halves to 64 and the ring to 2 stages, Q 65,536 B +
//     2 x (K 32,768 + V 32,768) + 8 barriers + slack = 197,696 B. The
//     consumer's registers stay those of d = 128: O 128 fp32 (was 64),
//     S 32 (was 64), P_hi and P_lo 16 each (were 32), 192 in all.
//   Any Sq, Skv >= 1: a q tile whose rows see no key runs no tile and
//   writes out = 0, lse = -inf.
//
// The kernel launches on the caller's stream, allocates nothing, and its C
// entry point returns a CUDA error code so the Python wrapper can raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;                // query rows per CTA
constexpr int kMaxBK = 128;             // the widest key tile
constexpr int kThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kBoxCols = 64;            // bf16 columns in a 128-byte row
constexpr int kRowBytes = 128;          // one box row: 64 bf16 columns
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Key tile width and K/V ring depth for head dim D: 128 keys and 3 stages
// where they fit in shared memory, 64 keys and 2 stages at D = 256.
template <int D>
struct Tile {
  static constexpr int kBK = D == 256 ? 64 : 128;
  static constexpr int kStages = D == 256 ? 2 : 3;
};

template <int D>
struct Smem {
  static constexpr int kBK = Tile<D>::kBK;
  static constexpr int kStages = Tile<D>::kStages;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQBox = kBQ * kRowBytes;       // 128 query rows
  static constexpr int kKBox = kBK * kRowBytes;       // one key tile
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKVTile = kBoxes * kKBox;
  static constexpr int q = 0;
  // stage s: K at kv + 2 s kKVTile, V after it
  static constexpr int kv = q + kQTile;
  static constexpr int bars = kv + kStages * 2 * kKVTile;
  static constexpr int kBars = 2 + 3 * kStages;   // q full/empty, K/V ring
  static constexpr int alloc = bars + kBars * 8 + 1024;
  static_assert(alloc <= 232448, "shared memory of one block");
};

// Addresses in the aligned shared-memory block: the K/V ring's tiles and
// its barriers (q full, then full K, full V and empty per stage, q empty).
template <int D>
struct Ring {
  static constexpr int kStages = Tile<D>::kStages;
  uint32_t base;
  __device__ uint32_t q_full() const { return base + Smem<D>::bars; }
  __device__ uint32_t full_k(int s) const { return q_full() + 8 * (1 + s); }
  __device__ uint32_t full_v(int s) const {
    return q_full() + 8 * (1 + kStages + s);
  }
  __device__ uint32_t empty(int s) const {
    return q_full() + 8 * (1 + 2 * kStages + s);
  }
  __device__ uint32_t q_empty() const {
    return q_full() + 8 * (1 + 3 * kStages);
  }
  __device__ uint32_t k_tile(int s) const {
    return base + Smem<D>::kv + s * 2 * Smem<D>::kKVTile;
  }
  __device__ uint32_t v_tile(int s) const {
    return k_tile(s) + Smem<D>::kKVTile;
  }
};

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (layout
// type 1): start address, leading and stride byte offsets in 16-byte units.
// K-major (Q, K): the stride offset steps 8 rows (1,024 B), the leading
// offset is unused. MN-major (V): the leading offset steps to the next box
// of 64 columns, the stride offset 8 keys.
// Shared addresses are below 2^18, so adding (bytes >> 4) to a descriptor
// moves its start address without touching the other fields.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t(addr >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// D (64 x 128, fp32) (+)= A B: A and B^T from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A B: A and B^T from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, a, b, scale_d);
  else
    wgmma_ss_n64(d, a, b, scale_d);
}

// D (64 x 128, fp32) += A B: A (64 x 16 bf16) from registers, B from
// shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D (64 x 64, fp32) += A B: A (64 x 16 bf16) from registers, B from
// shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// O (64 x D) += A B for one key step: at D = 256 two products, one per
// half of O, the second reading V's columns 128.. (`half_b`: the descriptor
// step to V's third 64-column box)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b,
                                         uint64_t half_b) {
  if constexpr (D == 256) {
    wgmma_rs_n128(reinterpret_cast<float(&)[64]>(d[0]), a0, a1, a2, a3, b);
    wgmma_rs_n128(reinterpret_cast<float(&)[64]>(d[64]), a0, a1, a2, a3,
                  b + half_b);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a0, a1, a2, a3, b);
  } else {
    wgmma_rs_n64(d, a0, a1, a2, a3, b);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// Named barriers 1 and 2 hand the tensor cores from one consumer
// warpgroup to the other (ping-pong): warpgroup w issues its products after
// `bar.sync 1 + w`, which completes once the other warpgroup has arrived
// there, right after issuing its own. So one warpgroup's softmax runs
// under the other's products.
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - w) : "memory");
}

// S = Q K^T for a warpgroup's 64 query rows and one key tile (issued, not
// waited for)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<D>::kBK / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
  using L = Smem<D>;
  // one descriptor per operand; a step of 16 columns moves its start
  // address, by 32 bytes within a box and by a box height across boxes
  const uint64_t qd = sw128_desc(q_rows, 16, 1024);
  const uint64_t kd = sw128_desc(k_tile, 16, 1024);
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t qoff = ((kk / 4) * L::kQBox + (kk % 4) * 32) >> 4;
    const uint64_t koff = ((kk / 4) * L::kKBox + (kk % 4) * 32) >> 4;
    wgmma_ss<L::kBK>(sc, qd + qoff, kd + koff, kk > 0);
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V for one key tile (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&phi)[Tile<D>::kBK / 4],
    const uint32_t (&plo)[Tile<D>::kBK / 4], uint32_t v_tile) {
  using L = Smem<D>;
  const uint64_t vd0 = sw128_desc(v_tile, L::kKBox, 1024);
  const uint64_t half = (2 * L::kKBox) >> 4;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kBK / 16; ++kk) {
    const uint64_t vd = vd0 + ((kk * 16 * kRowBytes) >> 4);    // 16 keys on
    wgmma_rs<D>(o, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
                phi[4 * kk + 3], vd, half);
    wgmma_rs<D>(o, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
                plo[4 * kk + 3], vd, half);
  }
  wgmma_commit();
}

// Where a thread's values sit in a tile: sc[4j + 2h + e] is query row
// row0 + 8h and key k0 + 8j + col0 + e (the wgmma accumulator layout).
// Row h keeps the keys in [lo[h], hi[h]]: below Skv, at or before the
// query (causal), within the window.
struct Rows {
  int row0, col0, qmin, lo[2], hi[2];
};

// Online softmax of one S tile on its accumulator fragment: the mask
// (kMask: a tile that the causal triangle, the window or Skv cuts), running
// max m and partial sum l; p overwrites s. Returns each row's correction of
// the accumulator in corr. Touches no O register and has no branch, so it
// runs while the previous tile's PV is still in flight.
template <int kBK, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2],
                                             float (&m_run)[2],
                                             float (&l_part)[2],
                                             float (&corr)[2], const Rows& w,
                                             int k0, float scale) {
  if constexpr (kMask) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // bounds relative to this thread's first key of the tile, so each
      // element compares against a constant
      const int lo = w.lo[h] - k0 - w.col0, hi = w.hi[h] - k0 - w.col0;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          sc[4 * j + 2 * h + e] =
              c >= lo && c <= hi ? sc[4 * j + 2 * h + e] : -CUDART_INF_F;
        }
    }
  }
  const float scale_log2 = scale * kLog2e;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx * scale);
    const float mb = m_new * kLog2e;
    corr[h] = m_run[h] <= kNegInf / 2 ? 0.f : ex2(m_run[h] * kLog2e - mb);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(sc[4 * j + 2 * h + e], scale_log2, -mb));
        sc[4 * j + 2 * h + e] = p;
        sum += p;
      }
    l_part[h] = l_part[h] * corr[h] + sum;
    m_run[h] = m_new;
  }
}

// O *= corr row by row, then P split into the bf16 A fragments of PV:
// register r of key step kk is the pair (sc[8 kk + 2 r], sc[8 kk + 2 r + 1])
template <int D, int kBK = Tile<D>::kBK>
__device__ __forceinline__ void rescale_and_split(float (&o)[D / 2],
                                                  const float (&corr)[2],
                                                  const float (&sc)[kBK / 2],
                                                  uint32_t (&phi)[kBK / 4],
                                                  uint32_t (&plo)[kBK / 4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
#pragma unroll
  for (int r = 0; r < kBK / 4; ++r) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * r], sc[2 * r + 1]);
    const float2 back = __bfloat1622float2(hi);
    phi[r] = bits(hi);
    plo[r] = bits(__floats2bfloat162_rn(sc[2 * r] - back.x,
                                        sc[2 * r + 1] - back.y));
  }
}

// A consumer warpgroup's registers: the O accumulator, the bf16 A
// fragments of the last P, and each row's running max and partial sum.
template <int D>
struct Acc {
  float o[D / 2];
  uint32_t phi[Tile<D>::kBK / 4], plo[Tile<D>::kBK / 4];
  float m_run[2], l_part[2];
};

// One turn t of a consumer warpgroup (ping-pong, see the note at the top):
// take the tensor cores, issue QK^T of tile t (kQK) and PV of tile t - 1
// (kPV) back to back, hand the tensor cores over, run the softmax of tile
// t while that PV is in flight, then rescale O and split P(t) once it has
// landed. One instantiation per kind of turn, so no branch sits between a
// wgmma's issue and its wait (ptxas would serialise the wgmmas).
template <int D, bool kQK, bool kPV, bool kMask, typename Bars>
__device__ __forceinline__ void consumer_turn(Acc<D>& a, const Bars& bars,
                                              const Rows& w, int cw, int r,
                                              int k0, uint32_t q_rows,
                                              float scale) {
  constexpr int kBK = Tile<D>::kBK, kStages = Tile<D>::kStages;
  // r: the ring position of tile t (it runs on across the CTA's q tiles)
  const int s = r % kStages, sp = (r + kStages - 1) % kStages;
  if constexpr (kQK) mbar_wait(bars.full_k(s), (r / kStages) & 1);
  if constexpr (kPV) mbar_wait(bars.full_v(sp), ((r - 1) / kStages) & 1);
  turn_wait(cw);
  float sc[kBK / 2];
  if constexpr (kQK) issue_qk<D>(sc, q_rows, bars.k_tile(s));
  if constexpr (kPV) issue_pv<D>(a.o, a.phi, a.plo, bars.v_tile(sp));
  if constexpr (kQK) turn_pass(cw);
  float corr[2];
  if constexpr (kQK) {
    wgmma_wait<kPV ? 1 : 0>();
    fence_regs(sc);
    softmax_tile<kBK, kMask>(sc, a.m_run, a.l_part, corr, w, k0, scale);
  }
  if constexpr (kPV) {
    wgmma_wait<0>();
    fence_regs(a.o);
    fence_regs(a.phi);
    fence_regs(a.plo);
    mbar_arrive(bars.empty(sp));             // K and V of tile t - 1 used
  }
  if constexpr (kQK) rescale_and_split<D>(a.o, corr, sc, a.phi, a.plo);
}

// One q tile of the grid's work: 128 query rows of one (batch x q head),
// and the key tiles [t_lo, t_lo + n_tiles) that the masks leave.
struct Work {
  int bh, kvh, q0, t_lo, n_tiles;
};

// Work item `item`, longest first: items run down the q tiles (the causal
// triangle's longest rows first), and across (batch x q head) within one,
// so CTAs resident together share kv heads in L2.
template <int kBK>
__device__ __forceinline__ Work work_of(int item, int BH, int n_q_tiles,
                                        int Hq, int G, int Sq, int Skv,
                                        int causal, int window) {
  Work k;
  k.bh = item % BH;
  k.kvh = (k.bh / Hq) * (Hq / G) + (k.bh % Hq) / G;
  k.q0 = (n_q_tiles - 1 - item / BH) * kBQ;
  const int q_last = min(k.q0 + kBQ, Sq) - 1;
  const int nk = (Skv + kBK - 1) / kBK;
  const int t_hi = causal ? min(nk, q_last / kBK + 1) : nk;
  k.t_lo = 0;              // first tile not wholly behind the window
  if (window) {
    const int64_t x = int64_t(k.q0) - window - kBK + 2;
    if (x > 0) k.t_lo = int((x + kBK - 1) / kBK);
  }
  k.n_tiles = t_hi - k.t_lo;
  return k;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int BH, int Hq, int G, int Sq, int Skv, int causal,
                      int window, float scale) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const Ring<D> bars{(smem_u32(smem_raw) + 1023) & ~1023u};
  const int n_q_tiles = (Sq + kBQ - 1) / kBQ;
  const int n_items = BH * n_q_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bars.q_full(), 1);
    mbar_init(bars.q_empty(), 2 * 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.full_k(s), 1);
      mbar_init(bars.full_v(s), 1);
      mbar_init(bars.empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Persistent: each CTA walks items blockIdx.x, + gridDim.x, ... Both
  // roles count the q tiles they load (nq) and the ring positions (r) the
  // same way, so their barrier phases agree.
  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps Q and the K/V ring loaded ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      int nq = 0, r = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Work k = work_of<kBK>(item, BH, n_q_tiles, Hq, G, Sq, Skv,
                                    causal, window);
        if (k.n_tiles <= 0) continue;
        mbar_wait(bars.q_empty(), (nq & 1) ^ 1);   // last q tile's QK done
        mbar_expect_tx(bars.q_full(), L::kQTile);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(bars.base + L::q + c * L::kQBox, &tm_q, bars.q_full(),
                   c * kBoxCols, k.q0, k.bh);
        ++nq;
        for (int i = 0; i < k.n_tiles; ++i, ++r) {
          const int s = r % kStages;
          mbar_wait(bars.empty(s), ((r / kStages) & 1) ^ 1);
          const int k0 = (k.t_lo + i) * kBK;
          mbar_expect_tx(bars.full_k(s), L::kKVTile);
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load(bars.k_tile(s) + c * L::kKBox, &tm_k, bars.full_k(s),
                     c * kBoxCols, k0, k.kvh);
          mbar_expect_tx(bars.full_v(s), L::kKVTile);
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load(bars.v_tile(s) + c * L::kKBox, &tm_v, bars.full_v(s),
                     c * kBoxCols, k0, k.kvh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const uint32_t q_rows = bars.base + L::q + cw * 64 * kRowBytes;
    int nq = 0, r = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Work k = work_of<kBK>(item, BH, n_q_tiles, Hq, G, Sq, Skv,
                                  causal, window);
      Rows w;
      w.qmin = k.q0 + cw * 64;                        // this warpgroup's rows
      w.row0 = w.qmin + (tid / 32) * 16 + lane / 4;   // and row0 + 8
      w.col0 = 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qp = w.row0 + 8 * h;
        w.hi[h] = causal ? min(qp, Skv - 1) : Skv - 1;
        w.lo[h] = window ? qp - window + 1 : 0;
      }
      Acc<D> a;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) a.o[i] = 0.f;
      a.m_run[0] = a.m_run[1] = kNegInf;
      a.l_part[0] = a.l_part[1] = 0.f;      // this thread's share of l
      if (k.n_tiles > 0) {
        // Tiles this warpgroup must mask: the first ones while the window
        // cuts them (t < t_front), and from t_back on, where the causal
        // triangle or Skv cuts them.
        int t_front = 0;
        if (window && w.qmin + 63 - window >= 0)
          t_front = (w.qmin + 63 - window) / kBK + 1;
        int t_back = Skv / kBK;
        if (causal) t_back = min(t_back, (w.qmin + 1) / kBK);
        auto masked = [&](int t) {
          return k.t_lo + t < t_front || k.t_lo + t >= t_back;
        };
        // turn t: QK^T of tile t (t < n_tiles) and PV of tile t - 1
        // (t > 0); warpgroup 0 goes first, and every turn but warpgroup
        // 1's last hands over, so both named barriers end balanced
        if (cw == 1) turn_pass(1);
        mbar_wait(bars.q_full(), nq & 1);
        ++nq;
        if (masked(0))
          consumer_turn<D, true, false, true>(a, bars, w, cw, r,
                                              k.t_lo * kBK, q_rows, scale);
        else
          consumer_turn<D, true, false, false>(a, bars, w, cw, r,
                                               k.t_lo * kBK, q_rows, scale);
        for (int t = 1; t < k.n_tiles; ++t) {
          const int k0 = (k.t_lo + t) * kBK;
          if (masked(t))
            consumer_turn<D, true, true, true>(a, bars, w, cw, r + t, k0,
                                               q_rows, scale);
          else
            consumer_turn<D, true, true, false>(a, bars, w, cw, r + t, k0,
                                                q_rows, scale);
        }
        mbar_arrive(bars.q_empty());           // this q tile's QK^T done
        consumer_turn<D, false, true, false>(a, bars, w, cw, r + k.n_tiles,
                                             0, q_rows, scale);
        if (cw == 0) turn_pass(0);
        r += k.n_tiles;
      }

      // epilogue: out = acc / max(l, 1e-30) in bf16, lse in fp32
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = a.l_part[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const int qp = w.row0 + 8 * h;
        if (qp < Sq) {
          bf16* orow = out + (int64_t(k.bh) * Sq + qp) * D + w.col0;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
                __floats2bfloat162_rn(a.o[4 * j + 2 * h] * inv,
                                      a.o[4 * j + 2 * h + 1] * inv);
          if (lane % 4 == 0)
            lse[int64_t(k.bh) * Sq + qp] =
                l > 0.f ? a.m_run[h] + logf(fmaxf(l, 1e-30f)) : -CUDART_INF_F;
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           long long B, long long Hq, long long Hkv, long long Sq,
           long long Skv, int causal, long long window, float scale,
           cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!bf16_rows_map(encode, &mq, q, Sq, B * Hq, D, kBQ) ||
      !bf16_rows_map(encode, &mk, k, Skv, B * Hkv, D, Tile<D>::kBK) ||
      !bf16_rows_map(encode, &mv, v, Skv, B * Hkv, D, Tile<D>::kBK))
    return int(cudaErrorInvalidValue);
  auto* fn = &flash_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::alloc);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  // persistent: one CTA per SM (or per q tile, if fewer)
  const long long items = B * Hq * ((Sq + kBQ - 1) / kBQ);
  const unsigned grid = unsigned(items < sms ? items : sms);
  fn<<<grid, kThreads, Smem<D>::alloc, st>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse),
      int(B * Hq), int(Hq), int(Hq / Hkv), int(Sq), int(Skv), causal,
      int(window), scale);
  return int(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v with dk = dv = d in {64, 128, 256}; pointers 16-byte
// aligned.
extern "C" int repro_flash_fwd_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    long long B, long long Hq, long long Hkv,
                                    long long Sq, long long Skv, long long d,
                                    int causal, long long window, float scale,
                                    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || window < 0 || Sq > 0x7fffffffLL - kBQ ||
      Skv > 0x7fffffffLL - kMaxBK ||
      B * Hq * ((Sq + kBQ - 1) / kBQ) > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  if (window >= Sq) window = 0;         // masks nothing any row could see
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal, window,
                      scale, st);
  if (d == 128)
    return launch<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal,
                       window, scale, st);
  if (d == 256)
    return launch<256>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv, causal,
                       window, scale, st);
  return int(cudaErrorInvalidValue);
}
