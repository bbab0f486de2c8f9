// Hand-written flash-attention forward for fp32 inputs on Hopper's tensor
// cores (sm_90a), as a 3xTF32 split.
//
// flash_fwd_f32_sm90_kernel — replaces the Pallas TPU kernel
//   `flash_attention_fwd` (src/repro/kernels/flash_attention.py, body
//   `_flash_fwd_kernel`) for fp32 inputs; bf16 inputs take
//   flash_fwd_sm90_kernel (flash_fwd_sm90.cu). For q (B, Hq, Sq, d),
//   k (B, Hkv, Skv, d), v (B, Hkv, Skv, d), d in {64, 128, 256}, q head h
//   reading kv head h / (Hq / Hkv):
//     out = softmax(mask(q k^T * d^-0.5)) v   in fp32, and
//     lse = log-sum-exp of each masked score row, -inf where the whole row
//           is masked,
//   under a causal mask (key <= query) and/or a sliding window
//   (query - key < window). The arithmetic is the Pallas kernel's: masked
//   scores are -1e30 and contribute p = 0, the running-max correction is 0
//   while the running max is still -1e30, out = acc / max(l, 1e-30) and
//   lse = m + log(l) where l > 0. Key tiles that the causal triangle or
//   the window masks whole are skipped (the Pallas kernel's `pl.when`).
//
//   Bound on the H100: operations. fp32 accuracy (2e-5 on out, 1e-4 on
//   lse against the fp32 plain version) needs three TF32 products per
//   product: each operand x is split into hi = tf32_rna(x) and
//   lo = tf32_rna(x - hi) (round to nearest, ties away from zero, as
//   cvt.rna.tf32.f32 rounds), and hi*hi + hi*lo + lo*hi accumulate in fp32
//   (lo*lo, about 2^-22 of the product, is dropped). One TF32 product
//   alone misses the tolerances tenfold. The least time is therefore the
//   function's operations x 3 at the dense TF32 rate (495 TFLOP/s), about
//   165 TFLOP/s of fp32 attention.
//
//   Why mma.sync and not wgmma: wgmma's TF32 form reads B only K-major
//   from shared memory (the transpose bits exist for f16 / bf16 only), so
//   K_lo, a transposed V and V_lo would all have to sit in shared memory
//   beside Q and Q_lo. At d = 256 that is 128 KiB for Q and Q_lo (64 rows)
//   plus 64 KiB each for K, K_lo and V^T, V^T_lo (32-key tiles): 256 KiB
//   before a second stage, over the 227 KB a block may use. mma.sync
//   (m16n8k8, tf32 in, fp32 accumulate) takes both operands from registers,
//   so shared memory holds raw fp32 tiles only and every thread splits the
//   fragments it loads.
//
//   Design:
//   - Tiles. A CTA holds 64 query rows of one (batch x q head) in 4 groups
//     of 16 rows. Key tiles are 32 keys. The grid is one CTA per (q tile,
//     batch x q head), issued last q tile first, so the causal triangle's
//     longest rows start first; neighbouring CTAs are neighbouring q heads
//     and share a kv head in L2.
//   - Warps (`kParts`). At d = 64 and 128 one warp owns a row group (4 warps;
//     at d = 128 two CTAs fit an SM). At d = 256 shared memory allows one
//     CTA per SM, so two warps share each row group (8 warps): each takes
//     half of d in S = Q K^T and half of O's columns in P V; they add each
//     other's partial S through the K tile, which every warp is done with
//     by then (two __syncthreads), and both run the same softmax
//     (a + b == b + a). `tools/flash_f32_bench.py --ablate` times the
//     other choice at each of the two head dims (`one_warp`, `two_warps`).
//   - Registers hold the state. S (16 x 32 a row group: 16 floats a thread,
//     the hi*hi product and the two cross products in separate
//     accumulators, 8 independent MMA chains), P, the running max and the
//     per-thread partial sum (reduced over the quad once, at the end), and
//     the O accumulator (16 x d: d / 2 floats a thread, 64 at d = 128 and
//     at d = 256 with two warps). Q fragments are re-read from shared
//     memory on every key tile and split there; Q_hi and Q_lo kept
//     resident would not fit.
//   - Contraction orders chosen for 128-bit fragment loads. Both products
//     contract over an index whose order is free, and the output column
//     order is the kernel's own:
//       S = Q K^T: in each 16-wide slice of d, lane (g, t) (g = lane / 4,
//       t = lane % 4) loads d = 4t .. 4t+3 of its rows as one float4; k
//       step s of m16n8k8 takes k index t <- d 4t+2s and t+4 <- 4t+2s+1,
//       in Q's A fragment and K's B fragment alike.
//       P V: the m16n8 accumulator gives a thread keys (2t, 2t+1) of each
//       8-key group, and m16n8k8's A fragment wants k (t, t+4): k index t
//       is taken to be key 2t and t+4 key 2t+1, and the B fragment reads
//       V's rows in the same order. So P feeds PV from registers with no
//       shuffle. In each 32-column slice of V, n-block j's column g is V
//       column 4g + j, so a lane loads 4 columns as one float4 for 4
//       n-blocks, and its accumulator holds columns 8t .. 8t+7 of its rows:
//       the epilogue stores two float4s per row and slice.
//   - Shared memory: Q (64 rows) and a 2-stage ring of K and V tiles,
//     filled by 16-byte cp.async.cg (rows past Sq or Skv zero-filled); tile
//     t + 1 lands while tile t is multiplied. Rows are padded so that the
//     fragment loads fall on distinct banks in each quarter warp: Q and K
//     rows by 16 floats (stride = 16 mod 32), V rows by 4 (stride = 4 mod
//     32). At d = 256: Q 69,632 + 2 x (K 34,816 + V 33,280) = 205,824 bytes,
//     one CTA per SM; d = 128 takes 107,520 (two CTAs per SM) and d = 64
//     58,368 (three).
//   - Masks. A tile that every row of the CTA sees whole (inside Skv, under
//     the causal diagonal, inside the window) skips the per-score mask.
//
//   What limits it (`tools/flash_f32_bench.py --peak --ablate` on an H100
//   80GB HBM3 at 700 W): mma.sync reaches 0.65 of the dense TF32 rate
//   there (323 TFLOP/s), so three products cap fp32 attention at about
//   108 TFLOP/s; with a third of the MMAs the kernel takes 0.56-0.61 of
//   its time, without the split's instructions 0.88-0.91, without the
//   softmax 0.90-0.92. Issue slots are the limit: in the loop's SASS at
//   d = 128 each MMA comes with about six other instructions, most of
//   them the split's four per operand value, which every warp repeats
//   for the K and V fragments it reads.
//
// The kernel launches on the caller's stream, allocates nothing, and its C
// entry point returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per CTA, 16 a warp
constexpr int kBK = 32;                 // keys per tile
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Warps that share each 16-row group, by head dim; each takes D / kParts
// of the score's contraction and of O's columns.
template <int D>
constexpr int kParts = D == 256 ? 2 : 1;

template <int D>
struct Layout {
  static constexpr int LDQK = D + 16;   // Q and K row stride, 16 mod 32
  static constexpr int LDV = D + 4;     // V row stride, 4 mod 32
  static constexpr int kQ = kBQ * LDQK;             // floats
  static constexpr int kK = kBK * LDQK;
  static constexpr int kStage = kK + kBK * LDV;
  static constexpr size_t bytes = size_t(kQ + kStages * kStage) * 4;
};

// rows [row0, row0 + ROWS) of a (rows, D) fp32 matrix into shared memory
// with row stride LD, by 16-byte cp.async; rows at or past `rows` are
// zero-filled (source size 0)
template <int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t row0, int64_t rows) {
  constexpr int kVecPerRow = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += THREADS) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    const bool in = row0 + r < rows;
    const float* from = in ? src + (row0 + r) * D + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::
                     "r"(smem_u32(dst + r * LD + c)), "l"(from),
                 "r"(in ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x rounded to the nearest TF32 value, ties away from zero: what
// cvt.rna.tf32.f32 gives for finite x, in two integer instructions (ptxas
// expands the cvt to four, with a range check and a select)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 22 significant bits, each part a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b, m16n8k8, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(128 * kParts<D>, 1)
flash_fwd_f32_sm90_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ out, float* __restrict__ lse,
                          int Hq, int G, int64_t BH, int64_t nq, int64_t Sq,
                          int64_t Skv, int causal, int64_t window,
                          float scale) {
  using L = Layout<D>;
  constexpr int P = kParts<D>;
  constexpr int kThreads = 128 * P;
  constexpr int kDP = D / P;            // d columns a warp takes
  constexpr int kSlices = kDP / 32;     // 32-column slices of V and O
  static_assert(P == 1 || (P == 2 && 8 * 512 <= L::kK),
                "two warps per row group trade their partial scores "
                "through the K tile");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = smem + L::kQ;

  const int64_t bh = blockIdx.x % BH;
  const int64_t q0 = (nq - 1 - int64_t(blockIdx.x) / BH) * kBQ;
  const int64_t kvh = (bh / Hq) * (Hq / G) + (bh % Hq) / G;
  const float* qh = q + bh * Sq * D;
  const float* kh = k + kvh * Skv * D;
  const float* vh = v + kvh * Skv * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rows16 = (warp & 3) * 16;   // the warp's 16 rows of the tile
  const int dp0 = (warp >> 2) * kDP;    // and its share of d
  // this thread's two query rows: g and g + 8 of its warp's 16
  const int64_t row[2] = {q0 + rows16 + g, q0 + rows16 + g + 8};
  const int64_t q_last = (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;

  // live key tiles [t_lo, t_hi]
  int64_t t_lo = 0;
  int64_t t_hi = (Skv - 1) / kBK;
  if (causal && q_last / kBK < t_hi) t_hi = q_last / kBK;
  if (window && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / kBK;

  float o[kSlices][4][4];
#pragma unroll
  for (int c = 0; c < kSlices; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][j][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};          // this thread's part of the sum

  if (t_lo <= t_hi) {
    load_rows<kBQ, D, L::LDQK, kThreads>(Qs, qh, q0, Sq);
    load_rows<kBK, D, L::LDQK, kThreads>(ring, kh, t_lo * kBK, Skv);
    load_rows<kBK, D, L::LDV, kThreads>(ring + L::kK, vh, t_lo * kBK, Skv);
    cp_async_commit();
  }
  const float* Qw = Qs + rows16 * L::LDQK + dp0;

  for (int64_t kt = t_lo; kt <= t_hi; ++kt) {
    const int64_t k0 = kt * kBK;
    float* Ks = ring + ((kt - t_lo) & 1) * L::kStage;
    const float* Vs = Ks + L::kK;
    if (kt < t_hi) {                    // tile kt + 1 into the other stage
      float* next = ring + ((kt + 1 - t_lo) & 1) * L::kStage;
      load_rows<kBK, D, L::LDQK, kThreads>(next, kh, k0 + kBK, Skv);
      load_rows<kBK, D, L::LDV, kThreads>(next + L::kK, vh, k0 + kBK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: hi*hi in s_hi, hi*lo + lo*hi in s_lo
    float s_hi[4][4], s_lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_hi[j][e] = s_lo[j][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < kDP; d0 += 16) {
      const float4 qa =
          *reinterpret_cast<const float4*>(Qw + g * L::LDQK + d0 + 4 * t);
      const float4 qb = *reinterpret_cast<const float4*>(
          Qw + (g + 8) * L::LDQK + d0 + 4 * t);
      uint32_t ah[2][4], al[2][4];
      split(qa.x, ah[0][0], al[0][0]);
      split(qb.x, ah[0][1], al[0][1]);
      split(qa.y, ah[0][2], al[0][2]);
      split(qb.y, ah[0][3], al[0][3]);
      split(qa.z, ah[1][0], al[1][0]);
      split(qb.z, ah[1][1], al[1][1]);
      split(qa.w, ah[1][2], al[1][2]);
      split(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + (8 * j + g) * L::LDQK + dp0 + d0 + 4 * t);
        uint32_t bh[4], bl[4];
        split(kv.x, bh[0], bl[0]);
        split(kv.y, bh[1], bl[1]);
        split(kv.z, bh[2], bl[2]);
        split(kv.w, bh[3], bl[3]);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          mma(s_hi[j], ah[s], bh[2 * s], bh[2 * s + 1]);
          mma(s_lo[j], ah[s], bl[2 * s], bl[2 * s + 1]);
          mma(s_lo[j], al[s], bh[2 * s], bh[2 * s + 1]);
        }
      }
    }

    float p[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = s_hi[j][e] + s_lo[j][e];
    if constexpr (P == 2) {
      // the two warps of a row group add each other's partial scores,
      // through the K tile that every warp is done with; a + b == b + a,
      // so both hold the same S and run the same softmax
      __syncthreads();
      float* x = Ks + lane;
#pragma unroll
      for (int i = 0; i < 16; ++i) x[(warp * 16 + i) * 32] = p[i / 4][i % 4];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 16; ++i)
        p[i / 4][i % 4] += x[((warp ^ 4) * 16 + i) * 32];
    }

    // online softmax on the fragment: element e of n-block j is row
    // row[e / 2], key k0 + 8j + 2t + e % 2
    const bool whole = k0 + kBK <= Skv &&
                       (!causal || k0 + kBK - 1 <= q0) &&
                       (!window || q_last - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = p[j][e] * scale;
        if (!whole) {
          const int64_t qp = row[e >> 1];
          const int64_t kp = k0 + 8 * j + 2 * t + (e & 1);
          const bool keep = kp < Skv && (!causal || qp >= kp) &&
                            (!window || qp - kp < window);
          s = keep ? s : kNegInf;
        }
        p[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = m_run[r] <= kNegInf / 2 ? 0.f : expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = p[j][e];
        p[j][e] = s <= kNegInf / 2 ? 0.f : expf(s - m_run[e >> 1]);
        l_run[e >> 1] += p[j][e];
      }
#pragma unroll
    for (int c = 0; c < kSlices; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][j][e] *= corr[e >> 1];

    // O += P V: k step kk is the 8 keys of S's n-block kk, k index t being
    // key 2t and t + 4 key 2t + 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split(p[kk][0], ph[0], pl[0]);
      split(p[kk][2], ph[1], pl[1]);
      split(p[kk][1], ph[2], pl[2]);
      split(p[kk][3], ph[3], pl[3]);
      const float* v0 = Vs + (8 * kk + 2 * t) * L::LDV + dp0 + 4 * g;
#pragma unroll
      for (int c = 0; c < kSlices; ++c) {
        const float4 va = *reinterpret_cast<const float4*>(v0 + 32 * c);
        const float4 vb =
            *reinterpret_cast<const float4*>(v0 + L::LDV + 32 * c);
        const float x0[4] = {va.x, va.y, va.z, va.w};
        const float x1[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split(x0[j], bh0, bl0);
          split(x1[j], bh1, bl1);
          mma(o[c][j], ph, bh0, bh1);
          mma(o[c][j], ph, bl0, bl1);
          mma(o[c][j], pl, bh0, bh1);
        }
      }
    }
    __syncthreads();                    // the stage is free to refill
  }

  // epilogue: element e of o[c][j] is row row[e / 2], column
  // dp0 + 32c + 8t + 4(e % 2) + j
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (row[r] >= Sq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    const float inv = 1.f / l;
    float* orow = out + (bh * Sq + row[r]) * D + dp0 + 8 * t;
#pragma unroll
    for (int c = 0; c < kSlices; ++c) {
      const int e = 2 * r;
      *reinterpret_cast<float4*>(orow + 32 * c) =
          make_float4(o[c][0][e] * inv, o[c][1][e] * inv,
                      o[c][2][e] * inv, o[c][3][e] * inv);
      *reinterpret_cast<float4*>(orow + 32 * c + 4) =
          make_float4(o[c][0][e + 1] * inv, o[c][1][e + 1] * inv,
                      o[c][2][e + 1] * inv, o[c][3][e + 1] * inv);
    }
    if (t == 0 && dp0 == 0)
      lse[bh * Sq + row[r]] = l_run[r] > 0.f ? m_run[r] + logf(l)
                                             : -__int_as_float(0x7f800000);
  }
}

template <int D>
int launch_flash_f32(const void* q, const void* k, const void* v, void* out,
                     void* lse, long long B, long long Hq, long long Hkv,
                     long long Sq, long long Skv, int causal,
                     long long window, float scale, cudaStream_t st) {
  using L = Layout<D>;
  auto* fn = &flash_fwd_f32_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return int(err);
  const long long nq = (Sq + kBQ - 1) / kBQ;
  fn<<<unsigned(nq * B * Hq), 128 * kParts<D>, L::bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), int(Hq), int(Hq / Hkv), B * Hq, nq, Sq, Skv,
      causal, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// fp32 q, k, v with dk = dv = d in {64, 128, 256}.
extern "C" int repro_flash_fwd_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   long long B, long long Hq, long long Hkv,
                                   long long Sq, long long Skv, long long d,
                                   int causal, long long window, float scale,
                                   void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || window < 0 || Hq > 0x7fffffffLL ||
      B * Hq * ((Sq + kBQ - 1) / kBQ) > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  if (window >= Sq) window = 0;         // masks nothing any row could see
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_flash_f32<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv,
                                causal, window, scale, st);
  if (d == 128)
    return launch_flash_f32<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv,
                                 causal, window, scale, st);
  if (d == 256)
    return launch_flash_f32<256>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv,
                                 causal, window, scale, st);
  return int(cudaErrorInvalidValue);
}
