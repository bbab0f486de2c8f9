// Hand-written Hopper (sm_90a) split-KV flash-attention decode for bf16.
//
// flash_decode_sm90_kernel + flash_decode_combine_kernel — replace the
//   Pallas TPU kernel `flash_attention_fwd`
//   (src/repro/kernels/flash_attention.py:116, body `_flash_fwd_kernel`)
//   for bf16 calls with few query rows per kv head:
//   G x Sq <= 16, G = Hq / Hkv (a decode step: llama-3.2-vision's
//   cross-attention at Sq = 1). Calls with more rows take
//   flash_fwd_sm90_kernel (flash_fwd_sm90.cu).
//   For q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, d),
//   d in {64, 128, 256}, q head h reading kv head h / G:
//     out = softmax(mask(q k^T * d^-0.5)) v   in bf16, and
//     lse = log-sum-exp of each masked score row in fp32, -inf where the
//           whole row is masked,
//   under a causal mask (key <= query) and/or a sliding window
//   (query - key < window), with the Pallas kernel's arithmetic: masked
//   scores contribute p = 0, the running-max correction is 0 while the
//   running max is still -1e30, out = acc / max(l, 1e-30) and
//   lse = m + log(l) where l > 0.
//
//   Bound on the H100: bytes. At the vision decode shape (B=4, Hq=32,
//   Hkv=8, Sq=1, Skv=6404, d=128) K and V are 104.9 MB and the function
//   needs 0.42 GFLOP (4 operations a byte; bf16 tensor cores bind above
//   ~295), so the design is about reading K and V once, with enough bytes
//   in flight, and about the fixed cost of a launch, not the tensor cores:
//
//   - Grid: (B x Hkv) x n_split CTAs. A CTA owns one kv head and one slice
//     of its keys, a whole number of 64-key tiles (the last slice ends at
//     Skv). Its rows are the G x Sq queries of the G q heads that read that
//     kv head, which lie next to each other in q (row r = g * Sq + i), so
//     K and V are read once for all of them: one m16 tile of rows, rows
//     past G x Sq zero. n_split is the caller's (the Python wrapper's
//     `decode_splits`: as many slices as give each SM one CTA, a pure
//     function of B x Hkv, Skv and the SM count).
//   - Memory pipeline: 4 warps and a ring of 3 stages of K and V tiles,
//     filled by TMA (one thread issues the boxes; each stage completes on
//     its own mbarrier): 64 keys x 64 dims a box in the 128-byte swizzle,
//     which `ldmatrix` reads without bank conflicts. At d = 128 a stage is
//     32 KB and a CTA 104,448 B: two tiles (64 KB) in flight per CTA. Two
//     CTAs fit an SM, but one an SM ran faster at the vision shape, and
//     deeper rings did not (tools/flash_decode_bench.py, PERF.md §6). The
//     tensor maps are per head (d, Skv, B x Hkv), so
//     key rows past Skv arrive as zeros; they are masked to p = 0. Q (16
//     rows, padded) comes by `cp.async`.
//   - Arithmetic: each warp takes 16 keys of a tile and keeps its own
//     running (m, l, acc) over them. S = Q K^T by `mma.sync` m16n8k16 in
//     bf16 with an fp32 accumulator (q, k bf16: their products are exact
//     in fp32, as the Pallas kernel's fp32 dot). P enters PV at fp32
//     precision as there: P is split into P_hi = bf16(P) and P_lo =
//     bf16(P - P_hi), two `mma.sync` products into the same accumulator.
//     The S accumulator fragment is the P operand's fragment, so P never
//     leaves registers.
//   - Partials: the 4 warps' (m, l, acc) are merged in shared memory and
//     each CTA writes its rows' unnormalised fp32 acc, m and l to the
//     caller's workspace; a slice no row sees (past the causal triangle,
//     or empty) writes m = -1e30, l = 0, acc = 0.
//   - Combine: flash_decode_combine_kernel, one CTA a (batch x kv head,
//     row; n_split <= 8192), merges the slices: M = max_j m_j,
//     l = sum_j l_j e^(m_j - M), out = sum_j acc_j e^(m_j - M) /
//     max(l, 1e-30) in bf16, lse = M + log(l) where l > 0, else -inf (and
//     out = 0). (Merging in the last CTA of each kv head instead, through
//     a counter, saved nothing measurable at the vision shape and left one
//     CTA to read every slice's partials, which was slower at 62 slices
//     of 16 rows at d = 256: PERF.md §6.)
//
// Both kernels launch on the caller's stream and allocate nothing; the C
// entry point returns a CUDA error code so the Python wrapper can raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;                   // query rows of a CTA: one m16
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 16 * kWarps;            // keys a tile: 16 a warp
constexpr int kCombineThreads = 128;
constexpr int kMaxSplits = 8192;            // the combine's weights: 32 KB
constexpr float kNegInf = -1e30f;

// Shared memory for head dim D, from a 1024-byte aligned base: the ring's
// barriers, Q (16 rows padded by 16 bytes, so `ldmatrix` reads them
// without bank conflicts), then the K/V ring: a tile of K or V is D / 64
// TMA boxes of 64 keys x 128 bytes in the 128-byte swizzle. After the key
// loop the ring holds the warps' partials for the CTA's merge.
template <int D>
struct Dec {
  static constexpr int kStride = 2 * D + 16;          // bytes a Q row
  static constexpr int kStages = 3;
  static constexpr int kBox = kBK * 128;              // 64 keys x 64 dims
  static constexpr int kTile = (D / 64) * kBox;       // K or V of a tile
  static constexpr int q = 64;                        // after the barriers
  static constexpr int ring = (q + kRows * kStride + 1023) / 1024 * 1024;
  static constexpr int alloc = ring + kStages * 2 * kTile + 1024;
  static constexpr int kParts = kWarps * kRows * (D + 2) * 4;
  static_assert(kParts <= kStages * 2 * kTile, "partials fit the ring");
  static_assert(alloc <= 232448, "shared memory of one block");
};

// Byte offset of 16-byte chunk c (8 bf16 columns) of key `row` in a K or
// V tile: box c / 8, the chunk's slot swizzled by the row (128B swizzle)
__device__ __forceinline__ uint32_t swz(int row, int c) {
  return (c / 8) * (kBK * 128) + row * 128 + (((c % 8) ^ (row % 8)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c += a (16 x 16, row-major) b (16 x 8, column-major), bf16 in, fp32 sum
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p0, p1 as bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - __low2float(h),
                                    p1 - __high2float(h)));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_sm90_kernel(__grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         const bf16* __restrict__ q,
                         float* __restrict__ part_o,
                         float* __restrict__ part_ml, int R, int Sq, int Skv,
                         int k_live, int n_split, int per_split, int causal,
                         int window, float scale) {
  using L = Dec<D>;
  constexpr int kStages = L::kStages, kStride = L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const int bh = blockIdx.x / n_split, split = blockIdx.x % n_split;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t_begin = split * per_split;
  const int t_end = min(t_begin + per_split, (k_live + kBK - 1) / kBK);
  const int nt = max(t_end - t_begin, 0);
  auto full = [&](int s) { return base + 8 * s; };   // the stage's barrier
  auto k_tile = [&](int s) { return base + L::ring + s * 2 * L::kTile; };
  auto v_tile = [&](int s) { return k_tile(s) + L::kTile; };
  // one thread puts tile i of the slice (K and V: 2 x D / 64 boxes) on
  // the way into stage s; the box rows past Skv arrive as zeros
  auto issue = [&](int i, int s) {
    mbar_expect_tx(full(s), 2 * L::kTile);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load(k_tile(s) + c * L::kBox, &tm_k, full(s), 64 * c,
               (t_begin + i) * kBK, bh);
      tma_load(v_tile(s) + c * L::kBox, &tm_v, full(s), 64 * c,
               (t_begin + i) * kBK, bh);
    }
  };

  if (threadIdx.x == 0) {        // the ring's barriers, and its first tiles
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kStages - 1 && i < nt; ++i) issue(i, i);
  }
  // Q (rows past R zero) by cp.async, while the first tiles' TMA runs
#pragma unroll
  for (int it = 0; it < kRows * (D / 8) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < R;
    cp_async16(base + L::q + r * kStride + c * 16,
               q + (int64_t(bh) * R + (ok ? r : 0)) * D + c * 8, ok ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();                            // Q and the barriers, for all

  // this thread's fragment: rows r0 and r0 + 8, two keys of each 8
  const int r0 = lane / 4;
  const int qp[2] = {r0 % Sq, (r0 + 8) % Sq};        // query positions
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};                      // this thread's share

  for (int t = 0; t < nt; ++t) {
    if (t > 0) __syncthreads();               // every warp is done with t - 1
    if (threadIdx.x == 0 && t + kStages - 1 < nt)   // ... so refill its stage
      issue(t + kStages - 1, (t + kStages - 1) % kStages);
    const int s = t % kStages;
    mbar_wait(full(s), (t / kStages) & 1);    // tile t has landed
    const uint32_t kt = k_tile(s), vt = v_tile(s);
    const int krow = warp * 16 + (lane % 8);  // this lane's ldmatrix rows

    // S = Q K^T over this warp's 16 keys: two n8 fragments
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, base + L::q + (lane % 16) * kStride +
                     (kk * 16 + 8 * (lane / 16)) * 2);
      ldsm_x4(b, kt + swz(krow + 8 * (lane / 16), 2 * kk + (lane / 8) % 2));
      mma_bf16(sc[0], a, b[0], b[1]);
      mma_bf16(sc[1], a, b[2], b[3]);
    }

    // scale, mask, running max (the Pallas kernel's order)
    const int kw = (t_begin + t) * kBK + warp * 16 + 2 * (lane % 4);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw + 8 * j + (e & 1), h = e / 2;
        bool keep = key < Skv;
        if (causal) keep = keep && key <= qp[h];
        if (window) keep = keep && qp[h] - key < window;
        const float x = keep ? sc[j][e] * scale : kNegInf;
        sc[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = m_run[h] <= kNegInf / 2 ? 0.f : __expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_part[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float x = sc[j][e];
        const float p = x <= kNegInf / 2 ? 0.f : __expf(x - m_run[h]);
        sc[j][e] = p;
        l_part[h] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: the S fragments are P's A fragment (keys 0-7, then 8-15)
    uint32_t phi[4], plo[4];
    split_pair(sc[0][0], sc[0][1], phi[0], plo[0]);
    split_pair(sc[0][2], sc[0][3], phi[1], plo[1]);
    split_pair(sc[1][0], sc[1][1], phi[2], plo[2]);
    split_pair(sc[1][2], sc[1][3], phi[3], plo[3]);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      ldsm_x4_t(b, vt + swz(krow + 8 * ((lane / 8) % 2), 2 * n2 + lane / 16));
      mma_bf16(o[2 * n2], phi, b[0], b[1]);
      mma_bf16(o[2 * n2], plo, b[0], b[1]);
      mma_bf16(o[2 * n2 + 1], phi, b[2], b[3]);
      mma_bf16(o[2 * n2 + 1], plo, b[2], b[3]);
    }
  }
  __syncthreads();                            // the ring is free

  // merge the warps in shared memory: acc [warp][row][D], then m, l
  float* po = reinterpret_cast<float*>(smem + L::ring);
  float* pm = po + kWarps * kRows * D;
  float* pl = pm + kWarps * kRows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_part[h] += __shfl_xor_sync(0xffffffffu, l_part[h], 1);
    l_part[h] += __shfl_xor_sync(0xffffffffu, l_part[h], 2);
    const int row = warp * kRows + r0 + 8 * h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(po + row * D + 8 * n + 2 * (lane % 4)) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (lane % 4 == 0) {
      pm[row] = m_run[h];
      pl[row] = l_part[h];
    }
  }
  __syncthreads();
  const int64_t slot = int64_t(blockIdx.x) * R;       // this CTA's rows
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, pm[w * kRows + r]);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float m = pm[w * kRows + r];
      if (m > kNegInf / 2) acc += po[(w * kRows + r) * D + d] * __expf(m - M);
    }
    part_o[(slot + r) * D + d] = acc;
    if (d == 0) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float m = pm[w * kRows + r];
        if (m > kNegInf / 2) l += pl[w * kRows + r] * __expf(m - M);
      }
      part_ml[2 * (slot + r)] = M;
      part_ml[2 * (slot + r) + 1] = l;
    }
  }

}

// Sum (or max) over the CTA's threads; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o; o /= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                          // red is free again
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w)
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// One (batch x kv head, row) a CTA: the slices' (acc, m, l) merged into
// out (bf16) and lse (fp32). The slices' weights e^(m_j - M) are computed
// once, by the threads in parallel, into shared memory (n_split floats,
// dynamic), so the sum over slices is independent loads.
template <int D>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ part_o,
                            const float* __restrict__ part_ml,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int R, int n_split) {
  extern __shared__ float wgt[];
  __shared__ float red[kCombineThreads / 32];
  const int bh = blockIdx.x / R, r = blockIdx.x % R;
  const int64_t first = int64_t(bh) * n_split * R + r;   // slice j: + j R
  float M = kNegInf;
  for (int j = threadIdx.x; j < n_split; j += kCombineThreads)
    M = fmaxf(M, part_ml[2 * (first + int64_t(j) * R)]);
  M = block_reduce<true>(M, red);
  float l = 0.f;
  for (int j = threadIdx.x; j < n_split; j += kCombineThreads) {
    const float m = part_ml[2 * (first + int64_t(j) * R)];
    const float w = m > kNegInf / 2 ? __expf(m - M) : 0.f;
    wgt[j] = w;
    l += part_ml[2 * (first + int64_t(j) * R) + 1] * w;
  }
  l = block_reduce<false>(l, red);            // also orders the wgt writes
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_split; ++j)
      acc += part_o[(first + int64_t(j) * R) * D + d] * wgt[j];
    out[(int64_t(bh) * R + r) * D + d] = __float2bfloat16_rn(acc * inv);
  }
  if (threadIdx.x == 0)
    lse[int64_t(bh) * R + r] =
        l > 0.f ? M + logf(fmaxf(l, 1e-30f)) : -CUDART_INF_F;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           long long BH, int R, int Sq, int Skv, int causal, int window,
           float scale, void* part_o, void* part_ml, int n_split,
           cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap mk, mv;
  if (!bf16_rows_map(encode, &mk, k, Skv, BH, D, kBK) ||
      !bf16_rows_map(encode, &mv, v, Skv, BH, D, kBK))
    return int(cudaErrorInvalidValue);
  auto* fn = &flash_decode_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Dec<D>::alloc);
  if (err != cudaSuccess) return int(err);
  const int n_tiles = (Skv + kBK - 1) / kBK;
  const int per_split = (n_tiles + n_split - 1) / n_split;
  const int k_live = causal ? (Sq < Skv ? Sq : Skv) : Skv;
  fn<<<unsigned(BH * n_split), kThreads, Dec<D>::alloc, st>>>(
      mk, mv, static_cast<const bf16*>(q), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), R, Sq, Skv, k_live, n_split, per_split,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_decode_combine_kernel<D>
      <<<unsigned(BH * R), kCombineThreads, n_split * 4, st>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), static_cast<float*>(lse), R, n_split);
  return int(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v with dk = dv = d in {64, 128, 256} and (Hq / Hkv) x Sq <=
// 16 rows; pointers 16-byte aligned; n_split <= 8192. part_o holds B x
// Hkv x n_split x rows x d fp32, part_ml B x Hkv x n_split x rows x 2
// fp32 (m, l).
extern "C" int repro_flash_decode_bf16(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       long long B, long long Hq,
                                       long long Hkv, long long Sq,
                                       long long Skv, long long d, int causal,
                                       long long window, float scale,
                                       void* part_o, void* part_ml,
                                       long long n_split, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || window < 0 || (Hq / Hkv) * Sq > kRows || n_split <= 0 ||
      n_split > kMaxSplits ||
      Skv > 0x7fffffffLL - kBK || B * Hkv * n_split > 0x7fffffffLL ||
      B * Hkv * (Hq / Hkv) * Sq > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  if (window >= Sq) window = 0;         // masks nothing any row could see
  const int R = int((Hq / Hkv) * Sq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, out, lse, B * Hkv, R, int(Sq), int(Skv),
                      causal, int(window), scale, part_o, part_ml,
                      int(n_split), st);
  if (d == 128)
    return launch<128>(q, k, v, out, lse, B * Hkv, R, int(Sq), int(Skv),
                       causal, int(window), scale, part_o, part_ml,
                       int(n_split), st);
  if (d == 256)
    return launch<256>(q, k, v, out, lse, B * Hkv, R, int(Sq), int(Skv),
                       causal, int(window), scale, part_o, part_ml,
                       int(n_split), st);
  return int(cudaErrorInvalidValue);
}
