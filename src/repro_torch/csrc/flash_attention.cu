// Hand-written Hopper (sm_90a) flash-attention forward.
//
// flash_fwd_kernel — replaces the Pallas TPU kernel `flash_attention_fwd`
//   (src/repro/kernels/flash_attention.py, body `_flash_fwd_kernel`).
//   Computes, for q (B, Hq, Sq, dk), k (B, Hkv, Skv, dk), v (B, Hkv, Skv, dv)
//   with q head h reading kv head h / (Hq / Hkv):
//     out = softmax(mask(q k^T * dk^-0.5)) v   in q's dtype, and
//     lse = log-sum-exp of each masked score row in fp32, -inf where the
//           whole row is masked,
//   under a causal mask (key <= query) and/or a sliding window
//   (query - key < window). It follows the Pallas kernel's arithmetic:
//   masked scores are set to -1e30 and contribute p = 0, the running-max
//   correction is 0 while the running max is still -1e30, out is
//   acc / max(l, 1e-30) and lse = m + log(l) where l > 0.
//
//   Bound on the H100: operations. At the serving prefill shape (B=4,
//   Hq=32, Hkv=8, S=2048, d=128, causal) the unmasked (q, k) pairs need
//   4 * d * 268 M = 137 GFLOP against 75 MB of q, k, v, out and lse: some
//   1,800 operations per byte, far above the ~295 at which bf16 tensor
//   cores, not memory, are the limit.
//
//   Design (simple and right first; wgmma, TMA and warp specialisation are
//   later work): one CTA of 4 warps per (batch x q head, 64 query rows).
//   The CTA walks the 64-key tiles of its kv head in order, skipping tiles
//   that the causal triangle or the window masks entirely (the Pallas
//   kernel's `pl.when(live)`), so the TPU's sequential grid axis becomes a
//   loop inside the block. Per tile:
//     1. K and V tiles land in shared memory (16-byte loads, zero rows past
//        Skv, which the mask then drops);
//     2. S = Q K^T in fp32: bf16 inputs use `nvcuda::wmma` 16x16x16
//        fragments (bf16 products are exact in fp32, sums in fp32); fp32
//        inputs use scalar FMA;
//     3. two threads per query row scale, mask and take the row max and
//        sum (one shuffle each), keep the running max m and sum l in
//        registers, and rescale their half of the fp32 accumulator row;
//     4. acc += P V with P in fp32, as the Pallas kernel does (it does not
//        round p to bf16 first). For bf16 inputs P is split into
//        P_hi = bf16(P) and P_lo = bf16(P - P_hi) and both go through the
//        bf16 tensor cores with fp32 accumulation, which carries P to about
//        16 significant bits (relative error under 2^-16); fp32 inputs use
//        scalar FMA.
//   The fp32 accumulator (64 x dv) lives in shared memory so that a row can
//   be rescaled by the thread that owns it between the tensor-core steps.
//   Shared memory for d = 128 in bf16 is 104,448 bytes: two CTAs per SM.
//   Any Sq, Skv >= 1: rows past Sq are computed on zeros and not written.
//
// The kernel launches on the caller's stream, allocates nothing, and its C
// entry point returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 128;           // 4 warps, 2 threads per query row
constexpr int kLDS = kBK + 4;           // fp32 score / fp32 P row stride
constexpr int kLDP = kBK + 8;           // bf16 P_hi / P_lo row stride
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

template <typename T, int DK, int DV>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // rows padded so each starts on 16 bytes and wmma tiles on 32 bytes
  static constexpr int LDK = DK + (kBf16 ? 8 : 4);
  static constexpr int LDV = DV + (kBf16 ? 8 : 4);
  static constexpr int LDA = DV + 4;
  static constexpr size_t s_bytes = size_t(kBQ) * kLDS * 4;
  static constexpr size_t p_bytes = kBf16 ? size_t(2) * kBQ * kLDP * 2 : 0;
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + size_t(kBQ) * LDK * sizeof(T));
  static constexpr size_t v = align128(k + size_t(kBK) * LDK * sizeof(T));
  static constexpr size_t sp = align128(v + size_t(kBK) * LDV * sizeof(T));
  static constexpr size_t acc =
      align128(sp + (s_bytes > p_bytes ? s_bytes : p_bytes));
  static constexpr size_t bytes = align128(acc + size_t(kBQ) * LDA * 4);
};

// rows [row0, row0 + 64) of a (rows, D) matrix into shared memory with row
// stride LD; rows at or past `rows` are zero
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row0,
                                          int64_t rows) {
  constexpr int kPerVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kPerVec;
  for (int i = threadIdx.x; i < 64 * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kPerVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Hq, int G, int64_t Sq,
                 int64_t Skv, int causal, int64_t window, float scale) {
  using L = Layout<T, DK, DV>;
  constexpr int HC = kBK / 2;           // score columns per thread
  constexpr int HV = DV / 2;            // accumulator columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::sp);
  float* As = reinterpret_cast<float*>(smem + L::acc);

  const int64_t bh = blockIdx.y;
  const int64_t kvh = (bh / Hq) * (Hq / G) + (bh % Hq) / G;
  const int64_t q0 = int64_t(blockIdx.x) * kBQ;
  const T* qh = q + bh * Sq * DK;
  const T* kh = k + kvh * Skv * DK;
  const T* vh = v + kvh * Skv * DV;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int r = tid >> 1;               // query row within the tile
  const int half = tid & 1;             // which half of the row's columns
  const int64_t qpos = q0 + r;
  const int64_t q_last = (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;

  load_tile<T, DK, L::LDK>(Qs, qh, q0, Sq);
  for (int c = 0; c < HV; ++c) As[r * L::LDA + half * HV + c] = 0.f;
  float m_run = kNegInf;
  float l_run = 0.f;

  const int64_t nk = (Skv + kBK - 1) / kBK;
  for (int64_t t = 0; t < nk; ++t) {
    const int64_t k0 = t * kBK;
    if (causal && k0 > q_last) break;                 // past the triangle
    if (window && k0 + kBK - 1 <= q0 - window) continue;   // behind it
    __syncthreads();              // the last tile's K, V and P are consumed
    load_tile<T, DK, L::LDK>(Ks, kh, k0, Skv);
    load_tile<T, DV, L::LDV>(Vs, vh, k0, Skv);
    __syncthreads();

    // 2. S = Q K^T, fp32
    if constexpr (L::kBf16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) {
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDK + kk * 16, L::LDK);
          wmma::load_matrix_sync(b, Ks + n * 16 * L::LDK + kk * 16, L::LDK);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(Ss + warp * 16 * kLDS + n * 16, c, kLDS,
                                wmma::mem_row_major);
      }
    } else {
      float s[HC];
#pragma unroll
      for (int j = 0; j < HC; ++j) s[j] = 0.f;
      for (int d = 0; d < DK; ++d) {
        const float qd = Qs[r * L::LDK + d];
#pragma unroll
        for (int j = 0; j < HC; ++j)
          s[j] += qd * Ks[(half * HC + j) * L::LDK + d];
      }
#pragma unroll
      for (int j = 0; j < HC; ++j) Ss[r * kLDS + half * HC + j] = s[j];
    }
    __syncthreads();

    // 3. online softmax: scale, mask, running max and sum
    float p[HC];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int64_t kpos = k0 + half * HC + j;
      const bool keep = kpos < Skv && (!causal || qpos >= kpos) &&
                        (!window || qpos - kpos < window);
      const float sj = keep ? Ss[r * kLDS + half * HC + j] * scale : kNegInf;
      p[j] = sj;
      mx = fmaxf(mx, sj);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      p[j] = p[j] <= kNegInf / 2 ? 0.f : expf(p[j] - m_new);
      sum += p[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = m_run <= kNegInf / 2 ? 0.f : expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
    for (int c = 0; c < HV; ++c) As[r * L::LDA + half * HV + c] *= corr;
    __syncthreads();              // every S read before P overwrites it

    // 4. acc += P V with P in fp32
    if constexpr (L::kBf16) {
      bf16* Ph = reinterpret_cast<bf16*>(smem + L::sp);
      bf16* Pl = Ph + kBQ * kLDP;
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const bf16 hi = __float2bfloat16(p[j]);
        Ph[r * kLDP + half * HC + j] = hi;
        Pl[r * kLDP + half * HC + j] =
            __float2bfloat16(p[j] - __bfloat162float(hi));
      }
      __syncthreads();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          ph[kBK / 16], pl[kBK / 16];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::load_matrix_sync(ph[kk], Ph + warp * 16 * kLDP + kk * 16, kLDP);
        wmma::load_matrix_sync(pl[kk], Pl + warp * 16 * kLDP + kk * 16, kLDP);
      }
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
      for (int n = 0; n < DV / 16; ++n) {
        float* at = As + warp * 16 * L::LDA + n * 16;
        wmma::load_matrix_sync(c, at, L::LDA, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wmma::load_matrix_sync(b, Vs + kk * 16 * L::LDV + n * 16, L::LDV);
          wmma::mma_sync(c, ph[kk], b, c);
          wmma::mma_sync(c, pl[kk], b, c);
        }
        wmma::store_matrix_sync(at, c, L::LDA, wmma::mem_row_major);
      }
    } else {
#pragma unroll
      for (int j = 0; j < HC; ++j) Ss[r * kLDS + half * HC + j] = p[j];
      __syncthreads();
      float a[HV];
#pragma unroll
      for (int c = 0; c < HV; ++c) a[c] = As[r * L::LDA + half * HV + c];
      for (int j = 0; j < kBK; ++j) {
        const float pj = Ss[r * kLDS + j];
#pragma unroll
        for (int c = 0; c < HV; ++c)
          a[c] += pj * Vs[j * L::LDV + half * HV + c];
      }
#pragma unroll
      for (int c = 0; c < HV; ++c) As[r * L::LDA + half * HV + c] = a[c];
    }
  }
  __syncthreads();

  if (qpos < Sq) {
    T* o = out + (bh * Sq + qpos) * DV + half * HV;
    const float l = fmaxf(l_run, 1e-30f);
    for (int c = 0; c < HV; ++c)
      o[c] = from_float<T>(As[r * L::LDA + half * HV + c] / l);
    if (half == 0)
      lse[bh * Sq + qpos] = l_run > 0.f ? m_run + logf(l) : -__int_as_float(0x7f800000);
  }
}

template <typename T, int DK, int DV>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 void* lse, long long B, long long Hq, long long Hkv,
                 long long Sq, long long Skv, int causal, long long window,
                 float scale, cudaStream_t st) {
  using L = Layout<T, DK, DV>;
  auto* fn = &flash_fwd_kernel<T, DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((Sq + kBQ - 1) / kBQ), unsigned(B * Hq));
  fn<<<grid, kThreads, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), int(Hq), int(Hq / Hkv), Sq, Skv, causal,
      window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Head dims (dk, dv) in {(64, 64), (128, 128)}.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, long long B,
                               long long Hq, long long Hkv, long long Sq,
                               long long Skv, long long dk, long long dv,
                               int dtype, int causal, long long window,
                               float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || B * Hq > 65535 || (Sq + kBQ - 1) / kBQ > 0x7fffffffLL ||
      window < 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(T, DK, DV)                                              \
  return launch_flash<T, DK, DV>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv,    \
                                 causal, window, scale, st)
  if (dk == 64 && dv == 64) {
    if (dtype == 1) REPRO_FLASH(bf16, 64, 64);
    REPRO_FLASH(float, 64, 64);
  }
  if (dk == 128 && dv == 128) {
    if (dtype == 1) REPRO_FLASH(bf16, 128, 128);
    REPRO_FLASH(float, 128, 128);
  }
#undef REPRO_FLASH
  return int(cudaErrorInvalidValue);
}
