// Hand-written flash-attention forward for fp32 inputs (any CUDA card,
// built for sm_90a with the rest of the library).
//
// flash_fwd_kernel — replaces the Pallas TPU kernel `flash_attention_fwd`
//   (src/repro/kernels/flash_attention.py, body `_flash_fwd_kernel`) for
//   fp32 inputs; bf16 inputs take flash_fwd_sm90_kernel
//   (flash_fwd_sm90.cu). Computes, for q (B, Hq, Sq, dk),
//   k (B, Hkv, Skv, dk), v (B, Hkv, Skv, dv) with q head h reading kv head
//   h / (Hq / Hkv):
//     out = softmax(mask(q k^T * dk^-0.5)) v   in fp32, and
//     lse = log-sum-exp of each masked score row, -inf where the whole row
//           is masked,
//   under a causal mask (key <= query) and/or a sliding window
//   (query - key < window). It follows the Pallas kernel's arithmetic:
//   masked scores are set to -1e30 and contribute p = 0, the running-max
//   correction is 0 while the running max is still -1e30, out is
//   acc / max(l, 1e-30) and lse = m + log(l) where l > 0.
//
//   Bound on the H100: operations, on the fp32 units outside the tensor
//   cores (wgmma has no full-fp32 product, and the fp32 tolerance is 2e-5).
//
//   Design (simple and right): one CTA of 4 warps per (batch x q head,
//   64 query rows). The CTA walks the 64-key tiles of its kv head in
//   order, skipping tiles that the causal triangle or the window masks
//   entirely (the Pallas kernel's `pl.when(live)`), so the TPU's
//   sequential grid axis becomes a loop inside the block. Per tile:
//     1. K and V tiles land in shared memory (16-byte loads, zero rows past
//        Skv, which the mask then drops);
//     2. S = Q K^T by scalar FMA, two threads per query row;
//     3. the two threads of a row scale, mask and take the row max and
//        sum (one shuffle each), keep the running max m and sum l in
//        registers, and rescale their half of the accumulator row;
//     4. acc += P V by scalar FMA.
//   The accumulator (64 x dv) lives in shared memory. Shared memory for
//   d = 128 is 152,576 bytes. Any Sq, Skv >= 1: rows past Sq are computed
//   on zeros and not written.
//
// The kernel launches on the caller's stream, allocates nothing, and its C
// entry point returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 128;           // 4 warps, 2 threads per query row
constexpr int kLDS = kBK + 4;           // score / P row stride
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

template <int DK, int DV>
struct Layout {
  // rows padded so each starts on 16 bytes
  static constexpr int LDK = DK + 4;
  static constexpr int LDV = DV + 4;
  static constexpr int LDA = DV + 4;
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + size_t(kBQ) * LDK * 4);
  static constexpr size_t v = align128(k + size_t(kBK) * LDK * 4);
  static constexpr size_t sp = align128(v + size_t(kBK) * LDV * 4);
  static constexpr size_t acc = align128(sp + size_t(kBQ) * kLDS * 4);
  static constexpr size_t bytes = align128(acc + size_t(kBQ) * LDA * 4);
};

// rows [row0, row0 + 64) of a (rows, D) matrix into shared memory with row
// stride LD; rows at or past `rows` are zero
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row0, int64_t rows) {
  constexpr int kVecPerRow = D / 4;
  for (int i = threadIdx.x; i < 64 * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Hq, int G, int64_t Sq,
                 int64_t Skv, int causal, int64_t window, float scale) {
  using L = Layout<DK, DV>;
  constexpr int HC = kBK / 2;           // score columns per thread
  constexpr int HV = DV / 2;            // accumulator columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* Ks = reinterpret_cast<float*>(smem + L::k);
  float* Vs = reinterpret_cast<float*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::sp);
  float* As = reinterpret_cast<float*>(smem + L::acc);

  const int64_t bh = blockIdx.y;
  const int64_t kvh = (bh / Hq) * (Hq / G) + (bh % Hq) / G;
  const int64_t q0 = int64_t(blockIdx.x) * kBQ;
  const float* qh = q + bh * Sq * DK;
  const float* kh = k + kvh * Skv * DK;
  const float* vh = v + kvh * Skv * DV;

  const int tid = threadIdx.x;
  const int r = tid >> 1;               // query row within the tile
  const int half = tid & 1;             // which half of the row's columns
  const int64_t qpos = q0 + r;
  const int64_t q_last = (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;

  load_tile<DK, L::LDK>(Qs, qh, q0, Sq);
  for (int c = 0; c < HV; ++c) As[r * L::LDA + half * HV + c] = 0.f;
  float m_run = kNegInf;
  float l_run = 0.f;

  const int64_t nk = (Skv + kBK - 1) / kBK;
  for (int64_t t = 0; t < nk; ++t) {
    const int64_t k0 = t * kBK;
    if (causal && k0 > q_last) break;                 // past the triangle
    if (window && k0 + kBK - 1 <= q0 - window) continue;   // behind it
    __syncthreads();              // the last tile's K, V and P are consumed
    load_tile<DK, L::LDK>(Ks, kh, k0, Skv);
    load_tile<DV, L::LDV>(Vs, vh, k0, Skv);
    __syncthreads();

    // 2. S = Q K^T
    float s[HC];
#pragma unroll
    for (int j = 0; j < HC; ++j) s[j] = 0.f;
    for (int d = 0; d < DK; ++d) {
      const float qd = Qs[r * L::LDK + d];
#pragma unroll
      for (int j = 0; j < HC; ++j)
        s[j] += qd * Ks[(half * HC + j) * L::LDK + d];
    }

    // 3. online softmax: scale, mask, running max and sum
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int64_t kpos = k0 + half * HC + j;
      const bool keep = kpos < Skv && (!causal || qpos >= kpos) &&
                        (!window || qpos - kpos < window);
      s[j] = keep ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      s[j] = s[j] <= kNegInf / 2 ? 0.f : expf(s[j] - m_new);
      sum += s[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = m_run <= kNegInf / 2 ? 0.f : expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < HC; ++j) Ss[r * kLDS + half * HC + j] = s[j];
    __syncthreads();

    // 4. acc = acc * corr + P V
    float a[HV];
#pragma unroll
    for (int c = 0; c < HV; ++c) a[c] = As[r * L::LDA + half * HV + c] * corr;
    for (int j = 0; j < kBK; ++j) {
      const float pj = Ss[r * kLDS + j];
#pragma unroll
      for (int c = 0; c < HV; ++c)
        a[c] += pj * Vs[j * L::LDV + half * HV + c];
    }
#pragma unroll
    for (int c = 0; c < HV; ++c) As[r * L::LDA + half * HV + c] = a[c];
  }
  __syncthreads();

  if (qpos < Sq) {
    float* o = out + (bh * Sq + qpos) * DV + half * HV;
    const float l = fmaxf(l_run, 1e-30f);
    for (int c = 0; c < HV; ++c) o[c] = As[r * L::LDA + half * HV + c] / l;
    if (half == 0)
      lse[bh * Sq + qpos] =
          l_run > 0.f ? m_run + logf(l) : -__int_as_float(0x7f800000);
  }
}

template <int DK, int DV>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 void* lse, long long B, long long Hq, long long Hkv,
                 long long Sq, long long Skv, int causal, long long window,
                 float scale, cudaStream_t st) {
  using L = Layout<DK, DV>;
  auto* fn = &flash_fwd_kernel<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((Sq + kBQ - 1) / kBQ), unsigned(B * Hq));
  fn<<<grid, kThreads, L::bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), int(Hq), int(Hq / Hkv), Sq, Skv, causal,
      window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// fp32 q, k, v with dk = dv = d in {64, 128}.
extern "C" int repro_flash_fwd_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   long long B, long long Hq, long long Hkv,
                                   long long Sq, long long Skv, long long d,
                                   int causal, long long window, float scale,
                                   void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || B * Hq > 65535 || (Sq + kBQ - 1) / kBQ > 0x7fffffffLL ||
      window < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_flash<64, 64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv,
                                causal, window, scale, st);
  if (d == 128)
    return launch_flash<128, 128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Skv,
                                  causal, window, scale, st);
  return int(cudaErrorInvalidValue);
}
