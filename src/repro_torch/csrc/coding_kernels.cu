// Hand-written Hopper (sm_90a) kernels for the UniLRC coding byte path.
//
// xor_fold_kernel — replaces the Pallas TPU kernels `xor_reduce` and
//   `xor_reduce_batched` (src/repro/kernels/xor_reduce.py). Computes
//   out[S][B] = XOR over j < s of src[S][j][B], on raw bytes.
//   Bound on the H100: memory. It moves (s + 1) * S * B bytes and does one
//   XOR per byte read, far below the card's ~300 operations per byte.
//   Design: every thread owns one 16-byte column chunk of one stripe and
//   folds the s rows with 16-byte vector loads (neighbouring threads read
//   neighbouring chunks, so each warp reads 512 contiguous bytes per row),
//   then writes one 16-byte result. The grid is (ceil(B / (16 * threads)),
//   S). A ragged B, or a base that is not 16-byte aligned, takes the same
//   body with byte loads and a masked tail, so no padding and no int32
//   lane view are needed.
//
// gf_matmul_kernel — replaces the Pallas TPU kernels `gf_bitmatmul` and
//   `gf_bitmatmul_batched` (src/repro/kernels/gf_bitmatmul.py). Computes
//   out[S][m][B] = A (m, k) @ data[S][k][B] over GF(2^8), exactly.
//   Bound on the H100: read as int8 bit-plane products (2 * 8m * 8k * B
//   operations) it is bound by operations at the 1,979 TOP/s int8 rate; this
//   first design runs on the integer ALUs instead, so what bounds it in
//   practice is instruction issue: per 16 data bytes and coefficient it
//   spends one shared-memory load, 8 byte permutes and 32 three-input
//   logic ops.
//   Design: multiplication by a constant c is GF(2)-linear, so
//   c * x = XOR over the set bits b of x of col[c][b], col[c][b] = c * 2^b.
//   The block stages the col bytes of its <= ROWS_PER_BLOCK output rows in
//   shared memory (k * ROWS_PER_BLOCK * 8 bytes). Each thread owns 16 data
//   bytes of one stripe: for each of the k data rows it loads them once,
//   turns each bit b into a byte mask (0x00 or 0xFF per byte), and folds
//   `mask & broadcast(col)` into one 16-byte accumulator per output row
//   (a LOP3 each). Output rows beyond ROWS_PER_BLOCK take more blocks along
//   grid z, which read the data again. No tensor cores: the int8 bit-plane
//   MMA design is later work.
//
// Both kernels launch on the caller's stream, allocate nothing, and their C
// entry points return cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 16;
constexpr int kMaxGridX = 1024;

template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* p, int64_t valid) {
  if (VEC) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid) w[i >> 2] |= uint32_t(p[i]) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool VEC>
__device__ __forceinline__ void store16(uint8_t* p, uint4 v, int64_t valid) {
  if (VEC) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid) p[i] = uint8_t(w[i >> 2] >> (8 * (i & 3)));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
xor_fold_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                int64_t s, int64_t B) {
  const int64_t stripe = blockIdx.y;
  const int64_t chunks = (B + 15) / 16;
  for (int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x; c < chunks;
       c += int64_t(gridDim.x) * kThreads) {
    const int64_t off = c * 16;
    const int64_t valid = B - off;
    const uint8_t* p = src + stripe * s * B + off;
    uint4 acc = load16<VEC>(p, valid);
    for (int64_t j = 1; j < s; ++j) {
      const uint4 v = load16<VEC>(p + j * B, valid);
      acc.x ^= v.x; acc.y ^= v.y; acc.z ^= v.z; acc.w ^= v.w;
    }
    store16<VEC>(dst + stripe * B + off, acc, valid);
  }
}

__device__ __forceinline__ uint32_t byte_mask(uint32_t w, int b) {
  // 0xFF in every byte whose bit b is set, 0x00 elsewhere.
  return ((w >> b) & 0x01010101u) * 0xFFu;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ cols,  // (m, k, 8)
                 const uint8_t* __restrict__ data,  // (S, k, B)
                 uint8_t* __restrict__ out,         // (S, m, B)
                 int64_t m, int64_t k, int64_t B) {
  extern __shared__ __align__(16) uint8_t smem[];   // (k, kRowsPerBlock, 8)
  const int64_t stripe = blockIdx.y;
  const int64_t r0 = int64_t(blockIdx.z) * kRowsPerBlock;
  const int rows = int(min(int64_t(kRowsPerBlock), m - r0));

  for (int64_t t = threadIdx.x; t < k * kRowsPerBlock; t += kThreads) {
    const int64_t j = t / kRowsPerBlock;
    const int i = int(t % kRowsPerBlock);
    uint2 v = make_uint2(0u, 0u);
    if (i < rows)
      v = *reinterpret_cast<const uint2*>(cols + ((r0 + i) * k + j) * 8);
    reinterpret_cast<uint2*>(smem)[t] = v;
  }
  __syncthreads();

  const int64_t chunks = (B + 15) / 16;
  const uint8_t* dstripe = data + stripe * k * B;
  uint8_t* ostripe = out + (stripe * m + r0) * B;
  for (int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x; c < chunks;
       c += int64_t(gridDim.x) * kThreads) {
    const int64_t off = c * 16;
    const int64_t valid = B - off;
    uint4 acc[kRowsPerBlock];
#pragma unroll
    for (int i = 0; i < kRowsPerBlock; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);

    for (int64_t j = 0; j < k; ++j) {
      const uint4 x = load16<VEC>(dstripe + j * B + off, valid);
      uint32_t mk[8][4];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        mk[b][0] = byte_mask(x.x, b);
        mk[b][1] = byte_mask(x.y, b);
        mk[b][2] = byte_mask(x.z, b);
        mk[b][3] = byte_mask(x.w, b);
      }
      const uint2* cj = reinterpret_cast<const uint2*>(smem) + j * kRowsPerBlock;
#pragma unroll
      for (int i = 0; i < kRowsPerBlock; ++i) {
        if (i < rows) {
          const uint2 cc = cj[i];
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const uint32_t c4 =
                __byte_perm(b < 4 ? cc.x : cc.y, 0u, (b & 3) * 0x1111u);
            acc[i].x ^= mk[b][0] & c4;
            acc[i].y ^= mk[b][1] & c4;
            acc[i].z ^= mk[b][2] & c4;
            acc[i].w ^= mk[b][3] & c4;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerBlock; ++i)
      if (i < rows) store16<VEC>(ostripe + i * B + off, acc[i], valid);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline unsigned grid_x(int64_t B) {
  const int64_t chunks = (B + 15) / 16;
  const int64_t blocks = (chunks + kThreads - 1) / kThreads;
  return unsigned(blocks < kMaxGridX ? (blocks > 0 ? blocks : 1) : kMaxGridX);
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int repro_xor_fold(const void* src, void* dst, long long S,
                              long long s, long long B, void* stream) {
  if (S <= 0 || s <= 0 || B <= 0 || S > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(grid_x(B), unsigned(S));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  uint8_t* o = static_cast<uint8_t*>(dst);
  if (B % 16 == 0 && aligned16(src) && aligned16(dst))
    xor_fold_kernel<true><<<grid, kThreads, 0, st>>>(in, o, s, B);
  else
    xor_fold_kernel<false><<<grid, kThreads, 0, st>>>(in, o, s, B);
  return int(cudaGetLastError());
}

extern "C" int repro_gf_matmul(const void* cols, const void* data, void* out,
                               long long S, long long m, long long k,
                               long long B, void* stream) {
  if (S <= 0 || m <= 0 || k <= 0 || B <= 0 || S > 65535)
    return int(cudaErrorInvalidValue);
  const long long zt = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  if (zt > 65535) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(k) * kRowsPerBlock * 8;
  const bool vec = B % 16 == 0 && aligned16(data) && aligned16(out);
  const void* fn = vec ? reinterpret_cast<const void*>(&gf_matmul_kernel<true>)
                       : reinterpret_cast<const void*>(&gf_matmul_kernel<false>);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(grid_x(B), unsigned(S), unsigned(zt));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(cols);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (vec)
    gf_matmul_kernel<true><<<grid, kThreads, smem, st>>>(c, d, o, m, k, B);
  else
    gf_matmul_kernel<false><<<grid, kThreads, smem, st>>>(c, d, o, m, k, B);
  return int(cudaGetLastError());
}
