// Hand-written Hopper (sm_90a) kernel for the UniLRC XOR byte path.
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
//   S), at most 1024 wide, unless the caller asks for another width (the
//   launch planner `kernels/autotune.py` takes a measured one): the chunks
//   are walked grid-stride, so any width from 1 up to the blocks the chunks
//   need is correct. A ragged B, or a base that is not 16-byte aligned, takes the same
//   body with byte loads and a masked tail, so no padding and no int32
//   lane view are needed.
//
// The GF(2^8) coding kernel is in gf_matmul_sm90.cu. The kernel launches on
// the caller's stream, allocates nothing, and its C entry point returns
// cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// blocks of kThreads chunks that B bytes need
inline int64_t blocks_for(int64_t B) {
  const int64_t chunks = (B + 15) / 16;
  return (chunks + kThreads - 1) / kThreads;
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// `grid_x` 0 is the default width, min(blocks, kMaxGridX); any other from
// 1 up to the blocks B needs is launched as asked, and a width outside that
// range is refused.
extern "C" int repro_xor_fold(const void* src, void* dst, long long S,
                              long long s, long long B, long long grid_x,
                              void* stream) {
  if (S <= 0 || s <= 0 || B <= 0 || S > 65535) return int(cudaErrorInvalidValue);
  const int64_t blocks = blocks_for(B);
  if (grid_x < 0 || grid_x > blocks) return int(cudaErrorInvalidValue);
  if (grid_x == 0) grid_x = blocks < kMaxGridX ? blocks : kMaxGridX;
  const dim3 grid{unsigned(grid_x), unsigned(S)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  uint8_t* o = static_cast<uint8_t*>(dst);
  if (B % 16 == 0 && aligned16(src) && aligned16(dst))
    xor_fold_kernel<true><<<grid, kThreads, 0, st>>>(in, o, s, B);
  else
    xor_fold_kernel<false><<<grid, kThreads, 0, st>>>(in, o, s, B);
  return int(cudaGetLastError());
}
