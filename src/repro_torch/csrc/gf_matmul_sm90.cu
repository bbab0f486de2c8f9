// Hand-written Hopper (sm_90a) GF(2^8) coding kernel on the int8 tensor
// cores.
//
// gf_matmul_sm90_kernel — replaces the Pallas TPU kernels `gf_bitmatmul`
//   and `gf_bitmatmul_batched` (src/repro/kernels/gf_bitmatmul.py). Computes
//   out[S][m][B] = A (m, k) @ data[S][k][B] over GF(2^8), exactly, as the
//   reference's bit-plane product: parity_bits = (A_bits . data_bits) mod 2,
//   with A_bits (8m, 8k) and row 8i+o, column 8j+b of A_bits = bit o of
//   cols[i][j][b] = A[i][j] * 2^b (core/gf.py `gf_bit_columns`). Sums reach
//   at most 8k and are exact in int32.
//   Bound on the H100: operations, for the wide products. The product is
//   2 * 8m * 8k int8 operations per byte position against (k + m) bytes
//   moved: at the encode shape (30 x 180) some 3,300 operations per byte,
//   above the card's balance of ~590 (1,979 TOP/s over 3.35 TB/s), so the
//   encode and the cluster decode are bound by the tensor cores; the
//   narrow delta terms (21 x 1, 42 x 2) fall below it and are bound by
//   bytes. The design keeps the tensor cores fed:
//
//   - Transposed product, data as the register operand. Out^T (positions x
//     8m) = Bits^T (positions x 8k) . A_bits^T, one
//     `wgmma.mma_async.m64nNk32.s32.u8.u8` per 32 bit columns with A from
//     registers: M = 64 byte positions per warpgroup, K = 32 bits = 4 data
//     rows x 8 bits, N = 8 parity bits per output row, padded to an
//     instantiated width (32, 64, 128, 176, 240).
//   - K order. Inside a 32-column step, column 4t+q is bit q of data row
//     4s+t and column 16+4t+q is bit 4+q of the same row. The 8-bit A
//     fragment gives lane (r = lane/4, t = lane%4) columns 4t..4t+3 and
//     16+4t..16+4t+3 of M rows r and r+8, so each lane expands whole bytes:
//     M rows r and r+8 of warp w are byte positions 16w+2r and 16w+2r+1 (one
//     16-bit shared load), and a nibble x becomes four 0/1 bytes as
//     (x * 0x00204081) & 0x01010101. Step s+1's bytes are read while step
//     s's wgmma runs and expanded as soon as their register set is free:
//     three register sets, wait_group 2, so two products stay queued behind
//     the tensor cores (one queued product left them idle between steps).
//   - Bit matrix: the wgmma's B operand, K-major, written by the consumers
//     from cols into shared memory in the no-swizzle core-matrix layout: per
//     step, per group of 8 N rows (N order below), two core matrices of 8
//     rows x 16 bytes (K columns 0-15, then 16-31): leading byte offset
//     128, stride byte offset 256.
//   - Contraction in passes. A_bits of a 180-column code is 8m x 1440 bits,
//     more than a block's shared memory at N = 240, so the 8k columns run in
//     as few passes as fit (two at the encode width: 23 + 22 steps, 176,640
//     bytes of bit matrix). A CTA walks the same byte tiles in every pass:
//     pass 0 stores the packed parity, a later pass loads it (issued before
//     its products, so the load overlaps them), XORs and stores (the parity
//     of a sum is the XOR of the parities of its parts). The same thread
//     owns the same output bytes in every pass, so program order orders the
//     passes' global accesses. Data is read once; the output is written once
//     per pass. Output widths 8m > 240 run as N tiles of at most 30 output
//     rows, one instantiation per launch, each tile with its own passes.
//   - Roles. A persistent grid, by default one CTA of three warpgroups per
//     SM (the caller may ask for another grid: `resolve_grid`; the launch
//     planner `kernels/autotune.py` takes a measured one), walks tiles of
//     128 byte positions of one stripe, grid-stride. Warpgroup 0 drops to 40
//     registers (`setmaxnreg.dec`) and one thread keeps a 3-stage ring of
//     data tiles full with TMA (a 3-D tensor map over (S, k, B), box
//     (1, 4 x steps of a pass, 128), zero fill past k and B, `mbarrier`
//     full/empty pairs, one empty arrival per consumer warp), running ahead
//     across tiles and passes. Warpgroups 1 and 2 (232 registers) take 64
//     byte positions each of every tile and take turns on the tensor cores
//     (two named barriers): each issues its products, passes the turn and
//     runs its epilogue under the other's products. Between passes they
//     rebuild the bit matrix behind a third named barrier.
//   - Data tile: the 128-byte swizzle (16-byte chunk c of row r lands at
//     chunk c ^ (r % 8)), so a warp's 16-bit reads from four rows hit four
//     chunks, free of bank conflicts.
//   - N order and epilogue. The s32 accumulator gives lane t, in each n8
//     block c, columns 8c+2t and 8c+2t+1 for M rows r and r+8. The order of
//     N is free, so it is chosen to leave whole bytes in one lane: in the
//     first 4 x (G / 4) blocks (G = N / 8), block 4a+b, column 2t+e is bit
//     2b+e of output row 4a+t, so lane t packs the 16 bits of its row (two
//     byte positions) from its own registers, `& 1` and shifts, no
//     shuffle. The last G % 4 blocks hold one output row each (column o =
//     bit o) and a 4 x 4 transpose over the quad (two shuffles) gives lane t
//     row 4 (G / 4) + t. Lane t stores the rows i with i % 4 = t as 16-bit
//     words (byte stores on a ragged edge), all rows packed before any
//     store, so no branch splits the packing.
//
// The C entry takes data rows of pitch B rounded up to 16 bytes from a
// 16-byte-aligned base (the wrapper copies to that layout when the caller's
// tensor has another), as TMA needs. The kernel launches on the caller's
// stream, allocates nothing, and the entry returns a CUDA error code so the
// Python wrapper can raise.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kTile = 128;          // byte positions per tile (two halves)
constexpr int kThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kStages = 3;          // data ring depth
constexpr int kMaxSteps = 64;       // a pass stages at most 256 data rows
constexpr int kSmemLimit = 232448;  // shared memory a block may use
constexpr int kBarBytes = 64;       // the ring's mbarriers
constexpr int kMaxN = 240;          // widest instantiation: 30 output rows
constexpr int kWidths[5] = {32, 64, 128, 176, kMaxN};   // instantiated N

// What the host works out once per call.
struct Plan {
  int64_t B;          // valid bytes per row
  int tiles;          // S x tiles per stripe (< 2^31)
  int tps;            // tiles of kTile byte positions per stripe
  int m, k;
  int ksteps;         // 32-column steps: ceil(8k / 32)
  int spp;            // steps per K pass; a staged tile has 4 spp rows
  int npk;            // K passes
  int rows_nt;        // output rows per N tile
  int nnt;            // N tiles
  int bits_bytes;     // the bit matrix of one pass, rounded to 1,024
  int stage_bytes;    // one staged data tile, rounded to 1,024
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the two consumer warpgroups, and no one else
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// Ping-pong on the tensor cores: consumer w takes its turn once the other
// has passed it (named barriers 1 and 2, 256 threads each).
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - w) : "memory");
}

// wgmma descriptor of one step of the bit matrix: no swizzle (layout type
// 0), core matrices of 8 rows x 16 bytes; the leading byte offset (128)
// steps along K, the stride byte offset (256) to the next 8 N rows.
__device__ __forceinline__ uint64_t bits_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
}

// four bits x < 16 -> four bytes of 0 or 1, bit q in byte q
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

#define GF_D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define GF_D16(i) GF_D4(i), GF_D4(i + 4), GF_D4(i + 8), GF_D4(i + 12)

// D (64 x N, s32) (+)= A B: A (64 x 32 u8) from registers, B (32 x N u8)
// K-major from shared memory; scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_u8<32>(uint32_t (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : GF_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_u8<64>(uint32_t (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : GF_D16(0),
        GF_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_u8<128>(uint32_t (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : GF_D16(0),
        GF_D16(16),
        GF_D16(32),
        GF_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_u8<176>(uint32_t (&d)[88],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, {%88, %89, %90, %91}, %92, p;\n}\n"
      : GF_D16(0),
        GF_D16(16),
        GF_D16(32),
        GF_D16(48),
        GF_D16(64),
        GF_D4(80),
        GF_D4(84)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_u8<240>(uint32_t (&d)[120],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %125, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119"
      "}, {%120, %121, %122, %123}, %124, p;\n}\n"
      : GF_D16(0),
        GF_D16(16),
        GF_D16(32),
        GF_D16(48),
        GF_D16(64),
        GF_D16(80),
        GF_D16(96),
        GF_D4(112),
        GF_D4(116)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef GF_D16
#undef GF_D4

// Column of bit o of output row i in an N tile (the note at the top).
template <int N>
__device__ __forceinline__ int bit_column(int i, int o) {
  constexpr int F = N / 32;                  // rows packed in one lane
  return i < 4 * F ? 8 * (i & ~3) + 8 * (o >> 1) + 2 * (i & 3) + (o & 1)
                   : 8 * i + o;
}

// Write one pass's bit matrix: output rows row_lo .. row_lo + rows - 1 (the
// N tile, zero past them), data rows 4 step0 .. 4 (step0 + nsteps) - 1
// (zero past k). Word (s, n, t) of half h, n = bit_column(i, o), holds bit
// o of cols[i][4(step0 + s) + t][4h .. 4h + 3].
template <int N>
__device__ void build_bits(uint8_t* sb, const uint8_t* __restrict__ cols,
                           const Plan& p, int row_lo, int rows, int step0,
                           int nsteps, int tid, int nthreads) {
  const int total = (N / 8) * nsteps * 32;
  for (int idx = tid; idx < total; idx += nthreads) {
    const int o = idx & 7, t = (idx >> 3) & 3, rest = idx >> 5;
    const int s = rest % nsteps, gi = rest / nsteps;
    const int j = 4 * (step0 + s) + t;
    uint2 c = make_uint2(0u, 0u);
    if (gi < rows && j < p.k)
      c = *reinterpret_cast<const uint2*>(
          cols + (int64_t(row_lo + gi) * p.k + j) * 8);
    const int n = bit_column<N>(gi, o);
    uint32_t* w = reinterpret_cast<uint32_t*>(sb + s * (N * 32) +
                                              (n >> 3) * 256 + (n & 7) * 16 +
                                              4 * t);
    w[0] = (c.x >> o) & 0x01010101u;
    w[32] = (c.y >> o) & 0x01010101u;          // K columns 16-31: +128 B
  }
}

// Offset of (row, byte position) in a staged data tile: 128-byte rows in
// the 128-byte swizzle, as TMA writes them into a 1,024-aligned stage.
__device__ __forceinline__ int tile_offset(int row, int pos) {
  return row * kTile + ((((pos >> 4) ^ row) & 7) << 4) + (pos & 15);
}

// This lane's two data bytes of step s: row 4s + t at byte positions pos
// and pos + 1 of the staged tile.
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* tile, int s,
                                               int t, int pos) {
  const int row = 4 * s + t;
  return *reinterpret_cast<const uint16_t*>(tile + tile_offset(row, pos));
}

// The A fragment of those bytes, expanded to bits.
__device__ __forceinline__ void expand(uint32_t (&a)[4], uint32_t v) {
  a[0] = nibble_bytes(v & 0xFu);             // M row r: bits 0-3
  a[1] = nibble_bytes((v >> 8) & 0xFu);      // M row r + 8
  a[2] = nibble_bytes((v >> 4) & 0xFu);      // M row r: bits 4-7
  a[3] = nibble_bytes(v >> 12);              // M row r + 8
}

template <int N>
__device__ __forceinline__ void issue(uint32_t (&d)[N / 2],
                                      const uint32_t (&a)[4], uint32_t sb,
                                      int s) {
  wgmma_fence();
  wgmma_u8<N>(d, a, bits_desc(sb + s * (N * 32)), s);
  wgmma_commit();
}

// Step s of a warpgroup's product: expand the bytes read ahead into `a`,
// read step s + 1's, issue, and wait until at most two products are in
// flight, which frees `next` (the set of step s - 2).
template <int N>
__device__ __forceinline__ void step(uint32_t (&d)[N / 2], uint32_t (&a)[4],
                                     uint32_t (&next)[4], uint32_t& v,
                                     uint32_t sb, const uint8_t* tile,
                                     int s, int nsteps, int t, int pos) {
  expand(a, v);
  v = load_bytes(tile, min(s + 1, nsteps - 1), t, pos);
  issue<N>(d, a, sb, s);
  wgmma_wait<2>();
  fence_regs(next);
}

// One warpgroup's product for 64 byte positions over the pass's nsteps
// steps, into d. Called in the warpgroup's turn, which it passes on once
// the last product is issued.
template <int N>
__device__ __forceinline__ void consume(uint32_t (&d)[N / 2], uint32_t sb,
                                        const uint8_t* tile, int nsteps,
                                        int t, int pos, int w) {
  uint32_t a0[4], a1[4], a2[4];
  fence_regs(d);
  uint32_t v = load_bytes(tile, 0, t, pos);
  int s = 0;
  for (; s + 3 <= nsteps; s += 3) {
    step<N>(d, a0, a1, v, sb, tile, s, nsteps, t, pos);
    step<N>(d, a1, a2, v, sb, tile, s + 1, nsteps, t, pos);
    step<N>(d, a2, a0, v, sb, tile, s + 2, nsteps, t, pos);
  }
  if (s < nsteps) step<N>(d, a0, a1, v, sb, tile, s, nsteps, t, pos);
  if (s + 1 < nsteps) step<N>(d, a1, a2, v, sb, tile, s + 1, nsteps, t, pos);
  turn_pass(w);              // the other consumer's products may follow
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(a0);
  fence_regs(a1);
  fence_regs(a2);
}

// This thread's output bytes: positions pos and pos + 1 of output rows
// row_lo + 4q + t, q = 0, 1, ... of one stripe.
struct OutBytes {
  uint8_t* at;        // row row_lo + t, position pos
  int64_t row_step;   // 4 output rows
  int rows;           // rows of the N tile left from row_lo + t
  bool any, two;      // pos < B, pos + 1 < B
  bool word;          // both, at an even address: one 16-bit access
};

__device__ __forceinline__ OutBytes out_bytes(uint8_t* out, const Plan& p,
                                              int64_t stripe, int64_t pos,
                                              int row_lo, int rows, int t) {
  OutBytes o;
  o.at = out + (stripe * p.m + row_lo + t) * p.B + pos;
  o.row_step = 4 * p.B;                // even: every row has at's parity
  o.rows = rows - t;
  o.any = pos < p.B;
  o.two = pos + 1 < p.B;
  o.word = o.two && !(reinterpret_cast<uintptr_t>(o.at) & 1);
  return o;
}

// What an earlier pass stored at this thread's bytes, loaded ahead of the
// products that it is XORed with.
template <int N>
__device__ __forceinline__ void load_old(uint32_t (&old)[(N / 8 + 3) / 4],
                                         const OutBytes& o) {
#pragma unroll
  for (int q = 0; q < (N / 8 + 3) / 4; ++q) {
    const uint8_t* at = o.at + q * o.row_step;
    old[q] = 0u;
    if (o.any && 4 * q < o.rows)
      old[q] = o.word ? uint32_t(*reinterpret_cast<const uint16_t*>(at))
                      : uint32_t(at[0]) | (o.two ? uint32_t(at[1]) << 8 : 0u);
  }
}

// Pack the accumulator's parity bits into bytes, XOR `old` and store. All
// rows are packed first, with no branch between them, then stored.
template <int N>
__device__ __forceinline__ void epilogue(const uint32_t (&d)[N / 2],
                                         uint32_t (&old)[(N / 8 + 3) / 4],
                                         const OutBytes& o, int t) {
  constexpr int G = N / 8, F = N / 32;
  // rows 4q + t, q < F: this lane's own 16 bits
#pragma unroll
  for (int q = 0; q < F; ++q) {
    uint32_t v = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = 4 * q + b;
      const uint32_t lo = (d[4 * c] & 1u) | ((d[4 * c + 1] & 1u) << 1);
      const uint32_t hi = (d[4 * c + 2] & 1u) | ((d[4 * c + 3] & 1u) << 1);
      v |= (lo | (hi << 8)) << (2 * b);
    }
    old[q] ^= v;
  }
  // the last G % 4 blocks, one row each: a 4 x 4 transpose over the quad
  if constexpr (G % 4 != 0) {
    uint32_t part[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * F + u;
      if (c < G) {
        const uint32_t lo = (d[4 * c] & 1u) | ((d[4 * c + 1] & 1u) << 1);
        const uint32_t hi = (d[4 * c + 2] & 1u) | ((d[4 * c + 3] & 1u) << 1);
        part[u] = (lo | (hi << 8)) << (2 * t);
      } else {
        part[u] = 0u;
      }
    }
    const uint32_t w01 = part[0] | (part[1] << 16);
    const uint32_t w23 = part[2] | (part[3] << 16);
    uint32_t keep = (t & 2) ? w23 : w01;
    keep |= __shfl_xor_sync(0xffffffffu, (t & 2) ? w01 : w23, 2);
    uint32_t mine = (t & 1) ? keep >> 16 : keep & 0xFFFFu;
    mine |= __shfl_xor_sync(0xffffffffu, (t & 1) ? keep & 0xFFFFu : keep >> 16,
                            1);
    old[F] ^= mine;
  }
#pragma unroll
  for (int q = 0; q < (G + 3) / 4; ++q) {
    uint8_t* at = o.at + q * o.row_step;
    if (o.any && 4 * q < o.rows) {
      if (o.word) {
        *reinterpret_cast<uint16_t*>(at) = uint16_t(old[q]);
      } else {
        at[0] = uint8_t(old[q]);
        if (o.two) at[1] = uint8_t(old[q] >> 8);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
gf_matmul_sm90_kernel(const __grid_constant__ CUtensorMap tm,
                      const uint8_t* __restrict__ cols,
                      uint8_t* __restrict__ out,
                      const __grid_constant__ Plan p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sb = smem_raw + (base - raw);              // the pass's bit matrix
  uint8_t* ring = sb + p.bits_bytes;                  // kStages data tiles
  const uint32_t bars = base + p.bits_bytes + kStages * p.stage_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int passes = p.nnt * p.npk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);                // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Both roles walk passes, then tiles blockIdx.x, + gridDim.x, ..., and
  // count ring positions (r) the same way, so their barrier phases agree.
  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the data ring loaded ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int r = 0;
      for (int pass = 0; pass < passes; ++pass) {
        const int row0 = 4 * (pass % p.npk) * p.spp;
        for (int T = blockIdx.x; T < p.tiles; T += gridDim.x, ++r) {
          const int s = r % kStages;
          const int stripe = int(unsigned(T) / unsigned(p.tps));
          mbar_wait(empty(s), ((r / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), 4 * p.spp * kTile);
          tma_load(base + p.bits_bytes + s * p.stage_bytes, &tm, full(s),
                   (T - stripe * p.tps) * kTile, row0, stripe);
        }
      }
    }
  } else {
    // ---- consumers: 64 byte positions of every tile each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int half = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x - 128;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int t = lane & 3;
    const int pos = half * 64 + warp * 16 + 2 * (lane >> 2);
    uint32_t d[N / 2];
    uint32_t old[(N / 8 + 3) / 4];
    int r = 0;
    if (half == 1) turn_pass(1);             // consumer 0 goes first
    for (int pass = 0; pass < passes; ++pass) {
      const int nt = pass / p.npk, kp = pass % p.npk;
      const int step0 = kp * p.spp, nsteps = min(p.spp, p.ksteps - step0);
      const int row_lo = nt * p.rows_nt, rows = min(p.rows_nt, p.m - row_lo);
      consumers_sync();          // the last pass's products are done
      build_bits<N>(sb, cols, p, row_lo, rows, step0, nsteps, tid, 256);
      fence_proxy_async();       // visible to the wgmma's operand reads
      consumers_sync();
      for (int T = blockIdx.x; T < p.tiles; T += gridDim.x, ++r) {
        const int s = r % kStages;
        const unsigned stripe = unsigned(T) / unsigned(p.tps);
        const OutBytes o = out_bytes(
            out, p, stripe, int64_t(T - stripe * p.tps) * kTile + pos,
            row_lo, rows, t);
        if (kp > 0) {
          load_old<N>(old, o);
        } else {
#pragma unroll
          for (int q = 0; q < (N / 8 + 3) / 4; ++q) old[q] = 0u;
        }
        turn_wait(half);
        mbar_wait(full(s), (r / kStages) & 1);
        consume<N>(d, base, ring + s * p.stage_bytes, nsteps, t, pos, half);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));  // this warp's reads are done
        epilogue<N>(d, old, o, t);
      }
    }
    if (half == 0) turn_wait(0);             // the last hand-over
  }
}

// (S, k, B) uint8 with rows of `pitch` bytes: boxes of 128 positions x
// `rows` data rows x 1 stripe, 128-byte swizzle, zero fill past k and B
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* data,
              long long S, long long k, long long B, long long pitch,
              int rows) {
  const cuuint64_t dims[3] = {cuuint64_t(B), cuuint64_t(k), cuuint64_t(S)};
  const cuuint64_t strides[2] = {cuuint64_t(pitch), cuuint64_t(k * pitch)};
  const cuuint32_t box[3] = {kTile, cuuint32_t(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(data), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(&gf_matmul_sm90_kernel<N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem));
}

template <int N>
int launch(const CUtensorMap& tm, const uint8_t* cols, uint8_t* out,
           const Plan& p, size_t smem, unsigned grid, cudaStream_t st) {
  cudaError_t err = allow_smem<N>(smem);
  if (err != cudaSuccess) return int(err);
  gf_matmul_sm90_kernel<N><<<grid, kThreads, smem, st>>>(tm, cols, out, p);
  return int(cudaGetLastError());
}

// CTAs of the instantiation for width N that one SM holds at once, as the
// occupancy calculator finds them (shared memory, threads and registers)
template <int N>
cudaError_t resident_of(size_t smem, int* out) {
  cudaError_t err = allow_smem<N>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, &gf_matmul_sm90_kernel<N>, kThreads, smem);
}

cudaError_t resident(int N, size_t smem, int* out) {
  switch (N) {
    case 32: return resident_of<32>(smem, out);
    case 64: return resident_of<64>(smem, out);
    case 128: return resident_of<128>(smem, out);
    case 176: return resident_of<176>(smem, out);
    default: return resident_of<240>(smem, out);
  }
}

constexpr int round1024(int64_t x) { return int((x + 1023) & ~int64_t(1023)); }

// The launch plan of an (m, k) product over S stripes of B bytes: the
// tiling (N width, N tiles, K passes) and the dynamic shared memory.
// Returns false for a shape the kernel does not take.
bool make_plan(long long S, long long m, long long k, long long B, Plan* p,
               int* width, size_t* smem_bytes) {
  if (S <= 0 || m <= 0 || k <= 0 || B <= 0 || m > (1 << 24) ||
      k > (1 << 24) || S * ((B + kTile - 1) / kTile) > 0x7fffffffLL)
    return false;
  *p = Plan{};
  p->B = B;
  p->tps = int((B + kTile - 1) / kTile);
  p->tiles = int(S * p->tps);
  p->m = int(m);
  p->k = int(k);
  p->ksteps = int((k + 3) / 4);
  // N tiles of at most kMaxN / 8 output rows, all of one width
  const int nnt = int((m + kMaxN / 8 - 1) / (kMaxN / 8));
  p->rows_nt = int((m + nnt - 1) / nnt);
  p->nnt = int((m + p->rows_nt - 1) / p->rows_nt);
  int N = 0;
  for (int i = 4; i >= 0; --i)
    if (8 * p->rows_nt <= kWidths[i]) N = kWidths[i];
  // as few K passes as fit
  size_t smem = 0;
  for (p->npk = (p->ksteps + kMaxSteps - 1) / kMaxSteps;; ++p->npk) {
    p->spp = (p->ksteps + p->npk - 1) / p->npk;
    p->bits_bytes = round1024(int64_t(p->spp) * N * 32);
    p->stage_bytes = round1024(4 * p->spp * kTile);
    smem = 1024 + size_t(p->bits_bytes) + size_t(kStages) * p->stage_bytes +
           kBarBytes;
    if (smem <= size_t(kSmemLimit)) break;
  }
  *width = N;
  *smem_bytes = smem;
  return true;
}

// The grid of a launch. `grid` 0 is the persistent default, one CTA per
// SM (or per tile, if fewer), which needs the SM count alone. Any other
// grid from 1 up to the tiles and to the CTAs the SMs hold at once
// (`resident` x SMs) is launched as asked: every CTA walks its tiles
// grid-stride, so any such grid is correct. A grid outside that range is
// refused.
cudaError_t resolve_grid(const Plan& p, int N, size_t smem, long long grid,
                         unsigned* out) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (grid == 0) {
    *out = unsigned(p.tiles < sms ? p.tiles : sms);
    return cudaSuccess;
  }
  if (grid < 0 || grid > p.tiles) return cudaErrorInvalidValue;
  int res = 0;
  err = resident(N, smem, &res);
  if (err != cudaSuccess) return err;
  if (grid > (long long)res * sms) return cudaErrorInvalidValue;
  *out = unsigned(grid);
  return cudaSuccess;
}

}  // namespace

// cols (m, k, 8), data (S, k, B) with rows of pitch B rounded up to 16
// bytes from a 16-byte-aligned base, out (S, m, B); `grid` as
// `resolve_grid` takes it (0: the persistent default).
extern "C" int repro_gf_matmul(const void* cols, const void* data, void* out,
                               long long S, long long m, long long k,
                               long long B, long long grid, void* stream) {
  Plan p;
  int N = 0;
  size_t smem = 0;
  unsigned g = 0;
  if (!make_plan(S, m, k, B, &p, &N, &smem) ||
      (reinterpret_cast<uintptr_t>(data) & 15) ||
      (reinterpret_cast<uintptr_t>(cols) & 7))
    return int(cudaErrorInvalidValue);
  const cudaError_t err = resolve_grid(p, N, smem, grid, &g);
  if (err != cudaSuccess) return int(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tm;
  if (!make_map(encode, &tm, data, S, k, B, (B + 15) & ~15LL, 4 * p.spp))
    return int(cudaErrorInvalidValue);
  const auto* c = static_cast<const uint8_t*>(cols);
  auto* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 32: return launch<32>(tm, c, o, p, smem, g, st);
    case 64: return launch<64>(tm, c, o, p, smem, g, st);
    case 128: return launch<128>(tm, c, o, p, smem, g, st);
    case 176: return launch<176>(tm, c, o, p, smem, g, st);
    default: return launch<240>(tm, c, o, p, smem, g, st);
  }
}

// What `repro_gf_matmul` would launch for the same shape and `grid` on the
// current device, without launching: out[0..8] = threads, grid (CTAs),
// dynamic shared memory bytes, N width, N tiles, K passes, steps per K
// pass, output rows per N tile, and the CTAs one SM holds at once by the
// occupancy calculator (`resident`: the grid's ceiling is that times the
// SMs). A grid `repro_gf_matmul` would refuse is refused here too.
extern "C" int repro_gf_plan(long long S, long long m, long long k,
                             long long B, long long grid, long long* out) {
  Plan p;
  int N = 0, res = 0;
  size_t smem = 0;
  unsigned g = 0;
  if (!make_plan(S, m, k, B, &p, &N, &smem))
    return int(cudaErrorInvalidValue);
  cudaError_t err = resolve_grid(p, N, smem, grid, &g);
  if (err == cudaSuccess) err = resident(N, smem, &res);
  if (err != cudaSuccess) return int(err);
  out[0] = kThreads;
  out[1] = g;
  out[2] = (long long)smem;
  out[3] = N;
  out[4] = p.nnt;
  out[5] = p.npk;
  out[6] = p.spp;
  out[7] = p.rows_nt;
  out[8] = res;
  return 0;
}
