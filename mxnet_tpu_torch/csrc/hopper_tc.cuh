// Tensor-core building blocks for the bf16 flash-attention kernels on
// Hopper (sm_90a): shared-memory tiles in the layout wgmma reads, filled by
// cp.async; matrix descriptors; the wgmma instructions the kernels issue.
//
// Tile layout. A tile of R rows x D bf16 (one row = one query or key, D the
// head dim) is kept as D / W column blocks of R x W, W = 64 elements
// (128-byte rows, 128-byte swizzle) at D >= 64 and W = 32 (64-byte rows,
// 64-byte swizzle) at D = 32. Within a block, a byte offset has its bits
// [7, 7 + B) XORed into bits [4, 4 + B) (Swizzle<B,4,3>, B = 3 for 128-byte
// rows, 2 for 64-byte rows): the canonical swizzled layout wgmma reads, and
// the 16-byte chunks of one column in an 8-row group land on distinct
// banks. Every block starts on a 1024-byte boundary.
//
// The same tile serves both operand roles:
//   - K-major (the contraction runs along D): A = Q or K, B = K or Q or dO
//     in QK^T-like products. One wgmma k-step (16 elements = 32 bytes) is
//     the descriptor's start moved by 32 bytes within a row (and by one
//     block every W / 16 steps); 8-row groups are SBO = 8 rows apart.
//   - MN-major (the contraction runs along the rows): B = V or dO or Q in
//     the P V-like products, transposed by wgmma (imm-trans-b = 1). One
//     k-step is 16 rows (two 8-row groups, SBO apart); the next W columns
//     are the next block, LBO = R rows apart.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------- copies

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src
// must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's shared-memory writes (cp.async, plain stores)
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ tiles

template <int R, int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int W = D >= 64 ? 64 : 32;        // elements per block row
  static constexpr int RB = 2 * W;                   // bytes per block row
  static constexpr int SWZ = RB == 128 ? 3 : 2;      // Swizzle<SWZ,4,3>
  static constexpr int LAYOUT = RB == 128 ? 1 : 2;   // descriptor: B128, B64
  static constexpr int BLOCK = R * RB;               // bytes per column block
  static constexpr int BYTES = D / W * BLOCK;
  static constexpr int CHUNKS = R * D / 8;           // 16-byte chunks
  static_assert(R % 8 == 0 && BLOCK % 1024 == 0, "tile alignment");

  // byte offset of 16-byte chunk c (elements 8c..8c+7) of row r
  __device__ __forceinline__ static uint32_t at(int r, int c) {
    const int e = 8 * c;
    const uint32_t off = (e / W) * BLOCK + r * RB + (e % W) * 2;
    return off ^ (((off >> 7) & ((1u << SWZ) - 1)) << 4);
  }
};

// rows [row0, row0 + R) of one head (seq stride ss elements) into the tile
// at shared address dst by cp.async, NT threads; rows >= S are zero
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int S) {
  using T = Tile<R, D>;
  constexpr int CPR = D / 8;                          // chunks per row
  static_assert(T::CHUNKS % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < T::CHUNKS / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CPR, c = i % CPR;
    const bool in = row0 + r < S;
    const __nv_bfloat16* g = src + (in ? (long long)(row0 + r) * ss : 0) +
                             8 * c;
    cp_async16(dst + T::at(r, c), g, in);
  }
}

// ----------------------------------------------------------- descriptors

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)layout << 62;
  return d;
}

// all R rows x elements 16kk..16kk+15 (the contraction), as a K-major
// operand
template <int R, int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using T = Tile<R, D>;
  constexpr int STEPS = T::W / 16;                    // k-steps per block
  const uint32_t a = tile + (kk / STEPS) * T::BLOCK + (kk % STEPS) * 32;
  return make_desc(a, 16, 8 * T::RB, T::LAYOUT);
}

// rows 16kk..16kk+15 (the contraction) x all D columns, as an MN-major
// operand
template <int R, int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using T = Tile<R, D>;
  return make_desc(tile + 16 * kk * T::RB, T::BLOCK, 8 * T::RB, T::LAYOUT);
}

// ------------------------------------------------------------------ wgmma
//
// Accumulator fragment of a 64 x N fp32 tile over the warpgroup's 128
// threads: thread t (warp w = t / 32, lane l) holds d[i], i < N / 2, at row
// 16w + l/4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (l % 4) + i % 2.
// An A operand from registers (64 x 16 bf16) uses the same rows and
// columns: a[0] = (row l/4, cols 2(l%4)..+1), a[1] = row + 8, a[2] = cols
// + 8, a[3] = both, each a pair of bf16 (lower column in the low half).

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins accumulator registers in place around the asynchronous wgmma, so
// the compiler neither reads them before the wait nor moves writes past it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the special-function unit (flushes denormals; 2^-1e30 = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 32, fp32) += A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, fp32) += A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 32, fp32) += A (registers, bf16 pairs) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 64, fp32) += A (registers, bf16 pairs) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 128, fp32) += A (registers, bf16 pairs) * B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

}  // namespace hopper
