// CUDA-core (SIMT) building blocks for the fp32 flash-attention kernels on
// Hopper (sm_90a): fp32 row tiles in shared memory, filled by 16-byte
// cp.async, and the vector loads that feed register-blocked micro-tiles.
//
// Row tile layout. A tile of R rows x D fp32 (one row = one query or key, D
// the head dim) is kept row-major with a row stride of D + 4 floats. Every
// row starts on a 16-byte boundary, so a thread reads 4 consecutive
// elements of a row as one float4 (one LDS.128), and since D + 4 is 4
// words past a multiple of the 32 banks, 8 consecutive rows read at one
// column land on 8 distinct 16-byte bank groups: a quarter-warp that reads
// 8 rows (or 8 chunks of one row, or one row by broadcast) is free of bank
// conflicts.
//
// Micro-tile product. Thread (tr, tc) = (t / 8, t % 8) of a block owns rows
// tr + 16i of tile A (i < RM) and rows tc + 8j of tile B (j < 4) and sums
// A_row . B_row over D, reading 4 consecutive elements of each row as one
// float4: RM + 4 LDS.128 for 16 RM FMAs a step of 4 (8 a load at RM 4). A
// quarter-warp shares tr, so it reads one A row by broadcast and 8
// consecutive B rows on 8 distinct bank groups.
#pragma once

#include "hopper_tc.cuh"

namespace simt {

template <int R, int D>
struct RowTile {
  static_assert(D % 4 == 0, "head dim");
  static constexpr int LD = D + 4;                   // row stride, floats
  static constexpr int FLOATS = R * LD;
  static constexpr int BYTES = FLOATS * 4;
};

// rows [row0, row0 + R) of one head (seq stride ss elements, fp32) into
// the row tile at dst by 16-byte cp.async, NT threads; rows >= S are zero
template <int R, int D, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ss, int row0, int S) {
  constexpr int CPR = D / 4;                          // chunks per row
  constexpr int LD = RowTile<R, D>::LD;
  static_assert((R * CPR) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < R * CPR / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CPR, c = i % CPR;
    const bool in = row0 + r < S;
    const float* g = src + (in ? (long long)(row0 + r) * ss : 0) + 4 * c;
    hopper::cp_async16(hopper::smem_u32(dst + r * LD + 4 * c), g, in);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// element u (0..3, a compile-time constant after unrolling) of v
__device__ __forceinline__ float at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// c + a . b, summed in the order x, y, z, w
__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// acc[i][j] += A row 16i . B row 8j over D elements, with a = A + tr * LD
// and b = B + tc * LD (row stride LD floats): the micro-tile above
template <int RM, int D, int LD>
__device__ __forceinline__ void dot_tile(float (&acc)[RM][4], const float* a,
                                         const float* b) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[RM], y[4];
#pragma unroll
    for (int i = 0; i < RM; ++i) x[i] = ld4(a + 16 * i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(b + 8 * j * LD + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(x[i], y[j], acc[i][j]);
  }
}

// bit l: row row0 + l (l < 32) is below S and unmasked (M null, or
// M[row] != 0); every lane of one warp calls it
__device__ __forceinline__ uint32_t live_bits(const int32_t* M, int row0,
                                              int S) {
  const int r = row0 + (threadIdx.x & 31);
  return __ballot_sync(0xffffffffu, r < S && (M == nullptr || M[r] != 0));
}

}  // namespace simt
