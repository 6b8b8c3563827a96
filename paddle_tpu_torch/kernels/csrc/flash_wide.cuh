// Tiles shared by the flash kernels' wide-head-dim instances (D > 128).
//
// The 64/128 instances keep a whole Q (or K/V) tile and its output
// accumulator in shared memory and registers; past D = 128 neither fits
// (O alone would take 128+ registers a thread). The wide instances
// therefore split the work two ways:
// - every product that sums over D (S = Q K^T, dP = dO V^T) accumulates
//   over 64-column chunks of D staged through shared memory, so the
//   staging does not grow with D;
// - every output's D axis is cut into 128-wide slices on the grid's z
//   axis. Each block recomputes S (and P, dP) for its own slice, in the
//   same order in every slice, so the row max, lse and P agree bitwise
//   across slices.
// The wrapper zero-pads D to a multiple of 64 (zero columns change no
// score and give zero output columns). Products run as f32 FMA on the
// CUDA cores: a simple tiling, 256 threads over a 64 x 64 tile of S, each
// thread 4 rows (ty * 4 + i) by 4 strided columns (tx + 16 j), so a row's
// 64 values lie in one group of 16 lanes and its max and sum are four
// __shfl_xor. Output slices are 64 rows x 128 columns, each thread the
// same 4 rows by 8 strided columns (tx + 16 jj): coalesced stores.
// No atomics: every output element is summed by one thread in a fixed
// order, so two launches agree bitwise.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wide {

constexpr int NT = 256;         // threads a block
constexpr int BT = 64;          // rows of a tile and of a block's own
constexpr int DC = 64;          // D chunk of the products summed over D
constexpr int DS = 128;         // D slice of a block's outputs (grid z)
constexpr int LD = DC + 1;      // chunk row stride: no bank conflicts
constexpr int CHUNK = BT * LD;  // floats of a chunk tile
constexpr int SLICE = BT * DS;  // floats of a slice tile

// Rows [r0, r0 + 64) x columns [d0, d0 + 64) of a [T, Dp] matrix into a
// chunk tile; rows past T land as zeros.
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int r0, int T, int Dp, int d0) {
  for (int f = threadIdx.x; f < BT * (DC / 4); f += NT) {
    const int r = f / (DC / 4), c = (f % (DC / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T)
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * Dp +
                                                d0 + c));
    float* d = dst + r * LD + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// Rows [r0, r0 + 64) x columns [s0, s0 + 128) of a [T, Dp] matrix into a
// slice tile; rows past T and columns past Dp land as zeros.
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int r0, int T, int Dp, int s0) {
  for (int f = threadIdx.x; f < BT * (DS / 4); f += NT) {
    const int r = f / (DS / 4), c = (f % (DS / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T && s0 + c < Dp)
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * Dp +
                                                s0 + c));
    *reinterpret_cast<float4*>(dst + r * DS + c) = x;
  }
}

// acc[i][j] += A[ty * 4 + i] . B[tx + 16 j] over one 64-column chunk.
__device__ __forceinline__ void chunk_product(float (&acc)[4][4],
                                              const float* a, const float* b,
                                              int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < DC; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][jj] += sum_c P[ty * 4 + i][c] * M[c][tx + 16 jj]: a 64 x 64 tile
// of P (chunk layout) times a 64 x 128 slice tile.
__device__ __forceinline__ void slice_product(float (&acc)[4][8],
                                              const float* p, const float* m,
                                              int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < BT; ++c) {
    float pv[4], mv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty * 4 + i) * LD + c];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) mv[jj] = m[c * DS + tx + 16 * jj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        acc[i][jj] = fmaf(pv[i], mv[jj], acc[i][jj]);
  }
}

// Rows [r0, r0 + 64) x columns [s0, s0 + 128) of a [T, Dp] output from
// acc * scale; rows past T and columns past Dp are not written.
__device__ __forceinline__ void store_slice(float* dst,
                                            const float (&acc)[4][8],
                                            float scale, int r0, int T,
                                            int Dp, int s0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= T) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = s0 + tx + 16 * jj;
      if (c < Dp) dst[(size_t)r * Dp + c] = acc[i][jj] * scale;
    }
  }
}

// Max and sum over a row's 16 lanes (one half warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

inline dim3 grid(int BH, int T, int Dp) {
  return dim3(BH, (T + BT - 1) / BT, (Dp + DS - 1) / DS);
}

}  // namespace wide
