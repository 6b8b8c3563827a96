// 3xTF32 products on `mma.sync.m16n8k8` fragments, shared by the flash
// forward and backward kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): cp.async row tiles and the slice instances'
// ring, the fragment reads of a shared tile, the hi/lo products, and the
// reuse of an f32 C fragment as an A operand.
//
// Fragment layout (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 g + t.
// A (16 x 8, row-major) holds rows g and g + 8 at columns t and t + 4; B
// (8 x 8, column-major) rows t and t + 4 of column g; the f32 C/D
// fragment rows g and g + 8 at columns 2t and 2t + 1. So every row of C
// lives in one quad of lanes (the four t of one g): a row reduction over
// a C tile is the thread's own values, then two __shfl_xor (1, 2).
#pragma once

#include "tf32x3.cuh"

namespace {

// Rows [row0, row0 + ROWS) of a [T, D] plane into shared memory at row
// stride ST floats, 16 bytes a copy over NTHREADS threads; rows past T are
// zero-filled. Commit the group after.
template <int D, int ST, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int T) {
  constexpr int V4 = D / 4;
  static_assert(ROWS * V4 % NTHREADS == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * V4 / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    const bool in = row0 + r < T;
    cp_async16(dst + r * ST + c, src + (in ? (size_t)(row0 + r) * D + c : 0),
               in);
  }
}

// Rows [row0, row0 + ROWS) x columns [c0, c0 + CH) of a [T, Dp] plane into
// shared memory at row stride CST, 16 bytes a copy over NTHREADS threads;
// rows past T are zero-filled: a step of the rings of the slice instances
// past D = 512. Commit the group after.
template <int ROWS, int CH, int CST, int NTHREADS>
__device__ __forceinline__ void load_step(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int T, int Dp, int c0) {
  static_assert(ROWS * CH / 4 % NTHREADS == 0, "step must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CH / 4 / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int r = idx / (CH / 4);
    const int c = (idx % (CH / 4)) * 4;
    const bool in = row0 + r < T;
    cp_async16(dst + r * CST + c,
               src + (in ? (size_t)(row0 + r) * Dp + c0 + c : 0), in);
  }
}

// Rows [row0, row0 + ROWS) of a [T, Dp] plane into shared memory at row
// stride Dp + 4 over NTHREADS threads; rows past T are zero-filled: the
// rows a block of the slice instances keeps resident. Commit the group
// after.
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void load_owned(float* dst,
                                           const float* __restrict__ src,
                                           int row0, int T, int Dp) {
  for (int idx = threadIdx.x; idx < ROWS * Dp / 4; idx += NTHREADS) {
    const int r = idx / (Dp / 4), c = (idx % (Dp / 4)) * 4;
    const bool in = row0 + r < T;
    cp_async16(dst + r * (Dp + 4) + c,
               src + (in ? (size_t)(row0 + r) * Dp + c : 0), in);
  }
}

// The ring of the slice instances over a block's n_units steps (issue(u)
// copies step u into slot u % SLOTS): start() issues the first LOOK steps,
// a group each; take(u, b) waits until steps u .. u + b - 1 (b <= BATCH)
// have landed for every thread and every warp is done with the steps
// before, then issues b more into the slots those left: one barrier a
// batch of BATCH steps.
template <int SLOTS, int BATCH, typename Issue>
struct Pipe {
  static constexpr int LOOK = SLOTS - BATCH;  // steps in flight ahead
  const Issue& issue;
  int n_units;
  __device__ __forceinline__ void start() const {
#pragma unroll
    for (int u = 0; u < LOOK; ++u) {
      if (u < n_units) issue(u);
      cp_async_commit();
    }
  }
  __device__ __forceinline__ void take(int u, int b) const {
    cp_async_wait<LOOK - BATCH>();
    __syncthreads();
    for (int y = 0; y < b; ++y) {
      if (u + LOOK + y < n_units) issue(u + LOOK + y);
      cp_async_commit();
    }
  }
};

struct FragA {  // 16 x 8, row-major: rows g, g+8; columns t, t+4
  uint32_t hi[4], lo[4];
};
struct FragB {  // 8 x 8, column-major: rows (k) t, t+4; column g
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in f32 accuracy: a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// A = tile[r0 .. r0+16, c0 .. c0+8] of a shared tile (row stride ST)
template <int ST>
__device__ __forceinline__ FragA load_a(const float* s, int r0, int c0,
                                        int g, int t) {
  const float* p = s + (r0 + g) * ST + c0 + t;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ST], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ST + 4], f.hi[3], f.lo[3]);
  return f;
}

// load_a at a row stride `st` known at run time (a tile resident at row
// stride Dp + 4)
__device__ __forceinline__ FragA load_a_at(const float* s, int st, int r0,
                                           int c0, int g, int t) {
  const float* p = s + (r0 + g) * st + c0 + t;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * st], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * st + 4], f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = tile[n0 + n][k0 + k]: the tile's rows are B's columns (the
// K of Q K^T, the V of dO V^T, the Q of K Q^T, the dO of V dO^T)
template <int ST>
__device__ __forceinline__ FragB load_b_t(const float* s, int n0, int k0,
                                          int g, int t) {
  const float* p = s + (n0 + g) * ST + k0 + t;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// B[k][n] = tile[k0 + perm(k)][n0 + n], perm = {0, 2, 4, 6, 1, 3, 5, 7}:
// the tile's rows are B's rows, in the k order of an A made by a_from_c
template <int ST>
__device__ __forceinline__ FragB load_b_perm(const float* s, int k0, int n0,
                                             int g, int t) {
  const float* p = s + (k0 + 2 * t) * ST + n0 + g;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[ST], f.hi[1], f.lo[1]);
  return f;
}

// The f32 C fragment of an 8-column tile (rows g, g+8; columns 2t, 2t+1)
// as a tf32 A fragment over k permuted by perm: no data moves between lanes
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// Four 8 x 4 f32 tiles of shared memory into registers, one ldmatrix of
// four 8 x 8 b16 tiles: lanes 8m .. 8m + 7 give the row addresses
// (16-byte aligned) of tile m, and register m of lane 4 g + t holds its
// element (g, t). So tiles at (rows r, r + 8) x (columns c, c + 4) give an
// A fragment in load_a's order, and tiles at (rows n, columns c, c + 4)
// a B fragment in load_b_t's.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// the A fragment of four values in load_a's order (ldsm_x4)
__device__ __forceinline__ FragA frag_a(const uint32_t (&x)[4]) {
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(x[e]), f.hi[e], f.lo[e]);
  return f;
}

// the B fragment of two values in load_b_t's order (ldsm_x4)
__device__ __forceinline__ FragB frag_b(uint32_t x0, uint32_t x1) {
  FragB f;
  split(__uint_as_float(x0), f.hi[0], f.lo[0]);
  split(__uint_as_float(x1), f.hi[1], f.lo[1]);
  return f;
}

// acc[n] += A(c) * tile[perm rows, 8n .. 8n+8] (tile row stride ST), the
// NT k-steps of c summed in a fresh accumulator and then added in f32.
// The tensor cores' f32 accumulation does not round to nearest, so one
// mma chain through all of T drifts: at T = 2048 it moved dv by 2.5e-5 of
// its size. The fresh accumulators go GROUP n-tiles at a time, so that
// GROUP mma chains are in flight at once without 4 * ND more registers
// (4 * GROUP registers; a kernel at the register limit takes 2).
template <int ST, int GROUP = 4, int ND, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[ND][4],
                                           const float (&c)[NT][4],
                                           const float* tile, int g, int t) {
  static_assert(ND % GROUP == 0, "n-tiles must group evenly");
  FragA a[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) a[j] = a_from_c(c[j]);
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += GROUP) {
    float part[GROUP][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int n = 0; n < GROUP; ++n)
        mma3(part[n], a[j], load_b_perm<ST>(tile, j * 8, (n0 + n) * 8, g, t));
#pragma unroll
    for (int n = 0; n < GROUP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

}  // namespace
