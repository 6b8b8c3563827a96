// Fused 1x1-conv + batch-norm epilogue kernels for Hopper (sm_90a), f32
// accurate, the products on the tensor cores as 3xTF32 `wgmma`.
//
// Replaces the three Pallas TPU kernels of paddle_tpu/kernels/conv_epilogue.py,
// which the fused `conv1x1_bn_act` op runs in ResNet under
// --fused_conv_epilogue:
//
//   conv1x1_stats     y = x . W  [R, O], plus stats [2, O] = (sum_r y,
//                     sum_r y*y) of that y, in f32, in the same pass
//                     (`_stats_kernel`, launched by `conv1x1_stats`)
//   conv1x1_epilogue  out = act((x . W) * scale + shift [+ residual]); the
//                     raw product never reaches device memory unless K is
//                     split (`_epilogue_kernel`, launched by
//                     `conv1x1_epilogue`)
//   scale_shift_act   out = act(y * scale + shift [+ residual]), one read
//                     and one write of [R, O] (`_apply_kernel`, launched by
//                     `scale_shift_act`)
//
// x [R, I], W [I, O], y / residual / out [R, O] row-major f32; scale and
// shift [O] f32; act is none or relu. Every R, I and O is taken: ragged
// edges are zero-filled or masked here, so nothing falls back the way the
// TPU wrappers fall back to XLA when `_pick_block_r` finds no tile.
//
// What bounds the two GEMM kernels on the H100: the ResNet-50 1x1 convs do
// 2*R*I*O FLOPs on 4*(R*I + I*O + R*O) bytes. The card's fastest
// f32-accurate rate for products is 3xTF32 on the tensor cores (495 / 3 =
// 165 TFLOP/s against 67 for f32 FMA), which puts the ridge at ~50
// FLOP/byte: bound by operations at I, O >= 128, by bytes at I = 64.
// What the design does about it:
// - Products: `wgmma.mma_async.m64nNk8.f32.tf32.tf32`, N = 128 (or 64),
//   A from registers, B from shared memory. Each f32 operand splits into a
//   tf32 hi and lo = x - hi (tf32x3.cuh), and each product sums lo.hi +
//   hi.lo + hi.hi, small terms first. Each element is split once: W by a
//   pre-pass (split_w_kernel) into hi and lo copies of W^T, K-major as
//   wgmma needs tf32 operands in shared memory; x by the one thread of the
//   warpgroup that owns its row and K slot when it reads its A fragment.
// - A block of two warpgroups computes a 128 x BN output tile; BN is 64
//   when O <= 64, so no half tile of padding is computed there. K runs
//   through a ring of 32-deep stages (4 at BN = 128, 3 at BN = 64, so two
//   blocks fit an SM there). One thread fills a stage with three TMA
//   copies (x's tile, W's hi and lo tiles; zeros past R and I) counted on
//   an mbarrier; each thread releases a stage on a second one when its
//   products are done, and the refill of the stage before overlaps this
//   one's products. No block-wide barrier in the loop. W's tiles sit in
//   wgmma's 128-byte swizzle (see Ring). A ring of 16-byte cp.async
//   copies in their place bound the kernel: without its products it ran
//   as fast. x rows that TMA cannot take (I % 4 != 0) come by 4-byte
//   cp.async.
// - The output tile leaves through shared memory in whole rows of
//   16-byte runs, the affine, residual and relu applied on the way: at
//   I = 64 the kernel is bound by bytes, most of them y's.
// - The tensor cores' f32 accumulation does not round to nearest, so a
//   product chained over all of K drifts (the flash backward's dv, chained
//   over 2048 terms, erred 2.5e-5 of its size). Each stage's 12 products
//   go into fresh registers, added to the tile's sum in f32.
// - Small grids: where the 128 x BN tiles fill less than one wave of the
//   SMs (the inference shapes at R = 784 and 3136), the caller's tile plan
//   splits K into slices; each writes its partial product to scratch and
//   scale_shift_act_kernel adds the slices in a fixed order before the
//   affine. No atomics.
// - BN statistics: each thread sums its two rows per column, shuffles add
//   the 8 lanes that hold a column, and the 8 warps' sums are added in
//   order through shared memory into partial[row tile, 2, O];
//   stats_reduce_kernel adds the row tiles in a fixed order. Two launches
//   on the same inputs agree bitwise.
// scale_shift_act does 2-4 FLOPs a value and is bound by bytes: float4
// loads and stores when O % 4 == 0.
//
// The 1xTF32 instance (conv1x1_tf32_kernel; the precision policy
// default, the Pallas kernels' precision=None, XLA's DEFAULT on this
// card): the same tiles, ring, epilogue and statistics (gemm_tile), with
// x rounded once to tf32 by the thread that reads it (split's hi: round
// to nearest, ties away from zero, as cvt.rna), W's pre-pass
// (round_w_kernel) writing the rounded copy alone, and one wgmma a k8
// step: a third of the products and half of W's bytes a stage. At the
// dense TF32 rate (494.7 TFLOP/s) the ridge is ~148 FLOP/byte, about
// I*O/(2(I+O)) at large R: bound by bytes at ResNet-50's shapes with I or
// O <= 256.
//
// The bf16 instances (AMP: the JAX package's bf16 products on f32 master
// weights) take x and W in bf16, scale and shift in f32, a residual in bf16
// or f32, and write y / out in bf16; partial sums and statistics stay f32.
// They compute what the Pallas bodies compute for bf16 operands: f32
// accumulation (preferred_element_type=jnp.float32), statistics summed from
// the f32 accumulator (in the f32 instance's fixed order), the affine,
// residual and relu in f32, only the output rounded to bf16.
// - conv1x1_bf16_kernel: one bf16 `wgmma.m64nNk16` per 16-deep step, both
//   operands read from shared memory by descriptor, as TMA stores them in
//   the 128-byte swizzle: x's tile K-major (rows of 64 values), W's tile
//   MN-major as W [I, O] lies in memory (K rows of 64 values along N), so
//   there is no pre-pass over W.
// - Bound on the H100: 2*R*I*O FLOPs at 989 TFLOP/s on 2*(R*I + I*O + R*O)
//   bytes (bf16 in and out) at 3.35 TB/s: the ridge is ~295 FLOP/byte,
//   about I*O/(I+O) at large R, so ResNet-50's 1x1 shapes with I or O <= 256
//   are bound by bytes and the 512 x 1024 and x 2048 ones by operations.
//   Most of them are one or a few 64-deep K stages a 128 x BN tile (I = 64:
//   one), so what a tile costs besides its bytes, its epilogue above all
//   (the statistics' shuffles, the rounding, the stores), decides the time.
// - The design about that: a persistent, warp-specialised kernel. The grid
//   is one block an SM (the plan's `grid`: at most one a work item, a 128 x
//   BN tile and K slice), each walking items blockIdx.x, + gridDim.x, ...,
//   column tiles fastest (work_item). A block is a producer warpgroup
//   (setmaxnreg 40; one thread issues every TMA copy) and two consumer
//   warpgroups (setmaxnreg 232) of 64 rows each (ws_ring.cuh). The
//   producer streams the (x box, W boxes) stages of every item through a
//   full/empty mbarrier ring (4 stages at BN = 128, 7 at BN = 64) across
//   item boundaries, so the next items' loads are in flight while the
//   consumers run an item's epilogue. A residual is read in the
//   accumulator's layout, a row's loads all started before the first is
//   used (an L2 prefetch of its tile by the producer measured slower).
// - Each 64-deep stage's 4 products go into fresh registers, added in f32
//   (the tensor cores' accumulation truncates), as before: two launches
//   give what the one-block-a-tile kernel gave, bit for bit.
// - The epilogue leaves by TMA stores: each consumer warpgroup rounds its
//   [64, BN] once into its staging tile, y by stmatrix, out by 4-byte
//   stores (a row of packed values for stmatrix spills the affine
//   epilogue at BN = 128), and one of its threads stores the boxes
//   (cp.async.bulk.tensor); stores from registers measured slower. Where O % 8 != 0 the rows are not 16-byte
//   aligned and the kernel stores from registers; a split K's raw f32
//   slices too. The statistics keep their fixed order (the thread's pair,
//   shuffles over 8 lanes, the 8 warps in order through shared memory,
//   behind a named barrier of the 256 consumer threads); stats_reduce_kernel
//   adds the row tiles after.
// - scale_shift_act in bf16 (y and out bf16, residual bf16 or f32): the f32
//   kernel's pass over four values a thread, 8-byte bf16 loads and stores.
#include <cuda.h>  // CUtensorMap (its encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"
#include "ws_ring.cuh"

namespace {

constexpr int BM = 128;        // output rows per block: two warpgroups of 64
constexpr int BK = 32;         // K depth of one ring stage
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int RED_X = 32;      // stats reduction block: 32 columns
constexpr int RED_Y = 32;      //   x 32 row-tile lanes

enum Epilogue { kStats = 0, kAffine = 1 };

typedef __nv_bfloat16 bf16;

// four consecutive values (16-byte aligned f32, 8-byte aligned bf16) as
// f32, and back; bf16 stores round to nearest
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One ring stage in shared memory, in floats: the x tile [BM][BK], row
// after row; then W's hi and lo tiles, each BN x BK, K-major in wgmma's
// 128-byte swizzle: row n is 128 bytes (BK floats), its 16-byte chunk c
// at c ^ (n % 8), as the tensor memory accelerator (TMA) writes it. Every
// stage starts on a 1024-byte boundary, as that swizzle needs. After the
// stages come the ring's barriers: full[s] (the stage's copies have
// landed) and empty[s] (every thread is done with it). (W's tiles without
// a swizzle, in 128-byte core matrices 128 and 1024 bytes apart, made the
// kernel markedly slower: those share banks.) X3: the 3xTF32 instance's
// stage holds W's hi and lo tiles, the 1xTF32 instance's W's rounded tile
// alone.
template <int BN, bool X3>
struct Ring {
  static constexpr int STAGES = BN == 128 ? 4 : 3;
  static constexpr int A = BM * BK;
  static constexpr int B = BN * BK;
  static constexpr int NW = X3 ? 2 : 1;  // W tiles a stage
  static constexpr int STAGE = A + NW * B;
  static constexpr int BARRIERS = STAGES * STAGE * 4;  // byte offset
  static constexpr int BYTES = BARRIERS + 2 * STAGES * 8;
  // the epilogue's staged tile and the stats' per-warp sums reuse it
  static_assert(BM * (BN + 8) + 2 * NWARPS * BN <= STAGES * STAGE,
                "the epilogue must fit the ring");
  static_assert(STAGE * 4 % 1024 == 0 && A * 4 % 1024 == 0,
                "stages and W's tiles must keep the swizzle's alignment");
};

// x's K steps [k0, k0 + BK) of this block's rows into an A tile, 4 bytes
// at a time (rows of x that are not 16-byte aligned, I % 4 != 0, which
// TMA does not take); rows past R and columns past I land as zeros.
__device__ __forceinline__ void copy_a(float* dst, const float* __restrict__ x,
                                       int R, int I, int row0, int k0) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < BM * BK; idx += NTHREADS) {
    const int r = idx / BK, k = k0 + idx % BK;
    const bool in = row0 + r < R && k < I;
    cp_async4(dst + idx, x + (in ? (size_t)(row0 + r) * I + k : 0), in);
  }
}

// The 128 x BN output tile blockIdx.x (column tiles fastest, so the tiles
// that share x rows run together and read them from L2) over the K steps
// of slice blockIdx.y. kStats: y and this row tile's column sums into
// partial[tile, 2, O]. kAffine: act(y * scale + shift [+ residual]), or,
// with scale null (a split K), the raw slice into out + slice * R * O.
// X3: 3xTF32 (x split into hi and lo as it is read, W's hi and lo tiles,
// three products a k8 step); else 1xTF32, the Pallas kernels'
// precision=None (x rounded to tf32 as it is read, W's rounded tile, one
// product a k8 step). Everything after the products is shared.
template <int BN, bool TMA_A, int EPI, bool X3>
__device__ __forceinline__ void gemm_tile(
    const CUtensorMap& xmap, const CUtensorMap& wmap, float* smem,
    const float* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ residual,
    float* __restrict__ out, float* __restrict__ partial, int R, int I, int O,
    int i_pad, int o_pad, int slice_steps, int relu) {
  using L = Ring<BN, X3>;
  constexpr int NACC = BN / 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem) + L::BARRIERS);
  uint64_t* empty = full + L::STAGES;
  const int tiles_o = o_pad / BN;
  const int tile_r = blockIdx.x / tiles_o;
  const int row0 = tile_r * BM;
  const int col0 = (blockIdx.x % tiles_o) * BN;
  const int step0 = blockIdx.y * slice_steps;
  const int nk = max(0, min(slice_steps, i_pad / BK - step0));

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int r_in = 16 * warp + g;  // this thread's rows: r_in, r_in + 8

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      // thread 0's expect, plus every thread's cp.async copies of x
      mbar_init(&full[s], TMA_A ? 1 : 1 + NTHREADS);
      mbar_init(&empty[s], NTHREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage i into slot i % STAGES: thread 0 starts the TMA copies (x's tile
  // too when TMA_A), every thread its cp.async copies of x otherwise.
  auto produce = [&](int i) {
    float* st = smem + (i % L::STAGES) * L::STAGE;
    uint64_t* bar = &full[i % L::STAGES];
    const int k0 = (step0 + i) * BK;
    if (threadIdx.x == 0) {
      mbar_expect(bar, (TMA_A ? L::A * 4 : 0) + L::NW * L::B * 4);
      if (TMA_A) tma_load(st, &xmap, k0, row0, bar);
      tma_load(st + L::A, &wmap, k0, col0, bar);
      if (X3) tma_load(st + L::A + L::B, &wmap, k0, o_pad + col0, bar);
    }
    if (!TMA_A) {
      copy_a(st, x, R, I, row0, k0);
      cp_async_arrive(bar);
    }
  };
  for (int s = 0; s < L::STAGES - 1 && s < nk; ++s) produce(s);

  float acc[NACC], part[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = part[e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % L::STAGES;
    mbar_wait(&full[slot], (kt / L::STAGES) & 1);

    // A fragments of the stage's four k8 steps. The K order inside each
    // 16-deep block is permuted (split_w_kernel writes W^T to match), so
    // that one 16-byte read gives a row's k slots t and t + 4 of two steps.
    const float* st = smem + slot * L::STAGE;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = (4 * u + t) * 4;
      const float4 v0 = *reinterpret_cast<const float4*>(st + r_in * BK + c);
      const float4 v1 =
          *reinterpret_cast<const float4*>(st + (r_in + 8) * BK + c);
      split(v0.x, ahi[2 * u][0], alo[2 * u][0]);
      split(v1.x, ahi[2 * u][1], alo[2 * u][1]);
      split(v0.y, ahi[2 * u][2], alo[2 * u][2]);
      split(v1.y, ahi[2 * u][3], alo[2 * u][3]);
      split(v0.z, ahi[2 * u + 1][0], alo[2 * u + 1][0]);
      split(v1.z, ahi[2 * u + 1][1], alo[2 * u + 1][1]);
      split(v0.w, ahi[2 * u + 1][2], alo[2 * u + 1][2]);
      split(v1.w, ahi[2 * u + 1][3], alo[2 * u + 1][3]);
    }
    const uint64_t dhi = sw128_desc(st + L::A),
                   dlo = X3 ? sw128_desc(st + L::A + L::B) : 0;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const uint64_t step = s * (32 >> 4);
      if (X3) {
        Wgmma<BN>::mma(part, alo[s], dhi + step, s);  // s == 0: fresh
        Wgmma<BN>::mma(part, ahi[s], dlo + step, 1);
      }
      Wgmma<BN>::mma(part, ahi[s], dhi + step, X3 || s > 0);
    }
    wgmma_commit();

    // while the products run: refill the slot stage kt - 1 used, once
    // every thread has let it go
    const int nxt = kt + L::STAGES - 1;
    if (nxt < nk && (TMA_A ? threadIdx.x == 0 : true)) {
      if (kt > 0) mbar_wait(&empty[nxt % L::STAGES], (kt - 1) / L::STAGES & 1);
      produce(nxt);
    }

    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] += part[e];
    mbar_arrive(&empty[slot]);
  }
  __syncthreads();  // every warp is done with the ring

  // The tile goes through shared memory (rows of OST floats: the float2
  // writes of a half-warp hit 32 distinct banks), so that its rows leave
  // as whole 16-byte runs, with the affine, residual and relu applied on
  // the way.
  constexpr int OST = BN + 8;
  float* ot = smem;
  if (EPI == kStats) {
    // column sums: this thread's two rows, the 8 lanes (g) that share the
    // column by shuffles, then the 8 warps in order (rows past R hold
    // exact zeros)
    float* red = smem + BM * OST;  // [NWARPS][2][BN]
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = acc[4 * j + e], b = acc[4 * j + 2 + e];
        float s = a + b, q = fmaf(b, b, a * a);
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, m);
          q += __shfl_xor_sync(0xffffffffu, q, m);
        }
        if (g == 0) {
          red[(2 * warp) * BN + 8 * j + 2 * t + e] = s;
          red[(2 * warp + 1) * BN + 8 * j + 2 * t + e] = q;
        }
      }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(ot + (r_in + 8 * h) * OST + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();

  if (EPI == kStats) {
    const float* red = smem + BM * OST;
    for (int idx = threadIdx.x; idx < 2 * BN; idx += NTHREADS) {
      const int stat = idx / BN, c = idx % BN;
      if (col0 + c >= O) continue;
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) total += red[(2 * w + stat) * BN + c];
      partial[((size_t)tile_r * 2 + stat) * O + col0 + c] = total;
    }
  }
  // kStats: y; kAffine: act(y * scale + shift [+ residual]), or the raw
  // slice of a split K (scale null) at out + slice * R * O
  const bool affine = EPI == kAffine && scale != nullptr;
  float* dst = out + (size_t)blockIdx.y * R * O;
  if ((O & 3) == 0) {  // float4 runs: 16-byte aligned, inside a row
#pragma unroll 4
    for (int idx = threadIdx.x; idx < BM * BN / 4; idx += NTHREADS) {
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const int row = row0 + r, col = col0 + c;
      if (row >= R || col >= O) continue;
      float4 v = *reinterpret_cast<const float4*>(ot + r * OST + c);
      const size_t at = (size_t)row * O + col;
      if (affine) {
        const float4 sc = *reinterpret_cast<const float4*>(scale + col);
        const float4 sh = *reinterpret_cast<const float4*>(shift + col);
        v = make_float4(v.x * sc.x + sh.x, v.y * sc.y + sh.y,
                        v.z * sc.z + sh.z, v.w * sc.w + sh.w);
        if (residual != nullptr) {
          const float4 res = *reinterpret_cast<const float4*>(residual + at);
          v.x += res.x; v.y += res.y; v.z += res.z; v.w += res.w;
        }
        if (relu)
          v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f),
                          fmaxf(v.w, 0.f));
      }
      *reinterpret_cast<float4*>(dst + at) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
      const int r = idx / BN, c = idx % BN;
      const int row = row0 + r, col = col0 + c;
      if (row >= R || col >= O) continue;
      float v = ot[r * OST + c];
      const size_t at = (size_t)row * O + col;
      if (affine) {
        v = v * scale[col] + shift[col];
        if (residual != nullptr) v += residual[at];
        if (relu) v = fmaxf(v, 0.f);
      }
      dst[at] = v;
    }
  }
}

#define GEMM_PARAMS                                                       \
  const __grid_constant__ CUtensorMap xmap,                               \
      const __grid_constant__ CUtensorMap wmap,                           \
      const float* __restrict__ x, const float* __restrict__ scale,       \
      const float* __restrict__ shift, const float* __restrict__ residual, \
      float* __restrict__ out, float* __restrict__ partial, int R, int I, \
      int O, int i_pad, int o_pad, int slice_steps, int relu
#define GEMM_ARGS                                                         \
  xmap, wmap, smem, x, scale, shift, residual, out, partial, R, I, O,     \
      i_pad, o_pad, slice_steps, relu

// The two instances, each a kernel of its own name: 3xTF32 (f32
// accurate: the policies high and highest) and 1xTF32 (default).
template <int BN, bool TMA_A, int EPI>
__global__ void __launch_bounds__(NTHREADS, BN == 128 ? 1 : 2)
conv1x1_tf32x3_kernel(GEMM_PARAMS) {
  extern __shared__ __align__(1024) float smem[];
  gemm_tile<BN, TMA_A, EPI, true>(GEMM_ARGS);
}

template <int BN, bool TMA_A, int EPI>
__global__ void __launch_bounds__(NTHREADS, BN == 128 ? 1 : 2)
conv1x1_tf32_kernel(GEMM_PARAMS) {
  extern __shared__ __align__(1024) float smem[];
  gemm_tile<BN, TMA_A, EPI, false>(GEMM_ARGS);
}

// wt[h][n][p] for h = 0 (hi), 1 (lo), n < o_pad, p < i_pad: the split of
// w[k][n] (0 past I or O), K-major, with k permuted inside each 16-deep
// block as the main loop's A fragments read x: position 16u + 8h' + q
// holds k = 16u + 4 (q % 4) + 2h' + q / 4. One 32 x 32 tile per block of
// 32 x 8 threads, transposed through shared memory.
// X3 false (round_w_kernel): wt[0] alone, w rounded to tf32 as the main
// loop rounds x.
template <bool X3>
__device__ __forceinline__ void prepare_w(const float* __restrict__ w,
                                          float* __restrict__ wt, int I,
                                          int O, int i_pad, int o_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int ky = ty; ky < 32; ky += 8) {
    const int k = k0 + ky, n = n0 + tx;
    tile[ky][tx] = (k < I && n < O) ? w[(size_t)k * O + n] : 0.f;
  }
  __syncthreads();
  const int kl = 16 * (tx >> 4) + 4 * (tx & 3) + 2 * ((tx >> 3) & 1) +
                 ((tx >> 2) & 1);
  for (int ny = ty; ny < 32; ny += 8) {
    uint32_t hi, lo;
    split(tile[kl][ny], hi, lo);
    const size_t at = (size_t)(n0 + ny) * i_pad + k0 + tx;
    wt[at] = __uint_as_float(hi);
    if (X3) wt[(size_t)o_pad * i_pad + at] = __uint_as_float(lo);
  }
}

__global__ void split_w_kernel(const float* __restrict__ w,
                               float* __restrict__ wt, int I, int O,
                               int i_pad, int o_pad) {
  prepare_w<true>(w, wt, I, O, i_pad, o_pad);
}

__global__ void round_w_kernel(const float* __restrict__ w,
                               float* __restrict__ wt, int I, int O,
                               int i_pad, int o_pad) {
  prepare_w<false>(w, wt, I, O, i_pad, o_pad);
}

// stats[s, c] = sum over row tiles t, in order, of partial[t, s, c]. Block
// (32 x 32): 32 columns; lane y sums tiles y, y + 32, ... in order, then
// lane 0 adds the 32 lane sums in order.
__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ stats, int tiles,
                                    int O) {
  __shared__ float lane_sum[RED_Y][RED_X + 1];
  const int c = blockIdx.x * RED_X + threadIdx.x;
  const int s = blockIdx.y;
  float total = 0.f;
  if (c < O)
    for (int t = threadIdx.y; t < tiles; t += RED_Y)
      total += partial[((size_t)t * 2 + s) * O + c];
  lane_sum[threadIdx.y][threadIdx.x] = total;
  __syncthreads();
  if (threadIdx.y == 0 && c < O) {
    float sum = 0.f;
    for (int y = 0; y < RED_Y; ++y) sum += lane_sum[y][threadIdx.x];
    stats[(size_t)s * O + c] = sum;
  }
}

// out = act(y * scale + shift [+ residual]) over a contiguous [R, O] of n
// values, in f32; with SLICES, y is the sum of `slices` such [R, O] planes
// n apart, added in order (a split-K product). TY, TR, TO: the types of y,
// the residual and out (f32, or bf16 in the AMP instances).
template <bool VEC, bool SLICES, typename TY, typename TR, typename TO>
__global__ void scale_shift_act_kernel(const TY* __restrict__ y, int slices,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ shift,
                                       const TR* __restrict__ residual,
                                       TO* __restrict__ out, long long n,
                                       int O, int relu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (VEC) {  // O % 4 == 0: four values never straddle two rows
    const long long n4 = n / 4;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
         i += stride) {
      const long long e = i * 4;
      const int c = (int)(e % O);
      float4 v = load4(y + e);
      if (SLICES)
        for (int s = 1; s < slices; ++s) {
          const float4 p = load4(y + s * n + e);
          v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
        }
      float o[4] = {v.x * scale[c] + shift[c], v.y * scale[c + 1] + shift[c + 1],
                    v.z * scale[c + 2] + shift[c + 2],
                    v.w * scale[c + 3] + shift[c + 3]};
      if (residual != nullptr) {
        const float4 r = load4(residual + e);
        o[0] += r.x; o[1] += r.y; o[2] += r.z; o[3] += r.w;
      }
      if (relu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = o[j] < 0.f ? 0.f : o[j];
      }
      store4(out + e, make_float4(o[0], o[1], o[2], o[3]));
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const int c = (int)(i % O);
      float v = to_f32(y[i]);
      if (SLICES)
        for (int s = 1; s < slices; ++s) v += to_f32(y[s * n + i]);
      float o = v * scale[c] + shift[c];
      if (residual != nullptr) o += to_f32(residual[i]);
      if (relu) o = o < 0.f ? 0.f : o;
      store1(out + i, o);
    }
  }
}

int pad_to(int v, int m) { return (v + m - 1) / m * m; }

// The tile plan the caller chose (kernels/conv_epilogue.py `tile_plan`):
// BN 64 or 128, and `slices` K slices of `slice_steps` bk-deep steps that
// cover I, none of them empty.
bool plan_ok(int I, int bk, int bn, int slices, int slice_steps) {
  const int k_steps = pad_to(I, bk) / bk;
  if (bn != 64 && bn != 128) return false;
  if (slices < 1 || slice_steps < 0) return false;
  return (long long)slices * slice_steps >= k_steps &&
         (slices == 1 || (long long)(slices - 1) * slice_steps < k_steps);
}

// W's pre-pass: its hi and lo copies (x3) or its rounded copy alone.
cudaError_t prepare_w(const float* w, float* wt, int I, int O, int bn,
                      bool x3, cudaStream_t s) {
  const int i_pad = pad_to(I, BK), o_pad = pad_to(O, bn);
  if (i_pad == 0) return cudaSuccess;
  const dim3 grid(i_pad / 32, o_pad / 32), block(32, 8);
  if (x3)
    split_w_kernel<<<grid, block, 0, s>>>(w, wt, I, O, i_pad, o_pad);
  else
    round_w_kernel<<<grid, block, 0, s>>>(w, wt, I, O, i_pad, o_pad);
  return cudaGetLastError();
}

template <int BN, int EPI, bool X3>
cudaError_t launch_gemm(const float* x, const float* wt, const float* scale,
                        const float* shift, const float* residual, float* out,
                        float* partial, int R, int I, int O, int slices,
                        int slice_steps, int relu, cudaStream_t stream) {
  const int i_pad = pad_to(I, BK), o_pad = pad_to(O, BN);
  const dim3 grid((unsigned)((R + BM - 1) / BM * (o_pad / BN)), slices);
  // TMA copies x where its rows are 16-byte aligned; W's split copies
  // always (padded to BK and BN)
  const bool va = I % 4 == 0;
  CUtensorMap xmap = {}, wmap = {};
  if (i_pad > 0) {
    cudaError_t err = cudaSuccess;
    if (va)
      err = tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, I, R, I,
                       BK, BM, false);
    if (err == cudaSuccess)
      err = tensor_map(&wmap, wt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, i_pad,
                       Ring<BN, X3>::NW * o_pad, i_pad, BK, BN, true);
    if (err != cudaSuccess) return err;
  }
  auto kernel = X3 ? (va ? conv1x1_tf32x3_kernel<BN, true, EPI>
                         : conv1x1_tf32x3_kernel<BN, false, EPI>)
                   : (va ? conv1x1_tf32_kernel<BN, true, EPI>
                         : conv1x1_tf32_kernel<BN, false, EPI>);
  constexpr int bytes = Ring<BN, X3>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      xmap, wmap, x, scale, shift, residual, out, partial, R, I, O, i_pad,
      o_pad, slice_steps, relu);
  return cudaGetLastError();
}

template <int EPI, bool X3>
cudaError_t launch_gemm_bn(int bn, const float* x, const float* wt,
                        const float* scale, const float* shift,
                        const float* residual, float* out, float* partial,
                        int R, int I, int O, int slices, int slice_steps,
                        int relu, cudaStream_t stream) {
  return bn == 64
             ? launch_gemm<64, EPI, X3>(x, wt, scale, shift, residual, out,
                                        partial, R, I, O, slices,
                                        slice_steps, relu, stream)
             : launch_gemm<128, EPI, X3>(x, wt, scale, shift, residual, out,
                                         partial, R, I, O, slices,
                                         slice_steps, relu, stream);
}

// y = x . w and stats [2, O], 3xTF32 (x3) or 1xTF32: W's pre-pass, the
// GEMM with the statistics' per-tile sums, their fixed-order reduction.
template <bool X3>
int stats_f32(const float* x, const float* w, float* wt, float* y,
              float* partial, float* stats, int R, int I, int O, int bn,
              void* stream) {
  if (R <= 0 || O <= 0) return (int)cudaSuccess;
  const int k_steps = pad_to(I, BK) / BK;
  if (!plan_ok(I, BK, bn, 1, k_steps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_w(w, wt, I, O, bn, X3, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm_bn<kStats, X3>(bn, x, wt, nullptr, nullptr, nullptr, y,
                                   partial, R, I, O, 1, k_steps, 0, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((O + RED_X - 1) / RED_X, 2);
  stats_reduce_kernel<<<grid, dim3(RED_X, RED_Y), 0, s>>>(
      partial, stats, (R + BM - 1) / BM, O);
  return (int)cudaGetLastError();
}

template <typename TY, typename TR, typename TO>
cudaError_t launch_apply(const TY* y, int slices, const float* scale,
                         const float* shift, const TR* residual, TO* out,
                         long long R, int O, int relu, cudaStream_t s) {
  const long long n = R * (long long)O;
  const bool vec = O % 4 == 0;
  const long long work = vec ? n / 4 : n;
  const long long cap = 132LL * 32;  // ~32 blocks of 256 per SM, grid-stride
  long long blocks = (work + 255) / 256;
  if (blocks > cap) blocks = cap;
  const unsigned b = (unsigned)blocks;
  if (slices > 1) {
    if (vec)
      scale_shift_act_kernel<true, true, TY, TR, TO><<<b, 256, 0, s>>>(
          y, slices, scale, shift, residual, out, n, O, relu);
    else
      scale_shift_act_kernel<false, true, TY, TR, TO><<<b, 256, 0, s>>>(
          y, slices, scale, shift, residual, out, n, O, relu);
  } else if (vec) {
    scale_shift_act_kernel<true, false, TY, TR, TO><<<b, 256, 0, s>>>(
        y, 1, scale, shift, residual, out, n, O, relu);
  } else {
    scale_shift_act_kernel<false, false, TY, TR, TO><<<b, 256, 0, s>>>(
        y, 1, scale, shift, residual, out, n, O, relu);
  }
  return cudaGetLastError();
}

// out = act((x . w) * scale + shift [+ residual]), 3xTF32 (x3) or
// 1xTF32; a split K's slices go through slice_out and scale_shift_act.
template <bool X3>
int epilogue_f32(const float* x, const float* w, float* wt,
                 const float* scale, const float* shift,
                 const float* residual, float* out, float* slice_out, int R,
                 int I, int O, int relu, int bn, int slices, int slice_steps,
                 void* stream) {
  if (R <= 0 || O <= 0) return (int)cudaSuccess;
  if (!plan_ok(I, BK, bn, slices, slice_steps) ||
      (slices > 1 && slice_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare_w(w, wt, I, O, bn, X3, s);
  if (err != cudaSuccess) return (int)err;
  if (slices == 1)
    return (int)launch_gemm_bn<kAffine, X3>(bn, x, wt, scale, shift,
                                            residual, out, nullptr, R, I, O,
                                            1, slice_steps, relu, s);
  err = launch_gemm_bn<kAffine, X3>(bn, x, wt, nullptr, nullptr, nullptr,
                                    slice_out, nullptr, R, I, O, slices,
                                    slice_steps, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_apply(slice_out, slices, scale, shift, residual, out, R,
                           O, relu, s);
}

// --- the bf16 instances ----------------------------------------------------

constexpr int BK16 = 64;  // bf16 K depth of one ring stage: rows of 128 bytes
constexpr int BF16_BLOCKS_PER_SM = 1;  // 384 threads at 168 registers
constexpr int OUT_BOX = 64 * 64 * 2;   // a [64 rows][64 columns] bf16 box

// Shared memory of conv1x1_bf16_kernel at BN, in bytes: the ring's
// stages (x's [BM][BK16] box K-major, then W's BN / 64 boxes of
// [BK16][64], MN-major as W [I, O] lies, each in the 128-byte swizzle
// TMA writes: see sw128_desc, sw128_mn_desc); then the output staging
// tile, each consumer warpgroup's [64, BN] as BN / 64 boxes of [64][64]
// in the same swizzle, which its TMA stores read; then the statistics'
// per-warp column sums [8 warps][2][BN] f32 for two items, so that one
// barrier an item keeps the next item's writers off this item's
// readers; then the ring's barriers. Every box starts on a 1024-byte
// boundary.
template <int BN>
struct RingBf16 {
  static constexpr int STAGES = BN == 128 ? 4 : 7;
  static constexpr int NB = BN / 64;
  static constexpr int A = BM * BK16 * 2;
  static constexpr int B_BOX = 64 * BK16 * 2;  // one 64-wide N box
  static constexpr int STAGE = A + NB * B_BOX;
  static constexpr int OUT = STAGES * STAGE;
  static constexpr int RED = OUT + 2 * NB * OUT_BOX;
  static constexpr int RED_TILE = CONSUMER_WARPS * 2 * BN;  // floats
  static constexpr int BARS = RED + 2 * RED_TILE * 4;
  static constexpr int BYTES = BARS + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0 && OUT % 1024 == 0,
                "boxes must keep the swizzle's alignment");
  static_assert(BYTES <= 232448, "more shared memory than a block has");
};

// Work item t of a block's walk (t = blockIdx.x, + gridDim.x, ...): the
// 128 x BN output tile and K slice it covers. Column tiles run fastest,
// then row tiles, then slices, so that the blocks at work at one moment
// read the same rows of x, the second time from L2.
struct Work {
  int row0, col0, tile_r, slice, step0, nk;
};

template <int BN>
__device__ __forceinline__ Work work_item(int t, int tiles_o, int tiles,
                                          int k_steps, int slice_steps) {
  Work w;
  w.slice = t / tiles;
  const int rc = t - w.slice * tiles;
  w.tile_r = rc / tiles_o;
  w.row0 = w.tile_r * BM;
  w.col0 = (rc - w.tile_r * tiles_o) * BN;
  w.step0 = w.slice * slice_steps;
  w.nk = max(0, min(slice_steps, k_steps - w.step0));
  return w;
}

// Consumer warpgroup cw's products of ring stage i (counted over the
// kernel): its 64 rows of x's box times W's boxes, the four k16 steps
// summed into fresh registers p, committed as one group for the caller
// to wait for. Returns the stage's slot.
template <class L, int BN>
__device__ __forceinline__ int stage_products(float (&p)[BN / 2],
                                              const unsigned char* ring,
                                              uint64_t* full, int i, int cw) {
  const int s = i % L::STAGES;
  mbar_wait(&full[s], (i / L::STAGES) & 1);
  const unsigned char* st = ring + s * L::STAGE;
  // a k16 step is 32 bytes along x's rows (+2) and 16 of W's rows (+128)
  const uint64_t da =
      sw128_desc(reinterpret_cast<const float*>(st + cw * 64 * BK16 * 2));
  const uint64_t db = sw128_mn_desc(st + L::A, L::B_BOX);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < BK16 / 16; ++k)
    WgmmaBf16<BN>::mma(p, da + 2 * k, db + 128 * k, k);  // k == 0: fresh
  wgmma_commit();
  return s;
}

// A consumer warp is done with ring slot s.
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[s]);
}

template <int N>
__device__ __forceinline__ void add_into(float (&acc)[N],
                                         const float (&p)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] += p[e];
}

// Four 8 x 8 bf16 blocks from a warp's registers to shared memory: lane l
// holds row l / 4, columns 2 (l % 4) and + 1 of each block, packed (mma's
// C layout), and gives the address of row l % 8 of block l / 8.
__device__ __forceinline__ void stmatrix_x4(void* row, uint32_t b0,
                                            uint32_t b1, uint32_t b2,
                                            uint32_t b3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_u32(row)),
      "r"(b0), "r"(b1), "r"(b2), "r"(b3)
      : "memory");
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}

// Values a, b of columns c, c + 1 of a row-major [R, O] row at p (= its
// column c): both where O is even (8- or 4-byte aligned), else each as
// far as O reaches.
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b, int c,
                                           int O) {
  if ((O & 1) == 0) {
    store2(p, a, b);
  } else {
    store1(p, a);
    if (c + 1 < O) store1(p + 1, b);
  }
}

// The bf16 GEMM, persistent and warp-specialised: gridDim.x blocks, each
// walking the work items t = blockIdx.x, + gridDim.x, ... (work_item).
// bf16 operands, f32 accumulation. kStats: y in bf16 into out and each
// row tile's column sums (of the f32 accumulator) into partial[tile, 2,
// O]. kAffine: act(y * scale + shift [+ residual]) into out in bf16, or,
// with slice_out (a split K), the raw f32 slice into slice_out + slice *
// R * O. tma_out: out's rows start 16 bytes apart (O % 8 == 0), so its
// tiles leave by TMA stores (omap).
template <int RES_F32>
using Residual = typename std::conditional<RES_F32 != 0, float, bf16>::type;

template <int BN, int EPI, int RES_F32>
__global__ void __launch_bounds__(WS_THREADS, 1)
conv1x1_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap omap,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const Residual<RES_F32>* __restrict__ residual,
                    bf16* __restrict__ out, float* __restrict__ slice_out,
                    float* __restrict__ partial, int R, int O, int k_steps,
                    int slice_steps, int slices, int relu, int tma_out) {
  using L = RingBf16<BN>;
  constexpr int NACC = BN / 2;
  extern __shared__ __align__(1024) float smem_f32[];  // as the f32 kernel's
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f32);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + L::STAGES;
  const int tiles_o = (O + BN - 1) / BN;
  const int tiles = (R + BM - 1) / BM * tiles_o;
  const int work = tiles * slices;

  init_ring<L::STAGES, 0>(full);

  if (threadIdx.x < 128) {  // the producer: every stage of every item
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int i = 0;
      for (int tt = blockIdx.x; tt < work; tt += gridDim.x) {
        const Work w = work_item<BN>(tt, tiles_o, tiles, k_steps,
                                     slice_steps);
        for (int kt = 0; kt < w.nk; ++kt, ++i) {
          const int s = ring_acquire<L::STAGES>(full, empty, i, L::STAGE);
          unsigned char* st = smem + s * L::STAGE;
          const int k0 = (w.step0 + kt) * BK16;
          tma_load(reinterpret_cast<float*>(st), &xmap, k0, w.row0, &full[s]);
#pragma unroll
          for (int h = 0; h < L::NB; ++h)
            tma_load(reinterpret_cast<float*>(st + L::A + h * L::B_BOX),
                     &wmap, w.col0 + 64 * h, k0, &full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64 cw..
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cwarp = 4 * cw + warp;  // the consumer warps in row order
  const int r_wg = 16 * warp + g;   // this thread's rows: r_wg, r_wg + 8
  const bool issuer = threadIdx.x % 128 == 0;
  unsigned char* staged = smem + L::OUT + cw * L::NB * OUT_BOX;
  const bool affine = EPI == kAffine && slice_out == nullptr;

  float acc[NACC], part[NACC];
  int i = 0, par = 0;
  for (int tt = blockIdx.x; tt < work; tt += gridDim.x, par ^= 1) {
    const Work w = work_item<BN>(tt, tiles_o, tiles, k_steps, slice_steps);
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
    // Each stage's four products go into fresh registers, added to acc
    // in f32 in stage order (the tensor cores' accumulation truncates),
    // and the stage is released once they have read it. (A second stage
    // in flight, in a second set of fresh registers waited for with
    // wgmma.wait_group 1, spills the affine epilogue at BN = 128.)
    for (int kt = 0; kt < w.nk; ++kt, ++i) {
      const int slot = stage_products<L, BN>(part, smem, full, i, cw);
      wgmma_wait_all();
      fence_regs(part);
      add_into(acc, part);
      release(empty, slot, lane);
    }

    // The epilogue, while the producer fills the ring with the next
    // items' stages. The staging tile is free once this warpgroup's last
    // TMA store has read it.
    if (tma_out && issuer) bulk_wait_read();
    if (EPI == kStats) {
      // column sums: this thread's two rows, the 8 lanes (g) that share
      // the column by shuffles, then the 8 warps in order (rows past R
      // hold exact zeros), as in conv1x1_tf32x3_kernel
      float* red = reinterpret_cast<float*>(smem + L::RED) + par * L::RED_TILE;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[4 * j + e], b = acc[4 * j + 2 + e];
          float s = a + b, q = fmaf(b, b, a * a);
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, m);
            q += __shfl_xor_sync(0xffffffffu, q, m);
          }
          if (g == 0) {
            red[(2 * cwarp) * BN + 8 * j + 2 * t + e] = s;
            red[(2 * cwarp + 1) * BN + 8 * j + 2 * t + e] = q;
          }
        }
      consumers_sync();  // also: both staging tiles are free
      const int idx = threadIdx.x - 128;
      if (idx < 2 * BN && w.col0 + idx % BN < O) {
        const int stat = idx / BN, c = idx % BN;
        float total = 0.f;
#pragma unroll
        for (int v = 0; v < CONSUMER_WARPS; ++v)
          total += red[(2 * v + stat) * BN + c];
        partial[((size_t)w.tile_r * 2 + stat) * O + w.col0 + c] = total;
      }
    } else if (tma_out) {
      warpgroup_sync(cw);
    }

    // kStats: y; kAffine: act(y * scale + shift [+ residual]) in f32,
    // rounded once; or a split K's raw f32 slice. The loads of this
    // thread's scale and shift values, and row by row (h) of its residual
    // values, are started before the first is used. y leaves registers as
    // 8 x 8 blocks by stmatrix; out by 4-byte stores, as the affine's
    // values leave no registers for a row of packed ones (it spilled).
    float2 sc[BN / 8], sh[BN / 8];
    if (affine) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = w.col0 + 8 * j + 2 * t;
        sc[j] = sh[j] = make_float2(0.f, 0.f);
        if (c >= O) continue;
        if ((O & 1) == 0) {  // columns c and c + 1
          sc[j] = load2(scale + c);
          sh[j] = load2(shift + c);
        } else {
          sc[j] = make_float2(scale[c], c + 1 < O ? scale[c + 1] : 0.f);
          sh[j] = make_float2(shift[c], c + 1 < O ? shift[c + 1] : 0.f);
        }
      }
    }
    float* raw = slice_out == nullptr
                     ? nullptr
                     : slice_out + (size_t)w.slice * R * O;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_wg + 8 * h;
      const int row = w.row0 + 64 * cw + r;
      const size_t at_row = (size_t)row * O;
      float2 res[BN / 8];
      if (affine && residual != nullptr) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = w.col0 + 8 * j + 2 * t;
          res[j] = make_float2(0.f, 0.f);
          if (row >= R || c >= O) continue;
          if ((O & 1) == 0) {
            res[j] = load2(residual + at_row + c);
          } else {
            res[j].x = to_f32(residual[at_row + c]);
            if (c + 1 < O) res[j].y = to_f32(residual[at_row + c + 1]);
          }
        }
      }
      uint32_t packed[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = w.col0 + 8 * j + 2 * t;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const bool in = row < R && c < O;
        if (raw != nullptr) {
          if (in) store_pair(raw + at_row + c, v0, v1, c, O);
          continue;
        }
        if (affine) {
          v0 = v0 * sc[j].x + sh[j].x;
          v1 = v1 * sc[j].y + sh[j].y;
          if (residual != nullptr) {
            v0 += res[j].x;
            v1 += res[j].y;
          }
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
        }
        if (tma_out && EPI == kStats)
          packed[j] = pack(v0, v1);
        else if (tma_out)  // chunk j % 8 of row r at (j % 8) ^ (r % 8)
          *reinterpret_cast<uint32_t*>(staged + (j / 8) * OUT_BOX + r * 128 +
                                       (((j % 8) ^ (r % 8)) << 4) + 4 * t) =
              pack(v0, v1);
        else if (in)
          store_pair(out + at_row + c, v0, v1, c, O);
      }
      if (tma_out && EPI == kStats) {
        // blocks 8 j' .. 8 j' + 7 of this row half, four a stmatrix: lane
        // l gives row l % 8 of block j' = 4q + l / 8; chunk j' % 8 of row
        // r at (j' % 8) ^ (r % 8)
        const int m = lane / 8, i8 = lane % 8;
        const int rr = 16 * warp + 8 * h + i8;
#pragma unroll
        for (int q = 0; q < BN / 32; ++q) {
          const int jj = 4 * q + m;
          stmatrix_x4(staged + (jj / 8) * OUT_BOX + rr * 128 +
                          (((jj % 8) ^ i8) << 4),
                      packed[4 * q], packed[4 * q + 1], packed[4 * q + 2],
                      packed[4 * q + 3]);
        }
      }
    }
    if (tma_out) {  // this warpgroup's rows, each box inside the tensor
      fence_proxy_async();
      warpgroup_sync(cw);
      const int row_wg = w.row0 + 64 * cw;
      if (issuer && row_wg < R) {
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
          if (w.col0 + 64 * b < O)
            tma_store_2d(&omap, staged + b * OUT_BOX, w.col0 + 64 * b,
                         row_wg);
        bulk_commit();
      }
    }
  }
  if (tma_out && issuer) bulk_wait();
}

// x [R, I] bf16 (rows ldx values apart) and W [I, O] bf16 (rows ldw apart;
// ldx and ldw multiples of 8, so rows start 16 bytes apart, as TMA needs),
// on a persistent grid of `grid` blocks.
template <int BN, int EPI, typename TR>
cudaError_t launch_gemm_bf16(const bf16* x, const bf16* w, const float* scale,
                             const float* shift, const TR* residual, bf16* out,
                             float* slice_out, float* partial, int R, int I,
                             int O, int ldx, int ldw, int slices,
                             int slice_steps, int relu, int grid,
                             cudaStream_t stream) {
  const int k_steps = pad_to(I, BK16) / BK16;
  const long long work = (long long)((R + BM - 1) / BM) *
                         ((O + BN - 1) / BN) * slices;
  if (grid < 1 || work > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap xmap = {}, wmap = {}, omap = {};
  cudaError_t err = cudaSuccess;
  if (k_steps > 0) {
    err = tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, I, R, ldx,
                     BK16, BM, true);
    if (err == cudaSuccess)
      err = tensor_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O, I,
                       ldw, 64, BK16, true);
  }
  // out's tiles leave by TMA stores where its rows start 16 bytes apart
  const int tma_out = slice_out == nullptr && O % 8 == 0;
  if (err == cudaSuccess && tma_out)
    err = tensor_map(&omap, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, O, R, O,
                     64, 64, true);
  if (err != cudaSuccess) return err;
  auto kernel = conv1x1_bf16_kernel<BN, EPI, sizeof(TR) == 4>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RingBf16<BN>::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WS_THREADS, RingBf16<BN>::BYTES, stream>>>(
      xmap, wmap, omap, scale, shift, residual, out, slice_out, partial, R, O,
      k_steps, slice_steps, slices, relu, tma_out);
  return cudaGetLastError();
}

template <int EPI, typename TR>
cudaError_t launch_gemm_bf16_bn(int bn, const bf16* x, const bf16* w,
                                const float* scale, const float* shift,
                                const TR* residual, bf16* out,
                                float* slice_out, float* partial, int R,
                                int I, int O, int ldx, int ldw, int slices,
                                int slice_steps, int relu, int grid,
                                cudaStream_t stream) {
  return bn == 64
             ? launch_gemm_bf16<64, EPI, TR>(x, w, scale, shift, residual, out,
                                             slice_out, partial, R, I, O, ldx,
                                             ldw, slices, slice_steps, relu,
                                             grid, stream)
             : launch_gemm_bf16<128, EPI, TR>(x, w, scale, shift, residual,
                                              out, slice_out, partial, R, I,
                                              O, ldx, ldw, slices,
                                              slice_steps, relu, grid,
                                              stream);
}

// out = act((x . w) * scale + shift [+ residual]) in bf16, residual of type
// TR; with slices > 1 the raw slices go to slice_out [slices, R, O] f32 and
// the apply kernel adds them in order before the affine.
template <typename TR>
cudaError_t epilogue_bf16(const bf16* x, const bf16* w, const float* scale,
                          const float* shift, const TR* residual, bf16* out,
                          float* slice_out, int R, int I, int O, int ldx,
                          int ldw, int relu, int bn, int slices,
                          int slice_steps, int grid, cudaStream_t s) {
  if (slices == 1)
    return launch_gemm_bf16_bn<kAffine, TR>(bn, x, w, scale, shift, residual,
                                            out, nullptr, nullptr, R, I, O,
                                            ldx, ldw, 1, slice_steps, relu,
                                            grid, s);
  const cudaError_t err = launch_gemm_bf16_bn<kAffine, TR>(
      bn, x, w, nullptr, nullptr, nullptr, out, slice_out, nullptr, R, I, O,
      ldx, ldw, slices, slice_steps, 0, grid, s);
  if (err != cudaSuccess) return err;
  return launch_apply(static_cast<const float*>(slice_out), slices, scale,
                      shift, residual, out, R, O, relu, s);
}


}  // namespace

// Constants the Python tile plan must agree with: rows per output tile,
// K depth per ring stage, the bf16 kernel's blocks an SM, and a block's
// dynamic shared memory at BN.
extern "C" int paddle_conv1x1_row_tile() { return BM; }
extern "C" int paddle_conv1x1_k_tile() { return BK; }
extern "C" int paddle_conv1x1_k_tile_bf16() { return BK16; }
extern "C" int paddle_conv1x1_blocks_per_sm_bf16() {
  return BF16_BLOCKS_PER_SM;
}
extern "C" int paddle_conv1x1_smem_bytes(int bn) {
  return bn == 64    ? Ring<64, true>::BYTES
         : bn == 128 ? Ring<128, true>::BYTES
                     : -1;
}
extern "C" int paddle_conv1x1_smem_bytes_tf32(int bn) {
  return bn == 64    ? Ring<64, false>::BYTES
         : bn == 128 ? Ring<128, false>::BYTES
                     : -1;
}
extern "C" int paddle_conv1x1_smem_bytes_bf16(int bn) {
  return bn == 64 ? RingBf16<64>::BYTES
                  : bn == 128 ? RingBf16<128>::BYTES : -1;
}

// y = x . w and stats [2, O]. Scratch from the caller: wt [2, pad(O, bn),
// pad(I, 32)] for W's split, partial [ceil(R / 128), 2, O]. Pointers are
// 16-byte aligned and contiguous (the wrapper makes them so).
extern "C" int paddle_conv1x1_stats_f32(const float* x, const float* w,
                                        float* wt, float* y, float* partial,
                                        float* stats, int R, int I, int O,
                                        int bn, void* stream) {
  return stats_f32<true>(x, w, wt, y, partial, stats, R, I, O, bn, stream);
}

// The same in 1xTF32 (the policy default); wt [1, pad(O, bn), pad(I, 32)].
extern "C" int paddle_conv1x1_stats_tf32(const float* x, const float* w,
                                         float* wt, float* y, float* partial,
                                         float* stats, int R, int I, int O,
                                         int bn, void* stream) {
  return stats_f32<false>(x, w, wt, y, partial, stats, R, I, O, bn, stream);
}

// out = act((x . w) * scale + shift [+ residual]); residual may be null.
// wt as for the stats; with slices > 1, K is cut into `slices` slices of
// slice_steps * 32 and slice_out is scratch [slices, R, O].
extern "C" int paddle_conv1x1_epilogue_f32(
    const float* x, const float* w, float* wt, const float* scale,
    const float* shift, const float* residual, float* out, float* slice_out,
    int R, int I, int O, int relu, int bn, int slices, int slice_steps,
    void* stream) {
  return epilogue_f32<true>(x, w, wt, scale, shift, residual, out, slice_out,
                            R, I, O, relu, bn, slices, slice_steps, stream);
}

// The same in 1xTF32 (the policy default); wt [1, pad(O, bn), pad(I, 32)].
extern "C" int paddle_conv1x1_epilogue_tf32(
    const float* x, const float* w, float* wt, const float* scale,
    const float* shift, const float* residual, float* out, float* slice_out,
    int R, int I, int O, int relu, int bn, int slices, int slice_steps,
    void* stream) {
  return epilogue_f32<false>(x, w, wt, scale, shift, residual, out,
                             slice_out, R, I, O, relu, bn, slices,
                             slice_steps, stream);
}

// out = act(y * scale + shift [+ residual]) over a contiguous [R, O].
extern "C" int paddle_scale_shift_act_f32(const float* y, const float* scale,
                                          const float* shift,
                                          const float* residual, float* out,
                                          long long R, int O, int relu,
                                          void* stream) {
  if (R * (long long)O <= 0) return (int)cudaSuccess;
  return (int)launch_apply(y, 1, scale, shift, residual, out, R, O, relu,
                           static_cast<cudaStream_t>(stream));
}

// The bf16 instances (AMP). x [R, I] and w [I, O] bf16 with rows ldx and
// ldw values apart (multiples of 8); y / out [R, O] bf16; scale, shift,
// partial, stats and slice_out f32; the residual bf16, or f32 when
// res_f32. Pointers are 16-byte aligned (the wrapper makes them so). The
// GEMM runs on a persistent grid of `grid` blocks (the caller's plan: at
// most one a work item, and paddle_conv1x1_blocks_per_sm_bf16() an SM).
extern "C" int paddle_conv1x1_stats_bf16(const void* x, const void* w,
                                         void* y, float* partial,
                                         float* stats, int R, int I, int O,
                                         int ldx, int ldw, int bn, int grid,
                                         void* stream) {
  if (R <= 0 || O <= 0) return (int)cudaSuccess;
  const int k_steps = pad_to(I, BK16) / BK16;
  if (!plan_ok(I, BK16, bn, 1, k_steps) || ldx % 8 || ldw % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gemm_bf16_bn<kStats, bf16>(
      bn, static_cast<const bf16*>(x), static_cast<const bf16*>(w), nullptr,
      nullptr, nullptr, static_cast<bf16*>(y), nullptr, partial, R, I, O, ldx,
      ldw, 1, k_steps, 0, grid, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 red_grid((O + RED_X - 1) / RED_X, 2);
  stats_reduce_kernel<<<red_grid, dim3(RED_X, RED_Y), 0, s>>>(
      partial, stats, (R + BM - 1) / BM, O);
  return (int)cudaGetLastError();
}

extern "C" int paddle_conv1x1_epilogue_bf16(
    const void* x, const void* w, const float* scale, const float* shift,
    const void* residual, void* out, float* slice_out, int R, int I, int O,
    int ldx, int ldw, int res_f32, int relu, int bn, int slices,
    int slice_steps, int grid, void* stream) {
  if (R <= 0 || O <= 0) return (int)cudaSuccess;
  if (!plan_ok(I, BK16, bn, slices, slice_steps) || ldx % 8 || ldw % 8 ||
      (slices > 1 && slice_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  return (int)(res_f32
                   ? epilogue_bf16(xb, wb, scale, shift,
                                   static_cast<const float*>(residual), ob,
                                   slice_out, R, I, O, ldx, ldw, relu, bn,
                                   slices, slice_steps, grid, s)
                   : epilogue_bf16(xb, wb, scale, shift,
                                   static_cast<const bf16*>(residual), ob,
                                   slice_out, R, I, O, ldx, ldw, relu, bn,
                                   slices, slice_steps, grid, s));
}

extern "C" int paddle_scale_shift_act_bf16(const void* y, const float* scale,
                                           const float* shift,
                                           const void* residual, void* out,
                                           long long R, int O, int res_f32,
                                           int relu, void* stream) {
  if (R * (long long)O <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* yb = static_cast<const bf16*>(y);
  bf16* ob = static_cast<bf16*>(out);
  return (int)(res_f32 ? launch_apply(yb, 1, scale, shift,
                                      static_cast<const float*>(residual), ob,
                                      R, O, relu, s)
                       : launch_apply(yb, 1, scale, shift,
                                      static_cast<const bf16*>(residual), ob,
                                      R, O, relu, s));
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
