// Flash attention in bf16 for Hopper (sm_90a): the forward, dq and dkv
// kernels for bf16 q, k, v (the per-layer transformer under AMP), every
// product on the tensor cores with bf16 operands and f32 accumulators,
// as `wgmma` fed by TMA.
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/flash_attention.py
// in the dtype the JAX package trains in (their "native dtype (bf16 under
// AMP): MXU-fast dots"): `_flash_kernel` (launched by `_flash_forward`),
// `_flash_dq_kernel` and `_flash_dkv_kernel` (`_flash_backward`). Same
// functions and the same rounding:
//
//   s  = (q . k^T) * sm_scale     f32 from bf16 operands; masked where
//                                 k_pos >= len[bh] or, causal, k_pos > q_pos
//   fwd: online softmax in f32 (max, denominator, accumulator);
//        P = exp(s - m) rounded to bf16 before P V; the denominator sums
//        the f32 P; o = acc / max(l, 1e-30) rounded once; lse f32
//        (+inf on a fully masked row, whose o is 0)
//   bwd: p = exp(s - lse) (0 where masked), dp = dO . v^T (f32),
//        ds = p * (dp - Di) with Di = rowsum(dO * o) f32 from the caller;
//        P and dS rounded to bf16 before dv = P^T dO, dk = ds^T q,
//        dq = ds k; dq = sm_scale * acc, dk = sm_scale * acc and dv
//        rounded once
//
// q, dO [BH, Tq, D]; k, v [BH, Tk, D] bf16; lse, Di [BH, Tq] f32; len
// [BH] int32 -> o, dq [BH, Tq, D], dk, dv [BH, Tk, D] bf16. The wrapper
// zero-pads D up to 64, 128 or a multiple of 64, past 256 up to 384 or
// 512, and past 512 up to a multiple of 128: the instances take 64, 128,
// 192, 256, 384 and 512, and past them the slice instances any multiple of
// 128 (fwd_slice, bwd_slice below), all on `wgmma` fed by TMA.
// exp is taken as 2^x of x * log2(e) folded into the scale (ex2.approx,
// relative error ~2^-22, far below P's bf16 rounding).
//
// What bounds them: at the training shapes (B8 H8 T2048, causal) the
// forward does 4*D FLOPs per visible (q, k) pair, dq 6*D and dkv 8*D (69,
// 103 and 137 GFLOP at D128; 137 and 206 GFLOP for the forward and dq at
// D256, and 275 GFLOP for dkv there: the per-layer LM with 8 heads of
// 256; the same 137, 206 and 275 at B8 H4 T2048 D512, 4 heads of 512) on
// ~0.1-0.4 GB: bound by
// operations, at the tensor cores' bf16 rate (989 TFLOP/s), which only
// `wgmma` reaches.
//
// The three kernels share one design (warp-specialised, one block per
// (bh, 128 rows it owns): q rows for the forward and dq, k rows for dkv,
// 64 of them past D = 128):
// - A block is three warpgroups. The first is the producer: it gives its
//   registers up (setmaxnreg 24) and one of its threads issues every TMA
//   copy; the other two (setmaxnreg 240) each own 64 of the block's rows,
//   the M of every `wgmma`. bh is the grid's x axis, the owned tiles its
//   y axis, the heaviest causal tiles first.
// - TMA brings each operand from a 3-D tensor map (D, T, BH) in boxes of
//   64 bf16 values (128 bytes) by the tile's rows in the 128-byte swizzle,
//   so a tile at a head's ragged end lands with zero rows and never reads
//   the next head's; a tile is D / 64 boxes. Every box starts on a
//   1024-byte boundary. The owned tiles (Q; K and V; Q and dO) are loaded
//   once; the streamed pair (K and V: tiles of fwd_keys(D) keys in the
//   forward, dq_keys(D) in dq; Q and dO: 64-query tiles, with their lse
//   and Di copied beside them by the producer warp's cp.async) goes
//   through a ring (fwd_stages(D), dq_stages(D) stages; two in dkv, where a
//   third measured no faster), each stage with a `full` barrier that
//   TMA's complete_tx sets and an `empty` one each consumer warp arrives
//   at. Tiles past the length or wholly above the diagonal are never
//   loaded.
// - Products whose operands both come from shared memory (S = Q K^T and,
//   in dq, dP = dO V^T; S^T = K Q^T and dP^T = V dO^T in dkv) read both
//   K-major, D being the reduction (sw128_desc). Products whose A is P or
//   dS (O += P V; dQ += dS K; dV += P^T dO, dK += dS^T Q) take A from
//   registers: an f32 accumulator's columns 16c .. 16c + 15, rounded and
//   packed in pairs, are the register A of one k16 step (WgmmaBf16Rs), so
//   P and dS never leave registers, and read B MN-major (sw128_mn_desc)
//   from the same boxes that serve as K-major operands: no transposed copy
//   is made.
// - Past D = 128 (the forward and dq only) nothing changes but the
//   widths: O and dQ are one m64n192k16 or m64n256k16 accumulator (N =
//   256 is wgmma's largest, so no output is cut into D slices and S, P
//   and dP are computed once a tile), and the K/V tiles narrow until the
//   owned tiles and two or three stages fit the shared memory and a
//   consumer's 240 registers (the forward at D = 256: O 128 f32 and S 32
//   at 64 keys).
// - The accumulator has mma's C layout per warp (rows g and g + 8 of its
//   16, each row in one quad of lanes), so a row's max and sum are the
//   thread's own values and two __shfl_xor. Masks are applied only on
//   tiles that cross the diagonal or a length. O is carried across tiles
//   in the wgmma accumulator (O * alpha, then += P V).
// - dkv keeps the transposed products: K and V are the M side, each
//   streamed Q/dO tile is the N side of S^T and dP^T and the K side (read
//   MN-major) of dV and dK, so every intermediate stays in registers: per
//   consumer thread at D = 128, dK and dV 128 f32, S^T and dP^T 64, their
//   packed bf16 32. lse and Di of a column come from shared memory.
//   Past D = 128 that split would need D / 2 + D / 2 + 64 registers and
//   K, V and two stages of 128 keys and 64 queries 256 KB at D = 256, so
//   there (dkv_split) a block owns 64 keys, shared by both consumers, and
//   the work is cut twice: each consumer forms S^T and dP^T (m64n32) for
//   32 of a tile's 64 queries over all of D, P^T and dS^T go rounded to
//   bf16 through a K-major exchange tile in shared memory (a named
//   barrier over the 256 consumer threads between), and each consumer
//   accumulates dV += P^T dO and dK += dS^T Q, both operands from shared
//   memory, for its own boxes of D: two of four at D = 256 (dK and dV 64
//   f32 each, S^T and dP^T 16 each), two and one of three at D = 192
//   (the boxes are TMA's 64-column ones, which an N = 96 operand would
//   cut in half).
// - dq keeps its 128 rows' Q and dO in shared memory and their lse and Di
//   in registers (each thread's rows g and g + 8); S and dP share one
//   accumulator layout, so dS = P (dP - Di) forms in place and packs into
//   dQ's register A as P does in the forward, and dQ's B is the K tile
//   that served S, read MN-major. 64-key tiles keep a consumer thread at
//   D = 128 to dQ 64 f32, S and dP 32 each, packed dS 16 (128-key tiles
//   would need ~224 before addresses); at D = 256, 48-key tiles to dQ 128,
//   S and dP 24 each, packed dS 12. dQ is carried across tiles in the
//   wgmma accumulator, a consumer warpgroup skips the tiles wholly above
//   its own diagonal (its empty arrival still made), and P = 0 on masked
//   columns and on rows past Tq (their lse is taken as +inf) without an
//   inf - inf.
// - Outputs leave through shared memory: each consumer warpgroup writes
//   its [64, D] tile (o; dq; dk and dv), rounded once, into its own rows of
//   the owned tile's boxes, free once its last product has read them, in
//   the swizzle TMA reads, and one of its threads stores the boxes with a
//   TMA store (rows past T are not written). Stores straight from
//   registers, 4 bytes a lane over 8 rows, took 7% of the forward.
// - Past D = 256 (fwd_split, dq_split below) a block owns 64 q rows,
//   shared by both consumers, and each consumer owns half of D of the
//   output (128 f32 registers at D = 512): it forms S (and dP) over its
//   half of D, the two f32 partials are exchanged through shared memory
//   and summed, and each adds P V (dS K) for its half. K/V tiles are 32
//   keys in the forward and 16 in dq, so Q (and dO) for 64 rows, two to
//   four stages and the exchange fit. dkv there (dkv_half) is the same
//   with q and k swapped, as two halves on the grid's z axis, since
//   dK and dV together would take a consumer 256 registers at D = 512: a
//   block owns 64 keys and computes dK (dq's products over 16-query Q/dO
//   tiles) or dV (the forward's S^T and P^T dO over 32-query tiles).
// - No atomics: each output element is summed by one thread in a fixed
//   order, so two launches on the same inputs agree bitwise.
// Budget (ptxas, sm_90a): 168 registers a thread at launch (384 threads,
// one block an SM), no spills; the consumers run at 240 after
// setmaxnreg, which acts on whole warpgroups, hence a producer
// warpgroup rather than a warp. Shared memory (each ring asserts its
// bytes against the 232,448 a block may have): the forward 229,432 bytes
// at D = 128 (Q 32 KB, three stages of K and V, 64 KB each) and 114,744
// at D = 64, 196,664 at D = 192 (Q 48 KB, three stages of 64-key K and
// V, 48 KB each) and 196,648 at D = 256 (Q 64 KB, two stages of K and V,
// 64 KB each); dq 163,896 (Q and dO 64 KB, three stages of K and V, 32
// KB each), 81,976 at D = 64, 208,952 at D = 192 (Q and dO 96 KB, three
// stages of 48-key K and V, 36 KB each) and 229,416 at D = 256 (Q and dO
// 128 KB, two stages of 48-key K and V, 48 KB each); dkv 132,136 (K and
// V 64 KB, two stages of Q and dO, 32 KB each, and of lse and Di) and
// 66,600 at D = 64, 181,288 at D = 192 (64-key K and V 48 KB, two stages
// of Q and dO, 48 KB each, two exchange buffers of P^T and dS^T, 32 KB)
// and 230,440 at D = 256 (K and V 64 KB, two stages 64 KB each, the
// exchange buffers 32 KB). Past D = 256: the forward 229,432 at D = 384
// (Q 48 KB, three stages of 32-key K and V, 48 KB each, two exchange
// buffers of S partials, 32 KB) and 229,416 at D = 512 (Q 64 KB, two
// stages of 64 KB); dq 229,448 at D = 384 (Q and dO 96 KB, four stages
// of 16-key K and V, 24 KB each, the exchange buffers of S and dP
// partials 32 KB) and 229,416 at D = 512 (Q and dO 128 KB, two stages of
// 32 KB); dkv's dK half 229,960 at D = 384 (K and V 96 KB, four stages of
// 16-query Q and dO, 24 KB each, with their lse and Di, the exchange
// buffers of S^T and dP^T partials 32 KB) and 229,672 at D = 512 (K and V
// 128 KB, two stages of 32 KB), its dV half 229,816 at D = 384 (K 48 KB,
// three stages of 32-query Q and dO, 48 KB each, with their lse, the
// exchange buffers of S^T partials 32 KB) and 229,672 at D = 512 (K 64
// KB, two stages of 64 KB); a dkv launch asks for the larger half's. Past
// D = 512 the slice instances' (fwd_slice, bwd_slice): at most 229,512.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"  // cp.async (dkv's lse and Di)
#include "tma.cuh"
#include "wgmma_bf16.cuh"
#include "ws_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

// --- wgmma behind a TMA ring ------------------------------------------------

constexpr int OWN = 128;          // rows a block owns, 64 a consumer
constexpr int DKV_QUERIES = 64;   // queries of a dkv Q/dO tile
constexpr int ROW_BYTES = 128;    // a box row: 64 bf16 values
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may opt in to

// Keys of a K/V tile and stages of the K/V ring, by head dim, of the
// forward (which owns Q) and of dq (which owns Q and dO): at D <= 128
// 128-key tiles (the forward) or 64-key ones (dq) in three stages; past
// it the owned tiles and a consumer's f32 accumulator (D / 2 registers)
// grow, so tiles narrow to 64 keys (the forward) and 48 (dq), in three
// stages at D = 192 and two at 256, what the shared memory and 240
// registers hold (KvRing's static_assert). Measured against 80- and
// 96-key forward tiles and 32- and 64-key dq tiles at B8 H8 T2048: as
// fast at D = 192, 3-5% faster at 256 (PERF.md §6).
constexpr int fwd_keys(int D) { return D <= 128 ? 128 : 64; }
constexpr int dq_keys(int D) { return D <= 128 ? 64 : 48; }
constexpr int fwd_stages(int D) { return D <= 192 ? 3 : 2; }
constexpr int dq_stages(int D) { return D <= 192 ? 3 : 2; }
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// no read or write of the register A operands moves across this point
template <int M>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// The register A operands of N / 16 k16 steps (WgmmaBf16Rs): columns
// 16c .. 16c + 15 of a warpgroup's [64, N] f32 accumulator, rounded to
// bf16 and packed in pairs.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&d)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[c][e] = pack(d[8 * c + 2 * e],
                                               d[8 * c + 2 * e + 1]);
}

// One K/V tile of the forward's online softmax, in place: this thread's
// entries of S (rows row[0], row[1]; keys k0 + 8j + 2t and + 1) masked
// past `length` and, causal, above the diagonal (looked at only on an
// `edge` tile), the running max m (unscaled) and denominator l updated,
// S replaced by P = 2^(s c - m c) in f32; alpha gets the factor each
// row's accumulator is to be scaled by.
template <int NK>
__device__ __forceinline__ void softmax_tile(float (&sc)[NK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const int (&row)[2], int k0,
                                             int length, int causal,
                                             bool edge, int t, float c) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
        if (k_pos >= length || (causal && k_pos > row[e >> 1]))
          sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < NK / 2; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    // a row masked so far keeps m = -inf; exp sees a finite offset
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = m[h] == -INFINITY ? 0.f : ex2((m[h] - m_safe) * c);
    m[h] = m_new;
    mc[h] = m_safe * c;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < NK / 2; ++e) {
    const float p = ex2(fmaf(sc[e], c, -mc[(e >> 1) & 1]));  // masked: 0
    sc[e] = p;
    sum[(e >> 1) & 1] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
}

// One K/V tile of dq, in place: this thread's entries of dP replaced by
// dS = P (dP - Di), P = 2^(s c - lse log2 e) from S, 0 past `length` and,
// causal, above the diagonal (looked at only on an `edge` tile); rows
// past Tq have lse2 = +inf, so P = 0 there without an inf - inf.
template <int NK>
__device__ __forceinline__ void ds_tile(const float (&sc)[NK / 2],
                                        float (&dp)[NK / 2],
                                        const float (&lse2)[2],
                                        const float (&di_r)[2],
                                        const int (&row)[2], int k0,
                                        int length, int causal, bool edge,
                                        int t, float c) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = ex2(fmaf(sc[4 * j + e], c, -lse2[h]));
      if (edge) {
        const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
        if (k_pos >= length || (causal && k_pos > row[h])) p = 0.f;
      }
      dp[4 * j + e] = p * (dp[4 * j + e] - di_r[h]);
    }
}

// This thread's rows (16 w + g and + 8 of the warpgroup's 64: columns 8j
// + 2t, + 1 of each 8-column group j) of a warpgroup's [64, D] f32
// accumulator times scale, rounded once, into a [64, D] bf16 tile in
// shared memory laid out as TMA boxes of 64 columns `box` bytes apart, in
// the 128-byte swizzle (chunk c of row r at c ^ (r % 8)): no two lanes of
// a store share a bank.
template <int D>
__device__ __forceinline__ void stage_tile(unsigned char* tile, int box,
                                           const float (&acc)[D / 2],
                                           const float (&scale)[2], int warp,
                                           int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + (j / 8) * box + r * ROW_BYTES +
                                   (((j % 8) ^ (r % 8)) << 4) + 4 * t) =
          pack(acc[4 * j + 2 * h] * scale[h],
               acc[4 * j + 2 * h + 1] * scale[h]);
  }
}

// Warpgroup w's [64, D] output tile, staged by stage_tile at `tile`, to
// rows row0 .. row0 + 63 and columns from 64 b0 on of head bh: every
// thread's stores handed to the async proxy, the warpgroup met, then one
// thread stores the D / 64 boxes and waits until TMA has read them.
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const unsigned char* tile, int box,
                                           int row0, int bh, int w,
                                           int b0 = 0) {
  fence_proxy_async();
  warpgroup_sync(w);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      tma_store_3d(map, tile + b * box, 64 * (b0 + b), row0, bh);
    bulk_commit();
    bulk_wait_read();
  }
}

// The descriptor of k16 step kk of a K-major operand whose D is cut into
// 64-column boxes `box` bytes apart: 32 bytes a step inside a box (+2),
// the next box after four.
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int kk, int box) {
  return desc + (uint64_t)((kk / 4) * (box >> 4) + 2 * (kk % 4));
}

// Shared memory, in bytes, of a kernel at head dim D that owns OWNED
// tiles of OWN rows (the forward: Q; dq: Q and dO) and streams K/V tiles
// of K keys through a ring of S stages: the owned tiles as NB = D / 64
// boxes each, then each stage's K and V boxes, then the barriers (the
// owned tiles', and each stage's full and empty).
template <int D, int K, int S, int OWNED>
struct KvRing {
  static constexpr int ROWS = OWN;  // q rows a block owns
  static constexpr int KEYS = K;
  static constexpr int STAGES = S;
  static constexpr int NB = D / 64;
  static constexpr int Q_BOX = OWN * ROW_BYTES;
  static constexpr int KV_BOX = KEYS * ROW_BYTES;
  static constexpr int RING = OWNED * NB * Q_BOX;  // stage s: RING + s STAGE
  static constexpr int V = NB * KV_BOX;            // V inside a stage
  static constexpr int STAGE = 2 * NB * KV_BOX;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8;
  static_assert(Q_BOX % 1024 == 0 && KV_BOX % 1024 == 0,
                "boxes must keep the swizzle's alignment");
  static_assert(KEYS % 16 == 0, "a tile is whole k16 steps of P V, dS K");
  static_assert(BYTES <= SMEM_LIMIT, "the ring does not fit");
};
template <int D>
using FwdRing = KvRing<D, fwd_keys(D), fwd_stages(D), 1>;
template <int D>
using DqRing = KvRing<D, dq_keys(D), dq_stages(D), 2>;

// The producer thread's part of a KvRing: K/V tiles 0 .. n_tiles - 1 of
// head bh, tile i into stage i % STAGES once the consumers have emptied
// it, counted on the stage's full barrier.
template <class L>
__device__ __forceinline__ void stream_kv(unsigned char* smem,
                                          const CUtensorMap* kmap,
                                          const CUtensorMap* vmap,
                                          uint64_t* full, uint64_t* empty,
                                          int n_tiles, int bh) {
  for (int i = 0; i < n_tiles; ++i) {
    const int s = ring_acquire<L::STAGES>(full, empty, i, L::STAGE);
    unsigned char* st = smem + L::RING + s * L::STAGE;
#pragma unroll
    for (int b = 0; b < L::NB; ++b) {
      tma_load_3d(st + b * L::KV_BOX, kmap, 64 * b, i * L::KEYS, bh,
                  &full[s]);
      tma_load_3d(st + L::V + b * L::KV_BOX, vmap, 64 * b, i * L::KEYS, bh,
                  &full[s]);
    }
  }
}

// The forward up to D = 256: each consumer warpgroup owns 64 of the
// block's 128 q rows and all of D.
template <int D>
__device__ __forceinline__ void fwd_rows(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* omap, const int* lens,
    float* lse, int Tq, int Tk, int causal, float sm_scale) {
  using L = FwdRing<D>;
  constexpr int NK = L::KEYS;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OWN;
  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + NK - 1) / NK;
  if (causal)  // the last tile any of the block's rows sees
    n_tiles = min(n_tiles, (min(q0 + OWN, Tq) + NK - 1) / NK);

  init_ring<L::STAGES>(q_full);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect(q_full, L::RING);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
        tma_load_3d(smem + b * L::Q_BOX, qmap, 64 * b, q0, bh, q_full);
      stream_kv<L>(smem, kmap, vmap, full, empty, n_tiles, bh);
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_wg = q0 + 64 * cw;  // the warpgroup's first row
  const int row[2] = {r_wg + 16 * warp + g, r_wg + 16 * warp + g + 8};
  const float c = sm_scale * LOG2E;  // s * c is s * sm_scale in base 2
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m unscaled
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  const uint64_t dq = sw128_desc(
      reinterpret_cast<const float*>(smem + cw * 64 * ROW_BYTES));
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    const unsigned char* st = smem + L::RING + s * L::STAGE;
    const uint64_t dk = sw128_desc(reinterpret_cast<const float*>(st));
    const uint64_t dv = sw128_mn_desc(st + L::V, L::KV_BOX);

    float sc[NK / 2];  // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      WgmmaBf16<NK, 0>::mma(sc, k_step(dq, kk, L::Q_BOX),
                                  k_step(dk, kk, L::KV_BOX), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = i * NK;
    float alpha[2];
    softmax_tile<NK>(sc, m, l, alpha, row, k0, length, causal,
                     k0 + NK > length || (causal && k0 + NK - 1 > r_wg), t,
                     c);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];

    uint32_t pa[NK / 16][4];  // bf16(P), the A of O += P V
    pack_a<NK>(pa, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      WgmmaBf16Rs<D>::mma(acc, pa[kk], dv + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
  }

  // o through this warpgroup's rows of Q's boxes, free after its last S
  unsigned char* ot = smem + cw * 64 * ROW_BYTES;
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  stage_tile<D>(ot, L::Q_BOX, acc, inv, warp, g, t);
  store_tile<D>(omap, ot, L::Q_BOX, r_wg, bh, cw);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tq)
        lse[(size_t)bh * Tq + row[h]] =
            l[h] > 0.f ? m[h] * sm_scale + logf(fmaxf(l[h], 1e-30f))
                       : INFINITY;
}

// Shared memory of dkv at head dim D, in bytes: K and V (KEYS rows each)
// as NB = D / 64 boxes, then each stage's Q and dO boxes (DKV_QUERIES
// rows), then, past D = 128, the exchange tiles (two buffers of bf16 P^T
// and dS^T, [KEYS, DKV_QUERIES] each), then each stage's lse and Di
// (f32), then the barriers (K/V's, and each stage's full and empty).
// Up to D = 128 a block owns 128 keys, 64 a consumer warpgroup; past it
// 64, shared by both (SPLIT, dkv_split), the first consumer's dK and dV
// columns being H0 of D.
template <int D>
struct DkvRing {
  static constexpr bool SPLIT = D > 128;
  static constexpr int KEYS = SPLIT ? 64 : OWN;
  static constexpr int H0 = SPLIT ? 128 : D;
  static constexpr int STAGES = 2;
  static constexpr int NB = D / 64;
  static constexpr int KV_BOX = KEYS * ROW_BYTES;
  static constexpr int QD_BOX = DKV_QUERIES * ROW_BYTES;
  static constexpr int V = NB * KV_BOX;
  static constexpr int RING = 2 * NB * KV_BOX;  // stage s at RING + s STAGE
  static constexpr int DO = NB * QD_BOX;        // dO inside a stage
  static constexpr int STAGE = 2 * NB * QD_BOX;
  static constexpr int XCH = RING + STAGES * STAGE;  // buffer b at + b XBUF
  static constexpr int XCH_TILE = KEYS * ROW_BYTES;  // P^T, then dS^T
  static constexpr int XBUF = 2 * XCH_TILE;
  static constexpr int STATS = XCH + (SPLIT ? 2 * XBUF : 0);
  static constexpr int BARS = STATS + STAGES * 2 * DKV_QUERIES * 4;
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8;
  static_assert(KV_BOX % 1024 == 0 && QD_BOX % 1024 == 0 &&
                    XCH_TILE % 1024 == 0,
                "boxes must keep the swizzle's alignment");
  static_assert(DKV_QUERIES * 2 == ROW_BYTES,
                "an exchange tile's row is one box row of queries");
  static_assert(BYTES <= SMEM_LIMIT, "the ring does not fit");
};

// What a dkv block's consumers share: its shared memory and barriers,
// head, first key, K length, query tiles and the first one it sees.
struct DkvBlock {
  unsigned char* smem;
  const float* stats;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;
  const CUtensorMap* dkmap;
  const CUtensorMap* dvmap;
  int bh, k0, length, n_q, first, Tq, causal;
  float sm_scale;
};

// In place, this thread's entries of a warpgroup's [64 keys, N queries]
// S^T tile (keys row[0] and row[1], queries q + 8j + 2t and + 1, their
// lse at lse_s): P^T = exp(s sm_scale - lse) in f32, 0 where masked
// (checked only on an edge tile).
template <int N>
__device__ __forceinline__ void dkv_p(float (&sp)[N / 2], const float* lse_s,
                                      const int (&row)[2], int q, int t,
                                      float c, bool edge, const DkvBlock& a) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 lz = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse_c = (e & 1) ? lz.y : lz.x;
      float p = ex2(fmaf(sp[4 * j + e], c, -lse_c * LOG2E));
      if (edge) {
        const int q_pos = q + 8 * j + 2 * t + (e & 1);
        const int k_pos = row[e >> 1];
        if (k_pos >= a.length || q_pos >= a.Tq ||
            (a.causal && q_pos < k_pos))
          p = 0.f;
      }
      sp[4 * j + e] = p;
    }
  }
}

// ... and the dP^T tile beside it (Di at di_s): dS^T = P^T (dP^T - Di),
// f32.
template <int N>
__device__ __forceinline__ void dkv_p_ds(float (&sp)[N / 2],
                                         float (&dp)[N / 2],
                                         const float* lse_s,
                                         const float* di_s,
                                         const int (&row)[2], int q, int t,
                                         float c, bool edge,
                                         const DkvBlock& a) {
  dkv_p<N>(sp, lse_s, row, q, t, c, edge, a);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 dz = *reinterpret_cast<const float2*>(di_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float di_c = (e & 1) ? dz.y : dz.x;
      dp[4 * j + e] = sp[4 * j + e] * (dp[4 * j + e] - di_c);
    }
  }
}

// dkv up to D = 128: each consumer warpgroup owns 64 of the block's 128
// keys and all of D.
template <int D>
__device__ __forceinline__ void dkv_rows(const DkvBlock& a) {
  using L = DkvRing<D>;
  constexpr int NQ = DKV_QUERIES;
  const int cw = threadIdx.x / 128 - 1;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw = a.k0 + 64 * cw;  // the warpgroup's first key
  const int row[2] = {kw + 16 * warp + g, kw + 16 * warp + g + 8};
  const float c = a.sm_scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  if (a.first < a.n_q) mbar_wait(a.kv_full, 0);
  const uint64_t dka = sw128_desc(
      reinterpret_cast<const float*>(a.smem + cw * 64 * ROW_BYTES));
  const uint64_t dva = sw128_desc(
      reinterpret_cast<const float*>(a.smem + L::V + cw * 64 * ROW_BYTES));
  for (int qb = a.first; qb < a.n_q; ++qb) {
    const int i = qb - a.first;
    const int s = i % L::STAGES;
    mbar_wait(&a.full[s], (i / L::STAGES) & 1);
    const int q0 = qb * NQ;
    // keys past the length, or after every query of the tile, add 0
    if (kw < a.length && (!a.causal || q0 + NQ - 1 >= kw)) {
      const unsigned char* qs = a.smem + L::RING + s * L::STAGE;
      const unsigned char* dos = qs + L::DO;
      const float* lse_s = a.stats + s * 2 * NQ;
      const float* di_s = lse_s + NQ;
      const uint64_t dqk = sw128_desc(reinterpret_cast<const float*>(qs));
      const uint64_t ddk = sw128_desc(reinterpret_cast<const float*>(dos));
      float sp[NQ / 2], dp[NQ / 2];  // S^T, dP^T, then P^T, dS^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
        WgmmaBf16<NQ, 0>::mma(sp, k_step(dka, kk, L::KV_BOX),
                              k_step(dqk, kk, L::QD_BOX), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
        WgmmaBf16<NQ, 0>::mma(dp, k_step(dva, kk, L::KV_BOX),
                              k_step(ddk, kk, L::QD_BOX), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sp);
      fence_regs(dp);

      const bool edge = kw + 64 > a.length || q0 + NQ > a.Tq ||
                        (a.causal && q0 < kw + 63);
      dkv_p_ds<NQ>(sp, dp, lse_s, di_s, row, q0, t, c, edge, a);
      uint32_t pa[NQ / 16][4], sa[NQ / 16][4];  // bf16(P^T), bf16(dS^T)
      pack_a<NQ>(pa, sp);
      pack_a<NQ>(sa, dp);
      const uint64_t dom = sw128_mn_desc(dos, L::QD_BOX);
      const uint64_t qm = sw128_mn_desc(qs, L::QD_BOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)  // dV += P^T dO
        WgmmaBf16Rs<D>::mma(dv_acc, pa[kk], dom + 128 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)  // dK += dS^T Q
        WgmmaBf16Rs<D>::mma(dk_acc, sa[kk], qm + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_frags(pa);
      fence_frags(sa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&a.empty[s]);
  }
  const float scale[2] = {a.sm_scale, a.sm_scale};
  const float one[2] = {1.f, 1.f};
  // dk and dv through this warpgroup's rows of K's and V's boxes
  unsigned char* kt = a.smem + cw * 64 * ROW_BYTES;
  unsigned char* vt = kt + L::V;
  stage_tile<D>(kt, L::KV_BOX, dk_acc, scale, warp, g, t);
  stage_tile<D>(vt, L::KV_BOX, dv_acc, one, warp, g, t);
  store_tile<D>(a.dkmap, kt, L::KV_BOX, kw, a.bh, cw);
  store_tile<D>(a.dvmap, vt, L::KV_BOX, kw, a.bh, cw);
}

// dkv past D = 128: both consumer warpgroups own the block's 64 keys.
// Consumer cw forms S^T and dP^T for queries 32 cw .. 32 cw + 31 of each
// tile over the whole of D (m64n32), rounds P^T and dS^T to bf16 into
// its columns of the tile's exchange buffer (K-major, [64 keys, 64
// queries] in the 128-byte swizzle), meets the other consumer, then adds
// P^T dO and dS^T Q over all 64 queries to its DN columns of dV and dK
// from box b0 on, A from the exchange tiles and B MN-major from the
// stage's boxes. The two buffers alternate by tile: a consumer writes
// buffer i % 2 only after both have met at tile i - 1, that is after the
// other's products of tile i - 2 (which read it) have completed.
template <int D, int DN>
__device__ __forceinline__ void dkv_split(const DkvBlock& a, int b0) {
  using L = DkvRing<D>;
  constexpr int NQ = DKV_QUERIES;
  constexpr int NH = NQ / 2;  // a consumer's queries of S^T and dP^T
  const int cw = threadIdx.x / 128 - 1;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {a.k0 + 16 * warp + g, a.k0 + 16 * warp + g + 8};
  const float c = a.sm_scale * LOG2E;
  float dk_acc[DN / 2], dv_acc[DN / 2];
#pragma unroll
  for (int e = 0; e < DN / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  if (a.first < a.n_q) mbar_wait(a.kv_full, 0);
  const uint64_t dka = sw128_desc(reinterpret_cast<const float*>(a.smem));
  const uint64_t dva =
      sw128_desc(reinterpret_cast<const float*>(a.smem + L::V));
  for (int qb = a.first; qb < a.n_q; ++qb) {
    const int i = qb - a.first;
    const int s = i % L::STAGES;
    mbar_wait(&a.full[s], (i / L::STAGES) & 1);
    const unsigned char* qs = a.smem + L::RING + s * L::STAGE;
    const unsigned char* dos = qs + L::DO;
    const float* lse_s = a.stats + s * 2 * NQ + NH * cw;
    const float* di_s = lse_s + NQ;
    const uint64_t dqk = sw128_desc(
        reinterpret_cast<const float*>(qs + NH * cw * ROW_BYTES));
    const uint64_t ddk = sw128_desc(
        reinterpret_cast<const float*>(dos + NH * cw * ROW_BYTES));
    float sp[NH / 2], dp[NH / 2];  // S^T, dP^T, then P^T, dS^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
      WgmmaBf16<NH, 0>::mma(sp, k_step(dka, kk, L::KV_BOX),
                            k_step(dqk, kk, L::QD_BOX), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
      WgmmaBf16<NH, 0>::mma(dp, k_step(dva, kk, L::KV_BOX),
                            k_step(ddk, kk, L::QD_BOX), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sp);
    fence_regs(dp);

    const int qc = qb * NQ + NH * cw;  // this consumer's first query
    const bool edge = a.k0 + 64 > a.length || qc + NH > a.Tq ||
                      (a.causal && qc < a.k0 + 63);
    dkv_p_ds<NH>(sp, dp, lse_s, di_s, row, qc, t, c, edge, a);
    // bf16 P^T and dS^T: this thread's keys 16 w + g (+ 8), queries 32 cw
    // + 8j + 2t (+ 1), chunk 4 cw + j of a 128-byte row, swizzled
    unsigned char* xp = a.smem + L::XCH + (i % 2) * L::XBUF;
    unsigned char* xs = xp + L::XCH_TILE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const int at = r * ROW_BYTES +
                       ((((NH / 8) * cw + j) ^ (r % 8)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(xp + at) =
            pack(sp[4 * j + 2 * h], sp[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(xs + at) =
            pack(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    consumers_sync();

    // a k16 step of the exchange tiles is 32 bytes along the row (+2)
    const uint64_t pa = sw128_desc(reinterpret_cast<const float*>(xp));
    const uint64_t sa = sw128_desc(reinterpret_cast<const float*>(xs));
    const uint64_t dom = sw128_mn_desc(dos + b0 * L::QD_BOX, L::QD_BOX);
    const uint64_t qm = sw128_mn_desc(qs + b0 * L::QD_BOX, L::QD_BOX);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk)  // dV += P^T dO
      WgmmaBf16<DN, 1>::mma(dv_acc, pa + 2 * kk, dom + 128 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk)  // dK += dS^T Q
      WgmmaBf16<DN, 1>::mma(dk_acc, sa + 2 * kk, qm + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&a.empty[s]);
  }
  // dk and dv through this consumer's boxes of K and V, which no product
  // reads after the last tile's meeting
  const float scale[2] = {a.sm_scale, a.sm_scale};
  const float one[2] = {1.f, 1.f};
  unsigned char* kt = a.smem + b0 * L::KV_BOX;
  unsigned char* vt = kt + L::V;
  stage_tile<DN>(kt, L::KV_BOX, dk_acc, scale, warp, g, t);
  stage_tile<DN>(vt, L::KV_BOX, dv_acc, one, warp, g, t);
  store_tile<DN>(a.dkmap, kt, L::KV_BOX, a.k0, a.bh, cw, b0);
  store_tile<DN>(a.dvmap, vt, L::KV_BOX, a.k0, a.bh, cw, b0);
}

// A dkv block up to D = 256 (DkvRing): the producer warp and the
// consumers of dkv_rows or dkv_split.
template <int D>
__device__ __forceinline__ void dkv_block(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* di, const CUtensorMap* dkmap, const CUtensorMap* dvmap,
    const int* lens, int Tq, int Tk, int causal, float sm_scale) {
  using L = DkvRing<D>;
  constexpr int NQ = DKV_QUERIES;
  float* stats = reinterpret_cast<float*>(smem + L::STATS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::STAGES;

  // batch*head on grid x, k tiles on y: the low k tiles, which causal
  // queries see most, come first
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * L::KEYS;
  const int length = max(0, min(lens[bh], Tk));
  const int n_q = (Tq + NQ - 1) / NQ;
  // a k tile wholly past the length is seen by no query: dk = dv = 0
  const int first = k0 >= length ? n_q : (causal ? k0 / NQ : 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's arrival, the warp's copies
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: warp 0
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x;
    if (lane < 32 && first < n_q) {
      if (lane == 0) {
        mbar_expect(kv_full, L::RING);
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          tma_load_3d(smem + b * L::KV_BOX, kmap, 64 * b, k0, bh, kv_full);
          tma_load_3d(smem + L::V + b * L::KV_BOX, vmap, 64 * b, k0, bh,
                      kv_full);
        }
      }
      for (int qb = first; qb < n_q; ++qb) {
        const int i = qb - first;
        const int s = i % L::STAGES;
        if (i >= L::STAGES)
          mbar_wait(&empty[s], (i / L::STAGES - 1) & 1);
        float* st = stats + s * 2 * NQ;
#pragma unroll
        for (int c = lane; c < NQ; c += 32) {  // rows past Tq: zeros
          const int qr = qb * NQ + c;
          const size_t at = (size_t)bh * Tq + (qr < Tq ? qr : 0);
          cp_async4(st + c, lse + at, qr < Tq);
          cp_async4(st + NQ + c, di + at, qr < Tq);
        }
        cp_async_arrive(&full[s]);
        if (lane == 0) {
          unsigned char* qs = smem + L::RING + s * L::STAGE;
          mbar_expect(&full[s], L::STAGE);
#pragma unroll
          for (int b = 0; b < L::NB; ++b) {
            tma_load_3d(qs + b * L::QD_BOX, qmap, 64 * b, qb * NQ, bh,
                        &full[s]);
            tma_load_3d(qs + L::DO + b * L::QD_BOX, domap, 64 * b, qb * NQ,
                        bh, &full[s]);
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const DkvBlock blk{smem, stats, kv_full, full, empty, dkmap, dvmap, bh,
                     k0, length, n_q, first, Tq, causal, sm_scale};
  if constexpr (!L::SPLIT) {
    dkv_rows<D>(blk);
  } else if constexpr (2 * L::H0 == D) {  // D = 256: one half each
    dkv_split<D, L::H0>(blk, (threadIdx.x / 128 - 1) * L::H0 / 64);
  } else {  // D = 192: boxes 0-1 and box 2
    if (threadIdx.x < 256)
      dkv_split<D, L::H0>(blk, 0);
    else
      dkv_split<D, D - L::H0>(blk, L::H0 / 64);
  }
}

// dq up to D = 256: each consumer warpgroup owns 64 of the block's 128
// q rows and all of D.
template <int D>
__device__ __forceinline__ void dq_rows(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* di, const CUtensorMap* dqmap, const int* lens, int Tq,
    int Tk, int causal, float sm_scale) {
  using L = DqRing<D>;
  constexpr int NK = L::KEYS;
  constexpr int DO = L::NB * L::Q_BOX;  // dO's boxes after Q's
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + L::STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OWN;
  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + NK - 1) / NK;
  if (causal)  // the last tile any of the block's rows sees
    n_tiles = min(n_tiles, (min(q0 + OWN, Tq) + NK - 1) / NK);

  init_ring<L::STAGES>(own_full);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect(own_full, L::RING);
#pragma unroll
      for (int b = 0; b < L::NB; ++b) {
        tma_load_3d(smem + b * L::Q_BOX, qmap, 64 * b, q0, bh, own_full);
        tma_load_3d(smem + DO + b * L::Q_BOX, domap, 64 * b, q0, bh,
                    own_full);
      }
      stream_kv<L>(smem, kmap, vmap, full, empty, n_tiles, bh);
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_wg = q0 + 64 * cw;  // the warpgroup's first row
  const int row[2] = {r_wg + 16 * warp + g, r_wg + 16 * warp + g + 8};
  const float c = sm_scale * LOG2E;  // s * c is s * sm_scale in base 2
  // p = 2^(s c - lse log2(e)); a row past Tq has lse = +inf, so p = 0
  float lse2[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < Tq;
    lse2[h] = in ? lse[(size_t)bh * Tq + row[h]] * LOG2E : INFINITY;
    di_r[h] = in ? di[(size_t)bh * Tq + row[h]] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  if (n_tiles > 0) mbar_wait(own_full, 0);
  const uint64_t dqa = sw128_desc(
      reinterpret_cast<const float*>(smem + cw * 64 * ROW_BYTES));
  const uint64_t doa = sw128_desc(
      reinterpret_cast<const float*>(smem + DO + cw * 64 * ROW_BYTES));
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    const int k0 = i * NK;
    // a tile wholly above this warpgroup's diagonal, or rows all past
    // Tq, add 0
    if (r_wg < Tq && (!causal || k0 <= r_wg + 63)) {
      const unsigned char* st = smem + L::RING + s * L::STAGE;
      const uint64_t dk = sw128_desc(reinterpret_cast<const float*>(st));
      const uint64_t dv =
          sw128_desc(reinterpret_cast<const float*>(st + L::V));
      float sc[NK / 2], dp[NK / 2];  // S, dP, then dS
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
        WgmmaBf16<NK, 0>::mma(sc, k_step(dqa, kk, L::Q_BOX),
                              k_step(dk, kk, L::KV_BOX), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
        WgmmaBf16<NK, 0>::mma(dp, k_step(doa, kk, L::Q_BOX),
                              k_step(dv, kk, L::KV_BOX), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      ds_tile<NK>(sc, dp, lse2, di_r, row, k0, length, causal,
                  k0 + NK > length || (causal && k0 + NK - 1 > r_wg), t, c);
      uint32_t sa[NK / 16][4];  // bf16(dS)
      pack_a<NK>(sa, dp);
      const uint64_t km = sw128_mn_desc(st, L::KV_BOX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)  // dQ += dS K
        WgmmaBf16Rs<D>::mma(acc, sa[kk], km + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_frags(sa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
  }

  // dq through this warpgroup's rows of Q's boxes, free after its last S
  unsigned char* qt = smem + cw * 64 * ROW_BYTES;
  const float scale[2] = {sm_scale, sm_scale};
  stage_tile<D>(qt, L::Q_BOX, acc, scale, warp, g, t);
  store_tile<D>(dqmap, qt, L::Q_BOX, r_wg, bh, cw);
}

// --- past D = 256: the forward and dq with D split between the consumers

// Past D = 256 (the forward and dq at 384 and 512) an f32 accumulator as
// wide as D would take a consumer D / 2 registers, and Q (and dO) for 128
// rows half the shared memory or more. So a block owns 64 q rows, shared
// by both consumer warpgroups, and D is cut in two: consumer cw owns
// boxes NBH cw .. NBH cw + NBH - 1 of D (DH = D / 2 columns) of the
// output, and forms S (and, in dq, dP) over those columns only, as an f32
// partial. Each writes its partials into its half of an exchange buffer,
// the consumers meet (consumers_sync), and each adds the other's partials
// to its own: a thread of either consumer holds the same entries (rows 16
// w + g and + 8, the same columns) of both, and f32 addition commutes, so
// both hold S = S_0 + S_1 bit for bit, and with it the same row max, lse,
// P (and dS). Then each adds P V (dS K) for its own columns of V (K), A
// from registers as below D = 256. Two exchange buffers alternate by
// tile: a consumer writes buffer i % 2 only after both have met at tile
// i - 1, that is after the other has read it at tile i - 2.
constexpr int SPLIT_OWN = 64;  // q rows a block owns past D = 256
// Keys of a K/V tile and stages of the ring: the forward 32-key tiles
// (S partials 16 f32 a thread), dq 16-key tiles (S and dP partials 8
// each), as many stages as fit beside the owned tiles and the exchange.
constexpr int split_fwd_stages(int D) { return D <= 384 ? 3 : 2; }
constexpr int split_dq_stages(int D) { return D <= 384 ? 4 : 2; }

// Shared memory, in bytes, of a split kernel at head dim D: the OWNED
// tiles of 64 rows (Q; Q and dO; in dkv K, or K and V) as NB = D / 64
// boxes each, each stage's streamed pair (K and V; in dkv Q and dO) of K
// rows, the two exchange buffers (each consumer's PARTS partials of [64,
// K] f32), each stage's STATS f32 values a streamed row (dkv's lse, and
// Di), then the barriers.
template <int D, int K, int S, int OWNED, int PARTS, int STATS = 0>
struct SplitRing {
  static constexpr int ROWS = SPLIT_OWN;  // rows a block owns
  static constexpr int KEYS = K;          // rows of a streamed tile
  static constexpr int STAGES = S;
  static constexpr int OWNED_TILES = OWNED;
  static constexpr int NSTAT = STATS;
  static constexpr int NB = D / 64;
  static constexpr int NBH = NB / 2;  // a consumer's boxes of D
  static constexpr int DH = D / 2;
  static constexpr int Q_BOX = SPLIT_OWN * ROW_BYTES;
  static constexpr int KV_BOX = KEYS * ROW_BYTES;
  static constexpr int RING = OWNED_TILES * NB * Q_BOX;  // + s STAGE: stage s
  static constexpr int V = NB * KV_BOX;  // V (dkv: dO) inside a stage
  static constexpr int STAGE = 2 * NB * KV_BOX;
  static constexpr int XCH = RING + STAGES * STAGE;  // buffer b at + b XBUF
  static constexpr int XHALF = PARTS * SPLIT_OWN * KEYS * 4;  // a consumer's
  static constexpr int XBUF = 2 * XHALF;
  static constexpr int STAT = XCH + 2 * XBUF;  // stage s: + s STATS KEYS 4
  static constexpr int BARS = STAT + STAGES * NSTAT * KEYS * 4;
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8;
  static_assert(NB % 2 == 0, "each consumer owns whole boxes of D");
  static_assert(Q_BOX % 1024 == 0 && KV_BOX % 1024 == 0,
                "boxes must keep the swizzle's alignment");
  static_assert(KEYS % 16 == 0, "a tile is whole k16 steps of P V, dS K");
  static_assert(BYTES <= SMEM_LIMIT, "the ring does not fit");
};
template <int D>
using FwdSplit = SplitRing<D, 32, split_fwd_stages(D), 1, 1>;
template <int D>
using DqSplit = SplitRing<D, 16, split_dq_stages(D), 2, 2>;

// This thread's N f32 partial entries into float4 slots j0 .. j0 + N / 4 -
// 1 of its consumer's half `mine` of an exchange buffer (slot j of thread
// tid at float4 j * 128 + tid: a quarter warp's stores fill 128 bytes).
template <int N>
__device__ __forceinline__ void xch_put(float4* mine, const float (&p)[N],
                                        int j0) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    mine[(j0 + j) * 128] =
        make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
}
// ... and, after the consumers have met, the other's entries added.
template <int N>
__device__ __forceinline__ void xch_add(const float4* theirs, float (&p)[N],
                                        int j0) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 o = theirs[(j0 + j) * 128];
    p[4 * j] += o.x;
    p[4 * j + 1] += o.y;
    p[4 * j + 2] += o.z;
    p[4 * j + 3] += o.w;
  }
}

// The forward past D = 256 (FwdSplit): 64 q rows a block, each consumer
// owning DH columns of O.
template <int D>
__device__ __forceinline__ void fwd_split(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* omap, const int* lens,
    float* lse, int Tq, int Tk, int causal, float sm_scale) {
  using L = FwdSplit<D>;
  constexpr int NK = L::KEYS;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * SPLIT_OWN;
  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + NK - 1) / NK;
  if (causal)  // the last tile any of the block's rows sees
    n_tiles = min(n_tiles, (min(q0 + SPLIT_OWN, Tq) + NK - 1) / NK);

  init_ring<L::STAGES>(q_full);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect(q_full, L::RING);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
        tma_load_3d(smem + b * L::Q_BOX, qmap, 64 * b, q0, bh, q_full);
      stream_kv<L>(smem, kmap, vmap, full, empty, n_tiles, bh);
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b0 = cw * L::NBH;  // this consumer's first box of D
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float c = sm_scale * LOG2E;  // s * c is s * sm_scale in base 2
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m unscaled
  float acc[L::DH / 2];
#pragma unroll
  for (int e = 0; e < L::DH / 2; ++e) acc[e] = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  const uint64_t dq = sw128_desc(
      reinterpret_cast<const float*>(smem + b0 * L::Q_BOX));
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    const unsigned char* st = smem + L::RING + s * L::STAGE;
    const uint64_t dk =
        sw128_desc(reinterpret_cast<const float*>(st + b0 * L::KV_BOX));
    const uint64_t dv = sw128_mn_desc(st + L::V + b0 * L::KV_BOX, L::KV_BOX);

    float sc[NK / 2];  // this consumer's partial of S = Q K^T, then S
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::DH / 16; ++kk)
      WgmmaBf16<NK, 0>::mma(sc, k_step(dq, kk, L::Q_BOX),
                            k_step(dk, kk, L::KV_BOX), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    float4* x =
        reinterpret_cast<float4*>(smem + L::XCH + (i % 2) * L::XBUF) + tid;
    xch_put<NK / 2>(x + cw * (L::XHALF / 16), sc, 0);
    consumers_sync();
    xch_add<NK / 2>(x + (1 - cw) * (L::XHALF / 16), sc, 0);

    const int k0 = i * NK;
    float alpha[2];
    softmax_tile<NK>(sc, m, l, alpha, row, k0, length, causal,
                     k0 + NK > length || (causal && k0 + NK - 1 > q0), t, c);
#pragma unroll
    for (int e = 0; e < L::DH / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];

    uint32_t pa[NK / 16][4];  // bf16(P), the A of O += P V
    pack_a<NK>(pa, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      WgmmaBf16Rs<L::DH>::mma(acc, pa[kk], dv + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
  }

  // o through this consumer's boxes of Q, which only its own S read
  unsigned char* ot = smem + b0 * L::Q_BOX;
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  stage_tile<L::DH>(ot, L::Q_BOX, acc, inv, warp, g, t);
  store_tile<L::DH>(omap, ot, L::Q_BOX, q0, bh, cw, b0);
  if (cw == 0 && t == 0)  // both consumers hold the same m and l
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tq)
        lse[(size_t)bh * Tq + row[h]] =
            l[h] > 0.f ? m[h] * sm_scale + logf(fmaxf(l[h], 1e-30f))
                       : INFINITY;
}

// dq past D = 256 (DqSplit): 64 q rows a block, Q and dO resident, each
// consumer owning DH columns of dQ.
template <int D>
__device__ __forceinline__ void dq_split(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* di, const CUtensorMap* dqmap, const int* lens, int Tq,
    int Tk, int causal, float sm_scale) {
  using L = DqSplit<D>;
  constexpr int NK = L::KEYS;
  constexpr int DO = L::NB * L::Q_BOX;  // dO's boxes after Q's
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + L::STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * SPLIT_OWN;
  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + NK - 1) / NK;
  if (causal)  // the last tile any of the block's rows sees
    n_tiles = min(n_tiles, (min(q0 + SPLIT_OWN, Tq) + NK - 1) / NK);

  init_ring<L::STAGES>(own_full);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect(own_full, L::RING);
#pragma unroll
      for (int b = 0; b < L::NB; ++b) {
        tma_load_3d(smem + b * L::Q_BOX, qmap, 64 * b, q0, bh, own_full);
        tma_load_3d(smem + DO + b * L::Q_BOX, domap, 64 * b, q0, bh,
                    own_full);
      }
      stream_kv<L>(smem, kmap, vmap, full, empty, n_tiles, bh);
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b0 = cw * L::NBH;  // this consumer's first box of D
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float c = sm_scale * LOG2E;  // s * c is s * sm_scale in base 2
  // p = 2^(s c - lse log2(e)); a row past Tq has lse = +inf, so p = 0
  float lse2[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < Tq;
    lse2[h] = in ? lse[(size_t)bh * Tq + row[h]] * LOG2E : INFINITY;
    di_r[h] = in ? di[(size_t)bh * Tq + row[h]] : 0.f;
  }
  float acc[L::DH / 2];
#pragma unroll
  for (int e = 0; e < L::DH / 2; ++e) acc[e] = 0.f;

  if (n_tiles > 0) mbar_wait(own_full, 0);
  const uint64_t dqa = sw128_desc(
      reinterpret_cast<const float*>(smem + b0 * L::Q_BOX));
  const uint64_t doa = sw128_desc(
      reinterpret_cast<const float*>(smem + DO + b0 * L::Q_BOX));
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % L::STAGES;
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    const int k0 = i * NK;
    const unsigned char* st = smem + L::RING + s * L::STAGE;
    const uint64_t dk =
        sw128_desc(reinterpret_cast<const float*>(st + b0 * L::KV_BOX));
    const uint64_t dv = sw128_desc(
        reinterpret_cast<const float*>(st + L::V + b0 * L::KV_BOX));
    float sc[NK / 2], dp[NK / 2];  // partials of S and dP, then S, dS
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::DH / 16; ++kk)  // S = Q K^T
      WgmmaBf16<NK, 0>::mma(sc, k_step(dqa, kk, L::Q_BOX),
                            k_step(dk, kk, L::KV_BOX), kk);
#pragma unroll
    for (int kk = 0; kk < L::DH / 16; ++kk)  // dP = dO V^T
      WgmmaBf16<NK, 0>::mma(dp, k_step(doa, kk, L::Q_BOX),
                            k_step(dv, kk, L::KV_BOX), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    float4* x =
        reinterpret_cast<float4*>(smem + L::XCH + (i % 2) * L::XBUF) + tid;
    xch_put<NK / 2>(x + cw * (L::XHALF / 16), sc, 0);
    xch_put<NK / 2>(x + cw * (L::XHALF / 16), dp, NK / 8);
    consumers_sync();
    xch_add<NK / 2>(x + (1 - cw) * (L::XHALF / 16), sc, 0);
    xch_add<NK / 2>(x + (1 - cw) * (L::XHALF / 16), dp, NK / 8);

    ds_tile<NK>(sc, dp, lse2, di_r, row, k0, length, causal,
                k0 + NK > length || (causal && k0 + NK - 1 > q0), t, c);
    uint32_t sa[NK / 16][4];  // bf16(dS)
    pack_a<NK>(sa, dp);
    const uint64_t km = sw128_mn_desc(st + b0 * L::KV_BOX, L::KV_BOX);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)  // dQ += dS K
      WgmmaBf16Rs<L::DH>::mma(acc, sa[kk], km + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(sa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
  }

  // dq through this consumer's boxes of Q, which only its own S read
  unsigned char* qt = smem + b0 * L::Q_BOX;
  const float scale[2] = {sm_scale, sm_scale};
  stage_tile<L::DH>(qt, L::Q_BOX, acc, scale, warp, g, t);
  store_tile<L::DH>(dqmap, qt, L::Q_BOX, q0, bh, cw, b0);
}

// --- past D = 256: dkv as two halves, dK and dV, with D split ------------

// Past D = 256 (dkv at 384 and 512) dK and dV of 64 keys in f32 are D
// values a key each, the SM's whole register file at D = 512, and K, V
// and one stage of 64-query Q/dO tiles 256 KB there. So a block owns 64
// keys and computes one of the two outputs, the grid's z axis: z = 0 dK
// (DkHalf), z = 1 dV (DvHalf). Each is the split layout above with the
// roles of q and k swapped: the owned tiles are the keys' (K and V; K),
// the streamed pair is a Q/dO tile (16 queries; 32) with its lse and Di
// (lse) copied beside it by the producer warp's cp.async, and consumer
// cw owns boxes NBH cw .. NBH cw + NBH - 1 of the output (128 f32
// registers at D = 512), and holds its half of K as the register A of S^T
// (64 registers at D = 512, read from shared memory once: 5% faster at B8
// H4 T2048 D512 than K read by every S^T product, PERF.md §6):
// - dK (dq_split transposed): S^T = K Q^T and dP^T = V dO^T over the
//   consumer's half of D, the f32 partials exchanged and summed, dS^T =
//   P^T (dP^T - Di) rounded to bf16 into the register A, dK += dS^T Q;
// - dV (fwd_split transposed, without the online softmax): S^T's
//   partials exchanged and summed, P^T = exp(S^T sm_scale - lse) rounded
//   into the register A, dV += P^T dO.
// S^T is formed in both: 10 D FLOPs a visible (q, k) pair against dkv's
// 8 D, on blocks that each hold half of the work.
template <int D>
using DkHalf = SplitRing<D, 16, split_dq_stages(D), 2, 2, 2>;
template <int D>
using DvHalf = SplitRing<D, 32, split_fwd_stages(D), 1, 1, 1>;
constexpr int HALF_BOX_ROWS = 16;  // rows of a Q/dO box, both halves

// This thread's register A (WgmmaBf16Rs) of N / 16 k16 steps of a
// warpgroup's [64, N] bf16 tile in shared memory, K-major in boxes of 64
// columns `box` bytes apart in the 128-byte swizzle (as TMA lays it):
// rows 16 w + g and + 8, columns 16 kk + 2t, + 1 and 16 kk + 2t + 8, + 9.
template <int N>
__device__ __forceinline__ void load_a(uint32_t (&a)[N / 16][4],
                                       const unsigned char* tile, int box,
                                       int warp, int g, int t) {
  const int r = 16 * warp + g;
  const unsigned char* row = tile + r * ROW_BYTES + 4 * t;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const unsigned char* lo = row + (kk / 4) * box +
                              (((2 * (kk % 4)) ^ (r % 8)) << 4);
    const unsigned char* hi = row + (kk / 4) * box +
                              (((2 * (kk % 4) + 1) ^ (r % 8)) << 4);
    a[kk][0] = *reinterpret_cast<const uint32_t*>(lo);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(lo + 8 * ROW_BYTES);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(hi);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(hi + 8 * ROW_BYTES);
  }
}

// The producer warp of a dkv half L: the block's 64 keys of K (and, in
// dK, V) once, then Q/dO tiles first .. n_q - 1 of L::KEYS queries (in
// boxes of HALF_BOX_ROWS rows, which stack into the swizzle of one box as
// tall as the tile), tile i into stage i % STAGES once the consumers have
// emptied it, with its lse (and Di) copied beside it (zeros past Tq).
template <class L>
__device__ __forceinline__ void stream_qdo(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* di, uint64_t* own_full, uint64_t* full, uint64_t* empty,
    int bh, int k0, int first, int n_q, int Tq) {
  constexpr int NQ = L::KEYS;
  const int lane = threadIdx.x;
  float* stats = reinterpret_cast<float*>(smem + L::STAT);
  if (lane == 0) {
    mbar_expect(own_full, L::RING);
#pragma unroll
    for (int b = 0; b < L::NB; ++b) {
      tma_load_3d(smem + b * L::Q_BOX, kmap, 64 * b, k0, bh, own_full);
      if constexpr (L::OWNED_TILES == 2)
        tma_load_3d(smem + (L::NB + b) * L::Q_BOX, vmap, 64 * b, k0, bh,
                    own_full);
    }
  }
  for (int qb = first; qb < n_q; ++qb) {
    const int i = qb - first;
    const int s = i % L::STAGES;
    if (i >= L::STAGES) mbar_wait(&empty[s], (i / L::STAGES - 1) & 1);
    float* st = stats + s * L::NSTAT * NQ;
#pragma unroll
    for (int c = lane; c < NQ; c += 32) {
      const int qr = qb * NQ + c;
      const size_t at = (size_t)bh * Tq + (qr < Tq ? qr : 0);
      cp_async4(st + c, lse + at, qr < Tq);
      if constexpr (L::NSTAT == 2) cp_async4(st + NQ + c, di + at, qr < Tq);
    }
    cp_async_arrive(&full[s]);
    if (lane == 0) {
      unsigned char* qs = smem + L::RING + s * L::STAGE;
      mbar_expect(&full[s], L::STAGE);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
#pragma unroll
        for (int r = 0; r < NQ; r += HALF_BOX_ROWS) {
          tma_load_3d(qs + b * L::KV_BOX + r * ROW_BYTES, qmap, 64 * b,
                      qb * NQ + r, bh, &full[s]);
          tma_load_3d(qs + L::V + b * L::KV_BOX + r * ROW_BYTES, domap,
                      64 * b, qb * NQ + r, bh, &full[s]);
        }
    }
  }
}

// The consumers of a dkv half past D = 256 (DK: DkHalf, else DvHalf):
// both own the block's 64 keys, each DH columns of dK (dV).
template <int D, bool DK>
__device__ __forceinline__ void dkv_half_consumers(const DkvBlock& a) {
  using L = std::conditional_t<DK, DkHalf<D>, DvHalf<D>>;
  constexpr int NQ = L::KEYS;
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b0 = cw * L::NBH;  // this consumer's first box of D
  const int row[2] = {a.k0 + 16 * warp + g, a.k0 + 16 * warp + g + 8};
  const float c = a.sm_scale * LOG2E;
  float acc[L::DH / 2];
#pragma unroll
  for (int e = 0; e < L::DH / 2; ++e) acc[e] = 0.f;

  if (a.first < a.n_q) mbar_wait(a.kv_full, 0);
  uint32_t ka[L::DH / 16][4];  // this consumer's half of K, S^T's A
  load_a<L::DH>(ka, a.smem + b0 * L::Q_BOX, L::Q_BOX, warp, g, t);
  for (int qb = a.first; qb < a.n_q; ++qb) {
    const int i = qb - a.first;
    const int s = i % L::STAGES;
    mbar_wait(&a.full[s], (i / L::STAGES) & 1);
    const unsigned char* qs = a.smem + L::RING + s * L::STAGE;
    const unsigned char* dos = qs + L::V;
    const uint64_t dqk =
        sw128_desc(reinterpret_cast<const float*>(qs + b0 * L::KV_BOX));
    // partials of S^T (and dP^T), then P^T (and dS^T)
    float sp[NQ / 2], dp[DK ? NQ / 2 : 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::DH / 16; ++kk)  // S^T = K Q^T
      WgmmaBf16Rs<NQ, 0>::mma(sp, ka[kk], k_step(dqk, kk, L::KV_BOX), kk);
    if constexpr (DK) {  // V's half, resident after K's boxes
      const uint64_t dva = sw128_desc(reinterpret_cast<const float*>(
          a.smem + (L::NB + b0) * L::Q_BOX));
      const uint64_t ddk =
          sw128_desc(reinterpret_cast<const float*>(dos + b0 * L::KV_BOX));
#pragma unroll
      for (int kk = 0; kk < L::DH / 16; ++kk)  // dP^T = V dO^T
        WgmmaBf16<NQ, 0>::mma(dp, k_step(dva, kk, L::Q_BOX),
                              k_step(ddk, kk, L::KV_BOX), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sp);
    fence_regs(dp);
    fence_frags(ka);
    float4* x =
        reinterpret_cast<float4*>(a.smem + L::XCH + (i % 2) * L::XBUF) + tid;
    float4* mine = x + cw * (L::XHALF / 16);
    float4* theirs = x + (1 - cw) * (L::XHALF / 16);
    xch_put<NQ / 2>(mine, sp, 0);
    if constexpr (DK) xch_put<NQ / 2>(mine, dp, NQ / 8);
    consumers_sync();
    xch_add<NQ / 2>(theirs, sp, 0);
    if constexpr (DK) xch_add<NQ / 2>(theirs, dp, NQ / 8);

    const int q0 = qb * NQ;
    const float* lse_s = a.stats + s * L::NSTAT * NQ;
    const bool edge = a.k0 + 64 > a.length || q0 + NQ > a.Tq ||
                      (a.causal && q0 < a.k0 + 63);
    uint32_t pa[NQ / 16][4];  // bf16(dS^T) or bf16(P^T), the A of the output
    if constexpr (DK) {
      dkv_p_ds<NQ>(sp, dp, lse_s, lse_s + NQ, row, q0, t, c, edge, a);
      pack_a<NQ>(pa, dp);
    } else {
      dkv_p<NQ>(sp, lse_s, row, q0, t, c, edge, a);
      pack_a<NQ>(pa, sp);
    }
    // dK += dS^T Q, dV += P^T dO
    const uint64_t bm =
        sw128_mn_desc((DK ? qs : dos) + b0 * L::KV_BOX, L::KV_BOX);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk)
      WgmmaBf16Rs<L::DH>::mma(acc, pa[kk], bm + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&a.empty[s]);  // this warp is done with it
  }

  // dk (dv) through this consumer's boxes of K, which only its own
  // load_a read
  unsigned char* out = a.smem + b0 * L::Q_BOX;
  const float scale[2] = {DK ? a.sm_scale : 1.f, DK ? a.sm_scale : 1.f};
  stage_tile<L::DH>(out, L::Q_BOX, acc, scale, warp, g, t);
  store_tile<L::DH>(DK ? a.dkmap : a.dvmap, out, L::Q_BOX, a.k0, a.bh, cw,
                    b0);
}

// A dkv block past D = 256: half DK (dK, else dV) of the 64 keys from
// blockIdx.y * 64 on, its query tiles from the causal bound.
template <int D, bool DK>
__device__ __forceinline__ void dkv_half(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* di, const CUtensorMap* dkmap, const CUtensorMap* dvmap,
    const int* lens, int Tq, int Tk, int causal, float sm_scale) {
  using L = std::conditional_t<DK, DkHalf<D>, DvHalf<D>>;
  constexpr int NQ = L::KEYS;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + L::STAGES;

  // the low k tiles, which causal queries see most, come first
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * L::ROWS;
  const int length = max(0, min(lens[bh], Tk));
  const int n_q = (Tq + NQ - 1) / NQ;
  // a k tile wholly past the length is seen by no query: its output is 0
  const int first = k0 >= length ? n_q : (causal ? k0 / NQ : 0);

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's arrival, the warp's copies
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: warp 0
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32 && first < n_q)
      stream_qdo<L>(smem, qmap, kmap, vmap, domap, lse, di, own_full, full,
                    empty, bh, k0, first, n_q, Tq);
    return;
  }
  setmaxnreg_inc<240>();

  const float* stats = reinterpret_cast<const float*>(smem + L::STAT);
  const DkvBlock blk{smem, stats, own_full, full, empty, dkmap, dvmap, bh,
                     k0, length, n_q, first, Tq, causal, sm_scale};
  dkv_half_consumers<D, DK>(blk);
}

// --- past D = 512: the forward with O cut into slices of D --------------
//
// Past D = 512 neither fwd_split's O (D / 2 f32 registers a consumer) nor
// its whole-D K/V tiles fit. The wrapper pads D to a multiple of 128 (Dp),
// and O is cut into slices of up to SLICE columns on the grid's z axis:
// block z owns columns SLICE z .. of O for 64 q rows, each consumer half of
// them (HB boxes of 64 columns, at most 4: 128 f32 registers, as
// fwd_split's at D = 512). Every block forms S over all of Dp: consumer cw
// sums its partial over boxes NBH cw .. NBH cw + NBH - 1 of Dp (NBH =
// Dp / 128), the partials meet as in fwd_split (exchange, sum), then each
// adds P V for its HB boxes of the slice's V. Every slice forms S, the
// row max, the denominator and P from the same boxes in the same order, so
// every slice holds the same bits and slice 0 alone writes lse. S is
// formed ceil(Dp / SLICE) times: twice at Dp = 640 and 1024.
// The boxes stream through one ring of uniform stages, in the order the
// consumers take them: for each 32-key tile, NBH stages of K boxes (one
// box a consumer: box j and NBH + j), then HB stages of V boxes (box
// SLICE z / 64 + k and + HB + k). The loop over Dp's boxes runs at run
// time, so any Dp past 512 is taken. Q (64 rows, Dp / 64 boxes) stays
// resident up to SLICE_Q_MAX (128 KB at Dp = 1024); past it each K stage
// also brings the two Q boxes its products read (QRES false), so nothing
// in shared memory grows with Dp. A stage's products stay in flight
// while the next stage's are issued; a stage is released once they are
// done (wgmma.wait_group 1). The output leaves through the ring once
// both consumers have read their last stage. Shared memory: 229,512 bytes at
// Dp = 1024 (Q 128 KB, eight stages of 8 KB, the exchange 32 KB) and past
// it (eight stages of 24 KB with their Q boxes), 180,360 at Dp = 640.
constexpr int SLICE = 512;        // columns of O a block owns at most
constexpr int SLICE_KEYS = 32;    // keys of a K/V tile
constexpr int SLICE_STAGES = 8;   // stages of the ring
constexpr int SLICE_Q_MAX = 1024;  // the widest Dp whose Q stays resident

// Shared memory, in bytes, of the slice forward at padded head dim Dp: Q's
// Dp / 64 boxes (QRES), the ring's stages (two K or V boxes, and with
// QRES false two Q boxes), the two exchange buffers of both consumers' S
// partials, then the barriers (Q's, and each stage's full and empty).
template <bool QRES>
struct SliceRing {
  static constexpr int KEYS = SLICE_KEYS;
  static constexpr int STAGES = SLICE_STAGES;
  static constexpr int Q_BOX = SPLIT_OWN * ROW_BYTES;
  static constexpr int KV_BOX = KEYS * ROW_BYTES;
  static constexpr int QS = 2 * KV_BOX;  // a stage's Q boxes (QRES false)
  static constexpr int STAGE = QS + (QRES ? 0 : 2 * Q_BOX);
  static constexpr int XHALF = SPLIT_OWN * KEYS * 4;  // a consumer's partial
  static constexpr int XBUF = 2 * XHALF;
  __host__ __device__ static constexpr int ring(int Dp) {
    return QRES ? Dp / 64 * Q_BOX : 0;
  }
  __host__ __device__ static constexpr int xch(int Dp) {
    return ring(Dp) + STAGES * STAGE;
  }
  __host__ __device__ static constexpr int bars(int Dp) {
    return xch(Dp) + 2 * XBUF;
  }
  __host__ __device__ static constexpr int bytes(int Dp) {
    return bars(Dp) + (1 + 2 * STAGES) * 8;
  }
  static_assert(Q_BOX % 1024 == 0 && KV_BOX % 1024 == 0,
                "boxes must keep the swizzle's alignment");
  static_assert(STAGES * STAGE >= 2 * (SLICE / 2) * SPLIT_OWN * 2,
                "the ring holds both consumers' output tiles");
};
static_assert(SliceRing<true>::bytes(SLICE_Q_MAX) <= SMEM_LIMIT &&
                  SliceRing<false>::bytes(0) <= SMEM_LIMIT,
              "the ring does not fit");

// One consumer warp is done with stage u of a ring of STAGES: its empty
// arrival.
template <int STAGES>
__device__ __forceinline__ void release_stage(uint64_t* empty, int u,
                                              int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[u % STAGES]);
}

// The slice forward's block (SliceRing<QRES>) at slice z = blockIdx.z,
// each consumer owning HB boxes of its O.
template <bool QRES, int HB>
__device__ __forceinline__ void fwd_slice(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* omap, const int* lens,
    float* lse, int Tq, int Tk, int Dp, int causal, float sm_scale) {
  using L = SliceRing<QRES>;
  constexpr int NK = L::KEYS;
  constexpr int STAGES = L::STAGES;
  const int NBH = Dp / 128;  // a consumer's boxes of S's sum
  const int sb0 = blockIdx.z * (SLICE / 64);  // the slice's first box
  unsigned char* ring = smem + L::ring(Dp);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars(Dp));
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * SPLIT_OWN;
  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + NK - 1) / NK;
  if (causal)  // the last tile any of the block's rows sees
    n_tiles = min(n_tiles, (min(q0 + SPLIT_OWN, Tq) + NK - 1) / NK);

  init_ring<STAGES>(q_full);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      if (QRES) {
        mbar_expect(q_full, Dp / 64 * L::Q_BOX);
        for (int b = 0; b < Dp / 64; ++b)
          tma_load_3d(smem + b * L::Q_BOX, qmap, 64 * b, q0, bh, q_full);
      }
      int u = 0;
      for (int i = 0; i < n_tiles; ++i) {
        for (int j = 0; j < NBH; ++j, ++u) {  // K (and Q) box j, NBH + j
          const int s = ring_acquire<STAGES>(full, empty, u, L::STAGE);
          unsigned char* st = ring + s * L::STAGE;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            tma_load_3d(st + c * L::KV_BOX, kmap, 64 * (c * NBH + j), i * NK,
                        bh, &full[s]);
            if (!QRES)
              tma_load_3d(st + L::QS + c * L::Q_BOX, qmap,
                          64 * (c * NBH + j), q0, bh, &full[s]);
          }
        }
#pragma unroll
        for (int k = 0; k < HB; ++k, ++u) {  // V box sb0 + k, + HB + k
          const int s = ring_acquire<STAGES>(full, empty, u, L::QS);
          unsigned char* st = ring + s * L::STAGE;
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tma_load_3d(st + c * L::KV_BOX, vmap, 64 * (sb0 + c * HB + k),
                        i * NK, bh, &full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float c = sm_scale * LOG2E;  // s * c is s * sm_scale in base 2
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m unscaled
  float acc[HB * 32];  // box k of this consumer's O: acc[32 k ..]
#pragma unroll
  for (int e = 0; e < HB * 32; ++e) acc[e] = 0.f;

  if (QRES && n_tiles > 0) mbar_wait(q_full, 0);
  int u = 0;  // the ring's stages taken so far
  for (int i = 0; i < n_tiles; ++i) {
    float sc[NK / 2];  // this consumer's partial of S = Q K^T, then S
    for (int j = 0; j < NBH; ++j, ++u) {
      const int s = u % STAGES;
      mbar_wait(&full[s], (u / STAGES) & 1);
      const unsigned char* st = ring + s * L::STAGE;
      const uint64_t dq = sw128_desc(reinterpret_cast<const float*>(
          QRES ? smem + (cw * NBH + j) * L::Q_BOX : st + L::QS +
                                                     cw * L::Q_BOX));
      const uint64_t dk =
          sw128_desc(reinterpret_cast<const float*>(st + cw * L::KV_BOX));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaBf16<NK, 0>::mma(sc, dq + 2 * kk, dk + 2 * kk, j + kk);
      wgmma_commit();
      if (j > 0) {
        wgmma_wait_one();  // the stage before is read
        release_stage<STAGES>(empty, u - 1, lane);
      }
    }
    wgmma_wait_all();
    fence_regs(sc);
    release_stage<STAGES>(empty, u - 1, lane);
    float4* x =
        reinterpret_cast<float4*>(smem + L::xch(Dp) + (i % 2) * L::XBUF) + tid;
    xch_put<NK / 2>(x + cw * (L::XHALF / 16), sc, 0);
    consumers_sync();
    xch_add<NK / 2>(x + (1 - cw) * (L::XHALF / 16), sc, 0);

    const int k0 = i * NK;
    float alpha[2];
    softmax_tile<NK>(sc, m, l, alpha, row, k0, length, causal,
                     k0 + NK > length || (causal && k0 + NK - 1 > q0), t, c);
#pragma unroll
    for (int e = 0; e < HB * 32; ++e) acc[e] *= alpha[(e >> 1) & 1];

    uint32_t pa[NK / 16][4];  // bf16(P), the A of O += P V
    pack_a<NK>(pa, sc);
#pragma unroll
    for (int k = 0; k < HB; ++k, ++u) {
      const int s = u % STAGES;
      mbar_wait(&full[s], (u / STAGES) & 1);
      const uint64_t dv =
          sw128_mn_desc(ring + s * L::STAGE + cw * L::KV_BOX, L::KV_BOX);
      float(&ak)[32] = *reinterpret_cast<float(*)[32]>(acc + 32 * k);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        WgmmaBf16Rs<64>::mma(ak, pa[kk], dv + 128 * kk, 1);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait_one();  // the stage before is read
        release_stage<STAGES>(empty, u - 1, lane);
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
    release_stage<STAGES>(empty, u - 1, lane);
    fence_frags(pa);
  }

  // o through the ring, free once both consumers have read their last stage
  consumers_sync();
  unsigned char* ot = ring + cw * HB * L::Q_BOX;
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  stage_tile<HB * 64>(ot, L::Q_BOX, acc, inv, warp, g, t);
  store_tile<HB * 64>(omap, ot, L::Q_BOX, q0, bh, cw, sb0 + cw * HB);
  if (blockIdx.z == 0 && cw == 0 && t == 0)  // every slice holds these
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tq)
        lse[(size_t)bh * Tq + row[h]] =
            l[h] > 0.f ? m[h] * sm_scale + logf(fmaxf(l[h], 1e-30f))
                       : INFINITY;
}

// The slice forward past D = 512: block z takes slice z of O, its
// consumers HB = min(SLICE, Dp - SLICE z) / 128 boxes each.
template <bool QRES>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_slice_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap omap,
                                const int* __restrict__ lens,
                                float* __restrict__ lse, int Tq, int Tk,
                                int Dp, int causal, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  switch (min(SLICE, Dp - SLICE * (int)blockIdx.z) / 128) {
    case 4:
      fwd_slice<QRES, 4>(smem, &qmap, &kmap, &vmap, &omap, lens, lse, Tq, Tk,
                         Dp, causal, sm_scale);
      break;
    case 3:
      fwd_slice<QRES, 3>(smem, &qmap, &kmap, &vmap, &omap, lens, lse, Tq, Tk,
                         Dp, causal, sm_scale);
      break;
    case 2:
      fwd_slice<QRES, 2>(smem, &qmap, &kmap, &vmap, &omap, lens, lse, Tq, Tk,
                         Dp, causal, sm_scale);
      break;
    default:
      fwd_slice<QRES, 1>(smem, &qmap, &kmap, &vmap, &omap, lens, lse, Tq, Tk,
                         Dp, causal, sm_scale);
  }
}

// --- past D = 512: dq, and dk and dv, with outputs in slices of D --------
//
// Past D = 512 neither dq_split's dQ nor dkv_half's dK (D / 2 f32
// registers a consumer) fits, nor do the owned tiles: 64 rows of Q and dO
// (of K and V) take 256 KB at Dp = 1024. The wrapper pads D to a multiple
// of 128 (Dp) and the outputs are cut into slices on the grid's z axis.
// A block owns 64 rows (q rows in dq, keys in dkv: A1 and A2 are Q and dO,
// or K and V) and walks tiles of BWD_SLICE_ROWS streamed rows (keys in dq,
// queries in dkv: B1 and B2 are K and V, or Q and dO). The consumers
// split the work by operand, not by D: consumer 0 forms X = A1 B1^T (S, or
// S^T in dkv), consumer 1 Y = A2 B2^T (dP, or dP^T), each over all of
// Dp's 64-column boxes in order, and both write theirs into an exchange
// buffer, meet, and read both back: every thread of either consumer holds
// the same entries of S and dP (rows 16 w + g and + 8), forms P and dS
// from them with the same instructions, and every slice does the same, so
// every block that shares a tile holds its P and dS bit for bit (the order
// over Dp's boxes does not depend on blockIdx.z). Then each adds its
// output's product for its boxes of the slice, A from registers (as in
// dq_split and dkv_half), B the slice's boxes of the streamed tile read
// MN-major:
// - dq (flash_bwd_dq_slice_bf16_kernel): dQ += dS K, slices of DQ_SLICE
//   columns, each consumer half of them (HB boxes, at most 4: 128 f32
//   registers, as dq_split's at D = 512);
// - dkv (flash_bwd_dkv_slice_bf16_kernel): consumer 0 dK += dS^T Q,
//   consumer 1 dV += P^T dO, slices of DKV_SLICE columns, each consumer
//   all of them of its output (HB boxes, at most 4). S^T and dP^T are
//   formed once for both outputs (the dK and dV halves of dkv_half would
//   form S^T twice and leave one consumer idle in the dV half), so slices
//   half as wide as dq's cost the same formations a column.
// Stages are uniform and stream through one ring in the order the
// consumers take them: for each tile, Dp / 64 stages of box b of B1 and
// of B2 (one box a consumer), then HB stages of the slice's boxes (dq:
// K's box k and HB + k of the slice; dkv: Q's and dO's box k). A1 stays
// resident up to BWD_RES_MAX (ARES) and each box stage brings A2's box;
// past it each box stage also brings A1's, so nothing in shared memory
// grows with Dp and any Dp is taken (both streamed at Dp 1024 ran twice
// as slow; both resident, which fits at Dp 640 only, 1-8% faster there:
// PERF.md §6). A stage's products stay in flight while the next stage's
// are issued; a stage is released once they are done. lse and Di come
// from global memory: in dq each thread's two rows' once, in dkv each
// thread's columns' at each tile's start. The outputs leave through A1's
// resident boxes (ARES) or the ring once both consumers are done.
// Shared memory: 229,448 bytes with A1 resident
// at Dp = 1024 (128 KB, four stages of 16 KB with A2's box, the exchange
// 32 KB), 180,296 at Dp = 640, and 229,512 past 1024 (eight stages of 24
// KB with both owned boxes).
constexpr int BWD_SLICE_ROWS = 32;  // streamed rows a tile: keys, queries
constexpr int DQ_SLICE = 512;       // columns of dq a block owns at most
constexpr int DKV_SLICE = 256;      // columns of dk, dv a block owns at most
constexpr int BWD_RES_MAX = 1024;   // the widest Dp with A1 resident

// Shared memory, in bytes, of a backward slice instance at padded head dim
// Dp: A1's Dp / 64 boxes of 64 rows (ARES), the ring's stages (B1's and
// B2's box, A2's, and A1's without ARES), the two exchange buffers of both
// consumers' [64, ROWS] f32 products, then the barriers (A1's, and each
// stage's full and empty).
template <bool ARES>
struct BwdSliceRing {
  static constexpr int ROWS = BWD_SLICE_ROWS;
  static constexpr int STAGES = ARES ? 4 : 8;
  static constexpr int A_BOX = SPLIT_OWN * ROW_BYTES;  // an owned box
  static constexpr int B_BOX = ROWS * ROW_BYTES;       // a streamed box
  static constexpr int STAGE = 2 * B_BOX + (ARES ? 1 : 2) * A_BOX;
  static constexpr int XHALF = SPLIT_OWN * ROWS * 4;  // a consumer's product
  static constexpr int XBUF = 2 * XHALF;
  __host__ __device__ static constexpr int ring(int Dp) {
    return ARES ? Dp / 64 * A_BOX : 0;
  }
  __host__ __device__ static constexpr int xch(int Dp) {
    return ring(Dp) + STAGES * STAGE;
  }
  __host__ __device__ static constexpr int bars(int Dp) {
    return xch(Dp) + 2 * XBUF;
  }
  __host__ __device__ static constexpr int bytes(int Dp) {
    return bars(Dp) + (1 + 2 * STAGES) * 8;
  }
  static_assert(A_BOX % 1024 == 0 && B_BOX % 1024 == 0,
                "boxes must keep the swizzle's alignment");
  static_assert(ROWS % 16 == 0, "a tile is whole k16 steps of the outputs");
};
static_assert(BwdSliceRing<true>::bytes(BWD_RES_MAX) <= SMEM_LIMIT &&
                  BwdSliceRing<false>::bytes(0) <= SMEM_LIMIT,
              "the ring does not fit");
// the outputs leave through offset 0: A1's boxes (ARES: ten or more past
// Dp = 512) or the ring's stages hold both consumers' 4 boxes
static_assert(BwdSliceRing<false>::STAGES * BwdSliceRing<false>::STAGE >=
                  2 * 4 * BwdSliceRing<false>::A_BOX,
              "the outputs do not fit where they are staged");

// What a backward slice block is given: the owned operands' maps (A1, A2),
// the streamed ones' (B1, B2), the slice stages' (C0 for consumer 0, C1
// for consumer 1) and the outputs' (O0, O1: dq twice, or dk and dv).
struct BwdSliceArgs {
  const CUtensorMap *a1, *a2, *b1, *b2, *c0, *c1, *o0, *o1;
  const int* lens;
  const float* lse;
  const float* di;
  int Tq, Tk, Dp, causal;
  float sm_scale;
};

// In place, this thread's entries of a dkv tile's S^T (sp, replaced by
// P^T = exp(s sm_scale - lse)) and dP^T (dp, replaced by dS^T = P^T (dP^T
// - Di)), f32: keys row[0], row[1], queries q + 8j + 2t and + 1, whose
// lse and Di are lz and dz (in registers, unlike dkv_p_ds); 0 where
// masked (looked at only on an `edge` tile).
template <int N>
__device__ __forceinline__ void dkv_tile(float (&sp)[N / 2],
                                         float (&dp)[N / 2],
                                         const float2 (&lz)[N / 8],
                                         const float2 (&dz)[N / 8],
                                         const int (&row)[2], int q, int t,
                                         float c, bool edge, int length,
                                         int Tq, int causal) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse_c = (e & 1) ? lz[j].y : lz[j].x;
      const float di_c = (e & 1) ? dz[j].y : dz[j].x;
      float p = ex2(fmaf(sp[4 * j + e], c, -lse_c * LOG2E));
      if (edge) {
        const int q_pos = q + 8 * j + 2 * t + (e & 1);
        const int k_pos = row[e >> 1];
        if (k_pos >= length || q_pos >= Tq || (causal && q_pos < k_pos))
          p = 0.f;
      }
      sp[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - di_c);
    }
}

// ... and after the consumers have met, one consumer's whole product.
template <int N>
__device__ __forceinline__ void xch_get(const float4* from, float (&p)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 o = from[j * 128];
    p[4 * j] = o.x;
    p[4 * j + 1] = o.y;
    p[4 * j + 2] = o.z;
    p[4 * j + 3] = o.w;
  }
}

// A backward slice block (BwdSliceRing<ARES>): dq (DKV false) or dk and
// dv (DKV true) at slice z = blockIdx.z, each consumer's output HB boxes.
template <bool ARES, int HB, bool DKV>
__device__ __forceinline__ void bwd_slice(unsigned char* smem,
                                          const BwdSliceArgs& a) {
  using L = BwdSliceRing<ARES>;
  constexpr int NT = L::ROWS;
  constexpr int STAGES = L::STAGES;
  const int NB = a.Dp / 64;
  // the slice's first box of each consumer's streamed operand, and of its
  // output
  const int sb0 = blockIdx.z * (DKV ? DKV_SLICE : DQ_SLICE) / 64;
  const int cb1 = DKV ? sb0 : sb0 + HB;
  unsigned char* ring = smem + L::ring(a.Dp);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::bars(a.Dp));
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;

  // the owned rows from r0 on; the streamed tiles first .. first + n - 1
  const int bh = blockIdx.x;
  const int length = max(0, min(a.lens[bh], a.Tk));
  int r0, first, n_tiles;
  if (DKV) {  // the low keys, which causal queries see most, first
    r0 = blockIdx.y * SPLIT_OWN;
    const int n_q = (a.Tq + NT - 1) / NT;
    // a k tile wholly past the length is seen by no query: dk = dv = 0
    first = r0 >= length ? n_q : (a.causal ? r0 / NT : 0);
    n_tiles = n_q - first;
  } else {  // the heaviest causal q tiles first
    r0 = (gridDim.y - 1 - blockIdx.y) * SPLIT_OWN;
    first = 0;
    n_tiles = (length + NT - 1) / NT;
    if (a.causal)  // the last tile any of the block's rows sees
      n_tiles = min(n_tiles, (min(r0 + SPLIT_OWN, a.Tq) + NT - 1) / NT);
  }

  init_ring<STAGES>(own_full);

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      if (ARES) {
        mbar_expect(own_full, NB * L::A_BOX);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(smem + b * L::A_BOX, a.a1, 64 * b, r0, bh, own_full);
      }
      int u = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int t0 = (first + i) * NT;
        for (int b = 0; b < NB; ++b, ++u) {  // box b of B1, B2, A2 (A1)
          const int s = ring_acquire<STAGES>(full, empty, u, L::STAGE);
          unsigned char* st = ring + s * L::STAGE;
          tma_load_3d(st, a.b1, 64 * b, t0, bh, &full[s]);
          tma_load_3d(st + L::B_BOX, a.b2, 64 * b, t0, bh, &full[s]);
          tma_load_3d(st + 2 * L::B_BOX, a.a2, 64 * b, r0, bh, &full[s]);
          if (!ARES)
            tma_load_3d(st + 2 * L::B_BOX + L::A_BOX, a.a1, 64 * b, r0, bh,
                        &full[s]);
        }
#pragma unroll
        for (int k = 0; k < HB; ++k, ++u) {  // the slice's box k
          const int s = ring_acquire<STAGES>(full, empty, u, 2 * L::B_BOX);
          unsigned char* st = ring + s * L::STAGE;
          tma_load_3d(st, a.c0, 64 * (sb0 + k), t0, bh, &full[s]);
          tma_load_3d(st + L::B_BOX, a.c1, 64 * (cb1 + k), t0, bh,
                      &full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const float c = a.sm_scale * LOG2E;  // s * c is s * sm_scale in base 2
  // dq: p = 2^(s c - lse log2(e)) of this thread's rows; a row past Tq has
  // lse = +inf, so p = 0
  float lse2[2] = {0.f, 0.f}, di_r[2] = {0.f, 0.f};
  if (!DKV)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = row[h] < a.Tq;
      lse2[h] = in ? a.lse[(size_t)bh * a.Tq + row[h]] * LOG2E : INFINITY;
      di_r[h] = in ? a.di[(size_t)bh * a.Tq + row[h]] : 0.f;
    }
  float acc[HB * 32];  // box k of this consumer's output: acc[32 k ..]
#pragma unroll
  for (int e = 0; e < HB * 32; ++e) acc[e] = 0.f;

  if (ARES && n_tiles > 0) mbar_wait(own_full, 0);
  int u = 0;  // the ring's stages taken so far
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = (first + i) * NT;
    // dkv: lse and Di of this thread's columns (0 past Tq, masked there)
    float2 lz[NT / 8], dz[NT / 8];
    if (DKV)
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int q = t0 + 8 * j + 2 * t;
        const size_t at = (size_t)bh * a.Tq + q;
        lz[j].x = q < a.Tq ? a.lse[at] : 0.f;
        lz[j].y = q + 1 < a.Tq ? a.lse[at + 1] : 0.f;
        dz[j].x = q < a.Tq ? a.di[at] : 0.f;
        dz[j].y = q + 1 < a.Tq ? a.di[at + 1] : 0.f;
      }
    float f[NT / 2];  // this consumer's product: S (S^T) or dP (dP^T)
    for (int b = 0; b < NB; ++b, ++u) {
      const int s = u % STAGES;
      mbar_wait(&full[s], (u / STAGES) & 1);
      const unsigned char* st = ring + s * L::STAGE;
      // A1's box resident or in the stage after A2's; A2's in the stage
      const unsigned char* ab =
          cw == 1 ? st + 2 * L::B_BOX
          : ARES  ? smem + b * L::A_BOX
                  : st + 2 * L::B_BOX + L::A_BOX;
      const uint64_t da = sw128_desc(reinterpret_cast<const float*>(ab));
      const uint64_t db =
          sw128_desc(reinterpret_cast<const float*>(st + cw * L::B_BOX));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaBf16<NT, 0>::mma(f, da + 2 * kk, db + 2 * kk, b + kk);
      wgmma_commit();
      if (b > 0) {
        wgmma_wait_one();  // the stage before is read
        release_stage<STAGES>(empty, u - 1, lane);
      }
    }
    wgmma_wait_all();
    fence_regs(f);
    release_stage<STAGES>(empty, u - 1, lane);
    float4* x = reinterpret_cast<float4*>(smem + L::xch(a.Dp) +
                                          (i % 2) * L::XBUF) + tid;
    xch_put<NT / 2>(x + cw * (L::XHALF / 16), f, 0);
    consumers_sync();
    float sx[NT / 2], dx[NT / 2];  // S and dP, then P and dS (transposed)
    xch_get<NT / 2>(x, sx);
    xch_get<NT / 2>(x + L::XHALF / 16, dx);

    uint32_t pa[NT / 16][4];  // bf16(dS), bf16(dS^T) or bf16(P^T)
    if (DKV) {
      const bool edge = r0 + SPLIT_OWN > length || t0 + NT > a.Tq ||
                        (a.causal && t0 < r0 + SPLIT_OWN - 1);
      dkv_tile<NT>(sx, dx, lz, dz, row, t0, t, c, edge, length, a.Tq,
                   a.causal);
      if (cw == 0)
        pack_a<NT>(pa, dx);
      else
        pack_a<NT>(pa, sx);
    } else {
      ds_tile<NT>(sx, dx, lse2, di_r, row, t0, length, a.causal,
                  t0 + NT > length || (a.causal && t0 + NT - 1 > r0), t, c);
      pack_a<NT>(pa, dx);
    }
#pragma unroll
    for (int k = 0; k < HB; ++k, ++u) {  // the output's box k
      const int s = u % STAGES;
      mbar_wait(&full[s], (u / STAGES) & 1);
      const uint64_t dm = sw128_mn_desc(
          ring + s * L::STAGE + cw * L::B_BOX, L::B_BOX);
      float(&ak)[32] = *reinterpret_cast<float(*)[32]>(acc + 32 * k);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk)
        WgmmaBf16Rs<64>::mma(ak, pa[kk], dm + 128 * kk, 1);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait_one();  // the stage before is read
        release_stage<STAGES>(empty, u - 1, lane);
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
    release_stage<STAGES>(empty, u - 1, lane);
    fence_frags(pa);
  }

  // the outputs through offset 0, free once both consumers are done
  consumers_sync();
  unsigned char* ot = smem + cw * HB * L::A_BOX;
  const float sc = DKV && cw == 1 ? 1.f : a.sm_scale;  // dv is not scaled
  const float scale[2] = {sc, sc};
  stage_tile<HB * 64>(ot, L::A_BOX, acc, scale, warp, g, t);
  store_tile<HB * 64>(cw == 0 ? a.o0 : a.o1, ot, L::A_BOX, r0, bh, cw,
                      DKV ? sb0 : sb0 + cw * HB);
}

// dq past D = 512 (Q resident with ARES): block z takes slice z of dq,
// its consumers HB = min(DQ_SLICE, Dp - DQ_SLICE z) / 128 boxes each.
template <bool ARES>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dq_slice_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const __grid_constant__ CUtensorMap domap,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ di,
                                   const __grid_constant__ CUtensorMap dqmap,
                                   const int* __restrict__ lens, int Tq,
                                   int Tk, int Dp, int causal,
                                   float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const BwdSliceArgs a{&qmap, &domap, &kmap, &vmap, &kmap, &kmap, &dqmap,
                       &dqmap, lens, lse, di, Tq, Tk, Dp, causal, sm_scale};
  switch (min(DQ_SLICE, Dp - DQ_SLICE * (int)blockIdx.z) / 128) {
    case 4:
      bwd_slice<ARES, 4, false>(smem, a);
      break;
    case 3:
      bwd_slice<ARES, 3, false>(smem, a);
      break;
    case 2:
      bwd_slice<ARES, 2, false>(smem, a);
      break;
    default:
      bwd_slice<ARES, 1, false>(smem, a);
  }
}

// dk and dv past D = 512 (K resident with ARES): block z takes slice z
// of both, each consumer HB = min(DKV_SLICE, Dp - DKV_SLICE z) / 64 boxes
// of its output (4, or 2 at the end of a Dp that is an odd multiple of
// 128).
template <bool ARES>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dkv_slice_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const __grid_constant__ CUtensorMap domap,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ di,
                                    const __grid_constant__ CUtensorMap dkmap,
                                    const __grid_constant__ CUtensorMap dvmap,
                                    const int* __restrict__ lens, int Tq,
                                    int Tk, int Dp, int causal,
                                    float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const BwdSliceArgs a{&kmap, &vmap, &qmap, &domap, &qmap, &domap, &dkmap,
                       &dvmap, lens, lse, di, Tq, Tk, Dp, causal, sm_scale};
  if (min(DKV_SLICE, Dp - DKV_SLICE * (int)blockIdx.z) == DKV_SLICE)
    bwd_slice<ARES, 4, true>(smem, a);
  else
    bwd_slice<ARES, 2, true>(smem, a);
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap,
                          const int* __restrict__ lens,
                          float* __restrict__ lse, int Tq, int Tk, int causal,
                          float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if constexpr (D > 256)
    fwd_split<D>(smem, &qmap, &kmap, &vmap, &omap, lens, lse, Tq, Tk, causal,
                 sm_scale);
  else
    fwd_rows<D>(smem, &qmap, &kmap, &vmap, &omap, lens, lse, Tq, Tk, causal,
                sm_scale);
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap domap,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             const __grid_constant__ CUtensorMap dqmap,
                             const int* __restrict__ lens, int Tq, int Tk,
                             int causal, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if constexpr (D > 256)
    dq_split<D>(smem, &qmap, &kmap, &vmap, &domap, lse, di, &dqmap, lens, Tq,
                Tk, causal, sm_scale);
  else
    dq_rows<D>(smem, &qmap, &kmap, &vmap, &domap, lse, di, &dqmap, lens, Tq,
               Tk, causal, sm_scale);
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              const __grid_constant__ CUtensorMap dkmap,
                              const __grid_constant__ CUtensorMap dvmap,
                              const int* __restrict__ lens, int Tq, int Tk,
                              int causal, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if constexpr (D > 256) {
    if (blockIdx.z == 0)
      dkv_half<D, true>(smem, &qmap, &kmap, &vmap, &domap, lse, di, &dkmap,
                        &dvmap, lens, Tq, Tk, causal, sm_scale);
    else
      dkv_half<D, false>(smem, &qmap, &kmap, &vmap, &domap, lse, di, &dkmap,
                         &dvmap, lens, Tq, Tk, causal, sm_scale);
  } else {
    dkv_block<D>(smem, &qmap, &kmap, &vmap, &domap, lse, di, &dkmap, &dvmap,
                 lens, Tq, Tk, causal, sm_scale);
  }
}

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v,
                       const int* lens, bf16* o, float* lse, int BH, int Tq,
                       int Tk, int causal, float sm_scale,
                       cudaStream_t stream) {
  using L = std::conditional_t<(D > 256), FwdSplit<D>, FwdRing<D>>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap = {}, kmap = {}, vmap = {}, omap = {};  // Tk = 0: no K/V
  cudaError_t err =
      tensor_map_3d(&qmap, q, BF16, 2, D, Tq, BH, 64, L::ROWS);
  if (err == cudaSuccess)
    err = tensor_map_3d(&omap, o, BF16, 2, D, Tq, BH, 64, 64);
  if (err == cudaSuccess && Tk > 0)
    err = tensor_map_3d(&kmap, k, BF16, 2, D, Tk, BH, 64, L::KEYS);
  if (err == cudaSuccess && Tk > 0)
    err = tensor_map_3d(&vmap, v, BF16, 2, D, Tk, BH, 64, L::KEYS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + L::ROWS - 1) / L::ROWS);
  flash_fwd_bf16_kernel<D><<<grid, WS_THREADS, L::BYTES, stream>>>(
      qmap, kmap, vmap, omap, lens, lse, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// The slice forward at padded head dim Dp (a multiple of 128 past 512):
// Q resident up to SLICE_Q_MAX, streamed past it; one block per (bh, 64 q
// rows, slice of O).
template <bool QRES>
cudaError_t launch_fwd_slice(const bf16* q, const bf16* k, const bf16* v,
                             const int* lens, bf16* o, float* lse, int BH,
                             int Tq, int Tk, int Dp, int causal,
                             float sm_scale, cudaStream_t stream) {
  using L = SliceRing<QRES>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap = {}, kmap = {}, vmap = {}, omap = {};  // Tk = 0: no K/V
  cudaError_t err =
      tensor_map_3d(&qmap, q, BF16, 2, Dp, Tq, BH, 64, SPLIT_OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&omap, o, BF16, 2, Dp, Tq, BH, 64, 64);
  if (err == cudaSuccess && Tk > 0)
    err = tensor_map_3d(&kmap, k, BF16, 2, Dp, Tk, BH, 64, L::KEYS);
  if (err == cudaSuccess && Tk > 0)
    err = tensor_map_3d(&vmap, v, BF16, 2, Dp, Tk, BH, 64, L::KEYS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_slice_bf16_kernel<QRES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::bytes(Dp));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + SPLIT_OWN - 1) / SPLIT_OWN,
                  (Dp + SLICE - 1) / SLICE);
  flash_fwd_slice_bf16_kernel<QRES><<<grid, WS_THREADS, L::bytes(Dp),
                                      stream>>>(
      qmap, kmap, vmap, omap, lens, lse, Tq, Tk, Dp, causal, sm_scale);
  return cudaGetLastError();
}

bool slice_d(int D) { return D > 512 && D % 128 == 0; }

// dq past 512 at padded head dim Dp (a multiple of 128): one block per
// (bh, 64 q rows, slice of dq).
template <bool ARES>
cudaError_t launch_dq_slice(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* dout, const float* lse,
                            const float* di, const int* lens, bf16* dq,
                            int BH, int Tq, int Tk, int Dp, int causal,
                            float sm_scale, cudaStream_t stream) {
  using L = BwdSliceRing<ARES>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap = {}, kmap = {}, vmap = {}, domap = {}, dqmap = {};
  cudaError_t err =
      tensor_map_3d(&qmap, q, BF16, 2, Dp, Tq, BH, 64, SPLIT_OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&domap, dout, BF16, 2, Dp, Tq, BH, 64, SPLIT_OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&dqmap, dq, BF16, 2, Dp, Tq, BH, 64, SPLIT_OWN);
  if (err == cudaSuccess && Tk > 0)  // Tk = 0: no K/V, dq = 0
    err = tensor_map_3d(&kmap, k, BF16, 2, Dp, Tk, BH, 64, L::ROWS);
  if (err == cudaSuccess && Tk > 0)
    err = tensor_map_3d(&vmap, v, BF16, 2, Dp, Tk, BH, 64, L::ROWS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_slice_bf16_kernel<ARES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::bytes(Dp));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + SPLIT_OWN - 1) / SPLIT_OWN,
                  (Dp + DQ_SLICE - 1) / DQ_SLICE);
  flash_bwd_dq_slice_bf16_kernel<ARES><<<grid, WS_THREADS, L::bytes(Dp),
                                        stream>>>(
      qmap, kmap, vmap, domap, lse, di, dqmap, lens, Tq, Tk, Dp, causal,
      sm_scale);
  return cudaGetLastError();
}

// dk and dv past 512: one block per (bh, 64 keys, slice of dk and dv).
template <bool ARES>
cudaError_t launch_dkv_slice(const bf16* q, const bf16* k, const bf16* v,
                             const bf16* dout, const float* lse,
                             const float* di, const int* lens, bf16* dk,
                             bf16* dv, int BH, int Tq, int Tk, int Dp,
                             int causal, float sm_scale,
                             cudaStream_t stream) {
  using L = BwdSliceRing<ARES>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap = {}, kmap = {}, vmap = {}, domap = {};  // Tq = 0: none
  CUtensorMap dkmap = {}, dvmap = {};
  cudaError_t err =
      tensor_map_3d(&kmap, k, BF16, 2, Dp, Tk, BH, 64, SPLIT_OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&vmap, v, BF16, 2, Dp, Tk, BH, 64, SPLIT_OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&dkmap, dk, BF16, 2, Dp, Tk, BH, 64, SPLIT_OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&dvmap, dv, BF16, 2, Dp, Tk, BH, 64, SPLIT_OWN);
  if (err == cudaSuccess && Tq > 0)
    err = tensor_map_3d(&qmap, q, BF16, 2, Dp, Tq, BH, 64, L::ROWS);
  if (err == cudaSuccess && Tq > 0)
    err = tensor_map_3d(&domap, dout, BF16, 2, Dp, Tq, BH, 64, L::ROWS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_slice_bf16_kernel<ARES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::bytes(Dp));
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + SPLIT_OWN - 1) / SPLIT_OWN,
                  (Dp + DKV_SLICE - 1) / DKV_SLICE);
  flash_bwd_dkv_slice_bf16_kernel<ARES><<<grid, WS_THREADS, L::bytes(Dp),
                                         stream>>>(
      qmap, kmap, vmap, domap, lse, di, dkmap, dvmap, lens, Tq, Tk, Dp,
      causal, sm_scale);
  return cudaGetLastError();
}


// A dkv launch at head dim D: keys a block, rows of a Q/dO box, shared
// memory and blocks on the grid's z axis; up to D = 256 DkvRing's, past
// it the dK and dV halves'.
template <int D, bool SPLIT = (D > 256)>
struct DkvGrid {
  static constexpr int KEYS = DkvRing<D>::KEYS;
  static constexpr int Q_ROWS = DKV_QUERIES;
  static constexpr int BYTES = DkvRing<D>::BYTES;
  static constexpr int HALVES = 1;
};
template <int D>
struct DkvGrid<D, true> {
  static constexpr int KEYS = SPLIT_OWN;
  static constexpr int Q_ROWS = HALF_BOX_ROWS;
  static constexpr int BYTES = DkHalf<D>::BYTES > DvHalf<D>::BYTES
                                   ? DkHalf<D>::BYTES
                                   : DvHalf<D>::BYTES;
  static constexpr int HALVES = 2;
};

template <int D>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* dout, const float* lse, const float* di,
                       const int* lens, bf16* dk, bf16* dv, int BH, int Tq,
                       int Tk, int causal, float sm_scale,
                       cudaStream_t stream) {
  using L = DkvGrid<D>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap = {}, kmap = {}, vmap = {}, domap = {};  // Tq = 0: none
  CUtensorMap dkmap = {}, dvmap = {};
  cudaError_t err = tensor_map_3d(&kmap, k, BF16, 2, D, Tk, BH, 64, L::KEYS);
  if (err == cudaSuccess)
    err = tensor_map_3d(&vmap, v, BF16, 2, D, Tk, BH, 64, L::KEYS);
  if (err == cudaSuccess)
    err = tensor_map_3d(&dkmap, dk, BF16, 2, D, Tk, BH, 64, 64);
  if (err == cudaSuccess)
    err = tensor_map_3d(&dvmap, dv, BF16, 2, D, Tk, BH, 64, 64);
  if (err == cudaSuccess && Tq > 0)
    err = tensor_map_3d(&qmap, q, BF16, 2, D, Tq, BH, 64, L::Q_ROWS);
  if (err == cudaSuccess && Tq > 0)
    err = tensor_map_3d(&domap, dout, BF16, 2, D, Tq, BH, 64, L::Q_ROWS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + L::KEYS - 1) / L::KEYS, L::HALVES);
  flash_bwd_dkv_bf16_kernel<D><<<grid, WS_THREADS, L::BYTES, stream>>>(
      qmap, kmap, vmap, domap, lse, di, dkmap, dvmap, lens, Tq, Tk, causal,
      sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* dout, const float* lse, const float* di,
                      const int* lens, bf16* dq, int BH, int Tq, int Tk,
                      int causal, float sm_scale, cudaStream_t stream) {
  using L = std::conditional_t<(D > 256), DqSplit<D>, DqRing<D>>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap = {}, kmap = {}, vmap = {}, domap = {}, dqmap = {};
  cudaError_t err =
      tensor_map_3d(&qmap, q, BF16, 2, D, Tq, BH, 64, L::ROWS);
  if (err == cudaSuccess)
    err = tensor_map_3d(&domap, dout, BF16, 2, D, Tq, BH, 64, L::ROWS);
  if (err == cudaSuccess)
    err = tensor_map_3d(&dqmap, dq, BF16, 2, D, Tq, BH, 64, 64);
  if (err == cudaSuccess && Tk > 0)  // Tk = 0: no K/V, dq = 0
    err = tensor_map_3d(&kmap, k, BF16, 2, D, Tk, BH, 64, L::KEYS);
  if (err == cudaSuccess && Tk > 0)
    err = tensor_map_3d(&vmap, v, BF16, 2, D, Tk, BH, 64, L::KEYS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + L::ROWS - 1) / L::ROWS);
  flash_bwd_dq_bf16_kernel<D><<<grid, WS_THREADS, L::BYTES, stream>>>(
      qmap, kmap, vmap, domap, lse, di, dqmap, lens, Tq, Tk, causal,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). All pointers are device
// pointers to contiguous tensors with 16-byte aligned bases; each returns
// a cudaError_t (0 = launched). D is 64, 128, 192, 256, 384 or 512, or
// past 512 a multiple of 128 (the slice instances of all three).
extern "C" int paddle_flash_attention_fwd_bf16(
    const bf16* q, const bf16* k, const bf16* v, const int* lens, bf16* o,
    float* lse, int BH, int Tq, int Tk, int D, int causal, float sm_scale,
    void* stream) {
  if (BH <= 0 || Tq <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_fwd<64>(q, k, v, lens, o, lse, BH, Tq, Tk, causal,
                               sm_scale, s);
  if (D == 128)
    return (int)launch_fwd<128>(q, k, v, lens, o, lse, BH, Tq, Tk, causal,
                                sm_scale, s);
  if (D == 192)
    return (int)launch_fwd<192>(q, k, v, lens, o, lse, BH, Tq, Tk, causal,
                                sm_scale, s);
  if (D == 256)
    return (int)launch_fwd<256>(q, k, v, lens, o, lse, BH, Tq, Tk, causal,
                                sm_scale, s);
  if (D == 384)
    return (int)launch_fwd<384>(q, k, v, lens, o, lse, BH, Tq, Tk, causal,
                                sm_scale, s);
  if (D == 512)
    return (int)launch_fwd<512>(q, k, v, lens, o, lse, BH, Tq, Tk, causal,
                                sm_scale, s);
  if (slice_d(D))
    return D <= SLICE_Q_MAX
               ? (int)launch_fwd_slice<true>(q, k, v, lens, o, lse, BH, Tq,
                                             Tk, D, causal, sm_scale, s)
               : (int)launch_fwd_slice<false>(q, k, v, lens, o, lse, BH, Tq,
                                              Tk, D, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paddle_flash_attention_bwd_dq_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* di, const int* lens, bf16* dq, int BH,
    int Tq, int Tk, int D, int causal, float sm_scale, void* stream) {
  if (BH <= 0 || Tq <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, di, lens, dq, BH, Tq, Tk,
                              causal, sm_scale, s);
  if (D == 128)
    return (int)launch_dq<128>(q, k, v, dout, lse, di, lens, dq, BH, Tq, Tk,
                               causal, sm_scale, s);
  if (D == 192)
    return (int)launch_dq<192>(q, k, v, dout, lse, di, lens, dq, BH, Tq, Tk,
                               causal, sm_scale, s);
  if (D == 256)
    return (int)launch_dq<256>(q, k, v, dout, lse, di, lens, dq, BH, Tq, Tk,
                               causal, sm_scale, s);
  if (D == 384)
    return (int)launch_dq<384>(q, k, v, dout, lse, di, lens, dq, BH, Tq, Tk,
                               causal, sm_scale, s);
  if (D == 512)
    return (int)launch_dq<512>(q, k, v, dout, lse, di, lens, dq, BH, Tq, Tk,
                               causal, sm_scale, s);
  if (!slice_d(D)) return (int)cudaErrorInvalidValue;
  return D <= BWD_RES_MAX
             ? (int)launch_dq_slice<true>(q, k, v, dout, lse, di, lens, dq, BH,
                                          Tq, Tk, D, causal, sm_scale, s)
             : (int)launch_dq_slice<false>(q, k, v, dout, lse, di, lens, dq,
                                           BH, Tq, Tk, D, causal, sm_scale, s);
}

extern "C" int paddle_flash_attention_bwd_dkv_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* di, const int* lens, bf16* dk, bf16* dv,
    int BH, int Tq, int Tk, int D, int causal, float sm_scale, void* stream) {
  if (BH <= 0 || Tk <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dkv<64>(q, k, v, dout, lse, di, lens, dk, dv, BH, Tq,
                               Tk, causal, sm_scale, s);
  if (D == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, di, lens, dk, dv, BH, Tq,
                                Tk, causal, sm_scale, s);
  if (D == 192)
    return (int)launch_dkv<192>(q, k, v, dout, lse, di, lens, dk, dv, BH, Tq,
                                Tk, causal, sm_scale, s);
  if (D == 256)
    return (int)launch_dkv<256>(q, k, v, dout, lse, di, lens, dk, dv, BH, Tq,
                                Tk, causal, sm_scale, s);
  if (D == 384)
    return (int)launch_dkv<384>(q, k, v, dout, lse, di, lens, dk, dv, BH, Tq,
                                Tk, causal, sm_scale, s);
  if (D == 512)
    return (int)launch_dkv<512>(q, k, v, dout, lse, di, lens, dk, dv, BH, Tq,
                                Tk, causal, sm_scale, s);
  if (!slice_d(D)) return (int)cudaErrorInvalidValue;
  return D <= BWD_RES_MAX
             ? (int)launch_dkv_slice<true>(q, k, v, dout, lse, di, lens, dk,
                                           dv, BH, Tq, Tk, D, causal,
                                           sm_scale, s)
             : (int)launch_dkv_slice<false>(q, k, v, dout, lse, di, lens, dk,
                                            dv, BH, Tq, Tk, D, causal,
                                            sm_scale, s);
}

// Dynamic shared memory of one block of kernel `which` (0 forward, 1 dq,
// 2 dkv) at head dim D, in bytes; -1 for a D the kernels do not take.
extern "C" int paddle_flash_attention_bf16_smem_bytes(int which, int D) {
  const int fwd[4] = {FwdRing<64>::BYTES, FwdRing<128>::BYTES,
                      FwdRing<192>::BYTES, FwdRing<256>::BYTES};
  const int dq[4] = {DqRing<64>::BYTES, DqRing<128>::BYTES,
                     DqRing<192>::BYTES, DqRing<256>::BYTES};
  const int dkv[4] = {DkvRing<64>::BYTES, DkvRing<128>::BYTES,
                      DkvRing<192>::BYTES, DkvRing<256>::BYTES};
  if (D > 0 && D % 64 == 0 && D <= 256)  // wgmma
    return (which == 0 ? fwd : which == 1 ? dq : dkv)[D / 64 - 1];
  if (D == 384 || D == 512)  // wgmma, D split
    return which == 0   ? (D == 384 ? FwdSplit<384>::BYTES
                                    : FwdSplit<512>::BYTES)
           : which == 1 ? (D == 384 ? DqSplit<384>::BYTES
                                    : DqSplit<512>::BYTES)
                        : (D == 384 ? DkvGrid<384>::BYTES
                                    : DkvGrid<512>::BYTES);
  if (!slice_d(D)) return -1;
  if (which == 0)  // the slice instances past 512
    return D <= SLICE_Q_MAX ? SliceRing<true>::bytes(D)
                            : SliceRing<false>::bytes(D);
  return D <= BWD_RES_MAX ? BwdSliceRing<true>::bytes(D)
                          : BwdSliceRing<false>::bytes(D);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
