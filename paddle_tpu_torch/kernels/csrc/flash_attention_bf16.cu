// Flash attention in bf16 for Hopper (sm_90a): the forward, dq and dkv
// kernels for bf16 q, k, v (the per-layer transformer under AMP), every
// product on the tensor cores with bf16 operands and f32 accumulators:
// the forward and dkv as `wgmma` fed by TMA, dq as `mma.sync.m16n8k16`.
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
// [BH] int32 -> o, dq [BH, Tq, D], dk, dv [BH, Tk, D] bf16. D is 64 or
// 128: the wrapper zero-pads any other D <= 128 up to one of them. Past
// 128 it pads D to a multiple of 64 and the wide instances run
// (flash_wide.cuh, instantiated for bf16: f32 FMA on the CUDA cores). No
// configuration of the repository reaches them. exp is taken as 2^x of
// x * log2(e) folded into the scale (ex2.approx, relative error ~2^-22,
// far below P's bf16 rounding).
//
// What bounds them: at the training shape (B8 H8 T2048 D128, causal) the
// forward does 4*D FLOPs per visible (q, k) pair, dq 6*D and dkv 8*D (69,
// 103 and 137 GFLOP) on ~0.1-0.2 GB: bound by operations, at the tensor
// cores' bf16 rate (989 TFLOP/s), which only `wgmma` reaches.
//
// The forward and dkv (warp-specialised, one block per (bh, 128 rows it
// owns): q rows for the forward, k rows for dkv):
// - A block is three warpgroups. The first is the producer: it gives its
//   registers up (setmaxnreg 24) and one of its threads issues every TMA
//   copy; the other two (setmaxnreg 240) each own 64 of the block's rows,
//   the M of every `wgmma`. bh is the grid's x axis, the owned tiles its
//   y axis, the heaviest causal tiles first.
// - TMA brings each operand from a 3-D tensor map (D, T, BH) in boxes of
//   64 bf16 values (128 bytes) by the tile's rows in the 128-byte swizzle,
//   so a tile at a head's ragged end lands with zero rows and never reads
//   the next head's; a D = 128 tile is two boxes. Every box starts on a
//   1024-byte boundary. The owned tile (Q; K and V) is loaded once; the
//   streamed pair (K and V: 128-key tiles; Q and dO: 64-query tiles, with
//   their lse and Di copied beside them by the producer warp's cp.async)
//   goes through a ring (three stages in the forward, two in dkv, where a
//   third measured no faster), each stage with a `full` barrier that
//   TMA's complete_tx sets and an `empty` one each consumer warp arrives
//   at. Tiles past the length or wholly above the diagonal are never
//   loaded.
// - Products whose operands both come from shared memory (S = Q K^T;
//   S^T = K Q^T and dP^T = V dO^T in dkv) read both K-major, D being the
//   reduction (sw128_desc). Products whose A is P or dS (O += P V; dV +=
//   P^T dO, dK += dS^T Q) take A from registers: an f32 accumulator's
//   columns 16c .. 16c + 15, rounded and packed in pairs, are the register
//   A of one k16 step (WgmmaBf16Rs), so P and dS never leave registers,
//   and read B MN-major (sw128_mn_desc) from the same boxes that serve as
//   K-major operands: no transposed copy is made.
// - The accumulator has mma's C layout per warp (rows g and g + 8 of its
//   16, each row in one quad of lanes), so a row's max and sum are the
//   thread's own values and two __shfl_xor. Masks are applied only on
//   tiles that cross the diagonal or a length. O is carried across tiles
//   in the wgmma accumulator (O * alpha, then += P V), as the mma.sync
//   design did.
// - dkv keeps the transposed products: K and V are the M side, each
//   streamed Q/dO tile is the N side of S^T and dP^T and the K side (read
//   MN-major) of dV and dK, so every intermediate stays in registers: per
//   consumer thread at D = 128, dK and dV 128 f32, S^T and dP^T 64, their
//   packed bf16 32. lse and Di of a column come from shared memory.
// - Outputs leave through shared memory: each consumer warpgroup writes
//   its [64, D] tile (o; dk and dv), rounded once, into its own rows of
//   the owned tile's boxes, free once its last product has read them, in
//   the swizzle TMA reads, and one of its threads stores the boxes with a
//   TMA store (rows past T are not written). Stores straight from
//   registers, 4 bytes a lane over 8 rows, took 7% of the forward.
// - No atomics: each output element is summed by one thread in a fixed
//   order, so two launches on the same inputs agree bitwise.
// Budget (ptxas, sm_90a): 168 registers a thread at launch (384 threads,
// one block an SM), no spills; the consumers run at 240 after
// setmaxnreg, which acts on whole warpgroups, hence a producer
// warpgroup rather than a warp. Shared memory: the forward 229,432 bytes
// at D = 128 (Q 32 KB, three stages of K and V, 64 KB each) and 114,744
// at D = 64; dkv 132,136 (K and V 64 KB, two stages of Q and dO, 32 KB
// each, and of lse and Di) and 66,600.
//
// dq (the mma.sync design; one block of 4 warps per (bh, 64 q rows)):
// - Q and dO stay in shared memory; K/V stream through a two-stage
//   cp.async ring of 32-row tiles (16-byte copies, rows past T
//   zero-filled) at rows of D + 8 bf16 (16 bytes of padding), so the eight
//   16-byte rows an `ldmatrix` reads start 4 banks apart. A warp owns 16
//   rows; a warp whose rows a tile cannot reach skips its products.
// - A operands come by `ldmatrix.x4`, B operands whose tile rows are the
//   product's N (K in Q K^T, V in dO V^T) too; those whose tile rows are
//   the reduction (K in dS K) by `ldmatrix.x4.trans`. Two neighbouring
//   m16n8 f32 accumulators, rounded to bf16 and packed in pairs, are
//   exactly the A fragment of an m16n8k16 product, so dS goes from
//   registers to the tensor cores as it is.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wide.cuh"
#include "tf32x3.cuh"  // cp.async
#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// --- dq: mma.sync behind a cp.async ring ----------------------------------

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BM = 16 * NWARPS;  // q rows a block owns, 16 a warp
constexpr int BN_BWD = 32;       // rows of a streamed K/V tile

// Rows [row0, row0 + ROWS) of a [T, D] bf16 plane into shared memory at
// row stride D + 8, 16 bytes a cp.async; rows past T are zero-filled.
// Commit the group after.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int T) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * C % NTHREADS == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * C / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int r = idx / C;
    const int c = (idx % C) * 8;
    const bool in = row0 + r < T;
    cp_async16(reinterpret_cast<float*>(dst + r * (D + 8) + c),
               reinterpret_cast<const float*>(
                   src + (in ? (size_t)(row0 + r) * D + c : 0)),
               in);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: a the 16 x 16 bf16 A fragment, (b0, b1) the 16 x 8 B one
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 15 of a tile
// (row stride ST): the four 8 x 8 matrices (rows 0-7, 8-15) x (k 0-7,
// 8-15) in the order a0-a1, a2-a3, a4-a5, a6-a7 hold them.
template <int ST>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int r0, int k0, int lane) {
  ldsm_x4(a, s + (r0 + (lane & 15)) * ST + k0 + (lane >> 4) * 8);
}

// B fragments of two 8-column n-tiles (n0, n0 + 8) for the k16 step k0,
// from a tile whose rows are the product's N and columns its K:
// {b[0], b[1]} for n0, {b[2], b[3]} for n0 + 8.
template <int ST>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* s,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ST + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile whose rows are the product's K and columns its N
// (read transposed).
template <int ST>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* s,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST + n0 +
                   (lane >> 4) * 8);
}

// acc[NT][4] = A(rows r0.., all D) . B(tile rows, all D)^T, zeroed first:
// S = Q K^T, dP = dO V^T and their transposes
template <int D, int NT>
__device__ __forceinline__ void product_nk(float (&acc)[NT][4],
                                           const bf16* a, const bf16* b,
                                           int r0, int lane) {
  constexpr int ST = D + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a<ST>(af, a, r0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      load_b_nk<ST>(bf, b, j * 8, kk * 16, lane);
      mma(acc[j], af, bf[0], bf[1]);
      mma(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// out[D/8][4] += round_bf16(c) . tile, c the f32 [16, 8 NT] accumulators
// of a warp (P or dS), tile the [8 NT, D] rows they multiply (V, K, dO
// or Q), read transposed
template <int D, int NT>
__device__ __forceinline__ void accumulate(float (&out)[D / 8][4],
                                           const float (&c)[NT][4],
                                           const bf16* tile, int lane) {
  constexpr int ST = D + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack(c[2 * kk][0], c[2 * kk][1]),
                           pack(c[2 * kk][2], c[2 * kk][3]),
                           pack(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      load_b_kn<ST>(b, tile, kk * 16, n * 8, lane);
      mma(out[n], a, b[0], b[1]);
      mma(out[n + 1], a, b[2], b[3]);
    }
  }
}

// Rows row[0], row[1] (columns 2t, 2t + 1 of each 8-column n-tile) of a
// [T, D] bf16 output from acc * scale, rounded once; rows past T are not
// written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[D / 8][4],
                                           const int (&row)[2], int T,
                                           const float (&scale)[2], int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= T) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row[h] * D + n * 8 + 2 * t) =
          pack(acc[n][2 * h] * scale[h], acc[n][2 * h + 1] * scale[h]);
  }
}

// Shared memory of dq: the two owned [BM, D] tiles (Q and dO) and the two
// streamed tensors' (K and V) two stages of [BN_BWD, D], bf16.
template <int D>
struct BwdSmem {
  static constexpr int ST = D + 8;
  static constexpr int OWN0 = 0;
  static constexpr int OWN1 = OWN0 + BM * ST;
  static constexpr int STR0 = OWN1 + BM * ST;
  static constexpr int STR1 = STR0 + 2 * BN_BWD * ST;
  static constexpr int END = STR1 + 2 * BN_BWD * ST;  // bf16 elements
  static constexpr int DQ_BYTES = END * 2;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             const int* __restrict__ lens,
                             bf16* __restrict__ dq, int Tq, int Tk,
                             int causal, float sm_scale) {
  using L = BwdSmem<D>;
  constexpr int ST = L::ST;
  constexpr int NT = BN_BWD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + BN_BWD - 1) / BN_BWD;
  if (causal) {
    const int last = min(q0 + BM, Tq);
    n_tiles = min(n_tiles, (last + BN_BWD - 1) / BN_BWD);
  }
  if (n_tiles > 0) {
    load_tile<D, BM>(smem + L::OWN0, q + qoff, q0, Tq);
    load_tile<D, BM>(smem + L::OWN1, dout + qoff, q0, Tq);
    load_tile<D, BN_BWD>(smem + L::STR0, k + koff, 0, Tk);
    load_tile<D, BN_BWD>(smem + L::STR1, v + koff, 0, Tk);
    cp_async_commit();
  }

  const int r0 = warp * 16;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < Tq;
    lse_r[h] = in ? lse[(size_t)bh * Tq + row[h]] : INFINITY;
    di_r[h] = in ? di[(size_t)bh * Tq + row[h]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) {
      const int nxt = (stage ^ 1) * BN_BWD * ST;
      load_tile<D, BN_BWD>(smem + L::STR0 + nxt, k + koff, (i + 1) * BN_BWD,
                           Tk);
      load_tile<D, BN_BWD>(smem + L::STR1 + nxt, v + koff, (i + 1) * BN_BWD,
                           Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int k0 = i * BN_BWD;
    const bf16* ks = smem + L::STR0 + stage * BN_BWD * ST;
    const bf16* vs = smem + L::STR1 + stage * BN_BWD * ST;
    if (q0 + r0 < Tq && (!causal || k0 <= q0 + r0 + 15)) {
      float s[NT][4], dp[NT][4];
      product_nk<D, NT>(s, smem + L::OWN0, ks, r0, lane);   // Q K^T
      product_nk<D, NT>(dp, smem + L::OWN1, vs, r0, lane);  // dO V^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // s becomes dS
          const int h = e >> 1;
          const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
          const bool live = k_pos < length && row[h] < Tq &&
                            (!causal || row[h] >= k_pos);
          const float p = live ? expf(s[j][e] * sm_scale - lse_r[h]) : 0.f;
          s[j][e] = p * (dp[j][e] - di_r[h]);
        }
      accumulate<D, NT>(acc, s, ks, lane);  // dq += bf16(dS) K
    }
    __syncthreads();
  }
  const float scale[2] = {sm_scale, sm_scale};
  store_rows<D>(dq + qoff, acc, row, Tq, scale, t);
}

template <int D>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* dout, const float* lse, const float* di,
                      const int* lens, bf16* dq, int BH, int Tq, int Tk,
                      int causal, float sm_scale, cudaStream_t stream) {
  const int bytes = BwdSmem<D>::DQ_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + BM - 1) / BM);
  flash_bwd_dq_bf16_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      q, k, v, dout, lse, di, lens, dq, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// --- the forward and dkv: wgmma behind a TMA ring ---------------------------

constexpr int WS_THREADS = 384;   // a producer warpgroup, two consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int OWN = 128;          // rows a block owns, 64 a consumer
constexpr int FWD_KEYS = 128;     // keys of a forward K/V tile
constexpr int DKV_QUERIES = 64;   // queries of a dkv Q/dO tile
constexpr int ROW_BYTES = 128;    // a box row: 64 bf16 values
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
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

// The 128 threads of consumer warpgroup w meet (named barrier 1 + w).
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// Warpgroup w's [64, D] output tile, staged by stage_tile at `tile`, to
// rows row0 .. row0 + 63 of head bh: every thread's stores handed to the
// async proxy, the warpgroup met, then one thread stores the D / 64 boxes
// and waits until TMA has read them.
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const unsigned char* tile, int box,
                                           int row0, int bh, int w) {
  fence_proxy_async();
  warpgroup_sync(w);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int b = 0; b < D / 64; ++b)
      tma_store_3d(map, tile + b * box, 64 * b, row0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The descriptor of k16 step kk of a K-major operand whose D is cut into
// 64-column boxes `box` bytes apart: 32 bytes a step inside a box (+2),
// the next box after four.
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int kk, int box) {
  return desc + (uint64_t)((kk / 4) * (box >> 4) + 2 * (kk % 4));
}

// Shared memory of the forward at head dim D, in bytes: Q (OWN rows) as
// NB = D / 64 boxes, then each stage's K and V boxes (FWD_KEYS rows),
// then the barriers (Q's, and each stage's full and empty).
template <int D>
struct FwdRing {
  static constexpr int STAGES = 3;
  static constexpr int NB = D / 64;
  static constexpr int Q_BOX = OWN * ROW_BYTES;
  static constexpr int KV_BOX = FWD_KEYS * ROW_BYTES;
  static constexpr int RING = NB * Q_BOX;       // stage s at RING + s STAGE
  static constexpr int V = NB * KV_BOX;         // V inside a stage
  static constexpr int STAGE = 2 * NB * KV_BOX;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8;
  static_assert(Q_BOX % 1024 == 0 && KV_BOX % 1024 == 0,
                "boxes must keep the swizzle's alignment");
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap,
                          const int* __restrict__ lens,
                          float* __restrict__ lse, int Tq, int Tk, int causal,
                          float sm_scale) {
  using L = FwdRing<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OWN;
  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + FWD_KEYS - 1) / FWD_KEYS;
  if (causal)  // the last tile any of the block's rows sees
    n_tiles = min(n_tiles, (min(q0 + OWN, Tq) + FWD_KEYS - 1) / FWD_KEYS);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect(q_full, L::RING);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
        tma_load_3d(smem + b * L::Q_BOX, &qmap, 64 * b, q0, bh, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::STAGES;
        if (i >= L::STAGES)
          mbar_wait(&empty[s], (i / L::STAGES - 1) & 1);
        unsigned char* st = smem + L::RING + s * L::STAGE;
        mbar_expect(&full[s], L::STAGE);
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          tma_load_3d(st + b * L::KV_BOX, &kmap, 64 * b, i * FWD_KEYS, bh,
                      &full[s]);
          tma_load_3d(st + L::V + b * L::KV_BOX, &vmap, 64 * b, i * FWD_KEYS,
                      bh, &full[s]);
        }
      }
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

    float sc[FWD_KEYS / 2];  // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      WgmmaBf16<FWD_KEYS, 0>::mma(sc, k_step(dq, kk, L::Q_BOX),
                                  k_step(dk, kk, L::KV_BOX), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = i * FWD_KEYS;
    if (k0 + FWD_KEYS > length || (causal && k0 + FWD_KEYS - 1 > r_wg)) {
#pragma unroll
      for (int j = 0; j < FWD_KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
          if (k_pos >= length || (causal && k_pos > row[e >> 1]))
            sc[4 * j + e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < FWD_KEYS / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float alpha[2], mc[2];
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
    for (int e = 0; e < FWD_KEYS / 2; ++e) {
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
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];

    uint32_t pa[FWD_KEYS / 16][4];  // bf16(P), the A of O += P V
    pack_a<FWD_KEYS>(pa, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_KEYS / 16; ++kk)
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
  store_tile<D>(&omap, ot, L::Q_BOX, r_wg, bh, cw);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tq)
        lse[(size_t)bh * Tq + row[h]] =
            l[h] > 0.f ? m[h] * sm_scale + logf(fmaxf(l[h], 1e-30f))
                       : INFINITY;
}

// Shared memory of dkv at head dim D, in bytes: K and V (OWN rows each)
// as NB = D / 64 boxes, then each stage's Q and dO boxes (DKV_QUERIES
// rows), then each stage's lse and Di (f32), then the barriers (K/V's,
// and each stage's full and empty).
template <int D>
struct DkvRing {
  static constexpr int STAGES = 2;
  static constexpr int NB = D / 64;
  static constexpr int KV_BOX = OWN * ROW_BYTES;
  static constexpr int QD_BOX = DKV_QUERIES * ROW_BYTES;
  static constexpr int V = NB * KV_BOX;
  static constexpr int RING = 2 * NB * KV_BOX;  // stage s at RING + s STAGE
  static constexpr int DO = NB * QD_BOX;        // dO inside a stage
  static constexpr int STAGE = 2 * NB * QD_BOX;
  static constexpr int STATS = RING + STAGES * STAGE;
  static constexpr int BARS = STATS + STAGES * 2 * DKV_QUERIES * 4;
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8;
  static_assert(KV_BOX % 1024 == 0 && QD_BOX % 1024 == 0,
                "boxes must keep the swizzle's alignment");
};

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
  using L = DkvRing<D>;
  constexpr int NQ = DKV_QUERIES;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* stats = reinterpret_cast<float*>(smem + L::STATS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::STAGES;

  // batch*head on grid x, k tiles on y: the low k tiles, which causal
  // queries see most, come first
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * OWN;
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
          tma_load_3d(smem + b * L::KV_BOX, &kmap, 64 * b, k0, bh, kv_full);
          tma_load_3d(smem + L::V + b * L::KV_BOX, &vmap, 64 * b, k0, bh,
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
            tma_load_3d(qs + b * L::QD_BOX, &qmap, 64 * b, qb * NQ, bh,
                        &full[s]);
            tma_load_3d(qs + L::DO + b * L::QD_BOX, &domap, 64 * b, qb * NQ,
                        bh, &full[s]);
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int cw = threadIdx.x / 128 - 1;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw = k0 + 64 * cw;  // the warpgroup's first key
  const int row[2] = {kw + 16 * warp + g, kw + 16 * warp + g + 8};
  const float c = sm_scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  if (first < n_q) mbar_wait(kv_full, 0);
  const uint64_t dka = sw128_desc(
      reinterpret_cast<const float*>(smem + cw * 64 * ROW_BYTES));
  const uint64_t dva = sw128_desc(
      reinterpret_cast<const float*>(smem + L::V + cw * 64 * ROW_BYTES));
  for (int qb = first; qb < n_q; ++qb) {
    const int i = qb - first;
    const int s = i % L::STAGES;
    mbar_wait(&full[s], (i / L::STAGES) & 1);
    const int q0 = qb * NQ;
    // keys past the length, or after every query of the tile, add 0
    if (kw < length && (!causal || q0 + NQ - 1 >= kw)) {
      const unsigned char* qs = smem + L::RING + s * L::STAGE;
      const unsigned char* dos = qs + L::DO;
      const float* lse_s = stats + s * 2 * NQ;
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

      const bool edge = kw + 64 > length || q0 + NQ > Tq ||
                        (causal && q0 < kw + 63);
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const float2 lz = *reinterpret_cast<const float2*>(lse_s + 8 * j +
                                                           2 * t);
        const float2 dz = *reinterpret_cast<const float2*>(di_s + 8 * j +
                                                           2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? lz.y : lz.x;
          const float di_c = (e & 1) ? dz.y : dz.x;
          float p = ex2(fmaf(sp[4 * j + e], c, -lse_c * LOG2E));
          if (edge) {
            const int q_pos = q0 + 8 * j + 2 * t + (e & 1);
            const int k_pos = row[e >> 1];
            if (k_pos >= length || q_pos >= Tq || (causal && q_pos < k_pos))
              p = 0.f;
          }
          dp[4 * j + e] = p * (dp[4 * j + e] - di_c);
          sp[4 * j + e] = p;
        }
      }
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
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const float scale[2] = {sm_scale, sm_scale};
  const float one[2] = {1.f, 1.f};
  // dk and dv through this warpgroup's rows of K's and V's boxes
  unsigned char* kt = smem + cw * 64 * ROW_BYTES;
  unsigned char* vt = kt + L::V;
  stage_tile<D>(kt, L::KV_BOX, dk_acc, scale, warp, g, t);
  stage_tile<D>(vt, L::KV_BOX, dv_acc, one, warp, g, t);
  store_tile<D>(&dkmap, kt, L::KV_BOX, kw, bh, cw);
  store_tile<D>(&dvmap, vt, L::KV_BOX, kw, bh, cw);
}

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v,
                       const int* lens, bf16* o, float* lse, int BH, int Tq,
                       int Tk, int causal, float sm_scale,
                       cudaStream_t stream) {
  using L = FwdRing<D>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap = {}, kmap = {}, vmap = {}, omap = {};  // Tk = 0: no K/V
  cudaError_t err = tensor_map_3d(&qmap, q, BF16, 2, D, Tq, BH, 64, OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&omap, o, BF16, 2, D, Tq, BH, 64, 64);
  if (err == cudaSuccess && Tk > 0)
    err = tensor_map_3d(&kmap, k, BF16, 2, D, Tk, BH, 64, FWD_KEYS);
  if (err == cudaSuccess && Tk > 0)
    err = tensor_map_3d(&vmap, v, BF16, 2, D, Tk, BH, 64, FWD_KEYS);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + OWN - 1) / OWN);
  flash_fwd_bf16_kernel<D><<<grid, WS_THREADS, L::BYTES, stream>>>(
      qmap, kmap, vmap, omap, lens, lse, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* dout, const float* lse, const float* di,
                       const int* lens, bf16* dk, bf16* dv, int BH, int Tq,
                       int Tk, int causal, float sm_scale,
                       cudaStream_t stream) {
  using L = DkvRing<D>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap = {}, kmap = {}, vmap = {}, domap = {};  // Tq = 0: none
  CUtensorMap dkmap = {}, dvmap = {};
  cudaError_t err = tensor_map_3d(&kmap, k, BF16, 2, D, Tk, BH, 64, OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&vmap, v, BF16, 2, D, Tk, BH, 64, OWN);
  if (err == cudaSuccess)
    err = tensor_map_3d(&dkmap, dk, BF16, 2, D, Tk, BH, 64, 64);
  if (err == cudaSuccess)
    err = tensor_map_3d(&dvmap, dv, BF16, 2, D, Tk, BH, 64, 64);
  if (err == cudaSuccess && Tq > 0)
    err = tensor_map_3d(&qmap, q, BF16, 2, D, Tq, BH, 64, DKV_QUERIES);
  if (err == cudaSuccess && Tq > 0)
    err = tensor_map_3d(&domap, dout, BF16, 2, D, Tq, BH, 64, DKV_QUERIES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + OWN - 1) / OWN);
  flash_bwd_dkv_bf16_kernel<D><<<grid, WS_THREADS, L::BYTES, stream>>>(
      qmap, kmap, vmap, domap, lse, di, dkmap, dvmap, lens, Tq, Tk, causal,
      sm_scale);
  return cudaGetLastError();
}

bool wide_d(int D) { return D > 128 && D % wide::DC == 0; }

}  // namespace

// Plain C entry points (bound with ctypes). All pointers are device
// pointers to contiguous tensors with 16-byte aligned bases; each returns
// a cudaError_t (0 = launched). D is 64, 128 or a multiple of 64 above 128
// (the wide instances).
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
  if (wide_d(D))
    return (int)launch_fwd_wide<bf16>(q, k, v, lens, o, lse, BH, Tq, Tk, D,
                                      causal, sm_scale, s);
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
  if (wide_d(D))
    return (int)launch_dq_wide<bf16>(q, k, v, dout, lse, di, lens, dq, BH,
                                     Tq, Tk, D, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
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
  if (wide_d(D))
    return (int)launch_dkv_wide<bf16>(q, k, v, dout, lse, di, lens, dk, dv,
                                      BH, Tq, Tk, D, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of kernel `which` (0 forward, 1 dq,
// 2 dkv) at head dim D, in bytes; -1 for a D the kernels do not take.
extern "C" int paddle_flash_attention_bf16_smem_bytes(int which, int D) {
  const int fwd[2] = {FwdRing<64>::BYTES, FwdRing<128>::BYTES};
  const int dq[2] = {BwdSmem<64>::DQ_BYTES, BwdSmem<128>::DQ_BYTES};
  const int dkv[2] = {DkvRing<64>::BYTES, DkvRing<128>::BYTES};
  const int* table = which == 0 ? fwd : which == 1 ? dq : dkv;
  if (D == 64 || D == 128) return table[D == 128];
  if (wide_d(D))
    return which == 0 ? wide::FWD_BYTES
                      : which == 1 ? wide::DQ_BYTES : wide::DKV_BYTES;
  return -1;
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
