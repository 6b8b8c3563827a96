// Flash attention in bf16 for Hopper (sm_90a): the forward, dq and dkv
// kernels for bf16 q, k, v (the per-layer transformer under AMP), every
// product on the tensor cores as `mma.sync.m16n8k16` with bf16 operands
// and f32 accumulators.
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
// configuration of the repository reaches them.
//
// Layout on the card. Every kernel is one block of 4 warps per (bh,
// 64-row tile it owns): q rows for the forward and dq, k rows for dkv;
// each warp owns 16 rows, the M of its products. bh is the grid's x axis
// (up to 2^31 - 1), the tiles its y axis, the heaviest causal tiles
// first. The owned tiles stay in shared memory; the other operand pair
// streams through a two-stage cp.async ring (16-byte copies, rows past T
// zero-filled): 64-key K/V tiles in the forward, 32-row tiles in the
// backward (K/V for dq; Q, dO, lse and Di for dkv). Tiles past the row's
// length or wholly above the causal diagonal are never loaded, and a
// warp whose 16 rows a tile cannot reach skips its products: that changes
// no bit of a result. No atomics: each output element is summed by one
// thread in a fixed order, so two launches on the same inputs agree
// bitwise.
//
// What bounds them: at the training shape (B8 H8 T2048 D128, causal) the
// forward does 4*D FLOPs per visible (q, k) pair, dq 6*D and dkv 8*D (69,
// 103 and 137 GFLOP) on ~0.1-0.2 GB: bound by operations, at the tensor
// cores' bf16 rate (989 TFLOP/s). The design is the simple one (a first
// bf16 kernel that is right; `wgmma` and warp specialisation are later
// work), shaped by mma.sync's fragments so that nothing is transposed in
// memory and no intermediate leaves registers:
// - Shared-memory rows are D + 8 bf16 (16 bytes of padding), so the eight
//   16-byte rows an `ldmatrix` reads start 4 banks apart: no conflicts.
// - A operands (the owned rows) come by `ldmatrix.x4`. B operands whose
//   tile rows are the product's N (K in Q K^T, V in dO V^T, Q and dO in
//   K Q^T and V dO^T) come by `ldmatrix.x4` too; those whose tile rows are
//   the reduction (V in P V, K in dS K, dO in P^T dO, Q in dS^T Q) by
//   `ldmatrix.x4.trans`.
// - S (and dP) land in m16n8 f32 accumulators: a row's values sit in one
//   quad of lanes, so its max and sum are the thread's own values and two
//   __shfl_xor. Two neighbouring m16n8 accumulators, rounded to bf16 and
//   packed in pairs, are exactly the A fragment of an m16n8k16 product, so
//   P and dS go from registers to the tensor cores as they are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wide.cuh"
#include "tf32x3.cuh"  // cp.async

namespace {

using bf16 = __nv_bfloat16;

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BM = 16 * NWARPS;  // rows a block owns, 16 a warp
constexpr int BN_FWD = 64;       // keys of a forward K/V tile
constexpr int BN_BWD = 32;       // rows of a backward streamed tile

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

template <int D>
struct FwdSmem {  // bf16 elements: Q, then two stages of K, then of V
  static constexpr int ST = D + 8;
  static constexpr int Q = 0;
  static constexpr int K = Q + BM * ST;
  static constexpr int V = K + 2 * BN_FWD * ST;
  static constexpr int BYTES = (V + 2 * BN_FWD * ST) * 2;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ lens, bf16* __restrict__ o,
                          float* __restrict__ lse, int Tq, int Tk, int causal,
                          float sm_scale) {
  using L = FwdSmem<D>;
  constexpr int ST = L::ST;
  constexpr int NT = BN_FWD / 8;  // 8-column n-tiles across S
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
  int n_tiles = (length + BN_FWD - 1) / BN_FWD;
  if (causal) {
    const int last = min(q0 + BM, Tq);  // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + BN_FWD - 1) / BN_FWD);
  }
  if (n_tiles > 0) {
    load_tile<D, BM>(smem + L::Q, q + qoff, q0, Tq);
    load_tile<D, BN_FWD>(smem + L::K, k + koff, 0, Tk);
    load_tile<D, BN_FWD>(smem + L::V, v + koff, 0, Tk);
    cp_async_commit();
  }

  const int r0 = warp * 16;  // the warp's rows in the q tile
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's rows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) {  // the next tile's copy overlaps this one
      const int nxt = (stage ^ 1) * BN_FWD * ST;
      load_tile<D, BN_FWD>(smem + L::K + nxt, k + koff, (i + 1) * BN_FWD,
                           Tk);
      load_tile<D, BN_FWD>(smem + L::V + nxt, v + koff, (i + 1) * BN_FWD,
                           Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();

    const int k0 = i * BN_FWD;
    const bf16* ks = smem + L::K + stage * BN_FWD * ST;
    const bf16* vs = smem + L::V + stage * BN_FWD * ST;
    // a warp whose rows are past Tq, or wholly above the tile, adds 0
    if (q0 + r0 < Tq && (!causal || k0 <= q0 + r0 + 15)) {
      float s[NT][4];
      product_nk<D, NT>(s, smem + L::Q, ks, r0, lane);  // S = Q K^T
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
          const bool live = k_pos < length && (!causal || row[h] >= k_pos);
          s[j][e] = live ? s[j][e] * sm_scale : -INFINITY;
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
      float m_safe[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // a row masked so far keeps m = -inf; exp sees a finite offset
        m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = m[h] == -INFINITY ? 0.f : expf(m[h] - m_safe[h]);
        m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m_safe[e >> 1]);  // masked: 0
          s[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      accumulate<D, NT>(acc, s, vs, lane);  // O += bf16(P) V
    }
    __syncthreads();  // every warp is done with this stage
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  store_rows<D>(o + qoff, acc, row, Tq, inv, t);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tq)
        lse[(size_t)bh * Tq + row[h]] =
            l[h] > 0.f ? m[h] + logf(fmaxf(l[h], 1e-30f)) : INFINITY;
}

// Shared memory of the backward kernels: the two owned [BM, D] tiles (Q
// and dO for dq, K and V for dkv) and the two streamed tensors' two stages
// of [BN_BWD, D] (K and V for dq, Q and dO for dkv), bf16; then, for dkv,
// two stages of lse and of Di (f32).
template <int D>
struct BwdSmem {
  static constexpr int ST = D + 8;
  static constexpr int OWN0 = 0;
  static constexpr int OWN1 = OWN0 + BM * ST;
  static constexpr int STR0 = OWN1 + BM * ST;
  static constexpr int STR1 = STR0 + 2 * BN_BWD * ST;
  static constexpr int END = STR1 + 2 * BN_BWD * ST;  // bf16 elements
  static constexpr int DQ_BYTES = END * 2;
  static constexpr int DKV_BYTES = END * 2 + 2 * 2 * BN_BWD * 4;
  static_assert(END * 2 % 16 == 0, "the f32 rows must stay aligned");
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
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              const int* __restrict__ lens,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int Tq, int Tk, int causal, float sm_scale) {
  using L = BwdSmem<D>;
  constexpr int ST = L::ST;
  constexpr int NT = BN_BWD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* lse_all = reinterpret_cast<float*>(smem_raw + L::END * 2);
  float* di_all = lse_all + 2 * BN_BWD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // batch*head on grid x, k tiles on y: the low k tiles, which causal
  // queries see most, come first
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  const int n_q_tiles = (Tq + BN_BWD - 1) / BN_BWD;
  // a k tile wholly past the length is seen by no query: dk = dv = 0
  const int first = k0 >= length ? n_q_tiles : (causal ? k0 / BN_BWD : 0);

  // Q, dO, lse and Di of q tile qb into ring stage `stage`
  auto load_q_tile = [&](int qb, int stage) {
    const int qr = qb * BN_BWD;
    load_tile<D, BN_BWD>(smem + L::STR0 + stage * BN_BWD * ST, q + qoff, qr,
                         Tq);
    load_tile<D, BN_BWD>(smem + L::STR1 + stage * BN_BWD * ST, dout + qoff,
                         qr, Tq);
    if (threadIdx.x < 2 * BN_BWD) {
      const int c = threadIdx.x % BN_BWD;
      const bool is_lse = threadIdx.x < BN_BWD;
      const bool in = qr + c < Tq;
      cp_async4((is_lse ? lse_all : di_all) + stage * BN_BWD + c,
                (is_lse ? lse : di) + (size_t)bh * Tq + (in ? qr + c : 0), in);
    }
  };
  if (first < n_q_tiles) {
    load_tile<D, BM>(smem + L::OWN0, k + koff, k0, Tk);
    load_tile<D, BM>(smem + L::OWN1, v + koff, k0, Tk);
    load_q_tile(first, 0);
    cp_async_commit();
  }

  const int r0 = warp * 16;  // the warp's rows in the k tile
  const int row[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qb = first; qb < n_q_tiles; ++qb) {
    const int stage = (qb - first) & 1;
    if (qb + 1 < n_q_tiles) load_q_tile(qb + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int q0 = qb * BN_BWD;
    const bf16* qs = smem + L::STR0 + stage * BN_BWD * ST;
    const bf16* dos = smem + L::STR1 + stage * BN_BWD * ST;
    const float* lse_s = lse_all + stage * BN_BWD;
    const float* di_s = di_all + stage * BN_BWD;
    // a warp whose rows are past the length, or below every query of the
    // tile, adds 0
    if (k0 + r0 < length && (!causal || k0 + r0 < q0 + BN_BWD)) {
      float p[NT][4], ds[NT][4];  // S^T, dP^T, then P^T, dS^T
      product_nk<D, NT>(p, smem + L::OWN0, qs, r0, lane);    // K Q^T
      product_nk<D, NT>(ds, smem + L::OWN1, dos, r0, lane);  // V dO^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          const int q_pos = q0 + c;
          const int k_pos = row[e >> 1];
          const bool live = k_pos < length && q_pos < Tq &&
                            (!causal || q_pos >= k_pos);
          const float pe = live ? expf(p[j][e] * sm_scale - lse_s[c]) : 0.f;
          ds[j][e] = pe * (ds[j][e] - di_s[c]);
          p[j][e] = pe;
        }
      accumulate<D, NT>(dv_acc, p, dos, lane);  // dv += bf16(P^T) dO
      accumulate<D, NT>(dk_acc, ds, qs, lane);  // dk += bf16(dS^T) Q
    }
    __syncthreads();
  }
  const float scale[2] = {sm_scale, sm_scale};
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + koff, dk_acc, row, Tk, scale, t);
  store_rows<D>(dv + koff, dv_acc, row, Tk, one, t);
}

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v,
                       const int* lens, bf16* o, float* lse, int BH, int Tq,
                       int Tk, int causal, float sm_scale,
                       cudaStream_t stream) {
  const int bytes = FwdSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + BM - 1) / BM);
  flash_fwd_bf16_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      q, k, v, lens, o, lse, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
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

template <int D>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* dout, const float* lse, const float* di,
                       const int* lens, bf16* dk, bf16* dv, int BH, int Tq,
                       int Tk, int causal, float sm_scale,
                       cudaStream_t stream) {
  const int bytes = BwdSmem<D>::DKV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + BM - 1) / BM);
  flash_bwd_dkv_bf16_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      q, k, v, dout, lse, di, lens, dk, dv, Tq, Tk, causal, sm_scale);
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
  const int fwd[2] = {FwdSmem<64>::BYTES, FwdSmem<128>::BYTES};
  const int dq[2] = {BwdSmem<64>::DQ_BYTES, BwdSmem<128>::DQ_BYTES};
  const int dkv[2] = {BwdSmem<64>::DKV_BYTES, BwdSmem<128>::DKV_BYTES};
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
