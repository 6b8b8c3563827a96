// Flash-attention backward for Hopper (sm_90a), f32-accurate on the
// tensor cores: every product is 3xTF32 `mma.sync.m16n8k8`, fed by
// `cp.async` tile copies.
//
// Replaces the two Pallas TPU kernels of `_flash_backward`
// (paddle_tpu/kernels/flash_attention.py): `_flash_dq_kernel` and
// `_flash_dkv_kernel`. Same functions, with P recomputed from the
// forward's logsumexp instead of a stored [T, T] probability matrix:
//
//   s  = (q . k^T) * sm_scale          masked where k_pos >= len[bh] or,
//                                      when causal, where k_pos > q_pos
//   p  = exp(s - lse)                  0 where masked (lse = +inf on a
//                                      fully masked row gives 0 too)
//   dp = dO . v^T
//   ds = p * (dp - Di)                 Di = rowsum(dO * o), from the caller
//   dq = sm_scale * ds . k             (dq kernel)
//   dv = p^T . dO,  dk = sm_scale * ds^T . q      (dkv kernel)
//
// q, dO [BH, Tq, D]; k, v [BH, Tk, D]; lse, Di [BH, Tq] f32; len [BH]
// int32 -> dq [BH, Tq, D], dk/dv [BH, Tk, D]. D is 64 or 128: the
// wrapper zero-pads any other D <= 128 up to one of them (zero columns
// change no score and give zero gradient columns). Past 128 it pads D to
// a multiple of 64, one in 257-512 to 384 or 512, and one past 512 to a
// multiple of 128 (as for the forward's slice instance): both kernels run
// their split instances at 192 and 256
// (flash_bwd_{dq,dkv}_tf32x3_split_kernel, below: the output split by D
// across the warpgroups, the products over D exchanged between them) and
// their quarter instances at 384 and 512
// (flash_bwd_{dq,dkv}_tf32x3_quarter_kernel: 32 q rows, or 32 keys, a
// block, the output split four ways by D); past those their slice
// instances (flash_bwd_{dq,dkv}_tf32x3_slice_kernel: 16 q rows, or 16
// keys, a block, the output split eight ways by D in slices of up to 1024
// columns on the grid's z axis, any multiple of 128).
// Queries count from position 0 for both Tq and Tk, as in the forward.
//
// Layout on the card, and why it differs from the TPU kernels:
// - dq: one block of 8 warps per (bh, 128-row q tile). Each warp owns 16
//   q rows. Q and dO of the tile stay in shared memory; the block walks
//   32-row K/V tiles up to the causal bound and the row's K length. dkv:
//   one block per (bh, 128-row k tile), each warp owning 16 k rows; K and
//   V stay, and the block walks the 32-row q tiles (Q, dO, lse, Di) from
//   the first one that can see the tile. A warp computes S^T = K Q^T there,
//   so that its k rows are the MMA's M dimension. The TPU walks both loops
//   as a sequential grid axis; here each is a loop inside the block, and
//   the accumulators (dq, or dk and dv) stay in registers. The grid puts
//   bh on x (up to 2^31 - 1) and the tiles on y, heaviest causal tiles
//   first.
// - Tiles past the row's K length, and tiles wholly above the causal
//   diagonal, are never loaded; a warp whose 16 rows a tile cannot reach
//   skips its products. Ragged edges (T not a multiple of the tile) are
//   masked here: rows past T land as zeros and are masked, and no caller
//   pads to 128 lanes the way `_pad_to_lanes` does for Mosaic.
// - No float atomics: each output element is summed by one thread in a
//   fixed order, so two launches on the same inputs agree bitwise.
//
// What bounds it: at the training shape (B8 H8 T2048 D128, causal) dq
// does 6*D FLOPs per visible (q, k) pair and dkv 8*D (103 and 137 GFLOP)
// on ~0.4 GB of inputs and outputs: bound by operations. The card does
// f32-accurate products fastest on its tensor cores as 3xTF32 (495 / 3 =
// 165 TFLOP/s dense, against 67 for f32 FMA on CUDA cores), the scheme of
// CUTLASS's OpMultiplyAddFastF32 and of PyTorch's memory-efficient
// attention in f32. What the design does about it:
// - Products: `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`. Each
//   operand x splits in registers, per fragment, into hi = x rounded to
//   tf32 and lo = x - hi (see split), and each product sums a_lo b_hi +
//   a_hi b_lo + a_hi b_hi in f32, the small terms first. The split is done
//   per fragment rather than once per tile into hi/lo copies in shared
//   memory: the copies would not fit beside the owned tiles at D = 128.
//   Splitting is most of the instructions a product costs, so it takes
//   three full-rate ones (cvt.rna.tf32.f32 compiles to four, with a check
//   for inf and NaN), and the mma.sync rate bounds what is left.
// - The tensor cores' f32 accumulation does not round to nearest, so a
//   product accumulated over all of T in one mma chain drifts (2.5e-5 of
//   |dv| at T = 2048). dq, dk and dv sum each streamed tile's products in
//   fresh registers and add those in f32 (accumulate).
// - Shared-memory rows have stride D + 4 floats (4 mod 32 banks). The A
//   and B fragment reads of m16n8k8 (rows lane>>2, columns lane&3 and +4)
//   then hit 32 distinct banks, and so do the transposed B reads below
//   (rows 2*(lane&3) and +1, column lane>>2): 8*(lane&3) + (lane>>2).
// - P and dS never leave registers. The f32 C fragment holds columns 2t
//   and 2t+1 of each 8-column tile (t = lane&3), the tf32 A fragment
//   columns t and t+4. A product sums over k in any order, so dS (dq) and
//   P^T, dS^T (dkv) become A operands as they are, with k permuted as
//   {0, 2, 4, 6, 1, 3, 5, 7}, and the B rows (K in dS K, dO in P^T dO, Q
//   in dS^T Q) are read in that same order. No shuffle, no shared tile.
// - cp.async (16-byte .cg, zero-filling rows past T) fills a two-stage
//   ring of the streamed tiles; the next tile's copy overlaps this tile's
//   products. lse and Di of a dkv q tile come by 4-byte cp.async, since
//   a row of them need not be 16-byte aligned.
// - Shared memory: 2 x [128, D+4] owned tiles + 2 x 2 x [32, D+4] streamed
//   ones: 198 KB at D = 128, so one block of 8 warps per SM; at D = 64,
//   102 KB: two dq blocks per SM, one dkv block (registers).
// Left for later: `wgmma` (it needs both tf32 operands K-major in shared
// memory: it fits S and dP, not the three accumulating products without
// transposed copies, and its B operand would need hi/lo copies in shared
// memory), warp specialisation with TMA producers, and a persistent grid
// over the causal triangle.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BOWN = 16 * NWARPS;  // rows a block owns: q (dq), k (dkv)
constexpr int BSTREAM = 32;        // rows of each streamed tile
constexpr int NT = BSTREAM / 8;    // 8-column MMA tiles across it

// Shared memory, in floats: the two owned [BOWN, D] tiles (Q and dO for
// dq, K and V for dkv), the two streamed tensors' two stages of
// [BSTREAM, D] (K and V for dq, Q and dO for dkv), then, for dkv only, two
// stages of lse and of Di.
template <int D>
struct Smem {
  static constexpr int ST = D + 4;  // row stride, 4 mod 32 banks
  static constexpr int OWN0 = 0;
  static constexpr int OWN1 = OWN0 + BOWN * ST;
  static constexpr int STR0 = OWN1 + BOWN * ST;
  static constexpr int STR1 = STR0 + 2 * BSTREAM * ST;
  static constexpr int LSE = STR1 + 2 * BSTREAM * ST;
  static constexpr int DI = LSE + 2 * BSTREAM;
  static constexpr int DQ_BYTES = LSE * 4;
  static constexpr int DKV_BYTES = (DI + 2 * BSTREAM) * 4;
};

// Rows [row0, row0 + ROWS) of a [T, D] plane into shared memory at row
// stride D + 4; rows past T are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int T) {
  load_rows<D, Smem<D>::ST, ROWS, NTHREADS>(dst, src, row0, T);
}

// s = A0 B0^T, dp = A1 B1^T over D's 8-column steps kk0 .. kk1 - 1 for a
// warp's 16 rows r0.. of the owned tiles (a0, a1, row stride ST) against
// a streamed tile pair (b0, b1) of 8 NT rows
template <int ST, int NT_>
__device__ __forceinline__ void two_products(float (&s)[NT_][4],
                                             float (&dp)[NT_][4],
                                             const float* a0, const float* a1,
                                             const float* b0, const float* b1,
                                             int r0, int kk0, int kk1, int g,
                                             int t) {
#pragma unroll
  for (int j = 0; j < NT_; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = kk0; kk < kk1; ++kk) {
    const FragA x0 = load_a<ST>(a0, r0, kk * 8, g, t);
    const FragA x1 = load_a<ST>(a1, r0, kk * 8, g, t);
#pragma unroll
    for (int j = 0; j < NT_; ++j) {
      mma3(s[j], x0, load_b_t<ST>(b0, j * 8, kk * 8, g, t));
      mma3(dp[j], x1, load_b_t<ST>(b1, j * 8, kk * 8, g, t));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 2 : 1)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           const int* __restrict__ lens,
                           float* __restrict__ dq, int Tq, int Tk, int causal,
                           float sm_scale) {
  using L = Smem<D>;
  constexpr int ST = L::ST;
  extern __shared__ __align__(16) float smem[];
  const float* qs = smem + L::OWN0;
  const float* dos = smem + L::OWN1;

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  // batch*head on grid x (up to 2^31 - 1), q tiles on y; causal blocks
  // with high q tiles do the most work: schedule them first
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BOWN;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + BSTREAM - 1) / BSTREAM;
  if (causal) {
    const int last = min(q0 + BOWN, Tq);  // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + BSTREAM - 1) / BSTREAM);
  }

  if (n_tiles > 0) {
    load_tile<D, BOWN>(smem + L::OWN0, q + qoff, q0, Tq);
    load_tile<D, BOWN>(smem + L::OWN1, dout + qoff, q0, Tq);
    load_tile<D, BSTREAM>(smem + L::STR0, k + koff, 0, Tk);
    load_tile<D, BSTREAM>(smem + L::STR1, v + koff, 0, Tk);
    cp_async_commit();
  }

  const int r0 = warp * 16;  // the warp's rows in the q tile
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's rows
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
    if (i + 1 < n_tiles) {  // the next tile's copy overlaps this one
      const int nxt = (stage ^ 1) * BSTREAM * ST;
      load_tile<D, BSTREAM>(smem + L::STR0 + nxt, k + koff,
                            (i + 1) * BSTREAM, Tk);
      load_tile<D, BSTREAM>(smem + L::STR1 + nxt, v + koff,
                            (i + 1) * BSTREAM, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the owned tiles) have landed
    __syncthreads();

    const int k0 = i * BSTREAM;
    const float* ks = smem + L::STR0 + stage * BSTREAM * ST;
    const float* vs = smem + L::STR1 + stage * BSTREAM * ST;
    // a warp whose rows are past Tq, or wholly above the tile, adds 0
    if (q0 + r0 < Tq && (!causal || k0 <= q0 + r0 + 15)) {
      float s[NT][4], dp[NT][4];
      two_products<ST>(s, dp, qs, dos, ks, vs, r0, 0, D / 8, g, t);
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
      accumulate<ST>(acc, s, ks, g, t);  // dq += dS K
    }
    __syncthreads();  // every warp is done with this stage
  }

  float* dqp = dq + qoff;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tq)
        *reinterpret_cast<float2*>(dqp + (size_t)row[h] * D + n * 8 + 2 * t) =
            make_float2(acc[n][2 * h] * sm_scale,
                        acc[n][2 * h + 1] * sm_scale);
}

// one block per SM at either D: at D = 64 the dk and dv accumulators,
// the A fragments and the partial sums need more than two blocks' 128
// registers a thread
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            const int* __restrict__ lens,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int Tq, int Tk, int causal, float sm_scale) {
  using L = Smem<D>;
  constexpr int ST = L::ST;
  extern __shared__ __align__(16) float smem[];
  const float* ks = smem + L::OWN0;
  const float* vs = smem + L::OWN1;

  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  // batch*head on grid x, k tiles on y: the low k tiles, which causal
  // queries see most, come first
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BOWN;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  const int n_q_tiles = (Tq + BSTREAM - 1) / BSTREAM;
  // a k tile wholly past the length is seen by no query: dk = dv = 0
  const int first = k0 >= length ? n_q_tiles : (causal ? k0 / BSTREAM : 0);

  // Q, dO, lse and Di of q tile qb into ring stage `stage`
  auto load_q_tile = [&](int qb, int stage) {
    const int q0 = qb * BSTREAM;
    load_tile<D, BSTREAM>(smem + L::STR0 + stage * BSTREAM * ST, q + qoff, q0,
                          Tq);
    load_tile<D, BSTREAM>(smem + L::STR1 + stage * BSTREAM * ST, dout + qoff,
                          q0, Tq);
    if (threadIdx.x < 2 * BSTREAM) {
      const int c = threadIdx.x % BSTREAM;
      const bool is_lse = threadIdx.x < BSTREAM;
      const bool in = q0 + c < Tq;
      cp_async4(smem + (is_lse ? L::LSE : L::DI) + stage * BSTREAM + c,
                (is_lse ? lse : di) + (size_t)bh * Tq + (in ? q0 + c : 0), in);
    }
  };

  if (first < n_q_tiles) {
    load_tile<D, BOWN>(smem + L::OWN0, k + koff, k0, Tk);
    load_tile<D, BOWN>(smem + L::OWN1, v + koff, k0, Tk);
    load_q_tile(first, 0);
    cp_async_commit();
  }

  const int r0 = warp * 16;  // the warp's rows in the k tile
  const int row[2] = {k0 + r0 + g, k0 + r0 + g + 8};  // this thread's rows
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

    const int q0 = qb * BSTREAM;
    const float* qs = smem + L::STR0 + stage * BSTREAM * ST;
    const float* dos = smem + L::STR1 + stage * BSTREAM * ST;
    const float* lse_s = smem + L::LSE + stage * BSTREAM;
    const float* di_s = smem + L::DI + stage * BSTREAM;
    // a warp whose rows are past the length, or below every query of the
    // tile, adds 0
    if (k0 + r0 < length && (!causal || k0 + r0 < q0 + BSTREAM)) {
      float p[NT][4], ds[NT][4];  // S^T, dP^T, then P^T, dS^T
      two_products<ST>(p, ds, ks, vs, qs, dos, r0, 0, D / 8, g, t);
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
      accumulate<ST>(dv_acc, p, dos, g, t);  // dv += P^T dO
      accumulate<ST>(dk_acc, ds, qs, g, t);  // dk += dS^T Q
    }
    __syncthreads();
  }

  float* dkp = dk + koff;
  float* dvp = dv + koff;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tk) {
        const size_t at = (size_t)row[h] * D + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(dkp + at) = make_float2(
            dk_acc[n][2 * h] * sm_scale, dk_acc[n][2 * h + 1] * sm_scale);
        *reinterpret_cast<float2*>(dvp + at) =
            make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* di,
                      const int* lens, float* dq, int BH, int Tq, int Tk,
                      int causal, float sm_scale, cudaStream_t stream) {
  const int smem_bytes = Smem<D>::DQ_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + BOWN - 1) / BOWN);
  flash_bwd_dq_tf32x3_kernel<D><<<grid, NTHREADS, smem_bytes, stream>>>(
      q, k, v, dout, lse, di, lens, dq, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* di,
                       const int* lens, float* dk, float* dv, int BH, int Tq,
                       int Tk, int causal, float sm_scale,
                       cudaStream_t stream) {
  const int smem_bytes = Smem<D>::DKV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + BOWN - 1) / BOWN);
  flash_bwd_dkv_tf32x3_kernel<D><<<grid, NTHREADS, smem_bytes, stream>>>(
      q, k, v, dout, lse, di, lens, dk, dv, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// --- dq at head dims 192 and 256: dq, S and dP split by D ------------------
//
// At D256 the design above needs 128 registers of dq a thread (a warp's
// 16 rows) beside S, dP, the fragments and the fresh sums, and Q and dO
// for 128 rows at stride D + 4 take 266,240 bytes. So a block owns 64 q
// rows and each warpgroup half of D of all 64 rows' dq: warp w's rows
// 16 (w % 4) .., its columns D/2 (w / 4) .. (64 registers at D256). Warp
// w forms S and dP over its half of D and adds warp w ^ 4's partial ones
// (the same rows), exchanged through shared memory: both then hold the
// same bits (a + b == b + a), so P and dS agree. Forming S and dP over
// all of D in both warps instead costs 10 D FLOPs a pair for dq's 6 D and
// ran 1.31x slower on an H100 (PERF.md §6). dS K runs on the warp's
// half of K's columns, each tile's a fresh sum added to dq in f32. Shared
// memory at D256: Q and dO 133,120 bytes + 2 stages x 16-key K and V
// 33,280 + the exchange 16,384 = 216,064 (166,912 at D192).
namespace dsplit {

// rows a block owns, q (dq) or k (dkv): both warpgroups all of them
constexpr int BOWN = 64;
constexpr int BSTREAM = 16;  // rows of a streamed tile: keys (dq), q (dkv)
constexpr int NT = BSTREAM / 8;

// Shared memory, in floats: the two owned [BOWN, D] tiles (Q and dO for
// dq, K and V for dkv), two stages of the streamed pair, the exchange of
// the S and dP partials (S^T, dP^T for dkv), then, for dkv only, two
// stages of lse and of Di.
template <int D>
struct Smem {
  static constexpr int ST = D + 4;
  static constexpr int OWN0 = 0;
  static constexpr int OWN1 = OWN0 + BOWN * ST;
  static constexpr int STR0 = OWN1 + BOWN * ST;
  static constexpr int STR1 = STR0 + 2 * BSTREAM * ST;
  static constexpr int X = STR1 + 2 * BSTREAM * ST;
  static constexpr int LSE = X + NWARPS * 2 * NT * 4 * 32;
  static constexpr int DI = LSE + 2 * BSTREAM;
  static constexpr int DQ_BYTES = LSE * 4;
  static constexpr int DKV_BYTES = (DI + 2 * BSTREAM) * 4;
  static_assert(DKV_BYTES <= 232448, "past a block's shared memory");
};

// The warps' S and dP partials (s, dp) through the exchange x: each
// adds the partial of warp ^ 4, which holds the same rows in the same
// fragment layout, so both end with the same bits (a + b == b + a).
// Every warp of the block calls it: it meets them at a barrier.
__device__ __forceinline__ void exchange(float (&s)[NT][4], float (&dp)[NT][4],
                                         float* x, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[(warp * 2 * NT * 4 + 4 * j + e) * 32 + lane] = s[j][e];
      x[(warp * 2 * NT * 4 + NT * 4 + 4 * j + e) * 32 + lane] = dp[j][e];
    }
  __syncthreads();
  const int p = (warp ^ 4) * 2 * NT * 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] += x[(p + 4 * j + e) * 32 + lane];
      dp[j][e] += x[(p + NT * 4 + 4 * j + e) * 32 + lane];
    }
}

}  // namespace dsplit

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_tf32x3_split_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ di,
                                 const int* __restrict__ lens,
                                 float* __restrict__ dq, int Tq, int Tk,
                                 int causal, float sm_scale) {
  using L = dsplit::Smem<D>;
  constexpr int ST = L::ST, BQ2 = dsplit::BOWN, BK2 = dsplit::BSTREAM;
  constexpr int NT2 = dsplit::NT, HALF = D / 2;
  extern __shared__ __align__(16) float smem[];
  const float* qs = smem + L::OWN0;
  const float* dos = smem + L::OWN1;

  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;  // the warpgroup: dq columns HALF wg ..
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ2;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + BK2 - 1) / BK2;
  if (causal) {
    const int last = min(q0 + BQ2, Tq);  // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + BK2 - 1) / BK2);
  }

  if (n_tiles > 0) {
    load_rows<D, ST, BQ2, NTHREADS>(smem + L::OWN0, q + qoff, q0, Tq);
    load_rows<D, ST, BQ2, NTHREADS>(smem + L::OWN1, dout + qoff, q0, Tq);
    load_rows<D, ST, BK2, NTHREADS>(smem + L::STR0, k + koff, 0, Tk);
    load_rows<D, ST, BK2, NTHREADS>(smem + L::STR1, v + koff, 0, Tk);
    cp_async_commit();
  }

  const int r0 = (warp % 4) * 16;  // the warp's rows in the q tile
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's rows
  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < Tq;
    lse_r[h] = in ? lse[(size_t)bh * Tq + row[h]] : INFINITY;
    di_r[h] = in ? di[(size_t)bh * Tq + row[h]] : 0.f;
  }

  float acc[HALF / 8][4];
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_tiles) {  // the next tile's copy overlaps this one
      const int nxt = (stage ^ 1) * BK2 * ST;
      load_rows<D, ST, BK2, NTHREADS>(smem + L::STR0 + nxt, k + koff,
                                      (i + 1) * BK2, Tk);
      load_rows<D, ST, BK2, NTHREADS>(smem + L::STR1 + nxt, v + koff,
                                      (i + 1) * BK2, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the owned tiles) have landed
    __syncthreads();

    const int k0 = i * BK2;
    const float* ks = smem + L::STR0 + stage * BK2 * ST;
    const float* vs = smem + L::STR1 + stage * BK2 * ST;
    // a warp whose rows are past Tq, or wholly above the tile, adds 0
    const bool live = q0 + r0 < Tq && (!causal || k0 <= q0 + r0 + 15);
    // S and dP over this warpgroup's half of D, the other half's from
    // warp ^ 4 (the same rows and liveness)
    float s[NT2][4], dp[NT2][4];
    two_products<ST>(s, dp, qs, dos, ks, vs, r0, wg * D / 16,
                     live ? (wg + 1) * D / 16 : wg * D / 16, g, t);
    dsplit::exchange(s, dp, smem + L::X, warp, threadIdx.x % 32);
    if (live) {
#pragma unroll
      for (int j = 0; j < NT2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // s becomes dS
          const int h = e >> 1;
          const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
          const bool vis = k_pos < length && row[h] < Tq &&
                           (!causal || row[h] >= k_pos);
          const float p = vis ? expf(s[j][e] * sm_scale - lse_r[h]) : 0.f;
          s[j][e] = p * (dp[j][e] - di_r[h]);
        }
      accumulate<ST>(acc, s, ks + wg * HALF, g, t);  // dq += dS K
    }
    __syncthreads();  // every warp is done with this stage
  }

  float* dqp = dq + qoff + wg * HALF;
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tq)
        *reinterpret_cast<float2*>(dqp + (size_t)row[h] * D + n * 8 + 2 * t) =
            make_float2(acc[n][2 * h] * sm_scale,
                        acc[n][2 * h + 1] * sm_scale);
}

template <int D>
cudaError_t launch_dq_split(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* di, const int* lens, float* dq,
                            int BH, int Tq, int Tk, int causal,
                            float sm_scale, cudaStream_t stream) {
  const int smem_bytes = dsplit::Smem<D>::DQ_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_split_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + dsplit::BOWN - 1) / dsplit::BOWN);
  flash_bwd_dq_tf32x3_split_kernel<D>
      <<<grid, NTHREADS, smem_bytes, stream>>>(
          q, k, v, dout, lse, di, lens, dq, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// --- dkv at head dims 192 and 256: dK, dV, S^T and dP^T split by D --------
//
// The dq split above with the roles of q and k swapped. At D256 the
// D <= 128 design needs 256 registers of dK and dV a thread, and K and V
// for 128 rows take 266,240 bytes. So a block owns 64 keys (K and V at
// stride D + 4: 133,120 bytes at D256) and walks 16-query tiles of Q and
// dO through a two-stage cp.async ring (66,560 bytes, and each stage's
// lse and Di by 4-byte copies, 256) from the first tile that can see its
// keys. Warp w owns keys 16 (w % 4) .. and columns D/2 (w / 4) .. of dK
// and dV: 64 + 64 accumulator registers at D256, the D <= 128 instance's
// budget. It forms S^T = K Q^T and dP^T = V dO^T over its half of D and
// adds warp w ^ 4's partials (the same keys) through the 16,384-byte
// exchange, so both warps hold the same bits and P^T and dS^T agree.
// dV += P^T dO and dK += dS^T Q then run on the warp's half of dO's and
// Q's columns, each tile's a fresh sum added in f32. A warp whose keys
// are past the length or below every query of the tile skips its
// products but still writes zeros to the exchange and meets every
// barrier. Shared memory: 216,320 bytes at D256 (167,168 at D192).
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_tf32x3_split_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ di,
                                  const int* __restrict__ lens,
                                  float* __restrict__ dk,
                                  float* __restrict__ dv, int Tq, int Tk,
                                  int causal, float sm_scale) {
  using L = dsplit::Smem<D>;
  constexpr int ST = L::ST, BK2 = dsplit::BOWN, BQ2 = dsplit::BSTREAM;
  constexpr int NT2 = dsplit::NT, HALF = D / 2;
  extern __shared__ __align__(16) float smem[];
  const float* ks = smem + L::OWN0;
  const float* vs = smem + L::OWN1;

  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;  // the warpgroup: dK, dV columns HALF wg ..
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  // batch*head on grid x, k tiles on y: the low k tiles, which causal
  // queries see most, come first
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK2;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  const int n_q_tiles = (Tq + BQ2 - 1) / BQ2;
  // a k tile wholly past the length is seen by no query: dk = dv = 0
  const int first = k0 >= length ? n_q_tiles : (causal ? k0 / BQ2 : 0);

  // Q, dO, lse and Di of q tile qb into ring stage `stage`
  auto load_q_tile = [&](int qb, int stage) {
    const int q0 = qb * BQ2;
    load_rows<D, ST, BQ2, NTHREADS>(smem + L::STR0 + stage * BQ2 * ST,
                                    q + qoff, q0, Tq);
    load_rows<D, ST, BQ2, NTHREADS>(smem + L::STR1 + stage * BQ2 * ST,
                                    dout + qoff, q0, Tq);
    if (threadIdx.x < 2 * BQ2) {
      const int c = threadIdx.x % BQ2;
      const bool is_lse = threadIdx.x < BQ2;
      const bool in = q0 + c < Tq;
      cp_async4(smem + (is_lse ? L::LSE : L::DI) + stage * BQ2 + c,
                (is_lse ? lse : di) + (size_t)bh * Tq + (in ? q0 + c : 0), in);
    }
  };

  if (first < n_q_tiles) {
    load_rows<D, ST, BK2, NTHREADS>(smem + L::OWN0, k + koff, k0, Tk);
    load_rows<D, ST, BK2, NTHREADS>(smem + L::OWN1, v + koff, k0, Tk);
    load_q_tile(first, 0);
    cp_async_commit();
  }

  const int r0 = (warp % 4) * 16;  // the warp's rows in the k tile
  const int row[2] = {k0 + r0 + g, k0 + r0 + g + 8};  // this thread's rows
  float dk_acc[HALF / 8][4], dv_acc[HALF / 8][4];
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qb = first; qb < n_q_tiles; ++qb) {
    const int stage = (qb - first) & 1;
    if (qb + 1 < n_q_tiles) load_q_tile(qb + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the owned tiles) have landed
    __syncthreads();

    const int q0 = qb * BQ2;
    const float* qs = smem + L::STR0 + stage * BQ2 * ST;
    const float* dos = smem + L::STR1 + stage * BQ2 * ST;
    const float* lse_s = smem + L::LSE + stage * BQ2;
    const float* di_s = smem + L::DI + stage * BQ2;
    // a warp whose rows are past the length, or below every query of the
    // tile, adds 0
    const bool live = k0 + r0 < length && (!causal || k0 + r0 < q0 + BQ2);
    // S^T and dP^T over this warpgroup's half of D, the other half's
    // from warp ^ 4 (the same keys and liveness)
    float p[NT2][4], ds[NT2][4];
    two_products<ST>(p, ds, ks, vs, qs, dos, r0, wg * D / 16,
                     live ? (wg + 1) * D / 16 : wg * D / 16, g, t);
    dsplit::exchange(p, ds, smem + L::X, warp, threadIdx.x % 32);
    if (live) {
#pragma unroll
      for (int j = 0; j < NT2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // S^T, dP^T become P^T, dS^T
          const int c = j * 8 + 2 * t + (e & 1);
          const int q_pos = q0 + c;
          const int k_pos = row[e >> 1];
          const bool vis = k_pos < length && q_pos < Tq &&
                           (!causal || q_pos >= k_pos);
          const float pe = vis ? expf(p[j][e] * sm_scale - lse_s[c]) : 0.f;
          ds[j][e] = pe * (ds[j][e] - di_s[c]);
          p[j][e] = pe;
        }
      accumulate<ST>(dv_acc, p, dos + wg * HALF, g, t);  // dv += P^T dO
      accumulate<ST>(dk_acc, ds, qs + wg * HALF, g, t);  // dk += dS^T Q
    }
    __syncthreads();  // every warp is done with this stage
  }

  float* dkp = dk + koff + wg * HALF;
  float* dvp = dv + koff + wg * HALF;
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tk) {
        const size_t at = (size_t)row[h] * D + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(dkp + at) = make_float2(
            dk_acc[n][2 * h] * sm_scale, dk_acc[n][2 * h + 1] * sm_scale);
        *reinterpret_cast<float2*>(dvp + at) =
            make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
}

template <int D>
cudaError_t launch_dkv_split(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* di, const int* lens, float* dk,
                             float* dv, int BH, int Tq, int Tk, int causal,
                             float sm_scale, cudaStream_t stream) {
  const int smem_bytes = dsplit::Smem<D>::DKV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_split_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + dsplit::BOWN - 1) / dsplit::BOWN);
  flash_bwd_dkv_tf32x3_split_kernel<D>
      <<<grid, NTHREADS, smem_bytes, stream>>>(
          q, k, v, dout, lse, di, lens, dk, dv, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// --- dq at head dims 384 and 512: 32 q rows a block, dq split four ways --
//
// The dq split above does not fit at D512: Q and dO for 64 rows take
// 264,192 bytes, and dq for a warp's 16 rows over half of D 128
// registers a thread. So, as the forward's quarter instance, a block owns
// 32 q rows as two row tiles of 16, and its 8 warps are 2 row tiles x 4
// parts of D: warp w owns rows 16 (w % 2) .. and columns D/4 (w / 2) ..
// of dq (64 registers at D512). Q and dO stay in shared memory (132,096
// bytes at D512), which leaves room for K/V stages of 8 keys. Each warp
// forms S and dP for its rows over its quarter of D; the four partials of
// each meet in the exchange and every warp of the row tile sums them in
// part order, so all four hold the same bits and agree on P and dS. A
// warp reads each k-step's Q and dO fragments and the K and V ones by
// ldmatrix (three instructions for what takes 12 loads), and sums S and
// dP in two accumulators each by k-step parity, so that the dependent
// mma chains are half as long: 1.10x faster together on an H100 (PERF.md
// §6; the forward's S gained nothing from either). dS K then runs on
// the warp's quarter of K's columns, each tile's a fresh sum added to dq
// in f32. Shared memory at D512: Q and dO 132,096 bytes + 2
// stages x 8-key K and V 66,048 + the exchange 8,192 = 206,336 (157,184
// at D384). Holding each warp's dO fragments in registers instead, with
// 16-key stages, took the kernel to 255 registers with spills and ran no
// faster on an H100 (PERF.md §6). Two barriers a tile; the grid as the
// forward's: (bh, 64-row pairs, 2).
namespace qsplit {

// rows a block owns, q (dq) or k (dkv): two row tiles of 16
constexpr int BOWN = 32;
constexpr int RT = BOWN / 16;       // row tiles of 16 rows
constexpr int PARTS = NWARPS / RT;  // parts of D: a warp each per row tile
constexpr int BSTREAM = 8;  // rows of a streamed tile: keys (dq), q (dkv)
constexpr int NT = BSTREAM / 8;
static_assert(NT == 1, "one ldmatrix holds a k-step of both streamed tiles");

// Shared memory, in floats: the two owned [BOWN, D] tiles (Q and dO for
// dq, K and V for dkv) at row stride D + 4, two stages of each streamed
// tile (K and V for dq, Q and dO for dkv), the exchange of the S and dP
// partials (S^T, dP^T for dkv; 2 x NT x 4 values a lane per warp), then,
// for dkv only, two stages of lse and of Di.
template <int D>
struct Smem {
  static constexpr int DP = D / PARTS;  // a warp's columns of D
  static constexpr int ST = D + 4;
  static constexpr int OWN0 = 0;
  static constexpr int OWN1 = OWN0 + BOWN * ST;
  static constexpr int STR0 = OWN1 + BOWN * ST;
  static constexpr int STR1 = STR0 + 2 * BSTREAM * ST;
  static constexpr int X = STR1 + 2 * BSTREAM * ST;
  static constexpr int LSE = X + NWARPS * 2 * NT * 4 * 32;
  static constexpr int DI = LSE + 2 * BSTREAM;
  static constexpr int DQ_BYTES = LSE * 4;
  static constexpr int DKV_BYTES = (DI + 2 * BSTREAM) * 4;
  // accumulate takes n-tiles in groups of 2 (dq) and 4 (dkv)
  static_assert(DP % 32 == 0, "a part's n-tiles must group by 4");
  static_assert(DKV_BYTES <= 232448, "past a block's shared memory");
};

}  // namespace qsplit

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_tf32x3_quarter_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ di,
                                   const int* __restrict__ lens,
                                   float* __restrict__ dq, int Tq, int Tk,
                                   int causal, float sm_scale) {
  using L = qsplit::Smem<D>;
  constexpr int ST = L::ST, DP = L::DP, BQ4 = qsplit::BOWN;
  constexpr int BK4 = qsplit::BSTREAM, NT4 = qsplit::NT;
  constexpr int RT = qsplit::RT, PARTS = qsplit::PARTS;
  constexpr int SLOT = 2 * NT4 * 4;  // a lane's exchange values per warp
  extern __shared__ __align__(16) float smem[];
  const float* qs = smem + L::OWN0;
  const float* dos = smem + L::OWN1;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rt = warp % RT;    // the row tile: rows 16 rt ..
  const int part = warp / RT;  // the part of D: columns DP part ..
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 =
      (gridDim.y - 1 - blockIdx.y) * 2 * BQ4 + (1 - blockIdx.z) * BQ4;
  if (q0 >= Tq) return;  // the upper half of the last pair
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + BK4 - 1) / BK4;
  if (causal) {
    const int last = min(q0 + BQ4, Tq);  // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + BK4 - 1) / BK4);
  }

  auto load_kv = [&](int i) {
    const int s = (i & 1) * BK4 * ST;
    load_rows<D, ST, BK4, NTHREADS>(smem + L::STR0 + s, k + koff, i * BK4, Tk);
    load_rows<D, ST, BK4, NTHREADS>(smem + L::STR1 + s, v + koff, i * BK4, Tk);
  };
  if (n_tiles > 0) {
    load_rows<D, ST, BQ4, NTHREADS>(smem + L::OWN0, q + qoff, q0, Tq);
    load_rows<D, ST, BQ4, NTHREADS>(smem + L::OWN1, dout + qoff, q0, Tq);
    load_kv(0);
    cp_async_commit();
  }

  const int r0 = rt * 16;  // the warp's rows in the q tile
  const int c0 = part * DP;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's rows
  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < Tq;
    lse_r[h] = in ? lse[(size_t)bh * Tq + row[h]] : INFINITY;
    di_r[h] = in ? di[(size_t)bh * Tq + row[h]] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* x = smem + L::X;
  // this lane's ldmatrix rows: of Q's and dO's A fragments (the tiles at
  // rows r0, r0 + 8 and columns 0, 4 of a k-step), and of K's (lanes
  // 0-15) or V's (16-31) B fragment (columns 0, 4 of a k-step)
  const int a_row =
      (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ST + c0 + 4 * (lane >> 4);
  const int b_row = (lane & 7) * ST + c0 + 4 * ((lane >> 3) & 1);

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();  // this thread's copies of tile i have landed
    __syncthreads();     // everyone's, and every warp is done with i - 1
    if (i + 1 < n_tiles) {  // into the stage tile i - 1 used
      load_kv(i + 1);
      cp_async_commit();
    }
    const int k0 = i * BK4;
    const float* ks = smem + L::STR0 + (i & 1) * BK4 * ST;
    const float* vs = smem + L::STR1 + (i & 1) * BK4 * ST;
    // a row tile past Tq, or wholly above the tile, adds 0: all PARTS of
    // its warps skip alike, and no other row tile reads their partials
    const bool live = q0 + r0 < Tq && (!causal || k0 <= q0 + r0 + 15);
    float s[NT4][4], dp[NT4][4];
    if (live) {  // S and dP over this warp's columns, into its slot
      // each in two accumulators by k-step parity, then summed
      float s2[2][4] = {}, dp2[2][4] = {};
      const float* kv_row = (lane >> 4 ? vs : ks) + b_row;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        uint32_t qa[4], oa[4], kv[4];
        ldsm_x4(qa, qs + a_row + kk * 8);
        ldsm_x4(oa, dos + a_row + kk * 8);
        ldsm_x4(kv, kv_row + kk * 8);
        mma3(s2[kk & 1], frag_a(qa), frag_b(kv[0], kv[1]));
        mma3(dp2[kk & 1], frag_a(oa), frag_b(kv[2], kv[3]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[0][e] = s2[0][e] + s2[1][e];
        dp[0][e] = dp2[0][e] + dp2[1][e];
      }
#pragma unroll
      for (int j = 0; j < NT4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[(warp * SLOT + 4 * j + e) * 32 + lane] = s[j][e];
          x[(warp * SLOT + NT4 * 4 + 4 * j + e) * 32 + lane] = dp[j][e];
        }
    }
    __syncthreads();  // every partial is in
    if (!live) continue;
    // S and dP = the row tile's partials summed in part order: the same
    // bits in each of its warps; s becomes dS
#pragma unroll
    for (int j = 0; j < NT4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = x[(rt * SLOT + 4 * j + e) * 32 + lane];
        float dv = x[(rt * SLOT + NT4 * 4 + 4 * j + e) * 32 + lane];
#pragma unroll
        for (int p = 1; p < PARTS; ++p) {
          const int w = p * RT + rt;
          sv += x[(w * SLOT + 4 * j + e) * 32 + lane];
          dv += x[(w * SLOT + NT4 * 4 + 4 * j + e) * 32 + lane];
        }
        const int h = e >> 1;
        const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
        const bool vis = k_pos < length && row[h] < Tq &&
                         (!causal || row[h] >= k_pos);
        const float pe = vis ? expf(sv * sm_scale - lse_r[h]) : 0.f;
        s[j][e] = pe * (dv - di_r[h]);
      }
    accumulate<ST, 2>(acc, s, ks + c0, g, t);  // dq += dS K
  }

  float* dqp = dq + qoff + c0;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tq)
        *reinterpret_cast<float2*>(dqp + (size_t)row[h] * D + n * 8 + 2 * t) =
            make_float2(acc[n][2 * h] * sm_scale,
                        acc[n][2 * h + 1] * sm_scale);
}

template <int D>
cudaError_t launch_dq_quarter(const float* q, const float* k, const float* v,
                              const float* dout, const float* lse,
                              const float* di, const int* lens, float* dq,
                              int BH, int Tq, int Tk, int causal,
                              float sm_scale, cudaStream_t stream) {
  const int smem_bytes = qsplit::Smem<D>::DQ_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_quarter_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + 2 * qsplit::BOWN - 1) / (2 * qsplit::BOWN), 2);
  flash_bwd_dq_tf32x3_quarter_kernel<D>
      <<<grid, NTHREADS, smem_bytes, stream>>>(
          q, k, v, dout, lse, di, lens, dq, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// --- dkv at head dims 384 and 512: 32 keys a block, dK and dV split four
// ways --------------------------------------------------------------------
//
// The dq quarter instance above with the roles of q and k swapped (the
// layout of namespace qsplit, which both take). The dkv split does not
// fit at D512: K and V for 64 keys take 264,192 bytes,
// and dK and dV for a warp's 16 keys over half of D 256 registers a
// thread. So a block owns 32 keys as two key tiles of 16, and its 8 warps
// are 2 key tiles x 4 parts of D: warp w owns keys 16 (w % 2) .. and
// columns D/4 (w / 2) .. of dK and dV (64 + 64 accumulator registers at
// D512, the dkv split's budget at D256). K and V stay in shared memory
// (132,096 bytes at D512), which leaves room for two stages of 8 queries
// of Q and dO (66,048), each stage's lse and Di by 4-byte copies. Each
// warp forms S^T = K Q^T and dP^T = V dO^T for its keys over its quarter
// of D, the fragments by ldmatrix and each product in two accumulators by
// k-step parity, as dq does; the four partials of each meet in the
// exchange (8,192 bytes) and every warp of the key tile sums them in part
// order, so all four hold the same bits and agree on P^T and dS^T. dV +=
// P^T dO and dK += dS^T Q then run on the warp's quarter of dO's and Q's
// columns, each tile's a fresh sum added in f32, 4 n-tiles at a time: 255
// registers at D512 and no spills. A key tile past the length or below
// every query of the tile skips its products; its warps still meet every
// barrier. Shared memory at D512: 206,464 bytes (157,312 at D384). Two
// barriers a tile; the grid (bh, 64-key pairs, 2), the low keys, which
// causal queries see most, first. On an H100 (PERF.md §6) 2 or 1 n-tiles
// at a time ran 1-2% slower; 16 keys a block as 8 parts of D 1.32x
// slower, and dK and dV as two halves, each forming only the products it
// needs (64 accumulators, 5 products where 4 do), 1.44x slower.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_tf32x3_quarter_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ di,
                                    const int* __restrict__ lens,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int Tq, int Tk,
                                    int causal, float sm_scale) {
  using L = qsplit::Smem<D>;
  constexpr int ST = L::ST, DP = L::DP, BK4 = qsplit::BOWN;
  constexpr int BQ4 = qsplit::BSTREAM, NT4 = qsplit::NT;
  constexpr int RT = qsplit::RT, PARTS = qsplit::PARTS;
  constexpr int SLOT = 2 * NT4 * 4;  // a lane's exchange values per warp
  extern __shared__ __align__(16) float smem[];
  const float* ks = smem + L::OWN0;
  const float* vs = smem + L::OWN1;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rt = warp % RT;    // the key tile: keys 16 rt ..
  const int part = warp / RT;  // the part of D: columns DP part ..
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * 2 * BK4 + blockIdx.z * BK4;
  if (k0 >= Tk) return;  // the upper half of the last pair
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  const int n_q_tiles = (Tq + BQ4 - 1) / BQ4;
  // a block wholly past the length is seen by no query: dk = dv = 0
  const int first = k0 >= length ? n_q_tiles : (causal ? k0 / BQ4 : 0);

  // Q, dO, lse and Di of q tile qb into its ring stage
  auto load_q_tile = [&](int qb) {
    const int q0 = qb * BQ4;
    const int s = (qb - first) & 1;
    load_rows<D, ST, BQ4, NTHREADS>(smem + L::STR0 + s * BQ4 * ST,
                                    q + qoff, q0, Tq);
    load_rows<D, ST, BQ4, NTHREADS>(smem + L::STR1 + s * BQ4 * ST,
                                    dout + qoff, q0, Tq);
    if (threadIdx.x < 2 * BQ4) {
      const int c = threadIdx.x % BQ4;
      const bool is_lse = threadIdx.x < BQ4;
      const bool in = q0 + c < Tq;
      cp_async4(smem + (is_lse ? L::LSE : L::DI) + s * BQ4 + c,
                (is_lse ? lse : di) + (size_t)bh * Tq + (in ? q0 + c : 0), in);
    }
  };
  if (first < n_q_tiles) {
    load_rows<D, ST, BK4, NTHREADS>(smem + L::OWN0, k + koff, k0, Tk);
    load_rows<D, ST, BK4, NTHREADS>(smem + L::OWN1, v + koff, k0, Tk);
    load_q_tile(first);
    cp_async_commit();
  }

  const int r0 = rt * 16;  // the warp's keys in the block
  const int c0 = part * DP;
  const int row[2] = {k0 + r0 + g, k0 + r0 + g + 8};  // this thread's keys
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  float* x = smem + L::X;
  // this lane's ldmatrix rows: of K's and V's A fragments (the tiles at
  // rows r0, r0 + 8 and columns 0, 4 of a k-step), and of Q's (lanes
  // 0-15) or dO's (16-31) B fragment (columns 0, 4 of a k-step)
  const int a_row =
      (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ST + c0 + 4 * (lane >> 4);
  const int b_row = (lane & 7) * ST + c0 + 4 * ((lane >> 3) & 1);

  for (int qb = first; qb < n_q_tiles; ++qb) {
    cp_async_wait<0>();  // this thread's copies of tile qb have landed
    __syncthreads();     // everyone's, and every warp is done with qb - 1
    if (qb + 1 < n_q_tiles) {  // into the stage tile qb - 1 used
      load_q_tile(qb + 1);
      cp_async_commit();
    }
    const int s = (qb - first) & 1;
    const int q0 = qb * BQ4;
    const float* qs = smem + L::STR0 + s * BQ4 * ST;
    const float* dos = smem + L::STR1 + s * BQ4 * ST;
    const float* lse_s = smem + L::LSE + s * BQ4;
    const float* di_s = smem + L::DI + s * BQ4;
    // a key tile past the length, or below every query of the tile, adds
    // 0: all PARTS of its warps skip alike, and no other key tile reads
    // their partials
    const bool live = k0 + r0 < length && (!causal || k0 + r0 < q0 + BQ4);
    float p[NT4][4], ds[NT4][4];  // S^T, dP^T, then P^T, dS^T
    if (live) {  // S^T and dP^T over this warp's columns, into its slot
      // each in two accumulators by k-step parity, then summed
      float s2[2][4] = {}, dp2[2][4] = {};
      const float* qo_row = (lane >> 4 ? dos : qs) + b_row;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        uint32_t ka[4], va[4], qo[4];
        ldsm_x4(ka, ks + a_row + kk * 8);
        ldsm_x4(va, vs + a_row + kk * 8);
        ldsm_x4(qo, qo_row + kk * 8);
        mma3(s2[kk & 1], frag_a(ka), frag_b(qo[0], qo[1]));
        mma3(dp2[kk & 1], frag_a(va), frag_b(qo[2], qo[3]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[0][e] = s2[0][e] + s2[1][e];
        ds[0][e] = dp2[0][e] + dp2[1][e];
      }
#pragma unroll
      for (int j = 0; j < NT4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[(warp * SLOT + 4 * j + e) * 32 + lane] = p[j][e];
          x[(warp * SLOT + NT4 * 4 + 4 * j + e) * 32 + lane] = ds[j][e];
        }
    }
    __syncthreads();  // every partial is in
    if (!live) continue;
    // S^T and dP^T = the key tile's partials summed in part order: the
    // same bits in each of its warps; they become P^T and dS^T
#pragma unroll
    for (int j = 0; j < NT4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = x[(rt * SLOT + 4 * j + e) * 32 + lane];
        float dpv = x[(rt * SLOT + NT4 * 4 + 4 * j + e) * 32 + lane];
#pragma unroll
        for (int pp = 1; pp < PARTS; ++pp) {
          const int w = pp * RT + rt;
          sv += x[(w * SLOT + 4 * j + e) * 32 + lane];
          dpv += x[(w * SLOT + NT4 * 4 + 4 * j + e) * 32 + lane];
        }
        const int c = j * 8 + 2 * t + (e & 1);
        const int q_pos = q0 + c;
        const int k_pos = row[e >> 1];
        const bool vis = k_pos < length && q_pos < Tq &&
                         (!causal || q_pos >= k_pos);
        const float pe = vis ? expf(sv * sm_scale - lse_s[c]) : 0.f;
        ds[j][e] = pe * (dpv - di_s[c]);
        p[j][e] = pe;
      }
    accumulate<ST>(dv_acc, p, dos + c0, g, t);  // dv += P^T dO
    accumulate<ST>(dk_acc, ds, qs + c0, g, t);  // dk += dS^T Q
  }

  float* dkp = dk + koff + c0;
  float* dvp = dv + koff + c0;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < Tk) {
        const size_t at = (size_t)row[h] * D + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(dkp + at) = make_float2(
            dk_acc[n][2 * h] * sm_scale, dk_acc[n][2 * h + 1] * sm_scale);
        *reinterpret_cast<float2*>(dvp + at) =
            make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
}

template <int D>
cudaError_t launch_dkv_quarter(const float* q, const float* k,
                               const float* v, const float* dout,
                               const float* lse, const float* di,
                               const int* lens, float* dk, float* dv, int BH,
                               int Tq, int Tk, int causal, float sm_scale,
                               cudaStream_t stream) {
  const int smem_bytes = qsplit::Smem<D>::DKV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_quarter_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + 2 * qsplit::BOWN - 1) / (2 * qsplit::BOWN), 2);
  flash_bwd_dkv_tf32x3_quarter_kernel<D>
      <<<grid, NTHREADS, smem_bytes, stream>>>(
          q, k, v, dout, lse, di, lens, dk, dv, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}


// --- past D = 512: dq, and dK and dV, in slices of D ----------------------
//
// Past D = 512 the quarter layout does not fit: Q and dO for 32 rows take
// 263,168 bytes at Dp = 1024, and a warp's quarter of dq D / 8 registers
// (dK and dV D / 4). The wrapper pads D to a multiple of 128 (Dp), and the
// outputs are cut into slices of up to SLICE columns on the grid's z axis.
// A block owns 16 rows, q rows (dq) or keys (dkv), and its 8 warps are 8
// parts of D: warp w owns columns 16 w .. of every 128 of the slice (dq
// 64 registers at a slice of 1024, dK and dV 128: one slice up to Dp =
// 1024, so nothing is formed twice there). Every block forms S and dP (S^T
// and dP^T in dkv) over all of Dp with the same parts: warp w sums, over
// each 128 columns of Dp in order, the products over its 16 columns of
// them, as two chains (one an 8-column k-step, the fragments by
// ldmatrix), summed after; the eight partials meet in the exchange and
// every warp sums them in part order. So every warp, and every slice,
// holds the same S and dP, P and dS, bit for bit. The owned rows (Q and
// dO; K and V) stay resident at row stride Dp + 4 up to RES_MAX (131,584
// bytes at Dp = 1024); past it each step also brings the owned rows of
// its 128 columns (RES false). The streamed rows come through one ring of
// uniform steps of 16 rows x 128 columns at row stride 132 (the fragment
// reads hit 32 distinct banks), in the order the block takes them, each a
// cp.async group that every thread issues SLOTS - BATCH steps ahead,
// BATCH steps a barrier:
// - dq (flash_bwd_dq_tf32x3_slice_kernel): for each 16-key tile, the K
//   and the V step of each 128 columns of Dp (S and dP), then the K steps
//   of the slice (dq += dS K, each tile's a fresh sum added in f32);
// - dkv (flash_bwd_dkv_tf32x3_slice_kernel): for each tile of 8 queries,
//   the steps of Dp, each Q's and dO's 8 rows (S^T and dP^T), then those
//   of the slice (dV += P^T dO, dK += dS^T Q); lse and Di of the tile's
//   queries come from global memory into registers.
// The slice's steps are copied again, from L2, after Dp's. The ring is
// `Pipe` and the owned rows `load_owned` (mma_tf32x3.cuh), as in the
// forward's slice instance. The loop over Dp's steps runs at run time,
// so any Dp past 512 is taken. Shared memory at Dp = 1024: dq 215,552
// bytes (Q and dO 131,584, eight slots of 8,448, the exchange 16,384),
// dkv 207,360 (K and V, the slots, the exchange 8,192); at Dp = 1152
// 231,936 and 223,744; past it 151,552 and 210,944 (slots of 16,896 with
// Q's or dO's 16 rows, 25,344 with K's and V's). The grid is (bh, 64-row
// groups, 4 x slices): z % 4 picks the group's 16 rows (dq: its upper
// rows first, the heavier under causal masking), so the grid's y axis
// holds as many rows as at 512.
namespace bslice {

constexpr int OWN = 16;    // rows a block owns: q rows (dq), keys (dkv)
constexpr int ROWS = 16;   // rows of a step: keys, or 8 queries of Q and dO
constexpr int CH = 128;    // columns of a step: 16 a part
constexpr int CST = CH + 4;  // a step's row stride, in floats
constexpr int SLICE = 1024;  // columns of the output a block owns at most
constexpr int NVMAX = SLICE / CH;  // steps of a slice
constexpr int SLOTS = 8;   // steps of the ring
constexpr int BATCH = 4;   // steps a barrier
constexpr int GROUP = 4;   // blocks of 16 rows a grid y index holds (on z)
constexpr int RES_MAX = 1152;  // the widest Dp whose owned rows stay resident

// Shared memory, in floats: the ring's slots (a step's 16 streamed rows,
// and with RES false the owned rows of its columns: Q's or dO's 16 for dq,
// K's and V's 16 each for dkv), the exchange of the S and dP partials (2 x
// NT x 4 values a lane per warp), then with RES the two owned tiles [16,
// Dp] at stride Dp + 4.
template <bool DKV, bool RES>
struct Ring {
  static constexpr int NT = DKV ? 1 : 2;  // 8-row MMA tiles a streamed tile
  static constexpr int OWNS = RES ? 0 : (DKV ? 2 : 1) * OWN;
  static constexpr int SLOT = (ROWS + OWNS) * CST;
  static constexpr int X = SLOTS * SLOT;
  static constexpr int OWN0 = X + NWARPS * 2 * NT * 4 * 32;
  __host__ __device__ static constexpr int bytes(int Dp) {
    return (OWN0 + (RES ? 2 * OWN * (Dp + 4) : 0)) * 4;
  }
};
static_assert(Ring<false, true>::bytes(RES_MAX) <= 232448 &&
                  Ring<true, true>::bytes(RES_MAX) <= 232448 &&
                  Ring<false, false>::bytes(0) <= 232448 &&
                  Ring<true, false>::bytes(0) <= 232448,
              "past a block's shared memory");

bool slice_d(int D) { return D > 512 && D % CH == 0; }

// This lane's ldmatrix rows in dkv (ldsm_x4: tiles at rows 0, 8 and
// columns 0, 4 of a k-step): row a_row(), column a_col() of an owned
// tile's A fragment in load_a's order, and the offset b_off() in a step
// of two B fragments in load_b_t's order, from its rows 0-7 (Q: r[0],
// r[1]) and 8-15 (dO: r[2], r[3]). In dq they ran 1.5% slower than
// load_a_at and load_b_t on an H100 (PERF.md §6).
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int a_col(int lane) { return 4 * (lane >> 4); }
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + 8 * (lane >> 4)) * CST + 4 * ((lane >> 3) & 1);
}

// Every warp's S and dP partials (s, dp) through the exchange x, each
// summed over the eight parts in part order: the same bits in every warp
// and every slice. Every warp calls it: it meets them at a barrier.
template <int NTS>
__device__ __forceinline__ void sum_parts(float (&s)[NTS][4],
                                          float (&dp)[NTS][4], float* x,
                                          int warp, int lane) {
  constexpr int SL = 2 * NTS * 4;  // a lane's exchange values per warp
#pragma unroll
  for (int j = 0; j < NTS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[(warp * SL + 4 * j + e) * 32 + lane] = s[j][e];
      x[(warp * SL + NTS * 4 + 4 * j + e) * 32 + lane] = dp[j][e];
    }
  __syncthreads();  // every partial is in
#pragma unroll
  for (int j = 0; j < NTS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv = x[(4 * j + e) * 32 + lane];
      float dv = x[(NTS * 4 + 4 * j + e) * 32 + lane];
#pragma unroll
      for (int p = 1; p < NWARPS; ++p) {
        sv += x[(p * SL + 4 * j + e) * 32 + lane];
        dv += x[(p * SL + NTS * 4 + 4 * j + e) * 32 + lane];
      }
      s[j][e] = sv;
      dp[j][e] = dv;
    }
}

}  // namespace bslice

template <bool RES>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_tf32x3_slice_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ di,
                                 const int* __restrict__ lens,
                                 float* __restrict__ dq, int Tq, int Tk,
                                 int Dp, int causal, float sm_scale) {
  using namespace bslice;
  using L = Ring<false, RES>;
  constexpr int NT5 = L::NT;
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int s0 = blockIdx.z / GROUP * SLICE;  // the slice's first column
  const int nv = min(SLICE, Dp - s0) / CH;    // its steps
  const int q0 = (gridDim.y - 1 - blockIdx.y) * GROUP * OWN +
                 (GROUP - 1 - (int)blockIdx.z % GROUP) * OWN;
  if (q0 >= Tq) return;  // past the last rows
  const size_t qoff = (size_t)bh * Tq * Dp;
  const size_t koff = (size_t)bh * Tk * Dp;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + ROWS - 1) / ROWS;
  if (causal) {
    const int last = min(q0 + OWN, Tq);  // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + ROWS - 1) / ROWS);
  }
  const int NS = Dp / CH;       // steps of Dp
  const int upt = 2 * NS + nv;  // a tile's: K and V of Dp, K of the slice
  const int OST = Dp + 4;       // the owned rows' stride (RES)
  float* own_q = smem + L::OWN0;
  float* own_do = own_q + OWN * OST;

  // step u of the block: tile u / upt's K (r even) or V (r odd) rows of
  // Dp's columns r / 2 (with RES false Q's or dO's rows of them), past 2 NS
  // its K rows of the slice's step r - 2 NS
  auto issue = [&](int u) {
    const int i = u / upt, r = u % upt;
    float* slot = smem + (u % SLOTS) * L::SLOT;
    if (r < 2 * NS) {
      load_step<ROWS, CH, CST, NTHREADS>(slot, (r & 1 ? v : k) + koff,
                                         i * ROWS, Tk, Dp, r / 2 * CH);
      if (!RES)
        load_step<OWN, CH, CST, NTHREADS>(slot + ROWS * CST,
                                          (r & 1 ? dout : q) + qoff, q0, Tq,
                                          Dp, r / 2 * CH);
    } else {
      load_step<ROWS, CH, CST, NTHREADS>(slot, k + koff, i * ROWS, Tk, Dp,
                                         s0 + (r - 2 * NS) * CH);
    }
  };
  const Pipe<SLOTS, BATCH, decltype(issue)> pipe{issue, n_tiles * upt};
  if (RES && n_tiles > 0) {  // Q and dO, in the first group
    load_owned<OWN, NTHREADS>(own_q, q + qoff, q0, Tq, Dp);
    load_owned<OWN, NTHREADS>(own_do, dout + qoff, q0, Tq, Dp);
  }
  pipe.start();

  const int row[2] = {q0 + g, q0 + g + 8};  // this thread's rows
  float lse_r[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < Tq;
    lse_r[h] = in ? lse[(size_t)bh * Tq + row[h]] : INFINITY;
    di_r[h] = in ? di[(size_t)bh * Tq + row[h]] : 0.f;
  }
  float acc[2 * NVMAX][4];  // the slice's step kv: acc[2 kv], acc[2 kv + 1]
#pragma unroll
  for (int n = 0; n < 2 * NVMAX; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int c0 = warp * 16;  // the warp's columns of each step

  int u = 0;  // the block's next step
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * ROWS;
    // S and dP over this warp's columns, each as two chains (one a k-step
    // of its 16 columns of a step), summed after
    float s2[2][NT5][4], dp2[2][NT5][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < NT5; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s2[c][j][e] = dp2[c][j][e] = 0.f;
    for (int j = 0; j < NS; j += BATCH / 2) {  // K and V steps in pairs
      const int b = min(BATCH, 2 * (NS - j));
      pipe.take(u, b);
#pragma unroll
      for (int h = 0; h < BATCH / 2; ++h) {
        if (2 * h >= b) continue;
        const float* ks = smem + ((u + 2 * h) % SLOTS) * L::SLOT;
        const float* vs = smem + ((u + 2 * h + 1) % SLOTS) * L::SLOT;
        const float* qs = RES ? own_q + (j + h) * CH : ks + ROWS * CST;
        const float* dos = RES ? own_do + (j + h) * CH : vs + ROWS * CST;
        const int ost = RES ? OST : CST;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const FragA qa = load_a_at(qs, ost, 0, c0 + kk * 8, g, t);
          const FragA oa = load_a_at(dos, ost, 0, c0 + kk * 8, g, t);
#pragma unroll
          for (int jn = 0; jn < NT5; ++jn) {
            mma3(s2[kk][jn], qa,
                 load_b_t<CST>(ks, jn * 8, c0 + kk * 8, g, t));
            mma3(dp2[kk][jn], oa,
                 load_b_t<CST>(vs, jn * 8, c0 + kk * 8, g, t));
          }
        }
      }
      u += b;
    }
    float s[NT5][4], dp[NT5][4];
#pragma unroll
    for (int j = 0; j < NT5; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s2[0][j][e] + s2[1][j][e];
        dp[j][e] = dp2[0][j][e] + dp2[1][j][e];
      }
    sum_parts(s, dp, smem + L::X, warp, lane);
#pragma unroll
    for (int j = 0; j < NT5; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // s becomes dS
        const int h = e >> 1;
        const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
        const bool vis = k_pos < length && row[h] < Tq &&
                         (!causal || row[h] >= k_pos);
        const float p = vis ? expf(s[j][e] * sm_scale - lse_r[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - di_r[h]);
      }
#pragma unroll
    for (int kv = 0; kv < NVMAX; kv += BATCH) {  // dq += dS K, step by step
      if (kv < nv) {
        const int b = min(BATCH, nv - kv);
        pipe.take(u, b);
#pragma unroll
        for (int h = 0; h < BATCH; ++h)
          if (h < b)
            accumulate<CST, 2>(
                *reinterpret_cast<float(*)[2][4]>(acc[2 * (kv + h)]), s,
                smem + ((u + h) % SLOTS) * L::SLOT + c0, g, t);
        u += b;
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  float* dqp = dq + qoff + s0 + c0;
#pragma unroll
  for (int n = 0; n < 2 * NVMAX; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (n / 2 < nv && row[h] < Tq)
        *reinterpret_cast<float2*>(dqp + (size_t)row[h] * Dp + (n / 2) * CH +
                                   (n % 2) * 8 + 2 * t) =
            make_float2(acc[n][2 * h] * sm_scale,
                        acc[n][2 * h + 1] * sm_scale);
}

template <bool RES>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_tf32x3_slice_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ di,
                                  const int* __restrict__ lens,
                                  float* __restrict__ dk,
                                  float* __restrict__ dv, int Tq, int Tk,
                                  int Dp, int causal, float sm_scale) {
  using namespace bslice;
  using L = Ring<true, RES>;
  constexpr int BQ5 = ROWS / 2;  // queries a tile
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int s0 = blockIdx.z / GROUP * SLICE;  // the slice's first column
  const int nv = min(SLICE, Dp - s0) / CH;    // its steps
  // the low keys, which causal queries see most, first
  const int k0 = blockIdx.y * GROUP * OWN + (int)blockIdx.z % GROUP * OWN;
  if (k0 >= Tk) return;  // past the last keys
  const size_t qoff = (size_t)bh * Tq * Dp;
  const size_t koff = (size_t)bh * Tk * Dp;

  const int length = max(0, min(lens[bh], Tk));
  const int n_q_tiles = (Tq + BQ5 - 1) / BQ5;
  // a block wholly past the length is seen by no query: dk = dv = 0
  const int first = k0 >= length ? n_q_tiles : (causal ? k0 / BQ5 : 0);
  const int NS = Dp / CH;   // steps of Dp
  const int upt = NS + nv;  // a tile's: Q and dO of Dp, of the slice
  const int OST = Dp + 4;   // the owned rows' stride (RES)
  float* own_k = smem + L::OWN0;
  float* own_v = own_k + OWN * OST;

  // step u of the block: Q's and dO's rows of q tile first + u / upt at
  // Dp's columns r (r < NS; with RES false K's and V's rows of them too)
  // or at the slice's step r - NS
  auto issue = [&](int u) {
    const int qb = first + u / upt, r = u % upt;
    float* slot = smem + (u % SLOTS) * L::SLOT;
    const int c = r < NS ? r * CH : s0 + (r - NS) * CH;
    load_step<BQ5, CH, CST, NTHREADS>(slot, q + qoff, qb * BQ5, Tq, Dp, c);
    load_step<BQ5, CH, CST, NTHREADS>(slot + BQ5 * CST, dout + qoff,
                                      qb * BQ5, Tq, Dp, c);
    if (!RES && r < NS) {
      load_step<OWN, CH, CST, NTHREADS>(slot + ROWS * CST, k + koff, k0, Tk,
                                        Dp, c);
      load_step<OWN, CH, CST, NTHREADS>(slot + (ROWS + OWN) * CST, v + koff,
                                        k0, Tk, Dp, c);
    }
  };
  const Pipe<SLOTS, BATCH, decltype(issue)> pipe{issue,
                                                 (n_q_tiles - first) * upt};
  if (RES && first < n_q_tiles) {  // K and V, in the first group
    load_owned<OWN, NTHREADS>(own_k, k + koff, k0, Tk, Dp);
    load_owned<OWN, NTHREADS>(own_v, v + koff, k0, Tk, Dp);
  }
  pipe.start();

  const int row[2] = {k0 + g, k0 + g + 8};  // this thread's keys
  float dk_acc[2 * NVMAX][4], dv_acc[2 * NVMAX][4];
#pragma unroll
  for (int n = 0; n < 2 * NVMAX; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const int c0 = warp * 16;  // the warp's columns of each step
  const int a_off = a_row(lane) * (RES ? OST : CST) + a_col(lane) + c0;
  const int bo = b_off(lane) + c0;

  int u = 0;
  for (int qb = first; qb < n_q_tiles; ++qb) {
    const int q0 = qb * BQ5;
    // lse and Di of this thread's queries (columns 2t, 2t + 1 of the
    // tile), read while S^T forms
    float lse_c[2], di_c[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q_pos = q0 + 2 * t + e;
      const bool in = q_pos < Tq;
      lse_c[e] = in ? lse[(size_t)bh * Tq + q_pos] : INFINITY;
      di_c[e] = in ? di[(size_t)bh * Tq + q_pos] : 0.f;
    }
    // S^T and dP^T over this warp's columns, each as two chains
    float s2[2][4] = {}, dp2[2][4] = {};
    for (int j = 0; j < NS; j += BATCH) {
      const int b = min(BATCH, NS - j);
      pipe.take(u, b);
#pragma unroll
      for (int h = 0; h < BATCH; ++h) {
        if (h >= b) continue;
        const float* slot = smem + ((u + h) % SLOTS) * L::SLOT;
        const float* ks = RES ? own_k + (j + h) * CH : slot + ROWS * CST;
        const float* vs = RES ? own_v + (j + h) * CH : ks + OWN * CST;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ka[4], va[4], qo[4];
          ldsm_x4(ka, ks + a_off + kk * 8);
          ldsm_x4(va, vs + a_off + kk * 8);
          ldsm_x4(qo, slot + bo + kk * 8);  // Q's rows, then dO's
          mma3(s2[kk], frag_a(ka), frag_b(qo[0], qo[1]));
          mma3(dp2[kk], frag_a(va), frag_b(qo[2], qo[3]));
        }
      }
      u += b;
    }
    float p[1][4], ds[1][4];  // S^T, dP^T, then P^T, dS^T
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[0][e] = s2[0][e] + s2[1][e];
      ds[0][e] = dp2[0][e] + dp2[1][e];
    }
    sum_parts(p, ds, smem + L::X, warp, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q_pos = q0 + 2 * t + (e & 1);
      const int k_pos = row[e >> 1];
      const bool vis = k_pos < length && q_pos < Tq &&
                       (!causal || q_pos >= k_pos);
      const float pe = vis ? expf(p[0][e] * sm_scale - lse_c[e & 1]) : 0.f;
      ds[0][e] = pe * (ds[0][e] - di_c[e & 1]);
      p[0][e] = pe;
    }
#pragma unroll
    for (int kv = 0; kv < NVMAX; kv += BATCH) {  // the slice, step by step
      if (kv < nv) {
        const int b = min(BATCH, nv - kv);
        pipe.take(u, b);
#pragma unroll
        for (int h = 0; h < BATCH; ++h)
          if (h < b) {
            const float* slot = smem + ((u + h) % SLOTS) * L::SLOT + c0;
            accumulate<CST, 2>(  // dv += P^T dO
                *reinterpret_cast<float(*)[2][4]>(dv_acc[2 * (kv + h)]), p,
                slot + BQ5 * CST, g, t);
            accumulate<CST, 2>(  // dk += dS^T Q
                *reinterpret_cast<float(*)[2][4]>(dk_acc[2 * (kv + h)]), ds,
                slot, g, t);
          }
        u += b;
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  float* dkp = dk + koff + s0 + c0;
  float* dvp = dv + koff + s0 + c0;
#pragma unroll
  for (int n = 0; n < 2 * NVMAX; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (n / 2 < nv && row[h] < Tk) {
        const size_t at =
            (size_t)row[h] * Dp + (n / 2) * CH + (n % 2) * 8 + 2 * t;
        *reinterpret_cast<float2*>(dkp + at) = make_float2(
            dk_acc[n][2 * h] * sm_scale, dk_acc[n][2 * h + 1] * sm_scale);
        *reinterpret_cast<float2*>(dvp + at) =
            make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
}

template <bool RES>
cudaError_t launch_dq_slice(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* di, const int* lens, float* dq,
                            int BH, int Tq, int Tk, int Dp, int causal,
                            float sm_scale, cudaStream_t stream) {
  using namespace bslice;
  const int smem_bytes = Ring<false, RES>::bytes(Dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_slice_kernel<RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + GROUP * OWN - 1) / (GROUP * OWN),
                  GROUP * ((Dp + SLICE - 1) / SLICE));
  flash_bwd_dq_tf32x3_slice_kernel<RES>
      <<<grid, NTHREADS, smem_bytes, stream>>>(
          q, k, v, dout, lse, di, lens, dq, Tq, Tk, Dp, causal, sm_scale);
  return cudaGetLastError();
}

template <bool RES>
cudaError_t launch_dkv_slice(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* di, const int* lens, float* dk,
                             float* dv, int BH, int Tq, int Tk, int Dp,
                             int causal, float sm_scale,
                             cudaStream_t stream) {
  using namespace bslice;
  const int smem_bytes = Ring<true, RES>::bytes(Dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_slice_kernel<RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + GROUP * OWN - 1) / (GROUP * OWN),
                  GROUP * ((Dp + SLICE - 1) / SLICE));
  flash_bwd_dkv_tf32x3_slice_kernel<RES>
      <<<grid, NTHREADS, smem_bytes, stream>>>(
          q, k, v, dout, lse, di, lens, dk, dv, Tq, Tk, Dp, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). All pointers are device
// pointers to contiguous tensors with 16-byte aligned bases; each returns
// a cudaError_t (0 = launched). D is 64, 128, 192, 256, 384, 512 (the
// split instances at 192 and 256, the quarter instances at 384 and 512) or
// a multiple of 128 above 512 (the slice instances).
extern "C" int paddle_flash_attention_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* di, const int* lens, float* dq, int BH,
    int Tq, int Tk, int D, int causal, float sm_scale, void* stream) {
  if (BH <= 0 || Tq <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_dq<64>(q, k, v, dout, lse, di, lens, dq, BH, Tq, Tk,
                                causal, sm_scale, s);
    case 128:
      return (int)launch_dq<128>(q, k, v, dout, lse, di, lens, dq, BH, Tq, Tk,
                                 causal, sm_scale, s);
    case 192:
      return (int)launch_dq_split<192>(q, k, v, dout, lse, di, lens, dq, BH,
                                       Tq, Tk, causal, sm_scale, s);
    case 256:
      return (int)launch_dq_split<256>(q, k, v, dout, lse, di, lens, dq, BH,
                                       Tq, Tk, causal, sm_scale, s);
    case 384:
      return (int)launch_dq_quarter<384>(q, k, v, dout, lse, di, lens, dq,
                                         BH, Tq, Tk, causal, sm_scale, s);
    case 512:
      return (int)launch_dq_quarter<512>(q, k, v, dout, lse, di, lens, dq,
                                         BH, Tq, Tk, causal, sm_scale, s);
    default:
      if (!bslice::slice_d(D)) return (int)cudaErrorInvalidValue;
      return D <= bslice::RES_MAX
                 ? (int)launch_dq_slice<true>(q, k, v, dout, lse, di, lens, dq,
                                              BH, Tq, Tk, D, causal, sm_scale,
                                              s)
                 : (int)launch_dq_slice<false>(q, k, v, dout, lse, di, lens,
                                               dq, BH, Tq, Tk, D, causal,
                                               sm_scale, s);
  }
}

extern "C" int paddle_flash_attention_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* di, const int* lens, float* dk, float* dv,
    int BH, int Tq, int Tk, int D, int causal, float sm_scale, void* stream) {
  if (BH <= 0 || Tk <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_dkv<64>(q, k, v, dout, lse, di, lens, dk, dv, BH, Tq,
                                 Tk, causal, sm_scale, s);
    case 128:
      return (int)launch_dkv<128>(q, k, v, dout, lse, di, lens, dk, dv, BH,
                                  Tq, Tk, causal, sm_scale, s);
    case 192:
      return (int)launch_dkv_split<192>(q, k, v, dout, lse, di, lens, dk, dv,
                                        BH, Tq, Tk, causal, sm_scale, s);
    case 256:
      return (int)launch_dkv_split<256>(q, k, v, dout, lse, di, lens, dk, dv,
                                        BH, Tq, Tk, causal, sm_scale, s);
    case 384:
      return (int)launch_dkv_quarter<384>(q, k, v, dout, lse, di, lens, dk,
                                          dv, BH, Tq, Tk, causal, sm_scale, s);
    case 512:
      return (int)launch_dkv_quarter<512>(q, k, v, dout, lse, di, lens, dk,
                                          dv, BH, Tq, Tk, causal, sm_scale, s);
    default:
      if (!bslice::slice_d(D)) return (int)cudaErrorInvalidValue;
      return D <= bslice::RES_MAX
                 ? (int)launch_dkv_slice<true>(q, k, v, dout, lse, di, lens,
                                               dk, dv, BH, Tq, Tk, D, causal,
                                               sm_scale, s)
                 : (int)launch_dkv_slice<false>(q, k, v, dout, lse, di, lens,
                                                dk, dv, BH, Tq, Tk, D, causal,
                                                sm_scale, s);
  }
}

// Dynamic shared memory of one block of the dq (dkv = 0) or dkv kernel at
// head dim D, in bytes; -1 for a D the kernels do not take.
extern "C" int paddle_flash_attention_bwd_smem_bytes(int dkv, int D) {
  switch (D) {
    case 64:
      return dkv ? Smem<64>::DKV_BYTES : Smem<64>::DQ_BYTES;
    case 128:
      return dkv ? Smem<128>::DKV_BYTES : Smem<128>::DQ_BYTES;
    case 192:
      return dkv ? dsplit::Smem<192>::DKV_BYTES : dsplit::Smem<192>::DQ_BYTES;
    case 256:
      return dkv ? dsplit::Smem<256>::DKV_BYTES : dsplit::Smem<256>::DQ_BYTES;
    case 384:
      return dkv ? qsplit::Smem<384>::DKV_BYTES : qsplit::Smem<384>::DQ_BYTES;
    case 512:
      return dkv ? qsplit::Smem<512>::DKV_BYTES : qsplit::Smem<512>::DQ_BYTES;
    default:  // the slice instances past 512
      if (!bslice::slice_d(D)) return -1;
      if (D <= bslice::RES_MAX)
        return dkv ? bslice::Ring<true, true>::bytes(D)
                   : bslice::Ring<false, true>::bytes(D);
      return dkv ? bslice::Ring<true, false>::bytes(D)
                 : bslice::Ring<false, false>::bytes(D);
  }
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
