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
// a multiple of 64 and the wide instances run
// (flash_bwd_{dq,dkv}_wide_kernel<float>, flash_wide.cuh). Queries count
// from position 0 for both Tq and Tk, as in the forward.
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

#include "flash_wide.cuh"
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

// s = A0 B0^T, dp = A1 B1^T over D for a warp's 16 rows r0.. of the
// owned tiles (a0, a1) against a streamed 32-row tile pair (b0, b1)
template <int D>
__device__ __forceinline__ void two_products(float (&s)[NT][4],
                                             float (&dp)[NT][4],
                                             const float* a0, const float* a1,
                                             const float* b0, const float* b1,
                                             int r0, int g, int t) {
  constexpr int ST = Smem<D>::ST;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA x0 = load_a<ST>(a0, r0, kk * 8, g, t);
    const FragA x1 = load_a<ST>(a1, r0, kk * 8, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
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
      two_products<D>(s, dp, qs, dos, ks, vs, r0, g, t);
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
      two_products<D>(p, ds, ks, vs, qs, dos, r0, g, t);
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

}  // namespace

// Plain C entry points (bound with ctypes). All pointers are device
// pointers to contiguous tensors with 16-byte aligned bases; each returns
// a cudaError_t (0 = launched). D is 64, 128 or a multiple of 64 above 128
// (the wide instances).
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
    default:
      if (D > 128 && D % wide::DC == 0)
        return (int)launch_dq_wide<float>(q, k, v, dout, lse, di, lens, dq,
                                          BH, Tq, Tk, D, causal, sm_scale, s);
      return (int)cudaErrorInvalidValue;
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
    default:
      if (D > 128 && D % wide::DC == 0)
        return (int)launch_dkv_wide<float>(q, k, v, dout, lse, di, lens, dk,
                                           dv, BH, Tq, Tk, D, causal,
                                           sm_scale, s);
      return (int)cudaErrorInvalidValue;
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
    default:
      if (D > 128 && D % wide::DC == 0)
        return dkv ? wide::DKV_BYTES : wide::DQ_BYTES;
      return -1;
  }
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
