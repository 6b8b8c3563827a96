// Flash-attention forward for Hopper (sm_90a), f32-accurate on the tensor
// cores: S = Q K^T on `wgmma` and O += P V on `mma.sync`, both as 3xTF32,
// fed by an asynchronous ring of K/V tiles.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (launched by
// `_flash_forward`, paddle_tpu/kernels/flash_attention.py). Same function:
//
//   s    = (q . k^T) * sm_scale        masked where k_pos >= len[bh] or,
//                                      when causal, where k_pos > q_pos
//   o    = softmax(s) . v              online softmax, f32 max/denominator/acc
//   lse  = m + log(l)                  +inf on a fully masked row (o = 0)
//
// q [BH, Tq, D], k/v [BH, Tk, D], len [BH] int32 -> o [BH, Tq, D],
// lse [BH, Tq] f32. D is 64 or 128: the wrapper zero-pads any other
// D <= 128 up to one of them (zero columns change no score and give zero
// output columns). Past 128 it pads D to a multiple of 64, and one in
// 257-512 to 384 or 512: at 192 and 256 the split instance below runs
// (flash_fwd_tf32x3_split_kernel: O split by D across the warpgroups), at
// 384 and 512 the quarter one (flash_fwd_tf32x3_quarter_kernel: 32 q rows
// a block, O split four ways by D); past 512 it pads D to a multiple of
// 128 and the slice one runs (flash_fwd_tf32x3_slice_kernel: the quarter
// layout with O cut into slices on the grid's z axis, K, V and past 1024
// Q streamed in 128-column steps). The denominator is max(l, 1e-30).
//
// Layout on the card, and why it differs from the TPU kernel:
// - One block of two warpgroups (8 warps) per (bh, 128-row q tile); bh on
//   grid x (up to 2^31 - 1), the q tiles on y, the highest (under causal
//   masking the heaviest) first. Each warpgroup owns 64 q rows, each warp
//   16 of them. The block walks 32-row K/V tiles (the TPU walks them as a
//   sequential grid axis) up to the causal bound and the row's K length.
//   Tiles past the length or wholly above the diagonal are never loaded,
//   and a warpgroup (for S) or warp (for P V) whose rows a tile cannot
//   reach skips its products: that changes no bit of a result.
//   Ragged edges are masked here (rows past T land as zeros), so no
//   caller pads to 128 lanes the way `_pad_to_lanes` does for Mosaic.
// - No atomics: each output element is summed by one thread in a fixed
//   order, so two launches on the same inputs agree bitwise.
//
// What bounds it: 4*D FLOPs per visible (q, k) pair (QK^T and PV) on q, k,
// v, o and lse read or written once. At the serving shape (B8 H16 T1024
// D64, causal) that is 17 GFLOP on 134 MB and at the training shape (B8
// H8 T2048 D128, causal) 69 GFLOP on 268 MB: far above the card's
// FLOP:byte ridge, so it is bound by operations. The card's fastest
// f32-accurate rate for products is the tensor cores' as 3xTF32 (495 / 3
// = 165 TFLOP/s, against 67 for f32 FMA on the CUDA cores, which the
// first version of this kernel used): each operand splits into a tf32 hi
// and lo = x - hi (tf32x3.cuh), and each product sums lo.hi + hi.lo +
// hi.hi in f32, the small terms first. What the design does about it:
// - S = Q K^T: `wgmma.m64n32k8.f32.tf32.tf32` per warpgroup, both
//   operands K-major (D is the reduction axis, as tf32 wgmma needs) from
//   shared memory in the 128-byte swizzle (wgmma_tf32.cuh): Q's hi and lo,
//   split once as the block's tile arrives, and each K tile's hi and lo,
//   split by the thread that brings its 16-byte chunks from device memory
//   (tile i + 1 rides in registers while tile i's products run, then
//   lands split in the stage tile i - 1 freed). So no pre-pass and no
//   scratch in device memory; a 32-key tile costs a thread 16 splits and
//   8 16-byte stores at D = 128. Q's hi/lo as wgmma's register operand,
//   the other way, needs 128 registers a thread at D = 128 beside O's 64:
//   past the budget.
// - The online softmax stays in registers: per warp, wgmma's accumulator
//   has mma.m16n8k8's C layout (rows g and g + 8 of the warp's 16, each in
//   one quad of lanes), so a row's max and sum are the thread's own values
//   and two __shfl_xor.
// - O += P V: 3xTF32 `mma.sync.m16n8k8` (mma_tf32x3.cuh). P's C fragment
//   is the A operand as it is, with k permuted {0, 2, 4, 6, 1, 3, 5, 7},
//   and V's rows are read from the ring in that order: P never goes to
//   shared memory and no transposed V is made (tf32 wgmma would need V
//   K-major along the keys, a transpose of every V element per tile).
//   Each tile's P V is summed in fresh registers and added to O * alpha in
//   f32: the tensor cores' f32 accumulation does not round to nearest, and
//   a chain through all of T drifts. V comes by cp.async (16-byte .cg,
//   zero-filling rows past T) at a row stride of D + 4 floats, so the
//   fragment reads hit 32 distinct banks.
// - Two stages; two barriers per tile; `fence.proxy.async` hands the
//   threads' stores of Q and K to wgmma.
// Budget (ptxas, sm_90a): at D = 128, O 64 registers, S 16, P's A
// fragments 32, the fresh sums 16, the K chunks in flight 16: 234
// registers, no spills; shared memory Q hi/lo 131,072 bytes + 2 stages x
// (K hi/lo 32,768 + V 16,896) = 230,400 of the 232,448 a block may have,
// one block of 8 warps per SM. At D = 64: 199 registers, 115,712 bytes,
// one block (two would need 128 registers: that spilled and ran slower).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int NWARPS = 8;  // two warpgroups of 64 q rows
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BQ = 16 * NWARPS;  // q rows a block owns, 16 a warp
constexpr int BK = 32;           // K/V rows a ring stage holds
constexpr int NT = BK / 8;       // 8-column MMA tiles across S
constexpr int STAGES = 2;

// Shared memory of the instance at head dim D, in bytes. Q's hi and lo,
// then each stage's K hi and lo, in wgmma's 128-byte swizzle: D / 32
// atoms along D, atom a holding columns 32a .. 32a + 31 of every row, 128
// bytes a row (sw128_desc); then each stage's raw V, rows D + 4 floats
// apart (4 mod 32 banks) for P V's fragment reads.
template <int D>
struct Tile {
  static constexpr int NA = D / 32;
  static constexpr int Q_ATOM = BQ * 128;
  static constexpr int K_ATOM = BK * 128;
  static constexpr int QHI = 0;
  static constexpr int QLO = QHI + NA * Q_ATOM;
  static constexpr int K = QLO + NA * Q_ATOM;  // stage s: hi, then lo
  static constexpr int K_STAGE = 2 * NA * K_ATOM;
  static constexpr int VST = D + 4;
  static constexpr int V = K + STAGES * K_STAGE;
  static constexpr int V_STAGE = BK * VST * 4;
  static constexpr int BYTES = V + STAGES * V_STAGE;
  // float4 chunks of a K tile each thread carries from device memory
  static constexpr int KV4 = BK * D / 4 / NTHREADS;
  static_assert(BK * D / 4 % NTHREADS == 0, "K tile must split evenly");
};

// Byte offset of the 16-byte chunk c4 (columns 4 c4 .. 4 c4 + 3) of row r
// of a tile in the 128-byte swizzle, atoms `atom` bytes apart.
__device__ __forceinline__ int sw_offset(int r, int c4, int atom) {
  return (c4 >> 3) * atom + r * 128 + (((c4 & 7) ^ (r & 7)) << 4);
}

// x's tf32 hi and lo (tf32x3.cuh) at `off` of the hi and lo tiles
__device__ __forceinline__ void store_split(char* hi, char* lo, int off,
                                            float4 x) {
  uint4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// The row r and 16-byte chunk c4 of a [rows, D] tile that this thread
// moves as its j-th chunk.
template <int D>
__device__ __forceinline__ void chunk_of(int j, int& r, int& c4) {
  const int idx = threadIdx.x + j * NTHREADS;
  r = idx / (D / 4);
  c4 = idx % (D / 4);
}

// chunk c4 of row row0 + r of a [T, D] plane; zeros past T
template <int D>
__device__ __forceinline__ float4 fetch(const float* __restrict__ src,
                                        int row0, int T, int r, int c4) {
  return row0 + r < T ? __ldg(reinterpret_cast<const float4*>(
                            src + (size_t)(row0 + r) * D) + c4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The online softmax over one key tile of a warp's 16 rows: S's fragment
// s (mma.m16n8k8's C fragment per warp: rows g and g + 8, each in one
// quad of lanes, this thread's columns 2t and 2t + 1 of each 8-key
// n-tile) masked where k_pos >= length or, under causal masking, k_pos >
// the row, and scaled; the rows' running max m and denominator l updated
// (a row's max and sum are the thread's own values and two __shfl_xor);
// O's accumulators rescaled by exp(m_old - m_new). s becomes P.
template <int NT, int ND>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[ND][4],
                                             const int (&row)[2], int k0,
                                             int length, int causal,
                                             float sm_scale, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
      const bool vis = k_pos < length && (!causal || row[h] >= k_pos);
      s[j][e] = vis ? s[j][e] * sm_scale : -INFINITY;
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
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
}

// one block of 8 warps per SM at either D (shared memory at D = 128; the
// register budget at D = 64)
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lens, float* __restrict__ o,
                        float* __restrict__ lse, int Tq, int Tk, int causal,
                        float sm_scale) {
  using L = Tile<D>;
  extern __shared__ __align__(1024) char smem[];

  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;  // the warpgroup: q rows 64 wg .. 64 wg + 63
  const int g = (threadIdx.x % 32) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ, Tq);  // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + BK - 1) / BK);
  }

  // K tile i's chunks ride in registers from device memory while tile
  // i - 1's products run, then land split in the stage tile i - 1 freed
  float4 kreg[L::KV4];
  auto fetch_k = [&](int i) {
#pragma unroll
    for (int j = 0; j < L::KV4; ++j) {
      int r, c4;
      chunk_of<D>(j, r, c4);
      kreg[j] = fetch<D>(k + koff, i * BK, Tk, r, c4);
    }
  };
  auto store_k = [&](int i) {
    char* hi = smem + L::K + (i % STAGES) * L::K_STAGE;
#pragma unroll
    for (int j = 0; j < L::KV4; ++j) {
      int r, c4;
      chunk_of<D>(j, r, c4);
      store_split(hi, hi + L::NA * L::K_ATOM, sw_offset(r, c4, L::K_ATOM),
                  kreg[j]);
    }
  };
  auto load_v = [&](int i) {
    load_rows<D, L::VST, BK, NTHREADS>(
        reinterpret_cast<float*>(smem + L::V + (i % STAGES) * L::V_STAGE),
        v + koff, i * BK, Tk);
  };
  if (n_tiles > 0) {
#pragma unroll 4
    for (int j = 0; j < BQ * D / 4 / NTHREADS; ++j) {
      int r, c4;
      chunk_of<D>(j, r, c4);
      const float4 x = fetch<D>(q + qoff, q0, Tq, r, c4);
      store_split(smem + L::QHI, smem + L::QLO, sw_offset(r, c4, L::Q_ATOM),
                  x);
    }
    fetch_k(0);
    store_k(0);
    load_v(0);
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
  // descriptors of this warpgroup's 64 rows of Q (hi, lo), atom 0
  const uint64_t dq_hi = sw128_desc(
      reinterpret_cast<const float*>(smem + L::QHI + wg * 64 * 128));
  const uint64_t dq_lo = dq_hi + ((L::QLO - L::QHI) >> 4);

  for (int i = 0; i < n_tiles; ++i) {
    const bool more = i + 1 < n_tiles;
    if (more) {  // the next tile's copies overlap this tile's products
      fetch_k(i + 1);
      load_v(i + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile's V has landed
    fence_proxy_async();  // this thread's K (and Q) stores, for wgmma
    __syncthreads();

    const int k0 = i * BK;
    const float* vs =
        reinterpret_cast<const float*>(smem + L::V + (i % STAGES) * L::V_STAGE);
    // a warpgroup whose rows are past Tq, or wholly above the tile, adds 0
    if (q0 + 64 * wg < Tq && (!causal || k0 <= q0 + 64 * wg + 63)) {
      float s[NT][4];
      float(&sd)[16] = *reinterpret_cast<float(*)[16]>(&s[0][0]);
      const uint64_t dk_hi = sw128_desc(reinterpret_cast<const float*>(
          smem + L::K + (i % STAGES) * L::K_STAGE));
      const uint64_t dk_lo = dk_hi + ((L::NA * L::K_ATOM) >> 4);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        // k-step ks: atom ks / 4, 32 bytes a step inside it
        const uint64_t qa = (ks / 4) * (L::Q_ATOM >> 4) + (ks % 4) * 2;
        const uint64_t ka = (ks / 4) * (L::K_ATOM >> 4) + (ks % 4) * 2;
        wgmma_m64n32_ss(sd, dq_lo + qa, dk_hi + ka, ks > 0);  // 0: fresh
        wgmma_m64n32_ss(sd, dq_hi + qa, dk_lo + ka, 1);
        wgmma_m64n32_ss(sd, dq_hi + qa, dk_hi + ka, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sd);

      // a warp whose rows are wholly above the tile adds 0
      if (!causal || k0 <= q0 + r0 + 15) {
        softmax_tile(s, m, l, acc, row, k0, length, causal, sm_scale, t);
        accumulate<L::VST>(acc, s, vs, g, t);  // O += P V
      }
    }
    if (more) store_k(i + 1);  // into the stage tile i - 1 used
    __syncthreads();  // every warp is done with this stage's V
  }

  float* op = o + qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Tq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(op + (size_t)row[h] * D + n * 8 + 2 * t) =
          make_float2(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    if (t == 0)
      lse[(size_t)bh * Tq + row[h]] =
          l[h] > 0.f ? m[h] + logf(fmaxf(l[h], 1e-30f)) : INFINITY;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lens, float* o, float* lse, int BH, int Tq,
                   int Tk, int causal, float sm_scale, cudaStream_t stream) {
  const int smem_bytes = Tile<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  flash_fwd_tf32x3_kernel<D><<<grid, NTHREADS, smem_bytes, stream>>>(
      q, k, v, lens, o, lse, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// --- head dims 192 and 256: O and S split by D across the warpgroups -----
//
// The D128 design does not fit at D256: Q's hi and lo for 128 rows would
// take 262,144 bytes of shared memory, and O for a warp's 16 rows 128
// registers a thread beside the fresh sums, P's fragments and the K
// chunks in flight. So a block owns 64 q rows, and each warpgroup owns
// half of D of all 64 rows' O: warp w's 16 rows are rows 16 (w % 4) ..,
// its columns D/2 (w / 4) .. (64 registers of O at D256, the D128
// budget). Each warpgroup forms S = Q K^T for all 64 rows over its own
// half of D (wgmma.m64n16k8, Q's and K's hi/lo in the 128-byte swizzle
// as above), and the two halves meet through shared memory: warp w adds
// warp w ^ 4's partial S (the same rows, the same fragment layout) to its
// own, and since a + b == b + a both hold the same bits, so the row max
// and the denominator agree too. The exchange goes through the tile's K
// stage, free once both warpgroups' products have read it: two more
// barriers a tile. Forming all of S in both warpgroups instead, with no
// exchange, costs 1.5x the forward's 4 D FLOPs a pair and ran 1.23x
// slower on an H100 (PERF.md §6). P V runs as above on the
// warpgroup's half of V's columns, each tile's P V a fresh sum added to
// O in f32. Shared memory at D256: Q hi/lo 131,072 bytes + 2 stages x
// (16-key K hi/lo 32,768 + V 16,640) = 229,888 of the 232,448 a block may
// have: the ring narrows to 16 keys a stage (32 would leave room for one
// stage only). At D192 the same tiles take 172,544 bytes.
namespace dsplit {

constexpr int BQ = 64;  // q rows a block owns: every warpgroup all of them
constexpr int BK = 16;  // keys a ring stage holds
constexpr int NT = BK / 8;
constexpr int STAGES = 2;

template <int D>
struct Tile {
  static constexpr int NA = D / 32;
  static constexpr int Q_ATOM = BQ * 128;
  static constexpr int K_ATOM = BK * 128;
  static constexpr int QHI = 0;
  static constexpr int QLO = QHI + NA * Q_ATOM;
  static constexpr int K = QLO + NA * Q_ATOM;  // stage s: hi, then lo
  static constexpr int K_STAGE = 2 * NA * K_ATOM;
  static constexpr int VST = D + 4;
  static constexpr int V = K + STAGES * K_STAGE;
  static constexpr int V_STAGE = BK * VST * 4;
  static constexpr int BYTES = V + STAGES * V_STAGE;
  static constexpr int KV4 = BK * D / 4 / NTHREADS;
  static constexpr int Q4 = BQ * D / 4 / NTHREADS;
  static_assert(BK * D / 4 % NTHREADS == 0 && BQ * D / 4 % NTHREADS == 0,
                "tiles must split evenly");
  static_assert(BYTES <= 232448, "past a block's shared memory");
};

}  // namespace dsplit

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_tf32x3_split_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ lens,
                              float* __restrict__ o, float* __restrict__ lse,
                              int Tq, int Tk, int causal, float sm_scale) {
  using L = dsplit::Tile<D>;
  constexpr int BQ2 = dsplit::BQ, BK2 = dsplit::BK, NT2 = dsplit::NT;
  constexpr int HALF = D / 2;
  extern __shared__ __align__(1024) char smem[];

  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;  // the warpgroup: O columns HALF wg ..
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

  float4 kreg[L::KV4];
  auto fetch_k = [&](int i) {
#pragma unroll
    for (int j = 0; j < L::KV4; ++j) {
      int r, c4;
      chunk_of<D>(j, r, c4);
      kreg[j] = fetch<D>(k + koff, i * BK2, Tk, r, c4);
    }
  };
  auto store_k = [&](int i) {
    char* hi = smem + L::K + (i % dsplit::STAGES) * L::K_STAGE;
#pragma unroll
    for (int j = 0; j < L::KV4; ++j) {
      int r, c4;
      chunk_of<D>(j, r, c4);
      store_split(hi, hi + L::NA * L::K_ATOM, sw_offset(r, c4, L::K_ATOM),
                  kreg[j]);
    }
  };
  auto load_v = [&](int i) {
    load_rows<D, L::VST, BK2, NTHREADS>(
        reinterpret_cast<float*>(smem + L::V +
                                 (i % dsplit::STAGES) * L::V_STAGE),
        v + koff, i * BK2, Tk);
  };
  if (n_tiles > 0) {
#pragma unroll 4
    for (int j = 0; j < L::Q4; ++j) {
      int r, c4;
      chunk_of<D>(j, r, c4);
      const float4 x = fetch<D>(q + qoff, q0, Tq, r, c4);
      store_split(smem + L::QHI, smem + L::QLO, sw_offset(r, c4, L::Q_ATOM),
                  x);
    }
    fetch_k(0);
    store_k(0);
    load_v(0);
    cp_async_commit();
  }

  const int r0 = (warp % 4) * 16;  // the warp's rows in the q tile
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's rows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HALF / 8][4];
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // descriptors of Q's 64 rows (hi, lo), atom 0
  const uint64_t dq_hi =
      sw128_desc(reinterpret_cast<const float*>(smem + L::QHI));
  const uint64_t dq_lo = dq_hi + ((L::QLO - L::QHI) >> 4);

  for (int i = 0; i < n_tiles; ++i) {
    const bool more = i + 1 < n_tiles;
    if (more) {  // the next tile's copies overlap this tile's products
      fetch_k(i + 1);
      load_v(i + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile's V has landed
    fence_proxy_async();  // this thread's K (and Q) stores, for wgmma
    __syncthreads();

    const int k0 = i * BK2;
    const float* vs = reinterpret_cast<const float*>(
        smem + L::V + (i % dsplit::STAGES) * L::V_STAGE);
    float s[NT2][4];
    float(&sd)[8] = *reinterpret_cast<float(*)[8]>(&s[0][0]);
    const uint64_t dk_hi = sw128_desc(reinterpret_cast<const float*>(
        smem + L::K + (i % dsplit::STAGES) * L::K_STAGE));
    const uint64_t dk_lo = dk_hi + ((L::NA * L::K_ATOM) >> 4);
    // this warpgroup's half of D: k-steps of 8, whole 32-column atoms
    constexpr int KSTEPS = D / 16;
    const int atom0 = wg * KSTEPS / 4;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t qa =
          (atom0 + kk / 4) * (L::Q_ATOM >> 4) + (kk % 4) * 2;
      const uint64_t ka =
          (atom0 + kk / 4) * (L::K_ATOM >> 4) + (kk % 4) * 2;
      wgmma_m64n16_ss(sd, dq_lo + qa, dk_hi + ka, kk > 0);  // 0: fresh
      wgmma_m64n16_ss(sd, dq_hi + qa, dk_lo + ka, 1);
      wgmma_m64n16_ss(sd, dq_hi + qa, dk_hi + ka, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sd);
    {  // the other half's S from warp ^ 4, through this stage's K tiles
      float* x = reinterpret_cast<float*>(
          smem + L::K + (i % dsplit::STAGES) * L::K_STAGE);
      const int lane = threadIdx.x % 32;
      __syncthreads();  // both warpgroups' products have read the stage
#pragma unroll
      for (int e = 0; e < 8; ++e) x[(warp * 8 + e) * 32 + lane] = sd[e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 8; ++e) sd[e] += x[((warp ^ 4) * 8 + e) * 32 + lane];
    }

    // a warp whose rows are wholly above the tile adds 0
    if (!causal || k0 <= q0 + r0 + 15) {
      softmax_tile(s, m, l, acc, row, k0, length, causal, sm_scale, t);
      accumulate<L::VST>(acc, s, vs + wg * HALF, g, t);  // O += P V
    }
    if (more) store_k(i + 1);  // into the stage tile i - 1 used
    __syncthreads();  // every warp is done with this stage
  }

  float* op = o + qoff + wg * HALF;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Tq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n)
      *reinterpret_cast<float2*>(op + (size_t)row[h] * D + n * 8 + 2 * t) =
          make_float2(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    if (wg == 0 && t == 0)
      lse[(size_t)bh * Tq + row[h]] =
          l[h] > 0.f ? m[h] + logf(fmaxf(l[h], 1e-30f)) : INFINITY;
  }
}

template <int D>
cudaError_t launch_split(const float* q, const float* k, const float* v,
                         const int* lens, float* o, float* lse, int BH,
                         int Tq, int Tk, int causal, float sm_scale,
                         cudaStream_t stream) {
  const int smem_bytes = dsplit::Tile<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_split_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + dsplit::BQ - 1) / dsplit::BQ);
  flash_fwd_tf32x3_split_kernel<D><<<grid, NTHREADS, smem_bytes, stream>>>(
      q, k, v, lens, o, lse, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// --- head dims 384 and 512: 32 q rows a block, O and S split four ways ---
//
// The split layout above does not fit at D512: Q's hi and lo for 64 rows
// take 262,144 bytes of shared memory, and O for a warp's 16 rows over
// half of D 128 registers a thread. So a block owns 32 q rows, as two
// row tiles of 16, and its 8 warps are 2 row tiles x 4 parts of D: warp
// w owns rows 16 (w % 2) .. and columns D/4 (w / 2) .. of O (64
// registers at D512, the D256 budget). S moves to `mma.sync` (tf32
// wgmma takes 64 rows and both operands' hi/lo from shared memory, which
// do not fit beside a K/V ring), from Q and K raw in shared memory, each
// fragment split into hi/lo as it is read. Each warp forms S for its 16
// rows over its quarter of D, the four partials of a row tile meet in
// shared memory (the exchange), and every warp of the row tile sums them
// in part order, so all four hold the same bits and the row max,
// denominator and lse agree. P V runs as in the split layout on the
// warp's quarter of V's columns, each tile's P V a fresh sum added to O
// in f32. Shared memory at D512: Q 66,048 bytes, 2 stages x 16 keys of
// raw K and V 132,096 (row stride D + 4 floats) and the 8,192-byte
// exchange = 206,336 (157,184 at D384). Holding each warp's Q fragments
// in registers instead (64 more a thread) took the kernel to 255
// registers with spills and ran 1.2x slower on an H100 (PERF.md §6). The
// load of the next tile is issued after the barrier that opens a tile,
// so two barriers a tile. The grid is (bh, 64-row pairs, 2): z picks a
// pair's upper (heavier under causal masking, z = 0) or lower 32 rows,
// so the grid's y axis holds as many rows as at 192 and 256.
namespace qsplit {

constexpr int BQ = 32;              // q rows a block owns
constexpr int RT = BQ / 16;         // row tiles of 16 rows
constexpr int PARTS = NWARPS / RT;  // parts of D: a warp each per row tile
constexpr int BK = 16;              // keys a ring stage holds
constexpr int NT = BK / 8;
constexpr int STAGES = 2;

// Shared memory, in floats: each stage's raw K, then each stage's raw V
// (row stride D + 4: the fragment reads hit 32 distinct banks), the
// exchange of S partials (one slot of NT x 4 values a lane per warp),
// then Q [BQ, D] at the same stride.
template <int D>
struct Tile {
  static constexpr int DP = D / PARTS;  // a warp's columns of D
  static constexpr int ST = D + 4;
  static constexpr int K = 0;
  static constexpr int V = K + STAGES * BK * ST;
  static constexpr int X = V + STAGES * BK * ST;
  static constexpr int Q = X + NWARPS * NT * 4 * 32;
  static constexpr int BYTES = (Q + BQ * ST) * 4;
  static_assert(DP % 16 == 0, "accumulate takes n-tiles in groups of 2");
  static_assert(BYTES <= 232448, "past a block's shared memory");
};

}  // namespace qsplit

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_tf32x3_quarter_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const int* __restrict__ lens,
                                float* __restrict__ o,
                                float* __restrict__ lse, int Tq, int Tk,
                                int causal, float sm_scale) {
  using L = qsplit::Tile<D>;
  constexpr int BQ4 = qsplit::BQ, BK4 = qsplit::BK, NT4 = qsplit::NT;
  constexpr int RT = qsplit::RT, PARTS = qsplit::PARTS;
  constexpr int ST = L::ST, DP = L::DP;
  extern __shared__ __align__(1024) char smem[];
  float* sm = reinterpret_cast<float*>(smem);

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
    const int s = (i % qsplit::STAGES) * BK4 * ST;
    load_rows<D, ST, BK4, NTHREADS>(sm + L::K + s, k + koff, i * BK4, Tk);
    load_rows<D, ST, BK4, NTHREADS>(sm + L::V + s, v + koff, i * BK4, Tk);
  };
  if (n_tiles > 0) {
    load_rows<D, ST, BQ4, NTHREADS>(sm + L::Q, q + qoff, q0, Tq);
    load_kv(0);
    cp_async_commit();
  }

  const int r0 = rt * 16;  // the warp's rows in the q tile
  const int c0 = part * DP;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's rows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* x = sm + L::X;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();  // this thread's copies of tile i have landed
    __syncthreads();     // everyone's, and every warp is done with i - 1
    if (i + 1 < n_tiles) {  // into the stage tile i - 1 used
      load_kv(i + 1);
      cp_async_commit();
    }
    const int k0 = i * BK4;
    const float* ks = sm + L::K + (i % qsplit::STAGES) * BK4 * ST;
    const float* vs = sm + L::V + (i % qsplit::STAGES) * BK4 * ST;
    // a row tile past Tq, or wholly above the tile, adds 0: all PARTS of
    // its warps skip alike, and no other row tile reads their partials
    const bool live = q0 + r0 < Tq && (!causal || k0 <= q0 + r0 + 15);
    float s[NT4][4];
    if (live) {  // S over this warp's columns, into its exchange slot
#pragma unroll
      for (int j = 0; j < NT4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const FragA a = load_a<ST>(sm + L::Q, r0, c0 + kk * 8, g, t);
#pragma unroll
        for (int j = 0; j < NT4; ++j)
          mma3(s[j], a, load_b_t<ST>(ks, j * 8, c0 + kk * 8, g, t));
      }
#pragma unroll
      for (int j = 0; j < NT4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[(warp * NT4 * 4 + 4 * j + e) * 32 + lane] = s[j][e];
    }
    __syncthreads();  // every partial is in
    if (!live) continue;
    // S = the row tile's partials summed in part order: the same bits in
    // each of its warps
#pragma unroll
    for (int j = 0; j < NT4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = x[(rt * NT4 * 4 + 4 * j + e) * 32 + lane];
#pragma unroll
        for (int p = 1; p < PARTS; ++p)
          sum += x[((p * RT + rt) * NT4 * 4 + 4 * j + e) * 32 + lane];
        s[j][e] = sum;
      }
    softmax_tile(s, m, l, acc, row, k0, length, causal, sm_scale, t);
    accumulate<ST, 2>(acc, s, vs + c0, g, t);  // O += P V
  }

  float* op = o + qoff + c0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Tq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      *reinterpret_cast<float2*>(op + (size_t)row[h] * D + n * 8 + 2 * t) =
          make_float2(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    if (part == 0 && t == 0)
      lse[(size_t)bh * Tq + row[h]] =
          l[h] > 0.f ? m[h] + logf(fmaxf(l[h], 1e-30f)) : INFINITY;
  }
}

template <int D>
cudaError_t launch_quarter(const float* q, const float* k, const float* v,
                           const int* lens, float* o, float* lse, int BH,
                           int Tq, int Tk, int causal, float sm_scale,
                           cudaStream_t stream) {
  const int smem_bytes = qsplit::Tile<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_quarter_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + 2 * qsplit::BQ - 1) / (2 * qsplit::BQ), 2);
  flash_fwd_tf32x3_quarter_kernel<D>
      <<<grid, NTHREADS, smem_bytes, stream>>>(q, k, v, lens, o, lse, Tq, Tk,
                                               causal, sm_scale);
  return cudaGetLastError();
}

// --- past D = 512: the quarter layout with O cut into slices of D -------
//
// Past D = 512 the quarter layout's Q (32 rows at stride D + 4) and two
// whole-D K/V stages do not fit, and its O would take a warp D / 8
// registers. The wrapper pads D to a multiple of 128 (Dp), and O is cut
// into slices of up to SLICE columns: blockIdx.z / 2 is the slice, z % 2
// the pair's upper or lower 32 rows, as above. Warp w owns row tile w % 2
// and part w / 2 of O's slice: column chunks of 32 (4 n-tiles) 4 c + part
// of it, 32 columns of every 128 (20 n-tiles, 80 registers, at a slice of
// 640: one slice at Dp = 640, where S would be formed twice in slices of
// 512). Every block forms S over all of Dp with the same parts: warp
// part p sums, over each 128 columns of Dp in order, its 32 columns 32 p
// .. of them, as four chains (one a k-step of 8 columns, summed in pairs
// after), and the four partials of a row tile meet in the exchange and
// are summed in part order, as above. So every slice forms the same S, row
// max, denominator and P bit for bit, and slice 0 alone writes lse. K
// and V stream through one ring of uniform steps (16 keys x 128 columns
// at a row stride of 132 floats: the fragment reads hit 32 distinct
// banks), in the order the block takes them: for each 16-key tile, Dp /
// 128 K steps, then NV = slice / 128 V steps, each a cp.async group that
// every thread issues SLOTS - 2 steps ahead; a barrier opens each batch
// of two steps (`Pipe`, mma_tf32x3.cuh). The loop over Dp's steps runs at run time, so any Dp
// past 512 is taken. Q stays resident at
// stride Dp + 4 up to SLICE_Q_MAX (132 KB at Dp = 1024); past it each K
// step also brings Q's 32 rows of its 128 columns (QRES false). Shared
// memory: 207,360 bytes at Dp = 1024 (Q 131,584, eight slots of 8,448,
// the exchange 8,192), 158,208 at Dp = 640, 210,944 past 1024 (slots of
// 25,344 with their Q rows).
namespace wsplit {

constexpr int SLICE = 640;  // columns of O a block owns at most
constexpr int CH = 128;     // columns of a streamed step: 32 a part
constexpr int CST = CH + 4;  // a step's row stride, in floats
constexpr int SLOTS = 8;    // steps of the ring
constexpr int SLICE_Q_MAX = 1024;  // the widest Dp whose Q stays resident

// Shared memory, in floats: the ring's slots (a step's 16 K or V rows,
// and with QRES false Q's 32 rows), the exchange (as qsplit's), then
// with QRES Q [32, Dp] at stride Dp + 4.
template <bool QRES>
struct Ring {
  static constexpr int KV = qsplit::BK * CST;  // a slot's K or V rows
  static constexpr int SLOT = KV + (QRES ? 0 : qsplit::BQ * CST);
  static constexpr int X = SLOTS * SLOT;
  static constexpr int Q = X + NWARPS * qsplit::NT * 4 * 32;
  __host__ __device__ static constexpr int bytes(int Dp) {
    return (Q + (QRES ? qsplit::BQ * (Dp + 4) : 0)) * 4;
  }
};
static_assert(Ring<true>::bytes(SLICE_Q_MAX) <= 232448 &&
                  Ring<false>::bytes(0) <= 232448,
              "past a block's shared memory");

}  // namespace wsplit

// The slice forward's block at slice blockIdx.z / 2, its O slice NV steps
// of 128 columns wide.
template <bool QRES, int NV>
__device__ __forceinline__ void fwd_slice(char* smem, const float* q,
                                          const float* k, const float* v,
                                          const int* lens, float* o,
                                          float* lse, int Tq, int Tk, int Dp,
                                          int causal, float sm_scale) {
  using namespace wsplit;
  using L = Ring<QRES>;
  constexpr int BQ4 = qsplit::BQ, BK4 = qsplit::BK, NT4 = qsplit::NT;
  constexpr int RT = qsplit::RT, PARTS = qsplit::PARTS;
  float* sm = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rt = warp % RT;    // the row tile: rows 16 rt ..
  const int part = warp / RT;  // the part: 32 columns of every 128
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int s0 = blockIdx.z / 2 * SLICE;  // the slice's first column
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * BQ4 +
                 (1 - (int)blockIdx.z % 2) * BQ4;
  if (q0 >= Tq) return;  // the upper half of the last pair
  const size_t qoff = (size_t)bh * Tq * Dp;
  const size_t koff = (size_t)bh * Tk * Dp;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + BK4 - 1) / BK4;
  if (causal) {
    const int last = min(q0 + BQ4, Tq);  // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + BK4 - 1) / BK4);
  }
  const int NS = Dp / CH;       // K steps a tile
  const int n_units = n_tiles * (NS + NV);
  const int QST = Dp + 4;       // Q's row stride (QRES)

  // step u of the block: K step u % (NS + NV) of tile u / (NS + NV), or
  // past NS its V step, into slot u % SLOTS
  auto issue = [&](int u) {
    const int i = u / (NS + NV), r = u % (NS + NV);
    float* slot = sm + (u % SLOTS) * L::SLOT;
    if (r < NS) {
      load_step<BK4, CH, CST, NTHREADS>(slot, k + koff, i * BK4, Tk, Dp,
                                        r * CH);
      if (!QRES)
        load_step<BQ4, CH, CST, NTHREADS>(slot + L::KV, q + qoff, q0, Tq,
                                          Dp, r * CH);
    } else {
      load_step<BK4, CH, CST, NTHREADS>(slot, v + koff, i * BK4, Tk, Dp,
                                        s0 + (r - NS) * CH);
    }
  };
  // one barrier a batch of two steps
  const Pipe<SLOTS, 2, decltype(issue)> pipe{issue, n_units};
  if (QRES && n_units > 0)  // Q, in the first group
    load_owned<BQ4, NTHREADS>(sm + L::Q, q + qoff, q0, Tq, Dp);
  pipe.start();

  const int r0 = rt * 16;  // the warp's rows in the q tile
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's rows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[4 * NV][4];  // step k's n-tiles: acc[4 k ..]
#pragma unroll
  for (int n = 0; n < 4 * NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* x = sm + L::X;

  int u = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * BK4;
    // a row tile past Tq, or wholly above the tile, adds 0: all PARTS of
    // its warps skip alike, and no other row tile reads their partials
    const bool live = q0 + r0 < Tq && (!causal || k0 <= q0 + r0 + 15);
    // this warp's S partial as four chains, one a k-step of a step's 32
    // columns, so that four products are in flight; summed in pairs after
    float sk[4][NT4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < NT4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sk[c][j][e] = 0.f;
    for (int j = 0; j < NS; j += 2) {  // S over this warp's columns
      const int b = min(2, NS - j);
      pipe.take(u, b);
      for (int h = 0; live && h < b; ++h) {
        const float* slot = sm + ((u + h) % SLOTS) * L::SLOT;
        const float* qs = QRES ? sm + L::Q + (j + h) * CH : slot + L::KV;
        const int qst = QRES ? QST : CST;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const FragA a =
              load_a_at(qs, qst, r0, part * 32 + kk * 8, g, t);
#pragma unroll
          for (int jn = 0; jn < NT4; ++jn)
            mma3(sk[kk][jn], a,
                 load_b_t<CST>(slot, jn * 8, part * 32 + kk * 8, g, t));
        }
      }
      u += b;
    }
    float s[NT4][4];
#pragma unroll
    for (int j = 0; j < NT4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (sk[0][j][e] + sk[1][j][e]) + (sk[2][j][e] + sk[3][j][e]);
        if (live) x[(warp * NT4 * 4 + 4 * j + e) * 32 + lane] = s[j][e];
      }
    __syncthreads();  // every partial is in
    if (live) {
      // S = the row tile's partials summed in part order: the same bits
      // in each of its warps and in every slice
#pragma unroll
      for (int j = 0; j < NT4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = x[(rt * NT4 * 4 + 4 * j + e) * 32 + lane];
#pragma unroll
          for (int p = 1; p < PARTS; ++p)
            sum += x[((p * RT + rt) * NT4 * 4 + 4 * j + e) * 32 + lane];
          s[j][e] = sum;
        }
      softmax_tile(s, m, l, acc, row, k0, length, causal, sm_scale, t);
    }
#pragma unroll
    for (int kv = 0; kv < NV; kv += 2) {  // O += P V, 128 columns a step
      const int b = NV - kv < 2 ? NV - kv : 2;
      pipe.take(u, b);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (live && h < b)
          accumulate<CST, 4>(
              *reinterpret_cast<float(*)[4][4]>(acc[4 * (kv + h)]), s,
              sm + ((u + h) % SLOTS) * L::SLOT + part * 32, g, t);
      u += b;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  float* op = o + qoff + s0 + part * 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= Tq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < 4 * NV; ++n)
      *reinterpret_cast<float2*>(op + (size_t)row[h] * Dp + (n / 4) * CH +
                                 (n % 4) * 8 + 2 * t) =
          make_float2(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    if (blockIdx.z < 2 && part == 0 && t == 0)  // every slice holds these
      lse[(size_t)bh * Tq + row[h]] =
          l[h] > 0.f ? m[h] + logf(fmaxf(l[h], 1e-30f)) : INFINITY;
  }
}

// The slice forward past D = 512: slice z / 2 of O, NV = min(SLICE, Dp -
// SLICE z / 2) / 128 steps wide.
template <bool QRES>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_tf32x3_slice_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ lens,
                              float* __restrict__ o, float* __restrict__ lse,
                              int Tq, int Tk, int Dp, int causal,
                              float sm_scale) {
  extern __shared__ __align__(1024) char smem[];
  switch (min(wsplit::SLICE, Dp - wsplit::SLICE * (int)(blockIdx.z / 2)) /
          wsplit::CH) {
    case 5:
      fwd_slice<QRES, 5>(smem, q, k, v, lens, o, lse, Tq, Tk, Dp, causal,
                         sm_scale);
      break;
    case 4:
      fwd_slice<QRES, 4>(smem, q, k, v, lens, o, lse, Tq, Tk, Dp, causal,
                         sm_scale);
      break;
    case 3:
      fwd_slice<QRES, 3>(smem, q, k, v, lens, o, lse, Tq, Tk, Dp, causal,
                         sm_scale);
      break;
    case 2:
      fwd_slice<QRES, 2>(smem, q, k, v, lens, o, lse, Tq, Tk, Dp, causal,
                         sm_scale);
      break;
    default:
      fwd_slice<QRES, 1>(smem, q, k, v, lens, o, lse, Tq, Tk, Dp, causal,
                         sm_scale);
  }
}

template <bool QRES>
cudaError_t launch_slice(const float* q, const float* k, const float* v,
                         const int* lens, float* o, float* lse, int BH,
                         int Tq, int Tk, int Dp, int causal, float sm_scale,
                         cudaStream_t stream) {
  const int smem_bytes = wsplit::Ring<QRES>::bytes(Dp);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_slice_kernel<QRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + 2 * qsplit::BQ - 1) / (2 * qsplit::BQ),
                  2 * ((Dp + wsplit::SLICE - 1) / wsplit::SLICE));
  flash_fwd_tf32x3_slice_kernel<QRES>
      <<<grid, NTHREADS, smem_bytes, stream>>>(q, k, v, lens, o, lse, Tq, Tk,
                                               Dp, causal, sm_scale);
  return cudaGetLastError();
}

bool slice_d(int D) { return D > 512 && D % wsplit::CH == 0; }

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous tensors with 16-byte aligned bases; returns a
// cudaError_t (0 = launched). D is 64, 128, 192, 256, 384, 512 or a
// multiple of 128 above 512 (the slice instance).
extern "C" int paddle_flash_attention_fwd_f32(
    const float* q, const float* k, const float* v, const int* lens,
    float* o, float* lse, int BH, int Tq, int Tk, int D, int causal,
    float sm_scale, void* stream) {
  if (BH <= 0 || Tq <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, lens, o, lse, BH, Tq, Tk, causal,
                             sm_scale, s);
    case 128:
      return (int)launch<128>(q, k, v, lens, o, lse, BH, Tq, Tk, causal,
                              sm_scale, s);
    case 192:
      return (int)launch_split<192>(q, k, v, lens, o, lse, BH, Tq, Tk,
                                    causal, sm_scale, s);
    case 256:
      return (int)launch_split<256>(q, k, v, lens, o, lse, BH, Tq, Tk,
                                    causal, sm_scale, s);
    case 384:
      return (int)launch_quarter<384>(q, k, v, lens, o, lse, BH, Tq, Tk,
                                      causal, sm_scale, s);
    case 512:
      return (int)launch_quarter<512>(q, k, v, lens, o, lse, BH, Tq, Tk,
                                      causal, sm_scale, s);
    default:
      if (!slice_d(D)) return (int)cudaErrorInvalidValue;
      return D <= wsplit::SLICE_Q_MAX
                 ? (int)launch_slice<true>(q, k, v, lens, o, lse, BH, Tq, Tk,
                                           D, causal, sm_scale, s)
                 : (int)launch_slice<false>(q, k, v, lens, o, lse, BH, Tq,
                                            Tk, D, causal, sm_scale, s);
  }
}

// Dynamic shared memory of one block at head dim D, in bytes; -1 for a D
// the kernel does not take.
extern "C" int paddle_flash_attention_fwd_smem_bytes(int D) {
  switch (D) {
    case 64:
      return Tile<64>::BYTES;
    case 128:
      return Tile<128>::BYTES;
    case 192:
      return dsplit::Tile<192>::BYTES;
    case 256:
      return dsplit::Tile<256>::BYTES;
    case 384:
      return qsplit::Tile<384>::BYTES;
    case 512:
      return qsplit::Tile<512>::BYTES;
    default:  // the slice forward past 512
      return !slice_d(D)                  ? -1
             : D <= wsplit::SLICE_Q_MAX ? wsplit::Ring<true>::bytes(D)
                                        : wsplit::Ring<false>::bytes(D);
  }
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
