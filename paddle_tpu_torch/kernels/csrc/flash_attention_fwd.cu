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
// output columns). Past 128 it pads D to a multiple of 64 and the wide
// instance runs (flash_fwd_wide_kernel<float>, flash_wide.cuh). The
// denominator is max(l, 1e-30).
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

#include "flash_wide.cuh"
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

      // S's fragment per warp is mma.m16n8k8's C fragment: the online
      // softmax over this tile, row h of the thread in a quad
      if (!causal || k0 <= q0 + r0 + 15) {
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

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous tensors with 16-byte aligned bases; returns a
// cudaError_t (0 = launched). D is 64, 128 or a multiple of 64 above 128
// (the wide instance).
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
    default:
      if (D > 128 && D % wide::DC == 0)
        return (int)launch_fwd_wide<float>(q, k, v, lens, o, lse, BH, Tq, Tk,
                                           D, causal, sm_scale, s);
      return (int)cudaErrorInvalidValue;
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
    default:
      return D > 128 && D % wide::DC == 0 ? wide::FWD_BYTES : -1;
  }
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
