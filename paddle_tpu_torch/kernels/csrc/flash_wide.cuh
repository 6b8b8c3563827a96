// Tiles shared by the bf16 flash backward kernels' wide-head-dim
// instances.
//
// Which kernels take them: bf16 dq and dkv past D = 512
// (flash_attention_bf16.cu). Every kernel at 129 <= D <= 512 runs its
// tensor-core instance at 192, 256, 384 or 512
// (flash_attention_{fwd,bwd,bf16}.cu), and past 512 the forward of either
// dtype and the f32 dq and dkv run their slice instances on the tensor
// cores.
//
// The 64/128 instances keep a whole Q (or K/V) tile and its output
// accumulator in shared memory and registers; past D = 128 neither fits
// (dq alone would take 128+ registers a thread). The wide instances
// therefore split the work two ways:
// - every product that sums over D (S = Q K^T, dP = dO V^T) accumulates
//   over 64-column chunks of D staged through shared memory, so the
//   staging does not grow with D;
// - every output's D axis is cut into 128-wide slices on the grid's z
//   axis. Each block recomputes S (and P, dP) for its own slice, in the
//   same order in every slice.
// The wrapper zero-pads D past 512 to a multiple of 128 (zero columns
// change no score and give zero output columns). The kernels are
// templates on the element type T of q, k, v and the gradients,
// instantiated for __nv_bfloat16 (Elem gives its widening, rounding and
// store). Tiles are widened to f32 as they land in shared memory, and
// products run as f32 FMA on the CUDA cores; P and dS are rounded to bf16
// before the products that take them, and outputs once as they are
// stored, the Pallas kernels' rounding. Products: a simple tiling, 256
// threads over a 64 x 64 tile of S, each thread 4 rows (ty * 4 + i) by 4
// strided columns (tx + 16 j). Output slices are 64 rows x 128 columns,
// each thread the same 4 rows by 8 strided columns (tx + 16 jj):
// coalesced stores. No atomics: every output element is summed by one
// thread in a fixed order, so two launches agree bitwise.
#pragma once

#include <cuda_bf16.h>
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

// The element type: VEC of it in 16 bytes, widened to f32 as loaded,
// ``round`` an f32 value to the type (and back), ``store`` it.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

// The 16 bytes of row r0 + r, columns c .. c + VEC - 1 of a [T, Dp]
// matrix, widened to f32 into out; zeros where the row is past T.
template <typename T>
__device__ __forceinline__ void load16(float* out, const T* src, int row,
                                       int T_len, int Dp, int c) {
  constexpr int V = Elem<T>::VEC;
  if (row < T_len) {
    const uint4 raw = __ldg(
        reinterpret_cast<const uint4*>(src + (size_t)row * Dp + c));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = Elem<T>::f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = 0.f;
  }
}

// Rows [r0, r0 + 64) x columns [d0, d0 + 64) of a [T, Dp] matrix into a
// chunk tile; rows past T land as zeros.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, int r0,
                                           int T_len, int Dp, int d0) {
  constexpr int V = Elem<T>::VEC;
  for (int f = threadIdx.x; f < BT * (DC / V); f += NT) {
    const int r = f / (DC / V), c = (f % (DC / V)) * V;
    float x[V];
    load16(x, src, r0 + r, T_len, Dp, d0 + c);
    float* d = dst + r * LD + c;
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] = x[i];
  }
}

// Rows [r0, r0 + 64) x columns [s0, s0 + 128) of a [T, Dp] matrix into a
// slice tile; rows past T and columns past Dp land as zeros.
template <typename T>
__device__ __forceinline__ void load_slice(float* dst, const T* src, int r0,
                                           int T_len, int Dp, int s0) {
  constexpr int V = Elem<T>::VEC;
  for (int f = threadIdx.x; f < BT * (DS / V); f += NT) {
    const int r = f / (DS / V), c = (f % (DS / V)) * V;
    float x[V];
    load16(x, src, s0 + c < Dp ? r0 + r : T_len, T_len, Dp, s0 + c);
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(dst + r * DS + c + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
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
// acc * scale, rounded to T once; rows past T and columns past Dp are not
// written.
template <typename T>
__device__ __forceinline__ void store_slice(T* dst, const float (&acc)[4][8],
                                            float scale, int r0, int T_len,
                                            int Dp, int s0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= T_len) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = s0 + tx + 16 * jj;
      if (c < Dp) dst[(size_t)r * Dp + c] = Elem<T>::store(acc[i][jj] * scale);
    }
  }
}

inline dim3 grid(int BH, int T, int Dp) {
  return dim3(BH, (T + BT - 1) / BT, (Dp + DS - 1) / DS);
}

constexpr int DQ_BYTES = 5 * CHUNK * 4;
constexpr int DKV_BYTES = 6 * CHUNK * 4;

}  // namespace wide

namespace {

// The backward. dq: one block per (bh, 64-row q tile, 128-column slice
// of D) walks the 64-key tiles up to the causal bound and the row's K
// length; S and dP sum over D in 64-column chunks, dS goes to shared
// memory, and dq's slice accumulates dS K over the tile's K slice. dkv:
// one block per (bh, 64-row k tile, slice) walks the q tiles from the
// first one that can see it, forming S^T = K Q^T and dP^T = V dO^T (keys
// are the rows a thread owns), and accumulates dv += P^T dO and dk +=
// dS^T Q over the tile's dO and Q slices. The slices reuse the chunk
// tiles' space.
template <typename T>
__global__ void __launch_bounds__(wide::NT)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             const int* __restrict__ lens, T* __restrict__ dq,
                             int Tq, int Tk, int Dp, int causal,
                             float sm_scale) {
  using namespace wide;
  extern __shared__ __align__(16) float wide_smem[];
  float* qs = wide_smem;
  float* ks = qs + CHUNK;
  float* dos = ks + CHUNK;
  float* vs = dos + CHUNK;
  float* dss = vs + CHUNK;
  float* kslice = wide_smem;  // over Q's and K's chunk tiles
  const int bh = blockIdx.x, q0 = blockIdx.y * BT, s0 = blockIdx.z * DS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = (size_t)bh * Tq * Dp, koff = (size_t)bh * Tk * Dp;
  const int klen = min(max(lens[bh], 0), Tk);
  const int kend = causal ? min(klen, q0 + BT) : klen;
  float lse_r[4], di_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < Tq ? lse[(size_t)bh * Tq + row] : INFINITY;
    di_r[i] = row < Tq ? di[(size_t)bh * Tq + row] : 0.f;
  }
  float acc[4][8] = {};
  for (int k0 = 0; k0 < kend; k0 += BT) {
    float s[4][4] = {}, dp[4][4] = {};
    for (int d0 = 0; d0 < Dp; d0 += DC) {
      __syncthreads();
      load_chunk(qs, q + qoff, q0, Tq, Dp, d0);
      load_chunk(ks, k + koff, k0, Tk, Dp, d0);
      load_chunk(dos, dout + qoff, q0, Tq, Dp, d0);
      load_chunk(vs, v + koff, k0, Tk, Dp, d0);
      __syncthreads();
      chunk_product(s, qs, ks, ty, tx);
      chunk_product(dp, dos, vs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < klen && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * sm_scale - lse_r[i]) : 0.f;
        dss[(ty * 4 + i) * LD + tx + 16 * j] =
            Elem<T>::round(p * (dp[i][j] - di_r[i]));
      }
    }
    __syncthreads();
    load_slice(kslice, k + koff, k0, Tk, Dp, s0);
    __syncthreads();
    slice_product(acc, dss, kslice, ty, tx);
  }
  store_slice(dq + qoff, acc, sm_scale, q0, Tq, Dp, s0, ty, tx);
}

template <typename T>
__global__ void __launch_bounds__(wide::NT)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              const int* __restrict__ lens,
                              T* __restrict__ dk, T* __restrict__ dv, int Tq,
                              int Tk, int Dp, int causal, float sm_scale) {
  using namespace wide;
  extern __shared__ __align__(16) float wide_smem[];
  float* ks = wide_smem;
  float* qs = ks + CHUNK;
  float* vs = qs + CHUNK;
  float* dos = vs + CHUNK;
  float* pts = dos + CHUNK;
  float* dsts = pts + CHUNK;
  float* qslice = wide_smem;           // over the four chunk tiles
  float* doslice = wide_smem + SLICE;  // (2 SLICE <= 4 CHUNK)
  const int bh = blockIdx.x, k0 = blockIdx.y * BT, s0 = blockIdx.z * DS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = (size_t)bh * Tq * Dp, koff = (size_t)bh * Tk * Dp;
  const int klen = min(max(lens[bh], 0), Tk);
  float acc_dk[4][8] = {}, acc_dv[4][8] = {};
  // no q tile sees a k tile past the row's length; under causal masking
  // the first q tile that sees this one starts at q_pos = k0
  const int qbegin = k0 < klen ? (causal ? k0 : 0) : Tq;
  for (int q0 = qbegin; q0 < Tq; q0 += BT) {
    float st[4][4] = {}, dpt[4][4] = {};
    for (int d0 = 0; d0 < Dp; d0 += DC) {
      __syncthreads();
      load_chunk(ks, k + koff, k0, Tk, Dp, d0);
      load_chunk(qs, q + qoff, q0, Tq, Dp, d0);
      load_chunk(vs, v + koff, k0, Tk, Dp, d0);
      load_chunk(dos, dout + qoff, q0, Tq, Dp, d0);
      __syncthreads();
      chunk_product(st, ks, qs, ty, tx);
      chunk_product(dpt, vs, dos, ty, tx);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qrow = q0 + tx + 16 * j;
      const float lse_c =
          qrow < Tq ? lse[(size_t)bh * Tq + qrow] : INFINITY;
      const float di_c = qrow < Tq ? di[(size_t)bh * Tq + qrow] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
        const bool ok =
            key < klen && qrow < Tq && (!causal || key <= qrow);
        const float p = ok ? expf(st[i][j] * sm_scale - lse_c) : 0.f;
        pts[(ty * 4 + i) * LD + tx + 16 * j] = Elem<T>::round(p);
        dsts[(ty * 4 + i) * LD + tx + 16 * j] =
            Elem<T>::round(p * (dpt[i][j] - di_c));
      }
    }
    __syncthreads();
    load_slice(qslice, q + qoff, q0, Tq, Dp, s0);
    load_slice(doslice, dout + qoff, q0, Tq, Dp, s0);
    __syncthreads();
    slice_product(acc_dv, pts, doslice, ty, tx);
    slice_product(acc_dk, dsts, qslice, ty, tx);
  }
  store_slice(dk + koff, acc_dk, sm_scale, k0, Tk, Dp, s0, ty, tx);
  store_slice(dv + koff, acc_dv, 1.f, k0, Tk, Dp, s0, ty, tx);
}

// The launches, on ``stream``; each returns the launch's error.
template <typename T>
cudaError_t launch_dq_wide(const T* q, const T* k, const T* v, const T* dout,
                           const float* lse, const float* di, const int* lens,
                           T* dq, int BH, int Tq, int Tk, int Dp, int causal,
                           float sm_scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wide::DQ_BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<T><<<wide::grid(BH, Tq, Dp), wide::NT,
                                wide::DQ_BYTES, stream>>>(
      q, k, v, dout, lse, di, lens, dq, Tq, Tk, Dp, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_wide(const T* q, const T* k, const T* v, const T* dout,
                            const float* lse, const float* di,
                            const int* lens, T* dk, T* dv, int BH, int Tq,
                            int Tk, int Dp, int causal, float sm_scale,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wide::DKV_BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wide_kernel<T><<<wide::grid(BH, Tk, Dp), wide::NT,
                                 wide::DKV_BYTES, stream>>>(
      q, k, v, dout, lse, di, lens, dk, dv, Tq, Tk, Dp, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace
