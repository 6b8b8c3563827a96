// Fused 1x1-conv + batch-norm epilogue kernels for Hopper (sm_90a), f32.
//
// Replaces the three Pallas TPU kernels of paddle_tpu/kernels/conv_epilogue.py,
// which the fused `conv1x1_bn_act` op runs in ResNet under
// --fused_conv_epilogue:
//
//   conv1x1_stats     y = x . W  [R, O], plus stats [2, O] = (sum_r y,
//                     sum_r y*y) of that y, in f32, in the same pass
//                     (`_stats_kernel`, launched by `conv1x1_stats`)
//   conv1x1_epilogue  out = act((x . W) * scale + shift [+ residual]); the
//                     raw product never reaches device memory
//                     (`_epilogue_kernel`, launched by `conv1x1_epilogue`)
//   scale_shift_act   out = act(y * scale + shift [+ residual]), one read
//                     and one write of [R, O] (`_apply_kernel`, launched by
//                     `scale_shift_act`)
//
// x [R, I], W [I, O], y / residual / out [R, O] row-major f32; scale and
// shift [O] f32; act is none or relu. Every R, I and O is taken: ragged
// edges are masked here, so nothing falls back the way the TPU wrappers
// fall back to XLA when `_pick_block_r` finds no tile.
//
// Layout on the card, and why it differs from the TPU kernels:
// - The product is a tiled f32 GEMM on CUDA cores: one 256-thread block per
//   128 x 128 output tile, the K = I loop staged through shared memory in
//   8-deep slices (double-buffered: the next slice is loaded into registers
//   while the current one is multiplied), each thread an 8 x 8 register tile
//   (two 4-row by two 4-column groups, so its shared-memory reads are float4
//   and a warp's are broadcasts). Both GEMM kernels share this main loop and
//   differ only in the epilogue.
// - The TPU walks R as a sequential grid axis and carries the BN sums across
//   it in VMEM. Blocks here run in no order, so each 128-row tile writes its
//   column sums to partial[tile, 2, O] and a second small kernel adds the
//   tiles in a fixed order. No float atomics: the statistics, and every
//   layer after them, come out the same from run to run.
//
// What bounds them on the H100: the ResNet-50 1x1 convs do 2*R*I*O FLOPs on
// 4*(R*I + I*O + R*O) bytes. At I, O >= 128 that is above the card's f32
// FLOP:byte ridge (67 TFLOP/s over 3.35 TB/s = 20), so the GEMM kernels are
// bound by operations there and by bytes at I = O = 64; the 8 x 8 register
// tiles reuse each shared-memory load 8 times to keep the FMA pipes fed.
// scale_shift_act does 2-3 FLOPs a value and is bound by bytes: float4
// loads and stores when O % 4 == 0. Tensor cores (wgmma, bf16/TF32) are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 8;          // K slice staged in shared memory
constexpr int NTHREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int TDIM = 16;
constexpr int RED_X = 32;      // stats reduction block: 32 columns
constexpr int RED_Y = 32;      //   x 32 row-tile lanes

enum Epilogue { kStats = 0, kAffine = 1 };

// Output row (or column) of a thread's i-th register row (column): two
// 4-wide groups, 64 apart.
__device__ __forceinline__ int tile_off(int t, int i) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// Four consecutive values of row `row` starting at column `c` of a
// row-major [rows, cols] matrix; entries outside it read as 0. With VEC the
// caller guarantees cols % 4 == 0 and a 16-byte aligned base, so the four
// values are all inside or all outside.
template <bool VEC>
__device__ __forceinline__ void load4(float (&v)[4], const float* __restrict__ m,
                                      int row, int rows, int c, int cols) {
  if (VEC) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows && c < cols)
      t = *reinterpret_cast<const float4*>(m + (size_t)row * cols + c);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (row < rows && c + j < cols) ? m[(size_t)row * cols + c + j] : 0.f;
  }
}

// acc[i][j] += sum_k x[r_i, k] * w[k, c_j] over all of K = I for this
// block's 128 x 128 tile. smem holds 2 x (A slice [BK][BM] + B slice
// [BK][BN]) = 4096 floats; rows past R and columns past O come out 0.
template <bool VA, bool VB>
__device__ __forceinline__ void gemm_tile(float (&acc)[8][8], float* smem,
                                          const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          int R, int I, int O, int row0,
                                          int col0) {
  const int tid = threadIdx.x;
  const int tx = tid % TDIM, ty = tid / TDIM;
  // global -> shared copy assignment: A as 128 rows x 2 float4 along K,
  // B as 8 rows x 32 float4 along O
  const int a_r = tid / 2, a_k = (tid % 2) * 4;
  const int b_k = tid / 32, b_c = (tid % 32) * 4;
  // buffer b: A slice at smem + b * SLICE, B slice BK * BM floats after it
  constexpr int SLICE = BK * BM + BK * BN;

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  load4<VA>(ra, x, row0 + a_r, R, a_k, I);
  load4<VB>(rb, w, b_k, I, col0 + b_c, O);
#pragma unroll
  for (int j = 0; j < 4; ++j) smem[(a_k + j) * BM + a_r] = ra[j];
  *reinterpret_cast<float4*>(smem + BK * BM + b_k * BN + b_c) =
      make_float4(rb[0], rb[1], rb[2], rb[3]);
  __syncthreads();

  const int nk = (I + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nk;
    if (more) {
      const int k0 = (t + 1) * BK;
      load4<VA>(ra, x, row0 + a_r, R, k0 + a_k, I);
      load4<VB>(rb, w, k0 + b_k, I, col0 + b_c, O);
    }
    const float* a_s = smem + cur * SLICE;
    const float* b_s = a_s + BK * BM;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * BM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a_s + kk * BM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * BN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b_s + kk * BN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      float* nxt = smem + (cur ^ 1) * SLICE;
#pragma unroll
      for (int j = 0; j < 4; ++j) nxt[(a_k + j) * BM + a_r] = ra[j];
      *reinterpret_cast<float4*>(nxt + BK * BM + b_k * BN + b_c) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
    }
    __syncthreads();
  }
}

// Store four consecutive columns c..c+3 of row r (those < O).
template <bool VO>
__device__ __forceinline__ void store4(float* __restrict__ out, size_t r, int c,
                                       int O, const float (&v)[4]) {
  if (VO) {
    if (c < O)
      *reinterpret_cast<float4*>(out + r * O + c) =
          make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < O) out[r * O + c + j] = v[j];
  }
}

template <bool VA, bool VB, int EPI>
__global__ void __launch_bounds__(NTHREADS, 2)
conv1x1_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const float* __restrict__ residual, float* __restrict__ out,
                    float* __restrict__ partial, int R, int I, int O, int relu) {
  __shared__ __align__(16) float smem[4 * BK * BM];
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tx = threadIdx.x % TDIM, ty = threadIdx.x / TDIM;
  float acc[8][8];
  gemm_tile<VA, VB>(acc, smem, x, w, R, I, O, row0, col0);

  if (EPI == kStats) {
    // raw y, then this tile's column sums (rows past R hold exact zeros)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + tile_off(ty, i);
      if (r >= R) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                            acc[i][4 * h + 3]};
        store4<VB>(out, (size_t)r, col0 + tile_off(tx, 4 * h), O, v);
      }
    }
    // smem is free: the main loop ended on a barrier
    float* red_s = smem;                 // [TDIM][BN] column sums
    float* red_q = smem + TDIM * BN;     // [TDIM][BN] column sums of squares
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += acc[i][j];
        q = fmaf(acc[i][j], acc[i][j], q);
      }
      red_s[ty * BN + tile_off(tx, j)] = s;
      red_q[ty * BN + tile_off(tx, j)] = q;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < 2 * BN; idx += NTHREADS) {
      const int stat = idx / BN, c = idx % BN;
      if (col0 + c >= O) continue;
      const float* src = stat ? red_q : red_s;
      float total = 0.f;
      for (int t = 0; t < TDIM; ++t) total += src[t * BN + c];
      partial[((size_t)blockIdx.x * 2 + stat) * O + col0 + c] = total;
    }
  } else {
    float sc[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tile_off(tx, j);
      sc[j] = c < O ? scale[c] : 0.f;
      sh[j] = c < O ? shift[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + tile_off(ty, i);
      if (r >= R) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + tile_off(tx, 4 * h);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = acc[i][4 * h + j] * sc[4 * h + j] + sh[4 * h + j];
        if (residual != nullptr) {
          float res[4];
          load4<VB>(res, residual, r, R, c, O);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] += res[j];
        }
        if (relu) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = v[j] < 0.f ? 0.f : v[j];
        }
        store4<VB>(out, (size_t)r, c, O, v);
      }
    }
  }
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

template <bool VEC>
__global__ void scale_shift_act_kernel(const float* __restrict__ y,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ shift,
                                       const float* __restrict__ residual,
                                       float* __restrict__ out, long long n,
                                       int O, int relu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (VEC) {  // O % 4 == 0: a float4 never straddles two rows
    const long long n4 = n / 4;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
         i += stride) {
      const int c = (int)((i * 4) % O);
      const float4 v = reinterpret_cast<const float4*>(y)[i];
      float o[4] = {v.x * scale[c] + shift[c], v.y * scale[c + 1] + shift[c + 1],
                    v.z * scale[c + 2] + shift[c + 2],
                    v.w * scale[c + 3] + shift[c + 3]};
      if (residual != nullptr) {
        const float4 r = reinterpret_cast<const float4*>(residual)[i];
        o[0] += r.x; o[1] += r.y; o[2] += r.z; o[3] += r.w;
      }
      if (relu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = o[j] < 0.f ? 0.f : o[j];
      }
      reinterpret_cast<float4*>(out)[i] = make_float4(o[0], o[1], o[2], o[3]);
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const int c = (int)(i % O);
      float o = y[i] * scale[c] + shift[c];
      if (residual != nullptr) o += residual[i];
      if (relu) o = o < 0.f ? 0.f : o;
      out[i] = o;
    }
  }
}

template <int EPI>
cudaError_t launch_gemm(const float* x, const float* w, const float* scale,
                        const float* shift, const float* residual, float* out,
                        float* partial, int R, int I, int O, int relu,
                        cudaStream_t stream) {
  const dim3 grid((R + BM - 1) / BM, (O + BN - 1) / BN);
  const bool va = I % 4 == 0, vb = O % 4 == 0;
  if (va && vb)
    conv1x1_gemm_kernel<true, true, EPI><<<grid, NTHREADS, 0, stream>>>(
        x, w, scale, shift, residual, out, partial, R, I, O, relu);
  else if (va)
    conv1x1_gemm_kernel<true, false, EPI><<<grid, NTHREADS, 0, stream>>>(
        x, w, scale, shift, residual, out, partial, R, I, O, relu);
  else if (vb)
    conv1x1_gemm_kernel<false, true, EPI><<<grid, NTHREADS, 0, stream>>>(
        x, w, scale, shift, residual, out, partial, R, I, O, relu);
  else
    conv1x1_gemm_kernel<false, false, EPI><<<grid, NTHREADS, 0, stream>>>(
        x, w, scale, shift, residual, out, partial, R, I, O, relu);
  return cudaGetLastError();
}

}  // namespace

// Rows of y per partial-stats tile: partial holds ceil(R / this) x 2 x O.
extern "C" int paddle_conv1x1_row_tile() { return BM; }

// y = x . w and stats [2, O]; partial is scratch of ceil(R / 128) x 2 x O.
// Pointers are 16-byte aligned and contiguous (the wrapper makes them so).
extern "C" int paddle_conv1x1_stats_f32(const float* x, const float* w,
                                        float* y, float* partial, float* stats,
                                        int R, int I, int O, void* stream) {
  if (R <= 0 || O <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gemm<kStats>(x, w, nullptr, nullptr, nullptr, y,
                                        partial, R, I, O, 0, s);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (R + BM - 1) / BM;
  const dim3 grid((O + RED_X - 1) / RED_X, 2);
  stats_reduce_kernel<<<grid, dim3(RED_X, RED_Y), 0, s>>>(partial, stats,
                                                          tiles, O);
  return (int)cudaGetLastError();
}

// out = act((x . w) * scale + shift [+ residual]); residual may be null.
extern "C" int paddle_conv1x1_epilogue_f32(const float* x, const float* w,
                                           const float* scale,
                                           const float* shift,
                                           const float* residual, float* out,
                                           int R, int I, int O, int relu,
                                           void* stream) {
  if (R <= 0 || O <= 0) return (int)cudaSuccess;
  return (int)launch_gemm<kAffine>(x, w, scale, shift, residual, out, nullptr,
                                   R, I, O, relu,
                                   static_cast<cudaStream_t>(stream));
}

// out = act(y * scale + shift [+ residual]) over a contiguous [R, O].
extern "C" int paddle_scale_shift_act_f32(const float* y, const float* scale,
                                          const float* shift,
                                          const float* residual, float* out,
                                          long long R, int O, int relu,
                                          void* stream) {
  const long long n = R * (long long)O;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = O % 4 == 0;
  const long long work = vec ? n / 4 : n;
  const long long cap = 132LL * 32;  // ~32 blocks of 256 per SM, grid-stride
  long long blocks = (work + 255) / 256;
  if (blocks > cap) blocks = cap;
  if (vec)
    scale_shift_act_kernel<true><<<(unsigned)blocks, 256, 0, s>>>(
        y, scale, shift, residual, out, n, O, relu);
  else
    scale_shift_act_kernel<false><<<(unsigned)blocks, 256, 0, s>>>(
        y, scale, shift, residual, out, n, O, relu);
  return (int)cudaGetLastError();
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
