// Flash-attention forward for Hopper (sm_90a), f32, plain FMA.
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
// lse [BH, Tq] f32. D is 64 or 128.
//
// Layout on the card, and why it differs from the TPU kernel:
// - One thread block per (bh, 64-row q tile); a loop inside the block walks
//   the 64-row K/V tiles (the TPU walks them as a sequential grid axis).
// - The Q tile, the current K and V tiles and the 64x64 probability tile
//   live in shared memory; each thread keeps an 8 x (D/16) slice of the
//   output accumulator in registers.
// - Tiles wholly above the causal diagonal, and tiles wholly past the
//   row's K length, are never loaded: a K tile past the length contributes
//   exactly nothing, so skipping it changes no result.
// - Ragged edges (T not a multiple of 64) are masked here, so callers do
//   not pad to 128 lanes the way `_pad_to_lanes` does for Mosaic.
//
// What bounds it: at the serving shape (B8 H16 T1024 D64, causal) it does
// ~17 GFLOP (QK^T and PV below the diagonal) on ~134 MB of q/k/v/o, far
// above the card's FLOP:byte ridge, so it is bound by operations. On CUDA
// cores each FMA needs its operands from shared memory; the 8x4 (S = QK^T)
// and 8x4/8x8 (O += PV) register tiles reuse each shared-memory load 4-8
// times to keep the FMA pipes fed. Tensor cores (wgmma, bf16/TF32) are
// later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int NTHREADS = 128;
constexpr int TX = 16;          // thread grid over a tile: TY rows x TX cols
constexpr int TY = NTHREADS / TX;
constexpr int RPT = BQ / TY;    // tile rows per thread (8)
constexpr int CPT = BK / TX;    // score columns per thread (4)
static_assert(BQ == BK, "load_tile copies 64-row tiles of Q, K and V alike");

template <int D>
struct Layout {                 // shared-memory offsets, in floats
  static constexpr int KSTRIDE = D + 1;   // pad: column reads hit 16 banks
  static constexpr int PSTRIDE = BK + 1;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * D;
  static constexpr int V = K + BK * KSTRIDE;
  static constexpr int P = V + BK * D;
  static constexpr int M = P + BQ * PSTRIDE;
  static constexpr int L = M + BQ;
  static constexpr int ALPHA = L + BQ;
  static constexpr int TOTAL = ALPHA + BQ;
};

// Copy rows [row0, row0 + 64) of a [T, D] plane into shared memory with
// row stride `stride`; rows past T read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int row0, int T) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < BQ * V4; idx += NTHREADS) {
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    float* out = dst + r * stride + c;
    out[0] = val.x;
    out[1] = val.y;
    out[2] = val.z;
    out[3] = val.w;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ lens, float* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int causal,
                     float sm_scale) {
  using S = Layout<D>;
  constexpr int DPT = D / TX;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem + S::Q;
  float* ks = smem + S::K;
  float* vs = smem + S::V;
  float* ps = smem + S::P;
  float* ms = smem + S::M;
  float* ls = smem + S::L;
  float* alphas = smem + S::ALPHA;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const float* qp = q + (size_t)bh * Tq * D;
  const float* kp = k + (size_t)bh * Tk * D;
  const float* vp = v + (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ, Tq);          // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + BK - 1) / BK);
  }

  load_tile<D>(qs, D, qp, q0, Tq);
  if (tid < BQ) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    load_tile<D>(ks, S::KSTRIDE, kp, k0, Tk);
    load_tile<D>(vs, D, vp, k0, Tk);
    __syncthreads();

    // S = Q K^T for this thread's 8 rows x 4 columns
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + TY * i) * D + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + TX * j) * S::KSTRIDE + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty + TY * i;
      const int q_pos = q0 + row;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + TX * j;
        const int k_pos = k0 + col;
        const bool live = k_pos < length && (!causal || q_pos >= k_pos);
        ps[row * S::PSTRIDE + col] = live ? s[i][j] * sm_scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: two neighbouring lanes share one row, 32 columns each
    {
      const int row = tid >> 1;
      float* prow = ps + row * S::PSTRIDE + (tid & 1) * (BK / 2);
      const float m_old = ms[row];
      const float l_old = ls[row];
      float mx = -INFINITY;
#pragma unroll 8
      for (int c = 0; c < BK / 2; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_old, mx);
      // a row masked so far keeps m = -inf; exp then sees a finite offset
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll 8
      for (int c = 0; c < BK / 2; ++c) {
        const float p = expf(prow[c] - m_safe);   // masked: exp(-inf) = 0
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_safe);
      if ((tid & 1) == 0) {
        ms[row] = m_new;
        ls[row] = l_old * alpha + sum;
        alphas[row] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V for this thread's 8 rows x D/16 columns
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = alphas[ty + TY * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + TY * i) * S::PSTRIDE + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * D + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // final m and l are visible to every thread

  float* op = o + (size_t)bh * Tq * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + TY * i;
    const int q_pos = q0 + row;
    if (q_pos >= Tq) continue;
    const float denom = fmaxf(ls[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      op[(size_t)q_pos * D + tx + TX * j] = acc[i][j] / denom;
  }
  if (tid < BQ && q0 + tid < Tq) {
    const float l = ls[tid];
    lse[(size_t)bh * Tq + q0 + tid] =
        l > 0.f ? ms[tid] + logf(fmaxf(l, 1e-30f)) : INFINITY;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lens, float* o, float* lse, int BH, int Tq,
                   int Tk, int causal, float sm_scale, cudaStream_t stream) {
  const int smem_bytes = Layout<D>::TOTAL * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  flash_fwd_f32_kernel<D><<<grid, NTHREADS, smem_bytes, stream>>>(
      q, k, v, lens, o, lse, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers to contiguous tensors; returns a cudaError_t (0 = launched).
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
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
