// Flash-attention backward for Hopper (sm_90a), f32, plain FMA.
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
// int32 -> dq [BH, Tq, D], dk/dv [BH, Tk, D]. D is 64 or 128. Queries
// count from position 0 for both Tq and Tk, as in the forward.
//
// Layout on the card, and why it differs from the TPU kernels:
// - dq: one thread block per (bh, 64-row q tile) keeps Q, dO, lse and Di
//   of its tile and loops over the 64-row K/V tiles up to the causal
//   bound and the row's K length. dkv: one block per (bh, 64-row k tile)
//   keeps K and V and loops over the q tiles from the first one that can
//   see it (the causal lower bound). The TPU walks both loops as a
//   sequential grid axis; here each is a loop inside the block, and the
//   accumulators (dq, or dk and dv) stay in registers.
// - Tiles past the row's K length, and tiles wholly above the causal
//   diagonal, are never loaded: they contribute exactly zero.
// - Ragged edges (T not a multiple of 64) are masked here: rows past Tq
//   load as zeros with lse = +inf, so they contribute nothing, and no
//   caller pads to 128 lanes the way `_pad_to_lanes` does for Mosaic.
//
// What bounds it: at the training shape (B8 H8 T2048 D128, causal) dq
// does 6*D FLOPs per visible (q, k) pair and dkv 8*D (103 and 137
// GFLOP) on ~0.4 GB of inputs and outputs, so both are bound by
// operations. On CUDA cores every FMA takes its operands from shared
// memory; each thread keeps 4x4 score tiles and 4 x D/16 accumulator
// tiles in registers so that every shared-memory load feeds 2-4 FMAs,
// and every shared tile has an odd row stride (D+1, 65) so that the
// column walks of Q K^T and dO V^T hit distinct banks. Tensor cores
// (wgmma, TMA, bf16) and a fused single-pass backward are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // k rows per tile
constexpr int NTHREADS = 256;
constexpr int TX = 16;          // thread grid over a 64x64 tile: TY x TX
constexpr int TY = NTHREADS / TX;
constexpr int RPT = BQ / TY;    // tile rows per thread (4)
constexpr int CPT = BK / TX;    // tile columns per thread (4)
constexpr int PSTRIDE = BK + 1; // row stride of the 64x64 P / dS tiles
static_assert(BQ == BK, "load_tile copies 64-row tiles of every operand");
static_assert(BQ % TY == 0 && BK % TX == 0, "thread grid must tile 64x64");

template <int D>
struct Shape {
  static constexpr int STRIDE = D + 1;     // row stride of [64, D] tiles
  static constexpr int TILE = BQ * STRIDE;
  static constexpr int DPT = D / TX;       // accumulator columns per thread
};

// dq kernel's shared memory, in floats: Q, dO, K, V tiles, the dS tile,
// then lse and Di of the q tile.
template <int D>
struct DqLayout {
  using S = Shape<D>;
  static constexpr int Q = 0;
  static constexpr int DO = Q + S::TILE;
  static constexpr int K = DO + S::TILE;
  static constexpr int V = K + S::TILE;
  static constexpr int DS = V + S::TILE;
  static constexpr int LSE = DS + BQ * PSTRIDE;
  static constexpr int DI = LSE + BQ;
  static constexpr int TOTAL = DI + BQ;
};

// dkv kernel's shared memory: K, V, Q, dO tiles, the P and dS tiles, lse
// and Di of the current q tile.
template <int D>
struct DkvLayout {
  using S = Shape<D>;
  static constexpr int K = 0;
  static constexpr int V = K + S::TILE;
  static constexpr int Q = V + S::TILE;
  static constexpr int DO = Q + S::TILE;
  static constexpr int P = DO + S::TILE;
  static constexpr int DS = P + BQ * PSTRIDE;
  static constexpr int LSE = DS + BQ * PSTRIDE;
  static constexpr int DI = LSE + BQ;
  static constexpr int TOTAL = DI + BQ;
};

// Copy rows [row0, row0 + 64) of a [T, D] plane into shared memory with
// row stride D + 1; rows past T read as zeros. Global reads are float4.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int T) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < BQ * V4; idx += NTHREADS) {
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    float* out = dst + r * Shape<D>::STRIDE + c;
    out[0] = val.x;
    out[1] = val.y;
    out[2] = val.z;
    out[3] = val.w;
  }
}

// lse and Di of q rows [q0, q0 + 64); rows past Tq get lse = +inf (so their
// p is 0) and Di = 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* di_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ di,
                                          int q0, int Tq) {
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < Tq;
    lse_s[r] = in ? lse[q0 + r] : INFINITY;
    di_s[r] = in ? di[q0 + r] : 0.f;
  }
}

// For this thread's 4x4 slice of a 64x64 (q, k) tile: s = Q K^T and
// dp = dO V^T from shared memory, then p = exp(s * sm - lse) (0 where
// masked) and ds = p * (dp - Di). Rows are ty + TY*i, columns tx + TX*j.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s, const float* di_s,
                                         int q0, int k0, int length, int causal,
                                         float sm_scale, float (&p)[RPT][CPT],
                                         float (&ds)[RPT][CPT]) {
  constexpr int ST = Shape<D>::STRIDE;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RPT], dov[RPT], kv[CPT], vv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = qs[(ty + TY * i) * ST + d];
      dov[i] = dos[(ty + TY * i) * ST + d];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      kv[j] = ks[(tx + TX * j) * ST + d];
      vv[j] = vs[(tx + TX * j) * ST + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty + TY * i;
    const int q_pos = q0 + row;
    const float l = lse_s[row];
    const float di = di_s[row];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int k_pos = k0 + tx + TX * j;
      const bool live = k_pos < length && (!causal || q_pos >= k_pos);
      // l = +inf (a fully masked row, or a row past Tq) gives exp(-inf) = 0
      const float pij = live ? expf(s[i][j] * sm_scale - l) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - di);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di,
                        const int* __restrict__ lens, float* __restrict__ dq,
                        int Tq, int Tk, int causal, float sm_scale) {
  using L = DqLayout<D>;
  constexpr int ST = Shape<D>::STRIDE;
  constexpr int DPT = Shape<D>::DPT;
  extern __shared__ float smem[];
  float* qs = smem + L::Q;
  float* dos = smem + L::DO;
  float* ks = smem + L::K;
  float* vs = smem + L::V;
  float* dss = smem + L::DS;
  float* lse_s = smem + L::LSE;
  float* di_s = smem + L::DI;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  // causal blocks with high q tiles do the most work: schedule them first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int q0 = qb * BQ;
  const int bh = blockIdx.y;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  int n_tiles = (length + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ, Tq);          // exclusive bound on q_pos
    n_tiles = min(n_tiles, (last + BK - 1) / BK);
  }

  load_tile<D>(qs, q + qoff, q0, Tq);
  load_tile<D>(dos, dout + qoff, q0, Tq);
  load_rows(lse_s, di_s, lse + (size_t)bh * Tq, di + (size_t)bh * Tq, q0, Tq);

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/dss
    load_tile<D>(ks, k + koff, k0, Tk);
    load_tile<D>(vs, v + koff, k0, Tk);
    __syncthreads();

    float p[RPT][CPT], ds[RPT][CPT];
    p_and_ds<D>(qs, dos, ks, vs, lse_s, di_s, q0, k0, length, causal,
                sm_scale, p, ds);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        dss[(ty + TY * i) * PSTRIDE + tx + TX * j] = ds[i][j];
    __syncthreads();

    // dq += dS K for this thread's 4 rows x D/16 columns
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dss[(ty + TY * i) * PSTRIDE + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = ks[c * ST + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  float* dqp = dq + qoff;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int q_pos = q0 + ty + TY * i;
    if (q_pos >= Tq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      dqp[(size_t)q_pos * D + tx + TX * j] = acc[i][j] * sm_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         const int* __restrict__ lens,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Tq, int Tk, int causal, float sm_scale) {
  using L = DkvLayout<D>;
  constexpr int ST = Shape<D>::STRIDE;
  constexpr int DPT = Shape<D>::DPT;
  extern __shared__ float smem[];
  float* ks = smem + L::K;
  float* vs = smem + L::V;
  float* qs = smem + L::Q;
  float* dos = smem + L::DO;
  float* ps = smem + L::P;
  float* dss = smem + L::DS;
  float* lse_s = smem + L::LSE;
  float* di_s = smem + L::DI;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;

  const int length = max(0, min(lens[bh], Tk));
  const int n_q_tiles = (Tq + BQ - 1) / BQ;
  // a k tile wholly past the length is seen by no query: dk = dv = 0
  const int first = k0 >= length ? n_q_tiles : (causal ? k0 / BQ : 0);

  load_tile<D>(ks, k + koff, k0, Tk);
  load_tile<D>(vs, v + koff, k0, Tk);

  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = first; qb < n_q_tiles; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();  // the previous tile's readers are done with qs/dos/ps
    load_tile<D>(qs, q + qoff, q0, Tq);
    load_tile<D>(dos, dout + qoff, q0, Tq);
    load_rows(lse_s, di_s, lse + (size_t)bh * Tq, di + (size_t)bh * Tq, q0,
              Tq);
    __syncthreads();

    float p[RPT][CPT], ds[RPT][CPT];
    p_and_ds<D>(qs, dos, ks, vs, lse_s, di_s, q0, k0, length, causal,
                sm_scale, p, ds);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int at = (ty + TY * i) * PSTRIDE + tx + TX * j;
        ps[at] = p[i][j];
        dss[at] = ds[i][j];
      }
    __syncthreads();

    // dv += P^T dO and dk += dS^T Q for this thread's 4 k rows x D/16 cols
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[RPT], dsv[RPT], dov[DPT], qv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = ps[r * PSTRIDE + ty + TY * i];
        dsv[i] = dss[r * PSTRIDE + ty + TY * i];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        dov[j] = dos[r * ST + tx + TX * j];
        qv[j] = qs[r * ST + tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  float* dkp = dk + koff;
  float* dvp = dv + koff;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int k_pos = k0 + ty + TY * i;
    if (k_pos >= Tk) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const size_t at = (size_t)k_pos * D + tx + TX * j;
      dkp[at] = dk_acc[i][j] * sm_scale;
      dvp[at] = dv_acc[i][j];
    }
  }
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* di,
                      const int* lens, float* dq, int BH, int Tq, int Tk,
                      int causal, float sm_scale, cudaStream_t stream) {
  const int smem_bytes = DqLayout<D>::TOTAL * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  flash_bwd_dq_f32_kernel<D><<<grid, NTHREADS, smem_bytes, stream>>>(
      q, k, v, dout, lse, di, lens, dq, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* di,
                       const int* lens, float* dk, float* dv, int BH, int Tq,
                       int Tk, int causal, float sm_scale,
                       cudaStream_t stream) {
  const int smem_bytes = DkvLayout<D>::TOTAL * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, BH);
  flash_bwd_dkv_f32_kernel<D><<<grid, NTHREADS, smem_bytes, stream>>>(
      q, k, v, dout, lse, di, lens, dk, dv, Tq, Tk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). All pointers are device
// pointers to contiguous tensors; each returns a cudaError_t (0 = launched).
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
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
