// The warp-specialised block of the port's bf16 Hopper kernels
// (flash_attention_bf16.cu, conv_epilogue.cu): a producer warpgroup that
// gives its registers up and one of whose threads issues every TMA copy,
// and two consumer warpgroups of 64 rows each, the M of every `wgmma`.
// The copies go through a ring of stages in shared memory, each with a
// `full` barrier (one arrival that expects the stage's bytes, which TMA's
// complete_tx counts down) and an `empty` one (one arrival a consumer
// warp once its products have read the stage).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int WS_THREADS = 384;   // a producer warpgroup, two consumers
constexpr int CONSUMER_WARPS = 8;

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 128 threads of consumer warpgroup w meet (named barrier 1 + w).
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}
// The 256 consumer threads meet (named barrier 3).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// Thread 0 sets up a ring's barriers at `bars`: OWNED one-arrival
// barriers (tiles loaded once), then each of the STAGES stages' full
// (one arrival with its bytes) and empty (one arrival a consumer warp);
// then the block meets.
template <int STAGES, int OWNED = 1>
__device__ __forceinline__ void init_ring(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < OWNED; ++b) mbar_init(bars + b, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + OWNED + s, 1);
      mbar_init(bars + OWNED + STAGES + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer thread's turn at the ring's i-th stage (counted from 0
// over the kernel): waits until the consumers have emptied its slot, i %
// STAGES, from the second round on, then makes the slot's full barrier
// expect `bytes` of copies. Returns the slot.
template <int STAGES>
__device__ __forceinline__ int ring_acquire(uint64_t* full, uint64_t* empty,
                                            int i, uint32_t bytes) {
  const int s = i % STAGES;
  if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
  mbar_expect(&full[s], bytes);
  return s;
}

}  // namespace
