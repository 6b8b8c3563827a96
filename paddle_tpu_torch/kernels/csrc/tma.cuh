// Host side of the TMA loads of the port's Hopper kernels
// (conv_epilogue.cu, flash_attention_bf16.cu): the tensor maps, encoded
// with libcuda's cuTensorMapEncodeTiled, found through the runtime.
#pragma once

#include <cuda.h>  // CUtensorMap (its encoder comes from the runtime)
#include <cuda_runtime.h>

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda's tensor-map encoder), found through
// the runtime, as this library links no libcuda of its own; null where
// it is missing.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map of a row-major [rows, cols] matrix of f32 or bf16 (`type`,
// `elem` bytes a value), `stride` values a row, read in boxes of box_rows
// x box_cols; zeros past its edges.
cudaError_t tensor_map(CUtensorMap* map, const void* base,
                       CUtensorMapDataType type, int elem, int cols, int rows,
                       int stride, int box_cols, int box_rows, bool swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A TMA map of a [planes, rows, cols] tensor of bf16 or f32 (`type`,
// `elem` bytes a value), contiguous, read in boxes of box_rows x
// box_cols of one plane in the 128-byte swizzle: rows past `rows` land
// as zeros inside each plane (a box never reaches the next plane).
cudaError_t tensor_map_3d(CUtensorMap* map, const void* base,
                          CUtensorMapDataType type, int elem, int cols,
                          int rows, int planes, int box_cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem,
                                 (cuuint64_t)cols * rows * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, 3, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
