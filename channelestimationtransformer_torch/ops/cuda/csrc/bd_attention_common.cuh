// Helpers shared by the attention kernels (bd_attention_fwd.cu,
// bd_attention_bwd.cu, mha_attention_fwd.cu): dtype conversion (f32, bf16
// and f16), the dropout mask, and the occupancy report of a launch
// configuration.
//
// The attention-probability dropout draws from Philox4x32-10 (philox.cuh).
// Its layout is shared with the plain version,
// ops/cuda/bd_attention.py:dropout_keep_mask:
//
//   key     = (seed & 0xffffffff, seed >> 32)    seed: one int64 on the device
//   counter = (col / 4, row, b * H + h, 0)       row: query, col: key position
//   element (row, col) is kept iff output word col % 4 < threshold,
//   threshold = min(int(keep_prob * 2^32), 2^32 - 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// The keep bits of columns j0 .. j0 + 3 of `row` (bit t for column j0 + t);
// j0 is a multiple of 4.
__device__ __forceinline__ unsigned keep_bits4(int j0, int row, int bh, uint2 key,
                                               unsigned thresh) {
  const uint4 w = philox4x32_10(make_uint4(static_cast<unsigned>(j0 >> 2),
                                           static_cast<unsigned>(row),
                                           static_cast<unsigned>(bh), 0u),
                                key);
  return (w.x < thresh) | ((w.y < thresh) << 1) | ((w.z < thresh) << 2) |
         ((w.w < thresh) << 3);
}

// What a launch of `kernel` at `threads` threads and `smem` dynamic bytes
// holds of an SM: out = {blocks resident, threads, dynamic shared bytes,
// registers a thread, local (spill) bytes a thread}. Set the kernel's
// dynamic shared memory limit first where smem > 48 KB.
template <typename K>
cudaError_t occupancy(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = blocks;
  out[1] = threads;
  out[2] = static_cast<int>(smem);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}
