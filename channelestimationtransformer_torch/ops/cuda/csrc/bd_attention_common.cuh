// Device helpers shared by the attention kernels (bd_attention_fwd.cu,
// bd_attention_bwd.cu): dtype conversion, row products over shared memory,
// and the dropout generator.
//
// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the Random123 reference), the counter-based generator of the
// port's attention-probability dropout. Its layout is shared with the plain
// version, ops/cuda/bd_attention.py:dropout_keep_mask:
//
//   key     = (seed & 0xffffffff, seed >> 32)    seed: one int64 on the device
//   counter = (col / 4, row, b * H + h, 0)       row: query, col: key position
//   element (row, col) is kept iff output word col % 4 < threshold,
//   threshold = min(int(keep_prob * 2^32), 2^32 - 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int EP>
__device__ __forceinline__ float dot_row(const float (&q)[EP], const float* __restrict__ row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < EP / 4; ++c) {
    const float4 k = r4[c];
    acc = fmaf(q[4 * c], k.x, acc);
    acc = fmaf(q[4 * c + 1], k.y, acc);
    acc = fmaf(q[4 * c + 2], k.z, acc);
    acc = fmaf(q[4 * c + 3], k.w, acc);
  }
  return acc;
}

// acc += p * row, with the row read as broadcast float4 loads.
template <int EP>
__device__ __forceinline__ void axpy_row(float p, const float* __restrict__ row,
                                         float (&acc)[EP]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < EP / 4; ++c) {
    const float4 x = r4[c];
    acc[4 * c] = fmaf(p, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(p, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(p, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(p, x.w, acc[4 * c + 3]);
  }
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint2 philox_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  return make_uint2(static_cast<unsigned>(s), static_cast<unsigned>(s >> 32));
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
