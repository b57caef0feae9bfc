// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the Random123 reference), the counter-based generator of the
// port's kernels: attention-probability dropout (bd_attention_common.cuh)
// and stochastic rounding (fixed_point_quantize.cu). Each kernel's counter
// layout is written beside it. The plain torch version of the generator is
// ops/cuda/bd_attention.py:philox4x32_10.
#pragma once

#include <cuda_runtime.h>

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

// key = (seed & 0xffffffff, seed >> 32) of one int64 seed on the device.
__device__ __forceinline__ uint2 philox_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  return make_uint2(static_cast<unsigned>(s), static_cast<unsigned>(s >> 32));
}
