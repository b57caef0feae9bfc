// Fixed-point fake quantization for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ops/pallas/quant.py:_fixed_kernel (launched by
// fused_fixed_point_quantize) of channelestimationtransformer_tpu. For each
// element of a float32 tensor, with scale = 2^fl (fl may be negative):
//
//     scaled = x * scale
//     q      = rint(scaled)                 nearest, half to even
//            | floor(scaled + u)            stochastic, u in [0, 1)
//     q      = q / scale
//     q      = min(max(q, t_min), t_max)    with clamp (NaN stays NaN)
//
// each step rounded on its own as the JAX expression writes it (no fused
// multiply-add), so the plain version in torch ops gives the same bits.
//
// Stochastic rounding draws u from Philox4x32-10 (philox.cuh). The counter
// layout, shared with the plain version
// (ops/cuda/quant.py:stochastic_uniform):
//
//   key     = (seed & 0xffffffff, seed >> 32)   seed: one int64 on the device
//   counter = (g & 0xffffffff, g >> 32, 0, 0)   g = i / 4, i the flat index
//   u_i     = (output word i % 4 >> 8) * 2^-24  24 random bits, as the TPU
//                                               kernel's (bits >> 8) * 2^-24
//
// The TPU kernel pads the tensor to 512 x 1024 blocks to suit VMEM; nothing
// is padded here. One thread takes a group of four consecutive elements
// (one Philox call, one float4 load and store where both pointers are
// 16-byte aligned; scalar accesses for a ragged last group) in a
// grid-stride loop, so any element count works.
//
// Bound on an H100 SXM (3.35 TB/s): 8 bytes an element (read once, written
// once), a handful of f32 operations: bound by bytes. At the PTQ path's
// tensors (16,384 or 8,192 elements) the bytes take 0.04 us or less, so a
// launch costs its fixed overhead; at 2^24 elements 40 us.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks an SM
constexpr float kTwoPowMinus24 = 5.9604644775390625e-08f;

template <bool STOCHASTIC, bool CLAMP>
__device__ __forceinline__ float quantize(float x, float u, float scale, float t_min,
                                          float t_max) {
  const float scaled = __fmul_rn(x, scale);
  float q = STOCHASTIC ? floorf(__fadd_rn(scaled, u)) : rintf(scaled);
  q = __fdiv_rn(q, scale);
  if (CLAMP) {
    q = q < t_min ? t_min : q;
    q = q > t_max ? t_max : q;
  }
  return q;
}

template <bool STOCHASTIC, bool CLAMP, bool VEC>
__global__ void __launch_bounds__(kThreads)
fixed_point_quantize_kernel(const float* __restrict__ x, float* __restrict__ y, long long n,
                            float scale, float t_min, float t_max,
                            const long long* __restrict__ seed) {
  const uint2 key = STOCHASTIC ? philox_key(seed) : make_uint2(0u, 0u);
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const long long i0 = 4 * g;
    const bool full = i0 + 4 <= n;
    float v[4];
    if (VEC && full) {
      const float4 t = reinterpret_cast<const float4*>(x)[g];
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = i0 + t < n ? x[i0 + t] : 0.f;
    }
    float u[4] = {0.f, 0.f, 0.f, 0.f};
    if (STOCHASTIC) {
      const uint4 w = philox4x32_10(
          make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32), 0u, 0u), key);
      u[0] = __fmul_rn(__uint2float_rn(w.x >> 8), kTwoPowMinus24);
      u[1] = __fmul_rn(__uint2float_rn(w.y >> 8), kTwoPowMinus24);
      u[2] = __fmul_rn(__uint2float_rn(w.z >> 8), kTwoPowMinus24);
      u[3] = __fmul_rn(__uint2float_rn(w.w >> 8), kTwoPowMinus24);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      v[t] = quantize<STOCHASTIC, CLAMP>(v[t], u[t], scale, t_min, t_max);
    if (VEC && full) {
      reinterpret_cast<float4*>(y)[g] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (i0 + t < n) y[i0 + t] = v[t];
    }
  }
}

template <bool STOCHASTIC, bool CLAMP>
cudaError_t launch(const float* x, float* y, long long n, float scale, float t_min,
                   float t_max, const long long* seed, cudaStream_t stream) {
  const long long need = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const int blocks = need < kMaxBlocks ? (int)need : kMaxBlocks;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec)
    fixed_point_quantize_kernel<STOCHASTIC, CLAMP, true>
        <<<blocks, kThreads, 0, stream>>>(x, y, n, scale, t_min, t_max, seed);
  else
    fixed_point_quantize_kernel<STOCHASTIC, CLAMP, false>
        <<<blocks, kThreads, 0, stream>>>(x, y, n, scale, t_min, t_max, seed);
  return cudaGetLastError();
}

}  // namespace

// `seed` null means nearest rounding, else stochastic with that seed.
// Returns a cudaError_t (0 on success); launches on `stream` and does not
// synchronise. n must be positive.
extern "C" int fixed_point_quantize(const float* x, float* y, long long n, float scale,
                                    float t_min, float t_max, int clamp,
                                    const long long* seed, void* stream) {
  if (n <= 0 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seed != nullptr)
    return clamp ? (int)launch<true, true>(x, y, n, scale, t_min, t_max, seed, s)
                 : (int)launch<true, false>(x, y, n, scale, t_min, t_max, seed, s);
  return clamp ? (int)launch<false, true>(x, y, n, scale, t_min, t_max, seed, s)
               : (int)launch<false, false>(x, y, n, scale, t_min, t_max, seed, s);
}
