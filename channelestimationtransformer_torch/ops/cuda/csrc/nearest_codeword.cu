// Nearest-codeword snap for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ops/pallas/quant.py:_codeword_kernel (launched by
// fused_nearest_codeword) of channelestimationtransformer_tpu. For each
// element x of a float32 tensor and a float32 codebook c[0..N):
//
//     best = c[0]; for j = 1 .. N-1: if |x - c[j]| < |x - best|: best = c[j]
//
// a linear scan with strict `<`, so ties go to the lowest index, distances
// |x - c| computed in f32 (no sortedness assumed: any codebook).
//
// The TPU kernel keeps the codebook in SMEM and pads the tensor to
// 512 x 1024 blocks; nothing is padded here. Each block stages the codebook
// in shared memory once (N * 4 bytes); every thread of a warp then reads the
// same entry, a broadcast. One thread takes a group of four consecutive
// elements (float4 load and store where both pointers are 16-byte aligned,
// scalar for a ragged last group), so each codebook entry read from shared
// memory serves four elements, in a grid-stride loop over any element
// count.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): 8 bytes an element,
// 2 f32 operations (a subtraction and a comparison) an (element, codeword)
// pair. At the LSQ path's tensors (16,384 elements, N = 67) both take
// 0.04 us or less, so a launch costs its fixed overhead; at 2^24 elements
// and N = 287 the operations bound it (144 us against 40 us of bytes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
nearest_codeword_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                        float* __restrict__ y, long long n, int ncb) {
  extern __shared__ float cbs[];
  for (int t = threadIdx.x; t < ncb; t += blockDim.x) cbs[t] = cb[t];
  __syncthreads();

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
    float best[4], best_d[4];
    const float c0 = cbs[0];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      best[t] = c0;
      best_d[t] = fabsf(__fsub_rn(v[t], c0));
    }
    for (int j = 1; j < ncb; ++j) {
      const float c = cbs[j];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float d = fabsf(__fsub_rn(v[t], c));
        if (d < best_d[t]) {
          best_d[t] = d;
          best[t] = c;
        }
      }
    }
    if (VEC && full) {
      reinterpret_cast<float4*>(y)[g] = make_float4(best[0], best[1], best[2], best[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (i0 + t < n) y[i0 + t] = best[t];
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 on success); launches on `stream` and does not
// synchronise. n must be positive; 0 < ncb <= 12,288 (48 KB of shared memory).
extern "C" int nearest_codeword(const float* x, const float* cb, float* y, long long n,
                                int ncb, void* stream) {
  if (n <= 0 || ncb <= 0 || ncb > 12288) return (int)cudaErrorInvalidValue;
  const long long need = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const int blocks = need < kMaxBlocks ? (int)need : kMaxBlocks;
  const size_t smem = sizeof(float) * (size_t)ncb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0)
    nearest_codeword_kernel<true><<<blocks, kThreads, smem, s>>>(x, cb, y, n, ncb);
  else
    nearest_codeword_kernel<false><<<blocks, kThreads, smem, s>>>(x, cb, y, n, ncb);
  return (int)cudaGetLastError();
}
