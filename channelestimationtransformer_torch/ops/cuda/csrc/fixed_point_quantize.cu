// Fixed-point fake quantization for Hopper (sm_90a), plain C interface: one
// launch quantizes a group of float32 tensors that share one format.
//
// Replaces the TPU kernel ops/pallas/quant.py:_fixed_kernel (launched by
// fused_fixed_point_quantize) of channelestimationtransformer_tpu. For each
// element of each tensor, with scale = 2^fl (fl may be negative):
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
// Grouping. The TPU kernel was written for one pass over all the weights of
// a model (~1M elements at the flagship); one launch a tensor costs ~2 us of
// fixed launch and drain on this card against 0.04 us of bytes for a
// 128 x 128 tensor. So a launch takes a table of up to kMaxGroup tensors by
// value, as a kernel parameter (3,720 bytes, under the classic 4 KB limit):
//
//   x[e], y[e]        input and output pointers of entry e
//   n[e]              its element count (0: an empty tensor, no blocks)
//   block_start[e]    its first block; block_start[count] is the grid
//   vec[e]            1 where x[e] and y[e] are both 16-byte aligned
//
// A tensor takes ceil(n / 4 / kThreads) blocks, at most kMaxBlocks, with a
// grid-stride loop inside it: a group of one launches what the single-tensor
// kernel did. A block finds its entry by a binary search over block_start in
// the parameter bank and never straddles two tensors. One thread takes four
// consecutive elements (one Philox call; one float4 load and store where the
// entry is aligned, scalar accesses for a ragged last group or an unaligned
// view). A larger group is cut into launches of kMaxGroup entries by the
// caller (ops/cuda/quant.py), each passing t0, the global index of its first
// entry. Nothing is allocated and nothing synchronises, so a launch can be
// captured in a CUDA graph.
//
// Stochastic rounding draws u from Philox4x32-10 (philox.cuh). One seed
// serves the whole group; the counter layout, shared with the plain version
// (ops/cuda/quant.py:stochastic_uniform):
//
//   key     = (seed & 0xffffffff, seed >> 32)   seed: one int64 on the device
//   counter = (g & 0xffffffff, g >> 32, t, 0)   g = i / 4, i the flat index in
//                                               the tensor; t = t0 + e, the
//                                               tensor's index in its group
//   u_i     = (output word i % 4 >> 8) * 2^-24  24 random bits, as the TPU
//                                               kernel's (bits >> 8) * 2^-24
//
// At t = 0 the bits are those of the single-tensor layout (g, g >> 32, 0, 0).
//
// Bound on an H100 SXM (3.35 TB/s): 8 bytes an element (read once, written
// once), a handful of f32 operations: bound by bytes. The flagship's 72 PTQ
// tensors (1,015,808 elements) take 2.43 us; 2^24 elements 40 us.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // a tensor's blocks; grid-stride beyond
constexpr int kMaxGroup = 128;        // ops/cuda/quant.py:MAX_GROUP
constexpr float kTwoPowMinus24 = 5.9604644775390625e-08f;

struct Group {
  const float* x[kMaxGroup];
  float* y[kMaxGroup];
  long long n[kMaxGroup];
  int block_start[kMaxGroup + 1];
  unsigned char vec[kMaxGroup];
};
static_assert(sizeof(Group) <= 3720, "the table must leave room under 4 KB of parameters");

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

// Groups of four g = first, first + stride, ... of one tensor of n elements.
template <bool STOCHASTIC, bool CLAMP, bool VEC>
__device__ __forceinline__ void quantize_tensor(const float* __restrict__ x,
                                                float* __restrict__ y, long long n,
                                                long long first, long long stride, unsigned t,
                                                uint2 key, float scale, float t_min,
                                                float t_max) {
  const long long groups = (n + 3) / 4;
  for (long long g = first; g < groups; g += stride) {
    const long long i0 = 4 * g;
    const bool full = i0 + 4 <= n;
    float v[4];
    if (VEC && full) {
      const float4 w = reinterpret_cast<const float4*>(x)[g];
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = i0 + j < n ? x[i0 + j] : 0.f;
    }
    float u[4] = {0.f, 0.f, 0.f, 0.f};
    if (STOCHASTIC) {
      const uint4 w = philox4x32_10(
          make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32), t, 0u), key);
      u[0] = __fmul_rn(__uint2float_rn(w.x >> 8), kTwoPowMinus24);
      u[1] = __fmul_rn(__uint2float_rn(w.y >> 8), kTwoPowMinus24);
      u[2] = __fmul_rn(__uint2float_rn(w.z >> 8), kTwoPowMinus24);
      u[3] = __fmul_rn(__uint2float_rn(w.w >> 8), kTwoPowMinus24);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = quantize<STOCHASTIC, CLAMP>(v[j], u[j], scale, t_min, t_max);
    if (VEC && full) {
      reinterpret_cast<float4*>(y)[g] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j < n) y[i0 + j] = v[j];
    }
  }
}

template <bool STOCHASTIC, bool CLAMP>
__global__ void __launch_bounds__(kThreads)
fixed_point_quantize_kernel(const __grid_constant__ Group group, int count, int t0, float scale,
                            float t_min, float t_max, const long long* __restrict__ seed) {
  // The block's entry: the last one whose first block is at or before it
  // (an empty entry has no blocks, so the search passes over it).
  const int b = blockIdx.x;
  int e = 0;
  for (int hi = count - 1; e < hi;) {
    const int mid = (e + hi + 1) / 2;
    if (group.block_start[mid] <= b)
      e = mid;
    else
      hi = mid - 1;
  }
  const int first_block = group.block_start[e];
  const long long stride = (long long)(group.block_start[e + 1] - first_block) * kThreads;
  const long long first = (long long)(b - first_block) * kThreads + threadIdx.x;
  const uint2 key = STOCHASTIC ? philox_key(seed) : make_uint2(0u, 0u);
  const unsigned t = static_cast<unsigned>(t0 + e);
  if (group.vec[e])
    quantize_tensor<STOCHASTIC, CLAMP, true>(group.x[e], group.y[e], group.n[e], first, stride,
                                             t, key, scale, t_min, t_max);
  else
    quantize_tensor<STOCHASTIC, CLAMP, false>(group.x[e], group.y[e], group.n[e], first,
                                              stride, t, key, scale, t_min, t_max);
}

}  // namespace

// Quantizes `count` (1 to kMaxGroup) tensors in one launch. `table` holds
// count triples (x pointer, y pointer, element count) as int64; `t0` is the
// first entry's index in the caller's group (the Philox counter's word 2).
// `seed` null means nearest rounding, else stochastic with that seed.
// Returns a cudaError_t (0 on success); launches on `stream` and does not
// synchronise. At least one entry must hold an element.
extern "C" int fixed_point_quantize_grouped(const long long* table, int count, int t0,
                                            float scale, float t_min, float t_max, int clamp,
                                            const long long* seed, void* stream) {
  if (count < 1 || count > kMaxGroup || t0 < 0 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  Group group;
  int blocks = 0;
  for (int e = 0; e < count; ++e) {
    const long long n = table[3 * e + 2];
    if (n < 0) return (int)cudaErrorInvalidValue;
    group.x[e] = reinterpret_cast<const float*>(table[3 * e]);
    group.y[e] = reinterpret_cast<float*>(table[3 * e + 1]);
    group.n[e] = n;
    group.vec[e] = ((static_cast<uint64_t>(table[3 * e]) |
                     static_cast<uint64_t>(table[3 * e + 1])) & 15) == 0;
    group.block_start[e] = blocks;
    const long long need = ((n + 3) / 4 + kThreads - 1) / kThreads;
    blocks += need < kMaxBlocks ? (int)need : kMaxBlocks;
  }
  group.block_start[count] = blocks;
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seed != nullptr) {
    if (clamp)
      fixed_point_quantize_kernel<true, true>
          <<<blocks, kThreads, 0, s>>>(group, count, t0, scale, t_min, t_max, seed);
    else
      fixed_point_quantize_kernel<true, false>
          <<<blocks, kThreads, 0, s>>>(group, count, t0, scale, t_min, t_max, seed);
  } else if (clamp) {
    fixed_point_quantize_kernel<false, true>
        <<<blocks, kThreads, 0, s>>>(group, count, t0, scale, t_min, t_max, seed);
  } else {
    fixed_point_quantize_kernel<false, false>
        <<<blocks, kThreads, 0, s>>>(group, count, t0, scale, t_min, t_max, seed);
  }
  return (int)cudaGetLastError();
}
