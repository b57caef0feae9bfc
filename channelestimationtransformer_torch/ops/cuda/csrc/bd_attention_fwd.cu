// Block-diagonal attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ops/pallas/bd_attention.py:_fwd_kernel (launched by
// _fwd_call) of channelestimationtransformer_tpu, with dropout 0. For each
// (batch, head):
//
//     out = softmax(scale * Q K^T, masked) V
//
// over [B, L, H, E] tensors (E == D), f32 or bf16 in, f32 math, output in the
// input dtype. Keys at positions >= l_k do not exist here (no padding in
// device memory); with `causal`, key column > query row is excluded.
//
// The TPU kernel packs all H heads into one block-diagonal [Lq, H*128]
// matmul to fill the 128-wide MXU, doing ~8x the needed FLOPs. None of that
// is carried over. One thread block per (b, h) stages that head's K and V in
// shared memory as f32 (rows zero-padded to EP = 16, 32 or 64 columns), and
// each thread owns one query row: its q and its output accumulator live in
// registers, and every thread of a warp reads the same K or V row, a
// broadcast float4 load. Two passes over the keys: the row maximum, then
// p = exp(s - max), the sum and p * V (the scores are recomputed rather than
// stored).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// at the flagship encoder shape (B 256, H 8, E 16, Lq = Lk = 90, f32) the
// call reads Q, K, V and writes O once: 4 B * B*H*E*(2*Lq + 2*Lk) = 47.2 MB,
// 14.1 us; it does 4*B*H*Lq*Lk*E = 1.06 GFLOP, 15.8 us on the f32 CUDA
// cores. So the f32 CUDA-core design is bound by operations, barely above
// the byte bound; at the shorter shapes of the path the bytes bound it. This
// design reads each input byte from device memory once and keeps scores and
// probabilities out of it. Its arithmetic is scalar FMAs fed by broadcast
// float4 loads from shared memory, and the second pass's recomputed scores
// cost 1.5x the minimal FMAs. Measured on an H100 SXM at 700 W
// (chip_smoke.py), the L 90 call takes ~7x its bound, held by those
// shared-memory loads. Tensor-core MMAs (mma.sync / wgmma), several query
// rows per thread, several heads per block and a one-pass online softmax are
// the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 128;  // query rows per pass of a block
constexpr int kMaxLk = 128;       // key length limit (the TPU kernel's LP)
constexpr int kMaxE = 64;         // head width limit

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

template <typename T, int EP>
__global__ void __launch_bounds__(kMaxThreads)
bd_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        int H, int Lq, int Lk, int E, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [Lk][EP]
  float* vs = ks + Lk * EP;                     // [Lk][EP]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const size_t row = (size_t)H * E;  // stride between sequence positions
  const T* qb = q + (size_t)b * Lq * row + (size_t)h * E;
  const T* kb = k + (size_t)b * Lk * row + (size_t)h * E;
  const T* vb = v + (size_t)b * Lk * row + (size_t)h * E;
  T* ob = o + (size_t)b * Lq * row + (size_t)h * E;

  for (int t = threadIdx.x; t < Lk * EP; t += blockDim.x) {
    const int j = t / EP, e = t - j * EP;
    ks[t] = e < E ? to_f32(kb[j * row + e]) : 0.f;
    vs[t] = e < E ? to_f32(vb[j * row + e]) : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Lq; i += blockDim.x) {
    float qr[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) qr[e] = e < E ? to_f32(qb[i * row + e]) : 0.f;
    const int nk = causal ? min(i + 1, Lk) : Lk;

    float m = -INFINITY;
    for (int j = 0; j < nk; ++j) m = fmaxf(m, dot_row<EP>(qr, ks + j * EP) * scale);

    float acc[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) acc[e] = 0.f;
    float sum = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(dot_row<EP>(qr, ks + j * EP) * scale - m);
      sum += p;
      const float4* v4 = reinterpret_cast<const float4*>(vs + j * EP);
#pragma unroll
      for (int c = 0; c < EP / 4; ++c) {
        const float4 x = v4[c];
        acc[4 * c] = fmaf(p, x.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, x.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, x.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, x.w, acc[4 * c + 3]);
      }
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int e = 0; e < EP; ++e)
      if (e < E) ob[i * row + e] = from_f32<T>(acc[e] * inv);
  }
}

template <typename T, int EP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Lq, int Lk, int E, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)Lk * EP;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bd_attention_fwd_kernel<T, EP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = min(kMaxThreads, (Lq + 31) / 32 * 32);
  bd_attention_fwd_kernel<T, EP><<<B * H, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Lq, Lk, E, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_e(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int Lq, int Lk, int E, float scale, int causal, cudaStream_t stream) {
  if (E <= 16) return launch<T, 16>(q, k, v, o, B, H, Lq, Lk, E, scale, causal, stream);
  if (E <= 32) return launch<T, 32>(q, k, v, o, B, H, Lq, Lk, E, scale, causal, stream);
  return launch<T, 64>(q, k, v, o, B, H, Lq, Lk, E, scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int bd_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                int H, int Lq, int Lk, int E, float scale, int causal,
                                int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxLk || E <= 0 || E > kMaxE)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_e<float>(q, k, v, o, B, H, Lq, Lk, E, scale, causal, s);
    case 1: return (int)launch_e<__nv_bfloat16>(q, k, v, o, B, H, Lq, Lk, E, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
