// Block-diagonal attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ops/pallas/bd_attention.py:_fwd_kernel (launched by
// _fwd_call) of channelestimationtransformer_tpu. For each (batch, head):
//
//     out = dropout(softmax(scale * Q K^T, masked)) V
//
// over [B, L, H, E] tensors (E == D), f32 or bf16 in, f32 math, output in the
// input dtype. Keys at positions >= l_k do not exist here (no padding in
// device memory); with `causal`, key column > query row is excluded. With a
// seed (training), probabilities are dropped by the Philox mask of
// bd_attention_common.cuh and kept ones scaled by 1 / keep_prob, and the row log-sum-exp
// lse [B, H, Lq] (f32) may be written for the backward kernel.
//
// The TPU kernel packs all H heads into one block-diagonal [Lq, H*128]
// matmul to fill the 128-wide MXU, doing ~8x the needed FLOPs. None of that
// is carried over. One thread block per (b, h) stages that head's K and V in
// shared memory as f32 (rows zero-padded to EP = 16, 32 or 64 columns), and
// each thread owns one query row: its q and its output accumulator live in
// registers, and every thread of a warp reads the same K or V row, a
// broadcast float4 load. Two passes over the keys: the row maximum, then
// p = exp(s - max), the sum and p * V (the scores are recomputed rather than
// stored). Dropout costs one Philox call per four (row, key) pairs, made by
// the thread that owns the row; the mask is never stored.
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

#include "bd_attention_common.cuh"

namespace {

constexpr int kMaxThreads = 128;  // query rows per pass of a block
constexpr int kMaxLk = 128;       // key length limit (the TPU kernel's LP)
constexpr int kMaxE = 64;         // head width limit

template <typename T, int EP, bool DROPOUT, bool LSE>
__global__ void __launch_bounds__(kMaxThreads)
bd_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                        const long long* __restrict__ seed, int H, int Lq, int Lk, int E,
                        float scale, int causal, unsigned thresh, float inv_keep) {
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
  const uint2 key = DROPOUT ? philox_key(seed) : make_uint2(0u, 0u);

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
    if constexpr (!DROPOUT) {
      for (int j = 0; j < nk; ++j) {
        const float p = expf(dot_row<EP>(qr, ks + j * EP) * scale - m);
        sum += p;
        axpy_row<EP>(p, vs + j * EP, acc);
      }
    } else {
      for (int j0 = 0; j0 < nk; j0 += 4) {
        const unsigned keep = keep_bits4(j0, i, blockIdx.x, key, thresh);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j0 + t;
          if (j < nk) {
            const float p = expf(dot_row<EP>(qr, ks + j * EP) * scale - m);
            sum += p;
            if ((keep >> t) & 1u) axpy_row<EP>(p, vs + j * EP, acc);
          }
        }
      }
    }
    const float inv = (DROPOUT ? inv_keep : 1.f) / sum;
#pragma unroll
    for (int e = 0; e < EP; ++e)
      if (e < E) ob[i * row + e] = from_f32<T>(acc[e] * inv);
    if constexpr (LSE) lse[(size_t)blockIdx.x * Lq + i] = m + logf(sum);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o;
  float* lse;
  const long long* seed;
  int B, H, Lq, Lk, E;
  float scale;
  int causal;
  unsigned thresh;
  float inv_keep;
};

template <typename T, int EP, bool DROPOUT, bool LSE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)a.Lk * EP;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(bd_attention_fwd_kernel<T, EP, DROPOUT, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = min(kMaxThreads, (a.Lq + 31) / 32 * 32);
  bd_attention_fwd_kernel<T, EP, DROPOUT, LSE><<<a.B * a.H, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.seed, a.H, a.Lq, a.Lk, a.E, a.scale, a.causal, a.thresh,
      a.inv_keep);
  return cudaGetLastError();
}

template <typename T, bool DROPOUT, bool LSE>
cudaError_t launch_e(const Args& a, cudaStream_t stream) {
  if (a.E <= 16) return launch<T, 16, DROPOUT, LSE>(a, stream);
  if (a.E <= 32) return launch<T, 32, DROPOUT, LSE>(a, stream);
  return launch<T, 64, DROPOUT, LSE>(a, stream);
}

// The eval path (no dropout, no lse) gets a variant with neither in its code.
template <typename T>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  if (a.seed != nullptr)
    return a.lse != nullptr ? launch_e<T, true, true>(a, stream)
                            : launch_e<T, true, false>(a, stream);
  return a.lse != nullptr ? launch_e<T, false, true>(a, stream)
                          : launch_e<T, false, false>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `lse` may be null (not written); `seed`
// null means no dropout, else keep iff the Philox word < `thresh` and scale
// kept probabilities by `inv_keep`. Returns a cudaError_t (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int bd_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                float* lse, const long long* seed, int B, int H, int Lq,
                                int Lk, int E, float scale, int causal, unsigned thresh,
                                float inv_keep, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxLk || E <= 0 || E > kMaxE)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, seed, B, H, Lq, Lk, E, scale, causal, thresh, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float>(a, s);
    case 1: return (int)launch_d<__nv_bfloat16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
