// Block-diagonal attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ops/pallas/bd_attention.py:_bwd_kernel (launched by
// _bwd_call, wired in by the custom_vjp of _bd_attention) of
// channelestimationtransformer_tpu. For each (batch, head), from Q, K, V, the
// forward's output O, its cotangent dO and the forward's row log-sum-exp lse:
//
//     P   = exp(scale * Q K^T - lse)                (masked entries 0)
//     dP' = keep * inv_keep * (dO V^T)              (keep: the forward's mask)
//     dS  = P * (dP' - D) * scale,  D = rowsum(dO * O)
//     dQ  = dS K,   dK = dS^T Q,   dV = (keep * inv_keep * P)^T dO
//
// over [B, L, H, E] tensors, f32 or bf16 in, f32 math, gradients in the
// input dtype. D equals the TPU kernel's sum(dp * p), dropout included.
//
// The TPU kernel's block-diagonal packing, 128-row key padding and the fold
// of the packed dK/dV (bd_attention.py:211-222) exist only to fill the MXU
// and are not carried over. One thread block per (b, h) stages K and V in
// shared memory as f32, with lse and D.
//   Phase 1, one thread per query row: q, dO and the dQ accumulator in
//   registers; the thread regenerates its row's dropout mask (one Philox
//   call per four keys, keyed as in the forward), keeps it as bits in shared
//   memory, and loops over the keys with broadcast K/V row loads.
//   Phase 2, one thread per key row: k, v and the dK/dV accumulators in
//   registers; query rows of Q and dO are staged through shared memory in
//   tiles of kTile rows and read as broadcasts, and the mask bits of phase 1
//   are read back.
// Scores are recomputed in each phase from shared memory. Each gradient
// element is summed by one thread in a fixed order: no atomics, the result
// is deterministic.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// at the flagship encoder shape (B 256, H 8, E 16, L 90, f32) the call reads
// Q, K, V, O, dO and lse and writes dQ, dK, dV: ~94 MB, 28 us; it does ~10*E
// FLOPs per unmasked (row, key) pair with the recompute, ~2.65 GFLOP, 40 us.
// So operations bound it. This design does ~14*E FLOPs per pair (QK^T and
// dO V^T are recomputed in both phases) as scalar FMAs fed from shared
// memory, and phase 2 uses only Lk threads of the block; its time on the card
// is in PERF.md. Tensor-core MMAs and several heads per block are the later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bd_attention_common.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kTile = 128;  // query rows of Q and dO staged at a time in phase 2
constexpr int kMaxLk = 128;
constexpr int kMaskWords = kMaxLk / 32;  // keep bits per query row
constexpr int kMaxE = 64;

template <int EP, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int E, float (&dst)[EP]) {
#pragma unroll
  for (int e = 0; e < EP; ++e) dst[e] = e < E ? to_f32(src[e]) : 0.f;
}

template <int EP, typename T>
__device__ __forceinline__ void store_row(const float (&src)[EP], int E, T* __restrict__ dst) {
#pragma unroll
  for (int e = 0; e < EP; ++e)
    if (e < E) dst[e] = from_f32<T>(src[e]);
}

template <typename T, int EP, bool DROPOUT>
__global__ void __launch_bounds__(kMaxThreads)
bd_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const long long* __restrict__ seed, T* __restrict__ dq,
                        T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk, int E,
                        float scale, int causal, unsigned thresh, float inv_keep) {
  extern __shared__ float4 smem4[];
  const int tile = min(Lq, kTile);
  float* ks = reinterpret_cast<float*>(smem4);  // [Lk][EP]
  float* vs = ks + Lk * EP;                     // [Lk][EP]
  float* qs = vs + Lk * EP;                     // [tile][EP] (phase 2)
  float* dos = qs + tile * EP;                  // [tile][EP] (phase 2)
  float* lses = dos + tile * EP;                // [Lq]
  float* drow = lses + Lq;                      // [Lq]: D = rowsum(dO * O)
  unsigned* bits = reinterpret_cast<unsigned*>(drow + Lq);  // [Lq][kMaskWords]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = (size_t)H * E;  // stride between sequence positions
  const size_t q_off = (size_t)b * Lq * row + (size_t)h * E;
  const size_t k_off = (size_t)b * Lk * row + (size_t)h * E;

  for (int t = threadIdx.x; t < Lk * EP; t += blockDim.x) {
    const int j = t / EP, e = t - j * EP;
    ks[t] = e < E ? to_f32(k[k_off + j * row + e]) : 0.f;
    vs[t] = e < E ? to_f32(v[k_off + j * row + e]) : 0.f;
  }
  for (int i = threadIdx.x; i < Lq; i += blockDim.x) lses[i] = lse[(size_t)bh * Lq + i];
  __syncthreads();
  const uint2 key = DROPOUT ? philox_key(seed) : make_uint2(0u, 0u);

  // Phase 1: dQ, one query row per thread.
  for (int i = threadIdx.x; i < Lq; i += blockDim.x) {
    float qr[EP], dor[EP], acc[EP];
    load_row<EP>(q + q_off + i * row, E, qr);
    load_row<EP>(dout + q_off + i * row, E, dor);
    load_row<EP>(o + q_off + i * row, E, acc);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      d = fmaf(dor[e], acc[e], d);
      acc[e] = 0.f;
    }
    drow[i] = d;
    const float lse_i = lses[i];
    const int nk = causal ? min(i + 1, Lk) : Lk;
    unsigned keep = 0u;
    for (int j = 0; j < nk; ++j) {
      if (DROPOUT && (j & 31) == 0) {
        keep = 0u;
        for (int j0 = j; j0 < min(j + 32, nk); j0 += 4)
          keep |= keep_bits4(j0, i, bh, key, thresh) << (j0 - j);
        bits[i * kMaskWords + (j >> 5)] = keep;
      }
      const float p = expf(dot_row<EP>(qr, ks + j * EP) * scale - lse_i);
      float dp = dot_row<EP>(dor, vs + j * EP);
      if (DROPOUT) dp = ((keep >> (j & 31)) & 1u) ? dp * inv_keep : 0.f;
      axpy_row<EP>(p * (dp - d) * scale, ks + j * EP, acc);
    }
    store_row<EP>(acc, E, dq + q_off + i * row);
  }

  // Phase 2: dK and dV, one key row per thread, query rows in tiles.
  const int j = threadIdx.x;
  float kr[EP], vr[EP], dkr[EP], dvr[EP];
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    kr[e] = j < Lk ? ks[j * EP + e] : 0.f;
    vr[e] = j < Lk ? vs[j * EP + e] : 0.f;
    dkr[e] = 0.f;
    dvr[e] = 0.f;
  }
  for (int i0 = 0; i0 < Lq; i0 += tile) {
    const int rows = min(tile, Lq - i0);
    __syncthreads();  // phase 1 done / the previous tile read
    for (int t = threadIdx.x; t < rows * EP; t += blockDim.x) {
      const int r = t / EP, e = t - r * EP;
      const size_t src = q_off + (i0 + r) * row + e;
      qs[t] = e < E ? to_f32(q[src]) : 0.f;
      dos[t] = e < E ? to_f32(dout[src]) : 0.f;
    }
    __syncthreads();
    if (j < Lk) {
      for (int i = causal ? max(i0, j) : i0; i < i0 + rows; ++i) {
        const float* qi = qs + (i - i0) * EP;
        const float* doi = dos + (i - i0) * EP;
        const float p = expf(dot_row<EP>(kr, qi) * scale - lses[i]);
        float dp = dot_row<EP>(vr, doi);
        float pd = p;
        if (DROPOUT) {
          const bool kept = (bits[i * kMaskWords + (j >> 5)] >> (j & 31)) & 1u;
          dp = kept ? dp * inv_keep : 0.f;
          pd = kept ? p * inv_keep : 0.f;
        }
        axpy_row<EP>(p * (dp - drow[i]) * scale, qi, dkr);
        axpy_row<EP>(pd, doi, dvr);
      }
    }
  }
  if (j < Lk) {
    store_row<EP>(dkr, E, dk + k_off + j * row);
    store_row<EP>(dvr, E, dv + k_off + j * row);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const long long* seed;
  void *dq, *dk, *dv;
  int B, H, Lq, Lk, E;
  float scale;
  int causal;
  unsigned thresh;
  float inv_keep;
};

template <typename T, int EP, bool DROPOUT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int tile = min(a.Lq, kTile);
  const size_t smem = sizeof(float) * (2 * (size_t)a.Lk * EP + 2 * (size_t)tile * EP +
                                       2 * (size_t)a.Lq) +
                      (DROPOUT ? sizeof(unsigned) * kMaskWords * (size_t)a.Lq : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(bd_attention_bwd_kernel<T, EP, DROPOUT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // Enough threads for one key row each (phase 2) and up to kMaxThreads query rows.
  const int threads = (max(min(a.Lq, kMaxThreads), a.Lk) + 31) / 32 * 32;
  bd_attention_bwd_kernel<T, EP, DROPOUT><<<a.B * a.H, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.seed,
      static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Lq, a.Lk,
      a.E, a.scale, a.causal, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, bool DROPOUT>
cudaError_t launch_e(const Args& a, cudaStream_t stream) {
  if (a.E <= 16) return launch<T, 16, DROPOUT>(a, stream);
  if (a.E <= 32) return launch<T, 32, DROPOUT>(a, stream);
  return launch<T, 64, DROPOUT>(a, stream);
}

template <typename T>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  return a.seed != nullptr ? launch_e<T, true>(a, stream) : launch_e<T, false>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `seed` null means no dropout, else the
// forward's mask (Philox word < `thresh`) and scale `inv_keep`. dq is
// [B, Lq, H, E], dk and dv [B, Lk, H, E]; every element is written. Returns
// a cudaError_t (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int bd_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, const long long* seed,
                                void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                                int E, float scale, int causal, unsigned thresh,
                                float inv_keep, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxLk || E <= 0 || E > kMaxE)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, seed, dq, dk, dv, B, H, Lq, Lk, E,
               scale, causal, thresh, inv_keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float>(a, s);
    case 1: return (int)launch_d<__nv_bfloat16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
