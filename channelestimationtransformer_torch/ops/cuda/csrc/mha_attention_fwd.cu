// Multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels ops/pallas/attention.py:_attn_kernel_blhe (:70;
// l_q == l_k, the model's [B, L, H, E] blocks) and _attn_kernel_small (:31;
// [B*H, L, E] groups, l_q != l_k and D != E allowed) of
// channelestimationtransformer_tpu, both launched by its mha_attention. For
// each (batch, head):
//
//     out = softmax(scale * Q K^T, masked) V
//
// q [B, Lq, H, E], k [B, Lk, H, E], v [B, Lk, H, D] and out [B, Lq, H, D] are
// read and written in place through their strides, with no transposes; f32
// or bf16 in, f32 math, output in the input dtype. With `causal` the mask is
// top-left aligned: key j is kept for query i iff j <= i (the TPU kernels'
// mask and full_attention's triu(1)), also when Lq != Lk.
//
// Design. One block of 256 threads per (b, h, tile of BQ = 16, 32 or 64
// query rows; the smallest that holds Lq, so the short decoder shapes waste
// few rows and still give B*H blocks). The block stages its Q tile in shared
// memory once as f32, then walks the keys in tiles of 64 (K and V rows as
// f32, zero-padded to W = 64 or 128 columns) with a running row max and sum
// (online softmax): the [Lq, Lk] scores never reach device memory, and any Lk
// fits. A causal block stops at the last key its rows can see. The threads
// form 16 row groups of 16 lanes. For the scores a thread holds RM = BQ/16
// rows x 4 keys (keys tc + 16*jj: consecutive lanes read consecutive padded
// K rows, free of bank conflicts); row maxima and sums are reduced over the
// 16 lanes by shuffles. The probabilities go through shared memory (over the
// K tile, which is no longer read) to the P*V product, where the thread
// holds RM rows x W/16 output columns. Every inner step is an outer product
// of float4 loads from shared memory: 8 to 11 FMAs per 16-byte load at 64-row
// tiles, ~3 at 16-row tiles.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores)
// at the xl model's encoder shape (B 64, H 8, E = D = 128, Lq = Lk = 256,
// f32): it reads Q, K, V and writes O once, 4 B * B*H*E*4*L = 268 MB, 80 us;
// it does 4*B*H*Lq*Lk*E = 17.2 GFLOP, 256 us on the f32 CUDA cores. So the
// call is bound by operations, and the design spends its shared memory and
// registers on keeping the FMA pipes fed (two blocks of 101 KB per SM,
// <= 128 registers a thread) and reads each K/V tile from L2 once per query
// tile. Measured on an H100 SXM at 700 W (chip_smoke.py): 669 us at that
// shape, 2.6x its bound (38% of the f32 peak; by count, the shared-memory
// wavefronts take ~70% of the FMA issue time); the 16-row decoder tiles run
// ~5x their byte bound. In bf16 the same work
// is 17 us on the tensor cores, which this CUDA-core kernel does not use:
// mma.sync / wgmma tiles (and a split-TF32 product for f32 inputs) are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "bd_attention_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kBK = 64;        // keys per tile
constexpr int kBKP = kBK + 4;  // padded row of the probability tile
constexpr int kMaxW = 128;     // head width limit, E and D
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float lane(const float4& x, int t) {
  return t == 0 ? x.x : t == 1 ? x.y : t == 2 ? x.z : x.w;
}

// W: padded head width (64 or 128); RM: query rows per thread (BQ = 16 * RM).
template <typename T, int W, int RM>
__global__ void __launch_bounds__(kThreads, 2)
mha_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int H, int Lq, int Lk,
                         int E, int D, float scale_log2, int causal) {
  constexpr int BQ = 16 * RM;
  constexpr int WP = W + 4;    // padded row: float4-aligned, conflict-free
  constexpr int NCH = W / 64;  // float4 output chunks per thread and row
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [BQ][WP]
  float* sk = sq + BQ * WP;                     // [kBK][WP]
  float* sv = sk + kBK * WP;                    // [kBK][WP]
  float* sp = sk;  // [BQ][kBKP] probabilities, over K once the scores are done

  const int n_qt = (Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * BQ;
  const int b = bh / H, h = bh - b * H;
  const size_t krow = (size_t)H * E, vrow = (size_t)H * D;  // position strides
  const T* qb = q + (size_t)b * Lq * krow + (size_t)h * E;
  const T* kb = k + (size_t)b * Lk * krow + (size_t)h * E;
  const T* vb = v + (size_t)b * Lk * vrow + (size_t)h * D;
  T* ob = o + (size_t)b * Lq * vrow + (size_t)h * D;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;

  for (int t = threadIdx.x; t < BQ * W; t += kThreads) {
    const int r = t / W, e = t - r * W;
    sq[r * WP + e] = q0 + r < Lq && e < E ? to_f32(qb[(size_t)(q0 + r) * krow + e]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][NCH][4];
#pragma unroll
  for (int ii = 0; ii < RM; ++ii) {
    m[ii] = -INFINITY;
    l[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[ii][c][x] = 0.f;
  }

  const int n_keys = causal ? min(Lk, q0 + BQ) : Lk;
  for (int j0 = 0; j0 < n_keys; j0 += kBK) {
    __syncthreads();  // Q is staged; the last tile's P and V are read
    for (int t = threadIdx.x; t < kBK * W; t += kThreads) {
      const int j = t / W, e = t - j * W;
      const bool row = j0 + j < Lk;
      sk[j * WP + e] = row && e < E ? to_f32(kb[(size_t)(j0 + j) * krow + e]) : 0.f;
      sv[j * WP + e] = row && e < D ? to_f32(vb[(size_t)(j0 + j) * vrow + e]) : 0.f;
    }
    __syncthreads();

    float s[RM][4];
#pragma unroll
    for (int ii = 0; ii < RM; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
    for (int e = 0; e < W; e += 4) {
      float4 kv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(sk + (tc + 16 * jj) * WP + e);
#pragma unroll
      for (int ii = 0; ii < RM; ++ii) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + (tr * RM + ii) * WP + e);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[ii][jj] = fmaf(qv.x, kv[jj].x, s[ii][jj]);
          s[ii][jj] = fmaf(qv.y, kv[jj].y, s[ii][jj]);
          s[ii][jj] = fmaf(qv.z, kv[jj].z, s[ii][jj]);
          s[ii][jj] = fmaf(qv.w, kv[jj].w, s[ii][jj]);
        }
      }
    }

    // Online softmax in log2 units: mask, new row max, rescale what was summed.
#pragma unroll
    for (int ii = 0; ii < RM; ++ii) {
      const int i = q0 + tr * RM + ii;
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + tc + 16 * jj;
        s[ii][jj] = j < Lk && (!causal || j <= i) ? s[ii][jj] * scale_log2 : -INFINITY;
        mt = fmaxf(mt, s[ii][jj]);
      }
      const float mn = fmaxf(m[ii], max16(mt));
      const float base = mn == -INFINITY ? 0.f : mn;  // no key seen yet: no inf - inf
      const float alpha = exp2f(m[ii] - base);
      m[ii] = mn;
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = exp2f(s[ii][jj] - base);
        ps += s[ii][jj];
      }
      l[ii] = l[ii] * alpha + ps;  // this thread's keys only; summed over lanes at the end
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[ii][c][x] *= alpha;
    }
    __syncthreads();  // every thread is done reading K: P goes over it
#pragma unroll
    for (int ii = 0; ii < RM; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sp[(tr * RM + ii) * kBKP + tc + 16 * jj] = s[ii][jj];
    __syncthreads();

    // acc += P V over this tile's keys (probabilities past n_keys are 0).
    const int kend = min(kBK, n_keys - j0);
    for (int j = 0; j < kend; j += 4) {
      float4 pv[RM];
#pragma unroll
      for (int ii = 0; ii < RM; ++ii)
        pv[ii] = *reinterpret_cast<const float4*>(sp + (tr * RM + ii) * kBKP + j);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(sv + (j + t) * WP + 64 * c + 4 * tc);
#pragma unroll
          for (int ii = 0; ii < RM; ++ii) {
            const float p = lane(pv[ii], t);
            acc[ii][c][0] = fmaf(p, vv.x, acc[ii][c][0]);
            acc[ii][c][1] = fmaf(p, vv.y, acc[ii][c][1]);
            acc[ii][c][2] = fmaf(p, vv.z, acc[ii][c][2]);
            acc[ii][c][3] = fmaf(p, vv.w, acc[ii][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < RM; ++ii) {
    const float inv = 1.f / sum16(l[ii]);
    const int i = q0 + tr * RM + ii;
    if (i >= Lq) continue;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = 64 * c + 4 * tc + x;
        if (d < D) ob[(size_t)i * vrow + d] = from_f32<T>(acc[ii][c][x] * inv);
      }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Lq, Lk, E, D;
  float scale_log2;
  int causal;
};

template <typename T, int W, int RM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BQ = 16 * RM;
  const size_t smem = sizeof(float) * (size_t)(BQ + 2 * kBK) * (W + 4);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(mha_attention_fwd_kernel<T, W, RM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)((a.Lq + BQ - 1) / BQ) * a.B * a.H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  mha_attention_fwd_kernel<T, W, RM><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.H, a.Lq, a.Lk, a.E, a.D, a.scale_log2, a.causal);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  if (a.Lq <= 16) return launch<T, W, 1>(a, stream);
  if (a.Lq <= 32) return launch<T, W, 2>(a, stream);
  return launch<T, W, 4>(a, stream);
}

template <typename T>
cudaError_t launch_width(const Args& a, cudaStream_t stream) {
  return max(a.E, a.D) <= 64 ? launch_rows<T, 64>(a, stream) : launch_rows<T, 128>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q [B, Lq, H, E],
// k [B, Lk, H, E], v [B, Lk, H, D], o [B, Lq, H, D]. Returns a cudaError_t (0
// on success); launches on `stream` and does not synchronise.
extern "C" int mha_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                 int H, int Lq, int Lk, int E, int D, float scale, int causal,
                                 int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || E <= 0 || E > kMaxW || D <= 0 || D > kMaxW)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, H, Lq, Lk, E, D, scale * kLog2e, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_width<float>(a, s);
    case 1: return (int)launch_width<__nv_bfloat16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
