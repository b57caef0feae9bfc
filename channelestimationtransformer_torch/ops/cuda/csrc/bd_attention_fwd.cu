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
// bd_attention_common.cuh and kept ones scaled by 1 / keep_prob, and the row
// log-sum-exp lse [B, H, Lq] (f32) may be written for the backward kernel.
//
// The TPU kernel packs all H heads into one block-diagonal [Lq, H*128]
// matmul to fill the 128-wide MXU, doing ~8x the needed FLOPs. None of that
// is carried over.
//
// Bound on an H100 SXM (3.35 TB/s; f32 products at 165 TFLOP/s, the
// split-TF32 rate of the tensor cores, 495 / 3): at the flagship encoder
// shape (B 256, H 8, E 16, Lq = Lk = 90, f32) the call reads Q, K, V and
// writes O once: 4 B * B*H*E*(2*Lq + 2*Lk) = 47.2 MB, 14.1 us; its
// 4*B*H*Lq*Lk*E = 1.06 GFLOP take 6.4 us. So bytes bound every call of the
// path.
//
// Design. A block takes one (b, h) and a slab of up to 128 query rows, with
// one warp per 16 rows (at the flagship: 6 warps at L 90, 3 at L 45, 2 at
// L 23, 1 at L 12 and 15). The block stages its Q slab and all the head's
// K and V rows (Lk <= 128) in shared memory as f32, in 16-byte pieces where
// rows are 16-byte multiples (f32 by cp.async, bf16 by vector loads
// converted on the way) and by plain loads otherwise (E 20 or 22, say);
// rows past the ends are zero-filled, columns padded to EP = 16, 32 or 64
// with zeros. A block of several heads of one b (coalesced [H, E] rows,
// up to 8 warps) was tried and measured no faster at any of the path's
// shapes (PERF.md), so it went. Since Lk <= 128, a warp
// holds all NK scores of its 16 rows in registers (NK = Lk rounded up to
// 16, 32, 48, 64, 96 or 128, a compile-time width: no runtime-bounded loop
// around mma.sync), so the softmax is exact in one pass: S = Q K^T once, the
// row max and sum over the quad of lanes that share a row, P in place, and
// O = P V with the C fragment of S as the A fragment of P in the k order
// (2t, 2t + 1) of mma_tf32.cuh. Every product is split-TF32 (three TF32
// MMAs, f32 accuracy); bf16 inputs are staged as f32 (bf16 is exact in
// TF32) and take the same products, as the backward does. The dropout
// bits are drawn in registers where they are used: the two lanes that
// share a 4-key group of a warp's rows i0 and i1 each make one row's
// Philox call (keyed as in the backward, which regenerates them) and swap,
// so every call is made once, with no shared-memory stage, no barrier and
// no index arithmetic. The dtype and the copy route are runtime switches
// outside the products, so the instances are (EP, NK) only.
//
// Measured on an NVIDIA H100 (chip_smoke.py, attention_ablation.py; numbers
// in PERF.md): about half the time of the CUDA-core kernel this replaces
// (a thread per query row reading K and V as broadcast float4 loads and
// recomputing the scores in a second pass), most of it in the products
// with their operand splits and a third in the Philox bits at L 90. The
// products look latency-bound: at 127 registers a thread two 6-warp blocks
// share an SM at L 90. Staging the bits per slab in shared memory, as the
// backward does, was slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bd_attention_common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxLk = 128;              // key length limit (the TPU kernel's LP)
constexpr int kMaxE = 64;                // head width limit
constexpr int kMaxSlab = 128;            // query rows a block
constexpr int kMaxWarps = kMaxSlab / 16;  // warps a block
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block: Q [QS][EP + 8], K [NK][EP + 8], V [NK][EP + 4]
// floats. The Q and K pitches make the 8-byte fragment loads of 8 rows x
// 4 lanes hit distinct banks, V's the 4-byte loads of rows 2t and 2t + 1.
constexpr size_t smem_bytes(int ep, int nk, int qs) {
  return sizeof(float) * (size_t)(qs * (ep + 8) + nk * (ep + 8) + nk * (ep + 4));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One 16-byte piece into shared memory as f32: 4 floats by cp.async, or
// 8 bf16 by one vector load, converted and stored as two float4. `ok`
// false writes zeros and reads nothing.
__device__ __forceinline__ void copy16(float* d, const float* s, bool ok) { cp_async16(d, s, ok); }
__device__ __forceinline__ void copy16(float* d, const __nv_bfloat16* s, bool ok) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (ok) {
    const uint4 u = *reinterpret_cast<const uint4*>(s);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
    const float2 c = __bfloat1622float2(p[2]), e = __bfloat1622float2(p[3]);
    lo = make_float4(a.x, a.y, b.x, b.y);
    hi = make_float4(c.x, c.y, e.x, e.y);
  }
  reinterpret_cast<float4*>(d)[0] = lo;
  reinterpret_cast<float4*>(d)[1] = hi;
}

// `rows` rows of E elements, row r from src + r * stride, into shared rows
// of `pitch` floats as f32; rows >= valid become zero, columns past E are
// not written. vec: 16-byte pieces (E a multiple of 16 bytes, 16-byte
// aligned), with one division a call when the pieces of a row divide the
// thread count; else plain loads of T.
template <typename T>
__device__ __forceinline__ void load_head(float* dst, int pitch, const T* src, size_t stride,
                                          int rows, int valid, int E, bool vec) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (vec) {
    constexpr int C = 16 / sizeof(T);  // elements a piece
    const int chunks = E / C;
    if (nthreads % chunks == 0) {
      const int c = (tid % chunks) * C;
      for (int r = tid / chunks; r < rows; r += nthreads / chunks) {
        const bool ok = r < valid;
        copy16(dst + r * pitch + c, src + (ok ? r * stride + c : 0), ok);
      }
      return;
    }
    for (int x = tid; x < rows * chunks; x += nthreads) {
      const int r = x / chunks, c = (x - r * chunks) * C;
      const bool ok = r < valid;
      copy16(dst + r * pitch + c, src + (ok ? r * stride + c : 0), ok);
    }
  } else {
    for (int x = tid; x < rows * E; x += nthreads) {
      const int r = x / E, c = x - r * E;
      dst[r * pitch + c] = r < valid ? to_f32(src[r * stride + c]) : 0.f;
    }
  }
}

// Elements `at` and `at + 1` of the output (the second only if `both`): one
// 8-byte or 4-byte store where E is even, so `at` is too.
__device__ __forceinline__ void store2(void* o, int dtype, size_t at, float x0, float x1,
                                       bool both, bool even) {
  if (dtype == 0) {
    float* p = static_cast<float*>(o) + at;
    if (both && even) *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    else {
      p[0] = x0;
      if (both) p[1] = x1;
    }
  } else {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(o) + at;
    if (both && even) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
    else {
      p[0] = __float2bfloat16(x0);
      if (both) p[1] = __float2bfloat16(x1);
    }
  }
}

// Columns E .. EP - 1 of `rows` rows from `dst`.
__device__ __forceinline__ void zero_pad(float* dst, int pitch, int rows, int E, int EP) {
  const int w = EP - E;
  for (int x = threadIdx.x; x < rows * w; x += blockDim.x) {
    const int r = x / w;
    dst[r * pitch + E + (x - r * w)] = 0.f;
  }
}

// EP: E padded to 16, 32 or 64; NK: keys padded to a multiple of 16 (>= Lk).
// dtype 0 = f32, 1 = bf16. Lane = 4 * g + t (mma_tf32.cuh).
// Two blocks an SM (<= 128 registers a thread) where the scores and the
// accumulators fit in that; one above, where 128 would spill.
template <int EP, int NK>
__global__ void __launch_bounds__(32 * kMaxWarps, EP * NK >= 2048 ? 1 : 2)
bd_attention_fwd_kernel(const void* __restrict__ q_, const void* __restrict__ k_,
                        const void* __restrict__ v_, void* __restrict__ o_,
                        float* __restrict__ lse, const long long* __restrict__ seed, int H,
                        int n_slabs, int Lq, int Lk, int E, int QS, float scale,
                        int causal, unsigned thresh, float inv_keep, int dtype, int vec) {
  constexpr int QP = EP + 8, KP = EP + 8, VP = EP + 4;
  constexpr int NT = NK / 8;  // 8-key tiles of a score row
  constexpr int NE = EP / 8;  // 8-column tiles of a head row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + QS * QP;
  float* vs = ks + NK * KP;

  const int slab = blockIdx.x % n_slabs, bhi = blockIdx.x / n_slabs;  // bhi = b * H + h
  const int b = bhi / H, h = bhi - b * H;
  const int s0 = slab * QS, rows = min(QS, Lq - s0);
  const size_t row = (size_t)H * E;  // stride between sequence positions
  const size_t q_off = ((size_t)b * Lq + s0) * row + (size_t)h * E;
  const size_t k_off = (size_t)b * Lk * row + (size_t)h * E;

  // The pad columns, then the copies (disjoint addresses: no barrier between).
  if (E < EP) {
    zero_pad(qs, QP, QS, E, EP);
    zero_pad(ks, KP, NK, E, EP);
    zero_pad(vs, VP, NK, E, EP);
  }
  auto load = [&](float* dst, int pitch, const void* src, size_t off, int n, int valid) {
    if (dtype == 0)
      load_head(dst, pitch, static_cast<const float*>(src) + off, row, n, valid, E, vec != 0);
    else
      load_head(dst, pitch, static_cast<const __nv_bfloat16*>(src) + off, row, n, valid, E,
                vec != 0);
  };
  load(qs, QP, q_, q_off, QS, rows);
  load(ks, KP, k_, k_off, NK, Lk);
  load(vs, VP, v_, k_off, NK, Lk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the last barrier: a warp with no rows may leave

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = 16 * warp;
  if (lr0 >= rows) return;
  const int i0 = s0 + lr0 + g, i1 = i0 + 8;

  // S = Q K^T over all NK keys (those past Lk are zero rows, masked below).
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NE; ++kk) {
    const float* qa = qs + (lr0 + g) * QP + 8 * kk + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(qa);
    const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * QP);
    uint32_t ah[4], al[4];
    split_tf32({x0.x, x1.x, x0.y, x1.y}, ah, al);  // k column t <-> element 2t
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(ks + (8 * n + g) * KP + 8 * kk + 2 * t);
      uint32_t bh[2], bl[2];
      split_tf32({y.x, y.y}, bh, bl);
      mma_split_tf32(s[n], ah, al, bh, bl);
    }
  }

  // Softmax of rows i0 (c 0, 1) and i1 (c 2, 3), exact: every key is here.
  const int lim0 = causal ? min(Lk, i0 + 1) : Lk, lim1 = causal ? min(Lk, i1 + 1) : Lk;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 8 * n + 2 * t + (c & 1);
      s[n][c] = j < (c < 2 ? lim0 : lim1) ? s[n][c] * scale : -INFINITY;
      if (c < 2) m0 = fmaxf(m0, s[n][c]);
      else m1 = fmaxf(m1, s[n][c]);
    }
  m0 = quad_max(m0);  // key 0 is visible to every row: finite
  m1 = quad_max(m1);
  // Dropout: the lane pair (t, t ^ 1) shares a 4-key group of rows i0 and
  // i1; the even lane draws row i0's bits, the odd lane row i1's (one
  // Philox call each, keyed as keep_bits4 is), and they swap.
  const bool dropout = seed != nullptr;
  const uint2 key = dropout ? philox_key(seed) : make_uint2(0u, 0u);
  const int my_row = t & 1 ? i1 : i0, my_lim = t & 1 ? lim1 : lim0, sh = 2 * (t & 1);
  const float ml0 = m0 * kLog2e, ml1 = m1 * kLog2e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    unsigned nib0 = 0xfu, nib1 = 0xfu;  // keep bits of the group, rows i0 and i1
    if (dropout) {
      const int j0 = 8 * n + 4 * (t >> 1);  // the group of keys 8n + 2t, 8n + 2t + 1
      const unsigned mine =
          j0 < my_lim ? keep_bits4(j0, my_row, bhi, key, thresh) : 0u;
      const unsigned other = __shfl_xor_sync(0xffffffffu, mine, 1);
      nib0 = t & 1 ? other : mine;
      nib1 = t & 1 ? mine : other;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // exp(s - m) as exp2: masked scores are -inf, exp2(-inf) = 0.
      const float p = exp2f(fmaf(s[n][c], kLog2e, -(c < 2 ? ml0 : ml1)));
      if (c < 2) l0 += p;
      else l1 += p;
      s[n][c] = (((c < 2 ? nib0 : nib1) >> (sh + (c & 1))) & 1u) ? p : 0.f;
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // O = P V: the C fragment of S is the A fragment of P (k column t <-> key 2t).
  float acc[NE][4];
#pragma unroll
  for (int n = 0; n < NE; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    uint32_t ah[4], al[4];
    split_tf32({s[jn][0], s[jn][2], s[jn][1], s[jn][3]}, ah, al);
    const float* v0 = vs + (8 * jn + 2 * t) * VP + g;
#pragma unroll
    for (int n = 0; n < NE; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32({v0[8 * n], v0[VP + 8 * n]}, bh, bl);
      mma_split_tf32(acc[n], ah, al, bh, bl);
    }
  }

  const float keep_scale = dropout ? inv_keep : 1.f;
  const float inv[2] = {keep_scale / l0, keep_scale / l1};
#pragma unroll
  for (int n = 0; n < NE; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // row i0 (c 0, 1), then i1 (c 2, 3)
      const int i = half ? i1 : i0, e = 8 * n + 2 * t, c = 2 * half;
      if (i < Lq && e < E)
        store2(o_, dtype, q_off + (size_t)(i - s0) * row + e, acc[n][c] * inv[half],
               acc[n][c + 1] * inv[half], e + 1 < E, E % 2 == 0);
    }
  if (lse != nullptr && t == 0) {
    const size_t at = (size_t)bhi * Lq;
    if (i0 < Lq) lse[at + i0] = m0 + logf(l0);
    if (i1 < Lq) lse[at + i1] = m1 + logf(l1);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const long long* seed;
  int B, H, Lq, Lk, E;
  float scale;
  int causal;
  unsigned thresh;
  float inv_keep;
  int dtype;
};

template <int EP, int NK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int qs = min((a.Lq + 15) & ~15, kMaxSlab);
  const size_t smem = smem_bytes(EP, NK, qs);
  auto kernel = bd_attention_fwd_kernel<EP, NK>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_slabs = (a.Lq + qs - 1) / qs;
  const long long blocks = (long long)a.B * a.H * n_slabs;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool vec = a.E % (a.dtype == 0 ? 4 : 8) == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v);
  kernel<<<(unsigned)blocks, 32 * (qs / 16), smem, stream>>>(  // a warp per 16 rows
      a.q, a.k, a.v, a.o, a.lse, a.seed, a.H, n_slabs, a.Lq, a.Lk, a.E, qs, a.scale,
      a.causal, a.thresh, a.inv_keep, a.dtype, vec ? 1 : 0);
  return cudaGetLastError();
}

template <int EP>
cudaError_t launch_k(const Args& a, cudaStream_t stream) {
  if (a.Lk <= 16) return launch<EP, 16>(a, stream);
  if (a.Lk <= 32) return launch<EP, 32>(a, stream);
  if (a.Lk <= 48) return launch<EP, 48>(a, stream);
  if (a.Lk <= 64) return launch<EP, 64>(a, stream);
  if (a.Lk <= 96) return launch<EP, 96>(a, stream);
  return launch<EP, 128>(a, stream);
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
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxLk || E <= 0 || E > kMaxE ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, seed, B, H, Lq, Lk, E, scale, causal, thresh, inv_keep, dtype};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 16) return (int)launch_k<16>(a, s);
  if (E <= 32) return (int)launch_k<32>(a, s);
  return (int)launch_k<64>(a, s);
}
