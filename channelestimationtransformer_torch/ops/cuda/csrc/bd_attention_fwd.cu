// Block-diagonal attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ops/pallas/bd_attention.py:_fwd_kernel (launched by
// _fwd_call) of channelestimationtransformer_tpu. For each (batch, head):
//
//     out = dropout(softmax(scale * Q K^T, masked)) V
//
// over [B, L, H, E] tensors (E == D), f32, bf16 or f16 in, f32 softmax and
// accumulation, output in the input dtype. Keys at positions >= l_k do not
// exist here (no padding in device memory); with `causal`, key column >
// query row is excluded. With a seed (training), probabilities are dropped
// by the Philox mask of bd_attention_common.cuh and kept ones scaled by
// 1 / keep_prob, and the row log-sum-exp lse [B, H, Lq] (f32) may be
// written for the backward kernel.
//
// The TPU kernel packs all H heads into one block-diagonal [Lq, H*128]
// matmul to fill the 128-wide MXU, doing ~8x the needed FLOPs. None of that
// is carried over.
//
// Bound on an H100 SXM (3.35 TB/s; products at 165 TFLOP/s in f32, the
// split-TF32 rate of the tensor cores, 495 / 3, and at 989 in bf16): at the
// flagship encoder shape (B 256, H 8, E 16, Lq = Lk = 90) the call reads Q,
// K, V and writes O once: 47.2 MB in f32, 14.1 us, and 23.6 MB in bf16,
// 7.0 us; its 4*B*H*Lq*Lk*E = 1.06 GFLOP take 6.4 us in f32 and 1.1 in
// bf16. So bytes bound every call of the path.
//
// Design. A block takes one (b, h) and a slab of up to 128 query rows, with
// one warp per 16 rows (at the flagship: 6 warps at L 90, 3 at L 45, 2 at
// L 23, 1 at L 12 and 15). The block stages its Q slab and all the head's
// K and V rows (Lk <= 128) in shared memory in the input dtype, by 16-byte
// cp.async where rows are 16-byte multiples and by plain loads otherwise
// (E 20 or 22 in bf16, say); rows past the ends are zero-filled, columns
// padded to EP = 16, 32 or 64 with zeros. A block of several heads of one
// b (coalesced [H, E] rows, up to 8 warps) was tried and measured no faster
// at any of the path's shapes (PERF.md), so it went. Since Lk <= 128, a
// warp holds all NK scores of its 16 rows in registers (NK = Lk rounded up
// to 16, 32, 48, 64, 96 or 128, a compile-time width: no runtime-bounded
// loop around mma.sync), so the softmax is exact in one pass: S = Q K^T
// once, the row max and sum over the quad of lanes that share a row, P in
// place, and O = P V with the C fragments of S as the A fragments of P.
// The dtype is a template parameter (the instances are (dtype, EP, NK)),
// and each has its own products (mma_tf32.cuh):
//   f32: split-TF32, three TF32 MMAs a product (f32 accuracy), in the k
//   order (2t, 2t + 1), so a C fragment of S is the A fragment of P in
//   place; Q and K rows pitched EP + 8 floats, V EP + 4.
//   bf16: rows staged as bf16. S = Q K^T takes one bf16 MMA (m16n8k16) a
//   product and is exact (bf16 products are exact in f32). P is split
//   into bf16 hi + lo (hi = bf16(p), lo = bf16(p - hi): ~16 bits) and P V
//   takes two MMAs; the row max, the row sum and lse stay f32. One
//   rounding of P (8 bits, as the TPU's MXU rounds it at default
//   precision) keeps this output within its bf16 tolerance, but moves O,
//   and through D = rowsum(dO * O) the backward fed by it, against the
//   plain backward on the plain forward's O and lse, up to 1.58x past
//   rtol/atol 1e-2 at B 256 (tests/test_torch_bf16_mma.py; chip_smoke.py
//   holds that pair). Q and K fragments are 32-bit loads, V's come by
//   ldmatrix.trans; all three tiles are pitched EP + 8 elements.
//   f16: the bf16 instance's code with f16 MMAs (m16n8k16 .f16), except
//   that P is rounded to f16 once (one MMA): with 3 more significant bits
//   than bf16 one rounding keeps the output, and the backward fed by it,
//   within the f16 tolerance (rtol/atol 2e-3 forward, 4e-3 backward) at
//   about a third of it at B 256 (tests/test_torch_f16_mma.py). P lies in
//   [0, 1], within f16's range.
// The dropout bits are drawn in registers where they are used: the two
// lanes that share a 4-key group of a warp's rows i0 and i1 each make one
// row's Philox call (keyed as in the backward, which regenerates them) and
// swap, so every call is made once, with no shared-memory stage, no barrier
// and no index arithmetic. The copy route is a runtime switch outside the
// products.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// attention_ablation.py; numbers in PERF.md): the f32 instance at about
// half the time of the CUDA-core kernel this replaces (a thread per query
// row reading K and V as broadcast float4 loads and recomputing the scores
// in a second pass), ~186 us for a training step's 13 calls, most of it
// in the products with their operand splits and a third in the Philox
// bits at L 90; at 116 registers a thread two 6-warp blocks share an SM
// there. Staging the bits per slab in shared memory, as the backward does,
// was slower. The bf16 instance ~153 us a step, against ~194 for its
// earlier datapath (rows staged as f32, split-TF32 products); at L 90 it
// takes ~57 us, ~23 of them in the Philox bits, at 96 registers and three
// blocks an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// Row pitches (elements) of the shared tiles Q [QS], K [NK] and V [NK]. f32:
// Q and K EP + 8, so the 8-byte fragment loads of 8 rows x 4 lanes hit
// distinct banks, V EP + 4 for the 4-byte loads of rows 2t and 2t + 1.
// bf16 and f16: EP + 8 for all three (mma_tf32.cuh).
template <typename T, int EP>
struct Pitch {
  static constexpr int q = EP + 8, k = EP + 8, v = sizeof(T) == 4 ? EP + 4 : EP + 8;
};

template <typename T, int EP>
constexpr size_t smem_bytes(int nk, int qs) {
  using P = Pitch<T, EP>;
  return sizeof(T) * (size_t)(qs * P::q + nk * (P::k + P::v));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Elements `p[0]` and `p[1]` of the output (the second only if `both`): one
// 8-byte or 4-byte store where E is even, so `p` is aligned for it.
__device__ __forceinline__ void store2(float* p, float x0, float x1, bool both, bool even) {
  if (both && even) *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  else {
    p[0] = x0;
    if (both) p[1] = x1;
  }
}

template <typename H>
__device__ __forceinline__ void store2(H* p, float x0, float x1, bool both, bool even) {
  if (both && even) *reinterpret_cast<uint32_t*>(p) = pack_b16<H>(x0, x1);
  else {
    p[0] = from_f32<H>(x0);
    if (both) p[1] = from_f32<H>(x1);
  }
}

// Columns E .. EP - 1 of `rows` rows from `dst`.
template <typename T>
__device__ __forceinline__ void zero_pad(T* dst, int pitch, int rows, int E, int EP) {
  const int w = EP - E;
  for (int x = threadIdx.x; x < rows * w; x += blockDim.x) {
    const int r = x / w;
    dst[r * pitch + E + (x - r * w)] = from_f32<T>(0.f);
  }
}

// s[n] = Q K^T for the warp's 16 rows (qa: the first) and keys 8n .. 8n + 7,
// over all EP columns (those past E are zero). f32: split-TF32.
template <int EP, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* qa, const float* ks,
                                       int g, int t) {
  constexpr int QP = Pitch<float, EP>::q, KP = Pitch<float, EP>::k;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < EP / 8; ++kk) {
    const float* qr = qa + g * QP + 8 * kk + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(qr);
    const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * QP);
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
}

// bf16 and f16 (H): one MMA a 16-column step and 8 keys, exact products.
template <int EP, int NT, typename H>
__device__ __forceinline__ b16_void<H> scores(float (&s)[NT][4], const H* qa, const H* ks,
                                              int g, int t) {
  constexpr int QP = Pitch<H, EP>::q, KP = Pitch<H, EP>::k;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < EP / 16; ++kk) {
    uint32_t a[4];
    frag_a_b16(a, qa + g * QP + 16 * kk + 2 * t, QP);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b[2];
      frag_b_b16(b, ks + (8 * n + g) * KP + 16 * kk + 2 * t);
      mma_b16<H>(s[n], a, b);
    }
  }
}

// acc[n] = P V for output columns 8n .. 8n + 7; s holds P in C-fragment
// order. f32: split-TF32, the C fragment of S is the A fragment of P
// (k column t <-> key 2t).
template <int EP, int NT>
__device__ __forceinline__ void pv(float (&acc)[EP / 8][4], const float (&s)[NT][4],
                                   const float* vs, int g, int t, int) {
  constexpr int VP = Pitch<float, EP>::v, NE = EP / 8;
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
}

// bf16: P split into bf16 hi and lo (two MMAs); f16: P rounded once (one
// MMA). The C fragments of two 8-key tiles are the A fragments of a 16-key
// step; V's B fragments come by ldmatrix.trans.
template <int EP, int NT, typename H>
__device__ __forceinline__ b16_void<H> pv(float (&acc)[EP / 8][4], const float (&s)[NT][4],
                                          const H* vs, int, int, int lane) {
  constexpr int VP = Pitch<H, EP>::v, NE = EP / 8;
#pragma unroll
  for (int n = 0; n < NE; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[4], lo[4];
    operand_from_c<H>(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < NE; n += 2) {
      uint32_t b0[2], b1[2];
      frag_b2_trans_b16(b0, b1, vs + 16 * kk * VP + 8 * n, VP, lane);
      mma_operand<H>(acc[n], hi, lo, b0);
      mma_operand<H>(acc[n + 1], hi, lo, b1);
    }
  }
}

// T: float, __nv_bfloat16 or __half; EP: E padded to 16, 32 or 64; NK:
// keys padded to a multiple of 16 (>= Lk). vec: rows by 16-byte cp.async.
// Lane = 4 * g + t (mma_tf32.cuh). Two blocks an SM (<= 128 registers a thread) where
// the scores and the accumulators fit in that; one above, where 128 would
// spill.
template <typename T, int EP, int NK>
__global__ void __launch_bounds__(32 * kMaxWarps, EP * NK >= 2048 ? 1 : 2)
bd_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, const long long* __restrict__ seed, int H,
                        int n_slabs, int Lq, int Lk, int E, int QS, float scale,
                        int causal, unsigned thresh, float inv_keep, int vec) {
  using P = Pitch<T, EP>;
  constexpr int NT = NK / 8;  // 8-key tiles of a score row
  constexpr int NE = EP / 8;  // 8-column tiles of a head row
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* ks = qs + QS * P::q;
  T* vs = ks + NK * P::k;

  const int slab = blockIdx.x % n_slabs, bhi = blockIdx.x / n_slabs;  // bhi = b * H + h
  const int b = bhi / H, h = bhi - b * H;
  const int s0 = slab * QS, rows = min(QS, Lq - s0);
  const size_t row = (size_t)H * E;  // stride between sequence positions
  const size_t q_off = ((size_t)b * Lq + s0) * row + (size_t)h * E;
  const size_t k_off = (size_t)b * Lk * row + (size_t)h * E;

  // The pad columns, then the copies (disjoint addresses: no barrier between).
  if (E < EP) {
    zero_pad(qs, P::q, QS, E, EP);
    zero_pad(ks, P::k, NK, E, EP);
    zero_pad(vs, P::v, NK, E, EP);
  }
  auto load = [&](T* dst, int pitch, const T* src, int n, int valid) {
    if (vec) load_rows<true>(dst, pitch, src, row, n, valid, E, threadIdx.x, blockDim.x);
    else load_rows<false>(dst, pitch, src, row, n, valid, E, threadIdx.x, blockDim.x);
  };
  load(qs, P::q, q + q_off, QS, rows);
  load(ks, P::k, k + k_off, NK, Lk);
  load(vs, P::v, v + k_off, NK, Lk);
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
  scores<EP>(s, qs + lr0 * P::q, ks, g, t);

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

  // O = P V.
  float acc[NE][4];
  pv<EP>(acc, s, vs, g, t, lane);

  const float keep_scale = dropout ? inv_keep : 1.f;
  const float inv[2] = {keep_scale / l0, keep_scale / l1};
#pragma unroll
  for (int n = 0; n < NE; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // row i0 (c 0, 1), then i1 (c 2, 3)
      const int i = half ? i1 : i0, e = 8 * n + 2 * t, c = 2 * half;
      if (i < Lq && e < E)
        store2(o + q_off + (size_t)(i - s0) * row + e, acc[n][c] * inv[half],
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
  int* occ;  // set: report the launch's occupancy into it and launch nothing
};

template <typename T, int EP, int NK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int qs = min((a.Lq + 15) & ~15, kMaxSlab);
  const size_t smem = smem_bytes<T, EP>(NK, qs);
  auto kernel = bd_attention_fwd_kernel<T, EP, NK>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = 32 * (qs / 16);  // a warp per 16 rows
  if (a.occ != nullptr) return occupancy(kernel, threads, smem, a.occ);
  const int n_slabs = (a.Lq + qs - 1) / qs;
  const long long blocks = (long long)a.B * a.H * n_slabs;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int C = 16 / sizeof(T);  // elements of a 16-byte piece
  const bool vec = a.E % C == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.seed, a.H, n_slabs, a.Lq, a.Lk, a.E, qs, a.scale,
      a.causal, a.thresh, a.inv_keep, vec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, int EP>
cudaError_t launch_k(const Args& a, cudaStream_t stream) {
  if (a.Lk <= 16) return launch<T, EP, 16>(a, stream);
  if (a.Lk <= 32) return launch<T, EP, 32>(a, stream);
  if (a.Lk <= 48) return launch<T, EP, 48>(a, stream);
  if (a.Lk <= 64) return launch<T, EP, 64>(a, stream);
  if (a.Lk <= 96) return launch<T, EP, 96>(a, stream);
  return launch<T, EP, 128>(a, stream);
}

template <typename T>
cudaError_t launch_e(const Args& a, cudaStream_t stream) {
  if (a.E <= 16) return launch_k<T, 16>(a, stream);
  if (a.E <= 32) return launch_k<T, 32>(a, stream);
  return launch_k<T, 64>(a, stream);
}

cudaError_t dispatch(const Args& a, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_e<float>(a, stream);
    case 1: return launch_e<__nv_bfloat16>(a, stream);
    default: return launch_e<__half>(a, stream);
  }
}

bool invalid(int B, int H, int Lq, int Lk, int E, int dtype) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxLk || E <= 0 || E > kMaxE ||
         dtype < 0 || dtype > 2;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. `lse` may be null (not
// written); `seed` null means no dropout, else keep iff the Philox word < `thresh` and scale
// kept probabilities by `inv_keep`. Returns a cudaError_t (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int bd_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                float* lse, const long long* seed, int B, int H, int Lq,
                                int Lk, int E, float scale, int causal, unsigned thresh,
                                float inv_keep, int dtype, void* stream) {
  if (invalid(B, H, Lq, Lk, E, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, seed, B, H, Lq, Lk, E, scale, causal, thresh, inv_keep, nullptr};
  return (int)dispatch(a, dtype, static_cast<cudaStream_t>(stream));
}

// The instance and launch that bd_attention_fwd takes at these sizes, not
// launched: out[5] as occupancy() in bd_attention_common.cuh. Returns a
// cudaError_t.
extern "C" int bd_attention_fwd_occupancy(int B, int H, int Lq, int Lk, int E, int dtype,
                                          int* out) {
  if (invalid(B, H, Lq, Lk, E, dtype) || out == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, H, Lq, Lk, E,
               1.f, 0, 0u, 1.f, out};
  return (int)dispatch(a, dtype, nullptr);
}
