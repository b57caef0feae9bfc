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
// or bf16 in, f32 accumulation, output in the input dtype. With `causal` the
// mask is top-left aligned: key j is kept for query i iff j <= i (the TPU
// kernels' mask and full_attention's triu(1)), also when Lq != Lk.
//
// Bound on an H100 SXM (3.35 TB/s; f32 products at 165 TFLOP/s, the
// split-TF32 rate of the tensor cores, 495 / 3): at the xl model's encoder
// shape (B 64, H 8, E = D = 128, Lq = Lk = 256, f32) the call reads Q, K, V
// and writes O once, 268 MB, 80 us; it does 4*B*H*Lq*Lk*E = 17.2 GFLOP,
// 104 us. So operations bound the long calls; the xl model's shorter calls
// (L 128 and below, the 15-row decoder calls) are bound by bytes.
//
// Design (FlashAttention-2 on mma.sync). A warp owns 16 query rows, the m16
// of the MMA. Scores S = Q K^T, the online softmax (row max and sum over the
// quad of 4 lanes that share a row of the C fragment) and O += P V all stay
// in registers; the [Lq, Lk] scores never reach memory and any Lk fits. Q
// rows and K and V tiles of BK keys go global -> shared by cp.async, K/V in
// two stages, so the next tile's copy overlaps this tile's MMAs; rows past
// the last key are zero-filled by the copy. WG warps that share a (b, h)
// share its K/V tiles: WG = 4 (64 query rows a block) for Lq > 32, 2 for
// Lq <= 32, and 1 for Lq <= 16, where a block of 4 warps serves 4 (b, h) and
// the xl decoder's 512 (b, h) take 128 blocks, not 512 that each stage a
// 64-key tile for 15 rows. A causal tile stops at its last visible key and
// a warp skips the tiles its rows cannot see. f32 inputs take the
// split-TF32 product (mma_tf32.cuh) for Q K^T and P V; its k order (2t,
// 2t + 1) makes a C fragment of S the A fragment of P in place. bf16 inputs
// take bf16 MMAs, P rounded to bf16 for P V as FlashAttention does, V's B
// fragments by ldmatrix.trans. Where E or D is not a multiple of 16 bytes,
// the tiles are loaded by plain loads instead of cp.async. The products run
// over the padded width W (64 or 128), whose columns past E and D are zero
// in shared memory.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 375.9 us
// at the L 256 shape above, 3.6x its bound (the CUDA-core kernel this
// replaces: 669.4 us); 839.5 us for the xl model's 13 calls a batch, where
// SDPA in f32 takes 1,141.9. attention_ablation.py puts 164 us of the L 256
// call in the loop without MMAs (the K/V tiles from L2) and the rest in the
// split-TF32 products: each warp re-splits the K and V tiles it shares, and
// 8 warps an SM do not hide the MMA and ALU latencies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bd_attention_common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxW = 128;  // head width limit, E and D
constexpr int kStages = 2;  // K/V pipeline stages (3 measured slower: fewer blocks an SM)
constexpr float kLog2e = 1.4426950408889634f;

// Row pitches (elements) of the shared tiles. Q and K rows W + 8: the 8-byte
// (f32) or 4-byte (bf16) fragment loads of 8 rows x 4 lanes hit distinct
// banks. V rows W + 4 for f32 (4-byte loads of rows 2t and 2t + 1) and
// W + 8 for bf16 (ldmatrix rows 16 bytes apart modulo 128).
template <typename T, int W>
struct Pitch {
  static constexpr int q = W + 8, k = W + 8, v = sizeof(T) == 4 ? W + 4 : W + 8;
};

template <int WG>
__device__ __forceinline__ void group_sync(int gi) {
  if constexpr (WG == kWarps) {
    __syncthreads();
  } else if constexpr (WG == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(gi + 1), "n"(WG * 32) : "memory");
  }
}

// s[n] = Q K^T for the warp's 16 rows and keys 8n .. 8n + 7 of the tile,
// over all W columns (those past E are zero). No branch around an MMA: a
// loop bound that the compiler cannot prove warp-uniform costs a
// convergence barrier (BSSY/BSYNC) per MMA group.
template <int NT, int QP, int KP, int W>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* sq, const float* sk,
                                       int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < W / 8; ++ks) {
    const float2 x0 = *reinterpret_cast<const float2*>(sq + g * QP + 8 * ks + 2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(sq + (g + 8) * QP + 8 * ks + 2 * t);
    uint32_t ah[4], al[4];
    split_tf32({x0.x, x1.x, x0.y, x1.y}, ah, al);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(sk + (8 * n + g) * KP + 8 * ks + 2 * t);
      uint32_t bh[2], bl[2];
      split_tf32({y.x, y.y}, bh, bl);
      mma_split_tf32(s[n], ah, al, bh, bl);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int NT, int QP, int KP, int W>
__device__ __forceinline__ void scores(float (&s)[NT][4], const __nv_bfloat16* sq,
                                       const __nv_bfloat16* sk, int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks) {
    const __nv_bfloat16* a = sq + g * QP + 16 * ks + 2 * t;
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * QP), ld32(a + 8), ld32(a + 8 * QP + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* b = sk + (8 * n + g) * KP + 16 * ks + 2 * t;
      const uint32_t bf[2] = {ld32(b), ld32(b + 8)};
      mma_bf16(s[n], af, bf);
    }
  }
}

// acc[n] += P V for output columns 8n .. 8n + 7 (past D: zeros, not
// stored); p is the tile's probabilities in C-fragment order.
template <int NT, int NO, int VP>
__device__ __forceinline__ void pv(float (&acc)[NO][4], const float (&p)[NT][4], const float* sv,
                                   int g, int t, int) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    split_tf32({p[j][0], p[j][2], p[j][1], p[j][3]}, ah, al);  // k column t <-> key 2t
    const float* v0 = sv + (8 * j + 2 * t) * VP + g;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32({v0[8 * n], v0[VP + 8 * n]}, bh, bl);
      mma_split_tf32(acc[n], ah, al, bh, bl);
    }
  }
}

template <int NT, int NO, int VP>
__device__ __forceinline__ void pv(float (&acc)[NO][4], const float (&p)[NT][4],
                                   const __nv_bfloat16* sv, int, int, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const __nv_bfloat16* row = sv + (16 * kk + (lane & 15)) * VP + 8 * (lane >> 4);
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, row + 8 * n);
      mma_bf16(acc[n], a, {r[0], r[1]});
      mma_bf16(acc[n + 1], a, {r[2], r[3]});
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared elements of one group: its Q rows and the stages of K and V tiles.
template <typename T, int W, int WG, int BK>
__host__ __device__ constexpr int group_elems() {
  using P = Pitch<T, W>;
  return 16 * WG * P::q + kStages * BK * (P::k + P::v);
}

// W: padded head width (64 or 128); WG: warps sharing a (b, h); BK: keys a
// tile; VEC: tiles by 16-byte cp.async.
template <typename T, int W, int WG, int BK, bool VEC>
__global__ void __launch_bounds__(kThreads)
mha_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int BH, int H, int Lq,
                         int Lk, int E, int D, float scale_log2, int causal) {
  using P = Pitch<T, W>;
  constexpr int BQ = 16 * WG;
  constexpr int G = kWarps / WG;  // groups a block
  constexpr int NT = BK / 8;      // key n-tiles of a score tile
  constexpr int NO = W / 8;       // output n-tiles
  constexpr int GE = group_elems<T, W, WG, BK>();
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = warp / WG, wi = warp - gi * WG;
  const int gtid = threadIdx.x - gi * WG * 32;
  const int g = lane >> 2, t = lane & 3;
  T* sq = reinterpret_cast<T*>(smem4) + gi * GE;  // [BQ][P::q]
  T* sk = sq + BQ * P::q;                           // [kStages][BK][P::k]
  T* sv = sk + kStages * BK * P::k;                      // [kStages][BK][P::v]

  const int n_qt = (Lq + BQ - 1) / BQ;
  const int item = blockIdx.x * G + gi;
  if (item >= BH * n_qt) return;  // a spare group (G > 1): its barrier is its own
  const int bh = item / n_qt, q0 = (item - bh * n_qt) * BQ;
  const int b = bh / H, h = bh - b * H;
  const size_t krow = (size_t)H * E, vrow = (size_t)H * D;  // position strides
  const T* qb = q + ((size_t)b * Lq + q0) * krow + (size_t)h * E;
  const T* kb = k + (size_t)b * Lk * krow + (size_t)h * E;
  const T* vb = v + (size_t)b * Lk * vrow + (size_t)h * D;
  T* ob = o + (size_t)b * Lq * vrow + (size_t)h * D;

  // The copies write columns < E (K, Q) and < D (V) and zero-fill rows past
  // the last key or query; the pad columns up to W are zeroed here once.
  if (E < W || D < W) {
    for (int x = gtid; x < (BQ + kStages * BK) * W; x += WG * 32) {
      const int r = x / W, c = x - r * W;
      if (r < BQ) {
        if (c >= E) sq[r * P::q + c] = from_f32<T>(0.f);
      } else {
        if (c >= E) sk[(r - BQ) * P::k + c] = from_f32<T>(0.f);
        if (c >= D) sv[(r - BQ) * P::v + c] = from_f32<T>(0.f);
      }
    }
    group_sync<WG>(gi);
  }

  const int n_keys = causal ? min(Lk, q0 + BQ) : Lk;
  const int n_tiles = (n_keys + BK - 1) / BK;
  auto load_tile = [&](int tile) {
    const int st = tile % kStages, j0 = tile * BK;
    load_rows<VEC>(sk + st * BK * P::k, P::k, kb + j0 * krow, krow, BK, n_keys - j0, E, gtid,
                   WG * 32);
    load_rows<VEC>(sv + st * BK * P::v, P::v, vb + j0 * vrow, vrow, BK, n_keys - j0, D, gtid,
                   WG * 32);
  };
  load_rows<VEC>(sq, P::q, qb, krow, BQ, Lq - q0, E, gtid, WG * 32);
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) {
    if (tile < n_tiles) load_tile(tile);
    cp_async_commit();  // empty groups keep the wait count below uniform
  }

  const int r0 = q0 + 16 * wi;  // the warp's first query row
  const int i0 = r0 + g, i1 = i0 + 8;
  // Keys below these are visible to rows i0 and i1.
  const int lim0 = causal ? min(Lk, i0 + 1) : Lk, lim1 = causal ? min(Lk, i1 + 1) : Lk;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = tile * BK;
    if (tile + kStages - 1 < n_tiles) load_tile(tile + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    group_sync<WG>(gi);  // this tile has landed for every thread

    if (r0 < Lq && !(causal && j0 > r0 + 15)) {
      const T* kt = sk + (tile % kStages) * BK * P::k;
      const T* vt = sv + (tile % kStages) * BK * P::v;
      float s[NT][4];
      scores<NT, P::q, P::k, W>(s, sq + 16 * wi * P::q, kt, g, t);

      // Online softmax in log2 units over rows i0 (c 0, 1) and i1 (c 2, 3).
      float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + 8 * n + 2 * t + (c & 1);
          s[n][c] = j < (c < 2 ? lim0 : lim1) ? s[n][c] * scale_log2 : -INFINITY;
          if (c < 2) mt0 = fmaxf(mt0, s[n][c]);
          else mt1 = fmaxf(mt1, s[n][c]);
        }
      const float mn0 = fmaxf(m0, quad_max(mt0)), mn1 = fmaxf(m1, quad_max(mt1));
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;  // no key seen yet: no inf - inf
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = exp2f(s[n][0] - base0);
        s[n][1] = exp2f(s[n][1] - base0);
        s[n][2] = exp2f(s[n][2] - base1);
        s[n][3] = exp2f(s[n][3] - base1);
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      l0 = l0 * alpha0 + ps0;  // this lane's keys; summed over the quad at the end
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }
      pv<NT, NO, P::v>(acc, s, vt, g, t, lane);
    }
    group_sync<WG>(gi);  // every warp is done with this stage before it is refilled
  }

  if (r0 >= Lq) return;
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = c < 2 ? i0 : i1, d = 8 * n + 2 * t + (c & 1);
      if (i < Lq && d < D) ob[(size_t)i * vrow + d] = from_f32<T>(acc[n][c] * (c < 2 ? inv0 : inv1));
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

template <typename T, int W, int WG, int BK, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int G = kWarps / WG;
  const size_t smem = sizeof(T) * (size_t)G * group_elems<T, W, WG, BK>();
  auto kernel = mha_attention_fwd_kernel<T, W, WG, BK, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long items = (long long)((a.Lq + 16 * WG - 1) / (16 * WG)) * a.B * a.H;
  const long long blocks = (items + G - 1) / G;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.B * a.H, a.H, a.Lq, a.Lk, a.E, a.D, a.scale_log2, a.causal);
  return cudaGetLastError();
}

template <typename T, int W, bool VEC>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  if (a.Lq <= 16) return launch<T, W, 1, 16, VEC>(a, stream);
  if (a.Lq <= 32) return launch<T, W, 2, 16, VEC>(a, stream);
  return launch<T, W, 4, 32, VEC>(a, stream);
}

template <typename T>
cudaError_t launch_dtype(const Args& a, cudaStream_t stream) {
  constexpr int C = 16 / sizeof(T);
  const bool vec = a.E % C == 0 && a.D % C == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v);
  if (max(a.E, a.D) <= 64)
    return vec ? launch_rows<T, 64, true>(a, stream) : launch_rows<T, 64, false>(a, stream);
  return vec ? launch_rows<T, 128, true>(a, stream) : launch_rows<T, 128, false>(a, stream);
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
    case 0: return (int)launch_dtype<float>(a, s);
    case 1: return (int)launch_dtype<__nv_bfloat16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
