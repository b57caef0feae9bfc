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
// over [B, L, H, E] tensors, f32 or bf16 in, f32 accumulation, gradients in
// the input dtype. D equals the TPU kernel's sum(dp * p), dropout included.
// The TPU kernel's block-diagonal packing, 128-row key padding and the fold
// of the packed dK/dV (bd_attention.py:211-222) exist only to fill the MXU
// and are not carried over.
//
// Bound on an H100 SXM (3.35 TB/s; f32 products at 165 TFLOP/s, the
// split-TF32 rate of the tensor cores, 495 / 3): at the flagship encoder
// shape (B 256, H 8, E 16, L 90, f32) the call reads Q, K, V, O, dO and lse
// and writes dQ, dK, dV, ~94 MB, 28 us; its ~10*E FLOPs per unmasked (row,
// key) pair, 2.65 GFLOP, take 16 us. So bytes bound every call of the path.
//
// Design. One block per (b, h) with one warp per 16 rows: NW warps, enough
// for the query slab (16 * NW rows, up to 128) and for the keys (up to 128,
// 16 a warp). At the path's L <= 16 shapes a block is one or two warps, and
// up to 32 such blocks share an SM. K and V of the (b, h) stay in shared
// memory for the whole call; Q, dO and O come in query slabs (one slab up
// to L 128; the slab shrinks until shared memory fits; O lands in the dS
// and P_drop buffers, read for D before they are written, so 2 blocks of
// 109 KB share an SM at L 90), all by cp.async where rows are 16-byte
// multiples, as f32.
//   Row phase, a warp per 16 query rows: D from dO and O, S = Q K^T and
//   dP = dO V^T once each as split-TF32 MMAs (mma_tf32.cuh), in chunks of 32
//   keys; then P, the dropped P and dS in registers, dQ = dS K from the
//   registers (the C fragment of dS is the A fragment of the product in the
//   k order (2t, 2t + 1)), and dS and the dropped P to shared memory. The
//   dropout bits were made per slab before the phase, one Philox call per
//   four keys, keyed as in the forward, into shared memory.
//   Key phase, a warp per 16 keys: dK += dS^T Q and dV += P_drop^T dO over
//   the slab's rows, accumulated in registers across slabs.
// Each (row, key) pair is computed once; masked entries are exactly 0 in P
// and dS. Each gradient element is summed by one warp in a fixed order: no
// atomics, the result is deterministic. bf16 inputs are staged as f32 by
// plain loads (bf16 is exact in TF32) and take the same products.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 156.6 us
// at the L 90 shape above, 5.5x its bound (the CUDA-core kernel this
// replaces: 288.7 us); 423.8 us for a training step's 13 calls, where
// SDPA's f32 backward takes 2,408.5. attention_ablation.py puts ~45 us of
// the L 90 call in the products and ~15 in the Philox bits; the rest is each
// block's staging and three serial phases, exposed at 2 blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bd_attention_common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxLk = 128;
constexpr int kMaskWords = kMaxLk / 32;  // keep bits per query row
constexpr int kMaxE = 64;
constexpr int kMaxSlab = 128;               // query rows a slab
constexpr size_t kSmemBudget = 200 * 1024;  // bytes a block

// Shared layout in floats, for padded width EP, Lk rounded up to 32 (lkr,
// whole 32-key chunks) and to 16 (lkp): K and V [lkr][EP + 4], Q and dO
// [QS][EP + 4], dS and P_drop [QS][lkp + 4] each, with O [QS][EP + 4] over
// them until D is read, then the bits [QS][4].
__host__ __device__ constexpr int over_floats(int ep, int lkp) {  // a row
  return 2 * (lkp + 4) > ep + 4 ? 2 * (lkp + 4) : ep + 4;
}
constexpr size_t smem_floats(int ep, int lkr, int lkp, int qs) {
  return 2 * (size_t)lkr * (ep + 4) + 2 * (size_t)qs * (ep + 4) +
         (size_t)qs * over_floats(ep, lkp) + (size_t)qs * kMaskWords;
}

// EP: E padded to 16, 32 or 64. Lane = 4 * g + t (mma_tf32.cuh).
template <typename T, int EP, bool DROPOUT, bool VEC>
__global__ void __launch_bounds__(256)
bd_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const long long* __restrict__ seed, T* __restrict__ dq,
                        T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk, int E,
                        int QS, float scale, int causal, unsigned thresh, float inv_keep) {
  constexpr int KP = EP + 4;  // pitch of the K, V, Q, dO and O rows
  constexpr int NE = EP / 8;  // 8-column tiles of a head row
  const int LKR = (Lk + 31) & ~31, LKP = (Lk + 15) & ~15;
  const int PP = LKP + 4;  // pitch of the dS and P_drop rows
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [LKR][KP]
  float* vs = ks + LKR * KP;                    // [LKR][KP]
  float* qs = vs + LKR * KP;                    // [QS][KP]
  float* dos = qs + QS * KP;                    // [QS][KP]
  float* sbuf = dos + QS * KP;                  // [QS][PP]: dS
  float* pbuf = sbuf + QS * PP;                 // [QS][PP]: P_drop
  float* os = sbuf;                             // [QS][KP]: O, until D is read
  unsigned* bits =
      reinterpret_cast<unsigned*>(sbuf + QS * over_floats(EP, LKP));  // [QS][kMaskWords]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = (size_t)H * E;  // stride between sequence positions
  const size_t q_off = (size_t)b * Lq * row + (size_t)h * E;
  const size_t k_off = (size_t)b * Lk * row + (size_t)h * E;
  const uint2 key = DROPOUT ? philox_key(seed) : make_uint2(0u, 0u);

  // The copies write columns < E and zero-fill the rows past Lk and Lq; the
  // pad columns up to EP (of K, V, Q and dO, contiguous rows of KP) are
  // zeroed here once. dS, P_drop and the bits are written before they are
  // read, as 0 past the last row and key; D reads O's columns < E only.
  if (E < EP) {
    for (int x = threadIdx.x; x < (2 * LKR + 2 * QS) * EP; x += blockDim.x) {
      const int r = x / EP, c = x - r * EP;
      if (c >= E) ks[r * KP + c] = 0.f;
    }
    __syncthreads();
  }
  auto load = [&](float* dst, const T* src, int rows, int valid) {
    load_rows<VEC>(dst, KP, src, row, rows, valid, E, threadIdx.x, blockDim.x);
  };
  load(ks, k + k_off, LKR, Lk);
  load(vs, v + k_off, LKR, Lk);

  const int kr0 = 16 * warp;  // the key phase's 16 keys
  float dk_acc[NE][4] = {}, dv_acc[NE][4] = {};

  for (int s0 = 0; s0 < Lq; s0 += QS) {
    load(qs, q + q_off + s0 * row, QS, Lq - s0);
    load(dos, dout + q_off + s0 * row, QS, Lq - s0);
    load(os, o + q_off + s0 * row, QS, Lq - s0);
    cp_async_commit();
    if (DROPOUT) {  // the slab's keep bits, one 32-key word a thread
      const int words = (Lk + 31) >> 5;
      for (int x = threadIdx.x; x < QS * words; x += blockDim.x) {
        const int r = x / words, w = x - r * words, i = s0 + r;
        const int end = min(32 * w + 32, causal ? min(Lk, i + 1) : Lk);
        unsigned keep = 0u;
        for (int j0 = 32 * w; j0 < end; j0 += 4)
          keep |= keep_bits4(j0, i, bh, key, thresh) << (j0 - 32 * w);
        bits[r * kMaskWords + w] = keep;
      }
    }
    // The row phase's lse, loaded while the copies land.
    const int lr0 = 16 * warp;  // the row phase's 16 query rows
    const bool rows_here = lr0 < QS && s0 + lr0 < Lq;
    const int i0 = s0 + lr0 + g, i1 = i0 + 8;
    const float lse0 = rows_here && i0 < Lq ? lse[(size_t)bh * Lq + i0] : 0.f;
    const float lse1 = rows_here && i1 < Lq ? lse[(size_t)bh * Lq + i1] : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    // D = rowsum(dO * O): two lanes a row, then to the lanes that hold it.
    float dsum = 0.f;
    if (rows_here) {
      const int rr = lr0 + (lane >> 1), e0 = (lane & 1) * (EP / 2);
#pragma unroll
      for (int e = e0; e < e0 + EP / 2; ++e)
        if (e < E) dsum = fmaf(dos[rr * KP + e], os[rr * KP + e], dsum);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    }
    const float d0 = __shfl_sync(0xffffffffu, dsum, 2 * g);
    const float d1 = __shfl_sync(0xffffffffu, dsum, 2 * g + 16);
    __syncthreads();  // O is read: dS and P_drop go over it

    // Row phase.
    if (rows_here) {
      const int nk = causal ? min(Lk, s0 + lr0 + 16) : Lk;  // keys these rows can see

      float dq_acc[NE][4] = {};

      for (int kc = 0; kc < LKP; kc += 32) {
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
        if (kc < nk) {
#pragma unroll
          for (int ks_ = 0; ks_ < NE; ++ks_) {
            const float* qa = qs + (lr0 + g) * KP + 8 * ks_ + 2 * t;
            const float* da = dos + (lr0 + g) * KP + 8 * ks_ + 2 * t;
            const float2 q0 = *reinterpret_cast<const float2*>(qa);
            const float2 q1 = *reinterpret_cast<const float2*>(qa + 8 * KP);
            const float2 o0 = *reinterpret_cast<const float2*>(da);
            const float2 o1 = *reinterpret_cast<const float2*>(da + 8 * KP);
            uint32_t qh[4], ql[4], oh[4], ol[4];
            split_tf32({q0.x, q1.x, q0.y, q1.y}, qh, ql);
            split_tf32({o0.x, o1.x, o0.y, o1.y}, oh, ol);
#pragma unroll
            for (int n = 0; n < 4; ++n) {  // keys past nk are zero rows or masked below
              const int kr = (kc + 8 * n + g) * KP + 8 * ks_ + 2 * t;
              const float2 kv = *reinterpret_cast<const float2*>(ks + kr);
              const float2 vv = *reinterpret_cast<const float2*>(vs + kr);
              uint32_t bh_[2], bl_[2];
              split_tf32({kv.x, kv.y}, bh_, bl_);
              mma_split_tf32(s[n], qh, ql, bh_, bl_);
              split_tf32({vv.x, vv.y}, bh_, bl_);
              mma_split_tf32(dp[n], oh, ol, bh_, bl_);
            }
          }
        }
        // P, P_drop and dS; s becomes dS and dp becomes P_drop.
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = kc + 8 * n + 2 * t + (c & 1);
            const int i = c < 2 ? i0 : i1;
            const bool valid = i < Lq && j < Lk && (!causal || j <= i);
            const float p = valid ? expf(s[n][c] * scale - (c < 2 ? lse0 : lse1)) : 0.f;
            float dpv = dp[n][c], pd = p;
            if (DROPOUT) {
              const int r = i - s0;
              const bool kept = valid && ((bits[r * kMaskWords + (j >> 5)] >> (j & 31)) & 1u);
              dpv = kept ? dpv * inv_keep : 0.f;
              pd = kept ? p * inv_keep : 0.f;
            }
            s[n][c] = p * (dpv - (c < 2 ? d0 : d1)) * scale;
            dp[n][c] = pd;
          }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = kc + 8 * n + 2 * t;
          if (kc + 8 * n >= LKP) break;
          *reinterpret_cast<float2*>(sbuf + (lr0 + g) * PP + col) = make_float2(s[n][0], s[n][1]);
          *reinterpret_cast<float2*>(sbuf + (lr0 + g + 8) * PP + col) =
              make_float2(s[n][2], s[n][3]);
          *reinterpret_cast<float2*>(pbuf + (lr0 + g) * PP + col) = make_float2(dp[n][0], dp[n][1]);
          *reinterpret_cast<float2*>(pbuf + (lr0 + g + 8) * PP + col) =
              make_float2(dp[n][2], dp[n][3]);
        }
        // dQ += dS K over this chunk's keys (dS is 0 past nk).
        if (kc < nk) {
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          uint32_t ah[4], al[4];
          split_tf32({s[jn][0], s[jn][2], s[jn][1], s[jn][3]}, ah, al);  // k column t <-> key 2t
          const float* k0 = ks + (kc + 8 * jn + 2 * t) * KP + g;
#pragma unroll
          for (int n = 0; n < NE; ++n) {
            uint32_t bh_[2], bl_[2];
            split_tf32({k0[8 * n], k0[KP + 8 * n]}, bh_, bl_);
            mma_split_tf32(dq_acc[n], ah, al, bh_, bl_);
          }
        }
        }
      }
#pragma unroll
      for (int n = 0; n < NE; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c < 2 ? i0 : i1, e = 8 * n + 2 * t + (c & 1);
          if (i < Lq && e < E) dq[q_off + (size_t)i * row + e] = from_f32<T>(dq_acc[n][c]);
        }
    }
    __syncthreads();  // dS and P_drop are in shared memory

    // Key phase: the warp's 16 keys, dK += dS^T Q and dV += P_drop^T dO.
    if (kr0 < LKP) {
      // Steps of 8 slab rows; with `causal`, rows above every key here add 0.
      const int ks_end = (min(QS, Lq - s0) + 7) / 8;
#pragma unroll 2
      for (int ks_ = causal ? max(0, (kr0 - s0) / 8) : 0; ks_ < ks_end; ++ks_) {
        const int ra = 8 * ks_ + 2 * t, rb = ra + 1;     // k column t <-> row 2t
        uint32_t sh[4], sl[4], ph[4], pl[4];
        split_tf32({sbuf[ra * PP + kr0 + g], sbuf[ra * PP + kr0 + g + 8], sbuf[rb * PP + kr0 + g],
               sbuf[rb * PP + kr0 + g + 8]}, sh, sl);
        split_tf32({pbuf[ra * PP + kr0 + g], pbuf[ra * PP + kr0 + g + 8], pbuf[rb * PP + kr0 + g],
               pbuf[rb * PP + kr0 + g + 8]}, ph, pl);
#pragma unroll
        for (int n = 0; n < NE; ++n) {
          uint32_t bh_[2], bl_[2];
          split_tf32({qs[ra * KP + 8 * n + g], qs[rb * KP + 8 * n + g]}, bh_, bl_);
          mma_split_tf32(dk_acc[n], sh, sl, bh_, bl_);
          split_tf32({dos[ra * KP + 8 * n + g], dos[rb * KP + 8 * n + g]}, bh_, bl_);
          mma_split_tf32(dv_acc[n], ph, pl, bh_, bl_);
        }
      }
    }
    __syncthreads();  // the slab's buffers are free
  }

  if (kr0 < LKP) {
#pragma unroll
    for (int n = 0; n < NE; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = kr0 + g + (c < 2 ? 0 : 8), e = 8 * n + 2 * t + (c & 1);
        if (j < Lk && e < E) {
          dk[k_off + (size_t)j * row + e] = from_f32<T>(dk_acc[n][c]);
          dv[k_off + (size_t)j * row + e] = from_f32<T>(dv_acc[n][c]);
        }
      }
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

template <typename T, int EP, bool DROPOUT, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int lkr = (a.Lk + 31) & ~31, lkp = (a.Lk + 15) & ~15;
  int qs = min((a.Lq + 15) & ~15, kMaxSlab);
  while (qs > 16 && sizeof(float) * smem_floats(EP, lkr, lkp, qs) > kSmemBudget) qs -= 16;
  const size_t smem = sizeof(float) * smem_floats(EP, lkr, lkp, qs);
  auto kernel = bd_attention_bwd_kernel<T, EP, DROPOUT, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int warps = max(qs, lkp) / 16;  // a warp per 16 slab rows and per 16 keys
  kernel<<<a.B * a.H, 32 * warps, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.seed,
      static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Lq, a.Lk,
      a.E, qs, a.scale, a.causal, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int EP, bool DROPOUT>
cudaError_t launch_vec(const Args& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (a.E % 4 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout) &&
        aligned16(a.o))
      return launch<T, EP, DROPOUT, true>(a, stream);
  }
  return launch<T, EP, DROPOUT, false>(a, stream);
}

template <typename T, bool DROPOUT>
cudaError_t launch_e(const Args& a, cudaStream_t stream) {
  if (a.E <= 16) return launch_vec<T, 16, DROPOUT>(a, stream);
  if (a.E <= 32) return launch_vec<T, 32, DROPOUT>(a, stream);
  return launch_vec<T, 64, DROPOUT>(a, stream);
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
