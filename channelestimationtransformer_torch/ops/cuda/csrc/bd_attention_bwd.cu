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
// over [B, L, H, E] tensors, f32, bf16 or f16 in, f32 accumulation,
// gradients in the input dtype. D equals the TPU kernel's sum(dp * p),
// dropout included. The TPU kernel's block-diagonal packing, 128-row key
// padding and the fold of the packed dK/dV (bd_attention.py:211-222) exist
// only to fill the MXU and are not carried over.
//
// Bound on an H100 SXM (3.35 TB/s; products at 165 TFLOP/s in f32, the
// split-TF32 rate of the tensor cores, 495 / 3, and at 989 in bf16): at the
// flagship encoder shape (B 256, H 8, E 16, L 90) the call reads Q, K, V,
// O, dO and lse and writes dQ, dK, dV, ~95 MB in f32, 28 us, and ~48 MB in
// bf16, 14 us; its ~10*E FLOPs per unmasked (row, key) pair, 2.65 GFLOP,
// take 16 us in f32 and 2.7 in bf16. So bytes bound every call of the path.
//
// Design. One block per (b, h) with one warp per 16 rows: NW warps, enough
// for the query slab (16 * NW rows, up to 128) and for the keys (up to 128,
// 16 a warp). At the path's L <= 16 shapes a block is one or two warps, and
// up to 32 such blocks share an SM. K and V of the (b, h) stay in shared
// memory for the whole call; Q, dO and O come in query slabs (one slab up
// to L 128; the slab shrinks until shared memory fits; O lands in the dS
// and P_drop buffers, read for D before they are written). Rows are staged
// in the input dtype, by 16-byte cp.async where they are 16-byte multiples
// and by plain loads otherwise (E 20 or 22 in bf16, say).
//   Row phase, a warp per 16 query rows: D from dO and O, S = Q K^T and
//   dP = dO V^T once each, in chunks of 32 keys (bf16: 16, which keeps
//   every bf16 instance clear of spills); then P, the dropped P and dS in
//   registers (f32), dQ = dS K from the registers (the C fragments of dS
//   are the A fragments of the product), and dS and the dropped P to
//   shared memory. The dropout bits were made per slab before the phase,
//   one Philox call per four keys, keyed as in the forward, into shared
//   memory.
//   Key phase, a warp per 16 keys: dK += dS^T Q and dV += P_drop^T dO over
//   the slab's rows, accumulated in registers across slabs.
// The dtype is a template parameter, and each instance has its own
// products (mma_tf32.cuh):
//   f32: split-TF32, three TF32 MMAs a product (f32 accuracy), in the k
//   order (2t, 2t + 1); shared memory holds f32, rows pitched EP + 4 and
//   Lk + 4, and 2 blocks of 109 KB share an SM at L 90.
//   bf16: rows staged as bf16. A product of two bf16 inputs takes one bf16
//   MMA (m16n8k16): S = Q K^T and dP = dO V^T, exact (bf16 products are
//   exact in f32). D, the softmax, lse and the 1/keep scaling stay f32 in
//   registers. dS and P_drop are computed in f32 and split into bf16
//   hi + lo (hi = bf16(x), lo = bf16(x - hi): ~16 bits), so each of
//   dQ = dS K, dK = dS^T Q and dV = P_drop^T dO takes two MMAs: one
//   rounding (8 bits, as the TPU's MXU rounds its operands at default
//   precision) misses the bf16 tolerance (rtol/atol 1e-2) at B 256, dQ by
//   up to 1.16x of it, dV 1.03x, dK 0.92x (tests/test_torch_bf16_mma.py).
//   dS is split in registers for dQ, and shared memory holds the hi and lo
//   planes of dS and P_drop for the key phase. S and dP read their Q, dO, K
//   and V fragments as 32-bit loads; the key phase's dS^T and P_drop^T
//   fragments and every B fragment of K, Q and dO come by ldmatrix.trans;
//   tiles are pitched at 8 elements past a multiple of 16.
//   f16: the bf16 instance's code with f16 MMAs (m16n8k16 .f16), except
//   that dS and P_drop are rounded to f16 once (one MMA a product, one
//   plane each in shared memory): with f16's 11 significant bits that
//   keeps rtol/atol 4e-3 at about a tenth of it at B 256
//   (tests/test_torch_f16_mma.py). P_drop lies in [0, 1 / keep_prob]; dS
//   does not keep to f16's range: in training it is the product of small
//   cotangents with P, ~1e-8 at the flagship's batch of 256, below f16's
//   normal range (2^-14) and down to its last subnormals (2^-24), where one
//   rounding loses most of its bits (the emulation puts the unscaled dQ
//   and dK at 2-90x their tolerance). So each slab's dS is multiplied by
//   sc, a power of two (exact), before it is rounded, and dQ and dK by 1/sc
//   after the products. sc takes the bound
//       |dS_ij| <= scale * max_i |dO_i|_1 * (inv_keep * max |V| + max_i |O_i|_inf)
//   (P <= 1, |dO_i . V_j| <= |dO_i|_1 max|V|, |D_i| <= |dO_i|_1 |O_i|_inf)
//   into [2^14, 2^15): below f16's largest value, 65504, and ~2^7 above the
//   bound's usual slack. The sums ride along with D: two lanes a row, the
//   warps' maxima through shared memory, V's once a block. dK accumulates
//   across slabs in the current slab's units (rescaled by sc_new / sc_old).
// Each (row, key) pair is computed once; masked entries are exactly 0 in P
// and dS. Each gradient element is summed by one warp in a fixed order: no
// atomics, the result is deterministic.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// attention_ablation.py; numbers in PERF.md): the f32 instance ~156 us at
// the L 90 shape above, 5.5x its bound (the CUDA-core kernel this
// replaces: 288.7 us), ~421 us for a training step's 13 calls; cutting
// parts out saves ~24 us (the row phase's products), ~28 (the key phase)
// and ~17 (the Philox bits) at L 90, the rest being each block's staging
// and three serial phases at 2 blocks an SM. The bf16 instance ~120 us at
// L 90 and ~337 a step, against ~285 and ~737 for its earlier datapath
// (rows staged as f32 by plain loads, split-TF32 products); its 99,840
// shared bytes a block at L 90 (the hi and lo planes) hold it to 2 blocks
// an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
constexpr int kMaxWarps = 8;                // warps a block: 16 rows or keys each

// Shared layout in elements of T, for padded width EP, Lk rounded up to 32
// (lkr, whole 32-key chunks) and to 16 (lkp): K and V [lkr][KP], Q and dO
// [QS][KP], dS and P_drop [planes][QS][PP] each, with O [QS][KP] over them
// until D is read, then the bits [QS][4] (32-bit words) and, f16, the
// warps' parts of dS's bound [3][kMaxWarps] (floats). f32: KP = EP + 4,
// PP = lkp + 4, one plane; bf16: EP + 8 and lkp + 8 (mma_tf32.cuh), two
// planes (the bf16 hi and lo of each value); f16: EP + 8 and lkp + 8, one
// plane.
template <typename T>
struct Layout {
  static constexpr int pad = sizeof(T) == 4 ? 4 : 8;
  static constexpr int planes = sizeof(T) == 4 || is_f16<T> ? 1 : 2;
  __host__ __device__ static constexpr int kp(int ep) { return ep + pad; }
  __host__ __device__ static constexpr int pp(int lkp) { return lkp + pad; }
  __host__ __device__ static constexpr int over(int ep, int lkp) {  // a row
    return 2 * planes * pp(lkp) > kp(ep) ? 2 * planes * pp(lkp) : kp(ep);
  }
  static constexpr size_t bytes(int ep, int lkr, int lkp, int qs) {
    return sizeof(T) * (2 * (size_t)lkr * kp(ep) + 2 * (size_t)qs * kp(ep) +
                        (size_t)qs * over(ep, lkp)) +
           sizeof(unsigned) * (size_t)qs * kMaskWords +
           (is_f16<T> ? sizeof(float) * 3 * kMaxWarps : 0);
  }
};

// 8-key tiles of a row-phase chunk: f32 32 keys; bf16 and f16 16 keys (one
// MMA k step), which keeps every 16-bit instance within its registers.
template <typename T>
constexpr int kChunkTiles = sizeof(T) == 4 ? 4 : 2;

// S and dP for the warp's 16 rows (qa, da: their first Q and dO rows) and
// the keys of a chunk (kt, vt: its first K and V rows), over all EP
// columns (those past E are zero). f32: split-TF32.
template <int EP>
__device__ __forceinline__ void row_products(float (&s)[4][4], float (&dp)[4][4],
                                             const float* qa, const float* da,
                                             const float* kt, const float* vt, int g, int t) {
  constexpr int KP = Layout<float>::kp(EP);
#pragma unroll
  for (int ks_ = 0; ks_ < EP / 8; ++ks_) {
    const float* qr = qa + g * KP + 8 * ks_ + 2 * t;
    const float* dr = da + g * KP + 8 * ks_ + 2 * t;
    const float2 q0 = *reinterpret_cast<const float2*>(qr);
    const float2 q1 = *reinterpret_cast<const float2*>(qr + 8 * KP);
    const float2 o0 = *reinterpret_cast<const float2*>(dr);
    const float2 o1 = *reinterpret_cast<const float2*>(dr + 8 * KP);
    uint32_t qh[4], ql[4], oh[4], ol[4];
    split_tf32({q0.x, q1.x, q0.y, q1.y}, qh, ql);
    split_tf32({o0.x, o1.x, o0.y, o1.y}, oh, ol);
#pragma unroll
    for (int n = 0; n < 4; ++n) {  // keys past nk are zero rows or masked later
      const int kr = (8 * n + g) * KP + 8 * ks_ + 2 * t;
      const float2 kv = *reinterpret_cast<const float2*>(kt + kr);
      const float2 vv = *reinterpret_cast<const float2*>(vt + kr);
      uint32_t bh_[2], bl_[2];
      split_tf32({kv.x, kv.y}, bh_, bl_);
      mma_split_tf32(s[n], qh, ql, bh_, bl_);
      split_tf32({vv.x, vv.y}, bh_, bl_);
      mma_split_tf32(dp[n], oh, ol, bh_, bl_);
    }
  }
}

// bf16 and f16 (H): one MMA a 16-column step and 8 keys, exact products.
template <int EP, int CT, typename H>
__device__ __forceinline__ b16_void<H> row_products(float (&s)[CT][4], float (&dp)[CT][4],
                                                    const H* qa, const H* da, const H* kt,
                                                    const H* vt, int g, int t) {
  constexpr int KP = Layout<H>::kp(EP);
#pragma unroll
  for (int kk = 0; kk < EP / 16; ++kk) {
    uint32_t qf[4], of[4];
    frag_a_b16(qf, qa + g * KP + 16 * kk + 2 * t, KP);
    frag_a_b16(of, da + g * KP + 16 * kk + 2 * t, KP);
#pragma unroll
    for (int n = 0; n < CT; ++n) {
      const int kr = (8 * n + g) * KP + 16 * kk + 2 * t;
      uint32_t b[2];
      frag_b_b16(b, kt + kr);
      mma_b16<H>(s[n], qf, b);
      frag_b_b16(b, vt + kr);
      mma_b16<H>(dp[n], of, b);
    }
  }
}

// dq_acc += dS K over a chunk's keys (kt: its first K row); ds holds dS in
// C-fragment order. f32: split-TF32, the C fragment of dS is the A
// fragment (k column t <-> key 2t).
template <int EP>
__device__ __forceinline__ void dq_products(float (&dq_acc)[EP / 8][4], const float (&ds)[4][4],
                                            const float* kt, int g, int t, int) {
  constexpr int KP = Layout<float>::kp(EP);
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    uint32_t ah[4], al[4];
    split_tf32({ds[jn][0], ds[jn][2], ds[jn][1], ds[jn][3]}, ah, al);
    const float* k0 = kt + (8 * jn + 2 * t) * KP + g;
#pragma unroll
    for (int n = 0; n < EP / 8; ++n) {
      uint32_t bh_[2], bl_[2];
      split_tf32({k0[8 * n], k0[KP + 8 * n]}, bh_, bl_);
      mma_split_tf32(dq_acc[n], ah, al, bh_, bl_);
    }
  }
}

// bf16: dS split into bf16 hi and lo (two MMAs); f16: dS (scaled) rounded
// once (one MMA). The C fragments of two 8-key tiles are the A fragments of
// a 16-key step; K's B fragments come by ldmatrix.trans.
template <int EP, int CT, typename H>
__device__ __forceinline__ b16_void<H> dq_products(float (&dq_acc)[EP / 8][4],
                                                   const float (&ds)[CT][4], const H* kt, int,
                                                   int, int lane) {
  constexpr int KP = Layout<H>::kp(EP);
#pragma unroll
  for (int kk = 0; kk < CT / 2; ++kk) {
    uint32_t hi[4], lo[4];
    operand_from_c<H>(hi, lo, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < EP / 8; n += 2) {
      uint32_t b0[2], b1[2];
      frag_b2_trans_b16(b0, b1, kt + 16 * kk * KP + 8 * n, KP, lane);
      mma_operand<H>(dq_acc[n], hi, lo, b0);
      mma_operand<H>(dq_acc[n + 1], hi, lo, b1);
    }
  }
}

// Elements (col, col + 1) of a dS or P_drop row: f32 as they are; bf16 as
// their hi (one 32-bit word at p) and lo (at p + plane); f16 rounded once.
__device__ __forceinline__ void store_pair(float* p, int, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <typename H>
__device__ __forceinline__ void store_pair(H* p, int plane, float x0, float x1) {
  uint32_t hi, lo;
  operand_b16<H>(x0, x1, hi, lo);
  *reinterpret_cast<uint32_t*>(p) = hi;
  if constexpr (!is_f16<H>) *reinterpret_cast<uint32_t*>(p + plane) = lo;
}

// Slab rows a key-phase step: the k of one MMA.
template <typename T>
constexpr int kKeyStep = sizeof(T) == 4 ? 8 : 16;

// One key-phase step: dK += dS^T Q and dV += P_drop^T dO for the warp's 16
// keys over kKeyStep slab rows. sb, pb: dS and P_drop at the step's first
// row and the warp's first key (pitch PP, planes `plane` apart); qb, db:
// the step's first Q and dO rows. f32: split-TF32 (k column t <-> row 2t).
template <int EP>
__device__ __forceinline__ void key_step(float (&dk_acc)[EP / 8][4], float (&dv_acc)[EP / 8][4],
                                         const float* sb, const float* pb, const float* qb,
                                         const float* db, int PP, int, int g, int t, int) {
  constexpr int KP = Layout<float>::kp(EP);
  const int ra = 2 * t, rb = ra + 1;
  uint32_t sh[4], sl[4], ph[4], pl[4];
  split_tf32({sb[ra * PP + g], sb[ra * PP + g + 8], sb[rb * PP + g], sb[rb * PP + g + 8]}, sh,
             sl);
  split_tf32({pb[ra * PP + g], pb[ra * PP + g + 8], pb[rb * PP + g], pb[rb * PP + g + 8]}, ph,
             pl);
#pragma unroll
  for (int n = 0; n < EP / 8; ++n) {
    uint32_t bh_[2], bl_[2];
    split_tf32({qb[ra * KP + 8 * n + g], qb[rb * KP + 8 * n + g]}, bh_, bl_);
    mma_split_tf32(dk_acc[n], sh, sl, bh_, bl_);
    split_tf32({db[ra * KP + 8 * n + g], db[rb * KP + 8 * n + g]}, bh_, bl_);
    mma_split_tf32(dv_acc[n], ph, pl, bh_, bl_);
  }
}

// bf16: the hi and lo A fragments of dS^T, then of P_drop^T (two MMAs a
// product); f16: their one plane (one MMA). The B fragments of Q and dO
// come by ldmatrix.trans.
template <int EP, typename H>
__device__ __forceinline__ b16_void<H> key_step(float (&dk_acc)[EP / 8][4],
                                                float (&dv_acc)[EP / 8][4], const H* sb,
                                                const H* pb, const H* qb, const H* db, int PP,
                                                int plane, int, int, int lane) {
  constexpr int KP = Layout<H>::kp(EP);
  uint32_t hi[4], lo[4], b0[2], b1[2];
  frag_a_trans_b16(hi, sb, PP, lane);
  if constexpr (!is_f16<H>) frag_a_trans_b16(lo, sb + plane, PP, lane);
#pragma unroll
  for (int n = 0; n < EP / 8; n += 2) {
    frag_b2_trans_b16(b0, b1, qb + 8 * n, KP, lane);
    mma_operand<H>(dk_acc[n], hi, lo, b0);
    mma_operand<H>(dk_acc[n + 1], hi, lo, b1);
  }
  frag_a_trans_b16(hi, pb, PP, lane);
  if constexpr (!is_f16<H>) frag_a_trans_b16(lo, pb + plane, PP, lane);
#pragma unroll
  for (int n = 0; n < EP / 8; n += 2) {
    frag_b2_trans_b16(b0, b1, db + 8 * n, KP, lane);
    mma_operand<H>(dv_acc[n], hi, lo, b0);
    mma_operand<H>(dv_acc[n + 1], hi, lo, b1);
  }
}

// f16: the power of two sc that takes a bound m on |dS| into [2^14, 2^15)
// (the header), 1 where m is 0 or not finite; sc stays within 2^+-120.
__device__ __forceinline__ float ds_scale(float m) {
  if (!(m > 0.f) || isinf(m)) return 1.f;
  return ldexpf(1.f, max(-120, min(120, 14 - ilogbf(m))));
}

// The kernel's body (bd_attention_bwd_kernel and bd_attention_bwd_f16_kernel
// below). T: float, __nv_bfloat16 or __half; EP: E padded to 16, 32 or 64.
// Lane = 4 * g + t (mma_tf32.cuh).
template <typename T, int EP, bool DROPOUT, bool VEC>
__device__ __forceinline__ void bwd_body(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ o,
                                         const T* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const long long* __restrict__ seed, T* __restrict__ dq,
                                         T* __restrict__ dk, T* __restrict__ dv, int H, int Lq,
                                         int Lk, int E, int QS, float scale, int causal,
                                         unsigned thresh, float inv_keep) {
  using L = Layout<T>;
  constexpr int KP = L::kp(EP);  // pitch of the K, V, Q, dO and O rows
  constexpr int NE = EP / 8;     // 8-column tiles of a head row
  constexpr int RS = kKeyStep<T>;
  constexpr int CT = kChunkTiles<T>;  // 8-key tiles of a row-phase chunk
  constexpr bool kScaled = is_f16<T>;  // dS scaled before it is rounded (the header)
  const int LKR = (Lk + 31) & ~31, LKP = (Lk + 15) & ~15;
  const int PP = L::pp(LKP);  // pitch of the dS and P_drop rows
  const int PS = QS * PP;     // elements of a dS or P_drop plane
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);  // [LKR][KP]
  T* vs = ks + LKR * KP;                // [LKR][KP]
  T* qs = vs + LKR * KP;                // [QS][KP]
  T* dos = qs + QS * KP;                // [QS][KP]
  T* sbuf = dos + QS * KP;              // [planes][QS][PP]: dS
  T* pbuf = sbuf + L::planes * PS;      // [planes][QS][PP]: P_drop
  T* os = sbuf;                         // [QS][KP]: O, until D is read
  unsigned* bits =
      reinterpret_cast<unsigned*>(sbuf + QS * L::over(EP, LKP));  // [QS][kMaskWords]
  float* parts = reinterpret_cast<float*>(bits + QS * kMaskWords);  // f16: [3][kMaxWarps]

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
      if (c >= E) ks[r * KP + c] = from_f32<T>(0.f);
    }
    __syncthreads();
  }
  auto load = [&](T* dst, const T* src, int rows, int valid) {
    load_rows<VEC>(dst, KP, src, row, rows, valid, E, threadIdx.x, blockDim.x);
  };
  load(ks, k + k_off, LKR, Lk);
  load(vs, v + k_off, LKR, Lk);

  const int kr0 = 16 * warp;  // the key phase's 16 keys
  float dk_acc[NE][4] = {}, dv_acc[NE][4] = {};
  float sc_keys = 1.f;  // f16: the scale of dk_acc's units

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
    // f16: also the warp's max |dO_i|_1 and max |O_i|_inf, and V's max |v|.
    float dsum = 0.f, dabs = 0.f, omax = 0.f;
    if (rows_here) {
      const int rr = lr0 + (lane >> 1), e0 = (lane & 1) * (EP / 2);
#pragma unroll
      for (int e = e0; e < e0 + EP / 2; ++e)
        if (e < E) {
          const float x = to_f32(dos[rr * KP + e]), y = to_f32(os[rr * KP + e]);
          dsum = fmaf(x, y, dsum);
          if constexpr (kScaled) {
            dabs += fabsf(x);
            omax = fmaxf(omax, fabsf(y));
          }
        }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    }
    const float d0 = __shfl_sync(0xffffffffu, dsum, 2 * g);
    const float d1 = __shfl_sync(0xffffffffu, dsum, 2 * g + 16);
    if constexpr (kScaled) {
      dabs += __shfl_xor_sync(0xffffffffu, dabs, 1);  // the row's two halves
      float vmax = 0.f;
      if (s0 == 0)  // V's rows, 8 columns a 16-byte load (the pad columns are 0)
        for (int x = threadIdx.x; x < Lk * (EP / 8); x += blockDim.x) {
          const int r = x / (EP / 8), c = 8 * (x % (EP / 8));
          const uint4 w = *reinterpret_cast<const uint4*>(vs + r * KP + c);
          const __half2* h2 = reinterpret_cast<const __half2*>(&w);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __half22float2(__habs2(h2[i]));
            vmax = fmaxf(vmax, fmaxf(f.x, f.y));
          }
        }
#pragma unroll
      for (int m = 1; m < 32; m <<= 1) {
        if (m > 1) dabs = fmaxf(dabs, __shfl_xor_sync(0xffffffffu, dabs, m));
        omax = fmaxf(omax, __shfl_xor_sync(0xffffffffu, omax, m));
        vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, m));
      }
      if (lane == 0) {
        parts[warp] = dabs;
        parts[kMaxWarps + warp] = omax;
        if (s0 == 0) parts[2 * kMaxWarps + warp] = vmax;
      }
    }
    __syncthreads();  // O is read: dS and P_drop go over it

    // f16: this slab's scale of dS, from the block's bound; dK's units follow it.
    float sc = 1.f;
    if constexpr (kScaled) {
      float dmax = 0.f, om = 0.f, vm = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        dmax = fmaxf(dmax, parts[w]);
        om = fmaxf(om, parts[kMaxWarps + w]);
        vm = fmaxf(vm, parts[2 * kMaxWarps + w]);
      }
      sc = ds_scale(scale * dmax * ((DROPOUT ? inv_keep : 1.f) * vm + om));
      if (s0 > 0) sc = fminf(sc, sc_keys * 0x1p60f);  // dk_acc * (sc / sc_keys) stays finite
    }
    const float ds_mul = kScaled ? scale * sc : scale;

    // Row phase.
    if (rows_here) {
      const int nk = causal ? min(Lk, s0 + lr0 + 16) : Lk;  // keys these rows can see

      float dq_acc[NE][4] = {};

      for (int kc = 0; kc < LKP; kc += 8 * CT) {
        float s[CT][4], dp[CT][4];
#pragma unroll
        for (int n = 0; n < CT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
        if (kc < nk) {
          row_products<EP>(s, dp, qs + lr0 * KP, dos + lr0 * KP, ks + kc * KP, vs + kc * KP, g,
                           t);
        }
        // P, P_drop and dS; s becomes dS and dp becomes P_drop.
#pragma unroll
        for (int n = 0; n < CT; ++n)
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
            s[n][c] = p * (dpv - (c < 2 ? d0 : d1)) * ds_mul;
            dp[n][c] = pd;
          }
#pragma unroll
        for (int n = 0; n < CT; ++n) {
          const int col = kc + 8 * n + 2 * t;
          if (kc + 8 * n >= LKP) break;
          store_pair(sbuf + (lr0 + g) * PP + col, PS, s[n][0], s[n][1]);
          store_pair(sbuf + (lr0 + g + 8) * PP + col, PS, s[n][2], s[n][3]);
          store_pair(pbuf + (lr0 + g) * PP + col, PS, dp[n][0], dp[n][1]);
          store_pair(pbuf + (lr0 + g + 8) * PP + col, PS, dp[n][2], dp[n][3]);
        }
        // dQ += dS K over this chunk's keys (dS is 0 past nk).
        if (kc < nk) {
          dq_products<EP>(dq_acc, s, ks + kc * KP, g, t, lane);
        }
      }
#pragma unroll
      for (int n = 0; n < NE; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c < 2 ? i0 : i1, e = 8 * n + 2 * t + (c & 1);
          if (i < Lq && e < E)
            dq[q_off + (size_t)i * row + e] =
                from_f32<T>(kScaled ? dq_acc[n][c] * (1.f / sc) : dq_acc[n][c]);
        }
    }
    __syncthreads();  // dS and P_drop are in shared memory

    // Key phase: the warp's 16 keys, dK += dS^T Q and dV += P_drop^T dO.
    if constexpr (kScaled) {  // dk_acc into this slab's units
      const float r = sc / sc_keys;
      sc_keys = sc;
#pragma unroll
      for (int n = 0; n < NE; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) dk_acc[n][c] *= r;
    }
    if (kr0 < LKP) {
      // Steps of RS slab rows; with `causal`, rows above every key here add 0.
      const int ks_end = (min(QS, Lq - s0) + RS - 1) / RS;
#pragma unroll 2
      for (int ks_ = causal ? max(0, (kr0 - s0) / RS) : 0; ks_ < ks_end; ++ks_)
        key_step<EP>(dk_acc, dv_acc, sbuf + RS * ks_ * PP + kr0, pbuf + RS * ks_ * PP + kr0,
                     qs + RS * ks_ * KP, dos + RS * ks_ * KP, PP, PS, g, t, lane);
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
          dk[k_off + (size_t)j * row + e] =
              from_f32<T>(kScaled ? dk_acc[n][c] * (1.f / sc_keys) : dk_acc[n][c]);
          dv[k_off + (size_t)j * row + e] = from_f32<T>(dv_acc[n][c]);
        }
      }
  }
}

#define BWD_PARAMS                                                                       \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,             \
      const T *__restrict__ o, const T *__restrict__ dout, const float *__restrict__ lse, \
      const long long *__restrict__ seed, T *__restrict__ dq, T *__restrict__ dk,        \
      T *__restrict__ dv, int H, int Lq, int Lk, int E, int QS, float scale, int causal, \
      unsigned thresh, float inv_keep
#define BWD_ARGS q, k, v, o, dout, lse, seed, dq, dk, dv, H, Lq, Lk, E, QS, scale, causal, \
                 thresh, inv_keep

// f32 and bf16.
template <typename T, int EP, bool DROPOUT, bool VEC>
__global__ void __launch_bounds__(256) bd_attention_bwd_kernel(BWD_PARAMS) {
  bwd_body<T, EP, DROPOUT, VEC>(BWD_ARGS);
}

// f16 (T = __half), with launch bounds of its own: under (256) alone ptxas
// gives the instances with dropout at E 16 (the flagship's training calls)
// 80 registers a thread and spills 20-32 bytes; with one block an SM as the
// stated minimum it gives them 128-135 and spills nothing. (Stated in
// bd_attention_bwd_kernel, it would move the f32 and bf16 instances'
// registers, which ptxas sets without spills.)
template <typename T, int EP, bool DROPOUT, bool VEC>
__global__ void __launch_bounds__(256, 1) bd_attention_bwd_f16_kernel(BWD_PARAMS) {
  bwd_body<T, EP, DROPOUT, VEC>(BWD_ARGS);
}

#undef BWD_PARAMS
#undef BWD_ARGS

// The kernel of an instance: f16's or the other dtypes'.
template <typename T, int EP, bool DROPOUT, bool VEC>
constexpr auto bwd_kernel() {
  if constexpr (is_f16<T>) return bd_attention_bwd_f16_kernel<T, EP, DROPOUT, VEC>;
  else return bd_attention_bwd_kernel<T, EP, DROPOUT, VEC>;
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
  bool dropout;
  int* occ;  // set: report the launch's occupancy into it and launch nothing
};

template <typename T, int EP, bool DROPOUT, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<T>;
  const int lkr = (a.Lk + 31) & ~31, lkp = (a.Lk + 15) & ~15;
  int qs = min((a.Lq + 15) & ~15, kMaxSlab);
  while (qs > 16 && L::bytes(EP, lkr, lkp, qs) > kSmemBudget) qs -= 16;
  const size_t smem = L::bytes(EP, lkr, lkp, qs);
  auto kernel = bwd_kernel<T, EP, DROPOUT, VEC>();
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = 32 * (max(qs, lkp) / 16);  // a warp per 16 slab rows and per 16 keys
  if (a.occ != nullptr) return occupancy(kernel, threads, smem, a.occ);
  kernel<<<a.B * a.H, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.seed,
      static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Lq, a.Lk,
      a.E, qs, a.scale, a.causal, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int EP, bool DROPOUT>
cudaError_t launch_vec(const Args& a, cudaStream_t stream) {
  constexpr int C = 16 / sizeof(T);  // elements of a 16-byte piece
  if (a.E % C == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout) &&
      aligned16(a.o))
    return launch<T, EP, DROPOUT, true>(a, stream);
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
  return a.dropout ? launch_e<T, true>(a, stream) : launch_e<T, false>(a, stream);
}

cudaError_t dispatch(const Args& a, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_d<float>(a, stream);
    case 1: return launch_d<__nv_bfloat16>(a, stream);
    case 2: return launch_d<__half>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool invalid(int B, int H, int Lq, int Lk, int E) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxLk || E <= 0 || E > kMaxE;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. `seed` null means no
// dropout, else the forward's mask (Philox word < `thresh`) and scale
// `inv_keep`. dq is [B, Lq, H, E], dk and dv [B, Lk, H, E]; every element is
// written. Returns a cudaError_t (0 on success); launches on `stream` and
// does not synchronise.
extern "C" int bd_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, const long long* seed,
                                void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                                int E, float scale, int causal, unsigned thresh,
                                float inv_keep, int dtype, void* stream) {
  if (invalid(B, H, Lq, Lk, E)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, seed, dq, dk, dv, B, H, Lq, Lk, E,
               scale, causal, thresh, inv_keep, seed != nullptr, nullptr};
  return (int)dispatch(a, dtype, static_cast<cudaStream_t>(stream));
}

// The instance and launch that bd_attention_bwd takes at these sizes (with
// dropout if `dropout`, 16-byte aligned tensors), not launched: out[5] as
// occupancy() in bd_attention_common.cuh. Returns a cudaError_t.
extern "C" int bd_attention_bwd_occupancy(int B, int H, int Lq, int Lk, int E, int dropout,
                                          int dtype, int* out) {
  if (invalid(B, H, Lq, Lk, E) || out == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, B, H, Lq, Lk, E, 1.f, 0, 0u, 1.f, dropout != 0, out};
  return (int)dispatch(a, dtype, nullptr);
}
