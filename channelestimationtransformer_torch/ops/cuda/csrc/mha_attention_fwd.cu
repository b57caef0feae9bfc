// Multi-head attention forward for Hopper (sm_90a), plain C interface, on
// two routes: "mma" (mma.sync; every dtype and width) and "wgmma" (bf16 or
// f16, Lq > 32, E and D each 64 or 128, 16-byte aligned tensors: warpgroup MMAs
// fed by TMA, below the mma route's kernel). The caller picks the route
// (ops/cuda/mha_attention.py:mha_route); neither falls back to the other.
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
// read and written in place through their strides, with no transposes; f32,
// bf16 or f16 in, f32 accumulation, output in the input dtype. With `causal` the
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
// Route "mma", design (FlashAttention-2 on mma.sync). A warp owns 16 query
// rows, the m16 of the MMA. Scores S = Q K^T, the online softmax (row max and sum over the
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
// fragments by ldmatrix.trans; f16 inputs the same with f16 MMAs, P rounded
// to f16. Where E or D is not a multiple of 16 bytes,
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
// 8 warps an SM do not hide the MMA and ALU latencies. Its bf16 instance
// takes ~150 us at L 256 (SDPA bf16 ~53), hence the wgmma route: it reloads
// Q and K fragments from shared memory for every key tile of 32 keys, every
// thread issues copies, and its MMA is Ampere's.
//
// Route "wgmma" (bf16 and f16; replaces _attn_kernel_blhe on the xl
// encoder's L 256, 128 and 64 calls). Bound at L 256 (B 64, H 8, E = D 128): 134 MB over HBM,
// 40 us; 17.2 GFLOP at 989 TFLOP/s, 17 us: bytes bound it, and every call
// of the route. Design (FlashAttention-3's shape, kept simple): persistent
// blocks of a producer warpgroup, whose one thread issues TMA loads of
// 128-byte-swizzled boxes (Q once an item into one of two buffers, K and V
// tiles into a two-stage ring, full / empty mbarriers), and one or two
// consumer warpgroups of 64 query rows that run S = Q K^T as wgmma from
// shared memory, the online softmax on the accumulators, P rounded to the
// input's 16-bit type in registers as the A operand of O += P V (V through the transpose bit),
// and store O through shared memory by TMA; setmaxnreg gives the producer's
// registers to the consumers (168 at entry, 240 after). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (attention_ablation.py): 52 us at L 256
// (SDPA bf16 53), 28 at L 128 (29), 8 at L 64 (17); without its products
// the L 256 call still takes 51 us, so the loads and stores (77% of the
// HBM rate) bound it, not the tensor cores. The f16 instances are the bf16
// ones with f16 wgmma, f16 tensor maps and P rounded to f16 (10 stored
// significand bits to bf16's 7; P lies in [0, 1]).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bd_attention_common.cuh"
#include "mma_tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxW = 128;  // head width limit, E and D
constexpr int kStages = 2;  // K/V pipeline stages (3 measured slower: fewer blocks an SM)
constexpr float kLog2e = 1.4426950408889634f;

// Row pitches (elements) of the shared tiles. Q and K rows W + 8: the 8-byte
// (f32) or 4-byte (bf16, f16) fragment loads of 8 rows x 4 lanes hit
// distinct banks. V rows W + 4 for f32 (4-byte loads of rows 2t and 2t + 1)
// and W + 8 for bf16 and f16 (ldmatrix rows 16 bytes apart modulo 128).
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

// bf16 and f16 (H): one MMA a 16-column step and 8 keys, exact products.
template <int NT, int QP, int KP, int W, typename H>
__device__ __forceinline__ b16_void<H> scores(float (&s)[NT][4], const H* sq, const H* sk,
                                              int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks) {
    uint32_t af[4];
    frag_a_b16(af, sq + g * QP + 16 * ks + 2 * t, QP);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bf[2];
      frag_b_b16(bf, sk + (8 * n + g) * KP + 16 * ks + 2 * t);
      mma_b16<H>(s[n], af, bf);
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

// bf16 and f16 (H): P rounded to H once.
template <int NT, int NO, int VP, typename H>
__device__ __forceinline__ b16_void<H> pv(float (&acc)[NO][4], const float (&p)[NT][4],
                                          const H* sv, int, int, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_b16<H>(p[2 * kk][0], p[2 * kk][1]),
                           pack_b16<H>(p[2 * kk][2], p[2 * kk][3]),
                           pack_b16<H>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_b16<H>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const H* row = sv + (16 * kk + (lane & 15)) * VP + 8 * (lane >> 4);
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, row + 8 * n);
      mma_b16<H>(acc[n], a, {r[0], r[1]});
      mma_b16<H>(acc[n + 1], a, {r[2], r[3]});
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

// --- Route "wgmma" ----------------------------------------------------------
//
// bf16 or f16, Lq > 32, E and D each 64 or 128, q, k, v and out 16-byte
// aligned.
// A persistent block: NC consumer warpgroups (warps 0 .. 4NC - 1), each
// owning 64 query rows of the block's item, and a producer warpgroup whose
// first warp's lane 0 issues every TMA load. The producer warpgroup gives
// its registers to the consumers (setmaxnreg, which acts on whole
// warpgroups: a lone producer warp's release never reached the consumers,
// whose request then waited forever). An item is (b, h, a tile of
// BQ = 64 NC query rows); block i takes items i, i + grid, ... so that the
// q tiles of one (b, h), adjacent items, run at the same time and read its
// K and V once from HBM and again from L2. The producer runs ahead across
// items: the next item's Q tile loads into the other Q buffer (NC 2) or once
// every consumer has issued its last Q K^T (empty_q), its K and V tiles as
// soon as a stage of the ring is free (empty_kv), while the consumers finish
// the item and store it.

constexpr int kWgStages = 2;   // K/V ring
constexpr int kBox = 64;       // columns of a TMA box: 128 bytes of 16-bit values
constexpr int kBoxBytes = 64 * 128;  // a box of 64 rows

// NC = 2 for Lq > 64 (BQ 128: K and V cross the SM once for 128 rows) with
// key tiles of 128; NC = 1 for Lq <= 64 (a second warpgroup would have no
// rows) with key tiles of 64, two blocks an SM.
template <int WE, int WD, int NC>
struct WgLayout {
  static constexpr int BQ = 64 * NC, BK = NC == 2 ? 128 : 64;
  static constexpr int threads = 128 * (NC + 1), blocks_per_sm = NC == 1 ? 2 : 1;
  // Registers a thread after setmaxnreg; the launch bounds give 168 (NC 2)
  // and 128 (NC 1) at entry, and the two counts share out exactly that.
  static constexpr int producer_regs = 24, consumer_regs = NC == 2 ? 240 : 232;
  // Shared memory, each part 1024-byte aligned: Q [buffer][NC][WE/64] boxes
  // of 64 rows; K [stage][WE/64] and V [stage][WD/64] boxes of BK rows; the
  // output staging O [NC][WD/64] boxes of 64 rows; then the barriers. Two Q
  // buffers where they fit (NC 2: 225 KB; NC 1 keeps two blocks an SM).
  static constexpr int q_buffers = NC == 2 ? 2 : 1;
  static constexpr int q_bytes = NC * (WE / kBox) * kBoxBytes;  // a buffer
  static constexpr int k_bytes = (WE / kBox) * BK * 128, v_bytes = (WD / kBox) * BK * 128;
  static constexpr int o_bytes = NC * (WD / kBox) * kBoxBytes;
  static constexpr int k_off = q_buffers * q_bytes, v_off = k_off + kWgStages * k_bytes;
  static constexpr int o_off = v_off + kWgStages * v_bytes, bar_off = o_off + o_bytes;
  // full_q, empty_q [buffer]; full_k, full_v, empty_kv [stage]
  static constexpr int n_bars = 2 * q_buffers + 3 * kWgStages;
  static constexpr int smem = bar_off + 8 * n_bars + 1024;  // + the base's alignment
};

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) wgmma_ss_n64<T>(d, a, b, acc);
  else wgmma_ss_n128<T>(d, a, b, acc);
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64<T>(d, a, b);
  else wgmma_rs_n128<T>(d, a, b);
}

// T: __nv_bfloat16 or __half. Maps (TMA, 4-D: E or D, H, L, B, T, 128-byte
// swizzle): tq and to boxes of 64 rows, tk and tv boxes of BK rows.
template <typename T, int WE, int WD, int NC>
__global__ void __launch_bounds__(WgLayout<WE, WD, NC>::threads,
                                  WgLayout<WE, WD, NC>::blocks_per_sm)
mha_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, int BH, int H, int Lq, int Lk,
                           float scale_log2, int causal) {
  static_assert(sizeof(T) == 2, "the wgmma route takes bf16 or f16");
  using Lay = WgLayout<WE, WD, NC>;
  constexpr int BQ = Lay::BQ, BK = Lay::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sq = smem;
  uint8_t* sk = smem + Lay::k_off;
  uint8_t* sv = smem + Lay::v_off;
  uint8_t* so = smem + Lay::o_off;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + Lay::bar_off);
  uint64_t* empty_q = full_q + Lay::q_buffers;
  uint64_t* full_k = empty_q + Lay::q_buffers;
  uint64_t* full_v = full_k + kWgStages;
  uint64_t* empty_kv = full_v + kWgStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int qb = 0; qb < Lay::q_buffers; ++qb) {
      mbar_init(full_q + qb, 1);
      mbar_init(empty_q + qb, 4 * NC);  // lane 0 of every consumer warp
    }
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full_k + st, 1);
      mbar_init(full_v + st, 1);
      mbar_init(empty_kv + st, 4 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_qt = (Lq + BQ - 1) / BQ, n_items = BH * n_qt;

  if (warp >= 4 * NC) {
    // Producer. Its phases: empty waits pass at once in a buffer's first round.
    setmaxnreg_dec<Lay::producer_regs>();
    if (warp == 4 * NC && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      int it = 0, n = 0;  // K/V tiles and items so far
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const int bh = item / n_qt, q0 = (item - bh * n_qt) * BQ;
        const int b = bh / H, h = bh - b * H;
        const int qb = n % Lay::q_buffers;
        mbar_wait(empty_q + qb, ((n / Lay::q_buffers) & 1) ^ 1);
        mbar_arrive_expect_tx(full_q + qb, Lay::q_bytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int x = 0; x < WE / kBox; ++x)
            tma_load_4d(sq + qb * Lay::q_bytes + (c * (WE / kBox) + x) * kBoxBytes, &tq,
                        full_q + qb, kBox * x, h, q0 + 64 * c, b);
        const int n_keys = causal ? min(Lk, q0 + BQ) : Lk;
        for (int j0 = 0; j0 < n_keys; j0 += BK, ++it) {
          const int st = it % kWgStages;
          mbar_wait(empty_kv + st, ((it / kWgStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full_k + st, Lay::k_bytes);
#pragma unroll
          for (int x = 0; x < WE / kBox; ++x)
            tma_load_4d(sk + st * Lay::k_bytes + x * BK * 128, &tk, full_k + st, kBox * x, h, j0,
                        b);
          mbar_arrive_expect_tx(full_v + st, Lay::v_bytes);
#pragma unroll
          for (int x = 0; x < WD / kBox; ++x)
            tma_load_4d(sv + st * Lay::v_bytes + x * BK * 128, &tv, full_v + st, kBox * x, h, j0,
                        b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg, warp wl in it, rows 16 wl + g and + 8 of the
    // group's 64 (lane = 4 g + t).
    setmaxnreg_inc<Lay::consumer_regs>();
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
    const int tid = threadIdx.x & 127;
    uint8_t* my_o = so + wg * (WD / kBox) * kBoxBytes;
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
      const int bh = item / n_qt, q0 = (item - bh * n_qt) * BQ;
      const int b = bh / H, h = bh - b * H;
      const int r0 = q0 + 64 * wg;  // the warpgroup's first row
      const int n_keys = causal ? min(Lk, q0 + BQ) : Lk;
      const int n_tiles = (n_keys + BK - 1) / BK;
      // Tiles this warpgroup reads: up to its last visible key, none past Lq.
      const int my_tiles = r0 < Lq ? ((causal ? min(Lk, r0 + 64) : Lk) + BK - 1) / BK : 0;
      const int i0 = r0 + 16 * wl + g, i1 = i0 + 8;
      // Keys below these are visible to rows i0 and i1.
      const int lim0 = causal ? min(Lk, i0 + 1) : Lk, lim1 = causal ? min(Lk, i1 + 1) : Lk;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      float o[WD / 2];
#pragma unroll
      for (int i = 0; i < WD / 2; ++i) o[i] = 0.f;

      // Arrivals on empty_q and empty_kv follow the waits on full_q and
      // full_k / full_v: a phase an arrival counts toward has then begun.
      const int qb = n % Lay::q_buffers;
      const uint32_t q_base = smem_addr(sq + qb * Lay::q_bytes + wg * (WE / kBox) * kBoxBytes);
      mbar_wait(full_q + qb, (n / Lay::q_buffers) & 1);
      if (my_tiles == 0 && lane == 0) mbar_arrive(empty_q + qb);
      for (int tile = 0; tile < n_tiles; ++tile, ++it) {
        const int st = it % kWgStages;
        const uint32_t phase = (it / kWgStages) & 1;
        mbar_wait(full_k + st, phase);
        if (tile < my_tiles) {
          const int j0 = tile * BK;
          // S = Q K^T over E: k16 step ks is box ks / 4, 32 bytes a step within it.
          const uint32_t k_base = smem_addr(sk + st * Lay::k_bytes);
          float s[BK / 2];
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < WE / 16; ++ks)
            wgmma_ss<T, BK>(s,
                         sw128_desc(q_base + (ks >> 2) * kBoxBytes + (ks & 3) * 32, 16, 1024),
                         sw128_desc(k_base + (ks >> 2) * BK * 128 + (ks & 3) * 32, 16, 1024),
                         ks > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          if (tile == my_tiles - 1 && lane == 0) mbar_arrive(empty_q + qb);

          // Online softmax in log2 units over rows i0 (registers 4j, 4j + 1)
          // and i1 (4j + 2, 4j + 3); masks only on a tile past Lk or across
          // the diagonal.
          const bool masked = j0 + BK > Lk || (causal && j0 + BK - 1 > r0);
          float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int key = j0 + 8 * j + 2 * t + (c & 1);
              float x = s[4 * j + c] * scale_log2;
              if (masked && key >= (c < 2 ? lim0 : lim1)) x = -INFINITY;
              s[4 * j + c] = x;
              if (c < 2) mt0 = fmaxf(mt0, x);
              else mt1 = fmaxf(mt1, x);
            }
          const float mn0 = fmaxf(m0, quad_max(mt0)), mn1 = fmaxf(m1, quad_max(mt1));
          const float base0 = mn0 == -INFINITY ? 0.f : mn0;  // no key seen yet: no inf - inf
          const float base1 = mn1 == -INFINITY ? 0.f : mn1;
          const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
          m0 = mn0;
          m1 = mn1;
          float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            s[4 * j] = exp2f(s[4 * j] - base0);
            s[4 * j + 1] = exp2f(s[4 * j + 1] - base0);
            s[4 * j + 2] = exp2f(s[4 * j + 2] - base1);
            s[4 * j + 3] = exp2f(s[4 * j + 3] - base1);
            ps0 += s[4 * j] + s[4 * j + 1];
            ps1 += s[4 * j + 2] + s[4 * j + 3];
          }
          l0 = l0 * alpha0 + ps0;  // this lane's keys; summed over the quad at the end
          l1 = l1 * alpha1 + ps1;
#pragma unroll
          for (int j = 0; j < WD / 8; ++j) {
            o[4 * j] *= alpha0;
            o[4 * j + 1] *= alpha0;
            o[4 * j + 2] *= alpha1;
            o[4 * j + 3] *= alpha1;
          }
          // P rounded to T once: keys 16 kk .. 16 kk + 15 are the A operand
          // of k16 step kk of P V.
          uint32_t p[BK / 16][4];
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            p[kk][0] = pack_b16<T>(s[8 * kk], s[8 * kk + 1]);
            p[kk][1] = pack_b16<T>(s[8 * kk + 2], s[8 * kk + 3]);
            p[kk][2] = pack_b16<T>(s[8 * kk + 4], s[8 * kk + 5]);
            p[kk][3] = pack_b16<T>(s[8 * kk + 6], s[8 * kk + 7]);
          }

          // O += P V: V's tile [BK][WD] is B MN-major; k16 step kk starts 16
          // rows (2,048 bytes) on, and its second 64 columns one box on.
          mbar_wait(full_v + st, phase);
          const uint32_t v_base = smem_addr(sv + st * Lay::v_bytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs<T, WD>(o, p[kk], sw128_desc(v_base + kk * 2048, BK * 128, 1024));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);
        } else {
          mbar_wait(full_v + st, phase);  // its bytes have landed before the stage is refilled
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_kv + st);
      }
      if (my_tiles == 0) continue;

      // Epilogue: O / l in T into the staging boxes (swizzled as TMA
      // reads them, 4-byte stores on 32 distinct banks a warp), then one TMA
      // store a box, which drops the rows past Lq.
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
      if (tid == 0) tma_store_wait_read<0>();  // the previous item's store has read the boxes
      named_barrier(1 + wg, 128);
      const int ra = 16 * wl + g;  // rows ra and ra + 8 of the boxes; both are g modulo 8
#pragma unroll
      for (int j = 0; j < WD / 8; ++j) {
        uint8_t* box = my_o + (j >> 3) * kBoxBytes + (((j & 7) ^ g) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(box + ra * 128) = pack_b16<T>(o[4 * j] * inv0,
                                                                   o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(box + (ra + 8) * 128) =
            pack_b16<T>(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int x = 0; x < WD / kBox; ++x)
          tma_store_4d(&to, my_o + x * kBoxBytes, kBox * x, h, r0, b);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Lq, Lk, E, D;
  float scale_log2;
  int causal;
  int* occ;  // set: report the launch's occupancy into it and launch nothing
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
  if (a.occ != nullptr) return occupancy(kernel, kThreads, smem, a.occ);
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

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a contiguous 16-bit [B, L, H, W] tensor of `type` (bf16 or
// f16) as dims (W, H, L, B), boxes of 64 columns x `rows` rows, 128-byte
// swizzle; reads past L fill zeros, stores past L are dropped.
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int B,
                       int L, int H, int W, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * W, 2ull * W * H, 2ull * W * H * L};  // bytes, dims 1-3
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int WE, int WD, int NC>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using Lay = WgLayout<WE, WD, NC>;
  auto kernel = mha_attention_wgmma_kernel<T, WE, WD, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::smem);
  if (err != cudaSuccess) return err;
  if (a.occ != nullptr) return occupancy(kernel, Lay::threads, Lay::smem, a.occ);
  // The consumers' setmaxnreg waits until the producer's release covers it:
  // refuse a build whose allocation at entry could not (it would hang).
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if (attr.numRegs * Lay::threads < (Lay::consumer_regs * NC + Lay::producer_regs) * 128)
    return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Lay::threads,
                                                           Lay::smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  constexpr CUtensorMapDataType type =
      is_f16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv, mo;
  if ((err = tensor_map(&mq, type, a.q, a.B, a.Lq, a.H, WE, 64)) != cudaSuccess ||
      (err = tensor_map(&mk, type, a.k, a.B, a.Lk, a.H, WE, Lay::BK)) != cudaSuccess ||
      (err = tensor_map(&mv, type, a.v, a.B, a.Lk, a.H, WD, Lay::BK)) != cudaSuccess ||
      (err = tensor_map(&mo, type, a.o, a.B, a.Lq, a.H, WD, 64)) != cudaSuccess)
    return err;
  const long long items = (long long)((a.Lq + Lay::BQ - 1) / Lay::BQ) * a.B * a.H;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const long long grid = items < (long long)sms * per_sm ? items : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, Lay::threads, Lay::smem, stream>>>(
      mq, mk, mv, mo, a.B * a.H, a.H, a.Lq, a.Lk, a.scale_log2, a.causal);
  return cudaGetLastError();
}

template <typename T, int WE>
cudaError_t launch_wgmma_d(const Args& a, cudaStream_t stream) {
  const bool two = a.Lq > 64;
  if (a.D == 64)
    return two ? launch_wgmma<T, WE, 64, 2>(a, stream) : launch_wgmma<T, WE, 64, 1>(a, stream);
  return two ? launch_wgmma<T, WE, 128, 2>(a, stream) : launch_wgmma<T, WE, 128, 1>(a, stream);
}

// The wgmma route's conditions (mha_attention.py:mha_route), held again here.
template <typename T>
cudaError_t launch_wgmma_route(const Args& a, cudaStream_t stream) {
  const bool width = (a.E == 64 || a.E == 128) && (a.D == 64 || a.D == 128);
  if (!width || a.Lq <= 32 || !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !aligned16(a.o))
    return cudaErrorInvalidValue;
  return a.E == 64 ? launch_wgmma_d<T, 64>(a, stream) : launch_wgmma_d<T, 128>(a, stream);
}

cudaError_t dispatch(const Args& a, int dtype, int route, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.E <= 0 || a.E > kMaxW || a.D <= 0 ||
      a.D > kMaxW)
    return cudaErrorInvalidValue;
  if (route == 1) {
    switch (dtype) {
      case 1: return launch_wgmma_route<__nv_bfloat16>(a, stream);
      case 2: return launch_wgmma_route<__half>(a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_dtype<float>(a, stream);
    case 1: return launch_dtype<__nv_bfloat16>(a, stream);
    case 2: return launch_dtype<__half>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; route: 0 = "mma" (every
// dtype and width), 1 = "wgmma" (bf16 or f16, Lq > 32, E and D each 64 or
// 128, 16-byte aligned tensors; else cudaErrorInvalidValue). Tensors are contiguous: q
// [B, Lq, H, E], k [B, Lk, H, E], v [B, Lk, H, D], o [B, Lq, H, D]. Returns
// a cudaError_t (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int mha_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                 int H, int Lq, int Lk, int E, int D, float scale, int causal,
                                 int dtype, int route, void* stream) {
  const Args a{q, k, v, o, B, H, Lq, Lk, E, D, scale * kLog2e, causal, nullptr};
  return (int)dispatch(a, dtype, route, static_cast<cudaStream_t>(stream));
}

// What a launch of `route` at these sizes holds of an SM, nothing
// launched: out[5] as occupancy() in bd_attention_common.cuh (the wgmma
// route's instances are chosen without the tensors' alignment).
extern "C" int mha_attention_fwd_occupancy(int B, int H, int Lq, int Lk, int E, int D, int dtype,
                                           int route, int* out) {
  // Any 16-byte aligned address stands for the tensors: nothing is read.
  const void* aligned = reinterpret_cast<const void*>(static_cast<uintptr_t>(256));
  const Args a{aligned, aligned, aligned, const_cast<void*>(aligned), B, H, Lq, Lk, E, D,
               1.f, 0, out};
  return (int)dispatch(a, dtype, route, nullptr);
}
