// Tensor-core building blocks shared by the attention kernels
// (mha_attention_fwd.cu, bd_attention_fwd.cu, bd_attention_bwd.cu):
// split-TF32, bf16 and f16 mma.sync products, 16-bit fragment loads from
// shared tiles (plain and by ldmatrix), and tile copies into shared memory
// by cp.async.
//
// Split TF32. A TF32 operand keeps 10 mantissa bits, so one TF32 pass of
// an f32 product misses the kernels' f32 tolerance (rtol 1e-4 / atol 1e-5;
// tests/test_torch_split_tf32.py shows it at L 256, E 128). Writing
// x = hi + lo with hi = tf32(x) and lo = x - hi truncated to TF32 keeps ~21 bits, and
//     a * b ~= a_hi * b_hi + a_hi * b_lo + a_lo * b_hi
// (the dropped a_lo * b_lo is ~2^-22 relative) lands as close to the exact
// product as an f32 FMA chain. Three TF32 MMAs per product: on an H100 SXM
// the f32-accurate rate is 495 / 3 = 165 TFLOP/s, against 67 on the CUDA
// cores. bf16 products are exact in f32, so a product of two bf16 inputs
// takes one bf16 MMA (m16n8k16) with f32 accumulators. A computed f32
// operand (the attention kernels' P, dS, P_drop) is split into bf16
// hi + lo, two MMAs: one rounding, as a TPU's matrix unit rounds its
// operands at default precision, misses the bf16 tolerance at the
// training batch (tests/test_torch_bf16_mma.py). f16 inputs (11
// significant bits) take the same m16n8k16 shape and fragments, and their
// products are exact in f32 too; a computed operand is rounded to f16 once
// (one MMA), which keeps the f16 tolerance (tests/test_torch_f16_mma.py).
// f16's exponent has 5 bits (largest value 65504, subnormal below 2^-14),
// so the backward scales dS by a power of two before it rounds it
// (bd_attention_bwd.cu).
//
// Fragment layouts of mma.sync (PTX ISA), lane = 4 * g + t:
//   m16n8k8 tf32   A 16x8 (row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//                  B 8x8 (col):  b0 (k t, n g), b1 (k t+4, n g)
//   m16n8k16 16-bit (bf16 or f16)
//                  A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//                  B 16x8:  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8 (all):  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// The k index of a product is a sum index, so a kernel may map it to its
// data in any order, as long as A and B agree: the TF32 kernels read the
// k columns (t, t+4) of a step from the adjacent elements (2t, 2t+1), which
// turns Q and K fragment reads into 8-byte loads and lets a C fragment of
// scores serve as the A fragment of P with no shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bd_attention_common.cuh"

// x rounded to TF32: nearest, ties away from zero, as cvt.rna.tf32.f32 for
// every finite x (half a TF32 ulp added to the magnitude, the 13 low bits
// cleared; a carry moves into the exponent). On sm_90 cvt.rna.tf32.f32
// compiles to four instructions with an inf/NaN guard; this is two, and
// the split below is the inner loops' main ALU cost.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = to_tf32(x); x - hi is exact in f32 and below half a
// TF32 ulp of x, and lo is it truncated to TF32 (error <= 2^-21 |x|, the
// size of the dropped lo * lo term). The tensor core reads only the 19 high
// bits of a TF32 operand, so lo goes in as the f32 bits of x - hi and the
// MMA truncates it: three instructions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// c += a * b, one TF32 pass, m16n8k8.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b at f32 accuracy from split fragments: the two small products
// go into the accumulator before the large one.
__device__ __forceinline__ void mma_split_tf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                               const uint32_t (&a_lo)[4],
                                               const uint32_t (&b_hi)[2],
                                               const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// The 16-bit input types of the m16n8k16 MMAs: __nv_bfloat16 and __half.
template <typename H>
constexpr bool is_f16 = std::is_same_v<H, __half>;

// void for a 16-bit H, no type for float: the return type of the kernels'
// 16-bit overloads, which keeps a float call on its own overload.
template <typename H>
using b16_void = std::enable_if_t<sizeof(H) == 2>;

// c += a * b, bf16 inputs, f32 accumulators, m16n8k16.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b, f16 inputs, f32 accumulators, m16n8k16.
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b for inputs of the 16-bit type H.
template <typename H>
__device__ __forceinline__ void mma_b16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  if constexpr (is_f16<H>) mma_f16(c, a, b);
  else mma_bf16(c, a, b);
}

// Two floats as a bf16 pair: `lo` in the low half (the lower k or n index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as an f16 pair (nearest even, subnormals kept).
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename H>
__device__ __forceinline__ uint32_t pack_b16(float lo, float hi) {
  if constexpr (is_f16<H>) return pack_f16(lo, hi);
  else return pack_bf16(lo, hi);
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i, r[i] holds matrix i in B-fragment order.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// 16-bit m16n8k16 fragments from shared tiles (lane = 4 * g + t), H bf16
// or f16. The kernels pitch such tiles at 8 elements more than a multiple
// of 16: rows are an odd number of 16-byte units, so the 8 rows of an
// ldmatrix matrix, and the 8 rows x 4 lanes of a 32-bit fragment load,
// fall on distinct banks, and every row starts 16-byte aligned (cp.async,
// ldmatrix).

// Two adjacent 16-bit values as one 32-bit word (the lower index in the low half).
template <typename H>
__device__ __forceinline__ uint32_t ld_b16x2(const H* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A of a row-major tile X [m][k]: p = &X[g][2t] of the 16 x 16 block.
template <typename H>
__device__ __forceinline__ void frag_a_b16(uint32_t (&a)[4], const H* p, int pitch) {
  a[0] = ld_b16x2(p);
  a[1] = ld_b16x2(p + 8 * pitch);
  a[2] = ld_b16x2(p + 8);
  a[3] = ld_b16x2(p + 8 * pitch + 8);
}

// B of a tile stored n-major, X [n][k] (B = X^T): p = &X[g][2t] of the 8 x 16 block.
template <typename H>
__device__ __forceinline__ void frag_b_b16(uint32_t (&b)[2], const H* p) {
  b[0] = ld_b16x2(p);
  b[1] = ld_b16x2(p + 8);
}

// A of X^T for a row-major tile X [k][m] (A's rows are X's columns), by
// ldmatrix.trans: p = &X[0][0] of the 16 x 16 block.
template <typename H>
__device__ __forceinline__ void frag_a_trans_b16(uint32_t (&a)[4], const H* p, int pitch,
                                                 int lane) {
  const int i = lane >> 3;  // matrix i: k rows 8 * (i >> 1), m columns 8 * (i & 1)
  ldmatrix_x4_trans(a, p + ((lane & 7) + 8 * (i >> 1)) * pitch + 8 * (i & 1));
}

// B of n-tiles 0 and 1 of a row-major tile X [k][n] (B = X), by
// ldmatrix.trans: p = &X[0][0] of the 16 x 16 block.
template <typename H>
__device__ __forceinline__ void frag_b2_trans_b16(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                                  const H* p, int pitch, int lane) {
  uint32_t r[4];
  ldmatrix_x4_trans(r, p + (lane & 15) * pitch + 8 * (lane >> 4));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// Split bf16: x = hi + lo with hi = bf16(x) and lo = bf16(x - hi) (x - hi
// is exact in f32; both rounded to nearest even) keeps ~16 significant
// bits, ~2^-17 relative, where one bf16 rounding keeps 8. Two bf16 MMAs a
// product, a_lo * b + a_hi * b.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// A computed f32 operand (P, P_drop, dS) as the A fragment of an MMA of
// type H: bf16 split into hi and lo (split_bf16), f16 rounded once into hi
// (lo is not set). A pair of elements at a time.
template <typename H>
__device__ __forceinline__ void operand_b16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  if constexpr (is_f16<H>) hi = pack_f16(x0, x1);
  else split_bf16(x0, x1, hi, lo);
}

// The A fragments (operand_b16) of the C fragments of two adjacent 8-column
// tiles (k = their 16 columns, in order).
template <typename H>
__device__ __forceinline__ void operand_from_c(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&c0)[4], const float (&c1)[4]) {
  operand_b16<H>(c0[0], c0[1], hi[0], lo[0]);
  operand_b16<H>(c0[2], c0[3], hi[1], lo[1]);
  operand_b16<H>(c1[0], c1[1], hi[2], lo[2]);
  operand_b16<H>(c1[2], c1[3], hi[3], lo[3]);
}

// c += a * b for a computed operand a: bf16 (a_hi + a_lo) * b in two MMAs,
// the small product first; f16 a_hi * b in one.
template <typename H>
__device__ __forceinline__ void mma_operand(float (&c)[4], const uint32_t (&a_hi)[4],
                                            const uint32_t (&a_lo)[4], const uint32_t (&b)[2]) {
  if constexpr (!is_f16<H>) mma_bf16(c, a_lo, b);
  mma_b16<H>(c, a_hi, b);
}

// 16 bytes global -> shared without the register file; `valid` false
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :
               : "r"(s), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// `rows` rows of `cols` elements, source row r at src + r * stride, into
// shared rows of `pitch` elements; rows >= valid become zero; columns past
// `cols` are not written. VEC: 16-byte cp.async (S == D; cols, stride and
// src in 16-byte units), one division a call when the 16-byte chunks of a
// row divide the thread count; else plain loads, converted to D.
template <bool VEC, typename D, typename S>
__device__ __forceinline__ void load_rows(D* dst, int pitch, const S* src, size_t stride, int rows,
                                          int valid, int cols, int tid, int nthreads) {
  if constexpr (VEC) {
    static_assert(sizeof(D) == sizeof(S), "cp.async copies bytes");
    constexpr int C = 16 / sizeof(S);
    const int chunks = cols / C;
    if (nthreads % chunks == 0) {
      const int c = (tid % chunks) * C, step = nthreads / chunks;
      for (int r = tid / chunks; r < rows; r += step) {
        const bool ok = r < valid;
        cp_async16(dst + r * pitch + c, src + (ok ? r * stride + c : 0), ok);
      }
      return;
    }
    for (int x = tid; x < rows * chunks; x += nthreads) {
      const int r = x / chunks, c = (x - r * chunks) * C;
      const bool ok = r < valid;
      cp_async16(dst + r * pitch + c, src + (ok ? r * stride + c : 0), ok);
    }
  } else {
    for (int x = tid; x < rows * cols; x += nthreads) {
      const int r = x / cols, c = x - r * cols;
      dst[r * pitch + c] = from_f32<D>(r < valid ? to_f32(src[r * stride + c]) : 0.f);
    }
  }
}
