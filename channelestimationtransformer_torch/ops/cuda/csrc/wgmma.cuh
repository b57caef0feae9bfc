// Hopper (sm_90a) building blocks of the wgmma route of mha_attention_fwd.cu:
// shared-memory matrix descriptors for 128-byte-swizzled 16-bit (bf16 or
// f16) tiles, the warpgroup MMA (wgmma) with its fence / commit / wait,
// mbarriers with a phase bit, TMA tile loads and stores
// (cp.async.bulk.tensor) over a 4-D tensor map, the async-proxy fence,
// register reallocation (setmaxnreg) and named barriers. Written here from
// the PTX ISA; no kernel library's code.
//
// Tiles. A TMA box of 64 16-bit columns (128 bytes) x R rows, loaded with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned buffer, lies as R rows
// of 128 bytes whose 16-byte chunk c of row r sits at chunk c ^ (r % 8). A
// width of 128 takes two such boxes, one after the other. wgmma reads such a
// tile through a descriptor:
//   K-major (rows are M or N, the 64 columns are K): 8-row groups 1024 bytes
//     apart (SBO); the k16 step s of the box starts 32 * s bytes in (the
//     hardware applies the swizzle to the address it forms);
//   MN-major (rows are K, columns are N): B of P V, the V tile [keys][D]
//     with the transpose bit; 8 K rows a group, 1024 bytes apart (SBO); the
//     next 64 N columns are the next box, LBO bytes on; the k16 step s starts
//     2048 * s bytes in.
//
// wgmma accumulators (m64nN, f32): warp w of the warpgroup holds rows
// 16w + g and 16w + g + 8 (lane = 4g + t); register 4j + i of a thread is
// row g (i < 2) or g + 8 (i >= 2), column 8j + 2t + (i & 1): the C fragment
// of mma.sync m16n8k16 for each 8-column block j. The A operand from
// registers is the m16n8k16 A fragment of the warp's 16 rows, so the C
// fragments of keys 16kk .. 16kk + 15 of S, packed in pairs to 16 bits, are
// the A operand of the k16 step kk of P V, as with mma.sync.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // is_f16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned, or that plus a k16 offset within a 128-byte row):
// start address, leading and stride byte offsets in 16-byte units, layout
// type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warp are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator array in place around wgmma issue and wait: the
// compiler may not move its reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The accumulator operands of an m64nNk16 wgmma: "+f" constraints on
// d[0 .. N/2 - 1] and their register list.
#define WGMMA_D32 \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WGMMA_D64 \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
        "+f"(d[62]), "+f"(d[63])
#define WGMMA_R32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_R64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63"

// The instruction of an m64nNk16 wgmma with f32 accumulators and inputs of
// type TY ("bf16" or "f16").
#define WGMMA_OP(N, TY) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "

// d = A B^T (scale_d 0) or d += A B^T: A [64][16] and B [64][16], both K-major in
// shared memory, given by their descriptors; inputs of the 16-bit type H.
template <typename H>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
#define WGMMA_SS_N64(TY)                                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" WGMMA_OP(64, TY) "{" \
               WGMMA_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                       \
               : WGMMA_D32                                                          \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))
  if constexpr (is_f16<H>) WGMMA_SS_N64("f16");
  else WGMMA_SS_N64("bf16");
#undef WGMMA_SS_N64
}

// d = A B^T (scale_d 0) or d += A B^T: A [64][16] and B [128][16], both K-major in
// shared memory, given by their descriptors; inputs of the 16-bit type H.
template <typename H>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
#define WGMMA_SS_N128(TY)                                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" WGMMA_OP(128, TY) "{" \
               WGMMA_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                        \
               : WGMMA_D64                                                           \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))
  if constexpr (is_f16<H>) WGMMA_SS_N128("f16");
  else WGMMA_SS_N128("bf16");
#undef WGMMA_SS_N128
}

// d += A B: A [64][16] from registers (each warp's 16 rows as the m16n8k16 A
// fragment), B [16][64] MN-major in shared memory (the transpose bit set).
template <typename H>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
#define WGMMA_RS_N64(TY)                                                   \
  asm volatile(WGMMA_OP(64, TY) "{" WGMMA_R32 "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n" \
               : WGMMA_D32                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b))
  if constexpr (is_f16<H>) WGMMA_RS_N64("f16");
  else WGMMA_RS_N64("bf16");
#undef WGMMA_RS_N64
}

// d += A B: A [64][16] from registers (each warp's 16 rows as the m16n8k16 A
// fragment), B [16][128] MN-major in shared memory (the transpose bit set).
template <typename H>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
#define WGMMA_RS_N128(TY)                                                  \
  asm volatile(WGMMA_OP(128, TY) "{" WGMMA_R64 "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n" \
               : WGMMA_D64                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b))
  if constexpr (is_f16<H>) WGMMA_RS_N128("f16");
  else WGMMA_RS_N128("bf16");
#undef WGMMA_RS_N128
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with parity `parity` has completed. A
// wait past ~2^31 cycles (over a second) traps: a lost arrival or a wrong
// transaction count then fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 31)) {
      __trap();
    }
  }
}

// --- TMA --------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box of `map` at coordinates (c0, c1, c2, c3) into shared memory at
// `dst`, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Shared memory at `src` into the box of `map` at (c0, c1, c2, c3); the
// elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N committed stores still read their shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until every committed store has completed.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (a TMA store, a wgmma operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- warp specialisation ----------------------------------------------------

// Registers a thread of this warpgroup may hold from here on, taken from or
// given back to the block's pool; every warp of the warpgroup executes it.
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
