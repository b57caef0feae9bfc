// Nearest-codeword snap for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ops/pallas/quant.py:_codeword_kernel (launched by
// fused_nearest_codeword) of channelestimationtransformer_tpu. For each
// element x of a float32 tensor and a float32 codebook c[0..N):
//
//     best = c[0]; for j = 1 .. N-1: if |x - c[j]| < |x - best|: best = c[j]
//
// a linear scan with strict `<`, so ties go to the lowest index, distances
// |x - c| computed in f32 (no sortedness assumed: any codebook).
//
// The TPU kernel keeps the codebook in SMEM and pads the tensor to
// 512 x 1024 blocks; nothing is padded here. Each block stages the codebook
// in shared memory once (N * 4 bytes); every thread of a warp then reads the
// same entry, a broadcast. One thread takes one element, in a grid-stride
// loop over any element count: at the LSQ path's 16,384 elements that is
// 64 blocks of 256 threads. Four elements a thread with float4 accesses
// (16 blocks, the earlier design) measured slower there on an H100
// (PERF.md): a launch waits on the chain of comparisons per thread, not on
// the reads.
//
// LSQ mode. On the LSQ-fibbinary path (ops/quant/lsq.py:lsq_quantize) the
// snap sits inside the chain of a DenseLSQ forward, each step a separate
// eager op. This mode does the whole chain in the same launch, from the
// weight w and the step size (one f32 on the device, read by every thread,
// so nothing syncs to the host), with g, Qn and Qp as arguments:
//
//     s  = (step - step * g) + step * g      grad_scale's value
//     x  = clamp(w / s, Qn, Qp)              NaN stays NaN
//     wq = ((snap(x) - x) + x) * s           codebook_pass's value, times s
//
// one IEEE operation a step (__fmul_rn, __fsub_rn, __fadd_rn, __fdiv_rn: no
// fused multiply-add), as torch computes each op of the chain on its own
// (g enters as a Python float, which torch rounds to f32 before the
// product), so the result equals the eager chain bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): 8 bytes an element,
// 2 f32 operations (a subtraction and a comparison) an (element, codeword)
// pair. At the LSQ path's tensors (16,384 elements, N = 67) both take
// 0.04 us or less, so a launch costs its fixed overhead; at 2^24 elements
// and N = 287 the operations bound it (144 us against 40 us of bytes).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct LsqArgs {
  const float* step;  // null: the plain snap
  float g, qn, qp;
};

template <bool LSQ>
__global__ void __launch_bounds__(kThreads)
nearest_codeword_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                        float* __restrict__ y, long long n, int ncb, LsqArgs lsq) {
  extern __shared__ float cbs[];
  for (int t = threadIdx.x; t < ncb; t += blockDim.x) cbs[t] = cb[t];
  float s = 0.f;
  if constexpr (LSQ) {
    const float step = *lsq.step, p = __fmul_rn(step, lsq.g);
    s = __fadd_rn(__fsub_rn(step, p), p);
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = x[i];
    if constexpr (LSQ) {
      const float q = __fdiv_rn(v, s);
      v = isnan(q) ? q : fminf(fmaxf(q, lsq.qn), lsq.qp);
    }
    float best = cbs[0], best_d = fabsf(__fsub_rn(v, best));
    for (int j = 1; j < ncb; ++j) {
      const float c = cbs[j], d = fabsf(__fsub_rn(v, c));
      if (d < best_d) {
        best_d = d;
        best = c;
      }
    }
    if constexpr (LSQ) best = __fmul_rn(__fadd_rn(__fsub_rn(best, v), v), s);
    y[i] = best;
  }
}

template <bool LSQ>
int launch(const float* x, const float* cb, float* y, long long n, int ncb, LsqArgs lsq,
           void* stream) {
  if (n <= 0 || ncb <= 0 || ncb > 12288) return (int)cudaErrorInvalidValue;
  const long long need = (n + kThreads - 1) / kThreads;
  const int blocks = need < kMaxBlocks ? (int)need : kMaxBlocks;
  const size_t smem = sizeof(float) * (size_t)ncb;
  nearest_codeword_kernel<LSQ>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, cb, y, n, ncb, lsq);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return a cudaError_t (0 on success); launch on `stream` and do not
// synchronise. n must be positive; 0 < ncb <= 12,288 (48 KB of shared
// memory).
extern "C" int nearest_codeword(const float* x, const float* cb, float* y, long long n,
                                int ncb, void* stream) {
  return launch<false>(x, cb, y, n, ncb, LsqArgs{nullptr, 0.f, 0.f, 0.f}, stream);
}

// The LSQ mode: y = the chain above on the weight w, `step` one f32 on the
// device.
extern "C" int nearest_codeword_lsq(const float* w, const float* step, const float* cb,
                                    float* y, long long n, int ncb, float g, float qn, float qp,
                                    void* stream) {
  if (step == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(w, cb, y, n, ncb, LsqArgs{step, g, qn, qp}, stream);
}
