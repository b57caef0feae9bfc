// Circular convolution with three taps over [B, L, C] activations, forward
// and gradients, for Hopper (sm_90a); plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to XLA
// (lax.conv_general_dilated in models/embed.py:circular_conv1d), and the
// port first left it to cuDNN (F.pad circular + F.conv1d). With TF32 off
// cuDNN takes FFT algorithms for the gradients at the flagship's shapes,
// ~90x the time of its forward, and they were most of a training step
// (PERF.md). These kernels compute, with the wrap inside the index,
//
//   forward  y[b,l,o]  = sum_t sum_i x[b,(l+t-1) mod L,i] W[o,i,t] + bias[o]
//   dgrad    dx[b,l,i] = sum_t sum_o dy[b,(l-t+1) mod L,o] W[o,i,t]
//   wgrad    dW[o,i,t] = sum_{b,l} dy[b,l,o] x[b,(l+t-1) mod L,i],
//            db[o]     = sum_{b,l} dy[b,l,o]
//
// in float32 on the CUDA cores (FFMA; no TF32 anywhere), on the tensors as
// they lie: no pad copy, no transposes. The data gradient is the forward
// with W transposed and its taps flipped, so one kernel, shift_kernel<TRANS>,
// computes both.
//
// Bound on an H100 SXM (67 TFLOP/s FFMA, 3.35 TB/s). At the flagship's batch
// 1024 the seven convolutions of a training step (two embeddings, C_in 16,
// and five distil convs, C 128, at L 90, 45, 23, 45, 23) take 24.1 GFLOP
// forward and 46.8 backward (the distil convs' dgrad and all seven wgrads),
// 0.36 and 0.70 ms at the FFMA rate; their tensors are ~0.25 GB forward and
// ~0.5 GB backward, 0.08 and 0.15 ms. So operations bound every call.
//
// Design: both kernels are tiled matrix products whose operands are staged
// through shared memory by registers (loads of the next stage in flight
// while the current one is multiplied; one barrier a stage), 8 x 8 outputs a
// thread as outer products of two float4 pairs.
// - shift_kernel: rows (b, l) x output channels. A tile is 96 rows by 128
//   channels: whole sequences where L <= 96 (one at L 90, two at 45, four at
//   23, six at 15), else 96 positions of one sequence. For each tile row the
//   staging computes its three source rows (l + t - 1 wrapped inside its own
//   sequence) once, so the wrap costs nothing in the product. A stage holds
//   8 input channels of all three taps (24 steps of the sum): the gathered
//   rows transposed to [tap][c][row], and W's [tap][c][n] slice, read from
//   W's [C_out, C_in, 3] layout in its own contiguous order.
// - wgrad_kernel: output channels o x (tap, i) flattened, summed over the
//   B*L rows. The rows are split across blocks (about one wave of the card's
//   resident blocks), each writing a partial dW (and db, from the tile that
//   holds the first taps) into a buffer the wrapper allocates; a stage holds
//   16 rows of dy and of the three shifted x rows. wgrad_reduce_kernel then
//   sums the partials in split order and writes dW in [C_out, C_in, 3]. No
//   atomics: two runs give the same bits.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --conv; PERF.md):
// a flagship training step's 7 forwards take ~0.77 ms (cuDNN's implicit GEMM
// 0.92, 1.44 with the pad and transposes it needs), its 5 data gradients
// ~0.74 and 7 weight gradients ~0.86 (cuDNN's FFT gradients ~84 ms): about
// 2.1-2.4x the FFMA bound. At 160-168 registers two 192-thread blocks share
// an SM; the 128-column weight-gradient instance is held to 128 registers
// for two 256-thread blocks and spills 16 bytes outside its inner loop.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kTaps = 3;

// ---- shift_kernel: forward (TRANS false) and data gradient (TRANS true) ----
constexpr int kRows = 96;    // output rows a tile
constexpr int kCols = 128;   // output channels a tile
constexpr int kDepth = 8;    // input channels a stage, of each tap
constexpr int kShiftThreads = (kRows / 8) * (kCols / 8);  // 192
constexpr int kAPitch = kRows + 4;  // As[tap][c][row]
constexpr int kBPitch = kCols + 4;  // Bs[tap][c][n]
constexpr int kAStage = kTaps * kDepth * kAPitch;
constexpr int kBStage = kTaps * kDepth * kBPitch;
constexpr int kShiftSmem = 2 * (kAStage + kBStage) * (int)sizeof(float);
// Staging roles: a thread stages channel tid % kDepth of rows tid / kDepth
// + kARowStep * q for each tap, and kBLoads weights.
constexpr int kARowStep = kShiftThreads / kDepth;  // 24
constexpr int kARows = kRows / kARowStep;           // 4
constexpr int kBLoads = kTaps * kDepth * kCols / kShiftThreads;  // 16
static_assert(kShiftThreads % kDepth == 0 && kRows % kARowStep == 0, "A staging");
static_assert(kShiftThreads == 8 * kTaps * kDepth && kBLoads == kCols / 8, "forward W staging");
static_assert(2 * kShiftThreads == kTaps * kCols && kBLoads == 2 * kDepth, "dgrad W staging");

// ---- wgrad_kernel ----
constexpr int kWRows = 16;  // rows of the sum a stage
constexpr int kWM = 128;    // output channels o a tile

template <int BN>
struct WCfg {
  static constexpr int threads = (kWM / 8) * (BN / 8);  // 256 or 128
  static constexpr int a_pitch = kWM + 4;              // As[row][o]
  static constexpr int b_pitch = BN + 4;               // Bs[row][tap, i]
  static constexpr int a_stage = kWRows * a_pitch;
  static constexpr int b_stage = kWRows * b_pitch;
  static constexpr int smem = 2 * (a_stage + b_stage) * (int)sizeof(float);
  static constexpr int a_step = threads / kWM;  // rows apart of a thread's dy loads
  static constexpr int a_loads = kWRows / a_step;
  static constexpr int b_step = threads / BN;
  static constexpr int b_loads = kWRows / b_step;
  static_assert(threads % kWM == 0 && threads % BN == 0, "wgrad staging");
};

constexpr int kReduceThreads = 256;

// Where output row m of tile t lies: whole sequences a tile (per_tile of
// them) where L <= rows, else `span` tiles a sequence.
struct Geometry {
  int B, L, per_tile, span;

  __device__ bool locate(int t, int m, int rows, int& b, int& l) const {
    if (per_tile > 0) {
      const int s = m / L;
      b = t * per_tile + s;
      l = m - s * L;
      return s < per_tile && b < B;
    }
    b = t / span;
    l = (t - b * span) * rows + m;
    return l < L;
  }
};

Geometry geometry(int B, int L, int rows, int* tiles) {
  Geometry g{B, L, 0, 0};
  if (L <= rows) {
    g.per_tile = rows / L;
    *tiles = (B + g.per_tile - 1) / g.per_tile;
  } else {
    g.span = (L + rows - 1) / rows;
    *tiles = B * g.span;
  }
  return g;
}

// Row offset, in rows of the [B*L, C] tensor, of tap t's source for (b, l):
// l + t - 1 wrapped inside sequence b.
__device__ __forceinline__ int wrapped_row(int b, int l, int tap, int L) {
  int j = l + tap - 1;
  j = j < 0 ? j + L : (j >= L ? j - L : j);
  return b * L + j;
}

__device__ __forceinline__ void outer8(float (&acc)[8][8], float4 a0, float4 a1, float4 b0,
                                       float4 b1) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// out[row, n] = sum_t sum_c in[src_t(row), c] * Wt(t, c, n) (+ bias[n]), with
//   TRANS false (forward):  C = C_in, N = C_out, Wt(t, c, n) = w[n][c][t];
//   TRANS true (dgrad):     C = C_out, N = C_in, Wt(t, c, n) = w[c][n][2 - t],
// w in [C_out, C_in, 3]; src_t(b, l) = (b, l + t - 1 mod L) for the forward.
// The dgrad's source is l - t + 1 = l + t' - 1 with t' = 2 - t: the flip.
template <bool TRANS>
__global__ void __launch_bounds__(kShiftThreads, 2)
    shift_kernel(const float* __restrict__ in, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out, Geometry g, int C,
                 int N) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int t = blockIdx.x, n0 = blockIdx.y * kCols;
  const int c_in = TRANS ? N : C;

  // Input staging: channel sc of rows srow + kARowStep * q, each tap.
  const int sc = tid % kDepth, srow = tid / kDepth;
  int a_off[kTaps][kARows];  // element offset of the source row, -1 outside
#pragma unroll
  for (int q = 0; q < kARows; ++q) {
    int b, l;
    const bool ok = g.locate(t, srow + kARowStep * q, kRows, b, l);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
      a_off[tap][q] = ok ? wrapped_row(b, l, tap, g.L) * C : -1;
  }
  // Weight staging, in w's own order. Forward: a run of kTaps * kDepth
  // floats (c, t) of output channel n = tid / 24 + 8 j. Dgrad: a run of
  // kTaps * kCols floats (n, t) of channel c = j / 2, r = tid + 192 (j % 2).
  int w_base, w_tap, w_c, w_n;
  if constexpr (TRANS) {
    w_base = n0 * kTaps + tid;
    w_n = tid / kTaps;
    w_tap = kTaps - 1 - tid % kTaps;
    w_c = 0;
  } else {
    const int r = tid % (kTaps * kDepth);
    w_n = tid / (kTaps * kDepth);
    w_c = r / kTaps;
    w_tap = r % kTaps;
    w_base = ((n0 + w_n) * c_in + w_c) * kTaps + w_tap;
  }

  float ra[kTaps][kARows], rb[kBLoads];
  auto load = [&](int c0) {
    const bool c_ok = c0 + sc < C;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
      for (int q = 0; q < kARows; ++q)
        ra[tap][q] = (c_ok && a_off[tap][q] >= 0) ? __ldg(in + a_off[tap][q] + c0 + sc) : 0.f;
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      if constexpr (TRANS) {
        const int c = j / 2, n = w_n + (j % 2) * (kShiftThreads / kTaps);
        const bool ok = c0 + c < C && n0 + n < N;
        rb[j] = ok ? __ldg(w + (size_t)(c0 + c) * c_in * kTaps + w_base +
                           (j % 2) * kShiftThreads)
                   : 0.f;
      } else {
        const int n = w_n + j * (kShiftThreads / (kTaps * kDepth));
        const bool ok = c0 + w_c < C && n0 + n < N;
        rb[j] = ok ? __ldg(w + w_base + (size_t)j * (kShiftThreads / (kTaps * kDepth)) * c_in *
                                            kTaps + c0 * kTaps)
                   : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
    float* const As = smem + buf * (kAStage + kBStage);
    float* const Bs = As + kAStage;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
      for (int q = 0; q < kARows; ++q)
        As[(tap * kDepth + sc) * kAPitch + srow + kARowStep * q] = ra[tap][q];
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      if constexpr (TRANS) {  // r + 192 has r's tap: 192 is a multiple of 3
        const int c = j / 2, n = w_n + (j % 2) * (kShiftThreads / kTaps);
        Bs[(w_tap * kDepth + c) * kBPitch + n] = rb[j];
      } else {
        const int n = w_n + j * (kShiftThreads / (kTaps * kDepth));
        Bs[(w_tap * kDepth + w_c) * kBPitch + n] = rb[j];
      }
    }
  };

  const int tm = tid / (kCols / 8), tn = tid % (kCols / 8);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int stages = (C + kDepth - 1) / kDepth;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) load((s + 1) * kDepth);
    const float* const As = smem + (s & 1) * (kAStage + kBStage);
    const float* const Bs = As + kAStage;
#pragma unroll
    for (int k = 0; k < kTaps * kDepth; ++k) {
      const float* a = As + k * kAPitch + tm * 8;
      const float* b = Bs + k * kBPitch + tn * 4;
      outer8(acc, *reinterpret_cast<const float4*>(a), *reinterpret_cast<const float4*>(a + 4),
             *reinterpret_cast<const float4*>(b),
             *reinterpret_cast<const float4*>(b + kCols / 2));
    }
    if (s + 1 < stages) store((s + 1) & 1);
    __syncthreads();
  }

  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j / 4) * (kCols / 2) + tn * 4 + j % 4;
    bv[j] = (bias != nullptr && n < N) ? bias[n] : 0.f;
  }
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int b, l;
    if (!g.locate(t, tm * 8 + i, kRows, b, l)) continue;
    float* const row = out + (size_t)(b * g.L + l) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (kCols / 2) + tn * 4;
      const float v[4] = {acc[i][4 * h] + bv[4 * h], acc[i][4 * h + 1] + bv[4 * h + 1],
                          acc[i][4 * h + 2] + bv[4 * h + 2], acc[i][4 * h + 3] + bv[4 * h + 3]};
      if (vec && n + 3 < N) {
        *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = v[e];
      }
    }
  }
}

// Partial dW of one split of the rows: part[split][o][tap * C_in + i] =
// sum over the split's rows r = (b, l) of dy[r][o] * x[(b, l + tap - 1 mod
// L)][i]; the blocks of column tile 0 also write part_db[split][o] = sum
// dy[r][o] (when part_db is not null).
template <int BN>
__global__ void __launch_bounds__(WCfg<BN>::threads, 2)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 float* __restrict__ part, float* __restrict__ part_db, int L, int rows,
                 int c_in, int c_out, int rows_per_split) {
  using Cfg = WCfg<BN>;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int n3 = kTaps * c_in;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kWM, split = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, rows);

  // dy staging: channel m0 + ao of rows ar + a_step * j.
  const int ao = tid % kWM, ar = tid / kWM;
  const bool ao_ok = m0 + ao < c_out;
  // x staging: column n0 + bn = (tap, i) of rows br + b_step * j.
  const int bn = tid % BN, br = tid / BN;
  const bool bn_ok = n0 + bn < n3;
  const int b_tap = bn_ok ? (n0 + bn) / c_in : 0;
  const int b_i = (n0 + bn) - b_tap * c_in;
  int l_first = (r0 + br) % L;  // position in its sequence of the thread's first x row

  float ra[Cfg::a_loads], rb[Cfg::b_loads];
  auto load = [&](int rs) {
#pragma unroll
    for (int j = 0; j < Cfg::a_loads; ++j) {
      const int r = rs + ar + Cfg::a_step * j;
      ra[j] = (ao_ok && r < r1) ? __ldg(dy + (size_t)r * c_out + m0 + ao) : 0.f;
    }
    int l = l_first;
#pragma unroll
    for (int j = 0; j < Cfg::b_loads; ++j) {
      const int r = rs + br + Cfg::b_step * j;
      const int shift = b_tap == 0 ? (l == 0 ? L - 1 : -1)
                                   : (b_tap == 2 ? (l == L - 1 ? 1 - L : 1) : 0);
      rb[j] = (bn_ok && r < r1) ? __ldg(x + (size_t)(r + shift) * c_in + b_i) : 0.f;
      l += Cfg::b_step;
      while (l >= L) l -= L;
    }
    l_first += kWRows;
    while (l_first >= L) l_first -= L;
  };
  auto store = [&](int buf) {
    float* const As = smem + buf * (Cfg::a_stage + Cfg::b_stage);
    float* const Bs = As + Cfg::a_stage;
#pragma unroll
    for (int j = 0; j < Cfg::a_loads; ++j) As[(ar + Cfg::a_step * j) * Cfg::a_pitch + ao] = ra[j];
#pragma unroll
    for (int j = 0; j < Cfg::b_loads; ++j) Bs[(br + Cfg::b_step * j) * Cfg::b_pitch + bn] = rb[j];
  };

  const int tm = tid / (BN / 8), tn = tid % (BN / 8);
  const bool with_db = part_db != nullptr && blockIdx.x == 0 && tid < kWM;
  float acc[8][8], db = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int stages = (r1 - r0 + kWRows - 1) / kWRows;
  load(r0);
  store(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) load(r0 + (s + 1) * kWRows);
    const float* const As = smem + (s & 1) * (Cfg::a_stage + Cfg::b_stage);
    const float* const Bs = As + Cfg::a_stage;
#pragma unroll
    for (int k = 0; k < kWRows; ++k) {
      const float* a = As + k * Cfg::a_pitch + tm * 8;
      const float* b = Bs + k * Cfg::b_pitch + tn * 4;
      outer8(acc, *reinterpret_cast<const float4*>(a), *reinterpret_cast<const float4*>(a + 4),
             *reinterpret_cast<const float4*>(b), *reinterpret_cast<const float4*>(b + BN / 2));
    }
    if (with_db) {
#pragma unroll
      for (int k = 0; k < kWRows; ++k) db += As[k * Cfg::a_pitch + tid];
    }
    if (s + 1 < stages) store((s + 1) & 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = m0 + tm * 8 + i;
    if (o >= c_out) continue;
    float* const row = part + ((size_t)split * c_out + o) * n3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j / 4) * (BN / 2) + tn * 4 + j % 4;
      if (n < n3) row[n] = acc[i][j];
    }
  }
  if (with_db && m0 + tid < c_out) part_db[(size_t)split * c_out + m0 + tid] = db;
}

// dW[o][i][tap] = sum over splits, in order, of part[split][o][tap * C_in + i];
// db[o] likewise from part_db (when db is not null).
__global__ void __launch_bounds__(kReduceThreads)
    wgrad_reduce_kernel(const float* __restrict__ part, const float* __restrict__ part_db,
                        float* __restrict__ dw, float* __restrict__ db, int c_in, int c_out,
                        int splits) {
  const int n3 = kTaps * c_in, size = c_out * n3;
  const int idx = blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx < size) {
    float s = 0.f;
#pragma unroll 8
    for (int p = 0; p < splits; ++p) s += __ldg(part + (size_t)p * size + idx);
    const int o = idx / n3, n = idx - o * n3, tap = n / c_in, i = n - tap * c_in;
    dw[((size_t)o * c_in + i) * kTaps + tap] = s;
  } else if (db != nullptr && idx < size + c_out) {
    const int o = idx - size;
    float s = 0.f;
#pragma unroll 8
    for (int p = 0; p < splits; ++p) s += __ldg(part_db + (size_t)p * c_out + o);
    db[o] = s;
  }
}

// Sets the kernel's dynamic shared memory to `smem` bytes where that is
// above the default 48 KB; refuses less than the kernel needs. A refusal is
// taken off the runtime's last error, so that it is reported once, here,
// and not again by the next launch's check.
template <typename K>
cudaError_t prepare(K kernel, int smem, int needed) {
  if (smem < needed) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

bool too_large(long long rows, long long cols) { return rows * cols >= INT_MAX; }

template <int BN>
cudaError_t wgrad_splits_for(int rows, int tiles, int smem, int* splits) {
  const cudaError_t err0 = prepare(wgrad_kernel<BN>, smem, WCfg<BN>::smem);
  if (err0 != cudaSuccess) return err0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_kernel<BN>,
                                                        WCfg<BN>::threads, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (rows + kWRows - 1) / kWRows;
  int n = max(1, per_sm * sms / tiles);
  n = min(n, chunks);
  const int per = (chunks + n - 1) / n * kWRows;  // rows a split, whole stages
  *splits = (rows + per - 1) / per;
  return cudaSuccess;
}

int wgrad_bn(int c_in) { return kTaps * c_in <= 64 ? 64 : 128; }

}  // namespace

// Dynamic shared memory, in bytes, that a launch of `kind` needs: 0 the
// forward / data-gradient kernel, 1 the weight-gradient kernel at this C_in.
// The wrappers pass it back as the launch's `smem`. Returns a cudaError_t.
extern "C" int circular_conv1d_smem(int kind, int c_in, int* bytes) {
  if (bytes == nullptr || c_in <= 0) return (int)cudaErrorInvalidValue;
  if (kind == 0) *bytes = kShiftSmem;
  else if (kind == 1) *bytes = wgrad_bn(c_in) == 64 ? WCfg<64>::smem : WCfg<128>::smem;
  else return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// Forward (transposed 0: in = x [B, L, C_in], out [B, L, C_out], bias
// [C_out] or null) or data gradient (transposed 1: in = dy [B, L, C_out],
// out = dx [B, L, C_in], bias null) of the circular convolution with w
// [C_out, C_in, 3]; all float32, contiguous. `smem` is the launch's dynamic
// shared memory (circular_conv1d_smem kind 0). Launches on `stream`, does
// not synchronise; returns a cudaError_t.
extern "C" int circular_conv1d_shift(const float* in, const float* w, const float* bias,
                                     float* out, int B, int L, int c_in, int c_out,
                                     int transposed, int smem, void* stream) {
  const int C = transposed ? c_out : c_in, N = transposed ? c_in : c_out;
  if (B <= 0 || L <= 0 || c_in <= 0 || c_out <= 0 || too_large((long long)B * L, C) ||
      too_large((long long)B * L, N) || (transposed && bias != nullptr))
    return (int)cudaErrorInvalidValue;
  int tiles = 0;
  const Geometry g = geometry(B, L, kRows, &tiles);
  const dim3 grid(tiles, (N + kCols - 1) / kCols);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (transposed) {
    err = prepare(shift_kernel<true>, smem, kShiftSmem);
    if (err != cudaSuccess) return (int)err;
    shift_kernel<true><<<grid, kShiftThreads, smem, s>>>(in, w, nullptr, out, g, C, N);
  } else {
    err = prepare(shift_kernel<false>, smem, kShiftSmem);
    if (err != cudaSuccess) return (int)err;
    shift_kernel<false><<<grid, kShiftThreads, smem, s>>>(in, w, bias, out, g, C, N);
  }
  return (int)cudaGetLastError();
}

// The number of row splits circular_conv1d_wgrad takes at these sizes on the
// current device (about one wave of resident blocks); the wrapper sizes the
// partial buffer from it: splits * C_out * (3 * C_in + 1) floats.
extern "C" int circular_conv1d_wgrad_splits(int B, int L, int c_in, int c_out, int smem,
                                            int* splits) {
  if (B <= 0 || L <= 0 || c_in <= 0 || c_out <= 0 || splits == nullptr ||
      too_large((long long)B * L, c_in) || too_large((long long)B * L, c_out))
    return (int)cudaErrorInvalidValue;
  const int bn = wgrad_bn(c_in);
  const int tiles = ((kTaps * c_in + bn - 1) / bn) * ((c_out + kWM - 1) / kWM);
  const cudaError_t err = bn == 64 ? wgrad_splits_for<64>(B * L, tiles, smem, splits)
                                   : wgrad_splits_for<128>(B * L, tiles, smem, splits);
  if (err == cudaSuccess && too_large(*splits, (long long)c_out * (kTaps * c_in + 1)))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// Weight (and bias) gradient: dw [C_out, C_in, 3] from x [B, L, C_in] and dy
// [B, L, C_out]; db [C_out] when not null. `part` holds splits * C_out *
// (3 * C_in + 1) floats of scratch (circular_conv1d_wgrad_splits); `smem`
// is circular_conv1d_smem kind 1. Two launches on `stream` (the partial
// sums, then their reduction), no synchronise; returns a cudaError_t.
extern "C" int circular_conv1d_wgrad(const float* x, const float* dy, float* part, float* dw,
                                     float* db, int B, int L, int c_in, int c_out, int splits,
                                     int smem, void* stream) {
  if (B <= 0 || L <= 0 || c_in <= 0 || c_out <= 0 || splits <= 0 ||
      too_large((long long)B * L, c_in) || too_large((long long)B * L, c_out) ||
      too_large(splits, (long long)c_out * (kTaps * c_in + 1)))
    return (int)cudaErrorInvalidValue;
  const int rows = B * L, n3 = kTaps * c_in, bn = wgrad_bn(c_in);
  const int per = ((rows + splits - 1) / splits + kWRows - 1) / kWRows * kWRows;
  if ((long long)per * (splits - 1) >= rows) return (int)cudaErrorInvalidValue;  // empty split
  float* const part_db = db != nullptr ? part + (size_t)splits * c_out * n3 : nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n3 + bn - 1) / bn, (c_out + kWM - 1) / kWM, splits);
  cudaError_t err;
  if (bn == 64) {
    err = prepare(wgrad_kernel<64>, smem, WCfg<64>::smem);
    if (err != cudaSuccess) return (int)err;
    wgrad_kernel<64><<<grid, WCfg<64>::threads, smem, s>>>(x, dy, part, part_db, L, rows, c_in,
                                                          c_out, per);
  } else {
    err = prepare(wgrad_kernel<128>, smem, WCfg<128>::smem);
    if (err != cudaSuccess) return (int)err;
    wgrad_kernel<128><<<grid, WCfg<128>::threads, smem, s>>>(x, dy, part, part_db, L, rows,
                                                            c_in, c_out, per);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = c_out * n3 + (db != nullptr ? c_out : 0);
  wgrad_reduce_kernel<<<(total + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part, part_db, dw, db, c_in, c_out, splits);
  return (int)cudaGetLastError();
}

// What a launch holds of an SM: out = {blocks resident, threads, dynamic
// shared bytes, registers a thread, local (spill) bytes a thread} of kind 0
// (forward), 1 (dgrad) or 2 (wgrad at this C_in). Returns a cudaError_t.
extern "C" int circular_conv1d_occupancy(int kind, int c_in, int* out) {
  if (out == nullptr || c_in <= 0) return (int)cudaErrorInvalidValue;
  auto report = [out](auto kernel, int threads, int smem) {
    cudaError_t err = prepare(kernel, smem, smem);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    out[0] = blocks;
    out[1] = threads;
    out[2] = smem;
    out[3] = attr.numRegs;
    out[4] = (int)attr.localSizeBytes;
    return cudaSuccess;
  };
  switch (kind) {
    case 0: return (int)report(shift_kernel<false>, kShiftThreads, kShiftSmem);
    case 1: return (int)report(shift_kernel<true>, kShiftThreads, kShiftSmem);
    case 2:
      return (int)(wgrad_bn(c_in) == 64
                       ? report(wgrad_kernel<64>, WCfg<64>::threads, WCfg<64>::smem)
                       : report(wgrad_kernel<128>, WCfg<128>::threads, WCfg<128>::smem));
    default: return (int)cudaErrorInvalidValue;
  }
}
