// One AMP residual block of the causal BigVGAN-tiny vocoder, float32, for
// sm_90a.  Replaces the Pallas TPU kernel bvsc_tpu/ops/pallas_voc.py
// (_amp_kernel, launched by amp_resblock_folded).
//
// The block runs 3 units, each
//   xt = snake_beta(x); xt = causal_conv(xt, k, dilation d_j);
//   xt = snake_beta(xt); xt = causal_conv(xt, k, 1); x = xt + x
// with snake_beta(v) = v + inv_beta[c] * sin(alpha[c] * v)^2 (alpha and
// inv_beta = 1 / (beta + 1e-9) are precomputed per channel by the wrapper).
//
// Layout: x and y are (B, C, T) contiguous float32.  One thread block owns
// one batch row and one tile of `tile` output samples, all C channels.  It
// loads x[b, :, t0 - H : t0 + tile] into shared memory (zeros where t < 0 or
// t >= T), with H = (k - 1) * (d0 + d1 + d2 + 3) the chain's left context,
// and runs the whole block there: the valid window starts at 0 and each conv
// moves its start right by its own context, ending at exactly H.  The halo
// is recomputed by every tile, not carried, so tiles run in any order.
//
// Sequence start: the reference zero-pads the input of every conv, so every
// intermediate is exactly zero at t < 0.  After each conv (bias included)
// the positions with global t < 0 are set to 0; without this the bias would
// leak into the pre-history and change the first H samples of every stage.
//
// What bounds it: float32 FMAs on the CUDA cores (parity mode forbids
// TF32).  One block does 6 * 2 * C^2 * k FLOP per output sample and moves
// one read and one write of C floats per sample.  This first version is
// simple: each thread computes one (channel, time) output at a time, reads
// its inputs from shared memory (consecutive threads read consecutive
// times, so no bank conflicts) and the weights through the read-only cache
// (a warp shares one output channel, so a weight load is a broadcast).  It
// keeps the intermediates out of device memory; it does not block registers
// or use tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 3;

__device__ __forceinline__ float snake_beta(float v, float a, float inv_b) {
  const float s = sinf(a * v);
  return v + inv_b * (s * s);
}

// dst[c, t] = snake_beta(src[c, t]) for t in [lo, L).
__device__ void snake_window(const float* src, float* dst, const float* __restrict__ a,
                             const float* __restrict__ inv_b, int C, int L, int lo) {
  const int n = L - lo;
  for (int i = threadIdx.x; i < C * n; i += blockDim.x) {
    const int c = i / n;
    const int t = lo + i % n;
    dst[c * L + t] = snake_beta(src[c * L + t], __ldg(a + c), __ldg(inv_b + c));
  }
}

// Causal dilated conv over the window [lo, L): for each output position t,
//   v = b[co] + sum_ci sum_tap w[co, ci, tap] * src[ci, t - (k - 1 - tap) * d]
// which reads src only at [lo - (k - 1) * d, L).  v is 0 where the global
// time t + g0 is negative.  residual: dst += v, else dst = v.
__device__ void conv_window(const float* src, float* dst, const float* __restrict__ w,
                            const float* __restrict__ b, int C, int L, int k, int d,
                            int lo, int g0, bool residual) {
  const int n = L - lo;
  const int back = (k - 1) * d;
  for (int i = threadIdx.x; i < C * n; i += blockDim.x) {
    const int co = i / n;
    const int t = lo + i % n;
    const float* wr = w + co * C * k;
    float acc = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      const float* row = src + ci * L + t - back;
      const float* wc = wr + ci * k;
      for (int tap = 0; tap < k; ++tap) acc = fmaf(__ldg(wc + tap), row[tap * d], acc);
    }
    const float v = (t + g0 < 0) ? 0.0f : acc + __ldg(b + co);
    dst[co * L + t] = residual ? v + dst[co * L + t] : v;
  }
}

struct Args {
  const float* x;
  float* y;
  const float* w1;     // (3, C, C, k)
  const float* b1;     // (3, C)
  const float* w2;     // (3, C, C, k)
  const float* b2;     // (3, C)
  const float* alpha;  // (6, C), exp(log alpha)
  const float* inv_b;  // (6, C), 1 / (exp(log beta) + 1e-9)
  int C, T, k, tile, halo;
  int d[kUnits];
};

__global__ void __launch_bounds__(kThreads) amp_resblock_kernel(Args p) {
  extern __shared__ float smem[];
  const int C = p.C, k = p.k;
  const int L = p.halo + p.tile;
  float* xs = smem;         // residual stream
  float* as = xs + C * L;   // snake output, input of conv 1
  float* bs = as + C * L;   // conv 1 output, snaked in place, input of conv 2
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int g0 = t0 - p.halo;  // global time of buffer column 0
  const float* xb = p.x + static_cast<size_t>(b) * C * p.T;

  for (int i = threadIdx.x; i < C * L; i += blockDim.x) {
    const int c = i / L;
    const int g = g0 + i % L;
    xs[i] = (g >= 0 && g < p.T) ? xb[static_cast<size_t>(c) * p.T + g] : 0.0f;
  }
  __syncthreads();

  int lo = 0;
  for (int j = 0; j < kUnits; ++j) {
    const size_t wo = static_cast<size_t>(j) * C * C * k;
    snake_window(xs, as, p.alpha + (2 * j) * C, p.inv_b + (2 * j) * C, C, L, lo);
    __syncthreads();
    lo += (k - 1) * p.d[j];
    conv_window(as, bs, p.w1 + wo, p.b1 + j * C, C, L, k, p.d[j], lo, g0, false);
    __syncthreads();
    snake_window(bs, bs, p.alpha + (2 * j + 1) * C, p.inv_b + (2 * j + 1) * C, C, L, lo);
    __syncthreads();
    lo += k - 1;
    conv_window(bs, xs, p.w2 + wo, p.b2 + j * C, C, L, k, 1, lo, g0, true);
    __syncthreads();
  }

  float* yb = p.y + static_cast<size_t>(b) * C * p.T;
  for (int i = threadIdx.x; i < C * p.tile; i += blockDim.x) {
    const int c = i / p.tile;
    const int t = i % p.tile;
    if (t0 + t < p.T) yb[static_cast<size_t>(c) * p.T + t0 + t] = xs[c * L + p.halo + t];
  }
}

}  // namespace

// Launches one resblock on `stream` (a cudaStream_t).  Returns the CUDA
// error code of the launch (0 on success); it does not synchronise.
extern "C" int amp_resblock_f32(const float* x, float* y, const float* w1, const float* b1,
                                const float* w2, const float* b2, const float* alpha,
                                const float* inv_beta, int B, int C, int T, int k, int d0,
                                int d1, int d2, int tile, void* stream) {
  Args p{x, y, w1, b1, w2, b2, alpha, inv_beta, C, T, k, tile, 0, {d0, d1, d2}};
  p.halo = (k - 1) * (d0 + d1 + d2 + kUnits);
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(C) * (p.halo + tile);
  cudaError_t err = cudaFuncSetAttribute(
      amp_resblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + tile - 1) / tile, B);
  amp_resblock_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
