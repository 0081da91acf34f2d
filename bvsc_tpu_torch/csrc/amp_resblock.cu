// One AMP residual block of the causal BigVGAN-tiny vocoder, float32, for
// sm_90a.  Replaces the Pallas TPU kernel bvsc_tpu/ops/pallas_voc.py
// (_amp_kernel, launched by amp_resblock_folded with compute_dtype=float32).
//
// The block runs 3 units, each
//   xt = snake_beta(x); xt = causal_conv(xt, k, dilation d_j);
//   xt = snake_beta(xt); xt = causal_conv(xt, k, 1); x = xt + x
// with snake_beta(v) = v + inv_beta[c] * sin(alpha[c] * v)^2 (alpha and
// inv_beta = 1 / (beta + 1e-9) are precomputed per channel by the wrapper;
// sinf is the precise one: __sinf is not float32-accurate at these
// arguments).  Parity mode: float32 products and sums, no TF32, no bf16.
//
// Activations in and out: x and y are float32, or under the bf16 storage
// dtype bf16 (the TPU kernel's out_dtype = x.dtype): the I/O element type is
// a template parameter, the window load widens a bf16 input to float32
// exactly (as _amp_kernel does before its body), everything in between is
// the float32 computation described here, and the final store rounds once
// to nearest-even bf16 (__float2bfloat16_rn, as _amp_kernel's
// astype(out_dtype)).  A bf16 call reads and writes half the bytes.  This
// file builds the float32 entry points; amp_resblock_io_bf16.cu includes it
// with AMP_RESBLOCK_IO_BF16 defined to build the bf16 one, so that nvcc
// compiles the two sets of instantiations in parallel.
//
// Layout: x and y are (B, C, T) contiguous; the conv weights come
// packed by the wrapper as (3, C_in, k, C_out), so the C_out weights of one
// (c_in, tap) are contiguous.  One thread block owns one batch row and one
// tile of `tile` output samples, all C channels.  It loads x[b, :, t0 - H :
// t0 + tile] into shared memory (zeros where t < 0 or t >= T), with
// H = (k - 1) * (d0 + d1 + d2 + 3) the chain's left context, and runs the
// whole block there: the valid window starts at 0 and each conv moves its
// start right by its own context, ending at exactly H.  The halo is
// recomputed by every tile, not carried (the TPU kernel carries it between
// sequential grid steps; blocks here run in any order).
//
// Sequence start: the reference zero-pads the input of every conv, so every
// intermediate is exactly zero at t < 0.  After each conv (bias included)
// the positions with global t < 0 are set to 0; without this the bias would
// leak into the pre-history and change the first H samples of every stage.
//
// Streaming (a carried context and a per-row stream start): the input row
// may hold `ctx` samples of left context before the T it is asked for, so x
// is (B, C, ctx + T) and output column t is input column ctx + t; a tile's
// halo is read from the input wherever it lies at or after input column 0.
// start[b] (an int32 device array, or null for all 0) is how many samples
// row b's stream fed the stage before output column 0, so output column t
// is stream time start[b] + t, and "global t < 0" above is that stream time:
// positions before their stream began are zero on load and after every
// conv.  ctx = 0 with a null start is the offline launch, unchanged.
//
// What bounds it: float32 FMAs on the CUDA cores, 6 * 2 * C^2 * k FLOP per
// output sample against one read and one write of C floats.  What the
// design does about it:
// - Compile-time shapes.  The kernel is a template on (C, k), the conv on
//   its dilation (C in {8, 16, 32, 64}, k in {3, 7, 11}, d in {1, 3, 5}:
//   the shipped configs), so the tap loop unrolls and every stride but the
//   window's row length is a constant.  Other shapes are refused.
// - Register blocking.  A warp computes R_co output channels x 32 * R_t
//   times at once: lane l holds times t0 + l + 32 r (r < R_t) for all R_co
//   channels in R_co * R_t independent accumulators.  Per (c_in, tap) it
//   loads R_t activations from shared memory (consecutive lanes, consecutive
//   addresses: no bank conflict) and R_co weights as float4s (one address
//   for the whole warp: a broadcast), then does R_co * R_t FMAs, so loads
//   per FMA fall from 2 on one dependent chain to (R_t + R_co / 4) /
//   (R_co * R_t).  The sum over (c_in, tap) is taken in that order in
//   float32 FMAs, then the bias is added.
// - Weights where they fit.  At C <= 32 each conv's weights (at most 45 KB)
//   are copied into shared memory with cp.async while the snake before that
//   conv runs.  At C = 64 one k = 11 conv's weights (180 KB) do not fit
//   beside the activations and are read as float4 broadcasts through the
//   read-only cache.
// - Filling the card.  The wrapper picks the tile (ops/amp_resblock.py,
//   tile_for): 8192 / C samples, halved where that grid would leave SMs
//   without a block, so a B = 4 stage of 2 056 samples at C = 64 runs 132
//   blocks of 64, one per SM, though each recomputes up to 1.9x its
//   outputs as halo (on an H100 that stage ran 1.4x faster than with 68
//   blocks of 128); 512 threads a block (256 at C = 8, where two blocks
//   share an SM).
// What it still does not do: use the tensor cores (parity forbids TF32; an
// error-compensated 3xTF32 split would keep float32-level error), share a
// halo between tiles (a cluster with distributed shared memory could), or
// overlap one conv's weight fetch from L2 with the previous conv at C = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kUnits = 3;
constexpr int kSmemWeightsMaxC = 32;
constexpr int kSlack = 256;  // floats after each conv's source buffer

// The micro-tile (R_co channels x R_t times a lane) and threads per block
// for C channels.
template <int C>
struct Blocking {
  static constexpr int rco = 8;
  static constexpr int rt = C == 64 ? 2 : 4;
  static constexpr int threads = C == 8 ? 256 : 512;
  static constexpr int warps = threads / 32;
  static constexpr int span = 32 * rt;  // times one warp item covers
  static constexpr bool smem_weights = C <= kSmemWeightsMaxC;
  static_assert(rco % 4 == 0 && C % rco == 0, "R_co must be a multiple of 4 dividing C");
  static_assert(span <= kSlack, "the last chunk of a window reads up to span - 1 past it");
};

// Shared memory: the residual xs, then the snake output as (conv 1's
// source) and the conv-1 output bs (conv 2's source), each C x L floats and
// each source followed by kSlack floats that no one writes: the last chunk
// of a window reads up to span - 1 floats past its source's last row, into
// that slack, never into a buffer another warp writes in the same phase;
// then one conv's weights at C <= 32.
template <int C, int K>
constexpr size_t smem_floats(int L) {
  return 3 * static_cast<size_t>(C) * L + 2 * kSlack +
         (Blocking<C>::smem_weights ? static_cast<size_t>(C) * C * K : 0);
}

// The I/O element type's load (widening, exact) and store (one rounding).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class IO>
__device__ __forceinline__ IO narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float snake_beta(float v, float a, float inv_b) {
  const float s = sinf(a * v);
  return v + inv_b * (s * s);
}

// f(c, i) for every channel c < C and column i in [lo, hi): (channel, part)
// rows spread over the warps, lanes on consecutive columns.
template <int C, int kWarps, class F>
__device__ __forceinline__ void for_window(int lo, int hi, F f) {
  constexpr int kParts = kWarps > C ? kWarps / C : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < C * kParts; r += kWarps) {
    const int c = r / kParts;
    for (int i = lo + (r % kParts) * 32 + lane; i < hi; i += 32 * kParts) f(c, i);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying one conv's packed weights (C * K * C floats) into ws.
template <int C, int K>
__device__ __forceinline__ void stage_weights(float* ws, const float* w) {
  constexpr int n = C * K * C / 4;
  for (int i = threadIdx.x; i < n; i += Blocking<C>::threads) cp_async16(ws + 4 * i, w + 4 * i);
}

// Causal dilated conv over the window [lo, L): for each output time t,
//   v = b[co] + sum_ci sum_tap w[ci, tap, co] * src[ci, t - (K - 1 - tap) * D]
// which reads src only at [lo - (K - 1) * D, L).  v is 0 where the stream
// time t + g0 is negative.  kResidual: dst += v, else dst = v.  A warp's
// item is R_co channels x `span` times; consecutive items share their
// channels, so the warps in flight read the same weights.
template <int C, int K, int D, bool kResidual>
__device__ __forceinline__ void conv_window(const float* src, float* dst, const float* w,
                                            const float* __restrict__ bias, int L, int lo,
                                            int g0) {
  using G = Blocking<C>;
  constexpr int R = G::rco, RT = G::rt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (L - lo + G::span - 1) / G::span;
  for (int item = warp; item < (C / R) * chunks; item += G::warps) {
    const int grp = item / chunks;
    const int co0 = grp * R;
    const int t0 = lo + (item - grp * chunks) * G::span + lane;
    float acc[R][RT];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[o][r] = 0.0f;
    const float* sp = src + t0 - (K - 1) * D;
    const float* wp = w + co0;
#pragma unroll 1
    for (int ci = 0; ci < C; ++ci, sp += L, wp += K * C) {
#pragma unroll
      for (int tap = 0; tap < K; ++tap) {
        float a[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) a[r] = sp[tap * D + 32 * r];
        float wv[R];
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4* w4 = reinterpret_cast<const float4*>(wp + tap * C) + q;
          float4 v;
          if constexpr (G::smem_weights) v = *w4; else v = __ldg(w4);
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[o][r] = fmaf(wv[o], a[r], acc[o][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int t = t0 + 32 * r;
      if (t >= L) continue;
      const bool pre = t + g0 < 0;
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const float v = pre ? 0.0f : acc[o][r] + __ldg(bias + co0 + o);
        float* out = dst + (co0 + o) * L + t;
        *out = kResidual ? v + *out : v;
      }
    }
  }
}

struct Args {
  const void* x;       // (B, C, ctx + T) of the I/O type
  void* y;             // (B, C, T) of the I/O type
  const float* w1;     // (3, C_in, k, C_out), packed
  const float* b1;     // (3, C)
  const float* w2;     // (3, C_in, k, C_out), packed
  const float* b2;     // (3, C)
  const float* alpha;  // (6, C), exp(log alpha)
  const float* inv_b;  // (6, C), 1 / (exp(log beta) + 1e-9)
  const int* start;    // (B,) samples each row's stream fed before output 0, or null
  int T, ctx, tile, halo;  // x rows hold ctx + T samples, y rows T
  int d[kUnits];
};

template <int C, int K, class IO>
__global__ void __launch_bounds__(Blocking<C>::threads) amp_resblock_kernel(Args p) {
  using G = Blocking<C>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // residual stream
  const int L = p.halo + p.tile;
  float* as = xs + C * L;                // snake output, input of conv 1
  float* bs = as + C * L + kSlack;       // conv 1 output, snaked in place, input of conv 2
  float* ws = bs + C * L + kSlack;       // one conv's weights (C <= 32)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int g0 = t0 - p.halo;                         // output column of buffer column 0
  const int s0 = g0 + (p.start ? __ldg(p.start + b) : 0);  // its stream time
  const int T = p.T, Tin = p.ctx + p.T;
  const IO* xb = static_cast<const IO*>(p.x) + static_cast<size_t>(b) * C * Tin;

  for_window<C, G::warps>(0, L, [&](int c, int i) {
    const int g = p.ctx + g0 + i;  // input column
    xs[c * L + i] =
        (g >= 0 && g < Tin && s0 + i >= 0) ? widen(xb[static_cast<size_t>(c) * Tin + g]) : 0.0f;
  });
  __syncthreads();

  int lo = 0;
  for (int j = 0; j < kUnits; ++j) {
    const size_t wo = static_cast<size_t>(j) * C * K * C;
    const float* al = p.alpha + 2 * j * C;
    const float* ib = p.inv_b + 2 * j * C;
    if constexpr (G::smem_weights) stage_weights<C, K>(ws, p.w1 + wo);
    for_window<C, G::warps>(lo, L, [&](int c, int i) {
      as[c * L + i] = snake_beta(xs[c * L + i], __ldg(al + c), __ldg(ib + c));
    });
    if constexpr (G::smem_weights) cp_async_wait_all();
    __syncthreads();
    const int d = j == 0 ? p.d[0] : (j == 1 ? p.d[1] : p.d[2]);
    lo += (K - 1) * d;
    const float* w1 = G::smem_weights ? ws : p.w1 + wo;
    switch (d) {
      case 1: conv_window<C, K, 1, false>(as, bs, w1, p.b1 + j * C, L, lo, s0); break;
      case 3: conv_window<C, K, 3, false>(as, bs, w1, p.b1 + j * C, L, lo, s0); break;
      default: conv_window<C, K, 5, false>(as, bs, w1, p.b1 + j * C, L, lo, s0); break;
    }
    __syncthreads();
    if constexpr (G::smem_weights) stage_weights<C, K>(ws, p.w2 + wo);
    for_window<C, G::warps>(lo, L, [&](int c, int i) {
      bs[c * L + i] = snake_beta(bs[c * L + i], __ldg(al + C + c), __ldg(ib + C + c));
    });
    if constexpr (G::smem_weights) cp_async_wait_all();
    __syncthreads();
    lo += K - 1;
    conv_window<C, K, 1, true>(bs, xs, G::smem_weights ? ws : p.w2 + wo, p.b2 + j * C, L, lo,
                               s0);
    __syncthreads();
  }

  IO* yb = static_cast<IO*>(p.y) + static_cast<size_t>(b) * C * T;
  const int n = T - t0 < p.tile ? T - t0 : p.tile;
  for_window<C, G::warps>(0, n, [&](int c, int i) {
    yb[static_cast<size_t>(c) * T + t0 + i] = narrow<IO>(xs[c * L + p.halo + i]);
  });
}

bool dilations_ok(const int (&d)[kUnits]) {
  for (int v : d)
    if (v != 1 && v != 3 && v != 5) return false;
  return true;
}

template <int C, int K, class IO>
int launch(const Args& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<C, K>(p.halo + p.tile);
  cudaError_t err = cudaFuncSetAttribute(amp_resblock_kernel<C, K, IO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + p.tile - 1) / p.tile, B);
  amp_resblock_kernel<C, K, IO><<<grid, Blocking<C>::threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The entry points' bodies, one per (C, K, I/O type) instantiation.
template <class IO>
struct Launch {
  const Args& p;
  int B;
  cudaStream_t stream;
  template <int C, int K>
  int run() const { return launch<C, K, IO>(p, B, stream); }
};


struct Plan {
  int L;
  int* out;
  template <int C, int K>
  int run() const {
    out[0] = Blocking<C>::threads;
    out[1] = static_cast<int>(sizeof(float) * smem_floats<C, K>(L));
    out[2] = Blocking<C>::rco;
    out[3] = Blocking<C>::rt;
    return 0;
  }
};

template <int C, class F>
int dispatch_k(int k, const F& f) {
  switch (k) {
    case 3: return f.template run<C, 3>();
    case 7: return f.template run<C, 7>();
    case 11: return f.template run<C, 11>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f.run<C, K>() for a supported (C, K); cudaErrorInvalidValue for any other.
template <class F>
int dispatch(int C, int k, const F& f) {
  switch (C) {
    case 8: return dispatch_k<8>(k, f);
    case 16: return dispatch_k<16>(k, f);
    case 32: return dispatch_k<32>(k, f);
    case 64: return dispatch_k<64>(k, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class IO>
int launch_entry(const void* x, void* y, const float* w1, const float* b1, const float* w2,
                 const float* b2, const float* alpha, const float* inv_beta, const int* start,
                 int B, int C, int T, int ctx, int k, int d0, int d1, int d2, int tile,
                 void* stream) {
  Args p{x, y, w1, b1, w2, b2, alpha, inv_beta, start, T, ctx, tile, 0, {d0, d1, d2}};
  if (!dilations_ok(p.d) || tile <= 0 || ctx < 0) return static_cast<int>(cudaErrorInvalidValue);
  p.halo = (k - 1) * (d0 + d1 + d2 + kUnits);
  return dispatch(C, k, Launch<IO>{p, B, static_cast<cudaStream_t>(stream)});
}

}  // namespace

#ifndef AMP_RESBLOCK_IO_BF16

// Launches one resblock on `stream` (a cudaStream_t): x (B, C, ctx + T),
// y (B, C, T), start null or (B,) int32 (see the header).  Returns the CUDA
// error code of the launch (0 on success); it does not synchronise.  A
// (C, k, d) outside the shipped configs, or ctx < 0, gives
// cudaErrorInvalidValue.
extern "C" int amp_resblock_f32(const float* x, float* y, const float* w1, const float* b1,
                                const float* w2, const float* b2, const float* alpha,
                                const float* inv_beta, const int* start, int B, int C, int T,
                                int ctx, int k, int d0, int d1, int d2, int tile, void* stream) {
  return launch_entry<float>(x, y, w1, b1, w2, b2, alpha, inv_beta, start, B, C, T, ctx, k, d0,
                             d1, d2, tile, stream);
}

// The launch's shape for (C, k, d0..d2, tile): out[0] threads per block,
// out[1] bytes of shared memory, out[2] R_co, out[3] R_t.  Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int amp_resblock_f32_plan(int C, int k, int d0, int d1, int d2, int tile, int* out) {
  const int d[kUnits] = {d0, d1, d2};
  if (!dilations_ok(d) || tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int L = (k - 1) * (d0 + d1 + d2 + kUnits) + tile;
  return dispatch(C, k, Plan{L, out});
}

#else  // AMP_RESBLOCK_IO_BF16

// amp_resblock_f32 with bf16 activations: x (B, C, ctx + T) and y (B, C, T)
// bf16 (widened on load, rounded once on store), everything else as there.
extern "C" int amp_resblock_f32_io_bf16(const void* x, void* y, const float* w1, const float* b1,
                                        const float* w2, const float* b2, const float* alpha,
                                        const float* inv_beta, const int* start, int B, int C,
                                        int T, int ctx, int k, int d0, int d1, int d2, int tile,
                                        void* stream) {
  return launch_entry<__nv_bfloat16>(x, y, w1, b1, w2, b2, alpha, inv_beta, start, B, C, T, ctx,
                                     k, d0, d1, d2, tile, stream);
}

#endif  // AMP_RESBLOCK_IO_BF16
