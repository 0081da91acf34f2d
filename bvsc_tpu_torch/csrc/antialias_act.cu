// One anti-aliased activation of the full BigVGAN vocoder, in float32, for
// sm_90a: ops/resample.py's Activation1d around a Snake or SnakeBeta, that
// is 2x kaiser-sinc upsampling, the snake, and 2x low-pass decimation, in
// one pass over device memory.  It replaces no TPU kernel: the JAX package
// computes Activation1d in plain jnp (bvsc_tpu/ops/resample.py), and the
// port's plain version is a chain of separate passes (replicate pads, a
// depthwise conv_transpose1d, a x2, a trim, the snake's elementwise ops, a
// depthwise strided conv1d), each reading and writing the 2x-upsampled
// signal.  Here the upsampled signal never leaves the thread block.
//
// What it computes, per (b, c) row of T samples, with the 12 up taps f and
// the 12 down taps g (both kaiser_sinc_filter1d(0.25, 0.3, 12), passed by
// the wrapper as they are):
//   u[2j]     = 2 * sum_{m<6} f[2m+1] * x[clamp(j + 2 - m)]
//   u[2j + 1] = 2 * sum_{m<6} f[2m]   * x[clamp(j + 3 - m)]       j in [0, T)
//   a[i]      = u[i] + inv_beta[c] * sin^2(alpha[c] * u[i])      i in [0, 2T)
//   y[n]      = sum_{k<12} g[k] * a[clamp2(2n + k - 5)]            n in [0, T)
// with clamp to [0, T - 1] and clamp2 to [0, 2T - 1].  These are exactly
// UpSample1d's replicate pad of 5, transposed conv at stride 2, x2 and trim
// of 15 each side (the two polyphase halves of f), and DownSample1d's
// replicate pad of 5 | 6 on the activated 2x signal and stride-2 conv: a
// position left of the row takes a[0], right of it a[2T - 1].
//
// The snake is computed as the plain path's torch ops compute it, one
// rounding a step (__fmul_rn / __fadd_rn, so nvcc contracts nothing):
// u * alpha, sin^2 (sinf, the precise one, squared; or with kApprox the
// JAX constants' polynomial of ops/snake.py:sin_sq_approx), times inv_beta,
// plus u.  alpha and inv_beta (= 1 / (beta + 1e-9)) come linear from the
// wrapper.  The two filters sum in float32 FMAs, in tap order; cuDNN sums
// in another order, so the output differs from the plain path's by float32
// rounding only.  No --use_fast_math, no __sinf.
//
// What bounds it on an H100: bytes.  It reads x once and writes y once, 8
// bytes an input element at float32 (3.35 TB/s), plus a halo of 6 input
// samples each side of a tile.  Its arithmetic is about the same size: two
// sinf and 24 filter FMAs an element, near the card's float32 issue rate at
// that byte rate.  What the design does about it:
// - One block owns one row and a tile of kTile = 1016 outputs; the grid is
//   (rows x tiles), one dimension, so every stage shape of the cell (B = 32,
//   C 768 -> 24, T 2 068 -> 132 352) gives tens of thousands of blocks for
//   the 132 SMs.  A ragged last tile does only its own outputs' work.
// - The block stages x[t0 - 8, t0 + n + 8) in shared memory with coalesced
//   loads, clamping each index at the row's ends: replicate padding with no
//   padded copy.
// - Pairs (a[2j], a[2j + 1]) of the activated 2x signal are made from 7
//   staged neighbours with the two 6-tap polyphase halves, so each
//   upsampled sample, and its sinf, is computed once; they go to shared
//   memory as two arrays, even and odd samples, never to device memory.
//   The decimating filter reads 6 odd and 6 even samples an output.
// - Interior tiles of a row whose length is a multiple of 4 (every tile
//   of the cell but each row's first and last) take a vectorised path:
//   global loads and stores of 4 elements (16 bytes in float32), and a
//   thread makes 4 consecutive pairs from 3 float4 reads of the staged
//   window and 4 consecutive outputs from 6 float4 reads of the pairs, so
//   that each shared-memory access of a quarter warp is one contiguous 128
//   bytes.  A row that is not aligned to 4 elements (the trimmed stage
//   input each stage hands its first activations, read in place rather
//   than copied) is loaded an element at a time, 4 a thread.  Other tiles
//   take the scalar path, one pair or output a thread at a time
//   (consecutive threads on consecutive addresses), with the clamps.  Both
//   sum in the same order, so the path does not change a bit of the
//   output.
// - The taps are a by-value kernel argument (the launch's constant bank):
//   no device copy, no per-call host work but filling the struct.
//
// Activations in and out: x and y are float32, or on the codec's bf16
// vocoder segment bf16.  The I/O element type is a template parameter: a
// bf16 input is widened to float32 as it is staged (exact), everything
// after runs in float32 exactly as in the float32 build, and y is rounded
// once to nearest-even bf16 (__float2bfloat16_rn, as torch's casts round).
// So a bf16 call gives the float32 build's result on the same input within
// half a bf16 ulp, where the plain chain in bf16 rounds each of its passes
// to bf16; it reads and writes half the bytes.  Interior tiles move 4 bf16
// (8 bytes) a thread.  This file builds the float32 entry point;
// antialias_act_io_bf16.cu includes it with ANTIALIAS_ACT_IO_BF16 defined
// to build the bf16 one, so that a float32 caller never compiles it (one
// library a source file, ops/_build.py).
// What it does not do yet: a persistent loop that overlaps one tile's
// loads with the last one's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 12;
constexpr int kThreads = 256;
constexpr int kTile = 4 * (kThreads - 2);  // outputs a block: 1016
constexpr int kLead = 8;                   // staged samples before the tile: 6 read, 16-B aligned
constexpr int kWin = kTile + 2 * kLead;    // the staged window
constexpr int kPairLead = 3;               // pairs of the 2x signal before the tile
constexpr int kPairs = 4 * kThreads;       // pairs a block makes: kTile + 6, rounded up to 4
static_assert(kPairs >= kTile + 2 * kPairLead, "the pairs cover the tile's filter reach");

struct Taps {
  float up[kTaps];
  float down[kTaps];
};

// One element, or four consecutive ones, of the I/O type to and from
// float32.  load4 reads 16 (float) or 8 (bf16) bytes at once where p is
// that aligned, else one element at a time.
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ float4 load4(const float* p, bool aligned) {
  return aligned ? __ldg(reinterpret_cast<const float4*>(p))
                 : make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool aligned) {
  if (!aligned) return make_float4(load1(p), load1(p + 1), load1(p + 2), load1(p + 3));
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// sin^2 as ops/snake.py's _sin_sq computes it: sinf squared, or the
// polynomial of sin_sq_approx (r = v - pi * round(v / pi), round half to
// even; the degree-7 odd sin polynomial of r, squared), one rounding a step.
template <bool kApprox>
__device__ __forceinline__ float sin_sq(float v) {
  if (kApprox) {
    constexpr float kPi = static_cast<float>(3.14159265358979);
    constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265358979);
    constexpr float kS1 = -1.6666654611e-1f, kS2 = 8.3321608736e-3f, kS3 = -1.9515295891e-4f;
    const float r = __fsub_rn(v, __fmul_rn(kPi, rintf(__fmul_rn(v, kInvPi))));
    const float r2 = __fmul_rn(r, r);
    const float poly = __fadd_rn(kS1, __fmul_rn(r2, __fadd_rn(kS2, __fmul_rn(r2, kS3))));
    const float s = __fadd_rn(r, __fmul_rn(__fmul_rn(r, r2), poly));
    return __fmul_rn(s, s);
  }
  const float s = sinf(v);
  return __fmul_rn(s, s);
}

template <bool kApprox>
__device__ __forceinline__ float snake(float u, float alpha, float inv_beta) {
  return __fadd_rn(u, __fmul_rn(inv_beta, sin_sq<kApprox>(__fmul_rn(u, alpha))));
}

// The upsampled pair (u[2j], u[2j + 1]) from x[j - 3 .. j + 3] in
// w[o .. o + 6]: the two polyphase halves of the up taps, x2.
template <class W>
__device__ __forceinline__ float2 make_pair(const W& w, int o, const Taps& taps) {
  float u0 = 0.f, u1 = 0.f;
#pragma unroll
  for (int m = 0; m < kTaps / 2; ++m) {
    u0 = fmaf(taps.up[2 * m + 1], w[o + 5 - m], u0);
    u1 = fmaf(taps.up[2 * m], w[o + 6 - m], u1);
  }
  return make_float2(2.f * u0, 2.f * u1);  // the ratio (exact)
}

// y[n] from the pairs: a[2n + k - 5] is od[i + k / 2] for even k and
// ev[i + (k + 1) / 2] for odd k, with i the pair index of n.
template <class E, class O>
__device__ __forceinline__ float decimate(const E& ev, const O& od, int i, const Taps& taps) {
  float acc = taps.down[0] * od[i];
#pragma unroll
  for (int m = 1; m < kTaps / 2; ++m) {
    acc = fmaf(taps.down[2 * m - 1], ev[i + m], acc);
    acc = fmaf(taps.down[2 * m], od[i + m], acc);
  }
  return fmaf(taps.down[kTaps - 1], ev[i + kTaps / 2], acc);
}

template <bool kApprox, class IoT>
__global__ void __launch_bounds__(kThreads)
    antialias_act_kernel(const IoT* __restrict__ x, IoT* __restrict__ y,
                         const float* __restrict__ alpha, const float* __restrict__ inv_beta,
                         long long ld, int C, int T, int tiles, int vec, Taps taps) {
  // xw[i] = x[clamp(t0 - kLead + i)]; ev[p], od[p] = a[2j], a[2j + 1] with
  // j = t0 - kPairLead + p
  __shared__ __align__(16) float xw[kWin];
  __shared__ __align__(16) float ev[kPairs];
  __shared__ __align__(16) float od[kPairs];
  const long long row = blockIdx.x / tiles;
  const int t0 = static_cast<int>(blockIdx.x - row * tiles) * kTile;
  const int n = min(kTile, T - t0);  // this tile's outputs
  const IoT* xr = x + row * ld;
  IoT* yr = y + row * T + t0;
  const int c = static_cast<int>(row % C);
  const float al = __ldg(alpha + c), ib = __ldg(inv_beta + c);
  const int tid = threadIdx.x;

  if (vec && t0 >= kLead && t0 + kTile + kLead <= T) {
    // Interior: no clamp reaches the window, n = kTile.  A row that is not
    // aligned to 4 elements (a trimmed view's) is read an element at a time.
    const IoT* src = xr + t0 - kLead;
    const bool aligned = reinterpret_cast<uintptr_t>(src) % (4 * sizeof(IoT)) == 0;
    for (int i = tid; i < kWin / 4; i += kThreads) {
      reinterpret_cast<float4*>(xw)[i] = load4(src + 4 * i, aligned);
    }
    __syncthreads();
    // pairs 4 tid .. 4 tid + 3 read xw[4 tid + 2 .. 4 tid + 11]
    float w[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 v = reinterpret_cast<const float4*>(xw)[tid + k];
      w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z, w[4 * k + 3] = v.w;
    }
    float e[4], o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 u = make_pair(w, r + 2, taps);
      e[r] = snake<kApprox>(u.x, al, ib);
      o[r] = snake<kApprox>(u.y, al, ib);
    }
    reinterpret_cast<float4*>(ev)[tid] = make_float4(e[0], e[1], e[2], e[3]);
    reinterpret_cast<float4*>(od)[tid] = make_float4(o[0], o[1], o[2], o[3]);
    __syncthreads();
    if (4 * tid < kTile) {
      // outputs 4 tid .. 4 tid + 3 read ev, od [4 tid .. 4 tid + 11]
      float pe[12], po[12];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 a = reinterpret_cast<const float4*>(ev)[tid + k];
        const float4 b = reinterpret_cast<const float4*>(od)[tid + k];
        pe[4 * k] = a.x, pe[4 * k + 1] = a.y, pe[4 * k + 2] = a.z, pe[4 * k + 3] = a.w;
        po[4 * k] = b.x, po[4 * k + 1] = b.y, po[4 * k + 2] = b.z, po[4 * k + 3] = b.w;
      }
      float out[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) out[r] = decimate(pe, po, r, taps);
      store4(yr + 4 * tid, make_float4(out[0], out[1], out[2], out[3]));
    }
    return;
  }

  // A row's first or last tile, or any tile of a row whose length is not a
  // multiple of 4: scalar, with the clamps.
  for (int i = tid; i < n + 2 * kLead; i += kThreads) {
    xw[i] = load1(xr + min(max(t0 - kLead + i, 0), T - 1));
  }
  __syncthreads();
  for (int p = tid; p < n + 2 * kPairLead; p += kThreads) {
    const int j = t0 - kPairLead + p;
    const int jc = min(max(j, 0), T - 1);
    float2 u = make_pair(xw, jc - t0 + kLead - 3, taps);
    if (j < 0) u.y = u.x;      // left of the row: a[0]
    if (j > T - 1) u.x = u.y;  // right of it: a[2T - 1]
    ev[p] = snake<kApprox>(u.x, al, ib);
    od[p] = snake<kApprox>(u.y, al, ib);
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) store1(yr + i, decimate(ev, od, i, taps));
}

template <class IoT>
int launch(const void* x, void* y, const float* alpha, const float* inv_beta, const float* taps,
           long long rows, long long ld, int C, int T, int approx, void* stream) {
  if (rows < 1 || C < 1 || T < 1 || ld < T) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (T + kTile - 1) / kTile;
  const long long blocks = rows * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Taps t;
  for (int k = 0; k < kTaps; ++k) {
    t.up[k] = taps[k];
    t.down[k] = taps[kTaps + k];
  }
  const int vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(y) % (4 * sizeof(IoT)) == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const IoT* xi = static_cast<const IoT*>(x);
  IoT* yi = static_cast<IoT*>(y);
  if (approx) {
    antialias_act_kernel<true, IoT><<<grid, kThreads, 0, s>>>(xi, yi, alpha, inv_beta, ld, C, T,
                                                               tiles, vec, t);
  } else {
    antialias_act_kernel<false, IoT><<<grid, kThreads, 0, s>>>(xi, yi, alpha, inv_beta, ld, C, T,
                                                                tiles, vec, t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifndef ANTIALIAS_ACT_IO_BF16

// Launches one anti-aliased activation on `stream` (a cudaStream_t): x
// float32 rows of T samples, ld elements apart (ld = T when contiguous; a
// trimmed view's rows are longer), y (rows, T) contiguous float32, row r of
// channel r % C; alpha and inv_beta (C,) float32 on the device; taps a host
// array of 24 floats, the up filter then the down filter.  approx != 0
// takes the polynomial sin^2.  Returns the launch's CUDA error code (0 on
// success); it does not synchronise.  rows, C or T below 1, ld below T, or
// a grid beyond 2^31 - 1 blocks, give cudaErrorInvalidValue.
extern "C" int antialias_act_f32(const void* x, void* y, const float* alpha,
                                 const float* inv_beta, const float* taps, long long rows,
                                 long long ld, int C, int T, int approx, void* stream) {
  return launch<float>(x, y, alpha, inv_beta, taps, rows, ld, C, T, approx, stream);
}

#else  // ANTIALIAS_ACT_IO_BF16

// antialias_act_f32 with bf16 activations: x and y bf16 (widened on load,
// rounded once on store), the arithmetic and everything else as there.
extern "C" int antialias_act_f32_io_bf16(const void* x, void* y, const float* alpha,
                                         const float* inv_beta, const float* taps, long long rows,
                                         long long ld, int C, int T, int approx, void* stream) {
  return launch<__nv_bfloat16>(x, y, alpha, inv_beta, taps, rows, ld, C, T, approx, stream);
}

#endif  // ANTIALIAS_ACT_IO_BF16
