// One AMP residual block of the causal BigVGAN-tiny vocoder in the TPU
// kernel's bf16 mode, on the H100's tensor cores, for sm_90a.  Replaces the
// Pallas TPU kernel bvsc_tpu/ops/pallas_voc.py (_amp_kernel, launched by
// amp_resblock_folded with compute_dtype=bfloat16, its default).
//
// What it computes, as the TPU kernel does in that mode: the block runs 3
// units, each
//   xt = snake_beta(x); xt = causal_conv(xt, k, dilation d_j);
//   xt = snake_beta(xt); xt = causal_conv(xt, k, 1); x = xt + x
// where each conv's two operands (the weights and the post-snake
// activations) are rounded to nearest-even bf16, the products are summed in
// float32, and snake (exact sinf, 1e-9 in the divisor), the bias, the
// sequence-start mask and the residual stay float32.  x and y are (B, C, T)
// contiguous float32.
//
// Tiling, as in amp_resblock.cu: one thread block owns one batch row and
// one tile of `tile` output samples, all C channels, and recomputes the left
// context H = (k - 1) * (d0 + d1 + d2 + 3) from a zero-filled window; each
// conv moves the valid window's start right by its own context.  After each
// conv (bias included) the positions with global t < 0 are set to 0, since
// the reference zero-pads the input of every conv.
//
// The conv as a GEMM on the tensor cores (mma.sync.m16n8k16, bf16 operands,
// float32 accumulation): M = 16 output samples, N = C_out (C / 8 n8 tiles),
// K = (tap, c_in) with index tap * C + c_in, padded with zero weights to a
// multiple of 16 (only at C = 8, where one k16 step spans two taps; its A
// values for a tap past k are set to 0).  The wrapper packs the weights as
// bf16 (3, C_out, Kp) rows, so a B fragment's pair along K is one 32-bit
// load.  Each tap's product (two taps at C = 8) is formed from a zero
// accumulator and then added to the running sum in float32, as the TPU
// kernel adds its per-tap dots: a long chain of k-steps in one tensor-core
// accumulator drifts, because its float32 accumulation does not round to
// nearest.
//
// Shared memory: the residual stream xs, float32, channel-major with a row
// stride SX = L rounded up to 4 mod 16 (so the epilogue's (time, channel
// pair) writes hit distinct banks), and two post-snake operand buffers,
// bf16, time-major with a row stride SA = C + 8 (C >= 16) or 8 (C = 8), so
// an A fragment's (channel pair) is one 32-bit load and the 8 time rows of
// a fragment hit distinct banks.  That is 4 C SX + 4 L SA bytes, about 2/3
// of the float32 kernel's per sample, so the tile is twice as long.
//
// What bounds it: bytes, in principle (one float32 read and one write of
// (B, C, T) per block against 6 * 2 C^2 k FLOP per sample at the tensor
// cores' bf16 rate).  This first version is simple: each warp computes a
// 16 x C output tile at a time, its A fragments from shared memory, its B
// fragments from the read-only cache (no weights in shared memory, no
// software pipelining, no wgmma), and snake runs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 3;

__device__ __forceinline__ float snake_beta(float v, float a, float inv_b) {
  const float s = sinf(a * v);
  return v + inv_b * (s * s);
}

// d += a . b: A 16 x 16 row-major, B 16 x 8 column-major, bf16 pairs packed
// low element first; D 16 x 8 float32.  Lane (g, q) = (lane / 4, lane % 4)
// holds A rows g and g + 8 at columns 2q, 2q + 1 and 2q + 8, 2q + 9
// (a[0] = (g, 2q), a[1] = (g + 8, 2q), a[2] = (g, 2q + 8), a[3] = (g + 8,
// 2q + 8)), B column g at rows 2q, 2q + 1 (b[0]) and 2q + 8, 2q + 9 (b[1]),
// and D rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2q, 2q + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 pair (channels c, c + 1) at time t of a time-major buffer.
__device__ __forceinline__ uint32_t pair_at(const __nv_bfloat16* buf, int sa, int t, int c) {
  return *reinterpret_cast<const uint32_t*>(buf + t * sa + c);
}

template <int C>
struct Shape {
  static_assert(C == 8 || C == 16 || C == 32 || C == 64, "C must be 8, 16, 32 or 64");
  static constexpr int kNTiles = C / 8;                     // n8 tiles of C_out
  static constexpr int kStepsPerGroup = C >= 16 ? C / 16 : 1;  // k16 steps per tap
                                                            // (at C = 8, one per 2 taps)
  static constexpr int kSA = C >= 16 ? C + 8 : C;           // bf16 row stride
};

struct Args {
  const float* x;
  float* y;
  const uint32_t* w1;  // (3, C, Kp) bf16, index [j][co][tap * C + ci]
  const float* b1;     // (3, C)
  const uint32_t* w2;  // (3, C, Kp) bf16
  const float* b2;     // (3, C)
  const float* alpha;  // (6, C), exp(log alpha)
  const float* inv_b;  // (6, C), 1 / (exp(log beta) + 1e-9)
  int T, k, tile, halo, L, sx, kp;
  int d[kUnits];
};

// dst[t, c] = bf16(snake_beta(xs[c, t])) for t in [lo, L).
template <int C>
__device__ void snake_to_bf16(const float* xs, int sx, __nv_bfloat16* dst, const float* __restrict__ a,
                              const float* __restrict__ inv_b, int L, int lo) {
  const int n = L - lo;
  for (int i = threadIdx.x; i < C * n; i += blockDim.x) {
    const int c = i / n;
    const int t = lo + i % n;
    dst[t * Shape<C>::kSA + c] =
        __float2bfloat16_rn(snake_beta(xs[c * sx + t], __ldg(a + c), __ldg(inv_b + c)));
  }
}

// Causal conv over the window [lo, L) of the bf16 operand `src`:
//   v[t, co] = b[co] + sum_tap sum_ci w[co, ci, tap] * src[t - (k - 1 - tap) * d, ci]
// (v = 0 where the global time t + g0 is negative).  kSnakeOut: write
// bf16(snake_beta(v)) with activation (a, inv_b) into the time-major `out`;
// else add v into the residual stream xs.
template <int C, bool kSnakeOut>
__device__ void conv_tc(const __nv_bfloat16* src, const uint32_t* __restrict__ w,
                        const float* __restrict__ bias, int kp, int L, int k, int d, int lo,
                        int g0, __nv_bfloat16* out, const float* __restrict__ a,
                        const float* __restrict__ inv_b, float* xs, int sx) {
  using S = Shape<C>;
  constexpr int NT = S::kNTiles;
  constexpr int SA = S::kSA;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int groups = kp / (16 * S::kStepsPerGroup);
  const int n_m = (L - lo + 15) / 16;
  const int wrow = kp / 2;  // 32-bit words per packed weight row
  for (int mt = warp; mt < n_m; mt += kWarps) {
    const int tm = lo + 16 * mt;
    const int r0 = min(tm + g, L - 1);  // rows past L are computed from
    const int r1 = min(tm + g + 8, L - 1);  // clamped reads and discarded
    float run[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      run[nt][0] = run[nt][1] = run[nt][2] = run[nt][3] = 0.0f;
    for (int grp = 0; grp < groups; ++grp) {
      float part[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        part[nt][0] = part[nt][1] = part[nt][2] = part[nt][3] = 0.0f;
#pragma unroll
      for (int st = 0; st < S::kStepsPerGroup; ++st) {
        const int s = grp * S::kStepsPerGroup + st;  // k16 step
        uint32_t af[4];
        if constexpr (C >= 16) {
          const int tap = (16 * s) / C;
          const int c = (16 * s) % C + 2 * q;
          const int sh = (k - 1 - tap) * d;
          af[0] = pair_at(src, SA, r0 - sh, c);
          af[1] = pair_at(src, SA, r1 - sh, c);
          af[2] = pair_at(src, SA, r0 - sh, c + 8);
          af[3] = pair_at(src, SA, r1 - sh, c + 8);
        } else {  // columns 0-7: tap 2s, columns 8-15: tap 2s + 1 (or padding)
          const int sh0 = (k - 1 - 2 * s) * d;
          af[0] = pair_at(src, SA, r0 - sh0, 2 * q);
          af[1] = pair_at(src, SA, r1 - sh0, 2 * q);
          if (2 * s + 1 < k) {
            const int sh1 = sh0 - d;
            af[2] = pair_at(src, SA, r0 - sh1, 2 * q);
            af[3] = pair_at(src, SA, r1 - sh1, 2 * q);
          } else {
            af[2] = af[3] = 0u;
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* wr = w + (8 * nt + g) * wrow + 8 * s + q;
          const uint32_t bf[2] = {__ldg(wr), __ldg(wr + 4)};
          mma_bf16(part[nt], af, bf);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        run[nt][0] += part[nt][0];
        run[nt][1] += part[nt][1];
        run[nt][2] += part[nt][2];
        run[nt][3] += part[nt][3];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int co = 8 * nt + 2 * q;
      const float bias0 = __ldg(bias + co), bias1 = __ldg(bias + co + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = tm + g + 8 * h;
        if (t >= L) continue;
        const bool pre = t + g0 < 0;
        const float v0 = pre ? 0.0f : run[nt][2 * h] + bias0;
        const float v1 = pre ? 0.0f : run[nt][2 * h + 1] + bias1;
        if constexpr (kSnakeOut) {
          *reinterpret_cast<__nv_bfloat162*>(out + t * SA + co) = __floats2bfloat162_rn(
              snake_beta(v0, __ldg(a + co), __ldg(inv_b + co)),
              snake_beta(v1, __ldg(a + co + 1), __ldg(inv_b + co + 1)));
        } else {
          xs[co * sx + t] += v0;
          xs[(co + 1) * sx + t] += v1;
        }
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) amp_resblock_bf16_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = Shape<C>;
  const int k = p.k, L = p.L, sx = p.sx;
  float* xs = reinterpret_cast<float*>(smem);                              // residual, C x sx
  __nv_bfloat16* a1 = reinterpret_cast<__nv_bfloat16*>(xs + C * sx);       // conv 1 input, L x SA
  __nv_bfloat16* a2 = a1 + L * S::kSA;                                     // conv 2 input, L x SA
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int g0 = t0 - p.halo;  // global time of buffer column 0
  const float* xb = p.x + static_cast<size_t>(b) * C * p.T;

  for (int i = threadIdx.x; i < C * L; i += blockDim.x) {
    const int c = i / L;
    const int t = i % L;
    const int gt = g0 + t;
    xs[c * sx + t] = (gt >= 0 && gt < p.T) ? xb[static_cast<size_t>(c) * p.T + gt] : 0.0f;
  }
  uint32_t* zero = reinterpret_cast<uint32_t*>(a1);
  for (int i = threadIdx.x; i < L * S::kSA; i += blockDim.x) zero[i] = 0u;  // both buffers
  __syncthreads();

  int lo = 0;
  for (int j = 0; j < kUnits; ++j) {
    const size_t wo = static_cast<size_t>(j) * C * (p.kp / 2);
    snake_to_bf16<C>(xs, sx, a1, p.alpha + (2 * j) * C, p.inv_b + (2 * j) * C, L, lo);
    __syncthreads();
    lo += (k - 1) * p.d[j];
    conv_tc<C, true>(a1, p.w1 + wo, p.b1 + j * C, p.kp, L, k, p.d[j], lo, g0, a2,
                     p.alpha + (2 * j + 1) * C, p.inv_b + (2 * j + 1) * C, nullptr, sx);
    __syncthreads();
    lo += k - 1;
    conv_tc<C, false>(a2, p.w2 + wo, p.b2 + j * C, p.kp, L, k, 1, lo, g0, nullptr, nullptr,
                      nullptr, xs, sx);
    __syncthreads();
  }

  float* yb = p.y + static_cast<size_t>(b) * C * p.T;
  for (int i = threadIdx.x; i < C * p.tile; i += blockDim.x) {
    const int c = i / p.tile;
    const int t = i % p.tile;
    if (t0 + t < p.T) yb[static_cast<size_t>(c) * p.T + t0 + t] = xs[c * sx + p.halo + t];
  }
}

template <int C>
int launch(const Args& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * C * static_cast<size_t>(p.sx) +
                      2 * sizeof(__nv_bfloat16) * static_cast<size_t>(p.L) * Shape<C>::kSA;
  cudaError_t err = cudaFuncSetAttribute(amp_resblock_bf16_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + p.tile - 1) / p.tile, B);
  amp_resblock_bf16_kernel<C><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one resblock on `stream` (a cudaStream_t).  w1 and w2 are the
// packed bf16 weights (3, C, Kp), Kp = the least multiple of 16 >= C * k,
// 16 * ceil(C k / 16).  C must be 8, 16, 32 or 64 and `tile` a multiple of
// 16.  Returns the CUDA error code of the launch (0 on success); it does
// not synchronise.
extern "C" int amp_resblock_bf16(const float* x, float* y, const void* w1, const float* b1,
                                 const void* w2, const float* b2, const float* alpha,
                                 const float* inv_beta, int B, int C, int T, int k, int d0,
                                 int d1, int d2, int tile, void* stream) {
  Args p{x, y, static_cast<const uint32_t*>(w1), b1, static_cast<const uint32_t*>(w2), b2,
         alpha, inv_beta, T, k, tile, 0, 0, 0, 0, {d0, d1, d2}};
  p.halo = (k - 1) * (d0 + d1 + d2 + kUnits);
  p.L = p.halo + tile;
  p.sx = p.L + ((4 - p.L % 16) + 16) % 16;
  p.kp = (C * k + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch<8>(p, B, s);
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
