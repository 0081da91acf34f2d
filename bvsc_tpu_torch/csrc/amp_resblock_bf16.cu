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
// contiguous, float32, or under the bf16 storage dtype bf16 (the TPU
// kernel's out_dtype = x.dtype): the I/O element type is a template
// parameter; a bf16 window is read with plain loads and widened to the
// float32 residual exactly (cp.async copies float32 only: it moves 4, 8 or
// 16 bytes), and the final store rounds once to nearest-even bf16
// (__float2bfloat16_rn, as _amp_kernel's astype(out_dtype)).  This file
// builds the float32-I/O entry points; amp_resblock_bf16_io_bf16.cu includes
// it with AMP_RESBLOCK_IO_BF16 defined to build the bf16 one, so that nvcc
// compiles the two sets of instantiations in parallel.
//
// Tiling, as in amp_resblock.cu: one thread block owns one batch row and
// one tile of `tile` output samples, all C channels, and recomputes the left
// context H = (k - 1) * (d0 + d1 + d2 + 3) from a zero-filled window; each
// conv moves the valid window's start right by its own context.  After each
// conv (bias included) the positions with global t < 0 are set to 0, since
// the reference zero-pads the input of every conv.  Streaming, as in
// amp_resblock.cu: x may carry `ctx` samples of left context per row (x is
// (B, C, ctx + T), output column t is input column ctx + t, the halo read
// from the input wherever it lies at or after column 0), and start[b] (an
// int32 device array, or null for all 0) shifts row b's times to its
// stream's, so "t < 0" is a stream time; ctx = 0 with a null start is the
// offline launch, unchanged.  The wrapper picks the
// tile (ops/amp_resblock.py, tile_for): 8192 / C samples, halved while the
// halved grid still fits in one wave (the card's SMs times the blocks one
// SM holds), so a B = 4 call's stage 0 (2 056 samples at C = 64) runs 132
// blocks of 64.
//
// The conv as a GEMM on the tensor cores (mma.sync.m16n8k16, bf16 operands,
// float32 accumulation): M = output samples, N = C_out, K = (tap, c_in)
// with index tap * C + c_in, padded with zero weights to Kp, a multiple of
// 16 (only at C = 8, where one k16 step spans two taps).  Each tap's product
// (two taps at C = 8) is formed from a zero accumulator and then added to
// the running sum in float32, as the TPU kernel adds its per-tap dots: a
// long chain of k-steps in one tensor-core accumulator drifts, because its
// float32 accumulation does not round to nearest.
//
// What bounds it on the card: the tensor cores at C = 64 (6 * 2 C^2 k FLOP
// per sample against 8 bytes of input and output), and below that the
// snakes on the CUDA cores: 6 exact sinf per channel and sample, 18
// float32-pipe instructions each on sinf's fast path, cost more than the
// convs' products.  Measured, it is neither yet: latency, with one block of
// 16 warps an SM at C >= 32 (chip_smoke.py prints both floors).  What the
// design does about it:
// - Compile-time shapes: a template on (C, k); the dilation only shifts a
//   row address.  Other shapes are refused before the launch.
// - Operands through ldmatrix.  The post-snake activations are bf16,
//   time-major, with a row stride SA = C + 8 (8 at C = 8): an odd number of
//   16-byte units, so the 8 rows of one 8 x 8 matrix hit distinct banks.  A
//   tap's shift is only a per-lane row address, so the im2col costs
//   nothing.  At C = 8 lanes 16-31 point at the second tap's rows, or at a
//   zeroed row for the padding tap past k.
// - Weights in shared memory at every C: each conv's packed weights (rows
//   of C_out, stride Kp + 8, again an odd number of 16-byte units), copied
//   by cp.async during the snake pass before conv 1, into two buffers where
//   both convs' fit beside the window (all shapes but C = 64, k = 11), else
//   into one, refilled between the convs.  The input window arrives by
//   cp.async too, every load in flight at once.
// - A register-blocked warp tile of R_m m16 tiles x 8 NT_w output channels:
//   1 x 32 at C = 64 and 2 x 16 at C = 32 (C_out split over two warps), 2 x
//   16 at C = 16, 2 x 8 at C = 8, so each A fragment feeds NT_w mmas and each
//   B fragment R_m.  Larger tiles (2 x 32 at C >= 32, 4 x C below) left
//   warps without items and ran 4-20 % slower on an H100; sums stay within
//   128 registers.
// - Threads: 512 a block at C >= 32 (one block an SM: shared memory), 256
//   at C <= 16, where two or three blocks share an SM and one's snake pass
//   overlaps another's products.
// - Snakes on every thread: the snake before conv 1 is a pass over the
//   window free of bank conflicts (each thread turns 8 channels of one time
//   into one 16-byte row of the operand); the snake before conv 2 is conv
//   1's epilogue.  Alpha and 1 / beta sit in shared memory.  (Conv 2's
//   epilogue could apply the next unit's first snake, but only the warps
//   that own conv items would run it: 25-40 % slower at C >= 16.)
// What it does not do yet: wgmma (64-row warpgroup products reading the
// shifted windows from shared memory, which needs a channel-group-major
// [C / 8][t][8] operand layout), share halos between tiles, or overlap the
// weight copies at C = 64, k = 11.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kUnits = 3;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use

// The warp tile and operand layout for C channels.
template <int C>
struct Blocking {
  static_assert(C == 8 || C == 16 || C == 32 || C == 64, "C must be 8, 16, 32 or 64");
  static constexpr int threads = C >= 32 ? 512 : 256;  // C <= 16: two blocks an SM
  static constexpr int warps = threads / 32;
  static constexpr int nt = C / 8;                     // n8 tiles of C_out
  static constexpr int rm = C == 64 ? 1 : 2;           // m16 tiles per warp item
  static constexpr int ntw = C == 64 ? 4 : C == 32 ? 2 : nt;  // n8 tiles per warp item:
                                                              // C_out split over 2 at C >= 32
  static constexpr int nsplit = nt / ntw;              // warp items across C_out
  static constexpr int steps = C >= 16 ? C / 16 : 1;   // k16 steps per tap (C = 8: per 2 taps)
  static constexpr int sa = C >= 16 ? C + 8 : 8;       // operand row stride, bf16
  static_assert(ntw == 1 || ntw % 2 == 0, "B fragments come in pairs of n8 tiles");
};

template <int C, int K>
struct Conv {
  static constexpr int kp = (C * K + 15) / 16 * 16;  // GEMM K, padded
  static constexpr int sw = kp + 8;                  // weight row stride, bf16
  static constexpr int groups = C >= 16 ? K : kp / 16;  // per-tap sums (C = 8: per 2 taps)
  static constexpr int weight_bytes = 2 * C * sw;
};

// Byte offsets of the shared-memory buffers for a window of L samples:
// the float32 residual xs (C x sx, sx = L rounded up to 4 mod 16, so the
// epilogue's (channel pair, time) writes hit distinct banks), the two bf16
// operands a1 and a2 (L x SA), a zeroed row, alpha and 1 / beta (6 C
// floats each), and one or two weight buffers.
struct Layout {
  int sx, a1, a2, zero, par, w0, w1, bytes, weight_buffers;
};

template <int C, int K>
Layout layout(int L) {
  using G = Blocking<C>;
  Layout s{};
  s.sx = L + ((4 - L % 16) + 16) % 16;
  int off = 4 * C * s.sx;
  s.a1 = off;
  off += 2 * L * G::sa;
  s.a2 = off;
  off += 2 * L * G::sa;
  s.zero = off;
  off += 16;
  s.par = off;
  off += 4 * 12 * C;
  s.w0 = off;
  off += Conv<C, K>::weight_bytes;
  s.weight_buffers = off + Conv<C, K>::weight_bytes <= kSmemLimit ? 2 : 1;
  s.w1 = s.weight_buffers == 2 ? off : s.w0;
  if (s.weight_buffers == 2) off += Conv<C, K>::weight_bytes;
  s.bytes = off;
  return s;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// 4 bytes, or 4 zeros where !ok (src-size 0).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8 i to 8 i + 7 give the row addresses of
// matrix i, and each lane gets row lane / 4, elements 2 (lane % 4) and
// 2 (lane % 4) + 1 of every matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
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

struct Args {
  const void* x;            // (B, C, ctx + T) of the I/O type
  void* y;                  // (B, C, T) of the I/O type
  const __nv_bfloat16* w1;  // (3, C, Kp) bf16, index [j][co][tap * C + ci]
  const float* b1;          // (3, C)
  const __nv_bfloat16* w2;  // (3, C, Kp) bf16
  const float* b2;          // (3, C)
  const float* alpha;       // (6, C), exp(log alpha)
  const float* inv_b;       // (6, C), 1 / (exp(log beta) + 1e-9)
  const int* start;         // (B,) samples each row's stream fed before output 0, or null
  int T, ctx, tile, halo, L;  // x rows hold ctx + T samples, y rows T
  int d[kUnits];
  Layout lay;
};

// f(c, i) for every channel c < C and column i in [lo, hi): (channel, part)
// rows spread over the warps, lanes on consecutive columns.
template <int C, class F>
__device__ __forceinline__ void for_window(int lo, int hi, F f) {
  constexpr int kWarps = Blocking<C>::warps;
  constexpr int kParts = kWarps > C ? kWarps / C : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < C * kParts; r += kWarps) {
    const int c = r / kParts;
    for (int i = lo + (r % kParts) * 32 + lane; i < hi; i += 32 * kParts) f(c, i);
  }
}

// Starts copying one conv's packed weights, C rows of Kp, into rows of SW.
template <int C, int K>
__device__ __forceinline__ void stage_weights(uint32_t ws, const __nv_bfloat16* w) {
  using V = Conv<C, K>;
  constexpr int row_chunks = V::kp / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < C * row_chunks; i += Blocking<C>::threads) {
    const int row = i / row_chunks, ch = i - row * row_chunks;
    cp_async16(ws + 2 * (row * V::sw + 8 * ch), w + row * V::kp + 8 * ch);
  }
  cp_async_commit();
}

// dst[t, :] = bf16(snake_beta(xs[:, t])) for t in [lo, L): each thread
// writes the 8 channels of one time as one 16-byte row segment; lanes take
// consecutive times, so reads of xs and writes of dst are free of bank
// conflicts.
template <int C>
__device__ void snake_pass(const float* xs, int sx, __nv_bfloat16* dst, const float* a,
                           const float* inv_b, int L, int lo) {
  constexpr int SA = Blocking<C>::sa;
  const int n = L - lo;
  for (int i = threadIdx.x; i < n * (C / 8); i += Blocking<C>::threads) {
    const int cg = i / n;
    const int t = lo + i - cg * n;
    const int c0 = 8 * cg;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 2 * j;
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          snake_beta(xs[c * sx + t], a[c], inv_b[c]),
          snake_beta(xs[(c + 1) * sx + t], a[c + 1], inv_b[c + 1]));
      w[j] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(dst + t * SA + c0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Causal conv over the window [lo, L) of the bf16 operand at `src`:
//   v[t, co] = b[co] + sum_tap sum_ci w[co, ci, tap] * src[t - (K - 1 - tap) * d, ci]
// (v = 0 where the stream time t + g0 is negative), with the weights at
// `ws`.  kSnakeOut: write bf16(snake_beta(v)) with activation (a, inv_b)
// into the time-major `out`; else add v into the residual stream xs.  A
// warp item is R_m m16 tiles x NT_w n8 tiles; rows past L are computed from
// clamped reads and discarded.
template <int C, int K, bool kSnakeOut>
__device__ void conv_tc(uint32_t src, uint32_t ws, const float* __restrict__ bias, int L, int d,
                        int lo, int g0, uint32_t zero, __nv_bfloat16* out, const float* a,
                        const float* inv_b, float* xs, int sx) {
  using G = Blocking<C>;
  using V = Conv<C, K>;
  constexpr int RM = G::rm, NTW = G::ntw, SA = G::sa;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int n_m = (L - lo + 15) / 16;
  const int n_items = (n_m + RM - 1) / RM * G::nsplit;
  for (int item = warp; item < n_items; item += G::warps) {
    const int mi = item / G::nsplit;
    const int nh = item - mi * G::nsplit;
    const int tm = lo + 16 * RM * mi;
    // A: lanes 0-15 give rows 0-15 of an m16 tile, lanes 16-31 the same
    // rows at channel 8 (C >= 16) or at the group's second tap (C = 8).
    uint32_t arow[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = min(tm + 16 * r + (lane & 15), L - 1);
      arow[r] = src + 2 * (row * SA + (C >= 16 ? (lane >> 4) * 8 : 0));
    }
    // B: weight rows co (lanes 0-7: n8 tile 2p, k 0-7; 8-15: k 8-15;
    // 16-31: n8 tile 2p + 1), so one x4 gives two n8 tiles' fragments.
    const int co_lane = 8 * NTW * nh + (lane & 7) + (NTW >= 2 ? ((lane >> 4) & 1) * 8 : 0);
    const uint32_t brow = ws + 2 * (co_lane * V::sw + ((lane >> 3) & 1) * 8);

    float run[RM][NTW][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int n = 0; n < NTW; ++n) run[r][n][0] = run[r][n][1] = run[r][n][2] = run[r][n][3] = 0.0f;
#pragma unroll
    for (int grp = 0; grp < V::groups; ++grp) {
      float part[RM][NTW][4];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int n = 0; n < NTW; ++n)
          part[r][n][0] = part[r][n][1] = part[r][n][2] = part[r][n][3] = 0.0f;
#pragma unroll
      for (int st = 0; st < G::steps; ++st) {
        const int s = grp * G::steps + st;  // k16 step
        uint32_t af[RM][4];
        if constexpr (C >= 16) {
          const uint32_t shift = 2u * static_cast<uint32_t>((K - 1 - grp) * d * SA) - 32u * st;
#pragma unroll
          for (int r = 0; r < RM; ++r) ldsm_x4(af[r], arow[r] - shift);
        } else {
          const int tap = 2 * grp + (lane >> 4);
          const uint32_t shift = 2u * static_cast<uint32_t>((K - 1 - tap) * d * SA);
#pragma unroll
          for (int r = 0; r < RM; ++r) ldsm_x4(af[r], tap < K ? arow[r] - shift : zero);
        }
        uint32_t bf[NTW][2];
        if constexpr (NTW == 1) {
          ldsm_x2(bf[0], brow + 32 * s);
        } else {
#pragma unroll
          for (int p = 0; p < NTW / 2; ++p) {
            uint32_t b4[4];
            ldsm_x4(b4, brow + 2 * (16 * p * V::sw) + 32 * s);
            bf[2 * p][0] = b4[0];
            bf[2 * p][1] = b4[1];
            bf[2 * p + 1][0] = b4[2];
            bf[2 * p + 1][1] = b4[3];
          }
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int n = 0; n < NTW; ++n) mma_bf16(part[r][n], af[r], bf[n]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[r][n][e] += part[r][n][e];
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int co = 8 * (NTW * nh + n) + 2 * q;
      const float bias0 = __ldg(bias + co), bias1 = __ldg(bias + co + 1);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = tm + 16 * r + g + 8 * h;
          if (t >= L) continue;
          const bool pre = t + g0 < 0;
          const float v0 = pre ? 0.0f : run[r][n][2 * h] + bias0;
          const float v1 = pre ? 0.0f : run[r][n][2 * h + 1] + bias1;
          if constexpr (kSnakeOut) {
            *reinterpret_cast<__nv_bfloat162*>(out + t * SA + co) = __floats2bfloat162_rn(
                snake_beta(v0, a[co], inv_b[co]), snake_beta(v1, a[co + 1], inv_b[co + 1]));
          } else {
            xs[co * sx + t] += v0;
            xs[(co + 1) * sx + t] += v1;
          }
        }
      }
    }
  }
}

template <int C, int K, class IO>
__global__ void __launch_bounds__(Blocking<C>::threads, 512 / Blocking<C>::threads)
    amp_resblock_bf16_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& s = p.lay;
  const int L = p.L, sx = s.sx;
  float* xs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* a1 = reinterpret_cast<__nv_bfloat16*>(smem + s.a1);  // conv 1 input
  __nv_bfloat16* a2 = reinterpret_cast<__nv_bfloat16*>(smem + s.a2);  // conv 2 input
  float* alpha = reinterpret_cast<float*>(smem + s.par);              // (6, C)
  float* inv_b = alpha + 6 * C;                                       // (6, C)
  const uint32_t w0 = smem_addr(smem + s.w0), w1 = smem_addr(smem + s.w1);
  const uint32_t zero = smem_addr(smem + s.zero);
  const bool two = s.weight_buffers == 2;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * p.tile;
  const int g0 = t0 - p.halo;                              // output column of buffer column 0
  const int s0 = g0 + (p.start ? __ldg(p.start + b) : 0);  // its stream time
  const int T = p.T, Tin = p.ctx + p.T;
  const IO* xb = static_cast<const IO*>(p.x) + static_cast<size_t>(b) * C * Tin;

  for (int i = threadIdx.x; i < 6 * C; i += Blocking<C>::threads) {
    alpha[i] = p.alpha[i];
    inv_b[i] = p.inv_b[i];
  }
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem + s.zero)[threadIdx.x] = 0u;
  // the window, zero outside the input and before the stream's start: a
  // float32 input by cp.async, every load in flight at once; a bf16 one
  // loaded and widened
  for_window<C>(0, L, [&](int c, int i) {
    const int gt = p.ctx + g0 + i;  // input column
    const bool ok = gt >= 0 && gt < Tin && s0 + i >= 0;
    if constexpr (sizeof(IO) == 4)
      cp_async4(smem_addr(xs + c * sx + i), ok ? xb + static_cast<size_t>(c) * Tin + gt : xb, ok);
    else
      xs[c * sx + i] = ok ? widen(xb[static_cast<size_t>(c) * Tin + gt]) : 0.0f;
  });
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  int lo = 0;
  for (int j = 0; j < kUnits; ++j) {
    const size_t wo = static_cast<size_t>(j) * C * Conv<C, K>::kp;
    const int d = j == 0 ? p.d[0] : (j == 1 ? p.d[1] : p.d[2]);
    // every read of w0 and w1 ended at the last __syncthreads
    stage_weights<C, K>(w0, p.w1 + wo);
    if (two) stage_weights<C, K>(w1, p.w2 + wo);
    snake_pass<C>(xs, sx, a1, alpha + 2 * j * C, inv_b + 2 * j * C, L, lo);
    if (two) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    lo += (K - 1) * d;
    conv_tc<C, K, true>(smem_addr(a1), w0, p.b1 + j * C, L, d, lo, s0, zero, a2,
                        alpha + (2 * j + 1) * C, inv_b + (2 * j + 1) * C, nullptr, sx);
    if (!two) {  // one buffer: refill it once every warp is done with conv 1
      __syncthreads();
      stage_weights<C, K>(w0, p.w2 + wo);
    }
    cp_async_wait<0>();
    __syncthreads();
    lo += K - 1;
    conv_tc<C, K, false>(smem_addr(a2), w1, p.b2 + j * C, L, 1, lo, s0, zero, nullptr, nullptr,
                         nullptr, xs, sx);
    __syncthreads();
  }

  IO* yb = static_cast<IO*>(p.y) + static_cast<size_t>(b) * C * T;
  const int n = T - t0 < p.tile ? T - t0 : p.tile;
  for_window<C>(0, n, [&](int c, int i) {
    yb[static_cast<size_t>(c) * T + t0 + i] = narrow<IO>(xs[c * sx + p.halo + i]);
  });
}

bool shape_ok(const int (&d)[kUnits], int tile) {
  for (int v : d)
    if (v != 1 && v != 3 && v != 5) return false;
  return tile > 0 && tile % 16 == 0;
}

template <int C, int K, class IO>
int launch(Args p, int B, cudaStream_t stream) {
  p.lay = layout<C, K>(p.L);
  if (p.lay.bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(amp_resblock_bf16_kernel<C, K, IO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + p.tile - 1) / p.tile, B);
  amp_resblock_bf16_kernel<C, K, IO><<<grid, Blocking<C>::threads, p.lay.bytes, stream>>>(p);
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
    const Layout s = layout<C, K>(L);
    out[0] = Blocking<C>::threads;
    out[1] = s.bytes;
    out[2] = Blocking<C>::rm;
    out[3] = 8 * Blocking<C>::ntw;
    out[4] = s.weight_buffers;
    out[5] = 0;  // blocks an SM holds at once (0: the window does not fit)
    if (s.bytes > kSmemLimit) return 0;
    cudaError_t err = cudaFuncSetAttribute(amp_resblock_bf16_kernel<C, K, float>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, s.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out + 5, amp_resblock_bf16_kernel<C, K, float>, Blocking<C>::threads, s.bytes);
    return static_cast<int>(err);
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
int launch_entry(const void* x, void* y, const void* w1, const float* b1, const void* w2,
                 const float* b2, const float* alpha, const float* inv_beta, const int* start,
                 int B, int C, int T, int ctx, int k, int d0, int d1, int d2, int tile,
                 void* stream) {
  Args p{x, y, static_cast<const __nv_bfloat16*>(w1), b1, static_cast<const __nv_bfloat16*>(w2),
         b2, alpha, inv_beta, start, T, ctx, tile, 0, 0, {d0, d1, d2}, Layout{}};
  if (!shape_ok(p.d, tile) || ctx < 0) return static_cast<int>(cudaErrorInvalidValue);
  p.halo = (k - 1) * (d0 + d1 + d2 + kUnits);
  p.L = p.halo + tile;
  return dispatch(C, k, Launch<IO>{p, B, static_cast<cudaStream_t>(stream)});
}

}  // namespace

#ifndef AMP_RESBLOCK_IO_BF16

// One snake, alone: never launched.  Its SASS is what chip_smoke.py counts
// (cuobjdump -sass) for the float32 instructions of one snake evaluation,
// the unit of the snake floor it prints beside each bf16 stage's bound.
extern "C" __global__ void snake_sass_probe(const float* x, float* y, float a, float inv_b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = snake_beta(x[i], a, inv_b);
}

// Launches one resblock on `stream` (a cudaStream_t): x (B, C, ctx + T),
// y (B, C, T), start null or (B,) int32 (see the header).  w1 and w2 are
// the packed bf16 weights (3, C, Kp), Kp = 16 * ceil(C k / 16), 16-byte
// aligned.  Returns the CUDA error code of the launch (0 on success); it
// does not synchronise.  A (C, k, d) outside C in {8, 16, 32, 64}, k in {3,
// 7, 11}, d in {1, 3, 5}, a tile that is not a positive multiple of 16, a
// negative ctx, or a window whose shared memory exceeds one block's gives
// cudaErrorInvalidValue.
extern "C" int amp_resblock_bf16(const float* x, float* y, const void* w1, const float* b1,
                                 const void* w2, const float* b2, const float* alpha,
                                 const float* inv_beta, const int* start, int B, int C, int T,
                                 int ctx, int k, int d0, int d1, int d2, int tile, void* stream) {
  return launch_entry<float>(x, y, w1, b1, w2, b2, alpha, inv_beta, start, B, C, T, ctx, k, d0,
                             d1, d2, tile, stream);
}

// The launch's shape for (C, k, d0..d2, tile): out[0] threads per block,
// out[1] bytes of shared memory, out[2] R_m (m16 tiles per warp item),
// out[3] output channels per warp item, out[4] weight buffers (2: both
// convs of a unit staged at once; 1: refilled between them), out[5] blocks
// an SM holds at once (the occupancy calculator's; 0 where the window does
// not fit).  Returns 0, cudaErrorInvalidValue for a shape the kernel does
// not take, or the error of the occupancy query.
extern "C" int amp_resblock_bf16_plan(int C, int k, int d0, int d1, int d2, int tile, int* out) {
  const int d[kUnits] = {d0, d1, d2};
  if (!shape_ok(d, tile)) return static_cast<int>(cudaErrorInvalidValue);
  const int L = (k - 1) * (d0 + d1 + d2 + kUnits) + tile;
  return dispatch(C, k, Plan{L, out});
}

#else  // AMP_RESBLOCK_IO_BF16

// amp_resblock_bf16 with bf16 activations: x (B, C, ctx + T) and y (B, C,
// T) bf16 (widened on load, rounded once on store), everything else as
// there.
extern "C" int amp_resblock_bf16_io_bf16(const void* x, void* y, const void* w1, const float* b1,
                                         const void* w2, const float* b2, const float* alpha,
                                         const float* inv_beta, const int* start, int B, int C,
                                         int T, int ctx, int k, int d0, int d1, int d2, int tile,
                                         void* stream) {
  return launch_entry<__nv_bfloat16>(x, y, w1, b1, w2, b2, alpha, inv_beta, start, B, C, T, ctx,
                                     k, d0, d1, d2, tile, stream);
}

#endif  // AMP_RESBLOCK_IO_BF16
