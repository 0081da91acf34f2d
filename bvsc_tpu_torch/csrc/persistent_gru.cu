// A persistent GRU recurrence for sm_90a: `steps` GRU steps in one launch,
// with the weights resident in shared memory.  Replaces the Pallas TPU kernel
// benchmarks/probe_persistent_gru.py (persistent_kernel, launched by
// pallas_persistent).
//
// Each step, for the 8 rows of h (the probe's LANES):
//   x  = [bf16(h) | bf16(xconst)]                         (8, 2H)
//   gi = x . W_ih + b_ih,  gh = bf16(h) . W_hh + b_hh      (8, 3H), f32 sums
//   r = sigmoid(i_r + h_r), z = sigmoid(i_z + h_z), n = tanh(i_n + r * h_n)
//   h = (1 - z) * n + z * h                                in f32
// with the gate columns packed [r | z | n].  The xconst half of x . W_ih is
// recomputed every step on purpose, as in the probe: it stands for the
// decode cell's feedback input, which cannot be hoisted out of the loop.
// int8 weights (the probe's variant E) are widened to float with no scale,
// exactly as the Pallas kernel widens them to bf16: the JAX probe's E leaves
// the quantisation scale out, so its weights are the raw +-127 integers.
//
// Design.  The TPU kernel keeps all 18.9 MB of weights in one core's VMEM;
// one SM holds at most 227 KB.  So the hidden units are split over a
// cooperative grid: block b owns U units (U = ceil(H / number of SMs), so
// 128 blocks of 8 units on a 132-SM H100) and loads their 3U gate columns of
// W_ih and W_hh once, column-major, into shared memory (bf16: 18 U H bytes,
// 147 456 B at U = 8, H = 1024; int8: half that).  Each step it reads the
// whole h from device memory (L2; written by every block the step before,
// so read with ld.global.cg past the incoherent L1) into a bf16 copy of x,
// computes its 8 x 3U gate sums, applies the GRU for its units and writes
// them into the other half of a ping-pong h buffer; one grid.sync() per
// step orders the steps.  The cooperative launch fails, rather than hangs,
// when the blocks cannot all be resident at once.
//
// Inside a block one warp owns one unit: its 32 lanes split the
// contraction in chunks of 8 (one 16-byte shared-memory load per weight
// column and per row of x, consecutive lanes on consecutive chunks, so no
// bank conflicts), keep 48 f32 partial sums (3 gates x 8 rows for each of
// gi and gh), and sum them with a butterfly of shuffles.
//
// What bounds it: the operations, 2 * 8 * 3H * 3H FLOP per step (77.3 GFLOP
// for H = 1024 and 512 steps), here as f32 FMAs on the CUDA cores from bf16
// shared memory (products of bf16 values are exact in f32, so only the
// summation order differs from the Pallas kernel); then the grid barrier
// and the 32 KB read of h per block per step.  Tensor cores (mma.sync or
// wgmma over the 8 rows padded to 16) are the obvious next step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 8;      // rows of h
constexpr int kChunk = 8;      // contraction values per shared-memory load
constexpr int kMaxUnits = 12;  // units per block, so at most 384 threads
constexpr int kSmemLimit = 232448;

struct Args {
  const void* wi;   // (2H, 3H) bf16 or int8
  const void* wh;   // (H, 3H) bf16 or int8
  const float* bi;  // (3H)
  const float* bh;  // (3H)
  const float* xc;  // (8, H)
  const float* h0;  // (8, H)
  float* hbuf;      // (2, 8, H): the state between steps
  float* out;       // (8, H)
  int H;
  int steps;
  int units;
};

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void unpack(uint4 v, float (&f)[kChunk]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}

// Eight consecutive weights of one column as floats: bf16 bits or int8.
__device__ __forceinline__ void load_chunk(const uint16_t* p, float (&f)[kChunk]) {
  unpack(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load_chunk(const int8_t* p, float (&f)[kChunk]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = static_cast<float>(static_cast<int8_t>((v.x >> (8 * i)) & 0xffu));
    f[4 + i] = static_cast<float>(static_cast<int8_t>((v.y >> (8 * i)) & 0xffu));
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// This lane's partial sums acc[g][l] = sum_k x[l, k] * w_s[g * U + u, k]
// over its chunks of k in [0, K).  x rows are x_stride apart.
template <typename W>
__device__ __forceinline__ void gate_sums(const W* w_s, int K, const uint16_t* x_s, int x_stride,
                                          int U, int u, int lane, float (&acc)[3][kLanes]) {
  for (int k = lane * kChunk; k < K; k += 32 * kChunk) {
    float w[3][kChunk];
#pragma unroll
    for (int g = 0; g < 3; ++g) load_chunk(w_s + static_cast<size_t>(g * U + u) * K + k, w[g]);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      float x[kChunk];
      unpack(*reinterpret_cast<const uint4*>(x_s + l * x_stride + k), x);
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int e = 0; e < kChunk; ++e) acc[g][l] = fmaf(x[e], w[g][e], acc[g][l]);
    }
  }
}

__device__ __forceinline__ void warp_sum(float (&acc)[3][kLanes]) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[g][l] += __shfl_xor_sync(0xffffffffu, acc[g][l], off);
}

// Column c = g * U + u of the block's shared-memory copy of w (rows, 3H):
// global column g * H + u0 + u, zero past H.
template <typename W>
__device__ void load_columns(const W* w, W* w_s, int rows, int H, int U, int u0) {
  const int G = 3 * U;
  for (int i = threadIdx.x; i < G * rows; i += blockDim.x) {
    const int c = i % G;  // consecutive threads: consecutive columns
    const int k = i / G;
    const int j = u0 + c % U;
    w_s[static_cast<size_t>(c) * rows + k] =
        j < H ? w[static_cast<size_t>(k) * 3 * H + (c / U) * H + j] : W(0);
  }
}

template <typename W>
__global__ void __launch_bounds__(32 * kMaxUnits) persistent_gru_kernel(Args p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, KI = 2 * H, U = p.units, G = 3 * U;
  const int u0 = blockIdx.x * U;
  W* wi_s = reinterpret_cast<W*>(smem);                                      // (3U, 2H)
  W* wh_s = wi_s + static_cast<size_t>(G) * KI;                              // (3U, H)
  uint16_t* x_s = reinterpret_cast<uint16_t*>(wh_s + static_cast<size_t>(G) * H);  // (8, 2H)

  load_columns(static_cast<const W*>(p.wi), wi_s, KI, H, U, u0);
  load_columns(static_cast<const W*>(p.wh), wh_s, H, H, U, u0);
  for (int i = threadIdx.x; i < kLanes * H; i += blockDim.x)
    x_s[(i / H) * KI + H + i % H] = static_cast<uint16_t>(bf16_bits(p.xc[i]));

  const int lane = threadIdx.x % 32;
  const int u = threadIdx.x / 32;
  const int j = u0 + u;  // this warp's hidden unit
  const bool active = j < H;
  float b[6] = {};
  if (active && lane < kLanes) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      b[g] = p.bi[g * H + j];
      b[3 + g] = p.bh[g * H + j];
    }
  }
  __syncthreads();

  for (int t = 0; t < p.steps; ++t) {
    const float* hin = t == 0 ? p.h0 : p.hbuf + static_cast<size_t>((t - 1) & 1) * kLanes * H;
    float* hout = t == p.steps - 1 ? p.out : p.hbuf + static_cast<size_t>(t & 1) * kLanes * H;

    // x[:, :H] = bf16(h), four values per thread and load
    for (int i = threadIdx.x; i < kLanes * H / 4; i += blockDim.x) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(hin) + i);
      const int l = (4 * i) / H, k = (4 * i) % H;
      uint2 packed;
      packed.x = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
      packed.y = bf16_bits(v.z) | (bf16_bits(v.w) << 16);
      *reinterpret_cast<uint2*>(x_s + l * KI + k) = packed;
    }
    __syncthreads();

    if (active) {  // warp-uniform
      float gi[3][kLanes] = {}, gh[3][kLanes] = {};
      gate_sums(wi_s, KI, x_s, KI, U, u, lane, gi);
      gate_sums(wh_s, H, x_s, KI, U, u, lane, gh);
      warp_sum(gi);
      warp_sum(gh);
      if (lane < kLanes) {
        float s[6] = {};
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          if (lane == l) {
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              s[g] = gi[g][l];
              s[3 + g] = gh[g][l];
            }
          }
        }
        const float i_r = s[0] + b[0], i_z = s[1] + b[1], i_n = s[2] + b[2];
        const float h_r = s[3] + b[3], h_z = s[4] + b[4], h_n = s[5] + b[5];
        const float r = sigmoid(i_r + h_r);
        const float z = sigmoid(i_z + h_z);
        const float n = tanhf(i_n + r * h_n);
        const float h = __ldcg(hin + lane * H + j);
        hout[lane * H + j] = (1.0f - z) * n + z * h;
      }
    }
    grid.sync();
  }
}

template <typename W>
size_t smem_bytes(int H, int units) {
  return sizeof(W) * 3 * static_cast<size_t>(units) * 3 * H + sizeof(uint16_t) * kLanes * 2 * H;
}

}  // namespace

// The launch plan on the current device: plan[0] units per block
// (ceil(H / SMs)), plan[1] blocks, plan[2] bytes of shared memory per block.
// Returns a CUDA error code (0 on success).
extern "C" int persistent_gru_plan(int H, int int8_weights, int* plan) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (H + n_sm - 1) / n_sm;
  plan[0] = units;
  plan[1] = (H + units - 1) / units;
  plan[2] = static_cast<int>(int8_weights ? smem_bytes<int8_t>(H, units)
                                          : smem_bytes<uint16_t>(H, units));
  return 0;
}

// Runs `steps` GRU steps on `stream` (a cudaStream_t) as one cooperative
// launch; the result goes to `out`, `hbuf` is scratch.  Pointers are to
// device memory laid out as in Args.  Returns the CUDA error code of the
// launch (0 on success); it does not synchronise.
extern "C" int persistent_gru(const void* wi, const void* wh, const float* bi, const float* bh,
                              const float* xc, const float* h0, float* hbuf, float* out, int H,
                              int steps, int int8_weights, void* stream) {
  int plan[3];
  int err = persistent_gru_plan(H, int8_weights, plan);
  if (err != 0) return err;
  const int units = plan[0], blocks = plan[1], smem = plan[2];
  if (units > kMaxUnits || smem > kSmemLimit || H % 16 != 0 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = int8_weights ? reinterpret_cast<const void*>(persistent_gru_kernel<int8_t>)
                                    : reinterpret_cast<const void*>(persistent_gru_kernel<uint16_t>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args args{wi, wh, bi, bh, xc, h0, hbuf, out, H, steps, units};
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(32 * units), params,
                                  static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
