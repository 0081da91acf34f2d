// A persistent GRU recurrence for sm_90a: `steps` GRU steps in one launch,
// with the weights resident on chip.  Replaces the Pallas TPU kernel
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
// int8 weights (the probe's variant E) are widened to bf16 with no scale,
// exactly as the Pallas kernel widens them outside its loop: the JAX probe's
// E leaves the quantisation scale out, so its weights are the raw +-127
// integers, which bf16 holds exactly.
//
// Partition.  The TPU kernel keeps all 18.9 MB of weights in one core's
// VMEM.  Here the hidden units are split over a cooperative grid: block b
// owns U = ceil(H / SMs) <= 8 units (128 blocks of 8 on a 132-SM H100),
// and its step is one small product on the tensor cores, mma.sync.m16n8k16
// (bf16 operands, f32 sums):
//   D (24 x 8) = A (24 x 3H) . X^T (3H x 8),   X = [bf16(h) | bf16(xc) | bf16(h)]
// where A's rows are the r, z and n columns of the block's units over the
// stacked contraction [W_ih; W_hh].  The 8 rows of h are the N = 8 side, so
// nothing is padded there; A is two m16 tiles, [r | z] and [n | 0] (rows
// of units past U, or past H, are zero too).  The contraction is split
// over 24 warps of 8 k-steps each: 16 warps own W_ih's 2H (x = [h | xc])
// and 8 own W_hh's H (x = h), so every warp's sums belong to gi or to gh
// alone, and the biases and gates apply to gi = x . W_ih + b_ih and
// gh = h . W_hh + b_hh as in the reference.  (One sum i_r + h_r over the
// whole stacked contraction is more exact but rounds elsewhere: with the
// probe's unscaled int8 weights, whose gate sums reach hundreds, it moves
// h by 1.5e-5 from the Pallas kernel after one step.)
//
// Staging.  Each warp loads its 8 k-steps' A fragments once, from device
// memory straight into registers: 4 registers a k-step for [r | z] and 2
// for [n | 0] (the zero half is a constant), 48 a thread.  int8 weights
// are widened to bf16 here, once, so the loop is one code path for both
// types.
//
// Per step.  (1) The block copies h, published as bf16 by every block the
// step before (16 KB; the float32 h0 at step 0), into shared memory beside
// bf16(xc) (rows padded by 16 bytes, so `ldmatrix` is conflict-free).
// (2) Each warp runs its 8 k-steps without a branch: `ldmatrix` for x at
// a fixed offset, two mma.sync, each 16-deep slab's product from a zero
// accumulator, added in f32 in k order (the tensor cores' own f32
// accumulation does not round to nearest, so no long chain runs inside
// them).  (3) The warps' sums meet in shared memory; 64 threads add them in
// warp order, gi's warps then gh's, and apply the GRU to their (row, unit);
// each keeps its float32 h in a register across steps, publishes bf16(h)
// (128 B a block) and, on the last step, writes the float32 `out`.
// (4) One arrival on a step counter in L2 (`red.release.gpu`) and a spin
// of one thread on it (`ld.acquire.gpu`) order the steps in place of
// `grid.sync()`; the counter only grows, so it needs no reset inside a
// launch, and the host zeroes it before each launch.  A spin that waits
// ~1 s traps, so a fault ends as a CUDA error, not a hang.  The
// cooperative launch is kept: it guarantees that every block is resident,
// without which such a spin could deadlock.  Every sum has a fixed order
// and no float atomics: a launch of T steps equals T chained one-step
// launches bit for bit.
//
// What bounds it: the operations, 2 * 8 * 3H * 3H FLOP a step (0.153 µs a
// step at the bf16 peak), far below the grid-wide dependency each step
// carries.  On the H100 a step takes ~3.0 µs (PERF.md): ~0.85 for the
// publish, arrival and spin (the parent's `grid.sync()` took ~0.97), ~0.36
// for the h read after it, ~1.1 for the products (16 mma.sync a warp, half
// of [n | 0] empty; at 768 threads a thread has 80 registers, and a few A
// fragments are reloaded from L1 each step), ~0.75 for the rest (block
// barriers, the warps' sums, the GRU).  The design keeps that chain short:
// a 16 KB h, one counter, no second pass, products with no branch and no
// weight traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 8;                 // rows of h: the N side of the mma
constexpr int kMaxUnits = 8;              // units per block: [r | z] is one m16 tile
constexpr int kKSteps = 8;                // k-steps a warp holds in registers
constexpr int kIhWarps = 16;              // warps over W_ih's 2H: H <= 1024
constexpr int kHhWarps = 8;               // warps over W_hh's H
constexpr int kWarps = kIhWarps + kHhWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kRedRows = 3 * kMaxUnits;   // a warp's sums: r, z and n of 8 units
constexpr int kEpilogue = kLanes * kMaxUnits;  // threads applying the GRU
constexpr int kCounterBytes = 128;        // the step counter's own line
constexpr long long kSpinLimit = 2000000000LL;  // clocks, ~1 s

struct Args {
  const void* wi;    // (2H, 3H) bf16 or int8
  const void* wh;    // (H, 3H) bf16 or int8
  const float* bi;   // (3H)
  const float* bh;   // (3H)
  const float* xc;   // (8, H)
  const float* h0;   // (8, H)
  uint16_t* hb;      // (2, 8, H) bf16: h published between steps
  unsigned* count;   // arrivals so far, zeroed by the host
  float* out;        // (8, H)
  int H;
  int steps;
  int units;
};

// d = a . b on the tensor cores from a zero accumulator: A 16 x 16
// row-major, B 16 x 8 column-major, bf16 pairs packed low element first.
// Registers only, so not volatile: the compiler may schedule it freely.
__device__ __forceinline__ void mma_from_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void arrive(unsigned* count) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count), "r"(1u) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint16_t widen(uint16_t w) { return w; }
__device__ __forceinline__ uint16_t widen(int8_t w) { return bf16_bits(static_cast<float>(w)); }

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 1) persistent_gru_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, U = p.units;
  const int xs = 2 * H + 8;  // x row stride in bf16: 16 bytes of padding
  uint16_t* x_s = reinterpret_cast<uint16_t*>(smem);                      // (8, 2H + 8)
  float* red_s = reinterpret_cast<float*>(smem + 2 * kLanes * xs);         // (24, 24, 8)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int u0 = blockIdx.x * U;
  // This warp's k-steps: [kw * 8, kw * 8 + 8) of W_ih's 2H / 16 or of
  // W_hh's H / 16.  H % 64 == 0, so W_ih's warps have all 8 or none, and
  // W_hh's last may have 4: its other 4 read xc's first 64 columns and
  // multiply them by zero weights.
  const bool ih = warp < kIhWarps;
  const int kw = ih ? warp : warp - kIhWarps;
  const int ksg = (ih ? 2 * H : H) / 16;
  const bool active = kw * kKSteps < ksg;
  const W* w = static_cast<const W*>(ih ? p.wi : p.wh);

  // A fragments, once.  Lane (g, t) holds rows g and g + 8 and contraction
  // columns 2t, 2t + 1 and 2t + 8, 2t + 9 of each k-step: [r | z] in a_rz,
  // [n | 0] in a_n (its zero rows are not stored).
  const int j = u0 + g;
  uint32_t a_rz[kKSteps][4];
  uint32_t a_n[kKSteps][2];
#pragma unroll
  for (int i = 0; i < kKSteps; ++i) {
    a_rz[i][0] = a_rz[i][1] = a_rz[i][2] = a_rz[i][3] = 0u;
    a_n[i][0] = a_n[i][1] = 0u;
    if (kw * kKSteps + i < ksg && g < U && j < H) {
      const int k = 16 * (kw * kKSteps + i) + 2 * t;
      auto w2 = [&](int kk, int gate) {
        const W* c = w + static_cast<size_t>(kk) * 3 * H + gate * H + j;
        return pack(widen(c[0]), widen(c[3 * H]));
      };
      a_rz[i][0] = w2(k, 0);
      a_rz[i][1] = w2(k, 1);
      a_rz[i][2] = w2(k + 8, 0);
      a_rz[i][3] = w2(k + 8, 1);
      a_n[i][0] = w2(k, 2);
      a_n[i][1] = w2(k + 8, 2);
    }
  }

  // The epilogue's (row l, unit u): its biases and its float32 h.
  const int eu = threadIdx.x % kMaxUnits, el = threadIdx.x / kMaxUnits;
  const int ej = u0 + eu;
  const bool owner = threadIdx.x < kEpilogue && eu < U && ej < H;
  float b[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, h = 0.f;  // b_ih r z n, b_hh r z n
  if (owner) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      b[q] = p.bi[q * H + ej];
      b[3 + q] = p.bh[q * H + ej];
    }
    h = p.h0[el * H + ej];
  }

  // x = [bf16(h0) | bf16(xc)]
  for (int i = threadIdx.x; i < kLanes * H / 4; i += kThreads) {
    const int l = (4 * i) / H, k = (4 * i) % H;
    const float4 hv = __ldcg(reinterpret_cast<const float4*>(p.h0) + i);
    const float4 cv = __ldg(reinterpret_cast<const float4*>(p.xc) + i);
    *reinterpret_cast<uint2*>(x_s + l * xs + k) =
        make_uint2(pack(bf16_bits(hv.x), bf16_bits(hv.y)), pack(bf16_bits(hv.z), bf16_bits(hv.w)));
    *reinterpret_cast<uint2*>(x_s + l * xs + H + k) =
        make_uint2(pack(bf16_bits(cv.x), bf16_bits(cv.y)), pack(bf16_bits(cv.z), bf16_bits(cv.w)));
  }
  __syncthreads();

  // ldmatrix rows: lanes 0-7 the 8 rows of x at a k-step's first 8
  // columns, lanes 8-15 at its last 8; this warp's first k-step.
  const uint16_t* x_warp = x_s + (lane & 7) * xs + 8 * ((lane >> 3) & 1) + 16 * kKSteps * kw;
  float* red = red_s + warp * kRedRows * kLanes + 2 * t;

  for (int step = 0; step < p.steps; ++step) {
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // D rows g, g + 8 of [r | z]; row g of [n | 0]
    if (active) {
#pragma unroll
      for (int i = 0; i < kKSteps; ++i) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1, x_warp + 16 * i);
        float d[4];
        mma_from_zero(d, a_rz[i], b0, b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += d[e];
        const uint32_t an[4] = {a_n[i][0], 0u, a_n[i][1], 0u};
        mma_from_zero(d, an, b0, b1);
        acc[4] += d[0];
        acc[5] += d[1];
      }
    }
    // D fragment: rows g and g + 8, columns (rows of h) 2t and 2t + 1.
    *reinterpret_cast<float2*>(red + g * kLanes) = make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(red + (g + 8) * kLanes) = make_float2(acc[2], acc[3]);
    *reinterpret_cast<float2*>(red + (g + 16) * kLanes) = make_float2(acc[4], acc[5]);
    __syncthreads();

    const bool last = step == p.steps - 1;
    uint16_t* hb = p.hb + static_cast<size_t>(step & 1) * kLanes * H;
    if (owner) {
      float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // i_r, i_z, i_n, h_r, h_z, h_n
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const float* r = red_s + (v * kRedRows + eu) * kLanes + el;
        const int o = v < kIhWarps ? 0 : 3;
#pragma unroll
        for (int q = 0; q < 3; ++q) s[o + q] += r[q * kMaxUnits * kLanes];
      }
      // the biases and the gates as the reference applies them
      const float r = sigmoid((s[0] + b[0]) + (s[3] + b[3]));
      const float z = sigmoid((s[1] + b[1]) + (s[4] + b[4]));
      const float n = tanhf((s[2] + b[2]) + r * (s[5] + b[5]));
      h = (1.0f - z) * n + z * h;
      if (last)
        p.out[el * H + ej] = h;
      else
        hb[el * H + ej] = bf16_bits(h);
    }
    if (last) break;

    // Every block's bf16(h) of this step is published before any block
    // reads it: one arrival each, one spinning thread each.
    __syncthreads();
    if (threadIdx.x == 0) {
      arrive(p.count);
      const unsigned target = gridDim.x * static_cast<unsigned>(step + 1);
      const long long start = clock64();
      while (load_acquire(p.count) < target) {
        if (clock64() - start > kSpinLimit) __trap();
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kLanes * H / 8; i += kThreads) {
      const int l = (8 * i) / H, k = (8 * i) % H;
      *reinterpret_cast<uint4*>(x_s + l * xs + k) = __ldcg(reinterpret_cast<const uint4*>(hb) + i);
    }
    __syncthreads();
  }
}

size_t smem_bytes(int H) {
  return sizeof(uint16_t) * kLanes * (2 * H + 8) + sizeof(float) * kWarps * kRedRows * kLanes;
}

size_t scratch_bytes(int H) { return sizeof(uint16_t) * 2 * kLanes * H + kCounterBytes; }

}  // namespace

// The launch plan on the current device, the same for both weight types:
// plan[0] units per block (ceil(H / SMs)), plan[1] blocks, plan[2] bytes of
// shared memory per block, plan[3] threads per block, plan[4] k-steps per
// warp, plan[5] bytes of scratch the caller passes.  Returns a CUDA error
// code (0 on success).
extern "C" int persistent_gru_plan(int H, int int8_weights, int* plan) {
  (void)int8_weights;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (H + n_sm - 1) / n_sm;
  plan[0] = units;
  plan[1] = (H + units - 1) / units;
  plan[2] = static_cast<int>(smem_bytes(H));
  plan[3] = kThreads;
  plan[4] = kKSteps;
  plan[5] = static_cast<int>(scratch_bytes(H));
  return 0;
}

// Runs `steps` GRU steps on `stream` (a cudaStream_t) as one cooperative
// launch; the result goes to `out`.  `scratch` holds plan[5] bytes of
// device memory (the published h and the step counter; the counter is
// zeroed here, on the stream).  Pointers are to device memory laid out as
// in Args.  Returns the CUDA error code of the launch (0 on success); it
// does not synchronise.
extern "C" int persistent_gru(const void* wi, const void* wh, const float* bi, const float* bh,
                              const float* xc, const float* h0, void* scratch, float* out, int H,
                              int steps, int int8_weights, void* stream) {
  int plan[6];
  int err = persistent_gru_plan(H, int8_weights, plan);
  if (err != 0) return err;
  const int units = plan[0], blocks = plan[1], smem = plan[2];
  if (units > kMaxUnits || H > 16 * kKSteps * kHhWarps || H % 64 != 0 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint16_t* hb = static_cast<uint16_t*>(scratch);
  unsigned* count = reinterpret_cast<unsigned*>(static_cast<unsigned char*>(scratch) +
                                                sizeof(uint16_t) * 2 * kLanes * H);
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kernel = int8_weights ? reinterpret_cast<const void*>(persistent_gru_kernel<int8_t>)
                                    : reinterpret_cast<const void*>(persistent_gru_kernel<uint16_t>);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args args{wi, wh, bi, bh, xc, h0, hb, count, out, H, steps, units};
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), params,
                                  static_cast<size_t>(smem), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
