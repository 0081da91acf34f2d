// The two matrix-unit probes of benchmarks/probe_roofline.py on the H100's
// tensor cores, for sm_90a: bf16 operands, f32 accumulation, the chain on
// wgmma and the gridded product on mma.sync.  No library GEMM is called.
//
// dot_chain_bf16 replaces the Pallas kernel `k` built by mk_kernel(M)
// (probe_roofline.py:20-32): out = sum over `reps` of w @ x, w (M, 128) and
// x (128, N) bf16, out f32.  The Pallas kernel multiplies w by
// s = bf16(acc[0, 0] * 0 + 1) before each product only to make each product
// depend on the last accumulator; s is exactly 1 for finite input, so it is
// dropped here.  What stays is `acc += dot(w, x)`: each product is formed on
// the tensor cores from a zero accumulator over its 8 k-steps, in k order,
// then added into one f32 accumulator per output, in rep order.  (Running
// all the k-steps straight into one tensor-core accumulator instead drifts
// further from the plain version: the tensor cores' f32 accumulation does
// not round to nearest.)  What bounds it: the operations, 2 M 128 N reps
// FLOP (8.7 us at M = 512, N = 1024, 64 reps); its operands are 0.4 MB at
// most, loaded once.  The first design (a warp a 16 x 16 tile, mma.sync, one
// product at a time) waited on each product's 8 dependent k-steps: 0.12 us a
// product at M = 128 against a bound of 0.034 (PERF.md §6).  mma.sync
// cannot simply keep several of these products in flight: they are the same
// instruction on the same registers, and the compiler merges them (4 in
// flight ran 1 in 4, above the bound).  wgmma's products are asynchronous
// and each is kept.  So:
// - a block is one warpgroup and owns a 64 x TN output tile; it holds its
//   64 rows of w as wgmma A fragments in registers (a warp's 16 rows each,
//   laid out as mma.sync's) and stages x's 128 x TN tile once in shared
//   memory as it lies in x, N-major (16-byte copies, 8 x 8 core matrices
//   without swizzle; wgmma transposes B);
// - a product is 8 `wgmma.mma_async` m64nTNk16 steps from a zero
//   accumulator (scale-d = 0 on the first) in one commit group.  The
//   products do not depend on each other, only their sum does, so
//   kChainInFlight of them run at once, each in its own registers; the
//   oldest is waited for (`wgmma.wait_group`) and added into the
//   accumulator, and its registers take the next one.  Every rounding
//   happens in the first design's order.  The loop runs passes of
//   kChainUnroll products that end with none in flight: with products in
//   flight across its back edge the compiler cannot tell which registers a
//   wait frees and serialises every wgmma (ptxas C7514, C7515);
// - TN is 8, 16, 32 or 64: the one with the least waves x TN (a block's
//   time grows with TN, a launch takes ceil(grid / SMs) waves), the widest
//   of equals.  At the probe's N = 1024 that is TN = 16 M / 128 for M = 128,
//   256 and 512: 128 blocks, one on each of 128 of the H100's 132 SMs.
// What is left (PERF.md §6): at TN = 32 and 64 a product takes ~1.1x its
// share of the bound; at TN = 16 ~1.8x, as an m64n16k16 step takes ~15
// cycles for 8 cycles of work (A from shared memory, or two 64 x 8 blocks an
// SM, were slower); and ~3 us a launch of start, staging and tail.
// Edges: rows of w past M read 0 and columns of x past N stage as 0; only
// the part of a tile inside (M, N) is written.
//
// gridded_dot_bf16 replaces the Pallas kernel `k2` (probe_roofline.py:45-57):
// out = w @ x with w (M, 128) and x (128, N) bf16, out f32.  What bounds it:
// the bytes, x read once and the f32 output written once (25.2 MB at
// N = 32 768), against 1.07 GFLOP, so it is written as a bandwidth kernel:
// - a persistent grid of min(tiles, SMs x blocks an SM) blocks walks the
//   128 x kGridTN output tiles with a stride of gridDim.x, m-tile major;
// - on a block's first tile of each m-tile, the bulk-copy engine (TMA)
//   stages that 128-row slab of w in shared memory once; each consumer warp
//   takes its 16 rows' A fragments from it by `ldmatrix` into registers;
// - one producer warp streams x tiles by TMA into a ring of kGridStages
//   shared-memory stages, signalled on mbarriers, while 8 consumer warps
//   form each tile's products (mma.sync m16n8k16, B by `ldmatrix.trans`);
// - each tile's float32 accumulators go to a staging buffer in shared
//   memory and out by TMA stores, which overlap the next tile's copy and
//   products.
// Every shared-memory tile is a set of 128-byte-row boxes in the TMA's
// 128-byte swizzle, so `ldmatrix` and the staging writes hit distinct
// banks.  The TMA zero-fills rows of w past M and columns of x past N, and
// its stores clip at the M and N edges.  Each output is one product over
// K = 128 from a zero float32 accumulator, as before.  The tile width, the
// stages and the staging buffers are the fastest of a sweep of builds on
// the H100 (PERF.md): 64-column tiles give each block ~4 tiles at the
// probe's shape, and 6 stages with 2 staging buffers start the first store
// sooner and keep stores in flight.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kK = 128;              // contraction depth of both probes
constexpr int kKSteps = kK / 16;     // k16 steps of one product
constexpr int kChainTM = 64;         // chain: output tile rows, one wgmma's M
constexpr int kChainMaxTN = 64;      // chain: widest output tile (TN = 8 .. 64)
constexpr int kChainThreads = 128;   // chain: one warpgroup a block
constexpr int kChainInFlight = 4;    // chain: products in flight a warpgroup
constexpr int kChainUnroll = 16;     // chain: products a pass of the loop
constexpr int kChainLBO = 128;       // chain: x's core matrices, bytes apart along K
constexpr int kChainSBO = (kK / 8) * kChainLBO;  // and along N
constexpr int kGridTM = 128;         // gridded: output tile rows (one w slab)
constexpr int kGridTN = 64;          // gridded: output tile columns
constexpr int kGridStages = 6;       // gridded: x stages in the ring
constexpr int kGridOutBufs = 2;      // gridded: output staging buffers
constexpr int kGridConsumers = kGridTM / 16;  // warps of 16 output rows each
constexpr int kGridThreads = 32 * (kGridConsumers + 1);  // + the producer warp
constexpr int kBox = 16384;          // one 128-row x 128-byte swizzled box
constexpr int kWBytes = kGridTM * kK * 2;
constexpr int kXStageBytes = kK * kGridTN * 2;
constexpr int kOutBufBytes = kGridTM * kGridTN * 4;
constexpr int kBarOffset = kWBytes + kGridStages * kXStageBytes + kGridOutBufs * kOutBufBytes;
constexpr int kBars = 2 * kGridStages + 2;  // full and empty per stage; w full, w empty
// 1024 bytes of slack align the swizzled boxes to the swizzle's period.
constexpr int kGridSmem = 1024 + kBarOffset + 8 * kBars;
static_assert(kGridTN % 64 == 0 && kGridTN <= 256, "x boxes are 64 columns wide");
static_assert(kGridStages >= 2 && kGridOutBufs >= 1, "a ring needs two stages");
static_assert(kChainInFlight <= 8 && kChainUnroll % kChainInFlight == 0,
              "a pass fills every slot the same number of times");

// d += a . b on the tensor cores: A 16 x 16 row-major, B 16 x 8
// column-major, bf16 pairs packed low element first; D 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows [r0, r0 + 16) and k-step ks of the row-major (M, 128)
// bf16 matrix w; rows past M read 0.  Lane (g, t) = (lane / 4, lane % 4)
// holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void load_a(const uint16_t* w, int M, int r0, int ks, int lane,
                                       uint32_t (&a)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const int c = ks * 16 + 2 * t;
  const int ra = r0 + g, rb = r0 + g + 8;
  auto ld = [&](int r, int col) -> uint32_t {
    return r < M ? __ldg(reinterpret_cast<const unsigned int*>(w + static_cast<size_t>(r) * kK + col))
                 : 0u;
  };
  a[0] = ld(ra, c);
  a[1] = ld(rb, c);
  a[2] = ld(ra, c + 8);
  a[3] = ld(rb, c + 8);
}

// Byte offset of 16-byte chunk `chunk` (0-7) of row `row` in a box of
// 128-byte rows under the TMA's 128-byte swizzle (box base 1024-aligned).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed (a new
// barrier counts its phase of parity 1 as completed).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box of `map` at (inner c0, outer c1) into shared memory at `dst`,
// its bytes completing on `bar`.  Elements outside the tensor read 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// TMA: the box at `src` in shared memory to (inner c0, outer c1) of `map`,
// clipped at the tensor's edges, in the thread's current bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int c1, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The consumer warps' barrier (named barrier 1; the producer takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kGridConsumers) : "memory");
}

// Shared memory (from a 1024-aligned base): w's slab as two boxes of 64
// k-columns, kGridStages x stages as kGridTN / 64 boxes of 64 columns, the
// output staging buffers as kGridTN / 32 boxes of 32 float32 columns, then
// the mbarriers.  Warps 0-7 compute rows 16 warp .. 16 warp + 15 of each
// tile; warp 8 is the producer.
__global__ void __launch_bounds__(kGridThreads, 1)
    gridded_dot_kernel(const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap out_map, int tiles_n, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t w_s = (raw + 1023u) & ~1023u;
  const uint32_t x_s = w_s + kWBytes;
  const uint32_t out_s = x_s + kGridStages * kXStageBytes;
  const uint32_t bars = w_s + kBarOffset;
  const uint32_t w_full = bars + 16 * kGridStages, w_empty = w_full + 8;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kGridStages + s); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGridStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kGridConsumers);
    }
    mbar_init(w_full, 1);
    mbar_init(w_empty, kGridConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kGridConsumers) {  // the producer: one lane issues every copy
    if (lane != 0) return;
    int cur_m = -1, s = 0;
    uint32_t phase = 0, w_phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m = t / tiles_n, n = t - m * tiles_n;
      if (m != cur_m) {  // the consumers hold the last slab in registers
        if (cur_m >= 0) {
          mbar_wait(w_empty, w_phase);
          w_phase ^= 1;
        }
        mbar_expect_tx(w_full, kWBytes);
        for (int b = 0; b < kK / 64; ++b) tma_load(w_s + b * kBox, &w_map, 64 * b, m * kGridTM, w_full);
        cur_m = m;
      }
      mbar_wait(empty(s), phase ^ 1);
      mbar_expect_tx(full(s), kXStageBytes);
      for (int b = 0; b < kGridTN / 64; ++b)
        tma_load(x_s + s * kXStageBytes + b * kBox, &x_map, n * kGridTN + 64 * b, 0, full(s));
      if (++s == kGridStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ldmatrix lanes: matrix q = lane / 8, its row r = lane % 8.
  const int q = lane >> 3, r = lane & 7;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment lanes
  const int r0 = 16 * warp;
  uint32_t a[kKSteps][4];
  int cur_m = -1, s = 0, i = 0;
  uint32_t phase = 0, w_phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int m = t / tiles_n, n = t - m * tiles_n;
    if (m != cur_m) {  // A fragments of the warp's 16 rows, kept for the m-tile
      mbar_wait(w_full, w_phase);
      w_phase ^= 1;
      const int row = r0 + r + 8 * (q & 1);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int chunk = 2 * ks + (q >> 1);  // 8-column chunk of k
        ldsm_x4(w_s + (chunk >> 3) * kBox + swz(row, chunk & 7), a[ks]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(w_empty);
      cur_m = m;
    }

    constexpr int kTilesN = kGridTN / 8;
    float acc[kTilesN][4] = {};
    mbar_wait(full(s), phase);
    const uint32_t xs = x_s + s * kXStageBytes;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int k = 16 * ks + 8 * (q & 1) + r;
#pragma unroll
      for (int np = 0; np < kTilesN / 2; ++np) {
        const int chunk = 2 * np + (q >> 1);  // 8-column chunk of the tile
        uint32_t b[4];
        ldsm_x4_trans(xs + (chunk >> 3) * kBox + swz(k, chunk & 7), b);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(acc[2 * np], a[ks], b0);
        mma_bf16(acc[2 * np + 1], a[ks], b1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (++s == kGridStages) {
      s = 0;
      phase ^= 1;
    }

    // Epilogue: wait until the store kGridOutBufs tiles back has read its
    // buffer, stage the accumulators, and store them by TMA.
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kGridOutBufs - 1) : "memory");
    consumers_sync();
    const uint32_t os = out_s + (i % kGridOutBufs) * kOutBufBytes;
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
      const int col = 8 * nt + 2 * tq, cc = col & 31;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t addr = os + (col >> 5) * kBox + swz(r0 + g + 8 * h, cc >> 2) + 4 * (cc & 3);
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(acc[nt][2 * h]),
                     "f"(acc[nt][2 * h + 1])
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();
    if (threadIdx.x == 0) {
      for (int b = 0; b < kGridTN / 32; ++b)
        tma_store(&out_map, n * kGridTN + 32 * b, m * kGridTM, os + b * kBox);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- K3, the dot chain ----

// One wgmma step of a warpgroup: d (64 x N f32) = a . B + (scale_d ? d : 0),
// a 64 x 16 bf16 in registers (a warp's 16 rows, as mma.sync's A fragment),
// B 16 x N bf16 in shared memory as the descriptor `desc` describes it; d
// as mma.sync's C fragments, n8 tile after n8 tile.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Returns once at most `kPending` of the warpgroup's commit groups run.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// wgmma_wait<pending>() for a `pending` the compiler knows (0 to 7).
__device__ __forceinline__ void wgmma_wait_at_most(int pending) {
  switch (pending) {
    case 0: wgmma_wait<0>(); break;
    case 1: wgmma_wait<1>(); break;
    case 2: wgmma_wait<2>(); break;
    case 3: wgmma_wait<3>(); break;
    case 4: wgmma_wait<4>(); break;
    case 5: wgmma_wait<5>(); break;
    case 6: wgmma_wait<6>(); break;
    default: wgmma_wait<7>();
  }
}

// Pins the registers of `d` here: the compiler moves no read or write of
// them across the wgmma issue or wait beside this point.
template <int n>
__device__ __forceinline__ void fence_operands(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor without swizzle: 8 x 8 core matrices of
// 128 contiguous bytes, `lbo` bytes apart along K and `sbo` along N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

// Block b owns the 64 x TN output tile (b / tiles_n, b % tiles_n); warp q
// of its warpgroup holds rows 16 q .. 16 q + 15 of it.  Shared memory holds
// x's tile N-major, as it lies in x: the 16 bytes x[k][n0 + 8 n8 ..
// n0 + 8 n8 + 7] at n8 kChainSBO + (k / 8) kChainLBO + (k % 8) 16, so each
// 8 x 8 core matrix is 8 rows of k, 128 contiguous bytes.
template <int TN>
__global__ void __launch_bounds__(kChainThreads, 1)
    dot_chain_kernel(const uint16_t* __restrict__ w, const uint16_t* __restrict__ x,
                     float* __restrict__ out, int M, int N, int reps, int tiles_n) {
  constexpr int kAcc = TN / 2;  // f32 values a thread holds of a 64 x TN tile
  __shared__ __align__(128) uint8_t xs[TN * kK * 2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (blockIdx.x / tiles_n) * kChainTM, n0 = (blockIdx.x % tiles_n) * TN;

  uint32_t a[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) load_a(w, M, m0 + 16 * warp, ks, lane, a[ks]);
  for (int c = tid; c < TN * (kK / 8); c += kChainThreads) {
    const int k = c % kK, n8 = c / kK;  // consecutive threads fill a core matrix
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + 8 * n8 < N)
      v = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(k) * N + n0 + 8 * n8));
    *reinterpret_cast<uint4*>(xs + n8 * kChainSBO + (k >> 3) * kChainLBO + (k & 7) * 16) = v;
  }
  // The stores above go through the generic proxy, wgmma reads through the
  // async one.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const uint64_t desc = smem_desc(smem_addr(xs), kChainLBO, kChainSBO);
  // The slots' first values are never read (scale-d = 0); set here, before
  // any wgmma, so that none of their registers is defined in flight.
  float acc[kAcc], prod[kChainInFlight][kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kChainInFlight; ++j) prod[j][i] = 0.f;
  }
  // One product into d: 8 k-steps from zero, in k order, one commit group.
  auto issue = [&](float (&d)[kAcc]) {
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
      Wgmma<TN>::run(d, a[ks], desc + ((2 * kChainLBO * ks) >> 4), ks > 0);
    wgmma_commit();
  };
  // Waits until at most `pending` products run, so that the one in slot d
  // is done, and adds it.
  auto fold = [&](float (&d)[kAcc], int pending) {
    wgmma_wait_at_most(pending);
    fence_operands(d);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += d[i];
  };
  // kChainUnroll products a pass, through kChainInFlight slots: product q
  // of the pass goes to slot q % kChainInFlight once the product before it
  // there is added.  A pass ends with nothing in flight, so the compiler can
  // see which registers each wait frees (C7514/C7515 otherwise: it
  // serialises every wgmma).
  int rep = 0;
  for (; rep + kChainUnroll <= reps; rep += kChainUnroll) {
#pragma unroll
    for (int q = 0; q < kChainInFlight; ++q) issue(prod[q]);
#pragma unroll
    for (int q = kChainInFlight; q < kChainUnroll; ++q) {
      fold(prod[q % kChainInFlight], kChainInFlight - 1);
      issue(prod[q % kChainInFlight]);
    }
#pragma unroll
    for (int q = 0; q < kChainInFlight; ++q) fold(prod[q], kChainInFlight - 1 - q);
  }
  for (; rep < reps; ++rep) {  // the rest, one at a time
    issue(prod[0]);
    fold(prod[0], 0);
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < TN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * t;
    if (col >= N) continue;  // N % 8 == 0: an n8 tile is all in or all out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * warp + g + 8 * h;
      if (r < M)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N + col) =
            make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  }
}

}  // namespace

struct ChainPlan {
  int tile_n, sms, tiles_n, grid;
};

// K3's launch for (M, N) on the current device: TN of 8, 16, 32 or 64 with
// the least ceil(grid / SMs) x TN, the widest of equals (file header).
static int chain_plan(int M, int N, ChainPlan* p) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices];  // 0: not asked yet
  if (M <= 0 || N <= 0 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles_m = (M + kChainTM - 1) / kChainTM;
  long long best = -1, grid = 0;
  for (int tn = 8; tn <= kChainMaxTN; tn *= 2) {
    const long long tiles_n = (N + tn - 1) / tn, blocks = tiles_m * tiles_n;
    const long long cost = (blocks + sms[dev] - 1) / sms[dev] * tn;
    if (best < 0 || cost <= best) {
      best = cost;
      grid = blocks;
      *p = {tn, sms[dev], static_cast<int>(tiles_n), 0};
    }
  }
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p->grid = static_cast<int>(grid);
  return 0;
}

// K3's launch for (M, N) on the current device, as 7 ints: tile rows, tile
// columns, warps, products in flight, shared-memory bytes, SMs and the grid.
// Returns the CUDA error code.
extern "C" int dot_chain_plan(int M, int N, int* out) {
  ChainPlan c;
  const int err = chain_plan(M, N, &c);
  if (err != 0) return err;
  const int plan[7] = {kChainTM, c.tile_n, kChainThreads / 32, kChainInFlight, c.tile_n * kK * 2,
                       c.sms, c.grid};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
  return 0;
}

// out (M, N) f32 = reps * (w @ x) as one chain; w (M, 128), x (128, N) bf16
// with N % 8 == 0, all row-major on the device, 16-byte aligned; reps >= 1.
// Launches on `stream` (a cudaStream_t) and returns the CUDA error code (0
// on success).
extern "C" int dot_chain_bf16(const void* w, const void* x, float* out, int M, int N, int reps,
                              void* stream) {
  if (reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  ChainPlan c;
  const int err = chain_plan(M, N, &c);
  if (err != 0) return err;
  const auto* wp = static_cast<const uint16_t*>(w);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (c.tile_n) {
    case 8:
      dot_chain_kernel<8><<<c.grid, kChainThreads, 0, s>>>(wp, xp, out, M, N, reps, c.tiles_n);
      break;
    case 16:
      dot_chain_kernel<16><<<c.grid, kChainThreads, 0, s>>>(wp, xp, out, M, N, reps, c.tiles_n);
      break;
    case 32:
      dot_chain_kernel<32><<<c.grid, kChainThreads, 0, s>>>(wp, xp, out, M, N, reps, c.tiles_n);
      break;
    default:
      dot_chain_kernel<64><<<c.grid, kChainThreads, 0, s>>>(wp, xp, out, M, N, reps, c.tiles_n);
  }
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime so that the build
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major (outer, inner) tensor as boxes of 128 rows x box_inner
// elements (128 bytes) in the 128-byte swizzle; out-of-range elements read 0.
static bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                   int inner, int outer, int box_inner) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), 128u};
  const cuuint32_t unit[2] = {1u, 1u};
  const EncodeTiled fn = encoder();
  return fn && fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct GridPlan {
  int sms, blocks_per_sm, tiles_n, tiles, grid;
};

// The persistent grid for (M, N) on the current device: min(tiles, SMs x
// the blocks an SM holds at kGridSmem, as the occupancy calculator says).
static int grid_plan(int M, int N, GridPlan* p) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices], occupancy[kMaxDevices];  // 0: not asked yet
  if (M <= 0 || N <= 0 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!occupancy[dev]) {
    err = cudaFuncSetAttribute(gridded_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGridSmem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gridded_dot_kernel, kGridThreads,
                                                          kGridSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occupancy[dev] = blocks;
  }
  const long long tiles_n = (N + kGridTN - 1) / kGridTN;
  const long long tiles = (M + kGridTM - 1) / kGridTM * tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = static_cast<long long>(sms[dev]) * occupancy[dev];
  *p = {sms[dev], occupancy[dev], static_cast<int>(tiles_n), static_cast<int>(tiles),
        static_cast<int>(tiles < slots ? tiles : slots)};
  return 0;
}

// K4's launch for (M, N) on the current device, as 9 ints: tile rows, tile
// columns, x stages, output staging buffers, threads, shared-memory bytes,
// blocks an SM (occupancy calculator), SMs and the grid.  Returns the CUDA
// error code.
extern "C" int gridded_dot_plan(int M, int N, int* out) {
  GridPlan g;
  const int err = grid_plan(M, N, &g);
  if (err != 0) return err;
  const int plan[9] = {kGridTM, kGridTN, kGridStages, kGridOutBufs, kGridThreads,
                       kGridSmem, g.blocks_per_sm, g.sms, g.grid};
  for (int i = 0; i < 9; ++i) out[i] = plan[i];
  return 0;
}

// out (M, N) f32 = w @ x; w (M, 128), x (128, N) bf16 with N % 8 == 0, all
// row-major on the device, 16-byte aligned.  Launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int gridded_dot_bf16(const void* w, const void* x, float* out, int M, int N,
                                void* stream) {
  GridPlan g;
  const int err = grid_plan(M, N, &g);
  if (err != 0) return err;
  CUtensorMap w_map, x_map, out_map;
  if (!encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, kK, M, 64) ||
      !encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, N, kK, 64) ||
      !encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, N, M, 32))
    return static_cast<int>(cudaErrorInvalidValue);
  gridded_dot_kernel<<<g.grid, kGridThreads, kGridSmem, static_cast<cudaStream_t>(stream)>>>(
      w_map, x_map, out_map, g.tiles_n, g.tiles);
  return static_cast<int>(cudaGetLastError());
}
