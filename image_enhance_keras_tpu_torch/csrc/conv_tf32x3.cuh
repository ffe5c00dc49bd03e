// The float32 convolution tile of the block and chain kernels (blocks.cu,
// tower.cu): an implicit GEMM on Hopper's TF32 tensor cores in split
// precision (3xTF32), for sm_90a.
//
// Each float32 operand v is split into hi = tf32(v) (round to nearest, ties
// away, 10 explicit mantissa bits) and lo = tf32(v - hi); v - hi is exact in
// float32.  A product is summed as lo*Whi + hi*Wlo + hi*Whi into one float32
// accumulator, small terms first; lo*Wlo (about 2^-22 of the product) is
// dropped.  Each product then keeps about 21-22 significant bits, close to
// float32's 24, at three tensor-core passes: 3 x 2*taps*C^2 operations per
// pixel at 495 TFLOP/s dense TF32 is still 2.5x the CUDA cores' 67 TFLOP/s
// float32 peak.  The split is this tile's own float32-accurate scheme: it
// does not depend on PyTorch's TF32 switches (engine.disable_tf32), which
// govern cuDNN and cuBLAS.
//
// The GEMM, per SAME KxK conv over NHWC activations with C = 128 channels:
//   M = 64 output pixels: 8 rows x 8 columns.  A core matrix of the A
//       operand is 8 consecutive pixels of one row (8 x 16 bytes); the next
//       8-row group (stride byte offset) is the next row of the window.
//   N = the 128 output channels.
//   K = taps x input channels, in steps of 8 channels (wgmma k8: 32 bytes,
//       two 16-byte core matrices a plane apart, the leading byte offset).
// A thread block (two warpgroups, MT = 1 M tile each) computes 8 rows x
// TILE_W = 16 columns x 128 channels (registers: 64 sums and 64 partial sums
// a thread).  Both operands are K-major in shared memory without swizzle
// (TF32 wgmma takes no transposed operand):
//   * A: the input window with its halo, one slice of 32 input channels at a
//     time (a 128-channel float32 window, hi and lo, does not fit in 227 KB),
//     split into hi and lo as it is staged: planes of 4 channels,
//     [hi/lo][plane][row][col][16 bytes].  A tap (ky, kx) moves the
//     descriptor's start by ky window rows and kx pixels, so each slice is
//     staged once for all taps.
//   * B: the weights, split and repacked once by the wrapper to
//     [tap][cin/8][hi/lo][2][cout][4] floats (ops/cuda/tf32x3.py packed):
//     each (tap, 8-channel step) is one 8 KB tile (4 KB hi, then 4 KB lo),
//     and the 4 tiles of one (slice, tap) step are contiguous: 32 KB per
//     step, streamed through a ring of STAGES steps by bulk copies (one
//     thread, cp.async.bulk), STAGES - 2 ahead of the products.  Each slot
//     has two mbarriers: `full` (the bytes have landed) and `empty` (every
//     warp is done with it), so the two warpgroups do not meet at a barrier
//     every step and one's rounded adds (below) overlap the other's products.
// Each step's 12 products per warpgroup accumulate in a fresh wgmma sum that
// is added to the float32 sums with rounded adds (see conv below: without
// that the tensor cores' accumulation over a whole conv is far less
// accurate than float32 FMA).
// Out-of-image window positions are zeros (SAME padding); the epilogues go
// through shared memory as 16-byte pieces and mask pixels outside the image,
// with the explicitly rounded float32 steps of the plain versions
// (__fadd_rn/__fmul_rn: no FMA contraction).
// A kernel on this tile is persistent: one thread block per SM (the tile
// takes 192,832 bytes of shared memory), at most one per work item, looping
// over the items, so the weight ring's mbarriers are set up once per thread
// block (persistent_grid, make_ring).
//
// The bf16 forms of the kernels run on their own tile, conv_bf16.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;                 // channels: N of every product
constexpr int WGS = 2;                 // warpgroups per thread block
constexpr int THREADS = 128 * WGS;
constexpr int MT = 1;                  // M tiles (8 x 8 pixels) per warpgroup
constexpr int TILE_H = 8;              // output rows of a thread block
constexpr int TILE_W = 8 * MT * WGS;   // output columns of a thread block
constexpr int KMAX = 5;
constexpr int WIN_H = TILE_H + KMAX - 1;
constexpr int WIN_W = TILE_W + KMAX - 1;
constexpr int CS = 32;                 // input channels of a staged slice
constexpr int SLICES = C / CS;
constexpr int PL = CS / 4;             // planes of 4 channels per slice, hi or lo
// +16 bytes: the planes of one pixel fall in different bank groups
constexpr int PLANE = WIN_H * WIN_W * 16 + 16;
constexpr int WIN_BYTES = 2 * PL * PLANE;
constexpr int KSTEPS = CS / 8;         // k8 steps per slice and tap
constexpr int B_HALF = 8 * C * 4;      // (tap, 8-channel step) weight tile, hi or lo
constexpr int B_TILE = 2 * B_HALF;
constexpr int B_STEP = KSTEPS * B_TILE; // the weights of one (slice, tap) step: 32 KB
constexpr int STAGES = 4;              // weight ring; STAGES - 2 steps ahead
constexpr int ACC = 64;                // float32 sums a thread holds per M tile
constexpr int TILE_PIX = TILE_H * TILE_W;
constexpr int PITCH = C + 8;           // floats per pixel of a staged output tile
constexpr int RING_BYTES = WIN_BYTES + STAGES * B_STEP;  // window and ring, reused by epilogues
constexpr int SMEM_BYTES = RING_BYTES + 2 * STAGES * 8;     // and the ring's mbarriers

static_assert(RING_BYTES % 8 == 0, "the mbarriers are 8-byte aligned");

// One tap's packed weights: SLICES (slice, tap) steps of B_STEP bytes
constexpr size_t TAP_BYTES = (size_t)SLICES * B_STEP;
static_assert(TILE_PIX * PITCH * 4 <= RING_BYTES, "a staged output tile fits the window and ring");
static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");

struct Tile {
  int n, y0, x0;
};

__host__ __device__ __forceinline__ int tiles_per_image(int H, int W) {
  return ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
}

// Tile `item` of the batch, row-major over the images' tile grids.
__device__ __forceinline__ Tile make_tile(int item, int H, int W) {
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int per = tiles_per_image(H, W);
  const int rem = item % per;
  Tile t;
  t.n = item / per;
  t.y0 = (rem / tiles_w) * TILE_H;
  t.x0 = (rem % tiles_w) * TILE_W;
  return t;
}

// v rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 and split_tf32 in ops/cuda/tf32x3.py do.
// Integer operations only: no conversion instruction.
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// ---- PTX: cp.async, proxy fence, wgmma ------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes from global to shared memory by the bulk-copy engine; completion
// is counted on the mbarrier as transferred bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// shared-memory writes of this thread become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the sums across wgmma fences
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor without swizzle: start address, leading
// byte offset (between the two 16-byte core matrices of a k8 step) and
// stride byte offset (between 8-row groups), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[64 x 128] (+)= A[64 x 8] * B[8 x 128], tf32 x tf32 -> f32 (accumulate
// unless scale_d is 0).  Fragment of d: thread t of the warpgroup holds row
// 16*(t/32) + (t%32)/4 + 8*((i/2)%2), column 8*(i/4) + 2*(t%4) + i%2 in d[i].
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One k8 step of the 3xTF32 product, small terms first; a/b: descriptors
// of the hi operands, the lo operands lie a_lo / b_lo bytes further.
__device__ __forceinline__ void mma_step(float (&d)[ACC], uint32_t a, uint32_t b, int scale_d) {
  constexpr uint32_t a_lo = PL * PLANE, b_lo = B_HALF;
  wgmma_tf32(d, desc(a + a_lo, PLANE, WIN_W * 16), desc(b, C * 16, 128), scale_d);
  wgmma_tf32(d, desc(a, PLANE, WIN_W * 16), desc(b + b_lo, C * 16, 128), 1);
  wgmma_tf32(d, desc(a, PLANE, WIN_W * 16), desc(b, C * 16, 128), 1);
}

// ---- the convolution --------------------------------------------------------

// Slice `sl` (32 input channels) of the tile's input window with the halo of
// a KxK conv, split into hi and lo planes; zeros outside the image.  src
// may have been written earlier in the same launch by other thread blocks (the
// chains), so it is read through L2 (ld.global.cg), never through the
// read-only path.
template <int K>
__device__ __forceinline__ void stage_slice(uint8_t* win, const float* src, const Tile& t, int H,
                                            int W, int sl) {
  constexpr int P = K / 2;
  constexpr int RH = TILE_H + K - 1;
  constexpr int RW = TILE_W + K - 1;
  constexpr int ITEMS = RH * RW * PL;
  constexpr int PER = (ITEMS + THREADS - 1) / THREADS;
  constexpr int WB = 4;  // loads in flight together
  const float* base = src + (size_t)t.n * H * W * C + sl * CS;
#pragma unroll
  for (int b0 = 0; b0 < PER; b0 += WB) {
    float4 v[WB];
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int i = threadIdx.x + (b0 + u) * THREADS;
      if (b0 + u >= PER || i >= ITEMS) continue;
      const int g = i % PL;
      const int pix = i / PL;
      const int r = pix / RW;
      const int gy = t.y0 - P + r;
      const int gx = t.x0 - P + pix - r * RW;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v[u] = __ldcg(reinterpret_cast<const float4*>(base + ((size_t)gy * W + gx) * C + g * 4));
    }
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      const int i = threadIdx.x + (b0 + u) * THREADS;
      if (b0 + u >= PER || i >= ITEMS) continue;
      const int g = i % PL;
      const int pix = i / PL;
      const int r = pix / RW;
      const int c = pix - r * RW;
      const float4 hi = make_float4(tf32_rna(v[u].x), tf32_rna(v[u].y), tf32_rna(v[u].z),
                                    tf32_rna(v[u].w));
      const float4 lo = make_float4(tf32_rna(v[u].x - hi.x), tf32_rna(v[u].y - hi.y),
                                    tf32_rna(v[u].z - hi.z), tf32_rna(v[u].w - hi.w));
      uint8_t* p = win + g * PLANE + (r * WIN_W + c) * 16;
      *reinterpret_cast<float4*>(p) = hi;
      *reinterpret_cast<float4*>(p + PL * PLANE) = lo;
    }
  }
}

// The weight ring: STAGES slots of one step's weights (B_STEP bytes) after
// the window, and their mbarriers after the slots.  seq counts the steps this
// thread block has sent through the ring (across convs): step number g uses
// slot g % STAGES for the (g / STAGES)-th time.
struct Ring {
  uint8_t* data;
  uint64_t* full;   // per slot: the step's weights have landed
  uint64_t* empty;  // per slot: every warp is done with the step's weights
  uint32_t seq;
};

// Once per thread block, before its first conv.
__device__ __forceinline__ Ring make_ring(uint8_t* smem) {
  Ring r;
  r.data = smem + WIN_BYTES;
  r.full = reinterpret_cast<uint64_t*>(smem + RING_BYTES);
  r.empty = r.full + STAGES;
  r.seq = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(r.full + i, 1);
      mbar_init(r.empty + i, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// (one thread) Step s of a KxK conv, the ring's step number g: once every
// warp is done with the slot's previous use, the step's KSTEPS weight tiles,
// contiguous in wgt ([K*K][C/8][2][2][C][4] floats, 8 KB tiles, a (slice,
// tap) step), into slot g % STAGES.
template <int K>
__device__ __forceinline__ void produce(const Ring& r, uint32_t g, const float* wgt, int s) {
  const int sl = s / (K * K);
  const int tap = s - sl * K * K;
  const uint32_t slot = g % STAGES, use = g / STAGES;
  if (use > 0) mbar_wait(r.empty + slot, (use - 1) & 1);
  mbar_expect_tx(r.full + slot, B_STEP);
  bulk_copy(r.data + slot * B_STEP,
            reinterpret_cast<const uint8_t*>(wgt) + ((size_t)tap * SLICES + sl) * B_STEP, B_STEP,
            r.full + slot);
}

// acc[j] = SAME KxK conv of src over M tile j of this warpgroup (8 rows x 8
// columns from x0 + 8*(MT*warpgroup + j)), all 128 output channels.  One
// step is one tap of one slice (4 k8 steps x 3 products): its products go
// into a fresh wgmma sum `part`, which is then added to acc with rounded
// float32 adds.  The tensor cores' own float32 accumulation does not
// round as an FMA does: summed there over all taps and channels, a float32
// conv was 5-50x further from float64 than cuDNN's float32, and 0.2-1.1x
// with the rounded adds (scripts/probe_tf32x3.py).
template <int K>
__device__ __forceinline__ void conv(float (&acc)[MT][ACC], uint8_t* smem, Ring& ring, const float* src,
                                     const float* __restrict__ wgt, const Tile& t, int H, int W) {
  constexpr int STEPS = SLICES * K * K;
  static_assert(STEPS >= STAGES - 2, "the prologue fits the sequence");
  uint8_t* win = smem;
  const uint32_t g0 = ring.seq;
  fence_proxy_async();  // earlier generic accesses of the ring's bytes come before the bulk copies
  __syncthreads();      // a previous conv or epilogue has finished with shared memory
  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES - 2; ++s) produce<K>(ring, g0 + s, wgt, s);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[j][i] = 0.f;
  float part[MT][ACC];
  const int col0 = (threadIdx.x / 128) * MT * 8;
  const uint32_t win_a = smem_addr(win);
  const uint32_t ring_a = smem_addr(ring.data);

#pragma unroll 1
  for (int s = 0; s < STEPS; ++s) {
    const int sl = s / (K * K);
    const int tap = s - sl * K * K;
    const int ky = tap / K;
    const int kx = tap - ky * K;
    if (tap == 0) {  // a new slice, once every warpgroup is done with the old one
      __syncthreads();
      stage_slice<K>(win, src, t, H, W, sl);
      fence_proxy_async();
      __syncthreads();
    }
    if (threadIdx.x == 0 && s + STAGES - 2 < STEPS) produce<K>(ring, g0 + s + STAGES - 2, wgt, s + STAGES - 2);
    __syncwarp();
    const uint32_t g = g0 + s;
    mbar_wait(ring.full + g % STAGES, (g / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < MT; ++j) fence_acc(part[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t b = ring_a + (g % STAGES) * B_STEP + kk * B_TILE;
#pragma unroll
      for (int j = 0; j < MT; ++j)
        mma_step(part[j], win_a + 2 * kk * PLANE + (ky * WIN_W + col0 + 8 * j + kx) * 16, b, kk != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if ((threadIdx.x & 31) == 0) mbar_arrive(ring.empty + g % STAGES);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      fence_acc(part[j]);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[j][i] = __fadd_rn(acc[j][i], part[j][i]);
    }
  }
  ring.seq = g0 + STEPS;
  __syncthreads();  // every warpgroup is done with the window: the epilogue may reuse it
}

// ---- epilogues, through shared memory ----------------------------------------

// The sums into a staged tile st (TILE_PIX pixels of PITCH floats, row-major
// over the 8 x TILE_W tile): d[j][4*n8 + 2*h + e] is pixel (2*warp + h,
// 8*(MT*warpgroup + j) + lane/4), channel 8*n8 + 2*(lane%4) + e.
__device__ __forceinline__ void stage_acc(const float (&acc)[MT][ACC], float* st) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x & 127) >> 5;
  const int col = (threadIdx.x >> 7) * MT * 8 + (lane >> 2);
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n8 = 0; n8 < C / 8; ++n8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (2 * warp + h) * TILE_W + col + 8 * j;
        *reinterpret_cast<float2*>(st + p * PITCH + n8 * 8 + cq) =
            make_float2(acc[j][n8 * 4 + h * 2], acc[j][n8 * 4 + h * 2 + 1]);
      }
  __syncthreads();
}

// 16-byte pieces (4 channels) of the tile's pixels that lie inside the image:
// f(offset in the (N, H, W, C) tensor, offset in the staged tile, channel),
// in floats.  A warp covers one pixel's 128 channels.
template <typename F>
__device__ __forceinline__ void for_tile_pieces(const Tile& t, int H, int W, F&& f) {
  constexpr int PIECES = C / 4;
  for (int i = threadIdx.x; i < TILE_PIX * PIECES; i += THREADS) {
    const int p = i / PIECES;
    const int ch = (i - p * PIECES) * 4;
    const int y = t.y0 + p / TILE_W;
    const int x = t.x0 + p % TILE_W;
    if (y < H && x < W) f((((size_t)t.n * H + y) * W + x) * C + ch, p * PITCH + ch, ch);
  }
}

// Activations through L2 (they may have been written earlier in the same
// launch), biases through the read-only path, stores; all 16 bytes.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// the staged sums of a piece (for_tile_pieces' second offset)
__device__ __forceinline__ float4 staged4(const float* st, int s) {
  return *reinterpret_cast<const float4*>(st + s);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 scale4(float s, float4 a) {
  return make_float4(__fmul_rn(s, a.x), __fmul_rn(s, a.y), __fmul_rn(s, a.z), __fmul_rn(s, a.w));
}

// dst = relu(acc + bias), through the staged tile
__device__ __forceinline__ void emit_relu(const float (&acc)[MT][ACC], float* st, const float* bias,
                                          float* dst, const Tile& t, int H, int W) {
  stage_acc(acc, st);
  for_tile_pieces(t, H, W, [&](size_t g, int s, int ch) {
    const float4 v = add4(staged4(st, s), ldg4(bias + ch));
    st4(dst + g, make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f)));
  });
}

// ---- launches -----------------------------------------------------------------

// The grid of a persistent kernel on this tile: min(items, SMs x resident
// thread blocks per SM) at SMEM_BYTES of dynamic shared memory, which it
// also allows the kernel.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int items, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = items < per_sm * sms ? items : per_sm * sms;
  return cudaSuccess;
}

}  // namespace
