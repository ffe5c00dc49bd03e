// The bf16 convolution tile of the block and chain kernels (blocks.cu,
// tower.cu): an implicit GEMM on Hopper's bf16 tensor cores
// (wgmma.m64n128k16.f32.bf16.bf16), for sm_90a.  bf16 activations, weights
// cast to bf16 by the wrapper, float32 sums, as the TPU kernels compute them.
//
// The GEMM, per SAME KxK conv over NHWC activations with C = 128 channels:
//   M = 64 output pixels: 8 rows x 8 columns.  A core matrix of A is 8
//       consecutive pixels of one window row (8 x 16 bytes); the next 8-row
//       group (stride byte offset) is the next window row.
//   N = the 128 output channels.
//   K = taps x input channels, in k16 steps of 16 channels (32 bytes: two
//       16-byte core matrices a plane apart, the leading byte offset).
// A thread block computes 8 rows x TILE_W = 16 columns x 128 channels of one
// conv (a work item) and is persistent (one per SM), warp-specialised:
//   * warpgroup 0, the producer (setmaxnreg 40): one thread streams the
//     weights through a ring of STAGES slots of half a tap each (4 k16 tiles,
//     16 KB) by cp.async.bulk; one thread fills the window buffers by TMA;
//   * warpgroups 1 and 2, the consumers (setmaxnreg 232): M tile cw of every
//     item, from the resident window and the ring; the epilogue straight from
//     the registers through a staged bf16 tile.
// Window.  Each item's input window with its halo is one 4-D TMA box per
// plane of 8 channels, (8, TILE_W + K - 1, TILE_H + K - 1, 1) of the tensor
// map over the NHWC activations, [plane][row][col][16 bytes] without swizzle,
// planes 128-byte aligned; TMA fills the out-of-image positions with zeros,
// which is SAME padding.  A tap (ky, kx) moves the descriptor's start by ky
// window rows and kx pixels.  Two window buffers: the next item's window
// lands while this one's products run.  The activations may have been
// written earlier in the same launch by other thread blocks (the chains): the
// writers fence the async proxy before the grid barrier.
// Weights.  bf16.packed's layout, [tap][C/16][2][C][8]: a tap is 8 contiguous
// 4 KB k16 tiles, a ring slot its first or second half.  A slot's `full`
// mbarrier counts its bytes, its `empty` mbarrier the consumer warps done
// with it.  Each block reads every weight slot from the L2; sharing a slot
// between two blocks of a cluster by multicast measured no faster (PERF.md
// section 6): the products alone run at the tile's pace.
// Products.  The arithmetic of the parent tile (conv_tf32x3.cuh's bf16
// policy before this tile, and bf16.conv_exact's order): per tap, one wgmma
// chain of the 8 k16 steps in channel order into a fresh float32 sum
// `part`, added to the float32 sums with one rounded add per tap, the taps
// in (ky, kx) order.  A tap's chain is committed as two groups, one per ring
// slot, each slot released once its group is done; one consumer's rounded
// adds run under the other's products.  Two `part` sums in flight per
// consumer (tap t's adds under tap t+1's products) need 192 float32 sums a
// thread: ptxas spilled them with or without setmaxnreg's 232 registers
// for the consumers, and K1 ran far slower, so one `part` it is.
// Epilogues.  The sums stay in the registers: bias, relu, the blocks'
// combines in the plain versions' explicitly rounded order (__fadd_rn /
// __fmul_rn, no FMA contraction), then the bf16 tile is staged in the window
// buffer the item has just finished with (272 bytes a pixel) and leaves 16
// bytes a lane, only where the pixel lies in the image.
// A stalled mbarrier wait traps after about 2^24 tries, so that a fault in
// the pipeline ends the launch with an error in place of a hang.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// Internal linkage, as the float32 tile's: a library of these kernels shares
// no symbol (no inline function's static, no template instantiation) with
// another one loaded in the same process.
namespace {
namespace bf16_tile {

using bf16 = __nv_bfloat16;

constexpr int C = 128;                       // channels: N of every product
constexpr int CONSUMERS = 2;                 // consumer warpgroups, one M tile each
constexpr int THREADS = 128 * (1 + CONSUMERS);  // and the producer warpgroup
constexpr int TILE_H = 8;                    // output rows of an item
constexpr int TILE_W = 8 * CONSUMERS;        // output columns of an item
constexpr int KMAX = 5;
constexpr int PLANES = C / 8;                // planes of 8 channels
constexpr int ACC = 64;                      // float32 sums a consumer thread holds
constexpr int KTILE = 16 * C * 2;            // bytes of one (tap, k16 step) weight tile
constexpr int SLOT_K16 = 4;                  // k16 steps a ring slot: half a tap
constexpr int SLOT_BYTES = SLOT_K16 * KTILE;
constexpr int HALVES = C / 16 / SLOT_K16;    // ring slots a tap
constexpr int STAGES = 6;                    // ring slots
constexpr int WINDOWS = 2;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 40 * 128 + 232 * 256 = 168 * 384
constexpr int STAGE_PITCH = 2 * C + 16;      // bytes a pixel of a staged bf16 tile
constexpr uint32_t WATCHDOG = 1u << 24;      // mbarrier tries before a trap

template <int K>
__host__ __device__ constexpr int win_h() { return TILE_H + K - 1; }
template <int K>
__host__ __device__ constexpr int win_w() { return TILE_W + K - 1; }
// bytes of one TMA box (a plane of the window) and its 128-byte aligned room
template <int K>
__host__ __device__ constexpr int box_bytes() { return win_h<K>() * win_w<K>() * 16; }
template <int K>
__host__ __device__ constexpr int plane_bytes() { return (box_bytes<K>() + 127) / 128 * 128; }

constexpr int WIN_BYTES = PLANES * plane_bytes<KMAX>();
constexpr int RING_OFF = WINDOWS * WIN_BYTES;
constexpr int BAR_OFF = RING_OFF + STAGES * SLOT_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + (2 * STAGES + 2 * WINDOWS) * 8;

static_assert(HALVES == 2, "a tap is two ring slots");
static_assert(WIN_BYTES % 128 == 0 && SLOT_BYTES % 128 == 0, "TMA destinations are 128-byte aligned");
static_assert(CONSUMERS * 64 * STAGE_PITCH <= PLANES * plane_bytes<3>(), "a staged tile fits a 3x3 window");
static_assert(SMEM_BYTES <= 232448, "fits one block's shared memory");

__host__ __device__ __forceinline__ int tiles_per_image(int H, int W) {
  return ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
}

struct Tile {
  int n, y0, x0;
};

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

// Item q of a launch phase of `kinds` convs (1, or 2 for Light53's first
// convs: the 5x5 items first) over `tiles` tiles is tile q % tiles of conv
// q / tiles.

// ---- PTX: mbarriers, bulk and tensor copies, wgmma ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory; every address below is an offset into
// it (the shared window's 32-bit addresses), known at compile time but for
// a slot or buffer index.
__device__ __forceinline__ uint8_t* smem() {
  extern __shared__ __align__(1024) uint8_t bf16_smem[];
  return bf16_smem;
}

__device__ __forceinline__ uint32_t sbase() { return smem_addr(smem()); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also expects `bytes` of copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  uint32_t done = 0, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && ++tries == WATCHDOG) __trap();
  } while (!done);
}

// bytes from global to shared memory by the bulk-copy engine, counted on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one 4-D box of the tensor map at (c, x, y, n), counted on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c, int x, int y, int n,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(n), "r"(bar)
      : "memory");
}

// generic-proxy accesses of this thread are ordered with async-proxy ones
// (TMA, bulk copies, wgmma operands): in shared memory, and in all memory
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// the consumer warpgroups' named barriers: 1 both, 2 + cw one
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int cw) {
  if (cw == 0) asm volatile("bar.sync 2, 128;\n" ::: "memory");
  else asm volatile("bar.sync 3, 128;\n" ::: "memory");
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

// Shared-memory matrix descriptor without swizzle, its start address left
// out: leading byte offset (between the two 16-byte core matrices of a k16
// step) and stride byte offset (between 8-row groups), in 16-byte units.
__device__ __forceinline__ uint64_t desc_hi(uint32_t lbo, uint32_t sbo) {
  return ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// The start-address field of a descriptor: bits 4-17 of the shared address.
__device__ __forceinline__ uint64_t desc_addr(uint32_t addr) {
  return (addr & 0x3FFFF) >> 4;
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], bf16 x bf16 -> f32, both K-major.
// Fragment of d: thread t of the warpgroup holds row 16*(t/32) + (t%32)/4 +
// 8*((i/2)%2), column 8*(i/4) + 2*(t%4) + i%2 in d[i].
__device__ __forceinline__ void wgmma_bf16(float (&d)[ACC], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

// ---- shared memory --------------------------------------------------------------

// The layout: WINDOWS window buffers of WIN_BYTES, STAGES ring slots of
// SLOT_BYTES, then the mbarriers: per slot `full` (its bytes have landed)
// and `empty` (every consumer warp is done with it), per
// window buffer `wfull` and `wempty`.
__device__ __forceinline__ uint32_t win_at(uint32_t buf) { return sbase() + buf * WIN_BYTES; }
__device__ __forceinline__ uint32_t slot_at(uint32_t slot) { return sbase() + RING_OFF + slot * SLOT_BYTES; }
__device__ __forceinline__ uint32_t full_bar(uint32_t slot) { return sbase() + BAR_OFF + 8 * slot; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t slot) { return sbase() + BAR_OFF + 8 * (STAGES + slot); }
__device__ __forceinline__ uint32_t wfull_bar(uint32_t buf) { return sbase() + BAR_OFF + 8 * (2 * STAGES + buf); }
__device__ __forceinline__ uint32_t wempty_bar(uint32_t buf) {
  return sbase() + BAR_OFF + 8 * (2 * STAGES + WINDOWS + buf);
}

// Once per block, before anything else; thread 0 sets up the mbarriers and
// the block meets before any copy or arrival.
__device__ __forceinline__ void init_barriers() {
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_bar(i), 1);
      mbar_init(empty_bar(i), CONSUMERS * 4);
    }
    for (int i = 0; i < WINDOWS; ++i) {
      mbar_init(wfull_bar(i), 1);
      mbar_init(wempty_bar(i), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- the producer ------------------------------------------------------------------

// (one thread) The weights of one KxK conv (bf16.packed: [K*K][C/16][2][C][8])
// through the ring, two slots a tap; g counts the block's slots.
template <int K>
__device__ __forceinline__ void push_weights(const bf16* w, uint32_t& g) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(w);
#pragma unroll 1
  for (int t = 0; t < K * K; ++t) {
#pragma unroll
    for (int h = 0; h < HALVES; ++h, ++g) {
      const uint32_t slot = g % STAGES, use = g / STAGES;
      mbar_wait(empty_bar(slot), (use & 1) ^ 1u);
      mbar_expect_tx(full_bar(slot), SLOT_BYTES);
      bulk_copy(slot_at(slot), src + (size_t)(t * HALVES + h) * SLOT_BYTES, SLOT_BYTES, full_bar(slot));
    }
  }
}

// (one thread) Tile t's window of a KxK conv from the tensor map (box
// (8, win_w, win_h, 1)) into window buffer j % WINDOWS, one box a plane; j
// counts the block's windows.
template <int K>
__device__ __forceinline__ void push_window(const CUtensorMap* map, const Tile& t, uint32_t& j) {
  const uint32_t buf = j % WINDOWS, use = j / WINDOWS;
  mbar_wait(wempty_bar(buf), (use & 1) ^ 1u);
  mbar_expect_tx(wfull_bar(buf), PLANES * box_bytes<K>());
  const uint32_t win = win_at(buf);
#pragma unroll 1
  for (int g = 0; g < PLANES; ++g)
    tma_load_4d(win + g * plane_bytes<K>(), map, 8 * g, t.x0 - K / 2, t.y0 - K / 2, t.n, wfull_bar(buf));
  ++j;
}

// ---- the consumers -----------------------------------------------------------------

// A consumer warp is done with ring slot `slot`: one arrival a warp on the
// slot's empty mbarrier.
__device__ __forceinline__ void release_slot(uint32_t slot) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar(slot));
}

// Issues half h of tap t (k16 steps 4h..4h+3) into p as one wgmma group, once
// its ring slot (g) has landed; the first step of a tap starts a fresh sum.
template <int K>
__device__ __forceinline__ void issue_half(float (&p)[ACC], uint32_t wa, int t, int h, uint32_t g) {
  constexpr uint32_t PLANE = plane_bytes<K>();
  const uint64_t a_hi = desc_hi(PLANE, win_w<K>() * 16), b_hi = desc_hi(C * 16, 128);
  const uint32_t slot = g % STAGES;
  mbar_wait(full_bar(slot), (g / STAGES) & 1);
  const int ky = t / K, kx = t - ky * K;
  const uint32_t a = wa + (ky * win_w<K>() + kx) * 16 + 2 * SLOT_K16 * h * PLANE;
  const uint32_t b = slot_at(slot);
  fence_acc(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SLOT_K16; ++kk)
    wgmma_bf16(p, a_hi | desc_addr(a + 2 * kk * PLANE), b_hi | desc_addr(b + kk * KTILE), (h | kk) != 0);
  wgmma_commit();
}

__device__ __forceinline__ void add_part(float (&acc)[ACC], float (&p)[ACC]) {
  fence_acc(p);
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
}

__device__ __forceinline__ void zero(float (&acc)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
}

// acc = SAME KxK conv of the window at wa (this consumer's M tile) over the
// ring, one sum in flight (p): each tap's two groups, then their slots
// released and the tap's rounded adds, which run under the other consumer's
// products.  g counts the block's ring slots.
template <int K>
__device__ __forceinline__ void conv(float (&acc)[ACC], float (&p)[ACC], uint32_t wa, uint32_t& g) {
  zero(acc);
#pragma unroll 1
  for (int t = 0; t < K * K; ++t) {
    issue_half<K>(p, wa, t, 0, g);
    issue_half<K>(p, wa, t, 1, g + 1);
    wgmma_wait<1>();
    release_slot(g % STAGES);
    wgmma_wait<0>();
    release_slot((g + 1) % STAGES);
    g += 2;
    add_part(acc, p);
  }
}

// Waits for window j's buffer to land; its shared address, this consumer's
// M tile (8 columns on from the window's first).
__device__ __forceinline__ uint32_t window(uint32_t j, int cw) {
  const uint32_t buf = j % WINDOWS;
  mbar_wait(wfull_bar(buf), (j / WINDOWS) & 1);
  return win_at(buf) + cw * 8 * 16;
}

// Every consumer warp is done with window j's buffer (after the accesses of
// this thread, generic ones included, so that the next TMA may overwrite it).
__device__ __forceinline__ void release_window(uint32_t j) {
  fence_proxy_async_shared();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(wempty_bar(j % WINDOWS));
}

// ---- epilogues ------------------------------------------------------------------------

// Where this thread's sums lie: d[4*n8 + 2*h + e] is pixel (y0 + 2*warp + h,
// x0 + 8*cw + lane/4), channel 8*n8 + 2*(lane%4) + e.
struct Frag {
  int y[2], x, ch;
  bool in[2];
};

__device__ __forceinline__ Frag frag(const Tile& t, int H, int W, int cw) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  Frag f;
  f.x = t.x0 + 8 * cw + (lane >> 2);
  f.ch = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f.y[h] = t.y0 + 2 * warp + h;
    f.in[h] = f.y[h] < H && f.x < W;
  }
  return f;
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v rounded to bf16 (to nearest even), as float
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two channels (a bf16 pair) of pixel h of the fragment in src, through the
// L2 (written earlier in the same launch by the chains); zeros outside the image.
__device__ __forceinline__ uint32_t ld_pair(const bf16* src, const Frag& f, const Tile& t, int H, int W, int h,
                                           int n8) {
  if (!f.in[h]) return 0u;
  return __ldcg(reinterpret_cast<const unsigned int*>(src + (((size_t)t.n * H + f.y[h]) * W + f.x) * C + 8 * n8 + f.ch));
}

// the bias pair of this thread's channels in group n8
__device__ __forceinline__ float2 bias2(const float* b, const Frag& f, int n8) {
  return __ldg(reinterpret_cast<const float2*>(b + 8 * n8 + f.ch));
}

// The bf16 pairs v (v[2*n8 + h]: channels 8*n8 + ch of pixel h) of the
// consumer's M tile into dst, through the staged tile in window j's buffer
// (both consumers are done with it): 16 bytes a lane, pixels in the image
// only.
__device__ __forceinline__ void store_tile(const uint32_t (&v)[32], uint32_t j, bf16* dst, const Tile& t, int H,
                                           int W, int cw) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  uint8_t* st = smem() + (j % WINDOWS) * WIN_BYTES + cw * 64 * STAGE_PITCH;
#pragma unroll
  for (int n8 = 0; n8 < C / 8; ++n8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (2 * warp + h) * 8 + (lane >> 2);
      *reinterpret_cast<uint32_t*>(st + p * STAGE_PITCH + 16 * n8 + 4 * (lane & 3)) = v[2 * n8 + h];
    }
  warpgroup_sync(cw);
  const int tid = threadIdx.x & 127;
#pragma unroll
  for (int u = 0; u < 64 * 16 / 128; ++u) {
    const int i = tid + 128 * u;
    const int p = i >> 4, q = i & 15;
    const int y = t.y0 + (p >> 3), x = t.x0 + 8 * cw + (p & 7);
    if (y < H && x < W)
      *reinterpret_cast<uint4*>(dst + (((size_t)t.n * H + y) * W + x) * C + 8 * q) =
          *reinterpret_cast<const uint4*>(st + p * STAGE_PITCH + 16 * q);
  }
}

// bf16(relu(acc + bias)), the first convs' epilogue
__device__ __forceinline__ void relu_pairs(const float (&acc)[ACC], const float* bias, const Frag& f,
                                           uint32_t (&v)[32]) {
#pragma unroll
  for (int n8 = 0; n8 < C / 8; ++n8) {
    const float2 b = bias2(bias, f, n8);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      v[2 * n8 + h] = pack_bf16(fmaxf(__fadd_rn(acc[4 * n8 + 2 * h], b.x), 0.f),
                                fmaxf(__fadd_rn(acc[4 * n8 + 2 * h + 1], b.y), 0.f));
  }
}

// ---- the phases both kernels run ----------------------------------------------------

// (the producer warpgroup) Item q of a first-conv phase: Light53's tb conv
// (5x5 over src5 with w5, items [0, tiles)) or the ta conv (3x3 over src3
// with w3); thread 0 pushes the weights, thread 32 the window.
template <bool kLight53>
__device__ __forceinline__ void produce_first(int q, int tiles, int H, int W, const CUtensorMap* src5,
                                              const CUtensorMap* src3, const bf16* w5, const bf16* w3, uint32_t& g,
                                              uint32_t& j) {
  const bool b5 = kLight53 && q < tiles;
  const Tile t = make_tile(q % tiles, H, W);
  if (threadIdx.x == 0) {
    if (b5) push_weights<5>(w5, g);
    else push_weights<3>(w3, g);
  } else if (threadIdx.x == 32) {
    if (b5) push_window<5>(src5, t, j);
    else push_window<3>(src3, t, j);
  }
}

// (a consumer warpgroup) The same item: the conv, bf16(relu(acc + bias))
// out through the staged tile into dst5 (tb) or dst3 (ta).
template <bool kLight53>
__device__ __forceinline__ void consume_first(int q, int tiles, int H, int W, int cw, const float* bias5,
                                              const float* bias3, bf16* dst5, bf16* dst3, float (&acc)[ACC],
                                              float (&p)[ACC], uint32_t& g, uint32_t& j) {
  const bool b5 = kLight53 && q < tiles;
  const Tile t = make_tile(q % tiles, H, W);
  const uint32_t wa = window(j, cw);
  if (b5) conv<5>(acc, p, wa, g);
  else conv<3>(acc, p, wa, g);
  uint32_t v[32];
  relu_pairs(acc, b5 ? bias5 : bias3, frag(t, H, W, cw), v);
  consumers_sync();  // both M tiles' products are done with the window
  store_tile(v, j, b5 ? dst5 : dst3, t, H, W, cw);
  release_window(j++);
}

// (the producer warpgroup) Tile q of a second-conv phase: branch a's second
// conv (5x5 for Light53, 3x3 for Light) over ta, then Light53's 3x3 over tb.
template <bool kLight53>
__device__ __forceinline__ void produce_second(int q, int H, int W, const CUtensorMap* ta, const CUtensorMap* tb3,
                                               const bf16* wa2, const bf16* wb2, uint32_t& g, uint32_t& j) {
  constexpr int KA2 = kLight53 ? 5 : 3;
  const Tile t = make_tile(q, H, W);
  if (threadIdx.x == 0) {
    push_weights<KA2>(wa2, g);
    if constexpr (kLight53) push_weights<3>(wb2, g);
  } else if (threadIdx.x == 32) {
    push_window<KA2>(ta, t, j);
    if constexpr (kLight53) push_window<3>(tb3, t, j);
  }
}

// ---- launches ------------------------------------------------------------------------

// The driver's tensor-map encoder, through the runtime (no link to libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of an (N, H, W, C) bf16 tensor whose boxes are the windows
// of a KxK conv, one plane each: (8, win_w, win_h, 1); outside the tensor
// the boxes read zeros.  A map depends on nothing but its base and shape,
// so each thread keeps the last MAPS it encoded and encodes only a new one.
template <int K>
cudaError_t window_map(CUtensorMap* map, const bf16* base, int n, int h, int w) {
  constexpr int MAPS = 16;
  struct Entry {
    CUtensorMap map;
    const bf16* base;
    int n, h, w;
  };
  thread_local Entry kept[MAPS] = {};
  thread_local int next = 0;
  for (const Entry& e : kept)
    if (e.base == base && e.n == n && e.h == h && e.w == w && base != nullptr) {
      *map = e.map;
      return cudaSuccess;
    }
  const auto fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)w * C * 2, (cuuint64_t)h * w * C * 2};
  cuuint32_t box[4] = {8, (cuuint32_t)win_w<K>(), (cuuint32_t)win_h<K>(), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  kept[next] = Entry{*map, base, n, h, w};
  next = (next + 1) % MAPS;
  return cudaSuccess;
}

// How many blocks of one kernel fit the card at once, by device: the kernel's
// shared-memory attribute is set and its occupancy asked once a device.
struct Fit {
  static constexpr int DEVICES = 64;
  std::atomic<int> blocks[DEVICES];  // 0: not asked yet
};

// Launches kernel(args) as a persistent grid, at most one block a work item
// and as many as fit the card at once (one an SM); cooperative where the
// kernel meets at grid barriers.  fit is the kernel's own (a static of the
// caller).
template <typename Args>
cudaError_t launch(void (*kernel)(Args), const Args& args, int items, bool cooperative, Fit& fit,
                   cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= Fit::DEVICES) return cudaErrorInvalidDevice;
  int blocks = fit.blocks[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    fit.blocks[dev].store(blocks, std::memory_order_relaxed);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items < blocks ? items : blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = cooperative ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch
  return err != cudaSuccess ? err : last;
}

}  // namespace bf16_tile
}  // namespace
