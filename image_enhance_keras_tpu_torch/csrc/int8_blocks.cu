// int8 residual blocks of the didbl int8 serving path (static activation
// scales), for sm_90a, on the s8 tensor cores (wgmma).
//
// Replaces the Pallas TPU kernels in image_enhance_keras_tpu/ops/pallas/int8_blocks.py:
//   * iek_light53_int8 <- light53_int8 (_light53_int8_kernel):
//       xq = q(x, s0)
//       ta = q(relu(dq(conv3(xq, wa1), s0, sa1) + ba1), s1)
//       tb = q(relu(dq(conv5(xq, wb1), s0, sb1) + bb1), s2)
//       out = 0.9*x + 0.1*((dq(conv5(ta, wa2), s1, sa2) + ba2) + (dq(conv3(tb, wb2), s2, sb2) + bb2))
//   * iek_light_int8   <- light_int8 (_light_int8_kernel):
//       t = q(relu(dq(conv3(q(x, s0), w1), s0, s1w) + b1), s1)
//       out = x + 0.1*(dq(conv3(t, w2), s1, s2w) + b2)
// with q(v, s) = clamp(rint(v * (1/s)), -127, 127) (round half to even) and
// dq(acc, s, sw) = float(acc) * (s * sw[cout]).  s0..s2 are the calibrated
// per-tensor activation scales (act_scales), sw the per-output-channel
// weight scales; the convs are s8 x s8 -> s32, SAME, NHWC, C = 128.  x and
// out are bf16.
//
// Semantics.  The TPU kernel runs halo'd spatial tiles: the first conv is
// VALID over the extended window and the intermediate is masked to zero
// outside the image.  With static scales that is exactly a whole-image SAME
// chain on the quantized codes, so the result does not depend on the tile
// split, and here each block is two launches over the whole image:
//   A. quantize x while staging it, the first conv(s) (Light53: conv3, then
//      conv5 over the same staged window), dequant + bias + relu,
//      requantize, int8 scratch (N,H,W,C);
//   B. second convs over the scratch maps (out-of-image reads are 0, which
//      is the TPU kernel's border mask followed by quantization), dequant
//      and the float32 residual epilogue, bf16 output.
// The s32 sums are exact in any order (at most 25*128*127^2 ~ 5.2e7).  Every
// float step is written with __fmul_rn/__fadd_rn in the TPU kernel's order
// (s_x*s_w first, then acc*that, then + b), so there is no FMA contraction
// and the plain PyTorch version agrees bit for bit; build without
// --use_fast_math.
//
// What bounds it on an H100: operations.  A Light53 block does 68 taps of a
// C x C product per pixel (2*68*C^2 int8 ops), a Light block 18; against the
// 1,979 TOPS dense int8 tensor-core peak and 3.35 TB/s that is far above the
// balance point, so the products belong on the tensor cores.
//
// Design: each conv is an implicit GEMM on wgmma.m64n128k32.s32.s8.s8, both
// operands in shared memory, K-major, without swizzle (8 rows x 16 bytes make
// a core matrix of 128 contiguous bytes).  M = 64 consecutive output pixels
// of one row, N = the 128 output channels, K = taps x C in steps of 32 input
// channels.  A thread block (two warpgroups, each holding 2 M tiles = 128 s32
// sums a thread) computes 4 rows x 64 columns x 128 channels, one block per
// SM (154-159 registers a thread, no spills):
//   * A: the quantized input window with its halo, staged once for all taps
//     (int8 codes by cp.async, bf16 x by batched loads quantized on the way),
//     as 8 planes of 16 channels, each plane [row][col][16 bytes].  A tap
//     (ky, kx) moves the descriptor's start by ky window rows and kx * 16
//     bytes; the two 16-byte halves of a 32-channel step are two planes
//     apart (the descriptor's leading byte offset).
//   * B: the weights, repacked once to [tap][cin/32][2][cout][16] so that each
//     (tap, 32-channel step) is one contiguous 4 KB tile, streamed through a
//     ring of 6 tiles with cp.async, 4 tiles ahead of the products; one
//     wgmma group stays in flight while the next is issued.
//   * Epilogues go through shared memory: the sums' fragments are written
//     there and leave (or, for x, arrive) as coalesced 16-byte pieces.
//   * Quantization uses no conversion instruction (code8): those run at a
//     quarter of the float rate.
//   * Ragged edges: out-of-image window positions are zero codes and the
//     epilogue masks pixels outside the image (96 = 64 + 32 columns).
// Launch B of Light53 parks the dequantized branch-a sums in shared memory
// (128 KB) while the branch-b conv runs, so 128 sums a thread stay live.
// What is left on the table (PERF.md): the staging and the epilogues do not
// overlap the products (one block per SM), and the weight stream shares the
// shared-memory bandwidth with the operand reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

namespace {

constexpr int C = 128;                      // channels: N of every product, 8 planes of K
constexpr int TILE_W = 64;                  // output columns of an M tile (wgmma M)
constexpr int MT = 2;                       // M tiles (output rows) per warpgroup
constexpr int WGS = 2;                      // warpgroups per thread block
constexpr int TILE_H = MT * WGS;            // output rows per thread block
constexpr int THREADS = 128 * WGS;
constexpr int KMAX = 5;
constexpr int WIN_H = TILE_H + KMAX - 1;
constexpr int WIN_W = TILE_W + KMAX - 1;
constexpr int PLANES = C / 16;
// +16 bytes: the 8 planes of one pixel fall in 8 different bank groups
constexpr int PLANE = WIN_H * WIN_W * 16 + 16;
constexpr int WIN_BYTES = PLANES * PLANE;
constexpr int CHUNKS = C / 32;              // K steps per tap
constexpr int B_TILE = C * 32;              // one (tap, 32-channel step) weight tile
constexpr int STAGES = 6;                   // weight ring; STAGES - 2 tiles ahead
constexpr int ACC = 64;                     // s32 sums a thread holds per M tile
constexpr int TILE_PIX = TILE_H * TILE_W;
// staged output tiles (in the window's space once the conv is done), bytes
// per pixel: +16 keeps the 8 pixels a warp writes in different banks
constexpr int PITCH8 = C + 16;
constexpr int PITCH16 = 2 * C + 16;
// shared memory: [window][weight ring][scales, biases][extra]; extra is the
// staged codes (launch A), the parked branch-a sums (launch B of Light53)
// or x (launch B of Light)
constexpr int VEC_OFF = WIN_BYTES + STAGES * B_TILE;
constexpr int EXTRA_OFF = VEC_OFF + 4 * C * 4;
constexpr int SMEM_FIRST = EXTRA_OFF + TILE_PIX * PITCH8;
constexpr int SMEM_LIGHT_B = EXTRA_OFF + TILE_PIX * PITCH16;
constexpr int SMEM_LIGHT53_B = EXTRA_OFF + MT * ACC * THREADS * 4;

static_assert(THREADS * 16 == B_TILE, "one 16-byte copy per thread fills a weight tile");
static_assert(TILE_PIX * PITCH16 <= WIN_BYTES, "a staged bf16 tile fits the window's space");
static_assert(SMEM_LIGHT53_B <= 232448 && SMEM_LIGHT_B <= 232448, "fits one block's shared memory");

struct Tile {
  int n, y0, x0;
};

__device__ __forceinline__ Tile tile_of_block(int W) {
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  Tile t;
  t.y0 = (blockIdx.x / tiles_w) * TILE_H;
  t.x0 = (blockIdx.x % tiles_w) * TILE_W;
  t.n = blockIdx.z;
  return t;
}

// The int8 code q(v) = clamp(rint(v * inv), -127, 127) (rint rounds half to
// even), in the low byte of the result.  Clamping to the integer bounds
// first gives the same code; then adding 1.5 * 2^23, where the float spacing
// is 1, rounds half to even, and the low byte of the sum's bits is the code
// in two's complement.  No conversion instruction (a quarter-rate unit).
__device__ __forceinline__ unsigned code8(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// low bytes of a, b -> bytes 0, 1
__device__ __forceinline__ unsigned pack2(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x0040);
}

__device__ __forceinline__ int pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return (int)__byte_perm(pack2(a, b), pack2(c, d), 0x5410);
}

// float(acc) * ssw + b with ssw = s * sw (rounded once, per channel), rounded
// after every step.
__device__ __forceinline__ float dequant(int acc, float ssw, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), ssw), b);
}

__device__ __forceinline__ void to_floats(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Sources of the staged input window: 16 channels of one pixel as 16 bytes.
struct QuantSrc {  // bf16 x, quantized with the static scale on the fly
  const bf16* x;
  float inv;
  // 16 bf16 values (two 16-byte loads) -> 16 codes
  __device__ __forceinline__ int4 quant16(const uint4& a, const uint4& b) const {
    float lo[8], hi[8];
    to_floats(a, lo);
    to_floats(b, hi);
    unsigned q[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[i] = code8(lo[i], inv);
      q[i + 8] = code8(hi[i], inv);
    }
    return make_int4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                     pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
  }
};

struct I8Src {  // int8 codes of an intermediate
  const int8_t* x;
};

// ---- PTX: cp.async, proxy fence, wgmma ------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// src_size 0 fills the 16 bytes with zeros (src is not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void fence_acc(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor without swizzle: start address, leading
// byte offset (between the two 16-byte core matrices of a 32-byte K step)
// and stride byte offset (between 8-row groups), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[64 x 128] += A[64 x 32] * B[32 x 128], s8 x s8 -> s32.  Fragment of d:
// thread t of the warpgroup holds row 16*(t/32) + (t%32)/4 + 8*((i/2)%2),
// column 8*(i/4) + 2*(t%4) + i%2 in d[i].
__device__ __forceinline__ void wgmma_s8(int (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---- the convolution --------------------------------------------------------

// Input window of the tile with its halo, 16 channels per item, zeros outside
// the image.  int8 codes: cp.async (zero-filled outside), one commit group.
template <int K>
__device__ __forceinline__ void stage_window(uint8_t* win, const I8Src& src, const Tile& t, int H,
                                             int W) {
  constexpr int P = K / 2;
  constexpr int RH = TILE_H + K - 1;
  constexpr int RW = TILE_W + K - 1;
  for (int i = threadIdx.x; i < RH * RW * PLANES; i += THREADS) {
    const int g = i % PLANES;
    const int pix = i / PLANES;
    const int r = pix / RW;
    const int c = pix - r * RW;
    const int gy = t.y0 - P + r;
    const int gx = t.x0 - P + c;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int8_t* p = inside ? src.x + (((size_t)t.n * H + gy) * W + gx) * C + g * 16 : src.x;
    cp_async16_zfill(win + g * PLANE + (r * WIN_W + c) * 16, p, inside ? 16 : 0);
  }
  cp_async_commit();
}

// bf16 x, quantized on the way: the loads of WB items are in flight together.
template <int K>
__device__ __forceinline__ void stage_window(uint8_t* win, const QuantSrc& src, const Tile& t,
                                             int H, int W) {
  constexpr int P = K / 2;
  constexpr int RH = TILE_H + K - 1;
  constexpr int RW = TILE_W + K - 1;
  constexpr int ITEMS = RH * RW * PLANES;
  constexpr int PER = (ITEMS + THREADS - 1) / THREADS;
  constexpr int WB = 9;
#pragma unroll
  for (int b0 = 0; b0 < PER; b0 += WB) {
    uint4 raw[WB][2];
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      raw[u][0] = raw[u][1] = make_uint4(0, 0, 0, 0);
      const int i = threadIdx.x + (b0 + u) * THREADS;
      if (b0 + u >= PER || i >= ITEMS) continue;
      const int g = i % PLANES;
      const int pix = i / PLANES;
      const int r = pix / RW;
      const int gy = t.y0 - P + r;
      const int gx = t.x0 - P + pix - r * RW;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const bf16* p = src.x + (((size_t)t.n * H + gy) * W + gx) * C + g * 16;
        raw[u][0] = __ldg(reinterpret_cast<const uint4*>(p));
        raw[u][1] = __ldg(reinterpret_cast<const uint4*>(p + 8));
      }
    }
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      const int i = threadIdx.x + (b0 + u) * THREADS;
      if (b0 + u >= PER || i >= ITEMS) continue;
      const int g = i % PLANES;
      const int pix = i / PLANES;
      const int r = pix / RW;
      const int c = pix - r * RW;
      *reinterpret_cast<int4*>(win + g * PLANE + (r * WIN_W + c) * 16) =
          src.quant16(raw[u][0], raw[u][1]);
    }
  }
}

// Weight tile s (of the (tap, 32-channel step) sequence) into its ring slot.
__device__ __forceinline__ void load_b(uint8_t* ring, const int8_t* wgt, int s) {
  cp_async16(ring + (s % STAGES) * B_TILE + threadIdx.x * 16,
             wgt + (size_t)s * B_TILE + threadIdx.x * 16);
}

// acc[j] = SAME conv over the tile's rows y0 + MT*warpgroup + j, 64 columns
// from x0, all 128 output channels (exact s32).  wgt: [K*K][C/32][2][C][16].
// The window is staged with the halo of a KW x KW conv (KW >= K), unless
// STAGE is false: then a previous conv of the block staged it.
// cp.async groups: the int8 window (if any), then one per weight tile, so
// that at step s every group up to tile s has landed when at most
// STAGES - 3 are pending.
template <int K, int KW, bool STAGE, typename Src>
__device__ __forceinline__ void conv_s8(int (&acc)[MT][ACC], uint8_t* smem, const Src& src,
                                        const int8_t* __restrict__ wgt, const Tile& t, int H,
                                        int W) {
  constexpr int STEPS = K * K * CHUNKS;
  constexpr int D = (KW - K) / 2;  // the window's halo beyond this conv's
  constexpr bool kAsyncWindow = std::is_same<Src, I8Src>::value;
  static_assert(STEPS >= STAGES - 2, "the prologue fits the sequence");
  uint8_t* win = smem;
  uint8_t* ring = smem + WIN_BYTES;
  __syncthreads();  // a previous conv or epilogue has finished with shared memory
  if constexpr (STAGE && kAsyncWindow) stage_window<KW>(win, src, t, H, W);
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    load_b(ring, wgt, s);
    cp_async_commit();
  }
  if constexpr (STAGE && !kAsyncWindow) stage_window<KW>(win, src, t, H, W);
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[j][i] = 0;
  const int row0 = (threadIdx.x / 128) * MT;
  const uint32_t win_a = smem_addr(win);
  const uint32_t ring_a = smem_addr(ring);

#pragma unroll 1
  for (int s = 0; s < STEPS; ++s) {
    cp_async_wait<STAGES - 3>();  // tile s has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();  // all of tile s (and the window) written; slot of s-2 released
    if (s + STAGES - 2 < STEPS) load_b(ring, wgt, s + STAGES - 2);
    cp_async_commit();
    const int tap = s / CHUNKS;
    const int chunk = s - tap * CHUNKS;
    const int ky = tap / K;
    const int kx = tap - ky * K;
    const uint64_t db = desc(ring_a + (s % STAGES) * B_TILE, C * 16, 128);
#pragma unroll
    for (int j = 0; j < MT; ++j) fence_acc(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const uint64_t da =
          desc(win_a + 2 * chunk * PLANE + ((row0 + j + ky + D) * WIN_W + kx + D) * 16, PLANE, 128);
      wgmma_s8(acc[j], da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of step s-1 are done: its ring slot can be refilled
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < MT; ++j) fence_acc(acc[j]);
  __syncthreads();  // every warpgroup is done with the window: the epilogue may reuse it
}

// ---- epilogues, through shared memory ----------------------------------------

// Where a thread's sums land: M tile j, half h (rows +8) -> tile pixel
// p0 + 64 j + 8 h (row-major over the 4 x 64 tile); n8 -> channels
// 8 n8 + cq, +1.
struct Frag {
  int p0, cq;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x & 31;
    p0 = (threadIdx.x >> 7) * MT * TILE_W + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    cq = (lane & 3) * 2;
  }
};

// 16-byte pieces of the tile's pixels that lie inside the image, with their
// global byte offset and their place in a staged tile of PITCH bytes per
// pixel (BYTES per pixel in global memory).
template <int BYTES, int PITCH, typename F>
__device__ __forceinline__ void for_tile_pieces(const Tile& t, int H, int W, F&& f) {
  constexpr int PIECES = BYTES / 16;
  for (int i = threadIdx.x; i < TILE_PIX * PIECES; i += THREADS) {
    const int p = i / PIECES;
    const int piece = i - p * PIECES;
    const int y = t.y0 + p / TILE_W;
    const int x = t.x0 + p % TILE_W;
    if (y < H && x < W)
      f((((size_t)t.n * H + y) * W + x) * BYTES + piece * 16, p * PITCH + piece * 16);
  }
}

// cp.async of the tile's bf16 x (inside the image) into xs, one commit group.
__device__ __forceinline__ void prefetch_x(uint8_t* xs, const bf16* x, const Tile& t, int H,
                                           int W) {
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  for_tile_pieces<2 * C, PITCH16>(t, H, W, [&](size_t g, int s) { cp_async16(xs + s, xb + g); });
  cp_async_commit();
}

// the staged tile (PITCH bytes per pixel) to global memory, 16 bytes a thread
template <int BYTES, int PITCH>
__device__ __forceinline__ void store_tile(void* dst, const uint8_t* st, const Tile& t, int H,
                                           int W) {
  uint8_t* db = reinterpret_cast<uint8_t*>(dst);
  for_tile_pieces<BYTES, PITCH>(t, H, W, [&](size_t g, int s) {
    *reinterpret_cast<int4*>(db + g) = *reinterpret_cast<const int4*>(st + s);
  });
}

// Dequant vectors of one or two convs into shared memory: s * sw[c] (the
// activation scale times the weight scale) and b[c], each C floats.
__device__ __forceinline__ void stage_vecs(float* v, float s1, const float* sw1, const float* b1,
                                           float s2 = 0.f, const float* sw2 = nullptr,
                                           const float* b2 = nullptr) {
  for (int i = threadIdx.x; i < C; i += THREADS) {
    v[i] = __fmul_rn(s1, __ldg(sw1 + i));
    v[C + i] = __ldg(b1 + i);
    if (sw2 != nullptr) {
      v[2 * C + i] = __fmul_rn(s2, __ldg(sw2 + i));
      v[3 * C + i] = __ldg(b2 + i);
    }
  }
}

// Launch A epilogue: the codes of relu(dq(acc) + b) at the next scale
// (inv_next = 1 / s_next) into the staging area, then out to dst.  vec holds
// s * sw and b of the conv.
__device__ __forceinline__ void emit_codes(const int (&acc)[MT][ACC], const float* vec,
                                           float inv_next, uint8_t* stage, int8_t* dst,
                                           const Tile& t, int H, int W) {
  const Frag f;
#pragma unroll
  for (int n8 = 0; n8 < C / 8; ++n8) {
    const int co = n8 * 8 + f.cq;
    const float sw0 = vec[co], sw1 = vec[co + 1], b0 = vec[C + co], b1 = vec[C + co + 1];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = n8 * 4 + h * 2;
        const unsigned q0 = code8(fmaxf(dequant(acc[j][i], sw0, b0), 0.f), inv_next);
        const unsigned q1 = code8(fmaxf(dequant(acc[j][i + 1], sw1, b1), 0.f), inv_next);
        *reinterpret_cast<uint16_t*>(stage + (f.p0 + j * TILE_W + 8 * h) * PITCH8 + co) =
            (uint16_t)pack2(q0, q1);
      }
  }
  __syncthreads();
  store_tile<C, PITCH8>(dst, stage, t, H, W);
}

// Launch A: t = q(relu(dq(conv(q(x, act[0])), act[0], sw) + b), s_next).
// With w5 set, the Light53 pair over one staged window (conv3 -> t3 at
// act[1], then conv5 -> t5 at act[2]); with w5 null, the Light block's
// conv3 (-> t3 at act[1]).
__global__ void __launch_bounds__(THREADS, 1)
i8_first_kernel(const bf16* __restrict__ x, const float* __restrict__ act,
                const int8_t* __restrict__ w3, const float* __restrict__ s3,
                const float* __restrict__ b3, int8_t* __restrict__ t3,
                const int8_t* __restrict__ w5, const float* __restrict__ s5,
                const float* __restrict__ b5, int8_t* __restrict__ t5, int H, int W) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + VEC_OFF);
  uint8_t* stage = smem + EXTRA_OFF;
  const Tile t = tile_of_block(W);
  const float sx = __ldg(act);
  stage_vecs(vec, sx, s3, b3, sx, s5, b5);
  const QuantSrc src{x, __frcp_rn(sx)};
  int acc[MT][ACC];
  if (w5 == nullptr) {
    conv_s8<3, 3, true>(acc, smem, src, w3, t, H, W);
    emit_codes(acc, vec, __frcp_rn(__ldg(act + 1)), stage, t3, t, H, W);
  } else {
    conv_s8<3, 5, true>(acc, smem, src, w3, t, H, W);
    emit_codes(acc, vec, __frcp_rn(__ldg(act + 1)), stage, t3, t, H, W);
    conv_s8<5, 5, false>(acc, smem, src, w5, t, H, W);
    emit_codes(acc, vec + 2 * C, __frcp_rn(__ldg(act + 2)), stage, t5, t, H, W);
  }
}

// Launch B of Light53: out = id*x + res*((dq(conv5(ta)) + ba2) + (dq(conv3(tb)) + bb2)).
__global__ void __launch_bounds__(THREADS, 1)
light53_i8_second_kernel(const bf16* __restrict__ x, const float* __restrict__ act,
                         const int8_t* __restrict__ ta, const int8_t* __restrict__ wa2,
                         const float* __restrict__ sa2, const float* __restrict__ ba2,
                         const int8_t* __restrict__ tb, const int8_t* __restrict__ wb2,
                         const float* __restrict__ sb2, const float* __restrict__ bb2,
                         bf16* __restrict__ out, int H, int W,
                         float res_scale, float identity_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + VEC_OFF);
  float* park = reinterpret_cast<float*>(smem + EXTRA_OFF);  // [MT*ACC][THREADS], this thread's
  const Tile t = tile_of_block(W);
  const Frag f;
  stage_vecs(vec, __ldg(act + 1), sa2, ba2, __ldg(act + 2), sb2, bb2);
  int acc[MT][ACC];
  conv_s8<5, 5, true>(acc, smem, I8Src{ta}, wa2, t, H, W);
#pragma unroll
  for (int n8 = 0; n8 < C / 8; ++n8) {
    const int co = n8 * 8 + f.cq;
    const float sw0 = vec[co], sw1 = vec[co + 1], b0 = vec[C + co], b1 = vec[C + co + 1];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = n8 * 4 + h * 2;
        park[(j * ACC + i) * THREADS + threadIdx.x] = dequant(acc[j][i], sw0, b0);
        park[(j * ACC + i + 1) * THREADS + threadIdx.x] = dequant(acc[j][i + 1], sw1, b1);
      }
  }
  conv_s8<3, 3, true>(acc, smem, I8Src{tb}, wb2, t, H, W);
  // x into the window's space; outputs written over it, then out
  prefetch_x(smem, x, t, H, W);
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int n8 = 0; n8 < C / 8; ++n8) {
    const int co = n8 * 8 + f.cq;
    const float sw0 = vec[2 * C + co], sw1 = vec[2 * C + co + 1];
    const float b0 = vec[3 * C + co], b1 = vec[3 * C + co + 1];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = n8 * 4 + h * 2;
        __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(
            smem + (f.p0 + j * TILE_W + 8 * h) * PITCH16 + co * 2);
        const float2 xv = __bfloat1622float2(*px);
        const float a0 = park[(j * ACC + i) * THREADS + threadIdx.x];
        const float a1 = park[(j * ACC + i + 1) * THREADS + threadIdx.x];
        const float o0 = __fadd_rn(__fmul_rn(identity_scale, xv.x),
                                   __fmul_rn(res_scale, __fadd_rn(a0, dequant(acc[j][i], sw0, b0))));
        const float o1 = __fadd_rn(__fmul_rn(identity_scale, xv.y),
                                   __fmul_rn(res_scale, __fadd_rn(a1, dequant(acc[j][i + 1], sw1, b1))));
        *px = __floats2bfloat162_rn(o0, o1);
      }
  }
  __syncthreads();
  store_tile<2 * C, PITCH16>(out, smem, t, H, W);
}

// Launch B of Light: out = x + res*(dq(conv3(t)) + b2).  x is fetched
// before the conv, into its own space.
__global__ void __launch_bounds__(THREADS, 1)
light_i8_second_kernel(const bf16* __restrict__ x, const float* __restrict__ act,
                       const int8_t* __restrict__ tin, const int8_t* __restrict__ w2,
                       const float* __restrict__ s2, const float* __restrict__ b2,
                       bf16* __restrict__ out, int H, int W, float res_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + VEC_OFF);
  uint8_t* xs = smem + EXTRA_OFF;
  const Tile t = tile_of_block(W);
  const Frag f;
  stage_vecs(vec, __ldg(act + 1), s2, b2);
  prefetch_x(xs, x, t, H, W);  // the oldest cp.async group: complete once the conv starts
  int acc[MT][ACC];
  conv_s8<3, 3, true>(acc, smem, I8Src{tin}, w2, t, H, W);
#pragma unroll
  for (int n8 = 0; n8 < C / 8; ++n8) {
    const int co = n8 * 8 + f.cq;
    const float sw0 = vec[co], sw1 = vec[co + 1], b0 = vec[C + co], b1 = vec[C + co + 1];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = n8 * 4 + h * 2;
        __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(
            xs + (f.p0 + j * TILE_W + 8 * h) * PITCH16 + co * 2);
        const float2 xv = __bfloat1622float2(*px);
        const float o0 = __fadd_rn(xv.x, __fmul_rn(res_scale, dequant(acc[j][i], sw0, b0)));
        const float o1 = __fadd_rn(xv.y, __fmul_rn(res_scale, dequant(acc[j][i + 1], sw1, b1)));
        *px = __floats2bfloat162_rn(o0, o1);
      }
  }
  __syncthreads();
  store_tile<2 * C, PITCH16>(out, xs, t, H, W);
}

dim3 grid_for(int n, int h, int w) {
  const unsigned tiles = (unsigned)(((h + TILE_H - 1) / TILE_H) * ((w + TILE_W - 1) / TILE_W));
  return dim3(tiles, 1, (unsigned)n);
}

// Dynamic shared memory above 48 KB has to be asked for, per kernel.
cudaError_t allow_smem() {
  cudaError_t err = cudaFuncSetAttribute(i8_first_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FIRST);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(light_i8_second_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIGHT_B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(light53_i8_second_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIGHT53_B);
  return err;
}

}  // namespace

extern "C" {

// Shapes the launches accept: C == 128, bf16 activations, weights repacked
// to [ky*kx][cin/32][2][cout][16] int8, every pointer 16-byte aligned, all
// tensors contiguous (the Python wrapper checks).  act holds the float32
// activation scales on the device.  Returns the CUDA error code of the
// launches (0 = success).
int iek_light53_int8(const bf16* x, const float* act,
                     const int8_t* wa1, const float* sa1, const float* ba1,
                     const int8_t* wa2, const float* sa2, const float* ba2,
                     const int8_t* wb1, const float* sb1, const float* bb1,
                     const int8_t* wb2, const float* sb2, const float* bb2,
                     int8_t* ta, int8_t* tb, bf16* out,
                     int n, int h, int w, int c,
                     float res_scale, float identity_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  i8_first_kernel<<<grid_for(n, h, w), THREADS, SMEM_FIRST, st>>>(
      x, act, wa1, sa1, ba1, ta, wb1, sb1, bb1, tb, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light53_i8_second_kernel<<<grid_for(n, h, w), THREADS, SMEM_LIGHT53_B, st>>>(
      x, act, ta, wa2, sa2, ba2, tb, wb2, sb2, bb2, out, h, w, res_scale, identity_scale);
  return (int)cudaGetLastError();
}

int iek_light_int8(const bf16* x, const float* act,
                   const int8_t* w1, const float* s1, const float* b1,
                   const int8_t* w2, const float* s2, const float* b2,
                   int8_t* t, bf16* out, int n, int h, int w, int c,
                   float res_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  i8_first_kernel<<<grid_for(n, h, w), THREADS, SMEM_FIRST, st>>>(
      x, act, w1, s1, b1, t, nullptr, nullptr, nullptr, nullptr, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light_i8_second_kernel<<<grid_for(n, h, w), THREADS, SMEM_LIGHT_B, st>>>(
      x, act, t, w2, s2, b2, out, h, w, res_scale);
  return (int)cudaGetLastError();
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
