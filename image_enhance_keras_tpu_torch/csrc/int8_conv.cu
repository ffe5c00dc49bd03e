// X4: a 3x3 SAME int8 convolution with per-channel folded scales, for sm_90a,
// on the s8 tensor cores (wgmma): the convs of the zoo's int8 forwards
// (difv4's LightBlocks, difvdsr's DiffBlocks, the subpixel head of
// didbl_subpixel), with the blocks' combines in its epilogues.  And, on the
// same machinery, X1 and X2: the static Light53 and Light blocks of didbl's
// XLA int8 forward (--forward int8), xla_block_kernel, two launches each.
//
// X4 replaces work the JAX package leaves to XLA, not a Pallas kernel
// (models/didbl_pallas.py _quant_c, _qconv_xla, _deqf, _quant_dyn_sample,
// _deq_dyn, as models/zoo_int8.py and apply_didbl_int8_xla_tail call them),
// followed by the block's activation:
//   static:  q = clamp(rint(x * (1/s_in[c])), -127, 127)   (per input channel)
//            y = A(acc) * sf[co] + b[co]
//   dynamic: s = max(abs-max of the sample, 1e-6) / 127.0 (a division)
//            q = clamp(rint(x / s), -127, 127)              (the rounded quotient)
//            y = A(acc) * (s_w[co] * s) + b[co]
//   v = act(y): none, relu max(y, 0), or leaky where(y >= 0, y, slope * y)
// acc is the exact s32 sum over 3 x 3 x C_in; A(acc) is float(acc), or
// bf16(float(acc)) under the bf16 accumulator (XLA converts the s32 sum to
// float32, then to bf16).  Every product and add is rounded on its own (no
// FMA), as JAX computes these ops one at a time; build without
// --use_fast_math.
//
// The input is bf16 or float32 NHWC x quantized while it is staged, or the
// int8 codes an earlier launch emitted (the block-level forms: no float
// activation between two convs of a block leaves the chip).  The epilogue
// (EPI_*) writes one of:
//   F32     v as float32 (the subpixel head, static or dynamic);
//   CODES   clamp(rint(v * (1/s_out[co])), -127, 127): the codes of the next
//           conv's input (a LightBlock's or a DiffBlock's conv_a, conv_c);
//   LIGHT   T(x + 0.1 * y), x the block input of type T (a LightBlock's conv_b);
//   DIFF_B  t = y as float32 and the codes of d = t - x (a DiffBlock's conv_b);
//   DIFF_D  T(x + 0.1 * ((d + y) + t)) with d = t - x recomputed (conv_d).
// C_in a multiple of 32, at most 256; C_out a multiple of 64 or 96; the
// weights int8 HWIO, repacked (ops/cuda/int8_conv.py wraps the kernel and
// holds its plain versions).
//
// X1 and X2 (models/didbl_pallas.py _light53_i8_xla, _light_i8_xla; wrapped
// by ops/cuda/int8_xla.py), bf16 x, C = 128, per-channel static scales
// (act_scales rows s_x, then the branch intermediates'), the folded "qf"
// weights with their "sf":
//   X1: ta = codes of relu(conv3(q(x)) dequantized) at s_a, tb of conv5 at s_b
//       out = bf16(0.9 * x + 0.1 * ((A(conv5(ta)) * sa2 + ba2) + (A(conv3(tb)) * sb2 + bb2)))
//   X2: t = codes of relu(conv3(q(x)) dequantized) at s_t
//       out = bf16(x + 0.1 * (A(conv3(t)) * s2 + b2))
// each in two launches of xla_block_kernel<FORM> (the codes between them):
// PAIR_CODES (both first convs over one window of x staged with the 5 x 5
// halo), PAIR_LIGHT53 (per 64 output channels conv5 over ta's window and
// conv3 over tb's, into two sets of sums in the registers, then the
// combine from them), ONE_CODES and ONE_LIGHT (X2's convs).  They run at
// the same rounding points as X4's forms.
//
// X1u (models/didbl_pallas.py _light53_i8_xla_upfused, IEK_INT8_UPQ's first
// HR block; JAX leaves it to XLA): X1 whose input arrives as the int8 codes
// of the bf16 x f of the LR map h_lr (csrc/upsample.cu's K3q) and whose
// identity leg is the float32 x f of 0.9 * h_lr (K3's float32 arithmetic):
//   out = bf16(skip + 0.1 * (a + b)),  skip = U_f(fl(float(h_lr) * fl(0.9)))
// in two launches: PAIR_CODES_I8 (PAIR_CODES over a window of the codes,
// staged by cp.async with zero fill, nothing quantized) and PAIR_LIGHT53_UP
// (PAIR_LIGHT53 whose combine forms the skip itself from h_lr: the HR skip
// map is never written).  For output (n, f k + r, f m + s, c) the skip is
// K3's: y = fl(h * fl(0.9)) at (k, m), (k1, m), (k, m1), (k1, m1) (k1 =
// min(k + 1, H/f - 1), m1 likewise), the H pass with the weights of r, then
// the W pass with those of s, every product and sum rounded on its own.
// The light53 launch keeps to 4 x 64 tiles and an even f, so that a
// consumer thread's two HR rows lie in one LR row pair and its 4 outputs of
// a channel pair read 8 LR words (2 columns, 4 neighbours); they arrive one
// channel group ahead of the combine (the first while conv3's products
// run), from the L2, where one thread prefetches the tile's LR rows.  The
// skip's arithmetic (2 + 6 + 3 rounded operations an output) runs in the
// consumers' epilogue: it needs no shared memory, which X1's light53 launch
// has no room for beside its windows and a ring of 4 slots.
//
// What bounds it on an H100: operations.  2 * 9 * C_in * C_out int8 ops a
// pixel (1.18 M at 256 -> 256; X1's 68 taps at 128: 2.2 M) against 1 to 4
// bytes of input and 1 to 6 of output per channel: far above the balance
// point of 1,979 TOPS over 3.35 TB/s.
//
// Design: an implicit GEMM on wgmma.m64nNTk32.s32.s8.s8 (NT = 128 output
// channels a column block where C_out allows it, else 96 or 64), both
// operands in shared memory, K-major, without swizzle.  A persistent,
// warp-specialised block (one per SM) walks over the tiles of 256 output
// positions; three warpgroups:
//   * the producer: warp 0 streams the weight tiles through a ring of up to
//     8 slots (X1, X2: 16; a slot one K step of NT x 32 bytes, X1 and X2
//     two, X1's second launch four) by cp.async.bulk, completion on an mbarrier's
//     transaction count; warps 1-3 stage each tile's input window once, for
//     every output channel, into one of two window buffers (one where two
//     would leave a ring of fewer than 4 slots), so the next tile's window
//     lands while this one's products run (int8 codes by cp.async with zero
//     fill; bf16 / float32 x by batched 16-byte loads quantized on the way);
//   * two consumers, 2 M tiles of 64 positions each: for every column block
//     of NT channels, the taps x C_in / 32 steps of wgmma over the resident
//     window, then the epilogue straight from the registers.  A consumer
//     releases a ring slot once its products are done, and the window once
//     the tile's last column block has read it, before that block's epilogue.
//     The epilogue's kind, accumulator rounding and activation are template
//     parameters picked once a launch, so that its unrolled code holds no
//     branch; the combines' loads of x (and t) run one channel group ahead,
//     and at the start of a tile one consumer thread prefetches those rows
//     into the L2 (cp.async.bulk.prefetch).  In X1 and X2 the producer
//     warpgroup gives its registers to the consumers (setmaxnreg 72 / 216:
//     no spills), the epilogues take both M tiles a channel group at a time
//     with the per-channel vectors in shared memory, and the combines' x is
//     loaded into registers while the last conv's products run.
//   * The window holds C_in / 16 planes of 16 channels, [position][16 bytes].
//     The pitch of a row leaves E columns of padding on each side (E the
//     halo of the launch's widest conv: 1, X1's 2); a window of halo e <= E
//     holds its tile's rows of a conv of that halo.  A tap (ky, kx) of a
//     KW x KW conv moves the descriptor's start by (ky - KW/2 + e) * pitch +
//     kx - KW/2 + E positions, the two halves of a 32-channel K step are a
//     plane apart (the leading byte offset).  Two tilings: 4 rows x 64
//     columns (a window of 4 + 2 e rows of 64 + 2 E) where W is a multiple
//     of 64 or two windows of the other kind do not fit; else 256
//     consecutive positions of the image's raster padded to a pitch of
//     W + 2 E (a window of 256 + 2 e pitch + 2 E positions; the padding
//     columns of each row are computed but not stored), so a 96-wide map
//     wastes 4 positions in 100, not 32 in 128 (X1's first launch and X2's;
//     X1's second launch holds ta's window in two buffers and tb's in one,
//     which fit raster tiles of a 96-wide map only without a ring: 4 x 64
//     tiles there).  Outside the image the staged codes are zero: SAME
//     padding of the codes, as XLA pads the quantized tensor.
//   * B: the weights repacked to [tap][C_in/32][C_out/NT][2][NT][16], so each
//     (tap, K step, column block) is one contiguous NT x 32 tile.
// The dynamic form adds a launch before the conv: each sample's abs-max of x,
// as float bits by atomicMax.
// Codes leave 8 bytes a lane: the 4 lanes of a quad trade their pairs so that
// a quad fills a 32-byte sector.
// Left on the table (scripts/probe_x4_parts.py and scripts/probe_x1_parts.py
// time the kernel without its epilogue and without its products): the two
// consumers run their epilogues together after each column block, and the
// tensor cores idle meanwhile; the epilogue does not hide under the
// products, and costs about a third of a launch.  The weight tiles stream
// from the L2 anew for every tile (4 KB a K step for 256 positions), about
// as fast as the tensor cores take them, so the products alone run near
// that stream's rate; larger tiles need more sums than the registers hold,
// or a cluster multicasting the weights.  X4's 128-channel forms spill a
// few of the consumers' registers (ptxas -v; X4 keeps 168 registers a
// thread).  The difv4 head's 96-wide map at C_in = 256 keeps the 4 x 64
// tiling (two raster windows of 454 positions do not fit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

namespace {

constexpr int TILE_W = 64;                  // positions of an M tile (wgmma M)
constexpr int MT = 2;                       // M tiles per consumer warpgroup
constexpr int CONSUMERS = 2;                // consumer warpgroups
constexpr int TILE_M = TILE_W * MT * CONSUMERS;  // output positions of a tile
constexpr int THREADS = 128 * (1 + CONSUMERS);   // + the producer warpgroup
constexpr int STAGERS = 96;                 // producer threads staging windows (warps 1-3)
constexpr int TILE_ROWS = MT * CONSUMERS;   // output rows of a 4 x 64 tile
constexpr int CIN_MAX = 256;
constexpr int COUT_CODES_MAX = 1024;        // C_out of the forms that emit codes
constexpr int MAX_STAGES = 8;               // weight ring slots
constexpr int MIN_STAGES = 4;               // slots two windows must leave, else one window
constexpr int WINDOWS = 2;                  // window buffers where they fit
// the mbarriers, first: the ring's full / empty, the windows' full / empty, X1's second window's
constexpr int BAR_BYTES = (8 * (2 * MAX_STAGES + 2 * WINDOWS + 2) + 127) / 128 * 128;
constexpr int SMEM_MAX = 232448;
constexpr int ABS_THREADS = 256;
constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2;
constexpr int EPI_F32 = 0, EPI_CODES = 1, EPI_LIGHT = 2, EPI_DIFF_B = 3, EPI_DIFF_D = 4;
constexpr int SRC_BF16 = 0, SRC_F32 = 1, SRC_I8 = 2;
constexpr int DYN_NONE = 0, DYN_FULL = 1, DYN_ABSMAX = 2, DYN_GIVEN = 3;
// The static blocks of the XLA int8 forward (xla_block_kernel): X1's two
// launches, the pair of first convs into codes and the pair of second convs
// with the combine; X2's two, one conv into codes and one with the combine;
// X1u's two, X1's from int8 codes and with the skip formed from the LR map
constexpr int PAIR_CODES = 0, PAIR_LIGHT53 = 1, ONE_CODES = 2, ONE_LIGHT = 3, PAIR_CODES_I8 = 4,
              PAIR_LIGHT53_UP = 5;
constexpr int X_C = 128;                    // their channels
constexpr int X_STAGES = 16;                // their weight ring's slots at most
constexpr int X_BAR_BYTES = (8 * (2 * X_STAGES + 2 * WINDOWS + 2) + 127) / 128 * 128;
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;  // setmaxnreg: 72 * 128 + 216 * 256 = 168 * 384
constexpr int X_S64 = 4, X_S128 = 2;        // K steps a ring slot: X1's second launch (2 KB each), the others
constexpr int X_VECS = 7;                   // their vectors in shared memory: 3 reciprocals, sf, bias, sf2, bias2

// The 4 x 64 tiling's window pitch where the widest conv has halo E (5 x 5: E = 2)
template <int E>
__host__ __device__ constexpr int pitch4() {
  return TILE_W + 2 * E;
}

// Everything a launch needs; the geometry (tiling, window, ring) is set by geometry().
struct Params {
  const void* x;       // the input: bf16 / float32 values or int8 codes
  const float* scale;  // static: s_in (C_in); dynamic: the samples' abs-maxes (N)
  const int8_t* w;     // the packed weights
  const float* sf;     // (C_out) dequant scales (dynamic: the weight scales s_w)
  const float* bias;   // (C_out)
  const float* s_out;  // (C_out) the scales of emitted codes (CODES, DIFF_B)
  const void* xr;      // the block input x of the combines (LIGHT, DIFF_B, DIFF_D)
  const float* t_in;   // DIFF_D: t
  float* out_f;        // F32: v; DIFF_B: t
  int8_t* out_q;       // CODES, DIFF_B: the codes
  void* out_x;         // LIGHT, DIFF_D: the block output, xr's type
  int n, H, W, cin, cout;
  int epi, xr_f32, acc_bf16, act;
  float slope;
  float res;            // X1, X2: the combines' residual scale
  // X1 and X2 (xla_block_kernel): the second conv of a launch and the second window
  const int8_t* w2;     // the second conv's weights (codes: conv5 wb1; light53: conv3 wb2)
  const float* sf2;
  const float* bias2;
  const float* s_out2;  // codes: the scales of tb
  int8_t* out_q2;       // codes: tb
  const void* x2;       // light53: tb's codes, the second conv's input
  float id;             // light53: the identity scale
  // X1u's light53 launch: the identity leg from the LR map
  const bf16* lr;       // h_lr (n, lr_h, lr_w, X_C); H = factor * lr_h, W = factor * lr_w
  const float* wt;      // K3's float32 weights: 1 - r / f at wt[r], r / f at wt[f + r]
  int lr_h, lr_w, factor;
  // geometry
  int raster;     // 0: 4 x 64 tiles; 1: 256 positions of the padded raster
  int pitch;      // window positions a row (pitch4<E>(), or W + 2 E)
  int positions;  // window positions
  int plane;      // bytes a plane of 16 channels (positions * 16 + 16)
  int win_bytes;  // bytes a window
  int nwin;       // window buffers (2: the next tile's lands while this one's products run)
  int positions2, plane2, win2_off;  // X1's light53 launch: tb's window (halo 1), one buffer
  int ring_off, vec_off, smem;
  int stages;     // weight ring slots
  int tiles_w, tiles_a_sample, tiles;
};

// ---- PTX: cp.async, bulk copies, mbarriers, proxy fence, wgmma ---------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_size 0 fills the 16 bytes with zeros (src is not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global memory into shared memory, counted
// on bar's transaction count
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor without swizzle: start address, leading
// byte offset (between the two 16-byte core matrices of a 32-byte K step)
// and stride byte offset (between 8-row groups), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[64 x N] += A[64 x 32] * B[32 x N], s8 x s8 -> s32.  Fragment of d:
// thread t of the warpgroup holds row 16*(t/32) + (t%32)/4 + 8*((i/2)%2),
// column 8*(i/4) + 2*(t%4) + i%2 in d[i].
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db);

#define IEK_R8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                  "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : IEK_R8(0), IEK_R8(8), IEK_R8(16), IEK_R8(24)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : IEK_R8(0), IEK_R8(8), IEK_R8(16), IEK_R8(24), IEK_R8(32), IEK_R8(40)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : IEK_R8(0), IEK_R8(8), IEK_R8(16), IEK_R8(24), IEK_R8(32), IEK_R8(40), IEK_R8(48), IEK_R8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef IEK_R8

// ---- quantization ---------------------------------------------------------

// The int8 code q(v) = clamp(rint(v * inv), -127, 127) (rint rounds half to
// even), in the low byte of the result: clamped to the integer bounds
// first, then adding 1.5 * 2^23, where the float spacing is 1, rounds half
// to even, and the low byte of the sum's bits is the code.
__device__ __forceinline__ unsigned code8(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// The codes clamp(rint(v / s), -127, 127) of the rounded quotients, without
// a division (as codes8_div of csrc/int8_blocks.cu, which argues it): q0 =
// v * rs with rs = 1 / s rounded is the quotient's code unless it lies
// within 2^-15 of a half-integer; there two Markstein corrections round
// the quotient exactly.
template <int N>
__device__ __forceinline__ void codes8_div(const float (&v)[N], float s, float rs,
                                           unsigned (&q)[N]) {
  unsigned near = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float c = fminf(fmaxf(__fmul_rn(v[i], rs), -127.f), 127.f);
    const float r = __fadd_rn(c, 12582912.f);
    near |= (unsigned)(fabsf(__fsub_rn(c, __fsub_rn(r, 12582912.f))) >= 0.5f - 0x1p-15f) << i;
    q[i] = __float_as_uint(r);
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!((near >> i) & 1u)) continue;
      const float q0 = __fmul_rn(v[i], rs);
      const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, v[i]), rs, q0);
      const float q2 = __fmaf_rn(__fmaf_rn(-q1, s, v[i]), rs, q1);
      q[i] = __float_as_uint(__fadd_rn(fminf(fmaxf(q2, -127.f), 127.f), 12582912.f));
    }
  }
}

// low bytes of a, b, c, d -> one 32-bit word
__device__ __forceinline__ int pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return (int)__byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// 16 channels of type T as 16-byte loads
template <typename T>
struct Act;

template <>
struct Act<bf16> {
  static constexpr int LOADS = 2;
  __device__ static __forceinline__ void to_floats(const uint4 (&r)[LOADS], float (&f)[16]) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[l]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[8 * l + 2 * i] = t.x;
        f[8 * l + 2 * i + 1] = t.y;
      }
    }
  }
  __device__ static __forceinline__ float absmax16B(const uint4& r) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      m = fmaxf(m, fmaxf(fabsf(t.x), fabsf(t.y)));
    }
    return m;
  }
};

template <>
struct Act<float> {
  static constexpr int LOADS = 4;
  __device__ static __forceinline__ void to_floats(const uint4 (&r)[LOADS], float (&f)[16]) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      f[4 * l] = __uint_as_float(r[l].x);
      f[4 * l + 1] = __uint_as_float(r[l].y);
      f[4 * l + 2] = __uint_as_float(r[l].z);
      f[4 * l + 3] = __uint_as_float(r[l].w);
    }
  }
  __device__ static __forceinline__ float absmax16B(const uint4& r) {
    return fmaxf(fmaxf(fabsf(__uint_as_float(r.x)), fabsf(__uint_as_float(r.y))),
                 fmaxf(fabsf(__uint_as_float(r.z)), fabsf(__uint_as_float(r.w))));
  }
};

// The dynamic scale of a sample: max(abs-max, 1e-6) / 127.0, a division.
__device__ __forceinline__ float sample_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
}

// Each sample's abs-max of x into amax[sample] (blockIdx.z), as float bits by
// atomicMax (non-negative floats order as their bits do); vecs: 16-byte
// vectors a sample.
template <typename T>
__global__ void __launch_bounds__(ABS_THREADS)
sample_absmax_kernel(const T* __restrict__ x, float* __restrict__ amax, long long vecs) {
  const uint4* p = reinterpret_cast<const uint4*>(x) + (size_t)blockIdx.z * vecs;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * ABS_THREADS + threadIdx.x; i < vecs;
       i += (long long)gridDim.x * ABS_THREADS)
    m = fmaxf(m, Act<T>::absmax16B(__ldg(p + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0 && m > 0.f)
    atomicMax(reinterpret_cast<unsigned*>(amax + blockIdx.z), __float_as_uint(m));
}

// ---- tiles ------------------------------------------------------------------

// A tile: sample n and its first position: the 4 x 64 tiling's (y0, x0), or
// the raster tiling's first raster position r0 (in y0; x0 unused).
struct Tile {
  int n, y0, x0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int tile) {
  Tile t;
  t.n = tile / p.tiles_a_sample;
  const int r = tile - t.n * p.tiles_a_sample;
  if (p.raster) {
    t.y0 = r * TILE_M;
    t.x0 = 0;
  } else {
    t.y0 = (r / p.tiles_w) * TILE_ROWS;
    t.x0 = (r % p.tiles_w) * TILE_W;
  }
  return t;
}

// Windows and pitches.  The pitch leaves E padding columns on each side of a
// row (E: the halo of the launch's widest conv); a window of halo e <= E
// holds the rows its tile's outputs read through a conv of that halo, all
// pitch columns of them.  Raster tiling: a row of the padded raster is
// pitch = W + 2 E positions, padded column c holding image column c - E.

// The image pixel (gy, gx) of position pos of tile t's window of halo e;
// false outside the image.
template <int E>
__device__ __forceinline__ bool window_pixel(const Params& p, const Tile& t, int e, int pos, int& gy,
                                             int& gx) {
  if (p.raster) {
    // rr = r + (e + 1) * pitch >= 0, r = r0 + pos - e * pitch - E the
    // position's raster index (row r / pitch, image column r % pitch - E)
    const int rr = t.y0 + pos + p.pitch - E;
    gy = rr / p.pitch - (e + 1);
    gx = rr - (gy + e + 1) * p.pitch - E;
  } else {
    constexpr int PW = pitch4<E>();
    const int wr = pos / PW;
    gy = t.y0 - e + wr;
    gx = t.x0 - E + pos - wr * PW;
  }
  return gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
}

// The image pixel of output position m (0..255) of tile t; false where it is not stored.
template <int E>
__device__ __forceinline__ bool out_pixel(const Params& p, const Tile& t, int m, int& y, int& x) {
  if (p.raster) {
    const int rr = t.y0 + m;
    y = rr / p.pitch;
    x = rr - y * p.pitch - E;
  } else {
    y = t.y0 + m / TILE_W;
    x = t.x0 + m % TILE_W;
  }
  return y < p.H && x >= 0 && x < p.W;
}

// ---- the producer -----------------------------------------------------------

// A position in the weight ring: the slot, the parity of its next phase, and
// (consumers) the slot of the step before, freed once its products are done.
struct RingPos {
  int slot = 0;
  unsigned phase = 0;
  int prev = -1;
};

// Warp 0, one lane: the weight tiles of one conv of taps x C_in / 32 steps,
// column block nb of nbs, through the ring, S consecutive steps a slot (a
// slot's first wait passes: parity 1).
template <int NT, int S = 1>
__device__ __forceinline__ void push_conv(const Params& p, const int8_t* w, int taps, int nb, int nbs,
                                          uint8_t* ring, uint64_t* full, uint64_t* empty, RingPos& r) {
  constexpr int B_TILE = NT * 32;
  const int steps = taps * (p.cin / 32);
  for (int st = 0; st < steps; st += S) {
    mbar_wait(empty + r.slot, r.phase ^ 1u);
    mbar_arrive_expect_tx(full + r.slot, S * B_TILE);
#pragma unroll
    for (int k = 0; k < S; ++k)
      bulk_g2s(ring + (r.slot * S + k) * B_TILE, w + ((size_t)(st + k) * nbs + nb) * B_TILE, B_TILE, full + r.slot);
    if (++r.slot == p.stages) {
      r.slot = 0;
      r.phase ^= 1u;
    }
  }
}

// X4's weight stream: every (tile, column block, step), in the order the consumers take them.
template <int NT>
__device__ __forceinline__ void load_weights(const Params& p, uint8_t* ring, uint64_t* full,
                                             uint64_t* empty) {
  RingPos r;
  const int nbs = p.cout / NT;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x)
    for (int nb = 0; nb < nbs; ++nb) push_conv<NT>(p, p.w, 9, nb, nbs, ring, full, empty, r);
}

// Warps 1-3 (tid 0..95): tile t's window of halo e (positions, plane as it
// has them) from src into w, quantized on the way (S = bf16 / float: static
// reciprocals inv, or DYN the sample's scale s and its reciprocal rs; BATCH
// 16-byte loads in flight a thread) or as codes (S = int8_t, by cp.async with
// zero fill).  Outside the image the staged codes are zero.
template <typename S, bool DYN, int E, int BATCH = 16>
__device__ __forceinline__ void stage_window(const Params& p, const void* src, const Tile& t, int e,
                                             int positions, int plane, uint8_t* w, const float* inv,
                                             float s, float rs, int tid) {
  const int planes = p.cin / 16;
  const int items = positions * planes;
  if constexpr (std::is_same<S, int8_t>::value) {
    const int8_t* x = static_cast<const int8_t*>(src);
    for (int i = tid; i < items; i += STAGERS) {
      const int pos = i / planes, g = i - pos * planes;
      int gy, gx;
      const bool in = window_pixel<E>(p, t, e, pos, gy, gx);
      const int8_t* from = in ? x + (((size_t)t.n * p.H + gy) * p.W + gx) * p.cin + g * 16 : x;
      cp_async16_zfill(w + g * plane + pos * 16, from, in ? 16 : 0);
    }
    cp_async_wait_all();
  } else {
    constexpr int L = Act<S>::LOADS;
    constexpr int WB = BATCH / L;  // staging items in flight a thread
    const S* x = static_cast<const S*>(src);
    for (int i0 = tid; i0 < items; i0 += WB * STAGERS) {
      uint4 raw[WB][L];
#pragma unroll
      for (int u = 0; u < WB; ++u) {
#pragma unroll
        for (int l = 0; l < L; ++l) raw[u][l] = make_uint4(0, 0, 0, 0);
        const int i = i0 + u * STAGERS;
        if (i >= items) continue;
        const int pos = i / planes, g = i - pos * planes;
        int gy, gx;
        if (window_pixel<E>(p, t, e, pos, gy, gx)) {
          const uint4* from =
              reinterpret_cast<const uint4*>(x + (((size_t)t.n * p.H + gy) * p.W + gx) * p.cin + g * 16);
#pragma unroll
          for (int l = 0; l < L; ++l) raw[u][l] = __ldg(from + l);
        }
      }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int i = i0 + u * STAGERS;
        if (i >= items) continue;
        const int pos = i / planes, g = i - pos * planes;
        float f[16];
        Act<S>::to_floats(raw[u], f);
        unsigned q[16];
        if constexpr (DYN) {
          codes8_div(f, s, rs, q);
        } else {
#pragma unroll
          for (int c = 0; c < 16; ++c) q[c] = code8(f[c], inv[16 * g + c]);
        }
        *reinterpret_cast<int4*>(w + g * plane + pos * 16) =
            make_int4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                      pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
      }
    }
  }
  fence_proxy_async();
}

// X4's stagers: each tile's window into window buffer k % nwin (k: the
// block's tile count), for every column block.
template <typename S, bool DYN>
__device__ __forceinline__ void stage_windows(const Params& p, uint8_t* win, const float* inv,
                                              uint64_t* wfull, uint64_t* wempty, int tid) {
  int k = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
    const int buf = k % p.nwin;
    const Tile t = tile_of(p, tile);
    mbar_wait(wempty + buf, ((k / p.nwin) & 1) ^ 1u);
    float s = 0.f, rs = 0.f;
    if constexpr (DYN) {
      s = sample_scale(__ldg(p.scale + t.n));
      rs = __frcp_rn(s);
    }
    stage_window<S, DYN, 1>(p, p.x, t, 1, p.positions, p.plane, win + buf * p.win_bytes, inv, s, rs, tid);
    mbar_arrive(wfull + buf);
  }
}

// ---- the consumers ------------------------------------------------------------

// act(A(acc) * sc + b); ACCB: A(acc) rounds to bf16.  Both switches are
// template parameters, so that the unrolled epilogue holds no branch and its
// conversions and loads interleave.
template <bool ACCB, int ACT>
__device__ __forceinline__ float dequant(int acc, float sc, float b, float slope) {
  float v = __int2float_rn(acc);
  if constexpr (ACCB) v = __bfloat162float(__float2bfloat16_rn(v));
  v = __fadd_rn(__fmul_rn(v, sc), b);
  if constexpr (ACT == ACT_RELU) v = fmaxf(v, 0.f);
  if constexpr (ACT == ACT_LEAKY) v = v >= 0.f ? v : __fmul_rn(slope, v);
  return v;
}

// act(A(acc) * sc + b) of two channels; ACCB rounds both sums to bf16 in one
// packed conversion (each rounded to nearest even, as one at a time).
template <bool ACCB, int ACT>
__device__ __forceinline__ float2 dequant2(int a0, int a1, float2 sc, float2 b) {
  float2 v = make_float2(__int2float_rn(a0), __int2float_rn(a1));
  if constexpr (ACCB) v = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
  v = make_float2(__fadd_rn(__fmul_rn(v.x, sc.x), b.x), __fadd_rn(__fmul_rn(v.y, sc.y), b.y));
  if constexpr (ACT == ACT_RELU) v = make_float2(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f));
  return v;
}

// Two channels of x (type T) as floats, and back.
template <typename T>
struct Pair;

template <>
struct Pair<bf16> {
  using Raw = unsigned;
  __device__ static __forceinline__ Raw load(const void* base, size_t i) {
    return __ldg(reinterpret_cast<const unsigned*>(static_cast<const bf16*>(base) + i));
  }
  __device__ static __forceinline__ float2 floats(Raw r) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  }
  __device__ static __forceinline__ void store(void* base, size_t i, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + i) = __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Pair<float> {
  using Raw = float2;
  __device__ static __forceinline__ Raw load(const void* base, size_t i) {
    return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(base) + i));
  }
  __device__ static __forceinline__ float2 floats(Raw r) { return r; }
  __device__ static __forceinline__ void store(void* base, size_t i, float a, float b) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + i) = make_float2(a, b);
  }
};

__device__ __forceinline__ uint16_t code_pair(float a, float b, float ia, float ib) {
  return (uint16_t)((code8(a, ia) & 0xFFu) | ((code8(b, ib) & 0xFFu) << 8));
}

__device__ __forceinline__ uint32_t sel4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// Where a thread's sums of M tile j go: for each of its 2 output positions
// the element offset of the pixel's channel 0 (0 where the position is not
// stored, so that loads stay inside the tensor) and whether it is stored.
struct Spots {
  size_t off[2];
  bool in[2];
  template <int E>
  __device__ static __forceinline__ Spots at(const Params& p, const Tile& t, int cw, int j) {
    Spots sp;
    const int r0 = ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int y, x;
      sp.in[h] = out_pixel<E>(p, t, (cw * MT + j) * TILE_W + r0 + 8 * h, y, x);
      sp.off[h] = sp.in[h] ? (((size_t)t.n * p.H + y) * p.W + x) * p.cout : 0;
    }
    return sp;
  }
};

// For M tile j and each channel-pair group n8 of column block nb: st(stored?,
// offset, channel, v0, v1, h, buffer) with v = act(A(acc) * sc + b) for the
// 2 positions (sc, b from sf, bias); ld(offset, h, buffer) loads what st
// reads, one group ahead (two buffers), so that a group's loads are in
// flight while the group before is computed and stored.
template <int NT, bool DYN, bool ACCB, int ACT, typename LoadF, typename StoreF>
__device__ __forceinline__ void for_pairs(const Params& p, const int (&acc)[NT / 2], const Spots& sp, int nb,
                                          float s, const float* sf, const float* bias, LoadF&& ld, StoreF&& st) {
  const int c0 = nb * NT + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) ld(sp.off[h] + c0, h, 0);
#pragma unroll
  for (int n8 = 0; n8 < NT / 8; ++n8) {
    const int co = c0 + n8 * 8;
    if (n8 + 1 < NT / 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) ld(sp.off[h] + co + 8, h, (n8 + 1) & 1);
    }
    float2 sc = __ldg(reinterpret_cast<const float2*>(sf + co));
    if constexpr (DYN) sc = make_float2(__fmul_rn(sc.x, s), __fmul_rn(sc.y, s));
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + co));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = n8 * 4 + h * 2;
      st(sp.in[h], sp.off[h] + co, co, dequant<ACCB, ACT>(acc[i], sc.x, b.x, p.slope),
         dequant<ACCB, ACT>(acc[i + 1], sc.y, b.y, p.slope), h, n8 & 1);
    }
  }
}

// The codes of M tile j, column block nb, at the scales 1 / inv_out, 8 bytes
// a store: for each 32 channels, the 4 lanes of a quad trade their code
// pairs so that lane q stores channels 8 q .. 8 q + 7 of them (a quad fills
// a 32-byte sector).  ld / fx as for_pairs' ld / st, fx returning the pair
// to code.
template <int NT, bool DYN, bool ACCB, int ACT, typename LoadF, typename F>
__device__ __forceinline__ void store_codes(const Params& p, const int (&acc)[NT / 2], const Spots& sp, int nb,
                                            float s, const float* sf, const float* bias, const float* inv_out,
                                            int8_t* out, LoadF&& ld, F&& fx) {
  const int q = threadIdx.x & 3;
  const int c0 = nb * NT + 2 * q;
#pragma unroll
  for (int h = 0; h < 2; ++h) ld(sp.off[h] + c0, h, 0);
#pragma unroll
  for (int k4 = 0; k4 < NT / 32; ++k4) {
    uint32_t w[2][4];  // this lane's code pairs of n8 = 4 k4 + u
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n8 = 4 * k4 + u;
      const int co = c0 + n8 * 8;
      if (n8 + 1 < NT / 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) ld(sp.off[h] + co + 8, h, (n8 + 1) & 1);
      }
      float2 sc = __ldg(reinterpret_cast<const float2*>(sf + co));
      if constexpr (DYN) sc = make_float2(__fmul_rn(sc.x, s), __fmul_rn(sc.y, s));
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + co));
      const float i0 = inv_out[co], i1 = inv_out[co + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = n8 * 4 + h * 2;
        const float2 v = fx(sp.in[h], sp.off[h] + co, dequant<ACCB, ACT>(acc[i], sc.x, b.x, p.slope),
                            dequant<ACCB, ACT>(acc[i + 1], sc.y, b.y, p.slope), h, n8 & 1);
        w[h][u] = code_pair(v.x, v.y, i0, i1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // round x: lane q receives from lane q ^ x its pair of n8 = 4 k4 + q
      uint32_t got[4];
      got[0] = sel4(w[h][0], w[h][1], w[h][2], w[h][3], q);
#pragma unroll
      for (int x = 1; x < 4; ++x)
        got[x] = __shfl_xor_sync(0xffffffffu, sel4(w[h][0], w[h][1], w[h][2], w[h][3], q ^ x), x);
      // the pair of lane r came in round q ^ r
      const uint32_t lo = sel4(got[0], got[1], got[2], got[3], q) | (sel4(got[0], got[1], got[2], got[3], q ^ 1) << 16);
      const uint32_t hi = sel4(got[0], got[1], got[2], got[3], q ^ 2) | (sel4(got[0], got[1], got[2], got[3], q ^ 3) << 16);
      if (sp.in[h])
        *reinterpret_cast<uint2*>(out + sp.off[h] + nb * NT + (4 * k4 + q) * 8) = make_uint2(lo, hi);
    }
  }
}

// The combine epilogues of M tile j, x (and out) of type T.
template <int NT, bool DYN, bool ACCB, typename T>
__device__ __forceinline__ void combine(const Params& p, const int (&acc)[NT / 2], const Spots& sp, int nb,
                                        float s, const float* inv_out) {
  using P = Pair<T>;
  const float res = 0.1f;
  typename P::Raw xv[2][2];  // [buffer][position]
  if (p.epi == EPI_LIGHT) {
    for_pairs<NT, DYN, ACCB, ACT_NONE>(
        p, acc, sp, nb, s, p.sf, p.bias, [&](size_t o, int h, int u) { xv[u][h] = P::load(p.xr, o); },
        [&](bool in, size_t o, int, float v0, float v1, int h, int u) {
          const float2 x = P::floats(xv[u][h]);
          if (in) P::store(p.out_x, o, __fadd_rn(x.x, __fmul_rn(res, v0)), __fadd_rn(x.y, __fmul_rn(res, v1)));
        });
  } else if (p.epi == EPI_DIFF_B) {  // t, and the codes of d = t - x
    store_codes<NT, DYN, ACCB, ACT_NONE>(
        p, acc, sp, nb, s, p.sf, p.bias, inv_out, p.out_q,
        [&](size_t o, int h, int u) { xv[u][h] = P::load(p.xr, o); },
        [&](bool in, size_t o, float v0, float v1, int h, int u) {
          const float2 x = P::floats(xv[u][h]);
          if (in) *reinterpret_cast<float2*>(p.out_f + o) = make_float2(v0, v1);
          return make_float2(__fsub_rn(v0, x.x), __fsub_rn(v1, x.y));
        });
  } else {  // EPI_DIFF_D: x + 0.1 * ((d + u) + t), d = t - x
    float2 tv[2][2];
    for_pairs<NT, DYN, ACCB, ACT_NONE>(
        p, acc, sp, nb, s, p.sf, p.bias,
        [&](size_t o, int h, int u) {
          xv[u][h] = P::load(p.xr, o);
          tv[u][h] = __ldg(reinterpret_cast<const float2*>(p.t_in + o));
        },
        [&](bool in, size_t o, int, float v0, float v1, int h, int u) {
          const float2 x = P::floats(xv[u][h]), t = tv[u][h];
          const float s0 = __fadd_rn(__fadd_rn(__fsub_rn(t.x, x.x), v0), t.x);
          const float s1 = __fadd_rn(__fadd_rn(__fsub_rn(t.y, x.y), v1), t.y);
          if (in) P::store(p.out_x, o, __fadd_rn(x.x, __fmul_rn(res, s0)), __fadd_rn(x.y, __fmul_rn(res, s1)));
        });
  }
}

// ld and fx of the epilogues that load nothing and code the dequantized pair as it is
struct NoLoad {
  __device__ __forceinline__ void operator()(size_t, int, int) const {}
};
struct Same {
  __device__ __forceinline__ float2 operator()(bool, size_t, float v0, float v1, int, int) const {
    return make_float2(v0, v1);
  }
};

// The epilogue of column block nb, M tile by M tile, straight from the
// registers: the kinds the kernel's input S takes (float32 out and codes
// from x; codes and the combines from codes; float32 out in the dynamic form).
template <typename S, int NT, bool DYN, bool ACCB, int ACT>
__device__ __forceinline__ void epilogue_of(const Params& p, const int (&acc)[MT][NT / 2], const Tile& t,
                                            int nb, float s, const float* inv_out, int cw) {
  auto f32 = [&](const Spots& sp, const int(&a)[NT / 2]) {
    for_pairs<NT, DYN, ACCB, ACT>(p, a, sp, nb, s, p.sf, p.bias, NoLoad{},
                                  [&](bool in, size_t o, int, float v0, float v1, int, int) {
                                    if (in) *reinterpret_cast<float2*>(p.out_f + o) = make_float2(v0, v1);
                                  });
  };
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const Spots sp = Spots::at<1>(p, t, cw, j);
    if constexpr (DYN) {
      f32(sp, acc[j]);
    } else if constexpr (std::is_same<S, int8_t>::value) {
      if (p.epi == EPI_CODES) {
        store_codes<NT, DYN, ACCB, ACT>(p, acc[j], sp, nb, s, p.sf, p.bias, inv_out, p.out_q, NoLoad{}, Same{});
      } else if constexpr (ACT == ACT_NONE) {
        if (p.xr_f32) combine<NT, DYN, ACCB, float>(p, acc[j], sp, nb, s, inv_out);
        else combine<NT, DYN, ACCB, bf16>(p, acc[j], sp, nb, s, inv_out);
      }
    } else if (p.epi == EPI_F32) {
      f32(sp, acc[j]);
    } else {
      store_codes<NT, DYN, ACCB, ACT>(p, acc[j], sp, nb, s, p.sf, p.bias, inv_out, p.out_q, NoLoad{}, Same{});
    }
  }
}

template <typename S, int NT, bool DYN, bool ACCB>
__device__ __forceinline__ void epilogue_acc(const Params& p, const int (&acc)[MT][NT / 2], const Tile& t,
                                             int nb, float s, const float* inv_out, int cw) {
  if (p.act == ACT_RELU) epilogue_of<S, NT, DYN, ACCB, ACT_RELU>(p, acc, t, nb, s, inv_out, cw);
  else if (p.act == ACT_LEAKY) epilogue_of<S, NT, DYN, ACCB, ACT_LEAKY>(p, acc, t, nb, s, inv_out, cw);
  else epilogue_of<S, NT, DYN, ACCB, ACT_NONE>(p, acc, t, nb, s, inv_out, cw);
}

template <typename S, int NT, bool DYN>
__device__ __forceinline__ void epilogue(const Params& p, const int (&acc)[MT][NT / 2], const Tile& t,
                                         int nb, float s, const float* inv_out, int cw) {
  if (p.acc_bf16) epilogue_acc<S, NT, DYN, true>(p, acc, t, nb, s, inv_out, cw);
  else epilogue_acc<S, NT, DYN, false>(p, acc, t, nb, s, inv_out, cw);
}

// The rows of tile t's outputs in x (and t) into the L2 ahead of the
// combine epilogues' loads (one thread): a bulk prefetch a row segment.
template <int E>
__device__ __forceinline__ void prefetch_rows(const Params& p, const Tile& t) {
  const size_t ex = p.xr_f32 ? 4 : 2;
  const int r_end = p.raster ? t.y0 + TILE_M : 0;
  for (int r = 0;; ++r) {
    int y, x0, x1;
    if (p.raster) {  // positions [y0, y0 + TILE_M) of the padded raster, row by row
      const int start = t.y0 + r * p.pitch - (r == 0 ? 0 : t.y0 % p.pitch);
      if (start >= r_end) break;
      y = start / p.pitch;
      x0 = max(start - y * p.pitch - E, 0);
      x1 = min(min(r_end - y * p.pitch - E, p.W), p.W);
    } else {
      if (r == TILE_ROWS) break;
      y = t.y0 + r;
      x0 = t.x0;
      x1 = min(t.x0 + TILE_W, p.W);
    }
    if (y >= p.H) break;
    if (x1 <= x0) continue;
    const size_t first = (((size_t)t.n * p.H + y) * p.W + x0) * p.cout;
    const unsigned n = (unsigned)((x1 - x0) * p.cout);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(static_cast<const uint8_t*>(p.xr) + first * ex),
                 "r"((unsigned)(n * ex))
                 : "memory");
    if (p.t_in != nullptr)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p.t_in + first), "r"(n * 4u) : "memory");
  }
}

// The K steps of one conv of KW x KW taps over C_in into acc (2 M tiles of
// 64 positions), from the resident window of halo e at wa (shared address of
// the consumer's first M tile, planes plane bytes apart; the second M tile
// dm bytes on) and the weight ring.  A tap (ky, kx) moves the descriptor's
// start by (ky - KW/2 + e) * pitch + kx - KW/2 + E positions, the two halves
// of a 32-channel step are a plane apart.  One wgmma group stays in flight;
// the ring slot of the step before is released once its products are done.
// other: the consumer's other sums, whose registers stay fenced.  S steps a
// ring slot (C_in / 32 a multiple of S), one wgmma group.
template <int NT, int KW, int E, int S = 1>
__device__ __forceinline__ void conv_steps(const Params& p, int (&acc)[MT][NT / 2], int (&other)[MT][NT / 2],
                                           uint32_t wa, int e, int plane, uint32_t dm, uint32_t ring_a,
                                           uint64_t* full, uint64_t* empty, RingPos& r, bool leader) {
  constexpr int B_TILE = NT * 32, K = KW / 2;
  // the descriptors' constant fields; shared addresses stay below 2^18
  const uint64_t a_hi = desc(0, plane, 128), b_hi = desc(0, NT * 16, 128);
  const int chunks = p.cin / 32;
#pragma unroll 1
  for (int tap = 0; tap < KW * KW; ++tap) {
    const int ky = tap / KW;
    uint32_t a = wa + ((ky - K + e) * p.pitch + tap - KW * ky - K + E) * 16;  // the tap's first K step
#pragma unroll 1
    for (int chunk = 0; chunk < chunks; chunk += S, a += 2 * S * plane) {
      mbar_wait(full + r.slot, r.phase);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        fence_acc(acc[j]);
        fence_acc(other[j]);
      }
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const uint64_t db = b_hi | ((ring_a + (r.slot * S + k) * B_TILE) >> 4);
#pragma unroll
        for (int j = 0; j < MT; ++j) wgmma_s8<NT>(acc[j], a_hi | ((a + 2 * k * plane + j * dm) >> 4), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the products of the step before are done: its ring slot is free
      if (r.prev >= 0 && leader) mbar_arrive(empty + r.prev);
      r.prev = r.slot;
      if (++r.slot == p.stages) {
        r.slot = 0;
        r.phase ^= 1u;
      }
    }
  }
}

// Waits for the last products of the consumer's convs and releases their
// last ring slot.
template <int N>
__device__ __forceinline__ void conv_done(int (&acc)[MT][N], int (&other)[MT][N], uint64_t* empty, RingPos& r,
                                          bool leader) {
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    fence_acc(acc[j]);
    fence_acc(other[j]);
  }
  if (leader) mbar_arrive(empty + r.prev);
  r.prev = -1;
}

template <int N>
__device__ __forceinline__ void zero_acc(int (&acc)[MT][N]) {
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[j][i] = 0;
}

// Consumer warpgroup cw (0 or 1): M tiles 2 cw and 2 cw + 1 of every tile,
// every column block, from the resident window and the weight ring.
template <typename S, int NT, bool DYN>
__device__ __forceinline__ void consume(const Params& p, const uint8_t* win, const uint8_t* ring,
                                        uint64_t* full, uint64_t* empty, uint64_t* wfull,
                                        uint64_t* wempty, const float* inv_out, int cw) {
  constexpr int ACC = NT / 2;  // s32 sums a thread holds per M tile
  const bool leader = (threadIdx.x & 31) == 0;  // one arrival a warp
  const int nbs = p.cout / NT;
  const uint32_t ring_a = smem_addr(ring);
  // M tile j's first staged position, and the second M tile's offset, in bytes
  const int rowp = p.raster ? TILE_W : pitch4<1>();
  const uint32_t m0 = cw * MT * rowp * 16, dm = rowp * 16;
  RingPos r;
  int k = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
    const int buf = k % p.nwin;
    const Tile t = tile_of(p, tile);
    const float s = DYN ? sample_scale(__ldg(p.scale + t.n)) : 0.f;
    if (p.xr != nullptr && threadIdx.x == 128) prefetch_rows<1>(p, t);
    mbar_wait(wfull + buf, (k / p.nwin) & 1);
    const uint32_t wa = smem_addr(win) + buf * p.win_bytes + m0;
    for (int nb = 0; nb < nbs; ++nb) {
      int acc[MT][ACC];
      zero_acc(acc);
      conv_steps<NT, 3, 1>(p, acc, acc, wa, 1, p.plane, dm, ring_a, full, empty, r, leader);
      conv_done(acc, acc, empty, r, leader);
      if (leader && nb == nbs - 1) mbar_arrive(wempty + buf);  // the tile's window is read
      epilogue<S, NT, DYN>(p, acc, t, nb, s, inv_out, cw);
    }
  }
}

// ---- the kernel -----------------------------------------------------------------

template <typename S, bool DYN, int NT>
__global__ void __launch_bounds__(THREADS, 1) conv3_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* wfull = empty + MAX_STAGES;
  uint64_t* wempty = wfull + WINDOWS;
  uint8_t* win = smem + BAR_BYTES;
  uint8_t* ring = smem + p.ring_off;
  float* inv_in = reinterpret_cast<float*>(smem + p.vec_off);
  float* inv_out = inv_in + CIN_MAX;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS * 4);
    }
    for (int i = 0; i < WINDOWS; ++i) {
      mbar_init(wfull + i, STAGERS);
      mbar_init(wempty + i, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the reciprocals, as JAX's 1.0 / s
  if constexpr (!DYN && !std::is_same<S, int8_t>::value)
    for (int i = threadIdx.x; i < p.cin; i += THREADS) inv_in[i] = __frcp_rn(__ldg(p.scale + i));
  if (p.s_out != nullptr)
    for (int i = threadIdx.x; i < p.cout; i += THREADS) inv_out[i] = __frcp_rn(__ldg(p.s_out + i));
  __syncthreads();
  if (threadIdx.x == 0) load_weights<NT>(p, ring, full, empty);
  else if (threadIdx.x >= 32 && threadIdx.x < 128)
    stage_windows<S, DYN>(p, win, inv_in, wfull, wempty, threadIdx.x - 32);
  else if (threadIdx.x >= 128)
    consume<S, NT, DYN>(p, win, ring, full, empty, wfull, wempty, inv_out, threadIdx.x / 128 - 1);
}

// ---- X1 and X2: the static blocks of the XLA int8 forward ------------------------------
//
// xla_block_kernel<FORM>, one launch of a block; windows at a pitch with E
// padding columns (the halo of the launch's widest conv):
//   PAIR_CODES (X1's first, E = 2): one window of halo 2 of bf16 x, quantized
//     with 1 / s_x while staged, for both first convs: conv3 (w, 9 taps) ->
//     the codes of relu(y) at s_a into out_q, then conv5 (w2, 25 taps) -> at
//     s_b into out_q2; 128 output channels a column block;
//   PAIR_LIGHT53 (X1's second, E = 2): ta's window of halo 2 (x, two buffers)
//     and tb's of halo 1 (x2, one buffer); per column block of 64 channels
//     conv5 over ta (w) into one set of sums and conv3 over tb (w2) into
//     another, then id * xr + res * (a + b) from the registers;
//   ONE_CODES (X2's first, E = 1): conv3 over bf16 x -> the codes of relu(y) at s_t;
//   ONE_LIGHT (X2's second, E = 1): conv3 over t's codes, xr + res * u;
//   PAIR_CODES_I8 (X1u's first): PAIR_CODES over a window of int8 codes (x);
//   PAIR_LIGHT53_UP (X1u's second): PAIR_LIGHT53 with skip + res * (a + b),
//     the skip formed from the LR map (lr) in the combine, 4 x 64 tiles.
// The producer warpgroup gives up registers to the consumers (setmaxnreg),
// and the epilogues run over both M tiles of a consumer a channel group at a
// time, so that the per-channel vectors are loaded once for 4 positions.

__host__ __device__ constexpr bool pair_codes(int form) {
  return form == PAIR_CODES || form == PAIR_CODES_I8;
}

__host__ __device__ constexpr bool pair_light53(int form) {
  return form == PAIR_LIGHT53 || form == PAIR_LIGHT53_UP;
}

__host__ __device__ constexpr int form_nt(int form) {
  return pair_light53(form) ? 64 : 128;
}

__host__ __device__ constexpr int form_s(int form) {
  return pair_light53(form) ? X_S64 : X_S128;
}

__host__ __device__ constexpr int form_e(int form) {
  return pair_codes(form) || pair_light53(form) ? 2 : 1;
}

// Warp 0, one lane: the weight tiles in the consumers' order.
template <int FORM>
__device__ __forceinline__ void xla_weights(const Params& p, uint8_t* ring, uint64_t* full, uint64_t* empty) {
  constexpr int NT = form_nt(FORM), S = form_s(FORM);
  RingPos r;
  const int nbs = p.cout / NT;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    if constexpr (pair_codes(FORM)) {
      push_conv<NT, S>(p, p.w, 9, 0, nbs, ring, full, empty, r);
      push_conv<NT, S>(p, p.w2, 25, 0, nbs, ring, full, empty, r);
    } else if constexpr (pair_light53(FORM)) {
      for (int nb = 0; nb < nbs; ++nb) {
        push_conv<NT, S>(p, p.w, 25, nb, nbs, ring, full, empty, r);
        push_conv<NT, S>(p, p.w2, 9, nb, nbs, ring, full, empty, r);
      }
    } else {
      push_conv<NT, S>(p, p.w, 9, 0, nbs, ring, full, empty, r);
    }
  }
}

// Warps 1-3: each tile's windows (bf16 x quantized on the way in X1's and
// X2's codes launches, int8 codes in the others).  The light53 forms stage
// tb's (one buffer) after ta's, once the tile before has read it.
template <int FORM>
__device__ __forceinline__ void xla_windows(const Params& p, uint8_t* win, uint8_t* win2, const float* inv,
                                            uint64_t* wfull, uint64_t* wempty, int tid) {
  constexpr int E = form_e(FORM);
  using S = typename std::conditional<FORM == PAIR_CODES || FORM == ONE_CODES, bf16, int8_t>::type;
  int k = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
    const int buf = k % p.nwin;
    const Tile t = tile_of(p, tile);
    mbar_wait(wempty + buf, ((k / p.nwin) & 1) ^ 1u);
    stage_window<S, false, E, 8>(p, p.x, t, E, p.positions, p.plane, win + buf * p.win_bytes, inv, 0.f, 0.f, tid);
    mbar_arrive(wfull + buf);
    if constexpr (pair_light53(FORM)) {  // tb's window, one buffer: barriers WINDOWS
      mbar_wait(wempty + WINDOWS, (k & 1) ^ 1u);
      stage_window<int8_t, false, E>(p, p.x2, t, 1, p.positions2, p.plane2, win2, inv, 0.f, 0.f, tid);
      mbar_arrive(wfull + WINDOWS);
    }
  }
}

// The 4 lanes of a quad trade their words: lane q holds w[u], its word of
// channel group u of 4; it gets every lane's word of group q, in the order
// of the lanes (lane r's in round q ^ r).
__device__ __forceinline__ uint4 quad_trade(const uint32_t (&w)[4], int q) {
  uint32_t got[4];
  got[0] = sel4(w[0], w[1], w[2], w[3], q);
#pragma unroll
  for (int x = 1; x < 4; ++x) got[x] = __shfl_xor_sync(0xffffffffu, sel4(w[0], w[1], w[2], w[3], q ^ x), x);
  return make_uint4(sel4(got[0], got[1], got[2], got[3], q), sel4(got[0], got[1], got[2], got[3], q ^ 1),
                    sel4(got[0], got[1], got[2], got[3], q ^ 2), sel4(got[0], got[1], got[2], got[3], q ^ 3));
}

// The codes of relu(A(acc) * sf + bias) at 1 / inv of both M tiles of the
// consumer, 8 bytes a store as store_codes leaves them; sf, bias and inv in
// shared memory.
template <int E, bool ACCB>
__device__ __forceinline__ void xla_codes_out(const Params& p, const int (&acc)[MT][64], const Tile& t, int cw,
                                              const float* sf, const float* bias, const float* inv, int8_t* out) {
  Spots sp[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) sp[j] = Spots::at<E>(p, t, cw, j);
  const int q = threadIdx.x & 3;
  const int c0 = 2 * q;
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4) {
    uint32_t w[MT][2][4];  // this lane's code pairs of n8 = 4 k4 + u
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int co = c0 + (4 * k4 + u) * 8;
      const float2 sc = *reinterpret_cast<const float2*>(sf + co);
      const float2 b = *reinterpret_cast<const float2*>(bias + co);
      const float2 iv = *reinterpret_cast<const float2*>(inv + co);
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = (4 * k4 + u) * 4 + h * 2;
          const float2 v = dequant2<ACCB, ACT_RELU>(acc[j][i], acc[j][i + 1], sc, b);
          w[j][h][u] = code_pair(v.x, v.y, iv.x, iv.y);
        }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // lane q: the code pairs of n8 = 4 k4 + q, lane by lane
        const uint4 v = quad_trade(w[j][h], q);
        if (sp[j].in[h])
          *reinterpret_cast<uint2*>(out + sp[j].off[h] + (4 * k4 + q) * 8) = make_uint2(v.x | (v.y << 16), v.z | (v.w << 16));
      }
  }
}

// x of column block nb of the consumer's outputs (bf16 pairs, xr), into registers.
template <int NT, int E>
__device__ __forceinline__ void load_x(const Params& p, const Tile& t, int cw, int nb, unsigned (&xv)[MT][2][NT / 8]) {
  const int c0 = nb * NT + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const Spots sp = Spots::at<E>(p, t, cw, j);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n8 = 0; n8 < NT / 8; ++n8) xv[j][h][n8] = Pair<bf16>::load(p.xr, sp.off[h] + c0 + n8 * 8);
  }
}

// The combine of column block nb of both M tiles: TWO (X1) bf16(id * x +
// res * (a + b)), a = A(acc_a) * sf + bias, b = A(acc_b) * sf2 + bias2;
// else (X2) bf16(x + res * a).  Every product and add rounded on its own;
// x in registers (load_x); vec: sf, bias, sf2, bias2 in shared memory, X_C
// floats each.  32 channels a step, as xla_codes_out's.  X2's quad trades its
// bf16 pairs, as there, so that a lane stores 16 bytes of a pixel (with 4
// bytes a lane its stores took a third of the launch); X1's stores its pairs
// as they are (the trade measured slower there).
template <int NT, int E, bool ACCB, bool TWO>
__device__ __forceinline__ void xla_combine(const Params& p, const int (&acc_a)[MT][NT / 2],
                                            const int (&acc_b)[MT][NT / 2],
                                            const unsigned (&xv)[MT][2][NT / 8], const float* vec, const Tile& t,
                                            int cw, int nb) {
  using P = Pair<bf16>;
  Spots sp[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) sp[j] = Spots::at<E>(p, t, cw, j);
  const int q = threadIdx.x & 3;
  const int c0 = nb * NT + q * 2;
#pragma unroll
  for (int g = 0; g < NT / 32; ++g) {
    uint32_t w[MT][2][4];  // X2: this lane's bf16 pairs of n8 = 4 g + l
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int n8 = 4 * g + l;
      const int co = c0 + n8 * 8;
      const float2 sa = *reinterpret_cast<const float2*>(vec + co);
      const float2 ba = *reinterpret_cast<const float2*>(vec + X_C + co);
      float2 sb = sa, bb = ba;
      if constexpr (TWO) {
        sb = *reinterpret_cast<const float2*>(vec + 2 * X_C + co);
        bb = *reinterpret_cast<const float2*>(vec + 3 * X_C + co);
      }
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = n8 * 4 + h * 2;
          const float2 x = P::floats(xv[j][h][n8]);
          float2 u = dequant2<ACCB, ACT_NONE>(acc_a[j][i], acc_a[j][i + 1], sa, ba);
          float o0, o1;
          if constexpr (TWO) {
            const float2 v = dequant2<ACCB, ACT_NONE>(acc_b[j][i], acc_b[j][i + 1], sb, bb);
            u = make_float2(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y));
            o0 = __fadd_rn(__fmul_rn(p.id, x.x), __fmul_rn(p.res, u.x));
            o1 = __fadd_rn(__fmul_rn(p.id, x.y), __fmul_rn(p.res, u.y));
          } else {
            o0 = __fadd_rn(x.x, __fmul_rn(p.res, u.x));
            o1 = __fadd_rn(x.y, __fmul_rn(p.res, u.y));
          }
          if constexpr (TWO) {
            if (sp[j].in[h]) P::store(p.out_x, sp[j].off[h] + co, o0, o1);
          } else {
            const __nv_bfloat162 o = __floats2bfloat162_rn(o0, o1);
            w[j][h][l] = *reinterpret_cast<const uint32_t*>(&o);
          }
        }
    }
    if constexpr (!TWO) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // lane q: channels 8 q .. 8 q + 7 of the group
          const uint4 v = quad_trade(w[j][h], q);
          if (sp[j].in[h])
            *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out_x) + sp[j].off[h] + nb * NT + 32 * g + 8 * q) = v;
        }
    }
  }
}

// ---- X1u's identity leg from the LR map (PAIR_LIGHT53_UP) ----

// Where a consumer thread's skip comes from.  Its outputs of M tile j lie in
// HR row Y_j = y0 + MT cw + j, those of position h (0, 1) in column X_h =
// x0 + r0 + 8 h; Y_0 is even and so is f, so Y_0 + 1 is no multiple of f and
// both rows read LR rows k = Y_0 / f and k1 = min(k + 1, lr_h - 1), with
// the row phases r_j = Y_j - f k; column X_h reads m_h = X_h / f and m1_h =
// min(m_h + 1, lr_w - 1) at phase s_h.  Rows and columns past the map (not
// stored) read its last row or column.  The weights are K3's table's.
struct UpSpots {
  const unsigned* row;  // LR row k of sample n, as bf16 pairs
  int dk;               // words from row k to row k1
  int col[2], dm[2];    // words to column m_h, and from m_h to m1_h
  float wr0[MT], wr1[MT], ws0[2], ws1[2];

  __device__ static __forceinline__ UpSpots at(const Params& p, const Tile& t, int cw) {
    UpSpots u;
    constexpr int WORDS = X_C / 2;  // words a pixel
    const int f = p.factor, y = t.y0 + MT * cw, kk = y / f;
    const int k = min(kk, p.lr_h - 1);
    u.row = reinterpret_cast<const unsigned*>(p.lr) + ((size_t)t.n * p.lr_h + k) * p.lr_w * WORDS;
    u.dk = (min(k + 1, p.lr_h - 1) - k) * p.lr_w * WORDS;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int r = y + j - kk * f;
      u.wr0[j] = __ldg(p.wt + r);
      u.wr1[j] = __ldg(p.wt + f + r);
    }
    const int r0 = ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = t.x0 + r0 + 8 * h, mm = x / f, m = min(mm, p.lr_w - 1), s = x - mm * f;
      u.col[h] = m * WORDS;
      u.dm[h] = (min(m + 1, p.lr_w - 1) - m) * WORDS;
      u.ws0[h] = __ldg(p.wt + s);
      u.ws1[h] = __ldg(p.wt + f + s);
    }
    return u;
  }

  // The LR words of channel pair nb NT + 8 n8 + 2 (lane % 4) of both
  // positions h: (k, m_h), (k1, m_h), (k, m1_h), (k1, m1_h) at v[4 h ..].
  template <int NT>
  __device__ __forceinline__ void load(int nb, int n8, unsigned (&v)[8]) const {
    const unsigned* base = row + nb * (NT / 2) + 4 * n8 + (threadIdx.x & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned* a = base + col[h];
      v[4 * h] = __ldg(a);
      v[4 * h + 1] = __ldg(a + dk);
      v[4 * h + 2] = __ldg(a + dm[h]);
      v[4 * h + 3] = __ldg(a + dk + dm[h]);
    }
  }
};

// a * w0 + b * w1, each product and the sum rounded on its own (K3's float32 lerp)
__device__ __forceinline__ float lerp_rn(float a, float w0, float b, float w1) {
  return __fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1));
}

// The LR rows and columns that tile t's skip reads, into the L2 (one thread).
__device__ __forceinline__ void prefetch_lr(const Params& p, const Tile& t) {
  const int f = p.factor;
  const int k0 = min(t.y0 / f, p.lr_h - 1), k1 = min((t.y0 + TILE_ROWS - 1) / f + 1, p.lr_h - 1);
  const int m0 = min(t.x0 / f, p.lr_w - 1), m1 = min((t.x0 + TILE_W - 1) / f + 1, p.lr_w - 1);
  const unsigned bytes = (unsigned)(m1 - m0 + 1) * X_C * 2;
  for (int k = k0; k <= k1; ++k)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p.lr + (((size_t)t.n * p.lr_h + k) * p.lr_w + m0) * X_C),
                 "r"(bytes)
                 : "memory");
}

// X1u's combine of column block nb of both M tiles: bf16(skip + res * (a +
// b)), a and b as xla_combine's, the skip of each output from the LR words
// lv of its channel group n8 (loaded a group ahead: lv takes group n8 + 1
// once group n8's words are read), every product and add rounded on its
// own.
template <int NT, int E, bool ACCB>
__device__ __forceinline__ void xla_combine_up(const Params& p, const int (&acc_a)[MT][NT / 2],
                                               const int (&acc_b)[MT][NT / 2], unsigned (&lv)[8],
                                               const UpSpots& us, const float* vec, const Tile& t, int cw, int nb) {
  using P = Pair<bf16>;
  Spots sp[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) sp[j] = Spots::at<E>(p, t, cw, j);
  const int c0 = nb * NT + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n8 = 0; n8 < NT / 8; ++n8) {
    const int co = c0 + n8 * 8;
    float2 y[2][4];  // fl(h * id) of each position's 4 neighbours
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 v = P::floats(lv[i]);
      y[i / 4][i % 4] = make_float2(__fmul_rn(v.x, p.id), __fmul_rn(v.y, p.id));
    }
    if (n8 + 1 < NT / 8) us.load<NT>(nb, n8 + 1, lv);
    const float2 sa = *reinterpret_cast<const float2*>(vec + co);
    const float2 ba = *reinterpret_cast<const float2*>(vec + X_C + co);
    const float2 sb = *reinterpret_cast<const float2*>(vec + 2 * X_C + co);
    const float2 bb = *reinterpret_cast<const float2*>(vec + 3 * X_C + co);
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = n8 * 4 + h * 2;
        float2 u = dequant2<ACCB, ACT_NONE>(acc_a[j][i], acc_a[j][i + 1], sa, ba);
        const float2 v = dequant2<ACCB, ACT_NONE>(acc_b[j][i], acc_b[j][i + 1], sb, bb);
        u = make_float2(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y));
        // the H pass at columns m and m1 (row phase r_j), then the W pass (column phase s_h)
        const float2 *q = y[h];
        const float s0 = lerp_rn(lerp_rn(q[0].x, us.wr0[j], q[1].x, us.wr1[j]), us.ws0[h],
                                 lerp_rn(q[2].x, us.wr0[j], q[3].x, us.wr1[j]), us.ws1[h]);
        const float s1 = lerp_rn(lerp_rn(q[0].y, us.wr0[j], q[1].y, us.wr1[j]), us.ws0[h],
                                 lerp_rn(q[2].y, us.wr0[j], q[3].y, us.wr1[j]), us.ws1[h]);
        if (sp[j].in[h])
          P::store(p.out_x, sp[j].off[h] + co, __fadd_rn(s0, __fmul_rn(p.res, u.x)), __fadd_rn(s1, __fmul_rn(p.res, u.y)));
      }
  }
}

// The codes epilogue under the launch's accumulator rounding.
template <int E>
__device__ __forceinline__ void xla_codes(const Params& p, const int (&acc)[MT][64], const Tile& t, int cw,
                                          const float* sf, const float* bias, const float* inv, int8_t* out) {
  if (p.acc_bf16) xla_codes_out<E, true>(p, acc, t, cw, sf, bias, inv, out);
  else xla_codes_out<E, false>(p, acc, t, cw, sf, bias, inv, out);
}

// Consumer warpgroup cw of launch FORM.
// vec: the X_VECS vectors of X_C floats in shared memory (xla_block_kernel).
template <int FORM>
__device__ __forceinline__ void xla_consume(const Params& p, const uint8_t* win, const uint8_t* win2,
                                            const uint8_t* ring, uint64_t* full, uint64_t* empty, uint64_t* wfull,
                                            uint64_t* wempty, const float* vec, int cw) {
  const float *inv_a = vec + X_C, *inv_b = vec + 2 * X_C, *dq = vec + 3 * X_C;
  constexpr int NT = form_nt(FORM), ACC = NT / 2, E = form_e(FORM), S = form_s(FORM);
  const bool leader = (threadIdx.x & 31) == 0;
  const uint32_t ring_a = smem_addr(ring);
  const int rowp = p.raster ? TILE_W : pitch4<E>();
  const uint32_t m0 = cw * MT * rowp * 16, dm = rowp * 16;
  RingPos r;
  int k = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
    const int buf = k % p.nwin;
    const Tile t = tile_of(p, tile);
    if ((FORM == PAIR_LIGHT53 || FORM == ONE_LIGHT) && threadIdx.x == 128) prefetch_rows<E>(p, t);
    if (FORM == PAIR_LIGHT53_UP && threadIdx.x == 128) prefetch_lr(p, t);
    mbar_wait(wfull + buf, (k / p.nwin) & 1);
    const uint32_t wa = smem_addr(win) + buf * p.win_bytes + m0;
    if constexpr (pair_codes(FORM)) {
      int acc[MT][ACC];
      zero_acc(acc);
      conv_steps<NT, 3, E, S>(p, acc, acc, wa, E, p.plane, dm, ring_a, full, empty, r, leader);
      conv_done(acc, acc, empty, r, leader);
      xla_codes<E>(p, acc, t, cw, dq, dq + X_C, inv_a, p.out_q);
      zero_acc(acc);
      conv_steps<NT, 5, E, S>(p, acc, acc, wa, E, p.plane, dm, ring_a, full, empty, r, leader);
      conv_done(acc, acc, empty, r, leader);
      if (leader) mbar_arrive(wempty + buf);  // the tile's window is read
      xla_codes<E>(p, acc, t, cw, dq + 2 * X_C, dq + 3 * X_C, inv_b, p.out_q2);
    } else if constexpr (FORM == PAIR_LIGHT53) {
      const uint32_t wb = smem_addr(win2) + m0;
      const int nbs = p.cout / NT;
      for (int nb = 0; nb < nbs; ++nb) {
        int acc_a[MT][ACC], acc_b[MT][ACC];
        zero_acc(acc_a);
        zero_acc(acc_b);
        conv_steps<NT, 5, E, S>(p, acc_a, acc_b, wa, E, p.plane, dm, ring_a, full, empty, r, leader);
        unsigned xv[MT][2][NT / 8];  // x of the combine, in flight while conv3's products run
        load_x<NT, E>(p, t, cw, nb, xv);
        if (nb == 0) mbar_wait(wfull + WINDOWS, k & 1);
        conv_steps<NT, 3, E, S>(p, acc_b, acc_a, wb, 1, p.plane2, dm, ring_a, full, empty, r, leader);
        conv_done(acc_a, acc_b, empty, r, leader);
        if (leader && nb == nbs - 1) {  // both windows of the tile are read
          mbar_arrive(wempty + buf);
          mbar_arrive(wempty + WINDOWS);
        }
        if (p.acc_bf16) xla_combine<NT, E, true, true>(p, acc_a, acc_b, xv, dq, t, cw, nb);
        else xla_combine<NT, E, false, true>(p, acc_a, acc_b, xv, dq, t, cw, nb);
      }
    } else if constexpr (FORM == PAIR_LIGHT53_UP) {
      const uint32_t wb = smem_addr(win2) + m0;
      const int nbs = p.cout / NT;
      const UpSpots us = UpSpots::at(p, t, cw);
      for (int nb = 0; nb < nbs; ++nb) {
        int acc_a[MT][ACC], acc_b[MT][ACC];
        zero_acc(acc_a);
        zero_acc(acc_b);
        conv_steps<NT, 5, E, S>(p, acc_a, acc_b, wa, E, p.plane, dm, ring_a, full, empty, r, leader);
        unsigned lv[8];  // the skip's LR words of channel group 0, in flight while conv3's products run
        us.load<NT>(nb, 0, lv);
        if (nb == 0) mbar_wait(wfull + WINDOWS, k & 1);
        conv_steps<NT, 3, E, S>(p, acc_b, acc_a, wb, 1, p.plane2, dm, ring_a, full, empty, r, leader);
        conv_done(acc_a, acc_b, empty, r, leader);
        if (leader && nb == nbs - 1) {  // both windows of the tile are read
          mbar_arrive(wempty + buf);
          mbar_arrive(wempty + WINDOWS);
        }
        if (p.acc_bf16) xla_combine_up<NT, E, true>(p, acc_a, acc_b, lv, us, dq, t, cw, nb);
        else xla_combine_up<NT, E, false>(p, acc_a, acc_b, lv, us, dq, t, cw, nb);
      }
    } else {
      int acc[MT][ACC];
      unsigned xv[MT][2][NT / 8];  // ONE_LIGHT: x of the combine, in flight while the products run
      if constexpr (FORM == ONE_LIGHT) load_x<NT, E>(p, t, cw, 0, xv);
      zero_acc(acc);
      conv_steps<NT, 3, E, S>(p, acc, acc, wa, E, p.plane, dm, ring_a, full, empty, r, leader);
      conv_done(acc, acc, empty, r, leader);
      if (leader) mbar_arrive(wempty + buf);
      if constexpr (FORM == ONE_CODES) {
        xla_codes<E>(p, acc, t, cw, dq, dq + X_C, inv_a, p.out_q);
      } else {
        if (p.acc_bf16) xla_combine<NT, E, true, false>(p, acc, acc, xv, dq, t, cw, 0);
        else xla_combine<NT, E, false, false>(p, acc, acc, xv, dq, t, cw, 0);
      }
    }
  }
}

template <int FORM>
__global__ void __launch_bounds__(THREADS, 1) xla_block_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + X_STAGES;
  uint64_t* wfull = empty + X_STAGES;  // [WINDOWS] the first window's buffers, then tb's
  uint64_t* wempty = wfull + WINDOWS + 1;
  uint8_t* win = smem + X_BAR_BYTES;
  uint8_t* win2 = smem + p.win2_off;
  uint8_t* ring = smem + p.ring_off;
  // 1 / s_x, 1 / s_a (X2: s_t), 1 / s_b (the codes forms), then sf, bias, sf2, bias2
  float* vec = reinterpret_cast<float*>(smem + p.vec_off);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS * 4);
    }
    for (int i = 0; i <= WINDOWS; ++i) {
      mbar_init(wfull + i, STAGERS);
      mbar_init(wempty + i, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < X_C; i += THREADS) {
    if constexpr (pair_codes(FORM) || FORM == ONE_CODES) {  // the reciprocals, as JAX's 1.0 / s
      if (FORM != PAIR_CODES_I8) vec[i] = __frcp_rn(__ldg(p.scale + i));
      vec[X_C + i] = __frcp_rn(__ldg(p.s_out + i));
      if (pair_codes(FORM)) vec[2 * X_C + i] = __frcp_rn(__ldg(p.s_out2 + i));
    }
    vec[3 * X_C + i] = __ldg(p.sf + i);
    vec[4 * X_C + i] = __ldg(p.bias + i);
    if (pair_codes(FORM) || pair_light53(FORM)) {
      vec[5 * X_C + i] = __ldg(p.sf2 + i);
      vec[6 * X_C + i] = __ldg(p.bias2 + i);
    }
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // the producer warpgroup, with few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) xla_weights<FORM>(p, ring, full, empty);
    else if (threadIdx.x >= 32) xla_windows<FORM>(p, win, win2, vec, wfull, wempty, threadIdx.x - 32);
  } else {  // the consumers, with the registers it gave up
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    xla_consume<FORM>(p, win, win2, ring, full, empty, wfull, wempty, vec, threadIdx.x / 128 - 1);
  }
}

// ---- host side ------------------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

// The tiling, the windows and the ring of p (n, H, W, cin, cout set) for a
// launch whose widest conv has halo E: a window of halo E in two buffers
// where they leave a ring of MIN_STAGES slots (else one), and, where halo2
// >= 0, a second window of halo halo2 in one buffer; nt output channels a
// column block, vec_bytes of vectors after the ring.  The raster tiling
// where W is not a multiple of 64, two windows of it fit so and raster_ok
// (else 4 x 64 tiles).  false where
// the windows and a ring of 2 slots do not fit shared memory.  The
// mbarriers (bar_bytes) come first, the ring holds at most max_stages slots.
bool geometry(Params& p, int E, int halo2, int nt, int vec_bytes, int bar_bytes = BAR_BYTES,
              int max_stages = MAX_STAGES, bool raster_ok = true) {
  const long long planes = p.cin / 16, b_tile = nt * 32;
  auto pitch_of = [&](bool raster) { return raster ? p.W + 2 * E : TILE_W + 2 * E; };
  auto positions_of = [&](bool raster, int e) {
    const long long pitch = pitch_of(raster);
    return raster ? TILE_M + 2 * e * pitch + 2 * E : (TILE_ROWS + 2 * e) * pitch;
  };
  // +16 bytes a plane: a pixel's planes fall in different bank groups
  auto bytes_of = [&](long long positions) { return planes * (positions * 16 + 16); };
  // ring slots left beside nwin windows (and the second window)
  auto slots = [&](bool raster, int nwin) {
    const long long wins = bar_bytes + nwin * bytes_of(positions_of(raster, E)) +
                           (halo2 >= 0 ? bytes_of(positions_of(raster, halo2)) : 0);
    return (SMEM_MAX - (wins + 127) / 128 * 128 - vec_bytes) / b_tile;
  };
  p.raster = raster_ok && p.W % TILE_W != 0 && slots(true, WINDOWS) >= MIN_STAGES;
  p.pitch = pitch_of(p.raster);
  p.nwin = slots(p.raster, WINDOWS) >= MIN_STAGES ? WINDOWS : 1;
  const long long ring = slots(p.raster, p.nwin);
  if (ring < 2) return false;
  p.positions = (int)positions_of(p.raster, E);
  p.plane = p.positions * 16 + 16;
  p.win_bytes = (int)planes * p.plane;
  p.stages = ring < max_stages ? (int)ring : max_stages;
  p.win2_off = bar_bytes + p.nwin * p.win_bytes;
  int end = p.win2_off;
  if (halo2 >= 0) {
    p.positions2 = (int)positions_of(p.raster, halo2);
    p.plane2 = p.positions2 * 16 + 16;
    end += (int)planes * p.plane2;
  }
  p.ring_off = (end + 127) / 128 * 128;
  p.vec_off = p.ring_off + p.stages * (int)b_tile;
  p.smem = p.vec_off + vec_bytes;
  long long tiles;
  if (p.raster) {
    p.tiles_w = 1;
    tiles = ((long long)p.H * p.pitch + TILE_M - 1) / TILE_M;
  } else {
    p.tiles_w = (p.W + TILE_W - 1) / TILE_W;
    tiles = (long long)p.tiles_w * ((p.H + TILE_ROWS - 1) / TILE_ROWS);
  }
  if (tiles * p.n > (1LL << 30)) return false;
  p.tiles_a_sample = (int)tiles;
  p.tiles = (int)tiles * p.n;
  return true;
}

template <typename S, bool DYN, int NT>
int launch_conv(Params p, cudaStream_t st) {
  if (!geometry(p, 1, -1, NT, (CIN_MAX + (p.s_out != nullptr ? p.cout : 0)) * 4)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3_kernel<S, DYN, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  conv3_kernel<S, DYN, NT><<<grid, THREADS, p.smem, st>>>(p);
  return (int)cudaGetLastError();
}

// One launch of X1, X1u or X2: the window of halo E in two buffers, tb's of
// halo 1 beside ta's in the light53 launches, the vectors after the ring;
// X1u's light53 launch on 4 x 64 tiles (its skip takes a tile's rows).
template <int FORM>
int launch_xla(Params p, cudaStream_t st) {
  // a ring slot: NT x 32 bytes a K step, form_s steps
  const int halo2 = pair_light53(FORM) ? 1 : -1, slot = form_nt(FORM) * form_s(FORM);
  if (!geometry(p, form_e(FORM), halo2, slot, X_VECS * X_C * 4, X_BAR_BYTES, X_STAGES, FORM != PAIR_LIGHT53_UP))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(xla_block_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  xla_block_kernel<FORM><<<grid, THREADS, p.smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename S, bool DYN>
int dispatch_nt(const Params& p, int nt, cudaStream_t st) {
  if (nt == 128) return launch_conv<S, DYN, 128>(p, st);
  if (nt == 96) return launch_conv<S, DYN, 96>(p, st);
  return launch_conv<S, DYN, 64>(p, st);
}

// Each sample's abs-max of x (n, h, wd, cin) accumulated into amax[n].
template <typename T>
int absmax(const T* x, float* amax, int n, int h, int wd, int cin, cudaStream_t st) {
  const long long vecs = (long long)h * wd * cin * (long long)sizeof(T) / 16;
  const long long per = (long long)ABS_THREADS * 8;
  const unsigned bx = (unsigned)(vecs / per + 1 < 1024 ? vecs / per + 1 : 1024);
  sample_absmax_kernel<T><<<dim3(bx, 1, (unsigned)n), ABS_THREADS, 0, st>>>(x, amax, vecs);
  return (int)cudaGetLastError();
}

// The conv of p on x of kind src (SRC_*): static scales in p.scale, or
// (dyn) the samples' abs-maxes there.
int run(const Params& p, int src, bool dyn, int nt, cudaStream_t st) {
  if (dyn) return src == SRC_F32 ? dispatch_nt<float, true>(p, nt, st) : dispatch_nt<bf16, true>(p, nt, st);
  if (src == SRC_I8) return dispatch_nt<int8_t, false>(p, nt, st);
  return src == SRC_F32 ? dispatch_nt<float, false>(p, nt, st) : dispatch_nt<bf16, false>(p, nt, st);
}

bool shape_ok(int n, int h, int wd, int cin, int cout, int nt, int act) {
  return cin % 32 == 0 && cin > 0 && cin <= CIN_MAX && (nt == 64 || nt == 96 || nt == 128) &&
         cout % nt == 0 && cout > 0 && n > 0 && h > 0 && wd > 0 && act >= ACT_NONE && act <= ACT_LEAKY;
}

Params base_params(const void* x, const float* scale, const int8_t* w, const float* sf,
                   const float* bias, int n, int h, int wd, int cin, int cout, int acc_bf16, int act,
                   float slope) {
  Params p{};
  p.x = x;
  p.scale = scale;
  p.w = w;
  p.sf = sf;
  p.bias = bias;
  p.n = n;
  p.H = h;
  p.W = wd;
  p.cin = cin;
  p.cout = cout;
  p.acc_bf16 = acc_bf16;
  p.act = act;
  p.slope = slope;
  p.epi = EPI_F32;
  return p;
}

}  // namespace

extern "C" {

// The one entry of the kernel.  x: (n, h, w, cin) of kind src (0 bf16, 1
// float32: quantized while staged; 2 int8 codes); w: the int8 weights
// repacked to [9][cin/32][cout/nt][2][nt][16], nt 64, 96 or 128 (the output
// channels of a column block, which the packing chose); sf, bias: (cout,)
// float32.  dyn (DYN_*): NONE static scales, s_in (cin,) for bf16 / float32
// x, null for codes; FULL the per-sample dynamic form (amax: n floats of
// scratch, zeroed here, then each sample's abs-max of x, then the conv at
// it, sf being the weight scales s_w); ABSMAX only the abs-maxes, accumulated
// into amax (a banded frame's first step; the caller zeroes it); GIVEN the
// conv at amax as given (the frame's).  The dynamic forms take bf16 /
// float32 x and the F32 epilogue.  epi (EPI_*) and its arrays, each (n, h,
// w, cout): F32 out_f; CODES s_out, out_q; LIGHT xr, out_x; DIFF_B xr,
// s_out, out_f, out_q; DIFF_D xr, t_in, out_x; xr and out_x bf16 (xr_f32 ==
// 0) or float32; LIGHT and the DIFF forms take codes and act 0.  cin a
// multiple of 32 up to 256, cout a multiple of nt, every pointer 16-byte
// aligned, all tensors contiguous (the Python wrapper checks).  act: 0 none,
// 1 relu, 2 leaky with slope.  Returns the CUDA error code of the launches
// (0 = success).
int iek_int8_conv3x(const void* x, int src, const float* s_in, float* amax, int dyn, const int8_t* w,
                    const float* sf, const float* bias, const float* s_out, const void* xr, int xr_f32,
                    const float* t_in, float* out_f, int8_t* out_q, void* out_x, int epi, int n, int h,
                    int wd, int cin, int cout, int nt, int acc_bf16, int act, float slope,
                    cudaStream_t st) {
  if (!shape_ok(n, h, wd, cin, cout, nt, act) || src < SRC_BF16 || src > SRC_I8 || dyn < DYN_NONE ||
      dyn > DYN_GIVEN || epi < EPI_F32 || epi > EPI_DIFF_D ||
      (dyn == DYN_NONE && (src == SRC_I8) != (s_in == nullptr)) ||
      (dyn != DYN_NONE && (src == SRC_I8 || s_in != nullptr || amax == nullptr || epi != EPI_F32)) ||
      (epi == EPI_F32 && src == SRC_I8) ||
      (epi != EPI_CODES && epi != EPI_F32 && (act != ACT_NONE || src != SRC_I8)))
    return (int)cudaErrorInvalidValue;
  const bool codes = epi == EPI_CODES || epi == EPI_DIFF_B;
  if ((codes && (s_out == nullptr || out_q == nullptr || cout > COUT_CODES_MAX)) ||
      (epi != EPI_CODES && epi != EPI_F32 && xr == nullptr) ||
      ((epi == EPI_F32 || epi == EPI_DIFF_B) && out_f == nullptr && dyn != DYN_ABSMAX) ||
      ((epi == EPI_LIGHT || epi == EPI_DIFF_D) && out_x == nullptr) ||
      (epi == EPI_DIFF_D && t_in == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dyn == DYN_FULL || dyn == DYN_ABSMAX) {
    if (dyn == DYN_FULL) {
      const cudaError_t err = cudaMemsetAsync(amax, 0, (size_t)n * sizeof(float), st);
      if (err != cudaSuccess) return (int)err;
    }
    const int code = src == SRC_F32 ? absmax<float>(static_cast<const float*>(x), amax, n, h, wd, cin, st)
                                    : absmax<bf16>(static_cast<const bf16*>(x), amax, n, h, wd, cin, st);
    if (code != 0 || dyn == DYN_ABSMAX) return code;
  }
  Params p = base_params(x, dyn == DYN_NONE ? s_in : amax, w, sf, bias, n, h, wd, cin, cout, acc_bf16,
                         act, slope);
  p.epi = epi;
  p.s_out = codes ? s_out : nullptr;
  p.xr = xr;
  p.xr_f32 = xr_f32;
  p.t_in = t_in;
  p.out_f = out_f;
  p.out_q = out_q;
  p.out_x = out_x;
  return run(p, src, dyn != DYN_NONE, nt, st);
}

// X1, the static Light53 block of the XLA int8 forward, in two launches of
// xla_block_kernel: PAIR_CODES (x bf16 (n, h, w, 128) quantized with 1 /
// act[0] while staged; ta, tb: the int8 codes of both branches at act[1],
// act[2]) and PAIR_LIGHT53 (out bf16 = id * x + res * (a + b)).  act: float32
// [3][128]; wa1 (3 x 3) and wb1 (5 x 5) packed with nt 128, wa2 (5 x 5) and
// wb2 (3 x 3) with nt 64 ([taps][cin/32][cout/nt][2][nt][16]); the "sf" and
// biases (128,) float32.  acc_bf16 as iek_int8_conv3x's.  Pointers 16-byte
// aligned, tensors contiguous.  Returns the CUDA error code (0 = success).
int iek_light53_int8_xla(const void* x, const float* act, const int8_t* wa1, const float* sa1, const float* ba1,
                         const int8_t* wa2, const float* sa2, const float* ba2, const int8_t* wb1,
                         const float* sb1, const float* bb1, const int8_t* wb2, const float* sb2,
                         const float* bb2, int8_t* ta, int8_t* tb, void* out, int n, int h, int wd, int c,
                         int acc_bf16, float res_scale, float identity_scale, cudaStream_t st) {
  if (c != X_C || n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  Params a = base_params(x, act, wa1, sa1, ba1, n, h, wd, c, c, acc_bf16, ACT_RELU, 0.f);
  a.s_out = act + c;
  a.out_q = ta;
  a.w2 = wb1;
  a.sf2 = sb1;
  a.bias2 = bb1;
  a.s_out2 = act + 2 * c;
  a.out_q2 = tb;
  const int code = launch_xla<PAIR_CODES>(a, st);
  if (code != 0) return code;
  Params b = base_params(ta, nullptr, wa2, sa2, ba2, n, h, wd, c, c, acc_bf16, ACT_NONE, 0.f);
  b.x2 = tb;
  b.w2 = wb2;
  b.sf2 = sb2;
  b.bias2 = bb2;
  b.xr = x;
  b.out_x = out;
  b.res = res_scale;
  b.id = identity_scale;
  return launch_xla<PAIR_LIGHT53>(b, st);
}

// X2, the static Light block, in two launches of xla_block_kernel: ONE_CODES
// (t: the codes of relu(conv3(q(x))) at act[1], x quantized with 1 / act[0])
// and ONE_LIGHT (out bf16 = x + res * u).  act: float32 [2][128]; w1, w2
// packed with nt 128; the rest as iek_light53_int8_xla.
int iek_light_int8_xla(const void* x, const float* act, const int8_t* w1, const float* s1, const float* b1,
                       const int8_t* w2, const float* s2, const float* b2, int8_t* t, void* out, int n, int h,
                       int wd, int c, int acc_bf16, float res_scale, cudaStream_t st) {
  if (c != X_C || n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  Params a = base_params(x, act, w1, s1, b1, n, h, wd, c, c, acc_bf16, ACT_RELU, 0.f);
  a.s_out = act + c;
  a.out_q = t;
  const int code = launch_xla<ONE_CODES>(a, st);
  if (code != 0) return code;
  Params b = base_params(t, nullptr, w2, s2, b2, n, h, wd, c, c, acc_bf16, ACT_NONE, 0.f);
  b.xr = x;
  b.out_x = out;
  b.res = res_scale;
  return launch_xla<ONE_LIGHT>(b, st);
}

// X1u, IEK_INT8_UPQ's first HR Light53 block, in two launches of
// xla_block_kernel: PAIR_CODES_I8 (xq: int8 (n, f h, f wd, 128), the codes
// of the bf16 x f of h_lr (K3q); ta, tb: the codes of both branches at
// act[0], act[1]) and PAIR_LIGHT53_UP (out bf16 (n, f h, f wd, 128) = skip +
// res * (a + b), the skip the float32 x f of identity * h_lr formed from
// h_lr, bf16 (n, h, wd, 128), with K3's float32 weights wt: 2 f floats on
// the device, 1 - r/f at wt[r], r/f at wt[f + r]).  act: float32 [2][128];
// f even; weights packed as X1's; acc_bf16 as iek_int8_conv3x's.  Pointers
// 16-byte aligned, tensors contiguous.  Returns the CUDA error code (0 =
// success).
int iek_light53_int8_xla_upq(const int8_t* xq, const void* h_lr, const float* act, const int8_t* wa1,
                             const float* sa1, const float* ba1, const int8_t* wa2, const float* sa2,
                             const float* ba2, const int8_t* wb1, const float* sb1, const float* bb1,
                             const int8_t* wb2, const float* sb2, const float* bb2, int8_t* ta, int8_t* tb,
                             void* out, const float* wt, int n, int h, int wd, int c, int factor, int acc_bf16,
                             float res_scale, float identity_scale, cudaStream_t st) {
  if (c != X_C || n <= 0 || h <= 0 || wd <= 0 || factor < 2 || factor % 2 != 0 ||
      (long long)h * wd * factor * factor > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int H = factor * h, W = factor * wd;
  Params a = base_params(xq, nullptr, wa1, sa1, ba1, n, H, W, c, c, acc_bf16, ACT_RELU, 0.f);
  a.s_out = act;
  a.out_q = ta;
  a.w2 = wb1;
  a.sf2 = sb1;
  a.bias2 = bb1;
  a.s_out2 = act + c;
  a.out_q2 = tb;
  const int code = launch_xla<PAIR_CODES_I8>(a, st);
  if (code != 0) return code;
  Params b = base_params(ta, nullptr, wa2, sa2, ba2, n, H, W, c, c, acc_bf16, ACT_NONE, 0.f);
  b.x2 = tb;
  b.w2 = wb2;
  b.sf2 = sb2;
  b.bias2 = bb2;
  b.lr = static_cast<const bf16*>(h_lr);
  b.wt = wt;
  b.lr_h = h;
  b.lr_w = wd;
  b.factor = factor;
  b.out_x = out;
  b.res = res_scale;
  b.id = identity_scale;
  return launch_xla<PAIR_LIGHT53_UP>(b, st);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
