// int8 residual blocks of the didbl int8 path, for sm_90a, on the s8 tensor
// cores (wgmma), with static (calibrated) or dynamic (per-window) activation
// scales, bf16 or float32 activations.
//
// Replaces the Pallas TPU kernels in image_enhance_keras_tpu/ops/pallas/int8_blocks.py:
//   * iek_light53_int8[_dynamic] <- light53_int8 (_light53_int8_kernel):
//       xq = q(x, s0)
//       ta = q(relu(dq(conv3(xq, wa1), s0, sa1) + ba1), s1)
//       tb = q(relu(dq(conv5(xq, wb1), s0, sb1) + bb1), s2)
//       out = 0.9*x + 0.1*((dq(conv5(ta, wa2), s1, sa2) + ba2) + (dq(conv3(tb, wb2), s2, sb2) + bb2))
//   * iek_light_int8[_dynamic]   <- light_int8 (_light_int8_kernel):
//       t = q(relu(dq(conv3(q(x, s0), w1), s0, s1w) + b1), s1)
//       out = x + 0.1*(dq(conv3(t, w2), s1, s2w) + b2)
// and, for the XLA int8 forward of the JAX package (models/didbl_pallas.py
// _light53_i8_xla_dyn: XLA convolutions there, no Pallas kernel;
// ops/cuda/int8_xla.py wraps it):
//   * iek_light53_int8_xla_dyn (X3): per-sample dynamic scales s = max(amax,
//     1e-6) / 127.0 of x and of each branch intermediate over the whole
//     sample, dequant scale s_w[cout] * s.
// X1, X1u and X2, the static per-channel blocks of that forward
// (_light53_i8_xla, _light53_i8_xla_upfused, _light_i8_xla), run on
// csrc/int8_conv.cu's persistent, warp-specialised xla_block_kernel.  There,
// as in X3, the accumulator is float(acc) or bf16(float(acc))
// (IEK_INT8_ACC), and every product and add of the dequant and the combine
// is rounded on its own (no FMA), as JAX computes these ops one at a time:
//   out = bf16(0.9*x + 0.1*(a + b)).
// K4/K5 compute dq(acc, s, sw) + b = fma(float(acc), s * sw[cout], b), sw the
// per-output-channel weight scales; the convs are s8 x s8 -> s32, NHWC,
// C = 128.  x and out are bf16 or float32 (the template's T); the identity and
// the epilogue run in float32, rounded once to T (to nearest even).
//
// Rounding points.  Each float step is one rounded operation, written out
// (__fmul_rn, __fadd_rn, __fmaf_rn), where XLA evaluates the TPU
// kernel's jaxpr on the CPU (interpret mode, the reference the tests hold
// to): it fuses dq(acc) + b and the epilogue's first product with its add
// into FMAs, out = fma(0.9, x, 0.1*(a+b)) and fma(0.1, u, x).  Build without
// --use_fast_math.  The plain PyTorch versions round at the same points, so
// kernels and plain versions agree bit for bit.
//
// Static scales (act_scales, the serving path): q(v, s) = clamp(rint(v *
// (1/s)), -127, 127), rint to even.  The TPU kernel's halo'd windows then give
// exactly a whole-image SAME chain on the codes, so the window partition does
// not matter, and a block is two launches over the whole image:
//   A. quantize x while staging it, the first conv(s) (Light53: conv3, then
//      conv5 over the same staged window), dequant + bias + relu,
//      requantize, int8 scratch (N,H,W,C);
//   B. second convs over the scratch maps (out-of-image reads are 0, which
//      is the TPU kernel's border mask followed by quantization), dequant
//      and the residual epilogue.
//
// Dynamic scales (act_scales=None): every TPU window quantizes with its own
// abs-max, s = max(amax, 1e-12) * float(1/127) (XLA folds the division by
// the constant into that product) and q(v, s) = clamp(rint(v / s), -127,
// 127) of the rounded IEEE quotient (codes8_div rounds it without a
// division).  The windows are th x tw tiles of the image padded
// to multiples of 8 (th, tw passed in); the input abs-max spans the window
// the TPU DMAs, rows [r0-halo, r0+th+halo) and columns [c0-halo,
// c0+tw+win_pad-halo) with win_pad = 2*halo rounded up to 8, more columns
// than the convs read; each branch's intermediate is computed VALID over the
// window's extended ring (e = 2 for Light53, whose branch b uses the inner
// ring of 1; e = 1 for Light), masked to zero outside the image, and
// requantized with its own abs-max.  One intermediate pixel near a window
// edge so has different codes in the two windows that hold it.  Four
// launches per block:
//   1. each window's input abs-max, as float bits by atomicMax (non-negative
//      floats order as their bits do, so any order gives the same max);
//   2. the ring launch: per window, the first conv(s) over the extended ring
//      (th+2e) x (tw+2e), from x quantized with the window's scale, into a
//      window-major float32 ring [window][th+2e][tw+2e][C] (each window holds
//      its own copy of the ring), with the window's intermediate abs-max by
//      atomicMax.  Its M tiles are 64 consecutive raster positions of the
//      ring, staged at a pitch of (ring width + KW - 1) columns, so that a
//      tap moves the descriptor's start by ky * pitch + kx pixels and the
//      tiles overhang the ring by about 1.05x (4 x 64 tiles: 1.28x at the
//      LR windows' 100-column rings, 1.45x at the HR windows' 132); the
//      positions in the pitch's KW - 1 extra columns are computed but neither
//      stored nor counted.  Rings wider than PITCH_MAX - KW + 1 columns are
//      cut into column segments.  The rings leave through shared memory as
//      16-byte stores, 256 contiguous bytes a position;
//   3. the requantization pass: every ring value quantized once with its
//      window's scale, into int8 code rings of the same shape (stream order
//      gives it every window's finished abs-max);
//   4. per window, the second conv(s) VALID over the code rings, staged by
//      cp.async exactly as the static launch B stages its scratch, dequantized
//      with the window's intermediate scales, and the epilogue.
// X3 reuses the static template, in four launches: each sample's abs-max
// of x; both first convs from x quantized with its sample's scale into
// float32 intermediates (N,H,W,C) with their
// per-sample abs-maxes (atomicMax), the float32 pairs stored straight from
// the registers so that they drain while the block's second first conv
// runs; the requantization pass, which turns each intermediate into int8
// codes once at its sample's scale (codes8_div; stream order hands it the
// finished abs-maxes: a global reduction sits between the two convs, so the
// intermediate cannot stay on chip); both second convs over the codes,
// staged by cp.async as the static launch B stages its scratch, and the combine.
//
// The intermediate is stored, not recomputed: the first convs run once, for
// 2 x 4 bytes of traffic per ring value and 1 + 1 more for its code (at the
// HR tail's (9,384,384,128) the two float32 rings are 2 x 0.74 GB), where
// recomputing them would double their products.  The requantization pass
// reads each float32 value once, where staging them through the second
// convs' 5x5 and 3x3 halos would read and quantize each about 3.6 times.

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
// SM:
//   * A: the quantized input window with its halo, staged once for all taps
//     (int8 codes by cp.async; bf16 or float32 values, x or a dynamic
//     scratch, by batched loads quantized on the way), as 8 planes of 16
//     channels, each plane [row][col][16 bytes].  A tap (ky, kx) moves the
//     descriptor's start by ky window rows and kx * 16 bytes; the two 16-byte
//     halves of a 32-channel step are two planes apart (the descriptor's
//     leading byte offset).
//   * B: the weights, repacked once to [tap][cin/32][2][cout][16] so that each
//     (tap, 32-channel step) is one contiguous 4 KB tile, streamed through a
//     ring of 6 tiles with cp.async, 4 tiles ahead of the products; one
//     wgmma group stays in flight while the next is issued.
//   * Epilogues go through shared memory: the sums' fragments are written
//     there and leave (or, for x, arrive) as coalesced 16-byte pieces, in
//     passes of 256 bytes of channels a pixel (bf16: one pass, float32 and
//     the dynamic float32 rings: two).
//   * Static quantization uses no conversion instruction (code8): those run
//     at a quarter of the float rate.
//   * Ragged edges: out-of-image window positions are zero codes and the
//     epilogue masks pixels outside the image (96 = 64 + 32 columns); a
//     dynamic window's tiles stop at its th x tw, its ring's raster
//     positions at the ring.
// Launch B of Light53 parks the dequantized branch-a sums in shared memory
// (128 KB) while the branch-b conv runs, so 128 sums a thread stay live.
// What is left on the table (PERF.md): the staging and the epilogues do not
// overlap the products (one block per SM), the weight stream shares the
// shared-memory bandwidth with the operand reads, and the dynamic ring
// launch stages and quantizes about 3 input pixels a position (halo rows of
// the raster band).

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
// bytes of channels a pixel that one epilogue pass stages (bf16: all 128
// channels; float32: 64)
constexpr int PASS = 256;
// staged output tiles (in the window's space once the conv is done), bytes
// per pixel: +16 keeps the 8 pixels a warp writes in different banks
constexpr int PITCH8 = C + 16;
constexpr int PITCH16 = PASS + 16;
// shared memory: [window][weight ring][scales, biases][extra]; extra is the
// staged codes (launch A), the parked branch-a sums (the second launch of
// Light53) or x (the second launch of Light); X3's launch 2 stores its
// float32 sums from the registers and needs no extra
constexpr int VEC_OFF = WIN_BYTES + STAGES * B_TILE;
constexpr int EXTRA_OFF = VEC_OFF + 4 * C * 4;
constexpr int SMEM_FIRST = EXTRA_OFF + TILE_PIX * PITCH8;
constexpr int SMEM_LIGHT_B = EXTRA_OFF + TILE_PIX * PITCH16;
constexpr int SMEM_LIGHT53_B = EXTRA_OFF + MT * ACC * THREADS * 4;
constexpr int SMEM_XDYN_FIRST = EXTRA_OFF;

// The dynamic ring launch's window: its M tiles are 256 consecutive raster
// positions of a ring segment staged at a pitch of at most PITCH_MAX pixels
// (segment width + KW - 1), so the block reads TILE_PIX + (KW-1) * (pitch+1)
// staged pixels; [window][weight ring][scales, biases][epilogue staging]
constexpr int PITCH_MAX = 136;
constexpr int SP_MAX = TILE_PIX + (KMAX - 1) * (PITCH_MAX + 1);
constexpr int PLANE_R = SP_MAX * 16 + 16;
constexpr int R_VEC_OFF = PLANES * PLANE_R + STAGES * B_TILE;
constexpr int R_STAGE_OFF = R_VEC_OFF + 4 * C * 4;
constexpr int SMEM_RING = R_STAGE_OFF + TILE_PIX * PITCH16;

static_assert(THREADS * 16 == B_TILE, "one 16-byte copy per thread fills a weight tile");
static_assert(SMEM_RING <= 232448, "the ring launch fits one block's shared memory");
static_assert(TILE_PIX * PITCH16 <= WIN_BYTES, "a staged epilogue pass fits the window's space");
static_assert(SMEM_LIGHT53_B <= 232448 && SMEM_LIGHT_B <= 232448, "fits one block's shared memory");
static_assert(SMEM_FIRST <= 232448 && SMEM_XDYN_FIRST <= 232448, "fits one block's shared memory");

// A thread block's 4 x 64 tile: image n, first pixel (y0, x0) in the
// coordinates of the source it stages from.
struct Tile {
  int n, y0, x0;
};

// Where a tile's outputs go: image n, first pixel (y0, x0); pixels at
// y < ylim, x < xlim are stored.
struct OutTile {
  int n, y0, x0, ylim, xlim;
};

__device__ __forceinline__ Tile tile_of_block(int W) {
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  Tile t;
  t.y0 = (blockIdx.x / tiles_w) * TILE_H;
  t.x0 = (blockIdx.x % tiles_w) * TILE_W;
  t.n = blockIdx.z;
  return t;
}

// The TPU kernel's windows (dynamic scales): th x tw tiles of the image padded
// to multiples of 8, wy x wx of them per image; blockIdx.z is the window.
struct Windows {
  int th, tw, wy, wx;
  __device__ __forceinline__ int n() const { return blockIdx.z / (wy * wx); }
  __device__ __forceinline__ int r0() const { return (blockIdx.z / wx) % wy * th; }
  __device__ __forceinline__ int c0() const { return blockIdx.z % wx * tw; }
};

// A window's extended ring (eh x ew) cut into nseg column segments of sw
// columns (the last may hold fewer), each walked in raster order at a pitch
// of sw + KW - 1 staged columns by nb thread blocks of TILE_PIX positions.
struct RingGrid {
  int sw, pitch, nb, nseg;
};

inline RingGrid ring_grid(int eh, int ew, int kw) {
  const int maxw = PITCH_MAX - (kw - 1);
  RingGrid r;
  r.nseg = (ew + maxw - 1) / maxw;
  r.sw = (ew + r.nseg - 1) / r.nseg;
  r.pitch = r.sw + kw - 1;
  r.nb = ((eh - 1) * r.pitch + r.sw + TILE_PIX - 1) / TILE_PIX;  // the last row's junk columns need no block
  return r;
}

// Columns the TPU DMAs beyond tw: 2*halo rounded up to 8.
__host__ __device__ constexpr int win_pad(int halo) { return (2 * halo + 7) / 8 * 8; }

// The int8 code q(v) = clamp(rint(v * inv), -127, 127) (rint rounds half to
// even), in the low byte of the result.  Clamping to the integer bounds
// first gives the same code; then adding 1.5 * 2^23, where the float spacing
// is 1, rounds half to even, and the low byte of the sum's bits is the code
// in two's complement.  No conversion instruction (a quarter-rate unit).
__device__ __forceinline__ unsigned code8(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// The dynamic codes clamp(rint(v / s), -127, 127) of the rounded quotients
// v / s of N values, the same way, without a division.  With rs = 1 / s
// rounded, q0 = v * rs rounded lies within |v / s| * 2^-23 of v / s, and the
// rounded quotient within |v / s| * 2^-24; wherever |q0| <= 127 the two so
// differ by under 2^-16 + 2^-17, and no half-integer (where the code steps)
// lies between them unless q0 lies within 2^-15 of one: then q0's code is
// the quotient's.  |q0| > 127 (infinities included) clamps as the quotient
// does, and NaN gives -127 both ways.  Near a step (values at half of the
// abs-max, for one, land there) the quotient is rounded exactly by two
// corrections: q1 = q0 + (v - q0 s) rs is within one ulp of v / s, so v - q1
// s is exact in an FMA and q1 + (v - q1 s) rs rounds to the rounded quotient
// (Markstein); no intermediate underflows, since |v / s| >= 1/2 there.
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

// A dynamic scale from an abs-max: max(amax, 1e-12) * float(1/127).
__device__ __forceinline__ float dyn_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.f / 127.f);
}

// low bytes of a, b -> bytes 0, 1
__device__ __forceinline__ unsigned pack2(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x0040);
}

__device__ __forceinline__ int pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return (int)__byte_perm(pack2(a, b), pack2(c, d), 0x5410);
}

// fma(float(acc), ssw, b) with ssw = s * sw (rounded once, per channel).
__device__ __forceinline__ float dequant(int acc, float ssw, float b) {
  return __fmaf_rn(__int2float_rn(acc), ssw, b);
}

// How a conv's sums become floats, by form: the Pallas kernels' fused
// dequant (DQ_FMA, K4/K5), or the XLA int8 forms' float(acc) (DQ_F32, the
// s32 and f32 accumulators) or bf16(float(acc)) (DQ_BF16: XLA converts the
// s32 sum to float32, then to bf16, so sums above 2^24 round twice), then
// the product with ssw and the add of b, each rounded.
constexpr int DQ_FMA = 0, DQ_F32 = 1, DQ_BF16 = 2;

template <int DQ>
__device__ __forceinline__ float deq(int acc, float ssw, float b) {
  if constexpr (DQ == DQ_FMA) {
    return dequant(acc, ssw, b);
  } else {
    float v = __int2float_rn(acc);
    if constexpr (DQ == DQ_BF16) v = __bfloat162float(__float2bfloat16_rn(v));
    return __fadd_rn(__fmul_rn(v, ssw), b);
  }
}

// Activations of type T: 16 channels as 16-byte loads, pairs in shared memory.
template <typename T>
struct Act;

template <>
struct Act<bf16> {
  static constexpr int LOADS = 2;  // 16-byte loads per 16 channels
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
  __device__ static __forceinline__ float2 load2(const uint8_t* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static __forceinline__ void store2(uint8_t* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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
  __device__ static __forceinline__ float2 load2(const uint8_t* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static __forceinline__ void store2(uint8_t* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// Sources of the staged input window: 16 channels of one pixel as 16 bytes.
// Values of type T quantized on the fly: static (s = 1 / scale, multiplied)
// or dynamic (s = the scale, divided; rs = 1 / s rounded, see codes8_div).
template <typename T, bool DYN>
struct QuantSrc {
  using Elem = T;
  const T* x;
  float s, rs;
  // r: channels 16 g .. 16 g + 15 of one pixel
  __device__ __forceinline__ int4 quant16(const uint4 (&r)[Act<T>::LOADS], int /*g*/) const {
    float f[16];
    Act<T>::to_floats(r, f);
    unsigned q[16];
    if constexpr (DYN) {
      codes8_div(f, s, rs, q);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) q[i] = code8(f[i], s);
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

// ---- the convolution --------------------------------------------------------

// Input window of the tile with its halo, 16 channels per item, zeros outside
// the source's H x W.  int8 codes: cp.async (zero-filled outside), one commit group.
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

// bf16 or float32 values, quantized on the way (a QuantSrc):
// the loads of WB items are in flight together.
template <int K, typename Src>
__device__ __forceinline__ void stage_window_q(uint8_t* win, const Src& src, const Tile& t, int H,
                                               int W) {
  using T = typename Src::Elem;
  constexpr int P = K / 2;
  constexpr int RH = TILE_H + K - 1;
  constexpr int RW = TILE_W + K - 1;
  constexpr int ITEMS = RH * RW * PLANES;
  constexpr int PER = (ITEMS + THREADS - 1) / THREADS;
  constexpr int L = Act<T>::LOADS;
  constexpr int WB = 18 / L;
#pragma unroll
  for (int b0 = 0; b0 < PER; b0 += WB) {
    uint4 raw[WB][L];
#pragma unroll
    for (int u = 0; u < WB; ++u) {
#pragma unroll
      for (int l = 0; l < L; ++l) raw[u][l] = make_uint4(0, 0, 0, 0);
      const int i = threadIdx.x + (b0 + u) * THREADS;
      if (b0 + u >= PER || i >= ITEMS) continue;
      const int g = i % PLANES;
      const int pix = i / PLANES;
      const int r = pix / RW;
      const int gy = t.y0 - P + r;
      const int gx = t.x0 - P + pix - r * RW;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const uint4* p = reinterpret_cast<const uint4*>(
            src.x + (((size_t)t.n * H + gy) * W + gx) * C + g * 16);
#pragma unroll
        for (int l = 0; l < L; ++l) raw[u][l] = __ldg(p + l);
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
      *reinterpret_cast<int4*>(win + g * PLANE + (r * WIN_W + c) * 16) = src.quant16(raw[u], g);
    }
  }
}

// Where a conv's A operand lies in shared memory.  TileGeo: a 4 x 64 tile of
// an H x W source (an image, or the window-major rings with n the window),
// staged as TILE_H + KW - 1 rows of WIN_W pixels a plane; M tile mt is output
// row mt.  RasterGeo: TILE_PIX consecutive raster positions p0.. of a ring
// segment whose rows are `pitch` pixels apart; staged pixel q is input
// raster position p0 + q, image pixel (y0 + (p0+q) / pitch, x0 + (p0+q) %
// pitch) of image n; M tile mt is positions 64 mt .. 64 mt + 63, and a tap
// (ky, kx) moves the start by ky * pitch + kx pixels.
struct TileGeo {
  static constexpr int PLANE_B = PLANE;
  Tile t;
  int H, W;
  __device__ __forceinline__ int a_pix(int mt, int ky, int kx) const {
    return (mt + ky) * WIN_W + kx;
  }
  template <int KW, typename Src>
  __device__ __forceinline__ void stage(uint8_t* win, const Src& src) const {
    if constexpr (std::is_same<Src, I8Src>::value)
      stage_window<KW>(win, src, t, H, W);
    else
      stage_window_q<KW>(win, src, t, H, W);
  }
};

struct RasterGeo {
  static constexpr int PLANE_B = PLANE_R;
  int n, p0, pitch, y0, x0, H, W;
  __device__ __forceinline__ int a_pix(int mt, int ky, int kx) const {
    return mt * TILE_W + ky * pitch + kx;
  }
  // x quantized with the window's dynamic scale on the way (TILE_PIX + (KW-1)
  // * (pitch+1) pixels, zeros outside the image); loads of WB items in flight
  template <int KW, typename T>
  __device__ __forceinline__ void stage(uint8_t* win, const QuantSrc<T, true>& src) const {
    constexpr int L = Act<T>::LOADS;
    constexpr int WB = 18 / L;
    const int items = (TILE_PIX + (KW - 1) * (pitch + 1)) * PLANES;
    for (int b0 = threadIdx.x; b0 < items; b0 += WB * THREADS) {
      uint4 raw[WB][L];
#pragma unroll
      for (int u = 0; u < WB; ++u) {
#pragma unroll
        for (int l = 0; l < L; ++l) raw[u][l] = make_uint4(0, 0, 0, 0);
        const int i = b0 + u * THREADS;
        if (i >= items) continue;
        const int pos = p0 + i / PLANES;
        const int iy = pos / pitch;
        const int gy = y0 + iy, gx = x0 + pos - iy * pitch;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const uint4* p = reinterpret_cast<const uint4*>(
              src.x + (((size_t)n * H + gy) * W + gx) * C + (i % PLANES) * 16);
#pragma unroll
          for (int l = 0; l < L; ++l) raw[u][l] = __ldg(p + l);
        }
      }
#pragma unroll
      for (int u = 0; u < WB; ++u) {
        const int i = b0 + u * THREADS;
        if (i >= items) continue;
        *reinterpret_cast<int4*>(win + (i % PLANES) * PLANE_R + (i / PLANES) * 16) =
            src.quant16(raw[u], i % PLANES);
      }
    }
  }
};

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
template <int K, int KW, bool STAGE, typename Geo, typename Src>
__device__ __forceinline__ void conv_s8(int (&acc)[MT][ACC], uint8_t* smem, const Src& src,
                                        const int8_t* __restrict__ wgt, const Geo& geo) {
  constexpr int STEPS = K * K * CHUNKS;
  constexpr int D = (KW - K) / 2;  // the window's halo beyond this conv's
  constexpr bool kAsyncWindow = std::is_same<Src, I8Src>::value;
  static_assert(STEPS >= STAGES - 2, "the prologue fits the sequence");
  uint8_t* win = smem;
  uint8_t* ring = smem + PLANES * Geo::PLANE_B;
  __syncthreads();  // a previous conv or epilogue has finished with shared memory
  if constexpr (STAGE && kAsyncWindow) geo.template stage<KW>(win, src);
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    load_b(ring, wgt, s);
    cp_async_commit();
  }
  if constexpr (STAGE && !kAsyncWindow) geo.template stage<KW>(win, src);
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
      const uint64_t da = desc(win_a + 2 * chunk * Geo::PLANE_B + geo.a_pix(row0 + j, ky + D, kx + D) * 16,
                               Geo::PLANE_B, 128);
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


// ---- epilogues ----------------------------------------------------------------

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

// 16-byte pieces of BYTES a pixel of the tile's stored pixels: f(byte offset
// in global memory, where gstride bytes make a pixel and the pieces start at
// goff within it; offset in a staged tile of PITCH bytes a pixel).
template <int BYTES, int PITCH, typename F>
__device__ __forceinline__ void for_tile_pieces(const OutTile& o, int H, int W, int gstride,
                                                int goff, F&& f) {
  constexpr int PIECES = BYTES / 16;
  for (int i = threadIdx.x; i < TILE_PIX * PIECES; i += THREADS) {
    const int p = i / PIECES;
    const int piece = i - p * PIECES;
    const int y = o.y0 + p / TILE_W;
    const int x = o.x0 + p % TILE_W;
    if (y < o.ylim && x < o.xlim)
      f((((size_t)o.n * H + y) * W + x) * gstride + goff + piece * 16, p * PITCH + piece * 16);
  }
}

// cp.async of epilogue pass `pass` of the tile's x (its stored pixels) into
// st, one commit group.
template <typename T>
__device__ __forceinline__ void prefetch_x(uint8_t* st, const T* x, const OutTile& o, int H, int W,
                                           int pass) {
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  for_tile_pieces<PASS, PITCH16>(o, H, W, C * sizeof(T), pass * PASS,
                                 [&](size_t g, int s) { cp_async16(st + s, xb + g); });
  cp_async_commit();
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

// Static launch A epilogue: the codes of relu(dq(acc) + b) at the next scale
// (inv_next = 1 / s_next) into the staging area, then out to dst.  vec
// holds s * sw and b of the conv.
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
  int8_t* db = dst;
  for_tile_pieces<C, PITCH8>(OutTile{t.n, t.y0, t.x0, H, W}, H, W, C, 0, [&](size_t g, int s) {
    *reinterpret_cast<int4*>(db + g) = *reinterpret_cast<const int4*>(stage + s);
  });
}

// max over the block's threads, into *amax as float bits by atomicMax (m >= 0)
__device__ __forceinline__ void atomic_max_block(float m, float* amax) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0 && m > 0.f)
    atomicMax(reinterpret_cast<unsigned*>(amax), __float_as_uint(m));
}

// Ring launch epilogue: v = relu(dq(acc) + b), zero outside the image and
// outside [ring, eh - ring) x [ring, ew - ring) of the window's extended
// ring (e = its width beyond the window), as float32 to the window's ring
// dst[eh][ew][C]; the block's positions are raster positions geo.p0 + pos of
// the segment from ring column cs, sw columns wide (positions in the pitch's
// other columns are neither stored nor counted).  The sums pass through st
// in two passes of 64 channels (TILE_PIX x PITCH16 bytes) and leave as
// 16-byte pieces, 256 contiguous bytes a position; the abs-max of v goes
// into *amax.
__device__ __forceinline__ void emit_ring(const int (&acc)[MT][ACC], const float* vec, float* dst,
                                          const RasterGeo& geo, int e, int cs, int sw, int eh,
                                          int ew, int ring, uint8_t* st, float* amax) {
  constexpr int CP = PASS / 4;  // float channels a pass
  const Frag f;
  bool keep[MT][2];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = geo.p0 + f.p0 + j * TILE_W + 8 * h;
      const int ey = p / geo.pitch, lx = p - ey * geo.pitch, ex = cs + lx;
      // ring pixel (ey, ex) is staged pixel (ey + e, lx + e)
      const int gy = geo.y0 + e + ey, gx = geo.x0 + e + lx;
      keep[j][h] = lx < sw && ey >= ring && ey < eh - ring && ex >= ring && ex < ew - ring &&
                   gy >= 0 && gy < geo.H && gx >= 0 && gx < geo.W;
    }
  float m = 0.f;
  uint8_t* db = reinterpret_cast<uint8_t*>(dst);
#pragma unroll
  for (int pass = 0; pass < C / CP; ++pass) {
#pragma unroll
    for (int n8 = pass * CP / 8; n8 < (pass + 1) * CP / 8; ++n8) {
      const int co = n8 * 8 + f.cq;
      const float sw0 = vec[co], sw1 = vec[co + 1], b0 = vec[C + co], b1 = vec[C + co + 1];
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = n8 * 4 + h * 2;
          const float v0 = keep[j][h] ? fmaxf(dequant(acc[j][i], sw0, b0), 0.f) : 0.f;
          const float v1 = keep[j][h] ? fmaxf(dequant(acc[j][i + 1], sw1, b1), 0.f) : 0.f;
          *reinterpret_cast<float2*>(st + (f.p0 + j * TILE_W + 8 * h) * PITCH16 + (co - pass * CP) * 4) =
              make_float2(v0, v1);
          m = fmaxf(m, fmaxf(v0, v1));
        }
    }
    __syncthreads();
    constexpr int PIECES = PASS / 16;
    for (int i = threadIdx.x; i < TILE_PIX * PIECES; i += THREADS) {
      const int pos = i / PIECES, piece = i - pos * PIECES;
      const int p = geo.p0 + pos;
      const int ey = p / geo.pitch, lx = p - ey * geo.pitch;
      if (lx < sw && ey < eh && cs + lx < ew)
        *reinterpret_cast<int4*>(db + (((size_t)ey * ew + cs + lx) * C + pass * CP) * 4 + piece * 16) =
            *reinterpret_cast<const int4*>(st + pos * PITCH16 + piece * 16);
    }
    __syncthreads();  // st is read out before it is written again
  }
  atomic_max_block(m, amax);
}

// The dequantized sums of a Light53 branch a parked in shared memory
// ([MT*ACC][THREADS], this thread's column) while branch b's conv runs.
template <int DQ = DQ_FMA>
__device__ __forceinline__ void park_sums(const int (&acc)[MT][ACC], const float* vec,
                                          float* park) {
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
        park[(j * ACC + i) * THREADS + threadIdx.x] = deq<DQ>(acc[j][i], sw0, b0);
        park[(j * ACC + i + 1) * THREADS + threadIdx.x] = deq<DQ>(acc[j][i + 1], sw1, b1);
      }
  }
}

// The residual epilogue: out = fma(id, x, res * (a + dq(acc) + b)) with a
// the parked branch-a sums (L53), or fma(res, dq(acc) + b, x) (Light); the
// XLA forms (DQ != DQ_FMA) round every product and add: id * x + res * (a +
// u), x + res * u.  vec holds s * sw and b of acc's conv.  x and then out
// pass through st (TILE_PIX x PITCH16 bytes) in passes of PASS bytes of
// channels a pixel; pass 0 of x is already in flight when PREFETCHED.
template <typename T, bool L53, bool PREFETCHED, int DQ = DQ_FMA>
__device__ __forceinline__ void residual_epilogue(const int (&acc)[MT][ACC], const float* vec,
                                                  const float* park, uint8_t* st, const T* x,
                                                  T* out, const OutTile& o, int H, int W,
                                                  float res_scale, float identity_scale) {
  constexpr int CP = PASS / sizeof(T);  // channels a pass
  constexpr int PASSES = C / CP;
  const Frag f;
  uint8_t* ob = reinterpret_cast<uint8_t*>(out);
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    if (pass > 0 || !PREFETCHED) prefetch_x(st, x, o, H, W, pass);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int n8 = pass * CP / 8; n8 < (pass + 1) * CP / 8; ++n8) {
      const int co = n8 * 8 + f.cq;
      const float sw0 = vec[co], sw1 = vec[co + 1], b0 = vec[C + co], b1 = vec[C + co + 1];
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = n8 * 4 + h * 2;
          uint8_t* px = st + (f.p0 + j * TILE_W + 8 * h) * PITCH16 + (co - pass * CP) * sizeof(T);
          const float2 xv = Act<T>::load2(px);
          const float u0 = deq<DQ>(acc[j][i], sw0, b0);
          const float u1 = deq<DQ>(acc[j][i + 1], sw1, b1);
          float o0, o1;
          if constexpr (L53) {
            const float a0 = park[(j * ACC + i) * THREADS + threadIdx.x];
            const float a1 = park[(j * ACC + i + 1) * THREADS + threadIdx.x];
            if constexpr (DQ == DQ_FMA) {
              o0 = __fmaf_rn(identity_scale, xv.x, __fmul_rn(res_scale, __fadd_rn(a0, u0)));
              o1 = __fmaf_rn(identity_scale, xv.y, __fmul_rn(res_scale, __fadd_rn(a1, u1)));
            } else {
              o0 = __fadd_rn(__fmul_rn(identity_scale, xv.x), __fmul_rn(res_scale, __fadd_rn(a0, u0)));
              o1 = __fadd_rn(__fmul_rn(identity_scale, xv.y), __fmul_rn(res_scale, __fadd_rn(a1, u1)));
            }
          } else if constexpr (DQ == DQ_FMA) {
            o0 = __fmaf_rn(res_scale, u0, xv.x);
            o1 = __fmaf_rn(res_scale, u1, xv.y);
          } else {
            o0 = __fadd_rn(xv.x, __fmul_rn(res_scale, u0));
            o1 = __fadd_rn(xv.y, __fmul_rn(res_scale, u1));
          }
          Act<T>::store2(px, o0, o1);
        }
    }
    __syncthreads();
    for_tile_pieces<PASS, PITCH16>(o, H, W, C * sizeof(T), pass * PASS, [&](size_t g, int s) {
      *reinterpret_cast<int4*>(ob + g) = *reinterpret_cast<const int4*>(st + s);
    });
    if (pass + 1 < PASSES) __syncthreads();  // st is read out before the next pass lands
  }
}

// ---- static scales: two launches over the whole image ---------------------------

// Launch A: t = q(relu(dq(conv(q(x, act[0])), act[0], sw) + b), s_next).
// With w5 set, the Light53 pair over one staged window (conv3 -> t3 at
// act[1], then conv5 -> t5 at act[2]); with w5 null, the Light block's
// conv3 (-> t3 at act[1]).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
i8_first_kernel(const T* __restrict__ x, const float* __restrict__ act,
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
  const QuantSrc<T, false> src{x, __frcp_rn(sx), 0.f};
  int acc[MT][ACC];
  if (w5 == nullptr) {
    conv_s8<3, 3, true>(acc, smem, src, w3, TileGeo{t, H, W});
    emit_codes(acc, vec, __frcp_rn(__ldg(act + 1)), stage, t3, t, H, W);
  } else {
    conv_s8<3, 5, true>(acc, smem, src, w3, TileGeo{t, H, W});
    emit_codes(acc, vec, __frcp_rn(__ldg(act + 1)), stage, t3, t, H, W);
    conv_s8<5, 5, false>(acc, smem, src, w5, TileGeo{t, H, W});
    emit_codes(acc, vec + 2 * C, __frcp_rn(__ldg(act + 2)), stage, t5, t, H, W);
  }
}

// Launch B of Light53: out = fma(id, x, res*((dq(conv5(ta)) + ba2) + (dq(conv3(tb)) + bb2))).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
light53_i8_second_kernel(const T* __restrict__ x, const float* __restrict__ act,
                         const int8_t* __restrict__ ta, const int8_t* __restrict__ wa2,
                         const float* __restrict__ sa2, const float* __restrict__ ba2,
                         const int8_t* __restrict__ tb, const int8_t* __restrict__ wb2,
                         const float* __restrict__ sb2, const float* __restrict__ bb2,
                         T* __restrict__ out, int H, int W, float res_scale, float identity_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + VEC_OFF);
  float* park = reinterpret_cast<float*>(smem + EXTRA_OFF);
  const Tile t = tile_of_block(W);
  stage_vecs(vec, __ldg(act + 1), sa2, ba2, __ldg(act + 2), sb2, bb2);
  int acc[MT][ACC];
  conv_s8<5, 5, true>(acc, smem, I8Src{ta}, wa2, TileGeo{t, H, W});
  park_sums(acc, vec, park);
  conv_s8<3, 3, true>(acc, smem, I8Src{tb}, wb2, TileGeo{t, H, W});
  // x into the window's space; outputs written over it, then out
  residual_epilogue<T, true, false>(acc, vec + 2 * C, park, smem, x, out,
                                    OutTile{t.n, t.y0, t.x0, H, W}, H, W, res_scale,
                                    identity_scale);
}

// Launch B of Light: out = fma(res, dq(conv3(t)) + b2, x).  x (its first
// pass) is fetched before the conv, into its own space.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
light_i8_second_kernel(const T* __restrict__ x, const float* __restrict__ act,
                       const int8_t* __restrict__ tin, const int8_t* __restrict__ w2,
                       const float* __restrict__ s2, const float* __restrict__ b2,
                       T* __restrict__ out, int H, int W, float res_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + VEC_OFF);
  uint8_t* xs = smem + EXTRA_OFF;
  const Tile t = tile_of_block(W);
  const OutTile o{t.n, t.y0, t.x0, H, W};
  stage_vecs(vec, __ldg(act + 1), s2, b2);
  prefetch_x(xs, x, o, H, W, 0);  // the oldest cp.async group: complete once the conv starts
  int acc[MT][ACC];
  conv_s8<3, 3, true>(acc, smem, I8Src{tin}, w2, TileGeo{t, H, W});
  residual_epilogue<T, false, true>(acc, vec, nullptr, xs, x, out, o, H, W, res_scale, 1.f);
}

// ---- the XLA int8 forms: per-channel static scales, per-sample dynamic --------

// The per-sample dynamic form (X3) quantizes with s = max(abs-max, 1e-6) /
// 127.0 (a division, as JAX writes it) and codes clamp(rint(v / s), -127,
// 127) of the rounded quotient (codes8_div).
__device__ __forceinline__ float sample_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
}

// Launch 1 of X3: each sample's abs-max of x into amax[sample] (blockIdx.z),
// as float bits by atomicMax; vecs: 16-byte vectors a sample.
__global__ void __launch_bounds__(THREADS)
sample_absmax_kernel(const bf16* __restrict__ x, float* __restrict__ amax, long long vecs) {
  const uint4* p = reinterpret_cast<const uint4*>(x) + (size_t)blockIdx.z * vecs;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < vecs;
       i += (long long)gridDim.x * THREADS)
    m = fmaxf(m, Act<bf16>::absmax16B(__ldg(p + i)));
  atomic_max_block(m, amax + blockIdx.z);
}

// The pixels whose values an abs-max of X3 covers: rows [y0, y1), columns
// [x0, x1) of each sample (the whole image, or a band's own rows when the
// image is one band of a frame with its neighbours' halo rows around it).
struct Window {
  int y0, y1, x0, x1;
};

// X3 launch 2 epilogue: v = relu(dq(acc) + b) of the tile's pixels inside
// the image, as float32 into dst (N, H, W, C), each thread's channel pairs
// straight from the registers (4 lanes make a 32-byte sector), so the
// stores drain while the block's next conv runs; the abs-max of v over win
// into *amax.
template <int DQ>
__device__ __forceinline__ void emit_floats(const int (&acc)[MT][ACC], const float* vec, float* dst,
                                            const Tile& t, int H, int W, float* amax,
                                            const Window& win) {
  const Frag f;
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = f.p0 + j * TILE_W + 8 * h;
      const int y = t.y0 + p / TILE_W, x = t.x0 + p % TILE_W;
      if (y >= H || x >= W) continue;
      const bool counted = y >= win.y0 && y < win.y1 && x >= win.x0 && x < win.x1;
      float* o = dst + (((size_t)t.n * H + y) * W + x) * C;
#pragma unroll
      for (int n8 = 0; n8 < C / 8; ++n8) {
        const int co = n8 * 8 + f.cq;
        const int i = n8 * 4 + h * 2;
        const float v0 = fmaxf(deq<DQ>(acc[j][i], vec[co], vec[C + co]), 0.f);
        const float v1 = fmaxf(deq<DQ>(acc[j][i + 1], vec[co + 1], vec[C + co + 1]), 0.f);
        *reinterpret_cast<float2*>(o + co) = make_float2(v0, v1);
        if (counted) m = fmaxf(m, fmaxf(v0, v1));
      }
    }
  atomic_max_block(m, amax);
}

// X3 launch 2: both first convs over one staged window of x quantized with
// its sample's scale (amax[0][n]): conv3 -> ta with its abs-max in
// amax[1][n], conv5 -> tb, amax[2][n]; dequant scales s_w[c] * s_x.
template <int DQ>
__global__ void __launch_bounds__(THREADS, 1)
xdyn_first_kernel(const bf16* __restrict__ x, float* __restrict__ amax,
                  const int8_t* __restrict__ w3, const float* __restrict__ s3,
                  const float* __restrict__ b3, float* __restrict__ t3,
                  const int8_t* __restrict__ w5, const float* __restrict__ s5,
                  const float* __restrict__ b5, float* __restrict__ t5, int H, int W, Window win) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + VEC_OFF);
  const Tile t = tile_of_block(W);
  const int samples = gridDim.z;
  const float sx = sample_scale(amax[t.n]);
  stage_vecs(vec, sx, s3, b3, sx, s5, b5);
  const QuantSrc<bf16, true> src{x, sx, __frcp_rn(sx)};
  int acc[MT][ACC];
  conv_s8<3, 5, true>(acc, smem, src, w3, TileGeo{t, H, W});
  emit_floats<DQ>(acc, vec, t3, t, H, W, amax + samples + t.n, win);
  conv_s8<5, 5, false>(acc, smem, src, w5, TileGeo{t, H, W});
  emit_floats<DQ>(acc, vec + 2 * C, t5, t, H, W, amax + 2 * samples + t.n, win);
}

// float4 vectors a thread of a requantization pass converts
constexpr int RQ_VECS = 4;

// X3's requantization pass: ta, tb (float32, (N, H, W, C)) into their int8
// codes clamp(rint(v / s), -127, 127) at each sample's scale s =
// sample_scale(amax[1 + branch][n]) (stream order hands it the finished
// abs-maxes of launch 2), once per value.  blockIdx.y: the branch,
// blockIdx.z: the sample; each thread RQ_VECS float4 vectors, lanes on
// consecutive vectors; vecs: float4 vectors a sample.
__global__ void __launch_bounds__(THREADS)
xdyn_requant_kernel(const float* __restrict__ ta, const float* __restrict__ tb,
                    const float* __restrict__ amax, int8_t* __restrict__ qa,
                    int8_t* __restrict__ qb, long long vecs) {
  const int samples = gridDim.z, n = blockIdx.z;
  const float s = sample_scale(amax[(1 + blockIdx.y) * samples + n]), rs = __frcp_rn(s);
  const float4* src = reinterpret_cast<const float4*>(blockIdx.y ? tb : ta) + (size_t)n * vecs;
  unsigned* dst = reinterpret_cast<unsigned*>(blockIdx.y ? qb : qa) + (size_t)n * vecs;
  for (long long i0 = (long long)blockIdx.x * THREADS * RQ_VECS + threadIdx.x; i0 < vecs;
       i0 += (long long)gridDim.x * THREADS * RQ_VECS) {
    float4 v[RQ_VECS];
#pragma unroll
    for (int u = 0; u < RQ_VECS; ++u)
      if (i0 + u * THREADS < vecs) v[u] = __ldcs(src + i0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < RQ_VECS; ++u) {
      if (i0 + u * THREADS >= vecs) continue;
      const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      unsigned q[4];
      codes8_div(f, s, rs, q);
      dst[i0 + u * THREADS] = (unsigned)pack4(q[0], q[1], q[2], q[3]);
    }
  }
}

// X3 launch 4: conv5 over ta's codes and conv3 over tb's (the requantization
// pass's, staged by cp.async as the static launch B stages its scratch),
// dequant scales s_w[c] * s_branch (amax[1][n], amax[2][n]), and the
// residual combine.
template <int DQ>
__global__ void __launch_bounds__(THREADS, 1)
xdyn_second_kernel(const bf16* __restrict__ x, const float* __restrict__ amax,
                   const int8_t* __restrict__ qa, const int8_t* __restrict__ wa2,
                   const float* __restrict__ sa2, const float* __restrict__ ba2,
                   const int8_t* __restrict__ qb, const int8_t* __restrict__ wb2,
                   const float* __restrict__ sb2, const float* __restrict__ bb2,
                   bf16* __restrict__ out, int H, int W, float res_scale, float identity_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + VEC_OFF);
  float* park = reinterpret_cast<float*>(smem + EXTRA_OFF);
  const Tile t = tile_of_block(W);
  const int samples = gridDim.z;
  const float sa = sample_scale(amax[samples + t.n]), sb = sample_scale(amax[2 * samples + t.n]);
  stage_vecs(vec, sa, sa2, ba2, sb, sb2, bb2);
  int acc[MT][ACC];
  conv_s8<5, 5, true>(acc, smem, I8Src{qa}, wa2, TileGeo{t, H, W});
  park_sums<DQ>(acc, vec, park);
  conv_s8<3, 3, true>(acc, smem, I8Src{qb}, wb2, TileGeo{t, H, W});
  residual_epilogue<bf16, true, false, DQ>(acc, vec + 2 * C, park, smem, x, out,
                                           OutTile{t.n, t.y0, t.x0, H, W}, H, W, res_scale,
                                           identity_scale);
}

// ---- dynamic scales: four launches over the TPU's windows -------------------------

// Launch 1: each window's input abs-max over the rows and columns the TPU
// kernel DMAs (zeros outside the image add nothing) into amax[window].  One
// thread block per window row (blockIdx.x), window blockIdx.z.
template <typename T>
__global__ void __launch_bounds__(THREADS)
window_absmax_kernel(const T* __restrict__ x, float* __restrict__ amax, int H, int W, Windows g,
                     int halo) {
  const int row = g.r0() - halo + (int)blockIdx.x;
  float m = 0.f;
  if (row >= 0 && row < H) {
    const int cb = max(0, g.c0() - halo);
    const int ce = min(W, g.c0() + g.tw + win_pad(halo) - halo);
    const uint4* p = reinterpret_cast<const uint4*>(x + (((size_t)g.n() * H + row) * W + cb) * C);
    const int vecs = (ce - cb) * C * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < vecs; i += THREADS) m = fmaxf(m, Act<T>::absmax16B(__ldg(p + i)));
  }
  atomic_max_block(m, amax + blockIdx.z);
}

// Launch 2: the first conv(s) of window blockIdx.z over its extended ring, E
// = (th + 2e) x (tw + 2e) from image (r0 - e, c0 - e), e = 2 for Light53 and
// 1 for Light, from x quantized with the window's scale amax[0][window]:
// Light53's conv3 (branch a, the whole ring) and conv5 (branch b, the inner
// ring of 1) over one staged window, Light's conv3.  Each into its ring
// (t3, t5: float32 [window][th + 2e][tw + 2e][C]) with its abs-max in
// amax[1 or 2][window].  blockIdx.x: segment blockIdx.x / rg.nb of the
// ring's columns, raster positions TILE_PIX * (blockIdx.x % rg.nb) on.
template <typename T, bool L53>
__global__ void __launch_bounds__(THREADS, 1)
dyn_first_kernel(const T* __restrict__ x, float* __restrict__ amax,
                 const int8_t* __restrict__ w3, const float* __restrict__ s3,
                 const float* __restrict__ b3, float* __restrict__ t3,
                 const int8_t* __restrict__ w5, const float* __restrict__ s5,
                 const float* __restrict__ b5, float* __restrict__ t5, int H, int W, Windows g,
                 RingGrid rg) {
  constexpr int E = L53 ? 2 : 1;
  constexpr int KW = 2 * E + 1;
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + R_VEC_OFF);
  uint8_t* st = smem + R_STAGE_OFF;
  const int eh = g.th + 2 * E, ew = g.tw + 2 * E;
  const int cs = (blockIdx.x / rg.nb) * rg.sw;
  const int windows = gridDim.z, win = blockIdx.z;
  const float sx = dyn_scale(amax[win]);
  stage_vecs(vec, sx, s3, b3, sx, s5, b5);
  const QuantSrc<T, true> src{x, sx, __frcp_rn(sx)};
  const RasterGeo geo{g.n(), (int)(blockIdx.x % rg.nb) * TILE_PIX, rg.pitch,
                      g.r0() - 2 * E, g.c0() - 2 * E + cs, H, W};
  const size_t wofs = (size_t)win * eh * ew * C;
  int acc[MT][ACC];
  conv_s8<3, KW, true>(acc, smem, src, w3, geo);
  emit_ring(acc, vec, t3 + wofs, geo, E, cs, rg.sw, eh, ew, 0, st, amax + windows + win);
  if constexpr (L53) {
    conv_s8<5, 5, false>(acc, smem, src, w5, geo);
    emit_ring(acc, vec + 2 * C, t5 + wofs, geo, E, cs, rg.sw, eh, ew, 1, st,
              amax + 2 * windows + win);
  }
}

// Requantization: each window's float32 ring(s) -> int8 codes q = clamp(rint(v
// / s), -127, 127) with s = dyn_scale(amax[1 + branch][window]), once per
// value, into [window][eh][ew][C] int8.  blockIdx.y: the branch (t0 -> q0,
// t1 -> q1), blockIdx.z: the window; each thread four float4 vectors of it,
// lanes on consecutive vectors.
__global__ void __launch_bounds__(THREADS)
ring_requant_kernel(const float* __restrict__ t0, const float* __restrict__ t1,
                    const float* __restrict__ amax, int8_t* __restrict__ q0,
                    int8_t* __restrict__ q1, int vecs) {
  const int windows = gridDim.z, win = blockIdx.z;
  const float s = dyn_scale(amax[(1 + blockIdx.y) * windows + win]), rs = __frcp_rn(s);
  const float4* src = reinterpret_cast<const float4*>(blockIdx.y ? t1 : t0) + (size_t)win * vecs;
  unsigned* dst = reinterpret_cast<unsigned*>(blockIdx.y ? q1 : q0) + (size_t)win * vecs;
  const int i0 = blockIdx.x * THREADS * RQ_VECS + threadIdx.x;
  float4 v[RQ_VECS];
#pragma unroll
  for (int u = 0; u < RQ_VECS; ++u)
    if (i0 + u * THREADS < vecs) v[u] = __ldcs(src + i0 + u * THREADS);
#pragma unroll
  for (int u = 0; u < RQ_VECS; ++u) {
    if (i0 + u * THREADS >= vecs) continue;
    const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    unsigned q[4];
    codes8_div(f, s, rs, q);
    dst[i0 + u * THREADS] = (unsigned)pack4(q[0], q[1], q[2], q[3]);
  }
}

// Launch 3: window blockIdx.z's second conv(s) VALID over its code rings
// (int8 [window][th + 2e][tw + 2e][C], staged by cp.async as the static
// second launch stages its scratch; Light53: conv5 over branch a's codes,
// conv3 over branch b's inner ring; Light: conv3), dequantized with the
// window's intermediate scales, then the residual epilogue on the window's
// th x tw outputs inside the image.  blockIdx.x: the 4 x 64 tiles of th x tw.
template <typename T, bool L53>
__global__ void __launch_bounds__(THREADS, 1)
dyn_second_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                  const int8_t* __restrict__ qa, const int8_t* __restrict__ wa2,
                  const float* __restrict__ sa2, const float* __restrict__ ba2,
                  const int8_t* __restrict__ qb, const int8_t* __restrict__ wb2,
                  const float* __restrict__ sb2, const float* __restrict__ bb2,
                  T* __restrict__ out, int H, int W, Windows g, float res_scale,
                  float identity_scale) {
  constexpr int E = L53 ? 2 : 1;
  extern __shared__ __align__(128) uint8_t smem[];
  float* vec = reinterpret_cast<float*>(smem + VEC_OFF);
  const int eh = g.th + 2 * E, ew = g.tw + 2 * E;
  const int tiles_w = (g.tw + TILE_W - 1) / TILE_W;
  const int y0 = (blockIdx.x / tiles_w) * TILE_H, x0 = (blockIdx.x % tiles_w) * TILE_W;
  const int windows = gridDim.z, win = blockIdx.z;
  const OutTile o{g.n(), g.r0() + y0, g.c0() + x0, min(H, g.r0() + g.th), min(W, g.c0() + g.tw)};
  const TileGeo e{Tile{win, y0 + E, x0 + E}, eh, ew};  // the tile in the rings' coordinates
  int acc[MT][ACC];
  if constexpr (L53) {
    float* park = reinterpret_cast<float*>(smem + EXTRA_OFF);
    stage_vecs(vec, dyn_scale(amax[windows + win]), sa2, ba2, dyn_scale(amax[2 * windows + win]),
               sb2, bb2);
    conv_s8<5, 5, true>(acc, smem, I8Src{qa}, wa2, e);
    park_sums(acc, vec, park);
    conv_s8<3, 3, true>(acc, smem, I8Src{qb}, wb2, e);
    residual_epilogue<T, true, false>(acc, vec + 2 * C, park, smem, x, out, o, H, W, res_scale,
                                      identity_scale);
  } else {
    uint8_t* xs = smem + EXTRA_OFF;
    stage_vecs(vec, dyn_scale(amax[windows + win]), sa2, ba2);
    prefetch_x(xs, x, o, H, W, 0);  // the oldest cp.async group: complete once the conv starts
    conv_s8<3, 3, true>(acc, smem, I8Src{qa}, wa2, e);
    residual_epilogue<T, false, true>(acc, vec, nullptr, xs, x, out, o, H, W, res_scale, 1.f);
  }
}

// ---- launches ------------------------------------------------------------------

unsigned tiles_of(int h, int w) {
  return (unsigned)(((h + TILE_H - 1) / TILE_H) * ((w + TILE_W - 1) / TILE_W));
}

// Dynamic shared memory above 48 KB has to be asked for, per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int light53_static(const T* x, const float* act, const int8_t* wa1, const float* sa1,
                   const float* ba1, const int8_t* wa2, const float* sa2, const float* ba2,
                   const int8_t* wb1, const float* sb1, const float* bb1, const int8_t* wb2,
                   const float* sb2, const float* bb2, int8_t* ta, int8_t* tb, T* out, int n,
                   int h, int w, float res_scale, float identity_scale, cudaStream_t st) {
  cudaError_t err = allow_smem(i8_first_kernel<T>, SMEM_FIRST);
  if (err == cudaSuccess) err = allow_smem(light53_i8_second_kernel<T>, SMEM_LIGHT53_B);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_of(h, w), 1, (unsigned)n);
  i8_first_kernel<T><<<grid, THREADS, SMEM_FIRST, st>>>(x, act, wa1, sa1, ba1, ta, wb1, sb1, bb1,
                                                        tb, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light53_i8_second_kernel<T><<<grid, THREADS, SMEM_LIGHT53_B, st>>>(
      x, act, ta, wa2, sa2, ba2, tb, wb2, sb2, bb2, out, h, w, res_scale, identity_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int light_static(const T* x, const float* act, const int8_t* w1, const float* s1, const float* b1,
                 const int8_t* w2, const float* s2, const float* b2, int8_t* t, T* out, int n,
                 int h, int w, float res_scale, cudaStream_t st) {
  cudaError_t err = allow_smem(i8_first_kernel<T>, SMEM_FIRST);
  if (err == cudaSuccess) err = allow_smem(light_i8_second_kernel<T>, SMEM_LIGHT_B);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_of(h, w), 1, (unsigned)n);
  i8_first_kernel<T><<<grid, THREADS, SMEM_FIRST, st>>>(x, act, w1, s1, b1, t, nullptr, nullptr,
                                                        nullptr, nullptr, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light_i8_second_kernel<T><<<grid, THREADS, SMEM_LIGHT_B, st>>>(x, act, t, w2, s2, b2, out, h, w,
                                                                 res_scale);
  return (int)cudaGetLastError();
}

// X3 in its three steps (a banded frame runs them one band after another,
// its abs-maxes reduced over the bands between them).  amax: float32 [3][n];
// ta, tb: float32 (n, h, w, C); qa, qb: int8, their codes.  Step 0: each
// sample's abs-max of x into amax[0] (accumulated: zero it first).  Step 1:
// the first convs from x quantized with amax[0], into ta, tb, their
// abs-maxes over win accumulated into amax[1], amax[2].  Step 2: the
// requantization pass (ta, tb into qa, qb at amax[1], amax[2]), then the
// second convs over the codes and the residual combine.
template <int DQ>
int light53_xla_dyn_step(int step, const bf16* x, const int8_t* wa1, const float* sa1,
                         const float* ba1, const int8_t* wa2, const float* sa2, const float* ba2,
                         const int8_t* wb1, const float* sb1, const float* bb1, const int8_t* wb2,
                         const float* sb2, const float* bb2, float* amax, float* ta, float* tb,
                         int8_t* qa, int8_t* qb, bf16* out, int n, int h, int w, Window win,
                         float res_scale, float identity_scale, cudaStream_t st) {
  const dim3 grid(tiles_of(h, w), 1, (unsigned)n);
  if (step == 0) {
    const long long vecs = (long long)h * w * C * (long long)sizeof(bf16) / 16;  // 16-byte vectors a sample
    const long long per = (long long)THREADS * 8;
    const unsigned bx = (unsigned)(vecs / per + 1 < 1024 ? vecs / per + 1 : 1024);
    sample_absmax_kernel<<<dim3(bx, 1, (unsigned)n), THREADS, 0, st>>>(x, amax, vecs);
  } else if (step == 1) {
    cudaError_t err = allow_smem(xdyn_first_kernel<DQ>, SMEM_XDYN_FIRST);
    if (err != cudaSuccess) return (int)err;
    xdyn_first_kernel<DQ><<<grid, THREADS, SMEM_XDYN_FIRST, st>>>(x, amax, wa1, sa1, ba1, ta, wb1,
                                                                  sb1, bb1, tb, h, w, win);
  } else {
    const long long vecs = (long long)h * w * C / 4;  // float4 vectors a sample
    const long long per = (long long)THREADS * RQ_VECS;
    const unsigned bx = (unsigned)((vecs + per - 1) / per < 1024 ? (vecs + per - 1) / per : 1024);
    xdyn_requant_kernel<<<dim3(bx, 2, (unsigned)n), THREADS, 0, st>>>(ta, tb, amax, qa, qb, vecs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(xdyn_second_kernel<DQ>, SMEM_LIGHT53_B);
    if (err != cudaSuccess) return (int)err;
    xdyn_second_kernel<DQ><<<grid, THREADS, SMEM_LIGHT53_B, st>>>(
        x, amax, qa, wa2, sa2, ba2, qb, wb2, sb2, bb2, out, h, w, res_scale, identity_scale);
  }
  return (int)cudaGetLastError();
}

// The whole X3 block over whole samples: amax zeroed here, then the three steps.
template <int DQ>
int light53_xla_dyn(const bf16* x, const int8_t* wa1, const float* sa1, const float* ba1,
                    const int8_t* wa2, const float* sa2, const float* ba2, const int8_t* wb1,
                    const float* sb1, const float* bb1, const int8_t* wb2, const float* sb2,
                    const float* bb2, float* amax, float* ta, float* tb, int8_t* qa, int8_t* qb,
                    bf16* out, int n, int h, int w, float res_scale, float identity_scale,
                    cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(amax, 0, 3 * (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  for (int step = 0; step < 3; ++step) {
    const int code = light53_xla_dyn_step<DQ>(step, x, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1,
                                              wb2, sb2, bb2, amax, ta, tb, qa, qb, out, n, h, w,
                                              Window{0, h, 0, w}, res_scale, identity_scale, st);
    if (code != 0) return code;
  }
  return 0;
}

// The window grid of a dynamic launch, or false where th, tw, h8 and w8 do
// not describe one (multiples of 8, th | h8, tw | w8, at most 65535 windows).
bool windows_of(int n, int h, int w, int th, int tw, int h8, int w8, Windows* g) {
  if (th <= 0 || tw <= 0 || th % 8 || tw % 8 || h8 != (h + 7) / 8 * 8 || w8 != (w + 7) / 8 * 8 ||
      h8 % th || w8 % tw)
    return false;
  *g = Windows{th, tw, h8 / th, w8 / tw};
  return (long long)n * g->wy * g->wx <= 65535;
}

// x's abs-max per window, the first conv(s) into the float32 rings, their
// codes, the second conv(s) and the epilogue; amax is [1 + branches][windows],
// zeroed here; qa, qb: the int8 code rings, the shape of ta, tb.
template <typename T, bool L53>
int dynamic_block(const T* x, const int8_t* w1, const float* s1, const float* b1,
                  const int8_t* w2, const float* s2, const float* b2, const int8_t* w3,
                  const float* s3, const float* b3, const int8_t* w4, const float* s4,
                  const float* b4, float* amax, float* ta, float* tb, int8_t* qa, int8_t* qb,
                  T* out, int n, int h, int w, const Windows& g, float res_scale,
                  float identity_scale, cudaStream_t st) {
  constexpr int E = L53 ? 2 : 1;
  const unsigned windows = (unsigned)(n * g.wy * g.wx);
  const int eh = g.th + 2 * E, ew = g.tw + 2 * E;
  const RingGrid rg = ring_grid(eh, ew, 2 * E + 1);
  const long long vecs = (long long)eh * ew * C / 4;  // float4 vectors of one window's ring
  if (vecs > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dyn_first_kernel<T, L53>, SMEM_RING);
  if (err == cudaSuccess)
    err = allow_smem(dyn_second_kernel<T, L53>, L53 ? SMEM_LIGHT53_B : SMEM_LIGHT_B);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(amax, 0, (L53 ? 3 : 2) * windows * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  window_absmax_kernel<T><<<dim3(g.th + 2 * (E + 1), 1, windows), THREADS, 0, st>>>(x, amax, h, w,
                                                                                  g, E + 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Light53: w1 = wa1 (3x3), w3 = wb1 (5x5); Light: w1 = its first conv
  dyn_first_kernel<T, L53><<<dim3(rg.nseg * rg.nb, 1, windows), THREADS, SMEM_RING, st>>>(
      x, amax, w1, s1, b1, ta, w3, s3, b3, tb, h, w, g, rg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned rq_blocks = (unsigned)((vecs + THREADS * RQ_VECS - 1) / (THREADS * RQ_VECS));
  ring_requant_kernel<<<dim3(rq_blocks, L53 ? 2 : 1, windows), THREADS, 0, st>>>(ta, tb, amax, qa, qb,
                                                                               (int)vecs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dyn_second_kernel<T, L53><<<dim3(tiles_of(g.th, g.tw), 1, windows), THREADS,
                              L53 ? SMEM_LIGHT53_B : SMEM_LIGHT_B, st>>>(
      x, amax, qa, w2, s2, b2, qb, w4, s4, b4, out, h, w, g, res_scale, identity_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes the launches accept: C == 128, x and out bf16 (f32 == 0) or float32
// (f32 == 1), weights repacked to [ky*kx][cin/32][2][cout][16] int8, every
// pointer 16-byte aligned, all tensors contiguous (the Python wrapper
// checks).  act holds the float32 activation scales on the device.  Returns
// the CUDA error code of the launches (0 = success).
int iek_light53_int8(const void* x, const float* act,
                     const int8_t* wa1, const float* sa1, const float* ba1,
                     const int8_t* wa2, const float* sa2, const float* ba2,
                     const int8_t* wb1, const float* sb1, const float* bb1,
                     const int8_t* wb2, const float* sb2, const float* bb2,
                     int8_t* ta, int8_t* tb, void* out,
                     int n, int h, int w, int c, int f32,
                     float res_scale, float identity_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return light53_static(static_cast<const float*>(x), act, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1,
                          bb1, wb2, sb2, bb2, ta, tb, static_cast<float*>(out), n, h, w,
                          res_scale, identity_scale, st);
  return light53_static(static_cast<const bf16*>(x), act, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1,
                        bb1, wb2, sb2, bb2, ta, tb, static_cast<bf16*>(out), n, h, w, res_scale,
                        identity_scale, st);
}

int iek_light_int8(const void* x, const float* act,
                   const int8_t* w1, const float* s1, const float* b1,
                   const int8_t* w2, const float* s2, const float* b2,
                   int8_t* t, void* out, int n, int h, int w, int c, int f32,
                   float res_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return light_static(static_cast<const float*>(x), act, w1, s1, b1, w2, s2, b2, t,
                        static_cast<float*>(out), n, h, w, res_scale, st);
  return light_static(static_cast<const bf16*>(x), act, w1, s1, b1, w2, s2, b2, t,
                      static_cast<bf16*>(out), n, h, w, res_scale, st);
}

// Dynamic scales over the TPU's th x tw windows of the image padded to h8 x
// w8.  amax: float32 [3][windows]; ta, tb: float32 [windows][th+4][tw+4][C];
// qa, qb: int8 of the same shape.
int iek_light53_int8_dynamic(const void* x,
                             const int8_t* wa1, const float* sa1, const float* ba1,
                             const int8_t* wa2, const float* sa2, const float* ba2,
                             const int8_t* wb1, const float* sb1, const float* bb1,
                             const int8_t* wb2, const float* sb2, const float* bb2,
                             float* amax, float* ta, float* tb, int8_t* qa, int8_t* qb, void* out,
                             int n, int h, int w, int c, int th, int tw, int h8, int w8, int f32,
                             float res_scale, float identity_scale, void* stream) {
  Windows g;
  if (c != C || !windows_of(n, h, w, th, tw, h8, w8, &g)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return dynamic_block<float, true>(static_cast<const float*>(x), wa1, sa1, ba1, wa2, sa2, ba2,
                                      wb1, sb1, bb1, wb2, sb2, bb2, amax, ta, tb, qa, qb,
                                      static_cast<float*>(out), n, h, w, g, res_scale,
                                      identity_scale, st);
  return dynamic_block<bf16, true>(static_cast<const bf16*>(x), wa1, sa1, ba1, wa2, sa2, ba2, wb1,
                                   sb1, bb1, wb2, sb2, bb2, amax, ta, tb, qa, qb,
                                   static_cast<bf16*>(out),
                                   n, h, w, g, res_scale, identity_scale, st);
}

// amax: float32 [2][windows]; t: float32 [windows][th+2][tw+2][C]; q: int8
// of the same shape.
int iek_light_int8_dynamic(const void* x,
                           const int8_t* w1, const float* s1, const float* b1,
                           const int8_t* w2, const float* s2, const float* b2,
                           float* amax, float* t, int8_t* q, void* out,
                           int n, int h, int w, int c, int th, int tw, int h8, int w8, int f32,
                           float res_scale, void* stream) {
  Windows g;
  if (c != C || !windows_of(n, h, w, th, tw, h8, w8, &g)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return dynamic_block<float, false>(static_cast<const float*>(x), w1, s1, b1, w2, s2, b2,
                                       nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, amax,
                                       t, nullptr, q, nullptr, static_cast<float*>(out), n, h, w, g,
                                       res_scale,
                                       1.f, st);
  return dynamic_block<bf16, false>(static_cast<const bf16*>(x), w1, s1, b1, w2, s2, b2, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, nullptr, amax, t, nullptr,
                                    q, nullptr, static_cast<bf16*>(out), n, h, w, g, res_scale, 1.f,
                                    st);
}

// Per-sample dynamic scales over the unfolded weights "q" / "s".  amax:
// float32 [3][n]; ta, tb: float32 (n, h, w, C); qa, qb: int8 (n, h, w, C).
int iek_light53_int8_xla_dyn(const void* x,
                             const int8_t* wa1, const float* sa1, const float* ba1,
                             const int8_t* wa2, const float* sa2, const float* ba2,
                             const int8_t* wb1, const float* sb1, const float* bb1,
                             const int8_t* wb2, const float* sb2, const float* bb2,
                             float* amax, float* ta, float* tb, int8_t* qa, int8_t* qb, void* out,
                             int n, int h, int w, int c, int acc_bf16, float res_scale,
                             float identity_scale, void* stream) {
  if (c != C || n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  if (acc_bf16)
    return light53_xla_dyn<DQ_BF16>(xb, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2,
                                    amax, ta, tb, qa, qb, ob, n, h, w, res_scale, identity_scale, st);
  return light53_xla_dyn<DQ_F32>(xb, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2, sb2, bb2, amax,
                                 ta, tb, qa, qb, ob, n, h, w, res_scale, identity_scale, st);
}

// One step of X3 (light53_xla_dyn_step) on one band of a frame: amax
// float32 [3][n], accumulated by steps 0 and 1 (zero it first); the
// abs-maxes of step 1 cover rows [wy0, wy1) and columns [wx0, wx1) of each
// sample, the band's own pixels; step 2 requantizes ta, tb into qa, qb at
// the frame's abs-maxes, then runs the second convs.
int iek_light53_int8_xla_dyn_step(int step, const void* x,
                                  const int8_t* wa1, const float* sa1, const float* ba1,
                                  const int8_t* wa2, const float* sa2, const float* ba2,
                                  const int8_t* wb1, const float* sb1, const float* bb1,
                                  const int8_t* wb2, const float* sb2, const float* bb2,
                                  float* amax, float* ta, float* tb, int8_t* qa, int8_t* qb,
                                  void* out, int n, int h, int w, int c, int wy0, int wy1, int wx0,
                                  int wx1, int acc_bf16, float res_scale, float identity_scale,
                                  void* stream) {
  if (c != C || n > 65535 || step < 0 || step > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  const Window win{wy0, wy1, wx0, wx1};
  if (acc_bf16)
    return light53_xla_dyn_step<DQ_BF16>(step, xb, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2,
                                         sb2, bb2, amax, ta, tb, qa, qb, ob, n, h, w, win, res_scale,
                                         identity_scale, st);
  return light53_xla_dyn_step<DQ_F32>(step, xb, wa1, sa1, ba1, wa2, sa2, ba2, wb1, sb1, bb1, wb2,
                                      sb2, bb2, amax, ta, tb, qa, qb, ob, n, h, w, win, res_scale,
                                      identity_scale, st);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
