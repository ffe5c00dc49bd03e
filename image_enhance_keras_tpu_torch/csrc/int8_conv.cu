// X4: a 3x3 SAME int8 convolution with per-channel folded scales, for sm_90a,
// on the s8 tensor cores (wgmma): the convs of the zoo's int8 forwards
// (difv4's LightBlocks, difvdsr's DiffBlocks, the subpixel head of
// didbl_subpixel).
//
// Replaces work the JAX package leaves to XLA, not a Pallas kernel
// (models/didbl_pallas.py _quant_c, _qconv_xla, _deqf, _quant_dyn_sample,
// _deq_dyn, as models/zoo_int8.py and apply_didbl_int8_xla_tail call them),
// followed by the block's activation:
//   static:  q = clamp(rint(x * (1/s_in[c])), -127, 127)   (per input channel)
//            y = A(acc) * sf[co] + b[co]
//   dynamic: s = max(abs-max of the sample, 1e-6) / 127.0 (a division)
//            q = clamp(rint(x / s), -127, 127)              (the rounded quotient)
//            y = A(acc) * (s_w[co] * s) + b[co]
//   out = act(y): none, relu max(y, 0), or leaky where(y >= 0, y, slope * y)
// acc is the exact s32 sum over 3 x 3 x C_in; A(acc) is float(acc), or
// bf16(float(acc)) under the bf16 accumulator (XLA converts the s32 sum to
// float32, then to bf16).  Every product and add is rounded on its own (no
// FMA), as JAX computes these ops one at a time; build without
// --use_fast_math.  x is bf16 or float32 NHWC (C_in a multiple of 32, at
// most 256), the weights int8 HWIO (C_out a multiple of 64), out float32
// NHWC.  ops/cuda/int8_conv.py wraps it and holds its plain version.
//
// What bounds it on an H100: operations.  2 * 9 * C_in * C_out int8 ops a
// pixel (1.18 M at 256 -> 256) against 1 to 4 bytes of x and 4 * C_out of
// out: far above the balance point of 1,979 TOPS over 3.35 TB/s.
//
// Design (the static template of csrc/int8_blocks.cu, with C_in and C_out
// parameters): an implicit GEMM on wgmma.m64nNTk32.s32.s8.s8, NT = 128
// output channels a block where C_out allows it, else 64; both operands in
// shared memory, K-major, without swizzle.  A thread block (two
// warpgroups, each 2 M tiles of 64 consecutive output pixels of a row)
// computes 4 rows x 64 columns x NT channels; grid.y walks C_out in NT
// steps, each block staging its own window.
//   * A: the input window with its 1-pixel halo, (4 + 2) x (64 + 2) pixels,
//     quantized while staged (batched 16-byte loads), as C_in / 16 planes of
//     16 channels [row][col][16 bytes]; a tap (ky, kx) moves the
//     descriptor's start by ky window rows and kx * 16 bytes, the two halves
//     of a 32-channel K step are a plane apart (the leading byte offset).
//     Outside the image the loads are zeros, whose codes are zero: SAME
//     padding of the codes, as XLA pads the quantized tensor.
//   * B: the weights repacked to [tap][C_in/32][C_out/NT][2][NT][16], so
//     each (tap, K step, column block) is one contiguous NT x 32 tile,
//     streamed through a ring of 6 tiles by cp.async, 4 ahead of the
//     products; one wgmma group stays in flight while the next is issued.
//   * The epilogue writes each thread's pairs of channels straight from
//     the registers as float2 stores (4 lanes make a 32-byte sector).
// The dynamic form adds a launch before the conv: each sample's abs-max of
// x, as float bits by atomicMax.
// Left on the table: the staging and the epilogue do not overlap the
// products (one block per SM), blocks of one tile re-stage and re-quantize
// its window once per NT column block, and a 96-pixel-wide map fills 1.5 M
// tiles of 64 per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int TILE_W = 64;                  // output columns of an M tile (wgmma M)
constexpr int MT = 2;                       // M tiles (output rows) per warpgroup
constexpr int WGS = 2;                      // warpgroups per thread block
constexpr int TILE_H = MT * WGS;            // output rows per thread block
constexpr int THREADS = 128 * WGS;
constexpr int WIN_H = TILE_H + 2;
constexpr int WIN_W = TILE_W + 2;
constexpr int CIN_MAX = 256;
// +16 bytes: the planes of one pixel fall in different bank groups
constexpr int PLANE = WIN_H * WIN_W * 16 + 16;
constexpr int STAGES = 6;                   // weight ring; STAGES - 2 tiles ahead
constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2;

// shared memory: [window: C_in/16 planes][weight ring][1/s_in: CIN_MAX][scales: NT][biases: NT]
__host__ __device__ constexpr int smem_bytes(int cin, int nt) {
  return (cin / 16) * PLANE + STAGES * nt * 32 + (CIN_MAX + 2 * nt) * 4;
}

// ---- PTX: cp.async, proxy fence, wgmma ------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
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

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
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
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

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
__global__ void __launch_bounds__(THREADS)
sample_absmax_kernel(const T* __restrict__ x, float* __restrict__ amax, long long vecs) {
  const uint4* p = reinterpret_cast<const uint4*>(x) + (size_t)blockIdx.z * vecs;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < vecs;
       i += (long long)gridDim.x * THREADS)
    m = fmaxf(m, Act<T>::absmax16B(__ldg(p + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0 && m > 0.f)
    atomicMax(reinterpret_cast<unsigned*>(amax + blockIdx.z), __float_as_uint(m));
}

// ---- the convolution --------------------------------------------------------

// Weight tile s (of the (tap, K step) sequence) of column block nb into its ring slot.
template <int NT>
__device__ __forceinline__ void load_b(uint8_t* ring, const int8_t* wgt, int s, int nbs, int nb) {
  constexpr int B_TILE = NT * 32;
  const int8_t* src = wgt + ((size_t)s * nbs + nb) * B_TILE;
  uint8_t* dst = ring + (s % STAGES) * B_TILE;
  for (int i = threadIdx.x; i < B_TILE / 16; i += THREADS) cp_async16(dst + i * 16, src + i * 16);
}

// One float of the epilogue: A(acc) * sc + b, then the activation.
__device__ __forceinline__ float epilogue(int acc, float sc, float b, int acc_bf16, int act,
                                          float slope) {
  float v = __int2float_rn(acc);
  if (acc_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  v = __fadd_rn(__fmul_rn(v, sc), b);
  if (act == ACT_RELU) v = fmaxf(v, 0.f);
  else if (act == ACT_LEAKY) v = v >= 0.f ? v : __fmul_rn(slope, v);
  return v;
}

// out[n, y0.., x0.., NT*nb ..] of one 4 x 64 tile.  DYN: scale holds the
// samples' abs-maxes and sf the weight scales s_w; else scale holds s_in.
template <typename T, int NT, bool DYN>
__global__ void __launch_bounds__(THREADS, 1)
conv3_kernel(const T* __restrict__ x, const float* __restrict__ scale,
             const int8_t* __restrict__ wgt, const float* __restrict__ sf,
             const float* __restrict__ bias, float* __restrict__ out, int H, int W, int cin,
             int cout, int acc_bf16, int act, float slope) {
  constexpr int ACC = NT / 2;  // s32 sums a thread holds per M tile
  constexpr int B_TILE = NT * 32;
  constexpr int L = Act<T>::LOADS;
  constexpr int WB = 8 / L;  // staging items in flight a thread
  extern __shared__ __align__(128) uint8_t smem[];
  const int planes = cin / 16, steps = 9 * (cin / 32);
  const int nb = blockIdx.y, nbs = gridDim.y;
  uint8_t* win = smem;
  uint8_t* ring = smem + planes * PLANE;
  float* inv = reinterpret_cast<float*>(ring + STAGES * B_TILE);
  float* ssw = inv + CIN_MAX;
  float* bb = ssw + NT;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int y0 = (blockIdx.x / tiles_w) * TILE_H, x0 = (blockIdx.x % tiles_w) * TILE_W;
  const int n = blockIdx.z;
  float s = 0.f, rs = 0.f;
  if constexpr (DYN) {
    s = sample_scale(__ldg(scale + n));
    rs = __frcp_rn(s);
  }
  for (int i = threadIdx.x; i < NT; i += THREADS) {
    const int co = nb * NT + i;
    ssw[i] = DYN ? __fmul_rn(__ldg(sf + co), s) : __ldg(sf + co);
    bb[i] = __ldg(bias + co);
  }
  if constexpr (!DYN)
    for (int i = threadIdx.x; i < cin; i += THREADS) inv[i] = __frcp_rn(__ldg(scale + i));
#pragma unroll
  for (int s0 = 0; s0 < STAGES - 2; ++s0) {
    load_b<NT>(ring, wgt, s0, nbs, nb);
    cp_async_commit();
  }
  __syncthreads();  // inv is staged

  // the window, quantized on the way; WB items' loads in flight together
  const int items = WIN_H * WIN_W * planes;
  for (int i0 = threadIdx.x; i0 < items; i0 += WB * THREADS) {
    uint4 raw[WB][L];
#pragma unroll
    for (int u = 0; u < WB; ++u) {
#pragma unroll
      for (int l = 0; l < L; ++l) raw[u][l] = make_uint4(0, 0, 0, 0);
      const int i = i0 + u * THREADS;
      if (i >= items) continue;
      const int pix = i / planes, g = i - pix * planes;
      const int r = pix / WIN_W;
      const int gy = y0 - 1 + r, gx = x0 - 1 + pix - r * WIN_W;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const uint4* p = reinterpret_cast<const uint4*>(x + (((size_t)n * H + gy) * W + gx) * cin + g * 16);
#pragma unroll
        for (int l = 0; l < L; ++l) raw[u][l] = __ldg(p + l);
      }
    }
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= items) continue;
      const int pix = i / planes, g = i - pix * planes;
      float f[16];
      Act<T>::to_floats(raw[u], f);
      unsigned q[16];
      if constexpr (DYN) {
        codes8_div(f, s, rs, q);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) q[k] = code8(f[k], inv[16 * g + k]);
      }
      *reinterpret_cast<int4*>(win + g * PLANE + pix * 16) =
          make_int4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
    }
  }

  int acc[MT][ACC];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[j][i] = 0;
  const int row0 = (threadIdx.x / 128) * MT;
  const uint32_t win_a = smem_addr(win);
  const uint32_t ring_a = smem_addr(ring);
  const int chunks = cin / 32;
#pragma unroll 1
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 3>();  // tile st has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();  // all of tile st (and the window) written; slot of st-2 released
    if (st + STAGES - 2 < steps) load_b<NT>(ring, wgt, st + STAGES - 2, nbs, nb);
    cp_async_commit();
    const int tap = st / chunks;
    const int chunk = st - tap * chunks;
    const int ky = tap / 3;
    const int kx = tap - ky * 3;
    const uint64_t db = desc(ring_a + (st % STAGES) * B_TILE, NT * 16, 128);
#pragma unroll
    for (int j = 0; j < MT; ++j) fence_acc(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const uint64_t da = desc(win_a + 2 * chunk * PLANE + ((row0 + j + ky) * WIN_W + kx) * 16, PLANE, 128);
      wgmma_s8<NT>(acc[j], da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of step st-1 are done: its ring slot can be refilled
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < MT; ++j) fence_acc(acc[j]);

  // epilogue: this thread's channel pairs, straight to global memory
  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 7) * MT * TILE_W + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + j * TILE_W + 8 * h;
      const int y = y0 + p / TILE_W, xx = x0 + p % TILE_W;
      if (y >= H || xx >= W) continue;
      float* o = out + (((size_t)n * H + y) * W + xx) * cout + nb * NT;
#pragma unroll
      for (int n8 = 0; n8 < NT / 8; ++n8) {
        const int i = n8 * 4 + h * 2;
        const int co = n8 * 8 + cq;
        const float v0 = epilogue(acc[j][i], ssw[co], bb[co], acc_bf16, act, slope);
        const float v1 = epilogue(acc[j][i + 1], ssw[co + 1], bb[co + 1], acc_bf16, act, slope);
        *reinterpret_cast<float2*>(o + co) = make_float2(v0, v1);
      }
    }
}

// Each sample's abs-max of x (n, h, wd, cin) accumulated into amax[n].
template <typename T>
int absmax(const T* x, float* amax, int n, int h, int wd, int cin, cudaStream_t st) {
  const long long vecs = (long long)h * wd * cin * (long long)sizeof(T) / 16;
  const long long per = (long long)THREADS * 8;
  const unsigned bx = (unsigned)(vecs / per + 1 < 1024 ? vecs / per + 1 : 1024);
  sample_absmax_kernel<T><<<dim3(bx, 1, (unsigned)n), THREADS, 0, st>>>(x, amax, vecs);
  return (int)cudaGetLastError();
}

// DYN: amax holds the samples' abs-maxes when amax_given (a banded frame's,
// reduced over its bands), else it is n floats of scratch they are taken into.
template <typename T, int NT, bool DYN>
int launch(const void* xv, const float* scale, const int8_t* w, const float* sf, const float* b,
           float* amax, float* out, int n, int h, int wd, int cin, int cout, int acc_bf16, int act,
           float slope, bool amax_given, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  cudaError_t err = cudaFuncSetAttribute(conv3_kernel<T, NT, DYN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(CIN_MAX, NT));
  if (err != cudaSuccess) return (int)err;
  if (DYN) {
    if (!amax_given) {
      err = cudaMemsetAsync(amax, 0, (size_t)n * sizeof(float), st);
      if (err != cudaSuccess) return (int)err;
      const int code = absmax<T>(x, amax, n, h, wd, cin, st);
      if (code != 0) return code;
    }
    scale = amax;
  }
  const unsigned tiles = (unsigned)(((h + TILE_H - 1) / TILE_H) * ((wd + TILE_W - 1) / TILE_W));
  conv3_kernel<T, NT, DYN><<<dim3(tiles, (unsigned)(cout / NT), (unsigned)n), THREADS,
                             smem_bytes(cin, NT), st>>>(x, scale, w, sf, b, out, h, wd, cin, cout,
                                                        acc_bf16, act, slope);
  return (int)cudaGetLastError();
}

template <typename T, bool DYN>
int dispatch_nt(const void* x, const float* scale, const int8_t* w, const float* sf, const float* b,
                float* amax, float* out, int n, int h, int wd, int cin, int cout, int nt, int acc_bf16,
                int act, float slope, cudaStream_t st, bool amax_given = false) {
  if (nt == 128)
    return launch<T, 128, DYN>(x, scale, w, sf, b, amax, out, n, h, wd, cin, cout, acc_bf16, act,
                               slope, amax_given, st);
  return launch<T, 64, DYN>(x, scale, w, sf, b, amax, out, n, h, wd, cin, cout, acc_bf16, act,
                            slope, amax_given, st);
}

}  // namespace

extern "C" {

// x: (n, h, w, cin) bf16 (x_f32 == 0) or float32; s_in: the (cin,) static
// input scales, or null for the per-sample dynamic form, which then needs
// amax (n floats of scratch) and takes sf as the weight scales s_w; w: the
// int8 weights repacked to [9][cin/32][cout/nt][2][nt][16], nt 64 or 128 (the
// output channels a thread block computes, which the packing chose); sf,
// bias: (cout,) float32; out: (n, h, w, cout) float32.  cin a multiple of
// 32 up to 256, cout a multiple of nt,
// every pointer 16-byte aligned, all tensors contiguous (the Python wrapper
// checks).  act: 0 none, 1 relu, 2 leaky with slope.  Returns the CUDA
// error code of the launches (0 = success).
int iek_int8_conv3(const void* x, int x_f32, const float* s_in, const int8_t* w, const float* sf,
                   const float* bias, float* amax, float* out, int n, int h, int wd, int cin,
                   int cout, int nt, int acc_bf16, int act, float slope, cudaStream_t st) {
  if (cin % 32 || cin <= 0 || cin > CIN_MAX || (nt != 64 && nt != 128) || cout % nt || cout <= 0 ||
      n <= 0 || h <= 0 || wd <= 0 || n > 65535 || act < ACT_NONE || act > ACT_LEAKY ||
      (s_in == nullptr && amax == nullptr))
    return (int)cudaErrorInvalidValue;
  if (s_in == nullptr)
    return x_f32 ? dispatch_nt<float, true>(x, s_in, w, sf, bias, amax, out, n, h, wd, cin, cout, nt,
                                            acc_bf16, act, slope, st)
                 : dispatch_nt<bf16, true>(x, s_in, w, sf, bias, amax, out, n, h, wd, cin, cout, nt,
                                           acc_bf16, act, slope, st);
  return x_f32 ? dispatch_nt<float, false>(x, s_in, w, sf, bias, amax, out, n, h, wd, cin, cout, nt,
                                           acc_bf16, act, slope, st)
               : dispatch_nt<bf16, false>(x, s_in, w, sf, bias, amax, out, n, h, wd, cin, cout, nt,
                                          acc_bf16, act, slope, st);
}

// The dynamic form on one band of a frame, in two steps.  Step 0: each
// sample's abs-max of x accumulated into amax (n floats; zero them first).
// Step 1: the conv with amax as the samples' abs-maxes (reduced over the
// frame's bands).  Arguments as iek_int8_conv3's dynamic form.
int iek_int8_conv3_dyn_step(int step, const void* x, int x_f32, const int8_t* w, const float* sf,
                            const float* bias, float* amax, float* out, int n, int h, int wd,
                            int cin, int cout, int nt, int acc_bf16, int act, float slope,
                            cudaStream_t st) {
  if (cin % 32 || cin <= 0 || cin > CIN_MAX || (nt != 64 && nt != 128) || cout % nt || cout <= 0 ||
      n <= 0 || h <= 0 || wd <= 0 || n > 65535 || act < ACT_NONE || act > ACT_LEAKY ||
      amax == nullptr || step < 0 || step > 1)
    return (int)cudaErrorInvalidValue;
  if (step == 0)
    return x_f32 ? absmax<float>(static_cast<const float*>(x), amax, n, h, wd, cin, st)
                 : absmax<bf16>(static_cast<const bf16*>(x), amax, n, h, wd, cin, st);
  return x_f32 ? dispatch_nt<float, true>(x, nullptr, w, sf, bias, amax, out, n, h, wd, cin, cout, nt,
                                          acc_bf16, act, slope, st, true)
               : dispatch_nt<bf16, true>(x, nullptr, w, sf, bias, amax, out, n, h, wd, cin, cout, nt,
                                         acc_bf16, act, slope, st, true);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
