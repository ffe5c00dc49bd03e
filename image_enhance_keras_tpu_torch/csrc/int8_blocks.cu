// int8 residual blocks of the didbl int8 serving path (static activation
// scales), for sm_90a.
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
// weight scales; the convs are s8 x s8 -> s32, SAME, NHWC with HWIO weights
// repacked to [ky][kx][cin/4][cout][4] so that one 32-bit word holds four
// input channels of one output channel.  x and out are bf16.
//
// Semantics.  The TPU kernel runs halo'd spatial tiles: the first conv is
// VALID over the extended window and the intermediate is masked to zero
// outside the image.  With static scales that is exactly a whole-image SAME
// chain on the quantized codes, so the result does not depend on the tile
// split, and here each block is two launches over the whole image:
//   A. quantize x while staging it, both first convs (blockIdx.z picks the
//      branch), dequant + bias + relu, requantize, int8 scratch (N,H,W,C);
//   B. second convs over the scratch maps (out-of-image reads are 0, which
//      is the TPU kernel's border mask followed by quantization), dequant
//      and the float32 residual epilogue, bf16 output.
// Every float step is written with __fmul_rn/__fadd_rn in the TPU kernel's
// order (s_x*s_w first, then acc*that, then + b), so there is no FMA
// contraction and the plain PyTorch version agrees bit for bit; build
// without --use_fast_math.
//
// What bounds it on an H100: operations.  A Light53 block does 68 taps of
// a C x C product per pixel (2*68*C^2 int8 ops), a Light block 18; against
// the 1,979 TOPS dense int8 tensor-core peak and 3.35 TB/s that is far
// above the balance point.  This first version uses __dp4a on the CUDA
// cores (four s8 products into s32 per instruction), not the tensor cores:
// wgmma/mma.sync tiling is later work.
//
// Tiling: a thread block computes 4 rows x 32 columns x 64 output channels.
// Each of its 8 warps owns 8 output channels; each lane owns one column and
// keeps 4 rows x 8 channels = 32 s32 sums.  Per stage of 16 input channels
// (4 words) the block copies the input window with its halo and the
// K*K x 4 x 64 weight words into shared memory; a lane loads one column of
// the window per (word, kx) and reuses it over the K vertical taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int TILE_H = 4;    // output rows per block (all held by each lane)
constexpr int TILE_W = 32;   // output columns per block (one per lane)
constexpr int CO_T = 64;     // output channels per block
constexpr int CO_THR = 8;    // output channels per warp
constexpr int CW_T = 4;      // 32-bit words (4 input channels each) per stage
constexpr int THREADS = 256; // 8 warps x 8 channels = CO_T
constexpr int KMAX = 5;
constexpr int IN_H = TILE_H + KMAX - 1;
constexpr int IN_W = TILE_W + KMAX - 1;

static_assert(THREADS / 32 * CO_THR == CO_T, "one warp per channel group");

struct __align__(16) Smem {
  int in[CW_T][IN_H][IN_W];
  int w[CW_T][KMAX * KMAX][CO_T];
};

struct Tile {
  int n, y0, x0, co0;
};

__device__ __forceinline__ Tile tile_of_block(int W, int branches) {
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  Tile t;
  t.y0 = (blockIdx.x / tiles_w) * TILE_H;
  t.x0 = (blockIdx.x % tiles_w) * TILE_W;
  t.co0 = blockIdx.y * CO_T;
  t.n = blockIdx.z / branches;
  return t;
}

// q(v) = clamp(rint(v * inv), -127, 127); rint rounds half to even.
__device__ __forceinline__ int quant1(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return (int)q;
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (int)((unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
               ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24));
}

// float(acc) * (s * sw) + b, rounded after every step.
__device__ __forceinline__ float dequant(int acc, float s, float sw, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(s, sw)), b);
}

__device__ __forceinline__ void load_vals(const bf16* p, float (&f)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store_vals(bf16* p, const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Sources of the staged input window: 16 channels of one pixel as 4 words.
struct QuantSrc {  // bf16 x, quantized with the static scale on the fly
  const bf16* x;
  float inv;
  __device__ __forceinline__ int4 load(size_t off) const {
    float lo[8], hi[8];
    load_vals(x + off, lo);
    load_vals(x + off + 8, hi);
    int q[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[i] = quant1(lo[i], inv);
      q[i + 8] = quant1(hi[i], inv);
    }
    return make_int4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                     pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
  }
};

struct I8Src {  // int8 codes of an intermediate
  const int8_t* x;
  __device__ __forceinline__ int4 load(size_t off) const {
    return __ldg(reinterpret_cast<const int4*>(x + off));
  }
};

// acc[j][c] += sum over taps and input channels of src * w (s32, exact), for
// output pixel (y0 + j, x0 + lane) and output channel co0 + warp*8 + c.
// wgt is [K*K][C/4][C] words.
template <int K, typename Src>
__device__ __forceinline__ void conv_i8(int (&acc)[TILE_H][CO_THR], Smem& s, const Src& src,
                                        const int* __restrict__ wgt, const Tile& t,
                                        int H, int W, int C) {
  constexpr int P = K / 2;
  constexpr int RH = TILE_H + K - 1;
  constexpr int RW = TILE_W + K - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cog = tid >> 5;
  const int cwords = C / 4;

#pragma unroll 1
  for (int ci0 = 0; ci0 < C; ci0 += 4 * CW_T) {
    __syncthreads();  // the previous stage is fully consumed
    for (int p = tid; p < RH * RW; p += THREADS) {
      const int r = p / RW;
      const int c = p - r * RW;
      const int gy = t.y0 - P + r;
      const int gx = t.x0 - P + c;
      int4 v = make_int4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = src.load((((size_t)t.n * H + gy) * W + gx) * C + ci0);
      s.in[0][r][c] = v.x;
      s.in[1][r][c] = v.y;
      s.in[2][r][c] = v.z;
      s.in[3][r][c] = v.w;
    }
    constexpr int V4 = CO_T / 4;
    for (int q = tid; q < K * K * CW_T * V4; q += THREADS) {
      const int v4 = q % V4;
      const int rest = q / V4;
      const int cw = rest % CW_T;
      const int tap = rest / CW_T;
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          wgt + ((size_t)tap * cwords + ci0 / 4 + cw) * C + t.co0 + v4 * 4));
      *reinterpret_cast<int4*>(&s.w[cw][tap][v4 * 4]) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int cw = 0; cw < CW_T; ++cw) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        int col[RH];
#pragma unroll
        for (int r = 0; r < RH; ++r) col[r] = s.in[cw][r][lane + kx];
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const int4 w0 = *reinterpret_cast<const int4*>(&s.w[cw][ky * K + kx][cog * CO_THR]);
          const int4 w1 = *reinterpret_cast<const int4*>(&s.w[cw][ky * K + kx][cog * CO_THR + 4]);
          const int wv[CO_THR] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < TILE_H; ++j)
#pragma unroll
            for (int c = 0; c < CO_THR; ++c) acc[j][c] = __dp4a(col[j + ky], wv[c], acc[j][c]);
        }
      }
    }
  }
}

__device__ __forceinline__ size_t pixel_offset(const Tile& t, int j, int H, int W, int C) {
  const int lane = threadIdx.x & 31;
  const int cog = threadIdx.x >> 5;
  return (((size_t)t.n * H + t.y0 + j) * W + t.x0 + lane) * C + t.co0 + cog * CO_THR;
}

__device__ __forceinline__ bool pixel_inside(const Tile& t, int j, int H, int W) {
  return t.y0 + j < H && t.x0 + (int)(threadIdx.x & 31) < W;
}

__device__ __forceinline__ void zero(int (&acc)[TILE_H][CO_THR]) {
#pragma unroll
  for (int j = 0; j < TILE_H; ++j)
#pragma unroll
    for (int c = 0; c < CO_THR; ++c) acc[j][c] = 0;
}

// Launch A: t = q(relu(dq(conv(q(x, act[0])), act[0], sw) + b), act[1 + branch]).
// branches == 2 runs the Light53 pair (branch 0: conv3 -> t3, branch 1:
// conv5 -> t5); branches == 1 runs the Light block's conv3.
__global__ void __launch_bounds__(THREADS, 2)
i8_first_kernel(const bf16* __restrict__ x, const float* __restrict__ act,
                const int* __restrict__ w3, const float* __restrict__ s3,
                const float* __restrict__ b3, int8_t* __restrict__ t3,
                const int* __restrict__ w5, const float* __restrict__ s5,
                const float* __restrict__ b5, int8_t* __restrict__ t5,
                int H, int W, int C, int branches) {
  __shared__ Smem s;
  const Tile t = tile_of_block(W, branches);
  const int branch = blockIdx.z % branches;
  const float sx = __ldg(act);
  const QuantSrc src{x, __frcp_rn(sx)};
  int acc[TILE_H][CO_THR];
  zero(acc);
  if (branch == 0)
    conv_i8<3>(acc, s, src, w3, t, H, W, C);
  else
    conv_i8<5>(acc, s, src, w5, t, H, W, C);

  const float* sw = branch == 0 ? s3 : s5;
  const float* b = branch == 0 ? b3 : b5;
  int8_t* dst = branch == 0 ? t3 : t5;
  const float inv_next = __frcp_rn(__ldg(act + 1 + branch));
  const int cb = t.co0 + (threadIdx.x >> 5) * CO_THR;
  float swv[CO_THR], bias[CO_THR];
#pragma unroll
  for (int c = 0; c < CO_THR; ++c) {
    swv[c] = __ldg(sw + cb + c);
    bias[c] = __ldg(b + cb + c);
  }
#pragma unroll
  for (int j = 0; j < TILE_H; ++j) {
    if (!pixel_inside(t, j, H, W)) continue;
    int q[CO_THR];
#pragma unroll
    for (int c = 0; c < CO_THR; ++c)
      q[c] = quant1(fmaxf(dequant(acc[j][c], sx, swv[c], bias[c]), 0.f), inv_next);
    *reinterpret_cast<int2*>(dst + pixel_offset(t, j, H, W, C)) =
        make_int2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  }
}

// Launch B of Light53: out = id*x + res*((dq(conv5(ta)) + ba2) + (dq(conv3(tb)) + bb2)).
__global__ void __launch_bounds__(THREADS, 2)
light53_i8_second_kernel(const bf16* __restrict__ x, const float* __restrict__ act,
                         const int8_t* __restrict__ ta, const int* __restrict__ wa2,
                         const float* __restrict__ sa2, const float* __restrict__ ba2,
                         const int8_t* __restrict__ tb, const int* __restrict__ wb2,
                         const float* __restrict__ sb2, const float* __restrict__ bb2,
                         bf16* __restrict__ out, int H, int W, int C,
                         float res_scale, float identity_scale) {
  __shared__ Smem s;
  const Tile t = tile_of_block(W, 1);
  const int cb = t.co0 + (threadIdx.x >> 5) * CO_THR;
  int acc[TILE_H][CO_THR];
  zero(acc);
  conv_i8<5>(acc, s, I8Src{ta}, wa2, t, H, W, C);
  const float sta = __ldg(act + 1);
  float a[TILE_H][CO_THR];
#pragma unroll
  for (int c = 0; c < CO_THR; ++c) {
    const float swc = __ldg(sa2 + cb + c), bc = __ldg(ba2 + cb + c);
#pragma unroll
    for (int j = 0; j < TILE_H; ++j) a[j][c] = dequant(acc[j][c], sta, swc, bc);
  }
  zero(acc);
  conv_i8<3>(acc, s, I8Src{tb}, wb2, t, H, W, C);
  const float stb = __ldg(act + 2);
  float swv[CO_THR], bias[CO_THR];
#pragma unroll
  for (int c = 0; c < CO_THR; ++c) {
    swv[c] = __ldg(sb2 + cb + c);
    bias[c] = __ldg(bb2 + cb + c);
  }
#pragma unroll
  for (int j = 0; j < TILE_H; ++j) {
    if (!pixel_inside(t, j, H, W)) continue;
    const size_t off = pixel_offset(t, j, H, W, C);
    float xv[CO_THR];
    load_vals(x + off, xv);
    float o[CO_THR];
#pragma unroll
    for (int c = 0; c < CO_THR; ++c) {
      const float bv = dequant(acc[j][c], stb, swv[c], bias[c]);
      o[c] = __fadd_rn(__fmul_rn(identity_scale, xv[c]),
                       __fmul_rn(res_scale, __fadd_rn(a[j][c], bv)));
    }
    store_vals(out + off, o);
  }
}

// Launch B of Light: out = x + res*(dq(conv3(t)) + b2).
__global__ void __launch_bounds__(THREADS, 2)
light_i8_second_kernel(const bf16* __restrict__ x, const float* __restrict__ act,
                       const int8_t* __restrict__ tin, const int* __restrict__ w2,
                       const float* __restrict__ s2, const float* __restrict__ b2,
                       bf16* __restrict__ out, int H, int W, int C, float res_scale) {
  __shared__ Smem s;
  const Tile t = tile_of_block(W, 1);
  int acc[TILE_H][CO_THR];
  zero(acc);
  conv_i8<3>(acc, s, I8Src{tin}, w2, t, H, W, C);
  const float st = __ldg(act + 1);
  const int cb = t.co0 + (threadIdx.x >> 5) * CO_THR;
  float swv[CO_THR], bias[CO_THR];
#pragma unroll
  for (int c = 0; c < CO_THR; ++c) {
    swv[c] = __ldg(s2 + cb + c);
    bias[c] = __ldg(b2 + cb + c);
  }
#pragma unroll
  for (int j = 0; j < TILE_H; ++j) {
    if (!pixel_inside(t, j, H, W)) continue;
    const size_t off = pixel_offset(t, j, H, W, C);
    float xv[CO_THR];
    load_vals(x + off, xv);
    float o[CO_THR];
#pragma unroll
    for (int c = 0; c < CO_THR; ++c)
      o[c] = __fadd_rn(xv[c], __fmul_rn(res_scale, dequant(acc[j][c], st, swv[c], bias[c])));
    store_vals(out + off, o);
  }
}

dim3 grid_for(int n, int h, int w, int c, int branches) {
  const unsigned tiles = (unsigned)(((h + TILE_H - 1) / TILE_H) * ((w + TILE_W - 1) / TILE_W));
  return dim3(tiles, (unsigned)(c / CO_T), (unsigned)(n * branches));
}

}  // namespace

extern "C" {

// Shapes the launches accept: C % 64 == 0, bf16 activations, weights
// repacked to [ky][kx][cin/4][cout][4] int8, every pointer 16-byte aligned,
// all tensors contiguous (the Python wrapper checks).  act holds the
// float32 activation scales on the device.  Returns the CUDA error code of
// the launches (0 = success).
int iek_light53_int8(const bf16* x, const float* act,
                     const int8_t* wa1, const float* sa1, const float* ba1,
                     const int8_t* wa2, const float* sa2, const float* ba2,
                     const int8_t* wb1, const float* sb1, const float* bb1,
                     const int8_t* wb2, const float* sb2, const float* bb2,
                     int8_t* ta, int8_t* tb, bf16* out,
                     int n, int h, int w, int c,
                     float res_scale, float identity_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  i8_first_kernel<<<grid_for(n, h, w, c, 2), THREADS, 0, st>>>(
      x, act, reinterpret_cast<const int*>(wa1), sa1, ba1, ta,
      reinterpret_cast<const int*>(wb1), sb1, bb1, tb, h, w, c, 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light53_i8_second_kernel<<<grid_for(n, h, w, c, 1), THREADS, 0, st>>>(
      x, act, ta, reinterpret_cast<const int*>(wa2), sa2, ba2,
      tb, reinterpret_cast<const int*>(wb2), sb2, bb2, out, h, w, c,
      res_scale, identity_scale);
  return (int)cudaGetLastError();
}

int iek_light_int8(const bf16* x, const float* act,
                   const int8_t* w1, const float* s1, const float* b1,
                   const int8_t* w2, const float* s2, const float* b2,
                   int8_t* t, bf16* out, int n, int h, int w, int c,
                   float res_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  i8_first_kernel<<<grid_for(n, h, w, c, 1), THREADS, 0, st>>>(
      x, act, reinterpret_cast<const int*>(w1), s1, b1, t,
      nullptr, nullptr, nullptr, nullptr, h, w, c, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light_i8_second_kernel<<<grid_for(n, h, w, c, 1), THREADS, 0, st>>>(
      x, act, t, reinterpret_cast<const int*>(w2), s2, b2, out, h, w, c, res_scale);
  return (int)cudaGetLastError();
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
