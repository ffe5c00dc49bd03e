// The direct-convolution tile shared by the float32 block kernels
// (blocks.cu) and the chain kernels (tower.cu).
//
// A thread block computes 8 rows x 32 columns x 64 output channels of one
// image.  Each of its 8 warps owns 8 output channels; each lane owns one
// column and keeps 8 rows x 8 channels = 64 sums in registers.  Per stage of
// 4 input channels the block copies the input window with its halo and the
// matching K*K x 4 x 64 weight slice into shared memory.  A lane loads one
// column of the window into registers per (channel, kx) and reuses it over
// the K vertical taps and 8 channels, so each shared-memory load feeds ~15
// FMAs; weight loads are warp-wide broadcasts.  Plain FP32 FMA on the CUDA
// cores: no TF32 and no tensor cores.  SAME padding is a bounds check that
// reads zero.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 8;    // output rows per block (all held by each lane)
constexpr int TILE_W = 32;   // output columns per block (one per lane)
constexpr int CO_T = 64;     // output channels per block
constexpr int CO_THR = 8;    // output channels per warp
constexpr int CI_T = 4;      // input channels per shared-memory stage
constexpr int THREADS = 256; // 8 warps x 8 channels = CO_T
constexpr int KMAX = 5;
constexpr int IN_H = TILE_H + KMAX - 1;
constexpr int IN_W = TILE_W + KMAX - 1;

static_assert(THREADS / 32 * CO_THR == CO_T, "one warp per channel group");

struct __align__(16) Smem {
  float in[CI_T][IN_H][IN_W];
  float w[CI_T][KMAX * KMAX][CO_T];
};

struct Tile {
  int n, y0, x0, co0;
};

// Output tile `tile` (row-major over the H/8 x W/32 grid of tiles), output
// channel block `cob`, image `n`.
__device__ __forceinline__ Tile make_tile(int tile, int cob, int n, int W) {
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  Tile t;
  t.y0 = (tile / tiles_w) * TILE_H;
  t.x0 = (tile % tiles_w) * TILE_W;
  t.co0 = cob * CO_T;
  t.n = n;
  return t;
}

__device__ __forceinline__ int tiles_per_image(int H, int W) {
  return ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
}

// acc[j][c] += sum over taps and input channels of src * w, for output pixel
// (y0 + j, x0 + lane) and output channel co0 + warp*8 + c.  kCoherent reads
// src through L2 (ld.global.cg): needed where src was written earlier in the
// same kernel by other thread blocks, which the read-only path (__ldg) may
// not see.
template <int K, bool kCoherent = false>
__device__ __forceinline__ void conv_accumulate(
    float (&acc)[TILE_H][CO_THR], Smem& s, const float* src,
    const float* __restrict__ wgt, const Tile& t, int H, int W, int C) {
  constexpr int P = K / 2;
  constexpr int RH = TILE_H + K - 1;
  constexpr int RW = TILE_W + K - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cog = tid >> 5;
  const float* src_n = src + (size_t)t.n * H * W * C;

#pragma unroll 1
  for (int ci0 = 0; ci0 < C; ci0 += CI_T) {
    __syncthreads();  // the previous stage is fully consumed
    for (int p = tid; p < RH * RW; p += THREADS) {
      const int r = p / RW;
      const int c = p - r * RW;
      const int gy = t.y0 - P + r;
      const int gx = t.x0 - P + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float4* q = reinterpret_cast<const float4*>(src_n + ((size_t)gy * W + gx) * C + ci0);
        if constexpr (kCoherent)
          v = __ldcg(q);
        else
          v = __ldg(q);
      }
      s.in[0][r][c] = v.x;
      s.in[1][r][c] = v.y;
      s.in[2][r][c] = v.z;
      s.in[3][r][c] = v.w;
    }
    constexpr int V4 = CO_T / 4;
    for (int q = tid; q < K * K * CI_T * V4; q += THREADS) {
      const int v4 = q % V4;
      const int rest = q / V4;
      const int ci = rest % CI_T;
      const int tap = rest / CI_T;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          wgt + ((size_t)tap * C + ci0 + ci) * C + t.co0 + v4 * 4));
      *reinterpret_cast<float4*>(&s.w[ci][tap][v4 * 4]) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < CI_T; ++ci) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        float col[RH];
#pragma unroll
        for (int r = 0; r < RH; ++r) col[r] = s.in[ci][r][lane + kx];
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const float4 w0 = *reinterpret_cast<const float4*>(&s.w[ci][ky * K + kx][cog * CO_THR]);
          const float4 w1 = *reinterpret_cast<const float4*>(&s.w[ci][ky * K + kx][cog * CO_THR + 4]);
          const float wv[CO_THR] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < TILE_H; ++j)
#pragma unroll
            for (int c = 0; c < CO_THR; ++c)
              acc[j][c] = fmaf(col[j + ky], wv[c], acc[j][c]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[TILE_H][CO_THR]) {
#pragma unroll
  for (int j = 0; j < TILE_H; ++j)
#pragma unroll
    for (int c = 0; c < CO_THR; ++c) acc[j][c] = 0.f;
}

__device__ __forceinline__ size_t pixel_offset(const Tile& t, int j, int H, int W, int C) {
  const int lane = threadIdx.x & 31;
  const int cog = threadIdx.x >> 5;
  return (((size_t)t.n * H + t.y0 + j) * W + t.x0 + lane) * C + t.co0 + cog * CO_THR;
}

__device__ __forceinline__ bool pixel_inside(const Tile& t, int j, int H, int W) {
  return t.y0 + j < H && t.x0 + (int)(threadIdx.x & 31) < W;
}

// The 8 channels of this thread at output row j: dst[c] = relu(acc[j][c] + bias[c]).
__device__ __forceinline__ void store_relu_bias(float* dst, const float (&acc)[TILE_H][CO_THR], int j,
                                                const float (&bias)[CO_THR]) {
  float4* o = reinterpret_cast<float4*>(dst);
  o[0] = make_float4(fmaxf(acc[j][0] + bias[0], 0.f), fmaxf(acc[j][1] + bias[1], 0.f),
                     fmaxf(acc[j][2] + bias[2], 0.f), fmaxf(acc[j][3] + bias[3], 0.f));
  o[1] = make_float4(fmaxf(acc[j][4] + bias[4], 0.f), fmaxf(acc[j][5] + bias[5], 0.f),
                     fmaxf(acc[j][6] + bias[6], 0.f), fmaxf(acc[j][7] + bias[7], 0.f));
}

}  // namespace
