// Fused residual blocks of the didbl generator, float32, for sm_90a.
//
// Replaces the Pallas TPU kernels in image_enhance_keras_tpu/ops/pallas/blocks.py:
//   * iek_light53_block <- fused_light53_block (_light53_kernel):
//       out = 0.1 * (9*x + (b_a2 + b_b2) + conv5(relu(conv3(x) + b_a1))
//                                        + conv3(relu(conv5(x) + b_b1)))
//   * iek_light_block   <- fused_light_block (_light_kernel):
//       out = x + 0.1 * (conv3(relu(conv3(x) + b1)) + b2)
// All convs are SAME (zero padding) over NHWC activations with HWIO weights.
//
// What bounds it on an H100: operations.  A Light53 block does 68 taps of a
// C x C product per pixel (2*68*C^2 FLOP), a Light block 18; at C = 128 that
// is ~2,200 FLOP per byte of activation read, far above the card's
// FP32-to-bandwidth balance (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B).
//
// Design.  The Pallas kernel holds a whole 96x96x128 tile with its halo in
// VMEM; that does not fit in one SM's 227 KB of shared memory, so each block
// is two launches:
//   1. first convs with bias and relu, written to N*H*W*C scratch (for
//      Light53 both branches, blockIdx.z picks the branch);
//   2. second convs plus the residual combine, in _light53_kernel's order
//      (acc = (0.9/0.1)*x + bias sum; acc += conv5(ta); acc += conv3(tb);
//      out = 0.1*acc).
// SAME padding is a bounds check that reads zero; on scratch that covers the
// whole image this is exactly the zero-padded intermediate of _relu_pad.
// The conv tile (conv_tile.cuh): a thread block computes 8 rows x 32
// columns x 64 output channels, 64 sums per lane in registers, with the input
// window and weight slice staged in shared memory per 4 input channels.
// Plain FP32 FMA on the CUDA cores: no TF32 and no tensor cores, so the
// result matches the float32 reference to rounding.  Double buffering, wgmma
// and TMA are left for later work.

#include "conv_tile.cuh"

namespace {

__device__ __forceinline__ Tile tile_of_block(int W, int branches) {
  return make_tile(blockIdx.x, blockIdx.y, blockIdx.z / branches, W);
}

// Launch 1: t = relu(conv(x) + b).  branches == 2 runs the Light53 pair
// (branch 0: conv3 -> t3, branch 1: conv5 -> t5); branches == 1 runs conv3.
__global__ void __launch_bounds__(THREADS, 2)
first_conv_kernel(const float* __restrict__ x,
                  const float* __restrict__ w3, const float* __restrict__ b3, float* __restrict__ t3,
                  const float* __restrict__ w5, const float* __restrict__ b5, float* __restrict__ t5,
                  int H, int W, int C, int branches) {
  __shared__ Smem s;
  const Tile t = tile_of_block(W, branches);
  const int branch = blockIdx.z % branches;
  float acc[TILE_H][CO_THR];
  zero(acc);

  if (branch == 0)
    conv_accumulate<3>(acc, s, x, w3, t, H, W, C);
  else
    conv_accumulate<5>(acc, s, x, w5, t, H, W, C);

  const float* b = branch == 0 ? b3 : b5;
  float* dst = branch == 0 ? t3 : t5;
  const int cb = t.co0 + (threadIdx.x >> 5) * CO_THR;
  float bias[CO_THR];
#pragma unroll
  for (int c = 0; c < CO_THR; ++c) bias[c] = __ldg(b + cb + c);
#pragma unroll
  for (int j = 0; j < TILE_H; ++j)
    if (pixel_inside(t, j, H, W)) store_relu_bias(dst + pixel_offset(t, j, H, W, C), acc, j, bias);
}

// Launch 2 of Light53: out = res * ((id/res)*x + ba2 + bb2 + conv5(ta) + conv3(tb)).
__global__ void __launch_bounds__(THREADS, 2)
light53_second_kernel(const float* __restrict__ x,
                      const float* __restrict__ ta, const float* __restrict__ wa2,
                      const float* __restrict__ ba2,
                      const float* __restrict__ tb, const float* __restrict__ wb2,
                      const float* __restrict__ bb2, float* __restrict__ out,
                      int H, int W, int C, float res_scale, float ident_over_res) {
  __shared__ Smem s;
  const Tile t = tile_of_block(W, 1);
  const int cb = t.co0 + (threadIdx.x >> 5) * CO_THR;
  float bsum[CO_THR];
#pragma unroll
  for (int c = 0; c < CO_THR; ++c) bsum[c] = __ldg(ba2 + cb + c) + __ldg(bb2 + cb + c);
  float acc[TILE_H][CO_THR];
#pragma unroll
  for (int j = 0; j < TILE_H; ++j) {
    float xv[CO_THR] = {};
    if (pixel_inside(t, j, H, W)) {
      const float4* xi = reinterpret_cast<const float4*>(x + pixel_offset(t, j, H, W, C));
      const float4 a = __ldg(xi), b = __ldg(xi + 1);
      xv[0] = a.x; xv[1] = a.y; xv[2] = a.z; xv[3] = a.w;
      xv[4] = b.x; xv[5] = b.y; xv[6] = b.z; xv[7] = b.w;
    }
#pragma unroll
    for (int c = 0; c < CO_THR; ++c) acc[j][c] = ident_over_res * xv[c] + bsum[c];
  }

  conv_accumulate<5>(acc, s, ta, wa2, t, H, W, C);
  conv_accumulate<3>(acc, s, tb, wb2, t, H, W, C);

#pragma unroll
  for (int j = 0; j < TILE_H; ++j) {
    if (!pixel_inside(t, j, H, W)) continue;
    float4* o = reinterpret_cast<float4*>(out + pixel_offset(t, j, H, W, C));
    o[0] = make_float4(res_scale * acc[j][0], res_scale * acc[j][1],
                       res_scale * acc[j][2], res_scale * acc[j][3]);
    o[1] = make_float4(res_scale * acc[j][4], res_scale * acc[j][5],
                       res_scale * acc[j][6], res_scale * acc[j][7]);
  }
}

// Launch 2 of Light: out = x + res * (conv3(t) + b2).
__global__ void __launch_bounds__(THREADS, 2)
light_second_kernel(const float* __restrict__ x, const float* __restrict__ tin,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ out, int H, int W, int C, float res_scale) {
  __shared__ Smem s;
  const Tile t = tile_of_block(W, 1);
  float acc[TILE_H][CO_THR];
  zero(acc);

  conv_accumulate<3>(acc, s, tin, w2, t, H, W, C);

  const int cb = t.co0 + (threadIdx.x >> 5) * CO_THR;
  float bias[CO_THR];
#pragma unroll
  for (int c = 0; c < CO_THR; ++c) bias[c] = __ldg(b2 + cb + c);
#pragma unroll
  for (int j = 0; j < TILE_H; ++j) {
    if (!pixel_inside(t, j, H, W)) continue;
    const size_t off = pixel_offset(t, j, H, W, C);
    const float4* xi = reinterpret_cast<const float4*>(x + off);
    const float4 a = __ldg(xi), b = __ldg(xi + 1);
    float4* o = reinterpret_cast<float4*>(out + off);
    o[0] = make_float4(a.x + res_scale * (acc[j][0] + bias[0]), a.y + res_scale * (acc[j][1] + bias[1]),
                       a.z + res_scale * (acc[j][2] + bias[2]), a.w + res_scale * (acc[j][3] + bias[3]));
    o[1] = make_float4(b.x + res_scale * (acc[j][4] + bias[4]), b.y + res_scale * (acc[j][5] + bias[5]),
                       b.z + res_scale * (acc[j][6] + bias[6]), b.w + res_scale * (acc[j][7] + bias[7]));
  }
}

dim3 grid_for(int n, int h, int w, int c, int branches) {
  const unsigned tiles = (unsigned)(((h + TILE_H - 1) / TILE_H) * ((w + TILE_W - 1) / TILE_W));
  return dim3(tiles, (unsigned)(c / CO_T), (unsigned)(n * branches));
}

}  // namespace

extern "C" {

// Shapes the launches accept: C % 64 == 0, every pointer 16-byte aligned,
// all tensors contiguous (the Python wrapper checks).  Returns the CUDA
// error code of the launches (0 = success).
int iek_light53_block(const float* x,
                      const float* wa1, const float* ba1, const float* wa2, const float* ba2,
                      const float* wb1, const float* bb1, const float* wb2, const float* bb2,
                      float* ta, float* tb, float* out,
                      int n, int h, int w, int c, float res_scale, float ident_over_res,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  first_conv_kernel<<<grid_for(n, h, w, c, 2), THREADS, 0, st>>>(
      x, wa1, ba1, ta, wb1, bb1, tb, h, w, c, 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light53_second_kernel<<<grid_for(n, h, w, c, 1), THREADS, 0, st>>>(
      x, ta, wa2, ba2, tb, wb2, bb2, out, h, w, c, res_scale, ident_over_res);
  return (int)cudaGetLastError();
}

int iek_light_block(const float* x, const float* w1, const float* b1,
                    const float* w2, const float* b2, float* t, float* out,
                    int n, int h, int w, int c, float res_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  first_conv_kernel<<<grid_for(n, h, w, c, 1), THREADS, 0, st>>>(
      x, w1, b1, t, nullptr, nullptr, nullptr, h, w, c, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  light_second_kernel<<<grid_for(n, h, w, c, 1), THREADS, 0, st>>>(
      x, t, w2, b2, out, h, w, c, res_scale);
  return (int)cudaGetLastError();
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
