// Chains of residual blocks of the didbl generator, float32, for sm_90a.
//
// Replaces the Pallas TPU kernels in image_enhance_keras_tpu/ops/pallas/tower.py:
//   * iek_light53_chain <- fused_light53_chain (_light53_body): K Light53
//     blocks back to back, each
//       ya = conv5(relu(conv3(x) + ba1)) + ba2
//       yb = conv3(relu(conv5(x) + bb1)) + bb2
//       x  = identity*x + res*(ya + yb)
//   * iek_light_chain   <- fused_light_chain (_light_body): K Light blocks,
//       x = x + res*(conv3(relu(conv3(x) + b1)) + b2)
// Weights are stacked on a leading K axis: (K, kh, kw, C, C) HWIO and (K, C).
// All convs are SAME (zero padding) over NHWC activations: each image of the
// batch is an independent tile.
//
// What bounds it on an H100: operations, as for one block (blocks.cu): 68
// taps of a C x C product per pixel for Light53, 18 for Light, so K blocks
// do K*2*68*C^2 FLOP per pixel against one read of x and one write of out.
//
// Design.  The Pallas kernel keeps the tile's activation in VMEM across all
// K blocks and streams each block's weights in by double-buffered DMA.  A
// 96x96x128 float32 tile is 4.7 MB, far beyond one SM's 227 KB of shared
// memory, so here the activations live in device memory (a ping-pong pair:
// `act` and `out`, arranged so that block K-1 writes `out`) and the K blocks
// run inside one persistent cooperative launch:
//   per block k:  L2 prefetch of block k+1's weights (the counterpart of the
//                 TPU's second weight slot; 4.5 MB for Light53, the L2 holds
//                 50 MB);
//                 phase 1: first convs + bias + relu into scratch ta (tb);
//                 grid-wide barrier;
//                 phase 2: second convs and the residual combine, in the
//                 chain body's order; ya is parked in the destination and
//                 read back by the same thread, so only one set of 64 sums
//                 is live;
//                 grid-wide barrier (except after the last block).
// The grid is sized to what is co-resident (occupancy x SMs) and each
// thread block loops over the work items of a phase (tile x 64-channel
// block x image x branch), each computed by the conv tile of conv_tile.cuh.
// Activations written inside the launch are read through L2 (__ldcg),
// never through the read-only path; cooperative_groups' grid sync orders
// the phases.  Plain FP32 FMA, no TF32; the combine uses explicitly rounded
// multiplies and adds so it rounds as the plain PyTorch version does.

#include <cooperative_groups.h>

#include "conv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

struct ChainArgs {
  const float* x;  // (N, H, W, C) input of block 0
  float* out;      // output of block K-1
  float* act;      // the other activation buffer
  float* ta;       // first-conv intermediates (Light53 branch a, or Light)
  float* tb;       // Light53 branch b
  const float* wa1; const float* ba1;  // Light53 conv_a1 (3x3); Light conv_a (3x3)
  const float* wa2; const float* ba2;  // Light53 conv_a2 (5x5); Light conv_b (3x3)
  const float* wb1; const float* bb1;  // Light53 conv_b1 (5x5)
  const float* wb2; const float* bb2;  // Light53 conv_b2 (3x3)
  int k_blocks, n, h, w, c;
  float res_scale, identity_scale;
};

// Spread over the whole grid: prefetch.global.L2 of every 128-byte line.
__device__ __forceinline__ void prefetch_l2(const float* p, size_t n_floats) {
  const size_t lines = (n_floats * sizeof(float) + 127) / 128;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < lines; i += stride)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(reinterpret_cast<const char*>(p) + i * 128));
}

__device__ __forceinline__ void load_bias(float (&b)[CO_THR], const float* src, const Tile& t) {
  const int cb = t.co0 + (threadIdx.x >> 5) * CO_THR;
#pragma unroll
  for (int c = 0; c < CO_THR; ++c) b[c] = __ldg(src + cb + c);
}

__device__ __forceinline__ void load8(float (&v)[CO_THR], const float* p) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[CO_THR]) {
  float4* o = reinterpret_cast<float4*>(p);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <bool kLight53>
__global__ void __launch_bounds__(THREADS, 2) chain_kernel(ChainArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Smem s;
  const int H = a.h, W = a.w, C = a.c, K = a.k_blocks;
  const int n_tiles = tiles_per_image(H, W);
  const int n_cob = C / CO_T;
  constexpr int branches = kLight53 ? 2 : 1;
  const int items2 = n_tiles * n_cob * a.n;
  const int items1 = items2 * branches;
  const size_t cc = (size_t)C * C;
  constexpr int KA2 = kLight53 ? 5 : 3;  // second conv of branch a
  float acc[TILE_H][CO_THR];
  float bias[CO_THR];

  for (int k = 0; k < K; ++k) {
    float* dst = (K - 1 - k) % 2 == 0 ? a.out : a.act;
    const float* src = k == 0 ? a.x : (dst == a.out ? a.act : a.out);
    const float* wa1 = a.wa1 + k * 9 * cc;
    const float* wa2 = a.wa2 + k * KA2 * KA2 * cc;
    const float* wb1 = kLight53 ? a.wb1 + k * 25 * cc : nullptr;
    const float* wb2 = kLight53 ? a.wb2 + k * 9 * cc : nullptr;
    if (k + 1 < K) {
      prefetch_l2(wa1 + 9 * cc, 9 * cc);
      prefetch_l2(wa2 + KA2 * KA2 * cc, KA2 * KA2 * cc);
      if constexpr (kLight53) {
        prefetch_l2(wb1 + 25 * cc, 25 * cc);
        prefetch_l2(wb2 + 9 * cc, 9 * cc);
      }
    }

    // phase 1: ta = relu(conv3(src) + ba1); Light53 also tb = relu(conv5(src) + bb1)
    for (int it = blockIdx.x; it < items1; it += gridDim.x) {
      const int z = it / (n_tiles * n_cob);
      const Tile t = make_tile(it % n_tiles, (it / n_tiles) % n_cob, z / branches, W);
      const bool branch_b = kLight53 && (z % branches) == 1;
      zero(acc);
      if constexpr (kLight53) {
        if (branch_b) conv_accumulate<5, true>(acc, s, src, wb1, t, H, W, C);
      }
      if (!branch_b) conv_accumulate<3, true>(acc, s, src, wa1, t, H, W, C);
      load_bias(bias, (branch_b ? a.bb1 : a.ba1) + k * C, t);
      float* tdst = branch_b ? a.tb : a.ta;
#pragma unroll
      for (int j = 0; j < TILE_H; ++j)
        if (pixel_inside(t, j, H, W)) store_relu_bias(tdst + pixel_offset(t, j, H, W, C), acc, j, bias);
    }
    grid.sync();

    // phase 2: the second convs and the residual combine
    for (int it = blockIdx.x; it < items2; it += gridDim.x) {
      const Tile t = make_tile(it % n_tiles, (it / n_tiles) % n_cob, it / (n_tiles * n_cob), W);
      zero(acc);
      conv_accumulate<KA2, true>(acc, s, a.ta, wa2, t, H, W, C);
      load_bias(bias, a.ba2 + k * C, t);
      if constexpr (kLight53) {
        // ya = conv5(ta) + ba2, parked in dst; then yb = conv3(tb) + bb2
#pragma unroll
        for (int j = 0; j < TILE_H; ++j) {
          if (!pixel_inside(t, j, H, W)) continue;
          float ya[CO_THR];
#pragma unroll
          for (int c = 0; c < CO_THR; ++c) ya[c] = __fadd_rn(acc[j][c], bias[c]);
          store8(dst + pixel_offset(t, j, H, W, C), ya);
        }
        zero(acc);
        conv_accumulate<3, true>(acc, s, a.tb, wb2, t, H, W, C);
        load_bias(bias, a.bb2 + k * C, t);
      }
#pragma unroll
      for (int j = 0; j < TILE_H; ++j) {
        if (!pixel_inside(t, j, H, W)) continue;
        const size_t off = pixel_offset(t, j, H, W, C);
        float xv[CO_THR], o[CO_THR];
        load8(xv, src + off);
        if constexpr (kLight53) {
          float ya[CO_THR];
          load8(ya, dst + off);
#pragma unroll
          for (int c = 0; c < CO_THR; ++c) {
            const float y = __fadd_rn(ya[c], __fadd_rn(acc[j][c], bias[c]));
            o[c] = __fadd_rn(__fmul_rn(a.identity_scale, xv[c]), __fmul_rn(a.res_scale, y));
          }
        } else {
#pragma unroll
          for (int c = 0; c < CO_THR; ++c)
            o[c] = __fadd_rn(xv[c], __fmul_rn(a.res_scale, __fadd_rn(acc[j][c], bias[c])));
        }
        store8(dst + off, o);
      }
    }
    if (k + 1 < K) grid.sync();
  }
}

template <bool kLight53>
int launch_chain(ChainArgs a, void* stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<kLight53>, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int items = (a.h + TILE_H - 1) / TILE_H * ((a.w + TILE_W - 1) / TILE_W) * (a.c / CO_T) * a.n *
                    (kLight53 ? 2 : 1);
  const int grid = items < per_sm * sms ? items : per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chain_kernel<kLight53>), dim3(grid),
                                    dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Shapes the launches accept: C % 64 == 0, K >= 1, every pointer 16-byte
// aligned, all tensors contiguous (the Python wrapper checks).  act, ta, tb
// and out are N*H*W*C float scratch/outputs, distinct from x.  Returns the
// CUDA error code of the launch (0 = success).
int iek_light53_chain(const float* x,
                      const float* wa1, const float* ba1, const float* wa2, const float* ba2,
                      const float* wb1, const float* bb1, const float* wb2, const float* bb2,
                      float* act, float* ta, float* tb, float* out,
                      int k_blocks, int n, int h, int w, int c,
                      float res_scale, float identity_scale, void* stream) {
  ChainArgs a{x, out, act, ta, tb, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
              k_blocks, n, h, w, c, res_scale, identity_scale};
  return launch_chain<true>(a, stream);
}

int iek_light_chain(const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
                    float* act, float* t, float* out, int k_blocks, int n, int h, int w, int c,
                    float res_scale, void* stream) {
  ChainArgs a{x, out, act, t, nullptr, w1, b1, w2, b2, nullptr, nullptr, nullptr, nullptr,
              k_blocks, n, h, w, c, res_scale, 1.0f};
  return launch_chain<false>(a, stream);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
