// Chains of residual blocks of the didbl generator, float32, for sm_90a, on
// the TF32 tensor cores in split precision (3xTF32, conv_tf32x3.cuh).
//
// Replaces the Pallas TPU kernels in image_enhance_keras_tpu/ops/pallas/tower.py:
//   * iek_light53_chain <- fused_light53_chain (_light53_body): K Light53
//     blocks back to back, each
//       ya = conv5(relu(conv3(x) + ba1)) + ba2
//       yb = conv3(relu(conv5(x) + bb1)) + bb2
//       x  = identity*x + res*(ya + yb)
//   * iek_light_chain   <- fused_light_chain (_light_body): K Light blocks,
//       x = x + res*(conv3(relu(conv3(x) + b1)) + b2)
// Weights are stacked on a leading K axis and come split and repacked by the
// wrapper (ops/cuda/tf32x3.py packed: [K][taps][C/8][hi/lo][2][C][4]);
// biases are (K, C).  All convs are SAME (zero padding) over NHWC
// activations with C = 128: each image of the batch is an independent tile.
//
// What bounds it on an H100: operations.  K blocks do K*2*68*C^2 FLOP per
// pixel for Light53 (K*2*18*C^2 for Light) against one read of x and one
// write of out.  Float32 FMA on the CUDA cores bounds that at 67 TFLOP/s;
// the tensor cores run TF32 at 495 TFLOP/s dense, and three TF32 products
// per multiply-add (hi*hi + hi*lo + lo*hi) keep float32's accuracy at an
// effective 165 TFLOP/s.  The split is the kernel's own: it does not depend
// on PyTorch's TF32 switches (engine.disable_tf32 turns those off for cuDNN
// and cuBLAS, whose single-pass TF32 would not meet the chain's 5e-5).
//
// Design.  The Pallas kernel keeps the tile's activation in VMEM across all
// K blocks and streams each block's weights in by double-buffered DMA.  A
// 96x96x128 float32 tile is 4.7 MB, far beyond one SM's 227 KB of shared
// memory, so here the activations live in device memory (a ping-pong pair:
// `act` and `out`, arranged so that block K-1 writes `out`) and the K blocks
// run inside one persistent cooperative launch, one thread block per SM:
//   per block k:  L2 prefetch of block k+1's packed weights (the counterpart
//                 of the TPU's second weight slot; 8.9 MB for Light53, the L2
//                 holds 50 MB);
//                 phase 1: first convs + bias + relu into scratch ta (tb),
//                 one work item per (tile, conv), Light53's conv5 items
//                 first (the longest first, then the conv3 items);
//                 grid-wide barrier;
//                 phase 2: second convs and the residual combine, in the
//                 chain body's order; ya is parked in the destination and
//                 read back by the same thread block;
//                 grid-wide barrier (except after the last block).
// Each work item is one 8-row x TILE_W-column tile of conv_tf32x3.cuh's
// implicit GEMM (wgmma.m64n128k8.f32.tf32.tf32).  Activations written
// inside the launch are read through L2 (__ldcg), never through the
// read-only path; cooperative_groups' grid sync orders the phases.  The
// epilogues keep the explicitly rounded order of the plain version
// (__fadd_rn/__fmul_rn, no FMA contraction), so only the products' order and
// split differ from it.

#include <cooperative_groups.h>

#include "conv_tf32x3.cuh"

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
  int k_blocks, n, h, w;
  float res_scale, identity_scale;
};

// Spread over the whole grid: prefetch.global.L2 of every 128-byte line.
__device__ __forceinline__ void prefetch_l2(const float* p, size_t n_floats) {
  const size_t lines = (n_floats * sizeof(float) + 127) / 128;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < lines; i += stride)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(reinterpret_cast<const char*>(p) + i * 128));
}

template <bool kLight53>
__global__ void __launch_bounds__(THREADS, 1) chain_kernel(ChainArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) uint8_t smem[];
  float* st = reinterpret_cast<float*>(smem);
  const int H = a.h, W = a.w, K = a.k_blocks;
  const int tiles = tiles_per_image(H, W) * a.n;
  constexpr int branches = kLight53 ? 2 : 1;
  constexpr size_t TAP = 2 * C * C;  // packed floats per tap: hi and lo
  constexpr int KA2 = kLight53 ? 5 : 3;  // second conv of branch a
  const float res = a.res_scale, ident = a.identity_scale;
  float acc[MT][ACC];
  Ring ring = make_ring(smem);

  for (int k = 0; k < K; ++k) {
    float* dst = (K - 1 - k) % 2 == 0 ? a.out : a.act;
    const float* src = k == 0 ? a.x : (dst == a.out ? a.act : a.out);
    const float* wa1 = a.wa1 + k * 9 * TAP;
    const float* wa2 = a.wa2 + k * KA2 * KA2 * TAP;
    const float* wb1 = kLight53 ? a.wb1 + k * 25 * TAP : nullptr;
    const float* wb2 = kLight53 ? a.wb2 + k * 9 * TAP : nullptr;
    if (k + 1 < K) {
      prefetch_l2(wa1 + 9 * TAP, 9 * TAP);
      prefetch_l2(wa2 + KA2 * KA2 * TAP, KA2 * KA2 * TAP);
      if constexpr (kLight53) {
        prefetch_l2(wb1 + 25 * TAP, 25 * TAP);
        prefetch_l2(wb2 + 9 * TAP, 9 * TAP);
      }
    }

    // phase 1: tb = relu(conv5(src) + bb1) (Light53), ta = relu(conv3(src) + ba1)
    for (int it = blockIdx.x; it < tiles * branches; it += gridDim.x) {
      const bool branch_b = kLight53 && it < tiles;
      const Tile t = make_tile(branch_b || !kLight53 ? it : it - tiles, H, W);
      if (branch_b) {
        conv<5>(acc, smem, ring, src, wb1, t, H, W);
        emit_relu(acc, st, a.bb1 + k * C, a.tb, t, H, W);
      } else {
        conv<3>(acc, smem, ring, src, wa1, t, H, W);
        emit_relu(acc, st, a.ba1 + k * C, a.ta, t, H, W);
      }
    }
    grid.sync();

    // phase 2: the second convs and the residual combine
    for (int it = blockIdx.x; it < tiles; it += gridDim.x) {
      const Tile t = make_tile(it, H, W);
      conv<KA2>(acc, smem, ring, a.ta, wa2, t, H, W);
      stage_acc(acc, st);
      if constexpr (kLight53) {
        // ya = conv5(ta) + ba2, parked in dst; then yb = conv3(tb) + bb2
        const float* ba2 = a.ba2 + k * C;
        for_tile_pieces(t, H, W, [&](size_t g, int s, int ch) {
          st4(dst + g, add4(staged4(st, s), ldg4(ba2 + ch)));
        });
        conv<3>(acc, smem, ring, a.tb, wb2, t, H, W);
        stage_acc(acc, st);
        const float* bb2 = a.bb2 + k * C;
        for_tile_pieces(t, H, W, [&](size_t g, int s, int ch) {
          const float4 y = add4(ld4(dst + g), add4(staged4(st, s), ldg4(bb2 + ch)));
          st4(dst + g, add4(scale4(ident, ld4(src + g)), scale4(res, y)));
        });
      } else {
        const float* ba2 = a.ba2 + k * C;
        for_tile_pieces(t, H, W, [&](size_t g, int s, int ch) {
          st4(dst + g, add4(ld4(src + g), scale4(res, add4(staged4(st, s), ldg4(ba2 + ch)))));
        });
      }
    }
    if (k + 1 < K) grid.sync();
  }
}

template <bool kLight53>
int launch_chain(ChainArgs a, void* stream) {
  const int items = tiles_per_image(a.h, a.w) * a.n * (kLight53 ? 2 : 1);
  int dev = 0, coop = 0, grid = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = persistent_grid(chain_kernel<kLight53>, items, &grid);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chain_kernel<kLight53>), dim3(grid),
                                    dim3(THREADS), args, SMEM_BYTES, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Shapes the launches accept: C == 128, K >= 1, weights packed by the
// wrapper, every pointer 16-byte aligned, all tensors contiguous (the Python
// wrapper checks).  act, ta, tb and out are N*H*W*C float scratch/outputs,
// distinct from x.  Returns the CUDA error code of the launch (0 = success).
int iek_light53_chain(const float* x,
                      const float* wa1, const float* ba1, const float* wa2, const float* ba2,
                      const float* wb1, const float* bb1, const float* wb2, const float* bb2,
                      float* act, float* ta, float* tb, float* out,
                      int k_blocks, int n, int h, int w, int c,
                      float res_scale, float identity_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  ChainArgs a{x, out, act, ta, tb, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
              k_blocks, n, h, w, res_scale, identity_scale};
  return launch_chain<true>(a, stream);
}

int iek_light_chain(const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
                    float* act, float* t, float* out, int k_blocks, int n, int h, int w, int c,
                    float res_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  ChainArgs a{x, out, act, t, nullptr, w1, b1, w2, b2, nullptr, nullptr, nullptr, nullptr,
              k_blocks, n, h, w, res_scale, 1.0f};
  return launch_chain<false>(a, stream);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
