// Chains of residual blocks of the didbl generator, float32 and bf16, for
// sm_90a: float32 on the TF32 tensor cores in split precision (3xTF32), bf16
// on the bf16 tensor cores, both on the tile of conv_tf32x3.cuh.
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
//
// bf16 (iek_light53_chain_bf16, iek_light_chain_bf16): activations and
// scratch bf16, weights cast to bf16 by the wrapper (ops/cuda/bf16.py
// packed), biases float32, as fused_light53_chain takes them.  Each conv
// plus bias rounds to bf16 at once, and the combine runs in bf16, one
// rounding (to nearest even) per step, as the chain body does (_light53_body):
//   ya = bf16(conv5(ta) + ba2), yb = bf16(conv3(tb) + bb2), y = bf16(ya + yb),
//   x  = bf16(bf16(identity*x) + bf16(res*y)),
// identity and res the bf16 values of the scales (0.8984375, 0.10009765625).
// ya is parked in the destination (bf16 already).  Bounded by operations:
// K*2*68*C^2 FLOP per pixel at 989 TFLOP/s dense bf16.

#include <cooperative_groups.h>

#include "conv_tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
struct ChainArgs {
  const T* x;  // (N, H, W, C) input of block 0
  T* out;      // output of block K-1
  T* act;      // the other activation buffer
  T* ta;       // first-conv intermediates (Light53 branch a, or Light)
  T* tb;       // Light53 branch b
  const T* wa1; const float* ba1;  // Light53 conv_a1 (3x3); Light conv_a (3x3)
  const T* wa2; const float* ba2;  // Light53 conv_a2 (5x5); Light conv_b (3x3)
  const T* wb1; const float* bb1;  // Light53 conv_b1 (5x5)
  const T* wb2; const float* bb2;  // Light53 conv_b2 (3x3)
  int k_blocks, n, h, w;
  float res_scale, identity_scale;
};

// Spread over the whole grid: prefetch.global.L2 of every 128-byte line.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const size_t lines = (bytes + 127) / 128;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < lines; i += stride)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(reinterpret_cast<const char*>(p) + i * 128));
}

template <bool kLight53, typename T>
__global__ void __launch_bounds__(THREADS, 1) chain_kernel(ChainArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) uint8_t smem[];
  float* st = reinterpret_cast<float*>(smem);
  const int H = a.h, W = a.w, K = a.k_blocks;
  const int tiles = tiles_per_image(H, W) * a.n;
  constexpr int branches = kLight53 ? 2 : 1;
  constexpr size_t TAP_BYTES = Policy<T>::TAP_BYTES;
  constexpr size_t TAP = TAP_BYTES / sizeof(T);  // packed elements per tap
  constexpr int KA2 = kLight53 ? 5 : 3;  // second conv of branch a
  const float res = a.res_scale, ident = a.identity_scale;
  float acc[MT][ACC];
  Ring ring = make_ring(smem);

  for (int k = 0; k < K; ++k) {
    T* dst = (K - 1 - k) % 2 == 0 ? a.out : a.act;
    const T* src = k == 0 ? a.x : (dst == a.out ? a.act : a.out);
    const T* wa1 = a.wa1 + k * 9 * TAP;
    const T* wa2 = a.wa2 + k * KA2 * KA2 * TAP;
    const T* wb1 = kLight53 ? a.wb1 + k * 25 * TAP : nullptr;
    const T* wb2 = kLight53 ? a.wb2 + k * 9 * TAP : nullptr;
    if (k + 1 < K) {
      prefetch_l2(wa1 + 9 * TAP, 9 * TAP_BYTES);
      prefetch_l2(wa2 + KA2 * KA2 * TAP, KA2 * KA2 * TAP_BYTES);
      if constexpr (kLight53) {
        prefetch_l2(wb1 + 25 * TAP, 25 * TAP_BYTES);
        prefetch_l2(wb2 + 9 * TAP, 9 * TAP_BYTES);
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

    // phase 2: the second convs and the residual combine (rnd4: the bf16
    // form's rounding after each step; nothing for float32)
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
          const float4 y = rnd4<T>(add4(ld4(dst + g), rnd4<T>(add4(staged4(st, s), ldg4(bb2 + ch)))));
          st4(dst + g, add4(rnd4<T>(scale4(ident, ld4(src + g))), rnd4<T>(scale4(res, y))));
        });
      } else {
        const float* ba2 = a.ba2 + k * C;
        for_tile_pieces(t, H, W, [&](size_t g, int s, int ch) {
          const float4 u = rnd4<T>(add4(staged4(st, s), ldg4(ba2 + ch)));
          st4(dst + g, add4(ld4(src + g), rnd4<T>(scale4(res, u))));
        });
      }
    }
    if (k + 1 < K) grid.sync();
  }
}

template <bool kLight53, typename T>
int launch_chain(ChainArgs<T> a, void* stream) {
  const int items = tiles_per_image(a.h, a.w) * a.n * (kLight53 ? 2 : 1);
  int dev = 0, coop = 0, grid = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = persistent_grid(chain_kernel<kLight53, T>, items, &grid);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chain_kernel<kLight53, T>), dim3(grid),
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
  ChainArgs<float> a{x, out, act, ta, tb, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                     k_blocks, n, h, w, res_scale, identity_scale};
  return launch_chain<true>(a, stream);
}

int iek_light_chain(const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
                    float* act, float* t, float* out, int k_blocks, int n, int h, int w, int c,
                    float res_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  ChainArgs<float> a{x, out, act, t, nullptr, w1, b1, w2, b2, nullptr, nullptr, nullptr, nullptr,
                     k_blocks, n, h, w, res_scale, 1.0f};
  return launch_chain<false>(a, stream);
}

// The bf16 forms: activations and scratch bf16, weights packed to bf16 by
// the wrapper, biases float32; res_scale and identity_scale the bf16 values
// of the scales.
int iek_light53_chain_bf16(const bf16* x,
                           const bf16* wa1, const float* ba1, const bf16* wa2, const float* ba2,
                           const bf16* wb1, const float* bb1, const bf16* wb2, const float* bb2,
                           bf16* act, bf16* ta, bf16* tb, bf16* out,
                           int k_blocks, int n, int h, int w, int c,
                           float res_scale, float identity_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  ChainArgs<bf16> a{x, out, act, ta, tb, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                    k_blocks, n, h, w, res_scale, identity_scale};
  return launch_chain<true>(a, stream);
}

int iek_light_chain_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                         bf16* act, bf16* t, bf16* out, int k_blocks, int n, int h, int w, int c,
                         float res_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  ChainArgs<bf16> a{x, out, act, t, nullptr, w1, b1, w2, b2, nullptr, nullptr, nullptr, nullptr,
                    k_blocks, n, h, w, res_scale, 1.0f};
  return launch_chain<false>(a, stream);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
