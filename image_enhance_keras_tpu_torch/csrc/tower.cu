// Chains of residual blocks of the didbl generator, float32 and bf16, for
// sm_90a: float32 on the TF32 tensor cores in split precision (3xTF32), on
// the tile of conv_tf32x3.cuh; bf16 on the bf16 tensor cores, on the tile of
// conv_bf16.cuh.
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
// Bounded by operations: K*2*68*C^2 FLOP per pixel at 989 TFLOP/s dense
// bf16.  The bf16 chain runs the same phases on conv_bf16.cuh's persistent
// warp-specialised tile (chain_kernel_bf16), one cooperative launch; phase 2
// keeps ya and bf16(identity*x) in the registers across Light53's conv3,
// and ta, tb and each block's output leave through the staged tile.  The
// writers of each phase fence the async proxy before the grid barrier, so
// that the next phase's TMA windows read what they wrote.

#include <cooperative_groups.h>

#include "conv_bf16.cuh"
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

// prefetch.global.L2 of every 128-byte line, spread over `lanes` threads of
// every block of the grid; this thread is lane `lane` of its block's.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes, int lane, int lanes) {
  const size_t lines = (bytes + 127) / 128;
  const size_t stride = (size_t)gridDim.x * lanes;
  for (size_t i = (size_t)blockIdx.x * lanes + lane; i < lines; i += stride)
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
  constexpr size_t TAP = TAP_BYTES / sizeof(float);  // packed elements per tap
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
      prefetch_l2(wa1 + 9 * TAP, 9 * TAP_BYTES, threadIdx.x, blockDim.x);
      prefetch_l2(wa2 + KA2 * KA2 * TAP, KA2 * KA2 * TAP_BYTES, threadIdx.x, blockDim.x);
      if constexpr (kLight53) {
        prefetch_l2(wb1 + 25 * TAP, 25 * TAP_BYTES, threadIdx.x, blockDim.x);
        prefetch_l2(wb2 + 9 * TAP, 9 * TAP_BYTES, threadIdx.x, blockDim.x);
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
          const float4 u = add4(staged4(st, s), ldg4(ba2 + ch));
          st4(dst + g, add4(ld4(src + g), scale4(res, u)));
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

// ---- the bf16 forms, on conv_bf16.cuh ---------------------------------------------

namespace bf16_tile {

struct Bf16ChainArgs {
  CUtensorMap src5[3], src3[3];  // the 5x5 and 3x3 windows of x, act and out
  CUtensorMap ta;                // ta's: 5x5 (Light53) or 3x3 (Light)
  CUtensorMap tb3;               // tb's: 3x3 (Light53)
  const bf16* x;  // (N, H, W, C) input of block 0
  bf16* act;      // the other activation buffer
  bf16* out;      // output of block K-1
  bf16* ta_out;
  bf16* tb_out;
  const bf16* wa1; const float* ba1;  // Light53 conv_a1 (3x3); Light conv_a (3x3)
  const bf16* wa2; const float* ba2;  // Light53 conv_a2 (5x5); Light conv_b (3x3)
  const bf16* wb1; const float* bb1;  // Light53 conv_b1 (5x5)
  const bf16* wb2; const float* bb2;  // Light53 conv_b2 (3x3)
  int k_blocks, n, h, w;
  float res_scale, identity_scale;
};

// The activation buffers of block k of K: src (0 x, 1 act, 2 out) and dst,
// arranged so that block K-1 writes out.
__device__ __forceinline__ int dst_of(int k, int K) { return (K - 1 - k) % 2 == 0 ? 2 : 1; }
__device__ __forceinline__ int src_of(int k, int K) { return k == 0 ? 0 : 3 - dst_of(k, K); }

template <bool kLight53>
__global__ void __launch_bounds__(THREADS, 1) chain_kernel_bf16(const __grid_constant__ Bf16ChainArgs a) {
  cg::grid_group grid = cg::this_grid();
  init_barriers();
  const int H = a.h, W = a.w, K = a.k_blocks;
  const int tiles = tiles_per_image(H, W) * a.n, items1 = tiles * (kLight53 ? 2 : 1);
  constexpr size_t TAP = (size_t)C * C;  // bf16 weights a tap
  constexpr int KA2 = kLight53 ? 5 : 3;  // second conv of branch a
  uint32_t g = 0, j = 0;
  if (threadIdx.x < 128) {  // the producer warpgroup, with few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    for (int k = 0; k < K; ++k) {
      const int si = src_of(k, K);
      const bf16* wa1 = a.wa1 + k * 9 * TAP;
      const bf16* wa2 = a.wa2 + k * KA2 * KA2 * TAP;
      const bf16* wb1 = a.wb1 + k * 25 * TAP;
      const bf16* wb2 = a.wb2 + k * 9 * TAP;
      if (k + 1 < K && threadIdx.x >= 64) {  // block k+1's weights into the L2, by warps 2-3
        prefetch_l2(wa1 + 9 * TAP, 9 * TAP * 2, threadIdx.x - 64, 64);
        prefetch_l2(wa2 + KA2 * KA2 * TAP, KA2 * KA2 * TAP * 2, threadIdx.x - 64, 64);
        if constexpr (kLight53) {
          prefetch_l2(wb1 + 25 * TAP, 25 * TAP * 2, threadIdx.x - 64, 64);
          prefetch_l2(wb2 + 9 * TAP, 9 * TAP * 2, threadIdx.x - 64, 64);
        }
      }
      // phase 1: tb = bf16(relu(conv5(src) + bb1)) (Light53), ta = bf16(relu(conv3(src) + ba1))
      for (int q = blockIdx.x; q < items1; q += gridDim.x)
        produce_first<kLight53>(q, tiles, H, W, &a.src5[si], &a.src3[si], wb1, wa1, g, j);
      grid.sync();
      fence_proxy_async();  // the phase's stores come before this phase's TMA reads
      // phase 2: the second convs over ta (and tb)
      for (int q = blockIdx.x; q < tiles; q += gridDim.x)
        produce_second<kLight53>(q, H, W, &a.ta, &a.tb3, wa2, wb2, g, j);
      if (k + 1 < K) {
        grid.sync();
        fence_proxy_async();
      }
    }
  } else {  // the consumers, with the registers it gave up
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const float res = a.res_scale, ident = a.identity_scale;
    float acc[ACC], p0[ACC], p1[ACC];
    for (int k = 0; k < K; ++k) {
      const int di = dst_of(k, K), si = src_of(k, K);
      bf16* dst = di == 2 ? a.out : a.act;
      const bf16* src = si == 0 ? a.x : si == 1 ? a.act : a.out;
      const float* ba2 = a.ba2 + k * C;
      const float* bb2 = a.bb2 + k * C;
      for (int q = blockIdx.x; q < items1; q += gridDim.x)
        consume_first<kLight53>(q, tiles, H, W, cw, a.bb1 + k * C, a.ba1 + k * C, a.tb_out, a.ta_out, acc, p0, g, j);
      fence_proxy_async();  // ta, tb before the next phase's TMA reads
      grid.sync();
      for (int q = blockIdx.x; q < tiles; q += gridDim.x) {
        const Tile t = make_tile(q, H, W);
        const Frag f = frag(t, H, W, cw);
        uint32_t v[32];
        if constexpr (kLight53) {
          conv<5>(acc, p0, window(j, cw), g);
          release_window(j++);
          // ya = bf16(conv5(ta) + ba2) and bf16(identity * src), held across conv3(tb)
          uint32_t ya[32], xs[32];
#pragma unroll
          for (int n8 = 0; n8 < C / 8; ++n8) {
            const float2 b = bias2(ba2, f, n8);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * n8 + 2 * h;
              const uint32_t sv = ld_pair(src, f, t, H, W, h, n8);
              ya[2 * n8 + h] = pack_bf16(__fadd_rn(acc[i], b.x), __fadd_rn(acc[i + 1], b.y));
              xs[2 * n8 + h] = pack_bf16(__fmul_rn(ident, bf_lo(sv)), __fmul_rn(ident, bf_hi(sv)));
            }
          }
          conv<3>(p0, p1, window(j, cw), g);
          // y = bf16(ya + bf16(conv3(tb) + bb2)); x = bf16(bf16(identity * x) + bf16(res * y))
#pragma unroll
          for (int n8 = 0; n8 < C / 8; ++n8) {
            const float2 b = bias2(bb2, f, n8);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * n8 + 2 * h, e = 2 * n8 + h;
              const float y0 = rnd(__fadd_rn(bf_lo(ya[e]), rnd(__fadd_rn(p0[i], b.x))));
              const float y1 = rnd(__fadd_rn(bf_hi(ya[e]), rnd(__fadd_rn(p0[i + 1], b.y))));
              v[e] = pack_bf16(__fadd_rn(bf_lo(xs[e]), rnd(__fmul_rn(res, y0))),
                               __fadd_rn(bf_hi(xs[e]), rnd(__fmul_rn(res, y1))));
            }
          }
        } else {
          conv<3>(acc, p0, window(j, cw), g);
          // u = bf16(conv3(ta) + b2); x = bf16(x + bf16(res * u))
#pragma unroll
          for (int n8 = 0; n8 < C / 8; ++n8) {
            const float2 b = bias2(ba2, f, n8);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * n8 + 2 * h;
              const uint32_t sv = ld_pair(src, f, t, H, W, h, n8);
              const float u0 = rnd(__fadd_rn(acc[i], b.x)), u1 = rnd(__fadd_rn(acc[i + 1], b.y));
              v[2 * n8 + h] = pack_bf16(__fadd_rn(bf_lo(sv), rnd(__fmul_rn(res, u0))),
                                        __fadd_rn(bf_hi(sv), rnd(__fmul_rn(res, u1))));
            }
          }
        }
        consumers_sync();
        store_tile(v, j, dst, t, H, W, cw);
        release_window(j++);
      }
      fence_proxy_async();  // the block's output before the next block's TMA reads
      if (k + 1 < K) grid.sync();
    }
  }
}

template <bool kLight53>
int launch_chain_bf16(Bf16ChainArgs& a, void* stream) {
  static Fit fit;
  const int tiles = tiles_per_image(a.h, a.w) * a.n;
  if (tiles == 0) return (int)cudaSuccess;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const bf16* acts[3] = {a.x, a.act, a.out};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    err = window_map<5>(&a.src5[i], acts[i], a.n, a.h, a.w);
    if (err == cudaSuccess) err = window_map<3>(&a.src3[i], acts[i], a.n, a.h, a.w);
  }
  if (err == cudaSuccess) err = kLight53 ? window_map<5>(&a.ta, a.ta_out, a.n, a.h, a.w)
                                         : window_map<3>(&a.ta, a.ta_out, a.n, a.h, a.w);
  if (err == cudaSuccess && kLight53) err = window_map<3>(&a.tb3, a.tb_out, a.n, a.h, a.w);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(chain_kernel_bf16<kLight53>, a, tiles * (kLight53 ? 2 : 1), true, fit,
                      static_cast<cudaStream_t>(stream));
}

}  // namespace bf16_tile
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

// The bf16 forms: activations and scratch bf16, weights packed to bf16 by
// the wrapper, biases float32; res_scale and identity_scale the bf16 values
// of the scales.
int iek_light53_chain_bf16(const bf16_tile::bf16* x,
                           const bf16_tile::bf16* wa1, const float* ba1, const bf16_tile::bf16* wa2,
                           const float* ba2, const bf16_tile::bf16* wb1, const float* bb1,
                           const bf16_tile::bf16* wb2, const float* bb2,
                           bf16_tile::bf16* act, bf16_tile::bf16* ta, bf16_tile::bf16* tb, bf16_tile::bf16* out,
                           int k_blocks, int n, int h, int w, int c,
                           float res_scale, float identity_scale, void* stream) {
  if (c != bf16_tile::C) return (int)cudaErrorInvalidValue;
  bf16_tile::Bf16ChainArgs a{};
  a.x = x; a.act = act; a.out = out; a.ta_out = ta; a.tb_out = tb;
  a.wa1 = wa1; a.ba1 = ba1; a.wa2 = wa2; a.ba2 = ba2; a.wb1 = wb1; a.bb1 = bb1; a.wb2 = wb2; a.bb2 = bb2;
  a.k_blocks = k_blocks; a.n = n; a.h = h; a.w = w; a.res_scale = res_scale; a.identity_scale = identity_scale;
  return bf16_tile::launch_chain_bf16<true>(a, stream);
}

int iek_light_chain_bf16(const bf16_tile::bf16* x, const bf16_tile::bf16* w1, const float* b1,
                         const bf16_tile::bf16* w2, const float* b2, bf16_tile::bf16* act, bf16_tile::bf16* t,
                         bf16_tile::bf16* out, int k_blocks, int n, int h, int w, int c,
                         float res_scale, void* stream) {
  if (c != bf16_tile::C) return (int)cudaErrorInvalidValue;
  bf16_tile::Bf16ChainArgs a{};
  a.x = x; a.act = act; a.out = out; a.ta_out = t;
  a.wa1 = w1; a.ba1 = b1; a.wa2 = w2; a.ba2 = b2;
  a.k_blocks = k_blocks; a.n = n; a.h = h; a.w = w; a.res_scale = res_scale; a.identity_scale = 1.0f;
  return bf16_tile::launch_chain_bf16<false>(a, stream);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
