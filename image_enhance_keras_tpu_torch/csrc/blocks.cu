// Fused residual blocks of the didbl generator, float32 and bf16, for
// sm_90a: float32 on the TF32 tensor cores in split precision (3xTF32), on
// the tile of conv_tf32x3.cuh; bf16 on the bf16 tensor cores, on the tile of
// conv_bf16.cuh.
//
// Replaces the Pallas TPU kernels in image_enhance_keras_tpu/ops/pallas/blocks.py:
//   * iek_light53_block <- fused_light53_block (_light53_kernel):
//       out = res * ((id/res)*x + (ba2 + bb2) + conv5(relu(conv3(x) + ba1))
//                                             + conv3(relu(conv5(x) + bb1)))
//   * iek_light_block   <- fused_light_block (_light_kernel):
//       out = x + res * (conv3(relu(conv3(x) + b1)) + b2)
// Weights come split and repacked by the wrapper (ops/cuda/tf32x3.py packed:
// [taps][C/8][hi/lo][2][C][4]); biases are (C,).  All convs are SAME (zero
// padding) over NHWC activations with C = 128.
//
// What bounds it on an H100: operations.  A Light53 block does 68 taps of a
// C x C product per pixel (2*68*C^2 FLOP), a Light block 18, against one
// read of x and one write of out.  Float32 FMA on the CUDA cores bounds that
// at 67 TFLOP/s; the tensor cores run TF32 at 495 TFLOP/s dense, and three
// TF32 products per multiply-add (hi*hi + hi*lo + lo*hi) keep float32's
// accuracy at an effective 165 TFLOP/s.
//
// Design.  The Pallas kernel holds a whole 96x96x128 tile with its halo in
// VMEM; that does not fit in one SM's 227 KB of shared memory, so each block
// is two ordinary launches, each a persistent grid of conv_tf32x3.cuh's
// thread blocks looping over work items (one item: one 8-row x 16-column
// tile of the implicit GEMM, wgmma.m64n128k8.f32.tf32.tf32):
//   1. first convs with bias and relu into N*H*W*C scratch; Light53's conv5
//      items (tb) first, then its conv3 items (ta), the longest first;
//   2. second convs and the residual combine, one item per tile, in
//      _light53_kernel's order: parked = (id/res)*x + (ba2 + bb2) + conv5(ta)
//      is written to out and read back by the same thread block after
//      conv3(tb): out = res * (parked + conv3(tb)).  Light: out = x + res *
//      (conv3(t) + b2).
// SAME padding is a bounds check that reads zero; on scratch that covers the
// whole image this is exactly the zero-padded intermediate of _relu_pad.
// The epilogues keep the plain version's explicitly rounded order
// (__fadd_rn/__fmul_rn, no FMA contraction), so only the products' order and
// split differ from it.
//
// bf16 (iek_light53_block_bf16, iek_light_block_bf16): x, ta, tb and out
// are bf16, the weights cast to bf16 by the wrapper (ops/cuda/bf16.py
// packed), the biases float32, as the TPU kernels take them
// (fused_light53_block casts the weights to x's dtype).  ta and tb are
// bf16(relu(conv + bias)); the combine runs in float32 in the same order as
// the float32 kernels', and only the final store rounds (to nearest even):
// out = bf16(res * (((id/res)*x + (ba2 + bb2) + conv5(ta)) + conv3(tb))).
// Bounded by operations as well: 2*68*C^2 FLOP per pixel at 989 TFLOP/s
// dense bf16.  Two launches of conv_bf16.cuh's persistent warp-specialised
// kernels:
//   1. first_kernel_bf16: one item a (tile, conv), Light53's conv5 items
//      (tb) first, then the conv3 items (ta), ta / tb out through the staged
//      tile;
//   2. second_kernel_bf16: one item a tile.  Light53: conv5 over ta's window
//      (two sums in flight), then the float32 partial sum
//      (id/res)*x + (ba2 + bb2) + conv5(ta) stays in the registers across
//      conv3 over tb's window (one sum in flight), and out leaves once.
//      Light: conv3 over t's window, out = x + res * (conv3(t) + b2).

#include "conv_bf16.cuh"
#include "conv_tf32x3.cuh"

namespace {

struct BlockArgs {
  const float* x;  // (N, H, W, C) input
  float* ta;       // first-conv scratch: Light53 branch a, or Light
  float* tb;       // Light53 branch b
  float* out;      // also Light53's parked partial sum
  const float* wa1; const float* ba1;  // Light53 conv_a1 (3x3); Light conv_a (3x3)
  const float* wa2; const float* ba2;  // Light53 conv_a2 (5x5); Light conv_b (3x3)
  const float* wb1; const float* bb1;  // Light53 conv_b1 (5x5)
  const float* wb2; const float* bb2;  // Light53 conv_b2 (3x3)
  int n, h, w;
  float res_scale, ident_over_res;
};

// Launch 1: tb = relu(conv5(x) + bb1) (Light53, items [0, tiles)), then
// ta = relu(conv3(x) + ba1).
template <bool kLight53>
__global__ void __launch_bounds__(THREADS, 1) first_kernel(BlockArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* st = reinterpret_cast<float*>(smem);
  const int H = a.h, W = a.w;
  const int tiles = tiles_per_image(H, W) * a.n;
  constexpr int branches = kLight53 ? 2 : 1;
  float acc[MT][ACC];
  Ring ring = make_ring(smem);
  for (int it = blockIdx.x; it < tiles * branches; it += gridDim.x) {
    if (kLight53 && it < tiles) {
      const Tile t = make_tile(it, H, W);
      conv<5>(acc, smem, ring, a.x, a.wb1, t, H, W);
      emit_relu(acc, st, a.bb1, a.tb, t, H, W);
    } else {
      const Tile t = make_tile(kLight53 ? it - tiles : it, H, W);
      conv<3>(acc, smem, ring, a.x, a.wa1, t, H, W);
      emit_relu(acc, st, a.ba1, a.ta, t, H, W);
    }
  }
}

// Launch 2: the second convs and the residual combine.
template <bool kLight53>
__global__ void __launch_bounds__(THREADS, 1) second_kernel(BlockArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* st = reinterpret_cast<float*>(smem);
  const int H = a.h, W = a.w;
  const int tiles = tiles_per_image(H, W) * a.n;
  const float res = a.res_scale;
  float acc[MT][ACC];
  Ring ring = make_ring(smem);
  for (int it = blockIdx.x; it < tiles; it += gridDim.x) {
    const Tile t = make_tile(it, H, W);
    conv<kLight53 ? 5 : 3>(acc, smem, ring, a.ta, a.wa2, t, H, W);
    stage_acc(acc, st);
    if constexpr (kLight53) {
      // (id/res)*x + (ba2 + bb2) + conv5(ta), parked
      const float ior = a.ident_over_res;
      for_tile_pieces(t, H, W, [&](size_t g, int s, int ch) {
        const float4 acc0 = add4(scale4(ior, ld4(a.x + g)), add4(ldg4(a.ba2 + ch), ldg4(a.bb2 + ch)));
        st4(a.out + g, add4(acc0, staged4(st, s)));
      });
      conv<3>(acc, smem, ring, a.tb, a.wb2, t, H, W);
      stage_acc(acc, st);
      for_tile_pieces(t, H, W, [&](size_t g, int s, int ch) {
        st4(a.out + g, scale4(res, add4(ld4(a.out + g), staged4(st, s))));
      });
    } else {
      for_tile_pieces(t, H, W, [&](size_t g, int s, int ch) {
        st4(a.out + g, add4(ld4(a.x + g), scale4(res, add4(staged4(st, s), ldg4(a.ba2 + ch)))));
      });
    }
  }
}

template <bool kLight53>
int launch_block(const BlockArgs& a, void* stream) {
  const int tiles = tiles_per_image(a.h, a.w) * a.n;
  if (tiles == 0) return (int)cudaSuccess;
  int grid1 = 0, grid2 = 0;
  cudaError_t err = persistent_grid(first_kernel<kLight53>, tiles * (kLight53 ? 2 : 1), &grid1);
  if (err == cudaSuccess) err = persistent_grid(second_kernel<kLight53>, tiles, &grid2);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  first_kernel<kLight53><<<grid1, THREADS, SMEM_BYTES, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  second_kernel<kLight53><<<grid2, THREADS, SMEM_BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- the bf16 forms, on conv_bf16.cuh ---------------------------------------------

namespace {
namespace bf16_tile {

struct Bf16BlockArgs {
  CUtensorMap x5, x3;  // x's windows of the 5x5 and the 3x3 convs
  CUtensorMap ta;      // ta's: 5x5 (Light53) or 3x3 (Light)
  CUtensorMap tb3;     // tb's: 3x3 (Light53)
  const bf16* x;
  bf16* ta_out;
  bf16* tb_out;
  bf16* out;
  const bf16* wa1; const float* ba1;  // Light53 conv_a1 (3x3); Light conv_a (3x3)
  const bf16* wa2; const float* ba2;  // Light53 conv_a2 (5x5); Light conv_b (3x3)
  const bf16* wb1; const float* bb1;  // Light53 conv_b1 (5x5)
  const bf16* wb2; const float* bb2;  // Light53 conv_b2 (3x3)
  int n, h, w;
  float res_scale, ident_over_res;
};

// Launch 1: tb = bf16(relu(conv5(x) + bb1)) (Light53, the first items),
// then ta = bf16(relu(conv3(x) + ba1)).
template <bool kLight53>
__global__ void __launch_bounds__(THREADS, 1) first_kernel_bf16(const __grid_constant__ Bf16BlockArgs a) {
  init_barriers();
  const int H = a.h, W = a.w;
  const int tiles = tiles_per_image(H, W) * a.n, items = tiles * (kLight53 ? 2 : 1);
  uint32_t g = 0, j = 0;
  if (threadIdx.x < 128) {  // the producer warpgroup, with few registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    for (int q = blockIdx.x; q < items; q += gridDim.x)
      produce_first<kLight53>(q, tiles, H, W, &a.x5, &a.x3, a.wb1, a.wa1, g, j);
  } else {  // the consumers, with the registers it gave up
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    float acc[ACC], p0[ACC];
    for (int q = blockIdx.x; q < items; q += gridDim.x)
      consume_first<kLight53>(q, tiles, H, W, cw, a.bb1, a.ba1, a.tb_out, a.ta_out, acc, p0, g, j);
  }
}

// Launch 2: the second convs and the residual combine.
template <bool kLight53>
__global__ void __launch_bounds__(THREADS, 1) second_kernel_bf16(const __grid_constant__ Bf16BlockArgs a) {
  init_barriers();
  const int H = a.h, W = a.w;
  const int tiles = tiles_per_image(H, W) * a.n;
  uint32_t g = 0, j = 0;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    for (int q = blockIdx.x; q < tiles; q += gridDim.x)
      produce_second<kLight53>(q, H, W, &a.ta, &a.tb3, a.wa2, a.wb2, g, j);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const float res = a.res_scale;
    float acc[ACC], p0[ACC], p1[ACC];
    for (int q = blockIdx.x; q < tiles; q += gridDim.x) {
      const Tile t = make_tile(q, H, W);
      const Frag f = frag(t, H, W, cw);
      uint32_t v[32];
      if constexpr (kLight53) {
        conv<5>(acc, p0, window(j, cw), g);
        release_window(j++);
        // park = (id/res)*x + (ba2 + bb2) + conv5(ta), in acc
        const float ior = a.ident_over_res;
#pragma unroll
        for (int n8 = 0; n8 < C / 8; ++n8) {
          const float2 b2 = bias2(a.ba2, f, n8), c2 = bias2(a.bb2, f, n8);
          const float bx = __fadd_rn(b2.x, c2.x), by = __fadd_rn(b2.y, c2.y);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t xv = ld_pair(a.x, f, t, H, W, h, n8);
            const int i = 4 * n8 + 2 * h;
            acc[i] = __fadd_rn(__fadd_rn(__fmul_rn(ior, bf_lo(xv)), bx), acc[i]);
            acc[i + 1] = __fadd_rn(__fadd_rn(__fmul_rn(ior, bf_hi(xv)), by), acc[i + 1]);
          }
        }
        conv<3>(p0, p1, window(j, cw), g);
        // out = bf16(res * (park + conv3(tb)))
#pragma unroll
        for (int n8 = 0; n8 < C / 8; ++n8)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * n8 + 2 * h;
            v[2 * n8 + h] = pack_bf16(__fmul_rn(res, __fadd_rn(acc[i], p0[i])),
                                      __fmul_rn(res, __fadd_rn(acc[i + 1], p0[i + 1])));
          }
      } else {
        conv<3>(acc, p0, window(j, cw), g);
        // out = bf16(x + res * (conv3(t) + b2))
#pragma unroll
        for (int n8 = 0; n8 < C / 8; ++n8) {
          const float2 b = bias2(a.ba2, f, n8);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t xv = ld_pair(a.x, f, t, H, W, h, n8);
            const int i = 4 * n8 + 2 * h;
            v[2 * n8 + h] = pack_bf16(__fadd_rn(bf_lo(xv), __fmul_rn(res, __fadd_rn(acc[i], b.x))),
                                      __fadd_rn(bf_hi(xv), __fmul_rn(res, __fadd_rn(acc[i + 1], b.y))));
          }
        }
      }
      consumers_sync();
      store_tile(v, j, a.out, t, H, W, cw);
      release_window(j++);
    }
  }
}

template <bool kLight53>
int launch_block_bf16(Bf16BlockArgs& a, void* stream) {
  static Fit fit1, fit2;
  const int tiles = tiles_per_image(a.h, a.w) * a.n;
  if (tiles == 0) return (int)cudaSuccess;
  cudaError_t err = window_map<5>(&a.x5, a.x, a.n, a.h, a.w);
  if (err == cudaSuccess) err = window_map<3>(&a.x3, a.x, a.n, a.h, a.w);
  if (err == cudaSuccess) err = kLight53 ? window_map<5>(&a.ta, a.ta_out, a.n, a.h, a.w)
                                         : window_map<3>(&a.ta, a.ta_out, a.n, a.h, a.w);
  if (err == cudaSuccess && kLight53) err = window_map<3>(&a.tb3, a.tb_out, a.n, a.h, a.w);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch(first_kernel_bf16<kLight53>, a, tiles * (kLight53 ? 2 : 1), false, fit1, st);
  if (err == cudaSuccess) err = launch(second_kernel_bf16<kLight53>, a, tiles, false, fit2, st);
  return (int)err;
}

}  // namespace bf16_tile
}  // namespace

extern "C" {

// Shapes the launches accept: C == 128, weights packed by the wrapper, every
// pointer 16-byte aligned, all tensors contiguous (the Python wrapper
// checks).  ta, tb and out are N*H*W*C float scratch/outputs, distinct from
// x.  Returns the CUDA error code of the launches (0 = success).
int iek_light53_block(const float* x,
                      const float* wa1, const float* ba1, const float* wa2, const float* ba2,
                      const float* wb1, const float* bb1, const float* wb2, const float* bb2,
                      float* ta, float* tb, float* out,
                      int n, int h, int w, int c, float res_scale, float ident_over_res,
                      void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  const BlockArgs a{x, ta, tb, out, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2,
                    n, h, w, res_scale, ident_over_res};
  return launch_block<true>(a, stream);
}

int iek_light_block(const float* x, const float* w1, const float* b1,
                    const float* w2, const float* b2, float* t, float* out,
                    int n, int h, int w, int c, float res_scale, void* stream) {
  if (c != C) return (int)cudaErrorInvalidValue;
  const BlockArgs a{x, t, nullptr, out, w1, b1, w2, b2, nullptr, nullptr, nullptr, nullptr,
                    n, h, w, res_scale, 1.0f};
  return launch_block<false>(a, stream);
}

// The bf16 forms: x, ta, tb and out bf16 (N*H*W*C), weights packed to bf16
// by the wrapper, biases float32.
int iek_light53_block_bf16(const bf16_tile::bf16* x,
                           const bf16_tile::bf16* wa1, const float* ba1, const bf16_tile::bf16* wa2, const float* ba2,
                           const bf16_tile::bf16* wb1, const float* bb1, const bf16_tile::bf16* wb2, const float* bb2,
                           bf16_tile::bf16* ta, bf16_tile::bf16* tb, bf16_tile::bf16* out,
                           int n, int h, int w, int c, float res_scale, float ident_over_res,
                           void* stream) {
  if (c != bf16_tile::C) return (int)cudaErrorInvalidValue;
  bf16_tile::Bf16BlockArgs a{};
  a.x = x; a.ta_out = ta; a.tb_out = tb; a.out = out;
  a.wa1 = wa1; a.ba1 = ba1; a.wa2 = wa2; a.ba2 = ba2; a.wb1 = wb1; a.bb1 = bb1; a.wb2 = wb2; a.bb2 = bb2;
  a.n = n; a.h = h; a.w = w; a.res_scale = res_scale; a.ident_over_res = ident_over_res;
  return bf16_tile::launch_block_bf16<true>(a, stream);
}

int iek_light_block_bf16(const bf16_tile::bf16* x, const bf16_tile::bf16* w1, const float* b1,
                         const bf16_tile::bf16* w2, const float* b2, bf16_tile::bf16* t, bf16_tile::bf16* out,
                         int n, int h, int w, int c, float res_scale, void* stream) {
  if (c != bf16_tile::C) return (int)cudaErrorInvalidValue;
  bf16_tile::Bf16BlockArgs a{};
  a.x = x; a.ta_out = t; a.out = out;
  a.wa1 = w1; a.ba1 = b1; a.wa2 = w2; a.ba2 = b2;
  a.n = n; a.h = h; a.w = w; a.res_scale = res_scale; a.ident_over_res = 1.0f;
  return bf16_tile::launch_block_bf16<false>(a, stream);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
