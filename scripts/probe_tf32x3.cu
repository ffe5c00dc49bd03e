// One SAME 3x3 or 5x5 conv (C = 128, NHWC, float32 or bf16 activations) on
// the block and chain kernels' tile
// (image_enhance_keras_tpu_torch/csrc/conv_tf32x3.cuh) under either product
// policy (3xTF32 for float32, bf16 for bf16), once with the tile's own conv
// (each step's wgmma sum added to the float32 sums with rounded adds) and
// once with every product summed by the tensor cores alone; the float32
// sums are written out.  Built and driven by scripts/probe_tf32x3.py.
#include "../image_enhance_keras_tpu_torch/csrc/conv_tf32x3.cuh"

namespace {

// conv<K> with the same window, ring and products, but the products of all
// taps and channels accumulated in the wgmma sums themselves.
template <int K, typename T>
__device__ void conv_unpromoted(float (&acc)[MT][ACC], uint8_t* smem, Ring& ring, const T* src,
                                const T* __restrict__ wgt, const Tile& t, int H, int W) {
  using P = Policy<T>;
  constexpr int STEPS = P::SLICES * K * K;
  const uint32_t g0 = ring.seq;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < STAGES - 2; ++s) produce<K>(ring, g0 + s, wgt, s);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[0][i] = 0.f;
  const uint32_t win_a = smem_addr(smem) + (threadIdx.x / 128) * 8 * 16;
  const uint32_t ring_a = smem_addr(ring.data);
  for (int s = 0; s < STEPS; ++s) {
    const int sl = s / (K * K);
    const int tap = s - sl * K * K;
    const int ky = tap / K, kx = tap - ky * K;
    if (tap == 0) {
      __syncthreads();
      stage_slice<K>(smem, src, t, H, W, sl);
      fence_proxy_async();
      __syncthreads();
    }
    if (threadIdx.x == 0 && s + STAGES - 2 < STEPS) produce<K>(ring, g0 + s + STAGES - 2, wgt, s + STAGES - 2);
    __syncwarp();
    const uint32_t g = g0 + s;
    mbar_wait(ring.full + g % STAGES, (g / STAGES) & 1);
    fence_acc(acc[0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::KSTEPS; ++kk)
      mma_step<T>(acc[0], win_a + 2 * kk * PLANE + (ky * WIN_W + kx) * 16,
                  ring_a + (g % STAGES) * B_STEP + kk * P::B_TILE, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc[0]);
    if ((threadIdx.x & 31) == 0) mbar_arrive(ring.empty + g % STAGES);
  }
  ring.seq = g0 + STEPS;
  __syncthreads();
}

template <int K, bool kPromoted, typename T>
__global__ void __launch_bounds__(THREADS, 1) probe_kernel(const T* x, const T* w, float* out,
                                                           int H, int W) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Tile t = make_tile(blockIdx.x, H, W);
  float acc[MT][ACC];
  Ring ring = make_ring(smem);
  if constexpr (kPromoted)
    conv<K>(acc, smem, ring, x, w, t, H, W);
  else
    conv_unpromoted<K>(acc, smem, ring, x, w, t, H, W);
  float* st = reinterpret_cast<float*>(smem);
  stage_acc(acc, st);
  for_tile_pieces(t, H, W, [&](size_t g, int s, int) {
    *reinterpret_cast<float4*>(out + g) = *reinterpret_cast<const float4*>(st + s);
  });
}

template <int K, bool P, typename T>
int run(const T* x, const T* w, float* out, int n, int h, int wd, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(probe_kernel<K, P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = tiles_per_image(h, wd) * n;
  probe_kernel<K, P, T><<<tiles, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(x, w, out, h, wd);
  return (int)cudaGetLastError();
}

template <typename T>
int run_any(const T* x, const T* w, float* out, int n, int h, int wd, int k, int promoted, void* stream) {
  if (k == 3)
    return promoted ? run<3, true>(x, w, out, n, h, wd, stream) : run<3, false>(x, w, out, n, h, wd, stream);
  return promoted ? run<5, true>(x, w, out, n, h, wd, stream) : run<5, false>(x, w, out, n, h, wd, stream);
}

}  // namespace

extern "C" {

// out = SAME conv of x (N, H, W, 128) with w packed by ops/cuda/tf32x3.py packed
int probe_conv(const float* x, const float* w, float* out, int n, int h, int wd, int k, int promoted,
               void* stream) {
  return run_any(x, w, out, n, h, wd, k, promoted, stream);
}

// the same for bf16 x (N, H, W, 128) and w packed by ops/cuda/bf16.py packed
int probe_conv_bf16(const bf16* x, const bf16* w, float* out, int n, int h, int wd, int k, int promoted,
                    void* stream) {
  return run_any(x, w, out, n, h, wd, k, promoted, stream);
}

const char* probe_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
