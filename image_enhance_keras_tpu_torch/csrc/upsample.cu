// Integer-factor TF1 bilinear upsample (align_corners=False), for sm_90a.
//
// Replaces the Pallas TPU kernel image_enhance_keras_tpu/ops/pallas/upsample.py
// (upsample_phase_tf1_pallas, _kernel):
//   per axis out[f*k + r] = (1 - r/f)*in[k] + (r/f)*in[min(k+1, n-1)],
//   H pass first, then the W pass over its result; (N,H,W,C) -> (N,fH,fW,C).
// Bit-identical to the plain phase construction (ops/resize.py
// upsample_phase_tf1 and JAX's _upsample_phase_xla): the H pass is fully
// rounded to the dtype before the W pass reads it, and every product and
// sum is rounded on its own (__fmul_rn/__fadd_rn; in bf16 each result is
// rounded to bf16, torch's per-op bf16 semantics).  The weights are the
// dtype's rounding of the double 1 - r/f and r/f, as torch.tensor() makes
// them.  Build without --use_fast_math.
//
// What bounds it on an H100: bytes.  It reads the input once and writes f^2
// times as much (x4: 16x), a few operations per element.  One thread makes
// 16 bytes of channels of one output pixel from four input pixels (read
// through L1/L2, where neighbouring threads share them) and writes them
// with one 16-byte store, consecutive threads on consecutive addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static constexpr int VEC = 4;  // channels per 16-byte vector
  __device__ static float round(float v) { return v; }
};

template <>
struct Arith<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// a*w0 + b*w1 with each product and the sum rounded to T.
template <typename T>
__device__ __forceinline__ float lerp(float a, float w0, float b, float w1) {
  return Arith<T>::round(__fadd_rn(Arith<T>::round(__fmul_rn(a, w0)),
                                   Arith<T>::round(__fmul_rn(b, w1))));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
upsample_phase_tf1_kernel(const T* __restrict__ in, T* __restrict__ out,
                          int N, int H, int W, int C, int f) {
  constexpr int VEC = Arith<T>::VEC;
  const int groups = C / VEC;
  const int OH = H * f, OW = W * f;
  const long long total = (long long)N * OH * OW * groups;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * THREADS) {
    const int g = (int)(idx % groups);
    long long p = idx / groups;
    const int X = (int)(p % OW);
    p /= OW;
    const int Y = (int)(p % OH);
    const int n = (int)(p / OH);
    const int k = Y / f, r = Y - k * f, k1 = min(k + 1, H - 1);
    const int m = X / f, s = X - m * f, m1 = min(m + 1, W - 1);
    const float wr0 = Arith<T>::round((float)(1.0 - (double)r / f));
    const float wr1 = Arith<T>::round((float)((double)r / f));
    const float ws0 = Arith<T>::round((float)(1.0 - (double)s / f));
    const float ws1 = Arith<T>::round((float)((double)s / f));
    const T* base = in + (size_t)n * H * W * C + (size_t)g * VEC;
    float a[VEC], b[VEC], c[VEC], d[VEC];  // in[k][m], in[k1][m], in[k][m1], in[k1][m1]
    load16(base + ((size_t)k * W + m) * C, a);
    load16(base + ((size_t)k1 * W + m) * C, b);
    load16(base + ((size_t)k * W + m1) * C, c);
    load16(base + ((size_t)k1 * W + m1) * C, d);
    float o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float hm = lerp<T>(a[v], wr0, b[v], wr1);   // H pass at column m
      const float hm1 = lerp<T>(c[v], wr0, d[v], wr1);  // H pass at column m1
      o[v] = lerp<T>(hm, ws0, hm1, ws1);                 // W pass
    }
    store16(out + (((size_t)n * OH + Y) * OW + X) * C + (size_t)g * VEC, o);
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int c, int f, cudaStream_t st) {
  const long long total = (long long)n * h * f * w * f * (c / Arith<T>::VEC);
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks per SM
  if (blocks < 1) blocks = 1;
  upsample_phase_tf1_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, h, w, c, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n,h,w,c) and out (n,f*h,f*w,c), contiguous, 16-byte aligned; bf16
// when is_bf16 (c % 8 == 0), else float32 (c % 4 == 0); the Python wrapper
// checks.  Returns the CUDA error code of the launch (0 = success).
int iek_upsample_phase_tf1(const void* x, void* out, int n, int h, int w, int c, int f,
                           int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, out, n, h, w, c, f, st);
  return launch<float>(x, out, n, h, w, c, f, st);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
