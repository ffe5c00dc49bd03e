// Integer-factor TF1 bilinear upsample (align_corners=False), for sm_90a.
//
// Replaces the Pallas TPU kernel image_enhance_keras_tpu/ops/pallas/upsample.py
// (upsample_phase_tf1_pallas, _kernel):
//   per axis out[f*k + r] = (1 - r/f)*in[k] + (r/f)*in[min(k+1, n-1)],
//   H pass first, then the W pass over its result; (N,H,W,C) -> (N,fH,fW,C).
// Bit-identical to the plain phase construction (ops/resize.py
// upsample_phase_plain and JAX's _upsample_phase_xla): the H pass is fully
// rounded to the dtype before the W pass reads it, and every product and
// sum is rounded on its own (__fmul_rn/__fadd_rn; in bf16 mul.rn/add.rn on
// bf16 pairs, each result rounded to bf16, torch's per-op bf16 semantics).  The weights are the
// dtype's rounding of the double 1 - r/f and r/f, as torch.tensor() makes
// them: the Python wrapper computes that table for every factor and passes
// it as a small device array.  Build without --use_fast_math.
//
// What bounds it on an H100: bytes.  It reads the input once and writes f^2
// times as much (x4: 16x), a few operations per element.  Design: one
// thread per 16-byte vector of one INPUT pixel (grid: x over the N*H input
// rows, y over the vectors of a row).  It loads its four neighbours
// in[k][m], in[k1][m], in[k][m1], in[k1][m1] once, forms the f H-pass values
// of columns m and m1 for each output row f*k + r, and writes all f x f
// output vectors: no division, no conversion (bf16 stays in bf16 pairs; as
// float32 each rounded step was a conversion at a quarter of the float
// rate, which bound the first bf16 version), no 64-bit index arithmetic per
// vector (a 64-bit base per output row, 32-bit offsets within it).  For each (r, s)
// the lanes of a warp store consecutive 16-byte vectors of one or two
// output pixels, by streaming stores (st.global.cs, evict-first: the output
// is not read back by this kernel).
//
// K3q (IEK_INT8_UPQ, the JAX package's _light53_i8_xla_upfused: the x4 whose
// only consumer is the per-channel int8 quantize of the first HR block):
// K3's bf16 x4 with the quantize in its epilogue.  Each output is rounded to
// bf16 first (K3's output), then coded as clamp(rint(y * r_c), -127, 127)
// with r_c = 1 / s_c rounded to float32 (the division JAX writes as
// 1.0 / s_c), and the codes leave as int8, 8 bytes a vector: the bf16 HR map
// (2 bytes an element) is never written.  Bound by bytes too: it reads the
// bf16 input once and writes f^2 int8 codes an input element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Arithmetic on 32-bit words of a 16-byte vector: one float32, or two bf16
// (bf16x2: Hopper's mul.rn / add.rn on bf16 pairs round each product and sum
// to bf16 once, as a float32 product or sum rounded to bf16 does, since the
// float32 product of two bf16 values is exact and so is their sum where a
// tie could arise; no conversion instruction and no FMA contraction in the
// asm).
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static constexpr int VEC = 4;  // channels per 16-byte vector
  __device__ static uint32_t weight(float w) { return __float_as_uint(w); }
  // a*w0 + b*w1, each product and the sum rounded on its own
  __device__ static uint32_t lerp(uint32_t a, uint32_t w0, uint32_t b, uint32_t w1) {
    return __float_as_uint(__fadd_rn(__fmul_rn(__uint_as_float(a), __uint_as_float(w0)),
                                     __fmul_rn(__uint_as_float(b), __uint_as_float(w1))));
  }
};

template <>
struct Arith<__nv_bfloat16> {
  static constexpr int VEC = 8;
  // w (a bf16 value) in both halves
  __device__ static uint32_t weight(float w) { return (__float_as_uint(w) >> 16) * 0x10001u; }
  __device__ static uint32_t lerp(uint32_t a, uint32_t w0, uint32_t b, uint32_t w1) {
    uint32_t p, q, s;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(a), "r"(w0));
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(q) : "r"(b), "r"(w1));
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(s) : "r"(p), "r"(q));
    return s;
  }
};

// The int8 code clamp(rint(v * inv), -127, 127), in the low byte of the
// result: clamping first gives the same code, and adding 1.5 * 2^23 (where
// the float spacing is 1) rounds half to even; no conversion instruction.
__device__ __forceinline__ unsigned code8(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}

// 8 bf16 values (a 16-byte vector) -> their 8 codes at inv[0..7], as 8 bytes
__device__ __forceinline__ uint2 codes8(const uint4& o, const float (&inv)[8]) {
  const uint32_t w[4] = {o.x, o.y, o.z, o.w};
  unsigned q[8];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    q[2 * v] = code8(__uint_as_float(w[v] << 16), inv[2 * v]);
    q[2 * v + 1] = code8(__uint_as_float(w[v] & 0xffff0000u), inv[2 * v + 1]);
  }
  return make_uint2(__byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410),
                    __byte_perm(__byte_perm(q[4], q[5], 0x0040), __byte_perm(q[6], q[7], 0x0040), 0x5410));
}

__device__ __forceinline__ void load16(const void* p, uint32_t (&w)[4]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// F > 0: the factor, unrolled; F == 0: any factor f (the loop form).
// wt: the host weight table, w0[r] at wt[r], w1[r] at wt[f + r].  Q (bf16
// only, K3q): the output is int8 codes at the C scales (out_q), not T values.
template <typename T, int F, bool Q>
__global__ void __launch_bounds__(THREADS)
upsample_phase_tf1_kernel(const T* __restrict__ in, T* __restrict__ out, int H, int W, int C,
                          int f_rt, const float* __restrict__ wt, const float* __restrict__ scales,
                          int8_t* __restrict__ out_q) {
  constexpr int VEC = Arith<T>::VEC;
  static_assert(!Q || VEC == 8, "the quantizing form takes bf16");
  const int f = F > 0 ? F : f_rt;
  const int groups = C / VEC;
  const int row = blockIdx.x;  // n * H + k
  const int n = row / H, k = row - n * H, k1 = min(k + 1, H - 1);
  const int item = blockIdx.y * blockDim.x + threadIdx.x;
  if (item >= W * groups) return;
  const int m = item / groups, g = item - m * groups, m1 = min(m + 1, W - 1);
  uint32_t a[4], b[4], c[4], d[4];  // in[k][m], in[k1][m], in[k][m1], in[k1][m1]
  const T* base = in + (size_t)n * H * W * C + g * VEC;
  load16(base + ((size_t)k * W + m) * C, a);
  load16(base + ((size_t)k1 * W + m) * C, b);
  load16(base + ((size_t)k * W + m1) * C, c);
  load16(base + ((size_t)k1 * W + m1) * C, d);
  float inv[8];  // K3q: 1 / s of the vector's channels, as JAX's 1.0 / s_c
  if constexpr (Q) {
#pragma unroll
    for (int v = 0; v < 8; ++v) inv[v] = __frcp_rn(__ldg(scales + g * VEC + v));
  }
  const int OW = W * f;
#pragma unroll
  for (int r = 0; r < f; ++r) {
    const uint32_t wr0 = Arith<T>::weight(__ldg(wt + r)), wr1 = Arith<T>::weight(__ldg(wt + f + r));
    uint32_t hm[4], hm1[4];  // H pass at columns m and m1, output row f*k + r
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      hm[v] = Arith<T>::lerp(a[v], wr0, b[v], wr1);
      hm1[v] = Arith<T>::lerp(c[v], wr0, d[v], wr1);
    }
    const size_t orow0 = ((size_t)row * f + r) * OW * C;  // n*fH + f*k + r
#pragma unroll
    for (int s = 0; s < f; ++s) {
      const uint32_t ws0 = Arith<T>::weight(__ldg(wt + s)), ws1 = Arith<T>::weight(__ldg(wt + f + s));
      uint4 o;  // W pass
      o.x = Arith<T>::lerp(hm[0], ws0, hm1[0], ws1);
      o.y = Arith<T>::lerp(hm[1], ws0, hm1[1], ws1);
      o.z = Arith<T>::lerp(hm[2], ws0, hm1[2], ws1);
      o.w = Arith<T>::lerp(hm[3], ws0, hm1[3], ws1);
      if constexpr (Q)
        __stcs(reinterpret_cast<uint2*>(out_q + orow0 + (f * m + s) * C + g * VEC), codes8(o, inv));
      else
        __stcs(reinterpret_cast<uint4*>(out + orow0 + (f * m + s) * C + g * VEC), o);
    }
  }
}

template <typename T, int F, bool Q>
cudaError_t launch_f(const T* x, T* out, int n, int h, int w, int c, int f, const float* wt,
                     const float* scales, int8_t* out_q, cudaStream_t st) {
  const int groups = c / Arith<T>::VEC;
  const long long blocks_y = ((long long)w * groups + THREADS - 1) / THREADS;
  if (blocks_y > 65535) return cudaErrorInvalidValue;
  upsample_phase_tf1_kernel<T, F, Q><<<dim3((unsigned)(n * h), (unsigned)blocks_y), THREADS, 0, st>>>(
      x, out, h, w, c, f, wt, scales, out_q);
  return cudaGetLastError();
}

template <typename T, bool Q = false>
cudaError_t launch(const void* x, void* out, int n, int h, int w, int c, int f, const float* wt,
                   cudaStream_t st, const float* scales = nullptr, int8_t* out_q = nullptr) {
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  switch (f) {
    case 2: return launch_f<T, 2, Q>(xi, o, n, h, w, c, f, wt, scales, out_q, st);
    case 3: return launch_f<T, 3, Q>(xi, o, n, h, w, c, f, wt, scales, out_q, st);
    case 4: return launch_f<T, 4, Q>(xi, o, n, h, w, c, f, wt, scales, out_q, st);
    default: return launch_f<T, 0, Q>(xi, o, n, h, w, c, f, wt, scales, out_q, st);
  }
}

}  // namespace

extern "C" {

// x (n,h,w,c) and out (n,f*h,f*w,c), contiguous, 16-byte aligned; bf16
// when is_bf16 (c % 8 == 0), else float32 (c % 4 == 0); f >= 2.  wt: 2f
// floats on the device, the host weight table (the dtype's rounding of
// 1 - r/f at wt[r], of r/f at wt[f + r]).  The Python wrapper checks.
// Returns the CUDA error code of the launch (0 = success).
int iek_upsample_phase_tf1(const void* x, void* out, int n, int h, int w, int c, int f,
                           int is_bf16, const float* wt, void* stream) {
  if (f < 2 || (long long)w * f * c >= (1LL << 31) || (long long)n * h >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(x, out, n, h, w, c, f, wt, st)
                                  : launch<float>(x, out, n, h, w, c, f, wt, st);
  return (int)err;
}

// K3q: x bf16 (n,h,w,c), c % 8 == 0, out int8 (n,f*h,f*w,c), scales float32
// (c,) on the device, the per-channel quantization scales; the rest as
// iek_upsample_phase_tf1.
int iek_upsample_quant_tf1(const void* x, int8_t* out, int n, int h, int w, int c, int f,
                           const float* wt, const float* scales, void* stream) {
  if (f < 2 || (long long)w * f * c >= (1LL << 31) || (long long)n * h >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return (int)launch<__nv_bfloat16, true>(x, nullptr, n, h, w, c, f, wt,
                                           static_cast<cudaStream_t>(stream), scales, out);
}

const char* iek_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
