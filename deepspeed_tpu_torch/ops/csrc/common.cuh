// Device helpers shared by the port's CUDA kernels (built for sm_90a by
// deepspeed_tpu_torch/ops/_build.py, one shared library per .cu file, each
// with a plain C interface that ctypes binds).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define DS_EXPORT extern "C" __attribute__((visibility("default")))

// Every library exports its own copy (one .cu per library), so the Python
// wrapper can name the error a C entry returned.
#define DS_DEFINE_ERROR_STRING                                   \
  DS_EXPORT const char* ds_error_string(int err) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(err));    \
  }

namespace ds {

// dtype codes: must match DTYPE_CODES in deepspeed_tpu_torch/ops/_build.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch and XLA cast
}

// The value x takes after a cast to T: the cast points of the TPU kernels.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Eight consecutive elements from a 16-byte aligned address, as floats.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&o)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// e / l as IEEE division rounds it (div.rn), from r = __frcp_rn(l), the
// reciprocal correctly rounded (formed once for many e): q = e r, then two
// corrections q + r (e - l q), each residual an exact fma once q is within an
// ulp (Markstein's theorem), for l in [0.5, 2^20] and e in [2^-100, 2^20], where
// nothing underflows or overflows. Five operations against the division's
// own reciprocal, range check and slow path per element; the bits checked
// against div.rn over every e of that range (scripts/softmax_div_check.py).
__device__ __forceinline__ float div_rn_by(float e, float l, float r) {
  const float q = __fmaf_rn(__fmaf_rn(-l, __fmul_rn(e, r), e), r, __fmul_rn(e, r));
  return __fmaf_rn(__fmaf_rn(-l, q, e), r, q);
}

}  // namespace ds
