// The row-batched CUDA-core GEMV behind the fp32 instantiations of the
// decode-layer kernels (decode_layer.cu). The bf16 decode-layer kernels and
// the W8A16 matmul (w8_matmul.cu) run decode_gemv_sm90.cuh.
//
// out[m, n] = epilogue(sum_k a[m, k] * W[k, n]) for M <= 64 decode rows.
// Bound on the H100: bytes. Each weight element read from memory feeds at
// most 2 * M flops, so reading the weight panel once is the whole cost.
//
// A block owns 16 output columns and 8 rows. It stages its rows' operand in
// shared memory in chunks of 1024 (normalising on the way in for the norm
// modes, LayerNorm or RMSNorm, with statistics the block computes itself, as
// the TPU kernels recompute them per N tile), then 128 groups of threads
// stride down K,
// each reading one piece of a weight row per step: 16 bytes (8 columns) of
// a bf16 row, 32 bytes of an fp32 row, or 8 bytes (8 columns) of an int8
// code row. A warp's loads are 16 rows x 32 (or 16) contiguous bytes; every
// weight byte is read once per 8 rows (row blocks beyond the first, M > 8,
// read the panel again). Partial sums reduce through warp
// shuffles and shared memory; the epilogue applies the bias, residual and
// GELU (tanh, or with exact_gelu the erf form) in fp32.
//
// SwiGLU (kNormGateUp) pairs two panels of one width, gate and up: a block
// owns 8 columns of each, its even threads reading the gate panel and its
// odd ones the up panel, so the staged rows feed both products in one pass
// and the epilogue writes cast(silu(g) * u) for its 8 columns.
//
// W8A16 (W = int8): K and the group size are multiples of 128 (or the
// group is all of K). Codes upcast in registers to the activation's values
// (exact: |c| <= 127). A thread loads its 8 code rows of a staged chunk up
// front (8 bytes = 8 columns each), sums a * c over the rows of one scale
// group in a partial, and folds it into its accumulator at the group's end
// (acc += part * s[u][n]): the per-group "partial x scale" of the TPU
// kernels' _qdot_any, within fp32 reordering of their order. A group cut by
// a chunk boundary folds once per chunk (the scale distributes over its
// partial sums, as the TPU kernel's streamed tiles of a single-group panel
// do). 16 columns a thread would need 2 x 128 fp32 registers for acc and
// part, so the int8 path keeps the bf16 layout with 8-byte loads: a warp
// reads 16-byte halves of 32-byte sectors whose other halves the
// neighbouring column block reads (from L2). The scales of the (at most 8)
// groups a chunk touches are staged in shared memory.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace ds {
namespace gemv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                         // decode rows per block
constexpr int kColGroups = 2;                    // 8-column groups per block
constexpr int kCols = 8 * kColGroups;            // output columns per block
constexpr int kKGroups = kThreads / kColGroups;  // threads striding down K
constexpr int kChunk = 1024;                     // K elements staged per pass
constexpr int kSteps = kChunk / kKGroups;        // rows a thread takes from a chunk

constexpr float kSqrt2OverPi = 0.7978845608028654f;

enum Mode : int { kNormProj, kOProjResidual, kNormUpGelu, kDownResidual, kNormGateUp };

// Output columns a block writes: kNormGateUp spends its 16 on 8 of each panel.
__host__ __device__ constexpr int block_cols(int mode) { return mode == kNormGateUp ? 8 : kCols; }

// T: activation dtype (bias, residual and output). S: dtype of the row
// operand (T, or fp32 for the r1 scratch; the norm modes of post_attn read
// the block input x, type T, under the parallel residual). W: weight
// storage (T, or int8 codes with fp32 scales).
template <typename T, typename S, typename W>
struct Args {
  const S* src;           // (M, K) row operand
  const float* ns;        // (K,) norm scale, norm modes
  const float* nb;        // (K,) norm bias, LayerNorm modes
  float eps;
  int rms;                // norm modes: RMSNorm (no mean, no bias) instead of LayerNorm
  int exact_gelu;         // kNormUpGelu: the erf GELU instead of the tanh one
  const W* w;             // (K, N), row-major; the gate panel in kNormGateUp
  const float* scale;     // (K / group, N) fp32, int8 weights
  int group;              // rows per scale group (K for one group)
  const W* w2;            // (K, N) up panel, kNormGateUp
  const float* scale2;    // its scales (same group), int8 weights
  const T* bias;          // (N,); may be null in kDownResidual (no bias)
  const T* resid;         // (M, N) x, kOProjResidual
  const float* resid_f;   // (M, N) r1, kDownResidual
  void* out;              // (M, N): fp32 for kOProjResidual, else T
  int M, K, N;
};

__device__ __forceinline__ float gelu_tanh(float u) {
  // the same expression, in the same order, as _gelu_tanh
  // (deepspeed_tpu/ops/pallas/fused_ops.py:165)
  const float inner = kSqrt2OverPi * (u + 0.044715f * u * u * u);
  return 0.5f * u * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_erf(float u) {
  // _gelu_exact (deepspeed_tpu/ops/pallas/decode_layer.py:98-100), the same
  // expression in the same order: 0.5 * u * (1 + erf(u * 2^-0.5)). erff is
  // the full-precision libdevice erf (no --use_fast_math in the build).
  return 0.5f * u * (1.f + erff(u * 0.70710678f));
}

__device__ __forceinline__ float swiglu(float g, float u) {
  // (gate * sigmoid(gate)) * up, as _post_attn_kernel computes h
  return (g * (1.f / (1.f + expf(-g)))) * u;
}

// Eight int8 codes (8 bytes, little-endian) as floats.
__device__ __forceinline__ void unpack8(const uint2 raw, float (&o)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = static_cast<float>(static_cast<int>(raw.x << (24 - 8 * i)) >> 24);
    o[4 + i] = static_cast<float>(static_cast<int>(raw.y << (24 - 8 * i)) >> 24);
  }
}

// acc[r][j] += a[r][kk] * w[k0 + kk][j]
__device__ __forceinline__ void fma_rows(float (*a_sm)[kChunk], int kk, const float (&w8)[8],
                                         float (&acc)[kRows][8]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float av = a_sm[r][kk];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av, w8[j], acc[r][j]);
  }
}

template <typename T, typename S, typename W, int MODE>
__global__ void __launch_bounds__(kThreads) rows_gemv_kernel(const Args<T, S, W> a) {
  constexpr bool kNorm = MODE == kNormProj || MODE == kNormUpGelu || MODE == kNormGateUp;
  constexpr bool kQuant = std::is_same<W, int8_t>::value;
  constexpr bool kPair = MODE == kNormGateUp;
  __shared__ float a_sm[kRows][kChunk];
  __shared__ float mean_sm[kRows], rstd_sm[kRows];
  __shared__ float red_sm[kWarps][kRows][kCols];
  __shared__ float sc_sm[kSteps][kCols];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * block_cols(MODE);
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.M - m0);

  if (kNorm) {  // fp32 norm statistics, one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      const S* xr = a.src + (size_t)(m0 + r) * a.K;
      float mean = 0.f;  // RMSNorm: mean(x^2), in the same order as the variance
      if (!a.rms) {
        float s = 0.f;
        for (int k = lane; k < a.K; k += 32) s += ds::to_float(xr[k]);
        mean = ds::warp_sum(s) / a.K;
      }
      float v = 0.f;
      for (int k = lane; k < a.K; k += 32) {
        const float d = ds::to_float(xr[k]) - mean;
        v += d * d;
      }
      const float var = ds::warp_sum(v) / a.K;
      if (lane == 0) {
        mean_sm[r] = mean;
        rstd_sm[r] = rsqrtf(var + a.eps);
      }
    }
    __syncthreads();
  }

  float acc[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  const int cg = tid % kColGroups;
  const int kg = tid / kColGroups;
  // kNormGateUp: column group 0 reads the gate panel, 1 the up panel, at
  // the same 8 columns
  const W* wcol = kPair ? (cg ? a.w2 : a.w) + n0 : a.w + n0 + cg * 8;
  for (int k0 = 0; k0 < a.K; k0 += kChunk) {
    const int kc = min(kChunk, a.K - k0);
    for (int r = 0; r < kRows; ++r) {
      for (int kk = tid; kk < kc; kk += kThreads) {
        float v = 0.f;
        if (r < rows) {
          v = ds::to_float(a.src[(size_t)(m0 + r) * a.K + k0 + kk]);
          if (kNorm)  // normalised in fp32, then cast before the product
            v = ds::round_to<T>(a.rms ? v * rstd_sm[r] * a.ns[k0 + kk]
                                      : (v - mean_sm[r]) * rstd_sm[r] * a.ns[k0 + kk] +
                                            a.nb[k0 + kk]);
        }
        a_sm[r][kk] = v;
      }
    }
    int u0 = 0;
    if constexpr (kQuant) {  // the scales of the groups this chunk touches
      u0 = k0 / a.group;
      const int nu = (k0 + kc - 1) / a.group - u0 + 1;
      for (int i = tid; i < nu * kCols; i += kThreads) {
        const int u = u0 + i / kCols, c = i % kCols;
        sc_sm[i / kCols][c] = kPair ? (c < 8 ? a.scale : a.scale2)[(size_t)u * a.N + n0 + c % 8]
                                    : a.scale[(size_t)u * a.N + n0 + c];
      }
    }
    __syncthreads();
    if constexpr (kQuant) {
      // this thread's code rows of the chunk, kg + t * kKGroups, all loaded
      // up front (8 loads in flight). K and the group size are multiples of
      // kKGroups, so the rows of one step t lie in one scale group for every
      // thread, and a group ends after a step, or with the chunk.
      const int steps = kc / kKGroups;
      uint2 raw[kSteps];
#pragma unroll
      for (int t = 0; t < kSteps; ++t)
        if (t < steps)
          raw[t] = __ldg(reinterpret_cast<const uint2*>(
              wcol + (size_t)(k0 + kg + t * kKGroups) * a.N));
      float part[kRows][8] = {};
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        if (t < steps) {
          float w8[8];
          unpack8(raw[t], w8);
          fma_rows(a_sm, kg + t * kKGroups, w8, part);
          const int next = k0 + (t + 1) * kKGroups;
          if (t + 1 == steps || next % a.group == 0) {  // fold: acc += part * s[u]
            const float* s = sc_sm[(next - 1) / a.group - u0] + cg * 8;
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                acc[r][j] = fmaf(part[r][j], s[j], acc[r][j]);
                part[r][j] = 0.f;
              }
          }
        }
      }
    } else {
#pragma unroll 4
      for (int kk = kg; kk < kc; kk += kKGroups) {
        float w8[8];
        ds::load8(wcol + (size_t)(k0 + kk) * a.N, w8);
        fma_rows(a_sm, kk, w8, acc);
      }
    }
    __syncthreads();
  }

  // sum over the K groups: lanes of one warp differ in bits 1-4, warps via smem
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int o = kColGroups; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[r][j] = v;
    }
  if (lane < kColGroups) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) red_sm[warp][r][lane * 8 + j] = acc[r][j];
  }
  __syncthreads();

  if constexpr (kPair) {  // h = cast(silu(g) * u): gate sums in 0-7, up in 8-15
    if (tid < kRows * 8) {
      const int r = tid / 8, c = tid % 8;
      if (r < rows) {
        float g = 0.f, u = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          g += red_sm[w][r][c];
          u += red_sm[w][r][8 + c];
        }
        static_cast<T*>(a.out)[(size_t)(m0 + r) * a.N + n0 + c] = ds::from_float<T>(swiglu(g, u));
      }
    }
  } else if (tid < kRows * kCols) {
    const int r = tid / kCols, c = tid % kCols;
    if (r < rows) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red_sm[w][r][c];
      const int n = n0 + c;
      const size_t o = (size_t)(m0 + r) * a.N + n;
      if constexpr (MODE == kDownResidual) {
        float out = a.resid_f[o] + v;
        if (a.bias) out += ds::to_float(a.bias[n]);
        static_cast<T*>(a.out)[o] = ds::from_float<T>(out);
      } else {
        const float bias = ds::to_float(a.bias[n]);
        if constexpr (MODE == kNormProj) {
          static_cast<T*>(a.out)[o] = ds::from_float<T>(v + bias);
        } else if constexpr (MODE == kOProjResidual) {
          static_cast<float*>(a.out)[o] = (ds::to_float(a.resid[o]) + v) + bias;
        } else {
          const float u = v + bias;
          static_cast<T*>(a.out)[o] = ds::from_float<T>(a.exact_gelu ? gelu_erf(u) : gelu_tanh(u));
        }
      }
    }
  }
}

template <typename T, typename S, typename W, int MODE>
cudaError_t launch(const Args<T, S, W>& a, cudaStream_t stream) {
  if (a.N % block_cols(MODE)) return cudaErrorInvalidValue;
  if (std::is_same<W, int8_t>::value &&
      (a.K % kKGroups || a.group <= 0 || a.group % kKGroups || a.K % a.group))
    return cudaErrorInvalidValue;
  const dim3 grid(a.N / block_cols(MODE), (a.M + kRows - 1) / kRows);
  rows_gemv_kernel<T, S, W, MODE><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gemv
}  // namespace ds
