// The two fused decode-layer kernels of a GPT-2 decode tick.
//
// norm_proj_fwd replaces _norm_proj_kernel
// (deepspeed_tpu/ops/pallas/decode_layer.py:185):
//   out = cast(cast(LN(x)) @ W + b)        LN in fp32, product and bias in fp32
// post_attn_fwd replaces _post_attn_kernel (decode_layer.py:344), GELU-tanh
// pair, LayerNorm, sequential residual:
//   r1  = x + y @ Wo + bo                  fp32, kept in fp32
//   hin = cast(LN(r1))
//   h   = cast(gelu_tanh(hin @ W1 + b1))
//   out = cast(r1 + h @ W2 + b2)
// "cast" is the activation dtype; the cast points are the TPU kernel's.
//
// Bound on the H100: bytes. A decode tick has M <= 64 rows, so each weight
// element read from memory feeds at most 2 * M flops: reading the weight
// panels once (E * N, or E * E + 2 * E * F elements) is the whole cost.
//
// Design: one row-batched GEMV kernel serves all four products. A block owns
// 16 output columns and 8 rows. It stages its rows' operand in shared memory
// in chunks of 1024 (normalising on the way in for the two LN products,
// with statistics the block computes itself, as the TPU kernel recomputes
// them per N tile), then 128 groups of threads stride down K, each reading
// one 16-byte piece of a weight row per step, so a warp's loads are 16 rows
// x 32 contiguous bytes and every weight byte is read once per 8 rows. The
// partial sums reduce through warp shuffles and shared memory; the epilogue
// applies the bias, residual and GELU in fp32. The TPU kernel carried r1,
// hin and the accumulator across a sequential grid; Hopper blocks run in no
// order, so post_attn_fwd makes three launches with a grid-wide step between
// them: o-proj + residual into an fp32 scratch r1, then norm + up-proj +
// GELU into a scratch h, then down-proj + residual.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                         // decode rows per block
constexpr int kColGroups = 2;                    // 8-column groups per block
constexpr int kCols = 8 * kColGroups;            // output columns per block
constexpr int kKGroups = kThreads / kColGroups;  // threads striding down K
constexpr int kChunk = 1024;                     // K elements staged per pass

constexpr float kSqrt2OverPi = 0.7978845608028654f;

enum Mode : int { kNormProj, kOProjResidual, kNormUpGelu, kDownResidual };

// T: activation and weight dtype. S: dtype of the row operand (T, or fp32
// for the r1 scratch).
template <typename T, typename S>
struct GemvArgs {
  const S* src;           // (M, K) row operand
  const float* ns;        // (K,) norm scale, norm modes
  const float* nb;        // (K,) norm bias, norm modes
  float eps;
  const T* w;             // (K, N), row-major
  const T* bias;          // (N,)
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

template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(kThreads) rows_gemv_kernel(const GemvArgs<T, S> a) {
  constexpr bool kNorm = MODE == kNormProj || MODE == kNormUpGelu;
  __shared__ float a_sm[kRows][kChunk];
  __shared__ float mean_sm[kRows], rstd_sm[kRows];
  __shared__ float red_sm[kWarps][kRows][kCols];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.M - m0);

  if (kNorm) {  // fp32 LayerNorm statistics, one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      const S* xr = a.src + (size_t)(m0 + r) * a.K;
      float s = 0.f;
      for (int k = lane; k < a.K; k += 32) s += ds::to_float(xr[k]);
      const float mean = ds::warp_sum(s) / a.K;
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
  for (int k0 = 0; k0 < a.K; k0 += kChunk) {
    const int kc = min(kChunk, a.K - k0);
    for (int r = 0; r < kRows; ++r) {
      for (int kk = tid; kk < kc; kk += kThreads) {
        float v = 0.f;
        if (r < rows) {
          v = ds::to_float(a.src[(size_t)(m0 + r) * a.K + k0 + kk]);
          if (kNorm)  // normalised in fp32, then cast before the product
            v = ds::round_to<T>((v - mean_sm[r]) * rstd_sm[r] * a.ns[k0 + kk] + a.nb[k0 + kk]);
        }
        a_sm[r][kk] = v;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = kg; kk < kc; kk += kKGroups) {
      float w8[8];
      ds::load8(a.w + (size_t)(k0 + kk) * a.N + n0 + cg * 8, w8);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = a_sm[r][kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av, w8[j], acc[r][j]);
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

  if (tid < kRows * kCols) {
    const int r = tid / kCols, c = tid % kCols;
    if (r < rows) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red_sm[w][r][c];
      const int n = n0 + c;
      const size_t o = (size_t)(m0 + r) * a.N + n;
      const float bias = ds::to_float(a.bias[n]);
      if constexpr (MODE == kNormProj) {
        static_cast<T*>(a.out)[o] = ds::from_float<T>(v + bias);
      } else if constexpr (MODE == kOProjResidual) {
        static_cast<float*>(a.out)[o] = (ds::to_float(a.resid[o]) + v) + bias;
      } else if constexpr (MODE == kNormUpGelu) {
        static_cast<T*>(a.out)[o] = ds::from_float<T>(gelu_tanh(v + bias));
      } else {
        static_cast<T*>(a.out)[o] = ds::from_float<T>((a.resid_f[o] + v) + bias);
      }
    }
  }
}

template <typename T, typename S, int MODE>
cudaError_t launch_gemv(const GemvArgs<T, S>& a, cudaStream_t stream) {
  if (a.N % kCols) return cudaErrorInvalidValue;
  const dim3 grid(a.N / kCols, (a.M + kRows - 1) / kRows);
  rows_gemv_kernel<T, S, MODE><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t norm_proj(const void* x, const float* ns, const float* nb, const void* w,
                      const void* b, void* out, int M, int E, int N, float eps,
                      cudaStream_t stream) {
  GemvArgs<T, T> a{};
  a.src = static_cast<const T*>(x);
  a.ns = ns;
  a.nb = nb;
  a.eps = eps;
  a.w = static_cast<const T*>(w);
  a.bias = static_cast<const T*>(b);
  a.out = out;
  a.M = M;
  a.K = E;
  a.N = N;
  return launch_gemv<T, T, kNormProj>(a, stream);
}

template <typename T>
cudaError_t post_attn(const void* y, const void* x, const void* wo, const void* bo,
                      const float* ns, const float* nb, const void* w1, const void* b1,
                      const void* w2, const void* b2, float* r1, void* h, void* out,
                      int M, int E, int F, float eps, cudaStream_t stream) {
  GemvArgs<T, T> o{};  // r1 = x + y @ Wo + bo
  o.src = static_cast<const T*>(y);
  o.w = static_cast<const T*>(wo);
  o.bias = static_cast<const T*>(bo);
  o.resid = static_cast<const T*>(x);
  o.out = r1;
  o.M = M;
  o.K = E;
  o.N = E;
  cudaError_t err = launch_gemv<T, T, kOProjResidual>(o, stream);
  if (err != cudaSuccess) return err;

  GemvArgs<T, float> u{};  // h = gelu(LN(r1) @ W1 + b1)
  u.src = r1;
  u.ns = ns;
  u.nb = nb;
  u.eps = eps;
  u.w = static_cast<const T*>(w1);
  u.bias = static_cast<const T*>(b1);
  u.out = h;
  u.M = M;
  u.K = E;
  u.N = F;
  err = launch_gemv<T, float, kNormUpGelu>(u, stream);
  if (err != cudaSuccess) return err;

  GemvArgs<T, T> d{};  // out = r1 + h @ W2 + b2
  d.src = static_cast<const T*>(h);
  d.w = static_cast<const T*>(w2);
  d.bias = static_cast<const T*>(b2);
  d.resid_f = r1;
  d.out = out;
  d.M = M;
  d.K = F;
  d.N = E;
  return launch_gemv<T, T, kDownResidual>(d, stream);
}

}  // namespace

DS_DEFINE_ERROR_STRING

// x (M, E); ns, nb (E,) fp32; w (E, N); b (N,); out (M, N). x, w, b and out
// share one dtype. Returns the cudaGetLastError() of the launch.
DS_EXPORT int norm_proj_fwd(const void* x, const void* ns, const void* nb, const void* w,
                            const void* b, void* out, int M, int E, int N, float eps,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  if (dtype == ds::kBFloat16) return norm_proj<ds::bf16>(x, nsf, nbf, w, b, out, M, E, N, eps, st);
  if (dtype == ds::kFloat32) return norm_proj<float>(x, nsf, nbf, w, b, out, M, E, N, eps, st);
  return cudaErrorInvalidValue;
}

// y, x (M, E); wo (E, E); bo (E,); ns, nb (E,) fp32; w1 (E, F); b1 (F,);
// w2 (F, E); b2 (E,); scratch r1 (M, E) fp32 and h (M, F); out (M, E).
// Three launches; returns the first non-zero cudaGetLastError(), else 0.
DS_EXPORT int post_attn_fwd(const void* y, const void* x, const void* wo, const void* bo,
                            const void* ns, const void* nb, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* r1, void* h, void* out,
                            int M, int E, int F, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16)
    return post_attn<ds::bf16>(y, x, wo, bo, nsf, nbf, w1, b1, w2, b2, r1f, h, out, M, E, F, eps, st);
  if (dtype == ds::kFloat32)
    return post_attn<float>(y, x, wo, bo, nsf, nbf, w1, b1, w2, b2, r1f, h, out, M, E, F, eps, st);
  return cudaErrorInvalidValue;
}
