// Flash-attention forward with the per-row log-sum-exp.
//
// Replaces the TPU kernel _fwd_kernel
// (deepspeed_tpu/ops/pallas/flash_attention.py:34).
//
// Computes, per (batch, head), out = softmax(q k^T * scale [causal]) v and
// lse = m + log(l) per query row, with an online softmax over key tiles so
// the S x S score matrix never exists in memory. Inputs and out are
// (B, S, H, D); lse is (B * H, 1, S) fp32. Causal masking keeps
// q_pos >= k_pos; a row with nothing to attend writes 0 and lse = 0, the
// TPU kernel's guards (flash_attention.py:64-67, :87-90).
//
// Bound on the H100: at S = 1024, D = 64 the work is ~250 flops per byte
// moved, so the bound is about even between the bytes (q, k, v read once,
// out and lse written once) and the bf16 tensor-core rate. This kernel does
// its products on the fp32 CUDA cores, reading operands from shared memory,
// so the fp32 FMA rate and shared-memory bandwidth bound it instead: it is
// the simple, right first kernel, and the tensor-core (wgmma) version is
// later work.
//
// Design: one block per (64-row query tile, batch * head). The block stages
// its query tile (pre-scaled, fp32) and then each 64-key (32 for D = 256)
// K/V tile in shared memory, with rows padded by one float so column reads
// hit distinct banks. Each of the 256 threads owns a 4 x 4 block of scores
// (rows ty + 16 i, keys tx + 16 j) and 4 x D/16 outputs; the 16 threads of
// a row reduce its max and sum with shuffles. Key tiles past the causal
// limit of the query tile are never loaded; ragged S is masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block

template <int D, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)kBQ * (BK + 1));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int Sk, int H,
                 float scale, int causal) {
  constexpr int QS = D + 1;   // padded row stride of the q and k tiles
  constexpr int PS = BK + 1;  // padded row stride of the probability tile
  constexpr int RQ = kBQ / 16, RK = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  float* q_sm = smem;
  float* k_sm = q_sm + kBQ * QS;
  float* v_sm = k_sm + BK * QS;
  float* p_sm = v_sm + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t row_stride = (size_t)H * D;
  const T* qb = q + (size_t)b * S * row_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * row_stride + (size_t)h * D;
  const T* vb = v + (size_t)b * Sk * row_stride + (size_t)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    q_sm[r * QS + d] = s < S ? ds::to_float(qb[(size_t)s * row_stride + d]) * scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) acc[i][dd] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool live = s < Sk;
      k_sm[r * QS + d] = live ? ds::to_float(kb[(size_t)s * row_stride + d]) : 0.f;
      v_sm[r * D + d] = live ? ds::to_float(vb[(size_t)s * row_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = q_sm[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = k_sm[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        if (k_pos >= Sk || (causal && k_pos > q_pos)) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // rows with everything masked so far keep m = -inf; keep exp defined
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(sc[i][j] - m_safe);
        p_sm[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) acc[i][dd] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ], vv[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = p_sm[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) vv[dd] = v_sm[c * D + tx + 16 * dd];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
    }
  }

  T* ob = out + (size_t)b * S * row_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < S) {
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int dd = 0; dd < RD; ++dd)
        ob[(size_t)row * row_stride + tx + 16 * dd] = ds::from_float<T>(acc[i][dd] / l_safe);
      if (tx == 0) {
        const float m_safe = m[i] == -INFINITY ? 0.f : m[i];
        lse[(size_t)bh * S + row] = m_safe + logf(l_safe);
      }
    }
  }
}

template <typename T, int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int S, int Sk, int H, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BK>();
  const auto kernel = flash_fwd_kernel<T, D, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out),
                                           lse, S, Sk, H, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int S, int Sk, int H, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64, 64>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    case 128:
      return launch<T, 128, 64>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    case 256:
      return launch<T, 256, 32>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

DS_DEFINE_ERROR_STRING

// q (B, S, H, D); k, v (B, Sk, H, D); out (B, S, H, D); lse (B * H, 1, S)
// fp32. q, k, v and out contiguous and of one dtype. Returns the
// cudaGetLastError() of the launch.
DS_EXPORT int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int S, int Sk, int H, int D, float scale,
                                  int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lsef = static_cast<float*>(lse);
  if (dtype == ds::kBFloat16)
    return by_dim<ds::bf16>(D, q, k, v, out, lsef, B, S, Sk, H, scale, causal, st);
  if (dtype == ds::kFloat32)
    return by_dim<float>(D, q, k, v, out, lsef, B, S, Sk, H, scale, causal, st);
  return cudaErrorInvalidValue;
}
