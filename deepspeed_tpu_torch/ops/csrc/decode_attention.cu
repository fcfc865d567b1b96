// One-token decode attention over a contiguous KV cache.
//
// Replaces the TPU kernels _decode_kernel and _decode_kernel_blocked
// (deepspeed_tpu/ops/pallas/decode_attention.py:78, :101).
//
// Computes, for every batch row b and query head h,
//   out[b, 0, h] = softmax(q[b, 0, h] . K[b, :L, kv]^T * scale) @ V[b, :L, kv]
// with L = lengths[b] (or one scalar length for the whole batch) and
// kv = h / (H / KV) (GQA: the H / KV query heads of a group share one K/V
// head). Scores, the online softmax and the accumulator are fp32.
//
// Bound on the H100: bytes. Each tick reads the live prefix of the cache
// once, 2 * sum_b L_b * KV * D elements, against 4 * sum_b L_b * H * D
// flops: far below the card's ~295 flops per byte.
//
// Design: one block per (KV head, batch row). Its warps take positions in
// turn (warp w reads w, w + 8, ...); a warp reads one K row and one V row
// per position with neighbouring lanes on neighbouring elements, keeps the
// group's G query rows in registers, and carries an online softmax per
// query head. The next position's K/V rows are loaded before the current
// one is used, so each warp keeps two rows in flight. The warps' partial
// (m, l, acc) merge through shared memory at the end. The loop stops at L,
// so positions past the live prefix are never read: the TPU kernel had to
// zero the V rows its overhanging blocks fetched, this one fetches none.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// EPL: elements of a head row per lane (D = 32 * EPL); MAXG: the largest
// query-group size this instantiation holds in registers.
template <typename T, int EPL, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache,
                        const int* __restrict__ lengths, int length_scalar,
                        T* __restrict__ out, int s_max, int n_heads, int n_kv,
                        float scale) {
  constexpr int D = EPL * 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = n_heads / n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int L = lengths != nullptr ? lengths[b] : length_scalar;
  L = max(0, min(L, s_max));  // memory bound only: the wrappers validate

  float qf[MAXG][EPL], acc[MAXG][EPL], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const T* qrow = q + ((size_t)b * n_heads + (size_t)kvh * group + g) * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qf[g][e] = g < group ? ds::to_float(qrow[e * 32 + lane]) * scale : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const size_t pos_stride = (size_t)n_kv * D;
  const size_t base = (size_t)b * s_max * pos_stride + (size_t)kvh * D + lane;
  const T* kb = k_cache + base;
  const T* vb = v_cache + base;

  float kf[EPL], vf[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) kf[e] = vf[e] = 0.f;
  int p = warp;
  if (p < L) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kf[e] = ds::to_float(kb[p * pos_stride + e * 32]);
      vf[e] = ds::to_float(vb[p * pos_stride + e * 32]);
    }
  }
  for (; p < L; p += kWarps) {
    float kn[EPL], vn[EPL];
    const int pn = p + kWarps;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kn[e] = pn < L ? ds::to_float(kb[pn * pos_stride + e * 32]) : 0.f;
      vn[e] = pn < L ? ds::to_float(vb[pn * pos_stride + e * 32]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < group) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qf[g][e], kf[e], s);
        s = ds::warp_sum(s);
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);  // 0 on the first position
        const float pr = expf(s - m_new);
        l[g] = l[g] * corr + pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * corr + pr * vf[e];
        m[g] = m_new;
      }
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kf[e] = kn[e];
      vf[e] = vn[e];
    }
  }

  // merge the warps' partial softmax states, one query head at a time
  __shared__ float acc_sm[kWarps][D];
  __shared__ float m_sm[kWarps], l_sm[kWarps];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < group) {  // uniform across the block, so the barriers are safe
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc_sm[warp][e * 32 + lane] = acc[g][e];
      if (lane == 0) {
        m_sm[warp] = m[g];
        l_sm[warp] = l[g];
      }
      __syncthreads();
      T* orow = out + ((size_t)b * n_heads + (size_t)kvh * group + g) * D;
      for (int d = threadIdx.x; d < D; d += kThreads) {
        float mx = -INFINITY;
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_sm[w]);
        float den = 0.f, num = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          const float c = m_sm[w] == -INFINITY ? 0.f : expf(m_sm[w] - mx);
          den += l_sm[w] * c;
          num += acc_sm[w][d] * c;
        }
        orow[d] = ds::from_float<T>(den > 0.f ? num / den : 0.f);
      }
      __syncthreads();
    }
  }
}

template <typename T, int EPL, int MAXG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   int length_scalar, void* out, int batch, int s_max, int n_heads,
                   int n_kv, float scale, cudaStream_t stream) {
  const dim3 grid(n_kv, batch);
  decode_attention_kernel<T, EPL, MAXG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, length_scalar, static_cast<T*>(out), s_max, n_heads, n_kv, scale);
  return cudaGetLastError();
}

template <typename T, int EPL>
cudaError_t by_group(int group, const void* q, const void* k, const void* v,
                     const int* lengths, int length_scalar, void* out, int batch,
                     int s_max, int n_heads, int n_kv, float scale, cudaStream_t st) {
  if (group <= 1)
    return launch<T, EPL, 1>(q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
  if (group <= 2)
    return launch<T, EPL, 2>(q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
  if (group <= 4)
    return launch<T, EPL, 4>(q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
  if (group <= 8)
    return launch<T, EPL, 8>(q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int head_dim, int group, const void* q, const void* k, const void* v,
                   const int* lengths, int length_scalar, void* out, int batch,
                   int s_max, int n_heads, int n_kv, float scale, cudaStream_t st) {
  switch (head_dim) {
    case 32:
      return by_group<T, 1>(group, q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
    case 64:
      return by_group<T, 2>(group, q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
    case 96:
      return by_group<T, 3>(group, q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
    case 128:
      return by_group<T, 4>(group, q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
    case 256:
      return by_group<T, 8>(group, q, k, v, lengths, length_scalar, out, batch, s_max, n_heads, n_kv, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

DS_DEFINE_ERROR_STRING

// q (B, 1, H, D); k_cache/v_cache (B, S_max, KV, D); lengths (B,) int32 or
// NULL, then length_scalar holds for every row; out (B, 1, H, D). All
// contiguous, one dtype. Returns the cudaGetLastError() of the launch.
DS_EXPORT int decode_attention_fwd(const void* q, const void* k_cache, const void* v_cache,
                                   const void* lengths, int length_scalar, void* out,
                                   int batch, int s_max, int n_heads, int n_kv,
                                   int head_dim, float scale, int dtype, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv) return cudaErrorInvalidValue;
  const int group = n_heads / n_kv;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ds::kBFloat16)
    return by_dim<ds::bf16>(head_dim, group, q, k_cache, v_cache, len, length_scalar, out,
                            batch, s_max, n_heads, n_kv, scale, st);
  if (dtype == ds::kFloat32)
    return by_dim<float>(head_dim, group, q, k_cache, v_cache, len, length_scalar, out,
                         batch, s_max, n_heads, n_kv, scale, st);
  return cudaErrorInvalidValue;
}
