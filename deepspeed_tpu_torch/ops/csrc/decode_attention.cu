// One-token decode attention over a contiguous KV cache, split over the
// cache and merged by lse (flash-decoding).
//
// Replaces the TPU kernels _decode_kernel and _decode_kernel_blocked
// (deepspeed_tpu/ops/pallas/decode_attention.py:78, :101).
//
// Computes, for every batch row b and query head h,
//   out[b, 0, h] = softmax(q[b, 0, h] . K[b, :L, kv]^T * scale) @ V[b, :L, kv]
// with L = lengths[b] (or one scalar length for the whole batch, lengths ==
// NULL) and kv = h / (H / KV) (GQA: the H / KV query heads of a group share
// one K/V head). Scores, softmax and p @ V are fp32. A row with L == 0 gives
// zeros.
//
// Bound on the H100: bytes, 2 * sum_b L_b * KV * D elements of cache per
// tick against 4 * sum_b L_b * H * D flops. The design (decode_split.cuh,
// shared with paged_attention.cu): one block per (64-position chunk, KV
// head, batch row), ceil(S_max / 64) chunks; each block copies its chunk's
// live K and V rows into shared memory with cp.async (rows past L
// zero-filled, never read), takes the G x 64 scores with per-thread FMAs,
// the chunk's softmax state and p @ V in fp32, and writes (acc, m, l) to
// the workspace; a merge kernel combines a row's live chunks in order.
//
// What limits it: not bytes but latency. At B = 8, S_max 512 on the H100
// the split kernel takes 4-9 us against a 0.6-4.4 us byte bound (one
// chunk's load, then its scores, softmax and p @ V in turn) and the merge
// ~2.4 us, most of it the second launch.
#include "decode_split.cuh"

using namespace ds::decode_split;

namespace {

struct ContiguousMap {
  const int* lengths;   // (B,), or null: length_scalar for every row
  int length_scalar, s_max, n_kv;

  __device__ int length(int b) const {
    const int L = lengths != nullptr ? lengths[b] : length_scalar;
    return max(0, min(L, s_max));   // memory bound only: the wrapper validates
  }
  __device__ int total() const { return s_max; }
  __device__ void prepare(int, int, int*) const {}
  // element offset of position p's row for KV head kvh
  template <int D>
  __device__ size_t row(int b, int kvh, int, int p, const int*) const {
    return (((size_t)b * s_max + p) * n_kv + kvh) * D;
  }
};

}  // namespace

DS_DEFINE_ERROR_STRING

// q (B, 1, H, D); k_cache/v_cache (B, S_max, KV, D); lengths (B,) int32 or
// NULL, then length_scalar holds for every row; out (B, 1, H, D); ws fp32
// (B, H, ceil(S_max / 64), D + 2). All contiguous, q, caches and out of
// one dtype. Returns the
// cudaGetLastError() of the launches.
DS_EXPORT int decode_attention_fwd(const void* q, const void* k_cache, const void* v_cache,
                                   const void* lengths, int length_scalar, void* out,
                                   void* ws, int batch, int s_max, int n_heads, int n_kv,
                                   int head_dim, float scale, int dtype, void* stream) {
  if (s_max <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  const ContiguousMap map{static_cast<const int*>(lengths), length_scalar, s_max, n_kv};
  const Launch a{q, k_cache, v_cache, out, static_cast<float*>(ws), batch, n_heads, n_kv,
                 (s_max + kChunk - 1) / kChunk, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a, map);
}
