// One-token decode attention straight off the paged KV arena, split over
// the cache and merged by lse (flash-decoding).
//
// Replaces the TPU kernel _paged_kernel
// (deepspeed_tpu/ops/pallas/paged_attention.py:88, via _pallas_paged).
//
// Computes, for every batch row b and query head h,
//   out[b, 0, h] = softmax(q[b, 0, h] . K_b[:L, kv]^T * scale) @ V_b[:L, kv]
// where position p of row b lives in arena page table[b, p / pt] at offset
// p % pt, L = min(lengths[b], T * pt) and kv = h / (H / KV) (GQA). Scores,
// softmax and p @ V are fp32. A row with L == 0 gives zeros.
//
// Bound on the H100: bytes. A tick reads each row's live pages once,
// 2 * sum_b L_b * KV * D elements, plus q, out and the table, against
// 4 * sum_b L_b * H * D flops.
//
// Design: the contiguous decode kernel's (decode_split.cuh) with a paged
// address map. One block per (64-position chunk, KV head, batch row),
// ceil(T * pt / 64) chunks; a block first reads the table entries its chunk
// spans (64 / pt of them, or 64 at pt = 1; clipped into [0, P), the XLA
// gather's mode="clip") into shared memory, then copies its live rows
// position by position through them, so any page size works and a chunk
// may start or end inside a page. Scores, softmax, p @ V and the merge by
// lse as in decode_split.cuh; what limits it as in decode_attention.cu
// (split 4-10 us, merge ~2.4 us at B = 8, T * pt = 512 on the H100).
//
// Hazards of the paged layout, and what the design does:
// - Dead rows. The tail page's positions past L, unallocated pages and the
//   trash page hold anything (NaN in a freed page). A row at or past L is
//   zero-filled by its copy (source size 0) and never read, and its p is 0,
//   so p @ V over the whole chunk sees zeros there.
// - Free slots past the table. A free slot's length keeps growing across
//   decode windows while its table row is all trash; L is clamped to
//   T * pt, so the table is never indexed past T - 1, and every chunk of
//   such a row is live and reads the trash page. That is correct: the
//   slot's output is discarded.
#include "decode_split.cuh"

using namespace ds::decode_split;

namespace {

struct PagedMap {
  const int* table;     // (B, T)
  const int* lengths;   // (B,)
  int n_pages, page_tokens, n_entries, n_kv;

  __device__ int total() const { return n_entries * page_tokens; }
  __device__ int length(int b) const { return max(0, min(lengths[b], total())); }
  // the table entries that the chunk starting at c0 spans, into ids
  __device__ void prepare(int b, int c0, int* ids) const {
    const int e0 = c0 / page_tokens;
    const int e1 = (min(c0 + kChunk, total()) - 1) / page_tokens;
    for (int e = e0 + (int)threadIdx.x; e <= e1; e += blockDim.x)
      ids[e - e0] = min(max(__ldg(table + (size_t)b * n_entries + e), 0), n_pages - 1);
  }
  // element offset of position p's row for KV head kvh
  template <int D>
  __device__ size_t row(int, int kvh, int c0, int p, const int* ids) const {
    const int page = ids[p / page_tokens - c0 / page_tokens];
    return (((size_t)page * page_tokens + p % page_tokens) * n_kv + kvh) * D;
  }
};

}  // namespace

DS_DEFINE_ERROR_STRING

// q (B, 1, H, D); k_pages/v_pages (P, pt, KV, D); table (B, T) int32;
// lengths (B,) int32; out (B, 1, H, D); ws fp32 (B, H, ceil(T * pt / 64),
// D + 2). All contiguous, q, the arenas and out of one dtype. Returns the
// cudaGetLastError() of the launches.
DS_EXPORT int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                  const void* table, const void* lengths, void* out, void* ws,
                                  int batch, int n_pages, int page_tokens, int n_entries,
                                  int n_heads, int n_kv, int head_dim, float scale, int dtype,
                                  void* stream) {
  if (n_kv <= 0 || page_tokens <= 0 || n_entries <= 0 || n_pages <= 0)
    return cudaErrorInvalidValue;
  const PagedMap map{static_cast<const int*>(table), static_cast<const int*>(lengths),
                     n_pages, page_tokens, n_entries, n_kv};
  const Launch a{q, k_pages, v_pages, out, static_cast<float*>(ws), batch, n_heads, n_kv,
                 (n_entries * page_tokens + kChunk - 1) / kChunk, scale,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a, map);
}
