// One-token decode attention straight off the paged KV arena.
//
// Replaces the TPU kernel _paged_kernel
// (deepspeed_tpu/ops/pallas/paged_attention.py:88, via _pallas_paged).
//
// Computes, for every batch row b and query head h,
//   out[b, 0, h] = softmax(q[b, 0, h] . K_b[:L, kv]^T * scale) @ V_b[:L, kv]
// where position p of row b lives in arena page table[b, p / pt] at offset
// p % pt, L = min(lengths[b], T * pt) and kv = h / (H / KV) (GQA). Scores,
// the online softmax and the accumulator are fp32. A row with L == 0 gives
// zeros.
//
// Bound on the H100: bytes. A tick reads each row's live pages once,
// 2 * sum_b L_b * KV * D elements, plus q, out and the table, against
// 4 * sum_b L_b * H * D flops: far below the card's ~295 flops per byte.
//
// Design: the contiguous decode kernel's (decode_attention.cu) with another
// address map. One block per (KV head, batch row); warp w takes positions
// w, w + 8, ...; a warp reads one K row and one V row per position with
// neighbouring lanes on neighbouring elements, keeps the group's G query
// rows in registers and carries an online softmax per query head; the next
// position's rows are loaded before the current one is used. Each warp
// keeps the last (table entry, page id) pair it resolved, so it reads the
// table once per page it visits rather than once per position. The warps'
// partial (m, l, acc) merge through shared memory at the end.
//
// Hazards of the paged layout, and what the design does:
// - Dead rows. The TPU kernel fetched whole pages and had to zero the V
//   rows of its tail page past L (0 * inf poisons p @ v). This loop stops
//   at L: a position past it, and every unallocated or trash page, is never
//   read.
// - Free slots past the table. A free slot's length keeps growing across
//   decode windows while its table row is all trash; L is clamped to
//   T * pt, so the table is never indexed past T - 1. Page ids clip into
//   [0, P) (the XLA gather's mode="clip").
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int EPL, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ out, int n_pages,
                       int page_tokens, int n_entries, int n_heads, int n_kv, float scale) {
  constexpr int D = EPL * 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = n_heads / n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int L = max(0, min(lengths[b], n_entries * page_tokens));
  const int* trow = table + (size_t)b * n_entries;

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
  const size_t head_off = (size_t)kvh * D + lane;
  // element offset of position p's row for this head and lane; resolves the
  // page through the table only when p enters a new table entry
  int cached_blk = -1;
  size_t cached_base = 0;
  auto row_of = [&](int p) -> size_t {
    const int blk = p / page_tokens;
    if (blk != cached_blk) {
      cached_blk = blk;
      const int page = min(max(__ldg(trow + blk), 0), n_pages - 1);
      cached_base = (size_t)page * page_tokens * pos_stride + head_off;
    }
    return cached_base + (size_t)(p - blk * page_tokens) * pos_stride;
  };

  float kf[EPL], vf[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) kf[e] = vf[e] = 0.f;
  int p = warp;
  if (p < L) {
    const size_t r = row_of(p);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kf[e] = ds::to_float(k_pages[r + e * 32]);
      vf[e] = ds::to_float(v_pages[r + e * 32]);
    }
  }
  for (; p < L; p += kWarps) {
    float kn[EPL], vn[EPL];
    const int pn = p + kWarps;
    if (pn < L) {
      const size_t r = row_of(pn);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kn[e] = ds::to_float(k_pages[r + e * 32]);
        vn[e] = ds::to_float(v_pages[r + e * 32]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) kn[e] = vn[e] = 0.f;
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

struct Args {
  const void *q, *k, *v;
  const int *table, *lengths;
  void* out;
  int batch, n_pages, page_tokens, n_entries, n_heads, n_kv;
  float scale;
  cudaStream_t stream;
};

template <typename T, int EPL, int MAXG>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.n_kv, a.batch);
  paged_attention_kernel<T, EPL, MAXG><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.table, a.lengths, static_cast<T*>(a.out), a.n_pages, a.page_tokens, a.n_entries,
      a.n_heads, a.n_kv, a.scale);
  return cudaGetLastError();
}

template <typename T, int EPL>
cudaError_t by_group(int group, const Args& a) {
  if (group <= 1) return launch<T, EPL, 1>(a);
  if (group <= 2) return launch<T, EPL, 2>(a);
  if (group <= 4) return launch<T, EPL, 4>(a);
  if (group <= 8) return launch<T, EPL, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int head_dim, int group, const Args& a) {
  switch (head_dim) {
    case 32: return by_group<T, 1>(group, a);
    case 64: return by_group<T, 2>(group, a);
    case 96: return by_group<T, 3>(group, a);
    case 128: return by_group<T, 4>(group, a);
    case 256: return by_group<T, 8>(group, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

DS_DEFINE_ERROR_STRING

// q (B, 1, H, D); k_pages/v_pages (P, pt, KV, D); table (B, T) int32;
// lengths (B,) int32; out (B, 1, H, D). All contiguous, q and the arenas of
// one dtype. Returns the cudaGetLastError() of the launch.
DS_EXPORT int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                  const void* table, const void* lengths, void* out,
                                  int batch, int n_pages, int page_tokens, int n_entries,
                                  int n_heads, int n_kv, int head_dim, float scale, int dtype,
                                  void* stream) {
  if (n_kv <= 0 || n_heads % n_kv || page_tokens <= 0 || n_entries <= 0 || n_pages <= 0)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(table),
               static_cast<const int*>(lengths), out, batch, n_pages, page_tokens,
               n_entries, n_heads, n_kv, scale, static_cast<cudaStream_t>(stream)};
  const int group = n_heads / n_kv;
  if (dtype == ds::kBFloat16) return by_dim<ds::bf16>(head_dim, group, a);
  if (dtype == ds::kFloat32) return by_dim<float>(head_dim, group, a);
  return cudaErrorInvalidValue;
}
