// One-token decode attention split over the cache and merged by lse: the
// design that decode_attention.cu (contiguous cache) and
// paged_attention.cu (page arena) share. Each of those files gives an
// address map (ContiguousMap, PagedMap) and its C entry; everything below
// is common to both.
//
// The function, for batch row b and query head h (kv = h / G, G = H / KV):
//   out[b, 0, h] = softmax(q[b, 0, h] . K[b, :L, kv]^T * scale) @ V[b, :L, kv]
// with scores, softmax and p @ V in fp32, as the TPU kernels form them. A
// row with L == 0 gives zeros.
//
// Bound on the H100: bytes. A tick reads the live prefix of the cache once,
// 2 * sum_b L_b * KV * D elements, for 4 * sum_b L_b * H * D flops, far
// below the card's ~295 flops per byte. What limits a kernel at these sizes
// is latency: how many of those bytes are in flight at once, and how long
// the chain of dependent steps after them is.
//
// Split: one block of kThreads per (chunk of kChunk positions, KV head,
// batch row): ceil(S / kChunk) chunks, S the cache's positions (S_max, or
// T * pt for the arena), known to the host from shapes alone (no read of
// lengths there). A block whose chunk starts at or past L exits at once.
// Each block serves all G query heads of its KV head, so K and V are read
// once per group.
//
// Load: the chunk's K rows, then its V rows, go to shared memory as 16-byte
// cp.async copies, neighbouring threads on neighbouring 16 bytes, every copy
// of a tile in flight together (one commit group per tile: scores start as
// soon as K has landed, while V is still arriving). Rows get 16 bytes of
// padding, so the score phase's 16-byte reads of 8 neighbouring rows fall in
// distinct banks. Dead rows: a row at or past L is never read; its copy is
// issued with source size 0, which zero-fills it. The p @ V loop runs over
// every row of the chunk (p = 0 past L), so a dead row that held what the
// cache holds there (NaN in a freed page) would poison the output: the
// zero fill is what keeps it out, as the TPU kernels zero those V rows
// (decode_attention.py:124-129, paged_attention.py:111-115).
//
// Scores: thread t takes position t % kChunk against query heads
// t / kChunk, + 2, ...: its own dot products over D in fp32 FMAs from
// shared memory (q pre-scaled, in fp32, read as a broadcast), no
// per-position warp reduction. Positions >= L are -inf. One warp per head
// then takes the chunk's max m, p = exp(s - m) and l = sum p.
//
// p @ V in fp32: a thread owns a pair of output columns for one or more
// heads and loops over the chunk's rows, p and V from shared memory. p is
// never rounded to bf16.
//
// Merge: each live block writes its unnormalised acc, m and l (fp32) to the
// workspace (B, H, n_chunks, D + 2) that the wrapper allocates, and a
// second kernel, launched from the same C entry on the same stream,
// combines each (row, head)'s ceil(L / kChunk) live states in chunk order:
// M = max m_i, out = sum acc_i e^(m_i - M) / sum l_i e^(m_i - M), zeros
// where nothing is live; one thread per output column. The merge runs at
// every n_chunks, one included. It takes 1.4-2.6 us of device time on the
// H100 at B = 8, S = 512; a "last block merges" counter would need a zeroed
// counter array per call, whose memset costs a launch as well. Each call
// gives the same bits: no atomics, fixed orders.
#pragma once

#include <atomic>

#include "common.cuh"

namespace ds {
namespace decode_split {

constexpr int kChunk = 64;        // positions per block; the wrappers' CHUNK
constexpr int kThreads = 128;
constexpr int kMaxDim = 256;      // the merge's threads: one per head column
static_assert(kChunk == 64, "the softmax phase gives each lane two positions");
static_assert(kThreads == 2 * kChunk, "the score phase takes two head sets");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = live ? 16 : 0;   // 0: nothing is read, the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// eight neighbouring elements of a shared-memory row (16-byte aligned)
__device__ __forceinline__ void smem8(const bf16* p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void smem8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ float2 smem2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 smem2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// shared memory of one block: K and V tiles, q (fp32, scaled), scores / p,
// each head's m and l, and the chunk's page ids (paged map only)
template <typename T, int D, int MAXG>
struct Layout {
  static constexpr int kRowBytes = D * (int)sizeof(T) + 16;   // padded row
  static constexpr int kSegs = D * (int)sizeof(T) / 16;        // 16-byte copies per row
  static constexpr int kTileBytes = kChunk * kRowBytes;
  static constexpr int kPStride = kChunk + 4;                  // fp32 score row
  static constexpr int kQ = 2 * kTileBytes;                    // byte offsets
  static constexpr int kP = kQ + MAXG * D * 4;
  static constexpr int kM = kP + MAXG * kPStride * 4;
  static constexpr int kL = kM + MAXG * 4;
  static constexpr int kIds = kL + MAXG * 4;
  static constexpr int kBytes = kIds + kChunk * 4;
  static_assert(D * sizeof(T) % 16 == 0, "rows are copied in 16-byte pieces");
};

template <typename T, int D, int MAXG, class Map>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const Map map, float* __restrict__ ws, int n_heads, int n_kv, int n_chunks,
             float scale) {
  using Lay = Layout<T, D, MAXG>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + Lay::kTileBytes;
  float* q_s = reinterpret_cast<float*>(smem + Lay::kQ);
  float* p_s = reinterpret_cast<float*>(smem + Lay::kP);
  float* m_s = reinterpret_cast<float*>(smem + Lay::kM);
  float* l_s = reinterpret_cast<float*>(smem + Lay::kL);
  int* ids_s = reinterpret_cast<int*>(smem + Lay::kIds);

  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = n_heads / n_kv;
  const size_t head0 = (size_t)b * n_heads + (size_t)kvh * group;   // (b, first head)
  const int L = map.length(b);
  const int c0 = chunk * kChunk;
  if (c0 >= L) return;   // nothing live in this chunk: the merge skips it
  const int n = min(kChunk, L - c0);   // live rows of the chunk

  map.prepare(b, c0, ids_s);
  __syncthreads();
  // K, then V: every 16-byte copy of a tile in flight at once
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    const T* src = t == 0 ? k : v;
    unsigned char* dst = t == 0 ? k_s : v_s;
    for (int i = tid; i < kChunk * Lay::kSegs; i += kThreads) {
      const int r = i / Lay::kSegs, seg = i % Lay::kSegs;
      const bool live = r < n;   // rows at or past L: zero-filled, never read
      const size_t row = map.template row<D>(b, kvh, c0, c0 + (live ? r : 0), ids_s);
      cp_async16(dst + r * Lay::kRowBytes + seg * 16, src + row + seg * (16 / sizeof(T)),
                 live);
    }
    cp_async_commit();
  }
  for (int i = tid; i < group * D; i += kThreads)
    q_s[i] = to_float(q[head0 * D + i]) * scale;
  cp_async_wait<1>();   // this thread's K copies have landed
  __syncthreads();      // and everyone's, and q

  // scores: position j against heads gs, gs + 2, ...
  {
    constexpr int kSH = (MAXG + 1) / 2;
    const int j = tid % kChunk, gs = tid / kChunk;
    const T* krow = reinterpret_cast<const T*>(k_s + j * Lay::kRowBytes);
    float s[kSH];
#pragma unroll
    for (int i = 0; i < kSH; ++i) s[i] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      float kf[8];
      smem8(krow + d0, kf);
#pragma unroll
      for (int i = 0; i < kSH; ++i) {
        const int g = gs + 2 * i;
        if (g < group) {
          const float4 a = *reinterpret_cast<const float4*>(q_s + g * D + d0);
          const float4 c = *reinterpret_cast<const float4*>(q_s + g * D + d0 + 4);
          s[i] = fmaf(a.x, kf[0], s[i]);
          s[i] = fmaf(a.y, kf[1], s[i]);
          s[i] = fmaf(a.z, kf[2], s[i]);
          s[i] = fmaf(a.w, kf[3], s[i]);
          s[i] = fmaf(c.x, kf[4], s[i]);
          s[i] = fmaf(c.y, kf[5], s[i]);
          s[i] = fmaf(c.z, kf[6], s[i]);
          s[i] = fmaf(c.w, kf[7], s[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSH; ++i) {
      const int g = gs + 2 * i;
      if (g < group) p_s[g * Lay::kPStride + j] = j < n ? s[i] : -INFINITY;
    }
  }
  __syncthreads();

  // the chunk's softmax state, one warp per head
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < group; g += kThreads / 32) {
      float* row = p_s + g * Lay::kPStride;
      const float a = row[lane], c = row[lane + 32];
      float m = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float m_safe = m == -INFINITY ? 0.f : m;
      const float pa = expf(a - m_safe), pc = expf(c - m_safe);
      const float l = warp_sum(pa + pc);
      row[lane] = pa;
      row[lane + 32] = pc;
      if (lane == 0) {
        m_s[g] = m;
        l_s[g] = l;
      }
    }
  }
  cp_async_wait<0>();   // V
  __syncthreads();

  // p @ V: column pair cg of heads hs, hs + kHS, ...
  constexpr int kCols = D / 2;
  constexpr int kHS = kThreads / kCols > 0 ? kThreads / kCols : 1;
  constexpr int kNH = (MAXG + kHS - 1) / kHS;
  const int cg = tid % kCols, hs = tid / kCols;
  if (hs >= kHS) return;
  float2 acc[kNH];
#pragma unroll
  for (int i = 0; i < kNH; ++i) acc[i] = make_float2(0.f, 0.f);
  const T* vcol = reinterpret_cast<const T*>(v_s) + 2 * cg;
#pragma unroll 8
  for (int j = 0; j < kChunk; ++j) {   // every row: dead rows are zero, p = 0 there
    const float2 vv = smem2(reinterpret_cast<const T*>(
        reinterpret_cast<const unsigned char*>(vcol) + j * Lay::kRowBytes));
#pragma unroll
    for (int i = 0; i < kNH; ++i) {
      const int g = hs + i * kHS;
      if (g < group) {
        const float p = p_s[g * Lay::kPStride + j];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNH; ++i) {
    const int g = hs + i * kHS;
    if (g >= group) continue;
    float* w = ws + ((head0 + g) * n_chunks + chunk) * (D + 2);
    *reinterpret_cast<float2*>(w + 2 * cg) = acc[i];
    if (cg == 0) *reinterpret_cast<float2*>(w + D) = make_float2(m_s[g], l_s[g]);
  }
}

// one block per (head, batch row), one thread per output column: the live
// chunks' states in chunk order (each thread takes the same M and den)
template <typename T, class Map>
__global__ void __launch_bounds__(kMaxDim)
merge_kernel(const float* __restrict__ ws, const Map map, T* __restrict__ out, int n_heads,
             int n_chunks, int head_dim) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int nc = (map.length(b) + kChunk - 1) / kChunk;   // live chunks
  const int stride = head_dim + 2;
  const float* part = ws + ((size_t)b * n_heads + h) * n_chunks * stride;
  float M = -INFINITY;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) M = fmaxf(M, part[c * stride + head_dim]);
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int i = 0; i < nc; ++i) {
    const float* st = part + i * stride;
    const float w = st[head_dim] == -INFINITY ? 0.f : expf(st[head_dim] - M);
    num = fmaf(st[d], w, num);
    den = fmaf(st[head_dim + 1], w, den);
  }
  out[((size_t)b * n_heads + h) * head_dim + d] = from_float<T>(den > 0.f ? num / den : 0.f);
}

struct Launch {
  const void *q, *k, *v;
  void* out;
  float* ws;   // (B, H, n_chunks, D + 2) fp32
  int batch, n_heads, n_kv, n_chunks;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int MAXG, class Map>
cudaError_t launch(const Launch& a, const Map& map) {
  using Lay = Layout<T, D, MAXG>;
  if (a.n_chunks < 1 || a.ws == nullptr) return cudaErrorInvalidValue;
  if (Lay::kBytes > 48 * 1024) {   // above the default: ask once per device
    static std::atomic<unsigned long long> allowed{0};   // a bit per device id < 64
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(allowed.load(std::memory_order_relaxed) & bit)) {
      e = cudaFuncSetAttribute(split_kernel<T, D, MAXG, Map>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
      if (e != cudaSuccess) return e;
      allowed.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  split_kernel<T, D, MAXG, Map><<<dim3(a.n_chunks, a.n_kv, a.batch), kThreads, Lay::kBytes,
                                  a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), map,
      a.ws, a.n_heads, a.n_kv, a.n_chunks, a.scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_kernel<T, Map><<<dim3(a.n_heads, a.batch), D, 0, a.stream>>>(
      a.ws, map, static_cast<T*>(a.out), a.n_heads, a.n_chunks, D);
  return cudaGetLastError();
}

template <typename T, int D, class Map>
cudaError_t by_group(int group, const Launch& a, const Map& map) {
  if (group <= 1) return launch<T, D, 1>(a, map);
  if (group <= 2) return launch<T, D, 2>(a, map);
  if (group <= 4) return launch<T, D, 4>(a, map);
  if (group <= 8) return launch<T, D, 8>(a, map);
  return cudaErrorInvalidValue;
}

template <typename T, class Map>
cudaError_t by_dim(int head_dim, const Launch& a, const Map& map) {
  if (a.n_kv <= 0 || a.n_heads % a.n_kv) return cudaErrorInvalidValue;
  const int group = a.n_heads / a.n_kv;
  switch (head_dim) {
    case 32: return by_group<T, 32>(group, a, map);
    case 64: return by_group<T, 64>(group, a, map);
    case 96: return by_group<T, 96>(group, a, map);
    case 128: return by_group<T, 128>(group, a, map);
    case 256: return by_group<T, 256>(group, a, map);
    default: return cudaErrorInvalidValue;
  }
}

template <class Map>
cudaError_t dispatch(int dtype, int head_dim, const Launch& a, const Map& map) {
  if (dtype == kBFloat16) return by_dim<bf16>(head_dim, a, map);
  if (dtype == kFloat32) return by_dim<float>(head_dim, a, map);
  return cudaErrorInvalidValue;
}

}  // namespace decode_split
}  // namespace ds
