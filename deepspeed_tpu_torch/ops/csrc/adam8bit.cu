// Fused AdamW over int8 / uint8 moments with a row-absmax requant: one
// launch updates every leaf of a table.
//
// Replaces the TPU kernel _kernel
// (deepspeed_tpu/ops/pallas/adam8bit_kernel.py:55).
//
// Per element of a (R, C) leaf, with the step scalars [gscale, lr, c1, c2]
// read from a 4-float device array (the TPU kernel's SMEM operand):
//   g  = g * gscale (+ l2 * p)
//   m  = b1 * (mc * scm) + (1 - b1) * g
//   r0 = rc * scr;  v = b2 * r0^2 + (1 - b2) * g^2;  r = sqrt(v)
//   upd = (m * (1/c1)) / (r * (1/sqrt(c2)) + eps) (+ wd * p)
//   p' = p - lr * upd
// and per row the new codes and scales from the row's absmax:
//   mc' = clip(rint(m * 127/amax|m|), -127, 127), scm' = amax|m| / 127
//   rc' = clip(rint(r * 255/amax r),    0, 255), scr' = amax r / 255
// (a zero absmax gives scale 1). p, mc, rc, scm and scr are updated in
// place, as the TPU kernel's input_output_aliases do.
//
// Bound on the H100: bytes. Each element reads g and p (fp32) and the two
// codes and writes p and the two codes: 16 bytes, against a few dozen
// flops; at GPT-2-1.5B (1.56e9 elements) that is 24.9 GB, 7.4 ms at
// 3.35 TB/s.
//
// Design. One launch takes a table of up to kMaxLeaves leaves by value (a
// __grid_constant__ kernel parameter: each leaf's gradient, parameter, codes
// and scales, its shape, its first work item and its plan), so the step of a
// whole model is one launch or a few, and the gradients' pointers reach the
// card with the launch: no copy for the stream to wait on. A work item is
// whole rows (a row's codes need its whole absmax): rows_per_item
// consecutive rows of a leaf, one block an item. The block's first `threads`
// threads take the item's chunks of 8 elements, chunk f to thread f % threads
// in sweep f / threads, at most kSlots sweeps; the host (ops/adam8bit.py,
// leaf_plan) picks rows and threads so that threads x sweeps is the chunk
// count where it can, so no thread idles in the last sweep. A thread loads all
// its chunks first (16-byte loads of g and p, 8-byte loads of the codes where
// the row width is a multiple of 8 and the leaf is aligned; masked scalar
// loads otherwise), then forms m and r, writes p' at once (p' needs no
// absmax) and keeps m and r in registers. Each chunk's two maxima go to
// shared memory, a row's run of entries is reduced by one warp (by one
// thread for rows of under 32 chunks), and the codes are written from the
// registers: every byte is read once and written once. Rows of more than
// kHeld chunks (8192 elements) take a block each and two passes, the maxima
// and then the update recomputed from the still unmodified inputs (the same
// function of the same values). Measured on an H100 (PERF.md, row 10): 76%
// of the byte bound over a GPT-2-1.5B step; a persistent grid striding over
// the items (no leaf search a block) spilled under two blocks an SM and ran
// 1.6x slower.
//
// Every thread reads the old scales of its rows before the first barrier of
// its block; the new ones are written after the last. The arithmetic uses
// the _rn intrinsics, so nvcc contracts nothing into an FMA and the plain
// PyTorch version rounds at the same points; the maxima are exact in any
// order, so any split of a row gives the same bits. rintf rounds half to
// even, as jnp.round does.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                 // chunks of 8 a thread holds
constexpr int kHeld = kThreads * kSlots;  // chunks an item holds in registers
constexpr int kMaxLeaves = 500;           // leaves a launch's table carries
constexpr int kCols = 10;                 // int64 columns of a host table row

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd, l2;
};

// A launch's leaves. plan: rows an item (bits 0-10), threads an item (11-19),
// wide (20: one row an item, two passes), vec (21: 16- and 8-byte loads; the
// gradient's alignment is checked here as well).
struct Table {
  const float* g[kMaxLeaves];
  float* p[kMaxLeaves];
  signed char* mc[kMaxLeaves];
  unsigned char* rc[kMaxLeaves];
  float* scm[kMaxLeaves];
  float* scr[kMaxLeaves];
  const float* scalars;
  Hyper a;
  int n_leaves;
  int first[kMaxLeaves + 1];  // first item of each leaf; first[n_leaves] = items
  int rows[kMaxLeaves];
  int cols[kMaxLeaves];
  int plan[kMaxLeaves];
};
static_assert(sizeof(Table) <= 32764, "a kernel parameter holds at most 32764 bytes");

struct Step {
  float gscale, lr, inv_c1, rs_c2;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// m and r of one element: the same instructions in every path
__device__ __forceinline__ void moments(float g, float p, signed char mc, unsigned char rc,
                                        float scm, float scr, float gscale, const Hyper& a,
                                        float& m, float& r) {
  g = __fmul_rn(g, gscale);
  if (a.l2 != 0.f) g = __fadd_rn(g, __fmul_rn(a.l2, p));
  m = __fadd_rn(__fmul_rn(a.b1, __fmul_rn(static_cast<float>(mc), scm)), __fmul_rn(a.omb1, g));
  const float r0 = __fmul_rn(static_cast<float>(rc), scr);
  const float v =
      __fadd_rn(__fmul_rn(a.b2, __fmul_rn(r0, r0)), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  r = __fsqrt_rn(v);
}

__device__ __forceinline__ float new_p(float p, float m, float r, const Step& s, const Hyper& a) {
  float upd = __fdiv_rn(__fmul_rn(m, s.inv_c1), __fadd_rn(__fmul_rn(r, s.rs_c2), a.eps));
  if (a.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(a.wd, p));
  return __fsub_rn(p, __fmul_rn(s.lr, upd));
}

__device__ __forceinline__ unsigned code_m(float m, float inv_m) {
  return static_cast<unsigned char>(
      static_cast<signed char>(fminf(fmaxf(rintf(__fmul_rn(m, inv_m)), -127.f), 127.f)));
}

__device__ __forceinline__ unsigned code_r(float r, float inv_r) {
  return static_cast<unsigned char>(fminf(fmaxf(rintf(__fmul_rn(r, inv_r)), 0.f), 255.f));
}

__device__ __forceinline__ unsigned byte_of(const uint2& w, int i) {
  return ((i < 4 ? w.x : w.y) >> (8 * (i & 3))) & 0xffu;
}

// Eight elements of a leaf from element `off` of its row-major data: n of
// them (8 with VEC, which needs a row width that is a multiple of 8 and
// aligned data), the codes packed as bytes.
struct Chunk {
  float g[8], p[8];
  uint2 mc, rc;
};

template <bool VEC>
__device__ __forceinline__ void load_chunk(const float* g, const float* p, const signed char* mc,
                                           const unsigned char* rc, size_t off, int n,
                                           Chunk& c) {
  if constexpr (VEC) {
    const float4 g0 = __ldcs(reinterpret_cast<const float4*>(g + off));
    const float4 g1 = __ldcs(reinterpret_cast<const float4*>(g + off) + 1);
    const float4 p0 = __ldcs(reinterpret_cast<const float4*>(p + off));
    const float4 p1 = __ldcs(reinterpret_cast<const float4*>(p + off) + 1);
    c.g[0] = g0.x; c.g[1] = g0.y; c.g[2] = g0.z; c.g[3] = g0.w;
    c.g[4] = g1.x; c.g[5] = g1.y; c.g[6] = g1.z; c.g[7] = g1.w;
    c.p[0] = p0.x; c.p[1] = p0.y; c.p[2] = p0.z; c.p[3] = p0.w;
    c.p[4] = p1.x; c.p[5] = p1.y; c.p[6] = p1.z; c.p[7] = p1.w;
    c.mc = __ldcs(reinterpret_cast<const uint2*>(mc + off));
    c.rc = __ldcs(reinterpret_cast<const uint2*>(rc + off));
  } else {
    unsigned wm[2] = {0u, 0u}, wr[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool in = i < n;
      c.g[i] = in ? g[off + i] : 0.f;
      c.p[i] = in ? p[off + i] : 0.f;
      wm[i >> 2] |= (in ? static_cast<unsigned char>(mc[off + i]) : 0u) << (8 * (i & 3));
      wr[i >> 2] |= (in ? static_cast<unsigned>(rc[off + i]) : 0u) << (8 * (i & 3));
    }
    c.mc = make_uint2(wm[0], wm[1]);
    c.rc = make_uint2(wr[0], wr[1]);
  }
}

template <bool VEC>
__device__ __forceinline__ void store_p(float* p, size_t off, int n, const float (&v)[8]) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<float4*>(p + off), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p + off) + 1, make_float4(v[4], v[5], v[6], v[7]));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[off + i] = v[i];
  }
}

template <bool VEC>
__device__ __forceinline__ void store_codes(signed char* mc, unsigned char* rc, size_t off, int n,
                                            const uint2& wm, const uint2& wr) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<uint2*>(mc + off), wm);
    __stcs(reinterpret_cast<uint2*>(rc + off), wr);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) {
        mc[off + i] = static_cast<signed char>(byte_of(wm, i));
        rc[off + i] = static_cast<unsigned char>(byte_of(wr, i));
      }
  }
}

// The codes of a chunk's elements from the row's maxima.
__device__ __forceinline__ void chunk_codes(const float (&m)[8], const float (&r)[8], float am,
                                            float ar, uint2& wm, uint2& wr) {
  const float inv_m = am > 0.f ? __fdiv_rn(127.f, am) : 1.f;
  const float inv_r = ar > 0.f ? __fdiv_rn(255.f, ar) : 1.f;
  unsigned a[2] = {0u, 0u}, b[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i >> 2] |= code_m(m[i], inv_m) << (8 * (i & 3));
    b[i >> 2] |= code_r(r[i], inv_r) << (8 * (i & 3));
  }
  wm = make_uint2(a[0], a[1]);
  wr = make_uint2(b[0], b[1]);
}

struct Leaf {
  const float* g;
  float* p;
  signed char* mc;
  unsigned char* rc;
  float* scm;
  float* scr;
  int C;
};

// rows row0 .. row0 + nrows - 1, every chunk held in registers
template <bool VEC>
__device__ __forceinline__ void held_item(const Leaf& L, int row0, int nrows, int threads,
                                          const Step& s, const Hyper& a, float* part_m,
                                          float* part_r, float* max_m, float* max_r) {
  const int nc = (L.C + 7) >> 3;
  const int F = nrows * nc;
  const int tid = threadIdx.x;
  Chunk ch[kSlots];
  float om[kSlots], orr[kSlots];
  // every load first: kSlots chunks in flight a thread
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int f = tid + j * threads;
    if (tid < threads && f < F) {
      const int k = f / nc, c = f - k * nc;
      const size_t row = static_cast<size_t>(row0 + k);
      load_chunk<VEC>(L.g, L.p, L.mc, L.rc, row * L.C + 8 * c, L.C - 8 * c, ch[j]);
      om[j] = L.scm[row];  // the old scales, read before the first barrier
      orr[j] = L.scr[row];
    }
  }
  float m[kSlots][8], r[kSlots][8];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int f = tid + j * threads;
    if (tid < threads && f < F) {
      const int k = f / nc, c = f - k * nc;
      const int n = L.C - 8 * c;
      float am = 0.f, ar = 0.f, pn[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        moments(ch[j].g[i], ch[j].p[i], static_cast<signed char>(byte_of(ch[j].mc, i)),
                static_cast<unsigned char>(byte_of(ch[j].rc, i)), om[j], orr[j], s.gscale, a,
                m[j][i], r[j][i]);
        pn[i] = new_p(ch[j].p[i], m[j][i], r[j][i], s, a);
        if (VEC || i < n) {
          am = fmaxf(am, fabsf(m[j][i]));
          ar = fmaxf(ar, r[j][i]);
        }
      }
      store_p<VEC>(L.p, static_cast<size_t>(row0 + k) * L.C + 8 * c, n, pn);
      part_m[f] = am;
      part_r[f] = ar;
    }
  }
  __syncthreads();
  // each row's maxima over its run of chunk entries
  if (nc < 32) {
    for (int k = tid; k < nrows; k += kThreads) {
      float am = 0.f, ar = 0.f;
      for (int c = 0; c < nc; ++c) {
        am = fmaxf(am, part_m[k * nc + c]);
        ar = fmaxf(ar, part_r[k * nc + c]);
      }
      max_m[k] = am;
      max_r[k] = ar;
    }
  } else {
    const int warp = tid / 32, lane = tid % 32;
    for (int k = warp; k < nrows; k += kWarps) {
      float am = 0.f, ar = 0.f;
      for (int c = lane; c < nc; c += 32) {
        am = fmaxf(am, part_m[k * nc + c]);
        ar = fmaxf(ar, part_r[k * nc + c]);
      }
      am = warp_max(am);
      ar = warp_max(ar);
      if (lane == 0) {
        max_m[k] = am;
        max_r[k] = ar;
      }
    }
  }
  __syncthreads();  // every old scale of the item has been read
  for (int k = tid; k < nrows; k += kThreads) {
    const float am = max_m[k], ar = max_r[k];
    L.scm[row0 + k] = am > 0.f ? __fmul_rn(am, static_cast<float>(1.0 / 127.0)) : 1.f;
    L.scr[row0 + k] = ar > 0.f ? __fmul_rn(ar, static_cast<float>(1.0 / 255.0)) : 1.f;
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int f = tid + j * threads;
    if (tid < threads && f < F) {
      const int k = f / nc, c = f - k * nc;
      uint2 wm, wr;
      chunk_codes(m[j], r[j], max_m[k], max_r[k], wm, wr);
      store_codes<VEC>(L.mc, L.rc, static_cast<size_t>(row0 + k) * L.C + 8 * c, L.C - 8 * c,
                       wm, wr);
    }
  }
}

// one row of more than kHeld chunks: the maxima, then the update recomputed
template <bool VEC>
__device__ __forceinline__ void wide_item(const Leaf& L, int row, const Step& s, const Hyper& a,
                                          float* red) {
  const int nc = (L.C + 7) >> 3;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(row) * L.C;
  const float om = L.scm[row], orr = L.scr[row];  // read before the barrier below
  float am = 0.f, ar = 0.f;
  for (int c = tid; c < nc; c += kThreads) {
    Chunk ch;
    const int n = L.C - 8 * c;
    load_chunk<VEC>(L.g, L.p, L.mc, L.rc, base + 8 * c, n, ch);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float m, r;
      moments(ch.g[i], ch.p[i], static_cast<signed char>(byte_of(ch.mc, i)),
              static_cast<unsigned char>(byte_of(ch.rc, i)), om, orr, s.gscale, a, m, r);
      if (VEC || i < n) {
        am = fmaxf(am, fabsf(m));
        ar = fmaxf(ar, r);
      }
    }
  }
  am = warp_max(am);
  ar = warp_max(ar);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    red[warp] = am;
    red[kWarps + warp] = ar;
  }
  __syncthreads();  // every thread has read the old scales
  am = red[0];
  ar = red[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    am = fmaxf(am, red[w]);
    ar = fmaxf(ar, red[kWarps + w]);
  }
  if (tid == 0) {
    L.scm[row] = am > 0.f ? __fmul_rn(am, static_cast<float>(1.0 / 127.0)) : 1.f;
    L.scr[row] = ar > 0.f ? __fmul_rn(ar, static_cast<float>(1.0 / 255.0)) : 1.f;
  }
  for (int c = tid; c < nc; c += kThreads) {
    Chunk ch;
    const int n = L.C - 8 * c;
    load_chunk<VEC>(L.g, L.p, L.mc, L.rc, base + 8 * c, n, ch);
    float m[8], r[8], pn[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      moments(ch.g[i], ch.p[i], static_cast<signed char>(byte_of(ch.mc, i)),
              static_cast<unsigned char>(byte_of(ch.rc, i)), om, orr, s.gscale, a, m[i], r[i]);
      pn[i] = new_p(ch.p[i], m[i], r[i], s, a);
    }
    store_p<VEC>(L.p, base + 8 * c, n, pn);
    uint2 wm, wr;
    chunk_codes(m, r, am, ar, wm, wr);
    store_codes<VEC>(L.mc, L.rc, base + 8 * c, n, wm, wr);
  }
}

__global__ void __launch_bounds__(kThreads, 2) adam8bit_kernel(const __grid_constant__ Table t) {
  __shared__ float part_m[kHeld], part_r[kHeld], max_m[kHeld], max_r[kHeld];
  const int item = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;  // the leaf whose items hold this one
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= item) lo = mid;
    else hi = mid - 1;
  }
  const Leaf L{t.g[lo], t.p[lo], t.mc[lo], t.rc[lo], t.scm[lo], t.scr[lo], t.cols[lo]};
  const int plan = t.plan[lo];
  const int per_item = plan & 0x7ff, threads = (plan >> 11) & 0x1ff;
  const bool wide = (plan >> 20) & 1;
  const bool vec = ((plan >> 21) & 1) && (reinterpret_cast<uintptr_t>(L.g) & 15) == 0;
  const int row0 = (item - t.first[lo]) * per_item;
  const int nrows = min(per_item, t.rows[lo] - row0);
  const float* sc = t.scalars;
  const Step s{sc[0], sc[1], __fdiv_rn(1.f, sc[2]), __fdiv_rn(1.f, __fsqrt_rn(sc[3]))};
  if (wide) {
    if (vec) wide_item<true>(L, row0, s, t.a, part_m);
    else wide_item<false>(L, row0, s, t.a, part_m);
  } else if (vec) {
    held_item<true>(L, row0, nrows, threads, s, t.a, part_m, part_r, max_m, max_r);
  } else {
    held_item<false>(L, row0, nrows, threads, s, t.a, part_m, part_r, max_m, max_r);
  }
}

}  // namespace

DS_DEFINE_ERROR_STRING

// One launch over a table of n_leaves leaves (1 .. kMaxLeaves), given as a
// host array of n_leaves rows of kCols int64: the device pointers g, p, mc,
// rc, scm, scr, then rows R, columns C, the leaf's first work item and its
// plan (ops/adam8bit.py, LeafTable); n_items work items in all. g, p (R, C)
// fp32; mc (R, C) int8; rc (R, C) uint8; scm, scr (R, 1) fp32; scalars
// [gscale, lr, c1, c2] fp32, all on the device. Updates p, mc, rc, scm and
// scr in place. Returns the cudaGetLastError() of the launch.
DS_EXPORT int adam8bit_update(const long long* table, int n_leaves, int n_items,
                              const void* scalars, float b1, float b2, float omb1, float omb2,
                              float eps, float wd, float l2, void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_items <= 0) return cudaErrorInvalidValue;
  Table t;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* row = table + static_cast<size_t>(i) * kCols;
    t.g[i] = reinterpret_cast<const float*>(row[0]);
    t.p[i] = reinterpret_cast<float*>(row[1]);
    t.mc[i] = reinterpret_cast<signed char*>(row[2]);
    t.rc[i] = reinterpret_cast<unsigned char*>(row[3]);
    t.scm[i] = reinterpret_cast<float*>(row[4]);
    t.scr[i] = reinterpret_cast<float*>(row[5]);
    t.rows[i] = static_cast<int>(row[6]);
    t.cols[i] = static_cast<int>(row[7]);
    t.first[i] = static_cast<int>(row[8]);
    t.plan[i] = static_cast<int>(row[9]);
  }
  t.first[n_leaves] = n_items;
  // a plan the kernel cannot follow is refused here, not run
  for (int i = 0; i < n_leaves; ++i) {
    const int R = t.rows[i], C = t.cols[i], plan = t.plan[i];
    const int per_item = plan & 0x7ff, threads = (plan >> 11) & 0x1ff, nc = (C + 7) / 8;
    const bool wide = (plan >> 20) & 1;
    const bool ok = R > 0 && C > 0 && per_item > 0 && threads > 0 && threads <= kThreads &&
                    (wide ? per_item == 1 : per_item * nc <= threads * kSlots) &&
                    t.first[i + 1] - t.first[i] == (R + per_item - 1) / per_item;
    if (!ok || t.first[0] != 0) return cudaErrorInvalidValue;
  }
  t.scalars = static_cast<const float*>(scalars);
  t.a = Hyper{b1, b2, omb1, omb2, eps, wd, l2};
  t.n_leaves = n_leaves;
  adam8bit_kernel<<<n_items, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return cudaGetLastError();
}
