// Fused transformer MLP: y = gelu_tanh(x w1 + b1) w2 + b2 with the hidden
// (R, F) never written to device memory, and its two gradient kernels, which
// recompute the hidden chunk by chunk.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/fused_mlp.py:
//   _fwd_kernel (:31)     -> fused_mlp_fwd: u = x w1 + b1 (fp32 sums),
//     h = gelu_tanh(u) cast to x's dtype, y = h w2 + b2 (b2 fp32) cast to
//     x's dtype;
//   _bwd_dx_kernel (:45)  -> fused_mlp_bwd_dx: dh = dy w2^T, du = dh *
//     gelu_tanh'(u) cast to x's dtype, dx = du w1^T. The TPU kernel adds
//     per-F-tile partials into its output in x's dtype; here all of F sums
//     in fp32 and dx is cast once (the plain version defines this);
//   _bwd_dw_kernel (:72)  -> fused_mlp_bwd_dw: dw1 = x^T du, dw2 = h^T dy
//     with du and h in fp32 (no cast), db1 = sum_r du, db2 = sum_r dy; dw1,
//     dw2 and db1 in the weights' dtype, db2 fp32 (:107-113, :214-215).
// x (R, E), w1 (E, F), b1 (F,), w2 (F, E), dy (R, E) of one dtype, bf16 or
// fp32; b2 (E,) fp32. Shapes taken: E a multiple of 64 up to 768 (bf16) or
// 384 (fp32: shared memory), F a multiple of 32, any R >= 1 (ragged row
// tiles are masked, where the JAX wrapper pads).
//
// Bound on the H100: operations at the training shapes. One product is
// 2 R E F flops (1.160e11 at R = 24576, E = 768, F = 3072: 0.117 ms at 989
// TFLOP/s); the forward does 2, dx 3 and dw 4. At decode rows (R = 8) the
// forward is bytes-bound on its 9.4 MB of weight panels (2.8 us).
//
// Design. The products run on the tensor cores with mma.sync m16n8k16 (bf16
// in, fp32 sums), fragments loaded from shared memory by ldmatrix (with
// .trans where an operand is stored k-major); the fp32 instantiation does the
// same tiles with fp32 FMAs on the CUDA cores (no TF32), so its sums are
// exact to fp32. A 16 x 8 tile with K = E (u, dh) runs four independent
// accumulator chains. 256 threads (8 warps) per block.
// - fwd: a block owns 32 rows and the whole (32, E) fp32 output tile in
//   registers (E / 64 n-tiles per warp, 96 floats at E = 768) and walks its
//   range of F in chunks of 32: u (32 x 32, one 16 x 8 tile per warp, K = E)
//   from the resident x tile and the staged w1[:, chunk]; h in shared
//   memory; y += h w2[chunk, :]. The two weight chunks load by cp.async into
//   their own buffers, each while the other phase computes. Both panels are
//   re-read by every row tile, from L2 (9.4 MB at 125m). Few row tiles
//   (decode, prefill) split F over grid.y into fp32 partials that a second
//   kernel sums in split order, adds b2 and casts.
// - dx: the same tiling with dy resident too: per chunk dh (K = E) and u,
//   du = dh * gelu'(u) in the registers of the tile that holds both, du cast
//   to the dtype in shared memory, dx += du w1[:, chunk]^T (w1 staged
//   row-major is the B operand as stored).
// - dw: a block owns 16 hidden columns and a segment of the rows, which it
//   walks in 16-row tiles of x and dy, double-buffered (the next tile loads
//   by cp.async while this one computes). Per tile: warps 0-3 compute u and
//   warps 4-7 dh, each a 16 x 8 tile over one half of K = E, the halves
//   added in order; du and h in fp32 into shared memory; dw1[:, 16] += x^T du and
//   dw2[16, :] += h^T dy on the tensor cores with du and h split into bf16
//   hi + lo parts (x and dy are exact in bf16), which keeps the fp32
//   operands to about 16 bits. Accumulators in registers (96 floats); each
//   segment writes fp32 partials and a second kernel sums the segments in
//   order and casts: no atomics, so a repeated step gives the same bits.
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBR = 32;        // rows per tile
constexpr int kBF = 32;        // hidden columns per chunk (fwd, dx)
constexpr int kBFW = 16;       // hidden columns per block (dw)
constexpr int kBRW = 16;       // rows per tile (dw), double-buffered
constexpr int kPad = 8;        // elements of padding per shared-memory row
constexpr int kMaxNT = 12;     // 8-wide n-tiles per warp over E: E <= 8 * 8 * 12
constexpr int kMaxE = 8 * 8 * kMaxNT;
constexpr float kSqrt2OverPi = 0.7978845608028654f;

using ds::bf16;

// _gelu_tanh and _gelu_tanh_grad (deepspeed_tpu/ops/pallas/fused_ops.py:165-176),
// the same expressions in the same order, in fp32
__device__ __forceinline__ float gelu_tanh(float u) {
  const float inner = kSqrt2OverPi * (u + 0.044715f * u * u * u);
  return 0.5f * u * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float u3 = 0.044715f * u * u * u;
  const float inner = kSqrt2OverPi * (u + u3);
  const float t = tanhf(inner);
  const float sech2 = 1.f - t * t;
  return 0.5f * (1.f + t) + 0.5f * u * sech2 * kSqrt2OverPi * (1.f + 0.134145f * u * u);
}

// ---------------------------------------------------------------------------
// warp tiles: C (16 x 8, fp32) += A (16 x 16) B (16 x 8)
// ---------------------------------------------------------------------------

// A matrix in shared memory. Canonical storage is row-major by the tile's
// rows with k contiguous (A: [m][k]; B: [n][k]); t: stored [k][m] / [k][n].
template <typename T>
struct Smem {
  const T* p;
  int ld;
  bool t;
};

template <typename T>
struct FragA {
  uint32_t r[4];
};
template <typename T>
struct FragB {
  uint32_t r[2];
};
// fp32: no register fragment; the FMA tile reads shared memory directly
template <>
struct FragA<float> {
  Smem<float> s;
  int m0, k0;
};
template <>
struct FragB<float> {
  Smem<float> s;
  int n0, k0;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A fragment of the 16 x 16 tile at (m0, k0): four 8 x 8 matrices, (m 0-7,
// k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15); lanes 8j..8j+7
// give the row addresses of matrix j.
__device__ __forceinline__ void load_a(FragA<bf16>& f, Smem<bf16> s, int m0, int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  const int mb = (j & 1) * 8, kb = (j >> 1) * 8;
  if (!s.t) {
    const uint32_t a = smem_u32(s.p + (m0 + mb + r) * s.ld + k0 + kb);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(f.r[0]), "=r"(f.r[1]), "=r"(f.r[2]), "=r"(f.r[3]) : "r"(a));
  } else {
    const uint32_t a = smem_u32(s.p + (k0 + kb + r) * s.ld + m0 + mb);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(f.r[0]), "=r"(f.r[1]), "=r"(f.r[2]), "=r"(f.r[3]) : "r"(a));
  }
}

// B fragment of the 16 x 8 tile at (k0, n0): (k 0-7) and (k 8-15) of n 0-7.
__device__ __forceinline__ void load_b(FragB<bf16>& f, Smem<bf16> s, int n0, int k0) {
  const int lane = threadIdx.x & 31, j = (lane >> 3) & 1, r = lane & 7;
  if (!s.t) {
    const uint32_t a = smem_u32(s.p + (n0 + r) * s.ld + k0 + j * 8);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(f.r[0]), "=r"(f.r[1]) : "r"(a));
  } else {
    const uint32_t a = smem_u32(s.p + (k0 + j * 8 + r) * s.ld + n0);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(f.r[0]), "=r"(f.r[1]) : "r"(a));
  }
}

__device__ __forceinline__ void load_a(FragA<float>& f, Smem<float> s, int m0, int k0) {
  f.s = s;
  f.m0 = m0;
  f.k0 = k0;
}

__device__ __forceinline__ void load_b(FragB<float>& f, Smem<float> s, int n0, int k0) {
  f.s = s;
  f.n0 = n0;
  f.k0 = k0;
}

__device__ __forceinline__ void mma(float (&c)[4], const FragA<bf16>& a, const FragB<bf16>& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
}

// Element e of a lane's C fragment: row g + 8 (e / 2), column 2 q + e % 2
// (g = lane / 4, q = lane % 4), as mma.sync lays it out.
__device__ __forceinline__ int frag_row(int e) { return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int frag_col(int e) { return (threadIdx.x & 3) * 2 + (e & 1); }

__device__ __forceinline__ void mma(float (&c)[4], const FragA<float>& a, const FragB<float>& b) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = a.m0 + frag_row(e), n = b.n0 + frag_col(e);
    float s = c[e];
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float av = a.s.t ? a.s.p[(a.k0 + k) * a.s.ld + m] : a.s.p[m * a.s.ld + a.k0 + k];
      const float bv = b.s.t ? b.s.p[(b.k0 + k) * b.s.ld + n] : b.s.p[n * b.s.ld + b.k0 + k];
      s = fmaf(av, bv, s);
    }
    c[e] = s;
  }
}

// ---------------------------------------------------------------------------
// staging: cp.async, 16 bytes per copy
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;   // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x cols elements (cols * sizeof(T) a multiple of 16) from g (row stride
// gld) into s (row stride sld); rows at or past `valid` are zero-filled.
template <typename T>
__device__ __forceinline__ void stage(T* s, int sld, const T* g, size_t gld, int rows, int cols,
                                      int valid) {
  constexpr int V = 16 / sizeof(T);
  const int per = cols / V;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * V;
    const bool ok = r < valid;
    cp_async16(s + r * sld + c, ok ? g + r * gld + c : g, ok);
  }
}

// ---------------------------------------------------------------------------
// fwd and dx: 32-row tiles, the (32, E) output in registers
// ---------------------------------------------------------------------------

// acc[i][j] is the 16 x 8 tile at rows 16 i, columns 8 (warp + 8 j)
template <typename T>
__device__ __forceinline__ void tile_add(float (&acc)[2][kMaxNT][4], Smem<T> a, Smem<T> b,
                                         int nt) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kBF; k += 16) {
    FragA<T> a0, a1;
    load_a(a0, a, 0, k);
    load_a(a1, a, 16, k);
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j < nt) {
        FragB<T> f;
        load_b(f, b, (warp + 8 * j) * 8, k);
        mma(acc[0][j], a0, f);
        mma(acc[1][j], a1, f);
      }
    }
  }
}

// c = the 16 x 8 tile at (m0, n0) of A (rows x K) B (K x cols), K a multiple
// of 16: four independent accumulators over each 64 of K, so that
// consecutive mma.sync need not wait for each other
template <typename T>
__device__ __forceinline__ void tile_k(float (&c)[4], Smem<T> a, Smem<T> b, int m0, int n0,
                                       int K) {
  float p[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
  int k = 0;
  for (; k + 64 <= K; k += 64) {
    FragA<T> fa[4];
    FragB<T> fb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load_a(fa[i], a, m0, k + 16 * i);
      load_b(fb[i], b, n0, k + 16 * i);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mma(p[i], fa[i], fb[i]);
  }
  for (; k < K; k += 16) {
    FragA<T> fa;
    FragB<T> fb;
    load_a(fa, a, m0, k);
    load_b(fb, b, n0, k);
    mma(p[0], fa, fb);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = (p[0][e] + p[1][e]) + (p[2][e] + p[3][e]);
}

// u (one 16 x 8 tile per warp of the 32 x 32 chunk) = A (32 x E) B (E x 32)
template <typename T>
__device__ __forceinline__ void tile_chunk(float (&c)[4], Smem<T> a, Smem<T> b, int E) {
  const int warp = threadIdx.x >> 5;
  tile_k(c, a, b, (warp >> 2) * 16, (warp & 3) * 8, E);
}

// rows 0..valid-1 of the (32, E) accumulator: into part (fp32, split s) or
// cast into out with the fp32 bias added (bias may be null)
template <typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[2][kMaxNT][4], int nt, int valid,
                                           size_t row0, int E, size_t split_stride, float* part,
                                           T* out, const float* bias) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * i + frag_row(e), col = (warp + 8 * j) * 8 + frag_col(e);
        if (r >= valid) continue;
        const size_t o = (row0 + r) * E + col;
        if (part)
          part[blockIdx.y * split_stride + o] = acc[i][j][e];
        else
          out[o] = ds::from_float<T>(bias ? acc[i][j][e] + bias[col] : acc[i][j][e]);
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ y,
           float* __restrict__ part, int R, int E, int F, int chunks_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = E + kPad, ldw = kBF + kPad;
  T* xs = reinterpret_cast<T*>(smem);   // [32][ldx]      the x row tile
  T* w1s = xs + kBR * ldx;              // [E][ldw]       w1[:, chunk]
  T* w2s = w1s + E * ldw;               // [32][ldx]      w2[chunk, :]
  T* hs = w2s + kBF * ldx;              // [32][ldw]      h of the chunk
  const int warp = threadIdx.x >> 5, nt = E / 64;
  const int r0 = blockIdx.x * kBR, valid = min(kBR, R - r0);
  const int c0 = blockIdx.y * chunks_per_split, c1 = min(F / kBF, c0 + chunks_per_split);

  float acc[2][kMaxNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  stage(xs, ldx, x + (size_t)r0 * E, E, kBR, E, valid);
  stage(w1s, ldw, w1 + c0 * kBF, F, E, kBF, E);
  cp_commit();
  stage(w2s, ldx, w2 + (size_t)c0 * kBF * E, E, kBF, E, kBF);
  cp_commit();
  for (int c = c0; c < c1; ++c) {
    cp_wait<1>();   // x and w1[:, c] (w2[c, :] may still be in flight)
    __syncthreads();
    float u[4];
    tile_chunk(u, Smem<T>{xs, ldx, false}, Smem<T>{w1s, ldw, true}, E);
    const int m0 = (warp >> 2) * 16, n0 = (warp & 3) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + frag_row(e), f = n0 + frag_col(e);
      const float v = u[e] + ds::to_float(b1[c * kBF + f]);
      hs[r * ldw + f] = ds::from_float<T>(gelu_tanh(v));
    }
    __syncthreads();   // h written; w1s free
    if (c + 1 < c1) stage(w1s, ldw, w1 + (c + 1) * kBF, F, E, kBF, E);
    cp_commit();
    cp_wait<1>();      // w2[c, :]
    __syncthreads();
    tile_add(acc, Smem<T>{hs, ldw, false}, Smem<T>{w2s, ldx, true}, nt);
    __syncthreads();   // w2s and hs free
    if (c + 1 < c1) stage(w2s, ldx, w2 + (size_t)(c + 1) * kBF * E, E, kBF, E, kBF);
    cp_commit();
  }
  cp_wait<0>();
  store_rows(acc, nt, valid, r0, E, (size_t)R * E, part, y, b2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dx_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
          const T* __restrict__ w2, const T* __restrict__ dy, T* __restrict__ dx,
          float* __restrict__ part, int R, int E, int F, int chunks_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = E + kPad, ldw = kBF + kPad;
  T* xs = reinterpret_cast<T*>(smem);   // [32][ldx]
  T* dys = xs + kBR * ldx;              // [32][ldx]
  T* w1s = dys + kBR * ldx;             // [E][ldw]       w1[:, chunk]
  T* w2s = w1s + E * ldw;               // [32][ldx]      w2[chunk, :]
  T* dus = w2s + kBF * ldx;             // [32][ldw]      du of the chunk, in T
  const int warp = threadIdx.x >> 5, nt = E / 64;
  const int r0 = blockIdx.x * kBR, valid = min(kBR, R - r0);
  const int c0 = blockIdx.y * chunks_per_split, c1 = min(F / kBF, c0 + chunks_per_split);

  float acc[2][kMaxNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  stage(xs, ldx, x + (size_t)r0 * E, E, kBR, E, valid);
  stage(dys, ldx, dy + (size_t)r0 * E, E, kBR, E, valid);
  stage(w2s, ldx, w2 + (size_t)c0 * kBF * E, E, kBF, E, kBF);
  cp_commit();
  stage(w1s, ldw, w1 + c0 * kBF, F, E, kBF, E);
  cp_commit();
  for (int c = c0; c < c1; ++c) {
    cp_wait<1>();   // x, dy and w2[c, :] (w1[:, c] may still be in flight)
    __syncthreads();
    float dh[4], u[4];
    // dh = dy w2[c, :]^T: w2[c, :] as stored is the B operand [n = f][k = e]
    tile_chunk(dh, Smem<T>{dys, ldx, false}, Smem<T>{w2s, ldx, false}, E);
    __syncthreads();   // w2s free
    if (c + 1 < c1) stage(w2s, ldx, w2 + (size_t)(c + 1) * kBF * E, E, kBF, E, kBF);
    cp_commit();
    cp_wait<1>();      // w1[:, c]
    __syncthreads();
    tile_chunk(u, Smem<T>{xs, ldx, false}, Smem<T>{w1s, ldw, true}, E);
    const int m0 = (warp >> 2) * 16, n0 = (warp & 3) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + frag_row(e), f = n0 + frag_col(e);
      const float v = u[e] + ds::to_float(b1[c * kBF + f]);
      dus[r * ldw + f] = ds::from_float<T>(dh[e] * gelu_tanh_grad(v));
    }
    __syncthreads();
    // dx += du w1[:, c]^T: w1[:, c] as stored ([e][f]) is the B operand [n][k]
    tile_add(acc, Smem<T>{dus, ldw, false}, Smem<T>{w1s, ldw, false}, nt);
    __syncthreads();   // w1s and dus free
    if (c + 1 < c1) stage(w1s, ldw, w1 + (c + 1) * kBF, F, E, kBF, E);
    cp_commit();
  }
  cp_wait<0>();
  store_rows<T>(acc, nt, valid, r0, E, (size_t)R * E, part, dx, nullptr);
}

// ---------------------------------------------------------------------------
// dw: 16 hidden columns per block, the rows split into segments
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
          const T* __restrict__ w2, const T* __restrict__ dy, float* __restrict__ part, int R,
          int E, int F, int tiles_per_seg) {
  constexpr bool kSplit = std::is_same<T, bf16>::value;   // hi + lo parts of du and h
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = E + kPad, ldw = kBFW + kPad;
  T* xs = reinterpret_cast<T*>(smem);   // [2][16][ldx]   x row tiles (double-buffered)
  T* dys = xs + 2 * kBRW * ldx;         // [2][16][ldx]   dy row tiles
  T* w1s = dys + 2 * kBRW * ldx;        // [E][ldw]       w1[:, f0:f0+16]
  T* w2s = w1s + E * ldw;               // [16][ldx]      w2[f0:f0+16, :]
  T* du_hi = w2s + kBFW * ldx;          // [16][ldw] each
  T* du_lo = du_hi + kBRW * ldw;
  T* h_hi = du_lo + kBRW * ldw;
  T* h_lo = h_hi + kBRW * ldw;
  float* ps = reinterpret_cast<float*>(h_lo + kBRW * ldw);   // [u, dh][K half][16][16]
  float* dus = ps + 4 * kBRW * kBFW;                         // [16][16] du (fp32)
  const int warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int f0 = blockIdx.x * kBFW, seg = blockIdx.y, ntiles = E / 8;
  const int row_tiles = (R + kBRW - 1) / kBRW;
  const int t0 = seg * tiles_per_seg, t1 = min(row_tiles, t0 + tiles_per_seg);

  float a1[kMaxNT][4], a2[kMaxNT][4];   // dw1 tiles (e, f) and dw2 tiles (f, e)
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a1[i][e] = a2[i][e] = 0.f;
  float db1 = 0.f, db2[kMaxE / kThreads] = {};

  auto stage_tile = [&](int t) {
    const int r0 = t * kBRW, valid = min(kBRW, R - r0), b = t & 1;
    stage(xs + b * kBRW * ldx, ldx, x + (size_t)r0 * E, E, kBRW, E, valid);
    stage(dys + b * kBRW * ldx, ldx, dy + (size_t)r0 * E, E, kBRW, E, valid);
    cp_commit();
  };
  stage(w1s, ldw, w1 + f0, F, E, kBFW, E);
  stage(w2s, ldx, w2 + (size_t)f0 * E, E, kBFW, E, kBFW);
  cp_commit();
  if (t0 < t1) stage_tile(t0);
  for (int t = t0; t < t1; ++t) {
    cp_wait<0>();      // this tile (and, the first time, the weight chunks)
    __syncthreads();
    if (t + 1 < t1) stage_tile(t + 1);   // into the other buffer, while this one computes
    const T* xt = xs + (t & 1) * kBRW * ldx;
    const T* dyt = dys + (t & 1) * kBRW * ldx;
    {  // u = x w1[:, f] (warps 0-3) and dh = dy w2[f, :]^T (warps 4-7): 16 x 8 tiles,
       // each over one half of K = E; the halves are added in order below
      const bool is_u = warp < 4;
      const int n0 = ((warp >> 1) & 1) * 8, kh = warp & 1, half = E / 2;
      const Smem<T> a{(is_u ? xt : dyt) + kh * half, ldx, false};
      const Smem<T> b = is_u ? Smem<T>{w1s + kh * half * ldw, ldw, true}
                             : Smem<T>{w2s + kh * half, ldx, false};
      float c[4];
      tile_k(c, a, b, 0, n0, half);
      float* out = ps + ((is_u ? 0 : 2) + kh) * kBRW * kBFW;
#pragma unroll
      for (int e = 0; e < 4; ++e) out[frag_row(e) * kBFW + n0 + frag_col(e)] = c[e];
    }
    __syncthreads();
    {  // one element per thread: du and h in fp32, then their bf16 hi + lo parts
      const int r = tid / kBFW, f = tid % kBFW, n = kBRW * kBFW;
      const float v = (ps[tid] + ps[n + tid]) + ds::to_float(b1[f0 + f]);
      const float du = (ps[2 * n + tid] + ps[3 * n + tid]) * gelu_tanh_grad(v), h = gelu_tanh(v);
      dus[tid] = du;
      const T du_t = ds::from_float<T>(du), h_t = ds::from_float<T>(h);
      du_hi[r * ldw + f] = du_t;
      h_hi[r * ldw + f] = h_t;
      if constexpr (kSplit) {
        du_lo[r * ldw + f] = ds::from_float<T>(du - ds::to_float(du_t));
        h_lo[r * ldw + f] = ds::from_float<T>(h - ds::to_float(h_t));
      }
    }
    __syncthreads();
    if (tid < kBFW)
      for (int r = 0; r < kBRW; ++r) db1 += dus[r * kBFW + tid];
    if (blockIdx.x == 0)
#pragma unroll
      for (int j = 0; j < kMaxE / kThreads; ++j) {
        const int col = tid + j * kThreads;
        if (col < E)
          for (int r = 0; r < kBRW; ++r) db2[j] += ds::to_float(dyt[r * ldx + col]);
      }
    {  // dw1 (E x 16) += x^T du: tile t = warp + 8 i at rows 16 (t / 2), columns 8 (t % 2);
       // x stored [r][e] and du [r][f] are the k-major A and B operands (K = 16 rows)
      FragB<T> bh, bl;
      load_b(bh, Smem<T>{du_hi, ldw, true}, (warp & 1) * 8, 0);
      if constexpr (kSplit) load_b(bl, Smem<T>{du_lo, ldw, true}, (warp & 1) * 8, 0);
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i) {
        const int tt = warp + 8 * i;
        if (tt < ntiles) {
          FragA<T> fa;
          load_a(fa, Smem<T>{xt, ldx, true}, (tt >> 1) * 16, 0);
          mma(a1[i], fa, bh);
          if constexpr (kSplit) mma(a1[i], fa, bl);
        }
      }
      // dw2 (16 x E) += h^T dy: tile t = warp + 8 i at columns 8 t
      FragA<T> ah, al;
      load_a(ah, Smem<T>{h_hi, ldw, true}, 0, 0);
      if constexpr (kSplit) load_a(al, Smem<T>{h_lo, ldw, true}, 0, 0);
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i) {
        const int tt = warp + 8 * i;
        if (tt < ntiles) {
          FragB<T> fb;
          load_b(fb, Smem<T>{dyt, ldx, true}, tt * 8, 0);
          mma(a2[i], ah, fb);
          if constexpr (kSplit) mma(a2[i], al, fb);
        }
      }
    }
    __syncthreads();   // this tile's buffers, du and h free
  }
  cp_wait<0>();
  // this segment's partials: [dw1 (E, F) | dw2 (F, E) | db1 (F) | db2 (E)]
  float* p = part + (size_t)seg * (2 * (size_t)E * F + F + E);
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) {
    const int tt = warp + 8 * i;
    if (tt >= ntiles) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int er = (tt >> 1) * 16 + frag_row(e), fc = (tt & 1) * 8 + frag_col(e);
      p[(size_t)er * F + f0 + fc] = a1[i][e];
      const int fr = frag_row(e), ec = tt * 8 + frag_col(e);
      p[(size_t)E * F + (size_t)(f0 + fr) * E + ec] = a2[i][e];
    }
  }
  if (tid < kBFW) p[2 * (size_t)E * F + f0 + tid] = db1;
  if (blockIdx.x == 0)
#pragma unroll
    for (int j = 0; j < kMaxE / kThreads; ++j) {
      const int col = tid + j * kThreads;
      if (col < E) p[2 * (size_t)E * F + F + col] = db2[j];
    }
}

// out[i] = cast(sum_s part[s * stride + i] (+ bias[i % bias_n])), s in order
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ part, int nseg, size_t n, size_t stride,
                              const float* __restrict__ bias, int bias_n, T* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nseg; ++k) s += part[k * stride + i];
    if (bias) s += bias[i % bias_n];
    out[i] = ds::from_float<T>(s);
  }
}

template <typename T>
cudaError_t reduce(const float* part, int nseg, size_t n, size_t stride, const float* bias,
                   int bias_n, T* out, cudaStream_t st) {
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 132 * 16);
  reduce_kernel<T><<<blocks, 256, 0, st>>>(part, nseg, n, stride, bias, bias_n, out);
  return cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
size_t fwd_smem(int E) {
  // x and the w2 chunk, the w1 chunk, h
  return sizeof(T) * ((size_t)(kBR + kBF) * (E + kPad) + (size_t)E * (kBF + kPad) +
                      kBR * (kBF + kPad));
}
template <typename T>
size_t dx_smem(int E) {
  // x, dy and the w2 chunk, the w1 chunk, du
  return sizeof(T) * ((size_t)(2 * kBR + kBF) * (E + kPad) + (size_t)E * (kBF + kPad) +
                      kBR * (kBF + kPad));
}
template <typename T>
size_t dw_smem(int E) {
  // two x and two dy row tiles, the w1 and w2 chunks, du and h (hi, lo); fp32
  // u and dh halves and du
  return sizeof(T) * ((size_t)4 * kBRW * (E + kPad) + (size_t)E * (kBFW + kPad) +
                      (size_t)kBFW * (E + kPad) + 4 * kBRW * (kBFW + kPad)) +
         sizeof(float) * 5 * kBRW * kBFW;
}

template <typename T>
cudaError_t fwd(const void* x, const void* w1, const void* b1, const void* w2, const float* b2,
                void* y, float* part, int R, int E, int F, int nsplit, int cps, cudaStream_t st) {
  const size_t smem = fwd_smem<T>(E);
  cudaError_t err = set_smem(fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kBR - 1) / kBR, nsplit);
  fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), b2, static_cast<T*>(y), nsplit > 1 ? part : nullptr, R, E, F,
      cps);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return reduce<T>(part, nsplit, (size_t)R * E, (size_t)R * E, b2, E, static_cast<T*>(y), st);
}

template <typename T>
cudaError_t bwd_dx(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                   void* dx, float* part, int R, int E, int F, int nsplit, int cps,
                   cudaStream_t st) {
  const size_t smem = dx_smem<T>(E);
  cudaError_t err = set_smem(dx_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kBR - 1) / kBR, nsplit);
  dx_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(dy), static_cast<T*>(dx),
      nsplit > 1 ? part : nullptr, R, E, F, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return reduce<T>(part, nsplit, (size_t)R * E, (size_t)R * E, nullptr, 1, static_cast<T*>(dx),
                   st);
}

template <typename T>
cudaError_t bwd_dw(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                   void* out, float* db2, float* part, int R, int E, int F, int nseg, int tps,
                   cudaStream_t st) {
  const size_t smem = dw_smem<T>(E);
  cudaError_t err = set_smem(dw_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kBFW, nseg);
  dw_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(dy), part, R, E, F, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t stride = 2 * (size_t)E * F + F + E, n_w = 2 * (size_t)E * F + F;
  err = reduce<T>(part, nseg, n_w, stride, nullptr, 1, static_cast<T*>(out), st);
  if (err != cudaSuccess) return err;
  return reduce<float>(part + n_w, nseg, (size_t)E, stride, nullptr, 1, db2, st);
}

bool shape_ok(int R, int E, int F, int dtype) {
  const int max_e = dtype == ds::kBFloat16 ? kMaxE : kMaxE / 2;
  return R > 0 && E > 0 && E % 64 == 0 && E <= max_e && F > 0 && F % kBF == 0;
}

}  // namespace

DS_DEFINE_ERROR_STRING

// x (R, E), w1 (E, F), b1 (F,), w2 (F, E) of one dtype; b2 (E,) fp32; y (R, E);
// part (nsplit, R, E) fp32 scratch when nsplit > 1, each split taking
// chunks_per_split chunks of 32 hidden columns. Returns the cudaGetLastError()
// of the launches.
DS_EXPORT int fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* y, void* part, int R, int E, int F, int nsplit,
                            int chunks_per_split, int dtype, void* stream) {
  if (!shape_ok(R, E, F, dtype) || nsplit < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b2f = static_cast<const float*>(b2);
  float* pf = static_cast<float*>(part);
  if (dtype == ds::kBFloat16)
    return fwd<bf16>(x, w1, b1, w2, b2f, y, pf, R, E, F, nsplit, chunks_per_split, st);
  if (dtype == ds::kFloat32)
    return fwd<float>(x, w1, b1, w2, b2f, y, pf, R, E, F, nsplit, chunks_per_split, st);
  return cudaErrorInvalidValue;
}

// dy (R, E) and dx (R, E) in x's dtype; part as for fused_mlp_fwd.
DS_EXPORT int fused_mlp_bwd_dx(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* dy, void* dx, void* part, int R, int E, int F,
                               int nsplit, int chunks_per_split, int dtype, void* stream) {
  if (!shape_ok(R, E, F, dtype) || nsplit < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (dtype == ds::kBFloat16)
    return bwd_dx<bf16>(x, w1, b1, w2, dy, dx, pf, R, E, F, nsplit, chunks_per_split, st);
  if (dtype == ds::kFloat32)
    return bwd_dx<float>(x, w1, b1, w2, dy, dx, pf, R, E, F, nsplit, chunks_per_split, st);
  return cudaErrorInvalidValue;
}

// out: [dw1 (E, F) | dw2 (F, E) | db1 (F,)] in the dtype; db2 (E,) fp32;
// part (nseg, 2 E F + F + E) fp32 scratch, segment s taking row tiles
// [s * tiles_per_seg, (s + 1) * tiles_per_seg) of 16 rows.
DS_EXPORT int fused_mlp_bwd_dw(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* dy, void* out, void* db2, void* part, int R, int E,
                               int F, int nseg, int tiles_per_seg, int dtype, void* stream) {
  if (!shape_ok(R, E, F, dtype) || nseg < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *pf = static_cast<float*>(part), *d2 = static_cast<float*>(db2);
  if (dtype == ds::kBFloat16)
    return bwd_dw<bf16>(x, w1, b1, w2, dy, out, d2, pf, R, E, F, nseg, tiles_per_seg, st);
  if (dtype == ds::kFloat32)
    return bwd_dw<float>(x, w1, b1, w2, dy, out, d2, pf, R, E, F, nseg, tiles_per_seg, st);
  return cudaErrorInvalidValue;
}
