// Fused transformer MLP: y = gelu_tanh(x w1 + b1) w2 + b2, and its two
// gradient kernels, which recompute the hidden (R, F): it is never saved for
// the backward.
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
// TFLOP/s); the forward does 2, dx 3 and dw 4 (6 with the lo halves of the
// bf16 dw's du and h: a floor of 0.70 ms there). At decode rows (R = 8) the
// forward is bytes-bound on its 9.4 MB of weight panels (2.8 us).
//
// The bf16 forward from ops/fused_mlp.SM90_MIN_ROWS rows, and the bf16 dx at
// any row count: two tensor-core GEMMs each on gemm_sm90.cuh's mainloop
// (wgmma + TMA; 128-row CTAs of two consumer warpgroups and a producer warp),
// through a bf16 scratch of the hidden at the TPU kernels' cast point (h
// before the second forward product, du before dx's), a chunk of rows at a
// time (ops/fused_mlp.py, mlp_plan: at most 256 MiB, one chunk at R = 24576).
// A Hopper CTA cannot keep the whole (rows, F) hidden on chip as the TPU
// kernel keeps it in VMEM: y's accumulator over all of E for 64 rows is 384
// fp32 registers a thread, and splitting E recomputes u or exchanges h
// between CTAs. The scratch holds exactly what the second product reads (the
// cast happens there anyway), and its write and read cost 302 MB of traffic
// at R = 24576, part of it in L2.
// - h_sm90_kernel: u = x w1 over K = E (w1 MN-major through the transpose
//   bit), the CTA walking f_tps tiles of 256 columns of F as 128 x 128
//   tiles that its two consumer warpgroups take in turns (ping-pong: one
//   warpgroup's epilogue runs under the other's products): + b1 (fp32),
//   gelu_tanh, bf16, staged in swizzled shared memory and stored by TMA.
// - y_sm90_kernel: y = h w2 + b2 over K = F, 128 x 192 tiles (kETile; n128
//   + n64), w2 MN-major; F split into fp32 partials where few row tiles
//   leave the card idle (decode, prefill), summed in split order by
//   reduce_kernel: no atomics, a repeated call gives the same bits.
// - du_sm90_kernel: u = x w1 and dh = dy w2^T (w2 K-major) over K = E into
//   two accumulators of one 128 x 128 tile (64 + 64 registers a thread);
//   du = dh gelu_tanh'(u + b1), bf16, stored by TMA.
// - dx_sm90_kernel: dx = du w1^T over K = F (w1 K-major), all of F summed
//   in fp32 (or split as y), cast once.
// The CTAs of one row tile (and its F segments or E tiles) are consecutive,
// so the CTAs in flight share a few row tiles of x and dy in L2. Measured on
// an H100 (PERF.md, row 11): y and dx run at 59% of the tensor cores' rate;
// du loses a sixth more to its GELU-derivative epilogue, which the tensor
// cores wait out (h's ping-pong hides its own). Neither L2 (two-CTA
// clusters sharing B by TMA multicast read a third less from it and ran no
// faster) nor the ring's depth (a fifth stage) is the limit.
//
// fwd and dx in fp32, and the bf16 fwd below SM90_MIN_ROWS rows (the decode
// ticks'). The products run on the tensor cores with mma.sync m16n8k16 (bf16
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
//
// dw, bf16: dw_sm90_kernel. Both accumulators over all of E for 64 hidden
// columns (2 x 64 x 768 fp32 = 393 KB) exceed the register file, so a
// thread-block cluster of n = ceil(E / BE) CTAs shares one hidden tile of
// 64 columns, each CTA owning one E-chunk of BE = 64, 128 or 192 columns
// (the host's plan: ops/fused_mlp.dw_plan; 192, n = 4, at E = 768). Two
// warpgroups; per 64-row tile:
// - TMA brings the CTA's chunk of the x and dy rows into a two-stage
//   mbarrier ring (128-byte swizzle, rows past R and columns past E read as
//   zeros); the weight slices w1[chunk, tile]^T and w2[tile, chunk] sit in
//   registers as the A operands of the partial products;
// - wgmma: partial u^T = w1^T x^T (warpgroup 0) and dh^T = w2 dy^T
//   (warpgroup 1) over the chunk;
// - the exchange, with no cluster-wide barrier: each CTA stages its partial
//   and sends every CTA its rows (rank q owns rows [64 q / n, 64 (q + 1) /
//   n)) by bulk copies through distributed shared memory that complete on
//   the owner's mbarrier; the owner sums the n partials of its rows in rank
//   order (bits independent of timing), adds b1, forms du = dh gelu'(u) and
//   h = gelu(u) in fp32, writes them as bf16 hi + lo pairs (hi = bf16(v), lo
//   = bf16(v - hi); x and dy are exact in bf16, so the products keep du and
//   h to about 16 bits) and copies its rows into every CTA;
// - wgmma: dw1[chunk, tile] += x^T (du_hi + du_lo) (warpgroup 0) and
//   dw2[tile, chunk] += (h_hi + h_lo)^T dy (warpgroup 1), accumulated in
//   registers (3 x 32 fp32 a thread at BE = 192).
// The loop keeps two tiles in flight (double-buffered du/h and receive
// buffers): the next tile's partial products and exchange overlap this
// tile's. x and dy are read from L2 ceil(F / 64) times (48 at F = 3072,
// against 192 for a CTA of 16 hidden columns over all of E); u and dh are
// computed once (no recompute over E). The clusters of the first hidden
// tile also sum db2 from their dy chunks. The rows split into segments,
// their count by the waves of clusters the card holds at once; each segment
// writes fp32 partials, summed in segment order by reduce_kernel: no
// atomics, so a repeated call gives the same bits. db1: each thread's
// column sums, then the threads in order, then the cluster's CTAs in rank
// order.
// dw, fp32: dw_kernel, CUDA cores: a block owns 16 hidden columns and a
// segment of the rows, which it walks in 16-row tiles of x and dy,
// double-buffered (the next tile loads by cp.async while this one
// computes). Per tile: warps 0-3 compute u and warps 4-7 dh, each a 16 x 8
// tile over one half of K = E, the halves added in order; du and h in fp32
// into shared memory; dw1[:, 16] += x^T du and dw2[16, :] += h^T dy.
// Accumulators in registers (96 floats); segments as above.
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>

#include "common.cuh"
#include "flash_sm90.cuh"
#include "gemm_sm90.cuh"

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
// dw, fp32: 16 hidden columns per block, the rows split into segments
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
dw_kernel(const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
          const float* __restrict__ w2, const float* __restrict__ dy, float* __restrict__ part,
          int R, int E, int F, int tiles_per_seg) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = E + kPad, ldw = kBFW + kPad;
  T* xs = reinterpret_cast<T*>(smem);   // [2][16][ldx]   x row tiles (double-buffered)
  T* dys = xs + 2 * kBRW * ldx;         // [2][16][ldx]   dy row tiles
  T* w1s = dys + 2 * kBRW * ldx;        // [E][ldw]       w1[:, f0:f0+16]
  T* w2s = w1s + E * ldw;               // [16][ldx]      w2[f0:f0+16, :]
  T* dut = w2s + kBFW * ldx;            // [16][ldw] du, then h
  T* ht = dut + kBRW * ldw;
  float* ps = reinterpret_cast<float*>(ht + kBRW * ldw);   // [u, dh][K half][16][16]
  float* dus = ps + 4 * kBRW * kBFW;                       // [16][16] du
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
    {  // one element per thread: du and h in fp32
      const int r = tid / kBFW, f = tid % kBFW, n = kBRW * kBFW;
      const float v = (ps[tid] + ps[n + tid]) + b1[f0 + f];
      const float du = (ps[2 * n + tid] + ps[3 * n + tid]) * gelu_tanh_grad(v);
      dus[tid] = du;
      dut[r * ldw + f] = du;
      ht[r * ldw + f] = gelu_tanh(v);
    }
    __syncthreads();
    if (tid < kBFW)
      for (int r = 0; r < kBRW; ++r) db1 += dus[r * kBFW + tid];
    if (blockIdx.x == 0)
#pragma unroll
      for (int j = 0; j < kMaxE / kThreads; ++j) {
        const int col = tid + j * kThreads;
        if (col < E)
          for (int r = 0; r < kBRW; ++r) db2[j] += dyt[r * ldx + col];
      }
    {  // dw1 (E x 16) += x^T du: tile t = warp + 8 i at rows 16 (t / 2), columns 8 (t % 2);
       // x stored [r][e] and du [r][f] are the k-major A and B operands (K = 16 rows)
      FragB<T> bh;
      load_b(bh, Smem<T>{dut, ldw, true}, (warp & 1) * 8, 0);
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i) {
        const int tt = warp + 8 * i;
        if (tt < ntiles) {
          FragA<T> fa;
          load_a(fa, Smem<T>{xt, ldx, true}, (tt >> 1) * 16, 0);
          mma(a1[i], fa, bh);
        }
      }
      // dw2 (16 x E) += h^T dy: tile t = warp + 8 i at columns 8 t
      FragA<T> ah;
      load_a(ah, Smem<T>{ht, ldw, true}, 0, 0);
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i) {
        const int tt = warp + 8 * i;
        if (tt < ntiles) {
          FragB<T> fb;
          load_b(fb, Smem<T>{dyt, ldx, true}, tt * 8, 0);
          mma(a2[i], ah, fb);
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

// ---------------------------------------------------------------------------
// dw, bf16: dw_sm90_kernel (wgmma, TMA, a thread-block cluster over E)
// ---------------------------------------------------------------------------

namespace s9 = ds::sm90;

constexpr int kDwRows = 64;       // rows per tile
constexpr int kDwHidden = 64;     // hidden columns per cluster
constexpr int kDwThreads = 256;   // two warpgroups
constexpr int kDwStages = 2;      // the x / dy ring
constexpr int kDwMaxCluster = 8;  // the portable cluster size
constexpr int kBlock = 64 * 64;   // elements of one swizzled [64][64] bf16 block
constexpr int kDwMaxSmem = 232448;   // a block's shared memory on the H100

// Shared memory of one CTA, byte offsets from the 1024-aligned base; every
// bf16 block starts on a 1024-byte boundary (the swizzle's phase). The
// receive buffers' size follows the cluster's size n.
template <int NB>
struct DwSm90 {
  static constexpr int BE = 64 * NB;                    // the E-chunk a CTA owns
  static constexpr int TILE = NB * kBlock * 2;          // a 64-row tile of x or dy over the chunk
  static constexpr int STAGE = 2 * TILE;                // x, then dy: NB blocks [64 r][64 e] each
  // two buffers of du hi, du lo, h hi, h lo ([64 r][64 f] bf16 each). A
  // buffer first holds the partials this CTA sends for its tile (part k of
  // row r in the bytes of row r of tile k, so an owner's rows of du and h
  // land only on bytes already delivered to it); at the start, the weight
  // slices as TMA lands them
  static constexpr int HL = kDwStages * STAGE;
  static constexpr int HL_BYTES = 4 * kBlock * 2;
  static constexpr int RCV = HL + 2 * HL_BYTES;         // two receive buffers
  // a receive buffer: the cluster's partials of this CTA's rows,
  // [source rank][part][row][32] fp32, parts 0-1 u's columns 0-31 and
  // 32-63, parts 2-3 dh's
  __host__ __device__ static constexpr int rcv_bytes(int n) {
    return n * 4 * ((kDwRows + n - 1) / n) * 128;
  }
  __host__ __device__ static constexpr int bars(int n) { return RCV + 2 * rcv_bytes(n); }
  // full[2], the weights, pfull[2], hfull[2]
  __host__ __device__ static constexpr int smem(int n) { return 1024 + bars(n) + 7 * 8; }
};

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}
// Every thread of every CTA of the cluster: writes before it (shared memory
// of any CTA of the cluster) are visible to reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}
// The address in CTA `rank`'s shared memory of the local shared address `a`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}
// `bytes` (a multiple of 16) of this CTA's shared memory at `src` to the
// cluster shared address `dst`, completing that many bytes of transactions
// on the mbarrier `bar` (of dst's CTA): one copy by the bulk-copy engine, no
// round trip, no cluster-wide barrier
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src, int bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Waits for the phase of parity `parity` of a local mbarrier whose
// transactions other CTAs of the cluster complete.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// Launches: grid (n x ceil(F / 64), segments), clusters of n = ceil(E / BE)
// CTAs along x; CTA rank c of cluster k owns hidden columns [64 k, 64 k +
// 64) and E-chunk [c BE, c BE + BE); blockIdx.y is the row segment.
//
// The tile loop runs two tiles at once. Iteration i: (B) tile i's partials
// have landed: sum them, form du and h, send this CTA's rows of them;
// (A) tile i + 1's partial products, into the other buffer, sent to their
// owners; (D) tile i's du and h have landed: dw1 and dw2 products. Tile
// i + 1's exchange overlaps tile i's products, tile i's the next tile's.
template <int NB>
__global__ void __launch_bounds__(kDwThreads, 1)
dw_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
               const __grid_constant__ CUtensorMap tm_w1,
               const __grid_constant__ CUtensorMap tm_w2, const bf16* __restrict__ b1,
               float* __restrict__ part, int R, int E, int F, int tiles_per_seg) {
  using L = DwSm90<NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = s9::align1024(smem_raw);
  const int n = cluster_size(), c = cluster_rank();
  const int rcv_bytes = L::rcv_bytes(n);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bars(n));
  uint64_t* wbar = full + kDwStages;
  uint64_t* pfull = wbar + 1;   // [2] this CTA's rows of every CTA's partials have landed
  uint64_t* hfull = pfull + 2;  // [2] the other owners' rows of du and h have landed

  const int f0 = (blockIdx.x / n) * kDwHidden, e0 = c * L::BE;
  const int row_tiles = (R + kDwRows - 1) / kDwRows;
  const int t0 = blockIdx.y * tiles_per_seg, t1 = min(row_tiles, t0 + tiles_per_seg);
  const int T = max(t1 - t0, 0);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const bool db2_cta = f0 == 0;   // the first hidden tile's clusters also sum dy

  auto stage_x = [&](int i) { return reinterpret_cast<bf16*>(sm + (i % kDwStages) * L::STAGE); };
  auto hl = [&](int b) { return reinterpret_cast<bf16*>(sm + L::HL + b * L::HL_BYTES); };
  auto rcv = [&](int b) { return sm + L::RCV + b * rcv_bytes; };

  // 64-column blocks of the chunk that lie inside E (the last chunk may end
  // early); the others are zeros, written once, never loaded
  const int live = min(NB, (E - e0) / 64);
  auto load_tile = [&](int i) {   // local tile i into stage i % 2
    bf16* xs = stage_x(i);
    bf16* dys = xs + NB * kBlock;
    uint64_t* bar = &full[i % kDwStages];
    s9::mbar_expect_tx(bar, 2 * live * kBlock * 2);
    for (int b = 0; b < live; ++b) {
      s9::tma_load_2d(xs + b * kBlock, &tm_x, bar, e0 + 64 * b, (t0 + i) * kDwRows);
      s9::tma_load_2d(dys + b * kBlock, &tm_dy, bar, e0 + 64 * b, (t0 + i) * kDwRows);
    }
  };
  if (live < NB) {
    const int per = (NB - live) * kBlock / 8;   // uint4s of one operand's dead blocks
    for (int i = tid; i < per; i += kDwThreads)
#pragma unroll
      for (int k = 0; k < 2 * kDwStages; ++k)   // x and dy of each stage
        reinterpret_cast<uint4*>(sm + k * L::TILE + live * kBlock * 2)[i] = make_uint4(0, 0, 0, 0);
    s9::fence_proxy_async();
  }
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) s9::mbar_init(&full[s], 1);
    s9::mbar_init(wbar, 1);
    for (int b = 0; b < 2; ++b) {
      s9::mbar_init(&pfull[b], 1);
      s9::mbar_init(&hfull[b], 1);
    }
    s9::mbar_fence_init();
  }
  // the cluster's mbarriers are initialised before any CTA completes
  // transactions on another's
  cluster_sync();
  if (tid == 0) {   // the weight slices, then the first tiles
    s9::mbar_expect_tx(wbar, 2 * live * kBlock * 2);
    for (int b = 0; b < live; ++b) {
      s9::tma_load_2d(hl(0) + b * kBlock, &tm_w1, wbar, f0, e0 + 64 * b);
      s9::tma_load_2d(hl(0) + (NB + b) * kBlock, &tm_w2, wbar, e0 + 64 * b, f0);
    }
    for (int i = 0; i < kDwStages && i < T; ++i) load_tile(i);
  }

  // wg 0: dw1 rows e0 + 64 j + m, columns f0 + n; wg 1: dw2 rows f0 + m,
  // columns e0 + 64 j + n (m, n the accumulator fragment's row and column)
  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float db1v[4] = {0.f, 0.f, 0.f, 0.f}, db2v = 0.f;
  // the rows whose u and dh this CTA sums and activates, and its four hidden
  // columns; rank q owns rows [64 q / n, 64 (q + 1) / n)
  const int ra = kDwRows * c / n, rb = kDwRows * (c + 1) / n, fq = 4 * (tid % 16);
  const int rows_max = (kDwRows + n - 1) / n;
  float b1v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) b1v[e] = f0 + fq + e < F ? ds::to_float(b1[f0 + fq + e]) : 0.f;
  const int g = lane / 4, tq = lane % 4, m0 = 16 * (warp % 4);
  const int fr = m0 + g, fc = 2 * tq;   // the P3/P4 accumulator's rows and columns
  const uint32_t pfull_a = smem_u32(pfull), hfull_a = smem_u32(hfull);
  // a partial's row r, part k, float p (of 32) as sent: the row's 16-byte
  // chunks XOR-swizzled by r
  auto part_off = [](int k, int r, int p) {
    return k * kBlock * 2 + r * 128 + ((((p >> 2) ^ r) & 7) << 4) + (p & 3) * 4;
  };

  // the A operand of the partial products in registers, for every tile:
  // wg 0 w1[chunk, tile]^T (f x e; TMA lands w1 as [e][f]), wg 1
  // w2[tile, chunk] (f x e as it lands), 16 k16 columns a step
  s9::mbar_wait(wbar, 0);
  uint32_t wa[4 * NB][4];
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const int j = lane >> 3, r8 = lane & 7;
    if (kk / 4 >= live) {
      wa[kk][0] = wa[kk][1] = wa[kk][2] = wa[kk][3] = 0u;
    } else if (wg == 0) {
      const int k = kk * 16 + (j >> 1) * 8 + r8;
      ldsm_x4_trans(wa[kk], smem_u32(hl(0) + (k / 64) * kBlock +
                                     s9::sw128_offset(k % 64, m0 + (j & 1) * 8)));
    } else {
      const int k = kk * 16 + (j >> 1) * 8;
      ldsm_x4(wa[kk], smem_u32(hl(0) + (NB + k / 64) * kBlock +
                               s9::sw128_offset(m0 + (j & 1) * 8 + r8, k % 64)));
    }
  }
  __syncthreads();   // the weight slices are read: the buffers are free

  float pa[32];
  // A: the partial u^T = w1^T x^T (wg 0) or dh^T = w2 dy^T (wg 1) of local
  // tile i over the chunk (fragment rows f, columns r), db2 meanwhile;
  // then into buffer i % 2 as sent, and to each owner its rows: four bulk
  // copies into the slot of this rank
  auto partials = [&](int i) {
    const bf16* xs = stage_x(i);
    const bf16* dys = xs + NB * kBlock;
    const bf16* bop = wg == 0 ? xs : dys;
    s9::mbar_wait(&full[i % kDwStages], (i / kDwStages) & 1);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      s9::wgmma_rs<64, 0>(pa, wa[kk], s9::kmajor_desc(bop + (kk / 4) * kBlock + (kk % 4) * 16),
                          kk > 0);
    s9::wgmma_commit();
    if (db2_cta && tid < L::BE) {   // db2 over the chunk, while the products run
      const bf16* col = dys + (tid / 64) * kBlock;
      float part4[4] = {0.f, 0.f, 0.f, 0.f};   // rows r = 4 i + k into part4[k], then in order
#pragma unroll 4
      for (int r = 0; r < kDwRows; ++r)
        part4[r % 4] += ds::to_float(col[s9::sw128_offset(r, tid % 64)]);
      db2v += (part4[0] + part4[1]) + (part4[2] + part4[3]);
    }
    s9::wgmma_wait_all();
    s9::fence_regs(pa);
    uint8_t* snd = reinterpret_cast<uint8_t*>(hl(i & 1));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = fr + 8 * (e >> 1), r = 8 * j + fc + (e & 1);
        *reinterpret_cast<float*>(snd + part_off(2 * wg + f / 32, r, f % 32)) = pa[4 * j + e];
      }
    s9::fence_proxy_async();
    __syncthreads();
    if (tid < 4 * n) {   // one copy a thread of warp 0: (owner q, part k)
      const int b = i & 1, q = tid / 4, k = tid % 4;
      if (tid == 0) s9::mbar_expect_tx(&pfull[b], n * (rb - ra) * 4 * 128);
      const int qa = kDwRows * q / n, qrows = kDwRows * (q + 1) / n - qa;
      bulk_copy_cluster(cluster_addr(smem_u32(rcv(b)) + ((c * 4 + k) * rows_max) * 128, q),
                        smem_u32(snd) + k * kBlock * 2 + qa * 128, qrows * 128,
                        cluster_addr(pfull_a + 8 * b, q));
      s9::bulk_commit();
    }
  };

  if (T > 0) partials(0);
  for (int i = 0; i < T; ++i) {
    const int b = i & 1;
    bf16* hlb = hl(b);
    // B: rows [ra, rb) of tile i: u and dh summed over the cluster in rank
    // order, du and h in fp32, written as bf16 hi + lo over the partial rows
    // this CTA sent itself, then copied into every other CTA's buffer
    mbar_wait_cluster(&pfull[b], (i >> 1) & 1);
    const uint8_t* rv = rcv(b);
    for (int it = tid; it < (rb - ra) * 16; it += kDwThreads) {
      const int rl = it / 16, r = ra + rl;
      // the n partials of u and of dh, each summed in rank order
      const uint8_t* src = rv + rl * 128 + ((((fq % 32) >> 2) ^ r) & 7) * 16;
      const int ku = fq / 32, stride = 4 * rows_max * 128;
      float4 u = *reinterpret_cast<const float4*>(src + ku * rows_max * 128);
      float4 d = *reinterpret_cast<const float4*>(src + (2 + ku) * rows_max * 128);
      for (int q = 1; q < n; ++q) {
        const float4 uq = *reinterpret_cast<const float4*>(src + q * stride + ku * rows_max * 128);
        const float4 dq =
            *reinterpret_cast<const float4*>(src + q * stride + (2 + ku) * rows_max * 128);
        u.x += uq.x;
        u.y += uq.y;
        u.z += uq.z;
        u.w += uq.w;
        d.x += dq.x;
        d.y += dq.y;
        d.z += dq.z;
        d.w += dq.w;
      }
      const float uv[4] = {u.x + b1v[0], u.y + b1v[1], u.z + b1v[2], u.w + b1v[3]};
      const float dv[4] = {d.x, d.y, d.z, d.w};
      float du[4], h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        du[e] = dv[e] * gelu_tanh_grad(uv[e]);
        h[e] = gelu_tanh(uv[e]);
        db1v[e] += du[e];
      }
      uint32_t w[4][2];   // du hi, du lo, h hi, h lo: two bf16 pairs each
      s9::split_hi_lo(du[0], du[1], w[0][0], w[1][0]);
      s9::split_hi_lo(du[2], du[3], w[0][1], w[1][1]);
      s9::split_hi_lo(h[0], h[1], w[2][0], w[3][0]);
      s9::split_hi_lo(h[2], h[3], w[2][1], w[3][1]);
      const int o = s9::sw128_offset(r, fq);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        *reinterpret_cast<uint2*>(hlb + k * kBlock + o) = make_uint2(w[k][0], w[k][1]);
    }
    s9::fence_proxy_async();
    __syncthreads();
    if (tid < 4 * n) {   // one copy a thread of warp 0: (CTA q, tile k)
      const int q = tid / 4, k = tid % 4;
      if (tid == 0) s9::mbar_expect_tx(&hfull[b], (kDwRows - (rb - ra)) * 4 * 128);
      if (q != c) {
        const uint32_t off = smem_u32(hlb) + k * kBlock * 2 + ra * 128;
        bulk_copy_cluster(cluster_addr(off, q), off, (rb - ra) * 128,
                          cluster_addr(hfull_a + 8 * b, q));
      }
      s9::bulk_commit();
    }

    // A: the next tile's partials, while tile i's du and h travel
    if (i + 1 < T) partials(i + 1);

    // D: dw1 += x^T (du_hi + du_lo) (wg 0), dw2 += (h_hi + h_lo)^T dy (wg 1),
    // 16 rows a step; x, dy, du and h all MN-major
    mbar_wait_cluster(&hfull[b], (i >> 1) & 1);
    const bf16* xs = stage_x(i);
    const bf16* dys = xs + NB * kBlock;
#pragma unroll
    for (int j = 0; j < NB; ++j) s9::fence_regs(acc[j]);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // wg 0: x_j^T du_hi, x_j^T du_lo; wg 1: h_hi^T dy_j, h_lo^T dy_j
        const bf16* op = (wg == 0 ? xs : dys) + j * kBlock;
        const bf16* hi = hlb + (wg == 0 ? 0 : 2 * kBlock);
        const bf16* a_hi = wg == 0 ? op : hi;
        const bf16* a_lo = wg == 0 ? op : hi + kBlock;
        const bf16* b_hi = wg == 0 ? hi : op;
        const bf16* b_lo = wg == 0 ? hi + kBlock : op;
        const int o = kk * 16 * 64;
        s9::wgmma_ss<64, 1, 1>(acc[j], s9::mnmajor_desc(a_hi + o, 64 * 128),
                               s9::mnmajor_desc(b_hi + o, 64 * 128), 1);
        s9::wgmma_ss<64, 1, 1>(acc[j], s9::mnmajor_desc(a_lo + o, 64 * 128),
                               s9::mnmajor_desc(b_lo + o, 64 * 128), 1);
      }
    }
    s9::wgmma_commit();
    s9::wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) s9::fence_regs(acc[j]);
    // stage i % 2 and buffer b are free once this CTA's copies out of them
    // have been read
    if (tid < 4 * n) s9::bulk_wait_read();
    __syncthreads();
    if (tid == 0 && i + kDwStages < T) load_tile(i + kDwStages);
  }

  // this segment's partials: [dw1 (E, F) | dw2 (F, E) | db1 (F) | db2 (E)];
  // columns past F and E-chunk columns past E are left out
  float* pp = part + (size_t)blockIdx.y * (2 * (size_t)E * F + F + E);
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = fr + 8 * hf, nn = 8 * jj + fc;
        const float2 v = make_float2(acc[j][4 * jj + 2 * hf], acc[j][4 * jj + 2 * hf + 1]);
        if (wg == 0) {
          const int e = e0 + 64 * j + m, f = f0 + nn;
          if (e < E && f < F) *reinterpret_cast<float2*>(pp + (size_t)e * F + f) = v;
        } else {
          const int f = f0 + m, e = e0 + 64 * j + nn;
          if (f < F && e < E)
            *reinterpret_cast<float2*>(pp + (size_t)E * F + (size_t)f * E + e) = v;
        }
      }
  if (db2_cta && tid < L::BE && e0 + tid < E) pp[2 * (size_t)E * F + F + e0 + tid] = db2v;
  // db1: the threads of each column in thread order, then the CTAs in rank
  // order (in the first receive buffer: every copy into it has landed)
  float* db1_thr = reinterpret_cast<float*>(rcv(0));
  float* db1_cta = db1_thr + kDwThreads * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) db1_thr[tid * 4 + e] = db1v[e];
  __syncthreads();
  if (tid < 64) {
    float v = 0.f;
    for (int k = 0; k < kDwThreads / 16; ++k) v += db1_thr[(tid / 4 + 16 * k) * 4 + tid % 4];
    db1_cta[tid] = v;
  }
  cluster_sync();
  if (c == 0 && tid < 64) {
    float v = 0.f;
    for (int q = 0; q < n; ++q) v += ld_cluster(cluster_addr(smem_u32(db1_cta + tid), q));
    if (f0 + tid < F) pp[2 * (size_t)E * F + f0 + tid] = v;
  }
  cluster_sync();   // no CTA leaves while rank 0 reads its shared memory
}

// ---------------------------------------------------------------------------
// fwd and dx, bf16: two tensor-core GEMMs each (gemm_sm90.cuh) through a
// bf16 scratch at the TPU kernels' cast point
// ---------------------------------------------------------------------------

namespace g9 = ds::gemm90;

constexpr int kHTile = 256;    // hidden columns of the plan's F tiles (f_tps counts these)
constexpr int kHPpTile = 128;  // ... of an h_sm90_kernel tile (one warpgroup's, ping-pong)
constexpr int kDuTile = 128;   // ... of a du_sm90_kernel tile (two accumulators a thread)
constexpr int kETile = 192;    // output columns of a y_sm90_kernel / dx_sm90_kernel tile

// h: x w1 (w1 (E, F) MN-major), ping-pong 128 x 128 tiles a warpgroup, 5
// stages of 32 KB and a 32 KB store tile a warpgroup; du: x w1 and dy w2^T
// (w2 (F, E) K-major), 3 stages of 64 KB and a 32 KB store tile; the E-wide
// products h w2 (w2 MN-major: TB 1) and du w1^T (w1 K-major: TB 0), 4 stages
using HCfg = g9::Config<kHPpTile, 1, 1, 0, 5, 2 * 2 * kHPpTile / 64>;
using DuCfg = g9::Config<kDuTile, 2, 1, 0, 3, 2 * kDuTile / 64>;
template <int TB>
using ECfg = g9::Config<kETile, 1, TB, 0, 4, 0>;

// The CTA's row tile and its F segment [t0, t1) of tps tiles of `tile`
// columns: the segments of a row tile are consecutive CTAs, so the CTAs in
// flight share a few row tiles of x (and dy) in L2 and walk all of F.
struct FSeg {
  int m0, t0, t1;
};
__device__ __forceinline__ FSeg f_segment(int F, int tile, int tps) {
  const int tiles = (F + tile - 1) / tile, nseg = (tiles + tps - 1) / tps;
  const int seg = blockIdx.x % nseg, t0 = seg * tps;
  return {static_cast<int>(blockIdx.x / nseg) * g9::kTM, t0, min(tiles, t0 + tps)};
}

// The chunk's h = bf16(gelu_tanh(x w1 + b1)) into the scratch (rows, F):
// one CTA a row tile and F segment of tps tiles of 256 columns, which its
// warpgroups take in turns of 128 (gemm_pingpong): one's GELU epilogue
// runs under the other's products.
__global__ void __launch_bounds__(g9::kThreads, 1)
h_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w1,
              const __grid_constant__ CUtensorMap tm_h, const bf16* __restrict__ b1, int E, int F,
              int tps) {
  const g9::Product prod = {&tm_x, &tm_w1};
  const FSeg sg = f_segment(F, kHPpTile, tps * (kHTile / kHPpTile));
  auto epilogue = [&](float (&acc)[2][kHPpTile / 2], int n0, const g9::Frag& fr, bf16* buf) {
#pragma unroll
    for (int j = 0; j < kHPpTile / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int f = n0 + 8 * j + 2 * fr.t + c;
        const float b = f < F ? ds::to_float(b1[f]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[h][4 * j + c] = gelu_tanh(acc[h][4 * j + c] + b);
          acc[h][4 * j + 2 + c] = gelu_tanh(acc[h][4 * j + 2 + c] + b);
        }
      }
    g9::store_bf16_pp<kHPpTile>(acc, buf, &tm_h, n0, fr);
  };
  g9::gemm_pingpong<HCfg>(prod, sg.m0, sg.t0, sg.t1, 0, E / g9::kTK, epilogue);
  g9::store_done();
}

// The chunk's du = bf16((dy w2^T) gelu_tanh'(x w1 + b1)) into the scratch
// (rows, F), u and dh in two accumulators of one tile: one CTA a row tile
// and F segment of tps tiles of 128 columns.
__global__ void __launch_bounds__(g9::kThreads, 1)
du_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w1,
               const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_w2,
               const __grid_constant__ CUtensorMap tm_du, const bf16* __restrict__ b1, int E, int F,
               int tps) {
  const g9::Product prod[2] = {{&tm_x, &tm_w1}, {&tm_dy, &tm_w2}};
  const FSeg sg = f_segment(F, kDuTile, tps);
  g9::gemm<DuCfg>(prod, sg.m0, sg.t0, sg.t1, 0, E / g9::kTK,
                  [&](float (&acc)[2][kDuTile / 2], int n0, const g9::Frag& fr, bf16* buf) {
#pragma unroll
                    for (int j = 0; j < kDuTile / 8; ++j)
#pragma unroll
                      for (int c = 0; c < 2; ++c) {
                        const int f = n0 + 8 * j + 2 * fr.t + c;
                        const float b = f < F ? ds::to_float(b1[f]) : 0.f;
                        acc[0][4 * j + c] = acc[1][4 * j + c] * gelu_tanh_grad(acc[0][4 * j + c] + b);
                        acc[0][4 * j + 2 + c] =
                            acc[1][4 * j + 2 + c] * gelu_tanh_grad(acc[0][4 * j + 2 + c] + b);
                      }
                    g9::store_bf16<kDuTile>(acc[0], buf, &tm_du, n0, fr);
                  });
  g9::store_done();
}

// The E-wide product of the chunk's rows, out (rows, E) = A (rows, F) B
// over the split's k-blocks [kbs y, kbs (y + 1)) of 64: grid (row tiles x
// E tiles, splits). One split: out = bf16(sum (+ bias)); more: the fp32
// sum into part + y * split_stride (reduce_kernel adds them in order).
template <int TB>
__device__ __forceinline__ void ewide(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                      const float* __restrict__ bias, bf16* __restrict__ out,
                                      float* __restrict__ part, size_t split_stride, int rows,
                                      int E, int F, int kbs) {
  const int nt = (E + kETile - 1) / kETile, m = blockIdx.x / nt, n = blockIdx.x % nt;
  const int kb0 = blockIdx.y * kbs, KB = min(kbs, (F + g9::kTK - 1) / g9::kTK - kb0);
  float* pp = part ? part + blockIdx.y * split_stride : nullptr;
  const g9::Product prod[1] = {{tm_a, tm_b}};
  g9::gemm<ECfg<TB>>(prod, m * g9::kTM, n, n + 1, kb0 * g9::kTK, KB,
                     [&](float (&acc)[1][kETile / 2], int n0, const g9::Frag& fr, bf16*) {
#pragma unroll
                       for (int rr = 0; rr < 2; ++rr) {
                         const int r = fr.row0 + fr.rw + 8 * rr;
                         if (r >= rows) continue;
#pragma unroll
                         for (int j = 0; j < kETile / 8; ++j) {
                           const int e = n0 + 8 * j + 2 * fr.t;
                           if (e >= E) continue;
                           const size_t o = (size_t)r * E + e;
                           float v0 = acc[0][4 * j + 2 * rr], v1 = acc[0][4 * j + 2 * rr + 1];
                           if (pp) {
                             *reinterpret_cast<float2*>(pp + o) = make_float2(v0, v1);
                           } else {
                             if (bias) {
                               v0 += bias[e];
                               v1 += bias[e + 1];
                             }
                             *reinterpret_cast<__nv_bfloat162*>(out + o) =
                                 __floats2bfloat162_rn(v0, v1);
                           }
                         }
                       }
                     });
}

// y = h w2 + b2 (the forward's second product), and dx = du w1^T: kernels
// of their own names, so that a profile tells them apart
__global__ void __launch_bounds__(g9::kThreads, 1)
y_sm90_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w2,
              const float* __restrict__ b2, bf16* __restrict__ y, float* __restrict__ part,
              size_t split_stride, int rows, int E, int F, int kbs) {
  ewide<1>(&tm_h, &tm_w2, b2, y, part, split_stride, rows, E, F, kbs);
}

__global__ void __launch_bounds__(g9::kThreads, 1)
dx_sm90_kernel(const __grid_constant__ CUtensorMap tm_du, const __grid_constant__ CUtensorMap tm_w1,
               bf16* __restrict__ dx, float* __restrict__ part, size_t split_stride, int rows, int E,
               int F, int kbs) {
  ewide<0>(&tm_du, &tm_w1, nullptr, dx, part, split_stride, rows, E, F, kbs);
}

// launches by kernel: 0 fwd_kernel, 1 dx_kernel, 2 dw_sm90_kernel (bf16),
// 3 dw_kernel (fp32), 4 reduce_kernel, 5 h_sm90_kernel, 6 y_sm90_kernel,
// 7 du_sm90_kernel, 8 dx_sm90_kernel; counted on the host where each is
// launched
enum Which : int { kFwd, kDx, kDwSm90, kDw, kReduce, kHSm90, kYSm90, kDuSm90, kDxSm90, kWhich };
std::atomic<unsigned long long> g_launched[kWhich];

cudaError_t counted(cudaError_t err, int which) {
  if (err == cudaSuccess) ++g_launched[which];
  return err;
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
  return counted(cudaGetLastError(), kReduce);
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
size_t dw_smem(int E) {
  // fp32: two x and two dy row tiles, the w1 and w2 chunks, du and h; the u
  // and dh halves and du
  return sizeof(float) * ((size_t)4 * kBRW * (E + kPad) + (size_t)E * (kBFW + kPad) +
                          (size_t)kBFW * (E + kPad) + 2 * kBRW * (kBFW + kPad) +
                          5 * kBRW * kBFW);
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
  err = counted(cudaGetLastError(), kFwd);
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
  err = counted(cudaGetLastError(), kDx);
  if (err != cudaSuccess || nsplit == 1) return err;
  return reduce<T>(part, nsplit, (size_t)R * E, (size_t)R * E, nullptr, 1, static_cast<T*>(dx),
                   st);
}

// fp32: dw_kernel over 16-row tiles, tps of them a segment
cudaError_t dw_fp32(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                    float* part, int R, int E, int F, int nseg, int tps, cudaStream_t st) {
  const size_t smem = dw_smem(E);
  cudaError_t err = set_smem(dw_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kBFW, nseg);
  dw_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(dy), part, R, E, F, tps);
  return counted(cudaGetLastError(), kDw);
}

// bf16: dw_sm90_kernel over 64-row tiles, tps of them a segment, E-chunks
// of 64 NB columns
template <int NB>
cudaError_t dw_sm90(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                    float* part, int R, int E, int F, int nseg, int tps, cudaStream_t st) {
  using L = DwSm90<NB>;
  const int n = (E + L::BE - 1) / L::BE;
  if (n > kDwMaxCluster || L::smem(n) > kDwMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap mx, mdy, mw1, mw2;
  if (!s9::matrix_map(&mx, x, R, E) || !s9::matrix_map(&mdy, dy, R, E) ||
      !s9::matrix_map(&mw1, w1, E, F) || !s9::matrix_map(&mw2, w2, F, E))
    return cudaErrorInvalidValue;
  const auto kernel = dw_sm90_kernel<NB>;
  cudaError_t err = set_smem(kernel, L::smem(n));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * ((F + kDwHidden - 1) / kDwHidden), nseg);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = L::smem(n);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mx, mdy, mw1, mw2, static_cast<const bf16*>(b1), part, R,
                           E, F, tps);
  if (err == cudaSuccess) err = cudaGetLastError();
  return counted(err, kDwSm90);
}

// Clusters of the bf16 dw kernel's launch at this E that the card can hold
// at once (cudaOccupancyMaxActiveClusters), or -1.
template <int NB>
int dw_sm90_active_clusters(int E) {
  using L = DwSm90<NB>;
  const int n = (E + L::BE - 1) / L::BE;
  const auto kernel = dw_sm90_kernel<NB>;
  if (n > kDwMaxCluster || L::smem(n) > kDwMaxSmem || set_smem(kernel, L::smem(n)) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * 64, 1);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = L::smem(n);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = -1;
  return cudaOccupancyMaxActiveClusters(&count, kernel, &cfg) == cudaSuccess ? count : -1;
}

// the dw kernel of the dtype, then the segments summed in order and cast
cudaError_t bwd_dw(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                   void* out, float* db2, float* part, int R, int E, int F, int nseg, int tps,
                   int chunk, int dtype, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == ds::kFloat32) {
    err = dw_fp32(x, w1, b1, w2, dy, part, R, E, F, nseg, tps, st);
  } else if (chunk == 64) {
    err = dw_sm90<1>(x, w1, b1, w2, dy, part, R, E, F, nseg, tps, st);
  } else if (chunk == 128) {
    err = dw_sm90<2>(x, w1, b1, w2, dy, part, R, E, F, nseg, tps, st);
  } else if (chunk == 192) {
    err = dw_sm90<3>(x, w1, b1, w2, dy, part, R, E, F, nseg, tps, st);
  }
  if (err != cudaSuccess) return err;
  const size_t stride = 2 * (size_t)E * F + F + E, n_w = 2 * (size_t)E * F + F;
  err = dtype == ds::kFloat32
            ? reduce<float>(part, nseg, n_w, stride, nullptr, 1, static_cast<float*>(out), st)
            : reduce<bf16>(part, nseg, n_w, stride, nullptr, 1, static_cast<bf16*>(out), st);
  if (err != cudaSuccess) return err;
  return reduce<float>(part + n_w, nseg, (size_t)E, stride, nullptr, 1, db2, st);
}

// One launch of a gemm_sm90.cuh kernel, counted as `which`.
template <class C, typename K, typename... Args>
cudaError_t launch_g9(K kernel, dim3 grid, int which, cudaStream_t st, Args... args) {
  cudaError_t err = set_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, g9::kThreads, C::SMEM, st>>>(args...);
  return counted(cudaGetLastError(), which);
}

// The host's plan (ops/fused_mlp.py, mlp_plan) as the bf16 entries take it:
// row chunks of chunk_rows (a multiple of 128, or all of R), F segments of
// f_tps tiles of 256 hidden columns, the E-wide products' splits of kbs
// k-blocks of 64 hidden columns, none empty.
bool sm90_plan_ok(int R, int E, int F, int chunk_rows, int f_tps, int splits, int kbs) {
  const int kb_all = (F + g9::kTK - 1) / g9::kTK, f_tiles = (F + kHTile - 1) / kHTile;
  return R > 0 && E > 0 && E % 64 == 0 && E <= kMaxE && F > 0 && F % kBF == 0 &&
         chunk_rows > 0 && (chunk_rows % g9::kTM == 0 || chunk_rows >= R) && f_tps > 0 &&
         (long long)((chunk_rows + g9::kTM - 1) / g9::kTM) * ((f_tiles + f_tps - 1) / f_tps) <
             INT_MAX &&
         splits > 0 && splits <= 65535 && kbs > 0 && (long long)splits * kbs >= kb_all &&
         (long long)(splits - 1) * kbs < kb_all &&
         (long long)((chunk_rows + g9::kTM - 1) / g9::kTM) * ((E + kETile - 1) / kETile) < INT_MAX;
}

// The E-wide product of a chunk: y_sm90_kernel (fwd) or dx_sm90_kernel.
cudaError_t ewide_launch(bool fwd, const CUtensorMap& ma, const CUtensorMap& mb, const float* b2,
                         bf16* out, float* part, size_t stride, int rows, int E, int F, int splits,
                         int kbs, cudaStream_t st) {
  const dim3 grid(((rows + g9::kTM - 1) / g9::kTM) * ((E + kETile - 1) / kETile), splits);
  if (splits == 1) part = nullptr;
  if (fwd)
    return launch_g9<ECfg<1>>(y_sm90_kernel, grid, kYSm90, st, ma, mb, b2, out, part, stride,
                              rows, E, F, kbs);
  return launch_g9<ECfg<0>>(dx_sm90_kernel, grid, kDxSm90, st, ma, mb, out, part, stride, rows,
                            E, F, kbs);
}

// The bf16 forward (fwd) or dx on the tensor cores, chunk by chunk of rows:
// h_sm90_kernel (du_sm90_kernel) writes the chunk's hidden into the
// scratch, then y_sm90_kernel (dx_sm90_kernel) its rows of the output or,
// split over F, of the fp32 partials; reduce_kernel sums the splits in
// order (adding b2) and casts.
cudaError_t mlp_sm90(bool fwd, const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                     const bf16* dy, const float* b2, bf16* out, bf16* scratch, float* part, int R,
                     int E, int F, int chunk_rows, int f_tps, int splits, int kbs,
                     cudaStream_t st) {
  CUtensorMap mw1, mw2;
  if (!s9::matrix_map(&mw1, w1, E, F) || !s9::matrix_map(&mw2, w2, F, E))
    return cudaErrorInvalidValue;
  const size_t stride = (size_t)R * E;
  for (int c0 = 0; c0 < R; c0 += chunk_rows) {
    const int rows = min(chunk_rows, R - c0);
    const size_t off = (size_t)c0 * E;
    CUtensorMap mx, mdy, ms;
    if (!s9::matrix_map(&mx, x + off, rows, E) || !s9::matrix_map(&ms, scratch, rows, F) ||
        (!fwd && !s9::matrix_map(&mdy, dy + off, rows, E)))
      return cudaErrorInvalidValue;
    const int mt = (rows + g9::kTM - 1) / g9::kTM;
    const int segs = ((F + kHTile - 1) / kHTile + f_tps - 1) / f_tps;
    cudaError_t err =
        fwd ? launch_g9<HCfg>(h_sm90_kernel, dim3(mt * segs), kHSm90, st, mx, mw1, ms, b1, E, F,
                              f_tps)
            : launch_g9<DuCfg>(du_sm90_kernel, dim3(mt * segs), kDuSm90, st, mx, mw1, mdy, mw2,
                               ms, b1, E, F, f_tps * (kHTile / kDuTile));
    if (err != cudaSuccess) return err;
    float* pc = part ? part + off : nullptr;
    err = ewide_launch(fwd, ms, fwd ? mw2 : mw1, b2, out + off, pc, stride, rows, E, F, splits,
                       kbs, st);
    if (err != cudaSuccess) return err;
  }
  if (splits == 1) return cudaSuccess;
  return reduce<bf16>(part, splits, stride, stride, b2, E, out, st);
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

// dy (R, E) and dx (R, E) fp32; part as for fused_mlp_fwd. fp32 only: bf16
// dx takes fused_mlp_bwd_dx_sm90 at every row count.
DS_EXPORT int fused_mlp_bwd_dx(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* dy, void* dx, void* part, int R, int E, int F,
                               int nsplit, int chunks_per_split, int dtype, void* stream) {
  if (!shape_ok(R, E, F, dtype) || nsplit < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (dtype == ds::kFloat32)
    return bwd_dx<float>(x, w1, b1, w2, dy, dx, pf, R, E, F, nsplit, chunks_per_split, st);
  return cudaErrorInvalidValue;
}

// out: [dw1 (E, F) | dw2 (F, E) | db1 (F,)] in the dtype; db2 (E,) fp32;
// part (nseg, 2 E F + F + E) fp32 scratch, segment s taking row tiles
// [s * tiles_per_seg, (s + 1) * tiles_per_seg): 16 rows (fp32) or 64 (bf16).
// chunk: the bf16 kernel's E-chunk (64, 128 or 192 columns; a cluster of
// ceil(E / chunk) CTAs); unread for fp32.
DS_EXPORT int fused_mlp_bwd_dw(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* dy, void* out, void* db2, void* part, int R, int E,
                               int F, int nseg, int tiles_per_seg, int chunk, int dtype,
                               void* stream) {
  if (!shape_ok(R, E, F, dtype) || nseg < 1 || tiles_per_seg < 1 ||
      (dtype != ds::kFloat32 && dtype != ds::kBFloat16))
    return cudaErrorInvalidValue;
  return bwd_dw(x, w1, b1, w2, dy, out, static_cast<float*>(db2), static_cast<float*>(part), R, E,
                F, nseg, tiles_per_seg, chunk, dtype, static_cast<cudaStream_t>(stream));
}

// Clusters of dw_sm90_kernel's launch at (chunk, E) the card holds at once;
// -1 where the launch is not possible.
DS_EXPORT int fused_mlp_dw_active_clusters(int chunk, int E) {
  if (chunk == 64) return dw_sm90_active_clusters<1>(E);
  if (chunk == 128) return dw_sm90_active_clusters<2>(E);
  if (chunk == 192) return dw_sm90_active_clusters<3>(E);
  return -1;
}

// The bf16 forward on the tensor cores: x (R, E), w1 (E, F), b1 (F,), w2
// (F, E) bf16; b2 (E,) fp32; y (R, E) bf16; scratch (chunk_rows, F) bf16;
// part (splits, R, E) fp32 when splits > 1. The plan's numbers as
// sm90_plan_ok takes them (ops/fused_mlp.py, mlp_plan). Returns the
// cudaGetLastError() of the launches (h_sm90_kernel and y_sm90_kernel a
// chunk, then reduce_kernel when split).
DS_EXPORT int fused_mlp_fwd_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* y, void* scratch, void* part, int R, int E,
                                 int F, int chunk_rows, int f_tps, int splits, int kbs,
                                 void* stream) {
  if (!sm90_plan_ok(R, E, F, chunk_rows, f_tps, splits, kbs) || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  return mlp_sm90(true, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                  static_cast<const bf16*>(b1), static_cast<const bf16*>(w2), nullptr,
                  static_cast<const float*>(b2), static_cast<bf16*>(y),
                  static_cast<bf16*>(scratch), static_cast<float*>(part), R, E, F, chunk_rows,
                  f_tps, splits, kbs, static_cast<cudaStream_t>(stream));
}

// The bf16 dx on the tensor cores: dy and dx (R, E) bf16; the rest as for
// fused_mlp_fwd_sm90 (du_sm90_kernel and dx_sm90_kernel a chunk, then
// reduce_kernel when split).
DS_EXPORT int fused_mlp_bwd_dx_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                                    const void* dy, void* dx, void* scratch, void* part, int R,
                                    int E, int F, int chunk_rows, int f_tps, int splits,
                                    int kbs, void* stream) {
  if (!sm90_plan_ok(R, E, F, chunk_rows, f_tps, splits, kbs) || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  return mlp_sm90(false, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                  static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                  static_cast<const bf16*>(dy), nullptr, static_cast<bf16*>(dx),
                  static_cast<bf16*>(scratch), static_cast<float*>(part), R, E, F, chunk_rows,
                  f_tps, splits, kbs, static_cast<cudaStream_t>(stream));
}

// Launches so far of kernel `which` (0 fwd_kernel, 1 dx_kernel, 2
// dw_sm90_kernel, 3 dw_kernel, 4 reduce_kernel, 5 h_sm90_kernel, 6
// y_sm90_kernel, 7 du_sm90_kernel, 8 dx_sm90_kernel).
DS_EXPORT unsigned long long fused_mlp_launched(int which) {
  return which >= 0 && which < kWhich ? g_launched[which].load() : 0;
}
