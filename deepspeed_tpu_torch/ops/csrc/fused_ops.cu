// Fused LayerNorm, bias + tanh-GELU and attention softmax, forward and backward.
//
// Replaces the six TPU kernels of deepspeed_tpu/ops/pallas/fused_ops.py:
// _ln_fwd_kernel (:46), _ln_bwd_kernel (:60), _bias_gelu_fwd_kernel (:179),
// _bias_gelu_bwd_kernel (:184), _softmax_fwd_kernel (:259) and
// _softmax_bwd_kernel (:275). The arithmetic is theirs, in fp32: LayerNorm's
// ONE-pass variance E[x^2] - mean^2 (each square and mean^2 rounded on their
// own, __fmul_rn, so that nvcc contracts none of them into an fma, which
// would change the one-pass result far from zero mean); GELU's tanh form term
// for term; the softmax's max at -inf read as 0, so a row whose every key
// is masked is 0/0 = NaN, as the TPU kernel gives.
//
// Bound on the H100: every kernel here is an elementwise pass or a
// single-row reduction, a few flops per byte, so the bytes bound them: each
// input read once and each output written once, at 3.35 TB/s. The design
// aims at reading each byte from device memory once and no more:
//   - rows are read with 16-byte loads (8 elements) where the row width is
//     a multiple of 8 (VEC), one element at a time otherwise;
//   - the LayerNorm forward and the softmax backward take one warp per row;
//     a second sweep of the row re-reads it from L1, which the first filled;
//   - the softmax forward reads each kept key once: for rows of up to
//     kSoftmaxHeldCols keys, softmax_fwd_held_kernel holds a warp's row in
//     registers from the max to the write (one expf a kept element, keys
//     past the causal limit never read), and each warp walks its own rows
//     with the next rows' loads in flight; rows wider than that keep the
//     three-sweep row kernel (softmax_fwd_wide_kernel);
//   - the bias-GELU backward's dbias is written as one fp32 partial row per
//     block of rows_per_block rows, summed over the rows in order, and the
//     wrapper adds the partial rows with torch.sum: no atomics, so a
//     repeated call gives the same bits;
//   - the LayerNorm backward reads x and dy once: ln_bwd_rows_kernel holds a
//     row's slab in a warp's registers from the row sums to the dx write,
//     each lane keeps its columns' dgamma and dbeta sums over the rows its
//     warp takes, and the block's warps add theirs in shared memory into one
//     fp32 partial row a block (one block an SM); ln_bwd_sum_kernel adds the
//     partial rows in a fixed order (no atomics). Rows wider than
//     kLnHeldCols keep the row pass that re-reads x and dy from L1
//     (ln_bwd_wide_kernel, one partial row per rows_per_block rows).
//     Measured on an H100 (PERF.md, row 12a): 70% of the bound at (8192,
//     1024) bf16; what moved it was holding each row's mean and rstd with its
//     prefetched x and dy, and gamma, in registers (0.027 -> 0.0195 ms for the
//     rows kernel), not a deeper prefetch of x and dy alone. The held softmax
//     forward (PERF.md, row 12c): 79% of the bound at (256, 512, 512) bf16,
//     88% of a device copy of the same bytes; the causal shapes at 61-64% of
//     a bound that counts only the kept keys, where dropping the expf or the
//     division (wrong values, timed only) gained 6-11%; a deeper prefetch or
//     more resident blocks spilled and ran slower.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr int kLnHeldCols = 1024;  // the widest row ln_bwd_rows_kernel holds: 4 slabs of 256
constexpr int kLnSumSegs = 16;     // segments of the partial rows in ln_bwd_sum_kernel
constexpr int kSoftmaxHeldCols = 1024;  // the widest row softmax_fwd_held_kernel holds

// Eight elements at columns c .. c + 7 of a row, as floats (VEC: 16-byte
// loads, the row width a multiple of 8; otherwise masked scalar loads, 0 past D).
template <typename T, bool VEC>
__device__ __forceinline__ void load_cols(const T* row, int c, int D, float (&o)[8]) {
  if constexpr (VEC) {
    ds::load8(row + c, o);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = c + i < D ? ds::to_float(row[c + i]) : 0.f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_cols(T* row, int c, int D, const float (&v)[8]) {
  if constexpr (VEC) {
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(row + c) = *reinterpret_cast<const uint4*>(h);
    } else {
      reinterpret_cast<float4*>(row + c)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(row + c)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < D) row[c + i] = ds::from_float<T>(v[i]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float u) {
  const float inner = kSqrt2OverPi * (u + 0.044715f * u * u * u);
  return 0.5f * u * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float u3 = 0.044715f * u * u * u;
  const float t = tanhf(kSqrt2OverPi * (u + u3));
  const float sech2 = 1.f - t * t;
  return 0.5f * (1.f + t) + 0.5f * u * sech2 * kSqrt2OverPi * (1.f + 3.f * 0.044715f * u * u);
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row
// ---------------------------------------------------------------------------
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ mean_out,
              float* __restrict__ rstd_out, int R, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    float v[8];
    load_cols<T, VEC>(xr, c, D, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[i];
      ss += __fmul_rn(v[i], v[i]);
    }
  }
  s = ds::warp_sum(s);
  ss = ds::warp_sum(ss);
  const float mean = s / D;
  const float var = ss / D - __fmul_rn(mean, mean);
  const float rstd = 1.f / sqrtf(var + eps);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  T* yr = y + (size_t)row * D;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    float v[8], g[8], b[8];
    load_cols<T, VEC>(xr, c, D, v);
    load_cols<float, VEC>(gamma, c, D, g);
    load_cols<float, VEC>(beta, c, D, b);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mean, rstd), g[i]), b[i]);
    store_cols<T, VEC>(yr, c, D, v);
  }
}

// Rows wider than kLnHeldCols: dx per row (warps over the block's rows), then
// the block's dgamma and dbeta partial rows (threads over columns, rows in
// order; each product and sum rounded on its own, as the plain model of this
// order, fused_ops.layer_norm_bwd_tiled_plain, rounds them).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ln_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ dg_part,
              float* __restrict__ db_part, int R, int D, int rows_per_block) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const T* xr = x + (size_t)row * D;
    const T* dyr = dy + (size_t)row * D;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 8; c < D; c += 32 * 8) {
      float v[8], d[8], g[8];
      load_cols<T, VEC>(xr, c, D, v);
      load_cols<T, VEC>(dyr, c, D, d);
      load_cols<float, VEC>(gamma, c, D, g);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xhat = (v[i] - mu) * rs;
        const float dxhat = d[i] * g[i];
        s1 += dxhat;
        s2 += dxhat * xhat;
      }
    }
    const float m1 = ds::warp_sum(s1) / D;
    const float m2 = ds::warp_sum(s2) / D;
    T* dxr = dx + (size_t)row * D;
    for (int c = lane * 8; c < D; c += 32 * 8) {
      float v[8], d[8], g[8];
      load_cols<T, VEC>(xr, c, D, v);
      load_cols<T, VEC>(dyr, c, D, d);
      load_cols<float, VEC>(gamma, c, D, g);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xhat = (v[i] - mu) * rs;
        v[i] = rs * (d[i] * g[i] - m1 - xhat * m2);
      }
      store_cols<T, VEC>(dxr, c, D, v);
    }
  }
  for (int c = threadIdx.x * 8; c < D; c += kThreads * 8) {
    float ag[8] = {}, ab[8] = {};
    for (int row = r0; row < r1; ++row) {
      float v[8], d[8];
      load_cols<T, VEC>(x + (size_t)row * D, c, D, v);
      load_cols<T, VEC>(dy + (size_t)row * D, c, D, d);
      const float mu = mean[row], rs = rstd[row];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ag[i] = __fadd_rn(ag[i], __fmul_rn(d[i], (v[i] - mu) * rs));
        ab[i] = __fadd_rn(ab[i], d[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < D) {
        dg_part[(size_t)blockIdx.x * D + c + i] = ag[i];
        db_part[(size_t)blockIdx.x * D + c + i] = ab[i];
      }
  }
}

// Eight elements of a row as loaded: bf16 kept packed (4 registers), fp32 as
// floats; the same values load_cols gives (0 past D).
template <typename T>
struct Eight;

template <>
struct Eight<float> {
  float v[8];
  template <bool VEC>
  __device__ __forceinline__ void load(const float* row, int c, int D) {
    load_cols<float, VEC>(row, c, D, v);
  }
  __device__ __forceinline__ float operator[](int i) const { return v[i]; }
  // a fresh value to the compiler: no product of the last sweep is reused
  __device__ __forceinline__ void opaque() {
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(v[i]));
  }
};

template <>
struct Eight<ds::bf16> {
  uint4 w;
  template <bool VEC>
  __device__ __forceinline__ void load(const ds::bf16* row, int c, int D) {
    if constexpr (VEC) {
      w = __ldcs(reinterpret_cast<const uint4*>(row + c));   // read once: evict first
    } else {
      unsigned h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = c + i < D ? __bfloat16_as_ushort(row[c + i]) : 0u;
      w = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    const unsigned word = i < 2 ? w.x : i < 4 ? w.y : i < 6 ? w.z : w.w;
    return __uint_as_float((i & 1 ? word >> 16 : word & 0xffffu) << 16);
  }
  __device__ __forceinline__ void opaque() {
    asm volatile("" : "+r"(w.x), "+r"(w.y), "+r"(w.z), "+r"(w.w));
  }
};

// Rows of up to NS * 256 <= kLnHeldCols columns, one sweep of x and dy: block b
// takes rows [b * rows_per_block, (b + 1) * rows_per_block), its warp w the
// rows w, w + 8, ... of them, each lane the columns s * 256 + lane * 8 + i.
// A lane holds gamma's slab, and its slab of a row's x, dy, mean and rstd in
// registers (the next PD rows' loads in flight meanwhile: one block an SM,
// so these keep the bytes in flight; fp32 has registers for one) from the
// row sums to the dx write; dx comes out as in
// ln_bwd_wide_kernel's row pass (the same sums in the same order, so the same
// bits). The lane keeps its columns' dgamma and dbeta sums over its warp's
// rows, in row order, each product and sum rounded on its own; the warps
// then add theirs in shared memory, ((w0 + w1) + (w2 + w3)) + ((w4 + w5) +
// (w6 + w7)), into the block's partial row.
template <typename T, bool VEC, int NS, int PD = sizeof(T) == 2 ? 2 : 1>
__global__ void __launch_bounds__(kThreads, 1)
ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ dg_part,
                   float* __restrict__ db_part, int R, int D, int rows_per_block) {
  __shared__ float red[4][2][NS * 256];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * rows_per_block + warp;   // this warp's first row
  const int r1 = min(R, blockIdx.x * rows_per_block + rows_per_block);
  const int n = r0 < r1 ? (r1 - r0 + kWarps - 1) / kWarps : 0;   // its rows
  float ag[NS][8], ab[NS][8], g[NS][8];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int c = s * 256 + lane * 8;
    if (c < D) load_cols<float, VEC>(gamma, c, D, g[s]);
#pragma unroll
    for (int i = 0; i < 8; ++i) ag[s][i] = ab[s][i] = 0.f;
  }
  // rows k .. k + PD of the warp: x, dy, mean and rstd
  Eight<T> xs[PD + 1][NS], ds_[PD + 1][NS];
  float mu[PD + 1], rs[PD + 1];
  auto load_row = [&](int row, int b) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int c = s * 256 + lane * 8;
      if (c < D) {
        xs[b][s].template load<VEC>(x + (size_t)row * D, c, D);
        ds_[b][s].template load<VEC>(dy + (size_t)row * D, c, D);
      }
    }
    mu[b] = mean[row];
    rs[b] = rstd[row];
  };
#pragma unroll
  for (int k = 0; k < PD; ++k)
    if (k < n) load_row(r0 + k * kWarps, k);
  for (int k = 0; k < n; ++k) {
    const int row = r0 + k * kWarps;
    if (k + PD < n) load_row(row + PD * kWarps, PD);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int c = s * 256 + lane * 8;
      if (c < D) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xhat = (xs[0][s][i] - mu[0]) * rs[0];
          const float dxhat = ds_[0][s][i] * g[s][i];
          s1 += dxhat;
          s2 += dxhat * xhat;
        }
      }
    }
    const float m1 = ds::warp_sum(s1) / D;
    const float m2 = ds::warp_sum(s2) / D;
    T* dxr = dx + (size_t)row * D;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int c = s * 256 + lane * 8;
      if (c < D) {
        xs[0][s].opaque();
        ds_[0][s].opaque();
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = ds_[0][s][i];
          const float xhat = (xs[0][s][i] - mu[0]) * rs[0];
          v[i] = rs[0] * (d * g[s][i] - m1 - xhat * m2);
          ag[s][i] = __fadd_rn(ag[s][i], __fmul_rn(d, xhat));
          ab[s][i] = __fadd_rn(ab[s][i], d);
        }
        store_cols<T, VEC>(dxr, c, D, v);
      }
    }
#pragma unroll
    for (int b = 0; b < PD; ++b) {
      mu[b] = mu[b + 1];
      rs[b] = rs[b + 1];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        xs[b][s] = xs[b + 1][s];
        ds_[b][s] = ds_[b + 1][s];
      }
    }
  }
  // the warps' sums, pairwise in warp order: level 1 odd warps to even, 2
  // warps 2, 6 to 0, 4, then 4 to 0
#pragma unroll
  for (int level = 1; level < kWarps; level <<= 1) {
    const int pos = warp & (2 * level - 1);
    if (pos == level) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          red[warp >> 1][0][s * 256 + lane * 8 + i] = ag[s][i];
          red[warp >> 1][1][s * 256 + lane * 8 + i] = ab[s][i];
        }
    }
    __syncthreads();
    if (pos == 0) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ag[s][i] = __fadd_rn(ag[s][i], red[(warp + level) >> 1][0][s * 256 + lane * 8 + i]);
          ab[s][i] = __fadd_rn(ab[s][i], red[(warp + level) >> 1][1][s * 256 + lane * 8 + i]);
        }
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = s * 256 + lane * 8 + i;
        if (c < D) {
          dg_part[(size_t)blockIdx.x * D + c] = ag[s][i];
          db_part[(size_t)blockIdx.x * D + c] = ab[s][i];
        }
      }
  }
}

// dgamma and dbeta from P partial rows, in a fixed order: a block takes 32
// of the 2 D columns (dgamma's, then dbeta's), its warp k the partial rows
// [k * per, (k + 1) * per) in order (per = ceil(P / kLnSumSegs)); warp 0
// then adds the segments in order. No atomics: a repeat gives the same bits.
__global__ void __launch_bounds__(32 * kLnSumSegs)
ln_bwd_sum_kernel(const float* __restrict__ dg_part, const float* __restrict__ db_part,
                  float* __restrict__ dg, float* __restrict__ db, int P, int D) {
  __shared__ float seg[kLnSumSegs][32];
  const int lane = threadIdx.x % 32, k = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const bool live = col < 2 * D;
  const float* part = col < D ? dg_part : db_part;
  const int c = col < D ? col : col - D;
  const int per = (P + kLnSumSegs - 1) / kLnSumSegs;
  const int p1 = min(P, (k + 1) * per);
  float acc = 0.f;
  if (live) {
#pragma unroll 4
    for (int p = k * per; p < p1; ++p) acc = __fadd_rn(acc, part[(size_t)p * D + c]);
  }
  seg[k][lane] = acc;
  __syncthreads();
  if (k == 0 && live) {
    float tot = seg[0][lane];
#pragma unroll
    for (int j = 1; j < kLnSumSegs; ++j) tot = __fadd_rn(tot, seg[j][lane]);
    (col < D ? dg : db)[c] = tot;
  }
}

// ---------------------------------------------------------------------------
// bias + tanh-GELU: elementwise, eight columns a thread
// ---------------------------------------------------------------------------
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gelu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias, T* __restrict__ y,
                int R, int D) {
  const int groups = (D + 7) / 8;   // column groups per row
  const size_t n = (size_t)R * groups;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    const size_t row = i / groups;
    const int c = (int)(i % groups) * 8;
    float v[8], b[8];
    load_cols<T, VEC>(x + row * D, c, D, v);
    load_cols<float, VEC>(bias, c, D, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = gelu_tanh(v[j] + b[j]);
    store_cols<T, VEC>(y + row * D, c, D, v);
  }
}

// dx = dy * gelu'(x + b) for the block's rows, and the block's dbias partial
// row: the fp32 dx summed over those rows in order.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gelu_bwd_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ db_part,
                int R, int D, int rows_per_block) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * 8;
  if (c >= D) return;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  float b[8], acc[8] = {};
  load_cols<float, VEC>(bias, c, D, b);
#pragma unroll 4
  for (int row = r0; row < r1; ++row) {
    float v[8], d[8];
    load_cols<T, VEC>(x + (size_t)row * D, c, D, v);
    load_cols<T, VEC>(dy + (size_t)row * D, c, D, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = d[j] * gelu_tanh_grad(v[j] + b[j]);
      acc[j] += v[j];
    }
    store_cols<T, VEC>(dx + (size_t)row * D, c, D, v);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + j < D) db_part[(size_t)blockIdx.y * D + c + j] = acc[j];
}

// ---------------------------------------------------------------------------
// attention softmax forward: rows of up to kSoftmaxHeldCols keys held in a
// warp's registers; wider rows one warp per row in three sweeps
// ---------------------------------------------------------------------------
// One row of the held kernel: its index and its kept keys, [0, lim).
struct SoftmaxRow {
  int row, lim;
};

// Virtual row v of the held kernel's grid. Under causal, virtual rows 2t and
// 2t + 1 of a head are its queries t and Sq - 1 - t, whose kept keys add up
// to the same count for every t: a warp's run of an even count of rows, from
// an even row, reads the same bytes wherever it starts (softmax_fwd_plan
// gives runs of one row or of an even count).
__device__ __forceinline__ SoftmaxRow softmax_row(int v, int Sq, int Sk, int q_offset,
                                                  int causal) {
  if (!causal) return {v, Sk};
  const int j = v % Sq, t = j >> 1;
  const int i = j & 1 ? Sq - 1 - t : t;
  return {v - j + i, max(0, min(Sk, q_offset + i + 1))};
}

// Rows of up to NC * 256 <= kSoftmaxHeldCols keys, each kept key read once.
// Four blocks an SM up to 1024 bytes a row (512 bf16 or 256 fp32 keys),
// else two, as fused_ops.softmax_fwd_plan counts them. Warp g of the grid
// takes the rows_per_warp virtual rows from g * rows_per_warp (softmax_row),
// its lane the columns j * 256 + lane * 8 + i, and holds a row in registers
// from the max to the write, the next PD rows' loads in flight meanwhile
// (PD + 1 buffers picked at compile time, so no register copy waits on a
// load; one row ahead: two spilled at this register budget and ran slower,
// PERF.md row 12c). Every warp walks rows_per_warp rows, a trip count the
// compiler sees is uniform, so its shuffles need no divergence handling;
// rows past `rows` load and store nothing. A lane's group of 8 columns past
// the row's kept keys is not read and is written as 0 / l: 0, or NaN in a
// row that keeps no key. The arithmetic is softmax_fwd_wide_kernel's,
// operation for operation, so are the bits: the max over the rounded
// products v * scale; each exponent's argument one fma, as nvcc contracts
// the wide kernel's v * scale - m; one expf a kept key; each lane's terms
// added in ascending column order, then the warp's sum; the quotient rounded
// as IEEE division rounds it (ds::div_rn_by from one reciprocal a row, or
// the division itself where a lane holds an e < 2^-100 or l is out of that
// function's range).
template <typename T, bool VEC, int NC, int PD = 1>
__global__ void __launch_bounds__(kThreads, NC * sizeof(T) <= 4 ? 4 : 2)
softmax_fwd_held_kernel(const T* __restrict__ s, T* __restrict__ p, int rows, int Sq, int Sk,
                        int q_offset, float scale, int causal, int rows_per_warp) {
  const int lane = threadIdx.x % 32;
  const int v0 = (blockIdx.x * kWarps + threadIdx.x / 32) * rows_per_warp;
  Eight<T> in[PD + 1][NC];
  SoftmaxRow at[PD + 1];
  auto load_row = [&](int k, int b) {
    at[b] = softmax_row(v0 + k, Sq, Sk, q_offset, causal);
    if (v0 + k >= rows) {   // past the last row: nothing loaded or stored
      at[b].row = -1;
      return;
    }
    const T* sr = s + (size_t)at[b].row * Sk;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = j * 256 + lane * 8;
      if (c < at[b].lim) in[b][j].template load<VEC>(sr, c, Sk);
    }
  };
  // f(j, i, keep) over the lane's group j of a row, keep: column i kept.
  // The tests on a group are the warp's (lim against the group's 256
  // columns), so its lanes never part: a group wholly kept runs with keep
  // true, one that holds the row's last kept key with the lanes' own
  // tests (selects, no branches), one past it not at all.
  auto each_group = [&](const int (&kept)[NC], int lim, auto f) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (lim >= (j + 1) * 256) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f(j, i, true);
      } else if (lim > j * 256) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f(j, i, i < kept[j]);
      }
    }
  };
  auto row_out = [&](int k, const Eight<T>(&x)[NC], const SoftmaxRow r) {
    int kept[NC];   // the lane's kept columns of each group
#pragma unroll
    for (int j = 0; j < NC; ++j) kept[j] = r.lim - (j * 256 + lane * 8);
    float m = -INFINITY;
    each_group(kept, r.lim, [&](int j, int i, bool keep) {
      m = fmaxf(m, keep ? __fmul_rn(x[j][i], scale) : -INFINITY);
    });
    m = warp_max(m);
    if (m == -INFINITY) m = 0.f;
    float e[NC][8] = {}, l = 0.f, emin = INFINITY;   // a key not kept adds 0 to l
    each_group(kept, r.lim, [&](int j, int i, bool keep) {
      const float v = expf(__fmaf_rn(x[j][i], scale, -m));
      e[j][i] = keep ? v : 0.f;
      l += e[j][i];
      emin = fminf(emin, keep ? v : INFINITY);
    });
    l = ds::warp_sum(l);
    if (r.row < 0) return;
    const bool in_range = l >= 0.5f && l <= 0x1p20f;
    const float z = in_range ? 0.f : 0.f / l;   // a key not kept
    const float rl = __frcp_rn(l);
    T* pr = p + (size_t)r.row * Sk;
    auto write = [&](auto quot) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = j * 256 + lane * 8;
        if (c < Sk) {
          float q[8];
          if (r.lim >= (j + 1) * 256) {
#pragma unroll
            for (int i = 0; i < 8; ++i) q[i] = quot(e[j][i]);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) q[i] = i < kept[j] ? quot(e[j][i]) : z;
          }
          store_cols<T, VEC>(pr, c, Sk, q);
        }
      }
    };
    if (in_range && emin >= 0x1p-100f)
      write([&](float v) { return ds::div_rn_by(v, l, rl); });
    else
      write([&](float v) { return v / l; });
  };
#pragma unroll
  for (int k = 0; k < PD; ++k)
    if (k < rows_per_warp) load_row(k, k);
  for (int k0 = 0; k0 < rows_per_warp; k0 += PD + 1) {
#pragma unroll
    for (int b = 0; b <= PD; ++b) {   // row k0 + b sits in buffer b
      const int k = k0 + b;
      if (k < rows_per_warp) {
        if (k + PD < rows_per_warp) load_row(k + PD, (b + PD) % (PD + 1));
        row_out(k, in[b], at[b]);
      }
    }
  }
}

// Rows wider than kSoftmaxHeldCols: one warp per (bh, query) row, three
// sweeps (the max, the sum, the write), the second and third re-reading the
// row from L1.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_wide_kernel(const T* __restrict__ s, T* __restrict__ p, int rows, int Sq, int Sk,
                        int q_offset, float scale, int causal) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  // keys past `last` are masked (causal: the bottom-aligned triangle)
  const int last = causal ? q_offset + row % Sq : Sk - 1;
  const T* sr = s + (size_t)row * Sk;
  float m = -INFINITY;
  for (int c = lane * 8; c < Sk; c += 32 * 8) {
    float v[8];
    load_cols<T, VEC>(sr, c, Sk, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < Sk && c + i <= last) m = fmaxf(m, v[i] * scale);
  }
  m = warp_max(m);
  if (m == -INFINITY) m = 0.f;
  float l = 0.f;
  for (int c = lane * 8; c < Sk; c += 32 * 8) {
    float v[8];
    load_cols<T, VEC>(sr, c, Sk, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < Sk && c + i <= last) l += expf(v[i] * scale - m);
  }
  l = ds::warp_sum(l);
  T* pr = p + (size_t)row * Sk;
  for (int c = lane * 8; c < Sk; c += 32 * 8) {
    float v[8];
    load_cols<T, VEC>(sr, c, Sk, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (c + i <= last ? expf(v[i] * scale - m) : 0.f) / l;
    store_cols<T, VEC>(pr, c, Sk, v);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_kernel(const T* __restrict__ p, const T* __restrict__ dy, T* __restrict__ ds_out,
                   int rows, int Sk, float scale) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* pr = p + (size_t)row * Sk;
  const T* dr = dy + (size_t)row * Sk;
  float dot = 0.f;
  for (int c = lane * 8; c < Sk; c += 32 * 8) {
    float a[8], d[8];
    load_cols<T, VEC>(pr, c, Sk, a);
    load_cols<T, VEC>(dr, c, Sk, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) dot += a[i] * d[i];
  }
  dot = ds::warp_sum(dot);
  T* out = ds_out + (size_t)row * Sk;
  for (int c = lane * 8; c < Sk; c += 32 * 8) {
    float a[8], d[8];
    load_cols<T, VEC>(pr, c, Sk, a);
    load_cols<T, VEC>(dr, c, Sk, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = __fmul_rn(a[i] * (d[i] - dot), scale);
    store_cols<T, VEC>(out, c, Sk, a);
  }
}

// ---------------------------------------------------------------------------
// launches: dtype and VEC (the row width a multiple of 8) picked here
// ---------------------------------------------------------------------------
template <template <typename, bool> class Launch, typename... Args>
cudaError_t dispatch(int dtype, int width, Args... args) {
  const bool vec = width % 8 == 0;
  if (dtype == ds::kBFloat16)
    return vec ? Launch<ds::bf16, true>::run(args...) : Launch<ds::bf16, false>::run(args...);
  if (dtype == ds::kFloat32)
    return vec ? Launch<float, true>::run(args...) : Launch<float, false>::run(args...);
  return cudaErrorInvalidValue;
}

int blocks_for(size_t threads_needed) {
  const size_t b = (threads_needed + kThreads - 1) / kThreads;
  return (int)(b < 132 * 16 ? (b ? b : 1) : 132 * 16);   // grid-stride past 16 blocks per SM
}

template <typename T, bool VEC>
struct LnFwd {
  static cudaError_t run(const void* x, const void* g, const void* b, void* y, void* mean,
                         void* rstd, int R, int D, float eps, cudaStream_t st) {
    ln_fwd_kernel<T, VEC><<<(R + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), R, D, eps);
    return cudaGetLastError();
  }
};

template <typename T, bool VEC>
struct LnBwd {
  template <int NS>
  static void rows(const void* x, const void* g, const void* mean, const void* rstd,
                   const void* dy, void* dx, void* dg, void* db, int R, int D, int rpb,
                   cudaStream_t st) {
    ln_bwd_rows_kernel<T, VEC, NS><<<(R + rpb - 1) / rpb, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(dg), static_cast<float*>(db), R, D, rpb);
  }
  static cudaError_t run(const void* x, const void* g, const void* mean, const void* rstd,
                         const void* dy, void* dx, void* dg_part, void* db_part, void* dg,
                         void* db, int R, int D, int rpb, cudaStream_t st) {
    const int ns = (D + 255) / 256;
    if (D > kLnHeldCols)
      ln_bwd_wide_kernel<T, VEC><<<(R + rpb - 1) / rpb, kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const float*>(g),
          static_cast<const float*>(mean), static_cast<const float*>(rstd),
          static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(dg_part),
          static_cast<float*>(db_part), R, D, rpb);
    else if (ns == 1)
      rows<1>(x, g, mean, rstd, dy, dx, dg_part, db_part, R, D, rpb, st);
    else if (ns == 2)
      rows<2>(x, g, mean, rstd, dy, dx, dg_part, db_part, R, D, rpb, st);
    else if (ns == 3)
      rows<3>(x, g, mean, rstd, dy, dx, dg_part, db_part, R, D, rpb, st);
    else
      rows<4>(x, g, mean, rstd, dy, dx, dg_part, db_part, R, D, rpb, st);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ln_bwd_sum_kernel<<<(2 * D + 31) / 32, 32 * kLnSumSegs, 0, st>>>(
        static_cast<const float*>(dg_part), static_cast<const float*>(db_part),
        static_cast<float*>(dg), static_cast<float*>(db), (R + rpb - 1) / rpb, D);
    return cudaGetLastError();
  }
};

template <typename T, bool VEC>
struct GeluFwd {
  static cudaError_t run(const void* x, const void* b, void* y, int R, int D, cudaStream_t st) {
    gelu_fwd_kernel<T, VEC><<<blocks_for((size_t)R * ((D + 7) / 8)), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(b), static_cast<T*>(y), R, D);
    return cudaGetLastError();
  }
};

template <typename T, bool VEC>
struct GeluBwd {
  static cudaError_t run(const void* x, const void* b, const void* dy, void* dx, void* db,
                         int R, int D, int rpb, cudaStream_t st) {
    const dim3 grid(((D + 7) / 8 + kThreads - 1) / kThreads, (R + rpb - 1) / rpb);
    gelu_bwd_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(b), static_cast<const T*>(dy),
        static_cast<T*>(dx), static_cast<float*>(db), R, D, rpb);
    return cudaGetLastError();
  }
};

template <typename T, bool VEC>
struct SoftmaxFwd {
  template <int NC>
  static void held(const void* s, void* p, int rows, int Sq, int Sk, int q_offset, float scale,
                   int causal, int rpw, cudaStream_t st) {
    const int warps = (rows + rpw - 1) / rpw;
    softmax_fwd_held_kernel<T, VEC, NC><<<(warps + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const T*>(s), static_cast<T*>(p), rows, Sq, Sk, q_offset, scale, causal, rpw);
  }
  static cudaError_t run(const void* s, void* p, int rows, int Sq, int Sk, int q_offset,
                         float scale, int causal, int rpw, cudaStream_t st) {
    const int nc = (Sk + 255) / 256;
    if (Sk > kSoftmaxHeldCols) {
      if (rpw != 1) return cudaErrorInvalidValue;   // one row a warp
      softmax_fwd_wide_kernel<T, VEC><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
          static_cast<const T*>(s), static_cast<T*>(p), rows, Sq, Sk, q_offset, scale, causal);
    } else if (nc == 1) {
      held<1>(s, p, rows, Sq, Sk, q_offset, scale, causal, rpw, st);
    } else if (nc == 2) {
      held<2>(s, p, rows, Sq, Sk, q_offset, scale, causal, rpw, st);
    } else if (nc == 3) {
      held<3>(s, p, rows, Sq, Sk, q_offset, scale, causal, rpw, st);
    } else {
      held<4>(s, p, rows, Sq, Sk, q_offset, scale, causal, rpw, st);
    }
    return cudaGetLastError();
  }
};

template <typename T, bool VEC>
struct SoftmaxBwd {
  static cudaError_t run(const void* p, const void* dy, void* ds_out, int rows, int Sk,
                         float scale, cudaStream_t st) {
    softmax_bwd_kernel<T, VEC><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const T*>(p), static_cast<const T*>(dy), static_cast<T*>(ds_out), rows, Sk,
        scale);
    return cudaGetLastError();
  }
};

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

DS_DEFINE_ERROR_STRING

// x, y (R, D) in one dtype; gamma, beta (D,) fp32; mean, rstd (R, 1) fp32.
DS_EXPORT int layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                             void* mean, void* rstd, int R, int D, float eps, int dtype,
                             void* stream) {
  if (R < 1 || D < 1) return cudaErrorInvalidValue;
  return dispatch<LnFwd>(dtype, D, x, gamma, beta, y, mean, rstd, R, D, eps, as_stream(stream));
}

// x, dy, dx (R, D); gamma (D,) fp32; mean, rstd (R, 1) fp32; dg_part and
// db_part (ceil(R / rows_per_block), D) fp32 scratch; dgamma, dbeta (D,)
// fp32. Rows of up to kLnHeldCols columns take ln_bwd_rows_kernel, wider ones
// ln_bwd_wide_kernel; then ln_bwd_sum_kernel adds the partial rows.
DS_EXPORT int layer_norm_bwd(const void* x, const void* gamma, const void* mean,
                             const void* rstd, const void* dy, void* dx, void* dg_part,
                             void* db_part, void* dgamma, void* dbeta, int R, int D,
                             int rows_per_block, int dtype, void* stream) {
  if (R < 1 || D < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  return dispatch<LnBwd>(dtype, D, x, gamma, mean, rstd, dy, dx, dg_part, db_part, dgamma,
                         dbeta, R, D, rows_per_block, as_stream(stream));
}

// x, y (R, D); bias (D,) fp32.
DS_EXPORT int bias_gelu_fwd(const void* x, const void* bias, void* y, int R, int D, int dtype,
                            void* stream) {
  if (R < 1 || D < 1) return cudaErrorInvalidValue;
  return dispatch<GeluFwd>(dtype, D, x, bias, y, R, D, as_stream(stream));
}

// x, dy, dx (R, D); bias (D,) fp32; db_part (ceil(R / rows_per_block), D) fp32.
DS_EXPORT int bias_gelu_bwd(const void* x, const void* bias, const void* dy, void* dx,
                            void* db_part, int R, int D, int rows_per_block, int dtype,
                            void* stream) {
  if (R < 1 || D < 1 || rows_per_block < 1) return cudaErrorInvalidValue;
  return dispatch<GeluBwd>(dtype, D, x, bias, dy, dx, db_part, R, D, rows_per_block,
                           as_stream(stream));
}

// s, p (BH, Sq, Sk); causal keeps key j for query i where q_offset + i >= j.
// Rows of up to kSoftmaxHeldCols keys take softmax_fwd_held_kernel, each warp
// rows_per_warp of them (fused_ops.softmax_fwd_plan); wider rows
// softmax_fwd_wide_kernel, one a warp (rows_per_warp 1).
DS_EXPORT int softmax_fwd(const void* s, void* p, int BH, int Sq, int Sk, int q_offset,
                          float scale, int causal, int rows_per_warp, int dtype, void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || rows_per_warp < 1) return cudaErrorInvalidValue;
  return dispatch<SoftmaxFwd>(dtype, Sk, s, p, BH * Sq, Sq, Sk, q_offset, scale, causal,
                              rows_per_warp, as_stream(stream));
}

// p, dy, ds (rows, Sk).
DS_EXPORT int softmax_bwd(const void* p, const void* dy, void* ds_out, int rows, int Sk,
                          float scale, int dtype, void* stream) {
  if (rows < 1 || Sk < 1) return cudaErrorInvalidValue;
  return dispatch<SoftmaxBwd>(dtype, Sk, p, dy, ds_out, rows, Sk, scale, as_stream(stream));
}
