// Fused cross-entropy head: the tied LM-head product, an online
// log-sum-exp and the label logit, with the logits never written to device
// memory, and the two gradients by recomputing them.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/fused_ce.py:
//   _fwd_kernel (:37) -> fused_ce_fwd: per token, lse over the padded vocab
//     (columns >= vocab_size at NEG = -1e30) and nll = lse - logit[label]
//     (0 for ignore_index);
//   _dh_kernel (:72)  -> fused_ce_dh: dh = dlog W, dlog = (p - onehot) *
//     valid with p = exp(logit - lse), dlog cast to W's dtype, fp32 sums;
//   _dw_kernel (:101) -> fused_ce_dw: dW = dlog^T h (the (Vp, E) rows of
//     the tied embedding, i.e. JAX's (E, Vp) dw transposed), dlog cast to
//     h's dtype, fp32 sums.
// h is (N, E), W the (Vp, E) rows the JAX kernels read as wteT (E, Vp),
// both bf16 or both fp32; labels (N,) int32.
//
// Bound on the H100: operations. The forward is one (N, E) x (E, Vp)
// product, 2 N E Vp flops (3.30e11 at the GPT-2-1.5B head, N = 2048,
// E = 1600, Vp = 50304: 0.333 ms at 989 TFLOP/s); dh and dw each rebuild
// the logits and do one more product of the same size (0.667 ms each).
// These first kernels do their products on the fp32 CUDA cores from shared
// memory (a bf16 input is exact in fp32, so the arithmetic is the TPU
// kernels' fp32 dots), so the fp32 FMA rate bounds them instead: the
// tensor-core (wgmma) versions are later work.
//
// Design. Every kernel builds a 16 x 256 tile of logits at a time, 16
// "rows" by 256 "columns", contracting E in chunks of 32 through shared
// memory; each of the 256 threads owns 4 rows x 4 columns of the tile.
// - fwd: rows are tokens, columns vocab entries. The vocab is split into
//   segments over grid.y (a TPU grid walks it in order; here blocks run in
//   parallel). Each thread keeps its own online (max, sum) per row over its
//   columns; the block merges them at the end and writes its segment's
//   (max, sum, label logit) per token; a second small kernel merges the
//   segments into lse and nll.
// - dh: rows are tokens, columns vocab. Each block holds the (16, E) fp32
//   accumulator of its tokens in shared memory (the TPU kernel's VMEM
//   output block), so each logits tile is built once and E is never split
//   across blocks; per tile it forms dlog in shared memory and adds
//   dlog x W[tile] into the accumulator. Vocab segments over grid.y add
//   their accumulators into the zeroed dh with fp32 atomics.
// - dw: rows are vocab entries, columns tokens (the transposed tile), the
//   same loop with h in W's place; one block per 16 vocab rows walks every
//   token, so it stores its rows of dW without atomics.
// Ragged N and Vp are masked: rows and columns past them are zero inputs,
// take no part in the softmax and are never written.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 16;         // rows per block
constexpr int kC = 256;        // columns per tile
constexpr int kBK = 32;        // contraction chunk
constexpr int kAS = kR + 4;    // row stride of the transposed row chunk (float4-aligned)
constexpr int kBS = kBK + 1;   // row stride of the column chunk (conflict-free reads)
constexpr int kDS = kR + 4;    // row stride of the dlog tile (float4-aligned)
constexpr float kNeg = -1e30f;

// s[i][j] = sum_e A[r][e] B[c][e] for this thread's rows r = rg * 4 + i and
// columns c = cg + 64 j (rg = tid / 64, cg = tid % 64). A holds nrows rows
// and B ncols rows of E elements; rows past them count as zeros.
template <typename T>
__device__ __forceinline__ void tile_logits(const T* __restrict__ A, int nrows,
                                            const T* __restrict__ B, int ncols, int E,
                                            float* As, float* Bs, float (&s)[4][4]) {
  const int tid = threadIdx.x, rg = tid / 64, cg = tid % 64;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < E; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < kR * kBK / kThreads; ++it) {
      const int idx = tid + it * kThreads, r = idx / kBK, kk = idx % kBK, k = k0 + kk;
      As[kk * kAS + r] = (r < nrows && k < E) ? ds::to_float(A[(size_t)r * E + k]) : 0.f;
    }
#pragma unroll 8
    for (int it = 0; it < kC * kBK / kThreads; ++it) {
      const int idx = tid + it * kThreads, c = idx / kBK, kk = idx % kBK, k = k0 + kk;
      Bs[c * kBS + kk] = (c < ncols && k < E) ? ds::to_float(B[(size_t)c * E + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * kAS + rg * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[(cg + 64 * j) * kBS + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
    __syncthreads();
  }
}

// (m, l) <- the online-softmax merge of (m, l) and (om, ol)
__device__ __forceinline__ void merge(float& m, float& l, float om, float ol) {
  const float M = fmaxf(m, om);
  l = l * expf(m - M) + ol * expf(om - M);
  m = M;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ labels,
              float* __restrict__ part, int N, int E, int Vp, int vocab, int tiles_per_seg) {
  __shared__ __align__(16) float As[kBK * kAS];
  __shared__ float Bs[kC * kBS];
  __shared__ float red[kThreads / 32][4][3];
  const int tid = threadIdx.x, rg = tid / 64, cg = tid % 64;
  const int n0 = blockIdx.x * kR, seg = blockIdx.y, nseg = gridDim.y;
  const int nrows = min(kR, N - n0);

  int lab[4];
  float m[4], l[4], ll[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + rg * 4 + i;
    lab[i] = n < N ? labels[n] : INT_MIN;
    m[i] = kNeg;
    l[i] = 0.f;
    ll[i] = 0.f;
  }
  const int vtiles = (Vp + kC - 1) / kC;
  const int t_end = min(vtiles, (seg + 1) * tiles_per_seg);
  for (int t = seg * tiles_per_seg; t < t_end; ++t) {
    const int v0 = t * kC;
    float s[4][4];
    tile_logits(h + (size_t)n0 * E, nrows, w + (size_t)v0 * E, min(kC, Vp - v0), E, As, Bs, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = v0 + cg + 64 * j;
        x[j] = v >= Vp ? -INFINITY : (v >= vocab ? kNeg : s[i][j]);
        if (v < Vp && v == lab[i]) ll[i] += x[j];
        mx = fmaxf(mx, x[j]);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(x[j] - mx);
      l[i] = l[i] * expf(m[i] - mx) + sum;
      m[i] = mx;
    }
  }
  // merge the 64 threads of each row group: 32 lanes by shuffles, then the
  // group's two warps through shared memory
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float ol = __shfl_xor_sync(0xffffffffu, l[i], o);
      ll[i] += __shfl_xor_sync(0xffffffffu, ll[i], o);
      merge(m[i], l[i], om, ol);
    }
    if (lane == 0) {
      red[warp][i][0] = m[i];
      red[warp][i][1] = l[i];
      red[warp][i][2] = ll[i];
    }
  }
  __syncthreads();
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + rg * 4 + i;
      if (n >= N) continue;
      float mm = red[warp][i][0], lm = red[warp][i][1];
      merge(mm, lm, red[warp + 1][i][0], red[warp + 1][i][1]);
      part[(size_t)(0 * nseg + seg) * N + n] = mm;
      part[(size_t)(1 * nseg + seg) * N + n] = lm;
      part[(size_t)(2 * nseg + seg) * N + n] = red[warp][i][2] + red[warp + 1][i][2];
    }
  }
}

__global__ void ce_fwd_combine(const float* __restrict__ part, const int* __restrict__ labels,
                               float* __restrict__ nll, float* __restrict__ lse, int N,
                               int nseg, int ignore) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = part[n], l = part[(size_t)nseg * N + n], ll = part[(size_t)2 * nseg * N + n];
  for (int s = 1; s < nseg; ++s) {
    merge(m, l, part[(size_t)s * N + n], part[(size_t)(nseg + s) * N + n]);
    ll += part[(size_t)(2 * nseg + s) * N + n];
  }
  const float z = m + logf(l);
  lse[n] = z;
  nll[n] = labels[n] != ignore ? z - ll : 0.f;
}

constexpr size_t bwd_smem_floats_fixed() {
  return (size_t)kBK * kAS + (size_t)kC * kBS + (size_t)kC * kDS + 2 * (size_t)kC;
}

// kDW false: dh, rows = tokens (A = h), columns = vocab (B = W);
// kDW true:  dW, rows = vocab (A = W), columns = tokens (B = h).
// out[row][e] = sum over the block's column tiles of dlog[row][c] B[c][e].
template <typename T, bool kDW>
__device__ __forceinline__ void
ce_bwd_body(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ labels,
            const float* __restrict__ lse, float* __restrict__ out, int N, int E, int Vp,
            int vocab, int ignore, int tiles_per_seg) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                   // kBK x kAS
  float* Bs = As + kBK * kAS;                         // kC x kBS
  float* dl = Bs + kC * kBS;                          // kC x kDS: dlog, column-major
  float* tok_lse = dl + kC * kDS;                     // per token of the tile's token side
  int* tok_lab = reinterpret_cast<int*>(tok_lse + kC);
  float* acc = reinterpret_cast<float*>(tok_lab + kC);  // kR x E
  const int tid = threadIdx.x, rg = tid / 64, cg = tid % 64;
  const int RN = kDW ? Vp : N, CN = kDW ? N : Vp;
  const T* A = (kDW ? w : h);
  const T* B = (kDW ? h : w);
  const int row0 = blockIdx.x * kR, seg = blockIdx.y, nseg = gridDim.y;
  const int nrows = min(kR, RN - row0);

  for (int i = tid; i < kR * E; i += kThreads) acc[i] = 0.f;
  if (!kDW && tid < kR) {   // the block's tokens (visible after tile_logits' barrier)
    const int n = row0 + tid;
    tok_lse[tid] = n < N ? lse[n] : 0.f;
    tok_lab[tid] = n < N ? labels[n] : ignore;
  }
  const int ctiles = (CN + kC - 1) / kC;
  const int t_end = min(ctiles, (seg + 1) * tiles_per_seg);
  for (int t = seg * tiles_per_seg; t < t_end; ++t) {
    const int c0 = t * kC, ncols = min(kC, CN - c0);
    if (kDW) {   // this tile's tokens (the previous tile's readers passed a barrier)
      const int n = c0 + tid;
      tok_lse[tid] = n < N ? lse[n] : 0.f;
      tok_lab[tid] = n < N ? labels[n] : ignore;
    }
    float s[4][4];
    tile_logits(A + (size_t)row0 * E, nrows, B + (size_t)c0 * E, ncols, E, As, Bs, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg * 4 + i, c = cg + 64 * j;
        const int n = kDW ? c0 + c : row0 + r;
        const int v = kDW ? row0 + r : c0 + c;
        const int k = kDW ? c : r;   // the token's slot in tok_lse / tok_lab
        float d = 0.f;
        if (n < N && v < Vp && tok_lab[k] != ignore) {
          const float x = v >= vocab ? kNeg : s[i][j];
          d = expf(x - tok_lse[k]) - (v == tok_lab[k] ? 1.f : 0.f);
        }
        dl[c * kDS + r] = ds::round_to<T>(d);
      }
    }
    __syncthreads();
    for (int e = tid; e < E; e += kThreads) {
      float a[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = acc[r * E + e];
      const T* bcol = B + (size_t)c0 * E + e;
#pragma unroll 4
      for (int c = 0; c < ncols; ++c) {
        const float x = ds::to_float(bcol[(size_t)c * E]);
        const float4* d4 = reinterpret_cast<const float4*>(dl + c * kDS);
#pragma unroll
        for (int q = 0; q < kR / 4; ++q) {
          const float4 dq = d4[q];
          a[4 * q] = fmaf(dq.x, x, a[4 * q]);
          a[4 * q + 1] = fmaf(dq.y, x, a[4 * q + 1]);
          a[4 * q + 2] = fmaf(dq.z, x, a[4 * q + 2]);
          a[4 * q + 3] = fmaf(dq.w, x, a[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r * E + e] = a[r];
    }
    __syncthreads();
  }
  for (int i = tid; i < nrows * E; i += kThreads) {
    float* dst = out + (size_t)row0 * E + i;
    if (nseg == 1)
      *dst = acc[i];
    else
      atomicAdd(dst, acc[i]);
  }
}

// dh and dW as kernels of their own names, so that a profile tells them apart
template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dh_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ labels,
             const float* __restrict__ lse, float* __restrict__ out, int N, int E, int Vp,
             int vocab, int ignore, int tiles_per_seg) {
  ce_bwd_body<T, false>(h, w, labels, lse, out, N, E, Vp, vocab, ignore, tiles_per_seg);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ labels,
             const float* __restrict__ lse, float* __restrict__ out, int N, int E, int Vp,
             int vocab, int ignore, int tiles_per_seg) {
  ce_bwd_body<T, true>(h, w, labels, lse, out, N, E, Vp, vocab, ignore, tiles_per_seg);
}

int tiles_per_segment(int tiles, int nseg) {
  nseg = max(1, min(nseg, tiles));
  return (tiles + nseg - 1) / nseg;
}

template <typename T>
cudaError_t fwd(const void* h, const void* w, const int* labels, float* nll, float* lse,
                float* part, int nseg, int N, int E, int Vp, int vocab, int ignore,
                cudaStream_t st) {
  const int vtiles = (Vp + kC - 1) / kC;
  const int tps = tiles_per_segment(vtiles, nseg);
  const int segs = (vtiles + tps - 1) / tps;
  const dim3 grid((N + kR - 1) / kR, segs);
  ce_fwd_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(h), static_cast<const T*>(w),
                                              labels, part, N, E, Vp, vocab, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine<<<(N + 255) / 256, 256, 0, st>>>(part, labels, nll, lse, N, segs, ignore);
  return cudaGetLastError();
}

template <typename T, bool kDW>
cudaError_t bwd(const void* h, const void* w, const int* labels, const float* lse, float* out,
                int nseg, int N, int E, int Vp, int vocab, int ignore, cudaStream_t st) {
  const int RN = kDW ? Vp : N, CN = kDW ? N : Vp;
  const int ctiles = (CN + kC - 1) / kC;
  const int tps = tiles_per_segment(ctiles, nseg);
  const int segs = (ctiles + tps - 1) / tps;
  const size_t smem = sizeof(float) * (bwd_smem_floats_fixed() + (size_t)kR * E);
  const auto kernel = kDW ? ce_dw_kernel<T> : ce_dh_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((RN + kR - 1) / kR, segs);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(h), static_cast<const T*>(w),
                                       labels, lse, out, N, E, Vp, vocab, ignore, tps);
  return cudaGetLastError();
}

}  // namespace

DS_DEFINE_ERROR_STRING

// h (N, E) and w (Vp, E) of one dtype; labels (N,) int32; nll, lse (N,)
// fp32; part (3, nseg, N) fp32 scratch. Returns the cudaGetLastError() of
// the launches.
DS_EXPORT int fused_ce_fwd(const void* h, const void* w, const void* labels, void* nll, void* lse,
                           void* part, int nseg, int N, int E, int Vp, int vocab, int ignore,
                           int dtype, void* stream) {
  if (N <= 0 || E <= 0 || Vp <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float *nf = static_cast<float*>(nll), *lf = static_cast<float*>(lse);
  float* pf = static_cast<float*>(part);
  if (dtype == ds::kBFloat16)
    return fwd<ds::bf16>(h, w, lab, nf, lf, pf, nseg, N, E, Vp, vocab, ignore, st);
  if (dtype == ds::kFloat32)
    return fwd<float>(h, w, lab, nf, lf, pf, nseg, N, E, Vp, vocab, ignore, st);
  return cudaErrorInvalidValue;
}

// dh (N, E) fp32, zeroed by the caller (vocab segments add into it).
DS_EXPORT int fused_ce_dh(const void* h, const void* w, const void* labels, const void* lse,
                          void* dh, int nseg, int N, int E, int Vp, int vocab, int ignore,
                          int dtype, void* stream) {
  if (N <= 0 || E <= 0 || Vp <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* lf = static_cast<const float*>(lse);
  float* out = static_cast<float*>(dh);
  if (dtype == ds::kBFloat16)
    return bwd<ds::bf16, false>(h, w, lab, lf, out, nseg, N, E, Vp, vocab, ignore, st);
  if (dtype == ds::kFloat32)
    return bwd<float, false>(h, w, lab, lf, out, nseg, N, E, Vp, vocab, ignore, st);
  return cudaErrorInvalidValue;
}

// dw (Vp, E) fp32, every row written (one block walks all tokens).
DS_EXPORT int fused_ce_dw(const void* h, const void* w, const void* labels, const void* lse,
                          void* dw, int N, int E, int Vp, int vocab, int ignore, int dtype,
                          void* stream) {
  if (N <= 0 || E <= 0 || Vp <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* lf = static_cast<const float*>(lse);
  float* out = static_cast<float*>(dw);
  if (dtype == ds::kBFloat16)
    return bwd<ds::bf16, true>(h, w, lab, lf, out, 1, N, E, Vp, vocab, ignore, st);
  if (dtype == ds::kFloat32)
    return bwd<float, true>(h, w, lab, lf, out, 1, N, E, Vp, vocab, ignore, st);
  return cudaErrorInvalidValue;
}
