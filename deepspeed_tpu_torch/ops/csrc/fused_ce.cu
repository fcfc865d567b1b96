// Fused cross-entropy head: the tied LM-head product, an online
// log-sum-exp and the label logit, with the logits never written to device
// memory whole, and the two gradients by recomputing them.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/fused_ce.py:
//   _fwd_kernel (:37)  per token, lse over the padded vocab (columns >=
//     vocab_size at NEG = -1e30) and nll = lse - logit[label] (0 for
//     ignore_index);
//   _dh_kernel (:72)   dh = dlog W, dlog = (p - onehot) * valid with p =
//     exp(logit - lse), dlog cast to W's dtype, fp32 sums;
//   _dw_kernel (:101)  dW = dlog^T h (the (Vp, E) rows of the tied
//     embedding, i.e. JAX's (E, Vp) dw transposed), dlog cast to h's
//     dtype, fp32 sums.
// h is (N, E), W the (Vp, E) rows the JAX kernels read as wteT (E, Vp),
// both bf16 or both fp32; labels (N,) int32.
//
// Bound on the H100: operations. Each product is 2 N E Vp flops (3.30e11
// at the GPT-2-1.5B head, N = 2048, E = 1600, Vp = 50304: 0.333 ms at 989
// TFLOP/s; 1.90e12 at gpt2-125m's micro-batch, N = 24576, E = 768: 1.92
// ms). The forward is one product; the backward needs the logits again
// and two more products (three; the TPU kernels' dh and dw each rebuild
// the logits: four).
//
// Two routes, chosen by dtype and shape (ops/fused_ce.py, sm90_route), each
// with C entries and launch counts of its own:
//
// bf16 with E % 8 == 0 (TMA's 16-byte row strides; every GPT-2 preset):
// the tensor cores. One GEMM mainloop (ce_gemm) templated on the operands'
// majorness, with four epilogues, behind four kernels:
// - A CTA is two consumer warpgroups, each with a 64 x 256 fp32 tile of the
//   output in registers (wgmma m64n256k16, operands from shared memory),
//   and one producer warp whose first lane keeps a ring of (A, B) stages in
//   flight by TMA: 64 of the contraction a stage, [64][64] boxes in the
//   128-byte swizzle (matrix_map), 48 KB a stage, 4 stages (3 for dlog,
//   whose output tile takes 64 KB more), each on a "full" mbarrier and
//   freed on an "empty" one that every consumer warp arrives on once the
//   wgmma reading it has retired (one group kept in flight).
// - ce_fwd_sm90_kernel: S = h W^T (both K-major), a CTA 128 tokens x a
//   segment of 256-column vocab tiles. Its epilogue masks columns >= vocab
//   (NEG; >= Vp: left out), picks the label logit, and folds the tile into a
//   running (max, sum) per token in the exp2 domain (row reductions by quad
//   shuffles), so the logits never leave registers; the segment's (m, l,
//   label logit) go to fp32 partials that ce_fwd_combine merges.
// - The backward walks the vocab in chunks of C columns (ops/fused_ce.py,
//   chunk_plan: N C bf16 of scratch at most SCRATCH_BYTES = 256 MiB, never
//   N Vp: one chunk at the 1.5B head, ten of 5120 at 125m). Per chunk:
//   ce_dlog_sm90_kernel forms S = h W_c^T as the forward does and writes
//   dlog = (exp(S - lse) - onehot) * valid, cast to bf16 (the TPU kernels'
//   cast point), through shared memory by TMA store into the scratch;
//   ce_dh_sm90_kernel adds dlog_c W_c (dlog K-major, W_c MN-major) into dh,
//   fp32 (the first chunk writes, later ones add; the last scales by g,
//   read from device memory, and casts to bf16); ce_dw_sm90_kernel writes
//   dW_c = dlog_c^T h (both MN-major: the transpose bits), scaled by g and
//   cast, each element once. Three products, no atomics: every output is
//   the same on every call.
// - Grids and traffic. The forward and dlog put the token tile on x, so
//   the CTAs in flight walk the same vocab tiles together and read each W
//   tile from device memory about once; segment_plan makes about whole
//   waves of 132 CTAs (1.5B head: 16 token tiles x 8 segments of 25 vocab
//   tiles, one wave; 125m: 192 x 11 segments of 18, 16 waves). Each
//   (token tile, vocab tile) pair reads (128 + 256) E bf16 from L2: 3.9 GB
//   at the 1.5B head, 22.3 GB at 125m, for device-memory reads of about W
//   once and h once (1.5B: h, 6.5 MB, stays in L2) or once a segment
//   (125m: 0.41 GB); dlog adds its writes (206 MB, 2.47 GB). dh and dw put
//   the E tile on x, so the CTAs of one token (vocab) tile run together and
//   read its dlog rows from device memory once a chunk; W_c (dh) and h
//   (dw) stay in L2 within a chunk; dh at 125m also reads and writes its
//   fp32 sum (75 MB) once a chunk after the first.
// - What bounds it (measured on an H100): not L2. A variant with 2-CTA clusters
//   that multicast each B tile (a third less L2 traffic) took the same
//   time. The forward and dlog run their epilogue after each tile's
//   products, with the tensor cores idle meanwhile: 32768 exp2 a tile at
//   16 a cycle an SM (about 0.33 ms over the 125m micro-batch's logits);
//   dh at 125m fills 4.4 waves a chunk.
//
// fp32, and bf16 with E % 8 != 0: the CUDA cores (the first port, kept as
// the fp32 route). Every kernel builds a 16 x 256 tile of logits at a time,
// 16 "rows" by 256 "columns", contracting E in chunks of 32 through shared
// memory; each of the 256 threads owns 4 rows x 4 columns of the tile.
// - fwd: rows are tokens, columns vocab entries, the vocab split into
//   segments over grid.y; each thread keeps its own online (max, sum) per
//   row, the block merges them and writes its segment's partials;
//   ce_fwd_combine merges the segments into lse and nll.
// - dh: rows are tokens, columns vocab. Each block holds the (16, E) fp32
//   accumulator of its tokens in shared memory (E <= 2560), forms dlog in
//   shared memory per tile and adds dlog x W[tile] into it; vocab segments
//   add their accumulators into the zeroed dh with fp32 atomics.
// - dw: rows are vocab entries, columns tokens, the same loop with h in W's
//   place; one block per 16 vocab rows walks every token.
// Ragged N and Vp are masked on both routes: rows and columns past them
// take no part in the softmax and are never written.
#include <climits>

#include "common.cuh"
#include "flash_sm90.cuh"

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

// launches by kernel, counted on the host where each is launched (the
// order of KERNELS in ops/fused_ce.py)
enum Launch {
  kLaunchFwdSm90, kLaunchDlogSm90, kLaunchDhSm90, kLaunchDwSm90, kLaunchCombine,
  kLaunchFwd, kLaunchDh, kLaunchDw, kLaunchCount
};
std::atomic<unsigned long long> g_launched[kLaunchCount];

using ds::sm90::counted;

cudaError_t combine(const float* part, const int* labels, float* nll, float* lse, int N, int nseg,
                    int ignore, cudaStream_t st) {
  ce_fwd_combine<<<(N + 255) / 256, 256, 0, st>>>(part, labels, nll, lse, N, nseg, ignore);
  return counted(cudaGetLastError(), g_launched[kLaunchCombine]);
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
  cudaError_t err = counted(cudaGetLastError(), g_launched[kLaunchFwd]);
  if (err != cudaSuccess) return err;
  return combine(part, labels, nll, lse, N, segs, ignore, st);
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
  return counted(cudaGetLastError(), g_launched[kDW ? kLaunchDw : kLaunchDh]);
}

// ===========================================================================
// bf16, E % 8 == 0: the tensor-core route (ce_gemm, four epilogues)
// ===========================================================================

namespace s9 = ds::sm90;
using bf16 = ds::bf16;

enum Mode { kFwd = 0, kDlog = 1, kDh = 2, kDw = 3 };

constexpr int kTM = 128;                    // output rows a CTA: two warpgroups of 64
constexpr int kTN = 256;                    // output columns a tile (wgmma n256)
constexpr int kTK = 64;                     // contraction a stage: one 128-byte swizzle row
constexpr int kBox = 64 * 64;               // elements of a [64][64] swizzled box
constexpr int kStage = 6 * kBox * 2;        // A (2 boxes) + B (4 boxes): 48 KB
constexpr int kGemmThreads = 2 * 128 + 32;  // two consumer warpgroups, one producer warp
constexpr float kLog2e = s9::kLog2e, kLn2 = s9::kLn2;

// The operands of each mode (1: MN-major, the transpose bit): A is h (fwd,
// dlog: K-major), dlog (dh: K-major), dlog^T (dw: M-major); B is W (fwd,
// dlog: K-major), W_c (dh: N-major), h (dw: N-major).
template <int MODE>
struct Gemm {
  static constexpr int TA = MODE == kDw;
  static constexpr int TB = MODE == kDh || MODE == kDw;
  static constexpr int STAGES = MODE == kDlog ? 3 : 4;
  static constexpr int OUT = STAGES * kStage;   // dlog: two [64][256] bf16 tiles for the store
  static constexpr int BAR = OUT + (MODE == kDlog ? 2 * 4 * kBox * 2 : 0);
  static constexpr int SMEM = 1024 + BAR + 2 * STAGES * 8;
};

struct CeArgs {
  int N, E, Vp, vocab, ignore;
  int c0, cw;           // the vocab chunk: W rows [c0, c0 + cw) (the forward: 0, Vp)
  int tiles_per_seg;    // fwd, dlog: 256-column tiles a CTA walks
  int nseg;             // fwd: segments (the partials' stride)
  int first, last;      // dh: the chunk writes dh / scales and casts it
  const int* labels;
  const float* lse;     // dlog
  const float* g;       // dh (last chunk), dw: the incoming gradient
  float* part;          // fwd: (3, nseg, N) fp32 partials
  float* dh_acc;        // dh: (N, E) fp32 between chunks
  bf16* dh_out;         // (N, E)
  bf16* dw_out;         // (Vp, E)
};

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) s9::mbar_arrive(bar);
}

// Accumulator element i of a thread: row (i / 2) % 2 of its two (r, r + 8),
// column 8 (i / 4) + 2 t + i % 2 of the tile (t = lane % 4).
__device__ __forceinline__ constexpr int acc_row(int i) { return (i / 2) % 2; }
__device__ __forceinline__ constexpr int acc_col(int i) { return 8 * (i / 4) + (i % 2); }

// The element of row rr at tile column c (c held by this thread: (c / 2) %
// 4 == t), by compare and select: no indexed registers.
__device__ __forceinline__ float acc_at(const float (&acc)[128], int rr, int c) {
  float x = 0.f;
  const int cc = c & ~6;
#pragma unroll
  for (int i = 0; i < 128; ++i)
    if (acc_row(i) == rr && acc_col(i) == cc) x = acc[i];
  return x;
}

template <int MODE>
__device__ __forceinline__ void ce_gemm(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                        const CUtensorMap* tm_o, const CeArgs& a) {
  using G = Gemm<MODE>;
  constexpr int ST = G::STAGES;
  constexpr bool kByVocab = MODE == kFwd || MODE == kDlog;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = s9::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::BAR);
  uint64_t* empty = full + ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the CTA's output tiles [t0, t1) of kTN columns, each over KB stages:
  // fwd, dlog: grid (token tiles, vocab segments); dh: (E tiles, token
  // tiles); dw: (E tiles, vocab tiles of the chunk)
  const int m0 = (kByVocab ? blockIdx.x : blockIdx.y) * kTM;
  int t0 = blockIdx.x, t1 = blockIdx.x + 1;
  if (kByVocab) {
    t0 = blockIdx.y * a.tiles_per_seg;
    t1 = min((a.cw + kTN - 1) / kTN, t0 + a.tiles_per_seg);
  }
  const int K = MODE == kDh ? a.cw : MODE == kDw ? a.N : a.E;
  const int KB = (K + kTK - 1) / kTK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      s9::mbar_init(&full[s], 1);
      s9::mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    s9::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {   // the producer warp
    if (lane == 0) {
      int it = 0;
      for (int t = t0; t < t1; ++t) {
        const int n0 = t * kTN;
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % ST, k = kb * kTK;
          if (it >= ST) s9::mbar_wait(&empty[s], ((it / ST) - 1) & 1);
          bf16* sa = reinterpret_cast<bf16*>(sm + s * kStage);
          bf16* sb = sa + 2 * kBox;
          s9::mbar_expect_tx(&full[s], kStage);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (MODE == kDw)   // dlog^T: [64 tokens][64 vocab] boxes
              s9::tma_load_2d(sa + i * kBox, tm_a, &full[s], m0 + 64 * i, k);
            else               // h or dlog: [64 tokens][64 of K]
              s9::tma_load_2d(sa + i * kBox, tm_a, &full[s], k, m0 + 64 * i);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kByVocab)           // W: [64 vocab][64 of E]
              s9::tma_load_2d(sb + j * kBox, tm_b, &full[s], k, a.c0 + n0 + 64 * j);
            else if (MODE == kDh)   // W_c: [64 vocab][64 of E]
              s9::tma_load_2d(sb + j * kBox, tm_b, &full[s], n0 + 64 * j, a.c0 + k);
            else                    // h: [64 tokens][64 of E]
              s9::tma_load_2d(sb + j * kBox, tm_b, &full[s], n0 + 64 * j, k);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: output rows [m0 + 64 wg, + 64); this thread's
  // rows r0, r0 + 8 and columns 8 j + 2 t + {0, 1} of each tile
  const int wg = warp / 4, t = lane % 4;
  const int rw = 16 * (warp % 4) + lane / 4;
  const int r0 = m0 + 64 * wg + rw;
  int lab[2] = {0, 0};
  float rs[2] = {0.f, 0.f};         // dlog: lse in the exp2 domain
  bool valid[2] = {false, false};   // dlog: a label to learn from
  float mrun[2] = {kNeg * kLog2e, kNeg * kLog2e}, lrun[2] = {0.f, 0.f}, llrun[2] = {0.f, 0.f};
  if (kByVocab) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int n = r0 + 8 * rr;
      lab[rr] = n < a.N ? a.labels[n] : INT_MIN;
      if (MODE == kDlog) {
        rs[rr] = n < a.N ? a.lse[n] * kLog2e : 0.f;
        valid[rr] = n < a.N && lab[rr] != a.ignore;
      }
    }
  }

  float acc[128];
  int it = 0;
  for (int tt = t0; tt < t1; ++tt) {
    const int n0 = tt * kTN;
    s9::fence_regs(acc);
    for (int kb = 0; kb < KB; ++kb, ++it) {
      const int s = it % ST;
      s9::mbar_wait(&full[s], (it / ST) & 1);
      const bf16* sa = reinterpret_cast<const bf16*>(sm + s * kStage) + wg * kBox;
      const bf16* sb = reinterpret_cast<const bf16*>(sm + s * kStage) + 2 * kBox;
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = G::TA ? s9::mnmajor_desc(sa + kk * 16 * 64, 64 * 128)
                                  : s9::kmajor_desc(sa + kk * 16);
        const uint64_t db = G::TB ? s9::mnmajor_desc(sb + kk * 16 * 64, 64 * 128)
                                  : s9::kmajor_desc(sb + kk * 16);
        s9::wgmma_ss<256, G::TA, G::TB>(acc, da, db, (kb | kk) != 0);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<1>();   // the previous stage's products have read it
      if (kb > 0) release(&empty[(it - 1) % ST], lane);
    }
    s9::wgmma_wait<0>();
    s9::fence_regs(acc);
    release(&empty[(it - 1) % ST], lane);

    if (MODE == kFwd) {
      // the label logit (masked as the softmax sees it), then the tile
      // folded into each row's running max and sum of 2^(x log2 e - m)
      const int v0 = a.c0 + n0;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int c = lab[rr] - v0;
        if ((unsigned)c < (unsigned)kTN && ((c >> 1) & 3) == t)
          llrun[rr] += lab[rr] >= a.vocab ? kNeg : acc_at(acc, rr, c);
      }
      if (v0 + kTN > a.vocab) {
#pragma unroll
        for (int i = 0; i < 128; ++i) {
          const int v = v0 + acc_col(i) + 2 * t;
          if (v >= a.vocab) acc[i] = v >= a.Vp ? -INFINITY : kNeg;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 128; ++i) mx[acc_row(i)] = fmaxf(mx[acc_row(i)], acc[i]);
      float mn[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) mn[rr] = fmaxf(mrun[rr], s9::quad_max(mx[rr]) * kLog2e);
#pragma unroll
      for (int i = 0; i < 128; ++i)
        sum[acc_row(i)] += exp2f(fmaf(acc[i], kLog2e, -mn[acc_row(i)]));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        lrun[rr] = lrun[rr] * exp2f(mrun[rr] - mn[rr]) + sum[rr];
        mrun[rr] = mn[rr];
      }
    } else if (MODE == kDlog) {
      // dlog = (exp(x - lse) - onehot) * valid, cast to bf16, staged in
      // shared memory in the 128-byte swizzle and stored by TMA (the
      // scratch's map clips rows past N and columns past the chunk)
      const int v0 = a.c0 + n0;
      const bool edge = v0 + kTN > a.vocab;
#pragma unroll
      for (int i = 0; i < 128; ++i) {
        const float p = exp2f(fmaf(acc[i], kLog2e, -rs[acc_row(i)]));
        acc[i] = edge && v0 + acc_col(i) + 2 * t >= a.vocab ? 0.f : p;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int c = lab[rr] - v0;
        if ((unsigned)c < (unsigned)kTN && ((c >> 1) & 3) == t) {
          const int cc = c & ~6;
#pragma unroll
          for (int i = 0; i < 128; ++i)
            if (acc_row(i) == rr && acc_col(i) == cc) acc[i] -= 1.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 128; ++i)
        if (!valid[acc_row(i)]) acc[i] = 0.f;
      bf16* out = reinterpret_cast<bf16*>(sm + G::OUT) + wg * 4 * kBox;
      const bool issuer = threadIdx.x % 128 == 0;
      if (issuer) s9::bulk_wait_read();   // the last tile's store has read the buffer
      s9::bar_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int col = 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(out + (col / 64) * kBox +
                                       s9::sw128_offset(rw + 8 * rr, col % 64)) =
              s9::pack_bf16(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
        }
      s9::fence_proxy_async();
      s9::bar_sync(1 + wg, 128);
      if (issuer) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          s9::tma_store_2d(tm_o, out + b * kBox, n0 + 64 * b, m0 + 64 * wg);
        s9::bulk_commit();
      }
    } else if (MODE == kDh) {
      // dh rows r0, r0 + 8, columns n0 + 8 j + 2 t: the chunk's products
      // added to the earlier chunks' fp32 sum; the last chunk scales by g
      // and casts
      const float gs = a.last ? *a.g : 1.f;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int n = r0 + 8 * rr;
        if (n >= a.N) continue;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int e = n0 + 8 * j + 2 * t;
          if (e >= a.E) continue;
          const size_t o = (size_t)n * a.E + e;
          float2 v = make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
          if (!a.first) {
            const float2 p = *reinterpret_cast<const float2*>(a.dh_acc + o);
            v.x = p.x + v.x;
            v.y = p.y + v.y;
          }
          if (a.last)
            *reinterpret_cast<__nv_bfloat162*>(a.dh_out + o) =
                __floats2bfloat162_rn(v.x * gs, v.y * gs);
          else
            *reinterpret_cast<float2*>(a.dh_acc + o) = v;
        }
      }
    } else {
      // dW rows c0 + r0, + 8 of the chunk, scaled by g and cast
      const float gs = *a.g;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = r0 + 8 * rr;
        if (m >= a.cw) continue;
        bf16* row = a.dw_out + (size_t)(a.c0 + m) * a.E;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int e = n0 + 8 * j + 2 * t;
          if (e < a.E)
            *reinterpret_cast<__nv_bfloat162*>(row + e) =
                __floats2bfloat162_rn(acc[4 * j + 2 * rr] * gs, acc[4 * j + 2 * rr + 1] * gs);
        }
      }
    }
  }

  if (MODE == kFwd) {   // the segment's partials: m (natural log units), l, the label logit
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int n = r0 + 8 * rr;
      const float l = s9::quad_sum(lrun[rr]), ll = s9::quad_sum(llrun[rr]);
      if (t == 0 && n < a.N) {
        const size_t stride = (size_t)a.nseg * a.N, at = (size_t)blockIdx.y * a.N + n;
        a.part[at] = mrun[rr] * kLn2;
        a.part[stride + at] = l;
        a.part[2 * stride + at] = ll;
      }
    }
  }
  if (MODE == kDlog && threadIdx.x % 128 == 0) s9::bulk_wait();   // the stores have landed
}

// one kernel a mode, so that a profile tells them apart
#define CE_SM90_KERNEL(name, mode)                                                            \
  __global__ void __launch_bounds__(kGemmThreads, 1)                                          \
      name(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b, \
           const __grid_constant__ CUtensorMap tm_o, const CeArgs args) {                     \
    ce_gemm<mode>(&tm_a, &tm_b, &tm_o, args);                                                  \
  }
CE_SM90_KERNEL(ce_fwd_sm90_kernel, kFwd)
CE_SM90_KERNEL(ce_dlog_sm90_kernel, kDlog)
CE_SM90_KERNEL(ce_dh_sm90_kernel, kDh)
CE_SM90_KERNEL(ce_dw_sm90_kernel, kDw)
#undef CE_SM90_KERNEL

template <int MODE, typename KernelFn>
cudaError_t launch_gemm(KernelFn kernel, dim3 grid, const CUtensorMap& ma, const CUtensorMap& mb,
                        const CUtensorMap& mo, const CeArgs& args, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gemm<MODE>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGemmThreads, Gemm<MODE>::SMEM, st>>>(ma, mb, mo, args);
  return counted(cudaGetLastError(), g_launched[kLaunchFwdSm90 + MODE]);
}

CeArgs ce_args(int N, int E, int Vp, int vocab, int ignore, const void* labels) {
  CeArgs a{};
  a.N = N;
  a.E = E;
  a.Vp = Vp;
  a.vocab = vocab;
  a.ignore = ignore;
  a.labels = static_cast<const int*>(labels);
  return a;
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

// The bf16 forward on the tensor cores: h (N, E), w (Vp, E) bf16 with E % 8
// == 0; labels (N,) int32; nll, lse (N,) fp32; part (3, nseg, N) fp32. The
// 256-column vocab tiles split into nseg segments of tps tiles, none empty
// (ops/fused_ce.py, segment_plan). Returns the cudaGetLastError() of the
// launches (ce_fwd_sm90_kernel, ce_fwd_combine).
DS_EXPORT int fused_ce_fwd_sm90(const void* h, const void* w, const void* labels, void* nll,
                                void* lse, void* part, int nseg, int tps, int N, int E, int Vp,
                                int vocab, int ignore, void* stream) {
  const int tiles = (Vp + kTN - 1) / kTN;
  if (N <= 0 || E <= 0 || Vp <= 0 || E % 8 || nseg <= 0 || tps <= 0 ||
      (long long)nseg * tps < tiles || (long long)(nseg - 1) * tps >= tiles)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap mh, mw;
  if (!s9::matrix_map(&mh, h, N, E) || !s9::matrix_map(&mw, w, Vp, E))
    return cudaErrorInvalidValue;
  CeArgs a = ce_args(N, E, Vp, vocab, ignore, labels);
  a.c0 = 0;
  a.cw = Vp;
  a.tiles_per_seg = tps;
  a.nseg = nseg;
  a.part = static_cast<float*>(part);
  const cudaError_t err =
      launch_gemm<kFwd>(ce_fwd_sm90_kernel, dim3((N + kTM - 1) / kTM, nseg), mh, mw, mh, a, st);
  if (err != cudaSuccess) return err;
  return combine(a.part, a.labels, static_cast<float*>(nll), static_cast<float*>(lse), N, nseg,
                 ignore, st);
}

// The bf16 backward on the tensor cores, in chunks of `chunk` vocab columns
// (a multiple of 256; ops/fused_ce.py, chunk_plan): per chunk
// ce_dlog_sm90_kernel (segments of dlog_tps tiles) writes dlog into
// `scratch` (N, chunk) bf16, ce_dh_sm90_kernel adds dlog W_c into dh_acc
// (N, E) fp32 (unused with one chunk), ce_dw_sm90_kernel writes dW_c. dh
// (N, E) and dw (Vp, E) bf16 come out scaled by *g (fp32, device memory).
// lse (N,) fp32 from the forward. Returns the cudaGetLastError() of the
// launches (three a chunk).
DS_EXPORT int fused_ce_bwd_sm90(const void* h, const void* w, const void* labels, const void* lse,
                                const void* g, void* dh, void* dw, void* dh_acc, void* scratch,
                                int chunk, int dlog_tps, int N, int E, int Vp, int vocab,
                                int ignore, void* stream) {
  if (N <= 0 || E <= 0 || Vp <= 0 || E % 8 || chunk <= 0 || chunk % kTN || dlog_tps <= 0 ||
      (Vp > chunk && !dh_acc))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap mh, mw;
  if (!s9::matrix_map(&mh, h, N, E) || !s9::matrix_map(&mw, w, Vp, E))
    return cudaErrorInvalidValue;
  CeArgs a = ce_args(N, E, Vp, vocab, ignore, labels);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.dh_acc = static_cast<float*>(dh_acc);
  a.dh_out = static_cast<bf16*>(dh);
  a.dw_out = static_cast<bf16*>(dw);
  a.tiles_per_seg = dlog_tps;
  const int m_tiles = (N + kTM - 1) / kTM, e_tiles = (E + kTN - 1) / kTN;
  if (m_tiles > 65535) return cudaErrorInvalidValue;   // dh's token tiles are its grid's y
  for (int c0 = 0; c0 < Vp; c0 += chunk) {
    a.c0 = c0;
    a.cw = min(chunk, Vp - c0);
    a.first = c0 == 0;
    a.last = c0 + chunk >= Vp;
    CUtensorMap md;   // dlog of the chunk: (N, cw), rows `chunk` apart
    if (!s9::matrix_map(&md, scratch, N, a.cw, chunk)) return cudaErrorInvalidValue;
    const int nseg = ((a.cw + kTN - 1) / kTN + dlog_tps - 1) / dlog_tps;
    cudaError_t err =
        launch_gemm<kDlog>(ce_dlog_sm90_kernel, dim3(m_tiles, nseg), mh, mw, md, a, st);
    if (err == cudaSuccess)
      err = launch_gemm<kDh>(ce_dh_sm90_kernel, dim3(e_tiles, m_tiles), md, mw, md, a, st);
    if (err == cudaSuccess)
      err = launch_gemm<kDw>(ce_dw_sm90_kernel, dim3(e_tiles, (a.cw + kTM - 1) / kTM), md, mh,
                             md, a, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launches so far of kernel `which` (the order of KERNELS in
// ops/fused_ce.py), counted on the host where each is launched.
DS_EXPORT unsigned long long fused_ce_launched(int which) {
  return which >= 0 && which < kLaunchCount ? g_launched[which].load() : 0;
}
