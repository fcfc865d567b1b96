// Flash-attention backward: dq, dk, dv from the saved forward (q, k, v, the
// per-row log-sum-exp) and the output cotangent.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
// _dqkv_kernel (:182, the default "merged" backward) and the split pair
// _dq_kernel (:93) and _dkv_kernel (:133) (DS_TPU_FLASH_BWD=split).
//
// Computes, per (batch, head), with s = q k^T masked as the forward masks
// it (causal keeps q_pos >= k_pos; ragged rows and keys past S / Sk are
// dropped) and p = exp(scale s - lse):
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - delta),
//   dk = scale * ds^T q,  dq = scale * ds k.
// delta = rowsum(do * o) (minus the lse cotangent, when there is one). A
// row with nothing to attend has p = 0 everywhere and so gives zero
// gradients.
//
// Layouts (the forward's, csrc/flash_attention.cu): q, do, dq (B, S, H, D);
// k, v, dk, dv (B, Sk, H, D), rows of stride H * D; lse and delta
// (B * H, 1, S) fp32. bf16 or fp32 inputs; D in {64, 128, 256}.
//
// The hazard of the merged TPU kernel: it accumulates dq in one
// VMEM-resident output block that the sequential TPU grid revisits for
// every key block. Hopper runs blocks in parallel and in no order, so
// here the merged kernel has one block per (key tile, batch * head); the
// block keeps its dk and dv in fp32 registers, loops over the query tiles
// from the causal lower bound, and adds its share of dq (ds k) into a
// zeroed fp32 buffer with atomic adds. The buffer has the public
// (B, S, H, D) layout. The adds come in no fixed order, so dq's last fp32
// bits vary from run to run (the smoke's fp32 tolerance is 1e-4 relative
// for that reason). Two small kernels around it belong to the merged
// backward: flash_bwd_prep_kernel forms delta in fp32 and zeroes the dq
// buffer (the split pair takes its delta too), flash_bwd_dq_cast_kernel
// writes dq = scale * buffer in the input dtype.
//
// Bound on the H100 at the training shape (B = 24, S = 1024, H = 12,
// D = 64, causal, bf16): five S x S x D products over the causal half,
// 5 * 2 * D * S (S + 1) / 2 * B * H = 9.7e10 flops, 0.098 ms at 989
// TFLOP/s. The bytes the function must move, q, k, v, do, lse and delta
// read and dq, dk, dv written in bf16 (0.27 GB), take 0.080 ms at 3.35
// TB/s, so the merged backward is bound by its operations: 0.098 ms. The
// merged design adds its own traffic beyond that bound: the fp32 dq
// buffer, read and written once (0.15 GB, 0.045 ms).
//
// Merged, bf16: flash_bwd_sm90_kernel, on the tensor cores (wgmma; the
// layouts are flash_sm90.cuh's). wgmma, not mma.sync: the products read
// their operands straight from the TMA-written swizzled tiles, and p^T /
// ds^T need one bf16 store each. 256 threads, two warpgroups, no producer
// warp: at D = 256 the accumulators need nearly all 255 registers a
// thread, which a 288-thread block cannot give. Its key tile (k, v) is
// resident; the query tiles (q, do, and the tile's lse and delta) stream
// through a ring of two stages by TMA, thread 0 issuing tile j + 2 as soon
// as both warpgroups are done with tile j, so one tile's copy overlaps the
// next one's products. Per query tile of 64 rows:
// - s^T = k q^T and dp^T = v do^T (wgmma, k / v and q / do K-major), keys
//   in the accumulator's rows and queries in its columns;
// - p^T = exp2(s^T scale log2(e) - lse log2(e)) and ds^T = p^T (dp^T -
//   delta) in fp32 registers, masked only on tiles that cross S, Sk or the
//   diagonal, stored as bf16 in shared memory (p and ds enter the tensor
//   cores as bf16, as in every flash-attention backward);
// - dv += p^T do and dk += ds^T q (p^T / ds^T K-major, do / q MN-major),
//   and this tile's dq share ds k (ds read from ds^T MN-major, k
//   MN-major).
// The dq share goes to the fp32 buffer as a TMA reduce-add: staged in
// shared memory (fp32, swizzled), one cp.reduce.async.bulk per 32 columns,
// added in L2 element by element. Per-element red.global.add, tried first,
// took most of the kernel's time (a development variant without it ran
// several times faster); at D = 256 the staging buffer does not fit beside
// the rest (64 KB), so that case keeps red.global.add.
// D = 64: key tiles of 128, each warpgroup owning 64 keys (its s^T holds
// all 64 queries); both warpgroups' dq shares cover the same rows and
// columns and are summed in shared memory before the one reduce. D = 128
// and 256: key tiles of 64 (dk and dv at D = 256 alone take 128 registers a
// warpgroup thread): the two warpgroups split s^T and dp^T by query halves
// and dk, dv and dq by column halves. scale multiplies the fp32
// accumulators only (dk in the epilogue, dq in the cast): nothing is
// pre-scaled in bf16. Shared memory: 114 KB at D = 64, 146 KB at D = 128,
// 210 KB at D = 256.
//
// Split, bf16: flash_bwd_dq_sm90_kernel and flash_bwd_dkv_sm90_kernel, on
// the tensor cores with flash_sm90.cuh's layouts, and with the TPU split
// kernels' numerics: those form every product from fp32 operands, so here p
// and ds enter the tensor cores as a bf16 hi + lo pair, hi = bf16(x) and lo
// = bf16(x - hi) (x - hi is exact in fp32). q, k, v and do are exact bf16,
// so each product p X = p_hi X + p_lo X is exact and summed in fp32 in one
// accumulator; what is left out, |x - hi - lo| <= 2^-18 |x|, lies under the
// 1e-5 per addend of an fp32 sum in another order. There is no switch that
// turns the lo part off. scale multiplies fp32 values only (s before the
// exp2, dq and dk in the epilogues).
// - dq kernel: one block per (64-row query tile, batch * head), the longest
//   causal rows first; one consumer warpgroup and one producer warp. q and
//   do stay resident, lse and delta in registers; k and v stream by TMA
//   through a ring of two stages up to the causal limit min(Sk, q0 + 64).
//   Per 64-key tile: s = q k^T and dp = do v^T (k / v and q / do K-major),
//   p and ds in fp32 registers (masked only on tiles that cross S, Sk or the
//   diagonal), ds split into the register-A fragments of dq += ds_hi k +
//   ds_lo k (k MN-major). dq is summed in registers and written once as
//   scale * dq: no fp32 buffer, no atomics, deterministic.
// - dkv kernel: the merged kernel's loop without its dq share (key tiles
//   of 128 at D = 64, each warpgroup owning 64 keys; of 64 at D = 128 and
//   256, the warpgroups splitting s^T and dp^T by query halves and dk, dv by
//   column halves). p^T and ds^T, hi and lo, go through shared memory at
//   every D (four K-major tiles): dv += p^T_hi do + p^T_lo do, dk += ds^T_hi
//   q + ds^T_lo q. Deterministic too.
// Bounds at the training shape (the function's work: dq 3 products, dkv
// 4): 0.0587 and 0.0782 ms, both by operations; the hi + lo design does 4
// and 6, a floor of 0.0782 and 0.1174 ms. Shared memory: dq 49 / 97 / 193
// KB, dkv 130 / 130 / 226 KB at D = 64 / 128 / 256.
//
// fp32: flash_bwd_kv_kernel (merged and split dkv) and flash_bwd_dq_kernel,
// products on the fp32 CUDA cores, the card's exact fp32 reference (the
// fp32 engines and the gates that compare bf16 runs against them go
// through it); no bf16 tensor reaches them. 256 threads as a 16 x 16 grid;
// each block stages its resident tile (k, v for the dkv loops; q, do for
// the dq loop) and then each streamed tile in shared memory as fp32, rows
// padded by one float. A thread owns the scores of rows ty + 16 i and keys
// tx + 16 j, forms s and dp in one pass over D, writes p and ds to shared
// memory, and then accumulates its rows of dk and dv (or dq) over the tile.
// Query tiles are 64 rows and key tiles 64 keys (32 and 32 at D = 256). dk
// carries scale through the pre-scaled q (fp32), as in the TPU kernels. The
// split dkv kernel is the merged loop without dq; the split dq kernel has
// one block per (query tile, batch * head), loops over the key tiles up to
// the causal limit and sums dq in registers: no atomics, deterministic.
#include "common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int kThreads = 256;

// launches by kernel: 0 flash_bwd_sm90_kernel, 1 flash_bwd_kv_kernel (fp32
// merged and split dkv), 2 flash_bwd_dq_kernel (fp32 split dq), 3
// flash_bwd_dq_sm90_kernel, 4 flash_bwd_dkv_sm90_kernel
constexpr int kCounted = 5;
std::atomic<unsigned long long> g_launched[kCounted];

template <int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  // q, do (BQ rows) and k, v (BK rows) padded; p, ds (BQ x BK) padded;
  // lse and delta of the query tile
  return sizeof(float) * (2 * (size_t)BQ * (D + 1) + 2 * (size_t)BK * (D + 1) +
                          2 * (size_t)BQ * (BK + 1) + 2 * (size_t)BQ);
}

struct Smem {
  float *q, *dout, *k, *v, *p, *ds, *lse, *delta;
};

template <int D, int BQ, int BK>
__device__ __forceinline__ Smem carve(float* base) {
  constexpr int QS = D + 1, PS = BK + 1;
  Smem m;
  m.q = base;
  m.dout = m.q + BQ * QS;
  m.k = m.dout + BQ * QS;
  m.v = m.k + BK * QS;
  m.p = m.v + BK * QS;
  m.ds = m.p + BQ * PS;
  m.lse = m.ds + BQ * PS;
  m.delta = m.lse + BQ;
  return m;
}

// Rows [r0, r0 + R) of a (rows, H, D) head slice into shared memory as
// fp32 times `mul`, zeros past `rows`.
template <typename T, int D, int R>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int rows,
                                      size_t row_stride, float mul) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * (D + 1) + d] = s < rows ? ds::to_float(src[(size_t)s * row_stride + d]) * mul : 0.f;
  }
}

// s = q k^T and dp = do v^T for the staged tiles, then p = exp(s - lse)
// and ds = p (dp - delta) into shared memory, masked as the forward masks.
template <int D, int BQ, int BK>
__device__ __forceinline__ void probs_and_ds(const Smem& m, int q0, int k0, int S, int Sk,
                                             int causal) {
  constexpr int QS = D + 1, PS = BK + 1, RQ = BQ / 16, RK = BK / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RQ][RK], dp[RQ][RK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RQ], ov[RQ], kv[RK], vv[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = m.q[(ty + 16 * i) * QS + d];
      ov[i] = m.dout[(ty + 16 * i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      kv[j] = m.k[(tx + 16 * j) * QS + d];
      vv[j] = m.v[(tx + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i, q_pos = q0 + r;
    const float lse = m.lse[r], delta = m.delta[r];
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int c = tx + 16 * j, k_pos = k0 + c;
      const bool live = q_pos < S && k_pos < Sk && !(causal && k_pos > q_pos);
      const float p = live ? expf(s[i][j] - lse) : 0.f;
      m.p[r * PS + c] = p;
      m.ds[r * PS + c] = p * (dp[i][j] - delta);
    }
  }
}

// One block per (key tile, batch * head): dk and dv for its keys, and
// (kDQ, the merged kernel) each query tile's ds k added into dq_acc.
template <typename T, int D, int BQ, int BK, bool kDQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq_acc,
                    T* __restrict__ dk, T* __restrict__ dv, int S, int Sk, int H, float scale,
                    int causal) {
  constexpr int QS = D + 1, PS = BK + 1, RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  const Smem m = carve<D, BQ, BK>(smem);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const size_t row_stride = (size_t)H * D;
  const size_t q_off = (size_t)b * S * row_stride + (size_t)h * D;
  const size_t k_off = (size_t)b * Sk * row_stride + (size_t)h * D;

  stage<T, D, BK>(m.k, k + k_off, k0, Sk, row_stride, 1.f);
  stage<T, D, BK>(m.v, v + k_off, k0, Sk, row_stride, 1.f);

  float dk_acc[RK][RD], dv_acc[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) dk_acc[i][dd] = dv_acc[i][dd] = 0.f;

  // query rows below k0 see none of this tile's keys under the causal mask
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous query tile is no longer read
    stage<T, D, BQ>(m.q, q + q_off, q0, S, row_stride, scale);
    stage<T, D, BQ>(m.dout, dout + q_off, q0, S, row_stride, 1.f);
    for (int r = tid; r < BQ; r += kThreads) {
      const int s = q0 + r;
      m.lse[r] = s < S ? lse[(size_t)bh * S + s] : 0.f;
      m.delta[r] = s < S ? delta[(size_t)bh * S + s] : 0.f;
    }
    __syncthreads();
    probs_and_ds<D, BQ, BK>(m, q0, k0, S, Sk, causal);
    __syncthreads();

    // dv += p^T do and dk += ds^T q over the tile's rows
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[RK], sv[RK], ov[RD], qv[RD];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pv[i] = m.p[r * PS + ty + 16 * i];
        sv[i] = m.ds[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) {
        ov[dd] = m.dout[r * QS + tx + 16 * dd];
        qv[dd] = m.q[r * QS + tx + 16 * dd];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) {
          dv_acc[i][dd] = fmaf(pv[i], ov[dd], dv_acc[i][dd]);
          dk_acc[i][dd] = fmaf(sv[i], qv[dd], dk_acc[i][dd]);
        }
    }

    if constexpr (kDQ) {
      // this key tile's share of dq for the query tile: ds k
      float acc[RQ][RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) acc[i][dd] = 0.f;
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float sv[RQ], kv[RD];
#pragma unroll
        for (int i = 0; i < RQ; ++i) sv[i] = m.ds[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) kv[dd] = m.k[c * QS + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int dd = 0; dd < RD; ++dd) acc[i][dd] = fmaf(sv[i], kv[dd], acc[i][dd]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row < S) {
          float* dst = dq_acc + q_off + (size_t)row * row_stride;
#pragma unroll
          for (int dd = 0; dd < RD; ++dd) atomicAdd(dst + tx + 16 * dd, acc[i][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < Sk) {
      const size_t o = k_off + (size_t)row * row_stride;
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) {
        dk[o + tx + 16 * dd] = ds::from_float<T>(dk_acc[i][dd]);
        dv[o + tx + 16 * dd] = ds::from_float<T>(dv_acc[i][dd]);
      }
    }
  }
}

// One block per (query tile, batch * head): dq = scale * sum over the key
// tiles up to the causal limit of ds k, in registers.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int Sk, int H,
                    float scale, int causal) {
  constexpr int QS = D + 1, PS = BK + 1, RQ = BQ / 16, RD = D / 16;
  extern __shared__ float smem[];
  const Smem m = carve<D, BQ, BK>(smem);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const size_t row_stride = (size_t)H * D;
  const size_t q_off = (size_t)b * S * row_stride + (size_t)h * D;
  const size_t k_off = (size_t)b * Sk * row_stride + (size_t)h * D;

  stage<T, D, BQ>(m.q, q + q_off, q0, S, row_stride, scale);
  stage<T, D, BQ>(m.dout, dout + q_off, q0, S, row_stride, 1.f);
  for (int r = tid; r < BQ; r += kThreads) {
    const int s = q0 + r;
    m.lse[r] = s < S ? lse[(size_t)bh * S + s] : 0.f;
    m.delta[r] = s < S ? delta[(size_t)bh * S + s] : 0.f;
  }

  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) acc[i][dd] = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous key tile is no longer read
    stage<T, D, BK>(m.k, k + k_off, k0, Sk, row_stride, 1.f);
    stage<T, D, BK>(m.v, v + k_off, k0, Sk, row_stride, 1.f);
    __syncthreads();
    probs_and_ds<D, BQ, BK>(m, q0, k0, S, Sk, causal);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RQ], kv[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = m.ds[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) kv[dd] = m.k[c * QS + tx + 16 * dd];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) acc[i][dd] = fmaf(sv[i], kv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < S) {
      T* dst = dq + q_off + (size_t)row * row_stride;
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) dst[tx + 16 * dd] = ds::from_float<T>(acc[i][dd] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, S, Sk, H;
  float scale;
  int causal;
  cudaStream_t stream;
};

// fp32 only. kind: 0 merged (dq into the fp32 buffer, dk, dv), 1 split
// dkv, 2 split dq
template <int D, int BQ, int BK>
cudaError_t launch(int kind, const Args& a) {
  using T = float;
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k);
  const T *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (kind == 2) {
    const auto kernel = flash_bwd_dq_kernel<T, D, BQ, BK>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
    kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta,
                                               static_cast<T*>(a.dq), a.S, a.Sk, a.H,
                                               a.scale, a.causal);
    return ds::sm90::counted(cudaGetLastError(), g_launched[2]);
  }
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H);
  const auto kernel = kind == 0 ? flash_bwd_kv_kernel<T, D, BQ, BK, true>
                                : flash_bwd_kv_kernel<T, D, BQ, BK, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, kind == 0 ? static_cast<float*>(a.dq) : nullptr,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.Sk, a.H, a.scale, a.causal);
  return ds::sm90::counted(cudaGetLastError(), g_launched[1]);
}

// ---- bf16 merged: flash_bwd_sm90_kernel -----------------------------------

using namespace ds::sm90;

template <int D, int BK>
struct Sm90Bwd {
  static constexpr bool kOwnKeys = BK == 128;  // each warpgroup owns 64 of the keys
  static constexpr int BQ = 64, KB = D / 64, STAGES = 2, THREADS = 256;
  static constexpr int NQ = kOwnKeys ? 64 : 32;     // queries of a warpgroup's s^T
  static constexpr int DN = kOwnKeys ? D : D / 2;   // dk, dv, dq columns of a warpgroup
  static constexpr int KV_BYTES = BK * D * 2;       // k or v
  static constexpr int Q_BYTES = BQ * D * 2;        // q or do, one stage
  static constexpr int P_BYTES = BK * BQ * 2;       // p^T or ds^T
  static constexpr int OFF_Q = 2 * KV_BYTES;        // stage s: q, then do
  static constexpr int OFF_P = OFF_Q + STAGES * 2 * Q_BYTES, OFF_DS = OFF_P + P_BYTES;
  // dq shares staged for the TMA reduce-add: fp32 [D / 32][64][32], swizzled
  // (at D = 256 they do not fit beside the rest: red.global.add instead)
  static constexpr bool kStageDq = D < 256;
  static constexpr int OFF_DQ = OFF_DS + P_BYTES;
  static constexpr int OFF_ROW = OFF_DQ + (kStageDq ? BQ * D * 4 : 0);  // stage s: lse, delta
  static constexpr int OFF_BAR = OFF_ROW + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = 1024 + OFF_BAR + (STAGES + 1) * 8;
  static constexpr uint32_t STAGE_TX = 2 * Q_BYTES + 2 * BQ * 4;
};

template <int D, int BK>
__global__ void __launch_bounds__(256, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_lse,
                      const __grid_constant__ CUtensorMap tm_delta,
                      const __grid_constant__ CUtensorMap tm_dq, float* __restrict__ dq_acc,
                      ds::bf16* __restrict__ dk, ds::bf16* __restrict__ dv, int S, int Sk, int H,
                      float scale, int causal) {
  using C = Sm90Bwd<D, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  ds::bf16* sK = reinterpret_cast<ds::bf16*>(sm);
  ds::bf16* sV = reinterpret_cast<ds::bf16*>(sm + C::KV_BYTES);
  ds::bf16* sP = reinterpret_cast<ds::bf16*>(sm + C::OFF_P);
  ds::bf16* sDS = reinterpret_cast<ds::bf16*>(sm + C::OFF_DS);
  float* sDQ = reinterpret_cast<float*>(sm + C::OFF_DQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* kvbar = full + C::STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;  // causal: the low key tiles see the most query tiles
  const int q_begin = causal ? (k0 / C::BQ) * C::BQ : 0;
  const int n_q = S > q_begin ? (S - q_begin + C::BQ - 1) / C::BQ : 0;

  auto stage_q = [&](int s) {
    return reinterpret_cast<ds::bf16*>(sm + C::OFF_Q + s * 2 * C::Q_BYTES);
  };
  auto stage_row = [&](int s) {
    return reinterpret_cast<float*>(sm + C::OFF_ROW + s * 2 * C::BQ * 4);
  };
  auto load_q_tile = [&](int j) {  // query tile j into stage j % 2 (thread 0 only)
    const int s = j % C::STAGES, qq = q_begin + j * C::BQ;
    ds::bf16* q_s = stage_q(s);
    ds::bf16* do_s = q_s + C::BQ * D;
    float* row_s = stage_row(s);
    mbar_expect_tx(&full[s], C::STAGE_TX);
    for (int c = 0; c < C::KB; ++c) {
      tma_load_4d(q_s + c * C::BQ * 64, &tm_q, &full[s], c * 64, h, qq, b);
      tma_load_4d(do_s + c * C::BQ * 64, &tm_do, &full[s], c * 64, h, qq, b);
    }
    tma_load_2d(row_s, &tm_lse, &full[s], bh * S + qq, 0);
    tma_load_2d(row_s + C::BQ, &tm_delta, &full[s], bh * S + qq, 0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
    for (int c = 0; c < C::KB; ++c) {
      tma_load_4d(sK + c * BK * 64, &tm_k, kvbar, c * 64, h, k0, b);
      tma_load_4d(sV + c * BK * 64, &tm_v, kvbar, c * 64, h, k0, b);
    }
    for (int j = 0; j < min(n_q, C::STAGES); ++j) load_q_tile(j);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4, t = lane % 4;
  const int wrow = 16 * (warp % 4) + lane / 4;    // accumulator rows: wrow, wrow + 8
  const int kr = C::kOwnKeys ? 64 * wg : 0;       // this warpgroup's keys [kr, kr + 64)
  const int qc = C::kOwnKeys ? 0 : 32 * wg;       // its s^T query columns [qc, qc + NQ)
  const int dc = C::kOwnKeys ? 0 : wg * (D / 2);  // its dk, dv, dq columns [dc, dc + DN)
  const float scale_log2 = scale * kLog2e;

  float dk_acc[C::DN / 2], dv_acc[C::DN / 2];
#pragma unroll
  for (int i = 0; i < C::DN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_q; ++j) {
    const int s = j % C::STAGES, qq = q_begin + j * C::BQ;
    const ds::bf16* q_s = stage_q(s);
    const ds::bf16* do_s = q_s + C::BQ * D;
    const float* row_s = stage_row(s);
    mbar_wait(&full[s], (j / C::STAGES) & 1);

    // s^T = k q^T and dp^T = v do^T: keys [kr, kr + 64) x queries [qc, qc + NQ)
    float st[C::NQ / 2], dpt[C::NQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ok = (kk / 4) * BK * 64 + kr * 64 + (kk % 4) * 16;
      const int oq = (kk / 4) * C::BQ * 64 + qc * 64 + (kk % 4) * 16;
      wgmma_ss<C::NQ, 0, 0>(st, kmajor_desc(sK + ok), kmajor_desc(q_s + oq), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ok = (kk / 4) * BK * 64 + kr * 64 + (kk % 4) * 16;
      const int oq = (kk / 4) * C::BQ * 64 + qc * 64 + (kk % 4) * 16;
      wgmma_ss<C::NQ, 0, 0>(dpt, kmajor_desc(sV + ok), kmajor_desc(do_s + oq), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // p^T and ds^T, stored to shared memory as bf16
    const bool edge = qq + C::BQ > S || k0 + BK > Sk || (causal && k0 + BK - 1 > qq);
#pragma unroll
    for (int i = 0; i < C::NQ / 2; ++i) {
      const int col = qc + 8 * (i / 4) + 2 * t + (i % 2);  // query within the tile
      const int key = k0 + kr + wrow + 8 * ((i / 2) % 2);
      float p = exp2f(fmaf(st[i], scale_log2, -row_s[col] * kLog2e));
      if (edge && (qq + col >= S || key >= Sk || (causal && key > qq + col))) p = 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - row_s[C::BQ + col]);
    }
#pragma unroll
    for (int i = 0; i < C::NQ / 2; i += 2) {
      const int row = kr + wrow + 8 * ((i / 2) % 2), col = qc + 8 * (i / 4) + 2 * t;
      const int off = sw128_offset(row, col);
      *reinterpret_cast<uint32_t*>(sP + off) = pack_bf16(st[i], st[i + 1]);
      *reinterpret_cast<uint32_t*>(sDS + off) = pack_bf16(dpt[i], dpt[i + 1]);
    }
    // the previous tile's dq reduce has read sDQ before anyone writes it again
    if (C::kStageDq && threadIdx.x % 128 == 0) bulk_wait_read();
    fence_proxy_async();
    __syncthreads();  // both warpgroups' p^T and ds^T are in place

    // dv += p^T do, dk += ds^T q: keys [kr, kr + 64) x columns [dc, dc + DN);
    // dq share = ds k over keys [kr, kr + 64): queries x columns [dc, dc + DN)
    float dq[C::DN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk) {
      const int op = kr * 64 + kk * 16;
      const int oq = (dc / 64) * C::BQ * 64 + kk * 16 * 64;
      wgmma_ss<C::DN, 0, 1>(dv_acc, kmajor_desc(sP + op), mnmajor_desc(do_s + oq, C::BQ * 128), 1);
      wgmma_ss<C::DN, 0, 1>(dk_acc, kmajor_desc(sDS + op), mnmajor_desc(q_s + oq, C::BQ * 128), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int od = (kr + 16 * kk) * 64;
      const int ok = (dc / 64) * BK * 64 + (kr + 16 * kk) * 64;
      wgmma_ss<C::DN, 1, 1>(dq, mnmajor_desc(sDS + od, BK * 128), mnmajor_desc(sK + ok, BK * 128),
                            kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq);
    if constexpr (C::kStageDq) {
      // this tile's dq share: into sDQ (at D = 64 the two warpgroups' shares
      // summed there first), then one TMA reduce-add per 32 columns
      auto stage_dq = [&](bool add) {
#pragma unroll
        for (int i = 0; i < C::DN / 2; i += 2) {
          const int row = wrow + 8 * ((i / 2) % 2), col = dc + 8 * (i / 4) + 2 * t;
          float2* p = reinterpret_cast<float2*>(sDQ + (col / 32) * C::BQ * 32 +
                                                sw128_offset_f32(row, col % 32));
          const float2 prev = add ? *p : make_float2(0.f, 0.f);
          *p = make_float2(prev.x + dq[i], prev.y + dq[i + 1]);
        }
      };
      const bool reducer = C::kOwnKeys ? wg == 1 : true;
      if (C::kOwnKeys && wg == 0) stage_dq(false);
      __syncthreads();  // stage s, p^T and ds^T are free (and warpgroup 0's share is in)
      if (threadIdx.x == 0 && j + C::STAGES < n_q) load_q_tile(j + C::STAGES);
      if (reducer) {
        stage_dq(C::kOwnKeys);
        fence_proxy_async();
        bar_sync(1 + wg, 128);
        if (threadIdx.x % 128 == 0) {
          for (int c = dc / 32; c < (dc + C::DN) / 32; ++c)
            tma_reduce_add_4d(&tm_dq, sDQ + c * C::BQ * 32, c * 32, h, qq, b);
          bulk_commit();
        }
      }
    } else {
      __syncthreads();  // stage s, p^T and ds^T are free
      if (threadIdx.x == 0 && j + C::STAGES < n_q) load_q_tile(j + C::STAGES);
      const size_t row_stride = (size_t)H * D;
      float* dq_b = dq_acc + (size_t)b * S * row_stride + (size_t)h * D + dc;
#pragma unroll
      for (int i = 0; i < C::DN / 2; ++i) {
        const int row = qq + wrow + 8 * ((i / 2) % 2);
        if (row < S)
          atomicAdd(dq_b + (size_t)row * row_stride + 8 * (i / 4) + 2 * t + (i % 2), dq[i]);
      }
    }
  }
  // the last reduce has finished with shared memory before the block exits
  if (C::kStageDq && threadIdx.x % 128 == 0) bulk_wait();

  const size_t row_stride = (size_t)H * D;
  const size_t off = (size_t)b * Sk * row_stride + (size_t)h * D + dc;
#pragma unroll
  for (int i = 0; i < C::DN / 2; i += 2) {
    const int key = k0 + kr + wrow + 8 * ((i / 2) % 2);
    if (key < Sk) {
      const size_t o = off + (size_t)key * row_stride + 8 * (i / 4) + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(scale * dk_acc[i], scale * dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D, int BK>
cudaError_t launch_sm90(const Args& a) {
  using C = Sm90Bwd<D, BK>;
  CUtensorMap mq, mk, mv, mdo, mlse, mdelta, mdq;
  const size_t rows = (size_t)a.B * a.H * a.S;
  if (!head_map(&mq, a.q, a.B, a.S, a.H, D, C::BQ) || !head_map(&mk, a.k, a.B, a.Sk, a.H, D, BK) ||
      !head_map(&mv, a.v, a.B, a.Sk, a.H, D, BK) ||
      !head_map(&mdo, a.dout, a.B, a.S, a.H, D, C::BQ) || !row_map(&mlse, a.lse, rows) ||
      !row_map(&mdelta, a.delta, rows) || !head_map(&mdq, a.dq, a.B, a.S, a.H, D, C::BQ, true))
    return cudaErrorInvalidValue;
  const auto kernel = flash_bwd_sm90_kernel<D, BK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sk + BK - 1) / BK);
  kernel<<<grid, C::THREADS, C::SMEM, a.stream>>>(
      mq, mk, mv, mdo, mlse, mdelta, mdq, static_cast<float*>(a.dq), static_cast<ds::bf16*>(a.dk),
      static_cast<ds::bf16*>(a.dv), a.S, a.Sk, a.H, a.scale, a.causal);
  return counted(cudaGetLastError(), g_launched[0]);
}

cudaError_t merged_sm90(int D, const Args& a) {
  switch (D) {
    case 64:
      return launch_sm90<64, 128>(a);
    case 128:
      return launch_sm90<128, 64>(a);
    case 256:
      return launch_sm90<256, 64>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- bf16 split: flash_bwd_dq_sm90_kernel, flash_bwd_dkv_sm90_kernel ------

template <int D>
struct Sm90Dq {
  static constexpr int BQ = 64, BK = 64, KB = D / 64, STAGES = 2;
  static constexpr int THREADS = 128 + 32;  // one consumer warpgroup, one producer warp
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int OFF_KV = 2 * Q_BYTES;  // q, do; then stage s: k, v
  static constexpr int OFF_BAR = OFF_KV + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + OFF_BAR + (2 * STAGES + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(Sm90Dq<D>::THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                         const float* __restrict__ delta, ds::bf16* __restrict__ dq_out, int S,
                         int Sk, int H, float scale, int causal) {
  using C = Sm90Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  ds::bf16* sQ = reinterpret_cast<ds::bf16*>(sm);
  ds::bf16* sDO = sQ + C::BQ * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = full + 2 * C::STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // the longest causal rows first
  const int k_end = causal ? min(Sk, q0 + C::BQ) : Sk;
  const int n_tiles = (k_end + C::BK - 1) / C::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * C::Q_BYTES);
      for (int c = 0; c < C::KB; ++c) {
        tma_load_4d(sQ + c * C::BQ * 64, &tm_q, qbar, c * 64, h, q0, b);
        tma_load_4d(sDO + c * C::BQ * 64, &tm_do, qbar, c * 64, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::STAGES;
        if (j >= C::STAGES) mbar_wait(&empty[s], ((j / C::STAGES) - 1) & 1);
        ds::bf16* sK = reinterpret_cast<ds::bf16*>(sm + C::OFF_KV + s * 2 * C::KV_BYTES);
        ds::bf16* sV = sK + C::BK * D;
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        for (int c = 0; c < C::KB; ++c) {
          tma_load_4d(sK + c * C::BK * 64, &tm_k, &full[s], c * 64, h, j * C::BK, b);
          tma_load_4d(sV + c * C::BK * 64, &tm_v, &full[s], c * 64, h, j * C::BK, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: accumulator rows are the queries wrow, wrow + 8
  const int t = lane % 4, wrow = 16 * warp + lane / 4;
  const float scale_log2 = scale * kLog2e;
  float lse_l2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + 8 * r;
    lse_l2[r] = row < S ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
    dlt[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES, k0 = j * C::BK;
    const ds::bf16* sK = reinterpret_cast<const ds::bf16*>(sm + C::OFF_KV + s * 2 * C::KV_BYTES);
    const ds::bf16* sV = sK + C::BK * D;
    mbar_wait(&full[s], (j / C::STAGES) & 1);

    // s = q k^T and dp = do v^T: queries x keys
    float st[C::BK / 2], dp[C::BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<C::BK, 0, 0>(st, kmajor_desc(sQ + (kk / 4) * C::BQ * 64 + (kk % 4) * 16),
                            kmajor_desc(sK + (kk / 4) * C::BK * 64 + (kk % 4) * 16), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<C::BK, 0, 0>(dp, kmajor_desc(sDO + (kk / 4) * C::BQ * 64 + (kk % 4) * 16),
                            kmajor_desc(sV + (kk / 4) * C::BK * 64 + (kk % 4) * 16), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dp);

    // p and ds in fp32; ds as the hi and lo A fragments of dq += ds k
    const bool edge = q0 + C::BQ > S || k0 + C::BK > Sk || (causal && k0 + C::BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) {
      const int r = (i / 2) % 2, row = q0 + wrow + 8 * r;
      const int key = k0 + 8 * (i / 4) + 2 * t + (i % 2);
      float p = exp2f(fmaf(st[i], scale_log2, -lse_l2[r]));
      if (edge && (row >= S || key >= Sk || (causal && key > row))) p = 0.f;
      dp[i] = p * (dp[i] - dlt[r]);
    }
    uint32_t hi[C::BK / 16][4], lo[C::BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        split_hi_lo(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1], hi[kk][x], lo[kk][x]);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      const uint64_t dk_ = mnmajor_desc(sK + kk * 16 * 64, C::BK * 128);
      wgmma_rs<D, 1>(dq, hi[kk], dk_, 1);
      wgmma_rs<D, 1>(dq, lo[kk], dk_, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t row_stride = (size_t)H * D;
  ds::bf16* ob = dq_out + (size_t)b * S * row_stride + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + 8 * r;
    if (row < S) {
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * row_stride + 8 * jj + 2 * t) =
            __floats2bfloat162_rn(scale * dq[4 * jj + 2 * r], scale * dq[4 * jj + 2 * r + 1]);
    }
  }
}

template <int D, int BK>
struct Sm90Dkv {
  static constexpr bool kOwnKeys = BK == 128;  // each warpgroup owns 64 of the keys
  static constexpr int BQ = 64, KB = D / 64, STAGES = 2, THREADS = 256;
  static constexpr int NQ = kOwnKeys ? 64 : 32;     // queries of a warpgroup's s^T
  static constexpr int DN = kOwnKeys ? D : D / 2;   // dk, dv columns of a warpgroup
  static constexpr int KV_BYTES = BK * D * 2;       // k or v
  static constexpr int Q_BYTES = BQ * D * 2;        // q or do, one stage
  static constexpr int P_ELEMS = BK * BQ;           // one of p^T hi, p^T lo, ds^T hi, ds^T lo
  static constexpr int OFF_Q = 2 * KV_BYTES;        // stage s: q, then do
  static constexpr int OFF_P = OFF_Q + STAGES * 2 * Q_BYTES;  // p^T hi, lo; ds^T hi, lo
  static constexpr int OFF_ROW = OFF_P + 4 * P_ELEMS * 2;     // stage s: lse, delta
  static constexpr int OFF_BAR = OFF_ROW + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = 1024 + OFF_BAR + (STAGES + 1) * 8;
  static constexpr uint32_t STAGE_TX = 2 * Q_BYTES + 2 * BQ * 4;
};

template <int D, int BK>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_delta, ds::bf16* __restrict__ dk,
                          ds::bf16* __restrict__ dv, int S, int Sk, int H, float scale,
                          int causal) {
  using C = Sm90Dkv<D, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  ds::bf16* sK = reinterpret_cast<ds::bf16*>(sm);
  ds::bf16* sV = reinterpret_cast<ds::bf16*>(sm + C::KV_BYTES);
  ds::bf16* sP = reinterpret_cast<ds::bf16*>(sm + C::OFF_P);  // hi at 0, lo at P_ELEMS
  ds::bf16* sDS = sP + 2 * C::P_ELEMS;                         // likewise
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* kvbar = full + C::STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;  // causal: the low key tiles see the most query tiles
  const int q_begin = causal ? (k0 / C::BQ) * C::BQ : 0;
  const int n_q = S > q_begin ? (S - q_begin + C::BQ - 1) / C::BQ : 0;

  auto stage_q = [&](int s) {
    return reinterpret_cast<ds::bf16*>(sm + C::OFF_Q + s * 2 * C::Q_BYTES);
  };
  auto stage_row = [&](int s) {
    return reinterpret_cast<float*>(sm + C::OFF_ROW + s * 2 * C::BQ * 4);
  };
  auto load_q_tile = [&](int j) {  // query tile j into stage j % 2 (thread 0 only)
    const int s = j % C::STAGES, qq = q_begin + j * C::BQ;
    ds::bf16* q_s = stage_q(s);
    ds::bf16* do_s = q_s + C::BQ * D;
    float* row_s = stage_row(s);
    mbar_expect_tx(&full[s], C::STAGE_TX);
    for (int c = 0; c < C::KB; ++c) {
      tma_load_4d(q_s + c * C::BQ * 64, &tm_q, &full[s], c * 64, h, qq, b);
      tma_load_4d(do_s + c * C::BQ * 64, &tm_do, &full[s], c * 64, h, qq, b);
    }
    tma_load_2d(row_s, &tm_lse, &full[s], bh * S + qq, 0);
    tma_load_2d(row_s + C::BQ, &tm_delta, &full[s], bh * S + qq, 0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(kvbar, 2 * C::KV_BYTES);
    for (int c = 0; c < C::KB; ++c) {
      tma_load_4d(sK + c * BK * 64, &tm_k, kvbar, c * 64, h, k0, b);
      tma_load_4d(sV + c * BK * 64, &tm_v, kvbar, c * 64, h, k0, b);
    }
    for (int j = 0; j < min(n_q, C::STAGES); ++j) load_q_tile(j);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4, t = lane % 4;
  const int wrow = 16 * (warp % 4) + lane / 4;    // accumulator rows: wrow, wrow + 8
  const int kr = C::kOwnKeys ? 64 * wg : 0;       // this warpgroup's keys [kr, kr + 64)
  const int qc = C::kOwnKeys ? 0 : 32 * wg;       // its s^T query columns [qc, qc + NQ)
  const int dc = C::kOwnKeys ? 0 : wg * (D / 2);  // its dk, dv columns [dc, dc + DN)
  const float scale_log2 = scale * kLog2e;

  float dk_acc[C::DN / 2], dv_acc[C::DN / 2];
#pragma unroll
  for (int i = 0; i < C::DN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_q; ++j) {
    const int s = j % C::STAGES, qq = q_begin + j * C::BQ;
    const ds::bf16* q_s = stage_q(s);
    const ds::bf16* do_s = q_s + C::BQ * D;
    const float* row_s = stage_row(s);
    mbar_wait(&full[s], (j / C::STAGES) & 1);

    // s^T = k q^T and dp^T = v do^T: keys [kr, kr + 64) x queries [qc, qc + NQ)
    float st[C::NQ / 2], dpt[C::NQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ok = (kk / 4) * BK * 64 + kr * 64 + (kk % 4) * 16;
      const int oq = (kk / 4) * C::BQ * 64 + qc * 64 + (kk % 4) * 16;
      wgmma_ss<C::NQ, 0, 0>(st, kmajor_desc(sK + ok), kmajor_desc(q_s + oq), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ok = (kk / 4) * BK * 64 + kr * 64 + (kk % 4) * 16;
      const int oq = (kk / 4) * C::BQ * 64 + qc * 64 + (kk % 4) * 16;
      wgmma_ss<C::NQ, 0, 0>(dpt, kmajor_desc(sV + ok), kmajor_desc(do_s + oq), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // p^T and ds^T in fp32, stored to shared memory as bf16 hi and lo
    const bool edge = qq + C::BQ > S || k0 + BK > Sk || (causal && k0 + BK - 1 > qq);
#pragma unroll
    for (int i = 0; i < C::NQ / 2; ++i) {
      const int col = qc + 8 * (i / 4) + 2 * t + (i % 2);  // query within the tile
      const int key = k0 + kr + wrow + 8 * ((i / 2) % 2);
      float p = exp2f(fmaf(st[i], scale_log2, -row_s[col] * kLog2e));
      if (edge && (qq + col >= S || key >= Sk || (causal && key > qq + col))) p = 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - row_s[C::BQ + col]);
    }
#pragma unroll
    for (int i = 0; i < C::NQ / 2; i += 2) {
      const int row = kr + wrow + 8 * ((i / 2) % 2), col = qc + 8 * (i / 4) + 2 * t;
      const int off = sw128_offset(row, col);
      uint32_t hi, lo;
      split_hi_lo(st[i], st[i + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(sP + off) = hi;
      *reinterpret_cast<uint32_t*>(sP + C::P_ELEMS + off) = lo;
      split_hi_lo(dpt[i], dpt[i + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(sDS + off) = hi;
      *reinterpret_cast<uint32_t*>(sDS + C::P_ELEMS + off) = lo;
    }
    fence_proxy_async();
    __syncthreads();  // both warpgroups' p^T and ds^T are in place

    // dv += p^T do, dk += ds^T q, each over hi then lo: keys [kr, kr + 64) x
    // columns [dc, dc + DN)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk) {
      const int op = kr * 64 + kk * 16;
      const int oq = (dc / 64) * C::BQ * 64 + kk * 16 * 64;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        wgmma_ss<C::DN, 0, 1>(dv_acc, kmajor_desc(sP + part * C::P_ELEMS + op), mnmajor_desc(do_s + oq, C::BQ * 128), 1);
        wgmma_ss<C::DN, 0, 1>(dk_acc, kmajor_desc(sDS + part * C::P_ELEMS + op), mnmajor_desc(q_s + oq, C::BQ * 128), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // stage s, p^T and ds^T are free
    if (threadIdx.x == 0 && j + C::STAGES < n_q) load_q_tile(j + C::STAGES);
  }

  const size_t row_stride = (size_t)H * D;
  const size_t off = (size_t)b * Sk * row_stride + (size_t)h * D + dc;
#pragma unroll
  for (int i = 0; i < C::DN / 2; i += 2) {
    const int key = k0 + kr + wrow + 8 * ((i / 2) % 2);
    if (key < Sk) {
      const size_t o = off + (size_t)key * row_stride + 8 * (i / 4) + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(scale * dk_acc[i], scale * dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq_sm90(const Args& a) {
  using C = Sm90Dq<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (!head_map(&mq, a.q, a.B, a.S, a.H, D, C::BQ) ||
      !head_map(&mk, a.k, a.B, a.Sk, a.H, D, C::BK) ||
      !head_map(&mv, a.v, a.B, a.Sk, a.H, D, C::BK) ||
      !head_map(&mdo, a.dout, a.B, a.S, a.H, D, C::BQ))
    return cudaErrorInvalidValue;
  const auto kernel = flash_bwd_dq_sm90_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::THREADS, C::SMEM, a.stream>>>(mq, mk, mv, mdo, a.lse, a.delta,
                                                  static_cast<ds::bf16*>(a.dq), a.S, a.Sk, a.H,
                                                  a.scale, a.causal);
  return counted(cudaGetLastError(), g_launched[3]);
}

template <int D, int BK>
cudaError_t launch_dkv_sm90(const Args& a) {
  using C = Sm90Dkv<D, BK>;
  CUtensorMap mq, mk, mv, mdo, mlse, mdelta;
  const size_t rows = (size_t)a.B * a.H * a.S;
  if (!head_map(&mq, a.q, a.B, a.S, a.H, D, C::BQ) || !head_map(&mk, a.k, a.B, a.Sk, a.H, D, BK) ||
      !head_map(&mv, a.v, a.B, a.Sk, a.H, D, BK) ||
      !head_map(&mdo, a.dout, a.B, a.S, a.H, D, C::BQ) || !row_map(&mlse, a.lse, rows) ||
      !row_map(&mdelta, a.delta, rows))
    return cudaErrorInvalidValue;
  const auto kernel = flash_bwd_dkv_sm90_kernel<D, BK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sk + BK - 1) / BK);
  kernel<<<grid, C::THREADS, C::SMEM, a.stream>>>(mq, mk, mv, mdo, mlse, mdelta,
                                                  static_cast<ds::bf16*>(a.dk),
                                                  static_cast<ds::bf16*>(a.dv), a.S, a.Sk, a.H,
                                                  a.scale, a.causal);
  return counted(cudaGetLastError(), g_launched[4]);
}

// kind: 1 split dkv, 2 split dq
cudaError_t split_sm90(int kind, int D, const Args& a) {
  switch (D) {
    case 64:
      return kind == 1 ? launch_dkv_sm90<64, 128>(a) : launch_dq_sm90<64>(a);
    case 128:
      return kind == 1 ? launch_dkv_sm90<128, 64>(a) : launch_dq_sm90<128>(a);
    case 256:
      return kind == 1 ? launch_dkv_sm90<256, 64>(a) : launch_dq_sm90<256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- the merged backward's passes around the kernel ------------------------

// delta = sum(do * o) - dlse in fp32 for each (b, s, h) row, written at
// (b * H + h) * S + s, and the row of the dq buffer zeroed (dq_acc not
// null). D / 8 threads a row, eight elements (16 bytes of bf16) each.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                      const float* __restrict__ dlse, float* __restrict__ delta,
                      float* __restrict__ dq_acc, int S, int H, size_t n_rows) {
  constexpr int L = D / 8;  // threads a row
  const size_t row = (size_t)blockIdx.x * (256 / L) + threadIdx.x / L;
  const int part = threadIdx.x % L;
  float acc = 0.f;
  if (row < n_rows) {
    float x[8], y[8];
    ds::load8(dout + row * D + part * 8, x);
    ds::load8(o + row * D + part * 8, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
    if (dq_acc) {
      float4* z = reinterpret_cast<float4*>(dq_acc + row * D + part * 8);
      z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < n_rows && part == 0) {
    const size_t h = row % H, bs = row / H, s = bs % S, b = bs / S;
    const size_t at = (b * H + h) * S + s;
    delta[at] = dlse ? acc - dlse[at] : acc;
  }
}

template <typename T, int D>
void launch_prep(const T* d, const T* o, const float* dlse, float* delta, float* dq_acc, int S,
                 int H, size_t rows, cudaStream_t st) {
  const dim3 grid((unsigned)((rows * (D / 8) + 255) / 256));
  flash_bwd_prep_kernel<T, D><<<grid, 256, 0, st>>>(d, o, dlse, delta, dq_acc, S, H, rows);
}

template <typename T>
cudaError_t prep(const void* dout, const void* out, const float* dlse, float* delta,
                 float* dq_acc, int B, int S, int H, int D, cudaStream_t st) {
  const size_t rows = (size_t)B * S * H;
  const T *d = static_cast<const T*>(dout), *o = static_cast<const T*>(out);
  switch (D) {
    case 64:
      launch_prep<T, 64>(d, o, dlse, delta, dq_acc, S, H, rows, st);
      break;
    case 128:
      launch_prep<T, 128>(d, o, dlse, delta, dq_acc, S, H, rows, st);
      break;
    case 256:
      launch_prep<T, 256>(d, o, dlse, delta, dq_acc, S, H, rows, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dq = scale * dq_acc in the output dtype, four elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dq_cast_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq, float scale,
                         size_t n4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 v = reinterpret_cast<const float4*>(dq_acc)[i];
  T* d = dq + 4 * i;
  d[0] = ds::from_float<T>(v.x * scale);
  d[1] = ds::from_float<T>(v.y * scale);
  d[2] = ds::from_float<T>(v.z * scale);
  d[3] = ds::from_float<T>(v.w * scale);
}

// fp32: the CUDA-core kernels
cudaError_t by_dim_fp32(int kind, int D, const Args& a) {
  switch (D) {
    case 64:
      return launch<64, 64, 64>(kind, a);
    case 128:
      return launch<128, 64, 64>(kind, a);
    case 256:
      return launch<256, 32, 32>(kind, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(int kind, const Args& a, int D, int dtype) {
  if (dtype == ds::kBFloat16) return kind == 0 ? merged_sm90(D, a) : split_sm90(kind, D, a);
  if (dtype == ds::kFloat32) return by_dim_fp32(kind, D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

DS_DEFINE_ERROR_STRING

// Every entry: q, do (B, S, H, D) and k, v (B, Sk, H, D) contiguous, of one
// dtype; lse and delta (B * H, 1, S) fp32. Each returns the
// cudaGetLastError() of its launch.

// Merged: dq_acc (B, S, H, D) fp32, ZEROED by the caller (the prep entry),
// receives sum(ds k) unscaled (the cast entry scales it); dk, dv
// (B, Sk, H, D) in the input dtype.
DS_EXPORT int flash_attention_bwd_merged(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq_acc, void* dk, void* dv, int B, int S, int Sk,
                                         int H, int D, float scale, int causal, int dtype,
                                         void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq_acc, dk, dv, B, S, Sk, H, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(0, a, D, dtype);
}

// Split, dk and dv: (B, Sk, H, D) in the input dtype.
DS_EXPORT int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int S, int Sk, int H, int D,
                                      float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, B, S, Sk, H, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(1, a, D, dtype);
}

// Split, dq: (B, S, H, D) in the input dtype, scaled.
DS_EXPORT int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int B, int S, int Sk, int H, int D, float scale,
                                     int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, B, S, Sk, H, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(2, a, D, dtype);
}

// delta (B * H, 1, S) fp32 = rowsum(do * o) - dlse (dlse (B * H, 1, S) fp32,
// or null for none); dq_acc (B, S, H, D) fp32 zeroed, unless null. do and o
// (B, S, H, D) contiguous, of one dtype.
DS_EXPORT int flash_attention_bwd_prep(const void* dout, const void* out, const void* dlse,
                                       void* delta, void* dq_acc, int B, int S, int H, int D,
                                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(dlse);
  float *de = static_cast<float*>(delta), *dq = static_cast<float*>(dq_acc);
  if (dtype == ds::kBFloat16) return prep<ds::bf16>(dout, out, dl, de, dq, B, S, H, D, st);
  if (dtype == ds::kFloat32) return prep<float>(dout, out, dl, de, dq, B, S, H, D, st);
  return cudaErrorInvalidValue;
}

// dq (B, S, H, D) in the input dtype = scale * dq_acc (fp32, same shape).
DS_EXPORT int flash_attention_bwd_dq_cast(const void* dq_acc, void* dq, int B, int S, int H,
                                          int D, float scale, int dtype, void* stream) {
  const size_t n4 = (size_t)B * S * H * D / 4;  // D is a multiple of 64
  const dim3 grid((unsigned)((n4 + 255) / 256));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(dq_acc);
  if (dtype == ds::kBFloat16)
    flash_bwd_dq_cast_kernel<ds::bf16><<<grid, 256, 0, st>>>(src, static_cast<ds::bf16*>(dq),
                                                             scale, n4);
  else if (dtype == ds::kFloat32)
    flash_bwd_dq_cast_kernel<float><<<grid, 256, 0, st>>>(src, static_cast<float*>(dq), scale, n4);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Launches so far of kernel `which` (0 flash_bwd_sm90_kernel, 1
// flash_bwd_kv_kernel, 2 flash_bwd_dq_kernel, 3 flash_bwd_dq_sm90_kernel, 4
// flash_bwd_dkv_sm90_kernel), counted on the host where each is launched.
DS_EXPORT unsigned long long flash_attention_bwd_launched(int which) {
  return which >= 0 && which < kCounted ? g_launched[which].load() : 0;
}
