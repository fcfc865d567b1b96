// Flash-attention backward: dq, dk, dv from the saved forward (q, k, v, the
// per-row log-sum-exp) and the output cotangent.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
// _dqkv_kernel (:182, the default "merged" backward) and the split pair
// _dq_kernel (:93) and _dkv_kernel (:133) (DS_TPU_FLASH_BWD=split).
//
// Computes, per (batch, head), with s = (q * scale) k^T masked as the
// forward masks it (causal keeps q_pos >= k_pos; ragged rows and keys past
// S / Sk are dropped) and p = exp(s - lse):
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - delta),
//   dk = ds^T (q * scale),  dq = scale * ds k.
// delta = rowsum(do * o) (minus the lse cotangent, when there is one) is
// computed by the wrapper. dk carries `scale` through the pre-scaled q, as
// in the TPU kernels. A row with nothing to attend has p = 0 everywhere and
// so gives zero gradients.
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
// zeroed fp32 buffer with atomicAdd. The buffer has the public (B, S, H, D)
// layout, so the wrapper's scale-and-cast to the input dtype is one
// elementwise pass. The atomics add in no fixed order, so dq's last fp32
// bits vary from run to run (the smoke's fp32 tolerance is 1e-4 relative
// for that reason). The split dkv kernel is the same loop without dq; the
// split dq kernel has one block per (query tile, batch * head), loops over
// the key tiles up to the causal limit and sums dq in registers: no
// atomics, deterministic.
//
// Bound on the H100 at the training shape (B = 24, S = 1024, H = 12,
// D = 64, causal, bf16): five S x S x D products over the causal half,
// 5 * 2 * D * S (S + 1) / 2 * B * H = 9.7e10 flops, 0.098 ms at 989
// TFLOP/s. The bytes the function must move, q, k, v, do, lse and delta
// read and dq, dk, dv written in bf16 (0.27 GB), take 0.080 ms at 3.35
// TB/s, so the merged backward is bound by its operations: 0.098 ms. The
// merged design adds its own traffic beyond that bound: the fp32 dq
// buffer, read and written once (0.15 GB, 0.045 ms). This kernel does its
// products on the fp32 CUDA cores from shared memory, like the forward:
// the simple, right first version. Tensor cores (wgmma) are later work.
//
// Design: 256 threads as a 16 x 16 grid. Each block stages its resident
// tile (k, v for the dkv loops; q, do for the dq loop) and then each
// streamed tile in shared memory, rows padded by one float so column reads
// hit distinct banks. A thread owns the scores of rows ty + 16 i and keys
// tx + 16 j, forms s and dp in one pass over D, writes p and ds to shared
// memory, and then accumulates its rows of dk and dv (or dq) over the
// tile. Query tiles are 64 rows and key tiles 64 keys (32 and 32 at
// D = 256, to stay under the 227 KB of shared memory).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// kind: 0 merged (dq into the fp32 buffer, dk, dv), 1 split dkv, 2 split dq
template <typename T, int D, int BQ, int BK>
cudaError_t launch(int kind, const Args& a) {
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
    return cudaGetLastError();
  }
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H);
  if (kind == 0) {
    const auto kernel = flash_bwd_kv_kernel<T, D, BQ, BK, true>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.S, a.Sk, a.H, a.scale, a.causal);
  } else {
    const auto kernel = flash_bwd_kv_kernel<T, D, BQ, BK, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, nullptr,
                                               static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                               a.S, a.Sk, a.H, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int kind, int D, const Args& a) {
  switch (D) {
    case 64:
      return launch<T, 64, 64, 64>(kind, a);
    case 128:
      return launch<T, 128, 64, 64>(kind, a);
    case 256:
      return launch<T, 256, 32, 32>(kind, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(int kind, const Args& a, int D, int dtype) {
  if (dtype == ds::kBFloat16) return by_dim<ds::bf16>(kind, D, a);
  if (dtype == ds::kFloat32) return by_dim<float>(kind, D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

DS_DEFINE_ERROR_STRING

// Every entry: q, do (B, S, H, D) and k, v (B, Sk, H, D) contiguous, of one
// dtype; lse and delta (B * H, 1, S) fp32. Each returns the
// cudaGetLastError() of its launch.

// Merged: dq_acc (B, S, H, D) fp32, ZEROED by the caller, receives
// sum(ds k) unscaled; dk, dv (B, Sk, H, D) in the input dtype.
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
