// Block-sparse attention forward over a per-(head, query block) LUT.
//
// Replaces the TPU kernel _pallas_kernel
// (deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py:59).
//
// Computes, per (batch, head, query block qi), out = softmax(q k^T * scale)
// v over the key blocks lut[h, qi, 0 .. counts[h, qi]) only, with an online
// softmax over those blocks so no score matrix exists in memory. Inputs and
// out are (B, S, H, D); lut (H, S / block, max_nnz) and counts
// (H, S / block) are int32, built on the host from the layout. The
// arithmetic is the TPU kernel's: q cast to fp32 and then scaled, scores,
// m, l and acc in fp32, p @ v with p in fp32, one cast at the end. Causal
// mode masks k_pos > q_pos inside the visited blocks; a query block with no
// enabled key block (count 0), or whose every visited key is masked,
// writes zeros (the TPU kernel's l_safe).
//
// Bound on the H100: the work is 4 * nnz * block^2 * D flops per (batch,
// head) against q, k, v and out read or written once (8 * S * D bytes in
// bf16), so (nnz / nb) * block / 2 flops per byte, nnz / nb the mean
// enabled blocks per row: 88 for the Fixed layout at S = 512, block 16, and
// about 190 for BigBird at S = 4096, block 64, both under the ~295 flops per
// byte where the bf16 tensor cores would bound it, so the bytes do. This kernel
// does its products on the fp32 CUDA cores from shared memory, as
// flash_attention.cu does (whose tile loop it reuses), so the fp32 FMA rate
// and shared-memory bandwidth bound it instead: the simple, right first
// kernel. It reads each visited key block once per query block that visits
// it, where the bound counts k and v once.
//
// Design: one block of 256 threads per (query block, batch * head). It
// stages its query block (pre-scaled, fp32) and then, for each LUT entry,
// the key block in key tiles of BK = min(block, 64) rows, in shared memory
// with rows padded by one float. Each thread owns a (block/16) x (BK/16)
// patch of scores and (block/16) x (D/16) outputs; the 16 threads of a row
// reduce its max and sum with shuffles. In causal mode a key tile wholly
// past the query block's last row is skipped: its scores would all be
// -inf, which changes neither m, l nor acc. Every visited key block costs
// the same, so a LUT row's count sets its block's time: the global rows of
// BigBird and BSLongformer (all blocks) form the launch's tail.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int D, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)BQ * (BK + 1));
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, const int* __restrict__ lut,
                  const int* __restrict__ counts, int S, int H, int max_nnz, float scale,
                  int causal) {
  constexpr int QS = D + 1;   // padded row stride of the q and k tiles
  constexpr int PS = BK + 1;  // padded row stride of the probability tile
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  float* q_sm = smem;
  float* k_sm = q_sm + BQ * QS;
  float* v_sm = k_sm + BK * QS;
  float* p_sm = v_sm + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qi = blockIdx.x, nq = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qi * BQ;
  const size_t row_stride = (size_t)H * D;
  const T* qb = q + (size_t)b * S * row_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * S * row_stride + (size_t)h * D;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)h * D;
  const int* lut_row = lut + ((size_t)h * nq + qi) * max_nnz;
  const int count = counts[(size_t)h * nq + qi];

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_sm[r * QS + d] = ds::to_float(qb[(size_t)(q0 + r) * row_stride + d]) * scale;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) acc[i][dd] = 0.f;
  }

  for (int t = 0; t < count; ++t) {
    const int j = lut_row[t];
    for (int k0 = j * BQ; k0 < (j + 1) * BQ; k0 += BK) {
      if (causal && k0 > q0 + BQ - 1) break;   // this and later tiles: all masked
      __syncthreads();  // the previous tile is no longer read
      for (int i = tid; i < BK * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const size_t off = (size_t)(k0 + r) * row_stride + d;
        k_sm[r * QS + d] = ds::to_float(kb[off]);
        v_sm[r * D + d] = ds::to_float(vb[off]);
      }
      __syncthreads();

      float sc[RQ][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int jj = 0; jj < RK; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[RQ], kv[RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) qv[i] = q_sm[(ty + 16 * i) * QS + d];
#pragma unroll
        for (int jj = 0; jj < RK; ++jj) kv[jj] = k_sm[(tx + 16 * jj) * QS + d];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int jj = 0; jj < RK; ++jj) sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
      }

#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int q_pos = q0 + ty + 16 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < RK; ++jj) {
          if (causal && k0 + tx + 16 * jj > q_pos) sc[i][jj] = -INFINITY;
          mx = fmaxf(mx, sc[i][jj]);
        }
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        // rows with everything masked so far keep m = -inf; keep exp defined
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
        float rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < RK; ++jj) {
          const float p = expf(sc[i][jj] - m_safe);
          p_sm[(ty + 16 * i) * PS + tx + 16 * jj] = p;
          rs += p;
        }
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
        l[i] = l[i] * corr + rs;
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) acc[i][dd] *= corr;
        m[i] = m_new;
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float pv[RQ], vv[RD];
#pragma unroll
        for (int i = 0; i < RQ; ++i) pv[i] = p_sm[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) vv[dd] = v_sm[c * D + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int dd = 0; dd < RD; ++dd) acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
      }
    }
  }

  T* ob = out + (size_t)b * S * row_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int dd = 0; dd < RD; ++dd)
      ob[(size_t)row * row_stride + tx + 16 * dd] = ds::from_float<T>(acc[i][dd] / l_safe);
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const int* lut,
                   const int* counts, int B, int S, int H, int max_nnz, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int BK = BQ < 64 ? BQ : 64;
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  const auto kernel = sparse_fwd_kernel<T, D, BQ, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), lut,
                                           counts, S, H, max_nnz, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_block(int block, const void* q, const void* k, const void* v, void* out,
                     const int* lut, const int* counts, int B, int S, int H, int max_nnz,
                     float scale, int causal, cudaStream_t st) {
  switch (block) {
    case 16:
      return launch<T, D, 16>(q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal, st);
    case 32:
      return launch<T, D, 32>(q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal, st);
    case 64:
      return launch<T, D, 64>(q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal, st);
    case 128:
      return launch<T, D, 128>(q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dim(int D, int block, const void* q, const void* k, const void* v, void* out,
                   const int* lut, const int* counts, int B, int S, int H, int max_nnz,
                   float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 64:
      return by_block<T, 64>(block, q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal,
                             st);
    case 128:
      return by_block<T, 128>(block, q, k, v, out, lut, counts, B, S, H, max_nnz, scale,
                              causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

DS_DEFINE_ERROR_STRING

// q, k, v, out (B, S, H, D), contiguous, one dtype; lut (H, S / block,
// max_nnz) and counts (H, S / block) int32. S a multiple of block. Returns
// the cudaGetLastError() of the launch.
DS_EXPORT int sparse_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const void* lut, const void* counts, int B, int S, int H,
                                   int D, int block, int max_nnz, float scale, int causal,
                                   int dtype, void* stream) {
  if (B < 1 || S < block || block < 1 || S % block || H < 1 || max_nnz < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lt = static_cast<const int*>(lut);
  const int* ct = static_cast<const int*>(counts);
  if (dtype == ds::kBFloat16)
    return by_dim<ds::bf16>(D, block, q, k, v, out, lt, ct, B, S, H, max_nnz, scale, causal, st);
  if (dtype == ds::kFloat32)
    return by_dim<float>(D, block, q, k, v, out, lt, ct, B, S, H, max_nnz, scale, causal, st);
  return cudaErrorInvalidValue;
}
