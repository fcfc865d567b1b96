// Flash-attention forward with the per-row log-sum-exp.
//
// Replaces the TPU kernel _fwd_kernel
// (deepspeed_tpu/ops/pallas/flash_attention.py:34).
//
// Computes, per (batch, head), out = softmax(q k^T * scale [causal]) v and
// lse = m + log(l) per query row, with an online softmax over key tiles so
// the S x S score matrix never exists in memory. Inputs and out are
// (B, S, H, D); lse is (B * H, 1, S) fp32. Causal masking keeps
// q_pos >= k_pos (top-left aligned, any Sk); a row with nothing to attend
// writes 0 and lse = 0, the TPU kernel's guards (flash_attention.py:64-67,
// :87-90).
//
// Bound on the H100: at S = 1024, D = 64 the work is ~250 flops per byte
// moved, so the bound is about even between the bytes (q, k, v read once,
// out and lse written once) and the bf16 tensor-core rate.
//
// Two kernels behind one entry. bf16 runs flash_fwd_sm90_kernel, on the
// tensor cores; fp32 runs flash_fwd_kernel, on the CUDA cores: the card's
// exact fp32 reference, which the fp32 engines (and the gates that compare
// bf16 runs against them) go through. No bf16 tensor reaches the CUDA-core
// kernel.
//
// flash_fwd_sm90_kernel (flash_sm90.cuh has the layouts and fragments):
// - A block owns 128 query rows of one (b, h) as two consumer warpgroups of
//   64 rows (D = 64, 128), or 64 rows with one warpgroup at D = 256, where
//   the 64 x 256 fp32 output accumulator alone takes 128 registers a
//   thread. One more warp is the producer: its first lane copies the
//   query tile and then each key tile (128 keys at D = 64, 64 at D = 128
//   and 256: 128 keys at D = 128 need more registers than a 288-thread
//   block gives) of k and v by TMA into a ring of two stages, each stage on
//   a "full" mbarrier (transaction bytes) and freed by an "empty" one that
//   every consumer warp arrives on. Shared memory: 81 KB at D = 64, 97 KB
//   at D = 128, 161 KB at D = 256.
// - Copies are TMA, straight from the (B, S, H, D) tensors through 4-D
//   tensor maps (row stride H * D, no copy), in the 128-byte swizzle; rows
//   past S or Sk arrive as zeros, so nothing is read out of bounds.
// - Per key tile a warpgroup computes S = q k^T with wgmma (q and k
//   K-major from shared memory, fp32 accumulators), applies scale * log2(e)
//   to the fp32 scores (q is never pre-scaled in bf16: 1/sqrt(128) is not a
//   power of two), masks only the tiles that cross the diagonal or Sk,
//   updates the row max and sum (a row's values lie in the 4 lanes of a
//   quad), rescales its output, rounds p to bf16 in registers and feeds it
//   as the register A operand of O += p v (v MN-major, transpose bit).
//   Key tiles wholly past the causal limit of the block are never loaded.
// - Epilogue: out = O / l in bf16 and lse = m ln 2 + log l, with the
//   guards above (m = -inf -> 0, l = 0 -> 1).
// - Grid (B * H, query tiles), the query tiles numbered from the last: the
//   longest causal rows start in the first wave and the short ones fill the
//   last (pythia-1b's engine(ids), B = 2, H = 8, S = 1024, has 256 blocks
//   of 64 rows for 132 SMs).
//
// flash_fwd_kernel (fp32): one block per (64-row query tile, batch * head)
// stages its query tile (pre-scaled, fp32) and then each 64-key (32 at
// D = 256) K/V tile in shared memory, rows padded by one float; each of the
// 256 threads owns a 4 x 4 block of scores and 4 x D/16 outputs, products
// on the fp32 CUDA cores.
#include "common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block

// launches by kernel: 0 flash_fwd_sm90_kernel, 1 flash_fwd_kernel
std::atomic<unsigned long long> g_launched[2];

template <int D, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)kBQ * (BK + 1));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int S, int Sk, int H,
                 float scale, int causal) {
  constexpr int QS = D + 1;   // padded row stride of the q and k tiles
  constexpr int PS = BK + 1;  // padded row stride of the probability tile
  constexpr int RQ = kBQ / 16, RK = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  float* q_sm = smem;
  float* k_sm = q_sm + kBQ * QS;
  float* v_sm = k_sm + BK * QS;
  float* p_sm = v_sm + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t row_stride = (size_t)H * D;
  const T* qb = q + (size_t)b * S * row_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * row_stride + (size_t)h * D;
  const T* vb = v + (size_t)b * Sk * row_stride + (size_t)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    q_sm[r * QS + d] = s < S ? ds::to_float(qb[(size_t)s * row_stride + d]) * scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) acc[i][dd] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool live = s < Sk;
      k_sm[r * QS + d] = live ? ds::to_float(kb[(size_t)s * row_stride + d]) : 0.f;
      v_sm[r * D + d] = live ? ds::to_float(vb[(size_t)s * row_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = q_sm[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = k_sm[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        if (k_pos >= Sk || (causal && k_pos > q_pos)) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // rows with everything masked so far keep m = -inf; keep exp defined
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(sc[i][j] - m_safe);
        p_sm[(ty + 16 * i) * PS + tx + 16 * j] = p;
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

  T* ob = out + (size_t)b * S * row_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < S) {
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int dd = 0; dd < RD; ++dd)
        ob[(size_t)row * row_stride + tx + 16 * dd] = ds::from_float<T>(acc[i][dd] / l_safe);
      if (tx == 0) {
        const float m_safe = m[i] == -INFINITY ? 0.f : m[i];
        lse[(size_t)bh * S + row] = m_safe + logf(l_safe);
      }
    }
  }
}

template <typename T, int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int S, int Sk, int H, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BK>();
  const auto kernel = flash_fwd_kernel<T, D, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out),
                                           lse, S, Sk, H, scale, causal);
  return ds::sm90::counted(cudaGetLastError(), g_launched[1]);
}

// fp32 only: bf16 goes to the tensor-core kernel below
template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int S, int Sk, int H, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64, 64>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    case 128:
      return launch<T, 128, 64>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    case 256:
      return launch<T, 256, 32>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- bf16: flash_fwd_sm90_kernel ------------------------------------------

using namespace ds::sm90;

template <int D, int NWG, int BN>
struct Sm90Fwd {
  static constexpr int STAGES = 2;
  static constexpr int BM = 64 * NWG;  // query rows per block
  static constexpr int KB = D / 64;    // 64-column blocks
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + (2 * STAGES + 1) * 8;
};

template <int D, int NWG, int BN>
__global__ void __launch_bounds__(Sm90Fwd<D, NWG, BN>::THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, ds::bf16* __restrict__ out,
                      float* __restrict__ lse, int S, int Sk, int H, float scale_log2,
                      int causal) {
  using C = Sm90Fwd<D, NWG, BN>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  ds::bf16* sQ = reinterpret_cast<ds::bf16*>(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = full + 2 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BM;  // the longest causal rows first
  const int k_end = causal ? min(Sk, q0 + C::BM) : Sk;
  const int n_tiles = (k_end + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < C::KB; ++c)
        tma_load_4d(sQ + c * C::BM * 64, &tm_q, qbar, c * 64, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
        ds::bf16* sK = reinterpret_cast<ds::bf16*>(sm + C::Q_BYTES + s * 2 * C::KV_BYTES);
        ds::bf16* sV = sK + BN * D;
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        for (int c = 0; c < C::KB; ++c) {
          tma_load_4d(sK + c * BN * 64, &tm_k, &full[s], c * 64, h, j * BN, b);
          tma_load_4d(sV + c * BN * 64, &tm_v, &full[s], c * 64, h, j * BN, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [q0 + 64 wg, + 64). Under the causal
  // mask a key tile past its rows (D = 128's last) is masked whole.
  const int wg = warp / 4, t = lane % 4;
  const int r0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // this thread's rows: r0, r0 + 8
  const ds::bf16* q_wg = sQ + wg * 64 * 64;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, k0 = j * BN;
    const ds::bf16* sK = reinterpret_cast<const ds::bf16*>(sm + C::Q_BYTES + s * 2 * C::KV_BYTES);
    const ds::bf16* sV = sK + BN * D;
    mbar_wait(&full[s], (j / STAGES) & 1);
    float sc[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN, 0, 0>(sc, kmajor_desc(q_wg + (kk / 4) * C::BM * 64 + (kk % 4) * 16),
                         kmajor_desc(sK + (kk / 4) * BN * 64 + (kk % 4) * 16), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in the log2 domain; masks only on tiles that cross Sk or the diagonal
    const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + 64 * wg);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] *= scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i / 4) + 2 * t + (i % 2), row = r0 + 8 * ((i / 2) % 2);
        if (col >= Sk || (causal && col > row)) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float corr[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      // rows with everything masked so far keep m = -inf; keep exp2 defined
      ms[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = exp2f(m[r] - ms[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = exp2f(sc[i] - ms[(i / 2) % 2]);
      rs[(i / 2) % 2] += sc[i];
    }
    l[0] = l[0] * corr[0] + rs[0];  // per-thread partial sums, reduced in the epilogue
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];

    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D, 1>(o, pa[kk], mnmajor_desc(sV + kk * 16 * 64, BN * 128), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t row_stride = (size_t)H * D;
  ds::bf16* ob = out + (size_t)b * S * row_stride + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float lr = quad_sum(l[r]);
    if (row < S) {
      const float l_safe = lr == 0.f ? 1.f : lr;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const __nv_bfloat162 v2 =
            __floats2bfloat162_rn(o[4 * jj + 2 * r] / l_safe, o[4 * jj + 2 * r + 1] / l_safe);
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * row_stride + 8 * jj + 2 * t) = v2;
      }
      if (t == 0) {
        const float m_safe = m[r] == -INFINITY ? 0.f : m[r];
        lse[(size_t)bh * S + row] = m_safe * kLn2 + logf(l_safe);
      }
    }
  }
}

template <int D, int NWG, int BN>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                        int S, int Sk, int H, float scale, int causal, cudaStream_t stream) {
  using C = Sm90Fwd<D, NWG, BN>;
  CUtensorMap mq, mk, mv;
  if (!head_map(&mq, q, B, S, H, D, C::BM) || !head_map(&mk, k, B, Sk, H, D, BN) ||
      !head_map(&mv, v, B, Sk, H, D, BN))
    return cudaErrorInvalidValue;
  const auto kernel = flash_fwd_sm90_kernel<D, NWG, BN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + C::BM - 1) / C::BM);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(mq, mk, mv, static_cast<ds::bf16*>(out), lse, S,
                                                Sk, H, scale * kLog2e, causal);
  return counted(cudaGetLastError(), g_launched[0]);
}

cudaError_t by_dim_sm90(int D, const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int S, int Sk, int H, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_sm90<64, 2, 128>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    case 128:
      return launch_sm90<128, 2, 64>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    case 256:
      return launch_sm90<256, 1, 64>(q, k, v, out, lse, B, S, Sk, H, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

DS_DEFINE_ERROR_STRING

// q (B, S, H, D); k, v (B, Sk, H, D); out (B, S, H, D); lse (B * H, 1, S)
// fp32. q, k, v and out contiguous and of one dtype. Returns the
// cudaGetLastError() of the launch.
DS_EXPORT int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int S, int Sk, int H, int D, float scale,
                                  int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lsef = static_cast<float*>(lse);
  if (dtype == ds::kBFloat16)
    return by_dim_sm90(D, q, k, v, out, lsef, B, S, Sk, H, scale, causal, st);
  if (dtype == ds::kFloat32)
    return by_dim<float>(D, q, k, v, out, lsef, B, S, Sk, H, scale, causal, st);
  return cudaErrorInvalidValue;
}

// Launches so far of kernel `which` (0 flash_fwd_sm90_kernel, 1
// flash_fwd_kernel), counted on the host where each is launched.
DS_EXPORT unsigned long long flash_attention_fwd_launched(int which) {
  return which == 0 || which == 1 ? g_launched[which].load() : 0;
}
