// Block-sparse attention forward over a per-(head, query block) layout.
//
// Replaces the TPU kernel _pallas_kernel
// (deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py:59).
//
// Computes, per (batch, head, query block qi), out = softmax(q k^T * scale)
// v over the key blocks lut[h, qi, 0 .. counts[h, qi]) only, with an online
// softmax over those blocks so no score matrix exists in memory. Inputs and
// out are (B, S, H, D). The arithmetic grade is the TPU kernel's: scores,
// m, l and acc in fp32, p @ v with fp32-grade p, one cast at the end.
// Causal mode masks k_pos > q_pos; a query block with no enabled key block
// (count 0), or whose every visited key is masked, writes zeros (the TPU
// kernel's l_safe).
//
// Bound on the H100: 4 * pairs * D flops per batch row (pairs: the enabled
// (query, key) positions over the heads) against q, k, v read and out
// written once. At the smoke's cases (BERT-large heads, D = 64) that is
// 3.0-17.2 GFLOP against 67 MB: the bytes bound every case, 0.0200 ms at
// 3.35 TB/s, the operations 0.0030-0.0174 ms at 989 TFLOP/s.
//
// Two kernels behind two entries. bf16 runs sparse_fwd_sm90_kernel (and,
// where a tile is split, sparse_merge_kernel); fp32 runs sparse_fwd_kernel,
// on the CUDA cores: the card's exact fp32 reference. No bf16 tensor reaches
// the CUDA-core kernel, and each kernel has its own launch count.
//
// sparse_fwd_sm90_kernel (flash_sm90.cuh has the layouts and fragments):
// - Work. The wrapper builds a plan on the host once per layout
//   (sparse_self_attention.py build_plan). A tile is 64 query rows of one
//   (b, h): 64 / block query blocks at block 16 and 32, one at 64, half of
//   one at 128. Its units are the union of its query blocks' LUT rows, in
//   key order, each unit a piece of min(block, 64) keys with one bit per
//   query block of the tile that enables it. A key tile is 64 keys: four
//   units at block 16, two at 32, one at 64 and 128 (each 128-key block is
//   two units). So the four query blocks of a Fixed window read their keys
//   once, where one block per query block (the CUDA-core kernel) read them
//   four times: 369 MB through L2 at case a, here ~92 MB. The union adds
//   no work to the Fixed and Dense layouts (their windows share a row) and
//   0.25 to Fixed causal (its triangle masks most of it).
// - A work item is a tile's whole union, or, past kCap key tiles, one of
//   ceil(n / kCap) even pieces of it; the item list is ordered widest
//   first, so BigBird's and BSLongformer's global rows (64 key tiles at
//   S = 4096) start first and run as 8 items of 8 instead of one serial
//   tail. An item that owns its tile writes out; a piece writes its fp32
//   state (acc, m, l; m in the log2 domain) to the workspace, and
//   sparse_merge_kernel, launched after it on the stream, combines a
//   tile's pieces by lse in slot order: M = max m_i, out = sum acc_i
//   2^(m_i - M) / sum l_i 2^(m_i - M), zeros where nothing is enabled. No
//   atomics, fixed orders: every call gives the same bits.
// - A block of one consumer warpgroup and one producer warp. The producer's
//   first lane copies the q tile, then each key tile's units of k and v by
//   TMA into a ring of two stages (a unit at block 16 is a 16-row box, 2048
//   bytes a column block, so it keeps the 128-byte swizzle's 1024-byte
//   phase), each stage on a "full" mbarrier and freed by an "empty" one:
//   the next key tile lands while this one is computed. A tile's last key
//   tile is filled with copies of its last unit whose bits are 0, so every
//   row of the stage holds finite keys and values, and their columns are
//   masked.
// - Per key tile: s = q k^T by wgmma (fp32 accumulators; q and k exact
//   bf16, so each product is exact), times scale * log2(e) in fp32 (q is
//   never scaled in bf16); scores of a unit the row's query block does not
//   enable, or past the diagonal, set to -inf (only on key tiles that hold
//   such a unit or cross the warp's rows: the warp's 16 rows share one
//   query block); the online softmax in fp32 with the TPU kernel's guards
//   (max -inf -> 0, l = 0 -> 1); then o += p v with p as a bf16 hi + lo
//   pair (flash_sm90.cuh split_hi_lo): each p v product is exact and what
//   is left out, <= 2^-18 |p|, lies under an fp32 sum's error. p rounded
//   to bf16 alone carries 2^-9 of itself per term and fails the card's
//   limit (1 ulp + 1e-5 of sum p |v| / l) at 41-125 times it
//   (scripts/sparse_planted_faults.py).
// - Causal: the plan leaves out units wholly past a tile's last row; key
//   tiles that cross a warp's rows are masked per element.
// - Registers (nvcc -Xptxas -v, sm_90a): 122-128 at D = 64 and 156-160 at
//   D = 128, no spills; sparse_merge_kernel 38. Dynamic shared memory
//   (with 1 KB of alignment slack): 41.1 KB at D = 64, 81.2 KB at D = 128.
// - Measured (H100 80GB HBM3, 700 W; PERF.md row 13): 0.050 ms at the
//   Fixed layout, B = 16, S = 512 (the CUDA-core kernel 0.72), 0.089 at
//   the Dense layout, 0.061-0.098 at the S = 4096 layouts, against the
//   0.020 ms byte bound.
//
// sparse_fwd_kernel (fp32): one block of 256 threads per (query block,
// batch * head). It stages its query block (pre-scaled, fp32) and then, for
// each LUT entry, the key block in key tiles of BK = min(block, 64) rows,
// in shared memory with rows padded by one float. Each thread owns a
// (block/16) x (BK/16) patch of scores and (block/16) x (D/16) outputs; the
// 16 threads of a row reduce its max and sum with shuffles. In causal mode
// a key tile wholly past the query block's last row is skipped. The
// arithmetic is the TPU kernel's: q cast to fp32 and then scaled, p @ v
// with p in fp32.
#include "common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int kThreads = 256;

// launches by kernel: 0 sparse_fwd_sm90_kernel, 1 sparse_merge_kernel, 2
// sparse_fwd_kernel
std::atomic<unsigned long long> g_launched[3];

// ---- fp32: sparse_fwd_kernel ----------------------------------------------


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

template <int D, int BQ>
cudaError_t launch_fp32(const float* q, const float* k, const float* v, float* out, const int* lut,
                        const int* counts, int B, int S, int H, int max_nnz, float scale,
                        int causal, cudaStream_t stream) {
  constexpr int BK = BQ < 64 ? BQ : 64;
  constexpr size_t smem = smem_bytes<D, BQ, BK>();
  const auto kernel = sparse_fwd_kernel<float, D, BQ, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, lut, counts, S, H, max_nnz, scale,
                                           causal);
  return ds::sm90::counted(cudaGetLastError(), g_launched[2]);
}

template <int D>
cudaError_t fp32_by_block(int block, const float* q, const float* k, const float* v, float* out,
                          const int* lut, const int* counts, int B, int S, int H, int max_nnz,
                          float scale, int causal, cudaStream_t st) {
  switch (block) {
    case 16: return launch_fp32<D, 16>(q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal, st);
    case 32: return launch_fp32<D, 32>(q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal, st);
    case 64: return launch_fp32<D, 64>(q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal, st);
    case 128: return launch_fp32<D, 128>(q, k, v, out, lut, counts, B, S, H, max_nnz, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: sparse_fwd_sm90_kernel, sparse_merge_kernel ---------------------

using namespace ds::sm90;

constexpr int kTile = 64;      // query rows of a work item; keys of a key tile
constexpr int kCap = 8;        // key tiles of a work item at most (the wrapper's CAP)
constexpr int kRowBits = 24;   // a unit word: its first key row | enable bits << 24
constexpr int kRowMask = (1 << kRowBits) - 1;

template <int D, int BLK>
struct SparseSm90 {
  static constexpr int KU = BLK < kTile ? BLK : kTile;  // keys of a unit
  static constexpr int G = kTile / KU;                   // units of a key tile
  static constexpr int KB = D / 64, STAGES = 2;
  static constexpr int THREADS = 128 + 32;  // one consumer warpgroup, one producer warp
  static constexpr int TILE_BYTES = kTile * D * 2;        // q; a stage's k or v
  static constexpr int OFF_KV = TILE_BYTES;               // stage s: k, then v
  static constexpr int OFF_UNITS = OFF_KV + STAGES * 2 * TILE_BYTES;
  static constexpr int OFF_BAR = OFF_UNITS + kCap * G * 4;
  static constexpr int SMEM = 1024 + OFF_BAR + (2 * STAGES + 1) * 8;
  static constexpr int STATE = kTile * (D + 2);           // a piece's acc, m, l
};

template <int D, int BLK>
__global__ void __launch_bounds__(SparseSm90<D, BLK>::THREADS, D == 64 ? 3 : 2)
sparse_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, ds::bf16* __restrict__ out,
                       float* __restrict__ ws, const int4* __restrict__ items,
                       const int* __restrict__ units, int B, int S, int H, int n_slots,
                       float scale_log2, int causal) {
  using C = SparseSm90<D, BLK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  ds::bf16* sQ = reinterpret_cast<ds::bf16*>(sm);
  int* sU = reinterpret_cast<int*>(sm + C::OFF_UNITS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = full + 2 * C::STAGES;

  const int4 item = items[blockIdx.x / B];  // ht, first unit, key tiles, slot
  const int b = blockIdx.x % B;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int h = item.x / n_tiles, q0 = (item.x % n_tiles) * kTile;
  const int n_kt = item.z, slot = item.w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < n_kt * C::G; i += C::THREADS) sU[i] = units[item.y + i];
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
    if (lane == 0 && n_kt > 0) {
      mbar_expect_tx(qbar, C::TILE_BYTES);
      for (int c = 0; c < C::KB; ++c) tma_load_4d(sQ + c * kTile * 64, &tm_q, qbar, c * 64, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % C::STAGES;
        if (j >= C::STAGES) mbar_wait(&empty[s], ((j / C::STAGES) - 1) & 1);
        ds::bf16* sK = reinterpret_cast<ds::bf16*>(sm + C::OFF_KV + s * 2 * C::TILE_BYTES);
        ds::bf16* sV = sK + kTile * D;
        mbar_expect_tx(&full[s], 2 * C::TILE_BYTES);
#pragma unroll
        for (int g = 0; g < C::G; ++g) {
          const int row = sU[j * C::G + g] & kRowMask;
#pragma unroll
          for (int c = 0; c < C::KB; ++c) {
            const int off = c * kTile * 64 + g * C::KU * 64;
            tma_load_4d(sK + off, &tm_k, &full[s], c * 64, h, row, b);
            tma_load_4d(sV + off, &tm_v, &full[s], c * 64, h, row, b);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup: accumulator rows r0 and r0 + 8, both in the
  // warp's query block (slot) of the tile
  const int t = lane % 4, r0 = q0 + 16 * warp + lane / 4;
  const int qslot = BLK < kTile ? 16 * warp / BLK : 0;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (n_kt > 0) mbar_wait(qbar, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % C::STAGES;
    const ds::bf16* sK =
        reinterpret_cast<const ds::bf16*>(sm + C::OFF_KV + s * 2 * C::TILE_BYTES);
    const ds::bf16* sV = sK + kTile * D;
    mbar_wait(&full[s], (j / C::STAGES) & 1);
    float sc[kTile / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kTile, 0, 0>(sc, kmajor_desc(sQ + (kk / 4) * kTile * 64 + (kk % 4) * 16),
                            kmajor_desc(sK + (kk / 4) * kTile * 64 + (kk % 4) * 16), kk > 0);
    wgmma_commit();

    // this key tile's units: first key row, and whether the warp's query
    // block enables it; mask only where some unit is off or past the rows
    int krow[C::G];
    bool on[C::G];
    bool edge = false;
#pragma unroll
    for (int g = 0; g < C::G; ++g) {
      const int w = sU[j * C::G + g];
      krow[g] = w & kRowMask;
      on[g] = (w >> (kRowBits + qslot)) & 1;
      edge |= !on[g] || (causal && krow[g] + C::KU - 1 > q0 + 16 * warp);
    }
    wgmma_wait_all();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      sc[i] *= scale_log2;
      if (edge) {
        const int g = 8 * (i / 4) / C::KU;
        const int key = krow[g] + (8 * (i / 4) + 2 * t + (i % 2)) % C::KU;
        const int row = r0 + 8 * ((i / 2) % 2);
        if (!on[g] || (causal && key > row)) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
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
    for (int i = 0; i < kTile / 2; ++i) {
      sc[i] = exp2f(sc[i] - ms[(i / 2) % 2]);
      rs[(i / 2) % 2] += sc[i];
    }
    l[0] = l[0] * corr[0] + rs[0];  // per-thread partial sums, reduced in the epilogue
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];

    // o += p v, p as the bf16 hi and lo A fragments
    uint32_t hi[kTile / 16][4], lo[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        split_hi_lo(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1], hi[kk][x], lo[kk][x]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t dv = mnmajor_desc(sV + kk * 16 * 64, kTile * 128);
      wgmma_rs<D, 1>(o, hi[kk], dv, 1);
      wgmma_rs<D, 1>(o, lo[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t row_stride = (size_t)H * D;
  ds::bf16* ob = out + (size_t)b * S * row_stride + (size_t)h * D;
  float* st = slot < 0 ? nullptr : ws + ((size_t)b * n_slots + slot) * C::STATE;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float lr = quad_sum(l[r]);
    if (st) {  // a piece: its unnormalised state, rows in tile order
      const int tr = row - q0;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<float2*>(st + tr * D + 8 * jj + 2 * t) =
            make_float2(o[4 * jj + 2 * r], o[4 * jj + 2 * r + 1]);
      if (t == 0) {
        st[kTile * D + tr] = m[r];
        st[kTile * D + kTile + tr] = lr;
      }
    } else if (row < S) {
      const float l_safe = lr == 0.f ? 1.f : lr;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * row_stride + 8 * jj + 2 * t) =
            __floats2bfloat162_rn(o[4 * jj + 2 * r] / l_safe, o[4 * jj + 2 * r + 1] / l_safe);
    }
  }
}

// one block per (split tile, batch row); a thread per pair of output
// columns of a row: the tile's pieces in slot order
template <int D>
__global__ void __launch_bounds__(256)
sparse_merge_kernel(const float* __restrict__ ws, const int4* __restrict__ merges,
                    ds::bf16* __restrict__ out, int B, int S, int H, int n_slots) {
  constexpr int STATE = kTile * (D + 2);
  const int4 mg = merges[blockIdx.x / B];  // ht, first slot, pieces
  const int b = blockIdx.x % B;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int h = mg.x / n_tiles, q0 = (mg.x % n_tiles) * kTile;
  const float* base = ws + ((size_t)b * n_slots + mg.y) * STATE;
  for (int i = threadIdx.x; i < kTile * D / 2; i += blockDim.x) {
    const int r = i / (D / 2), c = 2 * (i % (D / 2));
    if (q0 + r >= S) break;
    float M = -INFINITY;
    for (int p = 0; p < mg.z; ++p) M = fmaxf(M, base[p * STATE + kTile * D + r]);
    float2 num = make_float2(0.f, 0.f);
    float den = 0.f;
    for (int p = 0; p < mg.z; ++p) {
      const float* st = base + p * STATE;
      const float mi = st[kTile * D + r];
      const float w = mi == -INFINITY ? 0.f : exp2f(mi - M);
      const float2 a = *reinterpret_cast<const float2*>(st + r * D + c);
      num.x = fmaf(a.x, w, num.x);
      num.y = fmaf(a.y, w, num.y);
      den = fmaf(st[kTile * D + kTile + r], w, den);
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * S + q0 + r) * H * D + (size_t)h * D +
                                       c) = __floats2bfloat162_rn(num.x * inv, num.y * inv);
  }
}

struct Sm90Args {
  const void *q, *k, *v;
  void* out;
  const int4* items;
  const int* units;
  const int4* merges;
  float* ws;
  int n_items, n_merges, n_slots, B, S, H;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, int BLK>
cudaError_t launch_sm90(const Sm90Args& a) {
  using C = SparseSm90<D, BLK>;
  CUtensorMap mq, mk, mv;
  if (!head_map(&mq, a.q, a.B, a.S, a.H, D, kTile) || !head_map(&mk, a.k, a.B, a.S, a.H, D, C::KU) ||
      !head_map(&mv, a.v, a.B, a.S, a.H, D, C::KU))
    return cudaErrorInvalidValue;
  const auto kernel = sparse_fwd_sm90_kernel<D, BLK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<a.n_items * a.B, C::THREADS, C::SMEM, a.stream>>>(
      mq, mk, mv, static_cast<ds::bf16*>(a.out), a.ws, a.items, a.units, a.B, a.S, a.H, a.n_slots,
      a.scale * kLog2e, a.causal);
  err = counted(cudaGetLastError(), g_launched[0]);
  if (err != cudaSuccess || a.n_merges == 0) return err;
  sparse_merge_kernel<D><<<a.n_merges * a.B, 256, 0, a.stream>>>(
      a.ws, a.merges, static_cast<ds::bf16*>(a.out), a.B, a.S, a.H, a.n_slots);
  return counted(cudaGetLastError(), g_launched[1]);
}

template <int D>
cudaError_t sm90_by_block(int block, const Sm90Args& a) {
  switch (block) {
    case 16: return launch_sm90<D, 16>(a);
    case 32: return launch_sm90<D, 32>(a);
    case 64: return launch_sm90<D, 64>(a);
    case 128: return launch_sm90<D, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

DS_DEFINE_ERROR_STRING

// bf16. q, k, v, out (B, S, H, D), contiguous; the plan's items (n_items, 4)
// and merges (n_merges, 4; at least one row) int32, units int32; ws (B,
// n_slots, 64 * (D + 2)) fp32, null when n_slots is 0 (then n_merges is 0).
// S a multiple of block. Returns the cudaGetLastError() of the launches.
DS_EXPORT int sparse_attention_sm90_fwd(const void* q, const void* k, const void* v, void* out,
                                        const void* items, int n_items, const void* units,
                                        const void* merges, int n_merges, void* ws, int n_slots,
                                        int B, int S, int H, int D, int block, float scale,
                                        int causal, void* stream) {
  if (B < 1 || H < 1 || block < 1 || S < block || S % block || S > kRowMask || n_items < 1 ||
      (long long)n_items * B > 0x7fffffffLL || (long long)n_merges * B > 0x7fffffffLL ||
      (n_slots > 0) != (n_merges > 0) || (n_slots > 0 && ws == nullptr))
    return cudaErrorInvalidValue;
  const Sm90Args a{q, k, v, out, static_cast<const int4*>(items), static_cast<const int*>(units),
                   static_cast<const int4*>(merges), static_cast<float*>(ws), n_items, n_merges,
                   n_slots, B, S, H, scale, causal, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64: return sm90_by_block<64>(block, a);
    case 128: return sm90_by_block<128>(block, a);
    default: return cudaErrorInvalidValue;
  }
}

// fp32. q, k, v, out (B, S, H, D), contiguous; lut (H, S / block, max_nnz)
// and counts (H, S / block) int32. S a multiple of block. Returns the
// cudaGetLastError() of the launch.
DS_EXPORT int sparse_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const void* lut, const void* counts, int B, int S, int H,
                                   int D, int block, int max_nnz, float scale, int causal,
                                   void* stream) {
  if (B < 1 || S < block || block < 1 || S % block || H < 1 || max_nnz < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const int* lt = static_cast<const int*>(lut);
  const int* ct = static_cast<const int*>(counts);
  switch (D) {
    case 64: return fp32_by_block<64>(block, qf, kf, vf, of, lt, ct, B, S, H, max_nnz, scale, causal, st);
    case 128: return fp32_by_block<128>(block, qf, kf, vf, of, lt, ct, B, S, H, max_nnz, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// Launches so far of kernel `which` (0 sparse_fwd_sm90_kernel, 1
// sparse_merge_kernel, 2 sparse_fwd_kernel), counted on the host where each
// is launched.
DS_EXPORT unsigned long long sparse_attention_launched(int which) {
  return which >= 0 && which < 3 ? g_launched[which].load() : 0;
}
