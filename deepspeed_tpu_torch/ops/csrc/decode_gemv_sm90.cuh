// The bf16 decode-row GEMV on Hopper's tensor cores, behind the bf16
// branches of the fused decode-layer kernels (decode_layer.cu), dense bf16
// and W8A16 weights. It replaces, for bf16 activations, the CUDA-core GEMV
// of rows_gemv.cuh; Args and launch() also carry the plain matmul (kMatmul,
// fp32 out, no epilogue) that the W8A16 matmul (w8_matmul.cu) runs.
//
// out[m, n] = epilogue(sum_k a[m, k] W[k, n]) for M <= 64 decode rows, a
// the bf16 operand in device memory (the attention output, the normalised
// rows that norm_rows_kernel writes, or h). Bound on the H100: bytes. Each
// weight byte feeds 2 M (W8) or M (bf16) flops, far under the tensor
// cores' 295 flops a byte, so reading the panel once is the whole cost.
//
// Products: mma.sync m16n8k16, bf16 in, fp32 sums, as out^T = W^T a^T:
// the 16-wide side holds 16 weight columns, the 8-wide side 8 decode rows,
// so one weight fragment serves every 8-row tile of the block (up to 8:
// M = 64) and each weight byte is read once. Weight fragments come from a
// shared-memory tile whose 16-byte chunks are XOR-swizzled by k-row, so
// ldmatrix.trans reads 8 k-rows of one chunk column without bank conflicts.
// W8 codes take ldmatrix.trans too, a b16 element being two neighbouring
// code columns: a lane gets bytes (k, 2g), (k, 2g+1), (k+1, 2g), (k+1,
// 2g+1), so fragment row g is column 2g and row g+8 column 2g+1 of the
// 16-column group. Codes become bf16 by bits, exactly (|c| <= 127): the
// byte's low seven bits under the exponent of 128 give 128 + lo, its sign
// bit under the same exponent gives 128 or 256, and one bf16x2 subtraction
// leaves c. No I2F, no int8 products, no dequantised copy.
//
// Work split (the host's plan, ops/decode_layer.gemv_plan): a block of 128
// threads owns n_tile output columns (two panels of n_tile under SwiGLU:
// gate and up) and one K-slice of k_slice rows; grid (N / n_tile, K /
// k_slice). Its four warps take 16 of the (virtual) columns each, and
// where a tile has fewer than four 16-column groups, the warps of one group
// share its k16 steps. K-slices are multiples of 128 and of the scale
// group, so every fold lies in one block.
//
// Streaming: a ring of three stages of 128 k-rows in shared memory, each
// stage the weight rows (both panels), their scale row (W8) and the
// operand's 128 columns for every row, filled by 16-byte cp.async. Weight
// rows are whole 32-byte sectors (tiles are at least 32 bytes wide). A
// block issues its first stage's weights before it waits on the previous
// kernel (griddepcontrol.wait: programmatic dependent launch), then that
// stage's operand and the next stage; each later stage is issued two
// stages ahead of the one in use.
//
// W8 fold: _qdot_any's per-group fold (deepspeed_tpu/ops/pallas/
// decode_layer.py:160): a fresh fp32 fragment per 128-row group (per
// larger group where g > 128), acc += part * s[u][n] at the group's end;
// with one group the fold comes at the slice's end (the scale distributes
// over partial sums, as over the TPU kernel's streamed tiles).
//
// Reduction: the warps' sums meet in shared memory, summed in warp order.
// Split K: each block writes its fp32 partial to the workspace, bumps the
// column tile's ticket, and the last block to arrive sums the partials in
// slice order (bits independent of arrival order), runs the epilogue once
// and resets the ticket, so the next launch finds it zero.
#pragma once

#include <stdint.h>
#include <string.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace ds {
namespace gemv90 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 128;                  // k-rows per ring stage
constexpr int kStages = 3;                       // ring depth
constexpr int kAhead = kStages - 1;              // stages in flight ahead of the one in use
constexpr int kMaxRows = 64;                     // decode rows
constexpr int kMaxCols = 64;                     // (virtual) columns per block
constexpr int kActStride = kStageRows + 8;       // staged operand row, bf16: 272 bytes
constexpr int kNormThreads = 256;
constexpr int kNormPer = 8;                      // row elements a norm thread holds
constexpr size_t kMaxSmem = (size_t)kStages * (kStageRows * kMaxCols * 2 + kMaxCols * 4 +
                                               kMaxRows * kActStride * 2);

constexpr float kSqrt2OverPi = 0.7978845608028654f;

enum Mode : int { kNormProj, kOProjResidual, kNormUpGelu, kDownResidual, kMatmul, kNormGateUp };

// W: weight storage, bf16 or int8 codes with fp32 scales.
template <typename W>
struct Args {
  const bf16* a;          // (M, K) bf16 operand
  const W* w;             // (K, N), row-major; the gate panel in kNormGateUp
  const float* scale;     // (K / group, N) fp32, int8 weights
  const W* w2;            // (K, N) up panel, kNormGateUp
  const float* scale2;    // its scales (same group), int8 weights
  int group;              // rows per scale group (K for one group)
  const bf16* bias;       // (N,); may be null in kDownResidual and kNormGateUp
  const bf16* resid;      // (M, N) x, kOProjResidual
  const float* resid_f;   // (M, N) r1, kDownResidual
  void* out;              // (M, N): fp32 for kOProjResidual and kMatmul, else bf16
  float* ws;              // split partials, (K / k_slice) x M x N (x 2 under SwiGLU)
  int* tickets;           // one zeroed counter per column tile
  int M, K, N;
  int n_tile, k_slice;    // the plan
  int exact_gelu;         // kNormUpGelu: the erf GELU instead of the tanh one
};

// launches by kernel: 0 gemv_sm90_kernel (dense bf16), 1 its W8 instantiations,
// 2 norm_rows_kernel
inline std::atomic<unsigned long long> g_launched[3];

__device__ __forceinline__ float gelu_tanh(float u) {
  // _gelu_tanh (deepspeed_tpu/ops/pallas/fused_ops.py:165), term for term
  const float inner = kSqrt2OverPi * (u + 0.044715f * u * u * u);
  return 0.5f * u * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_erf(float u) {
  // _gelu_exact (deepspeed_tpu/ops/pallas/decode_layer.py:98-100)
  return 0.5f * u * (1.f + erff(u * 0.70710678f));
}

__device__ __forceinline__ float swiglu(float g, float u) {
  return (g * (1.f / (1.f + expf(-g)))) * u;
}

// ---- device helpers --------------------------------------------------------

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// Waits until the previous kernel on the stream has finished and its writes
// are visible; returns at once for a launch without the PDL attribute.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& d0, uint32_t& d1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(d0), "=r"(d1)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& d0, uint32_t& d1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(d0), "=r"(d1)
               : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The int8 codes in bytes 0 and 2 of w as a bf16x2 pair, exactly: with lo
// the byte's low seven bits and s its sign bit, bf16 bits 0x4300 | lo are
// 128 + lo and 0x4300 | s << 7 are 128 (s = 0) or 256, so their difference
// is lo - 128 s, the code.
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t w) {
  const uint32_t x = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t s = (w & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 xv, sv;
  memcpy(&xv, &x, 4);
  memcpy(&sv, &s, 4);
  const __nv_bfloat162 d = __hsub2(xv, sv);
  uint32_t r;
  memcpy(&r, &d, 4);
  return r;
}

// The 16-byte chunk where chunk c of k-row r lies, for rows of C chunks
// (C = 1, 2, 4, 8: 8 / C rows share a 128-byte line, lsh = log2(8 / C)):
// the 8 rows one ldmatrix reads in one chunk column fall on 8 distinct
// 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c, int C, int lsh) {
  return c ^ ((r >> lsh) & (C - 1));
}

// ---- the GEMV ----------------------------------------------------------------

// MT: 8-row tiles the registers hold (2 for M <= 16, else 8). With MT = 2
// two accumulators per tile take a warp's k16 steps in turn, so a burst of
// fragment loads feeds independent products (at M = 8 one accumulator
// would chain every product of the slice on the one before); with MT = 8
// the tiles are the independent chains. The kernel is bound by latency,
// so blocks an SM count: registers are capped for four (three for W8 at
// MT = 8, which would spill under four).
template <typename W, int MODE, int MT>
__global__ void __launch_bounds__(kThreads, (MT == 8 && sizeof(W) == 1) ? 3 : 4)
    gemv_sm90_kernel(const Args<W> p) {
  constexpr bool kQuant = std::is_same<W, int8_t>::value;
  constexpr int kBanks = MT == 2 ? 2 : 1;
  constexpr bool kPair = MODE == kNormGateUp;
  constexpr int kWB = sizeof(W);
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int last_sm;
  pdl_trigger();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = p.n_tile, vt = kPair ? 2 * nt : nt;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int n_tiles = gridDim.x, n_splits = gridDim.y;
  const int n0 = tile * nt, kbase = split * p.k_slice;
  const int nst = p.k_slice / kStageRows;
  const int M = p.M, mt = (M + 7) >> 3, mrows = mt * 8;
  const int row_bytes = vt * kWB, C = row_bytes >> 4, lsh = 4 - __ffs(C);
  const int pchunks = (nt * kWB) >> 4;                       // chunks of one panel's row
  const int w_bytes = kStageRows * row_bytes;
  const int sc_bytes = kQuant ? vt * 4 : 0;
  const int stage_bytes = w_bytes + sc_bytes + mrows * kActStride * 2;
  const int ring = min(nst, kStages);
  const uint32_t sbase = smem_u32(smem);

  // stage s's weight rows (both panels) and, for int8, their scale row
  auto load_w = [&](int s) {
    const int kb = kbase + s * kStageRows;
    const uint32_t dst = sbase + (s % ring) * stage_bytes;
    for (int i = tid; i < kStageRows * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      const int pnl = kPair ? c / pchunks : 0, cc = c - pnl * pchunks;
      const W* src = (pnl ? p.w2 : p.w) + (size_t)(kb + r) * p.N + n0 + cc * (16 / kWB);
      cp_async16(dst + r * row_bytes + (swz(r, c, C, lsh) << 4), src, 16);
    }
    if constexpr (kQuant) {
      const int u = kb / p.group;
      for (int i = tid; i < vt / 4; i += kThreads) {
        const int pnl = kPair ? (4 * i) / nt : 0, col = 4 * i - pnl * nt;
        cp_async16(dst + w_bytes + 16 * i, (pnl ? p.scale2 : p.scale) + (size_t)u * p.N + n0 + col,
                   16);
      }
    }
  };
  // stage s's 128 operand columns of every row (rows past M zero-filled)
  auto load_a = [&](int s) {
    const int kb = kbase + s * kStageRows;
    const uint32_t dst = sbase + (s % ring) * stage_bytes + w_bytes + sc_bytes;
    for (int i = tid; i < mrows * 16; i += kThreads) {
      const int m = i >> 4, c = i & 15;
      const bool live = m < M;
      cp_async16(dst + m * (kActStride * 2) + 16 * c,
                 p.a + (size_t)(live ? m : 0) * p.K + kb + 8 * c, live ? 16 : 0);
    }
  };

  // The first stage's weights depend on nothing: in flight before the
  // previous kernel ends. Groups: 0 those weights, 1 the first operand
  // stage, then one group a stage (weights and operand), kAhead ahead.
  load_w(0);
  cp_commit();
  pdl_wait();
  load_a(0);
  cp_commit();
  for (int s = 1; s < kAhead; ++s) {
    if (s < nst) {
      load_w(s);
      load_a(s);
    }
    cp_commit();
  }

  const int n_cg = vt >> 4, n_kp = kWarps / n_cg;
  const int cg = warp % n_cg, kp = warp / n_cg;
  const int g = lane >> 2, t = lane & 3;
  // the (virtual) columns of this lane's fragment rows g and g + 8
  const int vc0 = cg * 16 + (kQuant ? 2 * g : g), vc1 = vc0 + (kQuant ? 1 : 8);

  // a warp's k16 steps of a stage: j = kp + n_kp * i, i < steps; step i
  // goes to accumulator bank i % kBanks
  const int steps = (kStageRows / 16) / n_kp;
  float acc[kBanks][MT][4];
  float part[kBanks][MT][4];
#pragma unroll
  for (int q = 0; q < kBanks; ++q)
#pragma unroll
    for (int jm = 0; jm < MT; ++jm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][jm][e] = part[q][jm][e] = 0.f;

  for (int s = 0; s < nst; ++s) {
    if (s + kAhead < nst) {
      load_w(s + kAhead);
      load_a(s + kAhead);
    }
    cp_commit();
    cp_wait<kAhead>();   // stage s has landed
    __syncthreads();
    const uint32_t wst = sbase + (s % ring) * stage_bytes;
    const uint32_t ast = wst + w_bytes + sc_bytes;
#pragma unroll
    for (int i0 = 0; i0 < 8; i0 += kBanks) {
      if (i0 < steps) {
        // a burst of fragment loads, then the products
        uint32_t a[kBanks][4];
        uint32_t b[kBanks][MT][2];
#pragma unroll
        for (int q = 0; q < kBanks; ++q) {
          if (i0 + q < steps) {
            const int j = kp + n_kp * (i0 + q);
            if constexpr (kQuant) {
              const int r = j * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
              uint32_t d0, d1;
              ldsm_x2_trans(d0, d1, wst + r * row_bytes + (swz(r, cg, C, lsh) << 4));
              a[q][0] = codes_to_bf16x2(d0);        // (k 2t, 2t+1; column 2g)
              a[q][1] = codes_to_bf16x2(d0 >> 8);   // (k 2t, 2t+1; column 2g + 1)
              a[q][2] = codes_to_bf16x2(d1);        // k + 8
              a[q][3] = codes_to_bf16x2(d1 >> 8);
            } else {
              const int mat = lane >> 3;
              const int r = j * 16 + (lane & 7) + ((mat >> 1) << 3);
              ldsm_x4_trans(a[q], wst + r * row_bytes + (swz(r, 2 * cg + (mat & 1), C, lsh) << 4));
            }
            const int row = (lane & 7) + ((lane >> 4) << 3);
            const int col = j * 16 + (((lane >> 3) & 1) << 3);
#pragma unroll
            for (int jm = 0; jm < MT; jm += 2) {
              if (jm < mt) {
                const uint32_t addr = ast + (jm * 8 + row) * (kActStride * 2) + col * 2;
                if (jm + 1 < mt) {
                  uint32_t d[4];
                  ldsm_x4(d, addr);
                  b[q][jm][0] = d[0];
                  b[q][jm][1] = d[1];
                  b[q][jm + 1][0] = d[2];
                  b[q][jm + 1][1] = d[3];
                } else {
                  ldsm_x2(b[q][jm][0], b[q][jm][1], addr);
                }
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kBanks; ++q) {
          if (i0 + q < steps) {
#pragma unroll
            for (int jm = 0; jm < MT; ++jm) {
              if (jm < mt) {
                if constexpr (kQuant)
                  mma(part[q][jm], a[q], b[q][jm][0], b[q][jm][1]);
                else
                  mma(acc[q][jm], a[q], b[q][jm][0], b[q][jm][1]);
              }
            }
          }
        }
      }
    }
    if constexpr (kQuant) {   // fold at the group's end, or the slice's
      const int kend = kbase + (s + 1) * kStageRows;
      if (kend % p.group == 0 || s == nst - 1) {
        const float* sc = reinterpret_cast<const float*>(smem + (s % ring) * stage_bytes + w_bytes);
        const float s0 = sc[vc0], s1 = sc[vc1];
#pragma unroll
        for (int q = 0; q < kBanks; ++q)
#pragma unroll
          for (int jm = 0; jm < MT; ++jm) {
            acc[q][jm][0] = fmaf(part[q][jm][0], s0, acc[q][jm][0]);
            acc[q][jm][1] = fmaf(part[q][jm][1], s0, acc[q][jm][1]);
            acc[q][jm][2] = fmaf(part[q][jm][2], s1, acc[q][jm][2]);
            acc[q][jm][3] = fmaf(part[q][jm][3], s1, acc[q][jm][3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) part[q][jm][e] = 0.f;
          }
      }
    }
    __syncthreads();   // the slot is free for stage s + kStages
  }

  // the warps' sums (banks in order), [k phase][row][column], then summed in
  // phase order into phase 0
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int jm = 0; jm < MT; ++jm) {
    if (jm < mt) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[0][jm][e];
#pragma unroll
        for (int q = 1; q < kBanks; ++q) v[e] += acc[q][jm][e];
      }
      float* r0 = red + (size_t)(kp * mrows + jm * 8 + 2 * t) * vt;
      r0[vc0] = v[0];
      r0[vt + vc0] = v[1];
      r0[vc1] = v[2];
      r0[vt + vc1] = v[3];
    }
  }
  __syncthreads();
  for (int i = tid; i < M * vt; i += kThreads) {
    float v = red[i];
    for (int q = 1; q < n_kp; ++q) v += red[(size_t)q * mrows * vt + i];
    red[i] = v;
  }
  __syncthreads();

  if (n_splits > 1) {   // M x vt floats a block, vt a multiple of 16: float4 copies
    const int span4 = M * vt / 4;
    float4* red4 = reinterpret_cast<float4*>(red);
    const float4* ws4 = reinterpret_cast<const float4*>(p.ws) + (size_t)tile * span4;
    const size_t slice4 = (size_t)n_tiles * span4;   // float4s from one slice's partials to the next
    float4* mine = reinterpret_cast<float4*>(p.ws) + (size_t)tile * span4 + split * slice4;
    for (int i = tid; i < span4; i += kThreads) mine[i] = red4[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) last_sm = atomicAdd(p.tickets + tile, 1) == n_splits - 1;
    __syncthreads();
    if (!last_sm) return;
    __threadfence();
    for (int i = tid; i < span4; i += kThreads) {   // slice order: bits independent of arrival
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int q = 0; q < n_splits; ++q) {
        const float4 u = __ldcg(ws4 + q * slice4 + i);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      red4[i] = v;
    }
    if (tid == 0) p.tickets[tile] = 0;
    __syncthreads();
  }

  // The epilogue, once per output: each thread loads the inputs of its
  // next kEpi outputs (read-only: bias, x, r1), then writes them, so the
  // loads do not wait behind the stores.
  constexpr int kEpi = 4;
  for (int i0 = tid; i0 < M * nt; i0 += kEpi * kThreads) {
    float bias[kEpi], res[kEpi];
#pragma unroll
    for (int u = 0; u < kEpi; ++u) {
      const int i = i0 + u * kThreads;
      bias[u] = res[u] = 0.f;
      if (i < M * nt) {
        const int m = i / nt, n = n0 + i - m * nt;
        const size_t o = (size_t)m * p.N + n;
        if (p.bias) bias[u] = to_float(__ldg(p.bias + n));
        if constexpr (MODE == kOProjResidual) res[u] = to_float(__ldg(p.resid + o));
        if constexpr (MODE == kDownResidual) res[u] = __ldg(p.resid_f + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kEpi; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= M * nt) continue;
      const int m = i / nt, c = i - m * nt;
      const size_t o = (size_t)m * p.N + n0 + c;
      const float v = red[m * vt + c];
      if constexpr (kPair) {
        static_cast<bf16*>(p.out)[o] = from_float<bf16>(swiglu(v, red[m * vt + nt + c]));
      } else if constexpr (MODE == kMatmul) {
        static_cast<float*>(p.out)[o] = v;
      } else if constexpr (MODE == kDownResidual) {
        float out = res[u] + v;
        if (p.bias) out += bias[u];
        static_cast<bf16*>(p.out)[o] = from_float<bf16>(out);
      } else if constexpr (MODE == kNormProj) {
        static_cast<bf16*>(p.out)[o] = from_float<bf16>(v + bias[u]);
      } else if constexpr (MODE == kOProjResidual) {
        static_cast<float*>(p.out)[o] = (res[u] + v) + bias[u];
      } else {
        const float x = v + bias[u];
        static_cast<bf16*>(p.out)[o] = from_float<bf16>(p.exact_gelu ? gelu_erf(x) : gelu_tanh(x));
      }
    }
  }
}

// ---- the norm: statistics once per call --------------------------------------

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) s += red[w];
  __syncthreads();   // red is free again
  return s;
}

// out[m] = cast(norm(src[m])): one block per row. LayerNorm: the fp32 mean,
// then the variance about it; RMSNorm: mean(x^2); then the row normalised
// in fp32 and cast to bf16, the operand the next GEMV stages. A row of up
// to kNormThreads * kNormPer elements is read once, into registers; a longer
// one is read again for each pass.
template <typename S>
__global__ void __launch_bounds__(kNormThreads)
norm_rows_kernel(const S* __restrict__ src, const float* __restrict__ ns,
                 const float* __restrict__ nb, float eps, int rms, bf16* __restrict__ out, int E) {
  constexpr int kChunk = kNormThreads * kNormPer;
  __shared__ float red[kNormThreads / 32];
  pdl_trigger();
  pdl_wait();
  const S* x = src + (size_t)blockIdx.x * E;
  bf16* y = out + (size_t)blockIdx.x * E;
  const int tid = threadIdx.x;
  float v[kNormPer];
  auto load = [&](int k0) {   // zeros past E
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) {
      const int k = k0 + tid + i * kNormThreads;
      v[i] = k < E ? to_float(x[k]) : 0.f;
    }
  };
  load(0);
  float mean = 0.f;
  if (!rms) {
    float s = 0.f;
    for (int k0 = 0; k0 < E; k0 += kChunk) {
      if (k0) load(k0);
#pragma unroll
      for (int i = 0; i < kNormPer; ++i) s += v[i];
    }
    mean = block_sum(s, red) / E;
  }
  float q = 0.f;
  for (int k0 = 0; k0 < E; k0 += kChunk) {
    if (E > kChunk) load(k0);
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) {
      if (k0 + tid + i * kNormThreads < E) {
        const float d = v[i] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / E + eps);
  for (int k0 = 0; k0 < E; k0 += kChunk) {
    if (E > kChunk) load(k0);
    float sc[kNormPer], sh[kNormPer];   // loaded before any store: none waits behind one
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) {
      const int k = k0 + tid + i * kNormThreads;
      sc[i] = k < E ? __ldg(ns + k) : 0.f;
      sh[i] = k < E && !rms ? __ldg(nb + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kNormPer; ++i) {
      const int k = k0 + tid + i * kNormThreads;
      if (k < E)
        y[k] = from_float<bf16>(rms ? v[i] * rstd * sc[i] : (v[i] - mean) * rstd * sc[i] + sh[i]);
    }
  }
}

// ---- host ---------------------------------------------------------------------

template <typename Kernel, typename... A>
cudaError_t launch_ex(Kernel kernel, dim3 grid, dim3 block, size_t smem, bool dependent,
                      cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;   // the attribute on dependent launches only
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline cudaError_t counted(cudaError_t err, int which) {
  if (err == cudaSuccess) ++g_launched[which];
  return err;
}

// Shared memory of one launch: the ring, or the warps' sums where larger.
template <typename W>
size_t smem_bytes(const Args<W>& a, bool pair) {
  const int vt = (pair ? 2 : 1) * a.n_tile;
  const int mrows = (a.M + 7) / 8 * 8;
  const size_t stage = (size_t)kStageRows * vt * sizeof(W) + (sizeof(W) == 1 ? vt * 4 : 0) +
                       (size_t)mrows * kActStride * 2;
  const int nst = a.k_slice / kStageRows;
  const size_t ring = (size_t)(nst < kStages ? nst : kStages) * stage;
  const size_t red = (size_t)kWarps * 16 * mrows * 4;
  return ring > red ? ring : red;
}

// dependent: launched with programmatic stream serialization (it overlaps
// the previous kernel's tail up to its griddepcontrol.wait).
template <typename W, int MODE>
cudaError_t launch(const Args<W>& a, bool dependent, cudaStream_t stream) {
  constexpr bool kPair = MODE == kNormGateUp;
  const int nt = a.n_tile, vt = (kPair ? 2 : 1) * nt;
  if (a.M < 1 || a.M > kMaxRows || (nt != 16 && nt != 32 && nt != 64) || vt > kMaxCols ||
      nt * (int)sizeof(W) < 32 || a.N % nt || a.k_slice <= 0 || a.k_slice % kStageRows ||
      a.K % a.k_slice)
    return cudaErrorInvalidValue;
  if (std::is_same<W, int8_t>::value &&
      (a.group <= 0 || a.group % kStageRows || a.K % a.group))
    return cudaErrorInvalidValue;
  if (a.K / a.k_slice > 1 && (!a.ws || !a.tickets)) return cudaErrorInvalidValue;
  const bool wide = a.M > 16;
  auto kernel = wide ? gemv_sm90_kernel<W, MODE, 8> : gemv_sm90_kernel<W, MODE, 2>;
  static std::atomic<bool> sized[2]{};
  if (!sized[wide].load()) {
    // the largest shared-memory carveout, so that as many blocks share an SM
    // as their shared memory allows (left to the driver, one may run alone)
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    sized[wide].store(true);
  }
  const dim3 grid(a.N / nt, a.K / a.k_slice);
  const cudaError_t err =
      launch_ex(kernel, grid, dim3(kThreads), smem_bytes(a, kPair), dependent, stream, a);
  return counted(err, std::is_same<W, int8_t>::value ? 1 : 0);
}

template <typename S>
cudaError_t launch_norm(const S* src, const float* ns, const float* nb, float eps, int rms,
                        bf16* out, int M, int E, bool dependent, cudaStream_t stream) {
  if (M < 1 || M > kMaxRows || E < 1) return cudaErrorInvalidValue;
  return counted(launch_ex(norm_rows_kernel<S>, dim3(M), dim3(kNormThreads), 0, dependent, stream,
                           src, ns, nb, eps, rms, out, E),
                 2);
}

}  // namespace gemv90
}  // namespace ds
