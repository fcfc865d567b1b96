// One tensor-core GEMM mainloop for Hopper (sm_90a), the structure of the
// fused CE head's ce_gemm (fused_ce.cu) lifted out and templated on the
// operands' majorness, the tile width, the number of products that share
// an output tile, the stage count and an epilogue, in two schedules: gemm
// (both consumer warpgroups on one 128-row tile) and gemm_pingpong (each
// warpgroup on whole tiles, in turns). The fused FFN's bf16 forward and dx
// kernels (fused_mlp.cu) are built on it.
//
// A CTA computes 128-row output tiles: two consumer warpgroups, each with a
// 64 x BN fp32 accumulator per product in registers (wgmma m64nBNk16,
// operands from shared memory; BN = 192 as n128 + n64), and one producer
// warp whose first lane keeps a ring of stages in flight by TMA: 64 of the
// contraction a stage, [64][64] boxes in the 128-byte swizzle
// (sm90::matrix_map), each stage on a "full" mbarrier and freed on an
// "empty" one that every consumer warp arrives on once the wgmma reading it
// has retired (one group kept in flight: wgmma_wait<1> before the release).
// A CTA walks the output tiles [t0, t1) of one row block, so the producer
// loads the next tile's stages while the consumers run this one's epilogue.
//
// Operands. A is (rows, K) as stored, K-major, read as [64 rows][64 k]
// boxes at (k, row). B is either K-major, (N, K) as stored ([64 n][64 k]
// boxes at (k, n): TB = 0), or MN-major, (K, N) as stored ([64 k][64 n]
// boxes at (n, k), read through wgmma's transpose bit: TB = 1). With two
// products (NP = 2), both contract over the same K into two accumulators
// of the same output tile, and a stage holds both products' tiles. Boxes
// past a tensor's edge read as zeros (and count their full bytes on the
// mbarrier), so no loop branches on an edge.
#pragma once

#include "flash_sm90.cuh"

namespace ds {
namespace gemm90 {

namespace s9 = ds::sm90;
using bf16 = ds::bf16;

constexpr int kTM = 128;                 // output rows a CTA: two warpgroups of 64
constexpr int kTK = 64;                  // contraction a stage: one 128-byte swizzle row
constexpr int kBox = 64 * 64;            // elements of a [64][64] swizzled box
constexpr int kThreads = 2 * 128 + 32;   // two consumer warpgroups, one producer warp

// One product's tensor maps: A, and B of the majorness the Config names.
struct Product {
  const CUtensorMap* a;
  const CUtensorMap* b;
};

// BN output columns a tile; NP products (1 or 2); TB0, TB1 the products'
// B majorness (1: MN-major); STAGES stages; OUT_BOXES [64][64] bf16 boxes
// of shared memory after the ring for the epilogue's stores (0: none).
template <int BN_, int NP_, int TB0_, int TB1_, int STAGES_, int OUT_BOXES_>
struct Config {
  static constexpr int BN = BN_, NP = NP_, TB0 = TB0_, TB1 = TB1_, STAGES = STAGES_;
  static constexpr int NB = BN / 64;                         // B boxes a product
  static constexpr int PROD = (2 + NB) * kBox;               // elements of a product's stage
  static constexpr int STAGE = NP * PROD * 2;                // bytes of a stage
  static constexpr int OUT = STAGES * STAGE;                 // the epilogue's buffer
  static constexpr int BAR = OUT + OUT_BOXES_ * kBox * 2;    // the mbarriers
  static constexpr int SMEM = 1024 + BAR + (2 * STAGES + 1) * 8;   // 1024: alignment
  static_assert(BN == 128 || BN == 192, "tile width");
  static_assert(NP == 1 || NP == 2, "products");
  static_assert(SMEM <= 232448, "a CTA's shared memory on the H100");
};

// B's descriptor for k16 step kk of a stage's B tile.
template <int TB>
__device__ __forceinline__ uint64_t b_desc(const bf16* sb, int kk) {
  return TB ? s9::mnmajor_desc(sb + kk * 16 * 64, 64 * 128) : s9::kmajor_desc(sb + kk * 16);
}

// d (64 x BN) += A B over one k16 step; BN = 192 as n128 then n64, whose
// B columns start two boxes in (row 128 of a K-major tile, column block 2
// of an MN-major one) and whose accumulators follow n128's: the layout of
// one m64n192 accumulator.
template <int BN, int TB>
__device__ __forceinline__ void mma_k16(float (&d)[BN / 2], uint64_t da, const bf16* sb, int kk,
                                        int acc) {
  if constexpr (BN == 192) {
    s9::wgmma_ss<128, 0, TB>(*reinterpret_cast<float(*)[64]>(&d[0]), da, b_desc<TB>(sb, kk), acc);
    s9::wgmma_ss<64, 0, TB>(*reinterpret_cast<float(*)[32]>(&d[64]), da,
                            b_desc<TB>(sb + 2 * kBox, kk), acc);
  } else {
    s9::wgmma_ss<BN, 0, TB>(d, da, b_desc<TB>(sb, kk), acc);
  }
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) s9::mbar_arrive(bar);
}

// Where a consumer thread's accumulator lies: rows row0 + rw and + 8 of
// the CTA's tile (row0 = m0 + 64 wg), columns 8 j + 2 t + {0, 1} of the
// output tile: acc[4 j + 2 rr + c] at row rw + 8 rr, column 8 j + 2 t + c.
struct Frag {
  int wg, rw, t, row0;
};

// The CTA's output tiles [t0, t1) of BN columns at rows m0 .. m0 + 127, each
// over KB stages of the contraction from k0: epi(acc, n0, frag, buf) after
// each tile's products (acc[p] the product p's accumulator; buf the OUT
// region of shared memory). The producer warp returns at once.
template <class C, class Epi>
__device__ __forceinline__ void gemm(const Product (&prod)[C::NP], int m0, int t0, int t1, int k0,
                                     int KB, Epi&& epi) {
  constexpr int ST = C::STAGES, NB = C::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = s9::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

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
        const int n0 = t * C::BN;
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % ST, k = k0 + kb * kTK;
          if (it >= ST) s9::mbar_wait(&empty[s], ((it / ST) - 1) & 1);
          bf16* st = reinterpret_cast<bf16*>(sm + s * C::STAGE);
          s9::mbar_expect_tx(&full[s], C::STAGE);
#pragma unroll
          for (int p = 0; p < C::NP; ++p) {
            bf16* sa = st + p * C::PROD;
            bf16* sb = sa + 2 * kBox;
            const int tb = p == 0 ? C::TB0 : C::TB1;
#pragma unroll
            for (int i = 0; i < 2; ++i) s9::tma_load_2d(sa + i * kBox, prod[p].a, &full[s], k, m0 + 64 * i);
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              if (tb)   // (K, N) as stored: [64 k][64 n] at (n, k)
                s9::tma_load_2d(sb + j * kBox, prod[p].b, &full[s], n0 + 64 * j, k);
              else      // (N, K) as stored: [64 n][64 k] at (k, n)
                s9::tma_load_2d(sb + j * kBox, prod[p].b, &full[s], k, n0 + 64 * j);
            }
          }
        }
      }
    }
    return;
  }

  Frag fr;
  fr.wg = warp / 4;
  fr.rw = 16 * (warp % 4) + lane / 4;
  fr.t = lane % 4;
  fr.row0 = m0 + 64 * fr.wg;
  bf16* buf = reinterpret_cast<bf16*>(sm + C::OUT);

  float acc[C::NP][C::BN / 2];
  int it = 0;
  for (int t = t0; t < t1; ++t) {
#pragma unroll
    for (int p = 0; p < C::NP; ++p) s9::fence_regs(acc[p]);
    for (int kb = 0; kb < KB; ++kb, ++it) {
      const int s = it % ST;
      s9::mbar_wait(&full[s], (it / ST) & 1);
      const bf16* st = reinterpret_cast<const bf16*>(sm + s * C::STAGE);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int scale = (kb | kk) != 0;
        const bf16* s0 = st;
        mma_k16<C::BN, C::TB0>(acc[0], s9::kmajor_desc(s0 + fr.wg * kBox + kk * 16),
                               s0 + 2 * kBox, kk, scale);
        if constexpr (C::NP == 2) {
          const bf16* s1 = st + C::PROD;
          mma_k16<C::BN, C::TB1>(acc[C::NP - 1], s9::kmajor_desc(s1 + fr.wg * kBox + kk * 16),
                                 s1 + 2 * kBox, kk, scale);
        }
      }
      s9::wgmma_commit();
      s9::wgmma_wait<1>();   // the previous stage's products have read it
      if (kb > 0) release(&empty[(it - 1) % ST], lane);
    }
    s9::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < C::NP; ++p) s9::fence_regs(acc[p]);
    release(&empty[(it - 1) % ST], lane);
    epi(acc, t * C::BN, fr, buf);
  }
}

// Ping-pong: each consumer warpgroup computes whole 128-row tiles (two
// m64 halves, acc[h] rows m0 + 64 h), the two taking the CTA's tiles [t0,
// t1) in turn (warpgroup w the tiles t0 + w, t0 + w + 2, ...), so that one's
// epilogue runs under the other's products. A warpgroup starts a tile's
// products only once the other has finished the previous tile's (an
// "order" barrier, one phase a tile), so the stages are consumed in the
// order the producer fills them and a full barrier is never waited on a
// phase early; a stage's "empty" barrier counts the consuming warpgroup's
// four warps. epi(acc, n0, frag, buf) with frag.row0 = m0. One product.
template <class C, class Epi>
__device__ __forceinline__ void gemm_pingpong(const Product& prod, int m0, int t0, int t1, int k0,
                                              int KB, Epi&& epi) {
  static_assert(C::NP == 1, "one product");
  constexpr int ST = C::STAGES, NB = C::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = s9::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + ST;
  uint64_t* order = empty + ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      s9::mbar_init(&full[s], 1);
      s9::mbar_init(&empty[s], 4);   // the consuming warpgroup's warps
    }
    s9::mbar_init(order, 4);
    s9::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {   // the producer warp: every tile's stages in tile order
    if (lane == 0) {
      int it = 0;
      for (int t = t0; t < t1; ++t) {
        const int n0 = t * C::BN;
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int s = it % ST, k = k0 + kb * kTK;
          if (it >= ST) s9::mbar_wait(&empty[s], ((it / ST) - 1) & 1);
          bf16* sa = reinterpret_cast<bf16*>(sm + s * C::STAGE);
          bf16* sb = sa + 2 * kBox;
          s9::mbar_expect_tx(&full[s], C::STAGE);
#pragma unroll
          for (int i = 0; i < 2; ++i) s9::tma_load_2d(sa + i * kBox, prod.a, &full[s], k, m0 + 64 * i);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            if (C::TB0)
              s9::tma_load_2d(sb + j * kBox, prod.b, &full[s], n0 + 64 * j, k);
            else
              s9::tma_load_2d(sb + j * kBox, prod.b, &full[s], k, n0 + 64 * j);
          }
        }
      }
    }
    return;
  }

  Frag fr;
  fr.wg = warp / 4;
  fr.rw = 16 * (warp % 4) + lane / 4;
  fr.t = lane % 4;
  fr.row0 = m0;
  bf16* buf = reinterpret_cast<bf16*>(sm + C::OUT);

  float acc[2][C::BN / 2];
  for (int t = t0 + fr.wg; t < t1; t += 2) {
    const int i = t - t0, base = i * KB;
    if (i > 0) s9::mbar_wait(order, (i - 1) & 1);   // tile i - 1's products are done
    s9::fence_regs(acc[0]);
    s9::fence_regs(acc[1]);
    for (int kb = 0; kb < KB; ++kb) {
      const int it = base + kb, s = it % ST;
      s9::mbar_wait(&full[s], (it / ST) & 1);
      const bf16* st = reinterpret_cast<const bf16*>(sm + s * C::STAGE);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int scale = (kb | kk) != 0;
        mma_k16<C::BN, C::TB0>(acc[0], s9::kmajor_desc(st + kk * 16), st + 2 * kBox, kk, scale);
        mma_k16<C::BN, C::TB0>(acc[1], s9::kmajor_desc(st + kBox + kk * 16), st + 2 * kBox, kk,
                               scale);
      }
      s9::wgmma_commit();
      s9::wgmma_wait<1>();
      if (kb > 0) release(&empty[(it - 1) % ST], lane);
    }
    s9::wgmma_wait<0>();
    s9::fence_regs(acc[0]);
    s9::fence_regs(acc[1]);
    release(&empty[(base + KB - 1) % ST], lane);
    release(order, lane);   // the other warpgroup may start tile i + 1
    epi(acc, t * C::BN, fr, buf);
  }
}

// The warpgroup's 128 x BN tile of v[2] (ping-pong: v[h] rows 64 h) cast to
// bf16, staged in its part of buf and stored by TMA at (n0, fr.row0 + 64 h).
template <int BN>
__device__ __forceinline__ void store_bf16_pp(const float (&v)[2][BN / 2], bf16* buf,
                                              const CUtensorMap* map, int n0, const Frag& fr) {
  bf16* out = buf + fr.wg * 2 * (BN / 64) * kBox;
  const bool issuer = threadIdx.x % 128 == 0;
  if (issuer) s9::bulk_wait_read();
  s9::bar_sync(1 + fr.wg, 128);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int col = 8 * j + 2 * fr.t;
        *reinterpret_cast<uint32_t*>(out + (h * (BN / 64) + col / 64) * kBox +
                                     s9::sw128_offset(fr.rw + 8 * rr, col % 64)) =
            s9::pack_bf16(v[h][4 * j + 2 * rr], v[h][4 * j + 2 * rr + 1]);
      }
  s9::fence_proxy_async();
  s9::bar_sync(1 + fr.wg, 128);
  if (issuer) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        s9::tma_store_2d(map, out + (h * (BN / 64) + b) * kBox, n0 + 64 * b, fr.row0 + 64 * h);
    s9::bulk_commit();
  }
}

// The warpgroup's 64 x BN tile of v (the accumulator layout) cast to bf16,
// staged in its part of buf in the 128-byte swizzle and stored by TMA at
// column n0, row fr.row0 of map (which clips rows and columns past its
// edges). One thread of the warpgroup issues the stores; before it reuses
// the buffer it waits until the previous tile's stores have read it, and
// store_done() waits for the last ones.
template <int BN>
__device__ __forceinline__ void store_bf16(const float (&v)[BN / 2], bf16* buf,
                                           const CUtensorMap* map, int n0, const Frag& fr) {
  bf16* out = buf + fr.wg * (BN / 64) * kBox;
  const bool issuer = threadIdx.x % 128 == 0;
  if (issuer) s9::bulk_wait_read();
  s9::bar_sync(1 + fr.wg, 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int col = 8 * j + 2 * fr.t;
      *reinterpret_cast<uint32_t*>(out + (col / 64) * kBox + s9::sw128_offset(fr.rw + 8 * rr, col % 64)) =
          s9::pack_bf16(v[4 * j + 2 * rr], v[4 * j + 2 * rr + 1]);
    }
  s9::fence_proxy_async();
  s9::bar_sync(1 + fr.wg, 128);
  if (issuer) {
#pragma unroll
    for (int b = 0; b < BN / 64; ++b) s9::tma_store_2d(map, out + b * kBox, n0 + 64 * b, fr.row0);
    s9::bulk_commit();
  }
}

__device__ __forceinline__ void store_done() {
  if (threadIdx.x % 128 == 0 && threadIdx.x < 256) s9::bulk_wait();
}

}  // namespace gemm90
}  // namespace ds
