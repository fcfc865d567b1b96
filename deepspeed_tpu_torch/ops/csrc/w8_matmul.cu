// W8A16 matmul for decode rows: out = x @ dequant(codes, scale), fp32 out.
//
// Replaces _kernel of deepspeed_tpu/ops/pallas/w8_matmul.py:35: x (M, K)
// bf16 with M <= 64, codes int8 (K, N), scale fp32 (G, N) with G = 1 or
// g = K / G a multiple of 128. The TPU kernel streams one N panel's full-K
// codes through VMEM, upcasts each group tile to bf16 and adds
// part(u) * scale[u] into an fp32 accumulator.
//
// Bound on the H100: bytes. Each code byte read from memory feeds 2 * M
// flops (M <= 64), so reading the K x N codes once (plus the scales, x and
// the fp32 output) is the whole cost: 1536 x 4608 at M = 8 moves 7.47 MB,
// 2.23 us at 3.35 TB/s.
//
// Design: the row-batched GEMV of rows_gemv.cuh with int8 weights and no
// epilogue (kMatmul): a block owns 8 rows x 16 columns, 128 thread groups
// stride down K, each loading its 8 code rows (8 codes, 8 bytes each) of a
// staged 1024-row chunk up front, and each thread folds its per-group
// partial sums into its accumulator with the group's scale at the group's
// end (see rows_gemv.cuh). M > 8 runs 8-row blocks side by side, each
// reading the whole panel again: on the H100 M=64 takes 5-6x the M=8 time
// (PERF.md), so the re-reads are not served from L2 for free.
#include "rows_gemv.cuh"

DS_DEFINE_ERROR_STRING

// x (M, K) bf16; codes (K, N) int8; scale (K / g, N) fp32; out (M, N) fp32.
// Returns the cudaGetLastError() of the launch.
DS_EXPORT int w8a16_matmul_fwd(const void* x, const void* codes, const void* scale, int g,
                               void* out, int M, int K, int N, void* stream) {
  ds::gemv::Args<ds::bf16, ds::bf16, int8_t> a{};
  a.src = static_cast<const ds::bf16*>(x);
  a.w = static_cast<const int8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.group = g;
  a.out = out;
  a.M = M;
  a.K = K;
  a.N = N;
  return ds::gemv::launch<ds::bf16, ds::bf16, int8_t, ds::gemv::kMatmul>(
      a, static_cast<cudaStream_t>(stream));
}
