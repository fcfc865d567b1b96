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
// Design: the tensor-core decode GEMV of decode_gemv_sm90.cuh in its plain
// matmul mode (kMatmul: no norm, no bias, fp32 out), one gemv_sm90_kernel
// launch a call. mma.sync m16n8k16 as out^T = W^T x^T, so one weight
// fragment serves all of the (up to 64) rows and each code byte is read
// once; codes become bf16 by bits; a fresh fp32 partial per scale group,
// folded times the group's scale at the group's end; K split over blocks
// by the host's plan (ops/decode_layer.gemv_plan), streamed through a
// three-stage cp.async ring, the slices' fp32 partials summed in slice
// order by each column tile's last block (the workspace and tickets come
// from the wrapper and the tickets are reset by that block, so the call
// captures in a CUDA graph).
#include "decode_gemv_sm90.cuh"

DS_DEFINE_ERROR_STRING

namespace g9 = ds::gemv90;

// x (M, K) bf16; codes (K, N) int8; scale (K / g, N) fp32; out (M, N) fp32;
// ws the split partials (K / k_slice x M x N fp32, unread when K is not
// split), tickets one zeroed int32 per column tile; (n_tile, k_slice) the
// plan. Returns the cudaGetLastError() of the launch.
DS_EXPORT int w8a16_matmul_fwd(const void* x, const void* codes, const void* scale, int g,
                               void* out, void* ws, void* tickets, int M, int K, int N, int n_tile,
                               int k_slice, void* stream) {
  g9::Args<int8_t> a{};
  a.a = static_cast<const ds::bf16*>(x);
  a.w = static_cast<const int8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.group = g;
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.M = M;
  a.K = K;
  a.N = N;
  a.n_tile = n_tile;
  a.k_slice = k_slice;
  return g9::launch<int8_t, g9::kMatmul>(a, false, static_cast<cudaStream_t>(stream));
}

// Launches so far of gemv_sm90_kernel's W8 instantiations (which = 0),
// counted on the host where they are launched.
DS_EXPORT unsigned long long w8_matmul_launched(int which) {
  return which == 0 ? g9::g_launched[1].load() : 0;
}
