// Fused AdamW over int8 / uint8 moments with a row-absmax requant: one
// pass over each parameter leaf.
//
// Replaces the TPU kernel _kernel
// (deepspeed_tpu/ops/pallas/adam8bit_kernel.py:55).
//
// Per element of a (R, C) leaf, with the step scalars [gscale, lr, c1, c2]
// read from a 4-float device array (the TPU kernel's SMEM operand):
//   g  = g * gscale (+ l2 * p)
//   m  = b1 * (mc * scm) + (1 - b1) * g
//   r0 = rc * scr;  v = b2 * r0^2 + (1 - b2) * g^2;  r = sqrt(v)
//   upd = (m * (1/c1)) / (r * (1/sqrt(c2)) + eps) (+ wd * p)
//   p' = p - lr * upd
// and per row the new codes and scales from the row's absmax:
//   mc' = clip(rint(m * 127/amax|m|), -127, 127), scm' = amax|m| / 127
//   rc' = clip(rint(r * 255/amax r),    0, 255), scr' = amax r / 255
// (a zero absmax gives scale 1). p, mc, rc, scm and scr are updated in
// place, as the TPU kernel's input_output_aliases do.
//
// Bound on the H100: bytes. Each element reads g and p (fp32) and the two
// codes and writes p and the two codes: 16 bytes, against a few dozen
// flops; at GPT-2-1.5B (1.56e9 elements) that is 24.9 GB, 7.4 ms at
// 3.35 TB/s.
//
// Design: one block per row. A row's codes depend on the whole row's
// absmax, so every element's m and r must be known before any code is
// written. Pass 1 forms m and r, reduces the two maxima over the block and
// stages m and r in shared memory when the row fits (C <= kMaxStaged);
// pass 2 reads them back (or, for longer rows, recomputes them from the
// still unmodified inputs: the same function on the same values) and
// writes p and the codes. Every thread reads the row's old scales before
// the barrier that ends pass 1, and only then does thread 0 write the new
// ones. The arithmetic uses the _rn intrinsics, so nvcc contracts nothing
// into an FMA: both passes and the plain PyTorch version round at the same
// points. rintf rounds half to even, as jnp.round does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStaged = 12288;  // m and r of a row in shared memory: 96 KB

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd, l2;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// m and r of one element: the same instructions in both passes
__device__ __forceinline__ void moments(float g, float p, signed char mc, unsigned char rc,
                                        float scm, float scr, float gscale, const Hyper& a,
                                        float& m, float& r) {
  g = __fmul_rn(g, gscale);
  if (a.l2 != 0.f) g = __fadd_rn(g, __fmul_rn(a.l2, p));
  m = __fadd_rn(__fmul_rn(a.b1, __fmul_rn(static_cast<float>(mc), scm)), __fmul_rn(a.omb1, g));
  const float r0 = __fmul_rn(static_cast<float>(rc), scr);
  const float v =
      __fadd_rn(__fmul_rn(a.b2, __fmul_rn(r0, r0)), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  r = __fsqrt_rn(v);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
adam8bit_kernel(const float* __restrict__ g, float* __restrict__ p, signed char* __restrict__ mc,
                unsigned char* __restrict__ rc, float* __restrict__ scm,
                float* __restrict__ scr, const float* __restrict__ scalars, int C, Hyper a) {
  extern __shared__ float staged[];  // m[C] then r[C] (kStaged only)
  __shared__ float red[2][kWarps];

  const size_t row = blockIdx.x;
  const size_t off = row * static_cast<size_t>(C);
  const float* gr = g + off;
  float* pr = p + off;
  signed char* mr = mc + off;
  unsigned char* rr = rc + off;

  const float gscale = scalars[0], lr = scalars[1];
  const float inv_c1 = __fdiv_rn(1.f, scalars[2]);
  const float rs_c2 = __fdiv_rn(1.f, __fsqrt_rn(scalars[3]));
  const float scm_old = scm[row], scr_old = scr[row];  // read before the barrier below

  float am = 0.f, ar = 0.f;
  for (int j = threadIdx.x; j < C; j += kThreads) {
    float m, r;
    moments(gr[j], pr[j], mr[j], rr[j], scm_old, scr_old, gscale, a, m, r);
    am = fmaxf(am, fabsf(m));
    ar = fmaxf(ar, r);
    if (kStaged) {
      staged[j] = m;
      staged[C + j] = r;
    }
  }
  am = warp_max(am);
  ar = warp_max(ar);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = am;
    red[1][warp] = ar;
  }
  __syncthreads();  // every thread has read scm_old / scr_old and staged its m, r
  am = red[0][0];
  ar = red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    am = fmaxf(am, red[0][w]);
    ar = fmaxf(ar, red[1][w]);
  }
  if (threadIdx.x == 0) {
    scm[row] = am > 0.f ? __fmul_rn(am, static_cast<float>(1.0 / 127.0)) : 1.f;
    scr[row] = ar > 0.f ? __fmul_rn(ar, static_cast<float>(1.0 / 255.0)) : 1.f;
  }
  const float inv_m = am > 0.f ? __fdiv_rn(127.f, am) : 1.f;
  const float inv_r = ar > 0.f ? __fdiv_rn(255.f, ar) : 1.f;

  for (int j = threadIdx.x; j < C; j += kThreads) {
    const float pj = pr[j];
    float m, r;
    if (kStaged) {
      m = staged[j];
      r = staged[C + j];
    } else {
      moments(gr[j], pj, mr[j], rr[j], scm_old, scr_old, gscale, a, m, r);
    }
    float upd = __fdiv_rn(__fmul_rn(m, inv_c1), __fadd_rn(__fmul_rn(r, rs_c2), a.eps));
    if (a.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(a.wd, pj));
    pr[j] = __fsub_rn(pj, __fmul_rn(lr, upd));
    mr[j] = static_cast<signed char>(fminf(fmaxf(rintf(__fmul_rn(m, inv_m)), -127.f), 127.f));
    rr[j] = static_cast<unsigned char>(fminf(fmaxf(rintf(__fmul_rn(r, inv_r)), 0.f), 255.f));
  }
}

}  // namespace

DS_DEFINE_ERROR_STRING

// g, p (R, C) fp32; mc (R, C) int8; rc (R, C) uint8; scm, scr (R, 1) fp32;
// scalars [gscale, lr, c1, c2] fp32, all on the device. Updates p, mc, rc,
// scm and scr in place. Returns the cudaGetLastError() of the launch.
DS_EXPORT int adam8bit_update(const void* g, void* p, void* mc, void* rc, void* scm, void* scr,
                              const void* scalars, int R, int C, float b1, float b2, float omb1,
                              float omb2, float eps, float wd, float l2, void* stream) {
  if (R <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper a{b1, b2, omb1, omb2, eps, wd, l2};
  const auto* gf = static_cast<const float*>(g);
  auto* pf = static_cast<float*>(p);
  auto* mcp = static_cast<signed char*>(mc);
  auto* rcp = static_cast<unsigned char*>(rc);
  auto* scmf = static_cast<float*>(scm);
  auto* scrf = static_cast<float*>(scr);
  const auto* sf = static_cast<const float*>(scalars);
  if (C <= kMaxStaged) {
    static bool attribute_set = false;
    if (!attribute_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          adam8bit_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(2 * kMaxStaged * sizeof(float)));
      if (err != cudaSuccess) return err;
      attribute_set = true;
    }
    const size_t smem = 2 * static_cast<size_t>(C) * sizeof(float);
    adam8bit_kernel<true><<<R, kThreads, smem, st>>>(gf, pf, mcp, rcp, scmf, scrf, sf, C, a);
  } else {
    adam8bit_kernel<false><<<R, kThreads, 0, st>>>(gf, pf, mcp, rcp, scmf, scrf, sf, C, a);
  }
  return cudaGetLastError();
}
