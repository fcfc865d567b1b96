// The two fused decode-layer kernels of a GPT-2 decode tick, with weights in
// the activation dtype or as W8A16 pairs (int8 codes + grouped fp32 scales).
//
// norm_proj_fwd / norm_proj_w8_fwd replace _norm_proj_kernel
// (deepspeed_tpu/ops/pallas/decode_layer.py:185):
//   out = cast(cast(LN(x)) @ W + b)        LN in fp32, product and bias in fp32
// post_attn_fwd / post_attn_w8_fwd replace _post_attn_kernel
// (decode_layer.py:344), GELU-tanh pair, LayerNorm, sequential residual:
//   r1  = x + y @ Wo + bo                  fp32, kept in fp32
//   hin = cast(LN(r1))
//   h   = cast(gelu_tanh(hin @ W1 + b1))
//   out = cast(r1 + h @ W2 + b2)
// "cast" is the activation dtype; the cast points are the TPU kernel's. In
// the W8 entries each "@ W" is the TPU kernels' _qdot_any (decode_layer.py
// :160): codes upcast to the activation's values, per-group fp32 partials
// times the group's scale.
//
// Bound on the H100: bytes (rows_gemv.cuh). Every product is the
// row-batched GEMV of rows_gemv.cuh. The TPU kernel carried r1, hin and the
// accumulator across a sequential grid; Hopper blocks run in no order, so
// post_attn makes three launches with a grid-wide step between them: o-proj
// + residual into an fp32 scratch r1, then norm + up-proj + GELU into a
// scratch h, then down-proj + residual. The down projection's K is F; its
// scale groups (g = 128 at every GPT-2 preset, or one group of F) fold at
// each group's end and at each 1024-row chunk's end (rows_gemv.cuh).
#include "rows_gemv.cuh"

namespace {

namespace gv = ds::gemv;

// A weight operand: the panel, and for int8 codes its scales and group size.
template <typename W>
struct Weight {
  const W* w;
  const float* scale;
  int group;
};

template <typename T, typename W>
cudaError_t norm_proj(const void* x, const float* ns, const float* nb, Weight<W> w,
                      const void* b, void* out, int M, int E, int N, float eps,
                      cudaStream_t stream) {
  gv::Args<T, T, W> a{};
  a.src = static_cast<const T*>(x);
  a.ns = ns;
  a.nb = nb;
  a.eps = eps;
  a.w = w.w;
  a.scale = w.scale;
  a.group = w.group;
  a.bias = static_cast<const T*>(b);
  a.out = out;
  a.M = M;
  a.K = E;
  a.N = N;
  return gv::launch<T, T, W, gv::kNormProj>(a, stream);
}

template <typename T, typename W>
cudaError_t post_attn(const void* y, const void* x, Weight<W> wo, const void* bo,
                      const float* ns, const float* nb, Weight<W> w1, const void* b1,
                      Weight<W> w2, const void* b2, float* r1, void* h, void* out,
                      int M, int E, int F, float eps, cudaStream_t stream) {
  gv::Args<T, T, W> o{};  // r1 = x + y @ Wo + bo
  o.src = static_cast<const T*>(y);
  o.w = wo.w;
  o.scale = wo.scale;
  o.group = wo.group;
  o.bias = static_cast<const T*>(bo);
  o.resid = static_cast<const T*>(x);
  o.out = r1;
  o.M = M;
  o.K = E;
  o.N = E;
  cudaError_t err = gv::launch<T, T, W, gv::kOProjResidual>(o, stream);
  if (err != cudaSuccess) return err;

  gv::Args<T, float, W> u{};  // h = gelu(LN(r1) @ W1 + b1)
  u.src = r1;
  u.ns = ns;
  u.nb = nb;
  u.eps = eps;
  u.w = w1.w;
  u.scale = w1.scale;
  u.group = w1.group;
  u.bias = static_cast<const T*>(b1);
  u.out = h;
  u.M = M;
  u.K = E;
  u.N = F;
  err = gv::launch<T, float, W, gv::kNormUpGelu>(u, stream);
  if (err != cudaSuccess) return err;

  gv::Args<T, T, W> d{};  // out = r1 + h @ W2 + b2
  d.src = static_cast<const T*>(h);
  d.w = w2.w;
  d.scale = w2.scale;
  d.group = w2.group;
  d.bias = static_cast<const T*>(b2);
  d.resid_f = r1;
  d.out = out;
  d.M = M;
  d.K = F;
  d.N = E;
  return gv::launch<T, T, W, gv::kDownResidual>(d, stream);
}

template <typename T>
Weight<T> dense(const void* w) {
  return {static_cast<const T*>(w), nullptr, 0};
}

Weight<int8_t> w8(const void* codes, const void* scale, int group) {
  return {static_cast<const int8_t*>(codes), static_cast<const float*>(scale), group};
}

}  // namespace

DS_DEFINE_ERROR_STRING

// x (M, E); ns, nb (E,) fp32; w (E, N); b (N,); out (M, N). x, w, b and out
// share one dtype. Returns the cudaGetLastError() of the launch.
DS_EXPORT int norm_proj_fwd(const void* x, const void* ns, const void* nb, const void* w,
                            const void* b, void* out, int M, int E, int N, float eps,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  if (dtype == ds::kBFloat16)
    return norm_proj<ds::bf16>(x, nsf, nbf, dense<ds::bf16>(w), b, out, M, E, N, eps, st);
  if (dtype == ds::kFloat32)
    return norm_proj<float>(x, nsf, nbf, dense<float>(w), b, out, M, E, N, eps, st);
  return cudaErrorInvalidValue;
}

// As norm_proj_fwd with W8A16 weights: codes int8 (E, N), scales fp32
// (E / g, N), g the group size (E for one group).
DS_EXPORT int norm_proj_w8_fwd(const void* x, const void* ns, const void* nb,
                               const void* codes, const void* scale, int g, const void* b,
                               void* out, int M, int E, int N, float eps, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  if (dtype == ds::kBFloat16)
    return norm_proj<ds::bf16>(x, nsf, nbf, w8(codes, scale, g), b, out, M, E, N, eps, st);
  if (dtype == ds::kFloat32)
    return norm_proj<float>(x, nsf, nbf, w8(codes, scale, g), b, out, M, E, N, eps, st);
  return cudaErrorInvalidValue;
}

// y, x (M, E); wo (E, E); bo (E,); ns, nb (E,) fp32; w1 (E, F); b1 (F,);
// w2 (F, E); b2 (E,); scratch r1 (M, E) fp32 and h (M, F); out (M, E).
// Three launches; returns the first non-zero cudaGetLastError(), else 0.
DS_EXPORT int post_attn_fwd(const void* y, const void* x, const void* wo, const void* bo,
                            const void* ns, const void* nb, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* r1, void* h, void* out,
                            int M, int E, int F, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16)
    return post_attn<ds::bf16>(y, x, dense<ds::bf16>(wo), bo, nsf, nbf, dense<ds::bf16>(w1),
                               b1, dense<ds::bf16>(w2), b2, r1f, h, out, M, E, F, eps, st);
  if (dtype == ds::kFloat32)
    return post_attn<float>(y, x, dense<float>(wo), bo, nsf, nbf, dense<float>(w1), b1,
                            dense<float>(w2), b2, r1f, h, out, M, E, F, eps, st);
  return cudaErrorInvalidValue;
}

// As post_attn_fwd with W8A16 weights: each of wo, w1, w2 is codes (int8,
// the panel's shape) + scales (fp32, (K / g, N)) + its group size g.
DS_EXPORT int post_attn_w8_fwd(const void* y, const void* x, const void* co, const void* so,
                               int go, const void* bo, const void* ns, const void* nb,
                               const void* c1, const void* s1, int g1, const void* b1,
                               const void* c2, const void* s2, int g2, const void* b2,
                               void* r1, void* h, void* out, int M, int E, int F, float eps,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16)
    return post_attn<ds::bf16>(y, x, w8(co, so, go), bo, nsf, nbf, w8(c1, s1, g1), b1,
                               w8(c2, s2, g2), b2, r1f, h, out, M, E, F, eps, st);
  if (dtype == ds::kFloat32)
    return post_attn<float>(y, x, w8(co, so, go), bo, nsf, nbf, w8(c1, s1, g1), b1,
                            w8(c2, s2, g2), b2, r1f, h, out, M, E, F, eps, st);
  return cudaErrorInvalidValue;
}
