// The two fused decode-layer kernels of a decode tick, with weights in the
// activation dtype or as W8A16 pairs (int8 codes + grouped fp32 scales), for
// GPT-2 (LayerNorm, GELU-tanh pair), LLaMA (RMSNorm, SwiGLU) and GPT-NeoX
// (LayerNorm, exact-GELU pair, parallel residual).
//
// norm_proj_fwd / norm_proj_w8_fwd replace _norm_proj_kernel
// (deepspeed_tpu/ops/pallas/decode_layer.py:185):
//   out = cast(cast(norm(x)) @ W + b)      norm in fp32, product and bias in fp32
// norm is LayerNorm, or with rms set RMSNorm, x * rsqrt(mean(x^2) + eps) *
// scale (no mean, no bias; the same fp32 reduction order as the LayerNorm
// variance).
// post_attn_fwd / post_attn_w8_fwd replace _post_attn_kernel
// (decode_layer.py:344), GELU pair:
//   r1  = x + y @ Wo + bo                  fp32, kept in fp32
//   hin = cast(norm(r1)), or cast(norm(x)) under the parallel residual
//   h   = cast(gelu(hin @ W1 + b1))        gelu_tanh, or with exact_gelu the erf form
//   out = cast(r1 + h @ W2 + b2)
// post_attn_swiglu_fwd / post_attn_swiglu_w8_fwd replace its SwiGLU branch
// (decode_layer.py:385-392), three MLP panels and no MLP biases:
//   r1  = x + y @ Wo + bo                  (bo zeros for LLaMA, as the JAX wrapper passes)
//   hin = cast(norm(r1)), or cast(norm(x)) under the parallel residual
//   h   = cast(silu(hin @ Wg) * (hin @ Wu))  gate and up fp32 products, h in fp32
//   out = cast(r1 + h @ Wd)
// "cast" is the activation dtype; the cast points are the TPU kernel's. In
// the W8 entries each "@ W" is the TPU kernels' _qdot_any (decode_layer.py
// :160): codes upcast to the activation's values, per-group fp32 partials
// times the group's scale; gate and up share the group size over E, the
// down panel has its own over F. The parallel residual (decode_layer.py
// :376) normalises the block input x, upcast to fp32, instead of r1; the
// output still adds r1, so it is x + attn + mlp.
//
// Bound on the H100: bytes (rows_gemv.cuh). Every product is the
// row-batched GEMV of rows_gemv.cuh. The TPU kernel carried r1, hin and the
// accumulator across a sequential grid; Hopper blocks run in no order, so
// post_attn makes three launches with a grid-wide step between them: o-proj
// + residual into an fp32 scratch r1, then norm + up-proj + GELU (or norm +
// gate/up + SwiGLU, both panels in one pass over the staged rows) into a
// scratch h, then down-proj + residual. Under the parallel residual the
// middle launch reads x (an Args<T, T, W> instantiation, the operand type
// norm_proj stages) and no longer depends on the first; the three launches
// stay in order on one stream. The down projection's K is F; its scale
// groups (g = 128, or one group of F) fold at each group's end and at each
// 1024-row chunk's end (rows_gemv.cuh).
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
                      const void* b, void* out, int M, int E, int N, float eps, int rms,
                      cudaStream_t stream) {
  gv::Args<T, T, W> a{};
  a.src = static_cast<const T*>(x);
  a.ns = ns;
  a.nb = nb;
  a.eps = eps;
  a.rms = rms;
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

// r1 = x + y @ Wo + bo, the first of post_attn's three launches.
template <typename T, typename W>
cudaError_t oproj_residual(const void* y, const void* x, Weight<W> wo, const void* bo,
                           float* r1, int M, int E, cudaStream_t stream) {
  gv::Args<T, T, W> o{};
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
  return gv::launch<T, T, W, gv::kOProjResidual>(o, stream);
}

// out = r1 + h @ W2 (+ b2 where given), the last of post_attn's launches.
template <typename T, typename W>
cudaError_t down_residual(const void* h, Weight<W> w2, const void* b2, const float* r1,
                          void* out, int M, int E, int F, cudaStream_t stream) {
  gv::Args<T, T, W> d{};
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

// The middle launch: norm over src (the fp32 r1 scratch, or x under the
// parallel residual), then the up panel with GELU (kNormUpGelu, w2 unused)
// or the gate and up panels with SwiGLU (kNormGateUp, no b1).
template <typename T, typename S, typename W, int MODE>
cudaError_t norm_up(const S* src, const float* ns, const float* nb, float eps, int rms,
                    Weight<W> w1, Weight<W> w2, const void* b1, int exact_gelu, void* h, int M,
                    int E, int F, cudaStream_t stream) {
  gv::Args<T, S, W> u{};
  u.src = src;
  u.ns = ns;
  u.nb = nb;
  u.eps = eps;
  u.rms = rms;
  u.exact_gelu = exact_gelu;
  u.w = w1.w;
  u.scale = w1.scale;
  u.group = w1.group;
  u.w2 = w2.w;
  u.scale2 = w2.scale;
  u.bias = static_cast<const T*>(b1);
  u.out = h;
  u.M = M;
  u.K = E;
  u.N = F;
  return gv::launch<T, S, W, MODE>(u, stream);
}

template <typename T, typename W, int MODE>
cudaError_t norm_up_from(int parallel, const void* x, const float* r1, const float* ns,
                         const float* nb, float eps, int rms, Weight<W> w1, Weight<W> w2,
                         const void* b1, int exact_gelu, void* h, int M, int E, int F,
                         cudaStream_t stream) {
  if (parallel)
    return norm_up<T, T, W, MODE>(static_cast<const T*>(x), ns, nb, eps, rms, w1, w2, b1,
                                  exact_gelu, h, M, E, F, stream);
  return norm_up<T, float, W, MODE>(r1, ns, nb, eps, rms, w1, w2, b1, exact_gelu, h, M, E, F,
                                    stream);
}

template <typename T, typename W>
cudaError_t post_attn(const void* y, const void* x, Weight<W> wo, const void* bo,
                      const float* ns, const float* nb, Weight<W> w1, const void* b1,
                      Weight<W> w2, const void* b2, float* r1, void* h, void* out,
                      int M, int E, int F, float eps, int rms, int exact_gelu, int parallel,
                      cudaStream_t stream) {
  cudaError_t err = oproj_residual<T>(y, x, wo, bo, r1, M, E, stream);
  if (err != cudaSuccess) return err;
  // h = gelu(norm(src) @ W1 + b1)
  err = norm_up_from<T, W, gv::kNormUpGelu>(parallel, x, r1, ns, nb, eps, rms, w1, Weight<W>{},
                                            b1, exact_gelu, h, M, E, F, stream);
  if (err != cudaSuccess) return err;
  return down_residual<T>(h, w2, b2, r1, out, M, E, F, stream);
}

template <typename T, typename W>
cudaError_t post_attn_swiglu(const void* y, const void* x, Weight<W> wo, const void* bo,
                             const float* ns, const float* nb, Weight<W> wg, Weight<W> wu,
                             Weight<W> wd, float* r1, void* h, void* out, int M, int E, int F,
                             float eps, int rms, int parallel, cudaStream_t stream) {
  if (wg.group != wu.group) return cudaErrorInvalidValue;
  cudaError_t err = oproj_residual<T>(y, x, wo, bo, r1, M, E, stream);
  if (err != cudaSuccess) return err;
  // h = silu(norm(src) @ Wg) * (norm(src) @ Wu)
  err = norm_up_from<T, W, gv::kNormGateUp>(parallel, x, r1, ns, nb, eps, rms, wg, wu, nullptr,
                                            0, h, M, E, F, stream);
  if (err != cudaSuccess) return err;
  return down_residual<T>(h, wd, nullptr, r1, out, M, E, F, stream);
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

// x (M, E); ns, nb (E,) fp32 (nb unread under rms); w (E, N); b (N,); out
// (M, N). x, w, b and out share one dtype. rms: RMSNorm instead of
// LayerNorm. Returns the cudaGetLastError() of the launch.
DS_EXPORT int norm_proj_fwd(const void* x, const void* ns, const void* nb, const void* w,
                            const void* b, void* out, int M, int E, int N, float eps, int rms,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  if (dtype == ds::kBFloat16)
    return norm_proj<ds::bf16>(x, nsf, nbf, dense<ds::bf16>(w), b, out, M, E, N, eps, rms, st);
  if (dtype == ds::kFloat32)
    return norm_proj<float>(x, nsf, nbf, dense<float>(w), b, out, M, E, N, eps, rms, st);
  return cudaErrorInvalidValue;
}

// As norm_proj_fwd with W8A16 weights: codes int8 (E, N), scales fp32
// (E / g, N), g the group size (E for one group).
DS_EXPORT int norm_proj_w8_fwd(const void* x, const void* ns, const void* nb,
                               const void* codes, const void* scale, int g, const void* b,
                               void* out, int M, int E, int N, float eps, int rms, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  if (dtype == ds::kBFloat16)
    return norm_proj<ds::bf16>(x, nsf, nbf, w8(codes, scale, g), b, out, M, E, N, eps, rms,
                               st);
  if (dtype == ds::kFloat32)
    return norm_proj<float>(x, nsf, nbf, w8(codes, scale, g), b, out, M, E, N, eps, rms, st);
  return cudaErrorInvalidValue;
}

// y, x (M, E); wo (E, E); bo (E,); ns, nb (E,) fp32; w1 (E, F); b1 (F,);
// w2 (F, E); b2 (E,); scratch r1 (M, E) fp32 and h (M, F); out (M, E).
// exact_gelu: the erf GELU (GPT-NeoX) instead of gelu_tanh; parallel: the
// MLP's norm reads x instead of r1. Three launches; returns the first
// non-zero cudaGetLastError(), else 0.
DS_EXPORT int post_attn_fwd(const void* y, const void* x, const void* wo, const void* bo,
                            const void* ns, const void* nb, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* r1, void* h, void* out,
                            int M, int E, int F, float eps, int rms, int exact_gelu,
                            int parallel, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16)
    return post_attn<ds::bf16>(y, x, dense<ds::bf16>(wo), bo, nsf, nbf, dense<ds::bf16>(w1),
                               b1, dense<ds::bf16>(w2), b2, r1f, h, out, M, E, F, eps, rms,
                               exact_gelu, parallel, st);
  if (dtype == ds::kFloat32)
    return post_attn<float>(y, x, dense<float>(wo), bo, nsf, nbf, dense<float>(w1), b1,
                            dense<float>(w2), b2, r1f, h, out, M, E, F, eps, rms, exact_gelu,
                            parallel, st);
  return cudaErrorInvalidValue;
}

// As post_attn_fwd with W8A16 weights: each of wo, w1, w2 is codes (int8,
// the panel's shape) + scales (fp32, (K / g, N)) + its group size g.
DS_EXPORT int post_attn_w8_fwd(const void* y, const void* x, const void* co, const void* so,
                               int go, const void* bo, const void* ns, const void* nb,
                               const void* c1, const void* s1, int g1, const void* b1,
                               const void* c2, const void* s2, int g2, const void* b2,
                               void* r1, void* h, void* out, int M, int E, int F, float eps,
                               int rms, int exact_gelu, int parallel, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16)
    return post_attn<ds::bf16>(y, x, w8(co, so, go), bo, nsf, nbf, w8(c1, s1, g1), b1,
                               w8(c2, s2, g2), b2, r1f, h, out, M, E, F, eps, rms, exact_gelu,
                               parallel, st);
  if (dtype == ds::kFloat32)
    return post_attn<float>(y, x, w8(co, so, go), bo, nsf, nbf, w8(c1, s1, g1), b1,
                            w8(c2, s2, g2), b2, r1f, h, out, M, E, F, eps, rms, exact_gelu,
                            parallel, st);
  return cudaErrorInvalidValue;
}

// The SwiGLU branch: y, x (M, E); wo (E, E); bo (E,); ns, nb (E,) fp32 (nb
// unread under rms); wg, wu (E, F); wd (F, E); scratch r1 (M, E) fp32 and h
// (M, F); out (M, E). No MLP biases. parallel: the norm reads x instead of
// r1. Three launches, as post_attn_fwd.
DS_EXPORT int post_attn_swiglu_fwd(const void* y, const void* x, const void* wo, const void* bo,
                                   const void* ns, const void* nb, const void* wg,
                                   const void* wu, const void* wd, void* r1, void* h, void* out,
                                   int M, int E, int F, float eps, int rms, int parallel,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16)
    return post_attn_swiglu<ds::bf16>(y, x, dense<ds::bf16>(wo), bo, nsf, nbf,
                                      dense<ds::bf16>(wg), dense<ds::bf16>(wu),
                                      dense<ds::bf16>(wd), r1f, h, out, M, E, F, eps, rms,
                                      parallel, st);
  if (dtype == ds::kFloat32)
    return post_attn_swiglu<float>(y, x, dense<float>(wo), bo, nsf, nbf, dense<float>(wg),
                                   dense<float>(wu), dense<float>(wd), r1f, h, out, M, E, F,
                                   eps, rms, parallel, st);
  return cudaErrorInvalidValue;
}

// As post_attn_swiglu_fwd with W8A16 weights: codes + scales + group size
// for each of wo, wg, wu (groups over E, gate and up equal) and wd (over F).
DS_EXPORT int post_attn_swiglu_w8_fwd(const void* y, const void* x, const void* co,
                                      const void* so, int go, const void* bo, const void* ns,
                                      const void* nb, const void* cg, const void* sg, int gg,
                                      const void* cu, const void* su, int gu, const void* cd,
                                      const void* sd, int gd, void* r1, void* h, void* out,
                                      int M, int E, int F, float eps, int rms, int parallel,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16)
    return post_attn_swiglu<ds::bf16>(y, x, w8(co, so, go), bo, nsf, nbf, w8(cg, sg, gg),
                                      w8(cu, su, gu), w8(cd, sd, gd), r1f, h, out, M, E, F,
                                      eps, rms, parallel, st);
  if (dtype == ds::kFloat32)
    return post_attn_swiglu<float>(y, x, w8(co, so, go), bo, nsf, nbf, w8(cg, sg, gg),
                                   w8(cu, su, gu), w8(cd, sd, gd), r1f, h, out, M, E, F, eps,
                                   rms, parallel, st);
  return cudaErrorInvalidValue;
}
