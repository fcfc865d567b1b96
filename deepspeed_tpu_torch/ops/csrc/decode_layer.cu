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
// Bound on the H100: bytes. The TPU kernel carried r1, hin and the
// accumulator across a sequential grid; Hopper blocks run in no order, so
// each product is a launch of its own with a grid-wide step between them.
//
// bf16 (the serving dtype) runs the tensor-core GEMV of decode_gemv_sm90.cuh,
// split over K: norm_rows_kernel takes each row's statistics once per call
// and writes the normalised operand cast to bf16, then one GEMV per panel.
// norm_proj: norm(x), then the projection. post_attn: o-proj + residual into
// the fp32 scratch r1, norm(r1) (under the parallel residual norm(x) comes
// first, since it reads only x), norm + up-proj + GELU (or gate/up +
// SwiGLU, both panels in one block) into the scratch h, then down-proj +
// residual. Every launch after a call's first is a programmatic dependent
// launch: its blocks start on the previous kernel's tail, issue their first
// weight stages, and wait (griddepcontrol.wait) before they read anything
// that kernel writes. The host's plan (ops/decode_layer.gemv_plan) gives
// each GEMV its column tile and K-slice; a split GEMV sums its slices'
// partials in the workspace by the last block of each column tile.
//
// fp32 runs the CUDA-core row-batched GEMV of rows_gemv.cuh: three
// launches for post_attn (o-proj + residual, norm + up, down + residual),
// one for norm_proj, each block taking its rows' statistics itself; the
// plan, workspace, tickets and bf16 scratch arguments are unread there.
#include <vector>

#include "decode_gemv_sm90.cuh"
#include "rows_gemv.cuh"

namespace {

namespace gv = ds::gemv;
namespace g9 = ds::gemv90;
using ds::bf16;

// launches of rows_gemv_kernel (the fp32 instantiations); the sm90 kernels
// count theirs in g9::g_launched
std::atomic<unsigned long long> g_rows_gemv_launched{0};

// err, after n more launches of rows_gemv_kernel where err is success
cudaError_t counted_rows(cudaError_t err, int n) {
  if (err == cudaSuccess) g_rows_gemv_launched += n;
  return err;
}

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


// ---- bf16: the tensor-core GEMV of decode_gemv_sm90.cuh --------------------

// One GEMV's column tile and K-slice (ops/decode_layer.gemv_plan).
struct Plan {
  int n_tile, k_slice;
};

// The scratch every bf16 call shares: the split partials and one ticket per
// column tile (zero between launches: each launch's last blocks reset theirs).
struct Split {
  float* ws;
  int* tickets;
};

template <typename W>
g9::Args<W> gemv_args(const bf16* a, Weight<W> w, const void* bias, void* out, int M, int K,
                      int N, Plan plan, Split sp) {
  g9::Args<W> g{};
  g.a = a;
  g.w = w.w;
  g.scale = w.scale;
  g.group = w.group;
  g.bias = static_cast<const bf16*>(bias);
  g.out = out;
  g.ws = sp.ws;
  g.tickets = sp.tickets;
  g.M = M;
  g.K = K;
  g.N = N;
  g.n_tile = plan.n_tile;
  g.k_slice = plan.k_slice;
  return g;
}

// out = cast(cast(norm(x)) @ W + b): the norm's launch, then the GEMV's.
template <typename W>
cudaError_t norm_proj_sm90(const void* x, const float* ns, const float* nb, Weight<W> w,
                           const void* b, void* out, bf16* xn, Split sp, int M, int E, int N,
                           float eps, int rms, Plan plan, cudaStream_t stream) {
  cudaError_t err = g9::launch_norm(static_cast<const bf16*>(x), ns, nb, eps, rms, xn, M, E,
                                    false, stream);
  if (err != cudaSuccess) return err;
  return g9::launch<W, g9::kNormProj>(gemv_args(xn, w, b, out, M, E, N, plan, sp), true,
                                      stream);
}

// post_attn in bf16: plans[0] o-proj, plans[1] the up (or gate/up) panel,
// plans[2] the down panel. w2 is the up panel under SwiGLU (w1 the gate),
// w3 the down panel; b1 and b3 may be null (SwiGLU).
template <typename W, bool SWIGLU>
cudaError_t post_attn_sm90(const void* y, const void* x, Weight<W> wo, const void* bo,
                           const float* ns, const float* nb, Weight<W> w1, Weight<W> w2,
                           const void* b1, Weight<W> w3, const void* b3, float* r1, bf16* h,
                           void* out, bf16* hin, Split sp, int M, int E, int F, float eps,
                           int rms, int exact_gelu, int parallel, const Plan (&plans)[3],
                           cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  cudaError_t err;
  if (parallel) {   // norm(x): reads only the block input, so it goes first
    err = g9::launch_norm(xb, ns, nb, eps, rms, hin, M, E, false, stream);
    if (err != cudaSuccess) return err;
  }
  // r1 = x + y @ Wo + bo, in fp32
  g9::Args<W> o = gemv_args(static_cast<const bf16*>(y), wo, bo, r1, M, E, E, plans[0], sp);
  o.resid = xb;
  err = g9::launch<W, g9::kOProjResidual>(o, parallel, stream);
  if (err != cudaSuccess) return err;
  if (!parallel) {
    err = g9::launch_norm(static_cast<const float*>(r1), ns, nb, eps, rms, hin, M, E, true,
                          stream);
    if (err != cudaSuccess) return err;
  }
  // h = gelu(hin @ W1 + b1), or silu(hin @ Wg) * (hin @ Wu)
  g9::Args<W> u = gemv_args(hin, w1, b1, h, M, E, F, plans[1], sp);
  if constexpr (SWIGLU) {
    if (w1.group != w2.group) return cudaErrorInvalidValue;
    u.w2 = w2.w;
    u.scale2 = w2.scale;
    err = g9::launch<W, g9::kNormGateUp>(u, true, stream);
  } else {
    u.exact_gelu = exact_gelu;
    err = g9::launch<W, g9::kNormUpGelu>(u, true, stream);
  }
  if (err != cudaSuccess) return err;
  // out = cast(r1 + h @ W3 (+ b3))
  g9::Args<W> d = gemv_args(h, w3, b3, out, M, F, E, plans[2], sp);
  d.resid_f = r1;
  return g9::launch<W, g9::kDownResidual>(d, true, stream);
}

}  // namespace

DS_DEFINE_ERROR_STRING

// Launches so far by kernel: 0 gemv_sm90_kernel (dense bf16), 1 gemv_sm90_kernel
// (W8A16), 2 norm_rows_kernel, 3 rows_gemv_kernel (fp32); where a run can see
// which kernels a call took (a profiler can lose kernel records).
DS_EXPORT unsigned long long decode_layer_launched(int which) {
  if (which >= 0 && which < 3) return g9::g_launched[which].load();
  return which == 3 ? g_rows_gemv_launched.load() : 0;
}

// The edges of a captured CUDA graph (a cudaGraph_t) and how many of them are
// programmatic: stream capture turns a programmatic dependent launch into such
// an edge, which lets the dependent kernel start on its producer's tail as it
// does on a stream. Returns a CUDA error code, else 0.
DS_EXPORT int decode_graph_edges(void* graph, unsigned long long* total,
                                 unsigned long long* programmatic) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &n);
#else
  cudaError_t err = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
#endif
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
#if CUDART_VERSION >= 13000
  err = cudaGraphGetEdges(g, from.data(), to.data(), data.data(), &n);
#else
  err = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n);
#endif
  if (err != cudaSuccess) return err;
  unsigned long long prog = 0;
  for (size_t i = 0; i < n; ++i) prog += data[i].type == cudaGraphDependencyTypeProgrammatic;
  *total = n;
  *programmatic = prog;
  return 0;
}

// x (M, E); ns, nb (E,) fp32 (nb unread under rms); w (E, N); b (N,); out
// (M, N). x, w, b and out share one dtype. rms: RMSNorm instead of
// LayerNorm. bf16 only: xn (M, E) bf16 scratch, ws the split partials and
// tickets the zeroed counters for the plan (n_tile, k_slice). Returns the
// first non-zero cudaGetLastError() of the launches, else 0.
DS_EXPORT int norm_proj_fwd(const void* x, const void* ns, const void* nb, const void* w,
                            const void* b, void* out, void* xn, void* ws, void* tickets, int M,
                            int E, int N, float eps, int rms, int n_tile, int k_slice, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  if (dtype == ds::kBFloat16)
    return norm_proj_sm90(x, nsf, nbf, dense<bf16>(w), b, out, static_cast<bf16*>(xn),
                          Split{static_cast<float*>(ws), static_cast<int*>(tickets)}, M, E, N,
                          eps, rms, Plan{n_tile, k_slice}, st);
  if (dtype == ds::kFloat32)
    return counted_rows(
        norm_proj<float>(x, nsf, nbf, dense<float>(w), b, out, M, E, N, eps, rms, st), 1);
  return cudaErrorInvalidValue;
}

// As norm_proj_fwd with W8A16 weights: codes int8 (E, N), scales fp32
// (E / g, N), g the group size (E for one group).
DS_EXPORT int norm_proj_w8_fwd(const void* x, const void* ns, const void* nb,
                               const void* codes, const void* scale, int g, const void* b,
                               void* out, void* xn, void* ws, void* tickets, int M, int E, int N,
                               float eps, int rms, int n_tile, int k_slice, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  if (dtype == ds::kBFloat16)
    return norm_proj_sm90(x, nsf, nbf, w8(codes, scale, g), b, out, static_cast<bf16*>(xn),
                          Split{static_cast<float*>(ws), static_cast<int*>(tickets)}, M, E, N,
                          eps, rms, Plan{n_tile, k_slice}, st);
  if (dtype == ds::kFloat32)
    return counted_rows(
        norm_proj<float>(x, nsf, nbf, w8(codes, scale, g), b, out, M, E, N, eps, rms, st), 1);
  return cudaErrorInvalidValue;
}

// y, x (M, E); wo (E, E); bo (E,); ns, nb (E,) fp32; w1 (E, F); b1 (F,);
// w2 (F, E); b2 (E,); scratch r1 (M, E) fp32 and h (M, F); out (M, E).
// exact_gelu: the erf GELU (GPT-NeoX) instead of gelu_tanh; parallel: the
// MLP's norm reads x instead of r1. bf16 only: hin (M, E) bf16 scratch, ws
// and tickets, and the three GEMVs' plans (o-proj, up, down: n_tile and
// k_slice each). Returns the first non-zero cudaGetLastError(), else 0.
DS_EXPORT int post_attn_fwd(const void* y, const void* x, const void* wo, const void* bo,
                            const void* ns, const void* nb, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* r1, void* h, void* out,
                            void* hin, void* ws, void* tickets, int M, int E, int F, float eps,
                            int rms, int exact_gelu, int parallel, int nt_o, int ks_o, int nt_u,
                            int ks_u, int nt_d, int ks_d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16) {
    const Plan plans[3] = {{nt_o, ks_o}, {nt_u, ks_u}, {nt_d, ks_d}};
    return post_attn_sm90<bf16, false>(
        y, x, dense<bf16>(wo), bo, nsf, nbf, dense<bf16>(w1), Weight<bf16>{}, b1,
        dense<bf16>(w2), b2, r1f, static_cast<bf16*>(h), out, static_cast<bf16*>(hin),
        Split{static_cast<float*>(ws), static_cast<int*>(tickets)}, M, E, F, eps, rms,
        exact_gelu, parallel, plans, st);
  }
  if (dtype == ds::kFloat32)
    return counted_rows(post_attn<float>(y, x, dense<float>(wo), bo, nsf, nbf,
                                         dense<float>(w1), b1, dense<float>(w2), b2, r1f, h,
                                         out, M, E, F, eps, rms, exact_gelu, parallel, st), 3);
  return cudaErrorInvalidValue;
}

// As post_attn_fwd with W8A16 weights: each of wo, w1, w2 is codes (int8,
// the panel's shape) + scales (fp32, (K / g, N)) + its group size g.
DS_EXPORT int post_attn_w8_fwd(const void* y, const void* x, const void* co, const void* so,
                               int go, const void* bo, const void* ns, const void* nb,
                               const void* c1, const void* s1, int g1, const void* b1,
                               const void* c2, const void* s2, int g2, const void* b2,
                               void* r1, void* h, void* out, void* hin, void* ws, void* tickets,
                               int M, int E, int F, float eps, int rms, int exact_gelu,
                               int parallel, int nt_o, int ks_o, int nt_u, int ks_u, int nt_d,
                               int ks_d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16) {
    const Plan plans[3] = {{nt_o, ks_o}, {nt_u, ks_u}, {nt_d, ks_d}};
    return post_attn_sm90<int8_t, false>(
        y, x, w8(co, so, go), bo, nsf, nbf, w8(c1, s1, g1), Weight<int8_t>{}, b1,
        w8(c2, s2, g2), b2, r1f, static_cast<bf16*>(h), out, static_cast<bf16*>(hin),
        Split{static_cast<float*>(ws), static_cast<int*>(tickets)}, M, E, F, eps, rms,
        exact_gelu, parallel, plans, st);
  }
  if (dtype == ds::kFloat32)
    return counted_rows(post_attn<float>(y, x, w8(co, so, go), bo, nsf, nbf, w8(c1, s1, g1), b1,
                                         w8(c2, s2, g2), b2, r1f, h, out, M, E, F, eps, rms,
                                         exact_gelu, parallel, st), 3);
  return cudaErrorInvalidValue;
}

// The SwiGLU branch: y, x (M, E); wo (E, E); bo (E,); ns, nb (E,) fp32 (nb
// unread under rms); wg, wu (E, F); wd (F, E); scratch r1 (M, E) fp32 and h
// (M, F); out (M, E). No MLP biases. parallel: the norm reads x instead of
// r1. The bf16 scratch and plans as post_attn_fwd.
DS_EXPORT int post_attn_swiglu_fwd(const void* y, const void* x, const void* wo, const void* bo,
                                   const void* ns, const void* nb, const void* wg,
                                   const void* wu, const void* wd, void* r1, void* h, void* out,
                                   void* hin, void* ws, void* tickets, int M, int E, int F,
                                   float eps, int rms, int parallel, int nt_o, int ks_o,
                                   int nt_u, int ks_u, int nt_d, int ks_d, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16) {
    const Plan plans[3] = {{nt_o, ks_o}, {nt_u, ks_u}, {nt_d, ks_d}};
    return post_attn_sm90<bf16, true>(
        y, x, dense<bf16>(wo), bo, nsf, nbf, dense<bf16>(wg), dense<bf16>(wu), nullptr,
        dense<bf16>(wd), nullptr, r1f, static_cast<bf16*>(h), out, static_cast<bf16*>(hin),
        Split{static_cast<float*>(ws), static_cast<int*>(tickets)}, M, E, F, eps, rms, 0,
        parallel, plans, st);
  }
  if (dtype == ds::kFloat32)
    return counted_rows(post_attn_swiglu<float>(y, x, dense<float>(wo), bo, nsf, nbf,
                                                dense<float>(wg), dense<float>(wu),
                                                dense<float>(wd), r1f, h, out, M, E, F, eps,
                                                rms, parallel, st), 3);
  return cudaErrorInvalidValue;
}

// As post_attn_swiglu_fwd with W8A16 weights: codes + scales + group size
// for each of wo, wg, wu (groups over E, gate and up equal) and wd (over F).
DS_EXPORT int post_attn_swiglu_w8_fwd(const void* y, const void* x, const void* co,
                                      const void* so, int go, const void* bo, const void* ns,
                                      const void* nb, const void* cg, const void* sg, int gg,
                                      const void* cu, const void* su, int gu, const void* cd,
                                      const void* sd, int gd, void* r1, void* h, void* out,
                                      void* hin, void* ws, void* tickets, int M, int E, int F,
                                      float eps, int rms, int parallel, int nt_o, int ks_o,
                                      int nt_u, int ks_u, int nt_d, int ks_d, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nsf = static_cast<const float*>(ns);
  const float* nbf = static_cast<const float*>(nb);
  float* r1f = static_cast<float*>(r1);
  if (dtype == ds::kBFloat16) {
    const Plan plans[3] = {{nt_o, ks_o}, {nt_u, ks_u}, {nt_d, ks_d}};
    return post_attn_sm90<int8_t, true>(
        y, x, w8(co, so, go), bo, nsf, nbf, w8(cg, sg, gg), w8(cu, su, gu), nullptr,
        w8(cd, sd, gd), nullptr, r1f, static_cast<bf16*>(h), out, static_cast<bf16*>(hin),
        Split{static_cast<float*>(ws), static_cast<int*>(tickets)}, M, E, F, eps, rms, 0,
        parallel, plans, st);
  }
  if (dtype == ds::kFloat32)
    return counted_rows(post_attn_swiglu<float>(y, x, w8(co, so, go), bo, nsf, nbf,
                                                w8(cg, sg, gg), w8(cu, su, gu), w8(cd, sd, gd),
                                                r1f, h, out, M, E, F, eps, rms, parallel, st), 3);
  return cudaErrorInvalidValue;
}
