"""Fused decode-layer kernels: the port's plain versions (the arithmetic its
CUDA kernels are held against on the card) against the JAX Pallas kernels in
interpret mode, at M=3, E=128, N=384, F=512.

fp32: atol 1e-5 (fp32 sums in different orders). bf16: the kernels cast at
fixed points (the normalised rows before each product, the GELU output,
the final result) and keep r1 in fp32; a port that cast elsewhere would
disagree on many elements, so the bf16 check allows at most one bf16 ulp
at the output's scale and on at most 2% of the elements (an fp32 order
difference can tip a rounding).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import w8 as jw8
from deepspeed_tpu.ops.pallas import decode_layer as jdl
from deepspeed_tpu_torch.ops import decode_layer as dl

M, E, N, F = 3, 128, 384, 512


def _arrays(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=0.02: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(x=f(M, E, std=1.0), y=f(M, E, std=1.0),
                ns=(1 + rng.standard_normal(E) * 0.1).astype(np.float32), nb=f(E, std=0.1),
                w=f(E, N), b=f(N), wo=f(E, E), bo=f(E), w1=f(E, F), b1=f(F),
                w2=f(F, E), b2=f(E))


def _both(a, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    keep32 = ("ns", "nb")   # norm parameters go to both kernels as fp32
    j = {k: jnp.asarray(v, jnp.float32 if k in keep32 else jd) for k, v in a.items()}
    t = {k: torch.from_numpy(v).to(torch.float32 if k in keep32 else td) for k, v in a.items()}
    return j, t


def _ulp(x):
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _norm_proj(j, t):
    want = jdl.fused_norm_proj(j["x"], j["ns"], j["nb"], j["w"], j["b"], interpret=True)
    got = dl.fused_norm_proj(t["x"], t["ns"], t["nb"], t["w"], t["b"])
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


def _post_attn(j, t):
    want = jdl.fused_post_attn(j["y"], j["x"], j["wo"], j["bo"], j["ns"], j["nb"],
                               (j["w1"], j["b1"], j["w2"], j["b2"]), interpret=True)
    got = dl.fused_post_attn(t["y"], t["x"], t["wo"], t["bo"], t["ns"], t["nb"],
                             (t["w1"], t["b1"], t["w2"], t["b2"]))
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("op", [_norm_proj, _post_attn])
def test_plain_matches_pallas_fp32(op):
    want, got = op(*_both(_arrays(0), "float32"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("op", [_norm_proj, _post_attn])
def test_plain_matches_pallas_bf16_cast_points(op):
    want, got = op(*_both(_arrays(1), "bfloat16"))
    diff = np.abs(got - want)
    assert diff.max() <= _ulp(np.abs(want).max())
    assert (diff > 0).mean() <= 0.02


def test_fused_differs_from_unfused_in_bf16():
    # the unfused chain rounds r1 (and more) to bf16, the fused kernel keeps
    # it in fp32: the two paths are not interchangeable in bf16
    j, t = _both(_arrays(2), "bfloat16")
    fused = dl.fused_post_attn(t["y"], t["x"], t["wo"], t["bo"], t["ns"], t["nb"],
                               (t["w1"], t["b1"], t["w2"], t["b2"]))
    unfused = dl.reference_post_attn(t["y"], t["x"], t["wo"], t["bo"], t["ns"], t["nb"],
                                     (t["w1"], t["b1"], t["w2"], t["b2"]))
    assert (fused != unfused).float().mean() > 0.05


def test_reference_chains_match_jax_fp32():
    j, t = _both(_arrays(3), "float32")
    want = jdl.reference_norm_proj(j["x"], j["ns"], j["nb"], j["w"], j["b"])
    got = dl.reference_norm_proj(t["x"], t["ns"], t["nb"], t["w"], t["b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want = jdl.reference_post_attn(j["y"], j["x"], j["wo"], j["bo"], j["ns"], j["nb"],
                                   (j["w1"], j["b1"], j["w2"], j["b2"]))
    got = dl.reference_post_attn(t["y"], t["x"], t["wo"], t["bo"], t["ns"], t["nb"],
                                 (t["w1"], t["b1"], t["w2"], t["b2"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(exact_gelu=True), dict(parallel_residual=True),
                                dict(exact_gelu=True, rms=True),
                                dict(parallel_residual=True, rms=True),
                                dict(w8=True, exact_gelu=True)])
def test_deferred_branches_raise(kw):
    # RMSNorm, SwiGLU and W8A16 weights are ported; exact GELU and the
    # parallel residual (GPT-NeoX) still raise, under them too
    _, t = _both(_arrays(4), "float32")
    w8 = kw.pop("w8", False)
    ws = [_q(t[k]) if w8 else t[k] for k in ("wo", "w1", "w2")]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dl.fused_post_attn(t["y"], t["x"], ws[0], t["bo"], t["ns"], t["nb"],
                           (ws[1], t["b1"], ws[2], t["b2"]), **kw)


@pytest.mark.parametrize("m,e,n", [(8, 768, 2304), (64, 768, 3072), (65, 768, 2304),
                                   (8, 1600, 4800), (1, 128, 384), (8, 1536, 96)])
def test_supported_predicates_match_jax(m, e, n):
    assert dl.norm_proj_supported(m, e, n) == jdl.norm_proj_supported(m, e, n, 2, False)
    assert dl.post_attn_supported(m, e, n) == jdl.post_attn_supported(m, e, n, 2, False)


# ---------------------------------------------------------------------------
# W8A16 pairs (int8 codes + fp32 scales per group of 128 rows, or one group)
# ---------------------------------------------------------------------------

def _q(w: torch.Tensor, group: int = 128):
    codes, scale = jw8.quantize_weight(jnp.asarray(w.float().numpy()), group)
    return torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scale))


def _jq(pair):
    return jnp.asarray(pair[0].numpy()), jnp.asarray(pair[1].numpy())


@pytest.mark.parametrize("group", [128, 10 ** 9], ids=["g128", "one_group"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_plain_matches_pallas(group, dtype):
    # E=256, F=1024: two scale groups on the E panels, eight on the down
    # projection (g=128); or one group spanning each panel
    rng = np.random.default_rng(5)
    E8, F8 = 256, 1024
    f = lambda *s, std=0.02: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    a = dict(x=f(M, E8, std=1.0), y=f(M, E8, std=1.0), ns=(1 + f(E8, std=0.1)), nb=f(E8, std=0.1),
             w=f(E8, N), b=f(N), wo=f(E8, E8), bo=f(E8), w1=f(E8, F8), b1=f(F8), w2=f(F8, E8),
             b2=f(E8))
    j, t = _both(a, dtype)
    q = {k: _q(torch.from_numpy(a[k]), group) for k in ("w", "wo", "w1", "w2")}
    want = jdl.fused_norm_proj(j["x"], j["ns"], j["nb"], _jq(q["w"]), j["b"], interpret=True)
    got = dl.fused_norm_proj(t["x"], t["ns"], t["nb"], q["w"], t["b"])
    want2 = jdl.fused_post_attn(j["y"], j["x"], _jq(q["wo"]), j["bo"], j["ns"], j["nb"],
                                (_jq(q["w1"]), j["b1"], _jq(q["w2"]), j["b2"]), interpret=True)
    got2 = dl.fused_post_attn(t["y"], t["x"], q["wo"], t["bo"], t["ns"], t["nb"],
                              (q["w1"], t["b1"], q["w2"], t["b2"]))
    for w_, g_ in ((want, got), (want2, got2)):
        w_, g_ = np.asarray(w_.astype(jnp.float32)), g_.float().numpy()
        assert g_.dtype == np.float32 and g_.shape == w_.shape
        diff = np.abs(g_ - w_)
        if dtype == "float32":
            assert diff.max() <= 1e-5 * max(1.0, np.abs(w_).max())
        else:   # one cast of an fp32 value that two orders of summation may tip
            assert diff.max() <= _ulp(np.abs(w_).max()) and (diff > 0).mean() <= 0.02


def test_w8_mixed_weights_raise():
    _, t = _both(_arrays(6), "float32")
    with pytest.raises(ValueError, match="all W8A16 pairs or none"):
        dl.fused_post_attn(t["y"], t["x"], _q(t["wo"]), t["bo"], t["ns"], t["nb"],
                           (t["w1"], t["b1"], t["w2"], t["b2"]))


# ---------------------------------------------------------------------------
# The LLaMA branches: RMSNorm and the three-panel SwiGLU MLP
# ---------------------------------------------------------------------------

def _llama_arrays(seed, e=128, f=512):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, std=0.02: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(x=f32(M, e, std=1.0), y=f32(M, e, std=1.0),
                ns=(1 + rng.standard_normal(e) * 0.1).astype(np.float32),
                w=f32(e, N), wo=f32(e, e), wg=f32(e, f), wu=f32(e, f), wd=f32(f, e))


def _rms_norm_proj(j, t, q=None):
    w = (q["w"], _jq(q["w"])) if q else (t["w"], j["w"])
    want = jdl.fused_norm_proj(j["x"], j["ns"], None, w[1], None, rms=True, interpret=True)
    got = dl.fused_norm_proj(t["x"], t["ns"], None, w[0], None, rms=True)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


def _swiglu_post_attn(j, t, q=None):
    names = ("wo", "wg", "wu", "wd")
    tw = [q[k] for k in names] if q else [t[k] for k in names]
    jw = [_jq(q[k]) for k in names] if q else [j[k] for k in names]
    want = jdl.fused_post_attn(j["y"], j["x"], jw[0], None, j["ns"], None, tuple(jw[1:]),
                               swiglu=True, rms=True, interpret=True)
    got = dl.fused_post_attn(t["y"], t["x"], tw[0], None, t["ns"], None, tuple(tw[1:]),
                             swiglu=True, rms=True)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", [_rms_norm_proj, _swiglu_post_attn])
def test_llama_branches_match_pallas(op, dtype):
    # fp32: 1e-5 of the output's scale (fp32 sums in another order); bf16:
    # the cast points (normalised rows, h, the output) are the kernel's, so
    # at most one bf16 ulp on at most 2% of the elements
    want, got = op(*_both(_llama_arrays(7), dtype))
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5 * max(1.0, np.abs(want).max())
    else:
        assert diff.max() <= _ulp(np.abs(want).max()) and (diff > 0).mean() <= 0.02


@pytest.mark.parametrize("group", [128, 10 ** 9], ids=["g128", "one_group"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", [_rms_norm_proj, _swiglu_post_attn])
def test_llama_w8_branches_match_pallas(op, dtype, group):
    # E=256, F=1024: two scale groups over E (o-proj, gate, up) and eight
    # over F (down) at g=128, or one group spanning each panel
    a = _llama_arrays(8, e=256, f=1024)
    j, t = _both(a, dtype)
    q = {k: _q(torch.from_numpy(a[k]), group) for k in ("w", "wo", "wg", "wu", "wd")}
    want, got = op(j, t, q)
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5 * max(1.0, np.abs(want).max())
    else:
        assert diff.max() <= _ulp(np.abs(want).max()) and (diff > 0).mean() <= 0.02


@pytest.mark.parametrize("swiglu", [False, True])
def test_llama_reference_chains_match_jax_fp32(swiglu):
    j, t = _both(_llama_arrays(9), "float32")
    want = jdl.reference_norm_proj(j["x"], j["ns"], None, j["w"], None, rms=True)
    got = dl.reference_norm_proj(t["x"], t["ns"], None, t["w"], None, rms=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if swiglu:
        jm, tm = (j["wg"], j["wu"], j["wd"]), (t["wg"], t["wu"], t["wd"])
    else:   # RMSNorm under the GELU pair: a combination no model runs, ported all the same
        jm = (j["wg"], None, j["wd"], None)
        tm = (t["wg"], None, t["wd"], None)
    want = jdl.reference_post_attn(j["y"], j["x"], j["wo"], None, j["ns"], None, jm,
                                   swiglu=swiglu, rms=True)
    got = dl.reference_post_attn(t["y"], t["x"], t["wo"], None, t["ns"], None, tm,
                                 swiglu=swiglu, rms=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want = jdl.fused_post_attn(j["y"], j["x"], j["wo"], None, j["ns"], None, jm, swiglu=swiglu,
                               rms=True, interpret=True)
    got = dl.fused_post_attn(t["y"], t["x"], t["wo"], None, t["ns"], None, tm, swiglu=swiglu,
                             rms=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_swiglu_panels_must_agree():
    _, t = _both(_llama_arrays(10), "float32")
    with pytest.raises(ValueError, match="shapes"):
        dl.fused_post_attn(t["y"], t["x"], t["wo"], None, t["ns"], None,
                           (t["wg"], t["wu"][:, :256], t["wd"]), swiglu=True, rms=True)
    with pytest.raises(ValueError, match="all W8A16 pairs or none"):
        dl.fused_post_attn(t["y"], t["x"], t["wo"], None, t["ns"], None,
                           (_q(t["wg"]), t["wu"], t["wd"]), swiglu=True, rms=True)
