"""Fused decode-layer kernels: the port's plain versions (the arithmetic its
CUDA kernels are held against on the card) against the JAX Pallas kernels in
interpret mode, at M=3, E=128, N=384, F=512 (E=256, F=1024 for W8A16 and
the GPT-NeoX branches), every branch: LayerNorm or RMSNorm, GELU tanh or
exact (erf), SwiGLU, sequential or parallel residual, full-width or W8A16
weights.

fp32: atol 1e-5 (fp32 sums in different orders). bf16: the kernels cast at
fixed points (the normalised rows before each product, the GELU output,
the final result) and keep r1 in fp32; a port that cast elsewhere would
disagree on many elements, so the bf16 check allows at most one bf16 ulp
at the output's scale and on at most 2% of the elements (an fp32 order
difference can tip a rounding). The exact GELU needs no wider bound:
``torch.erf`` and XLA's CPU erf are both fp32-accurate, a few fp32 ulps
apart at the GELU input, inside the fp32 bound and the bf16 allowance.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import w8 as jw8
from deepspeed_tpu.ops.pallas import decode_layer as jdl
from deepspeed_tpu_torch.ops import decode_layer as dl

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

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


# ---------------------------------------------------------------------------
# The GPT-NeoX branches: exact GELU and the parallel residual (and the other
# combinations the JAX kernel accepts: tanh GELU and SwiGLU under the
# parallel residual, RMSNorm under each)
# ---------------------------------------------------------------------------

_NEOX_BRANCHES = {
    "erf_seq_ln": dict(exact_gelu=True),
    "erf_par_ln": dict(exact_gelu=True, parallel_residual=True),
    "tanh_par_ln": dict(parallel_residual=True),
    "erf_seq_rms": dict(exact_gelu=True, rms=True),
    "erf_par_rms": dict(exact_gelu=True, parallel_residual=True, rms=True),
    "tanh_par_rms": dict(parallel_residual=True, rms=True),
    "swiglu_par_rms": dict(swiglu=True, parallel_residual=True, rms=True),
    "swiglu_par_ln": dict(swiglu=True, parallel_residual=True),
}


def _neox_arrays(seed, e=256, f=1024):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, std=0.02: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(x=f32(M, e, std=1.0), y=f32(M, e, std=1.0),
                ns=(1 + rng.standard_normal(e) * 0.1).astype(np.float32), nb=f32(e, std=0.1),
                wo=f32(e, e), bo=f32(e), w1=f32(e, f), b1=f32(f), w2=f32(f, e), b2=f32(e),
                wg=f32(e, f), wu=f32(e, f), wd=f32(f, e))


def _branch_operands(a, kw, dtype, w8):
    """(jax operands, port operands) of one branch: o-proj, its bias, the
    norm (no bias under RMSNorm), the MLP weights (W8A16 pairs with 128-row
    groups when ``w8``)."""
    j, t = _both(a, dtype)
    names = ("wd", "wg", "wu") if kw.get("swiglu") else ("w1", "w2")
    q = {k: _q(torch.from_numpy(a[k])) for k in ("wo",) + names} if w8 else {}

    def side(d, wrap):
        w = {k: wrap(q[k]) if w8 else d[k] for k in ("wo",) + names}
        mlp = ((w["wg"], w["wu"], w["wd"]) if kw.get("swiglu")
               else (w["w1"], d["b1"], w["w2"], d["b2"]))
        return (d["y"], d["x"], w["wo"], d["bo"], d["ns"], None if kw.get("rms") else d["nb"],
                mlp)
    return side(j, _jq), side(t, lambda p: p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w8", [False, True], ids=["full", "w8"])
@pytest.mark.parametrize("branch", list(_NEOX_BRANCHES))
def test_neox_branches_match_pallas(branch, w8, dtype):
    """``fused_post_attn`` (its plain version on the CPU) against the Pallas
    kernel in interpret mode, each branch at full width and W8A16 (two
    scale groups over E, eight over F)."""
    kw = _NEOX_BRANCHES[branch]
    jargs, targs = _branch_operands(_neox_arrays(12), kw, dtype, w8)
    want = np.asarray(jdl.fused_post_attn(*jargs, **kw, interpret=True).astype(jnp.float32))
    got = dl.fused_post_attn(*targs, **kw).float().numpy()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5 * max(1.0, np.abs(want).max())
    else:
        assert diff.max() <= _ulp(np.abs(want).max()) and (diff > 0).mean() <= 0.02


@pytest.mark.parametrize("w8", [False, True], ids=["full", "w8"])
@pytest.mark.parametrize("branch", list(_NEOX_BRANCHES))
def test_neox_reference_chains_match_jax_fp32(branch, w8):
    """The unfused chain (``reference_post_attn``) against JAX's, and the
    branch's flags really change the result: the parallel residual against
    the sequential one, the exact GELU against tanh."""
    kw = _NEOX_BRANCHES[branch]
    jargs, targs = _branch_operands(_neox_arrays(13), kw, "float32", w8)
    want = np.asarray(jdl.reference_post_attn(*jargs, **kw))
    got = dl.reference_post_attn(*targs, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)
    other = dl.fused_post_attn(*targs, **dict(kw, parallel_residual=not kw.get(
        "parallel_residual", False)))
    fused = dl.fused_post_attn(*targs, **kw)
    assert not torch.allclose(other, fused, atol=1e-4)
    if not kw.get("swiglu"):
        tanh = dl.fused_post_attn(*targs, **dict(kw, exact_gelu=not kw.get("exact_gelu")))
        assert not torch.allclose(tanh, fused, atol=1e-6)


def test_branch_handles_are_distinct():
    """Each branch counts its own launches: twelve handles, one per MLP kind
    x residual x weight kind; the norm shares them; SwiGLU ignores the GELU
    flag, as the JAX kernel does."""
    combos = [(s, e, p, q) for s in (False, True) for e in (False, True)
              for p in (False, True) for q in (False, True) if not (s and e)]
    handles = {id(dl.post_attn_handle(*c)) for c in combos}
    assert len(handles) == 12
    assert dl.post_attn_handle(True, True, True) is dl.post_attn_handle(True, False, True)
    assert dl.post_attn_handle(False, True, True, True) is dl.POST_ATTN_ERF_PAR_W8
    assert dl.post_attn_handle(swiglu=True) is dl.POST_ATTN_SWIGLU
    assert dl.post_attn_handle() is dl.POST_ATTN
