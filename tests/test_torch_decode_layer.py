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


@pytest.mark.parametrize("kw", [dict(rms=True), dict(swiglu=True), dict(exact_gelu=True),
                                dict(parallel_residual=True), dict(w8=True)])
def test_deferred_branches_raise(kw):
    _, t = _both(_arrays(4), "float32")
    wo = (t["wo"], t["bo"]) if kw.pop("w8", False) else t["wo"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dl.fused_post_attn(t["y"], t["x"], wo, t["bo"], t["ns"], t["nb"],
                           (t["w1"], t["b1"], t["w2"], t["b2"]), **kw)


@pytest.mark.parametrize("m,e,n", [(8, 768, 2304), (64, 768, 3072), (65, 768, 2304),
                                   (8, 1600, 4800), (1, 128, 384), (8, 1536, 96)])
def test_supported_predicates_match_jax(m, e, n):
    assert dl.norm_proj_supported(m, e, n) == jdl.norm_proj_supported(m, e, n, 2, False)
    assert dl.post_attn_supported(m, e, n) == jdl.post_attn_supported(m, e, n, 2, False)
