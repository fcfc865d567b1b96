"""Flash-attention backward: the port's autograd.Function on the CPU (the
plain backward its CUDA kernels are held against on the card) against
``jax.grad`` through the JAX Pallas kernels in interpret mode, in both of
JAX's backward modes, with and without an lse cotangent, at every head dim
the kernels take and with an explicit scale; ragged S and Sk != S against
dense autograd in torch.

fp32 throughout. Tolerances: rtol 1e-5 with atol 1e-5 against the Pallas
backward (the same fp32 products summed in another order, gradients of
order 1), atol 2e-5 against dense autograd (a one-pass softmax against the
recomputed probabilities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash_lse
from deepspeed_tpu_torch.ops.attention import dense_attention, dot_product_attention
from deepspeed_tpu_torch.ops.flash_attention import (bwd_mode, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_with_lse)

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)


def _inputs(B, S, Sk, H, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    dlse = rng.standard_normal((B, S, H)).astype(np.float32)
    return q, k, v, do, dlse


def _torch_grads(fn, q, k, v, cotangents):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cotangents))
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


@pytest.mark.parametrize("mode", ["merged", "split"])
@pytest.mark.parametrize("causal,S", [(True, 128), (False, 128), (True, 256), (False, 256)])
def test_backward_matches_pallas(monkeypatch, mode, causal, S):
    monkeypatch.setenv("DS_TPU_FLASH_BWD", mode)   # read by both packages' backward
    q, k, v, do, _ = _inputs(1, S, S, 2, 64, seed=S + causal)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _torch_grads(lambda *a: flash_attention(*a, causal=causal), q, k, v, [do])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D,mode,scale", [
    (128, "merged", None), (128, "split", None), (256, "merged", None), (256, "split", None),
    (128, "merged", 0.3),                    # a scale that is not D^-1/2
])
def test_backward_matches_pallas_head_dims(monkeypatch, D, mode, scale):
    monkeypatch.setenv("DS_TPU_FLASH_BWD", mode)
    q, k, v, do, _ = _inputs(1, 128, 128, 1, D, seed=D)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=True, scale=scale, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _torch_grads(lambda *a: flash_attention(*a, causal=True, scale=scale), q, k, v, [do])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_cotangent_matches_pallas(causal):
    q, k, v, do, dlse = _inputs(2, 128, 128, 2, 64, seed=7 + causal)
    _, vjp = jax.vjp(lambda *a: jax_flash_lse(*a, causal=causal, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    got = _torch_grads(lambda *a: flash_attention_with_lse(*a, causal=causal), q, k, v,
                       [do, dlse])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


def _dense_with_lse(q, k, v, causal):
    S, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q, k) * q.shape[-1] ** -0.5
    if causal:
        s = s.masked_fill(~(torch.arange(S)[:, None] >= torch.arange(Sk)[None, :]),
                          float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)
    return out, torch.logsumexp(s, -1).transpose(1, 2)


@pytest.mark.parametrize("causal,S,Sk", [(True, 200, 200), (False, 200, 200),
                                         (False, 128, 256), (False, 192, 320)])
def test_ragged_and_cross_lengths_match_dense_autograd(causal, S, Sk):
    q, k, v, do, dlse = _inputs(2, S, Sk, 2, 64, seed=S + Sk)
    got = _torch_grads(lambda *a: flash_attention_with_lse(*a, causal=causal), q, k, v,
                       [do, dlse])
    want = _torch_grads(lambda *a: _dense_with_lse(*a, causal), q, k, v, [do, dlse])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)


def test_attention_dispatch_is_differentiable_on_both_paths():
    q, k, v, do, _ = _inputs(1, 128, 128, 2, 64, seed=3)
    flash = _torch_grads(lambda *a: dot_product_attention(*a, causal=True), q, k, v, [do])
    dense = _torch_grads(lambda *a: dot_product_attention(*a, causal=True, impl="jnp"),
                         q, k, v, [do])
    for g, w in zip(flash, dense):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)
    masked = _torch_grads(lambda *a: dense_attention(*a, causal=True), q, k, v, [do])
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in masked)


def test_unknown_mode_raises(monkeypatch):
    q, k, v, do, _ = _inputs(1, 128, 128, 1, 64, seed=1)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts)
    monkeypatch.setenv("DS_TPU_FLASH_BWD", "fused")
    with pytest.raises(ValueError, match="fused"):
        out.backward(torch.from_numpy(do))
    with pytest.raises(ValueError, match="bogus"):
        bwd_mode("bogus")
    monkeypatch.delenv("DS_TPU_FLASH_BWD")
    assert bwd_mode() == "merged" and bwd_mode("split") == "split"
    lse = torch.zeros(2, 1, 128)
    with pytest.raises(ValueError):
        flash_attention_bwd(*ts, ts[0], lse, ts[0], True, 0.125, mode="both")
