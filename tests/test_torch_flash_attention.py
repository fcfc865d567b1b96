"""Flash-attention forward: the port's plain version (what its CUDA kernels
are held against on the card) against the JAX Pallas kernel in interpret
mode, output and log-sum-exp, fp32, atol 2e-5 (the tolerance the JAX
package's own flash tests use: fp32 online softmax against one dense
softmax), at every head dim the kernels take and with an explicit scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash
from deepspeed_tpu_torch.ops.attention import _pick_impl, dot_product_attention
from deepspeed_tpu_torch.ops.flash_attention import flash_attention, flash_attention_with_lse

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)


def _qkv(B, S, Sk, H, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32))


@pytest.mark.parametrize("causal,S,Sk", [
    (True, 256, 256), (False, 256, 256),     # the slice's head dim, one tile each
    (True, 200, 200), (False, 200, 200),     # S off the CUDA kernel's 64-row tiles
    (False, 128, 256),                       # cross lengths
])
def test_plain_matches_pallas(causal, S, Sk):
    q, k, v = _qkv(2, S, Sk, 2, 64, seed=S + causal)
    want_o, want_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, interpret=True)
    got_o, got_lse = flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                              torch.from_numpy(v), causal=causal)
    assert got_o.shape == (2, S, 2, 64) and got_lse.shape == (2, S, 2)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=0)


@pytest.mark.parametrize("D,causal,scale", [
    (128, True, None), (128, False, None), (256, True, None), (256, False, None),
    (128, True, 0.3),                        # a scale that is not D^-1/2
])
def test_plain_matches_pallas_head_dims(D, causal, scale):
    q, k, v = _qkv(1, 128, 128, 1, D, seed=D + causal)
    want_o, want_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, scale=scale, interpret=True)
    got_o, got_lse = flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                              torch.from_numpy(v), causal=causal, scale=scale)
    assert got_o.shape == (1, 128, 1, D) and got_lse.shape == (1, 128, 1)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=0)


def test_dispatch_predicate():
    x = lambda S, D: torch.zeros(1, S, 2, D)  # noqa: E731
    assert _pick_impl("auto", x(128, 64)) == "flash"
    assert _pick_impl("auto", x(1024, 256)) == "flash"
    assert _pick_impl("auto", x(127, 64)) == "jnp"
    assert _pick_impl("auto", x(512, 96)) == "jnp"    # gpt2-760m's head dim
    assert _pick_impl("jnp", x(512, 64)) == "jnp"
    with pytest.raises(NotImplementedError):
        _pick_impl("ring", x(512, 64))


def test_flash_and_dense_paths_agree():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 128, 128, 2, 64, seed=5))
    flash = dot_product_attention(q, k, v, causal=True)
    dense = dot_product_attention(q, k, v, causal=True, impl="jnp")
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(flash_attention(q, k, v).numpy(), flash.numpy(), atol=0, rtol=0)
