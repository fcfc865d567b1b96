"""Decode attention: the port's plain version (what its CUDA kernel is held
against on the card) against the JAX Pallas kernels in interpret mode.

The same numpy inputs, made from a seed, go through both. fp32, atol 1e-5:
both sides compute fp32 scores, softmax and ``p @ v``, in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from deepspeed_tpu.ops.pallas.decode_attention import fits_vmem
from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_supported

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)


def _inputs(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,S,H,KV,D,length", [
    (2, 64, 4, 4, 32, 17),                 # scalar length: the static-batch generate
    (3, 64, 4, 4, 64, [1, 64, 30]),        # per-row lengths, incl. 1 and the full cache
    (2, 48, 8, 2, 32, [5, 48]),            # GQA: 4 query heads per KV head
    (1, 1024, 12, 12, 64, [700]),          # S*KV*D > 524288: the JAX blocked path
])
def test_plain_matches_pallas(B, S, H, KV, D, length):
    q, k, v = _inputs(B, S, H, KV, D, seed=S + H)
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(length, jnp.int32), interpret=True)
    t_len = length if isinstance(length, int) else torch.tensor(length, dtype=torch.int32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t_len)
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_blocked_case_takes_the_streamed_kernel():
    # the last case above is the one that exercises _decode_kernel_blocked
    assert not fits_vmem(1024, 12, 64, 4)


def test_positions_past_length_are_not_read():
    q, k, v = _inputs(2, 32, 2, 2, 32, seed=3)
    k[:, 10:], v[:, 10:] = np.nan, np.inf      # dead cache rows hold garbage
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 10)
    q2, k2, v2 = _inputs(2, 32, 2, 2, 32, seed=3)
    ref = decode_attention(torch.from_numpy(q2), torch.from_numpy(k2[:, :10]),
                           torch.from_numpy(v2[:, :10]), 10)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("length", [-1, 65, [3, 99]])
def test_length_outside_cache_raises(length):
    q, k, v = _inputs(2, 64, 2, 2, 32, seed=0)
    t_len = length if isinstance(length, int) else torch.tensor(length, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t_len)


@pytest.mark.parametrize("H,KV,D,ok", [
    (12, 12, 64, True), (12, 4, 64, True), (32, 4, 128, True), (25, 25, 64, True),
    (16, 16, 96, True), (12, 5, 64, False), (64, 4, 64, False), (8, 8, 80, False),
])
def test_decode_supported(H, KV, D, ok):
    assert decode_supported(H, KV, D) is ok
