"""Decode attention: the port's plain versions (what its CUDA kernel is held
against on the card, and the kernel's split-and-merge arithmetic) against
the JAX Pallas kernels in interpret mode, and the wrapper's launch plan.

The same numpy inputs, made from a seed, go through both. fp32, atol 1e-5:
both sides compute fp32 scores, softmax and ``p @ v``, in different orders.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from deepspeed_tpu.ops.pallas.decode_attention import fits_vmem
from deepspeed_tpu_torch.ops import decode_attention as da
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


# lengths around the kernel's 64-position chunks: none live, one, one short
# of a chunk, exactly one and two chunks, one past them, the whole cache
SPLIT_CASES = {
    "edges_g8": (8, 1, 32, [0, 1, 63, 64, 65, 128, 129, 192], 192),   # 8 query heads per KV
    "gqa_g4": (8, 2, 64, [5, 64, 65, 190], 192),
    "scalar": (4, 4, 32, 129, 200),                                   # one length for all rows
    "one_chunk": (4, 2, 32, [0, 7, 40], 40),                          # S <= CHUNK: one state
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_plain_matches_pallas_and_one_pass(name):
    """The kernels' split arithmetic (per-chunk fp32 states merged by lse in
    chunk order) against the interpreted TPU kernel and the one-pass plain
    version. Every dead cache row holds NaN (K) or inf (V) on the port's
    side: the split version must not read them; the JAX kernel, which does
    not zero dead V rows when the whole cache fits, gets them finite."""
    H, KV, D, length, S = SPLIT_CASES[name]
    B = 3 if isinstance(length, int) else len(length)
    q, k, v = _inputs(B, S, H, KV, D, seed=len(name))
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(length, jnp.int32), interpret=True)
    lens = np.broadcast_to(np.asarray(length), (B,))
    dead = np.arange(S)[None, :] >= lens[:, None]
    k, v = k.copy(), v.copy()          # JAX may still be reading the originals
    k[dead], v[dead] = np.nan, np.inf
    t_len = torch.full((B,), length) if isinstance(length, int) else torch.tensor(length)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t_len.int(),
            D ** -0.5)
    got = da.decode_attention_split_plain(*args)
    assert torch.isfinite(got).all(), "a dead row reached the split version's output"
    assert (got[lens == 0] == 0).all(), "an L=0 row gives zeros"
    # L = 0 rows: 0 / 0 in the JAX kernel that holds the whole cache; the
    # port gives zeros there, as the blocked TPU kernel does
    np.testing.assert_allclose(got.numpy()[lens > 0], np.asarray(want)[lens > 0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), da.decode_attention_plain(*args).numpy(),
                               atol=1e-5, rtol=0)


def test_split_plain_small_chunks_merge_many_states():
    """The same merge over chunks of 8 positions (up to 24 live states per
    row), where a row's maximum sits in a late chunk: each state must be
    rescaled by e^(m_i - M) before the sum."""
    q, k, v = _inputs(3, 190, 4, 2, 32, seed=12)
    k[1, 170] = 4 * q[1, 0, 2]        # one dominant score in the row's last chunks
    lens = torch.tensor([9, 190, 17], dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lens, 32 ** -0.5)
    np.testing.assert_allclose(da.decode_attention_split_plain(*args, chunk=8).numpy(),
                               da.decode_attention_plain(*args).numpy(), atol=1e-5, rtol=0)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so a wrapper takes its
    launch branch (the launch itself is replaced in the test)."""

    @property
    def is_cuda(self):
        return True


class _NoHostRead(TorchFunctionMode):
    """Raises where a tensor's value would be read back to the host (a
    synchronisation on the card)."""

    READS = {"item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.READS:
            raise AssertionError(f"the wrapper read a tensor back to the host ({func.__name__})")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def launch_recorder(monkeypatch, module):
    """Replace ``module``'s kernel launch and CUDA calls; yield the launches'
    argument tuples and the workspaces ``split_workspace`` made."""
    launches, workspaces = [], []
    real_ws = module.split_workspace

    def ws(*a):
        w = real_ws(*a)
        workspaces.append(tuple(w.shape))
        return w
    monkeypatch.setattr(module.KERNEL, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(module, "split_workspace", ws)
    monkeypatch.setattr(module, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    with _NoHostRead():
        yield launches, workspaces


@pytest.mark.parametrize("S,length", [(40, [3, 40]), (300, [0, 299]), (300, [300, 1]),
                                      (300, 77)])
def test_launch_plan_comes_from_shapes_alone(monkeypatch, S, length):
    """The CUDA branch's plan (chunks, workspace) depends on the cache's
    shape only, and nothing is read back from the card: no ``.item()``, no
    ``bool``/``int`` of a tensor, so the call can be captured in a graph."""
    q, k, v = (torch.from_numpy(x).as_subclass(_OnCard) for x in _inputs(2, S, 8, 2, 64, 1))
    t_len = length if isinstance(length, int) else \
        torch.tensor(length, dtype=torch.int32).as_subclass(_OnCard)
    with launch_recorder(monkeypatch, da) as (launches, workspaces):
        decode_attention(q, k, v, t_len)
    n = da.split_chunks(S)
    assert n == -(-S // da.CHUNK) and len(launches) == 1
    assert workspaces == [(2, 8, n, 66)]
    ws_ptr, scalar_len = launches[0][6], launches[0][4]
    assert ws_ptr is not None
    assert launches[0][3] is None and scalar_len == length if isinstance(length, int) \
        else launches[0][3] is not None
