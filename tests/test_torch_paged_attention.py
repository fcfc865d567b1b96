"""Paged decode attention: the port's plain versions (what its CUDA kernel is
held against on the card, and the kernel's split-and-merge arithmetic)
against the JAX Pallas kernel in interpret mode, the gather / multi-token
reference against the JAX functions, and the wrapper's launch plan.

The same numpy inputs, made from a seed, go through both. fp32, atol 1e-5:
both sides compute fp32 scores, softmax and ``p @ v``, in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import _jnp_attention
from deepspeed_tpu.ops.pallas import paged_attention as jax_pa
from deepspeed_tpu_torch.ops import paged_attention as pa

from .test_torch_decode_attention import _OnCard, launch_recorder

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _paged_case(rng, B, H, KV, D, pt, T):
    """Random contiguous per-row K/V scattered into an arena through a random
    table (the test_paged_attention.py fixture): (q, k_pages, v_pages, table,
    contiguous k, v), page 0 the trash page."""
    P = B * T + 1
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T * pt, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T * pt, KV, D)).astype(np.float32)
    table = (rng.permutation(P - 1) + 1)[:B * T].reshape(B, T).astype(np.int32)
    k_pages = np.zeros((P, pt, KV, D), np.float32)
    v_pages = np.zeros((P, pt, KV, D), np.float32)
    for b in range(B):
        for j in range(T):
            k_pages[table[b, j]] = k[b, j * pt:(j + 1) * pt]
            v_pages[table[b, j]] = v[b, j * pt:(j + 1) * pt]
    return q, k_pages, v_pages, table, k, v


def _hazard_case(rng, H, KV, D=64, pt=8, T=5, lengths=None):
    """Rows at L = 0, 1, pt, pt + 3, T*pt (full table) and T*pt + 5 (past
    the table), or at ``lengths`` but the last, each row's pages shuffled
    and its table padded with trash page 0; a free slot (the last row) whose
    table is all trash page 1 and whose length ran to 3*T*pt. Unallocated
    pages, trash page 0 and every dead position of a tail page hold NaN;
    trash page 1 (which the free slot reads) is finite."""
    lengths = ([0, 1, pt, pt + 3, T * pt, T * pt + 5] if lengths is None else lengths) \
        + [3 * T * pt]
    B = len(lengths)
    P = B * T + 2
    k_pages = np.full((P, pt, KV, D), np.nan, np.float32)
    v_pages = np.full((P, pt, KV, D), np.inf, np.float32)
    k_pages[1] = rng.standard_normal((pt, KV, D))
    v_pages[1] = rng.standard_normal((pt, KV, D))
    perm = rng.permutation(P - 2) + 2
    table = np.zeros((B, T), np.int32)
    table[-1] = 1
    used = 0
    for b, L in enumerate(lengths[:-1]):
        n = min(-(-L // pt), T)
        table[b, :n] = perm[used:used + n]
        used += n
        for j in range(n):
            live = min(pt, L - j * pt)
            k_pages[table[b, j], :live] = rng.standard_normal((live, KV, D))
            v_pages[table[b, j], :live] = rng.standard_normal((live, KV, D))
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    return q, k_pages, v_pages, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])     # MHA and 4:1 GQA
def test_plain_matches_pallas_with_hazards(H, KV):
    q, kp, vp, table, lengths = _hazard_case(np.random.default_rng(H + KV), H, KV)
    want = jax_pa.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(table), jnp.asarray(lengths),
                                         interpret=True)
    got = pa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    assert got.shape == (len(lengths), 1, H, 64) and got.dtype == torch.float32
    assert torch.isfinite(got).all(), "NaN/inf pages or dead positions reached the output"
    assert (got[0] == 0).all(), "an L=0 row gives zeros"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _unit_case(name):
    """The cases of tests/unit/test_paged_attention.py, in the port."""
    rng = np.random.default_rng(len(name))
    if name in ("parity_mha", "parity_gqa"):
        H, KV = (4, 4) if name == "parity_mha" else (8, 2)
        B, D, pt, T = 4, 64, 8, 5
        q, kp, vp, tab, k, v = _paged_case(rng, B, H, KV, D, pt, T)
        lengths = np.asarray([1, pt, pt + 3, T * pt], np.int32)
        want = jax_pa.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, tab, lengths)),
                                             interpret=True)
        got = pa.paged_decode_attention(*map(_t, (q, kp, vp, tab, lengths)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    elif name == "reference_vs_kernel":
        B, H, KV, D, pt, T = 3, 8, 2, 64, 8, 4
        q, kp, vp, tab, k, v = _paged_case(rng, B, H, KV, D, pt, T)
        lengths = np.asarray([5, pt + 1, T * pt], np.int32)
        want = jax_pa.paged_reference_attention(*map(jnp.asarray, (q, kp, vp, tab, lengths)))
        ref = pa.paged_reference_attention(*map(_t, (q, kp, vp, tab, lengths)))
        got = pa.paged_decode_attention(*map(_t, (q, kp, vp, tab, lengths)))
        np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    elif name == "multitoken_suffix":
        B, H, KV, D, pt, T, S = 2, 4, 4, 32, 8, 4, 3
        _, kp, vp, tab, k, v = _paged_case(rng, B, H, KV, D, pt, T)
        q = rng.standard_normal((B, S, H, D)).astype(np.float32)
        lengths = np.asarray([7, 2 * pt + 1], np.int32)
        want = jax_pa.paged_reference_attention(*map(jnp.asarray, (q, kp, vp, tab, lengths)))
        got = pa.paged_reference_attention(*map(_t, (q, kp, vp, tab, lengths)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    elif name == "per_row_equals_batched":   # the JAX vmap fold: rows are independent
        B, H, KV, D, pt, T = 4, 4, 4, 32, 8, 3
        q, kp, vp, tab, k, v = map(_t, _paged_case(rng, B, H, KV, D, pt, T))
        lens = torch.tensor([3, pt, pt + 2, 2 * pt], dtype=torch.int32)
        rows = torch.cat([pa.paged_decode_attention(q[b:b + 1], kp, vp, tab[b:b + 1],
                                                    lens[b:b + 1]) for b in range(B)])
        np.testing.assert_allclose(rows.numpy(),
                                   pa.paged_decode_attention(q, kp, vp, tab, lens).numpy(),
                                   atol=ATOL, rtol=0)
    elif name == "batched_arena_rejected":
        q, kp, vp, tab, k, v = map(_t, _paged_case(rng, 2, 4, 4, 32, 8, 2))
        with pytest.raises(ValueError, match="do not match"):
            pa.paged_decode_attention(q, torch.stack([kp, kp]), vp, tab, torch.tensor([3, 3]))
    elif name == "gather_layout":
        _, kp, vp, tab, k, v = _paged_case(rng, 2, 4, 4, 16, 8, 3)
        np.testing.assert_array_equal(pa.gather_kv_pages(_t(kp), _t(tab)).numpy(), k)
        np.testing.assert_array_equal(pa.gather_kv_pages(_t(vp), _t(tab)).numpy(),
                                      np.asarray(jax_pa.gather_kv_pages(jnp.asarray(vp),
                                                                        jnp.asarray(tab))))
    elif name == "supported_guard":
        assert pa.paged_decode_supported(16, 12, 12, 64)
        assert pa.paged_decode_supported(12, 32, 8, 128)    # any page size on the card
        assert not pa.paged_decode_supported(16, 12, 5, 64)     # KV must divide H
        assert not pa.paged_decode_supported(16, 8, 8, 80)      # D outside HEAD_DIMS
        assert not pa.paged_decode_supported(16, 64, 4, 64)     # group > 8
    elif name == "single_token_only":
        q, kp, vp, tab, k, v = map(_t, _paged_case(rng, 1, 4, 4, 32, 8, 2))
        with pytest.raises(ValueError, match="single-token"):
            pa.paged_decode_attention(torch.cat([q, q], 1), kp, vp, tab, torch.tensor([4]))
    elif name == "pagedkv_fields":
        pk = pa.PagedKV(torch.zeros(2, 8, 1, 4), torch.zeros(1, 2, dtype=torch.int32), 16)
        assert pk.pages.shape == (2, 8, 1, 4) and pk.cache_len == 16


@pytest.mark.parametrize("name", [
    "parity_mha", "parity_gqa", "reference_vs_kernel", "multitoken_suffix",
    "per_row_equals_batched", "batched_arena_rejected", "gather_layout", "supported_guard",
    "single_token_only", "pagedkv_fields"])
def test_unit_cases_replayed(name):
    _unit_case(name)


def test_multitoken_reference_masks_and_slices_like_jax():
    """The suffix-prefill path: per-row lengths, an attention mask and the
    ``s_kv`` slice to the model's cache length, against the JAX function."""
    rng = np.random.default_rng(11)
    B, H, KV, D, pt, T, S = 3, 8, 2, 32, 8, 4, 4
    _, kp, vp, tab, _, _ = _paged_case(rng, B, H, KV, D, pt, T)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    lengths = np.asarray([S, 13, 30], np.int32)
    mask = rng.random((B, 1, 1, 28)) < 0.9
    mask[..., 0] = True
    want = jax_pa.paged_reference_attention(*map(jnp.asarray, (q, kp, vp, tab, lengths)),
                                            attn_mask=jnp.asarray(mask), s_kv=28)
    got = pa.paged_reference_attention(*map(_t, (q, kp, vp, tab, lengths)),
                                       attn_mask=_t(mask), s_kv=28)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_cpu_wrapper_routes_to_plain_without_a_launch():
    q, kp, vp, table, lengths = _hazard_case(np.random.default_rng(5), 4, 2)
    args = tuple(map(_t, (q, kp, vp, table, lengths)))
    n0 = pa.KERNEL.launches
    got = pa.paged_decode_attention(*args)
    want = pa.paged_decode_attention_plain(*args, 64 ** -0.5)
    assert torch.equal(got, want) and pa.KERNEL.launches == n0


@pytest.mark.parametrize("bad", ["arena_d", "heads", "table_rows", "lengths"])
def test_bad_geometry_raises(bad):
    q, kp, vp, table, lengths = map(_t, _hazard_case(np.random.default_rng(6), 4, 2))
    if bad == "arena_d":
        kp, vp = kp[..., :32].contiguous(), vp[..., :32].contiguous()
    elif bad == "heads":
        q = torch.cat([q, q[:, :, :1]], 2)          # 5 query heads over 2 KV heads
    elif bad == "table_rows":
        table = table[1:]
    else:
        lengths = lengths[:3]
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kp, vp, table, lengths)


def test_jax_dense_reference_agrees_with_port_gather():
    """The gathered view is the contiguous original: dense attention over it
    (the JAX package's ``_jnp_attention``) equals the port's plain version."""
    rng = np.random.default_rng(9)
    q, kp, vp, tab, k, v = _paged_case(rng, 2, 4, 2, 32, 8, 3)
    lengths = np.asarray([9, 24], np.int32)
    kk, vv = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    mask = np.arange(24)[None, None, None, :] < lengths[:, None, None, None]
    want = _jnp_attention(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), causal=False,
                          bias=None, mask=jnp.asarray(mask), dropout_rate=0.0,
                          dropout_rng=None, scale=None)
    got = pa.paged_decode_attention(*map(_t, (q, kp, vp, tab, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# (H, KV, D, pt, T, lengths, chunk): the kernel's 64-position chunks over
# 16-token pages at 8 query heads per KV head (L = 0, 1, 63, 64, 65, 128,
# 129, the whole table, past it); 24-token pages, which chunks cut inside a
# page; the hazard rows with 16-position chunks, so every row of more than
# one page merges several states
PAGED_SPLIT_CASES = {
    "pt16_g8": (8, 1, 32, 16, 10, [0, 1, 63, 64, 65, 128, 129, 160, 300], 64),
    "pt24_g4": (8, 2, 32, 24, 4, [0, 5, 64, 65, 96, 130], 64),
    "hazard_chunk16": (8, 2, 64, 8, 5, None, 16),
}


@pytest.mark.parametrize("name", list(PAGED_SPLIT_CASES))
def test_split_plain_matches_pallas_paged(name):
    """The kernel's split arithmetic (gather, per-chunk fp32 states, merge
    by lse in chunk order) against the interpreted TPU kernel and the
    one-pass plain version, with NaN in every dead position and trash page
    and a free slot whose length ran past its all-trash table."""
    H, KV, D, pt, T, lengths, chunk = PAGED_SPLIT_CASES[name]
    q, kp, vp, table, lens = _hazard_case(np.random.default_rng(len(name)), H, KV, D, pt, T,
                                          lengths)
    want = jax_pa.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, table, lens)),
                                         interpret=True)
    args = tuple(map(_t, (q, kp, vp, table, lens))) + (D ** -0.5,)
    got = pa.paged_decode_attention_split_plain(*args, chunk=chunk)
    assert torch.isfinite(got).all(), "NaN pages or dead positions reached the output"
    assert (got[lens == 0] == 0).all(), "an L=0 row gives zeros"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pa.paged_decode_attention_plain(*args).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("pt,T", [(16, 4), (16, 32), (12, 9)])
def test_paged_launch_plan_comes_from_shapes_alone(monkeypatch, pt, T):
    """The paged wrapper's plan: ``ceil(T*pt / CHUNK)`` chunks and their
    workspace from the table's shape, nothing read back from the card."""
    q, kp, vp, table, lens = (_t(x).as_subclass(_OnCard) for x in
                              _hazard_case(np.random.default_rng(pt + T), 8, 2, 32, pt, T))
    with launch_recorder(monkeypatch, pa) as (launches, workspaces):
        pa.paged_decode_attention(q, kp, vp, table, lens)
    n = -(-T * pt // pa.CHUNK)
    assert len(launches) == 1 and workspaces == [(7, 8, n, 34)]
    assert launches[0][6] is not None
