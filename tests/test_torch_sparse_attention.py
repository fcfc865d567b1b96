"""The port's block-sparse attention (``ops/sparse_attention``) against the
JAX package's, on the CPU.

Layouts: every family (and its unidirectional and per-head variants) gives
the JAX package's block layout bit for bit, and ``_build_lut`` its LUT and
counts, at the test size and at the shapes ``chip_smoke.py`` drives. The
mask path against JAX's mask path (fp32, rtol 1e-6: the same fp32 softmax).
The kernel path on CPU tensors (the kernel's plain version) against the
JAX Pallas kernel in interpret mode, as the JAX package's own tests run it:
fp32 within 2e-5 (the same fp32 arithmetic, the online softmax summed in
another order) and bf16 within one bf16 ulp of the output's largest
magnitude (one cast at the end on both sides; an fp32 value the two orders
round apart moves by one ulp). Then the empty query block (zeros under
``"pallas"``, the mean of v under ``"mask"``, in both packages), the shape
and divisibility errors, and the kernel path's missing backward.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as jssa
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as tssa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

from .test_torch_fused_ops import warm_torch_cpu_ops  # noqa: F401 (an autouse fixture)

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

H, BLOCK, S, D = 2, 16, 128, 32

# id: (class name, keyword arguments); the first six are the JAX tests' configs
FAMILIES = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed": ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1)),
    "fixed_uni": ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=2,
                                              attention="unidirectional")),
    "variable": ("VariableSparsityConfig", dict(num_random_blocks=1, local_window_blocks=[2, 4],
                                                global_block_indices=[0])),
    "bigbird": ("BigBirdSparsityConfig", dict(num_random_blocks=1, num_sliding_window_blocks=3,
                                              num_global_blocks=1)),
    "bslongformer": ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                                        global_block_indices=[0])),
    "fixed_horizontal": ("FixedSparsityConfig", dict(horizontal_global_attention=True)),
    "fixed_patterns": ("FixedSparsityConfig", dict(num_different_global_patterns=2)),
    "variable_uni_ends": ("VariableSparsityConfig", dict(
        num_random_blocks=2, local_window_blocks=[1, 2, 3], global_block_indices=[0, 5],
        global_block_end_indices=[2, 6], attention="unidirectional",
        horizontal_global_attention=True)),
    "bigbird_uni": ("BigBirdSparsityConfig", dict(num_random_blocks=2, num_global_blocks=2,
                                                  attention="unidirectional")),
    "bslongformer_uni_ends": ("BSLongformerSparsityConfig", dict(
        num_sliding_window_blocks=5, global_block_indices=[1], global_block_end_indices=[3],
        attention="unidirectional")),
}
KERNEL_FAMILIES = ["dense", "fixed", "fixed_uni", "variable", "bigbird", "bslongformer"]
# the layouts chip_smoke.py drives: (id, seq_len)
SMOKE_LAYOUTS = [
    (("FixedSparsityConfig", dict(num_heads=16, block=16)), 512),
    (("FixedSparsityConfig", dict(num_heads=16, block=16, attention="unidirectional")), 512),
    (("DenseSparsityConfig", dict(num_heads=16, block=16)), 512),
    (("BigBirdSparsityConfig", dict(num_heads=16, block=64)), 4096),
    (("BSLongformerSparsityConfig", dict(num_heads=16, block=64)), 4096),
    (("VariableSparsityConfig", dict(num_heads=16, block=64)), 4096),
    (("BigBirdSparsityConfig", dict(num_heads=16, block=64, different_layout_per_head=True)),
     4096),
]


def _configs(fam, per_head=False, **over):
    name, kw = FAMILIES[fam]
    kw = dict(num_heads=H, block=BLOCK, different_layout_per_head=per_head, **kw, **over)
    return getattr(jsc, name)(**kw), getattr(tsc, name)(**kw)


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, H, D)).astype(np.float32) for _ in range(3)]


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype) for a in arrs]


def _torch(arrs, dtype):
    return [torch.tensor(a).to(dtype) for a in arrs]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(max(float(x), 1e-30))) - 7)


@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_layouts_and_luts_equal_jax(fam, per_head):
    try:
        jcfg, _ = _configs(fam, per_head)
    except ValueError as e:   # the same validation error in the port
        with pytest.raises(ValueError, match=str(e)):
            _configs(fam, per_head)
        return
    tcfg = _configs(fam, per_head)[1]
    jl, tl = jcfg.make_layout(S), tcfg.make_layout(S)
    assert tl.dtype == jl.dtype and np.array_equal(tl, jl)
    for a, b in zip(tssa._build_lut(tl), jssa._build_lut(jl)):
        assert np.array_equal(a, b)
    assert np.array_equal(tssa.layout_to_dense_mask(tl, BLOCK),
                          jssa.layout_to_dense_mask(jl, BLOCK))


@pytest.mark.parametrize("cfg,seq", SMOKE_LAYOUTS,
                         ids=lambda c: c[0][:-14] if isinstance(c, tuple) else str(c))
def test_smoke_layouts_equal_jax(cfg, seq):
    name, kw = cfg
    jl, tl = getattr(jsc, name)(**kw).make_layout(seq), getattr(tsc, name)(**kw).make_layout(seq)
    assert np.array_equal(tl, jl)
    for a, b in zip(tssa._build_lut(tl), jssa._build_lut(jl)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_mask_impl_matches_jax(fam, causal):
    jcfg, tcfg = _configs(fam, per_head=fam == "fixed_patterns")
    layout = jcfg.make_layout(S)
    arrs = _qkv(3)
    ref = jssa.sparse_attention(*_jax(arrs, jnp.float32), layout, BLOCK, causal=causal,
                                impl="mask")
    out = tssa.sparse_attention(*_torch(arrs, torch.float32), tcfg.make_layout(S), BLOCK,
                                causal=causal, impl="mask")
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _kernel_outputs(causal, dtype):
    """(JAX's interpreted kernel, the port's kernel path) over every family
    of ``KERNEL_FAMILIES`` at once: their layouts stacked along the head
    axis (each family's H heads in turn; the kernel takes a LUT per head),
    so that one interpreted call serves them all."""
    layout = np.concatenate([_configs(f)[0].make_layout(S) for f in KERNEL_FAMILIES])
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((1, S, layout.shape[0], D)).astype(np.float32) for _ in range(3)]
    ref = _np(jssa.sparse_attention(*_jax(arrs, getattr(jnp, dtype)), layout, BLOCK,
                                    causal=causal, impl="pallas", interpret=True))
    out = tssa.sparse_attention(*_torch(arrs, getattr(torch, dtype)), layout, BLOCK,
                                causal=causal, impl="pallas")
    return ref, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("fam", KERNEL_FAMILIES)
def test_kernel_impl_matches_interpreted_pallas(fam, causal, dtype):
    ref, out = _kernel_outputs(causal, dtype)
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    i = KERNEL_FAMILIES.index(fam)
    heads = slice(i * H, (i + 1) * H)
    ref, got = ref[:, :, heads], _np(out)[:, :, heads]
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_ulp(np.abs(ref).max()))


def test_empty_query_block_zeros_under_kernel_mean_under_mask():
    jcfg, tcfg = _configs("fixed")
    layout = jcfg.make_layout(S)
    layout[:, 3, :] = 0   # query block 3 attends nothing
    arrs = _qkv(5)
    jq, tq = _jax(arrs, jnp.float32), _torch(arrs, torch.float32)
    rows = slice(3 * BLOCK, 4 * BLOCK)
    jk = _np(jssa.sparse_attention(*jq, layout, BLOCK, impl="pallas", interpret=True))
    tk = _np(tssa.sparse_attention(*tq, layout, BLOCK, impl="pallas"))
    assert (jk[:, rows] == 0).all() and (tk[:, rows] == 0).all()
    np.testing.assert_allclose(tk, jk, rtol=2e-5, atol=2e-5)
    v_mean = arrs[2].mean(axis=1)   # (1, H, D): a uniform softmax over every key
    for out in (jssa.sparse_attention(*jq, layout, BLOCK, impl="mask"),
                tssa.sparse_attention(*tq, layout, BLOCK, impl="mask")):
        np.testing.assert_allclose(_np(out)[:, rows], np.broadcast_to(v_mean[:, None], (1, BLOCK,
                                                                                     H, D)),
                                   rtol=1e-5, atol=1e-5)


def test_shape_and_divisibility_errors_match_jax():
    jcfg, tcfg = _configs("fixed")
    with pytest.raises(ValueError, match="not divisible"):
        jcfg.make_layout(100)
    with pytest.raises(ValueError, match="not divisible"):
        tcfg.make_layout(100)
    arrs = _qkv(0)
    bad = jcfg.make_layout(S // 2)
    for impl in ("mask", "pallas"):
        with pytest.raises(ValueError, match="layout shape"):
            jssa.sparse_attention(*_jax(arrs, jnp.float32), bad, BLOCK, impl=impl, interpret=True)
        with pytest.raises(ValueError, match="layout shape"):
            tssa.sparse_attention(*_torch(arrs, torch.float32), bad, BLOCK, impl=impl)
    layout = jcfg.make_layout(S)
    with pytest.raises(ValueError, match="unknown impl"):
        jssa.sparse_attention(*_jax(arrs, jnp.float32), layout, BLOCK, impl="jnp")
    with pytest.raises(ValueError, match="unknown impl"):
        tssa.sparse_attention(*_torch(arrs, torch.float32), layout, BLOCK, impl="jnp")
    for pkg in (jsc, tsc):
        with pytest.raises(ValueError, match="sequence too short"):
            pkg.BigBirdSparsityConfig(num_heads=1, block=16,
                                      num_sliding_window_blocks=9).make_layout(64)


def test_kernel_backward_raises_and_module_caches_its_lut():
    _, tcfg = _configs("bigbird")
    q, k, v = (t.requires_grad_() for t in _torch(_qkv(2), torch.float32))
    sa = SparseSelfAttention(tcfg, impl="pallas")
    out = sa(q, k, v)
    assert out.requires_grad
    with pytest.raises(NotImplementedError, match="B10"):
        out.sum().backward()
    ref = tssa.sparse_attention(q.detach(), k.detach(), v.detach(), tcfg.make_layout(S), BLOCK,
                                impl="pallas")
    assert torch.equal(out.detach(), ref)
    lut = sa.get_lut(S, "cpu")
    assert sa.get_lut(S, torch.device("cpu"))[0] is lut[0] and lut[0].dtype == torch.int32
    assert sa.get_layout(S) is sa.get_layout(S)
    # the mask path is differentiable
    SparseSelfAttention(tcfg)(q, k, v).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
