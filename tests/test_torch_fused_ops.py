"""The port's fused LayerNorm, bias-GELU and attention softmax
(``ops/fused_ops.py``) against the JAX package's Pallas kernels in interpret
mode, on the CPU: values and every gradient, through the port's autograd
(CPU tensors run the kernels' plain versions) and ``jax.vjp`` over the JAX
ops with ``interpret=True``.

Tolerances: fp32 within rtol 1e-5 / atol 1e-5 of the outputs' scale (the
same fp32 arithmetic, sums in another order); bf16 element by element
within one bf16 ulp of the larger of the two values plus 1e-5 of the
output's largest magnitude (both cast once from fp32 at the same point; an
fp32 value the two orders round apart moves by one ulp, and near zero the
fp32 sums' own order noise, ~1e-7 of their addends, can exceed an ulp).
Cases: odd row counts (the JAX wrappers pad them to their row tile), Sq not
a multiple of the JAX ``block_q``, Sq < Sk, Sq > Sk (NaN rows in both
packages), parameters in another dtype than x (the gradients' dtypes), and
the mean-1000 LayerNorm input that pins the one-pass variance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import fused_ops as jfo
from deepspeed_tpu_torch.ops import fused_ops as fo

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def warm_torch_cpu_ops():
    """In a process that has already run JAX and torch computations, the
    FIRST torch CPU elementwise call now and then returns a contiguous
    stretch of its output computed from a neighbouring element (up to ~1e-3
    off; seen in one run in three after this file's LayerNorm cases, with
    torch's intra-op threads; every later call exact). One throwaway call
    takes that first call before the comparisons do."""
    x = torch.linspace(-8, 8, 1 << 16)
    for op in (torch.tanh, torch.exp, torch.rsqrt):
        op(x.abs() + 1)


def _rn(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), 1e-30)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref).max()))
    else:
        lim = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 1e-5 * np.abs(ref).max()
        assert (np.abs(got - ref) <= lim).all(), float((np.abs(got - ref) / lim).max())


def _jax_vjp(f, args, dy):
    y, vjp = jax.vjp(f, *args)
    return y, vjp(dy)


def _port_grads(f, args, dy):
    ts = [a.clone().requires_grad_() for a in args]
    y = f(*ts)
    y.backward(dy)
    return y.detach(), [t.grad for t in ts]


ODD, TWO_TILES = (3, 37), (256,)   # 111 rows (the JAX wrapper pads to 128); two 128-row tiles


@pytest.mark.parametrize("lead,dtype,pdtype", [
    (ODD, "float32", "float32"), (TWO_TILES, "float32", "float32"),
    (ODD, "bfloat16", "float32"), (TWO_TILES, "bfloat16", "bfloat16"),
    (ODD, "float32", "bfloat16")], ids=lambda v: "odd_rows" if v == ODD else (
        "two_row_tiles" if v == TWO_TILES else v))
def test_layer_norm_values_and_grads_match_jax(lead, dtype, pdtype):
    rng = np.random.default_rng(0)
    D = 256
    x, g, b = _rn(rng, lead + (D,)), 1 + _rn(rng, (D,), 0.1), _rn(rng, (D,), 0.1)
    dy = _rn(rng, lead + (D,))
    jd, jp = getattr(jnp, dtype), getattr(jnp, pdtype)
    td, tp = getattr(torch, dtype), getattr(torch, pdtype)
    jy, jg = _jax_vjp(lambda x, g, b: jfo.layer_norm(x, g, b, interpret=True),
                      (jnp.asarray(x, jd), jnp.asarray(g, jp), jnp.asarray(b, jp)),
                      jnp.asarray(dy, jd))
    ty, tg = _port_grads(fo.layer_norm, (torch.tensor(x).to(td), torch.tensor(g).to(tp),
                                         torch.tensor(b).to(tp)), torch.tensor(dy).to(td))
    assert ty.dtype == td and tg[0].dtype == td and tg[1].dtype == tp and tg[2].dtype == tp
    assert [str(a.dtype) for a in jg] == [dtype, pdtype, pdtype]
    _close(ty, jy, dtype)
    for got, ref, dt in zip(tg, jg, (dtype, pdtype, pdtype)):
        _close(got, ref, dt)


def test_layer_norm_pins_the_one_pass_variance():
    """Rows of 1000 and a few 1008s (variance ~1): every square and every
    partial sum is exact in fp32 whatever the order, so E[x²] and the mean
    are exact and the one-pass variance differs from the exact one only by
    the rounding of mean² (up to half an fp32 ulp at 1e6, 0.03). Both
    packages give that one-pass value to fp32 rounding of the rest; both
    miss the two-pass value by a hundred times that (~0.7% of the output's
    scale here)."""
    rng = np.random.default_rng(0)
    R, D = 6, 1024
    x = (1000 + 8 * (rng.random((R, D)) < 1 / 64)).astype(np.float32)
    g, b = _rn(rng, (D,)), _rn(rng, (D,))
    jy = _np(jfo.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), interpret=True))
    ty = _np(fo.layer_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b)))
    x64 = x.astype(np.float64)
    two_pass = ((x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-5)
                * g + b)
    scale = np.abs(two_pass).max()
    assert np.abs(ty - jy).max() <= 1e-5 * scale
    assert np.abs(jy - two_pass).max() > 1e-3 * scale
    assert np.abs(ty - two_pass).max() > 1e-3 * scale


@pytest.mark.parametrize("lead,dtype,bdtype", [
    ((5, 27), "float32", "float32"), ((200,), "float32", "float32"),
    ((5, 27), "bfloat16", "bfloat16"), ((200,), "bfloat16", "float32")],
    ids=["odd_rows-float32-float32", "two_row_tiles-float32-float32",
         "odd_rows-bfloat16-bfloat16", "two_row_tiles-bfloat16-float32"])
def test_bias_gelu_values_and_grads_match_jax(lead, dtype, bdtype):
    rng = np.random.default_rng(1)
    D = 96
    x, b, dy = _rn(rng, lead + (D,), 2.0), _rn(rng, (D,)), _rn(rng, lead + (D,))
    jd, jb = getattr(jnp, dtype), getattr(jnp, bdtype)
    td, tb = getattr(torch, dtype), getattr(torch, bdtype)
    jy, jg = _jax_vjp(lambda x, b: jfo.bias_gelu(x, b, interpret=True),
                      (jnp.asarray(x, jd), jnp.asarray(b, jb)), jnp.asarray(dy, jd))
    ty, tg = _port_grads(fo.bias_gelu, (torch.tensor(x).to(td), torch.tensor(b).to(tb)),
                         torch.tensor(dy).to(td))
    assert ty.dtype == td and tg[0].dtype == td and tg[1].dtype == tb
    _close(ty, jy, dtype)
    _close(tg[0], jg[0], dtype)
    _close(tg[1], jg[1], bdtype)


# (lead, Sq, Sk, causal, scale): Sq=130 is no multiple of the JAX block_q
# (128), so the JAX wrapper pads; 100 < 200 puts the triangle's offset at 100;
# rows past the held kernel's width take the card's wide route
SOFTMAX_CASES = {
    "causal_ragged": ((2, 3), 130, 130, True, 0.125),
    "full_ragged": ((2, 3), 130, 130, False, 0.125),
    "causal_sq_lt_sk": ((2,), 100, 200, True, 1.0),
    "full_sq_lt_sk": ((3,), 40, 72, False, 0.5),
    "causal_wide": ((2,), 6, fo.SOFTMAX_HELD_COLS + 5, True, 0.125),
}


@pytest.mark.parametrize("case,dtype", [(c, d) for c in SOFTMAX_CASES
                                        for d in ("float32", "bfloat16")
                                        if (c, d) != ("full_sq_lt_sk", "bfloat16")])
def test_attention_softmax_values_and_grads_match_jax(case, dtype):
    lead, Sq, Sk, causal, scale = SOFTMAX_CASES[case]
    rng = np.random.default_rng(2)
    s, dy = _rn(rng, lead + (Sq, Sk), 3.0), _rn(rng, lead + (Sq, Sk))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, (jds,) = _jax_vjp(lambda s: jfo.attention_softmax(s, causal=causal, scale=scale,
                                                          interpret=True),
                          (jnp.asarray(s, jd),), jnp.asarray(dy, jd))
    ty, (tds,) = _port_grads(lambda s: fo.attention_softmax(s, causal=causal, scale=scale),
                             (torch.tensor(s).to(td),), torch.tensor(dy).to(td))
    assert ty.dtype == td and tds.dtype == td
    assert not np.isnan(_np(ty)).any()
    _close(ty, jy, dtype)
    _close(tds, jds, dtype)


def test_attention_softmax_fully_masked_rows_are_nan_in_both():
    """Sq > Sk under ``causal``: query rows i < Sq − Sk see no key, and the
    TPU kernel's guard makes them 0/0 = NaN (ROADMAP.md, "Not port faults");
    the port reproduces it, and the other rows agree."""
    rng = np.random.default_rng(3)
    s, dy = _rn(rng, (2, 6, 4)), _rn(rng, (2, 6, 4))
    jy, (jds,) = _jax_vjp(lambda s: jfo.attention_softmax(s, causal=True, interpret=True),
                          (jnp.asarray(s),), jnp.asarray(dy))
    ty, (tds,) = _port_grads(lambda s: fo.attention_softmax(s, causal=True),
                             (torch.tensor(s),), torch.tensor(dy))
    jy, ty = _np(jy), _np(ty)
    nan_rows = np.zeros((2, 6, 4), dtype=bool)
    nan_rows[:, :2] = True
    assert np.array_equal(np.isnan(jy), nan_rows) and np.array_equal(np.isnan(ty), nan_rows)
    np.testing.assert_allclose(ty[:, 2:], jy[:, 2:], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tds), _np(jds), rtol=1e-5, atol=1e-6, equal_nan=True)


def test_no_grad_and_plain_versions():
    """Under ``no_grad`` the ops give the same values; the wrappers of CPU
    tensors are the plain versions; the parameter-gradient sums are the
    plain versions' fp32 sums cast to the parameters' dtype."""
    rng = np.random.default_rng(4)
    x, g, b = torch.tensor(_rn(rng, (9, 64))), torch.tensor(_rn(rng, (64,))), torch.tensor(
        _rn(rng, (64,)))
    with torch.no_grad():
        y = fo.layer_norm(x, g, b)
    assert torch.equal(y, fo.layer_norm_fwd_plain(x, g, b, 1e-5)[0])
    assert torch.equal(fo.layer_norm_fwd(x, g, b, 1e-5)[0], y)
    assert torch.equal(fo.bias_gelu_fwd(x, b), fo.bias_gelu_fwd_plain(x, b))
    p = fo.softmax_fwd(x[None], True, 0.5)
    assert torch.equal(p, fo.softmax_fwd_plain(x[None], True, 0.5))
    assert torch.equal(fo.gelu_tanh(x), 0.5 * x * (1 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x * x * x))))
