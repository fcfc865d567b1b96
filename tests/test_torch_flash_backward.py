"""Flash-attention backward: the port's autograd.Function on the CPU (the
plain backward its CUDA kernels are held against on the card) against
``jax.grad`` through the JAX Pallas kernels in interpret mode, in both of
JAX's backward modes, with and without an lse cotangent, at every head dim
the kernels take and with an explicit scale; ragged S and Sk != S against
dense autograd in torch.

fp32 there. Tolerances: rtol 1e-5 with atol 1e-5 against the Pallas
backward (the same fp32 products summed in another order, gradients of
order 1), atol 2e-5 against dense autograd (a one-pass softmax against the
recomputed probabilities). Then, in bf16, the card's split kernels'
rounding points (p and ds as bf16 hi + lo) emulated in torch against JAX's
split backward, and the kernels the CUDA library counts against
``BWD_KERNELS``.
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


# ---- the bf16 split kernels' rounding points (flash_bwd_{dq,dkv}_sm90_kernel) ----
#
# The card's split pair feeds p and ds to the tensor cores as bf16 hi + lo
# pairs and sums every product in fp32; the merged kernel rounds p and ds to
# bf16 once. The emulation below repeats those rounding points in torch (the
# kernels run only on the card) and is held against JAX's split backward,
# which forms every product from fp32 operands, within the fp32-only
# per-element limit the card's smoke gates (one bf16 ulp of the larger value
# + 1e-5 x the element's sum of addend magnitudes).

_SPLIT_CASES = [(True, 200, 200), (False, 136, 200)]   # causal ragged; non-causal Sk != S


def _bf16_inputs(S, Sk, D, seed, B=1, H=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
            for shape in ((B, S, H, D), (B, Sk, H, D), (B, Sk, H, D), (B, S, H, D))]


def _emulate_split(q, k, v, do, lse, delta, causal, scale, hi_lo=True):
    """(dq, dk, dv) in bf16 with the kernels' rounding points: s and dp from
    the bf16 operands in fp32, p = exp2(s·scale·log2e − lse·log2e), ds = p
    (dp − delta), each of p and ds as bf16 hi + lo (``hi_lo``) or rounded to
    bf16 once (the merged kernel's rounding), products summed in fp32, scale
    on the fp32 side."""
    B, S, H, _ = q.shape
    Sk = k.shape[1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    log2e = 1.4426950408889634
    s = torch.einsum("bshd,bthd->bhst", qf, kf)
    p = torch.exp2(s * (scale * log2e) - (lse.reshape(B, H, S, 1) * log2e))
    if causal:
        p = p.masked_fill(~(torch.arange(S)[:, None] >= torch.arange(Sk)[None, :]), 0.0)
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    ds = p * (dp - delta.reshape(B, H, S, 1))

    def parts(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if hi_lo else (hi,)

    dq = sum(torch.einsum("bhst,bthd->bshd", x, kf) for x in parts(ds)) * scale
    dk = sum(torch.einsum("bhst,bshd->bthd", x, qf) for x in parts(ds)) * scale
    dv = sum(torch.einsum("bhst,bshd->bthd", x, dof) for x in parts(p))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _addend_magnitudes(q, k, v, do, o, lse, causal, scale):
    """Each gradient element's sum of addend magnitudes in fp64 (the smoke's
    ``flash_fp64``): dv's Σ_i p_ij |do_i|; dq's and dk's scale × sums of p
    (Σ_d |do_d v_d| + Σ_d |do_d o_d|) |k| or |q|."""
    B, S, H, _ = q.shape
    Sk = k.shape[1]
    qd, kd, vd, dod, od = (t.double() for t in (q, k, v, do, o))
    s = torch.einsum("bshd,bthd->bhst", qd, kd) * scale
    if causal:
        s = s.masked_fill(~(torch.arange(S)[:, None] >= torch.arange(Sk)[None, :]),
                          float("-inf"))
    p = torch.exp(s - lse.double().reshape(B, H, S, 1))
    t = p * (torch.einsum("bshd,bthd->bhst", dod.abs(), vd.abs())
             + (dod * od).abs().sum(-1).permute(0, 2, 1)[..., None])
    return (scale * torch.einsum("bhst,bthd->bshd", t, kd.abs()),
            scale * torch.einsum("bhst,bshd->bthd", t, qd.abs()),
            torch.einsum("bhst,bshd->bthd", p, dod.abs()))


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30))) - 7)


def _over_fp32_limit(got, ref, mag):
    """The largest ratio of |got − ref| to one bf16 ulp of the larger value +
    1e-5 × mag, over the elements."""
    g, r = got.double(), ref.double()
    ulp = _bf16_ulp(torch.maximum(g.abs(), r.abs()))
    return float(((g - r).abs() / (ulp + 1e-5 * mag)).max())


def _split_reference(monkeypatch, causal, S, Sk, D):
    """The bf16 inputs, lse and delta (the port's plain forward), JAX's split
    backward on them (interpreted Pallas, one tile each way) and the addend
    magnitudes."""
    monkeypatch.setenv("DS_TPU_FLASH_BWD", "split")
    from deepspeed_tpu.ops.pallas.flash_attention import _flash_bwd_impl
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_plain

    q, k, v, do = _bf16_inputs(S, Sk, D, seed=S + Sk + D + causal)
    B, _, H, _ = q.shape
    scale = D ** -0.5
    o, lse = flash_attention_plain(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, 1, S)

    def bh(t):   # (B, L, H, D) -> (B·H, L, D), as a bf16 JAX array
        x = t.float().permute(0, 2, 1, 3).reshape(B * H, t.shape[1], D).numpy()
        return jnp.asarray(x, dtype=jnp.bfloat16)

    jq, jk, jv, jdo = map(bh, (q, k, v, do))
    got = _flash_bwd_impl(causal, scale, S, Sk, 1, True, jq, jk, jv,
                          jnp.asarray(lse.numpy()), jdo, jnp.asarray(delta.numpy()))
    want = [torch.from_numpy(np.array(g.astype(jnp.float32)))
            .reshape(B, H, -1, D).permute(0, 2, 1, 3) for g in got]
    mags = _addend_magnitudes(q, k, v, do, o, lse, causal, scale)
    return (q, k, v, do, lse, delta, scale), want, mags


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal,S,Sk", _SPLIT_CASES)
def test_split_hi_lo_rounding_meets_the_fp32_limit_against_pallas(monkeypatch, causal, S, Sk, D):
    (q, k, v, do, lse, delta, scale), want, mags = _split_reference(monkeypatch, causal, S, Sk, D)
    got = _emulate_split(q, k, v, do, lse, delta, causal, scale)
    ratios = [_over_fp32_limit(g, w, m) for g, w, m in zip(got, want, mags)]
    assert max(ratios) <= 1.0, ratios
    # the control: p and ds rounded to bf16 once (the merged kernel's
    # rounding) miss the same limit, so the limit sees what hi + lo keeps
    once = _emulate_split(q, k, v, do, lse, delta, causal, scale, hi_lo=False)
    assert max(_over_fp32_limit(g, w, m) for g, w, m in zip(once, want, mags)) > 1.0


def test_bwd_kernels_name_the_counted_kernels_in_counter_order():
    """``BWD_KERNELS`` names the flash backward library's counted
    ``__global__`` kernels in the order of its launch counters, read from
    the source: each ``g_launched[i]`` site and the kernel launched there."""
    import re
    from pathlib import Path

    from deepspeed_tpu_torch.ops import flash_attention as fa

    src = (Path(fa.__file__).with_name("csrc") / "flash_attention_bwd.cu").read_text()
    kernels = set(re.findall(
        r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(flash_bwd_\w+_kernel)\s*\(", src))
    counted = {}
    pos = 0
    for m in re.finditer(r"counted\(cudaGetLastError\(\), g_launched\[(\d+)\]\)", src):
        names = re.findall(r"\b(flash_bwd_\w+_kernel)\b", src[pos:m.start()])
        pos = m.end()
        counted.setdefault(int(m.group(1)), set()).add(names[-1])
    assert counted == {i: {name} for i, name in enumerate(fa.BWD_KERNELS)}
    uncounted = {"flash_bwd_prep_kernel", "flash_bwd_dq_cast_kernel"}
    assert kernels - uncounted == set(fa.BWD_KERNELS)
    assert "g_launched[kCounted]" in src and f"kCounted = {len(fa.BWD_KERNELS)};" in src
