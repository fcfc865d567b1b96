"""The LayerNorm backward's blocks (``ops/fused_ops.py``: ``ln_bwd_plan``) and
the plain model of its order of summation (``layer_norm_bwd_tiled_plain``),
and the softmax forward's grid (``softmax_fwd_plan``), on the CPU.

The plan: blocks of whole rows covering every row once, one block an SM for
rows of up to ``LN_HELD_COLS`` columns and ``LN_ROWS`` rows a block past
it. The tiled plain version against the JAX package's ``_ln_bwd_kernel``
run with ``interpret=True`` (through ``jax.vjp`` of the public op) and
against ``layer_norm_bwd_plain``, with ragged rows, D % 8 != 0, a row past
``LN_HELD_COLS``, bf16 and fp32, at the tolerances of
``test_torch_fused_ops.py`` (fp32 rtol 1e-5 / atol 1e-5 of the scale; bf16
one bf16 ulp of the larger value plus 1e-5 of the largest magnitude: the
same fp32 sums in another order); dx is the plain version's, bit for bit.
The order itself, block by block, warp by warp and segment by segment, is
pinned against a loop over float32 scalars in the kernels' order. Then the
wrapper's CUDA branch: one counted launch with the plan's rows a block,
nothing read back.

The softmax forward's plan: the held route up to ``SOFTMAX_HELD_COLS`` keys,
one wave of blocks, each warp a run of rows (even past one row); the kernel's row order
(causal queries t and Sq − 1 − t paired, modelled here in numpy) covers
every row once and gives each warp's run the same kept keys; the wide route
one row a warp. The wrapper's CUDA branch at a held and a wide width: one
counted launch with the plan's rows a warp, nothing read back.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import fused_ops as jfo
from deepspeed_tpu_torch.ops import fused_ops as fo

from .test_torch_decode_attention import _NoHostRead, _OnCard
from .test_torch_fused_ops import _close, _rn

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)


def test_ln_bwd_plan_covers_rows_once():
    for n_sm in (1, 4, 132):
        for D in (64, 1001, 1024, 1025, 2050):
            for R in (1, 7, 8, 111, 8192, 24576):
                rpb, parts = fo.ln_bwd_plan(R, D, n_sm)
                assert (parts - 1) * rpb < R <= parts * rpb
                if D > fo.LN_HELD_COLS:
                    assert rpb == fo.LN_ROWS
                else:
                    assert rpb >= fo.LN_WARPS and parts <= max(n_sm, 1)
    # BERT-large's (8192, 1024) on an H100's 132 SMs: 131 partial rows
    assert fo.ln_bwd_plan(8192, 1024, 132) == fo.LnBwdPlan(63, 131)


def _inputs(R, D, dtype, seed):
    rng = np.random.default_rng(seed)
    x, g, b, dy = _rn(rng, (R, D)), 1 + _rn(rng, (D,), 0.1), _rn(rng, (D,), 0.1), _rn(rng, (R, D))
    return x, g, b, dy


@pytest.mark.parametrize("R,D,dtype,n_sm", [(111, 100, "float32", 4), (111, 100, "bfloat16", 4),
                                            (300, 256, "bfloat16", 132),
                                            (20, 1030, "float32", 4)],
                         ids=["ragged-fp32", "ragged-bf16", "bf16", "wide-fp32"])
def test_tiled_plain_matches_jax_kernel(R, D, dtype, n_sm):
    x, g, b, dy = _inputs(R, D, dtype, R + D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda x, g, b: jfo.layer_norm(x, g, b, interpret=True),
                     jnp.asarray(x, jd), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy, jd))
    tx, tg, tb, tdy = torch.tensor(x).to(td), torch.tensor(g), torch.tensor(b), \
        torch.tensor(dy).to(td)
    _, mean, rstd = fo.layer_norm_fwd_plain(tx, tg, tb, 1e-5)
    plan = fo.ln_bwd_plan(R, D, n_sm)
    got = fo.layer_norm_bwd_tiled_plain(tx, tg, mean, rstd, tdy, plan)
    plain = fo.layer_norm_bwd_plain(tx, tg, mean, rstd, tdy)
    assert torch.equal(got[0], plain[0]) and got[0].dtype == td
    for w, t, p, dt in zip(want, got, plain, (dtype, "float32", "float32")):
        _close(t, w, dt)
        _close(t, p, "float32")


def _ordered(parts):
    """``ln_bwd_sum_kernel``'s order over float32 scalars."""
    P, D = parts.shape
    per = -(-P // fo.LN_SUM_SEGS)
    out = np.zeros(D, np.float32)
    for c in range(D):
        segs = []
        for k in range(fo.LN_SUM_SEGS):
            acc = np.float32(0)
            for p in range(k * per, min(P, (k + 1) * per)):
                acc = np.float32(acc + parts[p, c])
            segs.append(acc)
        tot = segs[0]
        for s in segs[1:]:
            tot = np.float32(tot + s)
        out[c] = tot
    return out


@pytest.mark.parametrize("R,D", [(37, 20), (40, 1030)], ids=["rows", "wide"])
def test_tiled_order_is_the_kernels(R, D):
    x, g, b, dy = _inputs(R, D, "float32", 5)
    tx, tg, tdy = torch.tensor(x), torch.tensor(g), torch.tensor(dy)
    _, mean, rstd = fo.layer_norm_fwd_plain(tx, tg, torch.tensor(b), 1e-5)
    plan = fo.ln_bwd_plan(R, D, 2)
    _, dg, db = fo.layer_norm_bwd_tiled_plain(tx, tg, mean, rstd, tdy, plan)
    xh = ((tx - mean) * rstd).numpy()
    terms = (np.float32(dy) * xh, np.float32(dy))
    rpb, P = plan
    for got, t in zip((dg, db), terms):
        parts = np.zeros((P, D), np.float32)
        for blk in range(P):
            rows = range(blk * rpb, min(R, (blk + 1) * rpb))
            if D > fo.LN_HELD_COLS:             # the block's rows in order
                for r in rows:
                    parts[blk] = parts[blk] + t[r]
                continue
            warps = np.zeros((fo.LN_WARPS, D), np.float32)
            for j, r in enumerate(rows):        # warp j % 8 takes local row j
                warps[j % fo.LN_WARPS] = warps[j % fo.LN_WARPS] + t[r]
            parts[blk] = ((warps[0] + warps[1]) + (warps[2] + warps[3])) + \
                ((warps[4] + warps[5]) + (warps[6] + warps[7]))
        assert np.array_equal(got.numpy(), _ordered(parts))


def test_ln_bwd_launch_from_shapes(monkeypatch):
    launches = []
    monkeypatch.setattr(fo.LN_BWD, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(fo, "_sm_count", lambda index: 4)
    monkeypatch.setattr(fo, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())

    def card(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)
    x, dy = card(300, 520), card(300, 520)
    gamma = card(520, dtype=torch.float32)
    mean, rstd = card(300, 1, dtype=torch.float32), card(300, 1, dtype=torch.float32)
    with _NoHostRead():
        dx, dg, db = fo.layer_norm_bwd(x, gamma, mean, rstd, dy)
    assert dx.shape == (300, 520) and dx.dtype == torch.bfloat16
    assert dg.shape == db.shape == (520,) and dg.dtype == torch.float32
    (args,) = launches
    # ..., R, D, rows a block, dtype, stream
    assert args[-5:] == (300, 520, fo.ln_bwd_plan(300, 520, 4).rows_per_block, 1, 7)
    assert args[8] == dg.data_ptr() and args[9] == db.data_ptr()


def test_softmax_fwd_plan_covers_rows_once():
    # resident blocks an SM: four up to 1024 bytes a row, else two
    per_sm = {(256, 2): 4, (512, 2): 4, (520, 2): 2, (1024, 2): 2, (256, 4): 4, (512, 4): 2}
    for n_sm, item in ((1, 2), (4, 4), (132, 2), (132, 4)):
        for Sk in (5, 256, 512, 520, 1024, 1025, 4096):
            for rows in (1, 7, 8, 111, 32768, 131072):
                route, rpw, blocks = fo.softmax_fwd_plan(rows, Sk, n_sm, item)
                warps = blocks * fo.SOFTMAX_WARPS
                assert (blocks - 1) * fo.SOFTMAX_WARPS * rpw < rows <= warps * rpw
                if Sk > fo.SOFTMAX_HELD_COLS:
                    assert (route, rpw) == ("wide", 1)
                else:
                    assert route == "held" and (rpw % 2 == 0 or rows <= warps)
                    assert blocks <= n_sm * per_sm.get((Sk, item), 4 if Sk < 256 else 2)
    # BERT-large on an H100's 132 SMs: (B·H, S, S) and a 128-query block
    # over 512 keys; a wide row
    assert fo.softmax_fwd_plan(256 * 512, 512, 132) == fo.SoftmaxFwdPlan("held", 32, 512)
    assert fo.softmax_fwd_plan(256 * 128, 512, 132) == fo.SoftmaxFwdPlan("held", 8, 512)
    assert fo.softmax_fwd_plan(16 * 64, 4096, 132) == fo.SoftmaxFwdPlan("wide", 1, 128)


def _held_rows(BH, Sq, Sk, causal, n_sm):
    """``softmax_fwd_held_kernel``'s rows, warp by warp (``softmax_row``),
    and each row's kept keys."""
    _, rpw, blocks = fo.softmax_fwd_plan(BH * Sq, Sk, n_sm)
    v = np.arange(blocks * fo.SOFTMAX_WARPS * rpw)
    v = v[v < BH * Sq]
    j = v % Sq
    i = np.where(j % 2 == 1, Sq - 1 - j // 2, j // 2) if causal else j
    kept = np.clip((Sk - Sq) + i + 1, 0, Sk) if causal else np.full_like(v, Sk)
    return rpw, v - j + i, kept


@pytest.mark.parametrize("BH,Sq,Sk", [(3, 512, 512), (5, 128, 512), (2, 77, 130), (4, 8, 5),
                                      (1, 7, 1024)])
def test_softmax_held_rows_once_and_even_per_warp(BH, Sq, Sk):
    for causal in (False, True):
        rpw, rows, kept = _held_rows(BH, Sq, Sk, causal, 4)
        assert np.array_equal(np.sort(rows), np.arange(BH * Sq))
        if causal and Sq <= Sk and Sq % 2 == 0 and rpw > 1:   # whole pairs: runs read alike
            full = len(rows) // rpw * rpw
            per_warp = kept[:full].reshape(-1, rpw).sum(1)
            assert (per_warp == per_warp[0]).all()


@pytest.mark.parametrize("Sk,route", [(520, "held"), (fo.SOFTMAX_HELD_COLS + 76, "wide")])
def test_softmax_fwd_launch_from_shapes(monkeypatch, Sk, route):
    launches = []
    monkeypatch.setattr(fo.SOFTMAX_FWD, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(fo, "_sm_count", lambda index: 4)
    monkeypatch.setattr(fo, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    s = torch.zeros((6, 40, Sk), dtype=torch.bfloat16).as_subclass(_OnCard)
    with _NoHostRead():
        p = fo.softmax_fwd(s, True, 0.125)
    assert p.shape == s.shape and p.dtype == torch.bfloat16
    (args,) = launches
    plan = fo.softmax_fwd_plan(240, Sk, 4, 2)
    assert plan.route == route
    # s, p, BH, Sq, Sk, q_offset, scale, causal, rows a warp, dtype, stream
    assert args[0] == s.data_ptr() and args[1] == p.data_ptr()
    assert args[2:] == (6, 40, Sk, Sk - 40, 0.125, 1, plan.rows_per_warp, 1, 7)
