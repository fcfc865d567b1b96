"""The tensor-core block-sparse kernel's plan (``build_plan``) and its plain
twin (``sparse_attention_tiled_plain``), on the CPU.

The plan: at every block the kernel takes, for every layout family (shared
and per head, causal or not, with empty query blocks), the (query block,
key) pairs its work items enable are the layout's, each exactly once
(under ``causal``, less the keys wholly past a tile's last row, which the
TPU kernel masks whole); items respect the cap, come widest first, and a
split tile's pieces own consecutive workspace slots. The tiled plain
version, which follows the plan item by item and merges split tiles by lse,
against the JAX package's Pallas kernel in interpret mode and against the
one-pass plain version: fp32 within 2e-5 (fp32 sums in other orders), bf16
within one bf16 ulp of the output's largest magnitude (one cast at the end
on both sides). A cap of one key tile splits every wide tile, and one
dominant score sits in a tile's last piece, so each piece's state must be
rescaled before the sum. Then the CUDA branch: its launch comes from the
cached plan and the shapes alone (no value read back from the card), one
launch a call, with the workspace the plan's slots need.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as jssa
from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as tssa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

from .test_torch_decode_attention import _NoHostRead, _OnCard
from .test_torch_sparse_attention import (BLOCK, FAMILIES, KERNEL_FAMILIES, S, _bf16_ulp,
                                          _configs, _jax, _kernel_outputs, _np, _torch)

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

PLAN_BLOCKS = (16, 32, 64, 128)


def _layout(fam, per_head, block, seq):
    name, kw = FAMILIES[fam]
    cfg = getattr(tsc, name)(num_heads=2, block=block, different_layout_per_head=per_head, **kw)
    layout = cfg.make_layout(seq)
    layout[:, 1 % layout.shape[1], :] = 0   # an empty query block
    return layout


def _coverage(plan, H):
    """(H, groups, S) counts of how often the plan's items enable each
    (row group, key) pair; a row group is a query block at block <= 64 and
    a 64-row tile at block 128."""
    block, S, tile = plan.block, plan.seq_len, tssa.TILE
    ku, n_tiles, per = min(block, tile), -(-S // tile), max(1, tile // block)
    cover = np.zeros((H, S // ku, S), dtype=np.int64)
    for ht, u0, n_kt, _ in plan.items:
        h, ti = divmod(int(ht), n_tiles)
        for w in plan.units[u0:u0 + n_kt * (tile // ku)]:
            row, bits = int(w) & ((1 << tssa.ROW_BITS) - 1), int(w) >> tssa.ROW_BITS
            for slot in range(per):
                if bits >> slot & 1:
                    cover[h, ti * per + slot, row:row + ku] += 1
    return cover


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
@pytest.mark.parametrize("block", PLAN_BLOCKS)
def test_plan_enables_the_layout_once_per_pair(block, per_head, causal):
    seq, tile = (512 if block < 128 else 1024), tssa.TILE
    gsize = min(block, tile)
    first = np.arange(seq // gsize) * gsize                # each row group's first row
    for fam in FAMILIES:
        try:
            layout = _layout(fam, per_head, block, seq)
        except ValueError:   # the family's validation (JAX's too: test_torch_sparse_attention)
            continue
        H = layout.shape[0]
        want = np.repeat(layout[:, first // block] != 0, block, axis=2)   # (H, groups, S)
        if causal:   # keys wholly past the group's tile are left out
            last = np.minimum(first // tile * tile + tile, seq) - 1
            want &= np.arange(seq)[None, None, :] <= last[None, :, None]
        for cap in (tssa.CAP, 1):
            plan = tssa.build_plan(layout, block, causal, cap=cap)
            cover = _coverage(plan, H)
            assert cover.max() <= 1, f"{fam}: a pair enabled twice"
            assert np.array_equal(cover == 1, want), f"{fam}, cap {cap}"
            n_kt = plan.items[:, 2]
            assert n_kt.max() <= cap and (np.diff(n_kt) <= 0).all(), "cap, widest first"
            assert sorted(set(plan.items[:, 0])) == list(range(H * -(-seq // tile))), \
                "every tile has an item"
            slots = sorted(int(s) for s in plan.items[:, 3] if s >= 0)
            assert slots == list(range(plan.n_slots))
            for ht, slot0, n_p, _ in plan.merges:
                mine = plan.items[plan.items[:, 0] == ht]
                assert n_p > 1 and sorted(mine[:, 3]) == list(range(slot0, slot0 + n_p))
                assert mine[:, 2].max() - mine[:, 2].min() <= 1, "even pieces"


def _stacked_inputs():
    """The inputs of test_torch_sparse_attention's one interpreted call."""
    layout = np.concatenate([_configs(f)[0].make_layout(S) for f in KERNEL_FAMILIES])
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((1, S, layout.shape[0], 32)).astype(np.float32)
            for _ in range(3)]
    return layout, arrs


@pytest.mark.parametrize("cap", [tssa.CAP, 1], ids=["cap8", "cap1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_tiled_plain_matches_interpreted_pallas_and_plain(causal, dtype, cap):
    ref, _ = _kernel_outputs(causal, dtype)
    layout, arrs = _stacked_inputs()
    q, k, v = _torch(arrs, getattr(torch, dtype))
    plan = tssa.build_plan(layout, BLOCK, causal, cap=cap)
    assert (cap == 1) == (len(plan.merges) > 0)
    got = tssa.sparse_attention_tiled_plain(q, k, v, plan, 32 ** -0.5)
    lut, counts = tssa.lut_on(layout, "cpu")
    plain = _np(tssa.sparse_attention_plain(q, k, v, lut, counts, BLOCK, causal, 32 ** -0.5))
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in (ref, plain):
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=_bf16_ulp(np.abs(want).max()))


def test_tiled_plain_merges_a_dominant_late_piece():
    """A BigBird row split into pieces of one key tile, where one row's
    maximum sits in its tile's last piece: each piece's state must be
    rescaled by 2^(m_i - M) before the sum."""
    jcfg, tcfg = _configs("bigbird")
    layout = jcfg.make_layout(S)
    layout[:, 0, :] = 1                       # query block 0 attends everything
    rng = np.random.default_rng(7)
    q, k, v = [rng.standard_normal((2, S, 2, 32)).astype(np.float32) for _ in range(3)]
    k[1, S - 3, 1] = 6 * q[1, 2, 1]          # row 2's dominant key in the last key tile
    plan = tssa.build_plan(layout, BLOCK, False, cap=1)
    assert any(ht == 1 * (S // tssa.TILE) for ht, _, _, _ in plan.merges)   # head 1, tile 0
    want = _np(jssa.sparse_attention(*_jax([q, k, v], jnp.float32), layout, BLOCK,
                                     impl="pallas", interpret=True))
    got = tssa.sparse_attention_tiled_plain(*_torch([q, k, v], torch.float32), plan, 32 ** -0.5)
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)
    assert np.abs(_np(got)[1, 2, 1] - v[1, S - 3, 1]).max() < 1e-3   # the dominant key wins


@contextlib.contextmanager
def _launch_recorder(monkeypatch):
    """Replace both kernels' launches and the CUDA calls; yield the
    launches (kernel name, argument tuple) and the workspaces made."""
    launches, workspaces = [], []
    real_ws = tssa.sparse_workspace

    def ws(*a):
        w = real_ws(*a)
        workspaces.append(None if w is None else tuple(w.shape))
        return w
    for name in ("KERNEL", "KERNEL_FP32"):
        monkeypatch.setattr(getattr(tssa, name), "launch",
                            lambda *a, name=name: launches.append((name, a)))
    monkeypatch.setattr(tssa, "sparse_workspace", ws)
    monkeypatch.setattr(tssa, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    with _NoHostRead():
        yield launches, workspaces


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("fam,block,seq", [("fixed", 16, 256), ("bigbird", 16, 1024),
                                           ("bslongformer", 128, 1024)])
def test_launch_comes_from_the_cached_plan_and_shapes(monkeypatch, fam, block, seq, dtype):
    """The module's CUDA branch: one launch a call of the dtype's kernel,
    its sizes from the plan built once (items, merges, slots: host ints),
    the workspace (B, slots, 64·(D + 2)) fp32 only where a tile is split;
    nothing is read back from the card, so the call can be captured in a
    graph."""
    name, kw = FAMILIES[fam]
    cfg = getattr(tsc, name)(num_heads=2, block=block, **kw)
    attn = SparseSelfAttention(cfg, impl="pallas")
    B, D = 2, 64
    q, k, v = (torch.zeros((B, seq, 2, D), dtype=dtype).as_subclass(_OnCard) for _ in range(3))
    dplan = attn.get_plan(seq, q.device)     # built before: the calls only read it
    plan = dplan.plan
    with _launch_recorder(monkeypatch) as (launches, workspaces):
        for _ in range(3):
            attn(q, k, v)
    assert attn.get_plan(seq, "cpu") is dplan and len(attn._plans) == 1
    if dtype == torch.float32:
        assert [n for n, _ in launches] == ["KERNEL_FP32"] * 3 and workspaces == []
        assert launches[0][1][11] == dplan.lut.shape[2]   # max_nnz
        return
    assert [n for n, _ in launches] == ["KERNEL"] * 3
    args = launches[0][1]
    assert args[5] == len(plan.items) and args[8] == len(plan.merges)
    assert args[10] == plan.n_slots and args[11:16] == (B, seq, 2, D, block)
    if plan.n_slots:
        assert workspaces == [(B, plan.n_slots, tssa.TILE * (D + 2))] * 3 and args[9] is not None
    else:
        assert workspaces == [None] * 3 and args[9] is None
    assert (fam != "fixed") == (plan.n_slots > 0)   # global rows split at S = 1024


def test_kernel_refuses_shapes_and_dtypes_it_lacks(monkeypatch):
    layout = _layout("fixed", False, 16, 256)
    dplan = tssa.plan_on(layout, 16, False, "cpu")
    with _launch_recorder(monkeypatch) as (launches, _):
        for D, dtype, err in ((32, torch.bfloat16, ValueError), (64, torch.float16, TypeError)):
            q = torch.zeros((1, 256, 2, D), dtype=dtype).as_subclass(_OnCard)
            with pytest.raises(err):
                tssa.sparse_attention_kernel(q, q, q, dplan, 0.125)
        q = torch.zeros((1, 512, 2, 64), dtype=torch.bfloat16).as_subclass(_OnCard)
        with pytest.raises(ValueError, match="plan"):
            tssa.sparse_attention_kernel(q, q, q, dplan, 0.125)
        full = np.ones((2, 64, 64))   # 16 key tiles a tile: a plan past the kernel's cap
        wide = tssa.plan_on(full, 16, False, "cpu")._replace(
            plan=tssa.build_plan(full, 16, False, cap=16))
        q = torch.zeros((1, 1024, 2, 64), dtype=torch.bfloat16).as_subclass(_OnCard)
        with pytest.raises(ValueError, match="key tiles"):
            tssa.sparse_attention_kernel(q, q, q, wide, 0.125)
    assert launches == []
