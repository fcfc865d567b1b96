"""The bf16 fused-FFN forward and dx on the tensor cores: their plan
(``mlp_plan``) and the plain model of their order of summation
(``fused_mlp_tiled_plain``, ``fused_mlp_bwd_dx_tiled_plain``), on the CPU.

The plan: row chunks of whole 128-row tiles covering the rows once, the
hidden's bf16 scratch within ``SCRATCH_BYTES``; F segments and splits of F
covering every hidden column once, none empty; at gpt2-125m's FFN the plan
``PERF.md`` states. The route rule (the bf16 forward from ``SM90_MIN_ROWS``
rows and bf16 dx at every row count on the tensor-core entries, fp32
never) is pinned. The tiled plain versions (row
chunks, the hidden cast to x's dtype, the splits' fp32 products summed in
order) against the JAX package's ``_fwd_kernel`` and ``_bwd_dx_kernel`` run
with ``interpret=True``, in fp32 and bf16, with the tolerances of
``test_torch_fused_mlp.py``: fp32 at rtol 1e-5 / atol 1e-6 (the same fp32
products summed in another order), bf16 within one bf16 ulp of each
output's largest magnitude. Then the wrappers' CUDA branch: one counted
launch of the entry the route names, its plan from the shapes alone (no
value read back from the card).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import fused_mlp as jax_fm
from deepspeed_tpu_torch.ops import fused_mlp as fm

from .test_torch_decode_attention import _NoHostRead, _OnCard

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)


def _operands(R, E, F, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, E))
    w1, w2 = 0.02 * rng.standard_normal((E, F)), 0.02 * rng.standard_normal((F, E))
    b1, b2 = 0.1 * rng.standard_normal(F), 0.1 * rng.standard_normal(E)
    dy = 0.1 * rng.standard_normal((R, E))
    return [a.astype(np.float32) for a in (x, w1, b1, w2, b2, dy)]


def _jax(x, w1, b1, w2, b2, dy, jdt, block_rows=32):
    """``(y, dx)`` of the JAX forward and dx kernels in interpret mode, rows
    padded with zeros to whole blocks (as the JAX wrapper pads them)."""
    R = x.shape[0]
    rp = -(-R // block_rows) * block_rows

    def pad(a):
        return np.concatenate([a, np.zeros((rp - R, a.shape[1]), np.float32)])
    res = [jnp.asarray(a, jdt) for a in (pad(x), w1, b1, w2)]
    y, _ = jax_fm._fused_mlp_fwd(*res, jnp.asarray(b2, jnp.float32), block_rows, True)
    dx = jax_fm._fused_mlp_bwd(block_rows, True, res, jnp.asarray(pad(dy), jdt))[0]
    return [np.asarray(o, np.float32)[:R] for o in (y, dx)]


# (R, E, F, chunk_rows, splits): the plan's own, and plans forced to several
# row chunks (a ragged last one) and several splits of F (a short last one)
CASES = [(37, 64, 256, None, None), (300, 128, 512, 128, 3), (130, 64, 160, 128, 2),
         (257, 192, 384, 256, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("R,E,F,chunk,splits", CASES,
                         ids=["own-plan", "chunks-splits", "ragged-F", "E192"])
def test_tiled_plain_matches_jax_kernels(R, E, F, chunk, splits, dtype):
    x, w1, b1, w2, b2, dy = _operands(R, E, F, R + E + F)
    plan = fm.mlp_plan(R, E, F)
    if chunk:
        kb = -(-F // fm.K_BLOCK)
        plan = plan._replace(chunk_rows=chunk, splits=splits, k_blocks=-(-kb // splits))
        assert -(-kb // plan.k_blocks) == splits
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _jax(x, w1, b1, w2, b2, dy, jdt)
    t = [torch.tensor(a, dtype=dtype) for a in (x, w1, b1, w2)]
    got = [fm.fused_mlp_tiled_plain(*t, torch.tensor(b2), plan),
           fm.fused_mlp_bwd_dx_tiled_plain(*t, torch.tensor(dy, dtype=dtype), plan)]
    for name, w, g in zip(("y", "dx"), want, got):
        assert g.dtype == dtype and g.shape == (R, E), name
        g = g.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
            assert np.abs(g - w).max() <= ulp, name


def test_tiled_plain_is_the_plain_version_in_one_piece():
    # one chunk, one split: the plain versions' own sums, bit for bit
    args = [torch.from_numpy(a) for a in _operands(70, 64, 256, 4)]
    x, w1, b1, w2, b2, dy = args
    plan = fm.MlpPlan(70, 1, 1, 4)
    assert torch.equal(fm.fused_mlp_tiled_plain(x, w1, b1, w2, b2, plan),
                       fm.fused_mlp_plain(x, w1, b1, w2, b2))
    assert torch.equal(fm.fused_mlp_bwd_dx_tiled_plain(x, w1, b1, w2, dy, plan),
                       fm.fused_mlp_bwd_dx_plain(x, w1, b1, w2, dy))


@pytest.mark.parametrize("E", [64, 128, 384, 768])
def test_mlp_plan_covers_rows_and_hidden(E):
    for F in (160, 1536, 3072, 8192):
        for R in (1, 8, 127, 128, 1000, 2048, 24576, 60000):
            p = fm.mlp_plan(R, E, F)
            # row chunks: whole 128-row tiles (or all the rows), the scratch
            # within its bound, the chunks covering the rows once
            assert p.chunk_rows == R or p.chunk_rows % fm.TILE_ROWS == 0
            assert p.chunk_rows * F * 2 <= fm.SCRATCH_BYTES
            assert 0 < p.chunk_rows <= R
            assert p.chunk_rows == R or -(-R // p.chunk_rows) * p.chunk_rows >= R
            # F segments of the F-wide kernels: each takes 1..all tiles, none empty
            nt = -(-F // fm.H_TILE)
            segs = -(-nt // p.f_tiles)
            assert 1 <= p.f_tiles <= nt and (segs - 1) * p.f_tiles < nt
            # splits of F in the E-wide products: every k-block once, none empty
            kb = -(-F // fm.K_BLOCK)
            assert p.splits * p.k_blocks >= kb and (p.splits - 1) * p.k_blocks < kb
            assert p.splits <= 65535


def test_mlp_plan_at_the_stated_shapes():
    # gpt2-125m's FFN (PERF.md, row 11): the flagship micro-batch in one
    # chunk, 6 hidden tiles a CTA of h / du (384 CTAs), 192-column tiles of
    # the E-wide products over all of F (768 CTAs); B=2 x 1024 rows: 2
    # hidden tiles a CTA (96 CTAs), 192-column tiles in 2 splits of 24
    # k-blocks (128 CTAs) summed by reduce_kernel
    assert fm.E_TILE == 192
    assert fm.mlp_plan(24576, 768, 3072) == fm.MlpPlan(24576, 6, 1, 48)
    assert fm.mlp_plan(2048, 768, 3072) == fm.MlpPlan(2048, 2, 2, 24)
    # past the scratch's bound: chunks of 43648 rows (341 tiles)
    assert fm.mlp_plan(60000, 768, 3072).chunk_rows == 43648


def test_route_rule_is_pinned():
    # the bf16 forward below 64 rows (the unfused decode ticks' 8, small
    # prefill chunks) keeps the mma.sync kernel; bf16 dx takes the
    # tensor-core entry at every row count; fp32 keeps the mma.sync kernels
    assert fm.SM90_MIN_ROWS == 64
    for R in (1, 8, 63, 64, 1000, 2048, 24576):
        assert fm.sm90_route(R, True) == (R >= 64)
        assert fm.sm90_route(R, False)
        assert not fm.sm90_route(R, True, torch.float32)
        assert not fm.sm90_route(R, False, torch.float32)
    x32, w32 = torch.zeros(64, 64), torch.zeros(64, 256)
    for fwd in (True, False):
        assert fm._sm90_plan(x32, w32, fwd) is None
        assert fm._sm90_plan(x32.bfloat16(), w32.bfloat16(), fwd) == fm.mlp_plan(64, 64, 256)
    assert fm._sm90_plan(x32[:8].bfloat16(), w32.bfloat16(), True) is None
    assert fm._sm90_plan(x32[:8].bfloat16(), w32.bfloat16(), False) == fm.mlp_plan(8, 64, 256)


@contextlib.contextmanager
def _recorder(monkeypatch):
    launches = []
    for k in (fm.FWD, fm.DX, fm.FWD_SM90, fm.DX_SM90):
        monkeypatch.setattr(k, "launch", lambda *a, k=k: launches.append((k.symbol, a)))
    monkeypatch.setattr(fm, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    with _NoHostRead():
        yield launches


@pytest.mark.parametrize("dtype,R", [(torch.bfloat16, 2048), (torch.bfloat16, 300),
                                     (torch.bfloat16, 8), (torch.float32, 300)],
                         ids=["bf16", "bf16-ragged", "bf16-decode-rows", "fp32"])
def test_launch_plan_from_shapes(monkeypatch, dtype, R):
    E, F = (768, 3072) if dtype == torch.bfloat16 else (384, 1536)

    def card(*shape):
        return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)
    x, w1, b1, w2, dy = card(R, E), card(E, F), card(F), card(F, E), card(R, E)
    b2 = torch.zeros(E).as_subclass(_OnCard)
    with _recorder(monkeypatch) as launches:
        y = fm.fused_mlp_fwd_op(x, w1, b1, w2, b2)
        dx = fm.fused_mlp_bwd_dx(x, w1, b1, w2, dy)
    assert y.shape == dx.shape == (R, E) and y.dtype == dx.dtype == dtype
    bf16 = dtype == torch.bfloat16
    fwd_sm90 = bf16 and R >= fm.SM90_MIN_ROWS
    assert [s for s, _ in launches] == [
        "fused_mlp_fwd_sm90" if fwd_sm90 else "fused_mlp_fwd",
        "fused_mlp_bwd_dx_sm90" if bf16 else "fused_mlp_bwd_dx"]
    p = fm.mlp_plan(R, E, F)
    for s, a in launches:
        if s.endswith("_sm90"):
            # ..., R, E, F, chunk_rows, f_tiles, splits, k_blocks, stream
            assert a[-8:] == (R, E, F, p.chunk_rows, p.f_tiles, p.splits, p.k_blocks, 7)
