"""The bf16 fused-FFN dw kernel's plan (``dw_plan``) and its plain model of
the kernel's order of summation (``fused_mlp_bwd_dw_tiled_plain``), on the
CPU.

The tiled plain model (64-row tiles in row segments, the cluster's E-chunk
partials of u and dh summed in rank order, du and h as bf16 hi + lo pairs in
the products) against the JAX package's ``_bwd_dw_kernel`` run with
``interpret=True`` (through the JAX backward, rows padded with zeros as the
JAX wrapper pads them: zero rows of x and dy add nothing to dw1, db1, dw2 or
db2), in fp32 and bf16, with the tolerances of ``test_torch_fused_mlp.py``:
fp32 at rtol 1e-5 / atol 1e-6 (the same fp32 products summed in another
order), bf16 within one bf16 ulp of each output's largest magnitude. Then
against the one-pass plain version in fp32 at shapes that split the rows
into several segments and E into several chunks, each element within 1e-5
of its addends' magnitudes; the hi + lo pair against fp32 and a once-rounded
bf16 control, which must miss. The plan at E = 64 ... 768: a cluster of at
most 8 CTAs covering E with the least padding, segments covering the rows
once, no segment empty, at the count that takes the fewest tile-times. Then
the wrapper's CUDA branch: one counted launch whose plan comes from the
shapes alone (no value read back from the card).
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
    b1 = 0.1 * rng.standard_normal(F)
    dy = 0.1 * rng.standard_normal((R, E))
    return [a.astype(np.float32) for a in (x, w1, b1, w2, dy)]


def _jax_dw(x, w1, b1, w2, dy, jdt, block_rows=32):
    """``(dw1, db1, dw2, db2)`` of the JAX backward's ``_bwd_dw_kernel`` in
    interpret mode, rows padded with zeros to whole blocks."""
    R = x.shape[0]
    rp = -(-R // block_rows) * block_rows

    def pad(a):
        return np.concatenate([a, np.zeros((rp - R, a.shape[1]), np.float32)])
    res = [jnp.asarray(a, jdt) for a in (pad(x), w1, b1, w2)]
    out = jax_fm._fused_mlp_bwd(block_rows, True, res, jnp.asarray(pad(dy), jdt))
    return [np.asarray(o, np.float32) for o in out[1:]]


NAMES = ("dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("F", [128, 256])
@pytest.mark.parametrize("E", [64, 192])
@pytest.mark.parametrize("R", [37, 130])
def test_tiled_plain_matches_jax_dw_kernel(R, E, F, dtype):
    x, w1, b1, w2, dy = _operands(R, E, F, R + E + F)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _jax_dw(x, w1, b1, w2, dy, jdt)
    got = fm.fused_mlp_bwd_dw_tiled_plain(*(torch.tensor(a, dtype=dtype)
                                            for a in (x, w1, b1, w2, dy)))
    assert [g.dtype for g in got] == [dtype, dtype, dtype, torch.float32]
    for name, w, g in zip(NAMES, want, got):
        g = g.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
            assert np.abs(g - w).max() <= ulp, name


@pytest.mark.parametrize("R,E,F", [(300, 768, 128), (1000, 384, 96), (130, 320, 64)],
                         ids=["E768-cluster4", "E384-segments", "E320-cluster5"])
def test_tiled_sum_matches_one_pass_fp32(R, E, F):
    # several E-chunks (the cluster's partials) and, where the rows allow,
    # several row segments: two fp32 orders of the same sums
    chunk, n, nseg, _ = fm.dw_plan(R, E, F)
    assert n > 1
    args = [torch.from_numpy(a) for a in _operands(R, E, F, 3)]
    x, w1, b1, w2, dy = args
    got = fm.fused_mlp_bwd_dw_tiled_plain(*args)
    ref = fm.fused_mlp_bwd_dw_plain(*args)
    u = x @ w1 + b1
    u_mag = x.abs() @ w1.abs() + b1.abs()
    du_mag = (dy.abs() @ w2.abs().T) * (fm.gelu_tanh_grad(u).abs() + u_mag)
    h_mag = fm.gelu_tanh(u).abs() + fm.gelu_tanh_grad(u).abs() * u_mag
    mags = (x.abs().T @ du_mag, du_mag.sum(0), h_mag.T @ dy.abs(), dy.abs().sum(0))
    for name, g, r, m in zip(NAMES, got, ref, mags):
        assert ((g - r).abs() <= 1e-5 * m).all(), name


def test_hi_lo_keeps_du_and_h_to_fp32_grade():
    # bf16 inputs: du and h enter the products as hi + lo; the pair's sum is
    # within 2^-16 of the fp32 value where one bf16 rounding is not
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32))
    hi, lo = fm._hi_lo(v)
    assert ((hi + lo - v).abs() <= 2.0 ** -16 * v.abs()).all()
    assert ((hi - v).abs() > 2.0 ** -16 * v.abs()).float().mean() > 0.5


@pytest.mark.parametrize("E", list(range(64, 769, 64)))
def test_dw_plan_covers_e_and_rows(E):
    F = 3072
    for R in (1, 8, 37, 1000, 2048, 24576):
        chunk, n, nseg, per = fm.dw_plan(R, E, F)
        assert chunk in fm.DW_CHUNKS and 1 <= n <= fm.DW_MAX_CLUSTER
        # the cluster covers E, the last chunk short by less than a chunk,
        # its shared memory fits, and no chunk that fits pads less
        assert (n - 1) * chunk < E <= n * chunk
        assert fm.dw_smem(chunk, n) <= fm.DW_MAX_SMEM
        pads = [-(-E // c) * c - E for c in fm.DW_CHUNKS if -(-E // c) <= fm.DW_MAX_CLUSTER
                and fm.dw_smem(c, -(-E // c)) <= fm.DW_MAX_SMEM]
        assert n * chunk - E == min(pads)
        # segments of whole 64-row tiles cover the rows once, none empty
        tiles = -(-R // fm.DW_TILE_ROWS)
        assert nseg * per >= tiles and (nseg - 1) * per < tiles
        # no other count of segments takes fewer tile-times (waves of the
        # clusters the card holds, times a segment's tiles, plus the
        # segments' partials)
        resident, clusters = 132 // n, F // fm.DW_HIDDEN

        def cost(s, p):
            return -(-clusters * s // resident) * p + fm.DW_SEGMENT_COST * s
        assert all(cost(nseg, per) <= cost(-(-tiles // p), p) for p in range(1, tiles + 1))


def test_dw_plan_at_the_training_shape():
    # gpt2-125m's FFN at the flagship micro-batch: 192-column chunks in
    # clusters of 4; with the 30 clusters an H100 holds at once, five row
    # segments of 77 tiles (ten waves of 77 tiles, against 768 tile-times in
    # one segment); with one cluster an SM's worth (33), two of 192
    assert fm.dw_plan(24576, 768, 3072, 30) == (192, 4, 5, 77)
    assert fm.dw_plan(24576, 768, 3072) == (192, 4, 2, 192)
    assert fm.dw_plan(8, 768, 3072, 30) == (192, 4, 1, 1)


@contextlib.contextmanager
def _recorder(monkeypatch):
    launches = []
    monkeypatch.setattr(fm.DW, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(fm, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    with _NoHostRead():
        yield launches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_dw_launch_plan_from_shapes(monkeypatch, dtype):
    R, E, F = 1000, 768 if dtype == torch.bfloat16 else 384, 3072
    x, dy = (torch.zeros(R, E, dtype=dtype).as_subclass(_OnCard) for _ in range(2))
    w1, w2 = torch.zeros(E, F, dtype=dtype).as_subclass(_OnCard), \
        torch.zeros(F, E, dtype=dtype).as_subclass(_OnCard)
    b1 = torch.zeros(F, dtype=dtype).as_subclass(_OnCard)
    monkeypatch.setattr(fm, "dw_resident", lambda device, E: 30)
    with _recorder(monkeypatch) as launches:
        dw1, db1, dw2, db2 = fm.fused_mlp_bwd_dw(x, w1, b1, w2, dy)
    assert len(launches) == 1
    args = launches[0]
    # ..., R, E, F, segments, tiles per segment, chunk, dtype, stream
    if dtype == torch.bfloat16:
        chunk, _, nseg, per = fm.dw_plan(R, E, F, 30)
    else:
        chunk, (nseg, per) = 0, fm._splits(F // fm.DW_COLS, -(-R // fm.DW_ROWS), 8)
    assert args[-8:] == (R, E, F, nseg, per, chunk, 1 if dtype == torch.bfloat16 else 0, 7)
    assert dw1.shape == (E, F) and dw2.shape == (F, E) and db1.shape == (F,)
    assert db2.shape == (E,) and db2.dtype == torch.float32
