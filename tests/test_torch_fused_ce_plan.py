"""The fused CE head's tensor-core route, on the CPU: its plans and the plain
model of its backward's order (``ops/fused_ce.py``).

- ``chunk_plan``: the backward's vocab chunks cover the padded vocab once,
  in multiples of the 256-column tile, with a ragged last chunk, and their
  bf16 dlog scratch stays under ``SCRATCH_BYTES``; ``segment_plan``: no
  segment is empty.
- ``fused_ce_bwd_chunked_plain`` (dlog per chunk cast to the inputs' dtype,
  dh summed over the chunks in fp32, both gradients scaled by g) against
  the JAX package's ``_dh_kernel`` / ``_dw_kernel`` in interpret mode
  through ``fused_ce_sum``'s VJP, with several chunks forced by a smaller
  scratch cap: fp32, atol 1e-5 as ``tests/test_torch_fused_ce.py``; and
  against ``fused_ce_bwd_plain`` scaled by g: fp32 rtol 1e-5 / atol 1e-6
  (the same products summed in another order: chunk by chunk), bf16 within
  one bf16 ulp (each side rounds once).
- The wrappers' CUDA branch, on CPU tensors that say they lie on the card:
  the route (tensor-core for bf16 with E % 8 == 0, else the CUDA-core
  kernels) and the plan come from the shapes alone, and nothing is read
  back from the card.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import fused_ce as jax_ce
from deepspeed_tpu_torch.ops import fused_ce as ce

from .test_torch_decode_attention import _NoHostRead, _OnCard

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

IGNORE = -100


@pytest.mark.parametrize("N,Vp", [(2048, 50304), (24576, 50304), (300, 1000), (1, 256),
                                  (100000, 50304), (600000, 50304), (24576, 128),
                                  (4096, 32000)])
def test_chunk_plan_covers_the_vocab_once(N, Vp):
    chunk, chunks = ce.chunk_plan(N, Vp)
    assert chunk % ce.TILE_N == 0 and chunk > 0
    starts = list(range(0, Vp, chunk))
    assert len(starts) == chunks
    widths = [min(chunk, Vp - c0) for c0 in starts]
    assert sum(widths) == Vp and all(w > 0 for w in widths)
    if chunk > ce.TILE_N:          # the floor of one tile binds past 2^19 tokens only
        assert 2 * N * chunk <= ce.SCRATCH_BYTES
    # the fewest chunks the cap allows, balanced: no chunk a tile narrower
    # than it needs to be
    widest = max(ce.TILE_N, ce.SCRATCH_BYTES // (2 * N) // ce.TILE_N * ce.TILE_N)
    assert chunks == -(-Vp // widest)
    assert chunk - ce.TILE_N < -(-Vp // chunks)


def test_chunk_plan_at_the_smoke_shapes():
    assert ce.chunk_plan(2048, 50304) == (50432, 1)      # the 1.5B head: one chunk
    assert ce.chunk_plan(24576, 50304) == (5120, 10)     # gpt2-125m's micro-batch: ten
    assert 24576 * 5120 * 2 <= ce.SCRATCH_BYTES < 24576 * 50304 * 2


@pytest.mark.parametrize("rows,cols", [(16, 197), (192, 197), (192, 20), (3, 4), (1, 1),
                                       (500, 3), (2, 1000)])
def test_segment_plan_has_no_empty_segment(rows, cols):
    nseg, per = ce.segment_plan(rows, cols)
    assert 1 <= nseg <= cols and per >= 1
    assert nseg * per >= cols and (nseg - 1) * per < cols


def _head(N, E, Vp, V, dtype, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, E)).astype(np.float32)
    wteT = (0.2 * rng.standard_normal((E, Vp))).astype(np.float32)
    labels = rng.integers(0, V, size=N).astype(np.int32)
    labels[::7] = IGNORE
    t = torch.from_numpy
    return t(h).to(dtype), t(wteT).to(dtype), t(labels)


def _small_scratch(monkeypatch, N, cols):
    """A scratch cap that makes chunks of ``cols`` columns at N tokens."""
    monkeypatch.setattr(ce, "SCRATCH_BYTES", 2 * N * cols)


@pytest.mark.parametrize("N", [74, 128])
def test_chunked_plain_matches_pallas_interpret(monkeypatch, N):
    E, Vp, V, g = 64, 896, 850, 0.7
    _small_scratch(monkeypatch, N, 512)
    assert ce.chunk_plan(N, Vp) == (512, 2)              # a whole chunk and a ragged one
    h, wteT, labels = _head(N, E, Vp, V, torch.float32, seed=N)
    pad = (-N) % 128                                     # the JAX wrapper's token tile
    hp = jnp.asarray(np.concatenate([h.numpy(), np.zeros((pad, E), np.float32)]))
    lp = jnp.asarray(np.concatenate([labels.numpy(), np.full(pad, IGNORE, np.int32)]))
    _, vjp = jax.vjp(lambda a, b: jax_ce.fused_ce_sum(a, b, lp, V, IGNORE, 128, 128, True),
                     hp, jnp.asarray(wteT.numpy()))
    dh_j, dw_j = (np.asarray(x) for x in vjp(jnp.float32(g)))

    _, lse = ce.fused_ce_plain(h, wteT, labels, V, IGNORE)
    gt = torch.tensor(g)
    dh, dw = ce.fused_ce_bwd_chunked_plain(h, wteT, labels, lse, V, IGNORE, gt)
    assert dh.shape == (N, E) and dw.shape == (E, Vp) and dh.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dh.numpy(), dh_j[:N], rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), dw_j, rtol=0, atol=1e-5)
    assert float(dw[:, V:].abs().max()) == 0.0           # padded vocab columns
    assert float(dh[::7].abs().max()) == 0.0             # ignored rows

    dh_p, dw_p = ce.fused_ce_bwd_plain(h, wteT, labels, lse, V, IGNORE)
    torch.testing.assert_close(dh, dh_p * g, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, dw_p * g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk_cols", [256, 512, 1024])
def test_chunked_plain_bf16_rounds_once(monkeypatch, chunk_cols):
    """In bf16 dlog is cast per chunk exactly as over the whole vocab (the
    cast is elementwise), and each output is rounded once: the chunked order
    lies within one bf16 ulp of the one-product order, element by element,
    plus 1e-6 of the sum of its addends' magnitudes (fp32 sums in another
    order, which near a cancelling sum exceed an ulp of the result)."""
    N, E, Vp, V, g = 300, 64, 1000, 990, 1.0 / 257
    _small_scratch(monkeypatch, N, chunk_cols)
    h, wteT, labels = _head(N, E, Vp, V, torch.bfloat16, seed=chunk_cols)
    _, lse = ce.fused_ce_plain(h, wteT, labels, V, IGNORE)
    dh, dw = ce.fused_ce_bwd_chunked_plain(h, wteT, labels, lse, V, IGNORE, torch.tensor(g))
    dh_p, dw_p = ce.fused_ce_bwd_plain(h, wteT, labels, lse, V, IGNORE)
    assert dh.dtype == dw.dtype == torch.bfloat16
    dlog = ce._dlog_plain(h, wteT, labels, lse, V, IGNORE).to(torch.bfloat16).float().abs()
    mags = (g * dlog @ wteT.float().abs().T, g * h.float().abs().T @ dlog)
    for got, want, mag in ((dh, dh_p * g, mags[0]), (dw, dw_p * g, mags[1])):
        got = got.float()
        big = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        assert bool(((got - want).abs() <= ulp + 1e-6 * mag).all())


# ----------------------------------------------------------------------
# the CUDA branch: route and plan from the shapes alone
# ----------------------------------------------------------------------
@contextlib.contextmanager
def _recorder(monkeypatch):
    launches = []
    for name in ("FWD_SM90", "BWD_SM90", "FWD", "DH", "DW"):
        monkeypatch.setattr(getattr(ce, name), "launch",
                            lambda *a, _n=name: launches.append((_n, a)))
    monkeypatch.setattr(ce, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    with _NoHostRead():
        yield launches


def _on_card(N, E, Vp, dtype):
    h = torch.zeros(N, E, dtype=dtype).as_subclass(_OnCard)
    w = torch.zeros(Vp, E, dtype=dtype).as_subclass(_OnCard)
    labels = torch.zeros(N, dtype=torch.int64).as_subclass(_OnCard)
    return h, w, labels


@pytest.mark.parametrize("N,E,Vp,V", [(2048, 1600, 50304, 50257), (24576, 768, 50304, 50257),
                                      (300, 200, 1000, 990), (300, 4096, 1000, 990)])
def test_sm90_launch_plan_from_shapes(monkeypatch, N, E, Vp, V):
    h, w, labels = _on_card(N, E, Vp, torch.bfloat16)
    lse = torch.zeros(N).as_subclass(_OnCard)
    g = torch.ones(()).as_subclass(_OnCard)
    with _recorder(monkeypatch) as launches:
        ce.fused_ce_fwd(h, w.T, labels, V, IGNORE)
        dh, dw = ce.fused_ce_bwd(h, w.T, labels, lse, V, IGNORE, g)
    assert [n for n, _ in launches] == ["FWD_SM90", "BWD_SM90"]
    fwd, bwd = launches[0][1], launches[1][1]
    nseg, tps = ce.segment_plan(-(-N // ce.TILE_M), -(-Vp // ce.TILE_N))
    assert fwd[6:13] == (nseg, tps, N, E, Vp, V, IGNORE) and fwd[13] == 7
    chunk, chunks = ce.chunk_plan(N, Vp)
    _, dlog_tps = ce.segment_plan(-(-N // ce.TILE_M), chunk // ce.TILE_N)
    assert bwd[9:16] == (chunk, dlog_tps, N, E, Vp, V, IGNORE)
    assert bwd[4] == g.data_ptr()                        # g read on the card, not here
    assert (bwd[7] is None) == (chunks == 1)             # fp32 dh between chunks only
    assert dh.shape == (N, E) and dw.shape == (E, Vp)
    assert dh.dtype == dw.dtype == torch.bfloat16        # scaled and cast in the epilogues


@pytest.mark.parametrize("dtype,E", [(torch.float32, 200), (torch.float32, 768),
                                     (torch.bfloat16, 100), (torch.bfloat16, 2556)])
def test_cuda_core_route_for_other_operands(monkeypatch, dtype, E):
    N, Vp, V = 300, 1000, 990
    h, w, labels = _on_card(N, E, Vp, dtype)
    lse = torch.zeros(N).as_subclass(_OnCard)
    with _recorder(monkeypatch) as launches:
        ce.fused_ce_fwd(h, w.T, labels, V, IGNORE)
        ce.fused_ce_bwd(h, w.T, labels, lse, V, IGNORE)
    assert [n for n, _ in launches] == ["FWD", "DH", "DW"]


def test_cuda_core_route_refuses_wide_rows(monkeypatch):
    h, w, labels = _on_card(8, 2564, 256, torch.bfloat16)     # E % 8 == 4, E > MAX_E
    with _recorder(monkeypatch), pytest.raises(ValueError, match="shared-memory"):
        ce.fused_ce_fwd(h, w.T, labels, 250, IGNORE)
