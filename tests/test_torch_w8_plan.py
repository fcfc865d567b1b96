"""The W8A16 matmul on the tensor-core decode GEMV, on the CPU: its plain
model of the kernel's order of summation and the plan the wrapper hands it.

``gemv_tiled_plain(x, (codes, scale))`` (per K-slice, warp phases,
accumulator banks, a fresh partial per scale group folded times the scale
at the group's end) against the JAX package's ``w8a16_matmul_pallas`` in
interpret mode (its module's ``INTERPRET`` flipped, as its own tests do),
at rows that take two accumulator banks (M = 1, 13) and one (M = 64), with
128-row groups and one whole-K group, on two small panels: each element
within 1e-5 of its addends' magnitudes (two fp32 orders of one sum; x is
bf16 on both sides). Then ``gemv_plan`` and ``gemv_partials`` at every W8
matmul panel of the smoke's int8 serving paths (gpt2-760m, llama-1b,
pythia-1b) and M = 1, 8, 64: slices whole multiples of the 128-row stage
and of the group, covering K once; 32-byte tile rows; partials for every
split launch. Then the wrapper's CUDA branch: one counted launch whose plan,
workspace and tickets come from the shapes alone (no value read back from
the card).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import w8 as jw8
from deepspeed_tpu.ops.pallas import w8_matmul as jwm
from deepspeed_tpu_torch.ops import decode_layer as dl
from deepspeed_tpu_torch.ops import w8 as tw8
from deepspeed_tpu_torch.ops import w8_matmul as twm

from .test_torch_decode_attention import _NoHostRead, _OnCard

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

# (K, N) of every W8 matmul panel the smoke's int8 serving paths run
PANELS = {
    "gpt2-760m": ((1536, 4608), (1536, 1536), (1536, 6144), (6144, 1536)),
    "llama-1b": ((2048, 2048), (2048, 256), (2048, 8192), (8192, 2048)),
    "pythia-1b": ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)),
}


def _case(M, K, N, group, seed):
    rng = np.random.default_rng(seed)
    w = (0.02 * rng.standard_normal((K, N))).astype(np.float32)
    codes, scale = jw8.quantize_weight(jnp.asarray(w), group)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, codes, scale


@pytest.mark.parametrize("K,N", [(384, 256), (1024, 384)], ids=["384x256", "1024x384"])
@pytest.mark.parametrize("group", [128, "K"], ids=["g128", "one_group"])
@pytest.mark.parametrize("M", [1, 13, 64])
def test_tiled_plain_matches_pallas(monkeypatch, M, group, K, N):
    monkeypatch.setattr(jwm, "INTERPRET", True)
    g = K if group == "K" else group
    x, jc, js = _case(M, K, N, g, M * K + N)
    want = np.asarray(jwm.w8a16_matmul_pallas(jnp.asarray(x, jnp.bfloat16), jc, js))
    codes, scale = torch.tensor(np.asarray(jc)), torch.tensor(np.asarray(js))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = dl.gemv_tiled_plain(xb, (codes, scale))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    mag = (xb.float().abs() @ tw8.dequantize_weight(codes, scale).abs()).numpy()
    assert (np.abs(got.numpy() - want) <= 1e-5 * mag).all()
    # the kernel's plain version, one pass in group order, within the same limit
    plain = twm.w8a16_matmul_plain(xb, codes, scale).numpy()
    assert (np.abs(got.numpy() - plain) <= 1e-5 * mag).all()


def _plan_cases():
    return [pytest.param(K, N, id=f"{model}-{K}x{N}") for model, panels in PANELS.items()
            for K, N in panels]


@pytest.mark.parametrize("group", [128, "K"], ids=["g128", "one_group"])
@pytest.mark.parametrize("K,N", _plan_cases())
def test_plan_and_partials_at_the_smoke_panels(K, N, group):
    g = K if group == "K" else group
    nt, ks = dl.gemv_plan(K, N, 1, g)
    assert N % nt == 0 and nt >= 32 and nt <= dl.MAX_BLOCK_COLS     # whole 32-byte code rows
    assert ks % dl.STAGE_ROWS == 0 and K % ks == 0 and (g >= K or ks % g == 0)
    splits = K // ks
    assert (N // nt) * splits >= dl.MIN_BLOCKS or N == 256    # llama's k/v: as K allows
    for M in (1, 8, 64):
        parts = dl.gemv_partials(M, K, N, (nt, ks))
        assert parts == (0 if splits == 1 else splits * M * N)


@contextlib.contextmanager
def _recorder(monkeypatch):
    launches = []
    monkeypatch.setattr(twm.KERNEL, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(twm, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(dl, "_TICKETS", {})
    with _NoHostRead():
        yield launches


@pytest.mark.parametrize("M,K,N,G", [(8, 1536, 4608, 12), (64, 6144, 1536, 48),
                                     (13, 2048, 256, 1)], ids=["760m-qkv", "760m-down", "kv-one"])
def test_w8_launch_plan_from_shapes(monkeypatch, M, K, N, G):
    x = torch.zeros(M, K, dtype=torch.bfloat16).as_subclass(_OnCard)
    codes = torch.zeros(K, N, dtype=torch.int8).as_subclass(_OnCard)
    scale = torch.ones(G, N).as_subclass(_OnCard)
    before = twm.KERNEL.launches
    with _recorder(monkeypatch) as launches:
        out = twm.w8a16_matmul_kernel(x, codes, scale)
    assert out.shape == (M, N) and out.dtype == torch.float32 and len(launches) == 1
    assert twm.KERNEL.launches == before   # the recorder replaced the counted launch
    args = launches[0]
    # x, codes, scale, group, out, workspace, tickets, M, K, N, n_tile, k_slice, stream
    nt, ks = dl.gemv_plan(K, N, 1, K // G)
    assert args[3] == K // G and args[7:] == (M, K, N, nt, ks, 7)
    assert all(isinstance(p, int) and p for p in args[5:7]) and args[5] != args[6]
    assert dl._TICKETS and all(t.numel() >= N // nt for t in dl._TICKETS.values())
