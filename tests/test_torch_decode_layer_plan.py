"""The bf16 decode-layer GEMV's split plan (``gemv_plan``) and its plain
model of the kernel's order of summation (``gemv_tiled_plain``), on the CPU.

The plan, at every projection of the serving models (gpt2-125m, gpt2-760m,
llama-1b, pythia-1b; bf16 weights, W8A16 with 128-row groups and with one
group; SwiGLU's gate and up panels as one pair) and at odd shapes: at least
two blocks an SM (264) wherever the slices and tiles allow as many, else the
most there can be; K-slices whole multiples of the 128-row stage and of the
scale group, covering K exactly once; column tiles whole 32-byte sectors,
at most 64 columns a block.

The tiled plain model (per K-slice, warp phases, accumulator banks and W8
folds summed in the kernel's order) against the JAX package's Pallas kernels
in interpret mode, every branch (LayerNorm or RMSNorm; GELU tanh or exact,
sequential or parallel residual; SwiGLU; bf16 weights and W8A16, 128-row
groups and one group), at rows that take two accumulator banks (M = 3) and
one (M = 20): fp32 within 1e-5 of the output's scale (fp32 sums in other
orders), bf16 within one bf16 ulp at the output's scale on at most 2% of
the elements (the kernels' cast points, where two summation orders may tip
a rounding). And against the one-pass plain version in fp32 at shapes that
split K into several slices, each element within 1e-5 of its addends'
magnitudes (two fp32 orders of one sum). Then the
wrappers' CUDA branch: the plans and scratch it hands the C entry come
from the shapes alone (no value read back from the card), one counted
launch a call.
"""
import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import w8 as jw8
from deepspeed_tpu.ops.pallas import decode_layer as jdl
from deepspeed_tpu_torch.ops import decode_layer as dl

from .test_torch_decode_attention import _NoHostRead, _OnCard

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

# (K, N) of every projection of the serving models
PANELS = {
    "gpt2-125m": ((768, 2304), (768, 768), (768, 3072), (3072, 768)),
    "gpt2-760m": ((1536, 4608), (1536, 1536), (1536, 6144), (6144, 1536)),
    "llama-1b": ((2048, 2048), (2048, 256), (2048, 8192), (8192, 2048)),
    "pythia-1b": ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)),
}
ODD = ((256, 384), (384, 128), (1280, 256), (4096, 11008), (128, 128), (640, 1024))
KINDS = (("bf16", 2, None), ("w8_g128", 1, 128), ("w8_one_group", 1, "K"))


def _plan_cases():
    cases = []
    for model, panels in PANELS.items():
        for K, N in panels:
            cases.append(pytest.param(K, N, False, id=f"{model}-{K}x{N}"))
        cases.append(pytest.param(2048 if model.startswith(("llama", "pythia")) else
                                  panels[2][0], panels[2][1], True, id=f"{model}-pair"))
    cases += [pytest.param(K, N, False, id=f"odd-{K}x{N}") for K, N in ODD]
    return cases


def _plans(K, N, wb, group, pair):
    """Every plan the kernel takes at this panel, as gemv_plan enumerates."""
    step = 128 if group is None or group >= K else math.lcm(128, group)
    tiles = [nt for nt in dl.N_TILES
             if nt * (2 if pair else 1) <= dl.MAX_BLOCK_COLS and nt * wb >= 32 and N % nt == 0]
    return [(nt, ks) for nt in tiles for ks in range(step, K + 1, step) if K % ks == 0]


@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("K,N,pair", _plan_cases())
def test_plan_fills_the_card_and_covers_k_once(K, N, pair, kind):
    _, wb, group = kind
    group = K if group == "K" else group
    nt, ks = dl.gemv_plan(K, N, wb, group, pair)
    # tiles: whole 32-byte sectors of each panel's row, at most 64 columns a block
    assert N % nt == 0 and nt * wb >= 32 and nt * (2 if pair else 1) <= 64
    # slices: multiples of the stage and of the group, covering K exactly once
    assert ks % dl.STAGE_ROWS == 0 and K % ks == 0
    if group is not None and group < K:
        assert ks % group == 0
    cover = np.zeros(K, dtype=np.int64)
    for s in range(K // ks):
        cover[s * ks:(s + 1) * ks] += 1
    assert (cover == 1).all()
    # two blocks an SM wherever a plan has as many, else the most a plan has
    blocks = (N // nt) * (K // ks)
    most = max((N // t) * (K // s) for t, s in _plans(K, N, wb, group, pair))
    assert blocks >= min(dl.MIN_BLOCKS, most)
    assert most < dl.MIN_BLOCKS or blocks >= dl.MIN_BLOCKS


def test_plan_blocks_at_the_serving_shapes():
    # every M=8 launch of the smoke's serving paths reaches two blocks an SM,
    # but for the 256-column k/v projections (16 and 8 column tiles by 16
    # slices of 128 rows: as many as K allows)
    short = []
    for model, panels in PANELS.items():
        for K, N in panels:
            for _, wb, group in KINDS:
                nt, ks = dl.gemv_plan(K, N, wb, K if group == "K" else group)
                if (N // nt) * (K // ks) < dl.MIN_BLOCKS:
                    short.append((model, K, N, wb))
    assert sorted(set(short)) == sorted({("llama-1b", 2048, 256, 2), ("llama-1b", 2048, 256, 1),
                                         ("gpt2-125m", 768, 768, 1)})


# ---------------------------------------------------------------------------
# The tiled plain model against the Pallas kernels
# ---------------------------------------------------------------------------

E, F, N = 256, 1024, 384


def _arrays(M, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, std=0.02: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    return dict(x=f(M, E, std=1.0), y=f(M, E, std=1.0), ns=(1 + f(E, std=0.1)), nb=f(E, std=0.1),
                w=f(E, N), b=f(N), wo=f(E, E), bo=f(E), w1=f(E, F), b1=f(F), wu=f(E, F),
                w2=f(F, E), b2=f(E))


PANEL_KEYS = ("w", "wo", "w1", "wu", "w2")


def _inputs(M, dtype, weights, seed):
    """JAX and torch operands: activations in ``dtype``, norm parameters in
    fp32, weights in ``dtype`` or as W8A16 pairs (the JAX quantizer's codes)."""
    a = _arrays(M, seed)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    j = {k: jnp.asarray(v, jnp.float32 if k in ("ns", "nb") else jd) for k, v in a.items()}
    t = {k: torch.from_numpy(v).to(torch.float32 if k in ("ns", "nb") else td)
         for k, v in a.items()}
    if weights != "dense":
        for k in PANEL_KEYS:
            group = 128 if weights == "w8_g128" else a[k].shape[0]
            codes, scale = jw8.quantize_weight(jnp.asarray(a[k]), group)
            j[k] = (codes, scale)
            t[k] = (torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scale)))
    return j, t


# (name, norm_proj or post_attn, flags)
BRANCHES = (
    ("norm_proj_ln", "norm_proj", {}),
    ("norm_proj_rms", "norm_proj", dict(rms=True)),
    ("post_attn_tanh", "post_attn", {}),
    ("post_attn_erf_par", "post_attn", dict(exact_gelu=True, parallel_residual=True)),
    ("post_attn_erf_seq", "post_attn", dict(exact_gelu=True)),
    ("post_attn_swiglu", "post_attn", dict(swiglu=True, rms=True)),
    ("post_attn_swiglu_par", "post_attn", dict(swiglu=True, parallel_residual=True)),
)


def _run(kind, kw, j, t):
    """(JAX kernel in interpret mode, the tiled plain model), fp32 numpy."""
    rms = kw.get("rms", False)
    if kind == "norm_proj":
        want = jdl.fused_norm_proj(j["x"], j["ns"], None if rms else j["nb"], j["w"], j["b"],
                                   rms=rms, interpret=True)
        got = dl.norm_proj_tiled_plain(t["x"], t["ns"], t["nb"], t["w"], t["b"].to(t["x"].dtype),
                                       1e-5, rms)
    else:
        swiglu = kw.get("swiglu", False)
        jm = (j["w1"], j["wu"], j["w2"]) if swiglu else (j["w1"], j["b1"], j["w2"], j["b2"])
        tm = (t["w1"], t["wu"], t["w2"]) if swiglu else (t["w1"], t["b1"], t["w2"], t["b2"])
        want = jdl.fused_post_attn(j["y"], j["x"], j["wo"], j["bo"], j["ns"],
                                   None if rms else j["nb"], jm, interpret=True, **kw)
        got = dl.post_attn_tiled_plain(t["y"], t["x"], t["wo"], t["bo"], t["ns"],
                                       torch.zeros_like(t["ns"]) if rms else t["nb"], tm, 1e-5,
                                       swiglu, rms, kw.get("exact_gelu", False) and not swiglu,
                                       kw.get("parallel_residual", False))
    return np.asarray(jnp.asarray(want, jnp.float32)), got.float().numpy()


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("M", [3, 20], ids=["M3_two_banks", "M20_one_bank"])
@pytest.mark.parametrize("weights,dtype", [("dense", "float32"), ("dense", "bfloat16"),
                                           ("w8_g128", "bfloat16"), ("w8_one_group", "bfloat16")])
@pytest.mark.parametrize("name,kind,kw", BRANCHES, ids=[b[0] for b in BRANCHES])
def test_tiled_plain_matches_pallas(name, kind, kw, weights, dtype, M):
    want, got = _run(kind, kw, *_inputs(M, dtype, weights, seed=len(name) + M))
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5 * max(1.0, np.abs(want).max())
    else:
        assert diff.max() <= _bf16_ulp(np.abs(want).max()) and (diff > 0).mean() <= 0.02


@pytest.mark.parametrize("weights", ["dense", "w8_g128", "w8_one_group"])
@pytest.mark.parametrize("M", [1, 8, 13, 64])
@pytest.mark.parametrize("K,Nn,pair", [(1024, 256, False), (768, 512, True), (3072, 128, False)])
def test_tiled_sum_matches_one_pass_fp32(K, Nn, pair, M, weights):
    # K split into several slices, each summed by warp phases and banks (W8:
    # folds at group or slice ends): the same sum as the one-pass product
    rng = np.random.default_rng(K + Nn + M)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, Nn)) * 0.02).astype(np.float32))
    if weights != "dense":
        group = 128 if weights == "w8_g128" else K
        codes, scale = jw8.quantize_weight(jnp.asarray(w.numpy()), group)
        w = (torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scale)))
    plan = dl.gemv_plan(K, Nn, 1 if weights != "dense" else 2,
                        None if weights == "dense" else w[0].shape[0] // w[1].shape[0], pair)
    assert K // plan[1] > 1   # the shape splits K
    got, want = dl.gemv_tiled_plain(a, w, pair), dl._dot(a, w)
    dense = w if weights == "dense" else w[0].float() * w[1].repeat_interleave(
        K // w[1].shape[0], 0)
    mag = a.abs() @ dense.abs()   # two fp32 orders of one sum part by less than 1e-5 of it
    assert bool(((got - want).abs() <= 1e-5 * mag).all())


def test_banks_follow_the_rows():
    assert [dl.gemv_banks(m) for m in (1, 8, 16, 17, 64)] == [2, 2, 2, 1, 1]


# ---------------------------------------------------------------------------
# The wrappers' CUDA branch
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _recorder(monkeypatch, kernels):
    """Replace the C launches and CUDA calls; yield the launches' argument
    tuples by handle."""
    launches = []
    for k in kernels:
        monkeypatch.setattr(k, "launch", lambda *a, k=k: launches.append((k, a)))
    monkeypatch.setattr(dl, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(dl, "_TICKETS", {})
    with _NoHostRead():
        yield launches


def _card(*ts):
    return [t.as_subclass(_OnCard) for t in ts]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w8"])
def test_norm_proj_launch_plan_from_shapes(monkeypatch, quant):
    M, E_, N_ = 8, 768, 2304
    x, ns, nb = _card(torch.zeros(M, E_, dtype=torch.bfloat16), torch.ones(E_), torch.zeros(E_))
    w = _card(torch.zeros(E_, N_, dtype=torch.int8), torch.ones(E_ // 128, N_)) if quant else \
        _card(torch.zeros(E_, N_, dtype=torch.bfloat16))[0]
    handle = dl.NORM_PROJ_W8 if quant else dl.NORM_PROJ
    with _recorder(monkeypatch, [handle]) as launches:
        out = dl.fused_norm_proj(x, ns, nb, tuple(w) if quant else w, None)
    assert out.shape == (M, N_) and len(launches) == 1 and launches[0][0] is handle
    args = launches[0][1]
    # ..., xn, ws, tickets, M, E, N, eps, rms, n_tile, k_slice, dtype, stream
    nt, ks = dl.gemv_plan(E_, N_, 1 if quant else 2, 128 if quant else None)
    assert args[-9:-6] == (M, E_, N_) and args[-4:-2] == (nt, ks) and args[-1] == 7
    assert all(isinstance(p, int) and p for p in args[-12:-9])   # scratch pointers
    assert dl._TICKETS and all(t.numel() >= N_ // nt for t in dl._TICKETS.values())


@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu", "swiglu"])
def test_post_attn_launch_plans_from_shapes(monkeypatch, swiglu):
    M, E_, F_ = 8, 2048, 8192
    bf = torch.bfloat16
    y, x, wo, ns = _card(torch.zeros(M, E_, dtype=bf), torch.zeros(M, E_, dtype=bf),
                         torch.zeros(E_, E_, dtype=bf), torch.ones(E_))
    up, down = _card(torch.zeros(E_, F_, dtype=bf), torch.zeros(F_, E_, dtype=bf))
    mlp = (up, up, down) if swiglu else (up, None, down, None)
    handle = dl.post_attn_handle(swiglu=swiglu)
    with _recorder(monkeypatch, [handle]) as launches:
        out = dl.fused_post_attn(y, x, wo, None, ns, None, mlp, swiglu=swiglu, rms=swiglu)
    assert out.shape == (M, E_) and len(launches) == 1 and launches[0][0] is handle
    args = launches[0][1]
    plans = [dl.gemv_plan(E_, E_, 2), dl.gemv_plan(E_, F_, 2, None, swiglu),
             dl.gemv_plan(F_, E_, 2)]
    assert args[-8:-2] == tuple(v for p in plans for v in p)
    # r1, h, out, hin, ws, tickets: pointers, all distinct
    ptrs = args[-21 if not swiglu else -20:][:6]
    assert all(isinstance(p, int) and p for p in ptrs) and len(set(ptrs)) == 6
