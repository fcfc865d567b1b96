"""Int8 weight-only (W8A16) serving and the fake-quant load branch of the
port, against the JAX package.

Kernel level: ``quantize_weight`` codes and scales equal JAX's exactly; the
w8 kernel's plain version against the Pallas kernel in interpret mode
within 1e-5 of ``|x| @ |dequant W|`` (both sum fp32 partials in group
order); the CPU routes of ``w8a16_matmul`` against JAX's off-TPU routes in
fp32 within 1e-6 relative (the grouped contraction sums in another order);
the dispatch predicates equal JAX's. Slice level, on a GPT-2 (E=256, 4
heads, 2 layers, vocab 512, group size 128: the c_attn panel has 2 scale
groups and the down projection 8): the int8 engine against JAX's holds the
same codes, its logits agree within 1e-5, greedy ``generate`` is
token-identical with the fused decode kernels off and on (JAX runs them in
interpret mode), from fp weights quantized at load and from the JAX
engine's own quantized tree; the continuous batcher's greedy streams are
byte-identical in both cache modes. Fake-quant (bits 4): leaves equal JAX's
``fake_quantize``, logits agree within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.inference.serving import ContinuousBatcher as JaxBatcher
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_config
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops import w8 as jw8
from deepspeed_tpu.ops.pallas import decode_layer as jdl
from deepspeed_tpu.ops.pallas import w8_matmul as jwm
from deepspeed_tpu_torch import ContinuousBatcher
from deepspeed_tpu_torch.inference import engine as port_engine
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.models.gpt2 import PRESETS, GPT2LMHeadModel, gpt2_config
from deepspeed_tpu_torch.ops import decode_layer as dl
from deepspeed_tpu_torch.ops import quantizer as tq
from deepspeed_tpu_torch.ops import w8 as tw8
from deepspeed_tpu_torch.ops import w8_matmul as twm

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

SMALL = dict(vocab_size=512, n_embd=256, n_layer=2, n_head=4, n_positions=128)
W8 = {"enabled": True, "bits": 8}
FAKE = {"enabled": True, "bits": 4, "groups": 16}
PAGED = {"page_tokens": 8, "n_pages": 64}


@pytest.fixture(autouse=True)
def fresh_mesh():
    mesh_mod.set_mesh(None)
    yield
    mesh_mod.set_mesh(None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _w(rng, *shape, std=0.02):
    return (rng.standard_normal(shape) * std).astype(np.float32)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,group", [((256, 384), 128), ((200, 64), 128),
                                         ((3, 256, 128), 128), ((2, 2, 256, 128), 64)],
                         ids=["zero_group", "one_group", "stack3d", "stack4d"])
def test_quantize_weight_equals_jax(shape, group):
    rng = np.random.default_rng(0)
    w = _w(rng, *shape, std=rng.uniform(0.005, 2.0))
    w[..., :group, :7] = 0.0                        # an all-zero group: scale 1, codes 0
    jc, js = jw8.quantize_weight(jnp.asarray(w), group)
    tc, ts = tw8.quantize_weight(_t(w), group)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if shape == (200, 64):
        assert ts.shape == (1, 64)                  # 128 does not divide 200: one group


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantizer_ops_equal_jax(bits, symmetric):
    x = np.random.default_rng(1).standard_normal((48, 64)).astype(np.float32)
    want = jq.fake_quantize(jnp.asarray(x), bits, 16, symmetric=symmetric)
    got = tq.fake_quantize(_t(x), bits, 16, symmetric=symmetric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jc, js = jq.quantize_symmetric(jnp.asarray(x), bits, 16)
    tc, ts = tq.quantize_symmetric(_t(x), bits, 16)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_stochastic_rounding_repeats_and_brackets():
    x = _t(np.random.default_rng(2).standard_normal((32, 64)).astype(np.float32))
    codes = [tq.quantize_symmetric(x, 4, 8, torch.Generator().manual_seed(s))[0] for s in (5, 5, 6)]
    assert torch.equal(codes[0], codes[1]) and not torch.equal(codes[0], codes[2])
    _, scale = tq.quantize_symmetric(x, 4, 8)
    y = (x.reshape(8, -1) / scale[:, None]).reshape(x.shape)
    c = codes[0].float()
    assert bool(((c == torch.floor(y)) | (c == torch.ceil(y))).all())
    with pytest.raises(ValueError, match="not divisible"):
        tq.quantize_symmetric(x, 4, 7)


def test_quantize_state_dict_renames_dense_kernels_only():
    model = GPT2LMHeadModel(gpt2_config("gpt2-tiny", dtype=torch.float32, **SMALL))
    sd = model.init_weights(torch.Generator().manual_seed(0)).state_dict()
    q = tw8.quantize_state_dict(sd, 128)
    assert not any(k.endswith("_kernel") for k in q)
    kernels = [k for k in sd if k.endswith("_kernel")]
    assert len(kernels) == 4 * SMALL["n_layer"]
    for k in kernels:
        assert q[k + "_q"].dtype == torch.int8 and q[k + "_s"].dtype == torch.float32
    for k in sd:
        if not k.endswith("_kernel"):
            assert q[k] is sd[k]           # embeddings, norms, biases: as given


def test_w8_model_declares_the_flax_pairs():
    # the W8 model's parameters are the JAX model's (names, shapes, dtypes,
    # and its initialisers: zero codes, unit scales), and carry no gradient
    mesh_mod.set_mesh(None)
    flax = FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, w8=True, **SMALL))
    boxed = flax.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(lambda x: np.asarray(getattr(x, "value", x)), boxed,
                                  is_leaf=lambda x: hasattr(x, "value"))
    cfg = gpt2_config("gpt2-125m", dtype=torch.float32, w8=True, **SMALL)
    model = GPT2LMHeadModel(cfg).init_weights(torch.Generator().manual_seed(0))
    want = gpt2_params_from_jax(tree, cfg)
    for name, p in model.named_parameters():
        assert p.dtype == want[name].dtype and p.shape == want[name].shape, name
        if "_kernel_" in name:
            assert not p.requires_grad and torch.equal(p, want[name]), name


# ---------------------------------------------------------------------------
# the w8 kernel's plain version, the dispatch, the predicates
# ---------------------------------------------------------------------------

def _panel(rng, K, N, group):
    w = _w(rng, K, N)
    c, s = jw8.quantize_weight(jnp.asarray(w), group)
    return c, s, _t(c), _t(s)


@pytest.mark.parametrize("G", [1, 3], ids=["G=1", "G=3"])
@pytest.mark.parametrize("M", [1, 5, 16, 64])
def test_w8_plain_matches_pallas(monkeypatch, M, G):
    monkeypatch.setattr(jwm, "INTERPRET", True)
    rng = np.random.default_rng(M)
    K, N = 384, 256                                # G=1: one whole-K group; G=3: g=128
    jc, js, tc, ts = _panel(rng, K, N, K // G)
    x = rng.standard_normal((M, K)).astype(np.float32)
    want = np.asarray(jwm.w8a16_matmul_pallas(jnp.asarray(x, jnp.bfloat16), jc, js))
    got = twm.w8a16_matmul_plain(_t(x), tc, ts)
    assert got.dtype == torch.float32
    xb = _t(x).to(torch.bfloat16).float()
    mag = (xb.abs() @ tw8.dequantize_weight(tc, ts).abs()).numpy()
    assert (np.abs(got.numpy() - want) <= 1e-5 * mag).all()
    # on the CPU the kernel's wrapper runs exactly its plain version
    assert torch.equal(twm.w8a16_matmul_kernel(_t(x).to(torch.bfloat16), tc, ts), got)


@pytest.mark.parametrize("M", [1, 5, 64, 65, 130])
def test_w8a16_matmul_cpu_routes_match_jax(M):
    # M <= 64: the grouped contraction; M > 64: the dequantized panel
    rng = np.random.default_rng(10 + M)
    jc, js, tc, ts = _panel(rng, 256, 384, 128)
    x = rng.standard_normal((M, 256)).astype(np.float32)
    want = np.asarray(jw8.w8a16_matmul(jnp.asarray(x), jc, js))
    got = tw8.w8a16_matmul(_t(x), tc, ts).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_predicates_match_jax():
    # group sizes 64, 128 and each panel's own K (one group)
    for preset in ("gpt2-125m", "gpt2-350m", "gpt2-760m", "gpt2-1.5b"):
        E = PRESETS[preset]["n_embd"]
        for M in (1, 8, 64, 65):
            for group in (64, 128, None):
                def groups(k):
                    return k // jw8.w8_group_size(k, group or k)
                for K, N in ((E, 3 * E), (E, E), (E, 4 * E), (4 * E, E)):
                    assert twm.supported((M, K), (K, N), groups(K)) == jwm.supported(
                        (M, K), (K, N), groups(K), mesh_ok=True), (preset, M, group, K, N)
                Ge, Gf = groups(E), groups(4 * E)
                for n in (3 * E, E):
                    assert dl.norm_proj_supported(M, E, n, True, Ge) == jdl.norm_proj_supported(
                        M, E, n, 2, True, Ge), (preset, M, group, n)
                assert dl.post_attn_supported(M, E, 4 * E, True, Ge, Gf) == \
                    jdl.post_attn_supported(M, E, 4 * E, 2, True, Ge, Gf), (preset, M, group)


def test_post_attn_predicate_leaves_out_the_tpu_tile_rule():
    # gpt2-125m with 768-row groups: the down panel (F=3072) holds 4 groups.
    # JAX's _pick_bf refuses it (no 128..2048-row tile both divides F and
    # holds a multiple of 8 groups, a Mosaic scale-tile rule); the CUDA
    # kernel needs only 128-aligned groups that divide K, so the port serves
    # it, and its plain version holds the arithmetic.
    assert not jdl.post_attn_supported(8, 768, 3072, 2, True, 1, 4)
    assert dl.post_attn_supported(8, 768, 3072, True, 1, 4)
    assert not dl.post_attn_supported(8, 768, 3072, True, 1, 48)   # 64-row groups
    assert not dl.post_attn_supported(8, 768, 3072, True, 1, 5)    # groups do not divide F


# ---------------------------------------------------------------------------
# the int8 engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_params():
    mesh_mod.set_mesh(None)
    model = FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL))
    boxed = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(getattr(x, "value", x)), boxed,
        is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


@pytest.fixture(scope="module")
def jax_engines(flax_params):
    """The JAX int8 engine per fused setting, and its quantized tree."""
    engines = {}
    for fused in (False, True):
        mesh_mod.set_mesh(None)
        engines[fused] = deepspeed_tpu.init_inference(
            model=FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL)),
            dtype=jnp.float32, params=flax_params, quant=W8, max_tokens=64, decode_fused=fused)
    mesh_mod.set_mesh(None)
    tree = jax.tree_util.tree_map(np.asarray, engines[False].params)
    return engines, tree


def _port(params, **kw):
    with torch.device("meta"):
        model = GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32, **SMALL))
    kw.setdefault("max_tokens", 64)
    return deepspeed_tpu_torch.init_inference(model, params=params, dtype=torch.float32,
                                              device="cpu", **kw)


def _dense_bytes(eng):
    return sum(p.numel() * p.element_size() for n, p in eng.module.named_parameters()
               if "_kernel" in n)


@pytest.mark.parametrize("source", ["fp_weights", "jax_quantized_tree"])
def test_w8_engine_holds_jax_codes_and_logits(flax_params, jax_engines, source):
    engines, tree = jax_engines
    port = _port(flax_params if source == "fp_weights" else tree, quant=W8)
    own = dict(port.module.named_parameters())
    assert not any(n.endswith("_kernel") for n in own)
    want = gpt2_params_from_jax(tree, port.model_cfg)
    for name, p in own.items():
        if "_kernel_" in name:
            assert p.dtype == (torch.int8 if name.endswith("_q") else torch.float32)
            assert not p.requires_grad
            assert torch.equal(p, want[name]), name
    bf16 = deepspeed_tpu_torch.init_inference(
        GPT2LMHeadModel(gpt2_config("gpt2-125m", **SMALL)), params=flax_params,
        dtype=torch.bfloat16, device="cpu")
    assert _dense_bytes(port) <= 0.6 * _dense_bytes(bf16)
    ids = np.random.default_rng(3).integers(0, 512, size=(2, 40)).astype(np.int32)
    want_logits = np.asarray(engines[False](ids))
    np.testing.assert_allclose(port(ids).numpy(), want_logits, atol=1e-5, rtol=0)
    # a 65-row forward (the dequantized panel on both sides)
    ids = ids[:1, :65] if ids.shape[1] >= 65 else np.tile(ids[:1], (1, 2))[:, :65]
    np.testing.assert_allclose(port(ids).numpy(), np.asarray(engines[False](ids)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("source", ["fp_weights", "jax_quantized_tree"])
@pytest.mark.parametrize("fused", [False, True], ids=["fused_off", "fused_on"])
def test_w8_greedy_generate_token_identical(flax_params, jax_engines, monkeypatch, fused,
                                            source):
    engines, tree = jax_engines
    calls = []
    real = dl.fused_post_attn
    from deepspeed_tpu_torch.models import gpt2 as port_gpt2
    monkeypatch.setattr(port_gpt2, "fused_post_attn",
                        lambda *a, **k: calls.append(isinstance(a[2], tuple)) or real(*a, **k))
    port = _port(flax_params if source == "fp_weights" else tree, quant=W8, decode_fused=fused)
    ids = np.random.default_rng(4).integers(0, 512, size=(2, 9)).astype(np.int32)
    want = np.asarray(engines[fused].generate(ids, max_new_tokens=10))
    np.testing.assert_array_equal(port.generate(ids, max_new_tokens=10).numpy(), want)
    assert bool(calls) == fused and all(calls)      # the W8 pairs reach the fused kernel


def _workload():
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 500, size=(19,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 500, size=(int(s),)).astype(np.int32)])
               for s in rng.integers(3, 14, size=7)]
    prompts.append(rng.integers(1, 500, size=(5,)).astype(np.int32))
    return prompts


def _serve(batcher, prompts):
    uids = [batcher.submit(p, max_new_tokens=8, temperature=0.8 if i % 2 else 0.0, top_p=0.9)
            for i, p in enumerate(prompts)]
    outs = {}
    while len(outs) < len(uids):
        outs.update(batcher.step(ticks=2))
    return [np.asarray(outs[u]) for u in uids]


@pytest.fixture(scope="module")
def jax_batcher_greedy(jax_engines):
    return _serve(JaxBatcher(jax_engines[0][False], n_slots=4), _workload())


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_w8_batcher_streams_match_jax(flax_params, jax_batcher_greedy, mode):
    b = ContinuousBatcher(_port(flax_params, quant=W8), n_slots=4,
                          prefix_cache=PAGED if mode == "paged" else None)
    prompts = _workload()
    for _ in range(2):                              # pass 2: radix hits in paged mode
        got = _serve(b, prompts)
        for i in range(0, len(prompts), 2):
            np.testing.assert_array_equal(got[i], jax_batcher_greedy[i], err_msg=f"row {i}")
    assert b.leak_counts() == {"slots": 0, "parked": 0, "pages": 0}
    assert sum(n for (B, S), n in b.prefill_chunks.items() if S > 1) > 0


# ---------------------------------------------------------------------------
# the fake-quant branch
# ---------------------------------------------------------------------------

def test_fake_quant_engine_matches_jax(flax_params):
    jax_eng = deepspeed_tpu.init_inference(
        model=FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL)),
        dtype=jnp.float32, params=flax_params, quant=FAKE)
    port = _port(flax_params, quant=FAKE)
    assert not port.model_cfg.w8
    want = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, jax_eng.params),
                                port.model_cfg)
    fp = gpt2_params_from_jax(flax_params, port.model_cfg)
    own = dict(port.module.named_parameters())
    for name in ("wte", "wpe", "h.0.attn.c_attn_kernel", "h.1.mlp.c_proj_kernel"):
        assert torch.equal(own[name], want[name]), name
        assert not torch.equal(own[name], fp[name]), name        # it did quantize
    ids = np.random.default_rng(5).integers(0, 512, size=(2, 24)).astype(np.int32)
    np.testing.assert_allclose(port(ids).numpy(), np.asarray(jax_eng(ids)), atol=1e-5, rtol=0)


def test_fake_quant_warns_where_groups_do_not_divide(flax_params, monkeypatch):
    said = []
    monkeypatch.setattr(port_engine.logger, "warning", said.append)
    _port(flax_params, quant={"enabled": True, "bits": 4, "groups": 7})
    assert said and all("ONE group" in s for s in said)
    said.clear()
    _port(flax_params, quant=FAKE)                 # every >= 2-D leaf divides by 16
    assert not said
