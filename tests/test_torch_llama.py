"""The port's LLaMA against the JAX package's, on the CPU.

Two configs, fp32, the same flax weights on both sides: ``llama-tiny``
(E=64, H=4, KV=2, D=16), which the fused decode kernels' 128-wide panels
send down the unfused path, and the JAX package's own fused GQA config
(``tests/unit/test_zdecode_fused_e2e.py``: E=256, H=4, KV=2, D=64, F=512,
2 layers, vocab 512), where every tick can take the fused kernels (the JAX
side runs them in interpret mode, the port their plain versions).

Tolerances: fp32 values within 1e-5 of the output's scale (fp32 sums in
another order), greedy token streams identical.
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
from deepspeed_tpu.models import common as jcommon
from deepspeed_tpu.models.llama import LlamaForCausalLM as FlaxLlama
from deepspeed_tpu.models.llama import llama_config as flax_llama_config
from deepspeed_tpu.ops import rotary as jrot
from deepspeed_tpu.ops import w8 as jw8
from deepspeed_tpu_torch import ContinuousBatcher
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.models.convert import llama_params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config
from deepspeed_tpu_torch.ops import rotary as trot

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

FUSED = dict(vocab_size=512, max_position_embeddings=64, hidden_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, intermediate_size=512)
CONFIGS = {"tiny": {}, "fused": FUSED}
W8 = {"enabled": True, "bits": 8}


@pytest.fixture(autouse=True)
def fresh_mesh():
    mesh_mod.set_mesh(None)
    yield
    mesh_mod.set_mesh(None)


def _unbox(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(getattr(x, "value", x)), tree,
        is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


def _flax(name, **kw):
    model = FlaxLlama(flax_llama_config("llama-tiny", dtype=jnp.float32, **CONFIGS[name], **kw))
    return model, _unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def flax_params():
    return {name: _flax(name)[1] for name in CONFIGS}


def _cfg(name, **kw):
    return llama_config("llama-tiny", dtype=torch.float32, **{**CONFIGS[name], **kw})


def _port_model(name, params, **kw):
    model = LlamaForCausalLM(_cfg(name, **kw))
    model.load_state_dict(llama_params_from_jax(params, model.cfg))
    return model


def _jax_engine(name, params, **kw):
    mesh_mod.set_mesh(None)
    return deepspeed_tpu.init_inference(
        model=FlaxLlama(flax_llama_config("llama-tiny", dtype=jnp.float32, **CONFIGS[name])),
        dtype=jnp.float32, params=params, **kw)


def _port_engine(name, params, **kw):
    with torch.device("meta"):   # weights come from params=
        model = LlamaForCausalLM(_cfg(name))
    return deepspeed_tpu_torch.init_inference(model, params=params, dtype=torch.float32,
                                              device="cpu", **kw)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# norm and rotary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-5)
    got = tcommon.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(scale), 1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    if dtype == "float32":
        _close(got.numpy(), want)
    else:   # fp32 arithmetic, one cast: equal but for a rounding tipped by the sum's order
        diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
        assert (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("rotary_dim", [None, 8])
@pytest.mark.parametrize("interleaved", [False, True], ids=["half_split", "interleaved"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_matches_jax(interleaved, rotary_dim, dtype):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 300]], np.int32)
    want = jrot.apply_rotary_pos_emb(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                                     jnp.asarray(pos), rotary_dim=rotary_dim, theta=10000.0,
                                     interleaved=interleaved)
    td = getattr(torch, dtype)
    got = trot.apply_rotary_pos_emb(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                                    torch.from_numpy(pos), rotary_dim=rotary_dim,
                                    theta=10000.0, interleaved=interleaved)
    for g, w in zip(got, want):
        assert g.dtype == td and tuple(g.shape) == w.shape
        w = np.asarray(w.astype(jnp.float32))
        if rotary_dim:   # the tail passes through untouched
            np.testing.assert_array_equal(g[..., rotary_dim:].float().numpy(),
                                          w[..., rotary_dim:])
        if dtype == "float32":
            _close(g.numpy(), w)
        else:   # cos/sin cast to bf16 before the products, as JAX does
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=2 ** -6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _unscan(params, n_layer):
    out = {k: v for k, v in params.items() if k != "layers"}
    for i in range(n_layer):
        out[f"layers_{i}"] = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
    return out


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scanned", "unscanned"])
@pytest.mark.parametrize("name,S", [("tiny", 16), ("fused", 128)])   # 128: the flash path
def test_forward_logits_match_flax(flax_params, name, S, scan_layers):
    cfg = flax_llama_config("llama-tiny", dtype=jnp.float32, scan_layers=scan_layers,
                            **CONFIGS[name])
    params = flax_params[name]
    if not scan_layers:
        params = _unscan(params, cfg.num_hidden_layers)
    ids = np.random.default_rng(S).integers(0, 512, size=(2, S)).astype(np.int32)
    out = FlaxLlama(cfg).apply({"params": params}, jnp.asarray(ids), labels=jnp.asarray(ids))
    port = _port_model(name, params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), labels=torch.from_numpy(ids).long())
    _close(got.logits.numpy(), out["logits"])
    np.testing.assert_allclose(float(got.loss), float(out["loss"]), rtol=1e-5)
    if not scan_layers:   # the two layouts give one state dict
        scanned = llama_params_from_jax(flax_params[name], port.cfg)
        for k, v in llama_params_from_jax(params, port.cfg).items():
            assert torch.equal(v, scanned[k]), k


def test_converter_rejects_mismatches(flax_params):
    params = flax_params["fused"]
    cfg = _cfg("fused")
    bad = {k: v for k, v in params.items() if k != "norm"}
    with pytest.raises(KeyError, match="missing"):
        llama_params_from_jax(bad, cfg)
    wrong = dict(params, lm_head=params["lm_head"][:, :256])
    with pytest.raises(ValueError, match="lm_head"):
        llama_params_from_jax(wrong, cfg)
    with pytest.raises(ValueError, match="leading axis"):
        llama_params_from_jax(params, _cfg("fused", num_hidden_layers=3))


def test_config_matches_jax():
    for name in ("llama-tiny", "llama-1b", "llama-7b"):
        j, t = flax_llama_config(name), llama_config(name)
        assert (t.n_layer, t.n_head, t.kv_heads, t.head_dim, t.padded_vocab_size) == (
            j.num_hidden_layers, j.num_attention_heads, j.kv_heads, j.head_dim,
            j.padded_vocab_size)
        with torch.device("meta"):
            m = LlamaForCausalLM(t)
        assert m.flops_per_token() == FlaxLlama(j).flops_per_token()
    with torch.device("meta"):
        n = sum(p.numel() for p in LlamaForCausalLM(llama_config("llama-1b")).parameters())
    assert n == 1_446_078_464


@pytest.mark.parametrize("fused", [False, True], ids=["fused_off", "fused_on"])
def test_decode_tick_matches_jax(flax_params, monkeypatch, fused):
    """A 5-token prefill then 4 greedy single-token ticks through the
    contiguous cache, the JAX decode model (``decode=True``) against the
    port's ``forward(cache=...)``, logits at every step."""
    calls = []
    real = port_llama.fused_post_attn
    monkeypatch.setattr(port_llama, "fused_post_attn",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    params = flax_params["fused"]
    jm = FlaxLlama(flax_llama_config("llama-tiny", dtype=jnp.float32, decode=True,
                                     decode_fused=fused, **FUSED))
    cache = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32),
                    position_ids=jnp.zeros((1, 1), jnp.int32))["cache"]
    cache = jax.tree_util.tree_map(jnp.zeros_like, cache)   # init ran one step into it
    port = _port_model("fused", params, decode_fused=fused)
    cfg = port.cfg
    tcache = [tcommon.init_layer_cache(2, 64, cfg.kv_heads, cfg.head_dim, torch.float32, "cpu")
              for _ in range(cfg.n_layer)]
    ids = np.random.default_rng(2).integers(0, 512, size=(2, 5)).astype(np.int32)
    pos = np.arange(5)[None].repeat(2, 0)
    for step in range(5):
        out, var = jm.apply({"params": params, "cache": cache}, jnp.asarray(ids),
                            position_ids=jnp.asarray(pos), mutable=["cache"])
        cache = var["cache"]
        got = port(torch.from_numpy(ids).long(), position_ids=torch.from_numpy(pos).long(),
                   cache=tcache).logits
        _close(got.detach().numpy(), out["logits"])
        nxt = np.asarray(jnp.argmax(out["logits"][:, -1], -1))
        assert np.array_equal(got[:, -1].argmax(-1).numpy(), nxt), f"step {step}"
        ids, pos = nxt[:, None].astype(np.int32), pos[:, -1:] + 1
    assert bool(calls) == fused, "the fused decode kernels ran iff decode_fused"


@pytest.mark.parametrize("quant", [None, W8], ids=["fp32", "w8"])
@pytest.mark.parametrize("name,fused", [("tiny", False), ("fused", True)])
def test_greedy_generate_token_identical(flax_params, name, fused, quant):
    kw = dict(max_tokens=48, decode_fused=fused)
    if quant:
        kw["quant"] = quant
    jax_eng = _jax_engine(name, flax_params[name], **kw)
    port = _port_engine(name, flax_params[name], **kw)
    ids = np.random.default_rng(4).integers(0, 512, size=(2, 9)).astype(np.int32)
    want = np.asarray(jax_eng.generate(ids, max_new_tokens=10))
    np.testing.assert_array_equal(port.generate(ids, max_new_tokens=10).numpy(), want)
    if quant:   # the seven dense kernels of each block are int8 codes; the rest is not
        own = dict(port.module.named_parameters())
        q = {n for n in own if n.endswith("_kernel_q")}
        assert len(q) == 7 * port.model_cfg.n_layer and not any(
            n.endswith("_kernel") for n in own)
        assert own["embed_tokens"].dtype == own["lm_head"].dtype == torch.float32
        tree = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, jax_eng.params),
                                     port.model_cfg)
        for n in q:
            assert torch.equal(own[n], tree[n]), n


def test_rotary_cache_rule_matches_jax(flax_params):
    """Rotary: ``max_tokens`` sizes the cache and the limit, below or past
    the trained context (128 for llama-tiny); a config ``cache_len`` caps
    both; a forward may run past the context."""
    for max_tokens, cache_len in ((32, None), (256, None), (256, 100), (None, None)):
        over = {} if cache_len is None else {"cache_len": cache_len}
        mesh_mod.set_mesh(None)
        jax_eng = deepspeed_tpu.init_inference(
            model=FlaxLlama(flax_llama_config("llama-tiny", dtype=jnp.float32, **over)),
            dtype=jnp.float32, params=flax_params["tiny"], max_tokens=max_tokens)
        with torch.device("meta"):
            model = LlamaForCausalLM(_cfg("tiny", **over))
        port = deepspeed_tpu_torch.init_inference(model, params=flax_params["tiny"],
                                                  dtype=torch.float32, device="cpu",
                                                  max_tokens=max_tokens)
        assert port._gen_limit == jax_eng._gen_limit
        want = {l.shape[-3] for p, l in jax.tree_util.tree_leaves_with_path(
            jax_eng.init_cache(1)) if "cached_key" in jax.tree_util.keystr(p)}
        assert {port.cache_len} == want
        assert port.init_cache(1)[0]["cached_key"].shape[2] == 2   # the KV heads only
    assert port(np.zeros((1, 160), np.int32)).shape == (1, 160, 512)


def _workload():
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 500, size=(11,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 500, size=(int(s),)).astype(np.int32)])
               for s in rng.integers(3, 10, size=5)]
    prompts.append(rng.integers(1, 500, size=(5,)).astype(np.int32))
    return prompts


def _serve(batcher, prompts):
    uids = [batcher.submit(p, max_new_tokens=9, temperature=0.8 if i % 2 else 0.0, top_p=0.9)
            for i, p in enumerate(prompts)]
    outs = {}
    while len(outs) < len(uids):
        outs.update(batcher.step(ticks=4))
    return [np.asarray(outs[u]) for u in uids]


@pytest.fixture(scope="module")
def jax_batcher_greedy(flax_params):
    mesh_mod.set_mesh(None)
    eng = _jax_engine("fused", flax_params["fused"], max_tokens=32, decode_fused=False)
    assert eng._gen_limit == 32
    return _serve(JaxBatcher(eng, n_slots=2), _workload())


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_batcher_streams_match_jax(flax_params, jax_batcher_greedy, mode):
    """The ContinuousBatcher over the GQA cache (2 KV heads for 4 query
    heads), contiguous and page-resident (8-token pages), two passes: greedy
    rows equal the JAX batcher's; ``max_tokens=32`` is the cache length (the
    rotary rule)."""
    eng = _port_engine("fused", flax_params["fused"], max_tokens=32, decode_fused=False)
    assert eng.cache_len == 32
    b = ContinuousBatcher(eng, n_slots=2,
                          prefix_cache={"page_tokens": 8, "n_pages": 32} if mode == "paged"
                          else None)
    assert (b.paged is not None) == (mode == "paged")
    if mode == "paged":
        assert b.prefix_cache.pool.pages["0.cached_key"].shape[2:] == (2, 64)
    prompts = _workload()
    for _ in range(2):                              # pass 2: radix hits in paged mode
        got = _serve(b, prompts)
        for i in range(0, len(prompts), 2):
            np.testing.assert_array_equal(got[i], jax_batcher_greedy[i], err_msg=f"row {i}")
    assert b.leak_counts() == {"slots": 0, "parked": 0, "pages": 0}
    if mode == "paged":
        assert b.prefix_cache.hit_tokens > 0


def test_w8_quantize_state_dict_takes_the_dense_kernels(flax_params):
    """``quantize_state_dict`` quantizes exactly the leaves JAX's
    ``quantize_dense_tree`` does (q, k, v, o, gate, up, down), to the same
    codes; the embedding, the head and the norms pass through."""
    from deepspeed_tpu_torch.ops.w8 import quantize_state_dict

    params = flax_params["fused"]
    cfg = _cfg("fused")
    mine = quantize_state_dict(llama_params_from_jax(params, cfg), 128)
    theirs = llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jw8.quantize_dense_tree(params, 128)),
        llama_config("llama-tiny", **FUSED, w8=True))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert torch.equal(torch.as_tensor(mine[k]), theirs[k]), k
