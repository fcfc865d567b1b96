"""The port's GPT-NeoX against the JAX package's, on the CPU.

Two configs, fp32, the same flax weights on both sides: ``neox-tiny``
(E=64, H=4, D=16, F=128, rotary_pct 0.25), which the fused decode kernels'
128-wide panels send down the unfused path, and a fused config (E=256, 2
layers, 2 heads so D=128, F=512, rotary_pct 0.25 so 32 rotated channels,
vocab 512), where every tick can take the fused kernels (the JAX side runs
them in interpret mode, the port their plain versions). The flax trees'
biases and LayerNorm parameters are redrawn from a seed (the flax
initialisers leave them 0 and 1, which would hide a misrouted bias or
norm), so every leaf is random per column.

Tolerances: fp32 values within 1e-5 of the output's scale (fp32 sums in
another order; ``torch.erf`` and XLA's CPU erf are both fp32-accurate
approximations, a few ulps apart at the GELU input, far inside that bound),
greedy token streams identical.
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
from deepspeed_tpu.models.gptneox import GPTNeoXForCausalLM as FlaxNeoX
from deepspeed_tpu.models.gptneox import PRESETS as FLAX_PRESETS
from deepspeed_tpu.models.gptneox import gptneox_config as flax_neox_config
from deepspeed_tpu.ops import w8 as jw8
from deepspeed_tpu_torch import ContinuousBatcher
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models import gptneox as port_neox
from deepspeed_tpu_torch.models.convert import gptneox_params_from_jax, params_from_jax
from deepspeed_tpu_torch.models.gptneox import PRESETS, GPTNeoXForCausalLM, gptneox_config

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

FUSED = dict(vocab_size=512, max_position_embeddings=64, hidden_size=256, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=512)
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


def _randomize(tree, seed):
    """Biases ~ N(0, 0.02), LayerNorm scales ~ 1 + N(0, 0.1) and biases ~
    N(0, 0.1); kernels and embeddings keep the flax draws."""
    rng = np.random.default_rng(seed)

    def walk(node, in_norm):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k.endswith("_ln"))
            elif in_norm and k == "scale":
                out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            elif in_norm and k == "bias":
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            elif k.endswith("_bias"):
                out[k] = (0.02 * rng.standard_normal(v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree, False)


def _flax(name, **kw):
    model = FlaxNeoX(flax_neox_config("neox-tiny", dtype=jnp.float32, **CONFIGS[name], **kw))
    tree = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, _randomize(_unbox(tree), 11)


@pytest.fixture(scope="module")
def flax_params():
    return {name: _flax(name)[1] for name in CONFIGS}


def _cfg(name, **kw):
    return gptneox_config("neox-tiny", dtype=torch.float32, **{**CONFIGS[name], **kw})


def _port_model(name, params, **kw):
    model = GPTNeoXForCausalLM(_cfg(name, **kw))
    model.load_state_dict(gptneox_params_from_jax(params, model.cfg))
    return model


def _jax_engine(name, params, **kw):
    mesh_mod.set_mesh(None)
    over = {k: kw.pop(k) for k in ("use_parallel_residual",) if k in kw}
    return deepspeed_tpu.init_inference(
        model=FlaxNeoX(flax_neox_config("neox-tiny", dtype=jnp.float32, **CONFIGS[name],
                                        **over)),
        dtype=jnp.float32, params=params, **kw)


def _port_engine(name, params, **kw):
    over = {k: kw.pop(k) for k in ("use_parallel_residual",) if k in kw}
    with torch.device("meta"):   # weights come from params=
        model = GPTNeoXForCausalLM(_cfg(name, **over))
    return deepspeed_tpu_torch.init_inference(model, params=params, dtype=torch.float32,
                                              device="cpu", **kw)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _unscan(params, n_layer):
    out = {k: v for k, v in params.items() if k != "layers"}
    for i in range(n_layer):
        out[f"layers_{i}"] = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
    return out


# ---------------------------------------------------------------------------
# config and converter
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    assert PRESETS == FLAX_PRESETS
    fields = ("vocab_size", "max_position_embeddings", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "intermediate_size", "rotary_pct", "rotary_emb_base",
              "layer_norm_eps", "use_parallel_residual", "initializer_range",
              "vocab_pad_multiple", "padded_vocab_size", "head_dim", "rotary_dim")
    for name in PRESETS:
        j, t = flax_neox_config(name), gptneox_config(name)
        assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}, name
        assert (t.n_layer, t.n_head, t.kv_heads) == (j.num_hidden_layers,
                                                     j.num_attention_heads,
                                                     j.num_attention_heads)
        with torch.device("meta"):
            m = GPTNeoXForCausalLM(t)
        assert m.flops_per_token() == FlaxNeoX(j).flops_per_token()
    p1b = gptneox_config("pythia-1b")
    assert (p1b.vocab_size, p1b.padded_vocab_size, p1b.head_dim, p1b.rotary_dim) == (
        50432, 50432, 256, 64)
    with torch.device("meta"):
        n = sum(p.numel() for p in GPTNeoXForCausalLM(p1b).parameters())
    assert n == 1_012_305_920


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="A9"):
        gptneox_config("neox-tiny", moe={"num_experts": 2})
    with pytest.raises(NotImplementedError, match="A8b"):
        gptneox_config("neox-tiny", remat=True)
    with torch.device("meta"):
        model = GPTNeoXForCausalLM(gptneox_config("neox-tiny"))
    with pytest.raises(NotImplementedError, match="A8b"):
        deepspeed_tpu_torch.initialize(model=model, config={
            "train_micro_batch_size_per_gpu": 1,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}, device="cpu")


@pytest.mark.parametrize("tree", ["unscanned", "w8", "w8_unscanned"])
def test_converter_takes_every_layout(flax_params, tree):
    """The scanned tree is the reference; an unscanned tree gives the same
    state dict, and a tree the JAX engine quantized to W8A16 converts to
    ``*_kernel_q`` / ``*_kernel_s`` pairs (the four dense kernels of each
    block) with the rest as it was."""
    params = flax_params["fused"]
    cfg = _cfg("fused")
    scanned = gptneox_params_from_jax(params, cfg)
    assert set(scanned) == {k for k, _ in GPTNeoXForCausalLM(cfg, device="meta")
                            .named_parameters()}
    src, conv_cfg = params, cfg
    if tree.startswith("w8"):
        src = jax.tree_util.tree_map(np.asarray, jw8.quantize_dense_tree(params, 128))
        conv_cfg = _cfg("fused", w8=True)
    if tree.endswith("unscanned"):
        src = _unscan(src, cfg.n_layer)
    got = gptneox_params_from_jax(src, conv_cfg)
    if tree == "unscanned":
        assert got.keys() == scanned.keys()
        for k, v in got.items():
            assert torch.equal(v, scanned[k]), k
        return
    q = {k for k in got if k.endswith("_kernel_q")}
    assert len(q) == 4 * cfg.n_layer and not any(k.endswith("_kernel") for k in got)
    for k in q:
        assert got[k].dtype == torch.int8
        assert got[k[:-2] + "_s"].dtype == torch.float32
        assert got[k[:-2] + "_s"].shape == (got[k].shape[0] // 128, got[k].shape[1])
    for k, v in scanned.items():
        if not k.endswith("_kernel"):
            assert torch.equal(got[k], v), k


def test_converter_rejects_mismatches(flax_params):
    params = flax_params["fused"]
    cfg = _cfg("fused")
    bad = {k: v for k, v in params.items() if k != "final_ln"}
    with pytest.raises(KeyError, match="missing"):
        gptneox_params_from_jax(bad, cfg)
    wrong = dict(params, embed_out=params["embed_out"][:, :256])
    with pytest.raises(ValueError, match="embed_out"):
        gptneox_params_from_jax(wrong, cfg)
    with pytest.raises(ValueError, match="leading axis"):
        gptneox_params_from_jax(params, _cfg("fused", num_hidden_layers=3))
    with pytest.raises(KeyError, match="GPTNeoXForCausalLM"):   # another family's tree
        from deepspeed_tpu.models.llama import LlamaForCausalLM as FlaxLlama
        from deepspeed_tpu.models.llama import llama_config as flax_llama_config
        llama = _unbox(FlaxLlama(flax_llama_config("llama-tiny", dtype=jnp.float32)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
        params_from_jax(llama, gptneox_config("neox-tiny"))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parallel", [True, False], ids=["parallel", "sequential"])
@pytest.mark.parametrize("scan_layers", [True, False], ids=["scanned", "unscanned"])
@pytest.mark.parametrize("name,S", [("tiny", 16), ("fused", 128)])   # 128: the flash path
def test_forward_logits_match_flax(flax_params, name, S, scan_layers, parallel):
    cfg = flax_neox_config("neox-tiny", dtype=jnp.float32, scan_layers=scan_layers,
                           use_parallel_residual=parallel, **CONFIGS[name])
    params = flax_params[name]
    if not scan_layers:
        params = _unscan(params, cfg.num_hidden_layers)
    ids = np.random.default_rng(S).integers(0, 512, size=(2, S)).astype(np.int32)
    out = FlaxNeoX(cfg).apply({"params": params}, jnp.asarray(ids), labels=jnp.asarray(ids))
    port = _port_model(name, params, use_parallel_residual=parallel)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), labels=torch.from_numpy(ids).long())
    _close(got.logits.numpy(), out["logits"])
    np.testing.assert_allclose(float(got.loss), float(out["loss"]), rtol=1e-5)


def test_qkv_panel_is_interleaved_per_head(flax_params):
    """The qkv output is (H, 3, D) per token: a port that split the panel
    into q|k|v thirds would give other logits (the test above would catch
    it too; this one names the layout)."""
    port = _port_model("fused", flax_params["fused"])
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 512, size=(1, 12))).long()
    with torch.no_grad():
        want = port(ids).logits
        E, H, D = 256, 2, 128
        for blk in port.layers:   # permute (H, 3, D) columns to (3, H, D): q|k|v thirds
            perm = torch.arange(3 * E).reshape(H, 3, D).transpose(0, 1).reshape(-1)
            blk.attention.qkv_kernel.copy_(blk.attention.qkv_kernel[:, perm])
            blk.attention.qkv_bias.copy_(blk.attention.qkv_bias[perm])
        assert not torch.allclose(port(ids).logits, want, atol=1e-3)


def test_partial_rotary_leaves_the_tail(flax_params):
    """rotary_pct 0.25 at D=128: channels 32..127 of q and k pass through
    the rotary unrotated; 0..31 turn with the position."""
    port = _port_model("fused", flax_params["fused"])
    attn, cfg = port.layers[0].attention, port.cfg
    assert cfg.rotary_dim == 32
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 1, 256))).float()
    seen = {}
    real = port_neox.apply_rotary_pos_emb

    def spy(q, k, pos, rotary_dim, theta):
        out = real(q, k, pos, rotary_dim, theta)
        seen[int(pos.max())] = (q, *out)
        return out
    port_neox.apply_rotary_pos_emb = spy
    try:
        with torch.no_grad():
            for p in (0, 5):
                attn(x, torch.tensor([[p]]), None)
    finally:
        port_neox.apply_rotary_pos_emb = real
    q0, rq0, _ = seen[0]
    q5, rq5, _ = seen[5]
    torch.testing.assert_close(rq0, q0)                       # position 0: no turn
    torch.testing.assert_close(rq5[..., 32:], q5[..., 32:], rtol=0, atol=0)
    assert not torch.allclose(rq5[..., :32], q5[..., :32])


@pytest.mark.parametrize("parallel", [True, False], ids=["parallel", "sequential"])
@pytest.mark.parametrize("fused", [False, True], ids=["fused_off", "fused_on"])
def test_decode_tick_matches_jax(flax_params, monkeypatch, fused, parallel):
    """A 5-token prefill then 4 greedy single-token ticks through the
    contiguous cache, the JAX decode model (``decode=True``) against the
    port's ``forward(cache=...)``, logits at every step; both residuals."""
    calls = []
    real = port_neox.fused_post_attn
    monkeypatch.setattr(port_neox, "fused_post_attn",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    params = flax_params["fused"]
    jm = FlaxNeoX(flax_neox_config("neox-tiny", dtype=jnp.float32, decode=True,
                                   decode_fused=fused, use_parallel_residual=parallel,
                                   **FUSED))
    cache = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32),
                    position_ids=jnp.zeros((1, 1), jnp.int32))["cache"]
    cache = jax.tree_util.tree_map(jnp.zeros_like, cache)   # init ran one step into it
    port = _port_model("fused", params, decode_fused=fused, use_parallel_residual=parallel)
    cfg = port.cfg
    tcache = [tcommon.init_layer_cache(2, 64, cfg.kv_heads, cfg.head_dim, torch.float32, "cpu")
              for _ in range(cfg.n_layer)]
    ids = np.random.default_rng(2).integers(0, 512, size=(2, 5)).astype(np.int32)
    pos = np.arange(5)[None].repeat(2, 0)
    for step in range(5):
        out, var = jm.apply({"params": params, "cache": cache}, jnp.asarray(ids),
                            position_ids=jnp.asarray(pos), mutable=["cache"])
        cache = var["cache"]
        with torch.no_grad():
            got = port(torch.from_numpy(ids).long(), position_ids=torch.from_numpy(pos).long(),
                       cache=tcache).logits
        _close(got.numpy(), out["logits"])
        nxt = np.asarray(jnp.argmax(out["logits"][:, -1], -1))
        assert np.array_equal(got[:, -1].argmax(-1).numpy(), nxt), f"step {step}"
        ids, pos = nxt[:, None].astype(np.int32), pos[:, -1:] + 1
    assert bool(calls) == fused, "the fused decode kernels ran iff decode_fused"
    assert all(k["exact_gelu"] and k["parallel_residual"] == parallel for k in calls)


@pytest.mark.parametrize("quant", [None, W8], ids=["fp32", "w8"])
@pytest.mark.parametrize("name,fused,parallel", [("tiny", False, True), ("fused", True, True),
                                                 ("fused", True, False)])
def test_greedy_generate_token_identical(flax_params, name, fused, parallel, quant):
    kw = dict(max_tokens=48, decode_fused=fused, use_parallel_residual=parallel)
    if quant:
        kw["quant"] = quant
    jax_eng = _jax_engine(name, flax_params[name], **dict(kw))
    port = _port_engine(name, flax_params[name], **dict(kw))
    ids = np.random.default_rng(4).integers(0, 512, size=(2, 9)).astype(np.int32)
    want = np.asarray(jax_eng.generate(ids, max_new_tokens=10))
    np.testing.assert_array_equal(port.generate(ids, max_new_tokens=10).numpy(), want)
    if quant:   # the four dense kernels of each block are int8 codes; the rest is not
        own = dict(port.module.named_parameters())
        q = {n for n in own if n.endswith("_kernel_q")}
        assert len(q) == 4 * port.model_cfg.n_layer and not any(
            n.endswith("_kernel") for n in own)
        assert own["embed_in"].dtype == own["embed_out"].dtype == torch.float32
        tree = gptneox_params_from_jax(jax.tree_util.tree_map(np.asarray, jax_eng.params),
                                       port.model_cfg)
        for n in q:
            assert torch.equal(own[n], tree[n]), n


def test_engine_keeps_norms_fp32_at_bf16(flax_params):
    """bf16 serving: the LayerNorm parameters hold bf16 values in fp32
    tensors (the fused kernels read them as fp32 pointers); the rest is
    bf16."""
    with torch.device("meta"):
        model = GPTNeoXForCausalLM(_cfg("fused"))
    eng = deepspeed_tpu_torch.init_inference(model, params=flax_params["fused"],
                                             dtype=torch.bfloat16, device="cpu")
    for name, p in eng.module.named_parameters():
        norm = "_ln." in name or name.startswith("final_ln.")
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), name
        if norm:
            assert torch.equal(p, p.to(torch.bfloat16).float()), name


def test_rotary_cache_rule_matches_jax(flax_params):
    """Rotary: ``max_tokens`` sizes the cache and the limit, below or past
    the trained context (128 for neox-tiny); a config ``cache_len`` caps
    both; a forward may run past the context."""
    for max_tokens, cache_len in ((32, None), (256, None), (256, 100), (None, None)):
        over = {} if cache_len is None else {"cache_len": cache_len}
        mesh_mod.set_mesh(None)
        jax_eng = deepspeed_tpu.init_inference(
            model=FlaxNeoX(flax_neox_config("neox-tiny", dtype=jnp.float32, **over)),
            dtype=jnp.float32, params=flax_params["tiny"], max_tokens=max_tokens)
        with torch.device("meta"):
            model = GPTNeoXForCausalLM(_cfg("tiny", **over))
        port = deepspeed_tpu_torch.init_inference(model, params=flax_params["tiny"],
                                                  dtype=torch.float32, device="cpu",
                                                  max_tokens=max_tokens)
        assert port._gen_limit == jax_eng._gen_limit
        want = {l.shape[-3] for p, l in jax.tree_util.tree_leaves_with_path(
            jax_eng.init_cache(1)) if "cached_key" in jax.tree_util.keystr(p)}
        assert {port.cache_len} == want
        assert port.init_cache(1)[0]["cached_key"].shape[2:] == (4, 16)
    assert port(np.zeros((1, 160), np.int32)).shape == (1, 160, 512)


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("fused", [False, True], ids=["fused_off", "fused_on"])
@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_batcher_streams_match_jax(flax_params, jax_batcher_greedy, mode, fused):
    """The ContinuousBatcher over NeoX (KV heads = heads, D=128), contiguous
    and page-resident (8-token pages), two passes, the port's ticks unfused
    and through the fused kernels' plain versions: greedy rows equal the
    JAX batcher's; ``max_tokens=32`` is the cache length (the rotary
    rule)."""
    eng = _port_engine("fused", flax_params["fused"], max_tokens=32, decode_fused=fused)
    assert eng.cache_len == 32
    b = ContinuousBatcher(eng, n_slots=2,
                          prefix_cache={"page_tokens": 8, "n_pages": 32} if mode == "paged"
                          else None)
    assert (b.paged is not None) == (mode == "paged")
    if mode == "paged":
        assert b.prefix_cache.pool.pages["0.cached_key"].shape[2:] == (2, 128)
    prompts = _workload()
    for _ in range(2):                              # pass 2: radix hits in paged mode
        got = _serve(b, prompts)
        for i in range(0, len(prompts), 2):
            np.testing.assert_array_equal(got[i], jax_batcher_greedy[i], err_msg=f"row {i}")
    assert b.leak_counts() == {"slots": 0, "parked": 0, "pages": 0}
    if mode == "paged":
        assert b.prefix_cache.hit_tokens > 0

