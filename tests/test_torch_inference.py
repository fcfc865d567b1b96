"""The port's inference engine against the JAX ``InferenceEngine``.

Small GPT-2 (E=128, L=2, H=2, vocab 512), fp32, the same flax weights on
both sides: greedy ``generate`` must be token-identical with the fused
decode kernels off and on (the JAX side runs them in interpret mode), the
``max_tokens``/``cache_len`` rule and the sampling transforms must match.
Also: entry points refuse to leave the card silently, unported options
raise, and the package and ``chip_smoke.py`` import nothing of JAX.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.inference import engine as jax_engine
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_config
from deepspeed_tpu_torch.inference import engine as port_engine
from deepspeed_tpu_torch.models.common import (append_kv_cache, cache_leaf_kind,
                                               init_layer_cache, set_cache_index)
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=512, n_embd=128, n_layer=2, n_head=2, n_positions=128)


@pytest.fixture(autouse=True)
def fresh_mesh():
    mesh_mod.set_mesh(None)
    yield
    mesh_mod.set_mesh(None)


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL))
    boxed = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(getattr(x, "value", x)), boxed,
        is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


def _port_model(**over):
    with torch.device("meta"):   # weights come from params=
        return GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32, **{**SMALL, **over}))


def _engines(params, **kw):
    jax_eng = deepspeed_tpu.init_inference(
        model=FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL)),
        dtype=jnp.float32, params=params, **kw)
    port = deepspeed_tpu_torch.init_inference(_port_model(), params=params,
                                              dtype=torch.float32, device="cpu", **kw)
    return jax_eng, port


@pytest.mark.parametrize("decode_fused", [False, True])
def test_greedy_generate_token_identical(flax_params, decode_fused):
    jax_eng, port = _engines(flax_params, decode_fused=decode_fused)
    ids = np.random.default_rng(0).integers(0, 512, size=(2, 9)).astype(np.int32)
    want = np.asarray(jax_eng.generate(ids, max_new_tokens=12))
    got = port.generate(ids, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, want)


def test_forward_matches_jax_engine(flax_params):
    jax_eng, port = _engines(flax_params)
    ids = np.random.default_rng(1).integers(0, 512, size=(2, 128)).astype(np.int32)
    np.testing.assert_allclose(port(ids).numpy(), np.asarray(jax_eng(ids)), atol=1e-4, rtol=0)


@pytest.mark.parametrize("max_tokens,cache_len", [
    (None, None), (64, None), (128, None), (512, None), (64, 48), (None, 100)])
def test_cache_len_rule_matches_jax(max_tokens, cache_len):
    over = {} if cache_len is None else {"cache_len": cache_len}
    jax_eng = jax_engine.InferenceEngine(
        model=FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL, **over)),
        max_tokens=max_tokens)
    want_cache = jax_eng.decode_cfg.cache_len or jax_eng.decode_cfg.n_positions
    m = GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32, **SMALL, **over))
    port = deepspeed_tpu_torch.init_inference(m.init_weights(torch.Generator().manual_seed(0)),
                                              max_tokens=max_tokens, device="cpu")
    assert (port._gen_limit, port.cache_len) == (jax_eng._gen_limit, want_cache)
    assert port.init_cache(1)[0]["cached_key"].shape == (1, want_cache, 2, 64)


def test_over_limit_prompt_raises(flax_params):
    jax_eng, port = _engines(flax_params, max_tokens=32)
    ids = np.zeros((1, 30), np.int32)
    with pytest.raises(ValueError, match="generation limit"):
        jax_eng.generate(ids, max_new_tokens=3)
    with pytest.raises(ValueError, match="generation limit"):
        port.generate(ids, max_new_tokens=3)
    port.generate(ids, max_new_tokens=2)          # exactly at the limit is fine
    with pytest.raises(ValueError, match="position table"):
        port(np.zeros((1, 129), np.int32))


@pytest.mark.parametrize("temperature,top_k,top_p,penalty", [
    (1.0, 0, 1.0, 1.3), (0.7, 5, 1.0, 1.0), (0.7, 0, 0.8, 1.0), (1.3, 10, 0.5, 0.8)])
def test_sampling_transforms_match_jax(temperature, top_k, top_p, penalty):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    seen = rng.random((4, 64)) < 0.2
    want = jax_engine._filtered_logits(
        jax_engine._penalized_logits(jnp.asarray(logits), penalty, jnp.asarray(seen)),
        temperature, top_k, top_p)
    got = port_engine._filtered_logits(
        port_engine._penalized_logits(torch.from_numpy(logits), penalty, torch.from_numpy(seen)),
        temperature, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_seeded_sampling_is_deterministic(flax_params):
    _, port = _engines(flax_params)
    ids = np.random.default_rng(2).integers(0, 512, size=(2, 5)).astype(np.int32)
    kw = dict(max_new_tokens=10, temperature=0.9, top_k=50, top_p=0.9)
    a = port.generate(ids, seed=3, **kw)
    b = port.generate(ids, seed=3, **kw)
    assert torch.equal(a, b) and a.shape == (2, 15) and int(a.max()) < 512


@pytest.mark.parametrize("pad", [511, None])
def test_eos_freezes_a_row_like_jax(flax_params, pad):
    jax_eng, port = _engines(flax_params)
    ids = np.random.default_rng(5).integers(0, 512, size=(2, 4)).astype(np.int32)
    free = port.generate(ids, max_new_tokens=8).numpy()
    eos = int(free[0, 5])
    out = port.generate(ids, max_new_tokens=8, eos_token_id=eos, pad_token_id=pad).numpy()
    row = out[0, 4:]
    first = int(np.argmax(row == eos))
    assert (row[first + 1:] == (eos if pad is None else pad)).all()
    want = jax_eng.generate(ids, max_new_tokens=8, eos_token_id=eos, pad_token_id=pad)
    np.testing.assert_array_equal(out, np.asarray(want))


def test_entry_points_stay_on_the_card(monkeypatch):
    m = GPT2LMHeadModel(gpt2_config("gpt2-tiny", dtype=torch.float32))
    m.init_weights(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.init_inference(m)
    eng = deepspeed_tpu_torch.init_inference(m, device="cpu")
    assert eng.device.type == "cpu" and eng(np.zeros((1, 4), np.int32)).device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(mp_size=2), dict(ep_size=2), dict(quant={"enabled": True}),
                                dict(prefix_cache=True, paged_decode=False), dict(specdec=True),
                                dict(prefix_cache={"page_tokens": 8}, paged_decode=False),
                                dict(checkpoint="ckpt")])
def test_unported_options_raise(kw):
    # a prefix cache with paged decode off is the gather path, not ported
    m = GPT2LMHeadModel(gpt2_config("gpt2-tiny", dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference(m.init_weights(torch.Generator().manual_seed(0)),
                                           device="cpu", **kw)


def test_cache_contract():
    layer = init_layer_cache(2, 6, 2, 4, torch.float32, "cpu")
    assert [cache_leaf_kind(k) for k in layer] == ["kv", "kv", "index"]
    k = torch.ones(2, 4, 2, 4)
    kc, _, cur = append_kv_cache(layer, k, 2 * k)
    assert cur == 0 and layer["cache_index"] == 4 and kc[:, :4].eq(1).all()
    with pytest.raises(ValueError, match="overruns"):   # the JAX path would clamp
        append_kv_cache(layer, k, k)
    assert layer["cache_index"] == 4 and kc[:, 4:].eq(0).all()
    set_cache_index([layer], 1)
    append_kv_cache(layer, 3 * k, k)
    assert layer["cache_index"] == 5 and kc[:, 1:5].eq(3).all() and kc[:, 0].eq(1).all()


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepspeed_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'deepspeed_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'deepspeed_tpu', "
        "'optax')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('deepspeed_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 19
    assert {f"deepspeed_tpu_torch.runtime.{m}" for m in (
        "config", "constants", "engine", "lr_schedules", "optimizers", "precision")} <= imported
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "deepspeed_tpu." not in src.replace(
        "deepspeed_tpu_torch", "")


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for where in (REPO, tmp_path):    # the repo, and a directory with the script alone
        if where == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
