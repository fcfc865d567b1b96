"""GPT-2 in the port against flax ``GPT2LMHeadModel``: the weight converter
for both flax layouts, forward logits, and the KV cache after a prefill.

Small model (E=128, L=2, H=2, vocab 512), fp32, the same flax weights on
both sides; logits at atol 1e-4 (fp32 through two layers and the head,
summed in different orders), cache leaves at atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_config
from deepspeed_tpu_torch.models.common import init_layer_cache
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

SMALL = dict(n_embd=128, n_layer=2, n_head=2, n_positions=256)


@pytest.fixture(autouse=True)
def fresh_mesh():
    mesh_mod.set_mesh(None)
    yield
    mesh_mod.set_mesh(None)


@functools.lru_cache(maxsize=None)
def _flax(vocab=512, scan_layers=True):
    cfg = flax_config("gpt2-125m", vocab_size=vocab, dtype=jnp.float32,
                      scan_layers=scan_layers, **SMALL)
    model = FlaxGPT2(cfg)
    boxed = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(getattr(x, "value", x)), boxed,
        is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))
    return model, params


def _port(params, vocab=512):
    cfg = gpt2_config("gpt2-125m", vocab_size=vocab, dtype=torch.float32, **SMALL)
    model = GPT2LMHeadModel(cfg)
    model.load_state_dict(gpt2_params_from_jax(params, cfg))
    return model.requires_grad_(False)


def _unscan(params, L):
    """The scanned tree's weights in the scan_layers=False layout."""
    out = {k: v for k, v in params.items() if k != "h"}
    for i in range(L):
        out[f"h_{i}"] = jax.tree_util.tree_map(lambda a: a[i], params["h"])
    return out


def test_converter_takes_both_layouts():
    _, params = _flax()
    cfg = gpt2_config("gpt2-125m", vocab_size=512, dtype=torch.float32, **SMALL)
    scanned = gpt2_params_from_jax(params, cfg)
    unscanned = gpt2_params_from_jax(_unscan(params, 2), cfg)
    assert scanned.keys() == unscanned.keys()
    assert scanned.keys() == dict(GPT2LMHeadModel(cfg).named_parameters()).keys()
    for k in scanned:
        assert torch.equal(scanned[k], unscanned[k]), k
    # kernels keep the flax (in, out) layout: no transposes
    np.testing.assert_array_equal(scanned["h.1.attn.c_attn_kernel"].numpy(),
                                  params["h"]["attn"]["c_attn_kernel"][1])


def test_converter_rejects_mismatches():
    _, params = _flax()
    cfg = gpt2_config("gpt2-125m", vocab_size=512, dtype=torch.float32, **SMALL)
    bad = {k: v for k, v in params.items() if k != "ln_f"}
    with pytest.raises(KeyError):
        gpt2_params_from_jax(bad, cfg)
    with pytest.raises(ValueError):
        gpt2_params_from_jax(params, gpt2_config("gpt2-125m", vocab_size=512, **{
            **SMALL, "n_layer": 3}))


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("S", [16, 128])     # 128: the flash path on the port's side
def test_forward_logits_match_flax(scan_layers, S):
    model, params = _flax(scan_layers=scan_layers)
    ids = np.random.default_rng(S).integers(0, 512, size=(2, S)).astype(np.int32)
    want = model.apply({"params": params}, jnp.asarray(ids))["logits"]
    got = _port(params)(torch.from_numpy(ids).long()).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_padded_vocab_columns_masked():
    model, params = _flax(vocab=500)      # padded to 512
    ids = np.random.default_rng(1).integers(0, 500, size=(1, 12)).astype(np.int32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids))["logits"])
    got = _port(params, vocab=500)(torch.from_numpy(ids).long()).logits.numpy()
    assert got.shape == want.shape == (1, 12, 512)
    np.testing.assert_array_equal(got[..., 500:], np.finfo(np.float32).min)
    np.testing.assert_allclose(got[..., :500], want[..., :500], atol=1e-4, rtol=0)


def test_kv_cache_after_prefill_matches_flax():
    _, params = _flax(scan_layers=False)
    dec = FlaxGPT2(flax_config("gpt2-125m", vocab_size=512, dtype=jnp.float32, decode=True,
                               cache_len=32, scan_layers=False, **SMALL))
    pos = jnp.asarray(np.arange(10)[None, :].repeat(2, 0))
    cache0 = {f"h_{i}": {"attn": {"cached_key": jnp.zeros((2, 32, 2, 64)),
                                  "cached_value": jnp.zeros((2, 32, 2, 64)),
                                  "cache_index": jnp.zeros((), jnp.int32)}}
              for i in range(2)}
    ids = np.random.default_rng(2).integers(0, 512, size=(2, 10)).astype(np.int32)
    out, vars_ = dec.apply({"params": params, "cache": cache0}, jnp.asarray(ids),
                           position_ids=pos, mutable=["cache"])
    want = [vars_["cache"][f"h_{i}"]["attn"] for i in range(2)]

    port = _port(params)
    cache = [init_layer_cache(2, 32, 2, 64, torch.float32, "cpu") for _ in range(2)]
    logits = port(torch.from_numpy(ids).long(), position_ids=torch.from_numpy(np.asarray(pos)),
                  cache=cache).logits
    np.testing.assert_allclose(logits.numpy(), np.asarray(out["logits"]), atol=1e-4, rtol=0)
    for i, layer in enumerate(cache):
        for leaf in ("cached_key", "cached_value"):
            np.testing.assert_allclose(layer[leaf].numpy(), np.asarray(want[i][leaf]),
                                       atol=1e-5, rtol=0)
        assert layer["cache_index"] == int(want[i]["cache_index"]) == 10
