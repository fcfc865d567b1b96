"""The port's ``ContinuousBatcher`` against the JAX package's.

The workload of ``tests/unit/test_zpaged_attention.py`` (ragged prompts
sharing a 19-token prefix plus a short unrelated one, greedy and sampled
rows alternating, 10 new tokens, ``step(ticks=2)``, two passes) on a
gpt2-tiny with ``n_embd=128`` (gpt2-tiny's 64 is under the fused decode
kernels' 128-wide panels, where both packages would skip them), fp32, the
same flax weights on both sides, ``n_slots=4``, 8-token pages and a 64-page
pool. Greedy streams must be byte-identical to the JAX batcher's in both
cache modes with the fused decode kernels off and on (the JAX side runs
them in interpret mode), and in page-resident mode with ``fused_mlp`` (the
JAX side's Pallas FFN kernel interpreted too). Sampled streams cannot match JAX's threefry draws;
they must repeat under a seed and agree between the port's two modes.
"""
import contextlib

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
from deepspeed_tpu_torch import ContinuousBatcher
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models.common import append_kv_cache, init_layer_cache

from .test_torch_fused_mlp import jax_fused_mlp_kernel

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

TINY = dict(n_embd=128)
PAGED = {"page_tokens": 8, "n_pages": 64}
MODES = {"contiguous": None, "paged": PAGED}


@pytest.fixture(scope="module")
def flax_params():
    mesh_mod.set_mesh(None)
    model = FlaxGPT2(flax_config("gpt2-tiny", dtype=jnp.float32, **TINY))
    boxed = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(getattr(x, "value", x)), boxed,
        is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


def _workload():
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 500, size=(19,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 500, size=(int(s),)).astype(np.int32)])
               for s in rng.integers(3, 14, size=9)]
    prompts.append(rng.integers(1, 500, size=(5,)).astype(np.int32))
    return prompts


def _serve(batcher, prompts, **kw):
    kw.setdefault("max_new_tokens", 10)
    uids = [batcher.submit(p, temperature=0.8 if i % 2 else 0.0, top_p=0.9, **kw)
            for i, p in enumerate(prompts)]
    outs = {}
    while len(outs) < len(uids):
        outs.update(batcher.step(ticks=2))
    return [np.asarray(outs[u]) for u in uids]


@pytest.fixture(scope="module")
def jax_greedy(flax_params):
    """The JAX batcher's pass-1 streams (cache off) per fused setting, and
    with ``fused_mlp`` (its interpreted Pallas kernel, decode fused off):
    one compile each for the module."""
    out = {}
    for fused, mlp in ((False, False), (True, False), (False, True)):
        mesh_mod.set_mesh(None)
        with jax_fused_mlp_kernel() if mlp else contextlib.nullcontext([]) as calls:
            eng = deepspeed_tpu.init_inference(
                model=FlaxGPT2(flax_config("gpt2-tiny", dtype=jnp.float32, fused_mlp=mlp,
                                           **TINY)),
                dtype=jnp.float32, params=flax_params, max_tokens=64, decode_fused=fused)
            out[fused, mlp] = _serve(JaxBatcher(eng, n_slots=4), _workload())
        assert bool(calls) == mlp
    mesh_mod.set_mesh(None)
    return out


def _port_engine(params, fused_mlp=False, **kw):
    with torch.device("meta"):
        model = port_gpt2.GPT2LMHeadModel(
            port_gpt2.gpt2_config("gpt2-tiny", dtype=torch.float32, fused_mlp=fused_mlp, **TINY))
    kw.setdefault("max_tokens", 64)
    return deepspeed_tpu_torch.init_inference(model, params=params, dtype=torch.float32,
                                              device="cpu", **kw)


@pytest.mark.parametrize("mode,fused,fused_mlp", [
    (mode, fused, False) for fused in (False, True) for mode in MODES] + [("paged", False, True)],
    ids=[f"{mode}-fused_{f}" for f in ("off", "on") for mode in MODES] + ["paged-fused_mlp"])
def test_greedy_streams_match_jax(flax_params, jax_greedy, monkeypatch, mode, fused, fused_mlp):
    """``fused_mlp``: every prefill chunk and (unfused) tick through the
    fused FFN, held against the JAX batcher running its Pallas kernel."""
    calls, mlp_calls = [], []
    real, real_mlp = port_gpt2.fused_norm_proj, port_gpt2.fused_mlp
    monkeypatch.setattr(port_gpt2, "fused_norm_proj",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(port_gpt2, "fused_mlp",
                        lambda *a, **k: mlp_calls.append(1) or real_mlp(*a, **k))
    b = ContinuousBatcher(_port_engine(flax_params, fused_mlp=fused_mlp, decode_fused=fused),
                          n_slots=4, prefix_cache=MODES[mode])
    assert (b.paged is not None) == (mode == "paged")
    prompts = _workload()
    first = _serve(b, prompts)
    hits = b.prefix_cache.hit_tokens if b.prefix_cache else 0
    second = _serve(b, prompts)           # pass 2: radix hits in paged mode
    for i in range(0, len(prompts), 2):
        want = jax_greedy[fused, fused_mlp][i]
        np.testing.assert_array_equal(first[i], want, err_msg=f"pass 1 row {i}")
        np.testing.assert_array_equal(second[i], want, err_msg=f"pass 2 row {i}")
    assert b.leak_counts() == {"slots": 0, "parked": 0, "pages": 0}
    assert bool(calls) == fused, "the fused decode kernels ran iff decode_fused"
    assert bool(mlp_calls) == fused_mlp, "the fused FFN ran iff fused_mlp"
    if mode == "paged":
        assert b.prefix_cache.hit_tokens > hits > 0
        assert b.stats["one_token_prefills"] > 0   # odd suffixes end in a 1-token chunk


def test_sampled_streams_repeat_and_agree_across_modes(flax_params):
    eng = _port_engine(flax_params)
    prompts = _workload()
    runs = {mode: _serve(ContinuousBatcher(eng, n_slots=4, prefix_cache=pc, seed=3), prompts)
            for mode, pc in MODES.items()}
    again = _serve(ContinuousBatcher(eng, n_slots=4, seed=3), prompts)
    other = _serve(ContinuousBatcher(eng, n_slots=4, seed=4), prompts)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(runs["paged"][i], runs["contiguous"][i], err_msg=f"row {i}")
        np.testing.assert_array_equal(again[i], runs["contiguous"][i], err_msg=f"row {i}")
    assert any(not np.array_equal(other[i], again[i]) for i in range(1, len(prompts), 2))


@pytest.mark.parametrize("mode", list(MODES))
def test_max_new_tokens_one_finishes_unslotted(flax_params, mode):
    b = ContinuousBatcher(_port_engine(flax_params), n_slots=2, prefix_cache=MODES[mode])
    prompts = [np.arange(1, 9, dtype=np.int32) + i for i in range(3)]
    outs = _serve(b, prompts, max_new_tokens=1)
    assert all(len(o) == len(p) + 1 for o, p in zip(outs, prompts))
    assert b.stats["ticks"] == 0 and b.leak_counts() == {"slots": 0, "parked": 0, "pages": 0}


def test_per_row_append_writes_only_its_own_row():
    layer = init_layer_cache(2, 6, 1, 2, torch.float32, "cpu", per_row=True)
    layer["cache_index"] = torch.tensor([5, 2], dtype=torch.int32)    # row 0 at the last slot
    k = torch.tensor([1.0, 2.0]).reshape(2, 1, 1, 1).expand(2, 1, 1, 2)
    kc, _, cur = append_kv_cache(layer, k, 3 * k)
    assert cur.tolist() == [5, 2] and layer["cache_index"].tolist() == [6, 3]
    assert kc[0, 5].eq(1).all() and kc[1, 2].eq(2).all()
    assert kc.count_nonzero() == 4                      # nothing else written
    with pytest.raises(ValueError, match="overruns"):   # the JAX path would clamp
        append_kv_cache(layer, k, k)
    assert kc.count_nonzero() == 4


@pytest.mark.parametrize("eos", [False, True], ids=["max_new", "eos"])
def test_finished_row_overshoot_stays_in_its_row(flax_params, eos):
    """Request A ends exactly at the cache's end (prompt 20 + 12 new = the
    32-token limit) while B decodes on; with no waiters a JAX window of 16
    ticks would run A past the cache. The port's windows stop at the
    headroom, every append stays inside its row (the CPU append raises
    otherwise), and both streams equal the engine's own ``generate``. With
    an EOS token, A finishes early and decodes pads inside its own row
    until the window ends."""
    eng = _port_engine(flax_params, max_tokens=32)
    assert eng.cache_len == 32
    rng = np.random.default_rng(1)
    a, b_ = rng.integers(1, 500, 20).astype(np.int32), rng.integers(1, 500, 6).astype(np.int32)
    solo = [eng.generate(p[None], max_new_tokens=n)[0].numpy() for p, n in ((a, 12), (b_, 20))]
    eos_id = int(solo[0][23]) if eos else None          # A's 4th new token
    if eos:
        solo = [eng.generate(p[None], max_new_tokens=n, eos_token_id=eos_id)[0].numpy()
                for p, n in ((a, 12), (b_, 20))]
    batcher = ContinuousBatcher(eng, n_slots=2, eos_token_id=eos_id)
    uids = [batcher.submit(a, max_new_tokens=12), batcher.submit(b_, max_new_tokens=20)]
    out = batcher.wait(uids, ticks=16)
    for uid, want in zip(uids, solo):
        got = out[uid]
        np.testing.assert_array_equal(got, want[:len(got)])
        if eos and eos_id in got[-12:]:
            assert got[-1] == eos_id
    assert batcher.leak_counts() == {"slots": 0, "parked": 0, "pages": 0}


def test_batcher_refuses_what_is_not_ported(flax_params):
    eng = _port_engine(flax_params)
    for kw in (dict(specdec={"drafter": "ngram"}), dict(admission={}), dict(slo={"ttft_ms": 1})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ContinuousBatcher(eng, n_slots=2, **kw)
    with pytest.raises(NotImplementedError, match="gather path"):
        ContinuousBatcher(eng, n_slots=2, prefix_cache=PAGED, paged_decode=False)
    with pytest.raises(ValueError, match="4\\*8\\+1 = 33"):       # undersized pool
        ContinuousBatcher(eng, n_slots=4, prefix_cache={"page_tokens": 8, "n_pages": 8})


@pytest.mark.parametrize("n_embd,head_dim", [(96, 48), (160, 80)])
def test_paged_batcher_refuses_a_head_dim_without_a_kernel(n_embd, head_dim):
    """The paged kernel has no build for this head dim: the page-resident
    batcher refuses it at construction, naming the geometry, instead of
    falling back tick by tick; contiguous slots still serve it."""
    cfg = port_gpt2.gpt2_config("gpt2-tiny", dtype=torch.float32, n_embd=n_embd)
    model = port_gpt2.GPT2LMHeadModel(cfg).init_weights(torch.Generator().manual_seed(0))
    eng = deepspeed_tpu_torch.init_inference(model, dtype=torch.float32, max_tokens=64,
                                             device="cpu")
    with pytest.raises(NotImplementedError, match=f"head_dim={head_dim}.*gather path"):
        ContinuousBatcher(eng, n_slots=2, prefix_cache=PAGED)
    b = ContinuousBatcher(eng, n_slots=2)
    out = _serve(b, [np.arange(1, 9, dtype=np.int32)], max_new_tokens=3)
    assert len(out[0]) == 8 + 3 and b.leak_counts() == {"slots": 0, "parked": 0, "pages": 0}


def test_admission_failure_rolls_back_pins_and_pages(flax_params):
    b = ContinuousBatcher(_port_engine(flax_params), n_slots=2, prefix_cache=PAGED)
    pg = b.paged
    free0 = pg.pool.free_pages
    b.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=6)

    def die(*a, **kw):
        raise RuntimeError("transient device flake")

    b._prefill = die
    with pytest.raises(RuntimeError, match="transient"):
        b.step()
    del b._prefill
    assert pg.pool.free_pages == free0 and pg._slot_pages_n == 0
    outs = _serve(b, [np.arange(1, 12, dtype=np.int32)], max_new_tokens=4)
    assert len(outs[0]) == 11 + 4


@pytest.mark.parametrize("u", [0.0, 2.0 ** -24, 0.5, 1.0 - 2.0 ** -24])
def test_sample_rows_never_picks_a_filtered_token(u):
    """The inverse-CDF pick takes the first token whose CDF exceeds u · mass:
    u = 0.0 must not land on token 0 when top-k has removed it (the left
    side of the search did, for one draw in 2^24)."""
    from deepspeed_tpu_torch.inference.serving import sample_rows

    V = 16
    logits = torch.full((2, V), -1.0)
    logits[:, 7], logits[:, 9] = 3.0, 2.5            # top-k=2 keeps tokens 7 and 9
    ones = torch.ones(2)
    pick = sample_rows(logits, False, torch.tensor([0.8, 0.8]), ones, ones,
                       torch.zeros((2, V), dtype=torch.bool), torch.tensor([u, u]), top_k=2)
    assert set(pick.tolist()) <= {7, 9}
    if u < 0.5:
        assert pick.tolist() == [7, 7]
