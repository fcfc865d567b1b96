"""The port's page bookkeeping (``inference/kvreuse.py``) against the JAX
package's: the same op sequence drives both ``RadixPrefixCache`` /
``PagedServingState`` pairs, and matched page ids, table rows, lengths,
free-list order and ``pages_in_use`` must be equal at every step. Also the
resolve rules, the page geometry, and page-exhaustion backpressure in the
port's batcher.

gpt2-tiny, fp32, 8-token pages, a 32-token generation limit (4 table
entries per slot), 2 slots: a pool of exactly the 9-page floor, so that
backpressure and eviction happen.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.inference import kvreuse as jax_kv
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_config
from deepspeed_tpu_torch.inference import kvreuse
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

PT, MAX_TOKENS, N_SLOTS = 8, 32, 2


@pytest.fixture(scope="module")
def flax_params():
    mesh_mod.set_mesh(None)
    model = FlaxGPT2(flax_config("gpt2-tiny", dtype=jnp.float32))
    boxed = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(
        lambda x: np.asarray(getattr(x, "value", x)), boxed,
        is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


def _port_engine(params, **kw):
    with torch.device("meta"):
        model = GPT2LMHeadModel(gpt2_config("gpt2-tiny", dtype=torch.float32))
    kw.setdefault("max_tokens", MAX_TOKENS)
    return deepspeed_tpu_torch.init_inference(model, params=params, dtype=torch.float32,
                                              device="cpu", **kw)


def _pair(params, n_pages):
    mesh_mod.set_mesh(None)
    jeng = deepspeed_tpu.init_inference(
        model=FlaxGPT2(flax_config("gpt2-tiny", dtype=jnp.float32)), dtype=jnp.float32,
        params=params, max_tokens=MAX_TOKENS)
    peng = _port_engine(params)
    jc = jax_kv.RadixPrefixCache(jax_kv.PagedKVPool(jeng, n_pages, PT))
    pc = kvreuse.RadixPrefixCache(kvreuse.PagedKVPool(peng, n_pages, PT))
    return (jc, jax_kv.PagedServingState(jc, jeng, N_SLOTS),
            pc, kvreuse.PagedServingState(pc, peng, N_SLOTS))


def _same_state(js, ps, where):
    assert ps.pool._free == js.pool._free, where
    assert ps.pool.pages_in_use == js.pool.pages_in_use, where
    np.testing.assert_array_equal(ps.table, js.table, err_msg=where)
    np.testing.assert_array_equal(ps.lengths, js.lengths, err_msg=where)
    assert ps._slot_pages_n == js._slot_pages_n, where


def _same_meta(jm, pm, where):
    assert (jm is None) == (pm is None), where
    if jm is not None:
        assert pm.own == jm.own and pm.m0 == jm.m0, where
        np.testing.assert_array_equal(pm.table_row, jm.table_row, err_msg=where)
        assert [n.page for n in pm.nodes] == [n.page for n in jm.nodes], where


def test_bookkeeping_matches_jax_step_by_step(flax_params):
    jc, js, pc, ps = _pair(flax_params, n_pages=9)      # exactly the floor
    rng = np.random.default_rng(0)
    system = rng.integers(1, 500, 16).astype(np.int32)
    p0, p1, p2 = (np.concatenate([system, rng.integers(1, 500, n).astype(np.int32)])
                  for n in (5, 9, 3))
    u1, u2 = (rng.integers(1, 500, 20).astype(np.int32) for _ in range(2))
    _same_state(js, ps, "construction (trash page)")
    assert ps.trash == js.trash

    def admit(prompt, max_new, slot=None, where=""):
        (jm0, jpids, jnodes), (pm0, ppids, pnodes) = jc.match(prompt), pc.match(prompt)
        assert (pm0, ppids) == (jm0, jpids), where
        assert [n.page for n in pnodes] == [n.page for n in jnodes], where
        span = min(len(prompt) + max_new, js.gen_limit)
        jm = js.try_admit(prompt, max_new, jm0, jnodes, jpids, span_tokens=span)
        pm = ps.try_admit(prompt, max_new, pm0, pnodes, ppids, span_tokens=span)
        _same_meta(jm, pm, where)
        _same_state(js, ps, where)
        if slot is not None and jm is not None:
            js.place(slot, jm)
            ps.place(slot, pm)
            _same_state(js, ps, where + " placed")
        return jm, pm

    def both(op, *args):
        getattr(js, op)(*args)
        getattr(ps, op)(*args)
        _same_state(js, ps, op)

    admit(p0, 8, slot=0, where="cold admit")
    both("note_window", 3)
    both("retire_slot", 0, p0)                      # the system prompt's 2 pages absorbed
    assert len(pc._nodes) == len(jc._nodes) == 2
    jm, pm = admit(p1, 7, slot=0, where="hit on the system prompt")
    assert pm.m0 == 16
    admit(u1, 12, slot=1, where="unrelated prompt fills the pool")
    assert ps.pool.free_pages == 0
    jm, pm = admit(p2, 10, where="full pool, hit chain pinned: backpressure")
    assert pm is None and pc.evictions == 0
    both("retire_slot", 0, p1)                      # absorbs p1's third block, unpins
    jm, pm = admit(p2, 10, where="admission evicts the LRU leaf")
    assert pm is not None and pc.evictions == 1
    js.abort_admit(jm)
    ps.abort_admit(pm)
    _same_state(js, ps, "abort_admit")
    both("retire_slot", 1, u1)
    jm, pm = admit(u2, 1, where="unslotted")
    js.finish_unslotted(jm, u2)
    ps.finish_unslotted(pm, u2)
    _same_state(js, ps, "finish_unslotted")
    assert ps._slot_pages_n == 0
    # evict everything evictable, in the same LRU order
    order_j, order_p = [], []
    while jc._evict_one():
        order_j.append(list(jc.pool._free))
    while pc._evict_one():
        order_p.append(list(pc.pool._free))
    assert order_p == order_j and order_p and not pc._nodes


def test_pool_geometry_matches_jax(flax_params):
    jc, js, pc, ps = _pair(flax_params, n_pages=10)
    meta_j = jax_kv._derive_meta(js.pool.engine, PT)
    meta_p = kvreuse._derive_meta(ps.pool.engine, PT)
    # the JAX cache stacks the layers on a leading axis; the port keeps one
    # leaf per layer: the same (pt, KV, D) pages and the same bytes per page
    assert {m.page_shape[-3:] for m in meta_p.values()} == \
        {m.page_shape[-3:] for m in meta_j.values()} == {(PT, 2, 32)}
    assert kvreuse._page_bytes(meta_p) == jax_kv._page_bytes(meta_j) == pc.pool.page_bytes
    arena = pc.pool.pages["0.cached_key"]
    assert arena.shape == (10, PT, 2, 32) and arena.device.type == "cpu"
    cache = ps.build_cache(np.array([3, 9], np.int32), np.array([[1, 2, 0, 0], [3, 0, 0, 0]]))
    assert len(cache) == 2 and cache[1]["cached_key"] is pc.pool.pages["1.cached_key"]
    assert cache[0]["page_table"].dtype == torch.int32 and cache[0]["cache_index"].tolist() == [3, 9]


def test_resolve_rules(flax_params, monkeypatch):
    eng = _port_engine(flax_params)
    assert kvreuse.resolve_prefix_cache(eng) is None
    pc = kvreuse.resolve_prefix_cache(eng, {"page_tokens": 8, "n_pages": 20})
    assert pc.pool.n_pages == 20 and pc.page_tokens == 8
    assert kvreuse.resolve_prefix_cache(eng, pc) is pc
    assert kvreuse.resolve_prefix_cache(eng, {}).page_tokens == 16      # {} enables defaults
    monkeypatch.setenv(kvreuse.PREFIX_CACHE_ENV, "1")
    assert kvreuse.resolve_prefix_cache(eng) is not None
    assert kvreuse.resolve_prefix_cache(eng, False) is None             # explicit off wins
    monkeypatch.setenv(kvreuse.PREFIX_CACHE_ENV, "0")
    assert kvreuse.resolve_prefix_cache(eng, pc) is None                # kill switch first
    monkeypatch.delenv(kvreuse.PREFIX_CACHE_ENV)
    with pytest.raises(ValueError, match="exceeds the cache length"):
        kvreuse.resolve_prefix_cache(eng, {"page_tokens": 64})
    assert kvreuse.resolve_paged_decode(eng, None, 2) is None           # contiguous slots
    assert kvreuse.resolve_paged_decode(eng, pc, 2).T == 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kvreuse.resolve_paged_decode(eng, pc, 2, override=False)
    with pytest.raises(NotImplementedError, match="gather path"):    # the engine's config
        kvreuse.resolve_paged_decode(_port_engine(flax_params, paged_decode=False), pc, 2)
    with pytest.raises(NotImplementedError, match="specdec"):
        kvreuse.resolve_paged_decode(eng, pc, 2, specdec={"drafter": "ngram"})
    small = kvreuse.resolve_prefix_cache(eng, {"page_tokens": 8, "n_pages": 8})
    with pytest.raises(ValueError, match=r"n_slots\*ceil\(gen_limit/page_tokens\)\+1 = 4\*4\+1 = 17"):
        kvreuse.resolve_paged_decode(eng, small, 4)


def _serve(batcher, prompts, max_new=6):
    uids = [batcher.submit(p, max_new_tokens=max_new, temperature=0.8 if i % 2 else 0.0,
                           top_p=0.9) for i, p in enumerate(prompts)]
    out = {}
    while len(out) < len(uids):
        out.update(batcher.step(ticks=2))
    return [out[u] for u in uids]


def test_page_exhaustion_requeues_in_order(flax_params):
    """A pool at the construction floor (n_slots*T+1 pages) cannot admit
    prefill-ahead rows past the live slots: the un-admitted tail goes back
    to the queue head in order, and every request still finishes with the
    streams of contiguous slots."""
    eng = _port_engine(flax_params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, 12).astype(np.int32) for _ in range(6)]
    tight = deepspeed_tpu_torch.ContinuousBatcher(
        eng, n_slots=N_SLOTS, prefix_cache={"page_tokens": PT, "n_pages": 9}, prefill_ahead=8)
    assert tight.paged is not None
    uids = [tight.submit(p, max_new_tokens=6) for p in prompts]
    tight.step(ticks=1)
    queued = [r.uid for r in tight._queue]
    assert queued and queued == sorted(queued) and queued[-1] == uids[-1]
    assert len(tight._parked) + sum(s is not None for s in tight._slots) < len(prompts)
    tight.wait(uids)
    assert tight.leak_counts() == {"slots": 0, "parked": 0, "pages": 0}
    base = _serve(deepspeed_tpu_torch.ContinuousBatcher(eng, n_slots=N_SLOTS), prompts)
    got = _serve(deepspeed_tpu_torch.ContinuousBatcher(
        eng, n_slots=N_SLOTS, prefix_cache={"page_tokens": PT, "n_pages": 9},
        prefill_ahead=8), prompts)
    for want, out in zip(base, got):
        np.testing.assert_array_equal(want, out)
