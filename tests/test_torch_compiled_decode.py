"""The compiled decode loop of the port, on the CPU.

``InferenceEngine.generate(compiled_loop=True)`` and the batcher's decode
windows replay one captured tick on the card (``inference/graphs.py``); on
the CPU the same in-place tick function runs without capture, so these
tests hold the code the card replays:

- ``generate(compiled_loop=True)`` against ``compiled_loop=False``, greedy
  and sampled, and the EOS case (full width against an early stop), as
  ``tests/unit/test_inference.py::test_generate_compiled_loop_matches_stepwise``
  holds the JAX engine's two loops; both loops' greedy tokens against the
  JAX engine's ``generate(compiled_loop=True)`` on the same fp32 weights,
  for GPT-2, LLaMA and GPT-NeoX;
- the batcher's compiled tick against its eager window, both cache modes,
  greedy and sampled rows, token for token;
- each request retiring on the same ``step()`` call as in the JAX batcher;
- the launch bookkeeping of a capture (taken back) and its replays (added
  once each), as pure Python;
- the static buffers a graph reads: one shared write head that appends
  leave alone, paged lengths and tables refreshed in place, the GEMV's
  column-tile counters that may not grow under capture, and the bounded
  graph cache.

Tolerances: none; every comparison is of token ids.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.inference.serving import ContinuousBatcher as JaxBatcher
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_gpt2_config
from deepspeed_tpu_torch import ContinuousBatcher
from deepspeed_tpu_torch.inference import engine as port_engine
from deepspeed_tpu_torch.inference.graphs import DecodeGraph, gc_paused
from deepspeed_tpu_torch.models.common import (STATIC_HEAD, advance_heads, append_kv_cache,
                                               set_cache_index)
from deepspeed_tpu_torch.ops import _build, decode_layer

from . import test_torch_gptneox as neox
from . import test_torch_llama as llama
from . import test_torch_serving as gpt2

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

FAMILIES = ("gpt2", "llama", "neox")
SAMPLED = dict(temperature=0.8, top_k=7, top_p=0.9, repetition_penalty=1.1, seed=13)


@pytest.fixture(autouse=True)
def fresh_mesh():
    mesh_mod.set_mesh(None)
    yield
    mesh_mod.set_mesh(None)


@pytest.fixture(scope="module")
def flax_params():
    """Each family's fp32 flax weights: GPT-2 at the serving tests' width
    (E=128), LLaMA and GPT-NeoX at their fused configs (E=256)."""
    mesh_mod.set_mesh(None)
    model = FlaxGPT2(flax_gpt2_config("gpt2-tiny", dtype=jnp.float32, **gpt2.TINY))
    tree = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return {"gpt2": llama._unbox(tree), "llama": llama._flax("fused")[1],
            "neox": neox._flax("fused")[1]}


def _engines(family, params, jax_side=False, **kw):
    """The port's engine (and the JAX engine) of a family on the same weights."""
    kw.setdefault("max_tokens", 48)
    if family == "gpt2":
        port = gpt2._port_engine(params, **kw)
        if not jax_side:
            return port
        mesh_mod.set_mesh(None)
        jax_eng = deepspeed_tpu.init_inference(
            model=FlaxGPT2(flax_gpt2_config("gpt2-tiny", dtype=jnp.float32, **gpt2.TINY)),
            dtype=jnp.float32, params=params, **kw)
        return port, jax_eng
    mod = llama if family == "llama" else neox
    port = mod._port_engine("fused", params, **kw)
    return (port, mod._jax_engine("fused", params, **kw)) if jax_side else port


def _ids(rows=2, cols=5, seed=31):
    return np.random.default_rng(seed).integers(0, 500, size=(rows, cols)).astype(np.int32)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_generate_compiled_loop_matches_stepwise(flax_params, family):
    """The compiled loop and the stepwise loop run one tick function: token
    for token equal, greedy and sampled; with EOS the compiled loop returns
    full width (pads after EOS) and the stepwise one may stop early, and
    the prefixes agree."""
    eng = _engines(family, flax_params[family])
    ids = _ids()
    for kw in (dict(), SAMPLED):
        a = eng.generate(ids, max_new_tokens=6, compiled_loop=True, **kw).numpy()
        b = eng.generate(ids, max_new_tokens=6, compiled_loop=False, **kw).numpy()
        assert a.shape == (2, 11)
        np.testing.assert_array_equal(a, b)
    free = eng.generate(ids, max_new_tokens=8).numpy()
    eos = int(free[0, 6])
    full = eng.generate(ids, max_new_tokens=8, eos_token_id=eos, pad_token_id=0,
                        compiled_loop=True).numpy()
    short = eng.generate(ids, max_new_tokens=8, eos_token_id=eos, pad_token_id=0,
                         compiled_loop=False).numpy()
    assert full.shape == (2, 13)
    np.testing.assert_array_equal(full[:, :short.shape[1]], short)
    _check_eos_padding(full, free, 5, eos, 0)


def _first_eos(row, start, eos):
    hits = np.flatnonzero(row[start:] == eos)
    return None if len(hits) == 0 else start + int(hits[0])


def _check_eos_padding(full, free, start, eos, pad):
    """Each row follows the free run up to its first EOS and pads after it."""
    for r in range(len(full)):
        f = _first_eos(free[r], start, eos)
        end = len(free[r]) if f is None else f + 1
        np.testing.assert_array_equal(full[r, :end], free[r, :end], err_msg=f"row {r}")
        assert (full[r, end:] == pad).all(), f"row {r}"


def test_stepwise_loop_stops_once_every_row_is_done(flax_params):
    """JAX's early stop: once every row has emitted EOS the stepwise loop
    returns, one done read a tick; the compiled loop keeps full width."""
    eng = _engines("gpt2", flax_params["gpt2"])
    ids = np.repeat(_ids(1), 2, axis=0)        # two equal rows finish together
    free = eng.generate(ids, max_new_tokens=10).numpy()
    eos = int(free[0, 7])
    short = eng.generate(ids, max_new_tokens=10, eos_token_id=eos,
                         compiled_loop=False).numpy()
    full = eng.generate(ids, max_new_tokens=10, eos_token_id=eos).numpy()
    first = _first_eos(free[0], 5, eos)
    # the loop checks after each tick, so at least one tick runs
    assert short.shape == (2, max(first + 1, 7)) and full.shape == (2, 15)
    np.testing.assert_array_equal(full[:, :short.shape[1]], short)
    _check_eos_padding(full, free, 5, eos, eos)       # pad defaults to the EOS id


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_match_jax_compiled_loop(flax_params, family):
    """Greedy tokens of both loops equal the JAX engine's
    ``generate(compiled_loop=True)`` on the same fp32 weights."""
    port, jax_eng = _engines(family, flax_params[family], jax_side=True)
    ids = _ids(2, 9, seed=4)
    want = np.asarray(jax_eng.generate(ids, max_new_tokens=10, compiled_loop=True))
    for compiled in (True, False):
        got = port.generate(ids, max_new_tokens=10, compiled_loop=compiled).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"compiled_loop={compiled}")


def test_generate_graph_cache_is_bounded(flax_params):
    """At most GRAPH_CACHE graphs by static key and DECODE_WIDTHS batch
    widths of static buffers; a graph keeps the state it was made over; a
    weight load drops them all."""
    eng = _engines("gpt2", flax_params["gpt2"])
    ids = _ids()
    for k in range(port_engine.GRAPH_CACHE + 3):
        eng.generate(ids, max_new_tokens=2, temperature=0.5, top_k=k + 1)
    assert len(eng._graphs) == port_engine.GRAPH_CACHE
    assert {key[4] for key in eng._graphs} == set(range(4, port_engine.GRAPH_CACHE + 4))
    for B in range(1, port_engine.DECODE_WIDTHS + 3):
        eng.generate(_ids(B), max_new_tokens=2)
    assert list(eng._decode_states) == list(range(3, port_engine.DECODE_WIDTHS + 3))
    assert all(key[0] in eng._decode_states for key in eng._graphs)
    assert all(st is eng._decode_states[key[0]] for key, (st, _) in eng._graphs.items())
    before = eng.generate(ids, max_new_tokens=4).numpy()
    eng.load_params(dict(eng.module.state_dict()))
    assert not eng._graphs and not eng._decode_states
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=4).numpy(), before)


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

def _serve_steps(batcher, prompts, ticks, sampled=True, max_new=None):
    """Submit everything, step to the end; returns the outputs by uid and,
    per ``step()`` call, the uids it finished."""
    max_new = max_new or [4 + (3 * i) % 9 for i in range(len(prompts))]
    uids = [batcher.submit(p, max_new_tokens=m,
                           temperature=0.8 if sampled and i % 2 else 0.0, top_p=0.9)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    outs, steps = {}, []
    while len(outs) < len(uids):
        done = batcher.step(ticks=ticks)
        steps.append(sorted(uids.index(u) for u in done))
        outs.update(done)
    return [np.asarray(outs[u]) for u in uids], steps


@pytest.mark.parametrize("fused", [False, True], ids=["fused_off", "fused_on"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mode", list(gpt2.MODES))
def test_batcher_compiled_tick_matches_eager_window(flax_params, mode, family, fused):
    """The in-place tick (static buffers, the tick counter's uniforms and
    output rows, the shared head advanced once a tick) gives the eager
    window's tokens, greedy and sampled rows, two passes (radix hits in
    paged mode), and the same ticks and windows."""
    eng = _engines(family, flax_params[family], max_tokens=64, decode_fused=fused)
    prompts = gpt2._workload()[:6]
    pc = {"page_tokens": 8, "n_pages": 64} if mode == "paged" else None
    runs = {}
    for compiled in (True, False):
        b = ContinuousBatcher(eng, n_slots=3, prefix_cache=pc, seed=5, compiled_loop=compiled)
        outs = [_serve_steps(b, prompts, ticks=4) for _ in range(2)]
        runs[compiled] = (outs, dict(b.stats), b.leak_counts())
        assert (b._tick_state is not None) == compiled
    (got, st_c, leaks_c), (want, st_e, leaks_e) = runs[True], runs[False]
    for p in range(2):
        for i, (x, y) in enumerate(zip(got[p][0], want[p][0])):
            np.testing.assert_array_equal(x, y, err_msg=f"pass {p} row {i}")
        assert got[p][1] == want[p][1]
    assert {k: st_c[k] for k in ("ticks", "windows", "decode_tokens")} == \
        {k: st_e[k] for k in ("ticks", "windows", "decode_tokens")}
    assert leaks_c == leaks_e == {"slots": 0, "parked": 0, "pages": 0}


@pytest.mark.parametrize("ticks", [4, 8])
@pytest.mark.parametrize("mode", list(gpt2.MODES))
def test_requests_retire_on_the_same_step_as_jax(flax_params, mode, ticks):
    """Greedy requests of mixed lengths, more than the slots, ``step(ticks)``
    (windows split at retirements and rounded up to powers of two): the
    port's batcher (compiled tick) finishes each request on the same
    ``step()`` call as the JAX batcher, with the same tokens."""
    port, jax_eng = _engines("gpt2", flax_params["gpt2"], jax_side=True, max_tokens=64)
    prompts = gpt2._workload()
    pc = gpt2.MODES[mode]
    want = _serve_steps(JaxBatcher(jax_eng, n_slots=3, prefix_cache=pc), prompts, ticks,
                        sampled=False)
    got = _serve_steps(ContinuousBatcher(port, n_slots=3, prefix_cache=pc), prompts, ticks,
                       sampled=False)
    assert got[1] == want[1]
    for i, (x, y) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(x, y, err_msg=f"row {i}")


@pytest.mark.parametrize("mode", list(gpt2.MODES))
def test_rounded_window_defers_the_next_retirement_as_in_jax(flax_params, mode):
    """One slot, ``step(ticks=8)``: A needs 3 ticks while B waits, so the
    window rounds up to 4 (A decodes one discarded pad) and B, admitted
    after it, has 4 of its 5 ticks left in this step: B retires on the
    second ``step()`` call in both batchers (an unrounded window of 3
    would finish B on the first)."""
    port, jax_eng = _engines("gpt2", flax_params["gpt2"], jax_side=True, max_tokens=64)
    prompts = gpt2._workload()[:2]
    pc = gpt2.MODES[mode]
    kw = dict(sampled=False, max_new=[4, 6])
    want = _serve_steps(JaxBatcher(jax_eng, n_slots=1, prefix_cache=pc), prompts, 8, **kw)
    got = _serve_steps(ContinuousBatcher(port, n_slots=1, prefix_cache=pc), prompts, 8, **kw)
    assert want[1] == got[1] == [[0], [1]]
    for i, (x, y) in enumerate(zip(got[0], want[0])):
        np.testing.assert_array_equal(x, y, err_msg=f"row {i}")


def test_paged_decode_cache_is_static(flax_params):
    """Every window's paged cache is the same list over the same device
    buffers, refreshed in place from the host mirrors, its layers sharing
    one lengths tensor that appends leave alone."""
    eng = _engines("gpt2", flax_params["gpt2"], max_tokens=32)
    b = ContinuousBatcher(eng, n_slots=2, prefix_cache={"page_tokens": 8, "n_pages": 16})
    pg = b.paged
    pg.lengths[:] = [3, 9]
    pg.table[0, :2] = [4, 5]
    c1 = pg.decode_cache()
    lengths = c1[0]["cache_index"]
    assert lengths.tolist() == [3, 9] and c1[0]["page_table"][0, :2].tolist() == [4, 5]
    assert all(layer["cache_index"] is lengths and layer[STATIC_HEAD] for layer in c1)
    pg.lengths[:] = [7, 1]
    c2 = pg.decode_cache()
    assert c2 is c1 and c2[1]["cache_index"] is lengths and lengths.tolist() == [7, 1]
    k = torch.ones(2, 1, 2, 64)
    append_kv_cache(c2[0], k, k, 32)
    assert c2[0]["cache_index"] is lengths and lengths.tolist() == [7, 1]
    advance_heads(c2)
    assert lengths.tolist() == [8, 2]


# ---------------------------------------------------------------------------
# static buffers and launch bookkeeping
# ---------------------------------------------------------------------------

def test_static_head_cache(flax_params):
    """A ``static_head`` cache: one head tensor for every layer, which
    appends leave alone, ``advance_heads`` moves once and
    ``set_cache_index`` writes in place."""
    eng = _engines("gpt2", flax_params["gpt2"], max_tokens=32)
    cache = eng.init_cache(2, static_head=True)
    head = cache[0]["cache_index"]
    assert all(layer["cache_index"] is head and layer[STATIC_HEAD] for layer in cache)
    set_cache_index(cache, torch.tensor([3, 5], dtype=torch.int32))
    k = torch.ones(2, 1, 2, 64)
    kc, _, cur = append_kv_cache(cache[0], k, 2 * k)
    assert cur is head and head.tolist() == [3, 5] and cache[0]["cache_index"] is head
    assert kc[0, 3].eq(1).all() and kc[1, 5].eq(1).all() and kc.count_nonzero() == 2 * 2 * 64
    advance_heads(cache, 2)
    assert head.tolist() == [5, 7]
    set_cache_index(cache, 0)
    assert cache[1]["cache_index"] is head and head.tolist() == [0, 0]
    plain = eng.init_cache(2)            # the old contract: per-layer heads, rebound
    append_kv_cache(plain[0], k, k)
    assert plain[0]["cache_index"].tolist() == [1, 1] and plain[1]["cache_index"].tolist() == [0, 0]


def test_decode_graph_runs_the_tick_on_the_cpu():
    """Without a card a DecodeGraph runs its tick n times and captures nothing."""
    calls = []
    g = DecodeGraph(lambda: calls.append(1), torch.device("cpu"))
    g.run(3)
    g.run(0)
    assert len(calls) == 3 and g.graph is None and g.replays == 0


@pytest.mark.parametrize("enabled", [True, False], ids=["gc_on", "gc_off"])
def test_gc_paused_restores_the_collector(enabled):
    """No automatic collection inside a capture's block; the collector's
    earlier state comes back after it, also when the block raises."""
    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        with gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError), gc_paused():
            raise RuntimeError("capture failed")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("mode", list(gpt2.MODES))
def test_dropped_batcher_frees_its_graphs_at_once(flax_params, mode):
    """A batcher's window graphs hold its tick, and the tick no reference
    to the batcher: dropping the batcher frees it and its graphs at once,
    with no garbage collection (a collection may not free a graph during
    another graph's capture)."""
    eng = _engines("gpt2", flax_params["gpt2"], max_tokens=64)
    b = ContinuousBatcher(eng, n_slots=3, prefix_cache=gpt2.MODES[mode], seed=5)
    _serve_steps(b, gpt2._workload()[:4], ticks=4)
    assert b._graphs
    refs = [weakref.ref(b)] + [weakref.ref(g) for g in b._graphs.values()]
    with gc_paused():
        del b
        assert all(r() is None for r in refs)


class _FakeLibrary(_build.LibraryCounts):
    """A C library's counters held in Python, loaded."""

    def __init__(self):
        super().__init__("fake_library", "fake_launched", ("k0", "k1"))
        self.counts = {"k0": 0, "k1": 0}

    def loaded(self):
        return True

    def raw(self):
        return dict(self.counts)


def test_capture_replay_launch_bookkeeping():
    """A capture's counts are taken back (it launches nothing) and kept as
    the graph's launches; each replay adds them once; eager launches around
    them count as they are; library counts read the same way."""
    a = _build.Kernel("fake_library", "a_fwd", [])
    b = _build.Kernel("fake_library", "b_fwd", [])
    lib = _FakeLibrary()
    a.launches, lib.counts["k0"] = 2, 5           # eager launches before
    with _build.recording_capture() as rec:
        a.launches += 3                            # what one captured tick counts
        b.launches += 1
        lib.counts["k0"] += 3
        lib.counts["k1"] += 6
    assert a.launches == 2 and b.launches == 0
    assert lib.read() == {"k0": 5, "k1": 0}
    assert rec.kernels == {a: 3, b: 1}
    assert rec.library == {("fake_library", "k0"): 3, ("fake_library", "k1"): 6}
    _build.count_replays(rec, 4)
    a.launches += 1                                # an eager launch after
    assert (a.launches, b.launches) == (2 + 3 * 4 + 1, 4)
    assert lib.read() == {"k0": 5 + 3 * 4, "k1": 6 * 4}
    _build.count_replays(rec, 0)
    assert lib.read() == {"k0": 17, "k1": 24}
    # a capture that raises still takes its counts back
    with pytest.raises(RuntimeError):
        with _build.recording_capture():
            b.launches += 7
            raise RuntimeError("capture failed")
    assert b.launches == 4
    for key in rec.library:                        # leave no trace for other tests
        _build._replayed.pop(key, None)


def test_gemv_tickets_do_not_grow_under_capture(monkeypatch):
    """A captured GEMV bakes its counters' address in: under capture a
    missing or short buffer raises; reserved before capture, it is reused."""
    key = ("cpu", 987654)
    monkeypatch.setitem(decode_layer._TICKETS, key, None)
    monkeypatch.setattr(decode_layer, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="reserve"):
        decode_layer.gemv_tickets("cpu", 987654, 8)
    monkeypatch.setattr(decode_layer, "capturing", lambda: False)
    t = decode_layer.gemv_tickets("cpu", 987654, decode_layer._MIN_TICKETS + 5)
    assert t.numel() == decode_layer._MIN_TICKETS + 5 and not t.any()
    monkeypatch.setattr(decode_layer, "capturing", lambda: True)
    assert decode_layer.gemv_tickets("cpu", 987654, 64) is t
    with pytest.raises(RuntimeError, match="reserve"):
        decode_layer.gemv_tickets("cpu", 987654, decode_layer._MIN_TICKETS + 6)


def test_tickets_needed_covers_the_widest_panel(flax_params):
    eng = _engines("gpt2", flax_params["gpt2"], max_tokens=32)
    E = eng.model_cfg.n_embd
    assert decode_layer.tickets_needed(eng.module) == 4 * E // decode_layer.N_TILES[-1]
