"""The int8-moment AdamW of the port (``ops/adam8bit.py``) against the JAX
package, on the CPU.

The quantizers against JAX's exactly; one unfused leaf step against JAX's
``scale_by_adam8bit`` + decay + lr; the fused kernel's plain version
(which the CUDA kernel is held against on the card) against the Pallas
kernel in interpret mode, with a clip scale below 1, L2 and decoupled
decay, on a 2-D leaf, a bias and a scanned ``(L, in, out)`` leaf; the state
converter; and four engine steps of ``adamw8bit`` (fused off and on) and of
``adam8bit`` in L2 mode against the JAX ``Engine``, both started from the
same parameters and moments (the JAX engine's state after one step, carried
by ``models/convert.py``).

fp32 throughout. Tolerances, each with its reason: quantizer codes and
scales exact (the same fp32 operations); one leaf step: params and scales
rtol 1e-6 (the same formula; fp32 results may differ in the last bit where
the two libraries fuse or vectorise differently), codes equal or off by one
on at most 0.1% of elements (a last-bit difference tips a round-half tie).
Engine steps: losses rtol 1e-5 and grad norms rtol 1e-5 (gradients summed
in another order); params rtol 1e-6 / atol 1e-7 on at least 99.9% of the
model's elements (the key-bias third of ``c_attn_bias``, a gradient of
rounding noise by softmax shift invariance, left out of the share), and
every element within a quarter of one step (lr/4) of JAX's over the four
steps: a code that flips at a tie changes that element's later steps by a
small share of lr (at most 0.027·lr here), while a wrong sign or size of
even a few elements' steps moves them by lr or more; codes off by at most
one on at most 0.1% of the model's elements; scales rtol 1e-5 on at least 99% of the rows (a row's
absmax comes from gradients that differ in their last bits, carried
through four moment updates) and within 1% on all (a flipped code moves
the next step's m by one code step, 1/127 of the row's absmax, and that
element can be the row's largest).
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch as ds
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_config
from deepspeed_tpu.ops import adam8bit as jax8
from deepspeed_tpu.ops.pallas.adam8bit_kernel import apply_fused_leaf
from deepspeed_tpu.telemetry import recompile
from deepspeed_tpu_torch.models.convert import adam8bit_state_from_jax, gpt2_params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
from deepspeed_tpu_torch.ops import adam8bit as port8

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

SMALL = dict(vocab_size=500, n_embd=64, n_layer=2, n_head=2, n_positions=128)
B1, B2, EPS = 0.9, 0.999, 1e-8


@pytest.fixture(autouse=True)
def fresh_mesh():
    mesh_mod.set_mesh(None)
    yield
    mesh_mod.set_mesh(None)


def _codes_close(got, want, share=1e-3):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()


def _warm_leaf(rng, shape):
    """A leaf with moments already in it: random codes and row scales."""
    sshape = shape[:-1] + (1,)
    return dict(p=rng.standard_normal(shape).astype(np.float32),
                g=(0.1 * rng.standard_normal(shape)).astype(np.float32),
                mc=rng.integers(-127, 128, shape).astype(np.int8),
                rc=rng.integers(0, 256, shape).astype(np.uint8),
                scm=(1e-3 * rng.random(sshape) + 1e-4).astype(np.float32),
                scr=(1e-3 * rng.random(sshape) + 1e-4).astype(np.float32))


# ---------------------------------------------------------------------------
# the quantizers and one leaf step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (7,), (5, 33), (2, 3, 40)])
def test_quantizers_match_jax_exactly(shape):
    rng = np.random.default_rng(len(shape))
    x = np.asarray(rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 2, shape), np.float32)
    if len(shape) == 2:
        x[1] = 0.0                                      # a zero row: scale 1
    for port_q, jax_q, arr in ((port8._quant_sym, jax8._quant_sym, x),
                               (port8._quant_pos, jax8._quant_pos, np.abs(x))):
        codes, scale = port_q(torch.from_numpy(np.asarray(arr)))
        want_codes, want_scale = jax_q(jnp.asarray(arr))
        assert codes.dtype == {jax8._quant_sym: torch.int8, jax8._quant_pos: torch.uint8}[jax_q]
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))


def test_unfused_leaf_step_matches_jax():
    """One step of the port's unfused chain (decoupled decay, a constant lr)
    against ``scale_by_adam8bit`` → ``add_decayed_weights`` → lr, both from
    the same warm moments at count 3."""
    rng = np.random.default_rng(1)
    leaves = {"w": _warm_leaf(rng, (24, 96)), "b": _warm_leaf(rng, (96,))}
    lr, wd = 1e-3, 0.1
    tx = optax.chain(jax8.scale_by_adam8bit(B1, B2, EPS), optax.add_decayed_weights(wd),
                     optax.scale_by_learning_rate(lr))
    params = {k: jnp.asarray(v["p"]) for k, v in leaves.items()}
    st = tx.init(params)
    st = (jax8.Adam8bitState(
        count=jnp.int32(3), m_codes={k: jnp.asarray(v["mc"]) for k, v in leaves.items()},
        r_codes={k: jnp.asarray(v["rc"]) for k, v in leaves.items()},
        scales={k: {"m": jnp.asarray(v["scm"]), "r": jnp.asarray(v["scr"])}
                for k, v in leaves.items()}),) + st[1:]
    upd, new_st = tx.update({k: jnp.asarray(v["g"]) for k, v in leaves.items()}, st, params)
    want_p = optax.apply_updates(params, upd)

    names = list(leaves)
    ps = [torch.from_numpy(leaves[k]["p"].copy()) for k in names]
    opt = port8.Adam8bit(ps, lambda c: lr, B1, B2, EPS, weight_decay=wd, names=names)
    opt.load_state_dict({"count": 3, "m_codes": {k: v["mc"] for k, v in leaves.items()},
                         "r_codes": {k: v["rc"] for k, v in leaves.items()},
                         "scales": {k: {"m": v["scm"], "r": v["scr"]} for k, v in leaves.items()}})
    opt.update(ps, [torch.from_numpy(leaves[k]["g"].copy()) for k in names], torch.tensor(1.0))
    assert opt.count == int(new_st[0].count) == 4
    for i, k in enumerate(names):
        np.testing.assert_allclose(ps[i].numpy(), np.asarray(want_p[k]), rtol=1e-6, atol=1e-7)
        _codes_close(opt.m_codes[i].numpy(), new_st[0].m_codes[k])
        _codes_close(opt.r_codes[i].numpy(), new_st[0].r_codes[k])
        for w in "mr":
            np.testing.assert_allclose(opt.scales[i][w].numpy(),
                                       np.asarray(new_st[0].scales[k][w]), rtol=1e-6)


@pytest.mark.parametrize("shape", [(40, 96), (96,), (2, 24, 48)])
def test_fused_plain_matches_pallas_interpret(shape):
    """The kernel's plain version (and the wrapper's CPU path, in place)
    against the Pallas kernel in interpret mode: clip scale 0.5, L2 0.01 and
    decoupled decay 0.1 together, lr 1e-3, count 5."""
    leaf = _warm_leaf(np.random.default_rng(len(shape) + 10), shape)
    c1, c2 = 1 - B1 ** 5, 1 - B2 ** 5
    scalars = np.array([0.5, 1e-3, c1, c2], np.float32)
    hyper = dict(b1=B1, b2=B2, eps=EPS, wd=0.1, l2=0.01)
    want = apply_fused_leaf(*(jnp.asarray(leaf[k]) for k in ("g", "p", "mc", "rc")),
                            {"m": jnp.asarray(leaf["scm"]), "r": jnp.asarray(leaf["scr"])},
                            jnp.asarray(scalars), interpret=True, **hyper)
    want = [np.asarray(want[0]), np.asarray(want[1]), np.asarray(want[2]),
            np.asarray(want[3]["m"]), np.asarray(want[3]["r"])]
    rows = {k: torch.from_numpy(v.copy()).reshape(-1, shape[-1] if k in ("g", "p", "mc", "rc")
                                                  else 1) for k, v in leaf.items()}
    got = port8.adam8bit_leaf_plain(rows["g"], rows["p"], rows["mc"], rows["rc"], rows["scm"],
                                    rows["scr"], torch.from_numpy(scalars), **hyper)
    port8.adam8bit_update(rows["g"], rows["p"], rows["mc"], rows["rc"], rows["scm"],
                          rows["scr"], torch.from_numpy(scalars), **hyper)
    in_place = [rows[k] for k in ("p", "mc", "rc", "scm", "scr")]
    for g_, ip, w in zip(got, in_place, want):
        torch.testing.assert_close(ip, g_, rtol=0, atol=0)
        g_ = g_.numpy().reshape(w.shape)
        if w.dtype in (np.int8, np.uint8):
            _codes_close(g_, w)
        else:
            np.testing.assert_allclose(g_, w, rtol=1e-6, atol=1e-7)


def test_fused_plain_agrees_with_the_optax_formula():
    """The two formulas (kernel: m·(1/c1) / (r·(1/√c2) + eps), codes from
    m·(127/amax); chain: (m/c1) / (√(v/c2) + eps), codes from m/scale) on the
    same leaf: params rtol 1e-6, codes off by one on ≤ 0.1%."""
    leaf = _warm_leaf(np.random.default_rng(3), (64, 200))
    t = {k: torch.from_numpy(v) for k, v in leaf.items()}
    c1, c2 = 1 - B1 ** 7, 1 - B2 ** 7
    p1, mc1, rc1, *_ = port8.adam8bit_leaf_plain(
        t["g"], t["p"], t["mc"], t["rc"], t["scm"], t["scr"],
        torch.tensor([1.0, 1e-3, c1, c2]), b1=B1, b2=B2, eps=EPS)
    upd, mc2, rc2, _ = port8._leaf_moments(t["g"], t["mc"], t["rc"],
                                           {"m": t["scm"], "r": t["scr"]}, b1=B1, b2=B2,
                                           c1=float(np.float32(c1)), c2=float(np.float32(c2)),
                                           eps=EPS)
    np.testing.assert_allclose(p1.numpy(), (t["p"] - 1e-3 * upd).numpy(), rtol=1e-6, atol=1e-7)
    _codes_close(mc1.numpy(), mc2.numpy())
    _codes_close(rc1.numpy(), rc2.numpy())


def test_state_bytes_are_two_per_param_and_eight_per_row():
    model = GPT2LMHeadModel(gpt2_config("gpt2-tiny", dtype=torch.float32))
    params = list(model.parameters())
    opt = port8.Adam8bit(params, lambda c: 1e-3, B1, B2, EPS)
    n = sum(p.numel() for p in params)
    rows = sum(p.numel() // p.shape[-1] for p in params)
    assert opt.state_bytes() == 2 * n + 8 * rows
    assert opt.m_codes[0].dtype == torch.int8 and opt.r_codes[0].dtype == torch.uint8
    assert opt.scales[0]["m"].shape == params[0].shape[:-1] + (1,)


# ---------------------------------------------------------------------------
# the state converter and the engine against the JAX engine
# ---------------------------------------------------------------------------

def _unbox(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(getattr(x, "value", x)), tree,
                                  is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL))
    return _unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _config(opt_type, fused, wd=0.1):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": opt_type, "params": {"lr": 1e-3, "weight_decay": wd,
                                                       "fused": fused}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                         "warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 4}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
            "steps_per_print": 1000}


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"input_ids": ids, "labels": ids} for ids in
            (rng.integers(0, SMALL["vocab_size"], size=(4, 128)).astype(np.int32)
             for _ in range(n))]


def test_state_converter_takes_both_layouts(flax_params):
    """A scanned state and the same state unscanned (``h_0 … h_{L-1}``)
    convert to the same port state; scales keep their (…, 1) rows."""
    cfg = gpt2_config("gpt2-125m", dtype=torch.float32, **SMALL)
    rng = np.random.default_rng(4)
    scanned = jax8.scale_by_adam8bit().init(flax_params)
    scanned = jax.tree_util.tree_map(
        lambda x: (rng.integers(0, 100, x.shape).astype(x.dtype) if x.dtype != np.float32
                   else rng.random(x.shape).astype(np.float32)), _unbox(scanned))

    def unscan(tree):
        out = {k: v for k, v in tree.items() if k != "h"}
        for i in range(SMALL["n_layer"]):
            out[f"h_{i}"] = jax.tree_util.tree_map(lambda x: x[i], tree["h"])
        return out

    flat = jax8.Adam8bitState(count=scanned.count, m_codes=unscan(scanned.m_codes),
                              r_codes=unscan(scanned.r_codes), scales=unscan(scanned.scales))
    a, b = adam8bit_state_from_jax(scanned, cfg), adam8bit_state_from_jax(flat, cfg)
    assert a["count"] == b["count"]
    for key in ("m_codes", "r_codes"):
        for name, t in a[key].items():
            torch.testing.assert_close(t, b[key][name], rtol=0, atol=0)
    for name, sc in a["scales"].items():
        assert sc["m"].shape[-1] == 1 and sc["m"].dtype == torch.float32
        torch.testing.assert_close(sc["r"], b["scales"][name]["r"], rtol=0, atol=0)
    np.testing.assert_array_equal(a["m_codes"]["h.1.mlp.c_fc_kernel"].numpy(),
                                  np.asarray(scanned.m_codes["h"]["mlp"]["c_fc_kernel"][1]))


# the chunked head, whose wte gradient is a transposed view
HEAD = dict(loss_chunk=96)


def _jax_engine(params, config):
    cfg = flax_config("gpt2-125m", dtype=jnp.float32, **SMALL, **HEAD)
    mesh = mesh_mod.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    eng, *_ = deepspeed_tpu.initialize(model=FlaxGPT2(cfg), config=config, mesh=mesh)
    eng.init_params(params=params)
    seen = []
    eng._maybe_print = lambda m: seen.append(jax.device_get(m))
    return eng, seen


@pytest.mark.parametrize("opt_type,fused", [("adamw8bit", False), ("adamw8bit", True),
                                            ("adam8bit", False)])
def test_engine_steps_match_jax(flax_params, opt_type, fused):
    config = _config(opt_type, fused)
    batches = _batches(5, seed=21)
    with mock.patch.dict(os.environ, {recompile.WATCHDOG_ENV: "0"}):
        jeng, seen = _jax_engine(flax_params, config)
        assert (jeng._fused_opt is not None) == fused
        jeng.train_batch(batches[0])                    # moments in the state
        params = jax.device_get(jeng.params)
        state = jax.device_get(jax8._find_state(jeng.state.opt_state))
        jax_losses = [float(jeng.train_batch(b)) for b in batches[1:]]
        jstate = jax.device_get(jax8._find_state(jeng.state.opt_state))

    eng, *_ = ds.initialize(model=GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32,
                                                              **SMALL, **HEAD)),
                            config=config, device="cpu")
    assert (eng._fused_opt is not None) == fused
    assert isinstance(eng.optimizer, port8.Adam8bit)
    assert (eng.optimizer.l2 > 0) == (opt_type == "adam8bit")
    eng.init_params(params=params)
    eng.optimizer.load_state_dict(adam8bit_state_from_jax(state, eng.model_cfg))
    eng.global_steps = 1
    losses, metrics = [], []
    for b in batches[1:]:
        losses.append(float(eng.train_batch(b)))
        metrics.append(eng.metrics)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in metrics],
                               [float(m["grad_norm"]) for m in seen[1:]], rtol=1e-5)
    np.testing.assert_allclose([m["lr"] for m in metrics], [float(m["lr"]) for m in seen[1:]],
                               rtol=1e-6)
    want = gpt2_params_from_jax(jax.device_get(jeng.params), eng.model_cfg)
    lr_max = max(m["lr"] for m in metrics)
    want_state = adam8bit_state_from_jax(jstate, eng.model_cfg)
    got_state = eng.optimizer.state_dict()
    assert got_state["count"] == want_state["count"] == 5
    E = SMALL["n_embd"]
    close, codes_m, codes_r, want_m, want_r, sc_got, sc_want = [], [], [], [], [], [], []
    for name, p in eng.params.items():
        got, ref = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=lr_max / 4, err_msg=name)
        ok = np.isclose(got, ref, rtol=1e-6, atol=1e-7)
        if name.endswith("c_attn_bias"):     # the key-bias third: noise gradients
            ok = np.delete(ok, np.s_[E:2 * E])
        close.append(ok.ravel())
        for acc, key, src in ((codes_m, "m_codes", got_state), (want_m, "m_codes", want_state),
                              (codes_r, "r_codes", got_state), (want_r, "r_codes", want_state)):
            acc.append(src[key][name].numpy().ravel())
        for w in "mr":
            sc_got.append(got_state["scales"][name][w].numpy().ravel())
            sc_want.append(want_state["scales"][name][w].numpy().ravel())
    assert np.concatenate(close).mean() >= 0.999
    _codes_close(np.concatenate(codes_m), np.concatenate(want_m))
    _codes_close(np.concatenate(codes_r), np.concatenate(want_r))
    sc_got, sc_want = np.concatenate(sc_got), np.concatenate(sc_want)
    np.testing.assert_allclose(sc_got, sc_want, rtol=1 / 100)
    assert np.isclose(sc_got, sc_want, rtol=1e-5, atol=0).mean() >= 0.99


def test_fp16_skipped_step_freezes_the_state(flax_params):
    """An overflowing fp16 step (a NaN position embedding that only S=128
    reads) leaves the count, codes, scales and LR where they were; the next
    clean step (S=64) moves them."""
    params = jax.tree_util.tree_map(np.array, flax_params)
    params["wpe"][100] = np.nan
    config = {**_config("adamw8bit", True), "fp16": {"enabled": True, "hysteresis": 1}}
    eng, *_ = ds.initialize(model=GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32,
                                                              **SMALL)),
                            config=config, device="cpu")
    eng.init_params(params=params)
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in eng.optimizer.state_dict()["m_codes"].items()}
    eng.train_batch(_batches(1, seed=5)[0])
    assert eng.metrics["overflow"] and eng.optimizer.count == 0
    assert all(torch.equal(before[k], v) for k, v in eng.optimizer.state_dict()["m_codes"].items())
    assert all(bool((s["m"] == 1).all()) for s in eng.optimizer.scales)
    lr0 = eng.metrics["lr"]
    ids = _batches(1, seed=6)[0]["input_ids"][:, :64]
    eng.train_batch({"input_ids": ids, "labels": ids})
    assert not eng.metrics["overflow"] and eng.optimizer.count == 1
    assert eng.metrics["lr"] == lr0
    assert any(bool((v != 0).any()) for v in eng.optimizer.m_codes)
