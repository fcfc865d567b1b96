"""Single-device training in the port against the JAX package, on the CPU.

Config parsing and batch arithmetic against JAX's ``Config``; the four LR
schedules and the fp16 loss-scale state machine against JAX's functions;
the chunked CE head and the GPT-2 loss with its gradients against JAX on
the same weights; and the engine gate: K = 4 ``train_batch`` steps (adamw,
clipping 1.0, ``WarmupDecayLR``, gradient accumulation 2) whose losses,
grad norms, LRs and final parameters match the JAX ``Engine``'s. Then the
port's own equivalences (three-call path, ``train_batches``, remat) and
refusals (the device rule, every unported option).

Small model (E=128, 2 layers, 2 heads of 64, S=128 so that the port's
flash path engages, vocab 500 padded to 512), fp32. Tolerances: losses and
gradients rtol 1e-5 / atol 1e-6 (fp32 sums in another order); engine
losses, grad norms, LRs and parameters rtol 1e-4 with atol 1e-6 (four Adam
steps amplify last-bit gradient differences; the key biases, whose gradient
is rounding noise, at atol 1e-5); LRs rtol 1e-6 (float64 host
arithmetic against JAX's float32).
"""
import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch as ds
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.models import common as jax_common
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_config
from deepspeed_tpu.runtime import config as jax_config
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import precision as jax_precision
from deepspeed_tpu.telemetry import recompile
from deepspeed_tpu_torch.models import common
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
from deepspeed_tpu_torch.runtime import config as port_config
from deepspeed_tpu_torch.runtime import lr_schedules as port_lr
from deepspeed_tpu_torch.runtime import precision as port_precision

SMALL = dict(vocab_size=500, n_embd=128, n_layer=2, n_head=2, n_positions=128)
S = 128
GATE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupDecayLR",
                      "params": {"total_num_steps": 8, "warmup_num_steps": 3,
                                 "warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3}},
        "gradient_clipping": 1.0, "zero_optimization": {"stage": 1}, "steps_per_print": 1000}


@pytest.fixture(autouse=True)
def fresh_mesh():
    mesh_mod.set_mesh(None)
    yield
    mesh_mod.set_mesh(None)


def _unbox(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(getattr(x, "value", x)), tree,
                                  is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL))
    return _unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _batches(n, rows, seed=0, seq=S):
    rng = np.random.default_rng(seed)
    return [{"input_ids": ids, "labels": ids} for ids in
            (rng.integers(0, SMALL["vocab_size"], size=(rows, seq)).astype(np.int32)
             for _ in range(n))]


def _port_model(**over):
    return GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32, **{**SMALL, **over}))


def _jax_run(params, config, batches, **over):
    """Losses and per-step metrics of the JAX engine on one device. Its
    recompile watchdog is off: a reference run that changes S on purpose
    must not count as a hot-loop recompile in the process's registry."""
    cfg = flax_config("gpt2-125m", dtype=jnp.float32, **{**SMALL, **over})
    mesh = mesh_mod.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    with mock.patch.dict(os.environ, {recompile.WATCHDOG_ENV: "0"}):
        eng, *_ = deepspeed_tpu.initialize(model=FlaxGPT2(cfg), config=config, mesh=mesh)
        eng.init_params(params=params)
        seen = []
        eng._maybe_print = lambda m: seen.append(jax.device_get(m))
        losses = [float(eng.train_batch(b)) for b in batches]
    return losses, seen, eng


def _port_engine(params, config, **over):
    eng, *_ = ds.initialize(model=_port_model(**over), config=config, device="cpu")
    eng.init_params(params=params)
    return eng


# ---------------------------------------------------------------------------
# config, schedules, loss scale
# ---------------------------------------------------------------------------

def test_typo_key_raises_config_error():
    for mod in (jax_config, port_config):
        with pytest.raises(mod.ConfigError, match="gradient_acumulation_steps"):
            mod.Config.from_dict({"train_batch_size": 8, "gradient_acumulation_steps": 2})
    cfg = port_config.Config.from_dict({"fp16": {"enabled": True}})
    assert cfg.dtype == torch.float16 and not cfg.bf16.enabled
    assert port_config.Config.from_dict({}).dtype == torch.bfloat16


@pytest.mark.parametrize("triple", [(8, 2, 4), (8, 2, 0), (8, 0, 4), (0, 2, 4), (8, 0, 0),
                                    (0, 3, 0), (8, 3, 0), (8, 2, 3), (0, 0, 2), (9, 0, 2)])
def test_resolve_batch_matches_jax(triple):
    d = dict(zip(("train_batch_size", "train_micro_batch_size_per_gpu",
                  "gradient_accumulation_steps"), triple))
    results = []
    for mod in (jax_config, port_config):
        cfg = mod.Config.from_dict({k: v for k, v in d.items() if v})
        try:
            cfg.resolve_batch(1)
            results.append((cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
                            cfg.gradient_accumulation_steps))
        except mod.ConfigError:
            results.append("ConfigError")
    assert results[0] == results[1]


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3, warmup_num_steps=10)),
    ("WarmupLR", dict(warmup_max_lr=2e-3, warmup_num_steps=7, warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=30, warmup_min_lr=0.0, warmup_max_lr=1e-3,
                           warmup_num_steps=5)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3, cycle_first_step_size=8,
                      cycle_second_step_size=6, decay_step_size=3, decay_lr_rate=0.5)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=4,
                         lr_range_test_step_rate=2.0, lr_range_test_staircase=True)),
    (None, {}),
])
def test_lr_schedules_match_jax(name, params):
    want = jax_lr.get_lr_schedule(name, params, base_lr=3e-4)
    got = port_lr.get_lr_schedule(name, params, base_lr=3e-4)
    steps = np.arange(40)
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               [float(want(jnp.int32(s))) for s in steps], rtol=1e-6, atol=0)


def test_loss_scale_transitions_match_jax():
    cfg = dict(enabled=True, initial_scale_power=10, loss_scale_window=3, hysteresis=2,
               min_loss_scale=64.0)
    jc, pc = jax_config.Float16Config(**cfg), port_config.Float16Config(**cfg)
    js, ps = jax_precision.init_loss_scale(jc), port_precision.init_loss_scale(pc)
    flags = np.random.default_rng(0).random(60) < 0.6
    for f in flags:
        js = jax_precision.update_loss_scale(js, jnp.bool_(f), jc)
        ps = port_precision.update_loss_scale(ps, bool(f), pc)
        assert (ps.scale, ps.good_steps, ps.hysteresis) == (
            float(js.scale), int(js.good_steps), int(js.hysteresis))
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(port_precision.grads_finite(grads))
    assert bool(port_precision.grads_finite(grads[:1]))


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

def _head_inputs(seed=0, B=2, T=37, E=16, V=100, Vp=128):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, E)).astype(np.float32)
    wte = (0.3 * rng.standard_normal((Vp, E))).astype(np.float32)
    labels = rng.integers(0, V, size=(B, T)).astype(np.int32)
    labels[0, :5] = -100
    return h, wte, labels


@pytest.mark.parametrize("chunk", [7, 74, 100])      # N = 74 tokens: chunks of 7, N, > N
@pytest.mark.parametrize("save_logits", [False, True])
def test_chunked_lm_loss_matches_jax(chunk, save_logits):
    h, wte, labels = _head_inputs()
    kw = dict(vocab_size=100, padded_vocab_size=128, chunk=chunk, save_logits=save_logits)
    want, (wdh, wdw) = jax.value_and_grad(
        lambda h, w: jax_common.chunked_lm_loss(h, w, jnp.asarray(labels), dtype=jnp.float32,
                                                **kw), argnums=(0, 1))(jnp.asarray(h),
                                                                       jnp.asarray(wte))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(wte).requires_grad_()
    got = common.chunked_lm_loss(th, tw, torch.from_numpy(labels), dtype=torch.float32, **kw)
    dh, dw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(dh.numpy(), np.asarray(wdh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(wdw), rtol=1e-5, atol=1e-6)
    assert dw[100:].abs().max() == 0   # padded vocab rows
    # the same loss and gradients as the dense head
    logits = th @ tw.T
    logits = torch.cat([logits[..., :100], torch.full_like(logits[..., 100:],
                                                           torch.finfo(torch.float32).min)], -1)
    dense = common.cross_entropy_loss(logits, torch.from_numpy(labels).long())
    ddh, ddw = torch.autograd.grad(dense, (th, tw))
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-5)
    np.testing.assert_allclose(dh.numpy(), ddh.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), ddw.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_and_shift_match_jax(z_loss):
    h, wte, labels = _head_inputs(seed=1)
    logits = h @ wte.T
    want = jax_common.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    got = common.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                    z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_array_equal(common.shift_labels(torch.from_numpy(labels)).numpy(),
                                  np.asarray(jax_common.shift_labels(jnp.asarray(labels))))


@pytest.mark.parametrize("loss_chunk", [None, 100])
def test_gpt2_loss_and_grads_match_flax(flax_params, loss_chunk):
    ids = _batches(1, 2, seed=3)[0]["input_ids"]
    cfg = flax_config("gpt2-125m", dtype=jnp.float32, loss_chunk=loss_chunk, **SMALL)

    def loss_fn(p):
        return FlaxGPT2(cfg).apply({"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids))["loss"]

    want, wgrads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, flax_params))
    model = _port_model(loss_chunk=loss_chunk)
    model.load_state_dict(gpt2_params_from_jax(flax_params, model.cfg))
    out = model(torch.from_numpy(ids).long(), labels=torch.from_numpy(ids).long())
    assert set(out) == ({"loss"} if loss_chunk else {"logits", "loss"})
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(out["loss"], params)))
    np.testing.assert_allclose(float(out["loss"]), float(want), rtol=1e-5)
    wgrads = gpt2_params_from_jax(jax.device_get(wgrads), model.cfg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), wgrads[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert grads["wte"][SMALL["vocab_size"]:].abs().max() == 0   # padded vocab rows


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

def test_engine_gate_matches_jax(flax_params):
    batches = _batches(4, 4, seed=11)
    jax_losses, jax_metrics, jax_eng = _jax_run(flax_params, GATE, batches)
    eng = _port_engine(flax_params, GATE)
    losses, metrics = [], []
    for b in batches:
        loss = eng.train_batch(b)
        assert loss.dim() == 0
        losses.append(float(loss))
        metrics.append(eng.metrics)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in metrics],
                               [float(m["grad_norm"]) for m in jax_metrics], rtol=1e-4)
    np.testing.assert_allclose([m["lr"] for m in metrics],
                               [float(m["lr"]) for m in jax_metrics], rtol=1e-6)
    assert (eng.global_steps, eng.micro_steps, eng.global_samples, eng.skipped_steps) == (
        jax_eng.global_steps, jax_eng.micro_steps, jax_eng.global_samples,
        jax_eng.skipped_steps) == (4, 8, 16, 0)
    _assert_params_match(eng, jax_eng)


def _assert_params_match(eng, jax_eng):
    """rtol 1e-4 / atol 1e-6, except the key-bias third of each c_attn_bias:
    softmax ignores a shift shared by a row's scores, so its gradient is
    zero but for rounding noise (~1e-10), which Adam's eps (1e-8) turns into
    steps of ~1e-2 lr that the two engines take differently."""
    want = gpt2_params_from_jax(jax.device_get(jax_eng.params), eng.model_cfg)
    E = eng.model_cfg.n_embd
    for name, p in eng.params.items():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("c_attn_bias"):
            np.testing.assert_allclose(got[E:2 * E], ref[E:2 * E], rtol=0, atol=1e-5,
                                       err_msg=name)
            got, ref = np.delete(got, np.s_[E:2 * E]), np.delete(ref, np.s_[E:2 * E])
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=name)


def test_bf16_grad_accumulation_matches_jax(flax_params):
    """grad_accum_dtype bf16 with gas 2, two steps, against the JAX Engine.
    The masters start at bf16 values, so JAX's bf16 cast of them (it
    differentiates with respect to the cast) is exact at step 1, and both
    engines round the same fp32 gradients into bf16 buffers. They differ
    where a gradient's last fp32 bits (sums in another order) tip its bf16
    rounding, one bf16 ulp (2^-8 relative) on a few elements: grad norms
    rtol 1e-3; losses rtol 1e-5 (step 2's masters moved by < 1 bf16 ulp of
    most weights, which JAX's forward sees rounded); parameters: where a
    tipped or noise-sized gradient flips Adam's step (about lr·sign(g)),
    the engines differ by up to 2·lr per step, so every element within
    2·Σlr and 99% of each leaf within rtol 1e-4 / atol 1e-6. The port's
    own arithmetic is held exactly: each micro-batch's fp32 gradient cast
    to bf16, summed in bf16, divided by gas in fp32."""
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), flax_params)
    config = {**GATE, "data_types": {"grad_accum_dtype": "bf16"}}
    batches = _batches(2, 4, seed=13)
    jax_losses, jax_metrics, jax_eng = _jax_run(params, config, batches)

    ref = _port_engine(params, config)
    g1, g2 = (ref._grads_of(ref._to_device({k: v[i * 2:(i + 1) * 2] for k, v in
                                           batches[0].items()}))[1] for i in range(2))

    def norm(acc):
        return float(torch.linalg.vector_norm(torch.stack([(g.float() / 2).norm() for g in acc])))

    want_bf16 = norm([a.bfloat16() + b.bfloat16() for a, b in zip(g1, g2)])
    want_fp32 = norm([a + b for a, b in zip(g1, g2)])
    assert abs(want_bf16 / want_fp32 - 1) > 1e-6      # the check below tells them apart

    eng = _port_engine(params, config)
    losses, metrics = [], []
    for b in batches:
        losses.append(float(eng.train_batch(b)))
        metrics.append(eng.metrics)
    np.testing.assert_allclose(float(metrics[0]["grad_norm"]), want_bf16, rtol=1e-6)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in metrics],
                               [float(m["grad_norm"]) for m in jax_metrics], rtol=1e-3)
    want = gpt2_params_from_jax(jax.device_get(jax_eng.params), eng.model_cfg)
    atol = 2 * sum(m["lr"] for m in metrics)
    for name, p in eng.params.items():
        got, ref_p = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got, ref_p, rtol=0, atol=atol, err_msg=name)
        close = np.isclose(got, ref_p, rtol=1e-4, atol=1e-6)
        if name.endswith("c_attn_bias"):   # the key-bias third: noise gradients
            close = np.delete(close, np.s_[eng.model_cfg.n_embd:2 * eng.model_cfg.n_embd])
        assert close.mean() >= 0.99, (name, close.mean())


def test_fp16_skip_and_halve_matches_jax(flax_params):
    # position 100's embedding is NaN: the S=128 batches give non-finite
    # gradients (skip the step, halve the scale), the S=64 batches never
    # read it; after a window of 2 clean steps the scale doubles back
    params = jax.tree_util.tree_map(np.array, flax_params)
    params["wpe"][100] = np.nan
    config = {**GATE, "fp16": {"enabled": True, "initial_scale_power": 16, "hysteresis": 1,
                               "loss_scale_window": 2}}
    batches = [_batches(1, 4, seed=12 + i, seq=seq)[0] for i, seq in enumerate((128, 64, 64, 128))]
    jax_losses, jax_metrics, jax_eng = _jax_run(params, config, batches)
    eng = _port_engine(params, config)
    losses, metrics = [], []
    for b in batches:
        losses.append(float(eng.train_batch(b)))
        metrics.append(eng.metrics)
    overflow = [bool(m["overflow"]) for m in metrics]
    assert overflow == [bool(m["overflow"]) for m in jax_metrics] == [True, False, False, True]
    assert [m["loss_scale"] for m in metrics] == [float(m["loss_scale"]) for m in jax_metrics]
    assert eng.loss_scale.scale == float(jax_eng.state.loss_scale.scale) == 2.0 ** 15
    assert eng.skipped_steps == jax_eng.skipped_steps == 2
    np.testing.assert_allclose([m["lr"] for m in metrics],
                               [float(m["lr"]) for m in jax_metrics], rtol=1e-6)
    fin = [not o for o in overflow]
    np.testing.assert_allclose(np.array(losses)[fin], np.array(jax_losses)[fin], rtol=1e-4)
    _assert_params_match(eng, jax_eng)


# ---------------------------------------------------------------------------
# the port's own equivalences
# ---------------------------------------------------------------------------

def _state(eng):
    return {k: v.detach().clone() for k, v in eng.params.items()}


def test_three_call_path_equals_train_batch(flax_params):
    batch = _batches(1, 4, seed=5)[0]
    a, b = _port_engine(flax_params, GATE), _port_engine(flax_params, GATE)
    loss = a.train_batch(batch)
    micro = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]
    steps = []
    for mb in micro:
        b.forward(mb)
        b.backward()
        steps.append(b.step())
    assert steps[0] is None       # not at the accumulation boundary yet
    metrics = steps[1]
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(a.metrics["grad_norm"]),
                               rtol=1e-6)
    for (name, p), q in zip(_state(a).items(), _state(b).values()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)
    assert (b.global_steps, b.micro_steps) == (1, 2)
    with pytest.raises(RuntimeError, match="backward"):
        b.backward()


def test_train_batches_equals_repeated_calls(flax_params):
    batches = _batches(3, 4, seed=6)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    a, b = _port_engine(flax_params, GATE), _port_engine(flax_params, GATE)
    losses = a.train_batches(stacked, 3)
    want = torch.stack([b.train_batch(x) for x in batches])
    assert losses.shape == (3,)
    # the same arithmetic; the CPU's BLAS may block views of the stacked
    # batch differently, so allow last-bit differences
    torch.testing.assert_close(losses, want, rtol=1e-6, atol=0)
    for p, q in zip(_state(a).values(), _state(b).values()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
    assert a.global_steps == b.global_steps == 3
    with pytest.raises(ValueError, match="stacked"):
        a.train_batches(batches[0], 4)    # 4 == train_batch_size: ambiguous


def test_remat_gives_the_same_gradients(flax_params):
    mb = {k: torch.from_numpy(v[:2]).long() for k, v in _batches(1, 2, seed=7)[0].items()}
    plain = _port_engine(flax_params, GATE)
    remat = _port_engine(flax_params, {**GATE, "activation_checkpointing": {"enabled": True}})
    assert remat.model_cfg.remat and not plain.model_cfg.remat
    l1, g1 = plain._grads_of(mb)
    l2, g2 = remat._grads_of(mb)
    assert float(l1) == float(l2)
    for x, y in zip(g1, g2):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="A3"):
        _port_engine(flax_params, {**GATE, "activation_checkpointing": {"policy": "dots_saveable"}})


def test_init_params_takes_a_state_dict_and_eval_matches(flax_params):
    a = _port_engine(flax_params, GATE)
    b = _port_engine(a.params, GATE)          # the port's own state dict
    for p, q in zip(_state(a).values(), _state(b).values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    batch = _batches(1, 2, seed=9)[0]
    ids = torch.from_numpy(batch["input_ids"]).long()
    with torch.no_grad():
        want = a.module(ids, labels=ids)["loss"]
    torch.testing.assert_close(b.eval_batch(batch), want, rtol=0, atol=0)
    b.init_params()                            # already initialised: a no-op
    torch.testing.assert_close(b.params["wte"], a.params["wte"], rtol=0, atol=0)


@pytest.mark.parametrize("loss_chunk", [None, 64])
def test_padded_vocab_columns_get_zero_gradient(loss_chunk):
    model = _port_model(loss_chunk=loss_chunk).init_weights(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_batches(1, 2, seed=8)[0]["input_ids"]).long()
    (g,) = torch.autograd.grad(model(ids, labels=ids)["loss"], [model.wte])
    assert g[SMALL["vocab_size"]:].abs().max() == 0 and g[:SMALL["vocab_size"]].abs().max() > 0


def test_engine_trains_the_weights_a_model_carries(flax_params):
    """A model given values (``load_state_dict`` or ``init_weights``) hands
    them to the engine; a bare or meta model is a template."""
    src = _port_engine(flax_params, GATE)
    model = _port_model()
    model.load_state_dict(src.params)
    eng, *_ = ds.initialize(model=model, config=GATE, device="cpu")
    eng.init_params()                  # already set from the model: a no-op
    for name, p in eng.params.items():
        torch.testing.assert_close(p, src.params[name], rtol=0, atol=0, msg=name)
    seeded = _port_model().init_weights(torch.Generator().manual_seed(5))
    eng, *_ = ds.initialize(model=seeded, config=GATE, device="cpu")
    torch.testing.assert_close(eng.params["wte"], seeded.wte, rtol=0, atol=0)
    bare, *_ = ds.initialize(model=_port_model(), config=GATE, device="cpu")
    assert not bare._initialized


def test_initialize_stays_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.initialize(model=_port_model(), config=GATE)
    eng, opt, loader, sched = ds.initialize(model=_port_model(), config=GATE, device="cpu")
    assert eng.device.type == "cpu" and opt is eng.optimizer and loader is None
    assert sched is eng.lr_scheduler and sched(3) == pytest.approx(1e-3)
    with pytest.raises(RuntimeError, match="init_params"):
        eng.train_batch(_batches(1, 4)[0])
    eng.init_params()     # torch.Generator(seed): the flax initialisers, not flax's values
    assert float(eng.params["h.0.ln_1.scale"].mean()) == 1.0


@pytest.mark.parametrize("change", [
    {"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}}},
    {"optimizer": {"type": "onebitadam", "params": {"comm_backend": "compressed"}}},
    {"pipeline": {"schedule": "1f1b"}},
    {"mesh": {"dp": 2}},
    {"mesh": {"pp": 2, "dp": -1}},
    {"sparse_gradients": True},
    {"curriculum_learning": {"enabled": True}},
    {"progressive_layer_drop": {"enabled": True}},
    {"quantize_training": {"enabled": True}},
    {"tensorboard": {"enabled": True}},
    {"activation_checkpointing": {"cpu_checkpointing": True}},
    {"optimizer": {"type": "adamw8bit"}}, {"optimizer": {"type": "lamb"}},
    {"optimizer": {"type": "sgd"}}, {"optimizer": {"type": "adagrad"}},
    {"optimizer": {"type": "lion"}}, {"optimizer": {"type": "zerooneadam"}},
])
def test_unported_options_raise(change):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ds.initialize(model=_port_model(), config={**GATE, **change}, device="cpu")


@pytest.mark.parametrize("kw", [dict(optimizer=object()), dict(training_data=[1, 2]),
                                dict(loss_fn=lambda *a: 0), dict(mesh=object())])
def test_unported_arguments_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ds.initialize(model=_port_model(), config=GATE, device="cpu", **kw)


@pytest.mark.parametrize("over", [dict(attn_pdrop=0.1), dict(embd_pdrop=0.1),
                                  dict(resid_pdrop=0.1), dict(moe={"num_experts": 2}),
                                  dict(fused_mlp=True), dict(loss_pallas=True)])
def test_unported_model_options_raise(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gpt2_config("gpt2-tiny", **over)


def test_data_iter_raises(flax_params):
    eng = _port_engine(flax_params, GATE)
    with pytest.raises(NotImplementedError, match="A7"):
        eng.train_batch(data_iter=iter(_batches(2, 2)))


def test_model_helpers_match_flax():
    cfg = flax_config("gpt2-125m")
    model = GPT2LMHeadModel(gpt2_config("gpt2-125m"), device="meta")
    assert model.flops_per_token() == FlaxGPT2(cfg).flops_per_token()
    d = model.dummy_inputs(batch_size=3)
    assert d["input_ids"].shape == (3, 128) and d["labels"] is d["input_ids"]
    assert dataclasses.replace(model.cfg, loss_chunk=8).loss_chunk == 8
