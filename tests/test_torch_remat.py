"""Activation checkpointing policies of the port (``models/common.py
resolve_remat_policy``) against remat off and against the JAX model, on
the CPU.

Every ported policy (the six bases of ``REMAT_BASES``, each with and
without ``+flash``) leaves the loss and every gradient as they are with
remat off (fp32: rtol 1e-6 / atol 1e-7, the same operations, recomputed)
and as the JAX model computes them under the same policy (rtol 1e-5 / atol
1e-6, as the GPT-2 gradient test: sums in another order). On the CPU the
JAX model runs dense attention, so ``+flash`` names nothing there and the
base policy's program stands for both.

What backward recomputes is counted by a dispatch mode, as backward with a
policy minus backward with remat off, op by op: the dot-saving policies
recompute no ``mm``; ``nothing_saveable`` recomputes every ``mm`` of the
block (with the checkpoint's early stop off, which would otherwise skip
the block's last product, whose output backward never reads); the flash
forward op runs once more per layer without ``+flash`` and not at all with
it; on dense attention ``dots_saveable`` keeps the batched products
(``bmm``) that ``dots_with_no_batch_dims_saveable`` recomputes.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu_torch as ds
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_config
from deepspeed_tpu_torch.models.common import REMAT_BASES, resolve_remat_policy
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

SMALL = dict(vocab_size=500, n_embd=128, n_layer=2, n_head=2, n_positions=128)  # D = 64, S = 128
POLICIES = [b + s for b in REMAT_BASES for s in ("", "+flash")]
FLASH = "ds_tpu_torch.flash_attention_fwd"


def _unbox(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(getattr(x, "value", x)), tree,
                                  is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL))
    return _unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(1).integers(0, SMALL["vocab_size"], (2, 128)).astype(np.int32)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _port(flax_params, ids, policy=None, attn="auto"):
    """(loss, {name: grad}, backward op counts) of the port's GPT-2."""
    over = dict(remat=True, remat_policy=policy) if policy else {}
    model = GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32, attn_impl=attn,
                                        **SMALL, **over))
    model.load_state_dict(gpt2_params_from_jax(flax_params, model.cfg))
    t = torch.from_numpy(ids).long()
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):   # read in forward
        loss = model(t, labels=t)["loss"]
    names, params = zip(*model.named_parameters())
    mode = _OpCount()
    with mode:
        grads = torch.autograd.grad(loss, params)
    return float(loss), dict(zip(names, grads)), mode.counts


@pytest.fixture(scope="module")
def jax_ref(flax_params, ids):
    """(loss, grads) of the JAX model under a base policy, built once for
    each distinct policy (``checkpoint_dots*`` are JAX's aliases of the
    ``dots*_saveable`` policies)."""
    cache = {}

    def get(base):
        base = {"checkpoint_dots": "dots_saveable",
                "checkpoint_dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable"}.get(
                    base, base)
        if base not in cache:
            cfg = flax_config("gpt2-125m", dtype=jnp.float32, remat=True, remat_policy=base,
                              **SMALL)
            fn = jax.jit(jax.value_and_grad(lambda p: FlaxGPT2(cfg).apply(
                {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids))["loss"]))
            loss, grads = fn(jax.tree_util.tree_map(jnp.asarray, flax_params))
            cache[base] = float(loss), jax.device_get(grads)
        return cache[base]

    return get


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_keeps_loss_and_gradients(flax_params, ids, jax_ref, policy):
    loss0, grads0, _ = _port(flax_params, ids)
    loss, grads, _ = _port(flax_params, ids, policy)
    assert loss == pytest.approx(loss0, rel=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], rtol=1e-6, atol=1e-7, msg=name)
    jloss, jgrads = jax_ref(policy.split("+")[0])
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    jgrads = gpt2_params_from_jax(jgrads, gpt2_config("gpt2-125m", **SMALL))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_backward_recomputes_what_the_policy_drops(flax_params, ids, policy):
    L = SMALL["n_layer"]
    *_, plain = _port(flax_params, ids)
    *_, remat = _port(flax_params, ids, policy)
    recomputed = {op: remat[op] - plain[op] for op in ("aten.mm", "aten.bmm", FLASH)}
    base = policy.split("+")[0]
    saved = REMAT_BASES[base]
    if saved is None:                                  # everything_saveable
        assert remat == plain
        return
    assert recomputed["aten.mm"] == (4 * L if not saved else 0), recomputed
    assert recomputed[FLASH] == (0 if policy.endswith("+flash") else L), recomputed
    assert plain[FLASH] == 0          # no forward op in a backward without remat


@pytest.mark.parametrize("policy,bmm_recomputed", [
    ("dots_saveable", 0), ("checkpoint_dots", 0),
    ("dots_with_no_batch_dims_saveable", 2), ("checkpoint_dots_with_no_batch_dims", 2),
    ("nothing_saveable", 2)])
def test_dense_attention_batch_dots(flax_params, ids, policy, bmm_recomputed):
    """On dense attention (two batched products per layer: scores and
    probabilities·v) the batch-dims distinction shows."""
    *_, plain = _port(flax_params, ids, attn="jnp")
    *_, remat = _port(flax_params, ids, policy, attn="jnp")
    assert remat["aten.bmm"] - plain["aten.bmm"] == bmm_recomputed * SMALL["n_layer"]


def test_policy_names_raise():
    with pytest.raises(ValueError, match="unknown remat policy 'dots_savable'"):
        resolve_remat_policy("dots_savable")
    with pytest.raises(ValueError, match="unknown remat policy suffix 'flsh'"):
        resolve_remat_policy("dots_saveable+flsh")
    for name in ("dots_saveable+offload", "nothing_saveable+flash+offload"):
        with pytest.raises(NotImplementedError, match="A11"):
            resolve_remat_policy(name)
    with pytest.raises(ValueError, match="unknown remat policy"):
        gpt2_config("gpt2-tiny", remat=True, remat_policy="save_everything")
    gpt2_config("gpt2-tiny", remat=False, remat_policy="save_everything")   # not used: no raise


def test_engine_takes_the_config_policy():
    config = {"train_micro_batch_size_per_gpu": 2,
              "activation_checkpointing": {"enabled": True, "policy": "dots_saveable+flash"}}
    eng, *_ = ds.initialize(model=GPT2LMHeadModel(gpt2_config("gpt2-tiny")), config=config,
                            device="cpu")
    assert eng.model_cfg.remat and eng.model_cfg.remat_policy == "dots_saveable+flash"
    with pytest.raises(NotImplementedError, match="A11"):
        ds.initialize(model=GPT2LMHeadModel(gpt2_config("gpt2-tiny")), device="cpu",
                      config={**config, "activation_checkpointing": {
                          "enabled": True, "policy": "dots_saveable+offload"}})
