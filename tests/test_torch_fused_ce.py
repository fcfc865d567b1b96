"""The fused CE head of the port (``ops/fused_ce.py``, the plain version its
CUDA kernels are held against on the card) against the JAX package's Pallas
kernels in interpret mode, and GPT-2's ``loss_pallas`` head against the JAX
model, on the CPU.

The kernels' function: per-token nll and lse, their sum, and the two
gradients dh and dw scaled by an incoming gradient, with a ragged token
count (the port masks it; the JAX wrapper pads to its tile with
``ignore_index`` rows, checked to give the same result), ``ignore_index``
rows, and padded vocab columns. fp32 throughout. Tolerances: nll, lse and
their sum rtol 1e-5; dh and dw atol 1e-5 (gradients of order 0.1, the same
fp32 products summed in another order); the model's loss rtol 1e-5 and
every gradient rtol 1e-5 / atol 1e-6, as the chunked head's test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as FlaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_config as flax_config
from deepspeed_tpu.ops.pallas import fused_ce as jax_ce
from deepspeed_tpu_torch.models import common
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
from deepspeed_tpu_torch.ops import fused_ce

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

SMALL = dict(vocab_size=500, n_embd=64, n_layer=2, n_head=2, n_positions=128)
V, VP, E, IGNORE = 250, 256, 64, -100


def _head(N, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, E)).astype(np.float32)
    wteT = (0.2 * rng.standard_normal((E, VP))).astype(np.float32)
    labels = rng.integers(0, V, size=N).astype(np.int32)
    labels[::7] = IGNORE
    return h, wteT, labels


def _jax_padded(h, wteT, labels, bq=128):
    """The JAX wrapper's layout: tokens padded to ``bq`` with zero rows
    labelled ``ignore_index``."""
    pad = (-len(h)) % bq
    hp = np.concatenate([h, np.zeros((pad, E), np.float32)])
    lp = np.concatenate([labels, np.full(pad, IGNORE, np.int32)])
    return jnp.asarray(hp), jnp.asarray(wteT), jnp.asarray(lp)


@pytest.mark.parametrize("N", [74, 256])     # a ragged count and whole tiles
def test_fused_ce_plain_matches_pallas_interpret(N):
    h, wteT, labels = _head(N, seed=N)
    hp, wp, lp = _jax_padded(h, wteT, labels)
    g = 0.7                                      # the incoming gradient scales dh and dw
    nll_j, lse_j = jax_ce._fwd_pair(hp, wp, lp, V, IGNORE, 128, 128, True)
    sum_j, vjp = jax.vjp(lambda a, b: jax_ce.fused_ce_sum(a, b, lp, V, IGNORE, 128, 128, True),
                         hp, wp)
    dh_j, dw_j = (np.asarray(x) for x in vjp(jnp.float32(g)))

    th, tw = torch.from_numpy(h), torch.from_numpy(wteT)
    tl = torch.from_numpy(labels)
    nll, lse = fused_ce.fused_ce_plain(th, tw, tl, V, IGNORE)
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j).reshape(-1)[:N], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j).reshape(-1)[:N], rtol=1e-5)
    assert float(nll[::7].abs().max()) == 0.0                     # ignore_index rows

    th.requires_grad_(), tw.requires_grad_()
    total = fused_ce.fused_ce_sum(th, tw, tl, V, IGNORE)
    dh, dw = torch.autograd.grad(total * g, (th, tw))
    np.testing.assert_allclose(float(total), float(sum_j), rtol=1e-5)
    np.testing.assert_allclose(dh.numpy(), dh_j[:N], rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), dw_j, rtol=0, atol=1e-5)
    assert np.abs(dh_j[N:]).max(initial=0.0) == 0.0               # the padding tail
    assert float(dw[:, V:].abs().max()) == 0.0                    # padded vocab columns
    assert float(dh[::7].abs().max()) == 0.0                      # ignored rows

    # the port's plain backward at the kernels' cast points, unscaled
    dh_p, dw_p = fused_ce.fused_ce_bwd_plain(th.detach(), tw.detach(), tl, lse, V, IGNORE)
    np.testing.assert_allclose(g * dh_p.numpy(), dh.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g * dw_p.numpy(), dw.numpy(), rtol=1e-6, atol=1e-7)


def test_padding_tail_gives_the_same_sum():
    """Padding the tokens with label-free rows (as the JAX wrapper does)
    changes neither the sum nor the real rows' gradients."""
    h, wteT, labels = _head(74, seed=3)
    hp, wp, lp = (torch.from_numpy(np.asarray(x)) for x in _jax_padded(h, wteT, labels))
    outs = []
    for a, b, lab in ((torch.from_numpy(h), torch.from_numpy(wteT), torch.from_numpy(labels)),
                      (hp, wp, lp)):
        a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
        total = fused_ce.fused_ce_sum(a, b, lab, V, IGNORE)
        outs.append((total, *torch.autograd.grad(total, (a, b))))
    (s1, dh1, dw1), (s2, dh2, dw2) = outs
    torch.testing.assert_close(s1, s2, rtol=1e-6, atol=0)
    torch.testing.assert_close(dh1, dh2[:74], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(dw1, dw2, rtol=1e-6, atol=1e-7)


def _unbox(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(getattr(x, "value", x)), tree,
                                  is_leaf=lambda x: hasattr(x, "names") and hasattr(x, "value"))


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxGPT2(flax_config("gpt2-125m", dtype=jnp.float32, **SMALL))
    return _unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def test_gpt2_loss_pallas_matches_the_jax_model(flax_params):
    """The port's ``loss_pallas`` head against the JAX model's memory-bounded
    head on the CPU (the chunked head: the JAX package takes its Pallas
    head only on a TPU), loss and every gradient."""
    ids = np.random.default_rng(2).integers(0, SMALL["vocab_size"], (2, 128)).astype(np.int32)
    cfg = flax_config("gpt2-125m", dtype=jnp.float32, loss_chunk=96, loss_pallas=True, **SMALL)

    def loss_fn(p):
        return FlaxGPT2(cfg).apply({"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids))["loss"]

    want, wgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, flax_params))
    model = GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32, loss_chunk=96,
                                        loss_pallas=True, **SMALL))
    model.load_state_dict(gpt2_params_from_jax(flax_params, model.cfg))
    t = torch.from_numpy(ids).long()
    out = model(t, labels=t)
    assert set(out) == {"loss"}
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(out["loss"], params)))
    np.testing.assert_allclose(float(out["loss"]), float(want), rtol=1e-5)
    wgrads = gpt2_params_from_jax(jax.device_get(wgrads), model.cfg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), wgrads[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_loss_pallas_without_loss_chunk_is_the_dense_head():
    """As in the JAX package, ``loss_pallas`` engages only with ``loss_chunk``:
    without it the model returns logits and the dense loss."""
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 500, (2, 64))).long()
    outs = []
    for pallas in (False, True):
        model = GPT2LMHeadModel(gpt2_config("gpt2-tiny", dtype=torch.float32,
                                            loss_pallas=pallas))
        model.init_weights(torch.Generator().manual_seed(0))
        outs.append(model(ids, labels=ids))
    assert set(outs[1]) == {"logits", "loss"}
    torch.testing.assert_close(outs[1]["loss"], outs[0]["loss"], rtol=0, atol=0)


def test_pallas_lm_loss_is_the_chunked_loss():
    h, wteT, labels = _head(74, seed=5)
    th = torch.from_numpy(h).reshape(2, 37, E)
    w = torch.from_numpy(np.ascontiguousarray(wteT.T))
    lab = torch.from_numpy(labels).reshape(2, 37)
    kw = dict(vocab_size=V, padded_vocab_size=VP, dtype=torch.float32)
    a = common.pallas_lm_loss(th, w, lab, **kw)
    b = common.chunked_lm_loss(th, w, lab, chunk=32, **kw)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
