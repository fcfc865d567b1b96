"""The port's fused FFN (``ops/fused_mlp.py``, the plain versions its CUDA
kernels are held against on the card) against the JAX package's Pallas
kernels in interpret mode, and GPT-2 with ``fused_mlp=True`` against the JAX
model running its kernel, on the CPU.

Module level: the forward and all five cotangents (dx, dw1, db1, dw2, db2)
of ``jax.vjp`` over ``fused_mlp(..., interpret=True)`` against the port's
autograd function, for a ragged row count, several row blocks, and the JAX
backward's multi-F-tile path (its VMEM budget shrunk from the test). fp32 at
rtol 1e-5 / atol 1e-6 (the same fp32 products summed in another order);
bf16 within one bf16 ulp of each output's largest magnitude (the hidden is
cast to bf16 at the same point on both sides, but a sum in another order
can round it the other way, and the TPU dx kernel adds bf16 partials where
the port sums in fp32). Then the dispatch rule (``fits_vmem`` and
``MLP.use_fused``) against JAX's, the flax tree of a ``fused_mlp=True``
model through the converter, and what activation checkpointing recomputes.

:func:`jax_fused_mlp_kernel` makes the JAX model run its Pallas kernel on
the CPU (its rule asks for a TPU, and its kernel for one device), counting
the calls; the train, inference and serving tests use it for their
``fused_mlp`` cases.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.pallas import fused_mlp as jax_fm
from deepspeed_tpu_torch.models.common import resolve_remat_policy
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.models.gpt2 import MLP, GPT2LMHeadModel, gpt2_config
from deepspeed_tpu_torch.ops import fused_mlp as fm

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)

SMALL = dict(vocab_size=500, n_embd=64, n_layer=2, n_head=2, n_positions=128)


@contextlib.contextmanager
def jax_fused_mlp_kernel():
    """The JAX GPT-2 fuses its MLP through the interpreted Pallas kernel:
    its rule's TPU check reads True, its kernel runs with ``interpret=True``,
    and a one-device mesh is current unless the caller sets one (the kernel
    takes one device; the tests' process has eight). Yields the list that
    each kernel call appends to."""
    calls, real = [], jax_fm.fused_mlp

    def interpreted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **{**kw, "interpret": True})

    own_mesh = mesh_mod.get_mesh(required=False) is None
    if own_mesh:
        mesh_mod.set_mesh(mesh_mod.build_mesh({"dp": 1}, devices=jax.devices()[:1]))
    try:
        with mock.patch.object(jax_gpt2, "on_tpu", lambda: True), \
                mock.patch.object(jax_fm, "fused_mlp", interpreted):
            yield calls
    finally:
        if own_mesh:
            mesh_mod.set_mesh(None)


def _operands(R, E, F, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, E))
    w1, w2 = 0.02 * rng.standard_normal((E, F)), 0.02 * rng.standard_normal((F, E))  # GPT-2's init
    b1, b2 = 0.1 * rng.standard_normal(F), 0.1 * rng.standard_normal(E)
    dy = 0.1 * rng.standard_normal((R, E))   # cotangents: gradients of O(1) over ~100 rows
    return [a.astype(np.float32) for a in (x, w1, b1, w2, b2, dy)]


def _both(R, E, F, seed, block_rows, dtype):
    """(JAX outputs, port outputs): y, then dx, dw1, db1, dw2, db2."""
    x, w1, b1, w2, b2, dy = _operands(R, E, F, seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jin = [jnp.asarray(a, jdt) for a in (x, w1, b1, w2, b2)]
    y, vjp = jax.vjp(lambda *a: jax_fm.fused_mlp(*a, block_rows=block_rows, interpret=True),
                     *jin)
    want = [np.asarray(t, np.float32) for t in (y, *vjp(jnp.asarray(dy, jdt)))]
    tin = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (x, w1, b1, w2, b2)]
    yt = fm.fused_mlp(*tin)
    grads = torch.autograd.grad(yt, tin, torch.tensor(dy, dtype=dtype))
    got = [t.detach().float().numpy() for t in (yt, *grads)]
    assert [g.dtype for g in grads] == [dtype] * 5
    return want, got


NAMES = ("y", "dx", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("R,E,F,block_rows,budget", [
    (37, 64, 256, 16, None),             # ragged: the JAX wrapper pads to 48 rows
    (130, 128, 512, 32, None),           # several row blocks, ragged
    (64, 32, 512, 16, 2 * 32 * 128 * 6 + 1),   # JAX backward over 4 F tiles
], ids=["ragged", "row_blocks", "f_tiles"])
def test_plain_matches_jax_kernel_fp32(monkeypatch, R, E, F, block_rows, budget):
    if budget:
        monkeypatch.setattr(jax_fm, "_BWD_VMEM_BUDGET", budget)
        assert F // jax_fm._pick_block_f(E, F, 4) == 4
    want, got = _both(R, E, F, R, block_rows, torch.float32)
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


def test_plain_matches_jax_kernel_bf16():
    want, got = _both(70, 64, 256, 5, 32, torch.bfloat16)
    for name, w, g in zip(NAMES, want, got):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(g - w).max() <= ulp, name


def test_kernel_plain_versions_are_the_gradients():
    """The dx and dw plain versions, called as the smoke calls them, equal
    autograd through the plain forward in fp32 (h and du are fp32 there)."""
    x, w1, b1, w2, b2, dy = (torch.from_numpy(a) for a in _operands(20, 64, 128, 9))
    tin = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    u = tin[0] @ tin[1] + tin[2]
    y = fm.gelu_tanh(u) @ tin[3] + tin[4]
    want = torch.autograd.grad(y, tin, dy)
    got = (fm.fused_mlp_bwd_dx_plain(x, w1, b1, w2, dy),
           *fm.fused_mlp_bwd_dw_plain(x, w1, b1, w2, dy))
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_fits_vmem_matches_jax(itemsize):
    for e in range(64, 2049, 64):
        for f in (2 * e, 4 * e):
            for block_rows in (128, 256):
                assert fm.fits_vmem(e, f, block_rows, itemsize) == jax_fm.fits_vmem(
                    e, f, block_rows, itemsize), (e, f, block_rows)


@pytest.mark.parametrize("preset,dtype,over,fused", [
    ("gpt2-125m", "bf16", {}, True), ("gpt2-125m", "fp32", {}, False),
    ("gpt2-350m", "bf16", {}, False), ("gpt2-tiny", "fp32", {}, True),
    ("gpt2-125m", "bf16", {"w8": True}, False), ("gpt2-125m", "bf16", {"fused_mlp": False}, False),
])
def test_use_fused_matches_jax_rule(preset, dtype, over, fused):
    over = {"fused_mlp": True, **over}
    port = MLP(gpt2_config(preset, dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
                           **over), device="meta")
    with jax_fused_mlp_kernel():
        ref = jax_gpt2.MLP(jax_gpt2.gpt2_config(
            preset, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32, **over))._use_fused()
    assert port.use_fused() == ref == fused


def _flax(fused: bool):
    cfg = jax_gpt2.gpt2_config("gpt2-125m", dtype=jnp.float32, fused_mlp=fused, **SMALL)
    return jax_gpt2.GPT2LMHeadModel(cfg)


def test_flax_tree_of_a_fused_model_converts_and_loads():
    ids = np.random.default_rng(3).integers(0, 500, size=(2, 24)).astype(np.int32)
    with jax_fused_mlp_kernel() as calls:
        boxed = _flax(True).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
        tree = jax.tree_util.tree_map(lambda a: np.asarray(getattr(a, "value", a)), boxed,
                                      is_leaf=lambda a: hasattr(a, "value"))
        want = np.asarray(_flax(True).apply({"params": tree}, jnp.asarray(ids))["logits"])
    assert calls, "the JAX model ran its fused kernel"
    plain = _flax(False).init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.shape, boxed)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.shape, plain))
    model = GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32, fused_mlp=True,
                                        **SMALL))
    model.load_state_dict(gpt2_params_from_jax(tree, model.cfg))
    assert all(b.mlp.use_fused() for b in model.h)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable", "everything_saveable"])
def test_remat_reruns_the_fused_forward(policy):
    """Checkpointing a block recomputes the fused forward op in backward
    (it saves its inputs, which the block recomputes, and the policies save
    no op output but the dots and, with ``+flash``, the flash forward's):
    one more launch per layer and micro-batch, except under
    ``everything_saveable``; dx and dw run once per layer either way."""
    model = GPT2LMHeadModel(gpt2_config("gpt2-125m", dtype=torch.float32, fused_mlp=True,
                                        **SMALL)).init_weights(torch.Generator().manual_seed(0))
    ids = torch.randint(0, 500, (2, 16), generator=torch.Generator().manual_seed(1))
    remat = resolve_remat_policy(policy)
    outs = {}
    for name, run in (("plain", lambda b, x: b(x)), ("remat", lambda b, x: remat(b, x, None))):
        y = model.wte[ids] + model.wpe[:16]
        for block in model.h:
            y = run(block, y)
        with _Ops() as ops:
            torch.autograd.grad(y.square().sum(), list(model.parameters()), allow_unused=True)
        outs[name] = ops.seen.count("ds_tpu_torch.fused_mlp_fwd")
    assert outs["plain"] == 0
    assert outs["remat"] == (0 if policy == "everything_saveable" else SMALL["n_layer"])


def test_fused_mlp_keeps_leading_dims_and_dtypes():
    x, w1, b1, w2, b2, _ = (torch.from_numpy(a) for a in _operands(6, 64, 128, 2))
    y = fm.fused_mlp(x.reshape(2, 3, 64).bfloat16(), w1.bfloat16(), b1.bfloat16(),
                     w2.bfloat16(), b2.bfloat16())
    assert y.shape == (2, 3, 64) and y.dtype == torch.bfloat16
    ref = fm.fused_mlp_plain(x.bfloat16(), w1.bfloat16(), b1.bfloat16(), w2.bfloat16(),
                             b2.bfloat16().float())
    assert torch.equal(y.reshape(6, 64), ref)
    assert gpt2_config("gpt2-125m", fused_mlp=True).fused_mlp   # no longer refused
