"""The fused adam8bit update's leaf table (``ops/adam8bit.py``: ``leaf_plan``,
``plan_table``, ``LeafTable``), on the CPU.

From shapes alone (gpt2-1.5b's 580 leaves on the meta device, no
allocation, and ragged and oversize widths): every row of every leaf the
kernel takes lies in exactly one work item, a row's chunks all in one item
and within the block's registers (threads x SLOTS), the kernel's own
mapping of chunks to threads covering each chunk once; leaves
``fused_leaf_supported`` rejects are left out; the launches a step equal
``launches_per_step``. Then the CUDA branch of a step: one counted launch a
table launch, the table the launch carries (pointers, shapes, first items,
plans) read back from the host array, nothing read back from the card. The
CPU arithmetic of the table path is the existing tests' (its plain version
per leaf; ``test_torch_adam8bit.py`` holds it against the JAX fused apply).
"""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
from deepspeed_tpu_torch.ops import adam8bit as a8

from .test_torch_decode_attention import _NoHostRead, _OnCard

# several pytest workers share the host's cores: one torch thread each
torch.set_num_threads(1)


def _rows(shape):
    C = shape[-1]
    return int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1, C


def _check_plan(R, C):
    """The kernel's mapping (csrc/adam8bit.cu) under ``leaf_plan(R, C)``:
    item i takes rows [i·K, min(R, (i+1)·K)), chunk f of an item goes to
    thread f % T in sweep f // T; each (row, chunk) once."""
    p = a8.leaf_plan(R, C)
    nc = -(-C // a8.CHUNK)
    assert 1 <= p.threads <= a8.THREADS
    if p.wide:
        assert nc > a8.HELD and p.rows == 1 and p.threads == a8.THREADS
        return p
    assert p.rows >= 1 and p.rows * nc <= p.threads * a8.SLOTS <= a8.HELD
    items = -(-R // p.rows)
    seen = np.zeros(R, np.int64)
    for i in range(items):
        rows = min(p.rows, R - i * p.rows)
        f = np.arange(rows * nc)
        assert (f // p.threads).max() < a8.SLOTS            # within the sweeps
        np.add.at(seen, i * p.rows + f // nc, 1)
    assert (seen == nc).all()                               # every chunk of every row once
    return p


def test_plans_of_the_1p5b_leaves_and_ragged_widths():
    model = GPT2LMHeadModel(gpt2_config("gpt2-1.5b"), device="meta")
    shapes = [tuple(p.shape) for p in model.parameters()]
    assert len(shapes) == 580
    for shape in set(shapes) | {(1000, 1), (777, 3), (513, 17), (3, 100000), (2, 8200),
                                (1, 8192), (5, 8193)}:
        _check_plan(*_rows(shape))
    # the widths PERF.md states: 1600 in 5-row items of 250 threads, 4800 and
    # 6400 one row of 200 threads (no thread idles in its last sweep)
    assert a8.leaf_plan(50304, 1600) == a8.LeafPlan(5, 250, False)
    assert a8.leaf_plan(1600, 4800) == a8.LeafPlan(1, 200, False)
    assert a8.leaf_plan(1600, 6400) == a8.LeafPlan(1, 200, False)
    assert a8.leaf_plan(1, 1600) == a8.LeafPlan(1, 200, False)


def test_table_of_the_1p5b_step_from_shapes_alone():
    model = GPT2LMHeadModel(gpt2_config("gpt2-1.5b"), device="meta")
    params = list(model.parameters())
    opt = a8.Adam8bit(params, lambda c: 1e-4, 0.9, 0.999, 1e-8, weight_decay=0.1, fused=True)
    plan = opt._table.launch_plan
    assert opt.launches_per_step == len(plan) == 2 == -(-580 // a8.MAX_LEAVES)
    assert [len(launch.leaves) for launch in plan] == [500, 80]
    shapes = [_rows(tuple(p.shape)) for p in params]
    for launch in plan:
        items = [-(-R // a8.leaf_plan(R, C).rows) for R, C in (shapes[i] for i in launch.leaves)]
        assert launch.first == list(np.cumsum([0] + items[:-1]))
        assert launch.items == sum(items)
    assert [i for launch in plan for i in launch.leaves] == list(range(580))


def test_unsupported_leaves_stay_out_of_the_table():
    shapes = [(), (7,), (2, 100001), (4, 3, 5), (100000,)]
    params = [torch.zeros(s) for s in shapes]
    opt = a8.Adam8bit(params, lambda c: 1e-3, 0.9, 0.999, 1e-8, fused=True)
    assert opt._table_idx == [1, 3, 4] and opt._rest_idx == [0, 2]
    assert opt._table.shapes == [(1, 7), (12, 5), (1, 100000)]
    assert opt.launches_per_step == 1
    assert a8.Adam8bit(params, lambda c: 1e-3, 0.9, 0.999, 1e-8).launches_per_step == 0


@contextlib.contextmanager
def _recorder(monkeypatch):
    """Each launch's arguments and the table it carries (read from the host
    array while the launch runs)."""
    launches = []

    def launch(tab_ptr, n_leaves, n_items, *rest):
        tab = np.ctypeslib.as_array((ctypes.c_int64 * (n_leaves * 10)).from_address(tab_ptr))
        launches.append((tab.reshape(n_leaves, 10).copy(), n_leaves, n_items, rest))
    monkeypatch.setattr(a8.KERNEL, "launch", launch)
    monkeypatch.setattr(a8, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    with _NoHostRead():
        yield launches


def test_a_step_launches_the_table(monkeypatch):
    """501 leaves of the table (two launches: 500 and 1) and two left to the
    unfused math (0-d, a row past MAX_ROW), on tensors that report a card."""
    rng = np.random.default_rng(0)
    shapes = [(2, 3)] * 499 + [(40, 1600), (3, 17), (), (2, 100001)]
    params = [torch.tensor(rng.standard_normal(s), dtype=torch.float32).as_subclass(_OnCard)
              for s in shapes]
    grads = [torch.tensor(rng.standard_normal(s), dtype=torch.float32).as_subclass(_OnCard)
             for s in shapes]
    grads[499] = grads[499].t().contiguous().t()          # a transposed view, as the tied head's
    opt = a8.Adam8bit(params, lambda c: 1e-3, 0.9, 0.999, 1e-8, weight_decay=0.1, fused=True)
    assert opt.launches_per_step == 2
    # the step scalars (host arithmetic, as the JAX package forms them), then
    # the update with nothing read back
    c1, c2 = a8._bias_corrections(0.9, 0.999, 1)
    norm = torch.tensor(2.0).as_subclass(_OnCard)
    with _recorder(monkeypatch) as launches:
        opt._fused_update(params, grads, norm, 1e-3, c1, c2)
    assert len(launches) == opt.launches_per_step
    assert [n for _, n, _, _ in launches] == [500, 1]
    tab = np.concatenate([t for t, _, _, _ in launches])
    for row, (i, plan) in zip(tab, zip(opt._table_idx, opt._table.plans)):
        R, C = _rows(shapes[i])
        assert row[1] == params[i].data_ptr() and row[2] == opt.m_codes[i].data_ptr()
        assert row[3] == opt.r_codes[i].data_ptr()
        assert row[4] == opt.scales[i]["m"].data_ptr() and row[5] == opt.scales[i]["r"].data_ptr()
        assert (row[6], row[7]) == (R, C)
        assert row[9] & 0x1fffff == plan.code(False)
        if i != 499:
            assert row[0] == grads[i].data_ptr()
    assert tab[499, 0] != grads[499].data_ptr()           # its contiguous copy went instead
    for (t, _, n_items, rest), launch in zip(launches, opt._table.launch_plan):
        assert list(t[:, 8]) == launch.first and n_items == launch.items
        assert rest[1:8] == (0.9, 0.999, 1.0 - 0.9, 1.0 - 0.999, 1e-8, 0.1, 0.0)
        assert rest[-1] == 7
    # parameters replaced by other tensors: the next step builds a new table
    params2 = [p.clone() for p in params]
    with _recorder(monkeypatch) as launches:
        opt._fused_update(params2, grads, norm, 1e-3, c1, c2)
    assert launches[0][0][0, 1] == params2[0].data_ptr() and len(launches) == 2


def test_one_leaf_update_is_a_one_leaf_table(monkeypatch):
    p = torch.zeros(6, 24).as_subclass(_OnCard)
    args = [torch.zeros(6, 24).as_subclass(_OnCard), p,
            torch.zeros(6, 24, dtype=torch.int8).as_subclass(_OnCard),
            torch.zeros(6, 24, dtype=torch.uint8).as_subclass(_OnCard),
            torch.ones(6, 1).as_subclass(_OnCard), torch.ones(6, 1).as_subclass(_OnCard),
            torch.ones(4).as_subclass(_OnCard)]
    with _recorder(monkeypatch) as launches:
        a8.adam8bit_update(*args, b1=0.9, b2=0.999, eps=1e-8)
    (tab, n, items, _), = launches
    assert n == 1 and items == 1 and tab[0, 8] == 0
    assert tab[0, 9] == a8.leaf_plan(6, 24).code(True) or tab[0, 9] == a8.leaf_plan(6, 24).code(
        False)
    with pytest.raises(ValueError, match="g is"):
        a8.adam8bit_update(args[0][:, :12], *args[1:], b1=0.9, b2=0.999, eps=1e-8)
