#!/usr/bin/env python3
"""Time one tree's fused adam8bit update at the smoke's leaf shapes and over
a whole GPT-2-1.5B step, and record digests of its outputs, so that two
trees can be held to the same bits.

    python3 scripts/adam8bit_ab.py [--tree DIR] [--label NAME] [--out FILE]
    python3 scripts/adam8bit_ab.py --compare FILE

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. Both trees are driven through the public entry points
(``adam8bit_update`` for one leaf, ``Adam8bit(fused=True).update`` for the
step); the helpers (device time from the profiler, CUDA-event time, bounds)
are this repository's ``chip_smoke.py``.

Cases: the smoke's ``kernels_adam8bit`` leaves (c_attn (1600, 4800), the
MLP's c_proj (6400, 1600), wte (50304, 1600), a bias (1, 4800) with and
without L2, three rows of 100000), ragged widths (1, 3, 17), and ``step``:
one optimizer step over every leaf of gpt2-1.5b (the meta model's
parameter shapes, 1.56e9 elements, random warm moments; adamw8bit's wd
0.1, clip scale 0.7). Every case starts from the same seeded inputs in
every tree. One JSON line per case: ``digest`` (two position-weighted int64
sums of each output's bytes, computed on the card), the call's device time
(``device_ms``; the step's ``kernel_device_ms`` is the update kernels'
share), CUDA events around back-to-back calls (``event_ms``), the step's
host time to enqueue one update (``host_ms``), its launches and the bound
(16 bytes an element and 16 a row); with ``--train-steps N``, the wall ms
per step of N gpt2-1.5b north-star train steps (``train_step``, the
smoke's ``train_1p5b`` model and config). ``--compare`` reads such a file
and checks that every case's digest is the same under every label.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8)
LEAVES = (("c_attn_kernel", (1600, 4800), 0.0), ("mlp_c_proj_kernel", (6400, 1600), 0.0),
          ("wte", (50304, 1600), 0.0), ("c_attn_bias", (1, 4800), 0.0),
          ("c_attn_bias_l2", (1, 4800), 0.01), ("row_100000", (3, 100000), 0.0),
          ("width_1", (1000, 1), 0.0), ("width_3", (777, 3), 0.0), ("width_17", (513, 17), 0.0))
CHUNK = 1 << 26   # elements a digest step


def digest(torch, t) -> list:
    """Two int64 sums over ``t``'s bytes as 32-bit words (the plain sum and
    one weighted by position), on the card; equal bits give equal digests."""
    b = t.detach().contiguous().view(-1).view(torch.uint8)
    pad = (-b.numel()) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    w = b.view(torch.int32)
    s0 = torch.zeros((), dtype=torch.int64, device=t.device)
    s1 = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, w.numel(), CHUNK):
        part = w[i:i + CHUNK].long()
        pos = torch.arange(i, i + part.numel(), device=t.device) % 1000003 + 1
        s0 += part.sum()
        s1 += (part * pos).sum()
    return [int(s0), int(s1)]


def fold_digests(digests: list) -> list:
    """One digest for many tensors: their digests folded in order."""
    a = b = 0
    for x, y in digests:
        a = (a * 1000003 + x) % (1 << 61)
        b = (b * 1000033 + y) % (1 << 61)
    return [a, b]


def compare(path: str) -> int:
    """Every case's digest the same in every run of the file."""
    by_case = {}
    for r in (json.loads(x) for x in open(path) if x.startswith("{")):
        if "digest" in r:
            by_case.setdefault(r["case"], []).append((r["label"], json.dumps(r["digest"])))
    verdict = {c: len({d for _, d in runs}) == 1 for c, runs in by_case.items()}
    ok = bool(verdict) and all(verdict.values())
    print(json.dumps(dict(compare=path, same_bits=verdict,
                          labels={c: [lab for lab, _ in runs] for c, runs in by_case.items()},
                          ok=ok)))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--compare", default=None, help="check the digests of a finished file")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="also time this many gpt2-1.5b north-star train steps")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import torch

    if not torch.cuda.is_available():
        print("adam8bit_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import adam8bit as a8

    if not a8.__file__.startswith(tree):
        raise RuntimeError(f"imported {a8.__file__}, not the tree's")
    _build.build_all(["adam8bit"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(dict(label=args.label, card=card, **obj))
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    keys = ("p", "mc", "rc", "scm", "scr")
    c1, c2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3
    scalars = torch.tensor([0.7, 1e-4, c1, c2], dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 61)
    for name, shape, l2 in LEAVES:
        t = cs.adam8bit_leaf(torch, g, shape)
        kw = dict(HYPER, wd=0.1, l2=l2)
        n0 = a8.KERNEL.launches
        a8.adam8bit_update(t["g"], *(t[k] for k in keys), scalars, **kw)
        launches = a8.KERNEL.launches - n0
        torch.cuda.synchronize()
        dig = [digest(torch, t[k]) for k in keys]

        def call(t=t, kw=kw):
            a8.adam8bit_update(t["g"], *(t[k] for k in keys), scalars, **kw)

        total, by_name = cs.device_ms_by_name(torch, call, 20)
        n, R = shape[0] * shape[1], shape[0]
        b_ms, b_by = cs.bound_ms(16 * n + 16 * R, 0, peaks)
        emit(dict(case=name, shape=list(shape), l2=l2, digest=dig, launches=launches,
                  device_ms=total, by_kernel={k[:80]: v for k, v in by_name.items()},
                  event_ms=cs.cuda_ms(torch, call, 20), bound_ms=b_ms, bound_by=b_by))
        del t
        torch.cuda.empty_cache()

    # one step over every leaf of gpt2-1.5b
    model = GPT2LMHeadModel(gpt2_config("gpt2-1.5b", n_positions=1024), device="meta")
    named = list(model.named_parameters())
    params = [torch.randn(p.shape, generator=g, device="cuda") * 0.02 for _, p in named]
    grads = [torch.randn(p.shape, generator=g, device="cuda") * 1e-3 for _, p in named]
    opt = a8.Adam8bit(params, lambda c: 1e-4, 0.9, 0.999, 1e-8, weight_decay=0.1, clip=1.0,
                      fused=True, names=[n for n, _ in named])
    for i, p in enumerate(params):
        opt.m_codes[i].copy_(torch.randint(-127, 128, p.shape, generator=g, device="cuda"))
        opt.r_codes[i].copy_(torch.randint(0, 256, p.shape, generator=g, device="cuda"))
        for k in "mr":
            sc = opt.scales[i][k]
            sc.copy_(torch.rand(sc.shape, generator=g, device="cuda") * 1e-4 + 1e-6)
    opt.count = 3
    norm = torch.tensor(1.0 / 0.7, device="cuda")   # clip scale 0.7
    n0 = a8.KERNEL.launches
    opt.update(params, grads, norm)
    launches = a8.KERNEL.launches - n0
    torch.cuda.synchronize()
    dig = [digest(torch, t) for t in params + opt.m_codes + opt.r_codes] + \
        [digest(torch, s[k]) for s in opt.scales for k in "mr"]

    def step():
        opt.update(params, grads, norm)

    total, by_name = cs.device_ms_by_name(torch, step, 5)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    n_el = sum(p.numel() for p in params)
    n_rows = sum(p.numel() // p.shape[-1] for p in params)
    b_ms, b_by = cs.bound_ms(16 * n_el + 16 * n_rows, 0, peaks)
    emit(dict(case="step", model="gpt2-1.5b", leaves=len(params), elements=n_el, rows=n_rows,
              digest=fold_digests(dig), launches=launches,
              launches_per_step=opt.launches_per_step, device_ms=total,
              kernel_device_ms=sum(v for k, v in by_name.items() if "adam8bit_kernel" in k),
              by_kernel={k[:80]: v for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]},
              event_ms=cs.cuda_ms(torch, step, 5), host_ms=sorted(host)[len(host) // 2],
              host_ms_all=host, bound_ms=b_ms, bound_by=b_by))
    del params, grads, opt
    torch.cuda.empty_cache()
    if args.train_steps:
        emit(train_steps(torch, cs, args.train_steps))
    if out:
        out.close()
    return 0


def train_steps(torch, cs, steps: int) -> dict:
    """gpt2-1.5b at the smoke's north-star recipe (``chip_smoke.
    run_train_1p5b``'s model and config): 2 warm-up steps, then ``steps``
    timed ones (host clock, ending in a synchronize)."""
    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

    cfg = gpt2_config("gpt2-1.5b", n_positions=1024, remat=True,
                      remat_policy="dots_saveable+flash", loss_chunk=8192)
    eng, *_ = ds.initialize(model=GPT2LMHeadModel(cfg, device="meta"),
                            config=cs.northstar_config())
    eng.init_params()
    ids = cs.text_like_ids(np.random.default_rng(cs.SEED + 13),
                           eng.train_micro_batch_size_per_gpu, 1024, cfg.vocab_size)
    batch = eng._to_device({"input_ids": ids, "labels": ids})
    eng.train_batches(batch, 2, stacked=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = eng.train_batches(batch, steps, stacked=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(case="train_step", model="gpt2-1.5b", steps=steps, ms_per_step=wall * 1e3 / steps,
                launches_per_step=eng.optimizer.launches_per_step,
                losses=[float(x) for x in losses])


if __name__ == "__main__":
    sys.exit(main())
