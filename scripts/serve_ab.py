#!/usr/bin/env python3
"""Time one tree's serving tick walls: the batcher with page-resident KV on
the smoke's serve traffic, at gpt2-125m, llama-1b and pythia-1b in bf16.

    python3 scripts/serve_ab.py [--tree DIR] [--label NAME] [--out FILE]
                                [--models gpt2-125m,llama-1b,pythia-1b]

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and served (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. The traffic and helpers are this repository's ``chip_smoke.py``.

Per model (full width and depth, random weights from the smoke's seed,
``max_tokens=512``, 8 slots, 16-token pages): one warm pass of the 32
requests, then two timed passes (wall, ms per tick, TTFT); a profiled
16-tick window (tick wall, device ms, busy share); and the sampling step
alone, ``_filtered_logits`` over 8 rows of the model's vocab with per-row
temperature and top-p, by its host time per call (no synchronise between
calls) and its device time. One JSON line per model.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = {"page_tokens": 16, "n_pages": 512}


def build_model(torch, name: str, seed: int):
    if name.startswith("gpt2"):
        from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel as cls, gpt2_config as cfg
    elif name.startswith("llama"):
        from deepspeed_tpu_torch.models.llama import LlamaForCausalLM as cls, llama_config as cfg
    else:
        from deepspeed_tpu_torch.models.gptneox import (GPTNeoXForCausalLM as cls,
                                                        gptneox_config as cfg)
    config = cfg(name)
    return cls(config).init_weights(torch.Generator().manual_seed(seed)), config.vocab_size


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to serve")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--models", default="gpt2-125m,llama-1b,pythia-1b")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference import engine as eng_mod
    from deepspeed_tpu_torch.ops import _build

    if not ds.__file__.startswith(tree):
        raise RuntimeError(f"imported {ds.__file__}, not the tree's")
    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = open(args.out, "a") if args.out else None

    for name in args.models.split(","):
        t0 = time.perf_counter()
        model, V = build_model(torch, name, cs.SEED)
        init_s = time.perf_counter() - t0
        eng = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512)
        del model
        reqs = cs.serve_requests(V)
        batcher = ds.ContinuousBatcher(eng, n_slots=8, seed=cs.SEED, prefix_cache=PAGES)
        passes = [cs.serve_pass(torch, batcher, reqs)[1] for _ in range(3)]
        prof = cs.serve_profile(torch, batcher, reqs)

        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 30)
        logits = torch.randn((8, V), generator=g, device="cuda").to(torch.bfloat16).float()
        temp = torch.full((8,), 0.8, device="cuda")
        top_p = torch.full((8,), 0.9, device="cuda")
        sample = lambda: eng_mod._filtered_logits(logits, temp, 0, top_p)  # noqa: E731
        for _ in range(20):
            sample()
        torch.cuda.synchronize()
        n = 200
        h0 = time.perf_counter()
        for _ in range(n):
            sample()
        host_ms = (time.perf_counter() - h0) * 1e3 / n
        torch.cuda.synchronize()
        line = json.dumps(dict(
            label=args.label, card=card, model=name, init_s=init_s,
            warm_pass=passes[0], passes=passes[1:],
            ms_per_tick=[p["ms_per_tick"] for p in passes[1:]],
            profile=prof, sampler_host_ms=host_ms,
            sampler_device_ms=cs.device_ms(torch, sample, n)))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del batcher, eng
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
