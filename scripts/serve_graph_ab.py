#!/usr/bin/env python3
"""Time the decode loop as CUDA-graph replays against the eager loop, in
turns on one card: the batcher's windows and ``generate``'s ticks.

    python3 scripts/serve_graph_ab.py [--paths NAME,...] [--out FILE] [--turns N]

Run on a machine with an NVIDIA Hopper card, from the root of the
repository. The traffic and helpers are ``chip_smoke.py``'s. Paths (full
width and depth, random weights from the smoke's seed, ``max_tokens=512``):

- ``serve_gpt2_paged``, ``serve_gpt2_contiguous``: gpt2-125m behind the
  batcher (8 slots; 16-token pages, or contiguous slots);
- ``serve_760m_bf16``, ``serve_760m_w8``, ``serve_llama_bf16``,
  ``serve_llama_w8``, ``serve_neox_bf16``, ``serve_neox_w8``: gpt2-760m,
  llama-1b and pythia-1b, page-resident, bf16 and W8A16;
- ``generate``: gpt2-125m ``generate`` at B=8, prompt 256, 128 new tokens.

Each path builds its engine once and runs the graph path and the eager
path in turns (graph, eager, eager, graph for ``--turns 2``). A serve turn
makes a fresh batcher (so the graph turn captures its tick graphs inside
its first window) and runs the smoke's 32 requests twice (pass 1 and pass
2: wall, TTFT p50 / p90, decode tokens/s, wall ms per tick), then one
profiled 16-tick window of 8 live slots (``serve_profile``: wall and
device ms per tick, busy share). A generate turn drops the engine's graphs,
times one full ``generate`` (with the capture), ``generate(max_new_tokens=1)``
(TTFT) and a second full one (ms per tick = (T(new) - T(1)) / (new - 1)),
and profiles T(1) and T(new) (device ms per tick: summed by kernel, and the
union of the kernels' intervals, whose share of the tick's wall is the busy
share). Each
turn prints one JSON line with the card's name and power limit; the
graph turns also give each graph's capture time (the eager first tick
plus the capture, inside the first window's wall) and replays.
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
W8 = {"enabled": True, "bits": 8}
SERVE = {"serve_gpt2_paged": ("gpt2-125m", {}, PAGES),
         "serve_gpt2_contiguous": ("gpt2-125m", {}, None),
         "serve_760m_bf16": ("gpt2-760m", {}, PAGES),
         "serve_760m_w8": ("gpt2-760m", {"quant": W8}, PAGES),
         "serve_llama_bf16": ("llama-1b", {}, PAGES),
         "serve_llama_w8": ("llama-1b", {"quant": W8}, PAGES),
         "serve_neox_bf16": ("pythia-1b", {}, PAGES),
         "serve_neox_w8": ("pythia-1b", {"quant": W8}, PAGES)}
PATHS = (*SERVE, "generate")


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


def serve_turn(torch, cs, ds, eng, reqs, pc, compiled: bool) -> dict:
    b = ds.ContinuousBatcher(eng, n_slots=8, seed=cs.SEED, prefix_cache=pc,
                             compiled_loop=compiled)
    passes = [cs.serve_pass(torch, b, reqs)[1] for _ in range(2)]
    prof = cs.serve_profile(torch, b, reqs)
    keep = ("wall_s", "ttft_p50_ms", "ttft_p90_ms", "e2e_p50_ms", "decode_tokens_per_s",
            "ms_per_tick", "ticks", "windows")
    return dict(passes=[{k: p[k] for k in keep} for p in passes], profile=prof,
                graphs={str(k): v for k, v in b.graph_stats().items()})


def generate_turn(torch, cs, eng, prompt, new: int, compiled: bool) -> dict:
    from torch.profiler import ProfilerActivity, profile

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompt, max_new_tokens=n, compiled_loop=compiled)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def device(n):   # summed and union device ms of one profiled call
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed(n)
        return cs.device_sum_and_union_ms(prof)

    eng._graphs.clear()
    first = timed(new)                    # captures the tick graph
    capture = [g.capture_s for _, g in eng._graphs.values()]
    ttft = timed(1)
    gen = timed(new)
    (s1, u1), (sn, un) = device(1), device(new)
    tick_wall = (gen - ttft) / (new - 1)
    tick_busy = (un - u1) / (new - 1)
    return dict(ttft_ms=ttft, first_generate_ms=first, generate_ms=gen, ms_per_tick=tick_wall,
                tick_device_ms=(sn - s1) / (new - 1), tick_device_union_ms=tick_busy,
                tick_device_busy_share=tick_busy / tick_wall,
                decode_tokens_per_s=prompt.shape[0] / (tick_wall / 1e3), capture_s=capture)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--turns", type=int, default=2,
                    help="graph/eager pairs, in the order g e e g g e ...")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("serve_graph_ab: no CUDA device", file=sys.stderr)
        return 1
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.ops import _build

    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = open(args.out, "a") if args.out else None
    order = [c for t in range(args.turns) for c in ((True, False) if t % 2 == 0
                                                    else (False, True))]
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        raise SystemExit(f"unknown paths {sorted(unknown)}; known: {', '.join(PATHS)}")
    built = {}
    for path in paths:
        name, kw, pc = SERVE.get(path, ("gpt2-125m", {}, None))
        if name not in built:
            built.clear()
            torch.cuda.empty_cache()
            built[name] = build_model(torch, name, cs.SEED)
        model, V = built[name]
        eng = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512, **kw)
        reqs = cs.serve_requests(V)
        g = torch.Generator().manual_seed(cs.SEED + 1)
        prompt = torch.randint(0, V, (8, 256), generator=g)
        eng.generate(prompt[:, :32], max_new_tokens=4, compiled_loop=False)   # warm-up
        for turn, compiled in enumerate(order):
            if path == "generate":
                res = generate_turn(torch, cs, eng, prompt, 128, compiled)
            else:
                res = serve_turn(torch, cs, ds, eng, reqs, pc, compiled)
            line = json.dumps(dict(card=card, path=path, model=name, turn=turn,
                                   loop="graph" if compiled else "eager", **res))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del eng
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
