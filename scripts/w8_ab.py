#!/usr/bin/env python3
"""Time one tree's W8A16 matmul (``w8a16_matmul_kernel``) at the serving
models' panels, beside the dequantize + ``matmul`` pair and the bound.

    python3 scripts/w8_ab.py [--tree DIR] [--label NAME] [--out FILE]

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. Both trees are driven through the public entry point in bf16; the
helpers (rotation of input sets past the L2, device time from the profiler,
CUDA-event and CUDA-graph time, bounds) are this repository's
``chip_smoke.py``.

Cases (random int8 codes and fp32 scales, 128-row groups, from a seed):
gpt2-760m's four panels at M = 1, 8, 37 and 64 rows, llama-1b's and
pythia-1b's four panels at M = 8 and 64. One JSON line per case, ms per
call: the kernel's device time (``device_ms``), CUDA events around
back-to-back calls (``event_ms``: the host's enqueue where it is slower
than the card), CUDA events around a CUDA graph of 20 calls (``graph_ms``),
the pair ``x @ dequantize(codes, scale)`` (``pair_ms``: two PyTorch calls;
no one call takes grouped int8 weights), and the bound (each input read
once, each output written once, at the card's memory rate).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP = 128
PANELS = {
    "gpt2-760m": (((1536, 4608), (1536, 1536), (1536, 6144), (6144, 1536)), (1, 8, 37, 64)),
    "llama-1b": (((2048, 2048), (2048, 256), (2048, 8192), (8192, 2048)), (8, 64)),
    "pythia-1b": (((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)), (8, 64)),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import torch

    if not torch.cuda.is_available():
        print("w8_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import w8 as w8ops
    from deepspeed_tpu_torch.ops import w8_matmul as wm

    if not wm.__file__.startswith(tree):
        raise RuntimeError(f"imported {wm.__file__}, not the tree's")
    _build.build_all(["w8_matmul"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(dict(label=args.label, card=card, **obj))
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 41)
    bf = torch.bfloat16
    for model, (panels, rows) in PANELS.items():
        for K, N in panels:
            sets_w = cs.w8_panels(torch, g, K, N, GROUP, -(-60_000_000 // (K * N)))
            for M in rows:
                sets = [(torch.randn((M, K), generator=g, device="cuda").to(bf), c, s)
                        for c, s in sets_w]
                rot = cs.Rotation(sets)

                def call():
                    return wm.w8a16_matmul_kernel(*rot.next())

                def pair():
                    x, c, s = rot.next()
                    return x @ w8ops.dequantize_weight(c, s, bf)

                nbytes = K * N + K // GROUP * N * 4 + M * K * 2 + M * N * 4
                b_ms, b_by = cs.bound_ms(nbytes, 2 * M * K * N, peaks)
                g_ms, g_err = cs.graph_ms(torch, call, 20)
                emit(dict(case=f"{model} {K}->{N}", shape=f"M={M} K={K} N={N} g={GROUP}",
                          device_ms=cs.device_ms(torch, call, args.iters),
                          event_ms=cs.cuda_ms(torch, call, args.iters), graph_ms=g_ms,
                          **({"graph_error": g_err} if g_err else {}),
                          pair_ms=cs.device_ms(torch, pair, args.iters),
                          bound_ms=b_ms, bound_by=b_by))
                del sets, rot
            del sets_w
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
