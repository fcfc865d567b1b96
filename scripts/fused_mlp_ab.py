#!/usr/bin/env python3
"""Time one tree's fused-FFN dw kernel (``fused_mlp_bwd_dw``, bf16) at the
training and serving shapes, beside the bound and the cuBLAS pair's
backward.

    python3 scripts/fused_mlp_ab.py [--tree DIR] [--label NAME] [--out FILE]

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. Both trees are driven through the public entry point; the helpers
(device time from the profiler, CUDA-event time, bounds, operands) are this
repository's ``chip_smoke.py``.

Cases: gpt2-125m's FFN (E=768, F=3072) at R = 24576 (micro 24 x 1024, the
train step's), 2048, 1000 and 8 rows, and E=384, F=1536 at R = 2048. One
JSON line per case, ms per call: the call's device time (``device_ms``: the
dw kernel and the passes that sum its segments and cast) and by kernel
name, CUDA events around back-to-back calls (``event_ms``), the bound
(``bound_ms``: 4 products of 2 R E F flops at the card's bf16 rate, or the
bytes) and the floor with the lo halves of du and h (``hi_lo_floor_ms``: 6
products); with ``--library``, the autograd backward of the unfused pair
``F.linear`` -> tanh GELU -> ``F.linear`` (all five gradients) on the same
inputs (``library_ms``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((24576, 768, 3072), (2048, 768, 3072), (1000, 768, 3072), (8, 768, 3072),
          (2048, 384, 1536))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--library", action="store_true", help="also time the cuBLAS pair")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import torch
    import torch.nn.functional as F_

    if not torch.cuda.is_available():
        print("fused_mlp_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import fused_mlp as fm

    if not fm.__file__.startswith(tree):
        raise RuntimeError(f"imported {fm.__file__}, not the tree's")
    _build.build_all(["fused_mlp"])
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

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 42)
    for R, E, F in SHAPES:
        x, w1, b1, w2, b2, dy = cs.mlp_operands(torch, g, R, E, F, torch.bfloat16)
        iters = 5 if R >= 2048 else 20

        def call():
            return fm.fused_mlp_bwd_dw(x, w1, b1, w2, dy)

        total, by_kernel = cs.device_ms_by_name(torch, call, iters)
        b_ms, b_by = cs.mlp_bounds(R, E, F, 2, peaks, False)["fused_mlp_bwd_dw"]
        row = dict(case="dw", shape=f"R={R} E={E} F={F} bfloat16", device_ms=total,
                   by_kernel={k[:80]: v for k, v in by_kernel.items()},
                   event_ms=cs.cuda_ms(torch, call, iters), bound_ms=b_ms, bound_by=b_by,
                   hi_lo_floor_ms=6 * 2.0 * R * E * F / peaks[1] * 1e3)
        if args.library:
            lib_in = [t.clone().requires_grad_() for t in (x, w1.T.contiguous(), b1,
                                                           w2.T.contiguous(),
                                                           b2.to(torch.bfloat16))]

            def lib_fwd():
                a = lib_in
                return F_.linear(F_.gelu(F_.linear(a[0], a[1], a[2]), approximate="tanh"),
                                 a[3], a[4])

            fwd_ms = cs.device_ms(torch, lib_fwd, iters)
            both = cs.device_ms(torch, lambda: torch.autograd.grad(lib_fwd(), lib_in, dy), iters)
            row["library_ms"] = both - fwd_ms if both and fwd_ms else None
            del lib_in
        emit(row)
        del x, w1, b1, w2, b2, dy
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
