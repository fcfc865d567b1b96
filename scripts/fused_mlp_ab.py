#!/usr/bin/env python3
"""Time one tree's fused-FFN forward, dx and dw kernels (bf16) at the
training and serving shapes, beside the bound and the cuBLAS pair.

    python3 scripts/fused_mlp_ab.py [--tree DIR] [--label NAME] [--out FILE]

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. Both trees are driven through the public entry point; the helpers
(device time from the profiler, CUDA-event time, bounds, operands) are this
repository's ``chip_smoke.py``.

Cases: gpt2-125m's FFN (E=768, F=3072) at R = 24576 (micro 24 x 1024, the
train step's), 2048, 1000, 256, 64 and 8 rows (8: an unfused decode tick;
64 and 256: prefill chunks), and E=384, F=1536 at R = 2048. One JSON line
per case and call (``case``: ``fwd``, ``dx``, ``dw``), ms per call: the
call's device time (``device_ms``: its kernels and the passes that sum
splits or segments and cast) and by kernel name, CUDA events around
back-to-back calls (``event_ms``), the bound (``bound_ms``: 2, 3 or 4
products of 2 R E F flops at the card's bf16 rate, or the bytes) and, for
dw, the floor with the lo halves of du and h (``hi_lo_floor_ms``: 6
products). Where the tree routes bf16 rows by ``fused_mlp.SM90_MIN_ROWS``,
the forward is timed on both routes (``route``: ``sm90``, the tensor-core
entry; ``mma.sync``, the other), which decides the row rule; dx takes its
tensor-core entry at every row count there. With ``--library``: the unfused pair ``F.linear`` -> tanh GELU ->
``F.linear`` (forward), its autograd backward (all five gradients) beside
dx and dw (``library_ms``), and dx's own unfused chain (``F.linear(x, w1ᵀ,
b1)``, ``dy @ w2ᵀ``, ``aten.gelu_backward(tanh)``, ``@ w1ᵀ``:
``unfused_chain_ms``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((24576, 768, 3072), (2048, 768, 3072), (1000, 768, 3072), (256, 768, 3072),
          (64, 768, 3072), (8, 768, 3072), (2048, 384, 1536))


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
    routes = (True, False) if hasattr(fm, "SM90_MIN_ROWS") else (None,)
    case_routes = {"fwd": routes, "dx": routes[:1], "dw": (None,)}
    for R, E, F in SHAPES:
        x, w1, b1, w2, b2, dy = cs.mlp_operands(torch, g, R, E, F, torch.bfloat16)
        iters = 5 if R >= 2048 else 20
        bounds = cs.mlp_bounds(R, E, F, 2, peaks, False)
        shape = f"R={R} E={E} F={F} bfloat16"
        lib = {}
        if args.library:
            w1t, w2t = w1.T.contiguous(), w2.T.contiguous()
            lib_in = [t.clone().requires_grad_() for t in (x, w1t, b1, w2t,
                                                           b2.to(torch.bfloat16))]

            def lib_fwd():
                a = lib_in
                return F_.linear(F_.gelu(F_.linear(a[0], a[1], a[2]), approximate="tanh"),
                                 a[3], a[4])

            def dx_chain():
                u = F_.linear(x, w1t, b1)
                return torch.ops.aten.gelu_backward(dy @ w2t, u, approximate="tanh") @ w1t

            fwd_ms = cs.device_ms(torch, lib_fwd, iters)
            both = cs.device_ms(torch, lambda: torch.autograd.grad(lib_fwd(), lib_in, dy), iters)
            lib = dict(fwd=fwd_ms, bwd=both - fwd_ms if both and fwd_ms else None,
                       chain=cs.device_ms(torch, dx_chain, iters))
            del lib_in, w1t, w2t
        calls = {"fwd": lambda: fm.fused_mlp_fwd_op(x, w1, b1, w2, b2),
                 "dx": lambda: fm.fused_mlp_bwd_dx(x, w1, b1, w2, dy),
                 "dw": lambda: fm.fused_mlp_bwd_dw(x, w1, b1, w2, dy)}
        base = {"fwd": "fused_mlp_fwd", "dx": "fused_mlp_bwd_dx", "dw": "fused_mlp_bwd_dw"}
        for case, call in calls.items():
            for sm90 in case_routes[case]:
                with (contextlib.nullcontext() if sm90 is None else cs.forced_route(fm, sm90)):
                    total, by_kernel = cs.device_ms_by_name(torch, call, iters)
                    event = cs.cuda_ms(torch, call, iters)
                b_ms, b_by = bounds[base[case]]
                row = dict(case=case, shape=shape, device_ms=total,
                           by_kernel={k[:80]: v for k, v in by_kernel.items()}, event_ms=event,
                           bound_ms=b_ms, bound_by=b_by)
                if case != "dw":
                    row["route"] = "mma.sync" if sm90 is None or not sm90 else "sm90"
                    row["main_route"] = sm90 is None or sm90 == fm.sm90_route(R, case == "fwd")
                else:
                    row["hi_lo_floor_ms"] = 6 * 2.0 * R * E * F / peaks[1] * 1e3
                if lib:
                    row["library_ms"] = lib["fwd"] if case == "fwd" else lib["bwd"]
                    if case == "dx":
                        row["unfused_chain_ms"] = lib["chain"]
                emit(row)
        del x, w1, b1, w2, b2, dy
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
