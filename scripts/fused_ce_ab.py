#!/usr/bin/env python3
"""Time one tree's fused CE head (``fused_ce_fwd``, ``fused_ce_bwd``, bf16) at
the smoke's shapes, beside the bound and the chunked head.

    python3 scripts/fused_ce_ab.py [--tree DIR] [--label NAME] [--out FILE] [--library]

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. Both trees are driven through the public entry points (a tree whose
``fused_ce_bwd`` takes no incoming gradient returns fp32 dh and dw,
unscaled); the helpers (device time from the profiler, CUDA-event time,
bounds, operands) are this repository's ``chip_smoke.py``.

Shapes: the GPT-2-1.5B head (N = 2048 tokens, E = 1600, Vp = 50304),
gpt2-125m's micro-batch (N = 24576, E = 768) and a ragged one (N = 300, E =
200, Vp = 1000). One JSON line per shape and pass, ms per call: the call's
device time (``device_ms``) and by kernel name, CUDA events around
back-to-back calls (``event_ms``), the bound (``bound_ms``: the forward one
product of 2 N E Vp flops, the backward three; ``bound_four_products_ms``
beside it); with ``--library``, the chunked head's forward and backward
(``chunked_lm_loss``, one chunk) on the same inputs (``library_ms``).
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((2048, 1600, 50304, 50257, "row_end"), (24576, 768, 50304, 50257, "row_end"),
          (300, 200, 1000, 990, "every_7th"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--library", action="store_true", help="also time the chunked head")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import torch

    if not torch.cuda.is_available():
        print("fused_ce_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.models.common import chunked_lm_loss
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import fused_ce as ce

    if not ce.__file__.startswith(tree):
        raise RuntimeError(f"imported {ce.__file__}, not the tree's")
    _build.build_all(["fused_ce"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    takes_g = "g" in inspect.signature(ce.fused_ce_bwd).parameters
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(dict(label=args.label, card=card, **obj))
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 43)
    for N, E, Vp, V, ignored in SHAPES:
        h, w, labels = cs.ce_operands(torch, g, N, E, Vp, V, torch.bfloat16, ignored)
        wteT = w.T
        _, lse = ce.fused_ce_fwd(h, wteT, labels, V, -100)
        gt = torch.tensor([1.0 / N], device="cuda")
        extra = (gt,) if takes_g else ()
        iters = 3 if N > 4096 else 5
        flops = 2.0 * N * E * Vp
        ins = (N + Vp) * E * 2 + N * 8
        shape = f"N={N} E={E} Vp={Vp} vocab={V} bfloat16"

        def fwd():
            return ce.fused_ce_fwd(h, wteT, labels, V, -100)

        def bwd():
            return ce.fused_ce_bwd(h, wteT, labels, lse, V, -100, *extra)

        lib = {}
        if args.library:
            hl, wl = h[None].clone().requires_grad_(), w.clone().requires_grad_()

            def lib_fwd():
                return chunked_lm_loss(hl, wl, labels[None], vocab_size=V, padded_vocab_size=Vp,
                                       chunk=1 << 30, dtype=torch.bfloat16)

            f_ms = cs.device_ms(torch, lib_fwd, iters)
            fb_ms = cs.device_ms(torch, lambda: torch.autograd.grad(lib_fwd(), (hl, wl)), iters)
            lib = dict(fwd=f_ms, bwd=fb_ms - f_ms if f_ms and fb_ms else None)
            del hl, wl
        for case, fn, n_products, out_bytes in (("fwd", fwd, 1, N * 8),
                                                ("bwd", bwd, 3, (N + Vp) * E * 2)):
            total, by_kernel = cs.device_ms_by_name(torch, fn, iters)
            b_ms, b_by = cs.bound_ms(ins + out_bytes, n_products * flops, peaks)
            row = dict(case=case, shape=shape, device_ms=total,
                       by_kernel={k[:80]: v for k, v in by_kernel.items()},
                       event_ms=cs.cuda_ms(torch, fn, iters), bound_ms=b_ms, bound_by=b_by)
            if case == "bwd":
                row["bound_four_products_ms"] = 4 * flops / peaks[1] * 1e3
            if lib:
                row["library_ms"] = lib[case]
            emit(row)
        del h, w, labels, wteT, lse
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
