#!/usr/bin/env python3
"""Time one tree's LayerNorm backward (``fused_ops.layer_norm_bwd``) at the
smoke's shapes and record digests of its outputs, so that two trees can be
held to the same dx bits.

    python3 scripts/fused_ops_ab.py [--tree DIR] [--label NAME] [--out FILE] [--library]
    python3 scripts/fused_ops_ab.py --compare FILE

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own, through the public entry points (``layer_norm_fwd_plain`` gives the
saved mean and rstd, ``layer_norm_bwd`` the call); the helpers are this
repository's ``chip_smoke.py`` (operands, device time, bounds).

Cases: BERT-large's (8192, 1024) in bf16 (the smoke's timed case), and the
smoke's fp32 ragged (333, 1001), (64, 1024) and a row past the one-sweep
kernel's width, (97, 2050). One JSON line per case: digests of dx and of
dgamma and dbeta (``adam8bit_ab.digest``), the call's device time
(``device_ms``) and by kernel (the row kernel and the partial rows' sum),
CUDA events around back-to-back calls (``event_ms``), the bound and, with
``--library``, ``F.layer_norm``'s autograd backward on the same inputs.
``--compare`` checks that every case's dx digest is the same under every
label (dgamma and dbeta change their order of summation in this change).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (((8192, 1024), "bfloat16"), ((333, 1001), "float32"), ((64, 1024), "float32"),
         ((97, 2050), "float32"))


def compare(path: str) -> int:
    """Every case's dx digest the same in every run of the file."""
    by_case = {}
    for r in (json.loads(x) for x in open(path) if x.startswith("{")):
        if "dx_digest" in r:
            by_case.setdefault(r["case"], []).append((r["label"], json.dumps(r["dx_digest"])))
    verdict = {c: len({d for _, d in runs}) == 1 for c, runs in by_case.items()}
    ok = bool(verdict) and all(verdict.values())
    print(json.dumps(dict(compare=path, dx_same_bits=verdict,
                          labels={c: [lab for lab, _ in runs] for c, runs in by_case.items()},
                          ok=ok)))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--library", action="store_true", help="also time F.layer_norm's backward")
    ap.add_argument("--compare", default=None, help="check the dx digests of a finished file")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from adam8bit_ab import digest
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("fused_ops_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import fused_ops as fo

    if not fo.__file__.startswith(tree):
        raise RuntimeError(f"imported {fo.__file__}, not the tree's")
    _build.build_all(["fused_ops"])
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

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 62)
    for shape, dt in CASES:
        dtype = getattr(torch, dt)
        (x, gm, bt), dy = cs.fused_ops_operands(torch, g, "layer_norm", shape, dtype)
        _, mean, rstd = fo.layer_norm_fwd_plain(x, gm, bt, 1e-5)

        def call():
            return fo.layer_norm_bwd(x, gm, mean, rstd, dy)

        dx, dg, db = call()
        torch.cuda.synchronize()
        iters = 20
        total, by_name = cs.device_ms_by_name(torch, call, iters)
        b_ms, b_by = cs.fused_ops_bound("layer_norm", shape, dtype.itemsize, "layer_norm_bwd",
                                        peaks)
        row = dict(case=f"{shape} {dt}", dx_digest=digest(torch, dx),
                   dgamma_dbeta_digest=[digest(torch, dg), digest(torch, db)], device_ms=total,
                   by_kernel={k[:80]: v for k, v in by_name.items()},
                   event_ms=cs.cuda_ms(torch, call, iters), bound_ms=b_ms, bound_by=b_by)
        if args.library:
            a = [x.clone().requires_grad_(), gm.to(dtype).requires_grad_(),
                 bt.to(dtype).requires_grad_()]

            def lib_f():
                return F.layer_norm(a[0], (shape[-1],), a[1], a[2], 1e-5)

            f_ms = cs.device_ms(torch, lib_f, iters)
            fb_ms = cs.device_ms(torch, lambda: torch.autograd.grad(lib_f(), a, dy), iters)
            row["library_ms"] = fb_ms - f_ms if f_ms and fb_ms else None
        emit(row)
        del x, gm, bt, dy, mean, rstd, dx, dg, db
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
