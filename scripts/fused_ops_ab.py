#!/usr/bin/env python3
"""Time one tree's LayerNorm backward (``fused_ops.layer_norm_bwd``) and
attention-softmax forward (``fused_ops.softmax_fwd``) at the smoke's shapes
and record digests of their outputs, so that two trees can be held to the
same bits.

    python3 scripts/fused_ops_ab.py [--tree DIR] [--label NAME] [--out FILE]
                                    [--ops layer_norm_bwd,softmax_fwd] [--library]
    python3 scripts/fused_ops_ab.py --compare FILE

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own, through the wrappers (``layer_norm_fwd_plain`` gives the LayerNorm
backward's saved mean and rstd); the helpers are this repository's
``chip_smoke.py`` (operands, device time, bounds).

Cases. LayerNorm backward: BERT-large's (8192, 1024) in bf16 (the smoke's
timed case), and the smoke's fp32 ragged (333, 1001), (64, 1024) and a row
past the one-sweep kernel's width, (97, 2050). Softmax forward: the smoke's
bf16 (256, 512, 512) without and with the causal mask and (256, 128, 512)
causal, its fp32 ragged (3, 77, 130) causal and (3, 77, 513), the rows that
keep no key (4, 8, 5) causal, and rows past the held kernel's width, fp32
(2, 33, 2051) and bf16 (16, 64, 4096) causal.

One JSON line per case: the digest of the output whose bits must not change
(``adam8bit_ab.digest``: dx; p), the call's device time (``device_ms``) and
by kernel, CUDA events around back-to-back calls (``event_ms``), the bound
(the softmax forward's counts only the kept keys' reads) and, with
``--library``, the library's calls on the same inputs (``F.layer_norm``'s
autograd backward; the scale, ``masked_fill`` under causal, and
``torch.softmax``). The bf16 softmax cases are also timed with the input
rotated over enough copies (at least 150 MB) that no call finds the previous
call's lines in L2 (``rotated_ms``, beside the warm ``device_ms``), and
beside a device copy of the scores (``copy_ms``: every byte read once and
written once, what the card's memory gives a pass that moves the full
case's bytes).
``--compare`` checks that every case's digest is the same under every label.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LN_CASES = (((8192, 1024), "bfloat16"), ((333, 1001), "float32"), ((64, 1024), "float32"),
            ((97, 2050), "float32"))
# (shape, dtype, causal, scale)
SOFTMAX_CASES = (((256, 512, 512), "bfloat16", False, 0.125),
                 ((256, 512, 512), "bfloat16", True, 0.125),
                 ((256, 128, 512), "bfloat16", True, 0.125),
                 ((3, 77, 130), "float32", True, 0.125), ((3, 77, 513), "float32", False, 1.0),
                 ((4, 8, 5), "float32", True, 1.0), ((2, 33, 2051), "float32", False, 1.0),
                 ((16, 64, 4096), "bfloat16", True, 0.125))
ROTATE_BYTES = 150e6   # three times the H100's 50 MB L2


def compare(path: str) -> int:
    """Every case's digest the same in every run of the file."""
    by_case = {}
    for r in (json.loads(x) for x in open(path) if x.startswith("{")):
        if "digest" in r:
            by_case.setdefault(f"{r['op']} {r['case']}", []).append(
                (r["label"], json.dumps(r["digest"])))
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
    ap.add_argument("--ops", default="layer_norm_bwd,softmax_fwd",
                    help="comma-separated: layer_norm_bwd, softmax_fwd")
    ap.add_argument("--library", action="store_true", help="also time the library's calls")
    ap.add_argument("--compare", default=None, help="check the digests of a finished file")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    ops = args.ops.split(",")
    if not set(ops) <= {"layer_norm_bwd", "softmax_fwd"}:
        ap.error(f"--ops: {args.ops}")
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

    def timed(call, iters=20):
        total, by_name = cs.device_ms_by_name(torch, call, iters)
        return dict(device_ms=total, by_kernel={k[:80]: v for k, v in by_name.items()},
                    event_ms=cs.cuda_ms(torch, call, iters))

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 62)
    for shape, dt in LN_CASES if "layer_norm_bwd" in ops else ():
        dtype = getattr(torch, dt)
        (x, gm, bt), dy = cs.fused_ops_operands(torch, g, "layer_norm", shape, dtype)
        _, mean, rstd = fo.layer_norm_fwd_plain(x, gm, bt, 1e-5)

        def call():
            return fo.layer_norm_bwd(x, gm, mean, rstd, dy)

        dx, dg, db = call()
        torch.cuda.synchronize()
        b_ms, b_by = cs.fused_ops_bound("layer_norm", shape, dtype.itemsize, "layer_norm_bwd",
                                        peaks)
        row = dict(op="layer_norm_bwd", case=f"{shape} {dt}", digest=digest(torch, dx),
                   dgamma_dbeta_digest=[digest(torch, dg), digest(torch, db)], **timed(call),
                   bound_ms=b_ms, bound_by=b_by)
        if args.library:
            a = [x.clone().requires_grad_(), gm.to(dtype).requires_grad_(),
                 bt.to(dtype).requires_grad_()]

            def lib_f():
                return F.layer_norm(a[0], (shape[-1],), a[1], a[2], 1e-5)

            f_ms = cs.device_ms(torch, lib_f, 20)
            fb_ms = cs.device_ms(torch, lambda: torch.autograd.grad(lib_f(), a, dy), 20)
            row["library_ms"] = fb_ms - f_ms if f_ms and fb_ms else None
        emit(row)
        del x, gm, bt, dy, mean, rstd, dx, dg, db
        torch.cuda.empty_cache()

    for shape, dt, causal, scale in SOFTMAX_CASES if "softmax_fwd" in ops else ():
        dtype = getattr(torch, dt)
        (s,), _ = cs.fused_ops_operands(torch, g, "attention_softmax", shape, dtype)
        p = fo.softmax_fwd(s, causal, scale)
        torch.cuda.synchronize()
        b_ms, b_by = cs.fused_ops_bound("attention_softmax", shape, dtype.itemsize,
                                        "softmax_fwd", peaks, causal)
        row = dict(op="softmax_fwd", case=f"{shape} {dt} causal={causal} scale={scale}",
                   digest=digest(torch, p),
                   **timed(lambda: fo.softmax_fwd(s, causal, scale)), bound_ms=b_ms,
                   bound_by=b_by)
        if dt == "bfloat16":
            row["copy_ms"] = cs.device_ms(torch, lambda: torch.empty_like(s).copy_(s), 20)
            copies = [s] + [s.clone() for _ in range(int(ROTATE_BYTES // (s.numel() * 2)))]
            turn = [0]

            def rotated():
                turn[0] = (turn[0] + 1) % len(copies)
                return fo.softmax_fwd(copies[turn[0]], causal, scale)

            row["rotated_ms"] = cs.device_ms(torch, rotated, 4 * len(copies))
            row["rotated_copies"] = len(copies)
            del copies
        if args.library:
            keep = fo._causal_keep(shape[1], shape[2], "cuda") if causal else None

            def lib_f():
                t = s * scale
                if keep is not None:
                    t = t.masked_fill(~keep, float("-inf"))
                return torch.softmax(t, -1)

            row["library_pair_ms"] = cs.device_ms(torch, lib_f, 20)
        emit(row)
        del s, p
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
