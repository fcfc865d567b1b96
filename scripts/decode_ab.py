#!/usr/bin/env python3
"""Time one tree's decode and paged attention kernels at the shapes of
PERF.md's rows 4 and 5, beside their library calls and bounds.

    python3 scripts/decode_ab.py [--tree DIR] [--label NAME] [--out FILE]

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. The helpers (inputs, rotation past the L2, device time from the
profiler, bounds) are this repository's ``chip_smoke.py``.

The cases: B = 8 rows in bf16; decode over S_max = 512 with ragged lengths,
paged over 16-token pages and 32 table entries with NaN at every dead
position; heads of gpt2-125m (H = KV = 12, D = 64), a 3:1 grouping
(H = 12, KV = 4), gpt2-760m (16, 16, 96), llama-1b (32, 4, 64), pythia-1b
(8, 8, 256) and, paged only, (32, 8, 128). One JSON line per case: the
kernel's device ms per call, the library call's, the bound, and the
launches one wrapper call counts.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE = ((12, 12, 64), (12, 4, 64), (16, 16, 96), (32, 4, 64), (8, 8, 256))
PAGED = ((12, 12, 64), (16, 16, 96), (32, 8, 128), (32, 4, 64), (8, 8, 256))
DECODE_LENGTHS = [1, 512, 37, 100, 256, 300, 511, 64]
PAGED_LENGTHS = [1, 16, 17, 255, 256, 300, 511, 512]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import paged_attention as pa

    if not da.__file__.startswith(tree):
        raise RuntimeError(f"imported {da.__file__}, not the tree's")
    _build.build_all(["decode_attention", "paged_attention"])
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

    bf, dev, B = torch.bfloat16, "cuda", 8
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 20)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    def row(kind, H, KV, D, kernel, library, sets, nbytes, live):
        rot = cs.Rotation(sets)
        n0 = (da if kind == "decode" else pa).KERNEL.launches
        kernel(*sets[0])
        launches = (da if kind == "decode" else pa).KERNEL.launches - n0
        call = lambda: kernel(*rot.next())  # noqa: E731
        kernel_ms, by_name = cs.device_ms_by_name(torch, call, args.iters)
        b_ms, b_by = cs.bound_ms(nbytes, 4 * live * H * D, peaks)
        emit(dict(kind=kind, H=H, KV=KV, D=D, kernel_ms=kernel_ms,
                  kernel_ms_by_name={k.split("(")[0][:80]: v for k, v in by_name.items()},
                  kernel_event_ms=cs.cuda_ms(torch, call, args.iters),
                  library_ms=cs.device_ms(torch, lambda: library(*rot.next()), args.iters),
                  bound_ms=b_ms, bound_by=b_by, launches_per_call=launches))

    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    live = int(lengths.sum())
    mask = (torch.arange(512, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    for H, KV, D in DECODE:
        n_sets = max(2, -(-64_000_000 // (4 * B * 512 * KV * D)))
        sets = [(rn(B, 1, H, D), rn(B, 512, KV, D), rn(B, 512, KV, D)) for _ in range(n_sets)]

        def sdpa(q, k, v, gqa=KV < H):
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask,
                                                  enable_gqa=gqa)
        row("decode", H, KV, D, lambda q, k, v: da.decode_attention(q, k, v, lengths), sdpa,
            sets, 2 * live * KV * D * 2 + 2 * B * H * D * 2 + B * 4, live)
        del sets

    pt, T = 16, 32
    plen = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    plive = sum(PAGED_LENGTHS)
    pmask = (torch.arange(T * pt, device=dev)[None, :] < plen[:, None])[:, None, None, :]
    for H, KV, D in PAGED:
        n_sets = max(2, -(-64_000_000 // (4 * (B * T + 1) * pt * KV * D)))
        sets = [cs.paged_arena(torch, g, PAGED_LENGTHS, B, H, KV, D, pt, T, bf)
                for _ in range(n_sets)]

        def gather_sdpa(q, kp, vp, table, gqa=KV < H):
            kk, vv = pa.gather_kv_pages(kp, table), pa.gather_kv_pages(vp, table)
            return F.scaled_dot_product_attention(q.transpose(1, 2), kk.transpose(1, 2),
                                                  vv.transpose(1, 2), attn_mask=pmask,
                                                  enable_gqa=gqa)
        row("paged", H, KV, D,
            lambda q, kp, vp, tb: pa.paged_decode_attention(q, kp, vp, tb, plen), gather_sdpa,
            sets, 2 * plive * KV * D * 2 + 2 * B * H * D * 2 + B * T * 4 + B * 4, plive)
        del sets
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
