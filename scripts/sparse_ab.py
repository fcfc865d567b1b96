#!/usr/bin/env python3
"""Time one tree's bf16 block-sparse attention kernel at the chip smoke's
sparse cases, beside the library calls, the bound and the hi + lo floor.

    python3 scripts/sparse_ab.py [--tree DIR] [--label NAME] [--out FILE]

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. A tree whose wrapper takes the LUT and counts
(``sparse_attention_kernel(q, k, v, lut, counts, block, causal, scale)``)
is timed through that call; a tree with a plan (``plan_on``) through the
plan built once. The cases, inputs and helpers (rotation past the L2,
device time from the profiler, bounds) are this repository's
``chip_smoke.py``: ``sparse_layouts`` (BERT-large heads, D = 64) and D =
128 at blocks 32 and 128. One JSON line per case: the kernel's device ms
per call (and, for BigBird and BSLongformer, their widest rows alone and
the rest alone), SDPA with the expanded boolean element mask (library),
dense SDPA without a mask, the bound (bytes or operations) and the hi + lo
floor, 6 B pairs D flops at the bf16 peak.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("sparse_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ssa

    if not ssa.__file__.startswith(tree):
        raise RuntimeError(f"imported {ssa.__file__}, not the tree's")
    _build.build_all(["sparse_attention"])
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

    planned = hasattr(ssa, "plan_on")

    def call_of(layout, block, causal):
        """The tree's kernel call on one layout, its plan or LUT built once."""
        if planned:
            dplan = ssa.plan_on(layout, block, causal, "cuda")
            return lambda q, k, v, sc: ssa.sparse_attention_kernel(q, k, v, dplan, sc)
        lut, counts = ssa.lut_on(layout, "cuda")
        return lambda q, k, v, sc: ssa.sparse_attention_kernel(q, k, v, lut, counts, block,
                                                               causal, sc)

    cases = [(name, cfg, causal, S, B, empty, wide, 64)
             for name, cfg, causal, S, B, empty, wide in cs.sparse_layouts()]
    for block in (32, 128):
        for causal in (False, True):
            cfg = FixedSparsityConfig(num_heads=cs.BERT_H, block=block,
                                      different_layout_per_head=True,
                                      num_different_global_patterns=2)
            cases.append((f"d128_block{block}" + ("_causal" if causal else ""), cfg, causal,
                          1024, 1, (), (), 128))
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 30)
    H, bf = cs.BERT_H, torch.bfloat16
    for name, cfg, causal, S, B, empty, wide, D in cases:
        block = cfg.block
        layout = cfg.make_layout(S)
        for qi in wide:
            layout[:, qi, :] = 1
        for qi in empty:
            layout[:, qi, :] = 0
        scale = D ** -0.5
        sets = [tuple(torch.randn((B, S, H, D), generator=g, device="cuda").to(bf)
                      for _ in range(3)) for _ in range(3)]
        rot = cs.Rotation(sets)
        call = call_of(layout, block, causal)
        keep = cs.sparse_keep(torch, layout, block, causal, "cuda")
        pairs = int(keep.sum())
        row = dict(case=name, shape=f"B={B} S={S} H={H} D={D} block={block} bfloat16"
                   + (" causal" if causal else ""),
                   kernel_ms=cs.device_ms(torch, lambda: call(*rot.next(), scale), args.iters))
        per_row = layout.sum(-1)
        if per_row.max() >= 4 * float(np.median(per_row)):
            wide_rows = (per_row == per_row.max())[..., None]
            for key, sub in (("widest_rows_alone_ms", layout * wide_rows),
                             ("without_widest_rows_ms", layout * ~wide_rows)):
                sub_call = call_of(sub, block, causal)
                row[key] = cs.device_ms(torch, lambda c=sub_call: c(*rot.next(), scale),
                                        args.iters)
        qrot = cs.Rotation([tuple(x.transpose(1, 2) for x in st) for st in sets])
        row["dense_sdpa_ms"] = cs.device_ms(torch, lambda: F.scaled_dot_product_attention(
            *qrot.next()), args.iters)
        if bool(keep.all()):
            row["library_ms"], row["library"] = row["dense_sdpa_ms"], "SDPA without a mask"
        else:
            mask = keep[None]
            row["library_ms"] = cs.device_ms(torch, lambda: F.scaled_dot_product_attention(
                *qrot.next(), attn_mask=mask), args.iters)
            row["library"] = "SDPA with the expanded boolean element mask"
        nq = S // block
        row["bound_ms"], row["bound_by"] = cs.bound_ms(
            4 * B * S * H * D * 2 + (1 + int(per_row.max())) * H * nq * 4,
            4.0 * B * pairs * D, peaks)
        row["hi_lo_floor_ms"] = 6.0 * B * pairs * D / peaks[1] * 1e3
        emit(row)
        del sets, qrot, keep
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
