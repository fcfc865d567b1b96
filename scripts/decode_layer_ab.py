#!/usr/bin/env python3
"""Time one tree's fused decode-layer kernels (norm -> projection, and
o-proj -> norm -> MLP -> residual) at the serving models' shapes, beside
the bound.

    python3 scripts/decode_layer_ab.py [--tree DIR] [--label NAME] [--out FILE]

Run on a machine with an NVIDIA Hopper card. ``--tree`` is the root of a
checkout whose ``deepspeed_tpu_torch`` is built and timed (default: this
repository), so that two commits can be compared in one call on one card,
run in turns (parent, change, change, parent), each in a process of its
own. Both trees are driven through the public entry points,
``fused_norm_proj`` and ``fused_post_attn``, in bf16. The helpers (rotation
of input sets past the L2, device time from the profiler, CUDA-event time,
bounds) are this repository's ``chip_smoke.py``.

Cases, each at M = 8 and M = 64 decode rows (random weights from a seed;
W8A16 with 128-row scale groups):

- post_attn: gpt2-125m (E=768, F=3072, LayerNorm, tanh GELU) bf16;
  gpt2-760m (E=1536, F=6144) W8; llama-1b (E=2048, F=8192, RMSNorm, SwiGLU)
  bf16 and W8; pythia-1b (E=2048, F=8192, LayerNorm, exact GELU, parallel
  residual) bf16 and W8.
- norm_proj: gpt2-125m qkv (E=768, N=2304) bf16; gpt2-760m qkv (E=1536,
  N=4608) W8; llama-1b q (N=2048) and k/v (N=256) RMSNorm, bf16 and W8;
  pythia-1b qkv (N=6144) bf16 and W8.

One JSON line per case, ms per call: the kernels' device time from the
profiler, summed (``device_ms``) and as the union of their intervals
(``device_union_ms``: a programmatic dependent launch overlaps the kernel
before it, which the sum counts twice); CUDA events around back-to-back
calls (``event_ms``: the host's enqueue where it is slower than the card);
CUDA events around a CUDA graph of 20 calls (``graph_ms``: the card's time
without the host); the summed device ms by kernel name (``by_kernel``); and
the bound (bytes: each input read once, each output written once, at the
card's memory rate).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, kind, E, N or F, weights, norm and MLP flags)
CASES = (
    ("post_attn_tanh_125m", "post_attn", 768, 3072, "bf16", {}),
    ("post_attn_w8_760m", "post_attn", 1536, 6144, "w8", {}),
    ("post_attn_swiglu_l1b", "post_attn", 2048, 8192, "bf16", dict(swiglu=True, rms=True)),
    ("post_attn_swiglu_w8_l1b", "post_attn", 2048, 8192, "w8", dict(swiglu=True, rms=True)),
    ("post_attn_erf_par_p1b", "post_attn", 2048, 8192, "bf16",
     dict(exact_gelu=True, parallel_residual=True)),
    ("post_attn_erf_par_w8_p1b", "post_attn", 2048, 8192, "w8",
     dict(exact_gelu=True, parallel_residual=True)),
    ("norm_proj_ln_125m_qkv", "norm_proj", 768, 2304, "bf16", {}),
    ("norm_proj_ln_w8_760m_qkv", "norm_proj", 1536, 4608, "w8", {}),
    ("norm_proj_rms_l1b_q", "norm_proj", 2048, 2048, "bf16", dict(rms=True)),
    ("norm_proj_rms_l1b_kv", "norm_proj", 2048, 256, "bf16", dict(rms=True)),
    ("norm_proj_rms_w8_l1b_q", "norm_proj", 2048, 2048, "w8", dict(rms=True)),
    ("norm_proj_rms_w8_l1b_kv", "norm_proj", 2048, 256, "w8", dict(rms=True)),
    ("norm_proj_ln_p1b_qkv", "norm_proj", 2048, 6144, "bf16", {}),
    ("norm_proj_ln_w8_p1b_qkv", "norm_proj", 2048, 6144, "w8", {}),
)
GROUP = 128


def panel_bytes(K: int, N: int, w8: bool) -> int:
    """A panel's bytes: bf16 values, or int8 codes and their fp32 scales."""
    return K * N + K // GROUP * N * 4 if w8 else 2 * K * N


def case_bytes(kind: str, M: int, E: int, N: int, w8: bool, kw: dict) -> int:
    """The bytes one call must move: each input once, each output once."""
    if kind == "norm_proj":
        return (panel_bytes(E, N, w8) + 2 * M * E + 2 * M * N + 2 * N
                + (1 if kw.get("rms") else 2) * 4 * E)
    n_up = 2 if kw.get("swiglu") else 1
    biases = 2 * E + (0 if kw.get("swiglu") else 2 * (N + E))
    return (panel_bytes(E, E, w8) + n_up * panel_bytes(E, N, w8) + panel_bytes(N, E, w8)
            + 3 * 2 * M * E + biases + (1 if kw.get("rms") else 2) * 4 * E)


def case_flops(kind: str, M: int, E: int, N: int, kw: dict) -> int:
    if kind == "norm_proj":
        return 2 * M * E * N
    return 2 * M * (E * E + (3 if kw.get("swiglu") else 2) * E * N)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="file the JSON lines are appended to")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rows", default="8,64", help="decode rows M, comma-separated")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, tree)   # the package from the tree; the helpers from this repository
    import torch

    if not torch.cuda.is_available():
        print("decode_layer_ab: no CUDA device", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import decode_layer as dl

    if not dl.__file__.startswith(tree):
        raise RuntimeError(f"imported {dl.__file__}, not the tree's")
    _build.build_all(["decode_layer"])
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

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 40)
    bf = torch.bfloat16

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    def panel(K, N, w8):
        return cs.w8_panels(torch, g, K, N, GROUP, 1)[0] if w8 else rn(K, N, std=0.02)

    for M in (int(m) for m in args.rows.split(",")):
        for name, kind, E, N, wkind, kw in CASES:
            w8 = wkind == "w8"
            nbytes = case_bytes(kind, M, E, N, w8, kw)
            n_sets = max(2, -(-60_000_000 // nbytes))
            sets = []
            for _ in range(n_sets):
                ns = 1 + rn(E, std=0.1, dtype=torch.float32)
                nb = None if kw.get("rms") else rn(E, std=0.1, dtype=torch.float32)
                if kind == "norm_proj":
                    sets.append((rn(M, E), ns, nb, panel(E, N, w8), rn(N, std=0.02)))
                elif kw.get("swiglu"):
                    sets.append((rn(M, E), rn(M, E), panel(E, E, w8), rn(E, std=0.02), ns, nb,
                                 (panel(E, N, w8), panel(E, N, w8), panel(N, E, w8))))
                else:
                    sets.append((rn(M, E), rn(M, E), panel(E, E, w8), rn(E, std=0.02), ns, nb,
                                 (panel(E, N, w8), rn(N, std=0.02), panel(N, E, w8),
                                  rn(E, std=0.02))))
            rot = cs.Rotation(sets)
            if kind == "norm_proj":
                def call():
                    x, ns, nb, w, b = rot.next()
                    return dl.fused_norm_proj(x, ns, nb, w, b, rms=kw.get("rms", False))
            else:
                def call():
                    return dl.fused_post_attn(*rot.next(), **kw)
            b_ms, b_by = cs.bound_ms(nbytes, case_flops(kind, M, E, N, kw), peaks)
            dims = f"M={M} E={E} " + ("N" if kind == "norm_proj" else "F") + f"={N}"
            sum_ms, union_ms = cs.device_union_ms(torch, call, args.iters)
            by_kernel = cs.device_ms_by_name(torch, call, args.iters)[1]
            g_ms, g_err = cs.graph_ms(torch, call, 20)
            emit(dict(case=name, shape=dims + (f" W8 g={GROUP}" if w8 else " bf16"),
                      device_ms=sum_ms, device_union_ms=union_ms,
                      event_ms=cs.cuda_ms(torch, call, args.iters), graph_ms=g_ms,
                      **({"graph_error": g_err} if g_err else {}),
                      bound_ms=b_ms, bound_by=b_by,
                      by_kernel={k[:80]: v for k, v in by_kernel.items()}))
            del sets, rot
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
