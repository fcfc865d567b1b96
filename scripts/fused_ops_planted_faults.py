#!/usr/bin/env python3
"""Plant faults in copies of the LayerNorm backward kernels
(``csrc/fused_ops.cu``) and show whether the chip smoke's checks catch them.

    python3 scripts/fused_ops_planted_faults.py [--out DIR]

Run from the root of the repository on a machine with an NVIDIA Hopper card,
as ``scripts/adam8bit_planted_faults.py`` runs (one temporary copy of the
port and ``chip_smoke.py`` a variant, built at once, run one at a time):

- ``clean``: no edit; every case must pass.
- ``warp_dgamma_dropped``: warp 3's dgamma sums never reach the block's
  partial row.
- ``dx_m2_dropped``: dx = rstd (dŷ − mean(dŷ)), without its x̂·mean(dŷ·x̂)
  term.
- ``ragged_tail_dropped``: with D % 8 != 0, a row's last chunk of under 8
  columns gets no dx and adds nothing to dgamma and dbeta.

The cases are ``chip_smoke.run_ln_bwd_checks``: bf16 (8192, 1024), fp32
(333, 1001), (64, 1024) and (97, 2050), bf16 (300, 1000), each against the
plain version within the smoke's limit and against the tiled plain version
bit for bit, repeated bit for bit. One JSON line per variant and case; each
fault must fail one case at least; the last line is the verdict.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from adam8bit_planted_faults import run_variants  # noqa: E402

SOURCE = "fused_ops"
FAULTS = {
    "clean": [],
    "warp_dgamma_dropped": [
        ("          red[warp >> 1][0][s * 256 + lane * 8 + i] = ag[s][i];\n",
         "          red[warp >> 1][0][s * 256 + lane * 8 + i] = warp == 3 ? 0.f : ag[s][i];\n")],
    "dx_m2_dropped": [
        ("          v[i] = rs[0] * (d * g[s][i] - m1 - xhat * m2);\n",
         "          v[i] = rs[0] * (d * g[s][i] - m1);\n")],
    "ragged_tail_dropped": [
        ("      if (c < D) {\n        xs[0][s].opaque();\n",
         "      if (c + 8 <= D) {\n        xs[0][s].opaque();\n")],
}


def run_cases(variant: str) -> None:
    """In a copy's process: hold each case, one JSON line each."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import fused_ops as fo

    if not fo.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"imported {fo.__file__}, not the copy in {os.getcwd()}")
    cs.emit = lambda obj: print(json.dumps(dict(variant=variant, **obj)), flush=True)
    cs.run_ln_bwd_checks(torch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the JSON lines")
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant:
        run_cases(args.variant)
        return 0
    return run_variants(os.path.abspath(__file__), SOURCE, FAULTS, args.out,
                        "fused_ops_planted_faults")


if __name__ == "__main__":
    sys.exit(main())
