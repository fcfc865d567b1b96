#!/usr/bin/env python3
"""Plant faults in copies of the LayerNorm backward and softmax forward
kernels (``csrc/fused_ops.cu``) and show whether the chip smoke's checks
catch them.

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
- ``softmax_masked_unwritten``: the held softmax kernel writes no group of
  8 columns that lies wholly past the row's kept keys.
- ``softmax_nan_row_lost``: l is guarded (0 read as 1) where a masked
  key's 0 / l is formed, so a row that keeps no key comes out as zeros
  instead of NaN.
- ``softmax_next_row_as_current``: the next row's loads (and its index) go
  into the buffer of the row about to be computed, so that row is computed
  from the next row's scores and the row itself is never written.
- ``softmax_tail_dropped``: with Sk % 8 != 0, a row's last group of under 8
  columns is not written.
- ``softmax_max_per_lane``: each lane shifts its exponents by its own max,
  without the warp's reduction.

The cases are ``chip_smoke.run_ln_bwd_checks`` (bf16 (8192, 1024), fp32
(333, 1001), (64, 1024) and (97, 2050), bf16 (300, 1000), each against the
plain version within the smoke's limit and against the tiled plain version
bit for bit, repeated bit for bit) and ``chip_smoke.run_softmax_fwd_checks``
(``SOFTMAX_FWD_CHECKS``: each against the plain version within the smoke's
limit, and twice on output memory filled with NaN: the same bits, masked
keys 0, rows that keep no key NaN). One JSON line per variant and case;
each fault must fail one case at least; the last line is the verdict.
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
    "softmax_masked_unwritten": [
        ("        if (c < Sk) {\n          float q[8];\n",
         "        if (c < r.lim) {\n          float q[8];\n")],
    "softmax_nan_row_lost": [
        ("    const float z = in_range ? 0.f : 0.f / l;",
         "    const float z = in_range ? 0.f : 0.f / fmaxf(l, 1.f);")],
    "softmax_next_row_as_current": [
        ("        if (k + PD < rows_per_warp) load_row(k + PD, (b + PD) % (PD + 1));\n",
         "        if (k + PD < rows_per_warp) load_row(k + PD, b);\n")],
    "softmax_tail_dropped": [
        ("        if (c < Sk) {\n          float q[8];\n",
         "        if (c + 8 <= Sk) {\n          float q[8];\n")],
    "softmax_max_per_lane": [
        ("    m = warp_max(m);\n    if (m == -INFINITY) m = 0.f;\n    float e[NC][8]",
         "    if (m == -INFINITY) m = 0.f;\n    float e[NC][8]")],
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
    cs.run_softmax_fwd_checks(torch)


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
