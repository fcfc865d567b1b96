#!/usr/bin/env python3
"""Plant faults in copies of the fused FFN's bf16 Hopper kernels (dw_sm90_kernel,
and the forward's and dx's tensor-core GEMMs) and show whether the chip
smoke's checks catch them.

    python3 scripts/fused_mlp_planted_faults.py [--out DIR]

Run from the root of the repository on a machine with an NVIDIA Hopper card.
Each variant is a copy of ``deepspeed_tpu_torch`` and ``chip_smoke.py`` in a
temporary directory (outside the repository), with at most one kind of
edit to ``csrc/fused_mlp.cu`` or ``csrc/gemm_sm90.cuh``; the copies'
``fused_mlp`` libraries are built all at once, then each variant runs in a
process of its own. In dw_sm90_kernel:

- ``du_lo_dropped``: du enters dw1's products as its bf16 hi half alone.
- ``chunk_u_partial_dropped``: the cluster's sum of u leaves out the last
  E-chunk's partial (dh keeps every chunk's).
- ``last_segment_dropped``: the CTAs of the last row segment take no tiles.

In the forward's and dx's tensor-core GEMMs:

- ``h_b1_dropped``: h_sm90_kernel's epilogue adds no b1 before the GELU.
- ``k_stage_dropped``: both mainloops (gemm_sm90.cuh) overwrite their sums
  at the second stage of every tile, dropping the first stage's products.
- ``du_gelu_for_grad``: du_sm90_kernel multiplies dh by gelu_tanh, not its
  derivative.
- ``last_split_dropped``: the sum of the splits of F leaves out the last.
- ``u_rounded_bf16``: h_sm90_kernel rounds u to bf16 before adding b1.

The cases: for the dw faults ``chip_smoke.run_dw_checks`` (the dw kernel at
the smoke's bf16 shapes, gpt2-125m's FFN at R = 24576, 2048, 8 and 1000 and
E = 64, 384 and 768 at other rows and hidden widths, each held as the smoke
holds it: every output within ``mlp_limit`` of the plain version and of
the plain model of the kernel's order, finite, a bitwise repeat, exact
launches by kernel; and ``dw_cancel_probe``); for the forward and dx faults
``chip_smoke.run_fwd_dx_checks`` (both entries at gpt2-125m's shapes held
the same way, also under plans forced to three row chunks, and ``fwd_cancel_probe`` and ``dx_cancel_probe``, where fp32
intermediates carry the result through cancellation); the clean copy runs
both. One JSON line per variant and case; each fault must fail one case at
least. The last line is the verdict; the exit code is 0 when the clean copy
passes and every fault is caught.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "fused_mlp.cu"
# variant: [(text, replacement)] in SOURCE, or [(file, text, replacement)]
# in another file of csrc/
FAULTS = {
    "clean": [],
    "du_lo_dropped": [("      s9::split_hi_lo(h[0], h[1], w[2][0], w[3][0]);\n",
                       "      w[1][0] = w[1][1] = 0u;\n"
                       "      s9::split_hi_lo(h[0], h[1], w[2][0], w[3][0]);\n")],
    "chunk_u_partial_dropped": [
        ("        u.x += uq.x;\n        u.y += uq.y;\n        u.z += uq.z;\n        u.w += uq.w;\n",
         "        if (q < n - 1) {\n          u.x += uq.x;\n          u.y += uq.y;\n"
         "          u.z += uq.z;\n          u.w += uq.w;\n        }\n")],
    "last_segment_dropped": [
        ("  const int t0 = blockIdx.y * tiles_per_seg, t1 = min(row_tiles, t0 + tiles_per_seg);\n",
         "  const int t0 = blockIdx.y * tiles_per_seg,\n"
         "            t1 = gridDim.y > 1 && blockIdx.y == gridDim.y - 1\n"
         "                     ? t0 : min(row_tiles, t0 + tiles_per_seg);\n")],
    "h_b1_dropped": [
        ("acc[h][4 * j + c] = gelu_tanh(acc[h][4 * j + c] + b);",
         "acc[h][4 * j + c] = gelu_tanh(acc[h][4 * j + c]);"),
        ("acc[h][4 * j + 2 + c] = gelu_tanh(acc[h][4 * j + 2 + c] + b);",
         "acc[h][4 * j + 2 + c] = gelu_tanh(acc[h][4 * j + 2 + c]);")],
    "k_stage_dropped": [   # in both schedules (gemm, gemm_pingpong)
        ("gemm_sm90.cuh", "const int scale = (kb | kk) != 0;\n        const bf16* s0 = st;",
         "const int scale = (kb | kk) != 0 && !(kb == 1 && kk == 0);\n"
         "        const bf16* s0 = st;"),
        ("gemm_sm90.cuh", "const int scale = (kb | kk) != 0;\n        mma_k16<C::BN, C::TB0>(acc[0]",
         "const int scale = (kb | kk) != 0 && !(kb == 1 && kk == 0);\n"
         "        mma_k16<C::BN, C::TB0>(acc[0]")],
    "du_gelu_for_grad": [
        ("gelu_tanh_grad(acc[0][4 * j + c] + b)", "gelu_tanh(acc[0][4 * j + c] + b)"),
        ("gelu_tanh_grad(acc[0][4 * j + 2 + c] + b)", "gelu_tanh(acc[0][4 * j + 2 + c] + b)")],
    "last_split_dropped": [
        ("return reduce<bf16>(part, splits, stride, stride, b2, E, out, st);",
         "return reduce<bf16>(part, splits - 1, stride, stride, b2, E, out, st);")],
    "u_rounded_bf16": [
        ("acc[h][4 * j + c] = gelu_tanh(acc[h][4 * j + c] + b);",
         "acc[h][4 * j + c] = gelu_tanh(ds::round_to<bf16>(acc[h][4 * j + c]) + b);"),
        ("acc[h][4 * j + 2 + c] = gelu_tanh(acc[h][4 * j + 2 + c] + b);",
         "acc[h][4 * j + 2 + c] = gelu_tanh(ds::round_to<bf16>(acc[h][4 * j + 2 + c]) + b);")],
}
# the checks each variant runs: the dw kernel's, the forward's and dx's, or both
DW_FAULTS = ("du_lo_dropped", "chunk_u_partial_dropped", "last_segment_dropped")
CHECKS = {v: ("dw",) if v in DW_FAULTS else ("dw", "fwd_dx") if v == "clean" else ("fwd_dx",)
          for v in FAULTS}
BUILD = ("import sys; sys.path.insert(0, '.'); from deepspeed_tpu_torch.ops import _build; "
         "_build.build_all(['fused_mlp'])")


def make_copy(variant: str) -> str:
    """A temporary copy of the port with the variant's edits; its path."""
    tmp = tempfile.mkdtemp(prefix=f"fused_mlp_{variant}_")
    shutil.copytree(os.path.join(ROOT, "deepspeed_tpu_torch"),
                    os.path.join(tmp, "deepspeed_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
    csrc = os.path.join(tmp, "deepspeed_tpu_torch", "ops", "csrc")
    for edit in FAULTS[variant]:
        name, text, repl = edit if len(edit) == 3 else (SOURCE, *edit)
        path = os.path.join(csrc, name)
        with open(path) as fh:
            src = fh.read()
        if src.count(text) != 1:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(f"{variant}: the text to edit occurs {src.count(text)} times "
                               f"in {name}")
        with open(path, "w") as fh:
            fh.write(src.replace(text, repl))
    return tmp


def run_cases(variant: str) -> None:
    """In a copy's process: hold each case, one JSON line each."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import fused_mlp as fm

    if not fm.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"imported {fm.__file__}, not the copy in {os.getcwd()}")
    cs.emit = lambda obj: print(json.dumps(dict(variant=variant, **obj)), flush=True)
    if "dw" in CHECKS[variant]:
        cs.run_dw_checks(torch)
    if "fwd_dx" in CHECKS[variant]:
        cs.run_fwd_dx_checks(torch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the JSON lines")
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant:
        run_cases(args.variant)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("fused_mlp_planted_faults: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [dict(card=card.strip().splitlines()[0] if card.strip() else "unavailable")]
    print(json.dumps(lines[0]), flush=True)
    copies = {v: make_copy(v) for v in FAULTS}
    verdict = {}
    try:
        builds = {v: subprocess.Popen([sys.executable, "-c", BUILD], cwd=tmp,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                  for v, tmp in copies.items()}
        built = {v: p.communicate(timeout=900)[0] for v, p in builds.items()}
        for variant, tmp in copies.items():
            if builds[variant].returncode:
                print(built[variant][-4000:], file=sys.stderr)
                verdict[variant] = "did not build"
                continue
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant",
                                  variant], cwd=tmp, capture_output=True, text=True, timeout=900)
            rows = [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]
            lines += rows
            if run.returncode != 0 or not rows:
                print(run.stderr[-4000:], file=sys.stderr)
                verdict[variant] = "did not run"
                continue
            failed = [f"{r['name']} {r['shape']}" for r in rows if not r["ok"]]
            verdict[variant] = dict(
                cases=len(rows), cases_failed=len(failed), first_failed=failed[:6],
                largest_err_over_limit=max(r["err_over_limit"] for r in rows),
                largest_vs_tiled_over_limit=max(r.get("tiled_err_over_limit", 0.0) for r in rows),
                as_expected=not failed if variant == "clean" else bool(failed))
            print(json.dumps(dict(variant=variant, **verdict[variant])), flush=True)
    finally:
        for tmp in copies.values():
            shutil.rmtree(tmp, ignore_errors=True)
    ok = all(isinstance(verdict[v], dict) and verdict[v]["as_expected"] for v in FAULTS)
    lines.append(dict(verdict=verdict, ok=ok))
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fused_mlp_planted_faults.jsonl"), "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
