#!/usr/bin/env python3
"""Plant faults in copies of the tensor-core block-sparse attention kernel
and show whether the chip smoke's sparse checks catch them.

    python3 scripts/sparse_planted_faults.py [--out DIR]

Run from the root of the repository on a machine with an NVIDIA Hopper card.
Each variant is a copy of ``deepspeed_tpu_torch`` and ``chip_smoke.py`` in a
temporary directory (outside the repository), with at most one edit to
``csrc/sparse_attention.cu``; the copies' libraries are built all at once,
then each variant runs in a process of its own:

- ``clean``: no edit; every case must pass.
- ``p_without_lo``: o += p v takes p's bf16 hi half only (p rounded to bf16,
  as a flash forward rounds it).
- ``merge_drop_last_piece``: the merge kernel leaves out a split tile's last
  piece.
- ``merge_no_rescale``: the merge sums the pieces' states without
  2^(m_i - M).
- ``union_bit_ignored``: a row sees every unit of its tile's union, so a
  query block sees key blocks its own LUT row lacks.
- ``causal_off_by_one``: the causal mask lets each row see the key after
  its own position.

The cases are ``chip_smoke.run_kernels_sparse`` untimed (every sparse
layout of the smoke, bf16 and fp32, D = 64 and 128, blocks 16 to 128),
each held as the smoke holds it: every element within one ulp plus 1e-5 of
sum_j p_j |v_j| / l of the plain version, the fp64 anchor, the tiled plain
version, empty rows zero, finite outputs, a bitwise repeat, exact launches.
One JSON line per variant and case; each fault must fail one case at
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
SOURCE = "sparse_attention.cu"
# variant: [(text, replacement)] in SOURCE
FAULTS = {
    "clean": [],
    "p_without_lo": [("      wgmma_rs<D, 1>(o, lo[kk], dv, 1);\n", "")],
    "merge_drop_last_piece": [("    for (int p = 0; p < mg.z; ++p) {\n",
                               "    for (int p = 0; p < mg.z - 1; ++p) {\n")],
    "merge_no_rescale": [("      const float w = mi == -INFINITY ? 0.f : exp2f(mi - M);\n",
                          "      const float w = mi == -INFINITY ? 0.f : 1.f;\n")],
    "union_bit_ignored": [("      on[g] = (w >> (kRowBits + qslot)) & 1;\n",
                           "      on[g] = (w >> kRowBits) != 0;\n")],
    "causal_off_by_one": [("causal && key > row)) sc[i]", "causal && key > row + 1)) sc[i]")],
}
BUILD = ("import sys; sys.path.insert(0, '.'); from deepspeed_tpu_torch.ops import _build; "
         "_build.build_all(['sparse_attention'])")


def make_copy(variant: str) -> str:
    """A temporary copy of the port with the variant's edits; its path."""
    tmp = tempfile.mkdtemp(prefix=f"sparse_{variant}_")
    shutil.copytree(os.path.join(ROOT, "deepspeed_tpu_torch"),
                    os.path.join(tmp, "deepspeed_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
    path = os.path.join(tmp, "deepspeed_tpu_torch", "ops", "csrc", SOURCE)
    with open(path) as fh:
        src = fh.read()
    for text, repl in FAULTS[variant]:
        if src.count(text) != 1:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(f"{variant}: the text to edit occurs {src.count(text)} times "
                               f"in {SOURCE}")
        src = src.replace(text, repl)
    with open(path, "w") as fh:
        fh.write(src)
    return tmp


def run_cases(variant: str) -> None:
    """In a copy's process: hold each case, one JSON line each."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ssa

    if not ssa.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"imported {ssa.__file__}, not the copy in {os.getcwd()}")
    cs.emit = lambda obj: print(json.dumps(dict(variant=variant, **obj)), flush=True)
    cs.run_kernels_sparse(torch, F, cs.card_peaks(torch.cuda.get_device_name(0)), timed=False)


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
        print("sparse_planted_faults: no CUDA device", file=sys.stderr)
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
            for row in rows:
                print(json.dumps(row), flush=True)
            lines += rows
            if run.returncode != 0 or not rows:
                print(run.stderr[-4000:], file=sys.stderr)
                verdict[variant] = "did not run"
                continue
            failed = [f"{r['case']} {r['phase']}" for r in rows if not r["ok"]]
            verdict[variant] = dict(
                cases_failed=failed,
                largest_err_over_limit=max(r["err_over_limit"] for r in rows),
                as_expected=not failed if variant == "clean" else bool(failed))
    finally:
        for tmp in copies.values():
            shutil.rmtree(tmp, ignore_errors=True)
    ok = all(isinstance(verdict[v], dict) and verdict[v]["as_expected"] for v in FAULTS)
    lines.append(dict(verdict=verdict, ok=ok))
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "sparse_planted_faults.jsonl"), "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
