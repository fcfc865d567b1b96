#!/usr/bin/env python3
"""Plant faults in copies of the W8A16 matmul (the W8 instantiation of the
tensor-core decode GEMV) and show whether the chip smoke's checks catch them.

    python3 scripts/w8_planted_faults.py [--out DIR]

Run from the root of the repository on a machine with an NVIDIA Hopper card.
Each variant is a copy of ``deepspeed_tpu_torch`` and ``chip_smoke.py`` in a
temporary directory (outside the repository), with at most one kind of
edit to ``csrc/decode_gemv_sm90.cuh``; the copies' ``w8_matmul`` libraries
are built all at once, then each variant runs in a process of its own:

- ``clean``: no edit; every case must pass.
- ``next_group_scale``: each stage stages the scale row of the next group
  (the last group's for the last): every fold takes a scale one group off.
- ``split_partial_dropped``: the last block of a column tile sums the
  slices' partials from the second on, leaving out the first slice's.
- ``code_sign_dropped``: codes become bf16 without their sign bit.

The cases are ``chip_smoke.run_w8_matmul_checks`` (gpt2-760m's panels at M
= 1, 8, 37 and 64 with 128-row groups and 1536->1536 with one group,
llama-1b's and pythia-1b's at M = 8 and 64), each held as the smoke holds
it: every element within ``w8_limits`` of the plain version, of its tiled
order and of the fp64 value, a bitwise repeat, exact launches by kernel.
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
SOURCE = "decode_gemv_sm90.cuh"
# variant: [(text, replacement)] in SOURCE
FAULTS = {
    "clean": [],
    "next_group_scale": [("      const int u = kb / p.group;\n",
                          "      const int u = min(kb / p.group + 1, p.K / p.group - 1);\n")],
    "split_partial_dropped": [("      for (int q = 0; q < n_splits; ++q) {\n",
                               "      for (int q = 1; q < n_splits; ++q) {\n")],
    "code_sign_dropped": [("  const uint32_t s = (w & 0x00800080u) | 0x43004300u;\n",
                           "  const uint32_t s = 0x43004300u;\n")],
}
BUILD = ("import sys; sys.path.insert(0, '.'); from deepspeed_tpu_torch.ops import _build; "
         "_build.build_all(['w8_matmul'])")


def make_copy(variant: str) -> str:
    """A temporary copy of the port with the variant's edits; its path."""
    tmp = tempfile.mkdtemp(prefix=f"w8_{variant}_")
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

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import w8_matmul as wm

    if not wm.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"imported {wm.__file__}, not the copy in {os.getcwd()}")
    cs.emit = lambda obj: print(json.dumps(dict(variant=variant, **obj)), flush=True)
    cs.run_w8_matmul_checks(torch)


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
        print("w8_planted_faults: no CUDA device", file=sys.stderr)
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
                largest_vs_fp64_over_limit=max(r["fp64_err_over_limit"] for r in rows),
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
        with open(os.path.join(args.out, "w8_planted_faults.jsonl"), "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
