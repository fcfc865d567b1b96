#!/usr/bin/env python3
"""Plant faults in copies of the fused CE head's tensor-core kernels
(``csrc/fused_ce.cu``) and show whether the chip smoke's checks catch them.

    python3 scripts/fused_ce_planted_faults.py [--out DIR]

Run from the root of the repository on a machine with an NVIDIA Hopper card.
Each variant is a copy of ``deepspeed_tpu_torch`` and ``chip_smoke.py`` in a
temporary directory (outside the repository), with at most one kind of
edit to ``csrc/fused_ce.cu``; the copies' ``fused_ce`` libraries are built
all at once, then each variant runs in a process of its own:

- ``clean``: no edit; every case must pass.
- ``vocab_mask_dropped``: the forward and dlog epilogues take the padded
  vocab columns (vocab_size <= v < Vp) into the softmax.
- ``k_step_dropped``: every GEMM leaves out its last 64-wide K step.
- ``dlog_chunk_dropped``: the backward skips its second vocab chunk (of
  three or more).
- ``onehot_not_subtracted``: dlog = p at the label too.
- ``ignored_rows_not_zeroed``: ignore_index rows keep their dlog.

The cases are ``chip_smoke.run_fused_ce_checks``: the smoke's shapes (the
1.5B head, gpt2-125m's micro-batch, a ragged shape in bf16 and in fp32,
a ragged bf16 shape with E % 8 != 0 on the CUDA-core kernels),
each held as the smoke holds it (nll and lse within 1e-4 of max(1, |lse|),
dh and dw element by element within their limits, the limits' power,
finite, a bitwise repeat, exact launches), the mask probe and the
cancellation probe. One JSON line per variant and case; each fault must
fail one case at least. The last line is the verdict; the exit code is 0
when the clean copy passes and every fault is caught.
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
SOURCE = "fused_ce.cu"
# variant: [(text, replacement)] in SOURCE
FAULTS = {
    "clean": [],
    "vocab_mask_dropped": [
        ("          if (v >= a.vocab) acc[i] = v >= a.Vp ? -INFINITY : kNeg;\n",
         "          if (v >= a.Vp) acc[i] = -INFINITY;\n"),
        ("        acc[i] = edge && v0 + acc_col(i) + 2 * t >= a.vocab ? 0.f : p;\n",
         "        acc[i] = edge && v0 + acc_col(i) + 2 * t >= a.Vp ? 0.f : p;\n")],
    "k_step_dropped": [
        ("  const int KB = (K + kTK - 1) / kTK;\n",
         "  const int KB = (K + kTK - 1) / kTK - (K > kTK ? 1 : 0);\n")],
    "dlog_chunk_dropped": [
        ("    cudaError_t err =\n        launch_gemm<kDlog>(",
         "    if (c0 == chunk && !a.last) continue;\n    cudaError_t err =\n"
         "        launch_gemm<kDlog>(")],
    "onehot_not_subtracted": [
        ("            if (acc_row(i) == rr && acc_col(i) == cc) acc[i] -= 1.f;\n",
         "            if (acc_row(i) == rr && acc_col(i) == cc) acc[i] -= 0.f;\n")],
    "ignored_rows_not_zeroed": [
        ("        valid[rr] = n < a.N && lab[rr] != a.ignore;\n",
         "        valid[rr] = n < a.N;\n")],
}
BUILD = ("import sys; sys.path.insert(0, '.'); from deepspeed_tpu_torch.ops import _build; "
         "_build.build_all(['fused_ce'])")


def make_copy(variant: str) -> str:
    """A temporary copy of the port with the variant's edits; its path."""
    tmp = tempfile.mkdtemp(prefix=f"fused_ce_{variant}_")
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
    from deepspeed_tpu_torch.ops import fused_ce as ce

    if not ce.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"imported {ce.__file__}, not the copy in {os.getcwd()}")
    cs.emit = lambda obj: print(json.dumps(dict(variant=variant, **obj)), flush=True)
    cs.run_fused_ce_checks(torch)


def worst(row) -> float:
    """The row's largest error in units of its limit (nll and lse: of their
    tolerance)."""
    parts = [row.get("err_over_limit", 0.0)]
    for k in ("dh", "dw"):
        if isinstance(row.get(k), dict):
            parts.append(row[k]["err_over_limit"])
    if isinstance(row.get("fwd"), dict):
        parts.append(row["fwd"]["max_err"] / row["fwd"]["tol"])
    elif "tol" in row:
        parts.append(row["max_err"] / row["tol"])
    return max(parts)


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
        print("fused_ce_planted_faults: no CUDA device", file=sys.stderr)
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
            failed = [f"{r.get('name', r['phase'])} {r['shape']}" for r in rows if not r["ok"]]
            verdict[variant] = dict(
                cases=len(rows), cases_failed=len(failed), first_failed=failed[:6],
                largest_err_over_limit=max(worst(r) for r in rows),
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
        with open(os.path.join(args.out, "fused_ce_planted_faults.jsonl"), "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
