#!/usr/bin/env python3
"""Plant faults in copies of the split decode and paged attention kernels and
show whether the chip smoke's decode checks catch them.

    python3 scripts/decode_planted_faults.py [--out DIR]

Run from the root of the repository on a machine with an NVIDIA Hopper card.
Each variant is a copy of ``deepspeed_tpu_torch`` and ``chip_smoke.py`` in a
temporary directory (outside the repository), with at most one edit to
``csrc/decode_split.cuh`` (the design both kernels share, so each fault hits
both), built there and run in a process of its own:

- ``clean``: no edit; every case must pass.
- ``merge_drop_last_chunk``: the merge kernel skips a row's last live chunk.
- ``merge_no_rescale``: the merge sums the chunks' states without
  e^(m_i - M).
- ``load_dead_rows``: rows past L are copied from the cache instead of
  zero-filled, so the NaN that the cases hold at every dead position
  reaches p @ V.

The cases are ``chip_smoke.decode_split_cases`` (decode and paged, bf16 and
fp32, lengths around the 64-position chunks, NaN in every dead position),
held by ``chip_smoke.run_decode_split_checks``: each element within its limit
against the plain version, the fp64 anchor, L = 0 rows zero, finite outputs,
a bitwise repeat. One JSON line per variant and case; each fault must fail
one case at least. The last line is the verdict; the exit code is 0 when the
clean copy passes and every fault is caught.
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
SOURCE = "decode_split.cuh"
# variant: [(text, replacement)] in SOURCE
FAULTS = {
    "clean": [],
    "merge_drop_last_chunk": [("  for (int i = 0; i < nc; ++i) {\n",
                               "  for (int i = 0; i < nc - 1; ++i) {\n")],
    "merge_no_rescale": [
        ("    const float w = st[head_dim] == -INFINITY ? 0.f : expf(st[head_dim] - M);\n",
         "    const float w = st[head_dim] == -INFINITY ? 0.f : 1.f;\n")],
    "load_dead_rows": [
        ("      const bool live = r < n;   // rows at or past L: zero-filled, never read\n",
         "      const bool live = c0 + r < map.total();\n")],
}


def make_copy(variant: str) -> str:
    """A temporary copy of the port with the variant's edits; its path."""
    tmp = tempfile.mkdtemp(prefix=f"decode_{variant}_")
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
    from deepspeed_tpu_torch.ops import decode_attention as da

    if not da.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"imported {da.__file__}, not the copy in {os.getcwd()}")
    cs.emit = lambda obj: print(json.dumps(dict(variant=variant, **obj)), flush=True)
    cs.run_decode_split_checks(torch)


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
        print("decode_planted_faults: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [dict(card=card.strip().splitlines()[0] if card.strip() else "unavailable")]
    print(json.dumps(lines[0]), flush=True)
    verdict = {}
    for variant in FAULTS:
        tmp = make_copy(variant)
        try:
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant", variant],
                                 cwd=tmp, capture_output=True, text=True, timeout=900)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rows = [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]
        for row in rows:
            print(json.dumps(row), flush=True)
        lines += rows
        if run.returncode != 0 or not rows:
            print(run.stderr[-4000:], file=sys.stderr)
            verdict[variant] = "did not run"
            continue
        failed = [r["case"] for r in rows if not r["ok"]]
        verdict[variant] = dict(
            cases_failed=failed,
            largest_err_over_limit=max(r["err_over_limit"] for r in rows),
            as_expected=not failed if variant == "clean" else bool(failed))
    ok = all(isinstance(verdict[v], dict) and verdict[v]["as_expected"] for v in FAULTS)
    lines.append(dict(verdict=verdict, ok=ok))
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "decode_planted_faults.jsonl"), "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
