#!/usr/bin/env python3
"""Plant faults in copies of the fused adam8bit kernel (``csrc/adam8bit.cu``)
and show whether the chip smoke's checks catch them.

    python3 scripts/adam8bit_planted_faults.py [--out DIR]

Run from the root of the repository on a machine with an NVIDIA Hopper card.
Each variant is a copy of ``deepspeed_tpu_torch`` and ``chip_smoke.py`` in a
temporary directory (outside the repository), with at most one kind of edit
to the source; the copies' libraries are built all at once, then each
variant runs in a process of its own:

- ``clean``: no edit; every case must pass.
- ``new_scale_read_as_old``: the two-pass path's second pass reads the
  row's scales from memory, where the new ones were already written, in
  place of the old ones every thread read before the barrier.
- ``first_barrier_dropped``: no barrier between the chunks' maxima (and the
  reads of the old scales) and the rows' reduction and new scales.
- ``last_leaf_dropped``: a table of several leaves launches without the
  last leaf's work items.
- ``ragged_tail_dropped``: a row's last chunk of under 8 elements is left
  out (ragged widths lose their scalar tail).
- ``r_absmax_one_group``: r's row maximum is one lane's strided share of
  the row, not the warp's.

The cases are ``chip_smoke.run_adam8bit_kernel``: the 1.5B leaf shapes, a
100000-wide row, three steps in place and the multi-leaf table (widths 1,
3, 17, 1600, 4800, 6400, 100000 and a 0-d leaf), each against the plain
version by ``adam8bit_ok``, repeated bit for bit, launches counted. One
JSON line per variant and case; each fault must fail one case at least.
The last line is the verdict; the exit code is 0 when the clean copy passes
and every fault is caught.
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
SOURCE = "adam8bit"
# variant: [(text, replacement)] in csrc/<SOURCE>.cu
FAULTS = {
    "clean": [],
    "new_scale_read_as_old": [
        ("static_cast<unsigned char>(byte_of(ch.rc, i)), om, orr, s.gscale, a, m[i], r[i]);",
         "static_cast<unsigned char>(byte_of(ch.rc, i)), L.scm[row], L.scr[row], s.gscale, a,"
         " m[i], r[i]);")],
    "first_barrier_dropped": [
        ("  __syncthreads();\n  // each row's maxima over its run of chunk entries\n",
         "  // each row's maxima over its run of chunk entries\n")],
    "last_leaf_dropped": [
        ("  adam8bit_kernel<<<n_items, kThreads",
         "  adam8bit_kernel<<<n_leaves > 1 ? t.first[n_leaves - 1] : n_items, kThreads")],
    "ragged_tail_dropped": [
        ("  const int nc = (L.C + 7) >> 3;\n  const int F = nrows * nc;\n",
         "  const int nc = L.C >> 3;\n  const int F = nrows * nc;\n")],
    "r_absmax_one_group": [
        ("      ar = warp_max(ar);\n      if (lane == 0) {\n", "      if (lane == 0) {\n")],
}


def make_copy(source: str, faults: dict, variant: str) -> str:
    """A temporary copy of the port with the variant's edits; its path."""
    tmp = tempfile.mkdtemp(prefix=f"{source}_{variant}_")
    shutil.copytree(os.path.join(ROOT, "deepspeed_tpu_torch"),
                    os.path.join(tmp, "deepspeed_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
    path = os.path.join(tmp, "deepspeed_tpu_torch", "ops", "csrc", f"{source}.cu")
    with open(path) as fh:
        src = fh.read()
    for text, repl in faults[variant]:
        if src.count(text) != 1:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(f"{variant}: the text to edit occurs {src.count(text)} times "
                               f"in {source}.cu")
        src = src.replace(text, repl)
    with open(path, "w") as fh:
        fh.write(src)
    return tmp


def run_variants(script: str, source: str, faults: dict, out_dir, out_name: str) -> int:
    """Build every variant's copy at once, run ``script --variant V`` in each
    copy, print and keep the lines, and give the verdict."""
    import torch

    if not torch.cuda.is_available():
        print(f"{out_name}: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [dict(card=card.strip().splitlines()[0] if card.strip() else "unavailable")]
    print(json.dumps(lines[0]), flush=True)
    copies = {v: make_copy(source, faults, v) for v in faults}
    build = ("import sys; sys.path.insert(0, '.'); from deepspeed_tpu_torch.ops import _build; "
             f"_build.build_all(['{source}'])")
    verdict = {}
    try:
        builds = {v: subprocess.Popen([sys.executable, "-c", build], cwd=tmp,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                  for v, tmp in copies.items()}
        built = {v: p.communicate(timeout=900)[0] for v, p in builds.items()}
        for variant, tmp in copies.items():
            if builds[variant].returncode:
                print(built[variant][-4000:], file=sys.stderr)
                verdict[variant] = "did not build"
                continue
            run = subprocess.run([sys.executable, script, "--variant", variant], cwd=tmp,
                                 capture_output=True, text=True, timeout=900)
            rows = [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]
            lines += rows
            if not rows:
                print(run.stderr[-4000:], file=sys.stderr)
                verdict[variant] = "did not run"
                continue
            failed = [f"{r.get('leaf', r.get('name', r.get('phase')))} {r.get('shape', '')}"
                      for r in rows if not r.get("ok", False)]
            if run.returncode:   # a refused launch or a fault past the checks: caught
                failed.append(f"exit {run.returncode}: {run.stderr.strip()[-300:]}")
            verdict[variant] = dict(cases=len(rows), cases_failed=len(failed),
                                    first_failed=failed[:6],
                                    as_expected=not failed if variant == "clean" else bool(failed))
            print(json.dumps(dict(variant=variant, **verdict[variant])), flush=True)
    finally:
        for tmp in copies.values():
            shutil.rmtree(tmp, ignore_errors=True)
    ok = all(isinstance(verdict[v], dict) and verdict[v]["as_expected"] for v in faults)
    lines.append(dict(verdict=verdict, ok=ok))
    print(json.dumps(lines[-1]), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{out_name}.jsonl"), "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if ok else 1


def run_cases(variant: str) -> None:
    """In a copy's process: hold each case, one JSON line each."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import adam8bit as a8

    if not a8.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"imported {a8.__file__}, not the copy in {os.getcwd()}")
    cs.emit = lambda obj: print(json.dumps(dict(variant=variant, **obj)), flush=True)
    cs.run_adam8bit_kernel(torch, cs.card_peaks(torch.cuda.get_device_name(0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the JSON lines")
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant:
        run_cases(args.variant)
        return 0
    return run_variants(os.path.abspath(__file__), SOURCE, FAULTS, args.out,
                        "adam8bit_planted_faults")


if __name__ == "__main__":
    sys.exit(main())
