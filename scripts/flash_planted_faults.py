#!/usr/bin/env python3
"""Plant faults in copies of the bf16 flash kernels and show whether the chip
smoke's flash checks catch them.

    python3 scripts/flash_planted_faults.py [--out DIR]

Run from the root of the repository on a machine with an NVIDIA Hopper card.
Each variant is a copy of ``deepspeed_tpu_torch`` and ``chip_smoke.py`` in a
temporary directory (outside the repository), with at most one edit to a
kernel source, built there and run in a process of its own:

- ``clean``: no edit; every case must pass.
- ``bwd_skip_ragged_q_tile_dkdv``: the merged backward
  (``flash_bwd_sm90_kernel``) drops the last query tile's share of dk and dv
  when S is not a multiple of the 64-row query tile.
- ``fwd_skip_ragged_k_tile``: the forward (``flash_fwd_sm90_kernel``) drops
  the last key tile's share of o (l keeps it) where the block's key range
  is not a multiple of the key tile.

The cases are the smoke's ragged causal bf16 ones (S = 200 and 1000 at
D = 64, S = 1000 at D = 256), held by ``chip_smoke.flash_case_held``. For
each variant, case and output one JSON line gives the ratio to the earlier
limit alone (``old_ratio``: the largest error over two bf16 ulps at the
output's scale) and to the per-element limit (``err_over_limit``). Each
faulty variant must fail the check at one case at least. The last line is
the verdict; the exit code is 0 when the clean copy passes and every fault
is caught.
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
CASES = ((2, 200, 12, 64), (2, 1000, 12, 64), (1, 1000, 4, 256))   # B, S, H, D; causal

_BWD_DV = ("      wgmma_ss<C::DN, 0, 1>(dv_acc, kmajor_desc(sP + op), "
           "mnmajor_desc(do_s + oq, C::BQ * 128), 1);\n")
_BWD_DK = ("      wgmma_ss<C::DN, 0, 1>(dk_acc, kmajor_desc(sDS + op), "
           "mnmajor_desc(q_s + oq, C::BQ * 128), 1);\n")
_FWD_PV = "      wgmma_rs<D, 1>(o, pa[kk], mnmajor_desc(sV + kk * 16 * 64, BN * 128), 1);\n"
# variant: [(source, text, replacement)]
FAULTS = {
    "clean": [],
    "bwd_skip_ragged_q_tile_dkdv": [
        ("flash_attention_bwd.cu", line, "      if (j + 1 < n_q || S % C::BQ == 0)\n  " + line)
        for line in (_BWD_DV, _BWD_DK)],
    "fwd_skip_ragged_k_tile": [
        ("flash_attention.cu", _FWD_PV,
         "      if (j + 1 < n_tiles || k_end % BN == 0)\n  " + _FWD_PV)],
}


def make_copy(variant: str) -> str:
    """A temporary copy of the port with the variant's edits; its path."""
    tmp = tempfile.mkdtemp(prefix=f"flash_{variant}_")
    shutil.copytree(os.path.join(ROOT, "deepspeed_tpu_torch"),
                    os.path.join(tmp, "deepspeed_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
    for source, text, repl in FAULTS[variant]:
        path = os.path.join(tmp, "deepspeed_tpu_torch", "ops", "csrc", source)
        with open(path) as fh:
            src = fh.read()
        if src.count(text) != 1:
            raise RuntimeError(f"{variant}: the text to edit occurs {src.count(text)} times "
                               f"in {source}")
        with open(path, "w") as fh:
            fh.write(src.replace(text, repl))
    return tmp


def run_cases(variant: str) -> None:
    """In a copy's process: hold each case, one JSON line per output."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(os.getcwd()):
        raise RuntimeError(f"imported {fa.__file__}, not the copy in {os.getcwd()}")
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    for B, S, H, D in CASES:
        q, k, v, do = (torch.randn((B, S, H, D), generator=g, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        _, _, fwd, rows, _ = cs.flash_case_held(torch, fa, q, k, v, do, True, D ** -0.5,
                                                modes=("merged",))
        bwd = rows["merged"]
        case = f"B={B} S={S} H={H} D={D} causal bf16"
        print(json.dumps(dict(variant=variant, case=case, part="forward", output="o",
                              old_ratio=fwd["max_err"] / fwd["tol"],
                              err_over_limit=fwd["err_over_limit"],
                              kernel_vs_fp64_over_limit=fwd["kernel_vs_fp64_over_limit"],
                              max_err=fwd["max_err"], ok=fwd["ok"])), flush=True)
        for i, name in enumerate(("dq", "dk", "dv")):
            print(json.dumps(dict(
                variant=variant, case=case, part="merged backward", output=name,
                old_ratio=bwd["max_err_dq_dk_dv"][i] / bwd["tol_dq_dk_dv"][i],
                err_over_limit=bwd["err_over_limit_dq_dk_dv"][i],
                kernel_vs_fp64_over_limit=bwd["kernel_vs_fp64_over_limit_dq_dk_dv"][i],
                max_err=bwd["max_err_dq_dk_dv"][i], ok=bwd["ok"])), flush=True)


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
        print("flash_planted_faults: no CUDA device", file=sys.stderr)
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
        if run.returncode != 0 or len(rows) != 4 * len(CASES):
            print(run.stderr[-4000:], file=sys.stderr)
            verdict[variant] = "did not run"
            continue
        # ok: the whole check of the part (the backward's covers dq, dk and dv)
        failed = [f"{r['case']} {r['part']}" for r in rows if not r["ok"]]
        old_missed = [f"{r['case']} {r['output']}" for r in rows
                      if r["err_over_limit"] > 1.0 and r["old_ratio"] <= 1.0]
        verdict[variant] = dict(cases_failed=sorted(set(failed)),
                                caught_only_by_the_per_element_limit=old_missed)
    ok = (isinstance(verdict["clean"], dict) and not verdict["clean"]["cases_failed"]
          and all(isinstance(verdict[v], dict) and verdict[v]["cases_failed"]
                  for v in FAULTS if v != "clean"))
    lines.append(dict(verdict=verdict, ok=ok))
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "flash_planted_faults.jsonl"), "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
