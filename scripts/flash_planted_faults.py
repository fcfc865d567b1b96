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
- ``split_dq_skip_ragged_k_tile``: the split dq kernel
  (``flash_bwd_dq_sm90_kernel``) drops the last key tile's share of dq where
  the block's key range is not a multiple of the 64-key tile.
- ``split_dkv_skip_ragged_q_tile``: the split dkv kernel
  (``flash_bwd_dkv_sm90_kernel``) drops the last query tile's share of dk
  and dv when S is not a multiple of the 64-row query tile.
- ``split_drop_lo``: the split kernels use p_hi and ds_hi only (the lo
  parts are zero), which is the merged kernel's rounding of p and ds.

The cases are the smoke's ragged causal bf16 ones (S = 200 and 1000 at
D = 64, S = 1000 at D = 256) and one non-causal S = 384, Sk = 640 at
D = 64, held by ``chip_smoke.flash_case_held`` in both backward modes. For
each variant, case and output one JSON line gives the ratio to the earlier
limit alone (``old_ratio``: the largest error over two bf16 ulps at the
output's scale), to the per-element limit (``err_over_limit``) and, for the
split pair, to that limit without its 2^-8 term (``err_over_fp32_limit``,
the fp32-only gate the split pair must meet). The dropped tiles must fail
the check at one case at least. ``split_drop_lo`` must stay within the
per-element limit (``FLASH_LIMIT``) and fail the fp32-only gate alone: the
gate sees the precision the lo parts keep. The last line is the verdict;
the exit code is 0 when the clean copy passes and every fault is caught as
it must be.
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
# B, S, Sk, H, D, causal
CASES = ((2, 200, 200, 12, 64, True), (2, 1000, 1000, 12, 64, True),
         (1, 1000, 1000, 4, 256, True), (2, 384, 640, 12, 64, False))

_BWD_DV = ("      wgmma_ss<C::DN, 0, 1>(dv_acc, kmajor_desc(sP + op), "
           "mnmajor_desc(do_s + oq, C::BQ * 128), 1);\n")
_BWD_DK = ("      wgmma_ss<C::DN, 0, 1>(dk_acc, kmajor_desc(sDS + op), "
           "mnmajor_desc(q_s + oq, C::BQ * 128), 1);\n")
_FWD_PV = "      wgmma_rs<D, 1>(o, pa[kk], mnmajor_desc(sV + kk * 16 * 64, BN * 128), 1);\n"
_DQ = ("      wgmma_rs<D, 1>(dq, hi[kk], dk_, 1);\n"
       "      wgmma_rs<D, 1>(dq, lo[kk], dk_, 1);\n")
_DKV = ("        wgmma_ss<C::DN, 0, 1>(dv_acc, kmajor_desc(sP + part * C::P_ELEMS + op), "
        "mnmajor_desc(do_s + oq, C::BQ * 128), 1);\n"
        "        wgmma_ss<C::DN, 0, 1>(dk_acc, kmajor_desc(sDS + part * C::P_ELEMS + op), "
        "mnmajor_desc(q_s + oq, C::BQ * 128), 1);\n")
_LO = "  lo = pack_bf16(a - __low2float(h), b - __high2float(h));\n"
# variant: [(source, text, replacement)]
FAULTS = {
    "clean": [],
    "bwd_skip_ragged_q_tile_dkdv": [
        ("flash_attention_bwd.cu", line, "      if (j + 1 < n_q || S % C::BQ == 0)\n  " + line)
        for line in (_BWD_DV, _BWD_DK)],
    "fwd_skip_ragged_k_tile": [
        ("flash_attention.cu", _FWD_PV,
         "      if (j + 1 < n_tiles || k_end % BN == 0)\n  " + _FWD_PV)],
    "split_dq_skip_ragged_k_tile": [
        ("flash_attention_bwd.cu", _DQ,
         "      if (j + 1 < n_tiles || k_end % C::BK == 0) {\n" + _DQ + "      }\n")],
    "split_dkv_skip_ragged_q_tile": [
        ("flash_attention_bwd.cu", _DKV,
         "        if (j + 1 < n_q || S % C::BQ == 0) {\n" + _DKV + "        }\n")],
    "split_drop_lo": [("flash_sm90.cuh", _LO, "  lo = 0u;\n")],
}
# what a variant must show: every case passes; some case fails; or the
# split pair fails the fp32-only gate and nothing else
EXPECT = {"clean": "pass", "split_drop_lo": "fails_fp32_gate_only"}


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
    for B, S, Sk, H, D, causal in CASES:
        q, k, v, do = (torch.randn((B, L, H, D), generator=g, device="cuda").to(torch.bfloat16)
                       for L in (S, Sk, Sk, S))
        _, _, fwd, rows, _ = cs.flash_case_held(torch, fa, q, k, v, do, causal, D ** -0.5)
        case = f"B={B} S={S} Sk={Sk} H={H} D={D} causal={causal} bf16"
        print(json.dumps(dict(variant=variant, case=case, part="forward", output="o",
                              old_ratio=fwd["max_err"] / fwd["tol"],
                              err_over_limit=fwd["err_over_limit"],
                              kernel_vs_fp64_over_limit=fwd["kernel_vs_fp64_over_limit"],
                              max_err=fwd["max_err"], ok=fwd["ok"])), flush=True)
        for mode, bwd in rows.items():
            for i, name in enumerate(("dq", "dk", "dv")):
                line = dict(
                    variant=variant, case=case, part=f"{mode} backward", output=name,
                    old_ratio=bwd["max_err_dq_dk_dv"][i] / bwd["tol_dq_dk_dv"][i],
                    err_over_limit=bwd["err_over_limit_dq_dk_dv"][i],
                    err_over_fp32_limit=bwd["err_over_fp32_limit_dq_dk_dv"][i],
                    kernel_vs_fp64_over_limit=bwd["kernel_vs_fp64_over_limit_dq_dk_dv"][i],
                    fp64_anchor_ok=bwd["fp64_anchor_ok_dq_dk_dv"][i],
                    max_err=bwd["max_err_dq_dk_dv"][i], ok=bwd["ok"])
                if mode == "split":
                    line.update(fp32_limit_ok=bwd["fp32_limit_ok"],
                                repeats_bitwise=bwd["repeats_bitwise"])
                print(json.dumps(line), flush=True)


def fp32_gate_only(rows) -> bool:
    """Every failing part is the split backward, failing the fp32-only gate
    and nothing else: within the per-element limit, two bf16 ulps at the
    output's scale and the fp64 anchor, repeating bit for bit."""
    bad = [r for r in rows if not r["ok"]]
    return bool(bad) and all(
        r["part"] == "split backward" and not r["fp32_limit_ok"] and r["repeats_bitwise"]
        for r in bad) and all(
        r["err_over_limit"] <= 1.0 and r["old_ratio"] <= 1.0 and r.get("fp64_anchor_ok", True)
        for r in rows)


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
        if run.returncode != 0 or len(rows) != 7 * len(CASES):
            print(run.stderr[-4000:], file=sys.stderr)
            verdict[variant] = "did not run"
            continue
        # ok: the whole check of the part (the backward's covers dq, dk and dv)
        failed = [f"{r['case']} {r['part']}" for r in rows if not r["ok"]]
        old_missed = [f"{r['case']} {r['output']}" for r in rows
                      if r["err_over_limit"] > 1.0 and r["old_ratio"] <= 1.0]
        verdict[variant] = dict(cases_failed=sorted(set(failed)),
                                caught_only_by_the_per_element_limit=old_missed,
                                fails_fp32_gate_only=fp32_gate_only(rows))
        expect = EXPECT.get(variant, "fails")
        verdict[variant]["as_expected"] = (
            not failed if expect == "pass" else
            verdict[variant]["fails_fp32_gate_only"] if expect == "fails_fp32_gate_only" else
            bool(failed))
    ok = all(isinstance(verdict[v], dict) and verdict[v]["as_expected"] for v in FAULTS)
    lines.append(dict(verdict=verdict, ok=ok))
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "flash_planted_faults.jsonl"), "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
