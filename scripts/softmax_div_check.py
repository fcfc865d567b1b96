#!/usr/bin/env python3
"""Check on the card that ``ds::div_rn_by`` (``ops/csrc/common.cuh``), the
softmax forward's quotient from one reciprocal a row, gives the bits of IEEE
division (``__fdiv_rn``) wherever the kernel uses it: every float e in
[2^-100, 2^20] against each of a set of divisors l in [0.5, 2^20] (1, 0.5,
2^20, every power of two between with its two neighbours, 1024 and its
neighbours, then log-uniform draws from ``--seed``).

    python3 scripts/softmax_div_check.py [--divisors 512] [--seed 0] [--out FILE]

Run on a machine with an NVIDIA Hopper card and nvcc: the check is built
from the repository's header with nvcc into a temporary directory and run
there. Prints one JSON line: the card, the divisions checked, the
mismatches (must be 0) and the first few of them; exits 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "deepspeed_tpu_torch", "ops", "csrc")
SOURCE = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "common.cuh"

__global__ void check(const float* ls, int nl, unsigned lo, unsigned n,
                      unsigned long long* bad, float* first) {
  for (int k = blockIdx.y; k < nl; k += gridDim.y) {
    const float l = ls[k], r = __frcp_rn(l);
    for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
         t += gridDim.x * blockDim.x) {
      const float e = __uint_as_float(lo + t);
      if (__float_as_uint(ds::div_rn_by(e, l, r)) != __float_as_uint(__fdiv_rn(e, l))) {
        const unsigned long long i = atomicAdd(bad, 1ull);
        if (i < 4) { first[2 * i] = e; first[2 * i + 1] = l; }
      }
    }
  }
}

int main() {
  std::vector<float> ls;
  float v;
  while (scanf("%a", &v) == 1) ls.push_back(v);
  float* d_ls; unsigned long long* d_bad; float* d_first;
  cudaMalloc(&d_ls, ls.size() * sizeof(float));
  cudaMalloc(&d_bad, sizeof(unsigned long long));
  cudaMalloc(&d_first, 8 * sizeof(float));
  cudaMemcpy(d_ls, ls.data(), ls.size() * sizeof(float), cudaMemcpyHostToDevice);
  cudaMemset(d_bad, 0, sizeof(unsigned long long));
  cudaMemset(d_first, 0, 8 * sizeof(float));
  const float elo = 0x1p-100f, ehi = 0x1p20f;
  unsigned lo, hi;
  memcpy(&lo, &elo, 4); memcpy(&hi, &ehi, 4);
  const unsigned n = hi - lo + 1;
  check<<<dim3(132 * 8, 16), 256>>>(d_ls, (int)ls.size(), lo, n, d_bad, d_first);
  const cudaError_t err = cudaDeviceSynchronize();
  unsigned long long bad = 0; float first[8];
  cudaMemcpy(&bad, d_bad, sizeof(bad), cudaMemcpyDeviceToHost);
  cudaMemcpy(first, d_first, sizeof(first), cudaMemcpyDeviceToHost);
  printf("{\"cuda_error\": \"%s\", \"e_values\": %u, \"divisors\": %zu, \"mismatches\": %llu, "
         "\"first\": [[\"%a\", \"%a\"], [\"%a\", \"%a\"], [\"%a\", \"%a\"], [\"%a\", \"%a\"]]}\n",
         cudaGetErrorString(err), n, ls.size(), bad, first[0], first[1], first[2], first[3],
         first[4], first[5], first[6], first[7]);
  return err != cudaSuccess || bad != 0;
}
"""


def divisors(count: int, seed: int) -> list:
    ls = [0.5, 1.0, 2.0 ** 20, 1000.0, 1023.0, 1024.0, 1025.0]
    for k in range(-1, 21):
        p = np.float32(2.0 ** k)
        ls += [p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf))]
    rng = np.random.default_rng(seed)
    ls += list(np.exp(rng.uniform(np.log(0.5), np.log(2.0 ** 20), max(0, count - len(ls)))))
    return [float(np.float32(x)) for x in ls if 0.5 <= np.float32(x) <= 2.0 ** 20]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--divisors", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="file the JSON line is appended to")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from deepspeed_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "div_check.cu"), os.path.join(tmp, "div_check")
        with open(src, "w") as fh:
            fh.write(SOURCE)
        subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-I", CSRC, "-o", exe, src], check=True)
        ls = divisors(args.divisors, args.seed)
        run = subprocess.run([exe], input="\n".join(float(x).hex() for x in ls), text=True,
                             capture_output=True, timeout=1800)
    if not run.stdout.startswith("{"):
        raise RuntimeError(f"the check printed no result: {run.stderr[-2000:]}")
    res = dict(card=card, **json.loads(run.stdout))
    res["ok"] = run.returncode == 0 and res["mismatches"] == 0
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
