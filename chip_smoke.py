#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Run from the root of the repository. Phases, each printing JSON lines:

1. env      the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build    every kernel built from ``deepspeed_tpu_torch/ops/csrc`` (seconds).
3. kernels  each kernel against its plain PyTorch version on the card, in
            bf16 at the serving slice's shapes, with its tolerance, its time,
            the plain version's, one library call's where one computes the
            same function, and the least time the card could take (bound);
            then each in fp32 at other shapes, checked but not timed.
4. slice    GPT-2-125M at full width and depth (random weights from a seed)
            through ``init_inference``: a forward at B=2, S=1024 held against
            the same engine on the CPU, and ``generate`` (B=8, prompt 256,
            128 new tokens) greedy and sampled, with each kernel's launch
            count over that run held against what the path implies.
5. profile  device busy time over a short generate (torch.profiler).

It exits non-zero, printing no result line, without CUDA or outside the
repository; any failed phase makes it exit non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--out DIR`` also writes the compiler output and the profiler table there.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

SEED = 1234

# NVIDIA data sheets: HBM bytes/s and dense bf16 tensor-core flop/s
CARD_PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
              "H100 SXM": (3.35e12, 989e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return CARD_PEAKS[f"H100 {key}"]
    return CARD_PEAKS["H100 SXM"]


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unavailable"


def bound_ms(nbytes: float, flops: float, peaks) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[1]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events, after warm-up.
    When the host enqueues slower than the card runs, this is host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int):
    """Mean device time per call: the summed durations of the GPU kernels
    and copies ``iters`` calls ran (torch.profiler / CUPTI), so launch gaps
    do not count. None if the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us else None


class Rotation:
    """Copies of a kernel's inputs, cycled call by call so that the timed
    working set exceeds the 50 MB L2 cache where the real path finds its
    operands cold (weights and KV caches stream from memory every tick)."""

    def __init__(self, sets):
        self.sets, self.i = sets, 0

    def next(self):
        s = self.sets[self.i % len(self.sets)]
        self.i += 1
        return s


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def kernel_cases(torch, F, peaks):
    """One dict per case: the wrapper, its plain version, a library call
    (or None), inputs, the error measure and its tolerance, and the bound."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import decode_layer as dl
    from deepspeed_tpu_torch.ops import flash_attention as fa

    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    cases = []
    # the forward's shape; a non-causal one; S = 200, off the 64-row tiles
    for causal, S, B in ((True, 1024, 2), (False, 256, 2), (True, 200, 1)):
        H, D = 12, 64
        q, k, v = randn(B, S, H, D), randn(B, S, H, D), randn(B, S, H, D)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) / 2 if causal else S * S
        cases.append(dict(
            name="flash_attention_fwd", shape=f"B={B} S={S} H={H} D={D} causal={causal}",
            main=S == 1024, replaces="deepspeed_tpu/ops/pallas/flash_attention.py:34",
            source="deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
            sets=[(q, k, v)],
            kernel=lambda q, k, v, c=causal: fa.flash_attention_with_lse(q, k, v, causal=c),
            plain=lambda q, k, v, c=causal: fa.flash_attention_plain(q, k, v, c, 64 ** -0.5),
            library=lambda *_, c=causal, t=(qt, kt, vt): F.scaled_dot_product_attention(
                *t, is_causal=c),
            compare="flash",
            bound=bound_ms(4 * B * S * H * D * 2 + B * H * S * 4, 4 * B * H * D * pairs, peaks)))

    B, S_max, H, D = 8, 512, 12, 64
    lengths = torch.tensor([1, 512, 37, 100, 256, 300, 511, 64], dtype=torch.int32, device=dev)
    live = int(lengths.sum())
    mask = (torch.arange(S_max, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    for KV in (12, 4):
        sets = [(randn(B, 1, H, D), randn(B, S_max, KV, D), randn(B, S_max, KV, D))
                for _ in range(10)]   # 10 caches of 6.3 MB (MHA): past the L2

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask)
        cases.append(dict(
            name="decode_attention", shape=f"B={B} S_max={S_max} H={H} KV={KV} D={D} "
            "lengths=" + ",".join(str(int(x)) for x in lengths),
            main=KV == H, replaces="deepspeed_tpu/ops/pallas/decode_attention.py:78",
            source="deepspeed_tpu_torch/ops/csrc/decode_attention.cu", sets=sets,
            kernel=lambda q, k, v: da.decode_attention(q, k, v, lengths),
            plain=lambda q, k, v: da.decode_attention_plain(q, k, v, lengths, 64 ** -0.5),
            library=sdpa if KV == H else None, compare="bf16",
            bound=bound_ms(2 * live * KV * D * 2 + 2 * B * H * D * 2 + B * 4,
                           4 * live * H * D, peaks)))

    M, E, N, Fh = 8, 768, 2304, 3072
    ln = lambda: (1 + randn(E, std=0.1, dtype=torch.float32), randn(E, std=0.1, dtype=torch.float32))  # noqa: E731
    sets = []
    for _ in range(16):   # 16 panels of 3.5 MB: past the L2
        ns, nb = ln()
        sets.append((randn(M, E), ns, nb, randn(E, N, std=0.02), randn(N, std=0.02)))
    cases.append(dict(
        name="norm_qkv", shape=f"M={M} E={E} N={N}", main=True,
        replaces="deepspeed_tpu/ops/pallas/decode_layer.py:185",
        source="deepspeed_tpu_torch/ops/csrc/decode_layer.cu", sets=sets,
        kernel=lambda x, ns, nb, w, b: dl.fused_norm_proj(x, ns, nb, w, b),
        plain=lambda x, ns, nb, w, b: dl.norm_proj_plain(x, ns, nb, w, b, 1e-5),
        library=None, compare="bf16",
        bound=bound_ms(E * N * 2 + M * E * 2 + M * N * 2 + N * 2 + 2 * E * 4,
                       2 * M * E * N, peaks)))

    sets = []
    for _ in range(6):    # 6 sets of 10.6 MB: past the L2
        ns, nb = ln()
        sets.append((randn(M, E), randn(M, E), randn(E, E, std=0.02), randn(E, std=0.02), ns, nb,
                     randn(E, Fh, std=0.02), randn(Fh, std=0.02), randn(Fh, E, std=0.02),
                     randn(E, std=0.02)))
    cases.append(dict(
        name="post_attn", shape=f"M={M} E={E} F={Fh}", main=True,
        replaces="deepspeed_tpu/ops/pallas/decode_layer.py:344",
        source="deepspeed_tpu_torch/ops/csrc/decode_layer.cu", sets=sets,
        kernel=lambda y, x, wo, bo, ns, nb, w1, b1, w2, b2: dl.fused_post_attn(
            y, x, wo, bo, ns, nb, (w1, b1, w2, b2)),
        plain=lambda *a: dl.post_attn_plain(*a, 1e-5),
        library=None, compare="bf16",
        bound=bound_ms((E * E + 2 * E * Fh) * 2 + 3 * M * E * 2 + (2 * E + Fh) * 2 + 2 * E * 4,
                       2 * M * (E * E + 2 * E * Fh), peaks)))
    return cases


def run_kernels(torch, F, peaks):
    results = []
    for case in kernel_cases(torch, F, peaks):
        args = case["sets"][0]
        got = case["kernel"](*args)
        ref = case["plain"](*args)
        torch.cuda.synchronize()
        if case["compare"] == "flash":
            (o, lse), (ro, rlse) = got, ref
            rlse = rlse.reshape(o.shape[0], o.shape[2], o.shape[1]).transpose(1, 2)
            err = float((o.float() - ro.float()).abs().max())
            lse_err = float((lse - rlse).abs().max())
            # both compute in fp32 and cast once: at most ~1 bf16 ulp apart
            tol = 2 * bf16_ulp(float(ro.float().abs().max()))
            ok = err <= tol and lse_err <= 1e-4 * max(1.0, float(rlse.abs().max()))
            extra = {"lse_max_err": lse_err}
        else:
            err = float((got.float() - ref.float()).abs().max())
            # fp32 arithmetic in a different order, one cast at the end (and
            # bf16 casts of normalised rows where an fp32 difference can
            # tip a rounding): allow two bf16 ulps at the output's scale
            tol = 2 * bf16_ulp(float(ref.float().abs().max()))
            ok = err <= tol
            extra = {}
        rot = Rotation(case["sets"])
        iters = 20 if case["name"] == "flash_attention_fwd" else 100
        timed = {}
        for which, n in (("kernel", iters), ("plain", max(iters // 5, 5)), ("library", iters)):
            fn = case[which]
            if fn is None:
                timed[which] = (None, None)
                continue
            call = lambda fn=fn: fn(*rot.next())  # noqa: E731
            timed[which] = (device_ms(torch, call, n), cuda_ms(torch, call, n))
        # device time where the profiler saw the card, else event time
        pick = {w: (d if d is not None else e) for w, (d, e) in timed.items()}
        b_ms, b_by = case["bound"]
        res = dict(phase="kernels", name=case["name"], shape=case["shape"], max_err=err,
                   tol=tol, ok=bool(ok), kernel_ms=pick["kernel"], plain_ms=pick["plain"],
                   library_ms=pick["library"], bound_us=b_ms * 1e3, bound_by=b_by,
                   timing="device" if timed["kernel"][0] is not None else "events",
                   event_ms={w: e for w, (_, e) in timed.items()}, **extra)
        emit(res)
        results.append((case, res))
    return results


def run_fp32_shapes(torch):
    """The fp32 instantiations at shapes off the slice's path: ragged row
    counts, a contraction past one 1024-element staging chunk, D=128 with
    8 query heads per KV head, a flash S off the 64-row tiles. Checked
    against the plain versions (fp32 sums in another order: atol 1e-4
    relative to the output's scale), not timed."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import decode_layer as dl
    from deepspeed_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std

    E, F, M = 256, 1280, 3
    lengths = torch.tensor([1, 300, 77], dtype=torch.int32, device="cuda")
    q, k, v = randn(1, 200, 4, 128), randn(1, 200, 4, 128), randn(1, 200, 4, 128)
    qd, kc, vc = randn(3, 1, 32, 128), randn(3, 300, 4, 128), randn(3, 300, 4, 128)
    x, y, ns, nb = randn(M, E), randn(M, E), 1 + randn(E, std=0.1), randn(E, std=0.1)
    w, b = randn(E, 384, std=0.02), randn(384, std=0.02)
    post = (y, x, randn(E, E, std=0.02), randn(E, std=0.02), ns, nb, randn(E, F, std=0.02),
            randn(F, std=0.02), randn(F, E, std=0.02), randn(E, std=0.02))
    cases = [
        ("flash_attention_fwd", "B=1 S=200 H=4 D=128 causal fp32",
         fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v, True, 128 ** -0.5)[0]),
        ("decode_attention", "B=3 S_max=300 H=32 KV=4 D=128 fp32",
         da.decode_attention(qd, kc, vc, lengths),
         da.decode_attention_plain(qd, kc, vc, lengths, 128 ** -0.5)),
        ("norm_qkv", f"M={M} E={E} N=384 fp32", dl.fused_norm_proj(x, ns, nb, w, b),
         dl.norm_proj_plain(x, ns, nb, w, b, 1e-5)),
        ("post_attn", f"M={M} E={E} F={F} fp32",
         dl.fused_post_attn(*post[:6], post[6:]), dl.post_attn_plain(*post, 1e-5)),
    ]
    ok = True
    for name, shape, got, ref in cases:
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        emit(dict(phase="kernels_fp32", name=name, shape=shape, max_err=err, tol=tol,
                  ok=err <= tol))
        ok &= err <= tol
    return ok


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def counters():
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import decode_layer as dl
    from deepspeed_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.KERNEL, "decode_attention": da.KERNEL,
            "norm_qkv": dl.NORM_PROJ, "post_attn": dl.POST_ATTN}


def run_slice(torch):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

    cfg = gpt2_config("gpt2-125m")
    model = GPT2LMHeadModel(cfg).init_weights(torch.Generator().manual_seed(SEED))
    eng = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512)
    g = torch.Generator().manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g)
    prompt = torch.randint(0, cfg.vocab_size, (8, 256), generator=g)
    L, new = cfg.n_layer, 128

    eng(ids[:, :128])                                   # warm-up: libraries, allocator
    eng.generate(prompt[:, :32], max_new_tokens=4)
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    kernels = counters()
    for k in kernels.values():
        k.launches = 0
    logits, fwd_ms = timed(lambda: eng(ids))
    _, ttft_ms = timed(lambda: eng.generate(prompt, max_new_tokens=1))
    greedy, gen_ms = timed(lambda: eng.generate(prompt, max_new_tokens=new))
    sampled, samp_ms = timed(lambda: eng.generate(prompt, max_new_tokens=new, temperature=0.8,
                                                  top_p=0.9, seed=7))
    launches = {name: k.launches for name, k in kernels.items()}
    ticks = 2 * (new - 1)   # greedy + sampled; the max_new_tokens=1 run has no tick
    expected = {"flash_attention_fwd": L, "decode_attention": L * ticks,
                "norm_qkv": L * ticks, "post_attn": L * ticks}
    ms_per_tick = (gen_ms - ttft_ms) / (new - 1)
    emit(dict(phase="slice", model="gpt2-125m", dtype="bfloat16", forward_shape=[2, 1024],
              forward_ms=fwd_ms, generate_shape=[8, 256, new], ttft_ms=ttft_ms,
              generate_ms=gen_ms, ms_per_tick=ms_per_tick,
              tokens_per_s=8 * new / (gen_ms / 1e3), decode_tokens_per_s=8 / (ms_per_tick / 1e3),
              sampled_generate_ms=samp_ms, launches=launches, expected_launches=expected))
    checks = {"launch_counts": launches == expected}

    # held against the same engine on the CPU (plain versions), same weights
    V = cfg.vocab_size
    eng_cpu = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512, device="cpu")
    cpu_logits = eng_cpu(ids)[..., :V].float()
    card = logits[..., :V].float().cpu()
    fwd_err = float((card - cpu_logits).abs().max())
    # Random-weight GPT-2 logits are flat: many positions have their top
    # two logits less than one bf16 ulp apart (the "flatness" line below
    # measures how many), so two bf16 engines that sum in different orders
    # break such ties differently. A pick counts as agreeing when the
    # reference scores it within two bf16 ulps of its own maximum; the
    # strict argmax agreement is printed beside it.
    delta = 2 * bf16_ulp(float(cpu_logits.abs().max()))
    top1 = float((card.argmax(-1) == cpu_logits.argmax(-1)).float().mean())
    top1_ties = near_max_share(card.argmax(-1), cpu_logits, delta)
    # bf16 logits that round at the same points but sum in different
    # orders, through 12 layers: a few ulps at the logits' scale
    fwd_tol = 8 * bf16_ulp(float(cpu_logits.abs().max()))
    checks["forward_vs_cpu"] = fwd_err <= fwd_tol and top1_ties >= 0.99 and top1 >= 0.95
    checks["forward_finite"] = bool(torch.isfinite(card).all())

    # how flat these logits are: the same weights in fp32 on the card
    l32 = ds.init_inference(model, dtype=torch.float32, max_tokens=512)(ids)[..., :V].float()
    top2 = l32.topk(2, dim=-1).values
    ulp = bf16_ulp(float(l32.abs().max()))
    flatness = dict(fp32_top2_margin_below_bf16_ulp=float((top2[..., 0] - top2[..., 1] < ulp)
                                                          .float().mean()),
                    bf16_ulp_at_max_logit=ulp,
                    card_bf16_vs_fp32_top1=float((logits[..., :V].argmax(-1) == l32.argmax(-1))
                                                 .float().mean()))
    del l32

    # greedy stream, teacher-forced: the card's forward over prompt +
    # generated tokens scores each generated token as its top pick
    tf_logits = eng(greedy[:, :-1])[:, 255:, :V].float()
    tf_agree = float((tf_logits.argmax(-1) == greedy[:, 256:]).float().mean())
    tf_ties = near_max_share(greedy[:, 256:], tf_logits, delta)
    checks["greedy_teacher_forced"] = tf_ties >= 0.99 and tf_agree >= 0.95
    again = eng.generate(prompt, max_new_tokens=new, temperature=0.8, top_p=0.9, seed=7)
    checks["sampled_seeded_deterministic"] = bool(torch.equal(again, sampled))
    checks["shapes_and_vocab"] = (tuple(greedy.shape) == (8, 256 + new)
                                  and tuple(sampled.shape) == (8, 256 + new)
                                  and int(sampled.max()) < V and int(greedy.max()) < V)
    emit(dict(phase="slice_checks", forward_max_err=fwd_err, forward_tol=fwd_tol,
              tie_delta=delta, forward_top1=top1, forward_top1_within_delta=top1_ties,
              teacher_forced_top1=tf_agree, teacher_forced_within_delta=tf_ties,
              flatness=flatness, checks=checks))
    return launches, all(checks.values()), eng, prompt


def near_max_share(pick, ref_logits, delta: float) -> float:
    """Share of positions whose picked token the reference logits score
    within ``delta`` of their maximum."""
    ref_logits = ref_logits.to(pick.device)
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, pick[..., None])[..., 0]
    return float(((best - got) <= delta).float().mean())


def run_profile(torch, eng, prompt, out_dir):
    """Device time against wall time for a prefill alone (1 new token) and
    for a prefill plus 16 ticks; their difference is 16 ticks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    windows = {}
    for new in (1, 17):
        eng.generate(prompt, max_new_tokens=new)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate(prompt, max_new_tokens=new)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        windows[new] = (wall_ms, sum(by_name.values()) / 1e3, by_name)
        if out_dir:
            with open(os.path.join(out_dir, f"profile_new{new}.txt"), "w") as fh:
                fh.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                                   row_limit=40))
    (w1, d1, _), (w17, d17, names) = windows[1], windows[17]
    measured = d17 > 0
    tick_wall, tick_dev = (w17 - w1) / 16, (d17 - d1) / 16
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    emit(dict(phase="profile", window="generate B=8 prompt=256, new=1 and new=17",
              prefill_wall_ms=w1, prefill_device_ms=d1 if measured else "not measured",
              tick_wall_ms=tick_wall, tick_device_ms=tick_dev if measured else "not measured",
              tick_device_busy_share=tick_dev / tick_wall if measured else "not measured",
              top_device_us_new17={k[:90]: v for k, v in top}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for build logs and profiles")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    emit(dict(phase="env", nvidia_smi=smi, device=name, count=torch.cuda.device_count(),
              torch=torch.__version__, cuda=torch.version.cuda,
              peaks={"bytes_per_s": peaks[0], "bf16_flops": peaks[1]}))

    ok = True
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, compiled=sorted(logs),
              sources=_build.sources()))
    if args.out:
        with open(os.path.join(args.out, "build.log"), "w") as fh:
            for src, log in logs.items():
                fh.write(f"==== {src}.cu\n{log}\n")

    kernel_results = run_kernels(torch, F, peaks)
    ok &= all(r["ok"] for _, r in kernel_results)
    ok &= run_fp32_shapes(torch)
    launches, slice_ok, eng, prompt = run_slice(torch)
    ok &= slice_ok
    run_profile(torch, eng, prompt, args.out)

    summary = []
    for case, r in kernel_results:
        if not case["main"]:
            continue
        summary.append(dict(
            name=case["name"], route="cuda", source=case["source"], replaces=case["replaces"],
            launches=launches.get(case["name"], 0), max_abs_err=r["max_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(smi, flush=True)
    emit({"kernels": summary})
    if not ok:
        print("chip_smoke: a phase failed (see the lines above)", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
