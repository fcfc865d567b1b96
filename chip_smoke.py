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
6. serve    the same model behind ``ContinuousBatcher`` (8 slots), page-
            resident (prefix cache on) and with contiguous slots: 32
            chat requests sharing a 192-token system prompt, served twice
            (the second pass hits the radix tree), with per-mode latency
            and throughput, launch counts held against the ticks, leak
            counts, prefix hits, greedy streams teacher-forced through the
            card's own forward, and the per-row sampling step on the card
            held against the CPU over the sampled streams' logits.

The ``kernels`` line gives each kernel's launches per path (``generate``,
``serve_paged``, ``serve_contiguous``: each zeroed before its run and read
after it) and their sum.

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

# NVIDIA data sheets: HBM bytes/s, dense bf16 tensor-core flop/s and fp32
# (non-tensor) flop/s
CARD_PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12), "H100 NVL": (3.9e12, 835e12, 60e12),
              "H100 SXM": (3.35e12, 989e12, 67e12)}


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


def bound_ms(nbytes: float, flops: float, peaks, fp32: bool = False) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[2 if fp32 else 1]
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

    cases += paged_cases(torch, F, peaks)

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


def paged_arena(torch, g, lengths, B, H, KV, D, pt, T, dtype):
    """One paged decode case: q, and K/V arenas whose live positions sit in
    shuffled pages named by the table, every other position (the tail
    pages' dead rows, unused pages, the trash page 0 past each row's pages)
    NaN."""
    dev = "cuda"
    P = B * T + 1
    perm = torch.randperm(P - 1, generator=g, device=dev).to(torch.int32) + 1
    table = torch.zeros((B, T), dtype=torch.int32, device=dev)
    kp = torch.full((P, pt, KV, D), float("nan"), dtype=dtype, device=dev)
    vp = torch.full_like(kp, float("nan"))
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(dtype)
    dead = (torch.arange(T * pt, device=dev)[None, :]
            >= torch.tensor(lengths, device=dev)[:, None])[:, :, None, None]
    n_pages = [min(-(-L // pt), T) for L in lengths]
    starts = [sum(n_pages[:b]) for b in range(B)]
    for b, n in enumerate(n_pages):
        table[b, :n] = perm[starts[b]:starts[b] + n]
    for arena in (kp, vp):
        full = torch.randn((B, T * pt, KV, D), generator=g, device=dev).to(dtype)
        full = full.masked_fill(dead, float("nan")).reshape(B, T, pt, KV, D)
        for b, n in enumerate(n_pages):
            arena[table[b, :n].long()] = full[b, :n]
    return q, kp, vp, table


def paged_cases(torch, F, peaks):
    """Paged decode attention at the serve phase's geometry (B=8, H=KV=12,
    D=64, 16-token pages, 32 table entries), in GQA (H=32, KV=8, D=128) and
    in fp32; live positions in shuffled pages, everything else NaN."""
    from deepspeed_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = []
    geoms = ((torch.bfloat16, 12, 12, 64, [1, 16, 17, 255, 256, 300, 511, 512]),
             (torch.bfloat16, 32, 8, 128, [1, 16, 17, 255, 256, 300, 511, 512]),
             (torch.float32, 8, 2, 64, [0, 3, 40, 130, 600]))   # L=0, and L > T*pt
    for dtype, H, KV, D, lens in geoms:
        B, pt, T = len(lens), 16, 32
        sets = [paged_arena(torch, g, lens, B, H, KV, D, pt, T, dtype) for _ in range(8)]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        live = sum(min(L, T * pt) for L in lens)
        item = torch.empty((), dtype=dtype).element_size()
        scale = D ** -0.5
        S_kv = T * pt
        mask = (torch.arange(S_kv, device="cuda")[None, :]
                < lengths.clamp(max=S_kv)[:, None])[:, None, None, :]

        def gather_sdpa(q, kp, vp, table, G=H // KV, mask=mask):
            k, v = pa.gather_kv_pages(kp, table), pa.gather_kv_pages(vp, table)
            k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask)
        cases.append(dict(
            name="paged_attention", shape=f"B={B} H={H} KV={KV} D={D} pt={pt} T={T} "
            f"{str(dtype)[6:]} lengths=" + ",".join(map(str, lens)),
            main=dtype == torch.bfloat16 and H == KV,
            replaces="deepspeed_tpu/ops/pallas/paged_attention.py:88",
            source="deepspeed_tpu_torch/ops/csrc/paged_attention.cu", sets=sets,
            kernel=lambda q, kp, vp, t, L=lengths: pa.paged_decode_attention(q, kp, vp, t, L),
            plain=lambda q, kp, vp, t, L=lengths, sc=scale: pa.paged_decode_attention_plain(
                q, kp, vp, t, L, sc),
            library=gather_sdpa, library_label="gather_kv_pages + SDPA on the gathered view",
            compare="bf16" if dtype == torch.bfloat16 else "fp32",
            bound=bound_ms(2 * live * KV * D * item + 2 * B * H * D * item + B * T * 4 + B * 4,
                           4 * live * H * D, peaks, fp32=dtype == torch.float32)))
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
        elif case["compare"] == "fp32":
            err = float((got - ref).abs().max())
            # fp32 sums in another order: 1e-4 relative to the output's scale
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            ok = err <= tol and bool(torch.isfinite(got).all())
            extra = {}
        else:
            err = float((got.float() - ref.float()).abs().max())
            # fp32 arithmetic in a different order, one cast at the end (and
            # bf16 casts of normalised rows where an fp32 difference can
            # tip a rounding): allow two bf16 ulps at the output's scale
            tol = 2 * bf16_ulp(float(ref.float().abs().max()))
            ok = err <= tol and bool(torch.isfinite(got).all())
            extra = {}
        if "library_label" in case:
            extra["library"] = case["library_label"]
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
    from deepspeed_tpu_torch.ops import paged_attention as pa

    return {"flash_attention_fwd": fa.KERNEL, "decode_attention": da.KERNEL,
            "norm_qkv": dl.NORM_PROJ, "post_attn": dl.POST_ATTN,
            "paged_attention": pa.KERNEL}


def zero_counts() -> None:
    for k in counters().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in counters().items()}


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

    zero_counts()
    logits, fwd_ms = timed(lambda: eng(ids))
    _, ttft_ms = timed(lambda: eng.generate(prompt, max_new_tokens=1))
    greedy, gen_ms = timed(lambda: eng.generate(prompt, max_new_tokens=new))
    sampled, samp_ms = timed(lambda: eng.generate(prompt, max_new_tokens=new, temperature=0.8,
                                                  top_p=0.9, seed=7))
    launches = read_counts()
    ticks = 2 * (new - 1)   # greedy + sampled; the max_new_tokens=1 run has no tick
    expected = {"flash_attention_fwd": L, "decode_attention": L * ticks,
                "norm_qkv": L * ticks, "post_attn": L * ticks, "paged_attention": 0}
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


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def serve_requests(vocab: int):
    """32 chat requests: a shared 192-token system prompt plus a unique
    16–64-token suffix, 64–128 new tokens; even uids greedy, odd uids
    sampled at T=0.8, top-p 0.9."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    system = rng.integers(0, vocab, size=192)
    reqs = []
    for i in range(32):
        suffix = rng.integers(0, vocab, size=int(rng.integers(16, 65)))
        reqs.append(dict(prompt=np.concatenate([system, suffix]).astype(np.int32),
                         max_new_tokens=int(rng.integers(64, 129)),
                         temperature=0.0 if i % 2 == 0 else 0.8,
                         top_p=1.0 if i % 2 == 0 else 0.9))
    return reqs


def serve_pass(torch, batcher, reqs):
    """Submit every request at once, ``step(ticks=8)`` until all finish;
    returns the outputs in request order and the pass's numbers."""
    pc = batcher.prefix_cache
    hit0, miss0 = (pc.hit_tokens, pc.miss_tokens) if pc is not None else (0, 0)
    st0 = dict(batcher.stats)
    batcher.reset_latency_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uids = [batcher.submit(**r) for r in reqs]
    out = {}
    while len(out) < len(uids):
        out.update(batcher.step(ticks=8))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = {k: batcher.stats[k] - st0[k] for k in st0}
    lat = batcher.latency_stats()
    hit, miss = (pc.hit_tokens - hit0, pc.miss_tokens - miss0) if pc is not None else (0, 0)
    nums = dict(wall_s=wall, ttft_p50_ms=lat["ttft_p50_s"] * 1e3,
                ttft_p90_ms=lat["ttft_p90_s"] * 1e3, e2e_p50_ms=lat["e2e_p50_s"] * 1e3,
                decode_tokens_per_s=st["decode_tokens"] / st["decode_s"],
                ms_per_tick=st["decode_s"] * 1e3 / st["ticks"], ticks=st["ticks"],
                windows=st["windows"], one_token_prefills=st["one_token_prefills"],
                prefill_tokens=st["prefill_tokens"], hit_tokens=hit, miss_tokens=miss,
                hit_token_share=hit / max(1, hit + miss), leaks=batcher.leak_counts())
    return [out[u] for u in uids], nums


def serve_profile(torch, batcher, reqs, out_path=None):
    """Device time against wall time for one 16-tick decode window of 8
    live slots (greedy and sampled rows, no waiters): the serve tick's
    device busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    uids = [batcher.submit(**r) for r in reqs[:batcher.n_slots]]
    batcher.step(ticks=1)                       # admit and place all eight
    st0 = dict(batcher.stats)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batcher.step(ticks=16)
        torch.cuda.synchronize()
    ticks = batcher.stats["ticks"] - st0["ticks"]
    wall_ms = (batcher.stats["decode_s"] - st0["decode_s"]) * 1e3
    dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e3
    batcher.wait(uids)
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=50))
    return dict(window_ticks=ticks, tick_wall_ms=wall_ms / ticks,
                tick_device_ms=dev_ms / ticks if dev_ms else "not measured",
                tick_device_busy_share=dev_ms / wall_ms if dev_ms else "not measured")


def run_serve(torch, delta_of, out_dir=None):
    """gpt2-125m behind ContinuousBatcher in both cache modes, two passes
    each; launch counts zeroed before each mode and read after it."""
    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

    cfg = gpt2_config("gpt2-125m")
    model = GPT2LMHeadModel(cfg).init_weights(torch.Generator().manual_seed(SEED))
    eng = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512)
    reqs = serve_requests(cfg.vocab_size)
    L, V = cfg.n_layer, cfg.vocab_size
    modes = {"paged": {"page_tokens": 16, "n_pages": 512}, "contiguous": None}
    ok, greedy_out, by_mode = True, {}, {}
    for mode, pc in modes.items():
        batcher = ds.ContinuousBatcher(eng, n_slots=8, prefix_cache=pc, seed=SEED)
        zero_counts()
        outs, passes = [], []
        for _ in range(2):
            o, nums = serve_pass(torch, batcher, reqs)
            outs.append(o)
            passes.append(nums)
        launches = read_counts()
        by_mode[f"serve_{mode}"] = launches
        singles = sum(p["ticks"] + p["one_token_prefills"] for p in passes)
        attn = "paged_attention" if mode == "paged" else "decode_attention"
        other = "decode_attention" if mode == "paged" else "paged_attention"
        expected = {attn: L * singles, other: 0, "norm_qkv": L * singles,
                    "post_attn": L * singles, "flash_attention_fwd": 0}
        checks = {"launch_counts": launches == expected,
                  "no_leaks": all(v == 0 for p in passes for v in p["leaks"].values()),
                  "shapes_and_vocab": all(len(o) == len(r["prompt"]) + r["max_new_tokens"]
                                          and int(o.max()) < V
                                          for o_pass in outs for o, r in zip(o_pass, reqs))}
        if mode == "paged":
            checks["pass2_hits"] = passes[1]["hit_tokens"] > 0
        # greedy streams teacher-forced through the card's own forward
        agree, ties = [], []
        for o_pass in outs:
            for i in range(0, len(reqs), 2):
                seq = torch.as_tensor(o_pass[i], dtype=torch.long, device=eng.device)
                n0 = len(reqs[i]["prompt"])
                lg = eng(seq[None, :-1])[0, n0 - 1:, :V].float()
                pick = seq[n0:]
                agree.append(float((lg.argmax(-1) == pick).float().mean()))
                ties.append(near_max_share(pick, lg, delta_of(lg)))
        tf_strict, tf_ties = float(np.mean(agree)), float(np.mean(ties))
        checks["greedy_teacher_forced"] = tf_ties >= 0.99 and tf_strict >= 0.95
        greedy_out[mode] = [outs[p][i] for p in range(2) for i in range(0, len(reqs), 2)]
        if mode == "paged":
            samp = sampling_check(torch, eng, reqs, outs[0])
            checks["sampling_card_vs_cpu"] = samp["ok"]
        prof = serve_profile(torch, batcher, reqs,
                             out_dir and os.path.join(out_dir, f"profile_serve_{mode}.txt"))
        checks["no_leaks"] &= all(v == 0 for v in batcher.leak_counts().values())
        emit(dict(phase="serve", mode=mode, model="gpt2-125m", dtype="bfloat16", n_slots=8,
                  requests=len(reqs), prefix_cache=pc, passes=passes, launches=launches,
                  expected_launches=expected, teacher_forced_top1=tf_strict,
                  teacher_forced_within_delta=tf_ties, profile=prof, checks=checks))
        ok &= all(checks.values())
        del batcher
    a, b = greedy_out["paged"], greedy_out["contiguous"]
    same = [float(np.mean(x[len(r["prompt"]):] == y[len(r["prompt"]):]))
            for x, y, r in zip(a, b, [reqs[i] for _ in range(2) for i in range(0, len(reqs), 2)])]
    emit(dict(phase="serve_compare", greedy_tokens_equal_paged_vs_contiguous=float(np.mean(same)),
              greedy_streams_identical=sum(s == 1.0 for s in same), greedy_streams=len(same)))
    return by_mode, ok


def sampling_check(torch, eng, reqs, outs, per_stream: int = 16):
    """The batcher's per-row sampling step on the card against the same step
    on the CPU, over logits the traffic produces: the sampled streams of one
    pass teacher-forced through the card's forward, ``per_stream`` positions
    each. Rows alternate greedy and T=0.8/top-p 0.9 as the traffic does, and
    every fourth row also takes a repetition penalty of 1.3 over its prompt.

    Greedy rows must pick the same token. Random-weight logits are so flat
    (~2e-5 mass per token) that the two devices' fp32 cumsum rounding
    (~6e-8) can move a sampled pick across a step, so a sampled pick must
    sit on the CPU's fp64 CDF at the same uniform within ``cdf_tol``, a
    tenth of a mean token's mass: a pick one token off fails on about half
    of the rows."""
    import numpy as np

    from deepspeed_tpu_torch.inference.engine import _filtered_logits, _penalized_logits
    from deepspeed_tpu_torch.inference.serving import _uniforms, sample_rows

    V = eng.model_cfg.vocab_size
    rows, seen_rows = [], []
    for i in range(1, len(reqs), 2):
        seq = torch.as_tensor(outs[i], dtype=torch.long, device=eng.device)
        n0 = len(reqs[i]["prompt"])
        lg = eng(seq[None, :-1])[0, n0 - 1:n0 - 1 + per_stream].float()
        rows.append(lg)
        seen = torch.zeros((len(lg), lg.shape[-1]), dtype=torch.bool, device=eng.device)
        seen[:, seq[:n0]] = True
        seen_rows.append(seen)
    logits, seen = torch.cat(rows), torch.cat(seen_rows)
    n = logits.shape[0]
    k = np.arange(n)
    temp = np.where(k % 2 == 1, 0.8, 0.0).astype(np.float32)
    top_p = np.where(k % 2 == 1, 0.9, 1.0).astype(np.float32)
    rep = np.where(k % 4 == 3, 1.3, 1.0).astype(np.float32)
    u = torch.as_tensor(_uniforms(SEED, 1, n))

    def pick(dev):
        t, p, r = (torch.as_tensor(a, device=dev) for a in (temp, top_p, rep))
        return sample_rows(logits.to(dev), False, t, p, r, seen.to(dev), u.to(dev), 0).cpu()

    card, cpu = pick(eng.device), pick("cpu")
    greedy, sampled = torch.as_tensor(temp <= 0), torch.as_tensor(temp > 0)
    # where the card's pick lies on the CPU's CDF at the same uniform
    lg = _penalized_logits(logits.cpu(), torch.as_tensor(rep)[:, None], seen.cpu())
    probs = torch.softmax(_filtered_logits(lg, torch.as_tensor(temp), 0, torch.as_tensor(top_p)),
                          dim=-1).double()
    cdf = torch.cumsum(probs, dim=-1)
    x = u.double() * cdf[:, -1]
    hi = cdf.gather(1, card[:, None])[:, 0]
    lo = hi - probs.gather(1, card[:, None])[:, 0]
    cdf_tol = 2e-6
    on_cdf = (x >= lo - cdf_tol) & (x <= hi + cdf_tol)
    res = dict(rows=n, greedy_rows=int(greedy.sum()), sampled_rows=int(sampled.sum()),
               greedy_equal=bool((card[greedy] == cpu[greedy]).all()),
               sampled_equal_share=float((card[sampled] == cpu[sampled]).float().mean()),
               sampled_on_cpu_cdf=bool(on_cdf[sampled].all()), cdf_tol=cdf_tol,
               picks_below_vocab=bool((card < V).all()))
    res["ok"] = res["greedy_equal"] and res["sampled_on_cpu_cdf"] and res["picks_below_vocab"]
    emit(dict(phase="serve_sampling", **res))
    return res


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
              peaks={"bytes_per_s": peaks[0], "bf16_flops": peaks[1], "fp32_flops": peaks[2]}))

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
    del eng
    serve_launches, serve_ok = run_serve(
        torch, lambda lg: 2 * bf16_ulp(float(lg.abs().max())), args.out)
    ok &= serve_ok
    # each path's counts were zeroed before it and read after it
    by_path = {"generate": launches, **serve_launches}

    summary = []
    for case, r in kernel_results:
        if not case["main"]:
            continue
        per_path = {p: c.get(case["name"], 0) for p, c in by_path.items()}
        summary.append(dict(
            name=case["name"], route="cuda", source=case["source"], replaces=case["replaces"],
            launches=sum(per_path.values()), launches_by_path=per_path,
            max_abs_err=r["max_err"], ms=r["kernel_ms"],
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
