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
6b. serve_w8 GPT-2-760M (E=1536, 24 layers, 16 heads, D=96; random weights
            from seed 1234) served in int8 (``quant={"enabled": True,
            "bits": 8}``: W8A16, int8 codes + fp32 scales per 128 rows) and in
            bf16 from the same weights, through the batcher with page-resident
            KV (and the int8 engine with contiguous slots), the serve phase's
            32 requests twice each: TTFT, e2e, decode tokens/s, ms per tick,
            device ms per tick from a profiled window, resident weight bytes,
            launches held against the ticks and the batcher's record of
            prefill chunks. Gates: the dense weights' bytes (0.516 of bf16's,
            layer 0 exactly), codes quantized on the card equal the CPU's,
            the forward (B=1, S=256) within 8 bf16 ulps of a CPU fp32 engine
            holding the same codes, 8 greedy streams teacher-forced through
            that engine (tie-aware ≥ 99%, strict ≥ 95%), the int8-vs-bf16
            logits' relative RMS ≤ 0.1, no leaks. Then ``generate`` (B=8,
            prompt 256, 64 new) with the fused decode kernels on (their W8
            branches) and off (the w8 matmul carries the ticks).
6c. serve_llama  llama-1b (E=2048, 22 layers, 32 query heads over 4 KV
            heads, D=64, F=8192, vocab 32000; random weights from seed 1234)
            through ``init_inference(max_tokens=512)`` in bf16 and in W8A16
            from the same weights: the batcher with page-resident KV (16-token
            pages, 8 slots) on the serve phase's 32 requests twice each, with
            each path's latency, ticks, device ms per tick and launches (per
            single-token forward and layer: 3 RMSNorm -> projection kernels,
            one o-proj -> RMSNorm -> SwiGLU call, one paged attention; the w8
            matmul as the prefill chunks imply); the sampling step on the card
            against the CPU, u = 0 draws included; ``engine(ids)`` at B=2,
            S=1024 (the flash forward at H=32); ``generate`` (B=8, prompt 256,
            64 new) with the fused decode kernels on and off in both dtypes.
            Gates: the forward (B=1, S=128) within 8 bf16 ulps of a CPU fp32
            engine holding each card engine's own weights, the int8-vs-bf16
            logits' relative RMS <= 0.1, the dense bytes (int8 / bf16 = 33/64
            exactly), no leaks, seeded sampling repeats, and the greedy
            streams teacher-forced through an fp32 engine on the card (itself
            within 1e-3 of the CPU's): >= 99% within two bf16 ulps of its
            maximum, and its argmax wherever its top two lie more than 16 ulps
            apart (the strict share is printed: random-weight llama-1b logits
            are too flat for any bf16 path to reach 95% strict).
6d. serve_neox  pythia-1b (E=2048, 16 layers, 8 heads, D=256, F=8192,
            rotary_pct 0.25, vocab 50432, untied head; 1,012,305,920
            parameters, random weights from seed 1234) through
            ``init_inference(max_tokens=512)`` in bf16 and in W8A16 from the
            same weights, as serve_llama runs llama-1b: the batcher (page-
            resident, 8 slots, the 32 requests twice; per single-token
            forward and layer one LayerNorm -> qkv kernel, one exact-GELU
            parallel-residual post_attn call, one paged attention at D=256),
            ``engine(ids)`` at B=2, S=1024 (the flash forward at D=256),
            ``generate`` fused on and off (decode attention at D=256), and the
            sequential-residual variant at 2 layers (one fused ``generate``
            per dtype: the exact-GELU sequential branches). The same gates
            as serve_llama, every greedy stream teacher-forced through an fp32
            engine on the card holding the same weights.
6e. slice_fused_mlp  GPT-2-125M with ``fused_mlp=True`` (random weights
            from seed 1234) through ``init_inference``: ``engine(ids)`` at
            B=2, S=1024 against the unfused engine and an fp32 engine on the
            card, ``generate`` (B=8, prompt 256, 128 new) with fused decode
            ticks and with every tick through the fused FFN, and one
            page-resident batcher pass of the serve phase's requests, each
            with its exact launch counts and greedy streams teacher-forced
            through the fp32 engine.
6f. serve_graph_parity  every ``generate`` and batcher above runs its
            decode ticks as replays of a captured CUDA graph (the default,
            ``compiled_loop=True``); this phase holds that path against the
            eager one: gpt2-125m, llama-1b and pythia-1b at full width and
            two layers, bf16 and W8A16, the batcher page-resident and with
            contiguous slots (12 of the serve requests, greedy and sampled
            rows) and ``generate`` greedy and sampled, with the fused decode
            kernels and without (the W8 matmul's ticks; GPT-2 with
            ``fused_mlp=True``: the fused FFN's 8-row forward): tokens
            identical bit for bit, launch counts equal kernel by kernel (the
            graph run's read as its eager prefills and first ticks plus each
            graph's launches per replay times its replays), both walls, each
            graph's capture time and the programmatic edges capture kept.
7. train    GPT-2-125M at full width and depth through ``initialize`` with
            the JAX package's flagship training config (S=1024, micro 24,
            gradient accumulation 4, adamw lr 1e-4 wd 0.1, clipping 1.0,
            ZeRO stage 1, bf16 gradient accumulation, the chunked CE head
            as one chunk): first a gradient gate at micro 2 (the fp32
            engine through the flash kernels against the fp32 engine on
            dense attention, per-leaf relative error ≤ 1e-3; the merged
            backward against the split pair; the bf16 engine against fp32
            dense, cosine ≥ 0.99 per leaf; one micro 2 × gas 2 step with
            bf16 gradient accumulation against the same step in fp32:
            grad_norm within 2^-7, each element's update within 2·lr and
            ≤ 1% of them off by more than lr/2), then 2 warm-up and 8 timed
            ``train_batches`` steps on a fixed seeded batch (losses finite
            and falling, exactly 12 × 4 forward and merged-backward
            launches per step), one profiled step (device busy share, top
            device ops) and steps with ``DS_TPU_FLASH_BWD=split``: one
            counted and timed (wall ms; 12 × 4 launches of each tensor-core
            split kernel by symbol, no CUDA-core flash kernel), one profiled
            (device ms).
7a. train_flash_precision  gpt2-125m at the gate's micro 2 × gas 2, S=1024:
            16 steps over 16 distinct seeded batches from one seeded init, in
            bf16 merged (twice: its run-to-run spread), bf16 split (p and ds
            fp32-grade) and fp32; each bf16 run's loss gaps to fp32, the
            step-1 gradient cosines, exact launches by symbol, and whether
            merged's gap exceeds split's by more than twice the spread.
7b. train_fused_mlp  the train phase's model and config with
            ``fused_mlp=True``: a gradient gate at micro 2 (the bf16 fused
            engine against the fp32 and the bf16 unfused engines), 2 warm-up
            and 4 timed steps (12 × 4 launches of each fused FFN entry per
            step: the tensor-core forward and dx, and dw; peak memory beside
            the train phase's), a profiled step (the forward's, dx's and dw's
            device ms), and one step under ``dots_saveable`` from the same
            weights.
7c. train_loss_pallas  the train phase's model, config, seeded weights and
            batch with ``loss_pallas=True`` (the fused CE head on the tensor
            cores): its loss and the gradients of ``wte`` and ``ln_f``'s scale
            on the first micro-batch against the chunked head's at the same
            weights (loss within 1e-3 relative, cosine >= 0.9999), one warm-up
            and 3 timed steps (exactly 4 launches of each tensor-core entry
            per step, flash as the chunked step), a profiled step beside one
            of the chunked engine (device ms each); then the fp32 engine at
            micro 1 (the CUDA-core route: one launch of each of its entries),
            the same gate.
8. train_1p5b  GPT-2-1.5B at full width and depth through ``initialize``
            with the JAX package's north-star recipe (S=1024, micro 2,
            adamw8bit lr 1e-4 wd 0.1 with the fused update kernel, ZeRO
            stage 3, remat ``dots_saveable+flash``, the chunked CE head at
            ``loss_chunk`` 8192, bf16 compute over fp32 masters): 2 warm-up
            and 8 timed steps (tokens/s, ms per step, MFU, peak memory, the
            optimizer state's bytes against fp32 AdamW's; exactly the
            optimizer's ``launches_per_step`` adam8bit launches (its leaf
            table: two) and 48 flash forward and merged-backward launches
            per step), the fused update against the unfused chain from the
            same state and gradients and against one-leaf calls of the same
            kernel (the same bits), with their times, one
            profiled step, and one step each of engines built from the same
            weights under ``dots_saveable`` (96 flash forwards) and
            ``loss_pallas`` (one launch of each tensor-core fused CE entry),
            their losses held against the chunked head's at those weights
            (``loss_pallas`` also its head gradients, as in 7c).

The kernels phase also holds the fused adam8bit update at the 1.5B leaf
shapes (and a 100000-wide row, three steps in place, and one table over
leaves of widths 1, 3, 17, 1600, 4800, 6400 and 100000 with a 0-d leaf
beside, each case repeated bit for bit, launches counted) against its plain
version, and the fused CE head's two routes (``kernels_fused_ce``): the
tensor-core forward and backward at the 1.5B head, gpt2-125m's micro-batch
(N=24576, E=768: ten vocab chunks) and a ragged bf16 shape, the CUDA-core
kernels at the ragged shape in fp32. Each is held against the plain
version (nll and lse within 1e-4 of max(1, |lse|); dh and dw element by
element within ``ce_reference``'s limits, half a bf16 ulp added where the
kernel casts, with the limits' power gated), repeats bit for bit (the
tensor-core route has no atomics), launches its route's entry once a call
and the library's device kernels as the plan implies, and is timed beside
the plain version, the chunked head and the bound (the backward's by
device kernel). ``kernels_fused_ce_mask_probe`` scales W's padded rows so
that an unmasked softmax would move lse past 100 limits;
``kernels_fused_ce_cancel`` builds logits from cancelling 64-wide K blocks,
whose control (partials rounded to bf16 per K step) must miss.
``scripts/fused_ce_planted_faults.py`` shows these checks failing kernels
with a planted fault; ``scripts/fused_ce_ab.py`` times two trees in turns. It also holds the flash backward kernels (merged, and the
split dq/dkv pair) against their plain version: bf16 (the tensor-core
forward, merged backward and split pair) at the train shapes, at D=128 and
D=256, at S=200 and S=1000 and at a non-causal S=384, Sk=640, and fp32 (the
CUDA-core kernels) at D=128, D=256, a ragged S and a non-causal Sk != S,
each with its device time, the plain version's, SDPA's backward and the
bound (the split pair's hi + lo floor beside it), and the kernels that ran,
as the C libraries count their launches. At each of these
cases the forward kernel's output and lse, which the backward takes, are
held against the plain forward first; at the bf16 cases the forward is
timed too (the train shape's is the ``at_train_shape`` entry of its
``kernels`` row). The bf16 flash outputs are held element by element
(``FLASH_LIMIT``: the kernels round p and ds to bf16, each addend within
2^-8 of itself) beside the fp64 values; the bf16 split pair, whose p and ds
enter the tensor cores as hi + lo, must also meet that limit without the
2^-8 term and repeat bit for bit. ``scripts/flash_planted_faults.py``
shows those checks failing kernels with a planted fault.

The kernels phase also holds the LLaMA branches (``kernels_llama``): the
RMSNorm -> projection kernel at M=8, E=2048, N=2048 and 256, and the
o-proj -> RMSNorm -> SwiGLU -> residual kernel at E=2048, F=8192, in bf16
and W8A16 (128-row groups and one group), then in fp32 at a small shape;
decode and paged attention at 8 query heads per KV head (H=32, KV=4, D=64),
the flash forward at H=32 and the w8 matmul on llama-1b's four panels, each
beside its library call where one exists.

The kernels phase also holds the GPT-NeoX branches (``kernels_neox``): every
branch of the o-proj -> norm -> MLP -> residual kernel beside GPT-2's and
LLaMA's (the exact GELU and the parallel residual with either GELU form,
under LayerNorm and RMSNorm, and SwiGLU under the parallel residual) at
M=8, E=2048, F=8192 in bf16 and W8A16, the four LayerNorm GELU branches
timed; each in fp32 at a small shape; each GELU branch again where the
exact and the tanh forms part by more than the limit, held against its
plain version and, as a control that must miss, against the other form's
(``kernels_neox_gelu_probe``); the LayerNorm -> qkv kernel at N=6144;
decode, paged and flash attention at H=KV=8, D=256 beside SDPA; the w8
matmul on pythia-1b's four panels.

The kernels phase also holds the fused FFN's kernels
(``kernels_fused_mlp``): forward, dx and dw at E=768, F=3072 in bf16 for R
= 24576 (the flagship micro-batch), 2048, 8 and 1000 rows against their
plain versions, the forward on both routes (the tensor-core GEMMs and the
mma.sync kernel; ``main_route`` marks the one the row rule gives) and dx on
its tensor-core GEMMs, timed beside the unfused torch pair (forward, and
its autograd backward beside dx and dw), dx's own unfused chain and the
bound; in fp32 at small shapes; and a GELU probe
(``kernels_fused_mlp_gelu_probe``, both bf16 routes) whose control, the
plain versions with the erf GELU, must miss. The Hopper kernels (the
tensor-core forward and dx, the dw cluster kernel) also against the plain
models of their order, bit for bit on a second call, with the library's
launches by kernel (the forward and dx also under a plan forced to three
row chunks, their loop that keeps a larger call's scratch within 256 MiB)
and their registers and spills (``build_fused_mlp_sm90``); dw also with the
floor with du's and h's lo halves, at E = 64, 384 and a ragged R
(``kernels_fused_mlp_dw``). Three probes hold fp32 intermediates through
cancellation, each with a control that rounds the intermediate to bf16 and
must miss: du's lo halves in dw1 (``kernels_fused_mlp_dw_cancel``), u + b1
and the splits' partials in the forward (``kernels_fused_mlp_fwd_cancel``),
dh across the blocks of E and the splits' partials in dx
(``kernels_fused_mlp_dx_cancel``).

The kernels phase also holds block-sparse attention (``kernels_sparse``)
at BERT-large's heads (H=16, D=64): the Fixed layout at B=16, S=512, block
16 (bidirectional; unidirectional and causal; one query block emptied, whose
rows must be zeros), the Dense layout, BigBird, BSLongformer, Variable and
a per-head BigBird layout at B=2, S=4096, block 64, and one row of every
key block beside two emptied ones at B=8, S=1024, block 16; then D=128 at
blocks 32 and 128, causal and not. bf16 runs the tensor-core kernel (and
its merge where a tile is split), fp32 the CUDA-core one: each case
through ``sparse_attention`` and again through the kernel on a plan built
once (bit for bit), each element within one ulp plus 1e-5 of sum_j p_j
|v_j| / l of the plain version, with an fp64 witness, the plan's plain
twin by the same limit (bf16), and exact launches of each kernel; bf16
timed beside its plain version, SDPA with the expanded element mask, dense
SDPA, the bound and the hi + lo floor (where some LUT rows are four times
the median, those rows alone and the rest alone, each from a plan of its
own), fp32 timed at case a. And the six fused-op kernels
(``kernels_fused_ops``): LayerNorm at (8192, 1024), bias-GELU at (8192,
4096), the attention softmax at (256, 512, 512) with and without the causal
mask and at (256, 128, 512), forward and backward (each backward on the
plain forward's saved outputs), in bf16 timed beside the library call(s)
and the bound, in fp32 at ragged widths and with Sq > Sk (NaN rows where
the plain version has them), and a mean-1000 LayerNorm held against the
one-pass plain version (the two-pass value must miss); the LayerNorm
backward also against its tiled plain version bit for bit, repeated bit for
bit, its time split into the rows kernel and the partial rows' sum
(``kernels_ln_bwd``: ``run_ln_bwd_checks``' shapes); the softmax forward
also past the held kernel's width (bf16 (16, 64, 4096) causal, fp32 (2,
33, 2051)), its time split into the held and wide kernels, its causal bound
counting the kept keys' reads, each case called twice on output memory
filled with NaN beforehand: the same bits, every masked key 0, a row that
keeps no key all NaN (``kernels_softmax_fwd``: ``run_softmax_fwd_checks``'
shapes, every held width). Two paths drive the
public entry points with exact launch counts: ``sparse_attention_api``
(``SparseSelfAttention(FixedSparsityConfig(num_heads=16, block=16),
impl="pallas")`` called four times in bf16: four launches of the
tensor-core kernel, nothing else; a backward through it raises; then once
in fp32, ``sparse_attention_api_fp32``: one launch of the CUDA-core
kernel) and ``fused_ops_train`` (a forward and
``.backward()`` through each op, then a ``no_grad`` forward: two forward
launches and one backward launch of each).

The kernels phase also holds the bf16 decode-layer kernels on the tensor
cores (``kernels_decode_sm90``, ``csrc/decode_gemv_sm90.cuh``): norm_proj
(LayerNorm at N=6144, RMSNorm at N=2048 and 256) and every branch of
post_attn at E=2048, F=8192, with bf16 weights and W8A16 (128-row groups and
one group), at M = 1, 8, 13 and 64, each within ``w8_limits`` of the plain
version and of the fp64 value with the same bf16 casts, bit-identical on a
second call and run by the tensor-core GEMV and the norm's kernel alone (the
library's own counts), timed (the union of the call's kernels) beside the
unfused PyTorch chain; the bf16 rows 6-7 cases of the other phases carry the
same repeat and launch gates. ``build_decode_sm90`` prints each tensor-core
kernel's registers, shared memory and spills from the build log (no spills
gated). ``scripts/decode_layer_planted_faults.py`` shows these checks
failing kernels with a planted fault; ``scripts/decode_layer_ab.py`` times
two trees' kernels in turns.

The kernels phase also holds the W8A16 kernels (``kernels_w8``): the w8
matmul (the tensor-core decode GEMV's W8 instantiation) at M = 1, 8, 37, 64
on gpt2-760m's four dense panels and on one single-group panel, and at M =
8 and 64 on llama-1b's and pythia-1b's, each against its plain version,
the plain model of its order and the fp64 value, bit for bit on a second
call, with the library's launches by kernel; the W8 branches of the two
decode-layer kernels at M=8 and the 760m and 125m widths (125m also with
one group per panel), each element within its stated limit of the plain
version; each timed with the plain version, the bound and (w8 matmul) the
dequantize + ``matmul`` pair; then in fp32. The build log's registers of the
W8 matmul (``build_w8_matmul``, no spills) and of the fused FFN's Hopper
kernels (``build_fused_mlp_sm90``) stand beside it.

The ``kernels`` line gives each kernel's launches per path (``generate``,
``serve_paged``, ``serve_contiguous``, ``serve_w8_paged``,
``serve_w8_contiguous``, ``serve_bf16_760m``, ``generate_w8_fused``,
``generate_w8_unfused``, ``serve_llama_paged``, ``serve_llama_w8_paged``,
``forward_llama``, ``generate_llama{,_w8}_{fused,unfused}``,
``serve_neox{,_w8}_paged``, ``forward_neox``,
``generate_neox{,_w8}_{fused,unfused}``, ``generate_neox_seq{,_w8}_fused``,
``forward_fused_mlp``, ``generate_fused_mlp{,_unfused_ticks}``,
``serve_fused_mlp_paged``, ``sparse_attention_api{,_fp32}``, ``fused_ops_train``,
``train``, ``train_flash_precision_{merged,merged_again,split,fp32}``,
``train_loss_pallas{,_fp32}``, ``train_fused_mlp{,_remat}``,
``train_split``, ``train_1p5b``,
``train_1p5b_dots``, ``train_1p5b_pallas``: each zeroed before its run and
read after it) and their sum; the rows of kernels that llama-1b and
pythia-1b also run carry ``at_llama_1b`` and ``at_pythia_1b``.

It exits non-zero, printing no result line, without CUDA or outside the
repository; any failed phase makes it exit non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--out DIR`` also writes the compiler output, the profiler tables and every
JSON line (``smoke.jsonl``) there.
"""
from __future__ import annotations

import argparse
import contextlib
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


# with --out, every emitted line is also appended here: the tool that runs
# the script on the card returns only the end of its output
_LOG_PATH = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _LOG_PATH:
        with open(_LOG_PATH, "a") as fh:
            fh.write(line + "\n")


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
    return device_ms_by_name(torch, fn, iters)[0]


def device_ms_of(prof) -> dict:
    """Device ms by kernel (or copy) name in a finished torch.profiler run:
    the summed durations of its CUDA events."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


# the tensor-core flash kernels' symbols (bf16); the CUDA-core ones (fp32)
# are flash_fwd_kernel, flash_bwd_kv_kernel (merged and split dkv) and
# flash_bwd_dq_kernel
FLASH_SM90 = {"fwd": "flash_fwd_sm90_kernel", "bwd": "flash_bwd_sm90_kernel",
              "dq": "flash_bwd_dq_sm90_kernel", "dkv": "flash_bwd_dkv_sm90_kernel"}
FLASH_CUDA_CORE = {"fwd": "flash_fwd_kernel", "bwd": "flash_bwd_kv_kernel",
                   "dq": "flash_bwd_dq_kernel", "dkv": "flash_bwd_kv_kernel"}

BF16_UNIT = 2.0 ** -8   # bf16's unit roundoff: 8 significant bits, rounded to nearest
FLASH_LIMIT = ("per element: 1 bf16 ulp of the larger value + (2^-8 + 1e-5) x the sum of "
               "its addends' magnitudes (the kernels round p, and ds, to bf16 before the "
               "products that take them); 2 bf16 ulps at the output's scale; against the "
               "fp64 value within max(1, the plain version's ratio)")


def flash_launched(fa, before: dict) -> dict:
    """The flash kernels launched since ``before`` (``fa.kernel_launches()``
    then), by symbol, as the C libraries count them."""
    return {n: c - before[n] for n, c in fa.kernel_launches().items()}


def flash_fp64(torch, q, k, v, causal: bool, scale: float, o=None, lse=None, do=None):
    """The flash function's exact values in fp64 on the card, each with its
    elements' sums of addend magnitudes: ``[(out, mag)]`` for the forward
    (mag = sum_j p_j |v_j| / l); with ``o``, ``lse`` (B·H, 1, S) and ``do``,
    ``[(dq, mag), (dk, mag), (dv, mag)]`` for the backward from those inputs
    (delta = rowsum(do·o)): dv's sum_i p_ij |do_i|; dk's and dq's scale x
    sums of p (sum_d |do_d v_d| + sum_d |do_d o_d|) |q| or |k|, which bound
    |ds| and the fp32 error of dp - delta. Heads in chunks of S x Sk
    matrices of about 256 MB."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    dev, f64 = q.device, torch.float64
    keep = (torch.arange(S, device=dev)[:, None] >= torch.arange(Sk, device=dev)[None, :]
            if causal else None)
    outs = (q,) if do is None else (q, k, v)
    exact = [torch.empty(t.shape, dtype=f64, device=dev) for t in outs]
    mag = [torch.empty_like(e) for e in exact]
    hc = max(1, min(H, (1 << 28) // (8 * S * Sk)))
    for b in range(B):
        for h0 in range(0, H, hc):
            h1 = min(H, h0 + hc)

            def heads(x):  # (heads, rows, D) in fp64
                return x[b, :, h0:h1].to(f64).transpose(0, 1)
            qb, kb, vb = heads(q), heads(k), heads(v)
            s = scale * qb @ kb.transpose(1, 2)
            if keep is not None:
                s = s.masked_fill(~keep, float("-inf"))
            if do is None:
                m = s.amax(-1, keepdim=True)
                p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
                l = p.sum(-1, keepdim=True)
                l = torch.where(l == 0, torch.ones_like(l), l)
                pairs = [(p @ vb / l, p @ vb.abs() / l)]
            else:
                dob, ob = heads(do), heads(o)
                p = torch.exp(s - lse.reshape(B, H, S)[b, h0:h1, :, None].to(f64))
                ds = p * (dob @ vb.transpose(1, 2) - (dob * ob).sum(-1, keepdim=True))
                t = p * (dob.abs() @ vb.abs().transpose(1, 2)
                         + (dob * ob).abs().sum(-1, keepdim=True))
                pairs = [(scale * ds @ kb, scale * t @ kb.abs()),
                         (scale * ds.transpose(1, 2) @ qb, scale * t.transpose(1, 2) @ qb.abs()),
                         (p.transpose(1, 2) @ dob, p.transpose(1, 2) @ dob.abs())]
            for i, (e, m_) in enumerate(pairs):
                exact[i][b, :, h0:h1] = e.transpose(0, 1)
                mag[i][b, :, h0:h1] = m_.transpose(0, 1)
    return list(zip(exact, mag))


def flash_check(torch, got, ref, exact, mag) -> dict:
    """A bf16 flash output against its plain version. The tensor-core
    kernels round p (forward: the operand of o += p v, while l sums the
    fp32 p; backward: of dv += p^T do) and ds (of dk and dq) to bf16; the
    plain versions keep both in fp32. Each addend is then within 2^-8 of
    itself, so each element must lie within one bf16 ulp of the larger of
    the two values + (2^-8 + 1e-5) x its sum of addend magnitudes (``mag``;
    1e-5 for fp32 sums in another order), and within two bf16 ulps at the
    output's scale. The witness: the ratio to the limit without the 2^-8
    term (what rounding p and ds costs), and the kernel and the plain version
    against the fp64 value (``exact``) in units of the limit at that value;
    the kernel must lie within max(1, the plain version's ratio) of it."""
    d = (got.double() - ref.double()).abs()
    ulp = bf16_ulp_t(torch, torch.maximum(got.float().abs(), ref.float().abs())).double()
    lim_x = bf16_ulp_t(torch, exact).double() + (BF16_UNIT + 1e-5) * mag
    res = dict(max_err=float(d.max()), tol=2 * bf16_ulp(float(ref.float().abs().max())),
               err_over_limit=float((d / (ulp + (BF16_UNIT + 1e-5) * mag)).max()),
               err_over_fp32_limit=float((d / (ulp + 1e-5 * mag)).max()),
               kernel_vs_fp64_over_limit=float(((got.double() - exact).abs() / lim_x).max()),
               plain_vs_fp64_over_limit=float(((ref.double() - exact).abs() / lim_x).max()))
    res["fp64_anchor_ok"] = (res["kernel_vs_fp64_over_limit"]
                             <= max(1.0, res["plain_vs_fp64_over_limit"]))
    res["ok"] = (res["max_err"] <= res["tol"] and res["err_over_limit"] <= 1.0
                 and res["fp64_anchor_ok"] and bool(torch.isfinite(got).all()))
    return res


def device_ms_by_name(torch, fn, iters: int):
    """Mean device ms per call, in all and by kernel name (torch.profiler),
    after warm-up; (None, {}) if the profiler saw no device activity in
    five runs (it now and then drops a run's device events, once three runs
    in a row)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {k: v / iters for k, v in device_ms_of(prof).items()}
        if by_name:
            break
    return (sum(by_name.values()) or None), by_name


def device_union_ms(torch, fn, iters: int):
    """Mean device ms per call counted two ways from one profiled run of
    ``iters`` calls after warm-up: the kernels' summed durations, and the
    union of their intervals. A programmatic dependent launch starts while
    the kernel before it runs (its blocks wait in griddepcontrol.wait), so
    there the sum counts the overlap twice and the union is the card's busy
    time. (None, None) if the profiler saw no device activity in three runs."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, busy = device_sum_and_union_ms(prof)
        if total:
            return total / iters, busy / iters
    return None, None


def device_sum_and_union_ms(prof):
    """A finished torch.profiler run's device ms: the kernels' (and
    copies') summed durations, and the union of their intervals (0, 0 if
    it saw none)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return 0.0, 0.0
    busy, lo, hi = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + (hi - lo), a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return sum(b - a for a, b in spans) / 1e3, busy / 1e3


def graph_ms(torch, fn, iters: int):
    """Mean ms per call of ``iters`` calls captured in one CUDA graph and
    replayed five times, by CUDA events: the card's time for the calls back
    to back, without the host's enqueue. None (and the reason) if the calls
    cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (5 * iters)
        del graph
        return ms, None
    except Exception as exc:   # reported beside the other timings, not raised
        torch.cuda.synchronize()
        return None, f"{type(exc).__name__}: {exc}"[:300]


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
            compare="flash", causal=causal, scale=64 ** -0.5,
            bound=bound_ms(4 * B * S * H * D * 2 + B * H * S * 4, 4 * B * H * D * pairs, peaks)))

    B, S_max = 8, 512
    lengths = torch.tensor([1, 512, 37, 100, 256, 300, 511, 64], dtype=torch.int32, device=dev)
    live = int(lengths.sum())
    mask = (torch.arange(S_max, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    # gpt2-125m's heads, a GQA grouping, and gpt2-760m's (H = KV = 16, D = 96)
    for H, KV, D in ((12, 12, 64), (12, 4, 64), (16, 16, 96)):
        sets = [(randn(B, 1, H, D), randn(B, S_max, KV, D), randn(B, S_max, KV, D))
                for _ in range(10)]   # 10 caches of 6.3 MB (125m MHA): past the L2

        def sdpa(q, k, v, gqa=KV < H):
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask,
                                                  enable_gqa=gqa)
        cases.append(dict(
            name="decode_attention", shape=f"B={B} S_max={S_max} H={H} KV={KV} D={D} "
            "lengths=" + ",".join(str(int(x)) for x in lengths),
            main=(H, KV) == (12, 12), at="gpt2-760m" if D == 96 else None,
            replaces="deepspeed_tpu/ops/pallas/decode_attention.py:78",
            source="deepspeed_tpu_torch/ops/csrc/decode_attention.cu", sets=sets,
            kernel=lambda q, k, v: da.decode_attention(q, k, v, lengths),
            plain=lambda q, k, v, sc=D ** -0.5: da.decode_attention_plain(q, k, v, lengths, sc),
            library=sdpa, compare="bf16",
            library_label="SDPA, masked" + (f", enable_gqa ({H // KV} query heads per KV head)"
                                            if KV < H else ""),
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
        library=None, compare="bf16", decode_gemvs=1,
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
        plain=lambda *a: dl.post_attn_plain(*a[:6], a[6:], 1e-5),
        library=None, compare="bf16", decode_gemvs=3,
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
    """Paged decode attention at the serve phases' geometries (B=8, 16-token
    pages, 32 table entries; H=KV=12, D=64 for gpt2-125m and H=KV=16, D=96
    for gpt2-760m), in GQA (H=32, KV=8, D=128) and in fp32; live positions
    in shuffled pages, everything else NaN."""
    from deepspeed_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = []
    geoms = ((torch.bfloat16, 12, 12, 64, [1, 16, 17, 255, 256, 300, 511, 512]),
             (torch.bfloat16, 16, 16, 96, [1, 16, 17, 255, 256, 300, 511, 512]),
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
            main=dtype == torch.bfloat16 and D == 64, at="gpt2-760m" if D == 96 else None,
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
            lse_err = float((lse - rlse).abs().max())
            held = flash_check(torch, o, ro, *flash_fp64(torch, *args, case["causal"],
                                                         case["scale"])[0])
            err, tol = held.pop("max_err"), held.pop("tol")
            ok = held.pop("ok") and lse_err <= 1e-4 * max(1.0, float(rlse.abs().max()))
            extra = dict(held, lse_max_err=lse_err, limit=FLASH_LIMIT)
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
        if "decode_gemvs" in case:   # rows 6-7: the tensor-core kernels, bit for bit
            held = decode_sm90_held(torch, lambda: case["kernel"](*args), got,
                                    case["decode_gemvs"], False)
            extra.update(held)
            ok = ok and held["bitwise_repeat"] and held["sm90_ok"]
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
            if which == "kernel" and "decode_gemvs" in case:   # overlapping launches
                extra["kernel_sum_ms"], dev = device_union_ms(torch, call, n)
            else:
                dev = device_ms(torch, call, n)
            timed[which] = (dev, cuda_ms(torch, call, n))
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
         dl.fused_post_attn(*post[:6], post[6:]), dl.post_attn_plain(*post[:6], post[6:], 1e-5)),
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


def decode_split_cases(torch):
    """Decode and paged attention at the lengths around the kernels' 64-position
    chunks (none live, one, one short of a chunk, one and two chunks, one
    past, the whole cache, past the table), with NaN in every dead position
    of the caches and arenas: (name, kernel call, plain call, q, gathered
    K, V, lengths, scale, dtype) per case."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    cases = []
    # contiguous: (H, KV, D, dtype, S_max, lengths or a scalar length)
    for H, KV, D, dtype, S, lens in (
            (32, 4, 64, torch.bfloat16, 512, [0, 1, 63, 64, 65, 128, 129, 512]),
            (12, 4, 96, torch.bfloat16, 300, 129),                # generate's scalar length
            (16, 2, 128, torch.bfloat16, 40, [0, 1, 40]),         # one chunk, then the merge
            (8, 8, 256, torch.float32, 200, [0, 64, 65, 200])):   # fp32 at 143 KB of smem
        B = 3 if isinstance(lens, int) else len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev).expand(B).contiguous()
        dead = (torch.arange(S, device=dev)[None, :] >= lengths[:, None])[:, :, None, None]
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
        k, v = k.masked_fill(dead, float("nan")), v.masked_fill(dead, float("nan"))
        length = lens if isinstance(lens, int) else lengths
        cases.append((f"decode H={H} KV={KV} D={D} S_max={S} {str(dtype)[6:]} lengths={lens}",
                      lambda q=q, k=k, v=v, n=length: da.decode_attention(q, k, v, n),
                      lambda q=q, k=k, v=v, n=lengths, sc=D ** -0.5:
                      da.decode_attention_plain(q, k, v, n, sc),
                      q, k, v, lengths, D ** -0.5, dtype))
    # paged: (H, KV, D, dtype, pt, T, lengths); 12-token pages end inside chunks
    for H, KV, D, dtype, pt, T, lens in (
            (32, 4, 64, torch.bfloat16, 16, 32, [0, 1, 63, 64, 65, 128, 129, 512, 600]),
            (12, 4, 128, torch.float32, 12, 20, [0, 5, 64, 65, 240, 300])):
        q, kp, vp, table = paged_arena(torch, g, lens, len(lens), H, KV, D, pt, T, dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        cases.append((f"paged H={H} KV={KV} D={D} pt={pt} T={T} {str(dtype)[6:]} lengths={lens}",
                      lambda q=q, kp=kp, vp=vp, t=table, n=lengths:
                      pa.paged_decode_attention(q, kp, vp, t, n),
                      lambda q=q, kp=kp, vp=vp, t=table, n=lengths, sc=D ** -0.5:
                      pa.paged_decode_attention_plain(q, kp, vp, t, n, sc),
                      q, pa.gather_kv_pages(kp, table), pa.gather_kv_pages(vp, table),
                      lengths.clamp(max=T * pt), D ** -0.5, dtype))
    return cases


def run_decode_split_checks(torch):
    """Each :func:`decode_split_cases` case held against its plain version
    (bf16: :func:`attention_errors`'s per-element limit and fp64 anchor;
    fp32: 1e-4 of the output's scale), its L = 0 rows exactly zero, and a
    second call equal bit for bit (fixed merge order, no atomics). One
    ``kernels_decode_split`` line per case; returns the lines and whether
    all passed."""
    rows = []
    for name, kernel, plain, q, k, v, lengths, scale, dtype in decode_split_cases(torch):
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        zero_rows = bool((got[lengths == 0] == 0).all())
        finite = bool(torch.isfinite(got).all())
        if dtype == torch.bfloat16:
            err, ratio, witness = attention_errors(torch, got, ref, q, k, v, lengths, scale)
            limit = "1 bf16 ulp + 1e-5 x sum_i p_i |v_i| / l per element; fp64 anchor"
        else:
            err = float((got - ref).abs().max())
            ratio = err / (1e-4 * max(1.0, float(ref.abs().max())))
            witness, limit = {}, "1e-4 x max(1, |out|) (fp32 sums in another order)"
        row = dict(phase="kernels_decode_split", case=name, max_err=err, err_over_limit=ratio,
                   limit=limit, repeats_bitwise=bool(torch.equal(got, again)),
                   zero_rows_ok=zero_rows, finite=finite, **witness)
        row["ok"] = (ratio <= 1.0 and row["repeats_bitwise"] and zero_rows and finite
                     and witness.get("fp64_anchor_ok", True))
        emit(row)
        rows.append(row)
    return rows, all(r["ok"] for r in rows)


def flash_bwd_cases(torch):
    """The flash cases (dtype, B, S, Sk, H, D, causal) of
    :func:`run_bwd_kernels`: the 125M train shape first (its rows are the
    kernels line's), the gpt2-1.5b train shape (B·H = 50), then bf16 at the
    tensor-core kernels' other tiles (D=128 and 256, S off the 64- and
    128-row tiles, a non-causal Sk != S) and fp32 (the CUDA-core kernels) at
    the same kinds of shapes."""
    bf, f32 = torch.bfloat16, torch.float32
    return [(bf, 24, 1024, 1024, 12, 64, True), (bf, 2, 1024, 1024, 25, 64, True),
            (bf, 2, 512, 512, 8, 128, True), (bf, 2, 512, 512, 4, 256, True),
            (bf, 2, 200, 200, 12, 64, True), (bf, 2, 1000, 1000, 12, 64, True),
            (bf, 1, 1000, 1000, 4, 256, True), (bf, 2, 384, 640, 12, 64, False),
            (bf, 2, 384, 640, 4, 128, False), (f32, 2, 512, 512, 8, 128, True),
            (f32, 2, 512, 512, 4, 256, True), (f32, 2, 200, 200, 12, 64, True),
            (f32, 2, 384, 640, 12, 64, False)]


def flash_case_held(torch, fa, q, k, v, do, causal: bool, sc: float,
                    modes=("merged", "split")):
    """One flash case held on the card: the forward kernel's (o, lse)
    against ``flash_attention_plain``, then each backward mode's (dq, dk,
    dv) against ``flash_attention_bwd_plain`` from that (o, lse). bf16 by
    :func:`flash_check` at the fp64 values of :func:`flash_fp64`; fp32
    within 1e-4 relative to each output's scale (the merged dq adds with
    atomics in no fixed order); lse within 1e-4 relative. The bf16 split
    pair keeps p and ds fp32-grade (hi + lo), so its outputs must also lie
    within the limit without the 2^-8 term (``err_over_fp32_limit`` <= 1)
    and repeat bit for bit on a second call. Each call's kernels are
    counted where the C libraries launch them: bf16 must run the
    tensor-core kernels of its mode (forward; merged, or the split dq and
    dkv kernels), fp32 the CUDA-core ones, and nothing else. Returns (o,
    lse, the forward's row, {mode: row}, the plain backward as a
    closure)."""
    fp32 = q.dtype == torch.float32
    B, S, H, _ = q.shape

    def held(got, ref, exact):
        if exact is not None:
            return flash_check(torch, got, ref, *exact)
        err, tol = float((got - ref).abs().max()), 1e-4 * max(1.0, float(ref.abs().max()))
        return dict(max_err=err, tol=tol, ok=err <= tol and bool(torch.isfinite(got).all()))

    before = fa.kernel_launches()
    o, lse = fa.flash_attention_fwd_op(q, k, v, causal, sc)
    launched = flash_launched(fa, before)
    ro, rlse = fa.flash_attention_plain(q, k, v, causal, sc)
    torch.cuda.synchronize()
    fwd = held(o, ro, None if fp32 else flash_fp64(torch, q, k, v, causal, sc)[0])
    fwd.update(lse_max_err=float((lse - rlse).abs().max()),
               lse_tol=1e-4 * max(1.0, float(rlse.abs().max())), launched=launched)
    kern = FLASH_CUDA_CORE if fp32 else FLASH_SM90
    want = {n: int(n == kern["fwd"]) for n in launched}
    fwd["ok"] = (fwd["ok"] and fwd["lse_max_err"] <= fwd["lse_tol"] and launched == want
                 and bool(torch.isfinite(lse).all()))
    del ro, rlse

    def plain():
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(B * H, 1, S)
        return fa.flash_attention_bwd_plain(q, k, v, o, lse, do, delta, causal, sc)

    ref = plain()
    exact = None if fp32 else flash_fp64(torch, q, k, v, causal, sc, o, lse, do)
    rows = {}
    for mode in modes:
        before = fa.kernel_launches()
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, sc, mode=mode)
        launched = flash_launched(fa, before)
        torch.cuda.synchronize()
        checks = [held(x, r, None if fp32 else exact[i]) for i, (x, r) in enumerate(zip(got, ref))]
        ran = (kern["bwd"],) if mode == "merged" else (kern["dq"], kern["dkv"])
        row = {key + "_dq_dk_dv": [c[key] for c in checks] for key in checks[0] if key != "ok"}
        row.update(launched=launched, ok=all(c["ok"] for c in checks)
                   and launched == {n: int(n in ran) for n in launched})
        if mode == "split" and not fp32:
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, sc, mode=mode)
            row["repeats_bitwise"] = all(torch.equal(x, y) for x, y in zip(got, again))
            row["fp32_limit_ok"] = all(c["err_over_fp32_limit"] <= 1.0 for c in checks)
            row["ok"] = row["ok"] and row["repeats_bitwise"] and row["fp32_limit_ok"]
            del again
        rows[mode] = row
        del got
    del ref, exact
    return o, lse, fwd, rows, plain


def run_bwd_kernels(torch, F, peaks):
    """The flash kernels at :func:`flash_bwd_cases`, held by
    :func:`flash_case_held`: bf16 (the tensor-core forward and merged
    backward, and the split dq/dkv pair) at the train shapes, at D=128 and
    256, S=200 and 1000 and a non-causal S=384, Sk=640; fp32 (the CUDA-core
    kernels) at D=128, D=256, a ragged S and a non-causal Sk != S. At the
    bf16 cases the forward is timed too. Each backward kernel's time is its
    own device time (the merged backward's prep and cast passes are
    printed beside it as ``wrapper_ms``, the whole call); its bound counts
    what its function must move: q, k, v, do, lse and delta read, its
    gradients written in the inputs' dtype. The merged design's zeroed fp32
    dq buffer, read and written, is its own cost, printed beside the bound
    as ``dq_scratch_ms``. The plain version and the library call (SDPA's
    forward + backward through ``torch.autograd.grad`` minus its forward)
    compute all three gradients. Returns ``{kernel name: row}`` of the 125M
    train-shape case (the forward's under ``flash_attention_fwd``) and ok."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    main_rows, ok = {}, True
    for ci, (dt, B, S, Sk, H, D, causal) in enumerate(flash_bwd_cases(torch)):
        main = ci == 0

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dt)
        q, k, v, do = rnd(B, S, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D), rnd(B, S, H, D)
        sc = D ** -0.5
        fp32 = dt == torch.float32
        item = q.element_size()
        nq, nk, rows = B * S * H * D, B * Sk * H * D, B * H * S
        pairs = B * H * (sum(min(i + 1, Sk) for i in range(S)) if causal else S * Sk)
        shape = f"B={B} S={S} Sk={Sk} H={H} D={D} causal={causal} {str(dt)[6:]}"
        o, lse, fwd, held, plain = flash_case_held(torch, fa, q, k, v, do, causal, sc)
        ok &= fwd["ok"]
        fwd = dict(phase="kernels_fwd_at_bwd_shape", shape=shape, **fwd)
        if not fp32:
            fwd["limit"] = FLASH_LIMIT
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def lib_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def lib_fwd_bwd():
            return torch.autograd.grad(lib_fwd(), (qt, kt, vt), dot)

        iters = 5 if S * B >= 8192 else 10
        plain_ms, _ = device_ms_by_name(torch, plain, 3)
        lib_fb, lib_f = (device_ms_by_name(torch, fn, iters)[0] for fn in (lib_fwd_bwd, lib_fwd))
        lib_ms = lib_fb - lib_f if lib_fb and lib_f else None
        if not fp32:
            # a train path's forward: its own time, plain and bound here
            f_bound, f_by = bound_ms(item * (2 * nq + 2 * nk) + 4 * rows, 4 * D * pairs, peaks)
            fwd.update(ms=device_ms(torch, lambda: fa.flash_attention_fwd_op(q, k, v, causal, sc),
                                    iters),
                       plain_ms=device_ms(torch, lambda: fa.flash_attention_plain(
                           q, k, v, causal, sc), 3),
                       library_ms=lib_f, library="SDPA forward", bound_ms=f_bound, bound_by=f_by)
        if main:
            main_rows["flash_attention_fwd"] = dict(
                {k_: fwd[k_] for k_ in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")}, max_abs_err=fwd["max_err"])
        emit(fwd)
        reads = item * (2 * nq + 2 * nk) + 2 * 4 * rows     # q, do, k, v, lse, delta
        bounds = {"flash_attention_bwd_merged": bound_ms(reads + item * (nq + 2 * nk),
                                                         5 * 2 * D * pairs, peaks, fp32),
                  "flash_attention_bwd_dq": bound_ms(reads + item * nq, 3 * 2 * D * pairs,
                                                     peaks, fp32),
                  "flash_attention_bwd_dkv": bound_ms(reads + item * 2 * nk,
                                                      4 * 2 * D * pairs, peaks, fp32)}
        for mode in ("merged", "split"):
            def wrapper(m=mode):
                return fa.flash_attention_bwd(q, k, v, o, lse, do, causal, sc, mode=m)

            # the kernels' times by symbol: the tensor-core kernels in bf16,
            # the CUDA-core ones in fp32
            syms = FLASH_CUDA_CORE if fp32 else FLASH_SM90
            names = ({syms["bwd"]: "flash_attention_bwd_merged"} if mode == "merged"
                     else {syms["dq"]: "flash_attention_bwd_dq",
                           syms["dkv"]: "flash_attention_bwd_dkv"})
            # the profiler now and then drops a run's device events: profile
            # again, up to three runs, until every kernel of the mode shows
            for attempts in range(1, 4):
                total, by_name = device_ms_by_name(torch, wrapper, iters)
                if all(any(sub in n for n in by_name) for sub in names):
                    break
            kernels = {}
            for sub, key in names.items():
                hits = [ms for n, ms in by_name.items() if sub in n]
                if hits:
                    b_ms, b_by = bounds[key]
                    kernels[key] = dict(ms=sum(hits), bound_ms=b_ms, bound_by=b_by)
            if "flash_attention_bwd_merged" in kernels:
                # its fp32 dq buffer read and written once: this design's
                # own traffic, beyond the function's bound
                kernels["flash_attention_bwd_merged"]["dq_scratch_ms"] = 2 * 4 * nq / peaks[0] * 1e3
            if mode == "split" and not fp32:
                # the hi + lo design's own products: dq 4 (s, dp, ds_hi k,
                # ds_lo k), dkv 6 (s^T, dp^T, two for dv, two for dk)
                for key, n_products in (("flash_attention_bwd_dq", 4),
                                        ("flash_attention_bwd_dkv", 6)):
                    if key in kernels:
                        kernels[key]["hi_lo_floor_ms"] = (n_products * 2 * D * pairs
                                                          / peaks[1] * 1e3)
            row = held[mode]
            row["ok"] = row["ok"] and len(kernels) == len(names)
            # event time of the same calls: a cross-check of the profiler's
            # sums (equal to device time where the card, not the host, is
            # the limit)
            emit(dict(phase="kernels_bwd", mode=mode, shape=shape, **row,
                      **({} if fp32 else dict(limit=FLASH_LIMIT)), profile_runs=attempts,
                      wrapper_ms=total, wrapper_event_ms=cuda_ms(torch, wrapper, iters),
                      kernels=kernels, plain_ms=plain_ms, library_ms=lib_ms,
                      library_event_ms=cuda_ms(torch, lib_fwd_bwd, iters)
                      - cuda_ms(torch, lib_fwd, iters),
                      library="SDPA forward+backward via torch.autograd.grad minus SDPA forward"))
            ok &= row["ok"]
            if main:
                for key, kern in kernels.items():
                    main_rows[key] = dict(kern, max_abs_err=max(row["max_err_dq_dk_dv"]),
                                          plain_ms=plain_ms, library_ms=lib_ms, shape=shape)
        del q, k, v, do, o, lse, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return main_rows, ok


# ---------------------------------------------------------------------------
# kernels phase: the training kernels of the 1.5B recipe
# ---------------------------------------------------------------------------

ADAM_HYPER = dict(b1=0.9, b2=0.999, eps=1e-8)


def adam8bit_leaf(torch, g, shape, dev="cuda"):
    """A (R, C) leaf with moments in it: fp32 g and p, random int8/uint8
    codes, row scales; on the card."""
    R, C = shape
    return dict(g=torch.randn(shape, generator=g, device=dev) * 1e-3,
                p=torch.randn(shape, generator=g, device=dev) * 0.02,
                mc=torch.randint(-127, 128, shape, generator=g, device=dev).to(torch.int8),
                rc=torch.randint(0, 256, shape, generator=g, device=dev).to(torch.uint8),
                scm=torch.rand((R, 1), generator=g, device=dev) * 1e-4 + 1e-6,
                scr=torch.rand((R, 1), generator=g, device=dev) * 1e-4 + 1e-6)


ADAM_KEYS = ("p", "mc", "rc", "scm", "scr")


def adam8bit_errors(got, ref) -> dict:
    """Kernel outputs against the plain version's: the parameter's largest
    difference, each code's largest difference and share of codes that
    differ, the scales' largest relative difference."""
    p, mc, rc, scm, scr = got
    rp, rmc, rrc, rscm, rscr = ref
    dm = (mc.int() - rmc.int()).abs()
    dr = (rc.int() - rrc.int()).abs()
    return dict(p_max_err=float((p - rp).abs().max()), p_scale=float(rp.abs().max()),
                code_max_diff=int(max(dm.max(), dr.max())),
                code_diff_share=float(((dm > 0).float().mean() + (dr > 0).float().mean()) / 2),
                scale_max_rel_err=float(max(((scm - rscm).abs() / rscm).max(),
                                            ((scr - rscr).abs() / rscr).max())))


def adam8bit_ok(e: dict) -> bool:
    """The kernel and its plain version round at the same points (the _rn
    intrinsics, no FMA contraction): parameters within 1e-6 of their
    scale, codes off by at most one on at most 0.1% (a last-bit difference
    at a round-half tie), scales within 1e-6 relative."""
    return (e["p_max_err"] <= 1e-6 * e["p_scale"] and e["code_max_diff"] <= 1
            and e["code_diff_share"] <= 1e-3 and e["scale_max_rel_err"] <= 1e-6)


# the multi-leaf case: one table over rows of these widths (ragged ones on
# the scalar path, 100000 on the two-pass path), a 0-d leaf beside
ADAM_MULTI = ((40, 1), (33, 3), (17, 17), (64, 1600), (16, 4800), (16, 6400), (3, 100000), ())


def adam8bit_state(torch, g, params, dev="cuda") -> dict:
    """A warm ``Adam8bit.state_dict`` for ``params`` (names "0", "1", ...):
    random codes and row scales, count 2."""
    def sc(p):
        shape = p.shape[:-1] + (1,) if p.dim() else ()
        return torch.rand(shape, generator=g, device=dev) * 1e-4 + 1e-6
    names = [str(i) for i in range(len(params))]
    return {"count": 2,
            "m_codes": {n: torch.randint(-127, 128, p.shape, generator=g, device=dev).to(
                torch.int8) for n, p in zip(names, params)},
            "r_codes": {n: torch.randint(0, 256, p.shape, generator=g, device=dev).to(
                torch.uint8) for n, p in zip(names, params)},
            "scales": {n: {"m": sc(p), "r": sc(p)} for n, p in zip(names, params)}}


def adam8bit_outputs(opt, params) -> list:
    return [*params, *opt.m_codes, *opt.r_codes, *(s[k] for s in opt.scales for k in "mr")]


def run_adam8bit_multi(torch, peaks, dev="cuda"):
    """One fused ``Adam8bit`` step over ``ADAM_MULTI`` (one table, one
    launch; the 0-d leaf on the unfused math), twice from the same state
    (the same bits), each leaf against its plain version: the table leaves
    against ``adam8bit_leaf_plain``, the 0-d leaf against ``Adam8bit(fused=
    False)``, by ``adam8bit_ok``. adamw8bit's wd 0.1, clip 1.0 at a norm of
    1/0.7, lr 1e-4, count 2. Returns (row, ok)."""
    from deepspeed_tpu_torch.ops import adam8bit as a8

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    params = [torch.randn(s, generator=g, device=dev) * 0.02 for s in ADAM_MULTI]
    grads = [torch.randn(s, generator=g, device=dev) * 1e-3 for s in ADAM_MULTI]
    state = adam8bit_state(torch, g, params, dev)
    norm = torch.tensor(1.0 / 0.7, device=dev)
    hyper = dict(weight_decay=0.1, clip=1.0)

    def step(fused=True, leaves=None):
        idx = range(len(params)) if leaves is None else leaves
        ps = [params[i].clone() for i in idx]
        o = a8.Adam8bit(ps, lambda c: 1e-4, 0.9, 0.999, 1e-8, fused=fused, **hyper)
        o.load_state_dict({"count": state["count"], **{
            k: {str(j): state[k][str(i)] for j, i in enumerate(idx)}
            for k in ("m_codes", "r_codes", "scales")}})
        n0 = a8.KERNEL.launches
        o.update(ps, [grads[i].clone() for i in idx], norm)
        return o, ps, a8.KERNEL.launches - n0

    o1, p1, launches = step()
    o2, p2, _ = step()
    if dev == "cuda":
        torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(adam8bit_outputs(o1, p1),
                                                   adam8bit_outputs(o2, p2)))
    gscale = o1._gscale(norm)
    c1, c2 = a8._bias_corrections(0.9, 0.999, state["count"] + 1)
    scalars = torch.stack([gscale, gscale.new_full((), 1e-4), gscale.new_full((), c1),
                           gscale.new_full((), c2)])
    per_leaf, ok = [], repeat
    for i, shape in enumerate(ADAM_MULTI):
        got = [p1[i], o1.m_codes[i], o1.r_codes[i], o1.scales[i]["m"], o1.scales[i]["r"]]
        if a8.fused_leaf_supported(shape):
            st = [state[k][str(i)] for k in ("m_codes", "r_codes")]
            sc = state["scales"][str(i)]
            ref = a8.adam8bit_leaf_plain(a8._rows(grads[i]), a8._rows(params[i]),
                                         a8._rows(st[0]), a8._rows(st[1]), a8._rows(sc["m"]),
                                         a8._rows(sc["r"]), scalars, b1=0.9, b2=0.999, eps=1e-8,
                                         wd=0.1)
            got = [a8._rows(t) for t in got]
        else:   # the unfused math, as the JAX fused apply takes such a leaf
            ou, pu, _ = step(fused=False, leaves=[i])
            ref = [pu[0], ou.m_codes[0], ou.r_codes[0], ou.scales[0]["m"], ou.scales[0]["r"]]
            got, ref = [t.reshape(1, 1) for t in got], [t.reshape(1, 1) for t in ref]
        err = adam8bit_errors(got, ref)
        per_leaf.append(dict(shape=list(shape), table=a8.fused_leaf_supported(shape),
                             ok=adam8bit_ok(err), **err))
        ok &= adam8bit_ok(err)
    ok &= launches == o1.launches_per_step == 1
    n_el = sum(p.numel() for p, s in zip(params, ADAM_MULTI) if s)
    n_rows = sum(p.numel() // p.shape[-1] for p, s in zip(params, ADAM_MULTI) if s)
    b_ms, b_by = bound_ms(16 * n_el + 16 * n_rows, 0, peaks)

    def call():
        o1.update(p1, grads, norm)

    row = dict(phase="kernels_adam8bit", name="adam8bit_update", leaf="multi_leaf_table",
               shapes=[list(s) for s in ADAM_MULTI], launches_per_call=launches,
               launches_per_step=o1.launches_per_step, repeat_same_bits=repeat,
               leaves=per_leaf, kernel_ms=device_ms(torch, call, 10),
               kernel_event_ms=cuda_ms(torch, call, 10), bound_ms=b_ms, bound_by=b_by, ok=ok)
    return row, ok


def run_adam8bit_kernel(torch, peaks):
    """The fused adam8bit update against ``adam8bit_leaf_plain`` at the
    1.5B leaf shapes (c_attn, the MLP's c_proj, wte, a bias, the bias with
    L2 on as well), a 100000-wide row (the two-pass path) and three
    consecutive steps on one leaf (the in-place scale update read back);
    each case's call repeated from the same inputs (the same bits) and its
    launches counted (one a call: a one-leaf table); then the multi-leaf
    table (``run_adam8bit_multi``). adamw8bit's hyper-parameters (wd 0.1),
    clip scale 0.7, lr 1e-4, count 3. Times: the kernel in place (device
    time), the plain version; no PyTorch call computes this update (library
    null). Bound: 16 bytes per element (g, p, codes read; p, codes written)
    and 16 per row (the two scales read and written), by bytes. Returns
    (largest parameter error, the per-leaf rows, ok)."""
    from deepspeed_tpu_torch.ops import adam8bit as a8

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    c1, c2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3
    scalars = torch.tensor([0.7, 1e-4, c1, c2], dtype=torch.float32, device="cuda")
    cases = [("c_attn_kernel", (1600, 4800), 0.1, 0.0),
             ("mlp_c_proj_kernel", (6400, 1600), 0.1, 0.0), ("wte", (50304, 1600), 0.1, 0.0),
             ("c_attn_bias", (1, 4800), 0.1, 0.0), ("c_attn_bias_l2", (1, 4800), 0.1, 0.01),
             ("row_100000", (3, 100000), 0.1, 0.0)]
    ok, max_err, rows = True, 0.0, []
    for name, shape, wd, l2 in cases:
        leaf = adam8bit_leaf(torch, g, shape)
        kw = dict(ADAM_HYPER, wd=wd, l2=l2)
        ref = a8.adam8bit_leaf_plain(leaf["g"], *(leaf[k] for k in ADAM_KEYS), scalars, **kw)
        got = {k: v.clone() for k, v in leaf.items()}
        n0 = a8.KERNEL.launches
        a8.adam8bit_update(got["g"], *(got[k] for k in ADAM_KEYS), scalars, **kw)
        launches = a8.KERNEL.launches - n0
        again = {k: v.clone() for k, v in leaf.items()}
        a8.adam8bit_update(again["g"], *(again[k] for k in ADAM_KEYS), scalars, **kw)
        torch.cuda.synchronize()
        repeat = all(torch.equal(got[k], again[k]) for k in ADAM_KEYS)
        err = adam8bit_errors([got[k] for k in ADAM_KEYS], ref)
        case_ok = adam8bit_ok(err) and bool(torch.isfinite(got["p"]).all()) and repeat \
            and launches == 1
        n, R = shape[0] * shape[1], shape[0]
        b_ms, b_by = bound_ms(16 * n + 16 * R, 0, peaks)

        def kernel(t=got):
            a8.adam8bit_update(t["g"], *(t[k] for k in ADAM_KEYS), scalars, **kw)

        def plain(t=leaf):
            return a8.adam8bit_leaf_plain(t["g"], *(t[k] for k in ADAM_KEYS), scalars, **kw)

        k_dev, p_dev = device_ms(torch, kernel, 20), device_ms(torch, plain, 5)
        row = dict(phase="kernels_adam8bit", name="adam8bit_update", leaf=name,
                   shape=list(shape), plan=a8.leaf_plan(*shape)._asdict(), wd=wd, l2=l2, **err,
                   repeat_same_bits=repeat, launches_per_call=launches, ok=case_ok,
                   kernel_ms=k_dev, plain_ms=p_dev, kernel_event_ms=cuda_ms(torch, kernel, 20),
                   plain_event_ms=cuda_ms(torch, plain, 5), library_ms=None, bound_ms=b_ms,
                   bound_by=b_by)
        emit(row)
        rows.append({k: row[k] for k in ("leaf", "shape", "kernel_ms", "plain_ms", "bound_ms",
                                          "bound_by", "p_max_err")})
        ok &= case_ok
        max_err = max(max_err, err["p_max_err"])
        del leaf, ref, got, again
    # three steps in place against three plain steps fed forward
    leaf = adam8bit_leaf(torch, g, (6400, 1600))
    ker, pl = {k: v.clone() for k, v in leaf.items()}, {k: v.clone() for k, v in leaf.items()}
    steps = []
    for step in range(3):
        sc = torch.tensor([0.7, 1e-4, 1 - 0.9 ** (3 + step), 1 - 0.999 ** (3 + step)],
                          dtype=torch.float32, device="cuda")
        a8.adam8bit_update(ker["g"], *(ker[k] for k in ADAM_KEYS), sc, **ADAM_HYPER, wd=0.1)
        out = a8.adam8bit_leaf_plain(pl["g"], *(pl[k] for k in ADAM_KEYS), sc, **ADAM_HYPER,
                                     wd=0.1)
        pl.update(zip(ADAM_KEYS, out))
        torch.cuda.synchronize()
        steps.append(adam8bit_errors([ker[k] for k in ADAM_KEYS], [pl[k] for k in ADAM_KEYS]))
    steps_ok = all(adam8bit_ok(e) for e in steps)
    emit(dict(phase="kernels_adam8bit", name="adam8bit_update", leaf="three_steps_in_place",
              shape=[6400, 1600], steps=steps, ok=steps_ok))
    del leaf, ker, pl
    multi, multi_ok = run_adam8bit_multi(torch, peaks)
    emit(multi)
    rows.append({k: multi[k] for k in ("leaf", "shapes", "kernel_ms", "bound_ms", "bound_by",
                                        "launches_per_call")})
    torch.cuda.empty_cache()
    return (max(max_err, max(e["p_max_err"] for e in steps),
                max(e["p_max_err"] for e in multi["leaves"])), rows,
            ok and steps_ok and multi_ok)


# the fused CE head's entries: the tensor-core route (bf16, E % 8 == 0) and
# the CUDA-core one (fp32, other E), each counted by its own wrapper
CE_SM90 = ("fused_ce_fwd_sm90", "fused_ce_bwd_sm90")
CE_CUDA_CORE = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")
CE_LINES = {"fused_ce_fwd_sm90": ":37", "fused_ce_bwd_sm90": ":72", "fused_ce_fwd": ":37",
            "fused_ce_dh": ":72", "fused_ce_dw": ":101"}
# (case, dtype, N, E, Vp, vocab, ignored tokens): the 1.5B head (the shifted
# labels' last position of each 1024-token row ignored), gpt2-125m's
# micro-batch, a ragged bf16 shape on the tensor-core route, the same in
# fp32 on the CUDA-core one, and a ragged bf16 shape with E % 8 != 0 (the
# CUDA-core kernels' bf16 builds)
CE_CASES = (("gpt2-1.5b head", "bfloat16", 2048, 1600, 50304, 50257, "row_end"),
            ("gpt2-125m micro-batch", "bfloat16", 24576, 768, 50304, 50257, "row_end"),
            ("ragged", "bfloat16", 300, 200, 1000, 990, "every_7th"),
            ("ragged fp32", "float32", 300, 200, 1000, 990, "every_7th"),
            ("ragged bf16 E%8!=0", "bfloat16", 300, 196, 1000, 990, "every_7th"))
# the tensor-core route's device kernels (profiler names contain these)
CE_DEVICE_KERNELS = ("ce_fwd_sm90_kernel", "ce_dlog_sm90_kernel", "ce_dh_sm90_kernel",
                     "ce_dw_sm90_kernel", "ce_fwd_combine")
CE_BLOCK = 2048   # tokens a block of the plain references: (block, Vp) fp32 temporaries


def ce_operands(torch, g, N, E, Vp, V, dtype, ignored, dev="cuda"):
    h = torch.randn((N, E), generator=g, device=dev).to(dtype)
    w = (torch.randn((Vp, E), generator=g, device=dev) * 0.02).to(dtype)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    if ignored == "every_7th":
        labels[::7] = -100
    else:
        labels[1023::1024] = -100
    return h, w, labels


def ce_reference(torch, ce, h, wteT, labels, V, g: float, delta=1e-4):
    """The plain forward and backward (``fused_ce_plain``, ``fused_ce_bwd_plain``
    scaled by g) in blocks of tokens, and the backward's per-element limits.

    Each product sums ``dlog_c · x`` in fp32 in another order than the
    plain version: 1e-4 of ``Σ|dlog_c|·|x|``, element by element, with
    ``dlog_c`` the plain dlog cast as the kernel casts it. In bf16 a dlog
    element can also round to its neighbour: the kernel's fp32 logit may
    differ from the plain one in its last bits, and an fp32 dlog near a
    rounding midpoint of bf16 then tips. For logit errors up to ``delta``,
    p lies within a factor exp(±delta) of the plain p; each dlog element
    whose two ends round apart may be off by that spread ``A``, which adds
    ``A·|x|`` to the element's limit (in fp32, A = 0). All scaled by g."""
    N, E = h.shape
    Vp = wteT.shape[1]
    dev = h.device
    w = wteT.float().T          # (Vp, E)
    w_abs = w.abs()
    vpos = torch.arange(Vp, device=dev)
    out = dict(nll=torch.empty(N, device=dev), lse=torch.empty(N, device=dev),
               dh=torch.empty((N, E), device=dev), lim_dh=torch.empty((N, E), device=dev),
               dw=torch.zeros((E, Vp), device=dev), lim_dw=torch.zeros((E, Vp), device=dev))
    may_tip = 0
    for i in range(0, N, CE_BLOCK):
        hb, lb = h[i:i + CE_BLOCK], labels[i:i + CE_BLOCK]
        nll_b, lse_b = ce.fused_ce_plain(hb, wteT, lb, V, -100)
        out["nll"][i:i + CE_BLOCK], out["lse"][i:i + CE_BLOCK] = nll_b, lse_b
        t = ce._logits_plain(hb, wteT, V) - lse_b[:, None]
        onehot = (vpos[None, :] == lb[:, None].long()).float()
        valid = (lb != -100).float()[:, None]
        b0 = ((torch.exp(t) - onehot) * valid).to(h.dtype).float()
        m = 1e-4 * b0.abs()
        if h.dtype != torch.float32:
            spread = torch.zeros_like(m)
            for sgn in (-1.0, 1.0):
                dd = ((torch.exp(t + sgn * delta) - onehot) * valid).to(h.dtype).float()
                spread = torch.maximum(spread, (dd - b0).abs())
                del dd
            may_tip += int((spread > 0).sum())
            m += spread
            del spread
        del t, onehot
        hf = hb.float()
        out["dh"][i:i + CE_BLOCK] = b0 @ w
        out["lim_dh"][i:i + CE_BLOCK] = m @ w_abs
        out["dw"] += hf.T @ b0
        out["lim_dw"] += hf.abs().T @ m
        del b0, m, hf
    for k in ("dh", "dw", "lim_dh", "lim_dw"):
        out[k] *= g
    out["info"] = dict(logit_delta=delta, dlog_elements_that_may_round_apart=may_tip,
                       dlog_elements=N * Vp)
    return out


def ce_held(torch, got, ref, lim, cast: bool, mask=None):
    """``got`` against ``ref`` element by element within ``lim``, plus half a
    bf16 ulp of the larger of the two where the kernel casts its output to
    bf16 (``cast``), one fp32 ulp where it scales in fp32."""
    got = got.float()
    err = (got - ref).abs()
    big = torch.maximum(got.abs(), ref.abs())
    lim = lim + (0.5 * bf16_ulp_t(torch, big) if cast else 2.0 ** -23 * big)
    if mask is not None:
        err, lim = err[:, mask], lim[:, mask]
    tiny = torch.finfo(torch.float32).tiny
    i = int(err.argmax())
    return dict(max_err=float(err.max()), tol_at_max_err=float(lim.flatten()[i]),
                err_over_limit=float((err / lim.clamp(min=tiny)).max()),
                ok=bool((err <= lim).all()))


def ce_check(torch, ce, h, w, labels, V, g: float, ref=None):
    """The operands' route (the forward, then the backward on the plain lse,
    each held alone) against ``ce_reference``: nll and lse within 1e-4 of
    max(1, |lse|), dh and dw by ``ce_held``, the limits' power (a dh without
    its softmax term, a dw with its unlabelled vocab rows lost, must each
    miss), finite outputs, a bitwise repeat, the route's launch counter and
    the library's device kernels per call."""
    N, E = h.shape
    Vp = w.shape[0]
    wteT = w.T
    sm90 = ce.sm90_route(h.dtype, E)
    ref = ref or ce_reference(torch, ce, h, wteT, labels, V, g)
    gt = torch.tensor([g], device=h.device)
    counters_ = (ce.FWD_SM90, ce.BWD_SM90) if sm90 else (ce.FWD, ce.DH, ce.DW)
    before, lib_before = [k.launches for k in counters_], ce.kernel_launches()
    nll, lse = ce.fused_ce_fwd(h, wteT, labels, V, -100)
    dh, dw = ce.fused_ce_bwd(h, wteT, labels, ref["lse"], V, -100, gt)
    torch.cuda.synchronize()
    calls = [k.launches - b for k, b in zip(counters_, before)]
    lib = {n: c - lib_before[n] for n, c in ce.kernel_launches().items()}
    chunk, chunks = ce.chunk_plan(N, Vp)
    if sm90:
        want_lib = {"ce_fwd_sm90_kernel": 1, "ce_fwd_combine": 1, "ce_dlog_sm90_kernel": chunks,
                    "ce_dh_sm90_kernel": chunks, "ce_dw_sm90_kernel": chunks}
    else:
        want_lib = {"ce_fwd_kernel": 1, "ce_fwd_combine": 1, "ce_dh_kernel": 1, "ce_dw_kernel": 1}
    nll2, lse2 = ce.fused_ce_fwd(h, wteT, labels, V, -100)
    dh2, dw2 = ce.fused_ce_bwd(h, wteT, labels, ref["lse"], V, -100, gt)
    torch.cuda.synchronize()
    bitwise = all(bool(torch.equal(a, b)) for a, b in ((nll, nll2), (lse, lse2), (dh, dh2),
                                                        (dw, dw2)))
    del nll2, lse2, dh2, dw2
    z_tol = 1e-4 * max(1.0, float(ref["lse"].abs().max()))
    fwd_err = max(float((nll - ref["nll"]).abs().max()), float((lse - ref["lse"]).abs().max()))
    labelled = torch.zeros(Vp, dtype=torch.bool, device=h.device)
    labelled[labels[labels != -100]] = True
    cast = h.dtype != torch.float32
    held_dh = ce_held(torch, dh, ref["dh"], ref["lim_dh"], cast)
    held_dw = dict(ce_held(torch, dw, ref["dw"], ref["lim_dw"], cast),
                   labelled_rows=ce_held(torch, dw, ref["dw"], ref["lim_dw"], cast, labelled),
                   other_rows=ce_held(torch, dw, ref["dw"], ref["lim_dw"], cast, ~labelled))
    # the limits' power: what a backward without the softmax term (dh: only
    # the label column's -W[label]) or with the unlabelled vocab rows lost
    # (dw) would be off by, in units of the limit at the plain value
    valid = (labels != -100)
    dh_label_only = (-(w.float()[labels.clamp(min=0)] * valid[:, None]).to(h.dtype).float()
                     * g)
    power = dict(dh=ce_held(torch, dh_label_only, ref["dh"], ref["lim_dh"], cast)
                 ["err_over_limit"],
                 dw=ce_held(torch, torch.zeros_like(ref["dw"]), ref["dw"], ref["lim_dw"], cast,
                            ~labelled)["err_over_limit"])
    del dh_label_only
    finite = all(bool(torch.isfinite(x.float()).all()) for x in (nll, lse, dh, dw))
    res = dict(route="sm90" if sm90 else "cuda_core", chunk=chunk if sm90 else None,
               chunks=chunks if sm90 else None,
               fwd=dict(max_err=fwd_err, tol=z_tol, ok=fwd_err <= z_tol), dh=held_dh, dw=held_dw,
               limit_power=power, limits=ref["info"], g=g, finite=finite,
               bitwise_repeat=bitwise, entry_calls=calls, library_kernels=lib,
               expected_library_kernels=want_lib)
    res["ok"] = (res["fwd"]["ok"] and held_dh["ok"] and held_dw["ok"] and power["dh"] > 1
                 and power["dw"] > 1 and finite and calls == [1] * len(counters_)
                 and lib == {n: want_lib.get(n, 0) for n in lib}
                 # the CUDA-core dh adds vocab segments with atomics
                 and (bitwise or not sm90))
    return res, ref["lse"]


def ce_mask_probe(torch, ce, dev="cuda"):
    """The padded vocab rows of W (vocab 50257 of Vp 50304) scaled 16x, so
    that a softmax over them moves lse past 100 limits: the tensor-core
    route must hold nll, lse, dh and dw (dw's padded rows exactly 0), and
    the plain forward without the mask must miss by more than 100 limits."""
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    N, E, Vp, V = 512, 1600, 50304, 50257
    h, w, labels = ce_operands(torch, g, N, E, Vp, V, torch.bfloat16, "every_7th", dev)
    w[V:] = (w[:Vp - V].float() * 16).to(torch.bfloat16)
    res, _ = ce_check(torch, ce, h, w, labels, V, 1.0 / N)
    _, lse_unmasked = ce.fused_ce_plain(h, w.T, labels, Vp, -100)
    shift = float((lse_unmasked - ce.fused_ce_plain(h, w.T, labels, V, -100)[1]).abs().max())
    res["unmasked_lse_shift_over_limit"] = shift / res["fwd"]["tol"]
    res["ok"] = res["ok"] and res["unmasked_lse_shift_over_limit"] > 100
    return dict(phase="kernels_fused_ce_mask_probe", shape=f"N={N} E={E} Vp={Vp} vocab={V} "
                "bfloat16, padded rows 16x", **res)


def ce_cancel_probe(torch, ce, dev="cuda"):
    """Logits built from cancelling terms: h = [a, a, c, 0], W = [b, -b, d,
    0] in 64-wide blocks, a and b of magnitude 2-4 (a first block's partial
    of ~±200, cancelled by the second), c and d of ~0.5 (the logit). The
    tensor-core route must hold nll, lse, dh and dw; the control, the plain
    version with its partial sums rounded to bf16 after each 64-wide K step,
    must miss lse and dh."""
    g = torch.Generator(device=dev).manual_seed(SEED + 62)
    N, E, Vp, V = 256, 256, 1024, 1000

    def mag(rows):
        sign = torch.where(torch.rand((rows, 64), generator=g, device=dev) < 0.5, -1.0, 1.0)
        return (2 + 2 * torch.rand((rows, 64), generator=g, device=dev)) * sign

    a, b = mag(N), mag(Vp)
    c = 0.5 * torch.randn((N, 64), generator=g, device=dev)
    d = 0.5 * torch.randn((Vp, 64), generator=g, device=dev)
    h = torch.cat([a, a, c, torch.zeros_like(c)], 1).to(torch.bfloat16)
    w = torch.cat([b, -b, d, torch.zeros_like(d)], 1).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[::7] = -100
    gs = 1.0 / N
    ref = ce_reference(torch, ce, h, w.T, labels, V, gs)
    res, _ = ce_check(torch, ce, h, w, labels, V, gs, ref)
    # the control: partials rounded to bf16 per 64-wide K step
    hf, wf = h.float(), w.float()
    s = torch.zeros((N, Vp), device=dev)
    for k in range(0, E, 64):
        s = (s + hf[:, k:k + 64] @ wf[:, k:k + 64].T).to(torch.bfloat16).float()
    s = torch.where(torch.arange(Vp, device=dev) < V, s, ce.NEG)
    lse_ctl = torch.logsumexp(s, -1)
    onehot = (torch.arange(Vp, device=dev)[None, :] == labels[:, None].long()).float()
    dlog_ctl = ((torch.exp(s - ref["lse"][:, None]) - onehot)
                * (labels != -100).float()[:, None]).to(torch.bfloat16).float()
    dh_ctl = (dlog_ctl @ wf) * gs
    res["control_lse_over_limit"] = float((lse_ctl - ref["lse"]).abs().max()) / res["fwd"]["tol"]
    res["control_dh_over_limit"] = ce_held(torch, dh_ctl, ref["dh"], ref["lim_dh"],
                                           True)["err_over_limit"]
    res["ok"] = (res["ok"] and res["control_lse_over_limit"] > 1
                 and res["control_dh_over_limit"] > 1)
    return dict(phase="kernels_fused_ce_cancel", shape=f"N={N} E={E} Vp={Vp} vocab={V} "
                "bfloat16, partials of ~±200 cancelling", **res)


def ce_case_rows(torch, ce, peaks, case, timed=True):
    """One case of ``CE_CASES``: ``ce_check`` and, with ``timed``, each
    entry's device time beside the plain version's (where its (N, Vp) fp32
    temporaries fit: always at these shapes), the chunked head's
    (``chunked_lm_loss``, one chunk: ``torch.mm`` + logsumexp; its backward
    beside the backward) and the bound: operations, 2·N·E·Vp flops a
    product, the forward one product, the tensor-core backward three
    (``bound_four_products_ms``: the TPU kernels' four), each CUDA-core
    kernel of the backward two (it rebuilds the logits). Rows: the
    tensor-core route's forward and backward (its device kernels by name),
    or the CUDA-core route's forward, dh and dw (one backward call split by
    kernel name)."""
    from deepspeed_tpu_torch.models.common import chunked_lm_loss

    label, dname, N, E, Vp, V, ignored = case
    dt = getattr(torch, dname)
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    h, w, labels = ce_operands(torch, g, N, E, Vp, V, dt, ignored)
    gs = 1.0 / float((labels != -100).sum())    # the mean loss's incoming gradient
    res, lse_p = ce_check(torch, ce, h, w, labels, V, gs)
    shape = f"{label}: N={N} E={E} Vp={Vp} vocab={V} {dname}"
    sm90 = res["route"] == "sm90"
    held = dict(res)
    for k in ("fwd", "dh", "dw"):
        held.pop(k)
    rows = {}
    if sm90:
        rows["fused_ce_fwd_sm90"] = dict(res["fwd"])
        rows["fused_ce_bwd_sm90"] = dict(
            max_err=max(res["dh"]["max_err"], res["dw"]["max_err"]),
            err_over_limit=max(res["dh"]["err_over_limit"], res["dw"]["err_over_limit"]),
            dh=res["dh"], dw=res["dw"])
    else:
        rows = {"fused_ce_fwd": dict(res["fwd"]), "fused_ce_dh": dict(res["dh"]),
                "fused_ce_dw": dict(res["dw"])}
    if timed:
        wteT = w.T
        gt = torch.tensor([gs], device="cuda")
        item, fp32 = h.element_size(), dt == torch.float32
        ins = N * E * item + Vp * E * item + N * 8
        flops = 2.0 * N * E * Vp
        hl = h[None].clone().requires_grad_()
        wl = w.clone().requires_grad_()
        lab2 = labels[None]

        def lib_fwd():
            return chunked_lm_loss(hl, wl, lab2, vocab_size=V, padded_vocab_size=Vp,
                                   chunk=1 << 30, dtype=dt)

        def fwd():
            return ce.fused_ce_fwd(h, wteT, labels, V, -100)

        def bwd():
            return ce.fused_ce_bwd(h, wteT, labels, lse_p, V, -100, gt)

        iters = 3 if N > CE_BLOCK else 5
        lib_f = device_ms(torch, lib_fwd, iters)
        lib_fb = device_ms(torch, lambda: torch.autograd.grad(lib_fwd(), (hl, wl)), iters)
        lib_b = lib_fb - lib_f if lib_fb and lib_f else None
        del hl, wl
        fwd_ms = device_ms(torch, fwd, iters)
        bwd_ms, by_name = device_ms_by_name(torch, bwd, iters)
        plain_f = device_ms(torch, lambda: ce.fused_ce_plain(h, wteT, labels, V, -100), 3)
        plain_b = device_ms(torch, lambda: ce.fused_ce_bwd_plain(h, wteT, labels, lse_p, V,
                                                                 -100), 3)
        torch.cuda.empty_cache()

        def kernel_time(sub):
            return sum(v for k, v in by_name.items() if sub in k) or None

        common = dict(plain="fused_ce_bwd_plain (dh and dw together)",
                      library="chunked_lm_loss backward (dh and dw together)")
        rows[next(iter(rows))].update(
            kernel_ms=fwd_ms, kernel_event_ms=cuda_ms(torch, fwd, iters), plain_ms=plain_f,
            library_ms=lib_f, library="chunked_lm_loss forward")
        b_fwd = bound_ms(ins + 2 * N * 4, flops, peaks, fp32)
        rows[next(iter(rows))].update(bound_ms=b_fwd[0], bound_by=b_fwd[1])
        if sm90:
            b = bound_ms(ins + N * 4 + (N + Vp) * E * item, 3 * flops, peaks)
            rows["fused_ce_bwd_sm90"].update(
                kernel_ms=bwd_ms, kernel_event_ms=cuda_ms(torch, bwd, iters),
                device_kernels_ms={k: kernel_time(k) for k in ("ce_dlog_sm90", "ce_dh_sm90",
                                                               "ce_dw_sm90")},
                other_ms=bwd_ms - sum(kernel_time(k) or 0.0 for k in (
                    "ce_dlog_sm90", "ce_dh_sm90", "ce_dw_sm90")) if bwd_ms else None,
                plain_ms=plain_b, library_ms=lib_b, bound_ms=b[0], bound_by=b[1],
                bound_four_products_ms=4 * flops / peaks[1] * 1e3, **common)
        else:
            for name, kern, out_b in (("fused_ce_dh", "ce_dh_kernel", N * E * 4),
                                      ("fused_ce_dw", "ce_dw_kernel", Vp * E * 4)):
                b = bound_ms(ins + N * 4 + out_b, 2 * flops, peaks, fp32)
                rows[name].update(kernel_ms=kernel_time(kern), bwd_ms=bwd_ms,
                                  bwd_event_ms=cuda_ms(torch, bwd, iters), plain_ms=plain_b,
                                  library_ms=lib_b, bound_ms=b[0], bound_by=b[1], **common)
        del gt
    del lse_p
    out = {}
    for name, row in rows.items():
        row = dict(phase="kernels_fused_ce", name=name, case=label, shape=shape, **row,
                   checks=held)
        row["ok"] = res["ok"] and (not timed or row.get("kernel_ms") is not None)
        out[name] = row
    del h, w, labels
    torch.cuda.empty_cache()
    return out


def run_fused_ce_checks(torch, timed=False, peaks=None):
    """Every case of ``CE_CASES`` and both probes; ``(rows by case and
    name, ok)``. Each row is emitted."""
    from deepspeed_tpu_torch.ops import fused_ce as ce

    by_case, ok = {}, True
    for case in CE_CASES:
        rows = ce_case_rows(torch, ce, peaks, case, timed)
        for row in rows.values():
            emit(row)
            ok &= row["ok"]
        by_case[case[0]] = rows
    for probe in (ce_mask_probe, ce_cancel_probe):
        row = probe(torch, ce)
        emit(row)
        ok &= row["ok"]
        torch.cuda.empty_cache()
    return by_case, ok


def run_fused_ce_kernels(torch, peaks):
    """The fused CE head's two routes against ``fused_ce_plain`` /
    ``fused_ce_bwd_plain`` (``ce_check``), timed, at ``CE_CASES`` (bf16: the
    1.5B head, gpt2-125m's micro-batch and a ragged shape on the tensor-core
    route; fp32 and bf16 with E % 8 != 0: ragged shapes on the CUDA-core
    route), and the mask and cancellation probes. The backward takes the
    plain version's lse, so each kernel is held alone. Returns the kernels
    line's rows: the tensor-core entries at the 1.5B head (the other bf16
    shapes under ``at_shapes``), the CUDA-core ones at the fp32 shape (the
    bf16 build under ``at_shapes``)."""
    by_case, ok = run_fused_ce_checks(torch, timed=True, peaks=peaks)
    keys = ("case", "shape", "max_err", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    rows = {}
    for name in CE_SM90:
        row = dict(by_case["gpt2-1.5b head"][name])
        row["at_shapes"] = [{k: by_case[c][name].get(k) for k in keys}
                            for c in ("gpt2-125m micro-batch", "ragged")]
        rows[name] = row
    for name in CE_CUDA_CORE:
        row = dict(by_case["ragged fp32"][name])
        row["at_shapes"] = [{k: by_case["ragged bf16 E%8!=0"][name].get(k) for k in keys}]
        rows[name] = row
    return rows, ok


GRAD_LEAVES = ("wte", "ln_f.scale")   # the tied head's weight and the last norm's scale


def head_grads(eng, batch) -> tuple:
    """``(loss, {leaf: fp32 gradient})`` of one micro-batch at the engine's
    current weights, for ``GRAD_LEAVES``."""
    loss, grads = eng._grads_of(batch)
    keep = {n: g.float() for n, g in zip(eng._names, grads) if n in GRAD_LEAVES}
    return float(loss), keep


def head_gate(torch, ref, got) -> dict:
    """A fused head's loss and gradients against the chunked head's at the
    same weights: the loss's relative difference and each leaf's cosine."""
    (l0, g0), (l1, g1) = ref, got
    cos = {n: float(torch.nn.functional.cosine_similarity(g1[n].flatten(), g0[n].flatten(),
                                                            dim=0)) for n in GRAD_LEAVES}
    return dict(loss=l1, chunked_loss=l0, loss_rel_diff=abs(l1 / l0 - 1), grad_cosine=cos)


def head_gate_ok(gate) -> bool:
    # bf16 heads sum in fp32 in other orders: the loss within 1e-3 of the
    # chunked head's, each gradient's direction within cosine 0.9999
    return (math.isfinite(gate["loss"]) and gate["loss_rel_diff"] <= 1e-3
            and all(c >= 0.9999 for c in gate["grad_cosine"].values()))


def run_train_loss_pallas(torch, peaks):
    """gpt2-125m at the train phase's flagship config (micro 24 × gas 4, S =
    1024, the same seeded weights and batch) with ``loss_pallas=True``: the
    fused CE head on the tensor-core route. Its loss and the gradients of
    ``GRAD_LEAVES`` on the first micro-batch against the chunked head's at
    the same weights (``head_gate``), then one warm-up and 3 timed steps
    (exact launches: each fused CE entry once per micro-batch, flash as the
    chunked step), one profiled step beside one profiled step of the
    chunked engine (device ms). Then ``train_loss_pallas_fp32``: the fp32
    engine at micro 1 (the CUDA-core route), the same gate and one step's
    exact launches."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

    cfg = gpt2_config("gpt2-125m", n_positions=1024, loss_chunk=1 << 30)
    micro, gas, S, L = 24, 4, 1024, cfg.n_layer
    ids = text_like_ids(np.random.default_rng(SEED + 8), micro * gas, S, cfg.vocab_size)
    batch = {"input_ids": ids, "labels": ids}
    engines = {}
    for name, c in (("chunked", cfg), ("pallas", dataclasses.replace(cfg, loss_pallas=True))):
        eng, *_ = ds.initialize(model=GPT2LMHeadModel(c, device="meta"),
                                config=train_config(micro, gas))
        eng.init_params()   # the same seeded weights for both
        engines[name] = eng
    mb = engines["chunked"]._to_device({"input_ids": ids[:micro], "labels": ids[:micro]})
    gate = head_gate(torch, head_grads(engines["chunked"], mb), head_grads(engines["pallas"], mb))
    del mb
    dev_batch = engines["pallas"]._to_device(batch)

    def profiled(eng):
        eng.train_batch(dev_batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            eng.train_batch(dev_batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        by_name = device_ms_of(prof)
        return wall, sum(by_name.values()), by_name

    eng = engines["pallas"]
    eng.train_batch(dev_batch)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = eng.train_batches(dev_batch, 3, stacked=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    per_step = {"flash_attention_fwd": L * gas, "flash_attention_bwd_merged": L * gas,
                "fused_ce_fwd_sm90": gas, "fused_ce_bwd_sm90": gas}
    expected = {n: 3 * per_step.get(n, 0) for n in launches}
    p_wall, p_dev, p_by = profiled(eng)
    c_wall, c_dev, _ = profiled(engines["chunked"])
    ce_dev = sum(v for k, v in p_by.items() if any(n in k for n in CE_DEVICE_KERNELS))
    top = sorted(p_by.items(), key=lambda kv: -kv[1])[:10]
    losses = [float(x) for x in losses]
    del engines, eng, dev_batch
    torch.cuda.empty_cache()

    # fp32, micro 1: the CUDA-core route
    fp32 = {}
    ids1 = ids[:1]
    for name, c in (("chunked", cfg), ("pallas", dataclasses.replace(cfg, loss_pallas=True))):
        e, *_ = ds.initialize(model=GPT2LMHeadModel(dataclasses.replace(c, dtype=torch.float32),
                                                    device="meta"),
                              config=train_config(1, 1, "fp32"))
        e.init_params()
        fp32[name] = e
    mb1 = fp32["chunked"]._to_device({"input_ids": ids1, "labels": ids1})
    gate32 = head_gate(torch, head_grads(fp32["chunked"], mb1), head_grads(fp32["pallas"], mb1))
    zero_counts()
    loss32 = float(fp32["pallas"].train_batch({"input_ids": ids1, "labels": ids1}))
    torch.cuda.synchronize()
    launches32 = read_counts()
    expected32 = {n: {"flash_attention_fwd": L, "flash_attention_bwd_merged": L,
                      "fused_ce_fwd": 1, "fused_ce_dh": 1, "fused_ce_dw": 1}.get(n, 0)
                  for n in launches32}
    del fp32, mb1
    torch.cuda.empty_cache()

    tokens = 3 * micro * gas * S
    checks = {"losses_finite": all(math.isfinite(x) for x in losses),
              "launch_counts": launches == expected, "head_gate": head_gate_ok(gate),
              "fp32_launch_counts": launches32 == expected32, "fp32_head_gate": head_gate_ok(gate32),
              "fp32_loss_finite": math.isfinite(loss32)}
    emit(dict(phase="train_loss_pallas", model="gpt2-125m", config=train_config(micro, gas),
              dtype="bfloat16", batch=[micro * gas, S], timed_steps=3,
              ms_per_step=wall * 1e3 / 3, tokens_per_s=tokens / wall, losses=losses,
              head_gate=gate, launches=launches, expected_launches=expected,
              profile=dict(step_wall_ms=p_wall, step_device_ms=p_dev or "not measured",
                           fused_ce_device_ms=ce_dev or "not measured",
                           chunked_step_wall_ms=c_wall,
                           chunked_step_device_ms=c_dev or "not measured",
                           device_ms_saved=c_dev - p_dev if c_dev and p_dev else "not measured",
                           top_device_ms={k[:90]: v for k, v in top}),
              fp32=dict(batch=[1, S], head_gate=gate32, loss=loss32, launches=launches32,
                        expected_launches=expected32),
              checks=checks))
    return ({"train_loss_pallas": launches, "train_loss_pallas_fp32": launches32},
            all(checks.values()))


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def counters():
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import decode_layer as dl
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa

    from deepspeed_tpu_torch.ops import adam8bit as a8
    from deepspeed_tpu_torch.ops import fused_ce as ce
    from deepspeed_tpu_torch.ops import fused_mlp as fm
    from deepspeed_tpu_torch.ops import fused_ops as fo
    from deepspeed_tpu_torch.ops import w8_matmul as wm
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ssa

    return {"flash_attention_fwd": fa.KERNEL, "decode_attention": da.KERNEL,
            "norm_qkv": dl.NORM_PROJ, "post_attn": dl.POST_ATTN,
            "paged_attention": pa.KERNEL, "flash_attention_bwd_merged": fa.BWD_MERGED,
            "flash_attention_bwd_dq": fa.BWD_DQ, "flash_attention_bwd_dkv": fa.BWD_DKV,
            "adam8bit_update": a8.KERNEL, "fused_ce_fwd_sm90": ce.FWD_SM90,
            "fused_ce_bwd_sm90": ce.BWD_SM90, "fused_ce_fwd": ce.FWD, "fused_ce_dh": ce.DH,
            "fused_ce_dw": ce.DW, "w8a16_matmul": wm.KERNEL,
            "decode_norm_proj_w8": dl.NORM_PROJ_W8, "decode_post_attn_w8": dl.POST_ATTN_W8,
            "norm_proj_rms": dl.NORM_PROJ_RMS, "post_attn_swiglu": dl.POST_ATTN_SWIGLU,
            "norm_proj_rms_w8": dl.NORM_PROJ_RMS_W8,
            "post_attn_swiglu_w8": dl.POST_ATTN_SWIGLU_W8,
            "post_attn_erf_par": dl.POST_ATTN_ERF_PAR,
            "post_attn_erf_par_w8": dl.POST_ATTN_ERF_PAR_W8,
            "post_attn_erf": dl.POST_ATTN_ERF, "post_attn_erf_w8": dl.POST_ATTN_ERF_W8,
            "post_attn_par": dl.post_attn_handle(parallel_residual=True),
            "post_attn_par_w8": dl.post_attn_handle(parallel_residual=True, quant=True),
            "post_attn_swiglu_par": dl.post_attn_handle(swiglu=True, parallel_residual=True),
            "post_attn_swiglu_par_w8": dl.post_attn_handle(swiglu=True, parallel_residual=True,
                                                           quant=True),
            "fused_mlp_fwd": fm.FWD, "fused_mlp_bwd_dx": fm.DX, "fused_mlp_bwd_dw": fm.DW,
            "fused_mlp_fwd_sm90": fm.FWD_SM90, "fused_mlp_bwd_dx_sm90": fm.DX_SM90,
            "sparse_attention_fwd": ssa.KERNEL, "sparse_attention_fwd_fp32": ssa.KERNEL_FP32,
            "layer_norm_fwd": fo.LN_FWD,
            "layer_norm_bwd": fo.LN_BWD, "bias_gelu_fwd": fo.GELU_FWD,
            "bias_gelu_bwd": fo.GELU_BWD, "softmax_fwd": fo.SOFTMAX_FWD,
            "softmax_bwd": fo.SOFTMAX_BWD}


# serving runs no backward, no optimizer and no loss head
NO_BACKWARD = {"flash_attention_bwd_merged": 0, "flash_attention_bwd_dq": 0,
               "flash_attention_bwd_dkv": 0, "adam8bit_update": 0,
               **{n: 0 for n in CE_SM90 + CE_CUDA_CORE}}


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
    _, fwd_again_ms = timed(lambda: eng(ids))   # the first call at this shape pays set-up
    _, ttft_ms = timed(lambda: eng.generate(prompt, max_new_tokens=1))
    greedy, gen_ms = timed(lambda: eng.generate(prompt, max_new_tokens=new))
    sampled, samp_ms = timed(lambda: eng.generate(prompt, max_new_tokens=new, temperature=0.8,
                                                  top_p=0.9, seed=7))
    launches = read_counts()
    ticks = 2 * (new - 1)   # greedy + sampled; the max_new_tokens=1 run has no tick
    expected = {"flash_attention_fwd": 2 * L, "decode_attention": L * ticks,
                "norm_qkv": L * ticks, "post_attn": L * ticks, "paged_attention": 0,
                **NO_BACKWARD, **NO_W8, **NO_LLAMA, **NO_NEOX, **NO_FUSED_MLP, **NO_BERT_OPS}
    ms_per_tick = (gen_ms - ttft_ms) / (new - 1)
    emit(dict(phase="slice", model="gpt2-125m", dtype="bfloat16", forward_shape=[2, 1024],
              forward_ms=fwd_ms, forward_again_ms=fwd_again_ms,
              generate_shape=[8, 256, new], ttft_ms=ttft_ms,
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
    device busy share, and the decode or paged attention kernels' device
    time per tick (their split and merge kernels, ``ds::decode_split::``)
    and share of the tick's device time."""
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
    by_name = device_ms_of(prof)
    dev_ms, busy_ms = device_sum_and_union_ms(prof)
    attn_ms = sum(v for k, v in by_name.items() if "decode_split::" in k)
    batcher.wait(uids)
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=50))
    # a programmatic dependent launch starts while the kernel before it
    # runs, and a graph's replays leave no gap between them: the busy share
    # is the union of the kernels' intervals over the wall
    return dict(window_ticks=ticks, tick_wall_ms=wall_ms / ticks,
                tick_device_ms=dev_ms / ticks if dev_ms else "not measured",
                tick_device_union_ms=busy_ms / ticks if dev_ms else "not measured",
                tick_device_busy_share=busy_ms / wall_ms if dev_ms else "not measured",
                tick_attention_device_ms=attn_ms / ticks if dev_ms else "not measured",
                tick_attention_share_of_device=attn_ms / dev_ms if dev_ms else "not measured")


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
                    "post_attn": L * singles, "flash_attention_fwd": 0, **NO_BACKWARD,
                    **NO_W8, **NO_LLAMA, **NO_NEOX, **NO_FUSED_MLP, **NO_BERT_OPS}
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


def sampling_check(torch, eng, reqs, outs, per_stream: int = 16, phase="serve_sampling"):
    """The batcher's per-row sampling step on the card against the same step
    on the CPU, over logits the traffic produces: the sampled streams of one
    pass teacher-forced through the card's forward, ``per_stream`` positions
    each. Rows alternate greedy and T=0.8/top-p 0.9 as the traffic does, and
    every fourth row also takes a repetition penalty of 1.3 over its prompt.
    A quarter of the sampled rows draw u = 0 or the largest float32 below 1,
    and no sampled pick may be a token the filters removed.

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
    u = _uniforms(SEED, 1, n)
    # the extreme draws: u = 0 must pick the first token the filters kept,
    # not token 0 (ROADMAP C1), and the largest float32 below 1 the last
    u[k % 8 == 1], u[k % 8 == 5] = 0.0, np.float32(1 - 2 ** -24)
    u = torch.as_tensor(u)

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
    kept = probs.gather(1, card[:, None])[:, 0] > 0
    res = dict(rows=n, greedy_rows=int(greedy.sum()), sampled_rows=int(sampled.sum()),
               greedy_equal=bool((card[greedy] == cpu[greedy]).all()),
               sampled_equal_share=float((card[sampled] == cpu[sampled]).float().mean()),
               sampled_on_cpu_cdf=bool(on_cdf[sampled].all()), cdf_tol=cdf_tol,
               sampled_never_filtered=bool(kept[sampled].all()),
               zero_uniform_rows=int((u[sampled] == 0).sum()),
               picks_below_vocab=bool((card < V).all()))
    res["ok"] = (res["greedy_equal"] and res["sampled_on_cpu_cdf"]
                 and res["sampled_never_filtered"] and res["picks_below_vocab"])
    emit(dict(phase=phase, **res))
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
    for a prefill plus 16 ticks; their difference is 16 ticks (device time
    summed by kernel, and the union of the kernels' intervals, whose share
    of the wall is the busy share)."""
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
        by_name = device_ms_of(prof)
        windows[new] = (wall_ms, *device_sum_and_union_ms(prof), by_name)
        if out_dir:
            with open(os.path.join(out_dir, f"profile_new{new}.txt"), "w") as fh:
                fh.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                                   row_limit=40))
    (w1, d1, u1, _), (w17, d17, u17, names) = windows[1], windows[17]
    measured = d17 > 0
    tick_wall, tick_dev, tick_busy = (w17 - w1) / 16, (d17 - d1) / 16, (u17 - u1) / 16
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    emit(dict(phase="profile", window="generate B=8 prompt=256, new=1 and new=17",
              prefill_wall_ms=w1, prefill_device_ms=d1 if measured else "not measured",
              tick_wall_ms=tick_wall, tick_device_ms=tick_dev if measured else "not measured",
              tick_device_union_ms=tick_busy if measured else "not measured",
              tick_device_busy_share=tick_busy / tick_wall if measured else "not measured",
              top_device_us_new17={k[:90]: v * 1e3 for k, v in top}))


# ---------------------------------------------------------------------------
# int8 weight-only (W8A16) phases: kernels_w8, serve_w8, generate_w8
# ---------------------------------------------------------------------------

W8 = {"enabled": True, "bits": 8}
W8_KERNELS = ("w8a16_matmul", "decode_norm_proj_w8", "decode_post_attn_w8")
NO_W8 = {n: 0 for n in W8_KERNELS}
# the LLaMA branches of the decode-layer kernels (RMSNorm, SwiGLU), bf16 and W8A16
LLAMA_KERNELS = ("norm_proj_rms", "post_attn_swiglu", "norm_proj_rms_w8", "post_attn_swiglu_w8")
NO_LLAMA = {n: 0 for n in LLAMA_KERNELS}
# gpt2-760m's four dense panels (K, N): c_attn, attn c_proj, c_fc, mlp c_proj
PANELS_760M = ((1536, 4608), (1536, 1536), (1536, 6144), (6144, 1536))


def bf16_ulp_t(torch, x):
    """Elementwise spacing of bf16 values at |x|."""
    e = torch.floor(torch.log2(x.abs().float().clamp(min=1e-30)))
    return torch.exp2(e - 7)


def w8_limits(torch, got, ref, mag, bf16_out: bool):
    """Element by element: an fp32 output within 1e-5 of ``mag`` (the sum of
    the magnitudes of its fp32 addends: two orders of summation differ by
    less); a bf16 output within one bf16 ulp of the plain value plus that
    fp32 slack, plus half a bf16 ulp of its row's largest output. The last
    term is for the intermediate bf16 casts (the normalised rows, and h in
    post_attn): an fp32 value that the two orders round apart there moves
    the whole row. Returns the
    largest error, the largest error / limit, and the share of elements
    whose limit exceeds two bf16 ulps of their own value."""
    lim = 1e-5 * mag
    wide = 0.0
    if bf16_out:
        ulp = bf16_ulp_t(torch, ref)
        row = bf16_ulp_t(torch, ref.float().abs().amax(-1, keepdim=True)) / 2
        lim = lim + ulp + row
        wide = float((lim > 2 * ulp).float().mean())
    d = (got.float() - ref.float()).abs()
    return float(d.max()), float((d / lim).max()), wide


def one_ulp_witness(torch, got, ref, mag, *args):
    """The bf16 rows against the plain limit alone (one bf16 ulp + 1e-5 of
    the addends' magnitudes): the kernel against the plain version, and
    each of them against the same arithmetic in fp64 with the same bf16
    casts (normalised rows, h, the output). Where the plain version too
    lies more than that limit from the fp64 value, two correct fp32 orders
    of one sum, rounded at the intermediate casts, part by more than one
    ulp. ``args``: the plain version's operands (5 for norm_proj, 10 for
    post_attn), eps 1e-5."""
    if len(args) == 5:
        exact = decode_fp64(torch, "norm_proj", args, {})
    else:
        exact = decode_fp64(torch, "post_attn", (*args[:6], args[6:]), {})
    lim = bf16_ulp_t(torch, ref) + 1e-5 * mag

    def over(a, b):
        return (a.float() - b.float()).abs() / lim

    return dict(err_over_1ulp_limit=float(over(got, ref).max()),
                share_over_1ulp_limit=float((over(got, ref) > 1).float().mean()),
                kernel_vs_fp64_over_1ulp_limit=float(over(got, exact).max()),
                plain_vs_fp64_over_1ulp_limit=float(over(ref, exact).max()))


def w8_matmul_held(torch, x, c, s) -> dict:
    """The W8A16 matmul on the card against its plain version, the plain
    model of its order of summation (``gemv_tiled_plain``) and the fp64
    value, each within ``w8_limits`` (1e-5 of |x| @ |dequant W| per element);
    a second call bit for bit; the library's own count, one launch of the
    tensor-core GEMV's W8 instantiation a call (``w8_matmul.kernel_launches``)."""
    from deepspeed_tpu_torch.ops import decode_layer as dl
    from deepspeed_tpu_torch.ops import w8 as w8ops
    from deepspeed_tpu_torch.ops import w8_matmul as wm

    before = wm.kernel_launches()
    got = wm.w8a16_matmul_kernel(x, c, s)
    again = wm.w8a16_matmul_kernel(x, c, s)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in wm.kernel_launches().items()}
    ref, tiled = wm.w8a16_matmul_plain(x, c, s), dl.gemv_tiled_plain(x, (c, s))
    exact = x.double() @ (c.double() * s.double().repeat_interleave(c.shape[0] // s.shape[0], 0))
    mag = x.float().abs() @ w8ops.dequantize_weight(c, s).abs()
    err, ratio, _ = w8_limits(torch, got, ref, mag, False)
    _, tiled_ratio, _ = w8_limits(torch, got, tiled, mag, False)
    _, fp64_ratio, _ = w8_limits(torch, got, exact, mag, False)
    return dict(max_err=err, err_over_limit=ratio, tiled_err_over_limit=tiled_ratio,
                fp64_err_over_limit=fp64_ratio,
                fp64_anchor_ok=fp64_ratio <= 1.0 and tiled_ratio <= 1.0,
                bitwise_repeat=bool(torch.equal(got, again)), sm90_launches=ran,
                sm90_ok=ran == {"gemv_sm90_kernel_w8": 2})


def run_w8_matmul_checks(torch) -> bool:
    """The W8A16 matmul untimed (``w8_matmul_held``) on gpt2-760m's panels at
    M = 1, 8, 37, 64 (128-row groups) and 1536->1536 with one group, and
    llama-1b's and pythia-1b's at M = 8, 64: one ``kernels_w8_checks`` line
    each, for ``scripts/w8_planted_faults.py``."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = [(K, N, M, 128) for K, N in PANELS_760M for M in (1, 8, 37, 64)]
    cases += [(1536, 1536, M, 1536) for M in (8, 64)]
    cases += [(K, N, M, 128) for K, N in PANELS_LLAMA_1B + PANELS_PYTHIA_1B for M in (8, 64)]
    ok = True
    for K, N, M, group in cases:
        (c, s), = w8_panels(torch, g, K, N, group, 1)
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        held = w8_matmul_held(torch, x, c, s)
        row = dict(phase="kernels_w8_checks", name="w8a16_matmul",
                   shape=f"M={M} K={K} N={N} g={group}", **held,
                   ok=held["err_over_limit"] <= 1.0 and held["fp64_anchor_ok"]
                   and held["bitwise_repeat"] and held["sm90_ok"])
        emit(row)
        ok &= row["ok"]
    return ok


def w8_panels(torch, g, K, N, group, n_sets):
    """``n_sets`` random W8A16 panels (codes in [-127, 127], scales around
    0.02 / 127) on the card: enough copies that the timed set exceeds L2."""
    out = []
    for _ in range(n_sets):
        codes = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        scale = (0.5 + torch.rand((K // group, N), generator=g, device="cuda")) * (0.02 / 127)
        out.append((codes, scale))
    return out


def run_kernels_w8(torch, peaks):
    """The w8 matmul kernel and the W8 branches of the two decode-layer
    kernels against their plain versions on the card, with their device
    time, the plain version's, the bound in bytes and (w8 matmul) the time
    of the nearest PyTorch pair, dequantize then ``torch.matmul`` (two
    calls: no one PyTorch call takes grouped int8 weights). Then the fp32
    instantiations (serving in fp32: the w8 route casts x to bf16, which
    its plain version does too), checked, not timed."""
    from deepspeed_tpu_torch.ops import decode_layer as dl
    from deepspeed_tpu_torch.ops import w8 as w8ops
    from deepspeed_tpu_torch.ops import w8_matmul as wm

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf = torch.bfloat16
    rows, ok = {}, True

    def timed(kernel, plain, pair, rot, union=False):
        """Device ms (None where the profiler saw no device activity) and,
        under ``*_event``, CUDA-event ms of each callable; with ``union``
        the kernel's is the union of its kernels' intervals (their sum
        under ``kernel_sum``: the decode-layer launches overlap)."""
        out = {}
        for which, fn, n in (("kernel", kernel, 50), ("plain", plain, 5), ("pair", pair, 50)):
            if fn is None:
                out[which] = out[which + "_event"] = None
                continue
            call = lambda fn=fn: fn(*rot.next())  # noqa: E731
            if which == "kernel" and union:
                out["kernel_sum"], out[which] = device_union_ms(torch, call, n)
            else:
                out[which] = device_ms(torch, call, n)
            out[which + "_event"] = cuda_ms(torch, call, n)
        return out

    def times(t):
        return dict(kernel_ms=t["kernel"], kernel_event_ms=t["kernel_event"],
                    plain_ms=t["plain"], plain_event_ms=t["plain_event"],
                    **({"kernel_sum_ms": t["kernel_sum"]} if "kernel_sum" in t else {}))

    # the w8 matmul on the four 760m panels, one single-group panel, and the
    # llama-1b and pythia-1b panels at decode rows and a full 64-row chunk
    cases = [("gpt2-760m", K, N, M, 128) for K, N in PANELS_760M for M in (1, 8, 37, 64)]
    cases.append(("gpt2-760m", 1536, 1536, 8, 1536))
    cases += [(model, K, N, M, 128) for model, panels_of in (("llama-1b", PANELS_LLAMA_1B),
                                                             ("pythia-1b", PANELS_PYTHIA_1B))
              for K, N in panels_of for M in (8, 64)]
    panels = {}
    for model, K, N, M, group in cases:
        key = (K, N, group)
        if key not in panels:
            panels[key] = w8_panels(torch, g, K, N, group, -(-60_000_000 // (K * N)))
        sets = [(torch.randn((M, K), generator=g, device="cuda").to(bf), c, s)
                for c, s in panels[key]]
        held = w8_matmul_held(torch, *sets[0])
        t = timed(wm.w8a16_matmul_kernel, wm.w8a16_matmul_plain,
                  lambda x, c, s: x @ w8ops.dequantize_weight(c, s, bf), Rotation(sets))
        G = K // group
        b_ms, b_by = bound_ms(K * N + G * N * 4 + M * K * 2 + M * N * 4, 2 * M * K * N, peaks)
        res = dict(phase="kernels_w8", name="w8a16_matmul", model=model,
                   shape=f"M={M} K={K} N={N} g={group}", **held,
                   limit="w8_limits: 1e-5 x |x| @ |dequant W| per element, against the plain "
                   "version, its tiled order and the fp64 value",
                   ok=held["err_over_limit"] <= 1.0 and held["fp64_anchor_ok"]
                   and held["bitwise_repeat"] and held["sm90_ok"], **times(t),
                   dequant_matmul_pair_ms=t["pair"], dequant_matmul_pair_event_ms=t["pair_event"],
                   bound_us=b_ms * 1e3, bound_by=b_by)
        emit(res)
        ok &= res["ok"]
        if (K, N, M, group) == (1536, 4608, 8, 128):
            rows["w8a16_matmul"] = res
    del panels

    # the W8 branches of the decode-layer kernels: 760m (the main rows), 125m,
    # and 125m with one scale group per panel
    for E, group, main in ((1536, 128, True), (768, 128, False), (768, None, False)):
        F, M = 4 * E, 8
        n_sets = -(-60_000_000 // (12 * E * E))
        grp = (lambda k: k) if group is None else (lambda k: group)

        def panel(K, N):
            return w8_panels(torch, g, K, N, grp(K), 1)[0]

        def rn(*shape, std=1.0, dtype=bf):
            return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

        np_sets, pa_sets = [], []
        for _ in range(n_sets):
            ns, nb = 1 + rn(E, std=0.1, dtype=torch.float32), rn(E, std=0.1, dtype=torch.float32)
            np_sets.append((rn(M, E), ns, nb, panel(E, 3 * E), rn(3 * E, std=0.02)))
            pa_sets.append((rn(M, E), rn(M, E), panel(E, E), rn(E, std=0.02), ns, nb,
                            panel(E, F), rn(F, std=0.02), panel(F, E), rn(E, std=0.02)))
        label = f"M={M} E={E} F={F} g={group or 'K (one group)'}"
        # norm -> projection
        x, ns, nb, w, b = np_sets[0]
        got, ref = dl.fused_norm_proj(x, ns, nb, w, b), dl.norm_proj_plain(x, ns, nb, w, b, 1e-5)
        torch.cuda.synchronize()
        xn = dl._norm_rows(x.float(), ns, nb, 1e-5).to(bf)
        mag = xn.float().abs() @ w8ops.dequantize_weight(*w).abs() + b.float().abs()
        err, ratio, wide = w8_limits(torch, got, ref, mag, True)
        held = decode_sm90_held(torch, lambda: dl.fused_norm_proj(x, ns, nb, w, b), got, 1, True)
        t = timed(lambda x, ns, nb, w, b: dl.fused_norm_proj(x, ns, nb, w, b),
                  lambda *a: dl.norm_proj_plain(*a, 1e-5), None, Rotation(np_sets), union=True)
        G = E // grp(E)
        b_ms, b_by = bound_ms(3 * E * E + G * 3 * E * 4 + M * E * 2 + M * 3 * E * 2 + 3 * E * 2
                              + 2 * E * 4, 2 * M * E * 3 * E, peaks)
        res = dict(phase="kernels_w8", name="decode_norm_proj_w8", shape=f"{label} N={3 * E}",
                   max_err=err, err_over_limit=ratio,
                   limit="per element: 1 bf16 ulp of the plain value + 1e-5 x |xn| @ |W| "
                   "+ half a bf16 ulp of the row's largest output",
                   limit_over_2ulp_share=wide, **held,
                   ok=ratio <= 1.0 and held["bitwise_repeat"] and held["sm90_ok"], **times(t),
                   **one_ulp_witness(torch, got, ref, mag, x, ns, nb, w, b),
                   bound_us=b_ms * 1e3, bound_by=b_by)
        emit(res)
        ok &= res["ok"]
        if main:
            rows["decode_norm_proj_w8"] = res
        # o-proj -> LN -> MLP -> residual
        args = pa_sets[0]
        y, x, wo, bo, ns, nb, w1, b1, w2, b2 = args
        got = dl.fused_post_attn(y, x, wo, bo, ns, nb, (w1, b1, w2, b2))
        ref = dl.post_attn_plain(*args[:6], args[6:], 1e-5)
        torch.cuda.synchronize()
        r1 = (x.float() + dl._dot(y, wo)) + bo.float()
        hin = dl._norm_rows(r1, ns, nb, 1e-5).to(bf)
        h = dl.gelu_tanh(dl._dot(hin, w1) + b1.float()).to(bf)
        mag = (x.float().abs() + y.float().abs() @ w8ops.dequantize_weight(*wo).abs()
               + bo.float().abs() + h.float().abs() @ w8ops.dequantize_weight(*w2).abs()
               + b2.float().abs())
        err, ratio, wide = w8_limits(torch, got, ref, mag, True)
        held = decode_sm90_held(torch, lambda: dl.fused_post_attn(
            y, x, wo, bo, ns, nb, (w1, b1, w2, b2)), got, 3, True)
        t = timed(lambda y, x, wo, bo, ns, nb, w1, b1, w2, b2: dl.fused_post_attn(
            y, x, wo, bo, ns, nb, (w1, b1, w2, b2)),
            lambda *a: dl.post_attn_plain(*a[:6], a[6:], 1e-5),
            None, Rotation(pa_sets), union=True)
        Ge, Gf = E // grp(E), F // grp(F)
        nbytes = (E * E + 2 * E * F + (Ge * E + Ge * F + Gf * E) * 4 + 3 * M * E * 2
                  + (2 * E + F) * 2 + 2 * E * 4)
        b_ms, b_by = bound_ms(nbytes, 2 * M * (E * E + 2 * E * F), peaks)
        res = dict(phase="kernels_w8", name="decode_post_attn_w8", shape=label, max_err=err,
                   err_over_limit=ratio,
                   limit="per element: 1 bf16 ulp of the plain value + 1e-5 x the fp32 "
                   "addends' magnitudes + half a bf16 ulp of the row's largest output",
                   limit_over_2ulp_share=wide, **held,
                   ok=ratio <= 1.0 and held["bitwise_repeat"] and held["sm90_ok"], **times(t),
                   **one_ulp_witness(torch, got, ref, mag, *args),
                   bound_us=b_ms * 1e3, bound_by=b_by)
        emit(res)
        ok &= res["ok"]
        if main:
            rows["decode_post_attn_w8"] = res
        del np_sets, pa_sets

    # fp32 activations (fp32 serving): checked against the plain versions
    # element by element, with 128-row groups and with one group per panel
    # (the down projection's group then spans three 1024-row chunks)
    def rn32(*shape, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std

    x = rn32(8, 1536)
    c, s = w8_panels(torch, g, 1536, 4608, 128, 1)[0]
    got, ref = w8ops.w8a16_matmul(x, c, s), wm.w8a16_matmul_plain(x, c, s)
    mag = x.to(bf).float().abs() @ w8ops.dequantize_weight(c, s).abs()
    err, ratio, _ = w8_limits(torch, got, ref, mag, False)
    fp32 = [dict(name="w8a16_matmul", shape="M=8 K=1536 N=4608 fp32 x (cast to bf16)",
                 max_err=err, err_over_limit=ratio, ok=got.dtype == torch.float32 and ratio <= 1)]
    E, F, M = 768, 3072, 5
    for group in (128, None):
        ws = {k: w8_panels(torch, g, K, N, group or K, 1)[0]
              for k, (K, N) in (("w", (E, 3 * E)), ("wo", (E, E)), ("w1", (E, F)),
                                ("w2", (F, E)))}
        x, y, ns, nb = rn32(M, E), rn32(M, E), 1 + rn32(E, std=0.1), rn32(E, std=0.1)
        b, bo = rn32(3 * E, std=0.02), rn32(E, std=0.02)
        b1, b2 = rn32(F, std=0.02), rn32(E, std=0.02)
        shape = f"M={M} E={E} F={F} g={group or 'K (one group)'} fp32"
        got = dl.fused_norm_proj(x, ns, nb, ws["w"], b)
        ref = dl.norm_proj_plain(x, ns, nb, ws["w"], b, 1e-5)
        mag = (dl._norm_rows(x, ns, nb, 1e-5).abs() @ w8ops.dequantize_weight(*ws["w"]).abs()
               + b.abs())
        err, ratio, _ = w8_limits(torch, got, ref, mag, False)
        fp32.append(dict(name="decode_norm_proj_w8", shape=shape, max_err=err,
                         err_over_limit=ratio, ok=ratio <= 1.0))
        got = dl.fused_post_attn(y, x, ws["wo"], bo, ns, nb, (ws["w1"], b1, ws["w2"], b2))
        ref = dl.post_attn_plain(y, x, ws["wo"], bo, ns, nb, (ws["w1"], b1, ws["w2"], b2), 1e-5)
        r1 = (x + dl._dot(y, ws["wo"])) + bo
        h = dl.gelu_tanh(dl._dot(dl._norm_rows(r1, ns, nb, 1e-5), ws["w1"]) + b1)
        mag = (x.abs() + y.abs() @ w8ops.dequantize_weight(*ws["wo"]).abs() + bo.abs()
               + h.abs() @ w8ops.dequantize_weight(*ws["w2"]).abs() + b2.abs())
        err, ratio, _ = w8_limits(torch, got, ref, mag, False)
        fp32.append(dict(name="decode_post_attn_w8", shape=shape, max_err=err,
                         err_over_limit=ratio, ok=ratio <= 1.0))
    for r in fp32:
        emit(dict(phase="kernels_w8_fp32", limit="1e-5 x the fp32 addends' magnitudes "
                  "per element", **r))
        ok &= r["ok"]
    return rows, ok


def chunk_launches(chunks, dense_layers: int) -> int:
    """w8 matmul launches a batcher's prefill chunks imply: every dense layer
    of the stack (4 per GPT-2 block, 7 per LLaMA block) for each chunk of
    2..64 rows x tokens (one-token chunks take the fused tick, chunks past
    64 the dequantized panel)."""
    return sum(dense_layers * n for (B, S), n in chunks.items() if S > 1 and B * S <= 64)


def dense_weight_bytes(module) -> int:
    return sum(p.numel() * p.element_size() for n, p in module.named_parameters()
               if "_kernel" in n)


def run_serve_w8(torch, out_dir=None):
    """gpt2-760m (full width and depth, random weights from seed 1234) served
    in int8 (``quant={"enabled": True, "bits": 8}``) and in bf16 from the
    same weights, through ``ContinuousBatcher`` with page-resident KV (and
    the int8 engine with contiguous slots too), the serve phase's 32
    requests twice each; then the int8 engine's gates against a CPU fp32
    engine holding the same codes, and ``generate`` (B=8, prompt 256, 64
    new) with the fused decode kernels on and off."""
    from collections import Counter

    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
    from deepspeed_tpu_torch.ops import w8 as w8ops

    cfg = gpt2_config("gpt2-760m")
    L, E, V = cfg.n_layer, cfg.n_embd, cfg.vocab_size
    model = GPT2LMHeadModel(cfg).init_weights(torch.Generator().manual_seed(SEED))
    engines, resident, checks = {}, {}, {}
    for label, kw in (("w8", dict(quant=W8)), ("bf16", {})):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        engines[label] = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512, **kw)
        torch.cuda.synchronize()
        resident[label] = torch.cuda.memory_allocated() - m0
    eng, eng16 = engines["w8"], engines["bf16"]

    # weight bytes: the int8 engine's dense leaves against the bf16 engine's
    dense8, dense16 = dense_weight_bytes(eng.module), dense_weight_bytes(eng16.module)
    g = cfg.w8_group
    per_layer = 12 * E * E + 4 * (E // g * 3 * E + E // g * E + E // g * 4 * E + 4 * E // g * E)
    layer0 = sum(p.numel() * p.element_size() for n, p in eng.module.h[0].named_parameters()
                 if "_kernel" in n)
    checks["weight_bytes"] = (layer0 == per_layer and dense8 == L * per_layer
                              and dense16 == L * 12 * E * E * eng16.module.wte.element_size()
                              and not any(n.endswith("_kernel") for n, _ in
                                          eng.module.named_parameters()))
    # codes quantized on the card against the CPU's, layer 0
    sd = model.state_dict()
    same = []
    for mod, name in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"), ("mlp", "c_proj")):
        c, s = w8ops.quantize_weight(sd[f"h.0.{mod}.{name}_kernel"], g)
        p = dict(eng.module.named_parameters())
        same.append(torch.equal(p[f"h.0.{mod}.{name}_kernel_q"].cpu(), c)
                    and torch.equal(p[f"h.0.{mod}.{name}_kernel_s"].cpu(), s))
    checks["codes_card_equal_cpu"] = all(same)
    emit(dict(phase="serve_w8_weights", model="gpt2-760m", dense_weight_bytes_w8=dense8,
              dense_weight_bytes_bf16=dense16, dense_ratio=dense8 / dense16,
              layer0_w8_bytes=layer0, layer0_expected=per_layer,
              resident_bytes=resident, resident_ratio=resident["w8"] / resident["bf16"],
              codes_card_equal_cpu=same))

    reqs = serve_requests(V)
    by_path, greedy = {}, None
    runs = (("serve_w8_paged", eng, {"page_tokens": 16, "n_pages": 512}),
            ("serve_w8_contiguous", eng, None),
            ("serve_bf16_760m", eng16, {"page_tokens": 16, "n_pages": 512}))
    for path, e, pc in runs:
        batcher = ds.ContinuousBatcher(e, n_slots=8, prefix_cache=pc, seed=SEED)
        zero_counts()
        chunks0 = Counter(batcher.prefill_chunks)
        outs, passes = [], []
        for _ in range(2):
            o, nums = serve_pass(torch, batcher, reqs)
            outs.append(o)
            passes.append(nums)
        launches = read_counts()
        by_path[path] = launches
        chunks = batcher.prefill_chunks - chunks0
        singles = sum(p["ticks"] + p["one_token_prefills"] for p in passes)
        attn = "paged_attention" if pc else "decode_attention"
        other = "decode_attention" if pc else "paged_attention"
        q = e is eng
        expected = {attn: L * singles, other: 0, "flash_attention_fwd": 0, **NO_BACKWARD,
                    **NO_LLAMA, **NO_NEOX, **NO_FUSED_MLP, **NO_BERT_OPS,
                    "norm_qkv": 0 if q else L * singles,
                    "post_attn": 0 if q else L * singles,
                    "decode_norm_proj_w8": L * singles if q else 0,
                    "decode_post_attn_w8": L * singles if q else 0,
                    "w8a16_matmul": chunk_launches(chunks, 4 * L) if q else 0}
        prof = serve_profile(torch, batcher, reqs,
                             out_dir and os.path.join(out_dir, f"profile_{path}.txt"))
        run_checks = {
            "launch_counts": launches == expected,
            "no_leaks": all(v == 0 for p in passes for v in p["leaks"].values())
            and all(v == 0 for v in batcher.leak_counts().values()),
            "shapes_and_vocab": all(len(o) == len(r["prompt"]) + r["max_new_tokens"]
                                    and int(o.max()) < V for op in outs for o, r in zip(op, reqs))}
        if path == "serve_w8_paged":   # suffix chunks after prefix hits
            run_checks["w8_matmul_launched"] = launches["w8a16_matmul"] > 0
        emit(dict(phase="serve_w8", path=path, model="gpt2-760m", dtype="bfloat16",
                  quant="int8 W8A16" if q else None, n_slots=8, requests=len(reqs),
                  prefix_cache=pc, passes=passes, profile=prof,
                  resident_weight_bytes=resident["w8" if q else "bf16"],
                  prefill_chunks={f"{B}x{S}": n for (B, S), n in sorted(chunks.items())},
                  launches=launches, expected_launches=expected, checks=run_checks))
        checks.update({f"{path}_{k}": v for k, v in run_checks.items()})
        if path == "serve_w8_paged":
            greedy = [outs[0][i] for i in range(0, 16, 2)]      # 8 greedy streams
        del batcher

    # the int8 engine against a CPU fp32 engine holding the same codes
    with torch.device("meta"):
        template = GPT2LMHeadModel(cfg)
    state = {k: v.detach().cpu() for k, v in eng.module.state_dict().items()}
    cpu = ds.init_inference(template, params=state, dtype=torch.float32, max_tokens=512,
                            quant=W8, device="cpu")
    del state
    ids = torch.randint(0, V, (1, 256), generator=torch.Generator().manual_seed(SEED + 6))
    card = eng(ids)[..., :V].float()
    ref = cpu(ids)[..., :V].float()
    c = card.cpu()
    fwd_err = float((c - ref).abs().max())
    fwd_tol = 8 * bf16_ulp(float(ref.abs().max()))
    delta = 2 * bf16_ulp(float(ref.abs().max()))
    checks["forward_vs_cpu_fp32"] = fwd_err <= fwd_tol and bool(torch.isfinite(c).all())
    l16 = eng16(ids)[..., :V].float()
    rel_rms = float((card - l16).pow(2).mean().sqrt() / l16.pow(2).mean().sqrt())
    checks["int8_vs_bf16_rel_rms"] = rel_rms <= 0.1
    # 8 greedy streams teacher-forced through the CPU engine (right-padded
    # into one batch: causal attention, the padding follows every scored token)
    n0 = [len(reqs[i]["prompt"]) for i in range(0, 16, 2)]
    T = max(len(s) for s in greedy) - 1
    batch = torch.zeros((len(greedy), T), dtype=torch.long)
    for r, s in enumerate(greedy):
        batch[r, :len(s) - 1] = torch.as_tensor(s[:-1])
    lg = cpu(batch)[..., :V].float()
    strict, ties = [], []
    for r, s in enumerate(greedy):
        pick = torch.as_tensor(s[n0[r]:], dtype=torch.long)
        rl = lg[r, n0[r] - 1:len(s) - 1]
        strict.append(float((rl.argmax(-1) == pick).float().mean()))
        ties.append(near_max_share(pick, rl, delta))
    tf_strict, tf_ties = float(np.mean(strict)), float(np.mean(ties))
    checks["greedy_teacher_forced_vs_cpu"] = tf_ties >= 0.99 and tf_strict >= 0.95
    del cpu, lg
    emit(dict(phase="serve_w8_checks", forward_shape=[1, 256], forward_max_err=fwd_err,
              forward_tol=fwd_tol, tie_delta=delta, int8_vs_bf16_logits_rel_rms=rel_rms,
              teacher_forced_top1=tf_strict, teacher_forced_within_delta=tf_ties,
              streams=len(greedy), checks=checks))

    # generate with the fused decode kernels on (the W8 branches) and off
    # (the w8 matmul carries the ticks): an engine over the same codes
    state = {k: v.detach() for k, v in eng.module.state_dict().items()}
    unfused = ds.init_inference(template, params=state, dtype=torch.bfloat16, max_tokens=512,
                                quant=W8, decode_fused=False)
    del state
    prompt = torch.randint(0, V, (8, 256), generator=torch.Generator().manual_seed(SEED + 7))
    new, gen = 64, {}
    for path, e in (("generate_w8_fused", eng), ("generate_w8_unfused", unfused)):
        e.generate(prompt[:, :32], max_new_tokens=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.generate(prompt, max_new_tokens=1)
        torch.cuda.synchronize()
        ttft = (time.perf_counter() - t0) * 1e3
        zero_counts()
        t0 = time.perf_counter()
        out = e.generate(prompt, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        by_path[path] = launches
        ticks = new - 1
        fused = path.endswith("_fused")
        expected = {n: 0 for n in launches}
        expected.update(decode_attention=L * ticks,
                        decode_norm_proj_w8=L * ticks if fused else 0,
                        decode_post_attn_w8=L * ticks if fused else 0,
                        w8a16_matmul=0 if fused else 4 * L * ticks)
        gen[path] = out
        ok_path = launches == expected and tuple(out.shape) == (8, 256 + new)
        checks[f"{path}_launch_counts"] = ok_path
        emit(dict(phase="generate_w8", path=path, shape=[8, 256, new], ttft_ms=ttft,
                  generate_ms=wall, ms_per_tick=(wall - ttft) / ticks,
                  decode_tokens_per_s=8 * ticks / ((wall - ttft) / 1e3), launches=launches,
                  expected_launches=expected, ok=ok_path))
    a, b = gen["generate_w8_fused"][:, 256:], gen["generate_w8_unfused"][:, 256:]
    emit(dict(phase="generate_w8_compare",
              greedy_tokens_equal_fused_vs_unfused=float((a == b).float().mean())))
    del unfused, engines, eng, eng16
    torch.cuda.empty_cache()
    emit(dict(phase="serve_w8_summary", checks=checks))
    return by_path, all(checks.values())


# ---------------------------------------------------------------------------
# LLaMA phases: kernels_llama, serve_llama, generate_llama
# ---------------------------------------------------------------------------

LLAMA_E, LLAMA_F, LLAMA_H, LLAMA_KV, LLAMA_D = 2048, 8192, 32, 4, 64
# llama-1b's dense panels (K, N): q and o, k and v, gate and up, down
PANELS_LLAMA_1B = ((2048, 2048), (2048, 256), (2048, 8192), (8192, 2048))
LLAMA_DENSE_PER_LAYER = 7          # q, k, v, o, gate, up, down


def abs_panel(w):
    """|W| in fp32: a dense panel, or a W8A16 pair dequantized."""
    from deepspeed_tpu_torch.ops import w8 as w8ops

    return (w8ops.dequantize_weight(*w) if isinstance(w, tuple) else w.float()).abs()


def timed_calls(torch, kernel, plain, library, rot, n=50, union=False):
    """Device ms of each callable on inputs cycled by ``rot`` (None where
    the profiler saw no device activity) and, under ``*_event``, its
    CUDA-event ms; the plain version takes 5 calls. With ``union`` (the
    decode-layer kernels, whose launches overlap under programmatic
    dependent launch) the kernel's device ms is the union of its kernels'
    intervals, their sum under ``kernel_sum``."""
    out = {}
    for which, fn, k in (("kernel", kernel, n), ("plain", plain, 5), ("library", library, n)):
        if fn is None:
            out[which] = out[which + "_event"] = None
            continue
        call = lambda fn=fn: fn(*rot.next())  # noqa: E731
        if which == "kernel" and union:
            out["kernel_sum"], out[which] = device_union_ms(torch, call, k)
        else:
            out[which] = device_ms(torch, call, k)
        out[which + "_event"] = cuda_ms(torch, call, k)
    return out


def kernel_row(phase, name, shape, err, ratio, limit, t, bound, **extra):
    """One held and timed case as a JSON line (ok: the error within its
    limit, and an fp64 anchor that ``extra`` carries held); returns the row."""
    b_ms, b_by = bound
    res = dict(phase=phase, name=name, shape=shape, max_err=err, err_over_limit=ratio,
               limit=limit, ok=ratio <= 1.0 and extra.get("fp64_anchor_ok", True)
               and extra.get("bitwise_repeat", True) and extra.get("sm90_ok", True),
               kernel_ms=t["kernel"],
               kernel_event_ms=t["kernel_event"], plain_ms=t["plain"],
               plain_event_ms=t["plain_event"], library_ms=t["library"],
               library_event_ms=t["library_event"], bound_us=b_ms * 1e3, bound_by=b_by,
               **({"kernel_sum_ms": t["kernel_sum"]} if "kernel_sum" in t else {}), **extra)
    emit(res)
    return res


def attention_errors(torch, got, ref, q, k, v, lengths, scale):
    """Decode attention's output against its plain version, element by
    element: within one bf16 ulp of the larger of the two plus 1e-5 of the
    sum of its addends' magnitudes, sum_i p_i |v_i| / l (fp32 sums over up
    to 512 positions in two orders: where the addends cancel, an output near
    zero is exact to a bf16 ulp of itself in neither). ``k``/``v``:
    contiguous ``(B, S, KV, D)`` caches (a paged arena gathered). Returns
    the largest error, its largest ratio to that limit, and a witness: the
    ratio to the bare one-ulp limit, and the kernel and the plain version
    each against the same arithmetic in fp64, in units of the limit, and
    whether the kernel lies within max(1, the plain version's) of it."""
    B, _, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    live = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = torch.einsum("bkgd,bskd->bkgs", q.double().reshape(B, KV, H // KV, D) * scale,
                     k.double()).masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True).clamp(min=1e-300)
    vd = v.double().masked_fill(~live[:, :, None, None], 0.0)
    exact = (torch.einsum("bkgs,bskd->bkgd", p, vd) / l).reshape(B, 1, H, D)
    mag = (torch.einsum("bkgs,bskd->bkgd", p, vd.abs()) / l).reshape(B, 1, H, D)
    ulp = bf16_ulp_t(torch, torch.maximum(got.float().abs(), ref.float().abs())).double()
    lim = ulp + 1e-5 * mag
    d = (got.double() - ref.double()).abs()
    lim_x = bf16_ulp_t(torch, exact).double() + 1e-5 * mag
    witness = dict(err_over_1ulp_limit=float((d / ulp).max()),
                   kernel_vs_fp64_over_limit=float(((got.double() - exact).abs() / lim_x).max()),
                   plain_vs_fp64_over_limit=float(((ref.double() - exact).abs() / lim_x).max()))
    # an anchor that does not lean on the plain version: the kernel within
    # the limit of the fp64 value, or no further from it than the plain one
    witness["fp64_anchor_ok"] = (witness["kernel_vs_fp64_over_limit"]
                                 <= max(1.0, witness["plain_vs_fp64_over_limit"]))
    return float(d.max()), float((d / lim).max()), witness


def attention_rows(torch, F, peaks, g, H, KV, D, phase):
    """Decode attention (B=8, S_max 512, ragged lengths), paged attention
    (16-token pages in shuffled order, 32 table entries) and the flash
    forward (B=2, S=1024, causal) at one head geometry in bf16: decode and
    paged within their plain versions' limits (:func:`attention_errors`),
    flash
    within two at the output's scale (its lse within 1e-4), each timed
    beside SDPA (with ``enable_gqa`` where KV < H: the query heads share KV
    heads; flash takes the KV heads repeated, as the full-sequence path
    does). Returns the three rows by kernel name."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa

    bf, gqa = torch.bfloat16, KV < H
    lib = (f"SDPA with enable_gqa ({H // KV} query heads share each KV head)" if gqa
           else "SDPA, masked")
    rows = {}

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    def timed(*a, **k):
        return timed_calls(torch, *a, **k)

    # decode attention over contiguous caches: enough copies to pass the L2
    B, S_max = 8, 512
    lengths = torch.tensor([1, 512, 37, 100, 256, 300, 511, 64], dtype=torch.int32, device="cuda")
    live = int(lengths.sum())
    mask = (torch.arange(S_max, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    n_sets = max(2, -(-64_000_000 // (4 * B * S_max * KV * D)))
    sets = [(rn(B, 1, H, D), rn(B, S_max, KV, D), rn(B, S_max, KV, D)) for _ in range(n_sets)]
    q, k, v = sets[0]
    got = da.decode_attention(q, k, v, lengths)
    ref = da.decode_attention_plain(q, k, v, lengths, D ** -0.5)
    torch.cuda.synchronize()
    err, ratio, witness = attention_errors(torch, got, ref, q, k, v, lengths, D ** -0.5)
    lim = ("per element: 1 bf16 ulp + 1e-5 x the sum of the addends' magnitudes "
           "(sum_i p_i |v_i| / l); and against the fp64 value within max(1, the plain "
           "version's ratio)")

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask,
                                              enable_gqa=gqa)
    t = timed(lambda q, k, v: da.decode_attention(q, k, v, lengths),
              lambda q, k, v: da.decode_attention_plain(q, k, v, lengths, D ** -0.5),
              sdpa, Rotation(sets), n=100)
    rows["decode_attention"] = kernel_row(
        phase, "decode_attention", f"B={B} S_max={S_max} H={H} KV={KV} D={D} lengths="
        + ",".join(str(int(n)) for n in lengths), err, ratio, lim, t,
        bound_ms(2 * live * KV * D * 2 + 2 * B * H * D * 2 + B * 4, 4 * live * H * D, peaks),
        library=lib, **witness)
    del sets

    # paged attention at the same heads (16-token pages, 32 table entries)
    lens, pt, T = [1, 16, 17, 255, 256, 300, 511, 512], 16, 32
    gp = torch.Generator(device="cuda").manual_seed(SEED + 9)
    n_sets = max(2, -(-64_000_000 // (4 * (B * T + 1) * pt * KV * D)))
    sets = [paged_arena(torch, gp, lens, B, H, KV, D, pt, T, bf) for _ in range(n_sets)]
    plen = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pmask = (torch.arange(T * pt, device="cuda")[None, :] < plen[:, None])[:, None, None, :]
    q, kp, vp, table = sets[0]
    got = pa.paged_decode_attention(q, kp, vp, table, plen)
    ref = pa.paged_decode_attention_plain(q, kp, vp, table, plen, D ** -0.5)
    torch.cuda.synchronize()
    err, ratio, witness = attention_errors(torch, got, ref, q, pa.gather_kv_pages(kp, table),
                                           pa.gather_kv_pages(vp, table), plen, D ** -0.5)

    def gather_sdpa(q, kp, vp, table):
        kk, vv = pa.gather_kv_pages(kp, table), pa.gather_kv_pages(vp, table)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kk.transpose(1, 2),
                                              vv.transpose(1, 2), attn_mask=pmask,
                                              enable_gqa=gqa)
    t = timed(lambda q, kp, vp, tb: pa.paged_decode_attention(q, kp, vp, tb, plen),
              lambda q, kp, vp, tb: pa.paged_decode_attention_plain(q, kp, vp, tb, plen,
                                                                    D ** -0.5),
              gather_sdpa, Rotation(sets), n=100)
    plive = sum(lens)
    rows["paged_attention"] = kernel_row(
        phase, "paged_attention", f"B={B} H={H} KV={KV} D={D} pt={pt} T={T} lengths="
        + ",".join(map(str, lens)), err, ratio, lim, t,
        bound_ms(2 * plive * KV * D * 2 + 2 * B * H * D * 2 + B * T * 4 + B * 4,
                 4 * plive * H * D, peaks),
        library="gather_kv_pages + " + lib + " on the gathered view", **witness)
    del sets

    # the flash forward: engine(ids)'s prefill (the KV heads repeated)
    Bf, Sf = 2, 1024
    q, k, v = (rn(Bf, Sf, H, D) for _ in range(3))
    (o, lse), (ro, rlse) = (fa.flash_attention_with_lse(q, k, v, causal=True),
                            fa.flash_attention_plain(q, k, v, True, D ** -0.5))
    torch.cuda.synchronize()
    rlse = rlse.reshape(Bf, H, Sf).transpose(1, 2)
    held = flash_check(torch, o, ro, *flash_fp64(torch, q, k, v, True, D ** -0.5)[0])
    err, tol = held.pop("max_err"), held.pop("tol")
    held.pop("ok")
    held["per_element_err_over_limit"] = held.pop("err_over_limit")
    finite = bool(torch.isfinite(o).all())
    lse_err = float((lse - rlse).abs().max())
    lse_ok = lse_err <= 1e-4 * max(1.0, float(rlse.abs().max()))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    t = timed(lambda q, k, v: fa.flash_attention_with_lse(q, k, v, causal=True),
              lambda q, k, v: fa.flash_attention_plain(q, k, v, True, D ** -0.5),
              lambda *_: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
              Rotation([(q, k, v)]), n=20)
    pairs = Sf * (Sf + 1) / 2
    # the row's ratio: the larger of its two limits' (FLASH_LIMIT); inf where the lse
    # misses or o is not finite (the row gates the fp64 anchor)
    rows["flash_attention_fwd"] = kernel_row(
        phase, "flash_attention_fwd", f"B={Bf} S={Sf} H={H} D={D} causal", err,
        max(err / tol, held["per_element_err_over_limit"]) if lse_ok and finite
        else float("inf"),
        FLASH_LIMIT + "; lse within 1e-4", t,
        bound_ms(4 * Bf * Sf * H * D * 2 + Bf * H * Sf * 4, 4 * Bf * H * D * pairs, peaks),
        library="SDPA", lse_max_err=lse_err, **held)
    torch.cuda.empty_cache()
    return rows


def run_kernels_llama(torch, F, peaks):
    """The kernels at llama-1b's shapes (M=8 decode rows, E=2048, F=8192,
    H=32 over KV=4 heads, D=64): the RMSNorm and SwiGLU branches of the two
    decode-layer kernels in bf16 and under W8A16 (g=128 and one group), each
    element within its limit of the plain version (``w8_limits``), timed with
    the plain version and the bound; their fp32 instantiations at a small
    aligned shape (1e-5 of the fp32 addends' magnitudes per element); decode,
    paged and flash attention at 8 query heads per KV head
    (:func:`attention_rows`); the w8 matmul on llama-1b's four panels at M=8
    and 64. Returns the new branches' rows, the earlier kernels' rows at
    llama-1b's shapes, and whether all held."""
    from deepspeed_tpu_torch.ops import decode_layer as dl
    from deepspeed_tpu_torch.ops import w8 as w8ops
    from deepspeed_tpu_torch.ops import w8_matmul as wm

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    bf = torch.bfloat16
    M, E, Fh, H, KV, D = 8, LLAMA_E, LLAMA_F, LLAMA_H, LLAMA_KV, LLAMA_D
    rows, at, ok = {}, {}, True

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    def timed(*a, **k):
        return timed_calls(torch, *a, **k)

    def row(*a, **k):
        return kernel_row("kernels_llama", *a, **k)

    zE = torch.zeros(E, device="cuda")
    lim_bf16 = ("per element: 1 bf16 ulp of the plain value + 1e-5 x the fp32 addends' "
                "magnitudes + half a bf16 ulp of the row's largest output")

    # the decode-layer branches: bf16 weights, W8A16 pairs (g=128, one group)
    for group in (None, 128, "one"):
        def panel(K, N, group=group):
            if group is None:
                return rn(K, N, std=0.02)
            return w8_panels(torch, g, K, N, K if group == "one" else group, 1)[0]

        def scale_bytes(K, N, group=group):
            return 0 if group is None else (1 if group == "one" else K // group) * N * 4

        wbytes = 2 if group is None else 1
        suffix = "" if group is None else "_w8"
        glabel = "" if group is None else f" g={'K (one group)' if group == 'one' else group}"
        for N in (2048, 256):
            nbytes = E * N * wbytes + scale_bytes(E, N) + M * E * 2 + M * N * 2 + E * 4
            sets = [(rn(M, E), 1 + rn(E, std=0.1, dtype=torch.float32), panel(E, N))
                    for _ in range(max(2, -(-60_000_000 // nbytes)))]
            x, ns, w = sets[0]
            zN = torch.zeros(N, dtype=bf, device="cuda")

            def kern(x, ns, w):
                return dl.fused_norm_proj(x, ns, None, w, None, rms=True)

            def plain(x, ns, w, zN=zN):
                return dl.norm_proj_plain(x, ns, zE, w, zN, 1e-5, rms=True)
            got, ref = kern(x, ns, w), plain(x, ns, w)
            torch.cuda.synchronize()
            xn = dl._norm_rows(x.float(), ns, None, 1e-5, rms=True).to(bf)
            err, ratio, wide = w8_limits(torch, got, ref, xn.float().abs() @ abs_panel(w), True)
            held = decode_sm90_held(torch, lambda: kern(x, ns, w), got, 1, group is not None)
            res = row("norm_proj_rms" + suffix, f"M={M} E={E} N={N}{glabel}", err, ratio,
                      lim_bf16, timed(kern, plain, None, Rotation(sets), union=True),
                      bound_ms(nbytes, 2 * M * E * N, peaks), limit_over_2ulp_share=wide, **held)
            ok &= res["ok"]
            if N == 2048 and group in (None, 128):
                rows["norm_proj_rms" + suffix] = res
            del sets
        # o-proj -> RMSNorm -> SwiGLU -> residual
        nbytes = ((E * E + 3 * E * Fh) * wbytes + scale_bytes(E, E) + 2 * scale_bytes(E, Fh)
                  + scale_bytes(Fh, E) + 3 * M * E * 2 + E * 4)
        sets = [(rn(M, E), rn(M, E), panel(E, E), 1 + rn(E, std=0.1, dtype=torch.float32),
                 panel(E, Fh), panel(E, Fh), panel(Fh, E))
                for _ in range(max(2, -(-60_000_000 // nbytes)))]
        y, x, wo, ns, wg, wu, wd = sets[0]

        def kern(y, x, wo, ns, wg, wu, wd):
            return dl.fused_post_attn(y, x, wo, None, ns, None, (wg, wu, wd), swiglu=True,
                                      rms=True)

        def plain(y, x, wo, ns, wg, wu, wd):
            return dl.post_attn_plain(y, x, wo, zE.to(bf), ns, zE, (wg, wu, wd), 1e-5,
                                      swiglu=True, rms=True)
        got, ref = kern(*sets[0]), plain(*sets[0])
        torch.cuda.synchronize()
        r1 = x.float() + dl._dot(y, wo)
        hin = dl._norm_rows(r1, ns, None, 1e-5, rms=True).to(bf)
        gate = dl._dot(hin, wg)
        h = (gate * torch.sigmoid(gate) * dl._dot(hin, wu)).to(bf)
        mag = x.float().abs() + y.float().abs() @ abs_panel(wo) + h.float().abs() @ abs_panel(wd)
        err, ratio, wide = w8_limits(torch, got, ref, mag, True)
        held = decode_sm90_held(torch, lambda: kern(*sets[0]), got, 3, group is not None)
        res = row("post_attn_swiglu" + suffix, f"M={M} E={E} F={Fh}{glabel}", err, ratio,
                  lim_bf16, timed(kern, plain, None, Rotation(sets), n=20, union=True),
                  bound_ms(nbytes, 2 * M * (E * E + 3 * E * Fh), peaks),
                  limit_over_2ulp_share=wide, launches_per_call=4, **held)
        ok &= res["ok"]
        if group in (None, 128):
            rows["post_attn_swiglu" + suffix] = res
        del sets

    # fp32 activations at a small aligned shape: per element within 1e-5 of
    # the fp32 addends' magnitudes (fp32 weights; W8A16 with 128-row groups
    # and with one group per panel, the down panel's spanning two chunks)
    def rn32(*shape, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std

    Es, Fs, Ms, Ns = 256, 1280, 3, 384
    z = torch.zeros(Fs, device="cuda")
    for group in (None, 128, "one"):
        def pnl(K, N, group=group):
            if group is None:
                return rn32(K, N, std=0.02)
            return w8_panels(torch, g, K, N, K if group == "one" else group, 1)[0]
        x, y, ns = rn32(Ms, Es), rn32(Ms, Es), 1 + rn32(Es, std=0.1)
        w, wo, wg, wu, wd = pnl(Es, Ns), pnl(Es, Es), pnl(Es, Fs), pnl(Es, Fs), pnl(Fs, Es)
        shape = f"M={Ms} E={Es} N={Ns} F={Fs} fp32, " + (
            "fp32 weights" if group is None else f"W8 g={'K' if group == 'one' else group}")
        got = dl.fused_norm_proj(x, ns, None, w, None, rms=True)
        ref = dl.norm_proj_plain(x, ns, z[:Es], w, z[:Ns], 1e-5, rms=True)
        xn = dl._norm_rows(x, ns, None, 1e-5, rms=True)
        found = [("norm_proj_rms", w8_limits(torch, got, ref, xn.abs() @ abs_panel(w), False))]
        got = dl.fused_post_attn(y, x, wo, None, ns, None, (wg, wu, wd), swiglu=True, rms=True)
        ref = dl.post_attn_plain(y, x, wo, z[:Es], ns, z[:Es], (wg, wu, wd), 1e-5, swiglu=True,
                                 rms=True)
        hin = dl._norm_rows(x + dl._dot(y, wo), ns, None, 1e-5, rms=True)
        gate = dl._dot(hin, wg)
        h = gate * torch.sigmoid(gate) * dl._dot(hin, wu)
        mag = x.abs() + y.abs() @ abs_panel(wo) + h.abs() @ abs_panel(wd)
        found.append(("post_attn_swiglu", w8_limits(torch, got, ref, mag, False)))
        for name, (err, ratio, _) in found:
            emit(dict(phase="kernels_llama_fp32", name=name, shape=shape, max_err=err,
                      err_over_limit=ratio, ok=ratio <= 1.0,
                      limit="1e-5 x the fp32 addends' magnitudes per element"))
            ok &= ratio <= 1.0

    # decode, paged and flash attention at 8 query heads per KV head (the
    # kernels' MAX_GROUP)
    at.update(attention_rows(torch, F, peaks, g, H, KV, D, "kernels_llama"))
    ok &= all(r["ok"] for r in at.values())

    # the w8 matmul on llama-1b's panels: decode rows (8) and a full chunk (64)
    def pair(x, c, sc):   # dequantize + matmul: two calls, timed beside
        return x @ w8ops.dequantize_weight(c, sc, bf)

    at["w8a16_matmul"] = []
    for K, N in PANELS_LLAMA_1B:
        panels = w8_panels(torch, g, K, N, 128, -(-60_000_000 // (K * N)))
        for Mw in (8, 64):
            sets = [(rn(Mw, K), c, sc) for c, sc in panels]
            held = w8_matmul_held(torch, *sets[0])
            err, ratio = held.pop("max_err"), held.pop("err_over_limit")
            t = timed(wm.w8a16_matmul_kernel, wm.w8a16_matmul_plain, None, Rotation(sets))
            rot = Rotation(sets)
            res = row("w8a16_matmul", f"M={Mw} K={K} N={N} g=128", err, ratio,
                      "w8_limits: 1e-5 x |x| @ |dequant W| per element (plain, tiled, fp64)", t,
                      bound_ms(K * N + K // 128 * N * 4 + Mw * K * 2 + Mw * N * 4,
                               2 * Mw * K * N, peaks),
                      dequant_matmul_pair_ms=device_ms(torch, lambda: pair(*rot.next()), 50),
                      **held)
            ok &= res["ok"]
            if Mw == 8:
                at["w8a16_matmul"].append(res)
            del sets
        del panels
    torch.cuda.empty_cache()
    return rows, at, ok


def teacher_forced(torch, ref, streams, V):
    """Greedy streams ``[(tokens, prompt_len), ...]`` teacher-forced through
    the engine ``ref``: the strict share of picks that are its argmax, the
    tie-aware share (within two bf16 ulps of its maximum), and, over the
    positions where its top two logits lie more than 16 bf16 ulps apart (so
    that no two errors within the forward's 8-ulp tolerance can swap them),
    the strict share there and how many such positions there were; and the
    share of positions whose top two lie under one bf16 ulp apart (how flat
    the logits are)."""
    strict = ties = decisive = agree_decisive = flat = n = 0
    for seq, n0 in streams:
        seq = torch.as_tensor(seq, dtype=torch.long, device=ref.device)
        lg = ref(seq[None, :-1])[0, n0 - 1:, :V].float()
        pick = seq[n0:]
        ulp = bf16_ulp(float(lg.abs().max()))
        top2 = lg.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        hit = lg.argmax(-1) == pick
        strict += int(hit.sum())
        ties += round(near_max_share(pick, lg, 2 * ulp) * len(pick))
        big = margin > 16 * ulp
        decisive += int(big.sum())
        agree_decisive += int((hit & big).sum())
        flat += int((margin < ulp).sum())
        n += len(pick)
    return dict(positions=n, strict=strict / n, within_2ulp=ties / n,
                decisive_positions=decisive, decisive_strict=agree_decisive / max(decisive, 1),
                top2_below_1ulp=flat / n)


def run_serve_llama(torch, out_dir=None):
    """llama-1b (E=2048, 22 layers, 32 heads over 4 KV heads, D=64, F=8192,
    vocab 32000; full size, random weights from seed 1234) served through
    ``init_inference(max_tokens=512)`` in bf16 and in W8A16 from the same
    weights: the batcher with page-resident KV (16-token pages, 8 slots) on
    the serve phase's 32 requests twice each; ``engine(ids)`` at B=2,
    S=1024; ``generate`` (B=8, prompt 256, 64 new) with the fused decode
    kernels on and off. Gates: exact launch counts, no leaks, the dense
    bytes, the forward (B=1, S=128) within 8 bf16 ulps of a CPU fp32 engine
    holding each card engine's own weights (bf16 values, int8 codes), the
    int8-vs-bf16 logits, the sampling step on the card, seeded sampling, and
    the batcher's greedy streams teacher-forced through an fp32 engine on
    the card holding the same weights (checked against the CPU's): picks
    within two bf16 ulps of its maximum at ≥ 99% of positions, and its
    argmax wherever its top two lie more than 16 ulps apart. The strict
    share is printed beside them, with the stock unfused path's on the
    generate streams: random-weight llama-1b logits are flat (12–15% of top
    two under one bf16 ulp apart) and the bf16 forward sits ~5 ulps from
    fp32, so no bf16 path reaches 95% strict there."""
    from collections import Counter

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, llama_config

    cfg = llama_config("llama-1b")
    L, V = cfg.n_layer, cfg.vocab_size
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg).init_weights(torch.Generator().manual_seed(SEED))
    init_s = time.perf_counter() - t0
    engines, resident, checks = {}, {}, {}
    for label, kw in (("bf16", {}), ("w8", dict(quant=W8))):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        engines[label] = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512, **kw)
        torch.cuda.synchronize()
        resident[label] = torch.cuda.memory_allocated() - m0
    n_params = sum(p.numel() for p in model.parameters())
    del model                    # the engines hold their own copies
    dense8, dense16 = (dense_weight_bytes(engines[k].module) for k in ("w8", "bf16"))
    E, F, HD, KVD = (cfg.hidden_size, cfg.intermediate_size, cfg.n_head * cfg.head_dim,
                     cfg.kv_heads * cfg.head_dim)
    n_dense = L * (2 * E * HD + 2 * E * KVD + 3 * E * F)     # q, o; k, v; gate, up, down
    # int8 codes + one fp32 scale per 128 rows: (1 + 4/128) / 2 = 33/64 of bf16's bytes
    checks["dense_bytes_ratio"] = dense16 == 2 * n_dense and 64 * dense8 == 33 * dense16
    checks["rotary_cache_len"] = engines["bf16"].cache_len == engines["bf16"]._gen_limit == 512
    emit(dict(phase="serve_llama_weights", model="llama-1b", init_s=init_s, params=n_params,
              dense_elements=n_dense, dense_weight_bytes_w8=dense8,
              dense_weight_bytes_bf16=dense16, dense_ratio=dense8 / dense16,
              resident_bytes=resident, resident_ratio=resident["w8"] / resident["bf16"],
              cache_len=engines["bf16"].cache_len))

    reqs = serve_requests(V)
    by_path, served = {}, {}
    for label, e in engines.items():
        q = label == "w8"
        path = f"serve_llama{'_w8' if q else ''}_paged"
        batcher = ds.ContinuousBatcher(e, n_slots=8, seed=SEED,
                                       prefix_cache={"page_tokens": 16, "n_pages": 512})
        zero_counts()
        chunks0 = Counter(batcher.prefill_chunks)
        outs, passes = [], []
        for _ in range(2):
            o, nums = serve_pass(torch, batcher, reqs)
            outs.append(o)
            passes.append(nums)
        launches = read_counts()
        by_path[path] = launches
        chunks = batcher.prefill_chunks - chunks0
        singles = sum(p["ticks"] + p["one_token_prefills"] for p in passes)
        expected = {n: 0 for n in launches}
        expected.update({"paged_attention": L * singles,
                         "norm_proj_rms_w8" if q else "norm_proj_rms": 3 * L * singles,
                         "post_attn_swiglu_w8" if q else "post_attn_swiglu": L * singles,
                         "w8a16_matmul": chunk_launches(chunks, LLAMA_DENSE_PER_LAYER * L)
                         if q else 0})
        prof = serve_profile(torch, batcher, reqs,
                             out_dir and os.path.join(out_dir, f"profile_{path}.txt"))
        run_checks = {
            "launch_counts": launches == expected,
            "no_leaks": all(v == 0 for p in passes for v in p["leaks"].values())
            and all(v == 0 for v in batcher.leak_counts().values()),
            "shapes_and_vocab": all(len(o) == len(r["prompt"]) + r["max_new_tokens"]
                                    and int(o.max()) < V for op in outs for o, r in zip(op, reqs)),
            "pass2_hits": passes[1]["hit_tokens"] > 0}
        samp = sampling_check(torch, e, reqs, outs[0], phase="serve_llama_sampling")
        run_checks["sampling_card_vs_cpu"] = samp["ok"]
        served[label] = [(o_pass[i], len(reqs[i]["prompt"]))
                         for o_pass in outs for i in range(0, len(reqs), 2)]
        emit(dict(phase="serve_llama", path=path, model="llama-1b", dtype="bfloat16",
                  quant="int8 W8A16" if q else None, n_slots=8, requests=len(reqs),
                  prefix_cache={"page_tokens": 16, "n_pages": 512}, passes=passes,
                  profile=prof, resident_weight_bytes=resident[label],
                  prefill_chunks={f"{B}x{S}": n for (B, S), n in sorted(chunks.items())},
                  launches=launches, expected_launches=expected, checks=run_checks))
        checks.update({f"{path}_{k}": v for k, v in run_checks.items()})
        del batcher

    # the forward against CPU fp32 engines holding each card engine's own
    # weights (bf16 values, int8 codes) on a short prompt; the same weights
    # in an fp32 engine on the card, held against the CPU's, are the
    # reference the greedy streams are teacher-forced through
    ids = torch.randint(0, V, (1, 128), generator=torch.Generator().manual_seed(SEED + 6))
    with torch.device("meta"):
        template = LlamaForCausalLM(cfg)
    fp32_card, gates = {}, {}
    for label, e in engines.items():
        kw = dict(quant=W8) if label == "w8" else {}
        state = {k: v.detach().cpu() for k, v in e.module.state_dict().items()}
        cpu = ds.init_inference(template, params=state, dtype=torch.float32, max_tokens=512,
                                device="cpu", **kw)
        ref = cpu(ids)[..., :V].float()
        del cpu
        fp32_card[label] = ds.init_inference(template, params=state, dtype=torch.float32,
                                             max_tokens=512, **kw)
        del state
        card = e(ids)[..., :V].float().cpu()
        card32 = fp32_card[label](ids)[..., :V].float().cpu()
        err = float((card - ref).abs().max())
        tol = 8 * bf16_ulp(float(ref.abs().max()))
        err32 = float((card32 - ref).abs().max())
        top1 = float((card.argmax(-1) == ref.argmax(-1)).float().mean())
        tf = teacher_forced(torch, fp32_card[label], served[label], V)
        tf_self = teacher_forced(torch, e, served[label], V)
        gates[label] = dict(forward_max_err=err, forward_tol=tol, forward_top1=top1,
                            fp32_card_vs_cpu_max_err=err32,
                            teacher_forced_vs_fp32=tf, teacher_forced_vs_own_bf16_forward=tf_self)
        checks[f"forward_vs_cpu_fp32_{label}"] = err <= tol and bool(torch.isfinite(card).all())
        # fp32 in other orders over 22 layers: far below a bf16 ulp (2^-8 relative)
        checks[f"fp32_reference_vs_cpu_{label}"] = err32 <= 1e-3 * float(ref.abs().max())
        checks[f"greedy_teacher_forced_{label}"] = (tf["within_2ulp"] >= 0.99
                                                    and tf["decisive_strict"] == 1.0)
    l8, l16 = (engines[k](ids)[..., :V].float() for k in ("w8", "bf16"))
    rel_rms = float((l8 - l16).pow(2).mean().sqrt() / l16.pow(2).mean().sqrt())
    checks["int8_vs_bf16_rel_rms"] = rel_rms <= 0.1
    emit(dict(phase="serve_llama_checks", forward_shape=[1, 128], gates=gates,
              int8_vs_bf16_logits_rel_rms=rel_rms))

    # engine(ids) at B=2, S=1024: the flash forward at H=32
    eng16 = engines["bf16"]
    big = torch.randint(0, V, (2, 1024), generator=torch.Generator().manual_seed(SEED + 1))
    eng16(big[:, :128])
    fwd = {}
    zero_counts()
    for k in ("first", "again"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng16(big)
        torch.cuda.synchronize()
        fwd[k] = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    by_path["forward_llama"] = launches
    expected = {n: 0 for n in launches}
    expected["flash_attention_fwd"] = 2 * L
    checks["forward_launch_counts"] = launches == expected
    checks["forward_finite"] = bool(torch.isfinite(out[..., :V]).all())
    emit(dict(phase="forward_llama", shape=[2, 1024], forward_ms=fwd["first"],
              forward_again_ms=fwd["again"], launches=launches, expected_launches=expected))
    del out

    # generate with the fused decode kernels on and off, bf16 and int8 (the
    # unfused engines hold the same weights); each path's greedy streams
    # teacher-forced through the fp32 reference, the stock unfused path's
    # beside the fused kernels'
    prompt = torch.randint(0, V, (8, 256), generator=torch.Generator().manual_seed(SEED + 7))
    new, compare = 64, {}
    for label, e in engines.items():
        w8 = "_w8" if label == "w8" else ""
        state = {k: v.detach() for k, v in e.module.state_dict().items()}
        unfused = ds.init_inference(template, params=state, dtype=torch.bfloat16,
                                    max_tokens=512, decode_fused=False,
                                    **(dict(quant=W8) if w8 else {}))
        del state
        gen = {}
        for fused, eg in ((True, e), (False, unfused)):
            path = f"generate_llama{w8}_{'fused' if fused else 'unfused'}"
            eg.generate(prompt[:, :32], max_new_tokens=4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eg.generate(prompt, max_new_tokens=1)
            torch.cuda.synchronize()
            ttft = (time.perf_counter() - t0) * 1e3
            zero_counts()
            t0 = time.perf_counter()
            out = eg.generate(prompt, max_new_tokens=new)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches = read_counts()
            by_path[path] = launches
            ticks = new - 1
            expected = {n: 0 for n in launches}
            expected["decode_attention"] = L * ticks
            if fused:
                expected["norm_proj_rms" + w8] = 3 * L * ticks
                expected["post_attn_swiglu" + w8] = L * ticks
            elif w8:
                expected["w8a16_matmul"] = LLAMA_DENSE_PER_LAYER * L * ticks
            gen[fused] = out
            ok_path = (launches == expected and tuple(out.shape) == (8, 256 + new)
                       and int(out.max()) < V)
            checks[f"{path}_launch_counts"] = ok_path
            tf = teacher_forced(torch, fp32_card[label], [(s, 256) for s in out], V)
            emit(dict(phase="generate_llama", path=path, shape=[8, 256, new], ttft_ms=ttft,
                      generate_ms=wall, ms_per_tick=(wall - ttft) / ticks,
                      decode_tokens_per_s=8 * ticks / ((wall - ttft) / 1e3), launches=launches,
                      expected_launches=expected, teacher_forced_vs_fp32=tf, ok=ok_path))
        compare[f"greedy_tokens_equal{w8}_fused_vs_unfused"] = float(
            (gen[True][:, 256:] == gen[False][:, 256:]).float().mean())
        del unfused, gen
        torch.cuda.empty_cache()
    # seeded sampling repeats through the fused ticks
    s1 = eng16.generate(prompt[:, :64], max_new_tokens=32, temperature=0.8, top_p=0.9, seed=7)
    s2 = eng16.generate(prompt[:, :64], max_new_tokens=32, temperature=0.8, top_p=0.9, seed=7)
    checks["sampled_generate_repeats"] = bool(torch.equal(s1, s2)) and int(s1.max()) < V
    emit(dict(phase="generate_llama_compare", **compare))
    del engines, eng16, fp32_card
    torch.cuda.empty_cache()
    emit(dict(phase="serve_llama_summary", checks=checks))
    return by_path, all(checks.values())


# ---------------------------------------------------------------------------
# GPT-NeoX (pythia-1b): kernels_neox, serve_neox
# ---------------------------------------------------------------------------

NEOX_E, NEOX_F, NEOX_H, NEOX_D = 2048, 8192, 8, 256
# pythia-1b's dense panels (K, N): qkv, dense (the o-proj), h_to_4h, 4h_to_h
PANELS_PYTHIA_1B = ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048))
NEOX_DENSE_PER_LAYER = 4
# the branches of post_attn beside GPT-2's (tanh, sequential) and LLaMA's
# (SwiGLU, sequential): the GPT-NeoX ones, which its paths run (the
# parallel residual by default, the sequential one under
# use_parallel_residual=False), and the other combinations of the flags,
# which no model's path runs and the kernels phase holds
NEOX_KERNELS = ("post_attn_erf_par", "post_attn_erf_par_w8", "post_attn_erf", "post_attn_erf_w8")
OFF_PATH_BRANCHES = ("post_attn_par", "post_attn_par_w8", "post_attn_swiglu_par",
                     "post_attn_swiglu_par_w8")
NO_NEOX = {n: 0 for n in NEOX_KERNELS + OFF_PATH_BRANCHES}
# each held branch of post_attn: its launch-count name and flags
POST_ATTN_BRANCHES = (
    ("post_attn_erf_par", dict(exact_gelu=True, parallel_residual=True)),
    ("post_attn_erf", dict(exact_gelu=True)),
    ("post_attn_par", dict(parallel_residual=True)),
    ("post_attn", {}),
    ("post_attn_erf_par", dict(exact_gelu=True, parallel_residual=True, rms=True)),
    ("post_attn_erf", dict(exact_gelu=True, rms=True)),
    ("post_attn_par", dict(parallel_residual=True, rms=True)),
    ("post_attn_swiglu_par", dict(swiglu=True, parallel_residual=True, rms=True)),
    ("post_attn_swiglu_par", dict(swiglu=True, parallel_residual=True)),
)


def branch_label(name, kw):
    return name + ("_rms" if kw.get("rms") else "")


def post_attn_operands(make, panel, M, E, Fh, kw):
    """One set of post_attn operands (y, x, wo, bo, ns, nb, mlp weights) for
    a branch's flags: ``make(*shape, std=, dtype=)`` draws activations and
    vectors, ``panel(K, N)`` weights (full width or W8A16 pairs); no norm
    bias under RMSNorm, no MLP biases under SwiGLU."""
    y, x = make(M, E), make(M, E)
    wo, bo = panel(E, E), make(E, std=0.02)
    ns = 1 + make(E, std=0.1, dtype="fp32")
    nb = None if kw.get("rms") else make(E, std=0.1, dtype="fp32")
    if kw.get("swiglu"):
        mlp = (panel(E, Fh), panel(E, Fh), panel(Fh, E))
    else:
        mlp = (panel(E, Fh), make(Fh, std=0.02), panel(Fh, E), make(E, std=0.02))
    return y, x, wo, bo, ns, nb, mlp


def post_attn_mag(torch, args, kw):
    """The sum of the magnitudes of each output's fp32 addends: |x| + |bo|
    + |y| @ |Wo| + |h| @ |W2| (+ |b2|), h the branch's MLP activation as the
    plain version casts it."""
    from deepspeed_tpu_torch.ops import decode_layer as dl

    y, x, wo, bo, ns, nb, mlp = args
    cdt = x.dtype
    r1 = x.float() + dl._dot(y, wo) + bo.float()
    src = x.float() if kw.get("parallel_residual") else r1
    hin = dl._norm_rows(src, ns, 0.0 if nb is None else nb, 1e-5, kw.get("rms", False)).to(cdt)
    if kw.get("swiglu"):
        wg, wu, w2 = mlp
        gate = dl._dot(hin, wg)
        h, b2 = (gate * torch.sigmoid(gate) * dl._dot(hin, wu)).to(cdt), 0.0
    else:
        w1, b1, w2, b2 = mlp
        gelu = dl.gelu_exact if kw.get("exact_gelu") else dl.gelu_tanh
        h, b2 = gelu(dl._dot(hin, w1) + b1.float()).to(cdt), b2.float().abs()
    return (x.float().abs() + bo.float().abs() + y.float().abs() @ abs_panel(wo)
            + h.float().abs() @ abs_panel(w2) + b2)


def branch_plain(args, kw):
    """The plain version of one branch on one operand set (a zero norm bias
    under RMSNorm, which it does not read)."""
    from deepspeed_tpu_torch.ops import decode_layer as dl

    y, x, wo, bo, ns, nb, mlp = args
    return dl.post_attn_plain(y, x, wo, bo, ns, 0 * ns if nb is None else nb, mlp, 1e-5,
                              kw.get("swiglu", False), kw.get("rms", False),
                              kw.get("exact_gelu", False), kw.get("parallel_residual", False))


def gelu_probe(torch, g, M, E, Fh, dtype, group, band, dev="cuda"):
    """The GELU form of each GELU branch of post_attn, held where the exact
    and the tanh forms part by more than the limit. A random model's MLP
    input sits within about one of zero, where the two forms differ by
    ~1e-4, below the bf16 and fp32 limits of the other cases. Here x = y =
    0 and zero biases bo, b2, so the normalised row is the norm's bias (0
    under RMSNorm) and u = nb @ W1 + b1, with b1 spread over ``band``; W2
    copies one h column into each output channel (exactly: a unit panel,
    or W8 codes 64 with scales 1/64), so each output is one h value. fp32
    takes u in about [2.3, 3.2] (the forms part by ~1.5e-4 of the value,
    the limit is 1e-5 of it); bf16 takes [-3.2, -2.6], where h is small
    and the forms part by several percent of it, many bf16 ulps. Each
    branch is held against its plain version (ratio <= 1), and against the
    plain version of the other GELU form, which must miss (ratio > 1).
    Returns whether every branch held and every control missed."""
    from deepspeed_tpu_torch.ops import decode_layer as dl

    def make(*shape, std=1.0, dtype=None):
        t = torch.randn(shape, generator=g, device=dev) * std
        return t if dtype == "fp32" else t.to(dtype)

    def panel(K, N):
        if group is None:
            return make(K, N, std=0.02, dtype=dtype)
        codes = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        return codes, torch.full((K // group, N), 0.02 / 127, device=dev)

    stride = Fh // E
    pick = torch.arange(E, device=dev) * stride
    if group is None:
        w2 = torch.zeros(Fh, E, device=dev, dtype=dtype)
        w2[pick, torch.arange(E, device=dev)] = 1
    else:
        codes = torch.zeros(Fh, E, device=dev, dtype=torch.int8)
        codes[pick, torch.arange(E, device=dev)] = 64
        w2 = codes, torch.full((Fh // group, E), 1 / 64, device=dev)
    zero = torch.zeros(M, E, device=dev, dtype=dtype)
    ok, bf16 = True, dtype == torch.bfloat16
    wlabel = "full width" if group is None else f"W8 g={group}"
    for name, kw in POST_ATTN_BRANCHES:
        if kw.get("swiglu"):
            continue
        ns = 1 + make(E, std=0.1, dtype="fp32")
        nb = None if kw.get("rms") else make(E, std=0.1, dtype="fp32")
        b1 = torch.linspace(band[0], band[1], Fh, device=dev).to(dtype)
        args = (zero, zero, panel(E, E), torch.zeros(E, device=dev, dtype=dtype), ns, nb,
                (panel(E, Fh), b1, w2, torch.zeros(E, device=dev, dtype=dtype)))
        got = dl.fused_post_attn(*args, **kw)
        ratios = []
        for exact in (kw.get("exact_gelu", False), not kw.get("exact_gelu", False)):
            kw_ref = {**kw, "exact_gelu": exact}
            _, ratio, _ = w8_limits(torch, got, branch_plain(args, kw_ref),
                                    post_attn_mag(torch, args, kw_ref), bf16)
            ratios.append(ratio)
        held = ratios[0] <= 1.0 < ratios[1]
        emit(dict(phase="kernels_neox_gelu_probe", name=branch_label(name, kw),
                  shape=f"M={M} E={E} F={Fh} {wlabel} {str(dtype)[6:]} u in {list(band)}",
                  err_over_limit=ratios[0], other_form_err_over_limit=ratios[1], ok=held,
                  limit="w8_limits (bf16 or fp32); the other form must exceed it"))
        ok &= held
    return ok


def run_kernels_neox(torch, F, peaks):
    """The kernels at pythia-1b's shapes (M=8 decode rows, E=2048, F=8192,
    H=KV=8, D=256). Every branch of post_attn beside GPT-2's and LLaMA's —
    the exact GELU and the parallel residual in all four combinations with
    the GELU form, under LayerNorm and RMSNorm, and SwiGLU under the
    parallel residual — in bf16 and W8A16 (g=128), each element within its
    limit of the plain version (``w8_limits``); the four GELU combinations
    under LayerNorm timed with the plain version and the bound. Then every
    branch in fp32 at a small aligned shape (1e-5 of the fp32 addends'
    magnitudes per element; fp32 weights, W8 g=128 and one group). The
    LayerNorm -> qkv kernel at N=6144, bf16 and W8; decode, paged and flash
    attention at D=256 (:func:`attention_rows`); the w8 matmul on
    pythia-1b's four panels at M=8. Returns the path branches' rows, the
    earlier kernels' rows at pythia-1b's shapes, and whether all held."""
    from deepspeed_tpu_torch.ops import decode_layer as dl
    from deepspeed_tpu_torch.ops import w8_matmul as wm

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    bf = torch.bfloat16
    M, E, Fh = 8, NEOX_E, NEOX_F
    rows, at, ok = {}, {}, True

    def make(*shape, std=1.0, dtype="bf16"):
        t = torch.randn(shape, generator=g, device="cuda") * std
        return t if dtype == "fp32" else t.to(bf)

    def timed(*a, **k):
        return timed_calls(torch, *a, **k)

    def row(*a, **k):
        return kernel_row("kernels_neox", *a, **k)

    lim_bf16 = ("per element: 1 bf16 ulp of the plain value + 1e-5 x the fp32 addends' "
                "magnitudes + half a bf16 ulp of the row's largest output")
    for group in (None, 128):
        def panel(K, N, group=group):
            if group is None:
                return make(K, N, std=0.02)
            return w8_panels(torch, g, K, N, group, 1)[0]

        def scale_bytes(K, N, group=group):
            return 0 if group is None else K // group * N * 4

        wbytes = 2 if group is None else 1
        suffix = "" if group is None else "_w8"
        glabel = "" if group is None else f" g={group}"

        # LayerNorm -> qkv at N=6144 (norm_qkv, decode_norm_proj_w8 at pythia-1b)
        N = 3 * E
        nbytes = E * N * wbytes + scale_bytes(E, N) + M * E * 2 + M * N * 2 + N * 2 + 2 * E * 4
        sets = [(make(M, E), 1 + make(E, std=0.1, dtype="fp32"), make(E, std=0.1, dtype="fp32"),
                 panel(E, N), make(N, std=0.02)) for _ in range(max(2, -(-60_000_000 // nbytes)))]
        x, ns, nb, w, b = sets[0]
        got, ref = dl.fused_norm_proj(x, ns, nb, w, b), dl.norm_proj_plain(x, ns, nb, w, b, 1e-5)
        torch.cuda.synchronize()
        xn = dl._norm_rows(x.float(), ns, nb, 1e-5).to(bf)
        err, ratio, wide = w8_limits(torch, got, ref, xn.float().abs() @ abs_panel(w)
                                     + b.float().abs(), True)
        name = "decode_norm_proj_w8" if group else "norm_qkv"
        held = decode_sm90_held(torch, lambda: dl.fused_norm_proj(x, ns, nb, w, b), got, 1,
                                group is not None)
        at[name] = row(name, f"M={M} E={E} N={N}{glabel}", err, ratio, lim_bf16,
                       timed(lambda x, ns, nb, w, b: dl.fused_norm_proj(x, ns, nb, w, b),
                             lambda x, ns, nb, w, b: dl.norm_proj_plain(x, ns, nb, w, b, 1e-5),
                             None, Rotation(sets), union=True),
                       bound_ms(nbytes, 2 * M * E * N, peaks), limit_over_2ulp_share=wide, **held)
        ok &= at[name]["ok"]
        del sets

        # post_attn: every branch held, the four GELU combinations under
        # LayerNorm timed (the pythia-1b branches among them)
        for name, kw in POST_ATTN_BRANCHES:
            label = branch_label(name, kw) + suffix
            n_up = 2 if kw.get("swiglu") else 1
            nbytes = ((E * E + (n_up + 1) * E * Fh) * wbytes + scale_bytes(E, E)
                      + n_up * scale_bytes(E, Fh) + scale_bytes(Fh, E) + 3 * M * E * 2
                      + 2 * E * 4 + E * 2 + (0 if kw.get("swiglu") else (Fh + E) * 2))
            timed_case = not kw.get("rms") and not kw.get("swiglu")
            n_sets = max(2, -(-60_000_000 // nbytes)) if timed_case else 1
            sets = [post_attn_operands(make, panel, M, E, Fh, kw) for _ in range(n_sets)]
            got, ref = dl.fused_post_attn(*sets[0], **kw), branch_plain(sets[0], kw)
            torch.cuda.synchronize()
            err, ratio, wide = w8_limits(torch, got, ref, post_attn_mag(torch, sets[0], kw), True)
            held = decode_sm90_held(torch, lambda kw=kw: dl.fused_post_attn(*sets[0], **kw), got,
                                    3, group is not None)
            shape = (f"M={M} E={E} F={Fh}{glabel} " + ("RMSNorm" if kw.get("rms") else "LN")
                     + (" SwiGLU" if kw.get("swiglu") else
                        " exact GELU" if kw.get("exact_gelu") else " tanh GELU")
                     + (" parallel" if kw.get("parallel_residual") else " sequential"))
            if timed_case:
                t = timed(lambda *a, kw=kw: dl.fused_post_attn(*a, **kw),
                          lambda *a, kw=kw: branch_plain(a, kw), None, Rotation(sets), n=20,
                          union=True)
            else:
                t = dict.fromkeys(("kernel", "kernel_event", "plain", "plain_event", "library",
                                   "library_event"))
            res = row(label, shape, err, ratio, lim_bf16, t,
                      bound_ms(nbytes, 2 * M * (E * E + (n_up + 1) * E * Fh), peaks),
                      limit_over_2ulp_share=wide, launches_per_call=4, **held)
            ok &= res["ok"]
            if label in NEOX_KERNELS:
                rows[label] = res
            del sets
        torch.cuda.empty_cache()

    # fp32 activations at a small aligned shape: per element within 1e-5 of
    # the fp32 addends' magnitudes (fp32 weights; W8A16 with 128-row groups
    # and with one group per panel, the down panel's spanning two chunks)
    Es, Fs = 256, 1280
    for group in (None, 128, "one"):
        def pnl(K, N, group=group):
            if group is None:
                return make(K, N, std=0.02, dtype="fp32")
            return w8_panels(torch, g, K, N, K if group == "one" else group, 1)[0]

        def make32(*shape, std=1.0, dtype=None):
            return make(*shape, std=std, dtype="fp32")

        wlabel = "fp32 weights" if group is None else f"W8 g={'K' if group == 'one' else group}"
        for name, kw in POST_ATTN_BRANCHES:
            args = post_attn_operands(make32, pnl, 3, Es, Fs, kw)
            got, ref = dl.fused_post_attn(*args, **kw), branch_plain(args, kw)
            err, ratio, _ = w8_limits(torch, got, ref, post_attn_mag(torch, args, kw), False)
            emit(dict(phase="kernels_neox_fp32", name=branch_label(name, kw),
                      shape=f"M=3 E={Es} F={Fs} fp32, {wlabel}", max_err=err,
                      err_over_limit=ratio, ok=ratio <= 1.0,
                      limit="1e-5 x the fp32 addends' magnitudes per element"))
            ok &= ratio <= 1.0

    # the GELU form where the two forms part: bf16 at pythia-1b's shape,
    # fp32 at the small one, full width and W8
    for group in (None, 128):
        ok &= gelu_probe(torch, g, M, E, Fh, bf, group, (-3.2, -2.6))
        ok &= gelu_probe(torch, g, 3, Es, Fs, torch.float32, group, (2.3, 3.2))

    # decode, paged and flash attention at D=256 (H = KV = 8)
    at.update(attention_rows(torch, F, peaks, g, NEOX_H, NEOX_H, NEOX_D, "kernels_neox"))
    ok &= all(at[k]["ok"] for k in ("decode_attention", "paged_attention",
                                    "flash_attention_fwd"))

    # the w8 matmul on pythia-1b's panels at M=8 (the int8 unfused ticks)
    at["w8a16_matmul"] = []
    for K, N in PANELS_PYTHIA_1B:
        panels = w8_panels(torch, g, K, N, 128, -(-60_000_000 // (K * N)))
        sets = [(make(M, K), c, sc) for c, sc in panels]
        held = w8_matmul_held(torch, *sets[0])
        err, ratio = held.pop("max_err"), held.pop("err_over_limit")
        res = row("w8a16_matmul", f"M={M} K={K} N={N} g=128", err, ratio,
                  "w8_limits: 1e-5 x |x| @ |dequant W| per element (plain, tiled, fp64)",
                  timed(wm.w8a16_matmul_kernel, wm.w8a16_matmul_plain, None, Rotation(sets)),
                  bound_ms(K * N + K // 128 * N * 4 + M * K * 2 + M * N * 4, 2 * M * K * N,
                           peaks), **held)
        ok &= res["ok"]
        at["w8a16_matmul"].append(res)
        del sets, panels
    torch.cuda.empty_cache()
    return rows, at, ok


# ---------------------------------------------------------------------------
# the bf16 decode-layer kernels on the tensor cores (rows 6-7)
# ---------------------------------------------------------------------------

DECODE_SM90_LIMIT = ("w8_limits per element (1 bf16 ulp of the plain value + 1e-5 x the fp32 "
                     "addends' magnitudes + half a bf16 ulp of the row's largest output), "
                     "against the plain version and against the fp64 value with the same "
                     "bf16 casts; identical bits on a second call")


def decode_sm90_held(torch, call, got, n_gemv: int, quant: bool) -> dict:
    """A bf16 rows 6-7 call made again: identical bits, and the library's own
    launch counts for it (``decode_layer.kernel_launches``): ``n_gemv``
    launches of the tensor-core GEMV (its W8A16 instantiations with
    ``quant``), one of the norm's, none of the CUDA-core GEMV."""
    from deepspeed_tpu_torch.ops import decode_layer as dl

    before = dl.kernel_launches()
    again = call()
    torch.cuda.synchronize()
    after = dl.kernel_launches()
    ran = {k: after[k] - before[k] for k in after}
    want = {"gemv_sm90_kernel": 0 if quant else n_gemv, "gemv_sm90_kernel_w8": n_gemv if quant
            else 0, "norm_rows_kernel": 1, "rows_gemv_kernel": 0}
    return dict(bitwise_repeat=bool(torch.equal(got, again)), sm90_launches=ran,
                sm90_ok=ran == want)


def decode_fp64(torch, kind: str, args, kw: dict):
    """The decode-layer function in fp64 with the kernels' bf16 casts (the
    normalised rows, h, the output): the value two correct fp32 orders of
    summation round around. ``args``: norm_proj's (x, ns, nb, w, b) or
    post_attn's (y, x, wo, bo, ns, nb, mlp); weights dense or W8A16 pairs."""
    from deepspeed_tpu_torch.ops import decode_layer as dl

    def dot(a, w):
        if isinstance(w, tuple):
            codes, scale = w
            w = codes.double() * scale.double().repeat_interleave(
                codes.shape[0] // scale.shape[0], 0)
        return a.double() @ w.double()

    def vec(v, like):
        return torch.zeros_like(like) if v is None else v.double()

    rms = kw.get("rms", False)
    if kind == "norm_proj":
        x, ns, nb, w, b = args
        cdt = x.dtype
        xn = dl._norm_rows(x.double(), ns.double(), vec(nb, ns.double()), 1e-5, rms).to(cdt)
        return (dot(xn, w) + b.double()).to(cdt)
    y, x, wo, bo, ns, nb, mlp = args
    cdt = x.dtype
    r1 = (x.double() + dot(y, wo)) + bo.double()
    src = x.double() if kw.get("parallel_residual") else r1
    hin = dl._norm_rows(src, ns.double(), vec(nb, ns.double()), 1e-5, rms).to(cdt)
    if kw.get("swiglu"):
        wg, wu, wd = mlp
        gate = dot(hin, wg)
        h = (gate * torch.sigmoid(gate) * dot(hin, wu)).to(cdt)
        return (r1 + dot(h, wd)).to(cdt)
    w1, b1, w2, b2 = mlp
    gelu = dl.gelu_exact if kw.get("exact_gelu") else dl.gelu_tanh
    h = gelu(dot(hin, w1) + b1.double()).to(cdt)
    return ((r1 + dot(h, w2)) + b2.double()).to(cdt)


def unfused_chain(torch, F, kind: str, args, kw: dict):
    """The same function as separate PyTorch calls, timed beside the kernels
    and neither gated nor a yardstick: ``F.layer_norm`` or ``F.rms_norm``
    (in fp32, cast back), ``F.linear``-style products in bf16 (W8A16:
    dequantise, then ``matmul``), ``F.gelu`` / ``F.silu``, the residual adds."""
    from deepspeed_tpu_torch.ops import w8 as w8ops

    bf = torch.bfloat16

    def lin(a, w, b=None):
        wd = w8ops.dequantize_weight(*w, bf) if isinstance(w, tuple) else w
        out = a @ wd
        return out if b is None else out + b

    def norm(a, ns, nb):
        E = a.shape[-1]
        if kw.get("rms"):
            return F.rms_norm(a.float(), (E,), ns, 1e-5).to(bf)
        return F.layer_norm(a.float(), (E,), ns, nb, 1e-5).to(bf)

    if kind == "norm_proj":
        x, ns, nb, w, b = args
        return lin(norm(x, ns, nb), w, b)
    y, x, wo, bo, ns, nb, mlp = args
    r1 = x + lin(y, wo, bo)
    hin = norm(x if kw.get("parallel_residual") else r1, ns, nb)
    if kw.get("swiglu"):
        wg, wu, wd = mlp
        return r1 + lin(F.silu(lin(hin, wg)) * lin(hin, wu), wd)
    w1, b1, w2, b2 = mlp
    h = F.gelu(lin(hin, w1, b1), approximate="none" if kw.get("exact_gelu") else "tanh")
    return r1 + lin(h, w2, b2)


DECODE_SM90_ROWS = (1, 8, 13, 64)
# norm_proj at pythia-1b's qkv (LayerNorm) and llama-1b's q and k/v (RMSNorm)
DECODE_SM90_NORM_PROJ = (("norm_proj_ln", 6144, {}), ("norm_proj_rms", 2048, dict(rms=True)),
                         ("norm_proj_rms", 256, dict(rms=True)))


def run_kernels_decode_sm90(torch, F, peaks, timed=True):
    """The bf16 decode-layer kernels (``csrc/decode_gemv_sm90.cuh``) at
    llama-1b's and pythia-1b's widths (E=2048, F=8192; norm_proj at N=6144,
    2048 and 256): every branch (norm_proj LayerNorm and RMSNorm; post_attn's
    nine flag combinations of :data:`POST_ATTN_BRANCHES`) with bf16 weights
    and W8A16 (128-row groups and one group), at M = 1, 8, 13 and 64 decode
    rows. Each case within ``w8_limits`` of the plain version and of the
    fp64 value with the same casts, bit-identical on a second call, and run
    by the tensor-core GEMV and the norm's kernel alone (the library's own
    counts); with ``timed``, timed (device ms as the union of the call's
    kernels) beside the unfused PyTorch chain, which is neither gated nor a
    yardstick. Returns whether all held."""
    from deepspeed_tpu_torch.ops import decode_layer as dl

    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    bf = torch.bfloat16
    E, Fh = NEOX_E, NEOX_F
    ok = True

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    for wkind in ("bf16", "w8_g128", "w8_one_group"):
        cache = {}

        def panel(K, N, tag, wkind=wkind, cache=cache):
            if (K, N, tag) not in cache:
                if wkind == "bf16":
                    cache[(K, N, tag)] = rn(K, N, std=0.02)
                else:
                    cache[(K, N, tag)] = w8_panels(torch, g, K, N,
                                                   128 if wkind == "w8_g128" else K, 1)[0]
            return cache[(K, N, tag)]

        quant = wkind != "bf16"
        ns, nb = 1 + rn(E, std=0.1, dtype=torch.float32), rn(E, std=0.1, dtype=torch.float32)
        cases = [("norm_proj", name, N, kw) for name, N, kw in DECODE_SM90_NORM_PROJ]
        cases += [("post_attn", branch_label(name, kw), Fh, kw) for name, kw in POST_ATTN_BRANCHES]
        for M in DECODE_SM90_ROWS:
            for kind, name, N, kw in cases:
                rms = kw.get("rms", False)
                if kind == "norm_proj":   # RMSNorm: no norm bias, a zero bias (llama-1b)
                    args = (rn(M, E), ns, None if rms else nb, panel(E, N, "qkv"),
                            torch.zeros(N, dtype=bf, device="cuda") if rms else rn(N, std=0.02))

                    def call(args=args, kw=kw):
                        return dl.fused_norm_proj(*args, rms=kw.get("rms", False))

                    def plain(args=args, kw=kw):
                        x, ns_, nb_, w, b = args
                        return dl.norm_proj_plain(x, ns_, 0 * ns_ if nb_ is None else nb_, w, b,
                                                  1e-5, kw.get("rms", False))
                    x_, ns_, nb_, w_, b_ = args
                    xn = dl._norm_rows(x_.float(), ns_, 0.0 if nb_ is None else nb_, 1e-5,
                                       rms).to(bf)
                    mag = xn.float().abs() @ abs_panel(w_) + b_.float().abs()
                    groups = E // 128 if wkind == "w8_g128" else 1
                    nbytes = (E * N * (1 if quant else 2) + M * E * 2 + M * N * 2 + E * 8
                              + (groups * N * 4 if quant else 0))
                    flops, n_gemv = 2 * M * E * N, 1
                else:
                    mlp = ((panel(E, Fh, "up"), panel(E, Fh, "up2"), panel(Fh, E, "down"))
                           if kw.get("swiglu") else
                           (panel(E, Fh, "up"), rn(Fh, std=0.02), panel(Fh, E, "down"),
                            rn(E, std=0.02)))
                    args = (rn(M, E), rn(M, E), panel(E, E, "o"), rn(E, std=0.02), ns,
                            None if rms else nb, mlp)

                    def call(args=args, kw=kw):
                        return dl.fused_post_attn(*args, **kw)

                    def plain(args=args, kw=kw):
                        return branch_plain(args, kw)
                    mag = post_attn_mag(torch, args, kw)
                    n_up = 2 if kw.get("swiglu") else 1
                    gb = (lambda K, N: 0) if not quant else (
                        lambda K, N: (K // 128 if wkind == "w8_g128" else 1) * N * 4)
                    nbytes = ((E * E + (n_up + 1) * E * Fh) * (1 if quant else 2) + gb(E, E)
                              + n_up * gb(E, Fh) + gb(Fh, E) + 3 * M * E * 2 + E * 8)
                    flops, n_gemv = 2 * M * (E * E + (n_up + 1) * E * Fh), 3
                got, ref = call(), plain()
                torch.cuda.synchronize()
                err, ratio, _ = w8_limits(torch, got, ref, mag, True)
                exact = decode_fp64(torch, kind, args, kw)
                _, ratio64, _ = w8_limits(torch, got, exact, mag, True)
                _, plain64, _ = w8_limits(torch, ref, exact, mag, True)
                held = decode_sm90_held(torch, call, got, n_gemv, quant)
                sum_ms, union_ms = device_union_ms(torch, call, 10) if timed else (None, None)
                chain_ms = device_ms(torch, lambda args=args, kind=kind, kw=kw: unfused_chain(
                    torch, F, kind, args, kw), 10) if timed else None
                b_ms, b_by = bound_ms(nbytes, flops, peaks)
                res = dict(phase="kernels_decode_sm90", name=name + ("_w8" if quant else ""),
                           shape=f"M={M} E={E} " + ("N" if kind == "norm_proj" else "F")
                           + f"={N} {wkind}", max_err=err, err_over_limit=ratio,
                           kernel_vs_fp64_over_limit=ratio64, plain_vs_fp64_over_limit=plain64,
                           limit=DECODE_SM90_LIMIT, **held, kernel_ms=union_ms,
                           kernel_sum_ms=sum_ms, unfused_chain_ms=chain_ms,
                           bound_ms=b_ms, bound_by=b_by)
                res["ok"] = bool(ratio <= 1.0 and ratio64 <= 1.0 and held["bitwise_repeat"]
                                 and held["sm90_ok"] and torch.isfinite(got).all())
                emit(res)
                ok &= res["ok"]
        del cache
        torch.cuda.empty_cache()
    return ok


def decode_sm90_build(log: str, match: str = "gemv90") -> list:
    """Each kernel whose symbol holds ``match`` (the tensor-core decode GEMV
    by default), with its registers, static shared memory and spill bytes
    (stores + loads), from a library's ``-Xptxas -v`` build log."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(symbol=m.group(1)) if match in m.group(1) else None
            if cur:
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return rows


def run_serve_neox(torch, out_dir=None):
    """pythia-1b (E=2048, 16 layers, 8 heads, D=256, F=8192, rotary_pct
    0.25, vocab 50432, untied head; full size, random weights from seed
    1234) served through ``init_inference(max_tokens=512)`` in bf16 and in
    W8A16 from the same weights: the batcher with page-resident KV (16-token
    pages, 8 slots) on the serve phase's 32 requests twice each;
    ``engine(ids)`` at B=2, S=1024 (the flash forward at D=256); ``generate``
    (B=8, prompt 256, 64 new) with the fused decode kernels on and off
    (decode attention at D=256); then the sequential-residual variant at
    pythia-1b's widths and 2 layers, one fused ``generate`` in each dtype.
    Gates: exact launch counts (per single-token forward and layer: one
    LayerNorm -> qkv kernel, one exact-GELU parallel post_attn call, one
    paged attention; the w8 matmul as the prefill chunks imply), no leaks,
    the dense bytes (int8 / bf16 = 33/64), the forward (B=1, S=128) within 8
    bf16 ulps of a CPU fp32 engine holding each card engine's own weights,
    the int8-vs-bf16 logits' relative RMS <= 0.1, the sampling step on the
    card, seeded sampling, and every greedy stream teacher-forced through an
    fp32 engine on the card holding the same weights (tie-aware >= 99%, the
    argmax wherever its top two lie more than 16 ulps apart; the strict
    share printed), as ``run_serve_llama`` gates them."""
    from collections import Counter

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gptneox import GPTNeoXForCausalLM, gptneox_config

    cfg = gptneox_config("pythia-1b")
    L, V = cfg.n_layer, cfg.vocab_size
    t0 = time.perf_counter()
    model = GPTNeoXForCausalLM(cfg).init_weights(torch.Generator().manual_seed(SEED))
    init_s = time.perf_counter() - t0
    engines, resident, checks = {}, {}, {}
    for label, kw in (("bf16", {}), ("w8", dict(quant=W8))):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        engines[label] = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512, **kw)
        torch.cuda.synchronize()
        resident[label] = torch.cuda.memory_allocated() - m0
    n_params = sum(p.numel() for p in model.parameters())
    del model                    # the engines hold their own copies
    dense8, dense16 = (dense_weight_bytes(engines[k].module) for k in ("w8", "bf16"))
    E, F = cfg.hidden_size, cfg.intermediate_size
    n_dense = L * (4 * E * E + 2 * E * F)     # qkv (E, 3E), dense (E, E), h_to_4h, 4h_to_h
    # int8 codes + one fp32 scale per 128 rows: (1 + 4/128) / 2 = 33/64 of bf16's bytes
    checks["dense_bytes_ratio"] = dense16 == 2 * n_dense and 64 * dense8 == 33 * dense16
    checks["rotary_cache_len"] = engines["bf16"].cache_len == engines["bf16"]._gen_limit == 512
    checks["params"] = n_params == 1_012_305_920
    norms = [p for n, p in engines["bf16"].module.named_parameters() if "_ln." in n]
    checks["norms_fp32"] = all(p.dtype == torch.float32 for p in norms)
    emit(dict(phase="serve_neox_weights", model="pythia-1b", init_s=init_s, params=n_params,
              dense_elements=n_dense, dense_weight_bytes_w8=dense8,
              dense_weight_bytes_bf16=dense16, dense_ratio=dense8 / dense16,
              resident_bytes=resident, resident_ratio=resident["w8"] / resident["bf16"],
              cache_len=engines["bf16"].cache_len, head_dim=cfg.head_dim,
              rotary_dim=cfg.rotary_dim))

    reqs = serve_requests(V)
    by_path, served = {}, {}
    for label, e in engines.items():
        q = label == "w8"
        w8 = "_w8" if q else ""
        path = f"serve_neox{w8}_paged"
        batcher = ds.ContinuousBatcher(e, n_slots=8, seed=SEED,
                                       prefix_cache={"page_tokens": 16, "n_pages": 512})
        zero_counts()
        chunks0 = Counter(batcher.prefill_chunks)
        outs, passes = [], []
        for _ in range(2):
            o, nums = serve_pass(torch, batcher, reqs)
            outs.append(o)
            passes.append(nums)
        launches = read_counts()
        by_path[path] = launches
        chunks = batcher.prefill_chunks - chunks0
        singles = sum(p["ticks"] + p["one_token_prefills"] for p in passes)
        expected = {n: 0 for n in launches}
        expected.update({"paged_attention": L * singles,
                         "decode_norm_proj_w8" if q else "norm_qkv": L * singles,
                         "post_attn_erf_par" + w8: L * singles,
                         "w8a16_matmul": chunk_launches(chunks, NEOX_DENSE_PER_LAYER * L)
                         if q else 0})
        prof = serve_profile(torch, batcher, reqs,
                             out_dir and os.path.join(out_dir, f"profile_{path}.txt"))
        run_checks = {
            "launch_counts": launches == expected,
            "no_leaks": all(v == 0 for p in passes for v in p["leaks"].values())
            and all(v == 0 for v in batcher.leak_counts().values()),
            "shapes_and_vocab": all(len(o) == len(r["prompt"]) + r["max_new_tokens"]
                                    and int(o.max()) < V for op in outs for o, r in zip(op, reqs)),
            "pass2_hits": passes[1]["hit_tokens"] > 0}
        samp = sampling_check(torch, e, reqs, outs[0], phase="serve_neox_sampling")
        run_checks["sampling_card_vs_cpu"] = samp["ok"]
        served[label] = [(o_pass[i], len(reqs[i]["prompt"]))
                         for o_pass in outs for i in range(0, len(reqs), 2)]
        emit(dict(phase="serve_neox", path=path, model="pythia-1b", dtype="bfloat16",
                  quant="int8 W8A16" if q else None, n_slots=8, requests=len(reqs),
                  prefix_cache={"page_tokens": 16, "n_pages": 512}, passes=passes,
                  profile=prof, resident_weight_bytes=resident[label],
                  prefill_chunks={f"{B}x{S}": n for (B, S), n in sorted(chunks.items())},
                  launches=launches, expected_launches=expected, checks=run_checks))
        checks.update({f"{path}_{k}": v for k, v in run_checks.items()})
        del batcher

    # the forward against CPU fp32 engines holding each card engine's own
    # weights (bf16 values, int8 codes); the same weights in an fp32 engine
    # on the card, held against the CPU's, are the reference the greedy
    # streams are teacher-forced through
    ids = torch.randint(0, V, (1, 128), generator=torch.Generator().manual_seed(SEED + 6))
    with torch.device("meta"):
        template = GPTNeoXForCausalLM(cfg)
    fp32_card, gates = {}, {}
    for label, e in engines.items():
        kw = dict(quant=W8) if label == "w8" else {}
        state = {k: v.detach().cpu() for k, v in e.module.state_dict().items()}
        cpu = ds.init_inference(template, params=state, dtype=torch.float32, max_tokens=512,
                                device="cpu", **kw)
        ref = cpu(ids)[..., :V].float()
        del cpu
        fp32_card[label] = ds.init_inference(template, params=state, dtype=torch.float32,
                                             max_tokens=512, **kw)
        del state
        card = e(ids)[..., :V].float().cpu()
        card32 = fp32_card[label](ids)[..., :V].float().cpu()
        err = float((card - ref).abs().max())
        tol = 8 * bf16_ulp(float(ref.abs().max()))
        err32 = float((card32 - ref).abs().max())
        top1 = float((card.argmax(-1) == ref.argmax(-1)).float().mean())
        tf = teacher_forced(torch, fp32_card[label], served[label], V)
        tf_self = teacher_forced(torch, e, served[label], V)
        gates[label] = dict(forward_max_err=err, forward_tol=tol, forward_top1=top1,
                            fp32_card_vs_cpu_max_err=err32,
                            teacher_forced_vs_fp32=tf, teacher_forced_vs_own_bf16_forward=tf_self)
        checks[f"forward_vs_cpu_fp32_{label}"] = err <= tol and bool(torch.isfinite(card).all())
        # fp32 in other orders over 16 layers: far below a bf16 ulp (2^-8 relative)
        checks[f"fp32_reference_vs_cpu_{label}"] = err32 <= 1e-3 * float(ref.abs().max())
        checks[f"greedy_teacher_forced_{label}"] = (tf["within_2ulp"] >= 0.99
                                                    and tf["decisive_strict"] == 1.0)
    l8, l16 = (engines[k](ids)[..., :V].float() for k in ("w8", "bf16"))
    rel_rms = float((l8 - l16).pow(2).mean().sqrt() / l16.pow(2).mean().sqrt())
    checks["int8_vs_bf16_rel_rms"] = rel_rms <= 0.1
    emit(dict(phase="serve_neox_checks", forward_shape=[1, 128], gates=gates,
              int8_vs_bf16_logits_rel_rms=rel_rms))

    # engine(ids) at B=2, S=1024: the flash forward at H=8, D=256
    eng16 = engines["bf16"]
    big = torch.randint(0, V, (2, 1024), generator=torch.Generator().manual_seed(SEED + 1))
    eng16(big[:, :128])
    fwd = {}
    zero_counts()
    for k in ("first", "again"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng16(big)
        torch.cuda.synchronize()
        fwd[k] = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    by_path["forward_neox"] = launches
    expected = {n: 0 for n in launches}
    expected["flash_attention_fwd"] = 2 * L
    checks["forward_launch_counts"] = launches == expected
    checks["forward_finite"] = bool(torch.isfinite(out[..., :V]).all())
    emit(dict(phase="forward_neox", shape=[2, 1024], forward_ms=fwd["first"],
              forward_again_ms=fwd["again"], launches=launches, expected_launches=expected))
    del out

    def run_generate(path, eg, prompt, new, ref, fused, w8, layers, post):
        """One timed greedy ``generate`` with its launches held against the
        ticks and its streams teacher-forced through ``ref``."""
        eg.generate(prompt[:, :32], max_new_tokens=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eg.generate(prompt, max_new_tokens=1)
        torch.cuda.synchronize()
        ttft = (time.perf_counter() - t0) * 1e3
        zero_counts()
        t0 = time.perf_counter()
        out = eg.generate(prompt, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        by_path[path] = launches
        ticks = new - 1
        expected = {n: 0 for n in launches}
        expected["decode_attention"] = layers * ticks
        if fused:
            expected["decode_norm_proj_w8" if w8 else "norm_qkv"] = layers * ticks
            expected[post + w8] = layers * ticks
        elif w8:
            expected["w8a16_matmul"] = NEOX_DENSE_PER_LAYER * layers * ticks
        n0 = prompt.shape[1]
        ok_path = (launches == expected and tuple(out.shape) == (prompt.shape[0], n0 + new)
                   and int(out.max()) < V)
        tf = teacher_forced(torch, ref, [(s, n0) for s in out], V)
        checks[f"{path}_launch_counts"] = ok_path
        emit(dict(phase="generate_neox", path=path, shape=[prompt.shape[0], n0, new],
                  ttft_ms=ttft, generate_ms=wall, ms_per_tick=(wall - ttft) / ticks,
                  decode_tokens_per_s=prompt.shape[0] * ticks / ((wall - ttft) / 1e3),
                  launches=launches, expected_launches=expected, teacher_forced_vs_fp32=tf,
                  ok=ok_path))
        return out, tf

    # generate with the fused decode kernels on and off, bf16 and int8 (the
    # unfused engines hold the same weights); each path's greedy streams
    # teacher-forced through the fp32 reference
    prompt = torch.randint(0, V, (8, 256), generator=torch.Generator().manual_seed(SEED + 7))
    new, compare = 64, {}
    for label, e in engines.items():
        w8 = "_w8" if label == "w8" else ""
        state = {k: v.detach() for k, v in e.module.state_dict().items()}
        unfused = ds.init_inference(template, params=state, dtype=torch.bfloat16,
                                    max_tokens=512, decode_fused=False,
                                    **(dict(quant=W8) if w8 else {}))
        del state
        gen = {}
        for fused, eg in ((True, e), (False, unfused)):
            path = f"generate_neox{w8}_{'fused' if fused else 'unfused'}"
            gen[fused], _ = run_generate(path, eg, prompt, new, fp32_card[label], fused, w8, L,
                                         "post_attn_erf_par")
        compare[f"greedy_tokens_equal{w8}_fused_vs_unfused"] = float(
            (gen[True][:, 256:] == gen[False][:, 256:]).float().mean())
        del unfused, gen
        torch.cuda.empty_cache()
    # seeded sampling repeats through the fused ticks
    s1 = eng16.generate(prompt[:, :64], max_new_tokens=32, temperature=0.8, top_p=0.9, seed=7)
    s2 = eng16.generate(prompt[:, :64], max_new_tokens=32, temperature=0.8, top_p=0.9, seed=7)
    checks["sampled_generate_repeats"] = bool(torch.equal(s1, s2)) and int(s1.max()) < V
    emit(dict(phase="generate_neox_compare", **compare))
    del engines, eng16, fp32_card
    torch.cuda.empty_cache()

    # the sequential residual (use_parallel_residual=False) at pythia-1b's
    # widths, depth cut to 2: one fused generate per dtype launches the
    # exact-GELU sequential branches on a path
    seq_cfg = gptneox_config("pythia-1b", use_parallel_residual=False, num_hidden_layers=2)
    seq_model = GPTNeoXForCausalLM(seq_cfg).init_weights(torch.Generator().manual_seed(SEED))
    with torch.device("meta"):
        seq_template = GPTNeoXForCausalLM(seq_cfg)
    for label, kw in (("bf16", {}), ("w8", dict(quant=W8))):
        w8 = "_w8" if kw else ""
        eg = ds.init_inference(seq_model, dtype=torch.bfloat16, max_tokens=512, **kw)
        # the fp32 reference holds the engine's own weights (bf16 values, int8 codes)
        state = {k: v.detach() for k, v in eg.module.state_dict().items()}
        ref = ds.init_inference(seq_template, params=state, dtype=torch.float32, max_tokens=512,
                                **kw)
        del state
        _, tf = run_generate(f"generate_neox_seq{w8}_fused", eg, prompt[:, :128], 32, ref, True,
                             w8, seq_cfg.n_layer, "post_attn_erf")
        checks[f"generate_neox_seq{w8}_teacher_forced"] = (tf["within_2ulp"] >= 0.99
                                                           and tf["decisive_strict"] == 1.0)
        del eg, ref
    del seq_model
    torch.cuda.empty_cache()
    emit(dict(phase="serve_neox_summary", checks=checks))
    return by_path, all(checks.values())


# ---------------------------------------------------------------------------
# serve_graph_parity phase
# ---------------------------------------------------------------------------

# the families at full width, cut to two layers: (label, models module,
# config function, preset, model class)
GRAPH_PARITY_MODELS = (("gpt2", "gpt2", "gpt2_config", "gpt2-125m", "GPT2LMHeadModel"),
                       ("llama", "llama", "llama_config", "llama-1b", "LlamaForCausalLM"),
                       ("neox", "gptneox", "gptneox_config", "pythia-1b",
                        "GPTNeoXForCausalLM"))
GRAPH_PARITY_LAYERS = 2
# the kernels a decode tick can run (rows 4-8 and row 11's mma.sync forward)
TICK_KERNELS = ("decode_attention", "paged_attention", "norm_qkv", "post_attn",
                "w8a16_matmul", "decode_norm_proj_w8", "decode_post_attn_w8",
                "norm_proj_rms", "post_attn_swiglu", "norm_proj_rms_w8", "post_attn_swiglu_w8",
                "post_attn_erf_par", "post_attn_erf_par_w8", "fused_mlp_fwd")


def graph_launches(graphs) -> dict:
    """Each captured graph's launches per replay and replays, by counter name."""
    names = {id(k): n for n, k in counters().items()}
    return [dict(capture_s=g.capture_s, replays=g.replays, edges=g.edges,
                 per_replay={names.get(id(k), k.symbol): d for k, d in g.launches.kernels.items()})
            for g in graphs if g.launches is not None]


def run_serve_graph_parity(torch):
    """Each family at full width and two layers (gpt2-125m, llama-1b,
    pythia-1b; random weights from the seed), bf16 and W8A16, served by
    the batcher with its decode windows as CUDA-graph replays and again
    with the eager window, page-resident and with contiguous slots, 12 of
    the serve requests (sampled rows 8-23 new tokens, greedy rows 24-39, so
    that windows run both the sampled and the greedy-pool graph), then
    ``generate`` (B=8, prompt 64, 24 new) greedy and sampled with
    ``compiled_loop`` True and False, and with ``decode_fused=False`` (the
    W8 matmul's ticks; GPT-2 with ``fused_mlp=True``: the 8-row ticks of the
    fused FFN's ``mma.sync`` forward). Gates: the two paths' tokens
    identical bit for bit, and their launch counts equal kernel by kernel
    (the graph run's: its eager prefills and first ticks, and each graph's
    launches per replay times its replays). Both walls printed, and each
    graph's capture time, replays and (bf16 fused ticks) the programmatic
    edges that stream capture kept of the GEMV's dependent launches."""
    import importlib

    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.inference.graphs import DecodeGraph

    ok = True
    pages = {"page_tokens": 16, "n_pages": 512}
    for family, mod, cfg_fn, preset, cls in GRAPH_PARITY_MODELS:
        m = importlib.import_module(f"deepspeed_tpu_torch.models.{mod}")
        layer_key = "n_layer" if family == "gpt2" else "num_hidden_layers"
        variants = [({}, {})]
        if family == "gpt2":   # the fused FFN's 8-row forward on unfused ticks
            variants.append(({"fused_mlp": True}, {"decode_fused": False}))
        for cfg_kw, eng_kw in variants:
            cfg = getattr(m, cfg_fn)(preset, **{layer_key: GRAPH_PARITY_LAYERS}, **cfg_kw)
            model = getattr(m, cls)(cfg).init_weights(torch.Generator().manual_seed(SEED))
            V = cfg.vocab_size
            # sampled rows short, greedy rows long: the windows after the
            # sampled rows retire are greedy-only and take the other graph
            reqs = [dict(r, max_new_tokens=(8 if i % 2 else 24) + r["max_new_tokens"] % 16)
                    for i, r in enumerate(serve_requests(V)[:12])]
            prompt = torch.randint(0, V, (8, 64), generator=torch.Generator().manual_seed(SEED))
            dtypes = (("bf16", {}),) if cfg_kw else (("bf16", {}), ("w8", dict(quant=W8)))
            for dlabel, qkw in dtypes:
                unfused = [{}] if eng_kw else [{}, {"decode_fused": False}]
                for ekw in unfused:
                    ekw = {**ekw, **eng_kw}
                    eng = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512,
                                            **qkw, **ekw)
                    label = f"{family}{'_fused_mlp' if cfg_kw else ''}_{dlabel}" + (
                        "_unfused" if ekw.get("decode_fused") is False else "")
                    edges = dlabel == "bf16" and not ekw
                    DecodeGraph.inspect_edges = edges
                    try:
                        ok &= graph_parity_engine(torch, np, ds, eng, label, reqs, prompt,
                                                  pages, serve=not ekw)
                    finally:
                        DecodeGraph.inspect_edges = False
                    del eng
                    torch.cuda.empty_cache()
            del model
    return ok


def graph_parity_engine(torch, np, ds, eng, label, reqs, prompt, pages, serve=True) -> bool:
    """One engine's graph path against its eager path (see
    :func:`run_serve_graph_parity`); emits one line per path and returns
    whether every gate held."""
    ok = True
    runs = []
    if serve:
        for mode, pc in (("paged", pages), ("contiguous", None)):
            res = {}
            for compiled in (True, False):
                b = ds.ContinuousBatcher(eng, n_slots=8, prefix_cache=pc, seed=SEED,
                                         compiled_loop=compiled)
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                uids = [b.submit(**r) for r in reqs]
                out = {}
                while len(out) < len(uids):
                    out.update(b.step(ticks=8))
                torch.cuda.synchronize()
                res[compiled] = dict(
                    tokens=[np.asarray(out[u]) for u in uids], launches=read_counts(),
                    wall_s=time.perf_counter() - t0, ticks=b.stats["ticks"],
                    windows=b.stats["windows"], leaks=b.leak_counts(),
                    graphs=graph_launches(b._graphs.values()))
                del b
            runs.append((f"serve_{mode}", res))
    for gen_label, kw in (("greedy", {}), ("sampled", dict(temperature=0.8, top_k=50,
                                                          top_p=0.9, seed=7))):
        res = {}
        for compiled in (True, False):
            eng._graphs.clear()   # each run pays its own capture
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.generate(prompt, max_new_tokens=24, compiled_loop=compiled, **kw)
            torch.cuda.synchronize()
            res[compiled] = dict(tokens=[out.cpu().numpy()], launches=read_counts(),
                                 wall_s=time.perf_counter() - t0, ticks=23, windows=1,
                                 graphs=graph_launches(g for _, g in eng._graphs.values()))
        runs.append((f"generate_{gen_label}", res))
    for path, res in runs:
        g, e = res[True], res[False]
        same = all(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(g["tokens"], e["tokens"]))
        tick = {k: n for k, n in e["launches"].items() if k in TICK_KERNELS and n}
        replayed = sum(r["replays"] for r in g["graphs"])
        checks = {"tokens_identical": same, "launches_equal": g["launches"] == e["launches"],
                  "ticks_equal": (g["ticks"], g["windows"]) == (e["ticks"], e["windows"]),
                  "replays": replayed > 0 and len(tick) > 0
                  and all(any(k in r["per_replay"] for r in g["graphs"]) for k in tick)}
        if "leaks" in g:   # the batcher: its sampled and its greedy-pool graph
            checks["no_leaks"] = all(v == 0 for r in (g, e) for v in r["leaks"].values())
            checks["replays"] &= len(g["graphs"]) == 2 and all(r["replays"] > 0
                                                               for r in g["graphs"])
        emit(dict(phase="serve_graph_parity", engine=label, path=path,
                  graph_wall_s=g["wall_s"], eager_wall_s=e["wall_s"], ticks=g["ticks"],
                  windows=g["windows"], tick_launches=tick, graphs=g["graphs"],
                  checks=checks))
        ok &= all(checks.values())
    return ok


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def train_config(micro: int, gas: int, accum: str = "bf16") -> dict:
    """The JAX package's flagship GPT-2-125M training config (bench.py)."""
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
            "data_types": {"grad_accum_dtype": accum}, "steps_per_print": 1000000}


def text_like_ids(rng, rows: int, seq: int, vocab: int):
    """Token ids with a Zipf (s = 1.2) unigram skew, like text's, so that a
    few steps on a fixed batch have something to learn."""
    return ((rng.zipf(1.2, size=(rows, seq)) - 1) % vocab).astype("int64")


def grad_gate(torch, cfg):
    """One micro-batch (2 × 1024) of gradients: the fp32 engine through the
    flash kernels (merged, then split) against the fp32 engine on dense
    attention, and the bf16 engine against the fp32 dense one. Then one
    optimizer step of the bf16 engine at micro 2 × gas 2 with bf16
    gradient accumulation, as the train path runs, against the same step
    accumulating in fp32: grad_norm and each leaf's update."""
    import dataclasses

    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel

    ids = text_like_ids(np.random.default_rng(SEED + 7), 2, 1024, cfg.vocab_size)

    def grads(dtype, attn, mode=None):
        model = GPT2LMHeadModel(dataclasses.replace(cfg, dtype=dtype, attn_impl=attn),
                                device="meta")
        eng, *_ = ds.initialize(model=model, config=train_config(2, 1, "fp32"))
        eng.init_params()
        if mode:
            os.environ["DS_TPU_FLASH_BWD"] = mode
        try:
            zero_counts()
            _, g = eng._grads_of(eng._to_device({"input_ids": ids, "labels": ids}))
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            os.environ.pop("DS_TPU_FLASH_BWD", None)
        out = {n: x.float() for n, x in zip(eng._names, g)}
        del eng, g
        torch.cuda.empty_cache()
        return out, counts

    dense, dense_counts = grads(torch.float32, "jnp")
    flash, flash_counts = grads(torch.float32, "auto")
    split, split_counts = grads(torch.float32, "auto", "split")
    bf16, _ = grads(torch.bfloat16, "auto")

    ids4 = text_like_ids(np.random.default_rng(SEED + 9), 4, 1024, cfg.vocab_size)
    step = {}
    for accum in ("bf16", "fp32"):
        eng, *_ = ds.initialize(model=GPT2LMHeadModel(cfg, device="meta"),
                                config=train_config(2, 2, accum))
        eng.init_params()       # the same seeded weights for both
        before = [p.detach().clone() for p in eng._params]
        eng.train_batch({"input_ids": ids4, "labels": ids4})
        step[accum] = (float(eng.metrics["grad_norm"]), eng.metrics["lr"],
                       {n: p.detach() - b for n, p, b in zip(eng._names, eng._params, before)})
        del eng, before
        torch.cuda.empty_cache()
    (gn_b, lr, upd_b), (gn_f, _, upd_f) = step["bf16"], step["fp32"]
    E = cfg.n_embd

    def flat(upd):
        # the key-bias third of c_attn_bias has a zero gradient but for
        # rounding noise (softmax ignores a shift shared by a row), so its
        # Adam step's sign is noise in both: left out
        return torch.cat([torch.cat([u[:E], u[2 * E:]]) if n.endswith("c_attn_bias")
                          else u.flatten() for n, u in upd.items()])

    diff = (flat(upd_b) - flat(upd_f)).abs()
    upd_diff, flip_share = float(diff.max()), float((diff > lr / 2).float().mean())
    del diff, upd_b, upd_f

    def rel(a, b):
        return max(float((a[n] - b[n]).abs().max() / b[n].abs().max().clamp(min=1e-30))
                   for n in b)

    def min_cos(a, b):
        return min(float(torch.nn.functional.cosine_similarity(
            a[n].flatten(), b[n].flatten(), dim=0)) for n in b if b[n].abs().max() > 0)

    L = cfg.n_layer
    res = dict(flash_vs_dense_max_rel=rel(flash, dense), split_vs_merged_max_rel=rel(split, flash),
               bf16_vs_fp32_dense_min_cos=min_cos(bf16, dense),
               bf16_accum_grad_norm=gn_b, fp32_accum_grad_norm=gn_f,
               bf16_accum_update_flip_share=flip_share, bf16_accum_update_max_abs_diff=upd_diff,
               lr=lr,
               launches_merged=flash_counts, launches_split=split_counts,
               launches_dense=dense_counts)
    # fp32 through 12 layers, sums in another order (the merged dq with
    # atomics): 1e-3 of each leaf's largest gradient
    checks = {"flash_vs_dense": res["flash_vs_dense_max_rel"] <= 1e-3,
              "split_vs_merged": res["split_vs_merged_max_rel"] <= 1e-3,
              "bf16_vs_fp32_cos": res["bf16_vs_fp32_dense_min_cos"] >= 0.99,
              # each bf16 buffer element is rounded at most twice (2^-9
              # relative each), and the merged dq's atomics tip a few bf16
              # roundings run to run: the norm within 2^-7
              "bf16_accum_grad_norm": abs(gn_b / gn_f - 1) <= 2 ** -7,
              # Adam's first step is lr·(m̂/(√v̂+eps) + wd·p) with |m̂/(√v̂+eps)|
              # ≤ 1, about lr·sign(g): no element's step differs by more
              # than 2·lr, and by more than lr/2 only where rounding flipped
              # the sign of a sum that nearly cancels (a dropped or
              # mis-added micro-batch flips a large share): ≤ 1% of elements
              "bf16_accum_update_flips": flip_share <= 0.01,
              "bf16_accum_update_bound": upd_diff <= 2 * lr * (1 + 1e-3),
              "kernels_ran": (flash_counts["flash_attention_bwd_merged"] == L
                              and flash_counts["flash_attention_fwd"] == L
                              and split_counts["flash_attention_bwd_dq"] == L
                              and split_counts["flash_attention_bwd_dkv"] == L
                              and split_counts["flash_attention_bwd_merged"] == 0
                              and sum(dense_counts.values()) == 0)}
    emit(dict(phase="train_grad_gate", model="gpt2-125m", micro_batch=[2, 1024],
              accum_step="micro 2 x gas 2, bf16 compute", **res, checks=checks))
    return all(checks.values())


def run_train(torch, peaks, out_dir=None):
    """gpt2-125m through ``initialize`` at the flagship config: the gradient
    gate, 2 warm-up and 8 timed steps (launches zeroed before the timed run
    and read after it), one profiled step (its flash launches by kernel
    symbol: the tensor-core ones only), then split mode: a warm-up step, a
    counted step (wall ms; the tensor-core split pair by symbol) and a
    profiled one (device ms)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = gpt2_config("gpt2-125m", n_positions=1024, loss_chunk=1 << 30)
    ok = grad_gate(torch, cfg)
    micro, gas, S, L = 24, 4, 1024, cfg.n_layer
    model = GPT2LMHeadModel(cfg, device="meta")
    eng, opt, _, sched = ds.initialize(model=model, config=train_config(micro, gas))
    eng.init_params()
    ids = text_like_ids(np.random.default_rng(SEED + 8), micro * gas, S, cfg.vocab_size)
    batch = {"input_ids": ids, "labels": ids}
    t0 = time.perf_counter()
    warm = eng.train_batches(batch, 2, stacked=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = eng.train_batches(batch, 8, stacked=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in torch.cat([warm, losses])]
    tokens = 8 * micro * gas * S
    tok_s = tokens / wall
    per_step = {"flash_attention_fwd": L * gas, "flash_attention_bwd_merged": L * gas}
    expected = {n: 8 * per_step.get(n, 0) for n in launches}

    dev_batch = eng._to_device(batch)
    eng.train_batch(dev_batch)
    torch.cuda.synchronize()
    # the bf16 step's flash launches by kernel, as the C libraries count
    # them (a profile can lose kernel records): the tensor-core forward and
    # merged backward L·gas times each, no CUDA-core flash kernel
    before = fa.kernel_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        eng.train_batch(dev_batch)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    flash_launches = flash_launched(fa, before)
    want_flash = {n: L * gas if n in (FLASH_SM90["fwd"], FLASH_SM90["bwd"]) else 0
                  for n in flash_launches}
    by_name = device_ms_of(prof)
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    if out_dir:
        with open(os.path.join(out_dir, "profile_train_step.txt"), "w") as fh:
            fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))

    # split mode: one warm-up step, then a counted and timed step (its
    # launches by entry and by kernel symbol: the tensor-core split pair
    # L·gas times each, no CUDA-core flash kernel), then a profiled one
    os.environ["DS_TPU_FLASH_BWD"] = "split"
    try:
        eng.train_batch(dev_batch)
        torch.cuda.synchronize()
        zero_counts()
        before = fa.kernel_launches()
        t1 = time.perf_counter()
        split_loss = float(eng.train_batch(dev_batch))
        torch.cuda.synchronize()
        split_wall = (time.perf_counter() - t1) * 1e3
        split_launches = read_counts()
        split_flash = flash_launched(fa, before)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as sprof:
            eng.train_batch(dev_batch)
            torch.cuda.synchronize()
        split_dev = sum(device_ms_of(sprof).values())
    finally:
        os.environ.pop("DS_TPU_FLASH_BWD", None)
    split_expected = {n: {"flash_attention_fwd": L * gas, "flash_attention_bwd_dq": L * gas,
                          "flash_attention_bwd_dkv": L * gas}.get(n, 0) for n in split_launches}
    want_split_flash = {n: L * gas if n in (FLASH_SM90["fwd"], FLASH_SM90["dq"], FLASH_SM90["dkv"])
                        else 0 for n in split_flash}

    mfu = model.flops_per_token() * tok_s / peaks[1]
    timed = losses[2:]
    checks = {"losses_finite": all(math.isfinite(x) for x in losses + [split_loss]),
              "loss_falling": timed[-1] < timed[0] and losses[-1] < losses[0],
              "launch_counts": launches == expected,
              "split_launch_counts": split_launches == split_expected,
              "split_flash_kernel_launches": split_flash == want_split_flash,
              "flash_kernel_launches": flash_launches == want_flash,
              "grad_gate": ok}
    emit(dict(phase="train", model="gpt2-125m", config=train_config(micro, gas),
              loss_chunk=cfg.loss_chunk, dtype="bfloat16", batch=[micro * gas, S],
              warmup_s=warm_s, timed_steps=8, wall_s=wall, ms_per_step=wall * 1e3 / 8,
              tokens_per_s=tok_s, flops_per_token=model.flops_per_token(), mfu=mfu,
              max_memory_allocated_gb=peak_mem / 2 ** 30, losses=losses, split_step_loss=split_loss,
              split_step=dict(wall_ms=split_wall,
                              device_ms=split_dev if split_dev else "not measured",
                              flash_launches=split_flash),
              launches=launches, expected_launches=expected, split_launches=split_launches,
              profile=dict(step_wall_ms=prof_wall,
                           step_device_ms=dev_ms if dev_ms else "not measured",
                           device_busy_share=dev_ms / prof_wall if dev_ms else "not measured",
                           flash_launches=flash_launches,
                           top_device_ms={k[:90]: v for k, v in top}),
              checks=checks))
    del eng, opt
    torch.cuda.empty_cache()
    return ({"train": launches, "train_split": split_launches}, peak_mem / 2 ** 30,
            all(checks.values()))


def run_train_flash_precision(torch):
    """Whether the merged backward's bf16 p and ds cost training loss: gpt2-125m
    at ``grad_gate``'s config (micro 2 × gas 2, S=1024) from one seeded init,
    16 optimizer steps over 16 distinct seeded ``text_like_ids`` batches, in
    four runs: bf16 merged twice (the spread its dq reduce-add's order gives
    from run to run), bf16 split (p and ds fp32-grade, hi + lo) and the fp32
    engine. Prints every run's losses, each bf16 run's mean and max |ΔL| to
    fp32, the step-1 gradient (the first micro-batch, before any update)
    cosine of merged and split to fp32, and the launches by entry and by
    kernel symbol. Gates: losses finite and falling, launches exact. The
    finding (not a gate): merged's mean gap beyond split's, in units of the
    merged-versus-merged spread; past 2 it is a fault."""
    import dataclasses

    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = gpt2_config("gpt2-125m", n_positions=1024, loss_chunk=1 << 30)
    steps, micro, gas, S, L = 16, 2, 2, 1024, cfg.n_layer
    rng = np.random.default_rng(SEED + 11)
    batches = [text_like_ids(rng, micro * gas, S, cfg.vocab_size) for _ in range(steps)]
    n = L * gas * steps
    runs = {"merged": (torch.bfloat16, "merged"), "merged_again": (torch.bfloat16, "merged"),
            "split": (torch.bfloat16, "split"), "fp32": (torch.float32, "merged")}
    entries = {"merged": ("flash_attention_fwd", "flash_attention_bwd_merged"),
               "split": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    res, grads, checks, by_path = {}, {}, {}, {}
    t0 = time.perf_counter()
    for name, (dtype, mode) in runs.items():
        fp32 = dtype == torch.float32
        model = GPT2LMHeadModel(dataclasses.replace(cfg, dtype=dtype), device="meta")
        eng, *_ = ds.initialize(model=model,
                                config=train_config(micro, gas, "fp32" if fp32 else "bf16"))
        eng.init_params()   # the same seeded weights in every run
        os.environ["DS_TPU_FLASH_BWD"] = mode
        try:
            first = eng._to_device({"input_ids": batches[0][:micro], "labels": batches[0][:micro]})
            grads[name] = [g.float() for g in eng._grads_of(first)[1]]
            torch.cuda.synchronize()
            zero_counts()
            before = fa.kernel_launches()
            losses = [float(eng.train_batch({"input_ids": ids, "labels": ids})) for ids in batches]
            torch.cuda.synchronize()
            counts, flash = read_counts(), flash_launched(fa, before)
        finally:
            os.environ.pop("DS_TPU_FLASH_BWD", None)
        del eng, model
        torch.cuda.empty_cache()
        syms = FLASH_CUDA_CORE if fp32 else FLASH_SM90
        want = {e: n if e in entries[mode] else 0 for e in counts}
        ran = {syms[k] for k in (("fwd", "bwd") if mode == "merged" else ("fwd", "dq", "dkv"))}
        want_flash = {k: n if k in ran else 0 for k in flash}
        checks[f"{name}_launches"] = counts == want and flash == want_flash
        checks[f"{name}_losses_finite_and_falling"] = (
            all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and sum(losses[-4:]) < sum(losses[:4]))
        res[name] = dict(losses=losses, launches={k: v for k, v in counts.items() if v},
                         flash_launches=flash)
        by_path[name] = counts

    def cos(a, b):
        num = sum(float((x.double() * y.double()).sum()) for x, y in zip(a, b))
        den = (math.sqrt(sum(float(x.double().pow(2).sum()) for x in a))
               * math.sqrt(sum(float(y.double().pow(2).sum()) for y in b)))
        return num / den

    def min_leaf_cos(a, b):
        return min(float(torch.nn.functional.cosine_similarity(
            x.flatten(), y.flatten(), dim=0)) for x, y in zip(a, b) if y.abs().max() > 0)

    ref = res["fp32"]["losses"]
    for name in ("merged", "merged_again", "split"):
        gap = [abs(x - y) for x, y in zip(res[name]["losses"], ref)]
        res[name].update(mean_abs_dloss_to_fp32=sum(gap) / steps, max_abs_dloss_to_fp32=max(gap))
    for name in ("merged", "split"):
        res[name].update(step1_grad_cos_to_fp32=cos(grads[name], grads["fp32"]),
                         step1_grad_min_leaf_cos_to_fp32=min_leaf_cos(grads[name], grads["fp32"]))
    del grads
    spread = sum(abs(x - y) for x, y in zip(res["merged"]["losses"],
                                            res["merged_again"]["losses"])) / steps
    excess = res["merged"]["mean_abs_dloss_to_fp32"] - res["split"]["mean_abs_dloss_to_fp32"]
    in_spreads = excess / spread if spread > 0 else (0.0 if excess <= 0 else math.inf)
    emit(dict(phase="train_flash_precision", model="gpt2-125m", config=train_config(micro, gas),
              batch=[micro * gas, S], steps=steps, seconds=time.perf_counter() - t0, runs=res,
              merged_vs_merged_mean_abs_dloss=spread,
              merged_gap_beyond_split=excess, merged_gap_beyond_split_in_spreads=in_spreads,
              finding=("fault: merged's bf16 p and ds cost loss beyond twice the run-to-run "
                       "spread" if in_spreads > 2 else
                       "no loss cost beyond twice the run-to-run spread"),
              checks=checks))
    return {"train_flash_precision_" + k: v for k, v in by_path.items()}, all(checks.values())


# ---------------------------------------------------------------------------
# train_1p5b phase
# ---------------------------------------------------------------------------

def northstar_config(**model_overrides) -> dict:
    """The JAX package's north-star recipe (bench.py ``bench_northstar``):
    micro 2, gas 1, adamw8bit lr 1e-4 wd 0.1 (here with ``fused: true``),
    ZeRO stage 3 (one device: no sharding), no clipping."""
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
           "optimizer": {"type": "adamw8bit",
                         "params": {"lr": 1e-4, "weight_decay": 0.1, "fused": True}},
           "zero_optimization": {"stage": 3}, "steps_per_print": 1000000}
    if model_overrides:
        cfg["model_overrides"] = model_overrides
    return cfg


def optimizer_check(torch, eng, batch, peaks):
    """The fused update (one launch over the optimizer's leaf table a
    ``launches_per_step``) against the unfused chain from the engine's
    current state and its real gradients on ``batch``, and against one-leaf
    calls of the same kernel (``adam8bit_update``, a one-leaf table each)
    from the same state, which must give the same bits: one step each on
    copies, then their times (CUDA events, the host's time to enqueue one
    update, and the kernel's own device time), and the plain version's over
    the same leaves.

    Limits: the two formulas differ in their last bits (see
    ``ops/adam8bit.py``), so parameters agree within 1e-3 of one lr-sized
    step plus one fp32 ulp of the parameter (each rounds p − lr·upd to p's
    grid: 1.2e-7 at a LayerNorm scale of 1), codes differ by at most one on
    at most 0.1% of elements, scales within 1e-5 relative."""
    from deepspeed_tpu_torch.ops import adam8bit as a8

    opt = eng.optimizer
    _, grads = eng._grads_of(batch)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    runs = {}
    for fused in (True, False):
        params = [p.detach().clone() for p in eng._params]
        o = a8.Adam8bit(params, opt.lr, opt.b1, opt.b2, opt.eps, weight_decay=opt.weight_decay,
                        l2=opt.l2, clip=opt.clip, fused=fused, names=opt.names)
        o.load_state_dict(opt.state_dict())
        o.update(params, grads, norm)
        runs[fused] = (o, params)
    torch.cuda.synchronize()
    (of, pf), (ou, pu) = runs[True], runs[False]
    lr = float(opt.lr(opt.count))
    p_diff = max(float((a - b).abs().max()) for a, b in zip(pf, pu))
    # how far past one ulp of the parameter plus 1e-3·lr the worst element is
    p_excess = max(float(((a - b).abs() - 2.0 ** -23 * b.abs()).max()) for a, b in zip(pf, pu))
    code_diff, code_share, n = 0, 0.0, 0
    for cf, cu in zip(of.m_codes + of.r_codes, ou.m_codes + ou.r_codes):
        d = (cf.int() - cu.int()).abs()
        code_diff = max(code_diff, int(d.max()))
        code_share += float((d > 0).sum())
        n += d.numel()
    code_share /= n
    scale_rel = max(float(((sf[k] - su[k]).abs() / su[k]).max())
                    for sf, su in zip(of.scales, ou.scales) for k in "mr")
    checks = {"fused_vs_unfused_params": p_excess <= 1e-3 * lr,
              "fused_vs_unfused_codes": code_diff <= 1 and code_share <= 1e-3,
              "fused_vs_unfused_scales": scale_rel <= 1e-5}
    unfused_event = cuda_ms(torch, lambda: ou.update(pu, grads, norm), 3)
    del ou, pu
    runs.pop(False)
    torch.cuda.empty_cache()
    # the same step as one-leaf calls of the kernel, leaf by leaf
    p1 = [p.detach().clone() for p in eng._params]
    o1 = a8.Adam8bit(p1, opt.lr, opt.b1, opt.b2, opt.eps, weight_decay=opt.weight_decay,
                     l2=opt.l2, clip=opt.clip, fused=True, names=opt.names)
    o1.load_state_dict(opt.state_dict())
    gscale = o1._gscale(norm)
    c1, c2 = a8._bias_corrections(opt.b1, opt.b2, opt.count + 1)
    sc1 = torch.stack([gscale, gscale.new_full((), lr), gscale.new_full((), c1),
                       gscale.new_full((), c2)])
    n0 = a8.KERNEL.launches
    for i, p in enumerate(p1):
        a8.adam8bit_update(a8._rows(grads[i].contiguous()), a8._rows(p), a8._rows(o1.m_codes[i]),
                           a8._rows(o1.r_codes[i]), a8._rows(o1.scales[i]["m"]),
                           a8._rows(o1.scales[i]["r"]), sc1, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                           wd=opt.weight_decay, l2=opt.l2)
    one_leaf_launches = a8.KERNEL.launches - n0
    torch.cuda.synchronize()
    checks["table_step_same_bits_as_one_leaf_calls"] = all(
        torch.equal(a, b) for a, b in zip(adam8bit_outputs(of, pf), adam8bit_outputs(o1, p1)))
    checks["one_leaf_calls_one_launch_each"] = one_leaf_launches == len(p1)
    del o1, p1
    torch.cuda.empty_cache()
    fused_event = cuda_ms(torch, lambda: of.update(pf, grads, norm), 5)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        of.update(pf, grads, norm)
        host.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    total, by_name = device_ms_by_name(torch, lambda: of.update(pf, grads, norm), 3)
    kernel_dev = sum(v for k, v in by_name.items() if "adam8bit_kernel" in k) or None
    scalars = torch.tensor([1.0, lr, 0.5, 0.5], device=pf[0].device)

    def plain():
        for i, p in enumerate(pf):
            if a8.fused_leaf_supported(p.shape):
                a8.adam8bit_leaf_plain(a8._rows(grads[i]), a8._rows(p), a8._rows(of.m_codes[i]),
                                       a8._rows(of.r_codes[i]), a8._rows(of.scales[i]["m"]),
                                       a8._rows(of.scales[i]["r"]), scalars,
                                       b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.weight_decay)

    plain_ms = cuda_ms(torch, plain, 1)
    n_el = sum(p.numel() for p in pf)
    n_rows = sum(p.numel() // p.shape[-1] for p in pf)
    b_ms, b_by = bound_ms(16 * n_el + 16 * n_rows, 0, peaks)
    res = dict(leaves=len(pf), elements=n_el, rows=n_rows, launches_per_step=of.launches_per_step,
               fused_vs_unfused_param_max_diff=p_diff,
               fused_vs_unfused_param_max_diff_past_one_ulp=p_excess, lr=lr,
               code_max_diff=code_diff,
               code_diff_share=code_share, scale_max_rel_diff=scale_rel,
               fused_step_event_ms=fused_event, fused_step_host_ms=sorted(host)[2],
               unfused_step_event_ms=unfused_event,
               fused_step_device_ms=total, fused_kernel_device_ms=kernel_dev,
               plain_event_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    del runs, of, pf, grads
    torch.cuda.empty_cache()
    return res, checks


def run_train_1p5b(torch, peaks, out_dir=None):
    """gpt2-1.5b at full width and depth through ``initialize`` with the
    north-star recipe (``northstar_config``; remat ``dots_saveable+flash``,
    the chunked head at ``loss_chunk`` 8192, bf16 compute over fp32
    masters): 2 warm-up and 8 timed steps (launches zeroed before the timed
    run and read after it), the optimizer check, one profiled step, then
    one step each of two engines built from the same weights: remat
    ``dots_saveable`` (no ``+flash``) and ``loss_pallas`` (the fused CE
    head), each with its launch counts and its loss against the chunked
    head's on those weights."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config

    cfg = gpt2_config("gpt2-1.5b", n_positions=1024, remat=True,
                      remat_policy="dots_saveable+flash", loss_chunk=8192)
    S, L = 1024, cfg.n_layer
    t0 = time.perf_counter()
    model = GPT2LMHeadModel(cfg, device="meta")
    eng, *_ = ds.initialize(model=model, config=northstar_config())
    eng.init_params()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    micro = eng.train_micro_batch_size_per_gpu
    ids = text_like_ids(np.random.default_rng(SEED + 13), micro, S, cfg.vocab_size)
    batch = eng._to_device({"input_ids": ids, "labels": ids})
    n_params = sum(p.numel() for p in eng._params)
    per_step = {"adam8bit_update": eng.optimizer.launches_per_step,
                "flash_attention_fwd": L, "flash_attention_bwd_merged": L}

    t0 = time.perf_counter()
    warm = eng.train_batches(batch, 2, stacked=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = eng.train_batches(batch, 8, stacked=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in torch.cat([warm, losses])]
    expected = {n: 8 * per_step.get(n, 0) for n in launches}
    tok_s = 8 * micro * S / wall
    mfu = model.flops_per_token() * tok_s / peaks[1]

    opt_res, opt_checks = optimizer_check(torch, eng, batch, peaks)

    eng.train_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        eng.train_batch(batch)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    by_name = device_ms_of(prof)
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    if out_dir:
        with open(os.path.join(out_dir, "profile_train_1p5b_step.txt"), "w") as fh:
            fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50))

    # two variants from the same weights: the loss each reports is the loss
    # at these weights, which the chunked head gives too; the fused head's
    # variant also holds its head gradients against the chunked head's
    ref_loss = float(eng.eval_batch(batch))
    ref_grads = head_grads(eng, batch)
    variants, var_launches = {}, {}
    for path, over, want in (
            ("train_1p5b_dots", {"remat_policy": "dots_saveable"},
             {"adam8bit_update": per_step["adam8bit_update"], "flash_attention_fwd": 2 * L,
              "flash_attention_bwd_merged": L}),
            ("train_1p5b_pallas", {"loss_pallas": True},
             {**per_step, "fused_ce_fwd_sm90": 1, "fused_ce_bwd_sm90": 1})):
        e2, *_ = ds.initialize(model=GPT2LMHeadModel(cfg, device="meta"),
                               config=northstar_config(**over), model_parameters=eng.params)
        gate = head_gate(torch, ref_grads, head_grads(e2, batch)) if over.get("loss_pallas") \
            else None
        zero_counts()
        t1 = time.perf_counter()
        loss = float(e2.train_batch(batch))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
        counts = read_counts()
        var_launches[path] = counts
        variants[path] = dict(overrides=over, loss=loss, loss_rel_diff=abs(loss / ref_loss - 1),
                              step_ms_first=step_ms, launches=counts,
                              expected_launches={n: want.get(n, 0) for n in counts})
        if gate is not None:
            variants[path]["head_gate"] = gate
        del e2
        torch.cuda.empty_cache()

    checks = {"fused_path": eng._fused_opt is not None,
              "losses_finite": all(math.isfinite(x) for x in losses),
              "loss_falling": losses[-1] < losses[2] and losses[-1] < losses[0],
              "launch_counts": launches == expected,
              "peak_memory_under_80gb": peak_mem < 80e9, **opt_checks}
    for path, v in variants.items():
        checks[f"{path}_launch_counts"] = v["launches"] == v["expected_launches"]
        # bf16 heads against the chunked head at the same weights: the fused
        # head sums in fp32 in another order (and remat changes nothing)
        checks[f"{path}_loss"] = math.isfinite(v["loss"]) and v["loss_rel_diff"] <= 1e-3
        if "head_gate" in v:
            checks[f"{path}_head_gate"] = head_gate_ok(v["head_gate"])
    state = eng.optimizer.state_bytes()
    emit(dict(phase="train_1p5b", model="gpt2-1.5b", config=northstar_config(),
              remat_policy=cfg.remat_policy, loss_chunk=cfg.loss_chunk, dtype="bfloat16",
              batch=[micro, S], params=n_params, init_s=init_s, warmup_s=warm_s, timed_steps=8,
              wall_s=wall, ms_per_step=wall * 1e3 / 8, tokens_per_s=tok_s,
              flops_per_token=model.flops_per_token(), mfu=mfu,
              # the host sets the wall time of this step (see the profile's
              # busy share); the device time of one step is the steadier number
              step_device_ms=dev_ms if dev_ms else "not measured",
              tokens_per_device_s=micro * S / (dev_ms / 1e3) if dev_ms else "not measured",
              max_memory_allocated_gb=peak_mem / 2 ** 30,
              optimizer_state_gb=state / 1e9, adamw_fp32_state_gb=8 * n_params / 1e9,
              losses=losses, launches=launches, expected_launches=expected,
              optimizer=opt_res, chunked_head_loss_at_variant_weights=ref_loss,
              variants=variants,
              profile=dict(step_wall_ms=prof_wall,
                           step_device_ms=dev_ms if dev_ms else "not measured",
                           device_busy_share=dev_ms / prof_wall if dev_ms else "not measured",
                           top_device_ms={k[:90]: v for k, v in top}),
              checks=checks))
    del eng, batch, ref_grads
    torch.cuda.empty_cache()
    return ({"train_1p5b": launches, **var_launches}, opt_res, all(checks.values()))


# ---------------------------------------------------------------------------
# the fused FFN (GPT-2 fused_mlp=True): kernels, serving, training
# ---------------------------------------------------------------------------

# the wrappers' counters: the mma.sync forward and dx (fp32, and the bf16
# forward below fused_mlp.SM90_MIN_ROWS rows), dw, and the tensor-core
# forward and dx
FUSED_MLP_KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd_dx", "fused_mlp_bwd_dw",
                     "fused_mlp_fwd_sm90", "fused_mlp_bwd_dx_sm90")
NO_FUSED_MLP = {n: 0 for n in FUSED_MLP_KERNELS}
FUSED_MLP_LINES = {"fused_mlp_fwd": ":31", "fused_mlp_bwd_dx": ":45", "fused_mlp_bwd_dw": ":72",
                   "fused_mlp_fwd_sm90": ":31", "fused_mlp_bwd_dx_sm90": ":45"}
# the library's kernels behind each tensor-core entry (fused_mlp.KERNELS)
MLP_SM90_KERNELS = {"fused_mlp_fwd_sm90": ("h_sm90_kernel", "y_sm90_kernel"),
                    "fused_mlp_bwd_dx_sm90": ("du_sm90_kernel", "dx_sm90_kernel")}
# gpt2-125m's FFN (the widest the JAX rule fuses in bf16) at the flagship
# micro-batch (24 x 1024 rows), B=2 x 1024 (the forward and a prefill), an
# unfused decode tick (8 rows) and a ragged count
MLP_SHAPES = ((24576, 768, 3072), (2048, 768, 3072), (8, 768, 3072), (1000, 768, 3072))
MLP_FP32_SHAPES = ((37, 64, 256), (130, 128, 512), (300, 384, 1536))
# the bf16 dw kernel's other plans: E = 64 (one CTA a cluster), 384 (two),
# a ragged row count, a hidden width short of a 64-column tile
DW_EXTRA_SHAPES = ((300, 64, 256), (2048, 384, 1536), (777, 384, 1536), (130, 768, 160))
DW_SM90_RAN = {"fwd_kernel": 0, "dx_kernel": 0, "dw_sm90_kernel": 1, "dw_kernel": 0,
               "reduce_kernel": 2, "h_sm90_kernel": 0, "y_sm90_kernel": 0, "du_sm90_kernel": 0,
               "dx_sm90_kernel": 0}
# gpt2-125m's FFN, the width of every fused_mlp path
MLP_E, MLP_F = 768, 3072


def mlp_operands(torch, g, R, E, F, dtype, dev="cuda"):
    """x ~ N(0, 1) (a LayerNorm's output), w1, w2, b1 ~ N(0, 0.02) (GPT-2's
    initializer range) in ``dtype``, b2 ~ N(0, 0.02) fp32 (the kernels'),
    dy ~ N(0, 1e-3) in ``dtype``."""
    def r(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=dev) * s
    return (r(R, E).to(dtype), r(E, F, s=0.02).to(dtype), r(F, s=0.02).to(dtype),
            r(F, E, s=0.02).to(dtype), r(E, s=0.02), r(R, E, s=1e-3).to(dtype))


def mlp_mags(torch, fm, x, w1, b1, w2, b2, dy):
    """Per output, the summed magnitudes of its fp32 addends, with the fp32
    error of u (its own addends' magnitudes) carried through the GELU
    (|gelu''| < 1): two correct fp32 orders of the same sums differ by far
    less than 1e-5 of these."""
    xf, w1f, w2f, dyf = x.float(), w1.float(), w2.float(), dy.float()
    u = xf @ w1f + b1.float()
    u_mag = xf.abs() @ w1f.abs() + b1.float().abs()
    h_mag = fm.gelu_tanh(u).abs() + fm.gelu_tanh_grad(u).abs() * u_mag
    du_mag = (dyf.abs() @ w2f.abs().T) * (fm.gelu_tanh_grad(u).abs() + u_mag)
    return dict(y=h_mag @ w2f.abs() + b2.float().abs(), dx=du_mag @ w1f.abs().T,
                dw1=xf.abs().T @ du_mag, db1=du_mag.sum(0), dw2=h_mag.T @ dyf.abs(),
                db2=dyf.abs().sum(0))


def mlp_limit(torch, got, ref, mag, cast_row: bool):
    """Element by element: within 1e-5 of ``mag`` (``mlp_mags``); a bf16
    output also within one bf16 ulp of the plain value and, where the
    function casts an intermediate to bf16 (h in the forward, du in dx:
    ``cast_row``), half a bf16 ulp of its row's largest output, as
    ``w8_limits`` allows for (an fp32 value the two orders round apart there
    moves the whole row). Returns (max error, max error / limit)."""
    lim = 1e-5 * mag.float()
    if ref.dtype == torch.bfloat16:
        lim = lim + bf16_ulp_t(torch, ref)
        if cast_row:
            lim = lim + bf16_ulp_t(torch, ref.float().abs().amax(-1, keepdim=True)) / 2
    d = (got.float() - ref.float()).abs()
    return float(d.max()), float((d / lim.clamp(min=1e-30)).max())


def mlp_outputs(fm, args, kernels: bool, parts=("y", "dx", "dw")):
    """``{y, dx, dw1, db1, dw2, db2}`` of the three wrappers or their plain
    versions, those of the calls named in ``parts`` (``y``: the forward,
    ``dx``, ``dw``: its four)."""
    x, w1, b1, w2, b2, dy = args
    calls = {"y": (fm.fused_mlp_fwd_op, fm.fused_mlp_plain, b2),
             "dx": (fm.fused_mlp_bwd_dx, fm.fused_mlp_bwd_dx_plain, dy),
             "dw": (fm.fused_mlp_bwd_dw, fm.fused_mlp_bwd_dw_plain, dy)}
    out = {}
    for part in parts:
        kern, plain, last = calls[part]
        got = (kern if kernels else plain)(x, w1, b1, w2, last)
        out.update(dict(zip(("dw1", "db1", "dw2", "db2"), got)) if part == "dw" else {part: got})
    return out


# which kernel produces each output (the forward and dx: their mma.sync
# entries' names, which mlp_names maps to the route a call takes), and
# whether a bf16 cast sits inside it
MLP_OUTPUTS = {"y": ("fused_mlp_fwd", True), "dx": ("fused_mlp_bwd_dx", True),
               "dw1": ("fused_mlp_bwd_dw", False), "db1": ("fused_mlp_bwd_dw", False),
               "dw2": ("fused_mlp_bwd_dw", False), "db2": ("fused_mlp_bwd_dw", False)}


def mlp_names(fm, x, w1) -> dict:
    """The wrapper counters a forward and a dx call on these operands
    launch: the tensor-core entries where ``sm90_route`` takes the rows
    (bf16 dx; the bf16 forward from ``SM90_MIN_ROWS``), else the mma.sync
    ones; dw as it is."""
    def name(base, fwd):
        return base + "_sm90" if fm._sm90_plan(x, w1, fwd) is not None else base
    return {"fused_mlp_fwd": name("fused_mlp_fwd", True),
            "fused_mlp_bwd_dx": name("fused_mlp_bwd_dx", False),
            "fused_mlp_bwd_dw": "fused_mlp_bwd_dw"}


def mlp_path_names(fm, rows: dict, kind: str = "fused_mlp_fwd") -> dict:
    """Forward (or, with ``kind="fused_mlp_bwd_dx"``, dx) calls by wrapper
    counter on a gpt2-125m path, from ``{rows of a call: calls}``: each call
    takes the route ``sm90_route`` gives its rows (bf16)."""
    out = {}
    for R, n in rows.items():
        name = kind + "_sm90" if fm.sm90_route(R, kind == "fused_mlp_fwd") else kind
        out[name] = out.get(name, 0) + n
    return out


@contextlib.contextmanager
def forced_route(fm, sm90: bool):
    """The bf16 forward on the tensor-core entry (``sm90``) or the mma.sync
    one at every row count, whatever the row rule says (bf16 dx takes its
    tensor-core entry at every row count either way)."""
    saved = fm.SM90_MIN_ROWS
    fm.SM90_MIN_ROWS = 1 if sm90 else 1 << 62
    try:
        yield
    finally:
        fm.SM90_MIN_ROWS = saved


def mlp_held(torch, fm, args, parts=("y", "dx", "dw")):
    """Each kernel's outputs against its plain version (the calls named in
    ``parts``, as ``mlp_outputs``): per kernel (named by the route the call
    takes) the largest error, the largest error / limit (over its outputs)
    and ok."""
    names = mlp_names(fm, args[0], args[1])
    got = mlp_outputs(fm, args, True, parts)
    ref = mlp_outputs(fm, args, False, parts)
    torch.cuda.synchronize()
    mags = mlp_mags(torch, fm, *args)
    per = {}
    for out, (base, cast_row) in MLP_OUTPUTS.items():
        if out not in got:
            continue
        err, ratio = mlp_limit(torch, got[out], ref[out], mags[out], cast_row)
        finite = bool(torch.isfinite(got[out].float()).all())
        p = per.setdefault(names[base], dict(max_err=0.0, err_over_limit=0.0, outputs={}))
        p["outputs"][out] = dict(max_err=err, err_over_limit=ratio, finite=finite,
                                 dtype=str(got[out].dtype)[6:],
                                 dtype_ok=got[out].dtype == ref[out].dtype)
        p["max_err"], p["err_over_limit"] = max(p["max_err"], err), max(p["err_over_limit"], ratio)
    for p in per.values():
        p["ok"] = all(o["finite"] and o["dtype_ok"] and o["err_over_limit"] <= 1.0
                      for o in p["outputs"].values())
    return per


def sm90_launches(fm, name, call, calls, chunks, splits):
    """``call()`` and the library's own counts of its launches by kernel;
    whether they are exactly those of ``calls`` calls of the tensor-core
    entry ``name`` under a plan of ``chunks`` row chunks and ``splits``
    splits of F (a call: per chunk h_sm90_kernel and y_sm90_kernel, or
    du_sm90_kernel and dx_sm90_kernel; reduce_kernel once where F is split;
    nothing else)."""
    before = fm.kernel_launches()
    got = call()
    ran = {k: v - before[k] for k, v in fm.kernel_launches().items()}
    want = {k: 0 for k in ran}
    want.update({k: calls * chunks for k in MLP_SM90_KERNELS[name]},
                reduce_kernel=calls * int(splits > 1))
    return got, {k: v for k, v in ran.items() if v}, ran == want


def forced_chunks(fm, plan, R):
    """``plan`` with the rows walked in three chunks of whole 128-row
    tiles, the last one shorter (the row-chunk loop that keeps a larger
    call's scratch within ``SCRATCH_BYTES``); None below three tiles."""
    tiles = -(-R // fm.TILE_ROWS)
    return plan._replace(chunk_rows=(tiles // 3 + 1) * fm.TILE_ROWS) if tiles >= 3 else None


def sm90_held(torch, fm, args) -> dict:
    """The tensor-core forward and dx, each called twice: identical bits,
    the library's own counts (``sm90_launches``), and the output against the
    plain model of the entry's order (``fused_mlp_tiled_plain``,
    ``fused_mlp_bwd_dx_tiled_plain``) under ``mlp_limit``. Then, from three
    128-row tiles, each entry once more under its plan forced to several
    row chunks (``forced_chunks``): against the tiled order under that plan,
    the same bits as in one chunk, launches a chunk. Returns
    ``{entry: checks}``."""
    x, w1, b1, w2, b2, dy = args
    R = x.shape[0]
    plan = fm.mlp_plan(R, x.shape[1], w1.shape[1])
    cplan = forced_chunks(fm, plan, R)
    mags = mlp_mags(torch, fm, *args)
    calls = {"fused_mlp_fwd_sm90": (fm.fused_mlp_fwd_op, fm.FWD_SM90, fm.fused_mlp_tiled_plain,
                                    b2, "y"),
             "fused_mlp_bwd_dx_sm90": (fm.fused_mlp_bwd_dx, fm.DX_SM90,
                                       fm.fused_mlp_bwd_dx_tiled_plain, dy, "dx")}
    res = {}
    for name, (wrapper, entry, tiled, last, out) in calls.items():
        (got, again), ran, sm90_ok = sm90_launches(
            fm, name, lambda: (wrapper(x, w1, b1, w2, last), wrapper(x, w1, b1, w2, last)),
            2, -(-R // plan.chunk_rows), plan.splits)
        torch.cuda.synchronize()
        _, ratio = mlp_limit(torch, got, tiled(x, w1, b1, w2, last), mags[out], True)
        res[name] = dict(tiled_err_over_limit=ratio, bitwise_repeat=torch.equal(got, again),
                         launches_by_kernel=ran, sm90_ok=sm90_ok, plan=plan._asdict())
        res[name]["ok"] = ratio <= 1.0 and res[name]["bitwise_repeat"] and sm90_ok
        if cplan is None:
            continue
        n = -(-R // cplan.chunk_rows)
        got_c, ran_c, c_ok = sm90_launches(
            fm, name, lambda: fm._launch_sm90(entry, x, w1, b1, w2, last, torch.empty_like(x),
                                              cplan), 1, n, cplan.splits)
        torch.cuda.synchronize()
        _, c_ratio = mlp_limit(torch, got_c, tiled(x, w1, b1, w2, last, cplan), mags[out], True)
        res[name]["chunked"] = dict(
            chunk_rows=cplan.chunk_rows, chunks=n, last_chunk_rows=R - (n - 1) * cplan.chunk_rows,
            tiled_err_over_limit=c_ratio, same_bits_as_one_chunk=torch.equal(got_c, got),
            launches_by_kernel=ran_c, sm90_ok=c_ok)
        res[name]["chunked"]["ok"] = c_ok and c_ratio <= 1.0 and torch.equal(got_c, got)
        res[name]["ok"] &= res[name]["chunked"]["ok"]
    return res


def dw_held(torch, fm, args) -> dict:
    """The bf16 dw kernel called twice: identical bits, the library's own
    counts (one ``dw_sm90_kernel`` and two ``reduce_kernel`` launches a call,
    no CUDA-core ``dw_kernel``), and its outputs against the plain model of
    its order of summation (``fused_mlp_bwd_dw_tiled_plain``) under
    ``mlp_limit``."""
    x, w1, b1, w2, b2, dy = args
    before = fm.kernel_launches()
    got = fm.fused_mlp_bwd_dw(x, w1, b1, w2, dy)
    again = fm.fused_mlp_bwd_dw(x, w1, b1, w2, dy)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in fm.kernel_launches().items()}
    resident = fm.dw_resident(x.device, x.shape[1])
    tiled = fm.fused_mlp_bwd_dw_tiled_plain(x, w1, b1, w2, dy, resident)
    mags = mlp_mags(torch, fm, *args)
    ratio = max(mlp_limit(torch, a, t, mags[k], False)[1]
                for k, a, t in zip(("dw1", "db1", "dw2", "db2"), got, tiled))
    return dict(tiled_err_over_limit=ratio,
                bitwise_repeat=all(torch.equal(a, b) for a, b in zip(got, again)),
                dw_launches=ran, sm90_ok=ran == {k: 2 * v for k, v in DW_SM90_RAN.items()},
                resident_clusters=resident,
                plan=dict(zip(("chunk", "cluster", "segments", "tiles_per_segment"),
                              fm.dw_plan(x.shape[0], x.shape[1], w1.shape[1], resident))))


def dw_case(torch, fm, args, peaks=None, regs=None) -> dict:
    """One bf16 dw case as a ``kernels_fused_mlp_dw`` line: the kernel's four
    outputs against the plain version under ``mlp_limit``, finite, and
    ``dw_held``'s checks; with ``peaks``, its device time, bound and floor
    with the hi + lo products."""
    x, w1, b1, w2, b2, dy = args
    R, E, F = x.shape[0], x.shape[1], w1.shape[1]
    dwh = dw_held(torch, fm, args)
    got = fm.fused_mlp_bwd_dw(x, w1, b1, w2, dy)
    ref = fm.fused_mlp_bwd_dw_plain(x, w1, b1, w2, dy)
    torch.cuda.synchronize()
    mags = mlp_mags(torch, fm, *args)
    outs = {k: mlp_limit(torch, a, r, mags[k], False)
            for k, a, r in zip(("dw1", "db1", "dw2", "db2"), got, ref)}
    ratio = max(v[1] for v in outs.values())
    row = dict(phase="kernels_fused_mlp_dw", name="fused_mlp_bwd_dw",
               shape=f"R={R} E={E} F={F} bfloat16", max_err=max(v[0] for v in outs.values()),
               err_over_limit=ratio,
               limit="mlp_limit against the plain version and its tiled order",
               finite=all(bool(torch.isfinite(a.float()).all()) for a in got), **dwh)
    if peaks is not None:
        b_ms, b_by = mlp_bounds(R, E, F, 2, peaks, False)["fused_mlp_bwd_dw"]
        row.update(registers=(regs or {}).get(str(dwh["plan"]["chunk"] // 64)),
                   kernel_ms=device_ms(torch, lambda: fm.fused_mlp_bwd_dw(x, w1, b1, w2, dy), 10),
                   bound_ms=b_ms, bound_by=b_by,
                   hi_lo_floor_ms=6 * 2.0 * R * E * F / peaks[1] * 1e3)
    row["ok"] = (ratio <= 1.0 and row["finite"] and dwh["tiled_err_over_limit"] <= 1.0
                 and dwh["bitwise_repeat"] and dwh["sm90_ok"])
    emit(row)
    return row


def dw_cancel_probe(torch, fm, R=64, E=768, F=3072, dev="cuda") -> dict:
    """dw1 where du's bf16 hi parts cancel and its lo parts carry the sum:
    w1 = 0 (u = b1), w2 a unit selection (dh = dy), dy's rows 0 and 1 two
    neighbouring bf16 values a and a + ulp(a) per column, x's rows 0 and 1
    +1 and -1, the rest zero. dw1[e, f] = du[0, f] - du[1, f] = -ulp(a)
    gelu'(b1[f]): du's two values round to one bf16 value (or one ulp apart)
    so dropping the lo halves leaves 0 (or an ulp of a gelu'), ~2^-8 of
    the addends. Returns dw1 against the plain version under ``mlp_limit``
    (must hold) and against a control whose du is cast to bf16 once (no lo
    half), which must miss."""
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    bf = torch.bfloat16
    x = torch.zeros((R, E), device=dev)
    x[0], x[1] = 1.0, -1.0
    a = (0.5 + 0.5 * torch.rand(F, generator=g, device=dev)).to(bf)
    a_next = (a.view(torch.int16) + 1).view(bf)   # the next bf16 value (a > 0)
    dy = torch.zeros((R, E), device=dev, dtype=bf)
    dy[0], dy[1] = a[:E], a_next[:E]
    w2 = torch.zeros((F, E), device=dev)
    w2[:E] = torch.eye(E, device=dev)
    b1 = (4 * torch.rand(F, generator=g, device=dev) - 2).to(bf)
    args = (x.to(bf), torch.zeros((E, F), device=dev, dtype=bf), b1, w2.to(bf),
            torch.zeros(E, device=dev), dy)
    got = fm.fused_mlp_bwd_dw(*args[:4], dy)[0]
    ref = fm.fused_mlp_bwd_dw_plain(*args[:4], dy)[0]
    du = (dy.float() @ w2.T) * fm.gelu_tanh_grad(b1.float())
    ctrl = (x.T @ du.to(bf).float()).to(bf)
    torch.cuda.synchronize()
    mag = mlp_mags(torch, fm, *args)["dw1"]
    _, ratio = mlp_limit(torch, got, ref, mag, False)
    _, control = mlp_limit(torch, got, ctrl, mag, False)
    return dict(err_over_limit=ratio, control_err_over_limit=control,
                ok=ratio <= 1.0 and control > 1.0)


def _split_plan(fm, R):
    """``mlp_plan(R)`` at gpt2-125m's FFN, which must split F on the
    tensor-core route: its second split starts at hidden column
    ``k_blocks * K_BLOCK``."""
    plan = fm.mlp_plan(R, MLP_E, MLP_F)
    if not (fm.sm90_route(R, True) and plan.splits > 1):
        raise ValueError(f"mlp_plan({R}) does not split F on the tensor-core route: {plan}")
    return plan


def fwd_cancel_probe(torch, fm, R=2048, dev="cuda") -> dict:
    """y where fp32 intermediates carry the result through cancellation.
    x's columns 0-2 are 1 (the rest 0). Hidden columns A (64 in each of the
    first two splits of F): w1[0] = 256, w1[1] = d (bf16 in [-3, 3]), b1 =
    -256, so u + b1 = d only in fp32 (bf16(256 + d) is a multiple of 2).
    Columns fa (first split) and fb (second): w1[2] = G = 128, b1 = 0, so h
    = gelu(G) = G. w2 selects y[:, e] = (h[A0[e]] + G) + (h[A1[e]] - G) for
    e < 64: each split's fp32 partial holds G + h, which bf16 rounds to a
    multiple of 1. Returns y against the plain version under ``mlp_limit``
    (must hold) and against two controls that must miss: u rounded to bf16
    before b1, and the splits' partials rounded to bf16 before their sum."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    plan = _split_plan(fm, R)
    n, G, b = 64, 128.0, plan.k_blocks * fm.K_BLOCK
    A0, A1 = torch.arange(n, device=dev), torch.arange(b, b + n, device=dev)
    fa, fb = n, b + n
    x = torch.zeros((R, MLP_E), device=dev)
    x[:, :3] = 1.0
    w1 = torch.zeros((MLP_E, MLP_F), device=dev)
    b1 = torch.zeros(MLP_F, device=dev)
    d = (6 * torch.rand(2 * n, generator=g, device=dev) - 3).to(bf).float()
    for cols, dv in ((A0, d[:n]), (A1, d[n:])):
        w1[0, cols], w1[1, cols], b1[cols] = 256.0, dv, -256.0
    w1[2, fa] = w1[2, fb] = G
    w2 = torch.zeros((MLP_F, MLP_E), device=dev)
    e = torch.arange(n, device=dev)
    w2[A0, e] = w2[A1, e] = 1.0
    w2[fa, :n], w2[fb, :n] = 1.0, -1.0
    args = (x.to(bf), w1.to(bf), b1.to(bf), w2.to(bf), torch.zeros(MLP_E, device=dev),
            torch.zeros((R, MLP_E), device=dev, dtype=bf))
    got = fm.fused_mlp_fwd_op(*args[:5])
    ref = fm.fused_mlp_plain(*args[:5])
    xf, w1f, b1f, w2f = (t.float() for t in args[:4])
    u = (xf @ w1f).to(bf).float() + b1f        # control 1: u in bf16 before b1
    ctrl_u = (fm.gelu_tanh(u).to(bf).float() @ w2f).to(bf)
    h = fm.gelu_tanh(xf @ w1f + b1f).to(bf).float()
    width = plan.k_blocks * fm.K_BLOCK       # control 2: each split's partial in bf16
    parts = [(h[:, c:c + width] @ w2f[c:c + width]).to(bf).float() for c in range(0, MLP_F, width)]
    ctrl_split = sum(parts).to(bf)
    torch.cuda.synchronize()
    mag = mlp_mags(torch, fm, *args)["y"]
    _, ratio = mlp_limit(torch, got, ref, mag, True)
    _, c_u = mlp_limit(torch, got, ctrl_u, mag, True)
    _, c_split = mlp_limit(torch, got, ctrl_split, mag, True)
    return dict(err_over_limit=ratio, control_u_bf16_err_over_limit=c_u,
                control_split_bf16_err_over_limit=c_split, plan=plan._asdict(),
                ok=ratio <= 1.0 and c_u > 1.0 and c_split > 1.0)


def dx_cancel_probe(torch, fm, R=2048, dev="cuda") -> dict:
    """dx where fp32 intermediates carry the result through cancellation.
    x = 0 (u = b1, b1 in [-3, 3] on hidden columns A: 64 in each of the
    first two splits of F). dy's columns 0, 1 and 64 are 1 (two 64-wide
    blocks of the contraction over E): w2[A, 0] = 64, w2[A, 1] = c (bf16 in
    [-0.25, 0.25]), w2[A, 64] = -64, so dh = c only in fp32 across the
    blocks (bf16(64 + c) - 64 is 0). Columns fa (first split) and fb
    (second): w2[., 2] = 32 with dy's column 2 = 1 and b1 = 10 (gelu' = 1),
    so du = 32. w1 selects dx[:, e] = (du[A0[e]] + 32) + (du[A1[e]] - 32) for
    e < 64, each split's fp32 partial holding 32 + du, which bf16 rounds to
    a multiple of 0.25. Returns dx against the plain version under
    ``mlp_limit`` (must hold) and against two controls that must miss: dh's
    first block rounded to bf16 before the second's, and the splits'
    partials rounded to bf16 before their sum."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    plan = _split_plan(fm, R)
    n, b = 64, plan.k_blocks * fm.K_BLOCK
    A = torch.cat([torch.arange(n, device=dev), torch.arange(b, b + n, device=dev)])
    fa, fb = n, b + n
    b1 = torch.zeros(MLP_F, device=dev)
    b1[A] = (6 * torch.rand(2 * n, generator=g, device=dev) - 3).to(bf).float()
    b1[fa] = b1[fb] = 10.0
    dy = torch.zeros((R, MLP_E), device=dev)
    dy[:, [0, 1, 2, 64]] = 1.0
    w2 = torch.zeros((MLP_F, MLP_E), device=dev)
    c = (0.5 * torch.rand(2 * n, generator=g, device=dev) - 0.25).to(bf).float()
    w2[A, 0], w2[A, 1], w2[A, 64] = 64.0, c, -64.0
    w2[fa, 2] = w2[fb, 2] = 32.0
    w1 = torch.zeros((MLP_E, MLP_F), device=dev)
    e = torch.arange(n, device=dev)
    w1[e, A[:n]] = w1[e, A[n:]] = 1.0
    w1[:n, fa], w1[:n, fb] = 1.0, -1.0
    args = (torch.zeros((R, MLP_E), device=dev, dtype=bf), w1.to(bf), b1.to(bf), w2.to(bf),
            torch.zeros(MLP_E, device=dev), dy.to(bf))
    got = fm.fused_mlp_bwd_dx(*args[:4], args[5])
    ref = fm.fused_mlp_bwd_dx_plain(*args[:4], args[5])
    w1f, b1f, w2f, dyf = args[1].float(), args[2].float(), args[3].float(), args[5].float()
    gp = fm.gelu_tanh_grad(b1f)
    # control 1: dh's first 64-wide block of E in bf16, then the rest added
    dh = (dyf[:, :64] @ w2f[:, :64].T).to(bf).float() + dyf[:, 64:] @ w2f[:, 64:].T
    ctrl_dh = ((dh * gp).to(bf).float() @ w1f.T).to(bf)
    du = ((dyf @ w2f.T) * gp).to(bf).float()
    width = plan.k_blocks * fm.K_BLOCK       # control 2: each split's partial in bf16
    parts = [(du[:, c:c + width] @ w1f[:, c:c + width].T).to(bf).float()
             for c in range(0, MLP_F, width)]
    ctrl_split = sum(parts).to(bf)
    torch.cuda.synchronize()
    mag = mlp_mags(torch, fm, *args)["dx"]
    _, ratio = mlp_limit(torch, got, ref, mag, True)
    _, c_dh = mlp_limit(torch, got, ctrl_dh, mag, True)
    _, c_split = mlp_limit(torch, got, ctrl_split, mag, True)
    return dict(err_over_limit=ratio, control_dh_bf16_err_over_limit=c_dh,
                control_split_bf16_err_over_limit=c_split, plan=plan._asdict(),
                ok=ratio <= 1.0 and c_dh > 1.0 and c_split > 1.0)


def run_dw_checks(torch) -> bool:
    """The bf16 dw kernel untimed at ``MLP_SHAPES`` and ``DW_EXTRA_SHAPES``
    (``dw_case``), for ``scripts/fused_mlp_planted_faults.py``."""
    from deepspeed_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    ok = True
    for R, E, F in MLP_SHAPES + DW_EXTRA_SHAPES:
        ok &= dw_case(torch, fm, mlp_operands(torch, g, R, E, F, torch.bfloat16))["ok"]
        torch.cuda.empty_cache()
    probe = dw_cancel_probe(torch, fm)
    emit(dict(phase="kernels_fused_mlp_dw_cancel", name="fused_mlp_bwd_dw",
              shape="R=64 E=768 F=3072 bfloat16", max_err=None, **probe))
    return ok and probe["ok"]


def erf_gelu_grad(torch, u):
    """d/du of the exact GELU 0.5·u·(1 + erf(u/√2))."""
    return 0.5 * (1.0 + torch.erf(u * 2 ** -0.5)) + u * torch.exp(-0.5 * u * u) * (
        2 * math.pi) ** -0.5


def fused_mlp_gelu_probe(torch, fm, R, E, F, dtype, band, dev="cuda"):
    """x = 0, unit selections w1[e, e] = w2[e, e] = 1 (zero elsewhere), b1
    spread over ``band`` (where the tanh and erf GELUs part) and repeated
    along F, b2 = 0, dy = 1: y[r, e] = gelu(b1[e]) and dx[r, e] =
    gelu'(b1[e]) (cast), dw2[f, e] = R·gelu(b1[f]), db1[f] = R·gelu'(b1[f])
    for f < E (0 past E, where w2's rows are 0). Those four outputs against the plain versions (must hold) and,
    as a control that must miss, against the plain versions with the erf
    forms of GELU and its derivative."""
    from deepspeed_tpu_torch.ops.decode_layer import gelu_exact

    x = torch.zeros((R, E), dtype=dtype, device=dev)
    w1 = torch.zeros((E, F), device=dev)
    w1[:, :E] = torch.eye(E, device=dev)
    b1 = torch.linspace(band[0], band[1], E, device=dev).repeat(F // E).to(dtype)
    args = (x, w1.to(dtype), b1, w1.T.contiguous().to(dtype), torch.zeros(E, device=dev),
            torch.ones((R, E), dtype=dtype, device=dev))
    got, ref = mlp_outputs(fm, args, True), mlp_outputs(fm, args, False)
    saved = fm.gelu_tanh, fm.gelu_tanh_grad
    fm.gelu_tanh, fm.gelu_tanh_grad = gelu_exact, lambda u: erf_gelu_grad(torch, u)
    try:
        ctrl = mlp_outputs(fm, args, False)
    finally:
        fm.gelu_tanh, fm.gelu_tanh_grad = saved
    torch.cuda.synchronize()
    mags = mlp_mags(torch, fm, *args)
    rows = {}
    for out in ("y", "dx", "dw2", "db1"):
        cast_row = MLP_OUTPUTS[out][1]
        _, ratio = mlp_limit(torch, got[out], ref[out], mags[out], cast_row)
        _, control = mlp_limit(torch, got[out], ctrl[out], mags[out], cast_row)
        rows[out] = dict(err_over_limit=ratio, control_err_over_limit=control,
                         ok=ratio <= 1.0 and control > 1.0)
    return rows


def mlp_bounds(R, E, F, item, peaks, fp32):
    """Bound per kernel: each input read once and each output written once
    (x, w1, b1, w2 and b2 or dy; y, dx, or dw1, db1, dw2 and the fp32 db2),
    against 2, 3 and 4 products of 2·R·E·F flops."""
    w = 2 * E * F * item + F * item
    flops = 2.0 * R * E * F
    return {"fused_mlp_fwd": bound_ms(2 * R * E * item + w + 4 * E, 2 * flops, peaks, fp32),
            "fused_mlp_bwd_dx": bound_ms(3 * R * E * item + w, 3 * flops, peaks, fp32),
            "fused_mlp_bwd_dw": bound_ms(2 * R * E * item + 2 * w + 4 * E, 4 * flops, peaks,
                                         fp32)}


def mlp_build_regs(mlp_build) -> tuple[dict, dict]:
    """Registers and spill bytes from the fused_mlp library's ``-Xptxas -v``
    log: the bf16 dw kernel's by E-chunk (``"3"``: 192 columns), and the
    tensor-core forward's and dx's kernels by entry and instantiation."""
    def short(sym, k):
        rest = sym.split(k, 1)[1]
        return k + (f"<{rest[3:rest.index('E')]}>" if rest.startswith("ILi") else "")
    dw = {r["symbol"].split("dw_sm90_kernelILi")[1][0]: {
        k: r.get(k) for k in ("registers", "spill_bytes")}
        for r in mlp_build if "dw_sm90_kernelILi" in r["symbol"]}
    sm90 = {entry: {short(r["symbol"], k): {x: r.get(x) for x in ("registers", "spill_bytes")}
                    for k in kernels for r in mlp_build if k in r["symbol"]}
            for entry, kernels in MLP_SM90_KERNELS.items()}
    return dw, sm90


def run_kernels_fused_mlp(torch, F_, peaks, mlp_build=()):
    """The fused FFN kernels against their plain versions on the card. bf16
    at ``MLP_SHAPES``: the forward on both routes (the tensor-core entry and
    the mma.sync one; ``main_route`` marks the one the row rule gives the
    wrapper) and dx on its tensor-core entry, every output held against the
    plain version; the tensor-core entries also against the plain models of
    their order, bit for bit on a second call, with the library's launches
    by kernel, and under a plan forced to several row chunks
    (``sm90_held``), and their registers and spills (``mlp_build``); dw held
    as before (``dw_held``, its floor with the hi + lo products, its
    registers). Each row carries its device time, its plain version's, the
    library's and the bound; dx's rows also dx's own unfused chain
    (``unfused_chain_ms``: ``F.linear(x, w1ᵀ, b1)``, ``dy @ w2ᵀ``,
    ``aten.gelu_backward(..., approximate="tanh")``, ``@ w1ᵀ``). Library:
    the unfused torch pair ``F.linear`` → tanh GELU → ``F.linear`` (forward),
    and that pair's autograd backward (all five gradients) beside dx and dw
    (no one call computes the fused function). Then dw's other plans
    (``DW_EXTRA_SHAPES``), the cancellation probes of dw, the forward and dx,
    fp32 at ``MLP_FP32_SHAPES`` (checked, not timed) and the GELU probes in
    bf16 and fp32. Returns ({kernel: row at the flagship shape, with the
    other shapes under ``at_shapes``}, ok)."""
    from deepspeed_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    regs, sm90_regs = mlp_build_regs(mlp_build)
    rows, ok = {}, True
    for R, E, F in MLP_SHAPES:
        args = mlp_operands(torch, g, R, E, F, torch.bfloat16)
        x, w1, b1, w2, b2, dy = args
        w1t, w2t, b2b = w1.T.contiguous(), w2.T.contiguous(), b2.to(torch.bfloat16)
        lib_in = [t.clone().requires_grad_() for t in (x, w1t, b1, w2t, b2b)]

        def lib_fwd(a=lib_in):
            return F_.linear(F_.gelu(F_.linear(a[0], a[1], a[2]), approximate="tanh"), a[3], a[4])

        def lib_fwd_bwd():
            return torch.autograd.grad(lib_fwd(), lib_in, dy)

        def dx_chain():
            u = F_.linear(x, w1t, b1)
            return torch.ops.aten.gelu_backward(dy @ w2t, u, approximate="tanh") @ w1t

        iters = 5 if R >= 2048 else 20
        lib_f = device_ms(torch, lib_fwd, iters)
        lib_fb = device_ms(torch, lib_fwd_bwd, iters)
        lib_b = lib_fb - lib_f if lib_fb and lib_f else None
        chain_ms = device_ms(torch, dx_chain, iters)
        calls = {"fwd": (lambda: fm.fused_mlp_fwd_op(x, w1, b1, w2, b2),
                         lambda: fm.fused_mlp_plain(x, w1, b1, w2, b2), lib_f),
                 "dx": (lambda: fm.fused_mlp_bwd_dx(x, w1, b1, w2, dy),
                        lambda: fm.fused_mlp_bwd_dx_plain(x, w1, b1, w2, dy), lib_b),
                 "dw": (lambda: fm.fused_mlp_bwd_dw(x, w1, b1, w2, dy),
                        lambda: fm.fused_mlp_bwd_dw_plain(x, w1, b1, w2, dy), lib_b)}
        plain_ms = {k: device_ms(torch, c[1], 3) for k, c in calls.items()}
        bounds = mlp_bounds(R, E, F, 2, peaks, False)
        main = set(mlp_names(fm, x, w1).values())
        for sm90 in (True, False):
            with forced_route(fm, sm90):
                held = mlp_held(torch, fm, args, ("y", "dx", "dw") if sm90 else ("y",))
                extra = sm90_held(torch, fm, args) if sm90 else {}
                if sm90:
                    dwh = dw_held(torch, fm, args)
                    held["fused_mlp_bwd_dw"].update(
                        dwh, hi_lo_floor_ms=6 * 2.0 * R * E * F / peaks[1] * 1e3,
                        registers=regs.get(str(dwh["plan"]["chunk"] // 64)))
                    held["fused_mlp_bwd_dw"]["ok"] &= (dwh["tiled_err_over_limit"] <= 1.0
                                                       and dwh["bitwise_repeat"] and dwh["sm90_ok"])
                for name, h in held.items():
                    kind = "dw" if name.endswith("dw") else "dx" if "dx" in name else "fwd"
                    kern, _, lib = calls[kind]
                    base = {"fwd": "fused_mlp_fwd", "dx": "fused_mlp_bwd_dx",
                            "dw": "fused_mlp_bwd_dw"}[kind]
                    b_ms, b_by = bounds[base]
                    row = dict(phase="kernels_fused_mlp", name=name, shape=f"R={R} E={E} F={F} bfloat16",
                               route="mma.sync" if name in ("fused_mlp_fwd", "fused_mlp_bwd_dx")
                               else "sm90", main_route=name in main, **h,
                               limit="mlp_limit: 1e-5 of the fp32 addends' magnitudes + "
                               "one bf16 ulp (+ half an ulp of the row's largest output in y and dx)",
                               kernel_ms=device_ms(torch, kern, iters),
                               kernel_event_ms=cuda_ms(torch, kern, iters),
                               plain_ms=plain_ms[kind], library_ms=lib,
                               library="unfused pair F.linear -> gelu(tanh) -> F.linear" + (
                                   " forward" if kind == "fwd" else
                                   ", autograd backward (all five gradients)"),
                               bound_ms=b_ms, bound_by=b_by)
                    if name in extra:
                        row.update(extra[name], ok=h["ok"] and extra[name]["ok"],
                                   registers=sm90_regs.get(name))
                    if kind == "dx":
                        row["unfused_chain_ms"] = chain_ms
                    row["ok"] = row["ok"] and row["kernel_ms"] is not None
                    emit(row)
                    ok &= row["ok"]
                    if R == MLP_SHAPES[0][0]:
                        rows[name] = dict(row, at_shapes=[])
                    else:
                        rows[name]["at_shapes"].append({k: row[k] for k in (
                            "shape", "main_route", "max_err", "err_over_limit",
                            "tiled_err_over_limit", "kernel_ms", "plain_ms", "library_ms",
                            "unfused_chain_ms", "bound_ms", "bound_by", "hi_lo_floor_ms")
                            if k in row})
        del args, x, w1, b1, w2, b2, dy, lib_in, held, w1t, w2t
        torch.cuda.empty_cache()
    # the dw kernel's other plans, checked and timed alone; then the probes
    for R, E, F in DW_EXTRA_SHAPES:
        ok &= dw_case(torch, fm, mlp_operands(torch, g, R, E, F, torch.bfloat16), peaks,
                      regs)["ok"]
    probe = dw_cancel_probe(torch, fm)
    emit(dict(phase="kernels_fused_mlp_dw_cancel", shape="R=64 E=768 F=3072 bfloat16",
              limit="mlp_limit on dw1; the control (du cast to bf16 once) must miss", **probe))
    ok &= probe["ok"]
    ok &= run_fwd_dx_probes(torch, fm)
    for R, E, F in MLP_FP32_SHAPES:
        held = mlp_held(torch, fm, mlp_operands(torch, g, R, E, F, torch.float32))
        for name, h in held.items():
            emit(dict(phase="kernels_fused_mlp_fp32", name=name, shape=f"R={R} E={E} F={F}", **h,
                      limit="mlp_limit: 1e-5 of the fp32 addends' magnitudes"))
            ok &= h["ok"]
    # the GELU's form on both bf16 routes of the forward (R = 8 takes the
    # mma.sync forward by the row rule; forced, the tensor-core one; dx takes
    # its tensor-core entry in both) and in fp32
    for dt, R, E, F, band, sm90 in ((torch.bfloat16, 8, 768, 3072, (-3.2, -2.6), False),
                                    (torch.bfloat16, 8, 768, 3072, (-3.2, -2.6), True),
                                    (torch.float32, 3, 64, 256, (2.3, 3.2), False)):
        with forced_route(fm, sm90):
            probe = fused_mlp_gelu_probe(torch, fm, R, E, F, dt, band)
        row_ok = all(p["ok"] for p in probe.values())
        emit(dict(phase="kernels_fused_mlp_gelu_probe", shape=f"R={R} E={E} F={F} {str(dt)[6:]}",
                  route="sm90" if sm90 else "mma.sync", b1_band=band, outputs=probe, ok=row_ok))
        ok &= row_ok
    return rows, ok


def run_fwd_dx_probes(torch, fm) -> bool:
    """The tensor-core forward's and dx's cancellation probes
    (``kernels_fused_mlp_fwd_cancel``, ``kernels_fused_mlp_dx_cancel``)."""
    ok = True
    for phase, name, probe, carried in (
            ("kernels_fused_mlp_fwd_cancel", "fused_mlp_fwd_sm90", fwd_cancel_probe,
             "u + b1 before the GELU, the splits' partials"),
            ("kernels_fused_mlp_dx_cancel", "fused_mlp_bwd_dx_sm90", dx_cancel_probe,
             "dh across the blocks of E, the splits' partials")):
        res = probe(torch, fm)
        emit(dict(phase=phase, name=name, shape=f"R=2048 E={MLP_E} F={MLP_F} bfloat16",
                  max_err=None, carried_in_fp32=carried,
                  limit="mlp_limit; each control (that intermediate rounded to bf16) must miss",
                  **res))
        ok &= res["ok"]
    return ok


def run_fwd_dx_checks(torch) -> bool:
    """The tensor-core forward and dx untimed at ``MLP_SHAPES``: every
    output within ``mlp_limit`` of the plain version and of the plain model
    of the entry's order, finite, a bitwise repeat, exact launches by kernel
    (``sm90_held``); then their cancellation probes. For
    ``scripts/fused_mlp_planted_faults.py``."""
    from deepspeed_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    ok = True
    with forced_route(fm, True):
        for R, E, F in MLP_SHAPES:
            args = mlp_operands(torch, g, R, E, F, torch.bfloat16)
            held = mlp_held(torch, fm, args, ("y", "dx"))
            extra = sm90_held(torch, fm, args)
            for name, h in held.items():
                row = dict(phase="kernels_fused_mlp", name=name, shape=f"R={R} E={E} F={F} bfloat16",
                           **h, **{k: v for k, v in extra[name].items() if k != "ok"})
                row["ok"] = h["ok"] and extra[name]["ok"]
                emit(row)
                ok &= row["ok"]
            del args
            torch.cuda.empty_cache()
        ok &= run_fwd_dx_probes(torch, fm)
    return ok


def run_slice_fused_mlp(torch, out_dir=None):
    """gpt2-125m with ``fused_mlp=True`` (random weights from seed 1234)
    through ``init_inference(max_tokens=512)`` in bf16: ``engine(ids)`` at
    B=2, S=1024 held against the unfused bf16 engine with the same weights
    and both against an fp32 engine on the card (which the rule leaves
    unfused: fits_vmem fails at fp32); ``generate`` (B=8, prompt 256, 128
    new) with the fused decode ticks and with ``decode_fused=False`` (every
    tick through the fused FFN); one page-resident ``ContinuousBatcher``
    pass of the serve phase's 32 requests. Gates: exact launch counts on
    every path (``fused_mlp_fwd``: one per layer and multi-token forward,
    and per unfused tick), the fused forward no farther from the fp32
    engine's logits than the unfused bf16 one (RMS, within 10%) and within
    8 bf16 ulps of it at the logits' largest magnitude, and every greedy
    stream teacher-forced through the fp32 engine (tie-aware ≥ 99%, the
    argmax wherever its top two lie more than 16 ulps apart)."""
    from collections import Counter

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
    from deepspeed_tpu_torch.ops import fused_mlp as fm

    cfg = gpt2_config("gpt2-125m", fused_mlp=True)
    L, V = cfg.n_layer, cfg.vocab_size
    model = GPT2LMHeadModel(cfg).init_weights(torch.Generator().manual_seed(SEED))
    eng = ds.init_inference(model, dtype=torch.bfloat16, max_tokens=512)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    with torch.device("meta"):
        plain_template = GPT2LMHeadModel(gpt2_config("gpt2-125m"))
    unfused = ds.init_inference(plain_template, params=state, dtype=torch.bfloat16,
                                max_tokens=512)
    ref32 = ds.init_inference(model, dtype=torch.float32, max_tokens=512)
    del model, state
    checks = {"rule": all(b.mlp.use_fused() for b in eng.module.h)
              and not any(b.mlp.use_fused() for b in unfused.module.h)
              and not any(b.mlp.use_fused() for b in ref32.module.h)}
    by_path = {}

    # engine(ids) at B=2, S=1024 against the unfused engine and the fp32 one
    ids = torch.randint(0, V, (2, 1024), generator=torch.Generator().manual_seed(SEED + 1))
    eng(ids[:, :128])
    unfused(ids[:, :128])
    zero_counts()
    fwd = {}
    for k in ("first", "again"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = eng(ids)
        torch.cuda.synchronize()
        fwd[k] = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    by_path["forward_fused_mlp"] = launches
    expected = {n: 0 for n in launches}
    expected.update({"flash_attention_fwd": 2 * L, **mlp_path_names(fm, {2 * 1024: 2 * L})})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lu = unfused(ids)
    torch.cuda.synchronize()
    unfused_ms = (time.perf_counter() - t0) * 1e3
    lf, lu, l32 = logits[..., :V].float(), lu[..., :V].float(), ref32(ids)[..., :V].float()
    del logits

    def rel_rms(a, b):
        return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())

    ulp = bf16_ulp(float(l32.abs().max()))
    fwd_res = dict(fused_vs_fp32_rel_rms=rel_rms(lf, l32), unfused_vs_fp32_rel_rms=rel_rms(lu, l32),
                   fused_vs_fp32_max_err=float((lf - l32).abs().max()),
                   unfused_vs_fp32_max_err=float((lu - l32).abs().max()),
                   tol_8ulp=8 * ulp, fused_vs_unfused_max_err=float((lf - lu).abs().max()),
                   fused_vs_unfused_top1=float((lf.argmax(-1) == lu.argmax(-1)).float().mean()),
                   fused_top1_within_2ulp_of_fp32=near_max_share(lf.argmax(-1), l32, 2 * ulp))
    del lf, lu, l32
    checks["forward_launch_counts"] = launches == expected
    checks["forward_vs_fp32"] = (fwd_res["fused_vs_fp32_rel_rms"]
                                 <= 1.1 * fwd_res["unfused_vs_fp32_rel_rms"]
                                 and fwd_res["fused_vs_fp32_max_err"] <= 8 * ulp
                                 and fwd_res["fused_top1_within_2ulp_of_fp32"] >= 0.99)
    emit(dict(phase="slice_fused_mlp_forward", model="gpt2-125m", shape=[2, 1024],
              forward_ms=fwd["first"], forward_again_ms=fwd["again"],
              unfused_forward_ms=unfused_ms, launches=launches, expected_launches=expected,
              **fwd_res))

    # generate with fused decode ticks, and with every tick unfused
    prompt = torch.randint(0, V, (8, 256), generator=torch.Generator().manual_seed(SEED + 2))
    new = 128
    nofuse = ds.init_inference(GPT2LMHeadModel(cfg, device="meta"),
                               params={k: v.detach() for k, v in eng.module.state_dict().items()},
                               dtype=torch.bfloat16, max_tokens=512, decode_fused=False)
    for path, eg, fused in (("generate_fused_mlp", eng, True),
                            ("generate_fused_mlp_unfused_ticks", nofuse, False)):
        eg.generate(prompt[:, :32], max_new_tokens=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eg.generate(prompt, max_new_tokens=1)
        torch.cuda.synchronize()
        ttft = (time.perf_counter() - t0) * 1e3
        zero_counts()
        t0 = time.perf_counter()
        out = eg.generate(prompt, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        by_path[path] = launches
        ticks = new - 1
        expected = {n: 0 for n in launches}
        # the prompt's prefill (8 x 256 rows), then every unfused tick's 8 rows
        expected.update({"decode_attention": L * ticks,
                         **mlp_path_names(fm, {8 * 256: L, **({} if fused else {8: L * ticks})})})
        if fused:
            expected.update({"norm_qkv": L * ticks, "post_attn": L * ticks})
        tf = teacher_forced(torch, ref32, [(s, 256) for s in out], V)
        checks[f"{path}_launch_counts"] = launches == expected
        checks[f"{path}_teacher_forced"] = tf["within_2ulp"] >= 0.99 and tf["decisive_strict"] == 1.0
        checks[f"{path}_shape"] = tuple(out.shape) == (8, 256 + new) and int(out.max()) < V
        emit(dict(phase="slice_fused_mlp_generate", path=path, shape=[8, 256, new],
                  ttft_ms=ttft, generate_ms=wall, ms_per_tick=(wall - ttft) / ticks,
                  decode_tokens_per_s=8 * ticks / ((wall - ttft) / 1e3), launches=launches,
                  expected_launches=expected, teacher_forced_vs_fp32=tf))
    del nofuse

    # one page-resident batcher pass of the serve phase's requests
    reqs = serve_requests(V)
    batcher = ds.ContinuousBatcher(eng, n_slots=8, seed=SEED,
                                   prefix_cache={"page_tokens": 16, "n_pages": 512})
    chunks0 = Counter(batcher.prefill_chunks)
    zero_counts()
    outs, nums = serve_pass(torch, batcher, reqs)
    launches = read_counts()
    by_path["serve_fused_mlp_paged"] = launches
    chunks = batcher.prefill_chunks - chunks0
    singles = nums["ticks"] + nums["one_token_prefills"]
    multi = sum(n for (B, S), n in chunks.items() if S > 1)
    mlp_rows = {}   # each multi-token chunk's B x S rows, once a layer
    for (B, S), n in chunks.items():
        if S > 1:
            mlp_rows[B * S] = mlp_rows.get(B * S, 0) + L * n
    expected = {n: 0 for n in launches}
    expected.update({"paged_attention": L * singles, "norm_qkv": L * singles,
                     "post_attn": L * singles, **mlp_path_names(fm, mlp_rows)})
    tf = teacher_forced(torch, ref32, [(outs[i], len(reqs[i]["prompt"]))
                                       for i in range(0, len(reqs), 2)], V)
    checks["serve_launch_counts"] = launches == expected and multi > 0
    checks["serve_no_leaks"] = (all(v == 0 for v in nums["leaks"].values())
                                and all(v == 0 for v in batcher.leak_counts().values()))
    checks["serve_teacher_forced"] = tf["within_2ulp"] >= 0.99 and tf["decisive_strict"] == 1.0
    checks["serve_shapes"] = all(len(o) == len(r["prompt"]) + r["max_new_tokens"]
                                 and int(o.max()) < V for o, r in zip(outs, reqs))
    emit(dict(phase="slice_fused_mlp_serve", path="serve_fused_mlp_paged", n_slots=8,
              requests=len(reqs), pass_=nums,
              prefill_chunks={f"{B}x{S}": n for (B, S), n in sorted(chunks.items())},
              launches=launches, expected_launches=expected, teacher_forced_vs_fp32=tf))
    emit(dict(phase="slice_fused_mlp", model="gpt2-125m", fused_mlp=True, checks=checks))
    del batcher, eng, unfused, ref32
    torch.cuda.empty_cache()
    return by_path, all(checks.values())


def run_train_fused_mlp(torch, peaks, unfused_peak_gb, out_dir=None):
    """gpt2-125m with ``fused_mlp=True`` at the flagship config (S=1024,
    micro 24, gas 4, ZeRO 1; ``train_config``): a gradient gate on one 2 x
    1024 micro-batch (the bf16 fused engine against the fp32 engine, which
    the rule leaves unfused, and against the bf16 unfused engine: per leaf,
    cosine with fp32 ≥ 0.99, and a relative L2 distance from fp32 at most
    twice the unfused bf16 engine's plus 1e-3), 2 warm-up and 4 timed
    steps (losses finite and falling; exactly 12 × 4 launches per step of
    each fused FFN entry the row rule gives 24576 rows, the tensor-core
    forward and dx, and dw, and of the flash forward and merged backward;
    peak memory beside the unfused train phase's), one profiled step, and
    one step of an engine under ``remat_policy="dots_saveable"`` from the
    same weights (its loss within 1e-3 of the non-remat engine's at those
    weights; the recompute reruns the fused forward and the flash forward:
    2 × 12 × 4 launches of each, 12 × 4 of each backward kernel). The
    library's own counts show every timed call ran the Hopper kernels
    (``dw_sm90_kernel``; ``h_sm90_kernel`` and ``y_sm90_kernel``,
    ``du_sm90_kernel`` and ``dx_sm90_kernel`` once a row chunk) and none
    of the others; the profiled step gives the forward's, dx's and dw's
    device ms beside the step's."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, gpt2_config
    from deepspeed_tpu_torch.ops import fused_mlp as fm

    cfg = gpt2_config("gpt2-125m", n_positions=1024, loss_chunk=1 << 30, fused_mlp=True)
    L = cfg.n_layer
    ids2 = text_like_ids(np.random.default_rng(SEED + 7), 2, 1024, cfg.vocab_size)

    def grads(dtype, fused):
        model = GPT2LMHeadModel(dataclasses.replace(cfg, dtype=dtype, fused_mlp=fused),
                                device="meta")
        eng, *_ = ds.initialize(model=model, config=train_config(2, 1, "fp32"))
        eng.init_params()
        zero_counts()
        _, g = eng._grads_of(eng._to_device({"input_ids": ids2, "labels": ids2}))
        torch.cuda.synchronize()
        counts = read_counts()
        out = {n: x.float() for n, x in zip(eng._names, g)}
        del eng, g
        torch.cuda.empty_cache()
        return out, counts

    g32, c32 = grads(torch.float32, True)
    gf, cf = grads(torch.bfloat16, True)
    gu, cu = grads(torch.bfloat16, False)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    leaves = {}
    for n in g32:
        if g32[n].abs().max() == 0:
            continue
        cos = float(torch.nn.functional.cosine_similarity(gf[n].flatten(), g32[n].flatten(),
                                                          dim=0))
        leaves[n] = dict(cos_fused_fp32=cos, rel_fused_fp32=rel(gf[n], g32[n]),
                         rel_unfused_fp32=rel(gu[n], g32[n]), rel_fused_unfused=rel(gf[n], gu[n]))
    del g32, gf, gu
    gate_ok = all(v["cos_fused_fp32"] >= 0.99
                  and v["rel_fused_fp32"] <= 2 * v["rel_unfused_fp32"] + 1e-3
                  for v in leaves.values())
    worst = max(leaves, key=lambda n: leaves[n]["rel_fused_fp32"] / max(
        leaves[n]["rel_unfused_fp32"], 1e-12))
    one = {**mlp_path_names(fm, {2 * 1024: L}),
           **mlp_path_names(fm, {2 * 1024: L}, "fused_mlp_bwd_dx"), "fused_mlp_bwd_dw": L}
    checks = {"grad_gate": gate_ok,
              "grad_gate_launches": all(cf[k] == v for k, v in one.items())
              and all(c32[k] == 0 and cu[k] == 0 for k in one)}
    emit(dict(phase="train_fused_mlp_grad_gate", model="gpt2-125m", micro_batch=[2, 1024],
              leaves=len(leaves), min_cos_fused_fp32=min(v["cos_fused_fp32"]
                                                         for v in leaves.values()),
              max_rel_fused_fp32=max(v["rel_fused_fp32"] for v in leaves.values()),
              max_rel_unfused_fp32=max(v["rel_unfused_fp32"] for v in leaves.values()),
              max_rel_fused_unfused=max(v["rel_fused_unfused"] for v in leaves.values()),
              worst_leaf={worst: leaves[worst]}, launches_fused=cf, launches_fp32=c32,
              launches_unfused=cu, checks=dict(checks)))

    micro, gas, S = 24, 4, 1024
    model = GPT2LMHeadModel(cfg, device="meta")
    eng, *_ = ds.initialize(model=model, config=train_config(micro, gas))
    eng.init_params()
    ids = text_like_ids(np.random.default_rng(SEED + 8), micro * gas, S, cfg.vocab_size)
    batch = eng._to_device({"input_ids": ids, "labels": ids})
    t0 = time.perf_counter()
    warm = eng.train_batches(batch, 2, stacked=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    steps = 4
    by_kernel = fm.kernel_launches()
    t0 = time.perf_counter()
    losses = eng.train_batches(batch, steps, stacked=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    by_kernel = {k: v - by_kernel[k] for k, v in fm.kernel_launches().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in torch.cat([warm, losses])]
    per_step = {**mlp_path_names(fm, {micro * S: L * gas}),
                **mlp_path_names(fm, {micro * S: L * gas}, "fused_mlp_bwd_dx"),
                "fused_mlp_bwd_dw": L * gas, "flash_attention_fwd": L * gas,
                "flash_attention_bwd_merged": L * gas}
    expected = {n: steps * per_step.get(n, 0) for n in launches}
    tok_s = steps * micro * gas * S / wall
    chunks = -(-micro * S // fm.mlp_plan(micro * S, MLP_E, MLP_F).chunk_rows)

    eng.train_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        eng.train_batch(batch)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    by_name = device_ms_of(prof)
    dev_ms = sum(by_name.values())
    dw_ms = sum(v for k, v in by_name.items() if "dw_sm90_kernel" in k)
    fwd_ms = sum(v for k, v in by_name.items() if "h_sm90_kernel" in k or "y_sm90_kernel" in k)
    dx_ms = sum(v for k, v in by_name.items() if "du_sm90_kernel" in k or "dx_sm90_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    if out_dir:
        with open(os.path.join(out_dir, "profile_train_fused_mlp_step.txt"), "w") as fh:
            fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    del prof

    # remat dots_saveable from the same weights
    ref_loss = float(eng.eval_batch(batch))
    rcfg = {**train_config(micro, gas), "activation_checkpointing": {
        "enabled": True, "policy": "dots_saveable"}}
    e2, *_ = ds.initialize(model=GPT2LMHeadModel(cfg, device="meta"), config=rcfg,
                           model_parameters=eng.params)
    zero_counts()
    t1 = time.perf_counter()
    remat_loss = float(e2.train_batch(batch))
    torch.cuda.synchronize()
    remat_ms = (time.perf_counter() - t1) * 1e3
    remat_launches = read_counts()
    remat_want = {**per_step, **mlp_path_names(fm, {micro * S: 2 * L * gas}),
                  "flash_attention_fwd": 2 * L * gas}
    remat_expected = {n: remat_want.get(n, 0) for n in remat_launches}
    del e2
    checks.update({
        "losses_finite": all(math.isfinite(x) for x in losses + [remat_loss, ref_loss]),
        "loss_falling": losses[-1] < losses[2] and losses[-1] < losses[0],
        "launch_counts": launches == expected,
        # each step's L x gas dw calls ran the Hopper kernel, none the fp32 one;
        # the forward and dx calls their tensor-core GEMMs, once a row chunk
        "dw_launches_by_kernel": by_kernel["dw_sm90_kernel"] == steps * L * gas
        and by_kernel["dw_kernel"] == 0,
        "fwd_dx_launches_by_kernel": all(
            by_kernel[k] == steps * L * gas * chunks for k in (
                "h_sm90_kernel", "y_sm90_kernel", "du_sm90_kernel", "dx_sm90_kernel"))
        and by_kernel["fwd_kernel"] == 0 and by_kernel["dx_kernel"] == 0,
        "remat_launch_counts": remat_launches == remat_expected,
        "remat_loss": abs(remat_loss / ref_loss - 1) <= 1e-3})
    emit(dict(phase="train_fused_mlp", model="gpt2-125m", config=train_config(micro, gas),
              fused_mlp=True, dtype="bfloat16", batch=[micro * gas, S], warmup_s=warm_s,
              timed_steps=steps, wall_s=wall, ms_per_step=wall * 1e3 / steps,
              tokens_per_s=tok_s, mfu=model.flops_per_token() * tok_s / peaks[1],
              max_memory_allocated_gb=peak_gb, unfused_train_max_memory_allocated_gb=unfused_peak_gb,
              losses=losses, launches=launches, expected_launches=expected,
              fused_mlp_launches_by_kernel=by_kernel,
              profile=dict(step_wall_ms=prof_wall,
                           step_device_ms=dev_ms if dev_ms else "not measured",
                           dw_sm90_device_ms=dw_ms if dev_ms else "not measured",
                           fwd_sm90_device_ms=fwd_ms if dev_ms else "not measured",
                           dx_sm90_device_ms=dx_ms if dev_ms else "not measured",
                           device_busy_share=dev_ms / prof_wall if dev_ms else "not measured",
                           top_device_ms={k[:90]: v for k, v in top}),
              remat=dict(policy="dots_saveable", loss=remat_loss, loss_at_same_weights=ref_loss,
                         loss_rel_diff=abs(remat_loss / ref_loss - 1), step_ms_first=remat_ms,
                         launches=remat_launches, expected_launches=remat_expected),
              checks=checks))
    del eng, batch
    torch.cuda.empty_cache()
    return ({"train_fused_mlp": launches, "train_fused_mlp_remat": remat_launches},
            all(checks.values()))


# ---------------------------------------------------------------------------
# BERT-large ops: block-sparse attention and the fused LayerNorm / bias-GELU /
# attention-softmax ops (kernels_sparse, kernels_fused_ops, and the paths
# sparse_attention_api and fused_ops_train)
# ---------------------------------------------------------------------------

SPARSE_KERNEL = "sparse_attention_fwd"            # bf16: sparse_fwd_sm90_kernel (+ merge)
SPARSE_KERNEL_FP32 = "sparse_attention_fwd_fp32"  # fp32: the CUDA-core sparse_fwd_kernel
FUSED_OPS_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "bias_gelu_fwd", "bias_gelu_bwd",
                     "softmax_fwd", "softmax_bwd")
NO_BERT_OPS = {n: 0 for n in (SPARSE_KERNEL, SPARSE_KERNEL_FP32) + FUSED_OPS_KERNELS}
FUSED_OPS_LINES = {"layer_norm_fwd": ":46", "layer_norm_bwd": ":60", "bias_gelu_fwd": ":179",
                   "bias_gelu_bwd": ":184", "softmax_fwd": ":259", "softmax_bwd": ":275"}
BERT_E, BERT_H, BERT_D, BERT_F = 1024, 16, 64, 4096   # BERT-large
BERT_B, BERT_S = 16, 512                               # phase-2 pretraining: 8192 tokens
SPARSE_API_CALLS = 4


def ulp_t(torch, x, dtype):
    """Elementwise spacing of ``dtype`` values (bf16 or fp32) at |x|."""
    e = torch.floor(torch.log2(x.abs().float().clamp(min=1e-30)))
    return torch.exp2(e - (7 if dtype == torch.bfloat16 else 23))


def sparse_layouts():
    """The sparse cases: (name, sparsity config, causal, seq_len, batch, the
    query blocks to empty, the query blocks to fill). a-d at BERT-large's
    phase-2 pretraining length, e-f at the long sequence sparse attention
    exists for; g puts one row of all 64 key blocks (16 key tiles of the
    tensor-core kernel, two pieces of its cap of 8, merged by lse; the other
    tiles take 5) beside an empty query block of the same tile and another
    elsewhere."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
        FixedSparsityConfig, VariableSparsityConfig)

    H = BERT_H
    return [("a_fixed", FixedSparsityConfig(num_heads=H, block=16), False, BERT_S, BERT_B, (), ()),
            ("b_fixed_uni_causal", FixedSparsityConfig(num_heads=H, block=16,
                                                       attention="unidirectional"),
             True, BERT_S, BERT_B, (), ()),
            ("c_dense", DenseSparsityConfig(num_heads=H, block=16), False, BERT_S, BERT_B, (), ()),
            ("d_fixed_empty_row", FixedSparsityConfig(num_heads=H, block=16), False, BERT_S,
             BERT_B, (5,), ()),
            ("e_bigbird", BigBirdSparsityConfig(num_heads=H, block=64), False, 4096, 2, (), ()),
            ("e_bslongformer", BSLongformerSparsityConfig(num_heads=H, block=64), False, 4096,
             2, (), ()),
            ("e_variable", VariableSparsityConfig(num_heads=H, block=64), False, 4096, 2, (), ()),
            ("f_bigbird_per_head", BigBirdSparsityConfig(num_heads=H, block=64,
                                                         different_layout_per_head=True),
             False, 4096, 2, (), ()),
            ("g_wide_row_empty_rows", FixedSparsityConfig(num_heads=H, block=16), False, 1024, 8,
             (10, 40), (9,))]


def sparse_keep(torch, layout, block, causal, device):
    """The (H, S, S) bool element mask a layout enables (and the causal
    triangle)."""
    keep = torch.from_numpy(layout != 0).to(device)
    keep = keep.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        keep = keep & torch.ones(keep.shape[1:], dtype=torch.bool, device=device).tril()
    return keep


def sparse_errors(torch, got, ref, q, k, v, keep, scale, tiled=None):
    """The kernel against its plain version, element by element: within one
    ulp of the output's dtype at the larger of the two plus 1e-5 of the sum of
    its addends' magnitudes, sum_j p_j |v_j| / l (the attention limit of the
    decode and paged rows). Then the fp64 witness: the kernel and the plain
    version against the same function in fp64, in units of the limit, and
    the kernel within max(1, the plain version's ratio) of it. ``tiled``
    (the plan's plain twin's output) is held against the plain version by
    the same limit (``tiled_plain_err_over_limit``). Batch by batch (the
    fp64 scores of S=4096 take 2 GiB a batch)."""
    worst = dict(max_err=0.0, err_over_limit=0.0, kernel_vs_fp64_over_limit=0.0,
                 plain_vs_fp64_over_limit=0.0)
    if tiled is not None:
        worst["tiled_plain_err_over_limit"] = 0.0
    for b in range(q.shape[0]):
        s = torch.einsum("shd,thd->hst", q[b].double() * scale, k[b].double())
        s = s.masked_fill(~keep, float("-inf"))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
        del s
        l = p.sum(-1, keepdim=True)
        l = torch.where(l == 0, torch.ones_like(l), l)
        vd = v[b].double()
        exact = (torch.einsum("hst,thd->hsd", p, vd) / l).transpose(0, 1)
        mag = (torch.einsum("hst,thd->hsd", p, vd.abs()) / l).transpose(0, 1)
        del p
        g, r = got[b].double(), ref[b].double()
        lim = ulp_t(torch, torch.maximum(g.abs(), r.abs()), got.dtype).double() + 1e-5 * mag
        lim_x = ulp_t(torch, exact, got.dtype).double() + 1e-5 * mag
        d = (g - r).abs()
        worst["max_err"] = max(worst["max_err"], float(d.max()))
        worst["err_over_limit"] = max(worst["err_over_limit"], float((d / lim).max()))
        worst["kernel_vs_fp64_over_limit"] = max(worst["kernel_vs_fp64_over_limit"],
                                                 float(((g - exact).abs() / lim_x).max()))
        worst["plain_vs_fp64_over_limit"] = max(worst["plain_vs_fp64_over_limit"],
                                                float(((r - exact).abs() / lim_x).max()))
        if tiled is not None:
            x = tiled[b].double()
            lim_t = ulp_t(torch, torch.maximum(x.abs(), r.abs()), got.dtype).double() + 1e-5 * mag
            worst["tiled_plain_err_over_limit"] = max(worst["tiled_plain_err_over_limit"],
                                                      float(((x - r).abs() / lim_t).max()))
    worst["fp64_anchor_ok"] = (worst["kernel_vs_fp64_over_limit"]
                               <= max(1.0, worst["plain_vs_fp64_over_limit"]))
    return worst


def sparse_launched(ssa, before=None):
    """The sparse kernels' launch counts: each C entry's (the wrappers'
    counters) and each kernel's (the library's own), minus ``before``."""
    now = {SPARSE_KERNEL: ssa.KERNEL.launches, SPARSE_KERNEL_FP32: ssa.KERNEL_FP32.launches,
           **ssa.kernel_launches()}
    return now if before is None else {n: c - before[n] for n, c in now.items()}


def sparse_case(torch, F, peaks, g, name, cfg, causal, S, B, empty, wide, dtype, timed,
                D=BERT_D):
    """One sparse case: the kernel (through ``sparse_attention``, impl
    "pallas", which builds the plan; then again through the kernel wrapper
    on a plan built once, bit for bit) against its plain version on the
    same inputs, with its exact launches; in bf16 the plan's plain twin
    (``sparse_attention_tiled_plain``) by the same limit. With ``timed``:
    its device time, the plain version's, SDPA with the expanded boolean
    element mask (library), dense SDPA without a mask, the bound and (bf16)
    the hi + lo floor: 6 B pairs D flops, since p v runs twice."""
    import numpy as np

    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ssa

    H, block = BERT_H, cfg.block
    layout = cfg.make_layout(S)
    for qi in wide:
        layout[:, qi, :] = 1
    for qi in empty:
        layout[:, qi, :] = 0
    dplan = ssa.plan_on(layout, block, causal, "cuda")
    scale = D ** -0.5
    n_sets = 3 if timed else 1
    sets = [tuple(torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
                  for _ in range(3)) for _ in range(n_sets)]
    q, k, v = sets[0]
    torch.cuda.synchronize()
    before = sparse_launched(ssa)
    got = ssa.sparse_attention(q, k, v, layout, block, causal=causal, impl="pallas")
    torch.cuda.synchronize()
    launched = sparse_launched(ssa, before)
    again = ssa.sparse_attention_kernel(q, k, v, dplan, scale)
    ref = ssa.sparse_attention_plain(q, k, v, dplan.lut, dplan.counts, block, causal, scale)
    bf16 = dtype == torch.bfloat16
    tiled = ssa.sparse_attention_tiled_plain(q, k, v, dplan.plan, scale) if bf16 else None
    torch.cuda.synchronize()
    keep = sparse_keep(torch, layout, block, causal, "cuda")
    res = sparse_errors(torch, got, ref, q, k, v, keep, scale, tiled)
    rows_empty = [slice(qi * block, (qi + 1) * block) for qi in empty]
    empty_zero = all(bool((got[:, r] == 0).all()) for r in rows_empty)
    finite = bool(torch.isfinite(got.float()).all())
    n_merges = len(dplan.plan.merges)
    expect = {SPARSE_KERNEL: int(bf16), SPARSE_KERNEL_FP32: int(not bf16),
              "sparse_fwd_sm90_kernel": int(bf16),
              "sparse_merge_kernel": int(bf16 and n_merges > 0),
              "sparse_fwd_kernel": int(not bf16)}
    nnz = int(layout.sum())
    pairs = int(keep.sum())   # (query, key) pairs this run's data needs, over the heads
    items = dplan.plan.items
    row = dict(phase="kernels_sparse" if bf16 else "kernels_sparse_fp32",
               name=SPARSE_KERNEL if bf16 else SPARSE_KERNEL_FP32,
               case=name, shape=f"B={B} S={S} H={H} D={D} block={block} {str(dtype)[6:]}"
               + (" causal" if causal else ""), layout=type(cfg).__name__,
               per_head=cfg.different_layout_per_head, density=nnz / layout.size,
               blocks_per_row=[int(layout.sum(-1).min()), int(layout.sum(-1).max())],
               empty_query_blocks=list(empty), wide_query_blocks=list(wide),
               empty_rows_zero=empty_zero, finite=finite, repeat_bitwise=torch.equal(got, again),
               launches=launched, expected_launches=expect,
               plan=dict(items=len(items), key_tiles=int(items[:, 2].sum()),
                         widest_item=int(items[:, 2].max()), merges=n_merges,
                         slots=dplan.plan.n_slots),
               limit="per element: 1 ulp of the output dtype + 1e-5 x sum_j p_j |v_j| / l; "
               "and against the fp64 value within max(1, the plain version's ratio)", **res)
    row["ok"] = (res["err_over_limit"] <= 1.0 and res["fp64_anchor_ok"] and finite
                 and empty_zero and row["repeat_bitwise"] and launched == expect
                 and res.get("tiled_plain_err_over_limit", 0.0) <= 1.0)
    if timed:
        mask = keep[None]
        qt = [tuple(x.transpose(1, 2) for x in st) for st in sets]
        rot = Rotation(list(range(n_sets)))
        iters = 20
        row["kernel_ms"] = device_ms(torch, lambda: ssa.sparse_attention_kernel(
            *sets[rot.next()], dplan, scale), iters)
        row["kernel_event_ms"] = cuda_ms(torch, lambda: ssa.sparse_attention_kernel(
            *sets[rot.next()], dplan, scale), iters)
        row["plain_ms"] = device_ms(torch, lambda: ssa.sparse_attention_plain(
            q, k, v, dplan.lut, dplan.counts, block, causal, scale), 2)
        row["dense_sdpa_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(
            *qt[rot.next()]), iters)
        if bool(keep.all()):   # the Dense layout: SDPA without a mask is the same function
            row["library_ms"] = row["dense_sdpa_ms"]
            row["library"] = "SDPA without a mask"
        else:
            row["library_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(
                *qt[rot.next()], attn_mask=mask), iters)
            row["library"] = ("SDPA with the expanded boolean element mask (the same "
                              "function wherever every query row has a block)")
        per_row = layout.sum(-1)
        if bf16 and per_row.max() >= 4 * np.median(per_row):
            # the launch's old tail: the widest LUT rows (BigBird's and
            # BSLongformer's global rows) alone, and every row but those,
            # each from a plan of its own sub-layout
            wide_rows = (per_row == per_row.max())[..., None]
            for key, sub in (("widest_rows_alone_ms", layout * wide_rows),
                             ("without_widest_rows_ms", layout * ~wide_rows)):
                sub_plan = ssa.plan_on(sub, block, causal, "cuda")
                row[key] = device_ms(torch, lambda p=sub_plan: ssa.sparse_attention_kernel(
                    *sets[rot.next()], p, scale), iters)
        item = 2 if bf16 else 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            4 * B * S * H * D * item + dplan.lut.numel() * 4 + dplan.counts.numel() * 4,
            4.0 * B * pairs * D, peaks, not bf16)
        if bf16:
            row["hi_lo_floor_ms"] = 6.0 * B * pairs * D / peaks[1] * 1e3
        row["ok"] = row["ok"] and row["kernel_ms"] is not None
    emit(row)
    del sets, q, k, v, got, again, ref, keep, tiled
    torch.cuda.empty_cache()
    return row


AT_SHAPE_KEYS = ("case", "shape", "layout", "density", "max_err", "err_over_limit",
                 "kernel_ms", "plain_ms", "library_ms", "dense_sdpa_ms", "bound_ms", "bound_by",
                 "hi_lo_floor_ms", "widest_rows_alone_ms", "without_widest_rows_ms")


def run_kernels_sparse(torch, F, peaks, timed=True):
    """Block-sparse attention on the card: every case of ``sparse_layouts``
    in bf16 (timed) and fp32 (checked; case a timed), then the other head
    dim and blocks the kernels take (D=128; block 32 and 128) at a small
    shape, bf16 timed. Returns ({kernel: its case a row, the bf16 one with
    the others under ``at_shapes``}, ok); ``timed=False`` times nothing."""
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    main, ok = {}, True
    cases = [(name, cfg, causal, S, B, empty, wide, 64)
             for name, cfg, causal, S, B, empty, wide in sparse_layouts()]
    for block in (32, 128):
        for causal in (False, True):
            cfg = FixedSparsityConfig(num_heads=BERT_H, block=block,
                                      different_layout_per_head=True,
                                      num_different_global_patterns=2)
            cases.append((f"d128_block{block}" + ("_causal" if causal else ""), cfg, causal,
                          1024, 1, (), (), 128))
    for name, cfg, causal, S, B, empty, wide, D in cases:
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            row = sparse_case(torch, F, peaks, g, name, cfg, causal, S, B, empty, wide, dtype,
                              timed and (bf16 or name == "a_fixed"), D=D)
            ok &= row["ok"]
            if not timed:
                continue
            kname = SPARSE_KERNEL if bf16 else SPARSE_KERNEL_FP32
            if kname not in main:
                main[kname] = dict(row, at_shapes=[])
            elif bf16:
                main[kname]["at_shapes"].append({k: row[k] for k in AT_SHAPE_KEYS if k in row})
    return main, ok


def run_sparse_api(torch):
    """The public entry point, as a user calls it:
    ``SparseSelfAttention(FixedSparsityConfig(num_heads=16, block=16),
    impl="pallas")(q, k, v)`` at B=16, S=512, H=16, D=64 in bf16,
    SPARSE_API_CALLS times: exactly that many launches of the bf16 entry
    (one tensor-core kernel a call: no tile of this layout is split, so no
    merge) and none of any other kernel; the outputs finite, of the input's
    shape, equal call to call; the module's LUT and plan built once; a
    backward through it raises NotImplementedError. Then the same module in
    fp32 once (``sparse_attention_api_fp32``): one launch of the fp32 entry,
    held against the plain version. Returns ({path: counts}, ok)."""
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig, SparseSelfAttention
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ssa

    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    q, k, v = (torch.randn((BERT_B, BERT_S, BERT_H, BERT_D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    attn = SparseSelfAttention(FixedSparsityConfig(num_heads=BERT_H, block=16), impl="pallas")
    attn(q, k, v)    # the first call builds the layout, the LUT and the plan on the card
    torch.cuda.synchronize()
    zero_counts()
    c_before = ssa.kernel_launches()
    t0 = time.perf_counter()
    outs = [attn(q, k, v) for _ in range(SPARSE_API_CALLS)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / SPARSE_API_CALLS
    launches = read_counts()
    by_kernel = {n: c - c_before[n] for n, c in ssa.kernel_launches().items()}
    expected = {n: 0 for n in launches}
    expected[SPARSE_KERNEL] = SPARSE_API_CALLS
    try:
        qg = q.clone().requires_grad_()
        attn(qg, k, v).float().sum().backward()
        raised = False
    except NotImplementedError as e:
        raised = "B10" in str(e)
    checks = {"launch_counts": launches == expected,
              "kernel_counts": by_kernel == {"sparse_fwd_sm90_kernel": SPARSE_API_CALLS,
                                             "sparse_merge_kernel": 0, "sparse_fwd_kernel": 0},
              "finite_and_shaped": all(bool(torch.isfinite(o.float()).all())
                                       and o.shape == q.shape for o in outs),
              "repeatable": all(torch.equal(o, outs[0]) for o in outs),
              "lut_and_plan_cached": len(attn._luts) == 1 and len(attn._plans) == 1,
              "backward_raises": raised}
    emit(dict(phase="sparse_attention_api", shape=f"B={BERT_B} S={BERT_S} H={BERT_H} "
              f"D={BERT_D} bfloat16", calls=SPARSE_API_CALLS, wall_ms_per_call=wall_ms,
              launches={n: c for n, c in launches.items() if c}, launches_by_kernel=by_kernel,
              checks=checks, ok=all(checks.values())))

    q32, k32, v32 = (x.float() for x in (q, k, v))
    torch.cuda.synchronize()
    zero_counts()
    out32 = attn(q32, k32, v32)
    torch.cuda.synchronize()
    launches32 = read_counts()
    expected32 = {n: 0 for n in launches32}
    expected32[SPARSE_KERNEL_FP32] = 1
    dplan = attn.get_plan(BERT_S, q.device)
    ref = ssa.sparse_attention_plain(q32, k32, v32, dplan.lut, dplan.counts, 16, False,
                                     BERT_D ** -0.5)
    keep = sparse_keep(torch, attn.get_layout(BERT_S), 16, False, "cuda")
    res = sparse_errors(torch, out32, ref, q32, k32, v32, keep, BERT_D ** -0.5)
    checks32 = {"launch_counts": launches32 == expected32,
                "within_limit": res["err_over_limit"] <= 1.0 and res["fp64_anchor_ok"],
                "finite_and_shaped": bool(torch.isfinite(out32).all()) and
                out32.shape == q.shape and out32.dtype == torch.float32}
    emit(dict(phase="sparse_attention_api_fp32", shape=f"B={BERT_B} S={BERT_S} H={BERT_H} "
              f"D={BERT_D} float32", launches={n: c for n, c in launches32.items() if c},
              err_over_limit=res["err_over_limit"], checks=checks32, ok=all(checks32.values())))
    del q, k, v, outs, q32, k32, v32, out32, ref, keep
    torch.cuda.empty_cache()
    return ({"sparse_attention_api": launches, "sparse_attention_api_fp32": launches32},
            all(checks.values()) and all(checks32.values()))


def fused_ops_operands(torch, g, op, shape, dtype, dev="cuda"):
    """Inputs of one fused op: LayerNorm x ~ N(0, 1) (a residual stream's
    scale) with fp32 gamma ~ 1 + N(0, 0.1), beta ~ N(0, 0.1); bias-GELU x ~
    N(0, 1) (a projection's output) and bias ~ N(0, 0.02); softmax scores ~
    N(0, 8) (q.k at D=64, before the 1/8 scale). dy ~ N(0, 1) in x's dtype."""
    def r(*s, scale=1.0, dt=torch.float32):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dt)
    D = shape[-1]
    if op == "layer_norm":
        return (r(*shape, dt=dtype), 1 + r(D, scale=0.1), r(D, scale=0.1)), r(*shape, dt=dtype)
    if op == "bias_gelu":
        return (r(*shape, dt=dtype), r(D, scale=0.02)), r(*shape, dt=dtype)
    return (r(*shape, scale=8.0, dt=dtype),), r(*shape, dt=dtype)


def fused_ops_held(torch, fo, op, args, dy, kw, kernels=True, saved=None):
    """The fused op's kernels (or their plain versions) on rows: the forward
    outputs and the backward's, by kernel name. ``saved``: the outputs of
    another forward (the plain version's), which the backward then takes in
    place of this forward's, so that each backward kernel is held against
    its plain version on the same inputs."""
    sfx = "" if kernels else "_plain"
    if op == "layer_norm":
        x, gm, bt = args
        y, mean, rstd = getattr(fo, "layer_norm_fwd" + sfx)(x, gm, bt, 1e-5)
        src = {"mean": mean, "rstd": rstd} if saved is None else saved["layer_norm_fwd"]
        dx, dg, db = getattr(fo, "layer_norm_bwd" + sfx)(x, gm, src["mean"], src["rstd"], dy)
        return {"layer_norm_fwd": {"y": y, "mean": mean, "rstd": rstd},
                "layer_norm_bwd": {"dx": dx, "dgamma": dg, "dbeta": db}}
    if op == "bias_gelu":
        x, b = args
        y = getattr(fo, "bias_gelu_fwd" + sfx)(x, b)
        dx, db = getattr(fo, "bias_gelu_bwd" + sfx)(x, b, dy)
        return {"bias_gelu_fwd": {"y": y}, "bias_gelu_bwd": {"dx": dx, "dbias": db}}
    (s,) = args
    p = getattr(fo, "softmax_fwd" + sfx)(s, kw["causal"], kw["scale"])
    ds = getattr(fo, "softmax_bwd" + sfx)(p if saved is None else saved["softmax_fwd"]["p"], dy,
                                          kw["scale"])
    return {"softmax_fwd": {"p": p}, "softmax_bwd": {"ds": ds}}


def fused_ops_mags(torch, fo, op, args, dy, kw, ref):
    """Per output, the magnitudes of its fp32 addends (see fused_ops_held)."""
    f = torch.float32
    if op == "layer_norm":
        x, gm, bt = (a.float() for a in args)
        mean, rstd = ref["layer_norm_fwd"]["mean"], ref["layer_norm_fwd"]["rstd"]
        xhat = (x - mean) * rstd
        dyf = dy.float()
        dxh = (dyf * gm).abs()
        m2 = (dxh * xhat.abs()).mean(-1, keepdim=True)
        y0 = xhat.abs() * gm.abs() + bt.abs()
        # rstd moves by half var's relative error: var's addends over var
        rstd_mag = rstd.pow(3) * (x * x).mean(-1, keepdim=True)
        mean_mag = x.abs().mean(-1, keepdim=True)
        # y also carries the statistics' own sum-order error: the mean's
        # through rstd·|γ|, rstd's through |x − mean|·|γ| = |x̂|·|γ| / rstd
        return {"y": y0 + rstd * gm.abs() * mean_mag + xhat.abs() * gm.abs() * rstd_mag / rstd,
                "y_without_statistics": y0, "mean": mean_mag, "rstd": rstd_mag,
                "dx": rstd * (dxh + dxh.mean(-1, keepdim=True) + xhat.abs() * m2),
                "dgamma": (dyf * xhat).abs().sum(0), "dbeta": dyf.abs().sum(0)}
    if op == "bias_gelu":
        x, b = args
        u = x.float() + b.float()
        dmag = dy.float().abs() * (1 + u.abs() * (1 + 0.134 * u * u))
        return {"y": u.abs(), "dx": dmag, "dbias": dmag.sum(0)}
    p = ref["softmax_fwd"]["p"].float()
    dyf = dy.to(f)
    return {"p": p.abs(), "ds": p.abs() * (dyf.abs() + (p.abs() * dyf.abs()).sum(-1, keepdim=True))
            * kw["scale"]}


def fused_ops_check(torch, fo, op, args, dy, kw):
    """Each kernel's outputs against its plain version: per kernel, the
    largest error, error / limit, NaN positions equal, dtype equal and ok.
    Limit: one ulp of the output's dtype at the plain value (the one-pass
    statistics mean and rstd: fp32 ulps) plus 1e-5 of the magnitudes."""
    ref = fused_ops_held(torch, fo, op, args, dy, kw, False)
    got = fused_ops_held(torch, fo, op, args, dy, kw, True, saved=ref)
    torch.cuda.synchronize()
    mags = fused_ops_mags(torch, fo, op, args, dy, kw, ref)
    per = {}
    for kname, outs in ref.items():
        p = per[kname] = dict(max_err=0.0, err_over_limit=0.0, outputs={})
        for out, r in outs.items():
            gt = got[kname][out]
            nan_r, nan_g = torch.isnan(r), torch.isnan(gt)
            live = ~nan_r
            lim = ulp_t(torch, r.float(), r.dtype) + 1e-5 * mags[out].float()
            d = torch.where(live, (gt.float() - r.float()).abs(), torch.zeros_like(lim))
            q = torch.where(live, d / lim.clamp(min=1e-30), torch.zeros_like(lim))
            err, ratio = float(d.max()), float(q.max())
            p["outputs"][out] = dict(max_err=err, err_over_limit=ratio,
                                     nan_rows_equal=bool(torch.equal(nan_r, nan_g)),
                                     nans=int(nan_r.sum()), dtype=str(gt.dtype)[6:],
                                     dtype_ok=gt.dtype == r.dtype)
            if f"{out}_without_statistics" in mags:   # the earlier limit: printed, not gated
                lim0 = ulp_t(torch, r.float(), r.dtype) \
                    + 1e-5 * mags[f"{out}_without_statistics"].float()
                p["outputs"][out]["err_over_limit_without_statistics"] = float(
                    torch.where(live, d / lim0.clamp(min=1e-30), torch.zeros_like(lim0)).max())
            p["max_err"], p["err_over_limit"] = max(p["max_err"], err), max(p["err_over_limit"],
                                                                          ratio)
        p["ok"] = all(o["err_over_limit"] <= 1.0 and o["nan_rows_equal"] and o["dtype_ok"]
                      for o in p["outputs"].values())
    return per


# (op, shape, keywords): BERT-large at B=16, S=512 (8192 rows): the
# LayerNorm at E=1024, bias-GELU at F=4096, the attention softmax over
# (B*H, S, S) at scale 1/8, both masks; then a shorter query block (Sq < Sk)
FUSED_OPS_CASES = (
    ("layer_norm", (BERT_B * BERT_S, BERT_E), {}),
    ("bias_gelu", (BERT_B * BERT_S, BERT_F), {}),
    ("attention_softmax", (BERT_B * BERT_H, BERT_S, BERT_S), dict(causal=False, scale=0.125)),
    ("attention_softmax", (BERT_B * BERT_H, BERT_S, BERT_S), dict(causal=True, scale=0.125)),
    ("attention_softmax", (BERT_B * BERT_H, 128, BERT_S), dict(causal=True, scale=0.125)),
    # rows past the held softmax kernel's width: the wide route
    ("attention_softmax", (16, 64, 4096), dict(causal=True, scale=0.125)),
)
# fp32, checked: ragged widths (no 16-byte loads), odd rows, Sq > Sk (NaN rows)
FUSED_OPS_FP32_CASES = (
    ("layer_norm", (333, 1001), {}), ("layer_norm", (64, 1024), {}), ("layer_norm", (97, 2050), {}),
    ("bias_gelu", (333, 4099), {}), ("bias_gelu", (100, 4096), {}),
    ("attention_softmax", (3, 77, 130), dict(causal=True, scale=0.125)),
    ("attention_softmax", (3, 77, 513), dict(causal=False, scale=1.0)),
    ("attention_softmax", (4, 8, 5), dict(causal=True, scale=1.0)),
    ("attention_softmax", (2, 33, 2051), dict(causal=False, scale=1.0)),
)


def softmax_kept_keys(shape, causal: bool) -> int:
    """Keys the softmax forward must read over (BH, Sq, Sk): under
    ``causal``, min(Sk, max(0, Sk - Sq + i + 1)) for query i of each head."""
    BH, Sq, Sk = shape
    if not causal:
        return BH * Sq * Sk
    return BH * sum(min(Sk, max(0, Sk - Sq + i + 1)) for i in range(Sq))


def fused_ops_bound(op, shape, item, kname, peaks, causal: bool = False):
    """Each input read once and each output written once (parameters and
    their gradients fp32 here, mean and rstd fp32; the softmax forward reads
    only the kept keys, ``softmax_kept_keys``), against a count of fp32
    operations per element (LayerNorm 8 fwd / 12 bwd, GELU 12 / 20, softmax
    6 / 5) at the fp32 rate."""
    n = 1
    for s in shape:
        n *= s
    rows, D = n // shape[-1], shape[-1]
    kept = softmax_kept_keys(shape, causal) if kname == "softmax_fwd" else n
    nbytes, per_el = {
        "layer_norm_fwd": (2 * n * item + 2 * D * 4 + 2 * rows * 4, 8),
        "layer_norm_bwd": (3 * n * item + D * 4 + 2 * rows * 4 + 2 * D * 4, 12),
        "bias_gelu_fwd": (2 * n * item + D * 4, 12),
        "bias_gelu_bwd": (3 * n * item + 2 * D * 4, 20),
        "softmax_fwd": ((kept + n) * item, 6), "softmax_bwd": (3 * n * item, 5)}[kname]
    return bound_ms(nbytes, per_el * n, peaks, True)


# the LayerNorm backward's rows kernel (the one sweep; the wide route's is
# ln_bwd_wide_kernel) and the partial rows' sum, as the profiler names them
LN_BWD_KERNELS = ("ln_bwd_rows_kernel", "ln_bwd_wide_kernel", "ln_bwd_sum_kernel")
# the softmax forward's two routes, as the profiler names them
SOFTMAX_FWD_KERNELS = ("softmax_fwd_held_kernel", "softmax_fwd_wide_kernel")


def softmax_fwd_dirty_check(torch, fo, s, causal: bool, scale: float) -> dict:
    """The softmax forward kernel called twice, each time on output memory
    filled with NaN just before (a tensor of p's size filled and freed after
    emptying the allocator's cache, so that the call's ``empty_like`` gets
    its block back: ``dirty``): the two calls the same bits; every masked
    key of a row that keeps one exactly 0 and no NaN in such a row (a column
    left unwritten shows as NaN); every column of a row that keeps no key
    NaN. Also the route of its plan."""
    BH, Sq, Sk = s.shape
    plan = fo.softmax_fwd_plan(BH * Sq, Sk, fo._sm_count(s.device.index or 0), s.element_size())

    def call():
        torch.cuda.empty_cache()
        junk = torch.full_like(s, float("nan"))
        ptr = junk.data_ptr()
        del junk
        out = fo.softmax_fwd(s, causal, scale)
        return out, out.data_ptr() == ptr
    (p1, dirty1), (p2, dirty2) = call(), call()
    torch.cuda.synchronize()
    keep = fo._causal_keep(Sq, Sk, s.device) if causal else torch.ones(
        (Sq, Sk), dtype=torch.bool, device=s.device)
    empty = ~keep.any(-1)                                   # rows that keep no key
    pf = p1.float()
    live = ~empty[None, :, None]
    bits = torch.int16 if p1.dtype == torch.bfloat16 else torch.int32
    res = dict(route=plan.route, plan=plan._asdict(), dirty=dirty1 and dirty2,
               repeat_same_bits=torch.equal(p1.view(bits), p2.view(bits)),
               masked_not_zero=int(((pf != 0) & ~keep[None] & live).sum()),
               stray_nans=int((torch.isnan(pf) & live).sum()),
               empty_rows=int(empty.sum()) * BH,
               empty_rows_all_nan=bool(torch.isnan(pf[:, empty]).all()))
    res["dirty_ok"] = (res["dirty"] and res["repeat_same_bits"] and res["masked_not_zero"] == 0
                       and res["stray_nans"] == 0 and res["empty_rows_all_nan"])
    return res


def ln_bwd_tiled_check(torch, fo, x, gm, mean, rstd, dy) -> dict:
    """The LayerNorm backward kernels against ``layer_norm_bwd_tiled_plain``
    on the same saved statistics: dgamma and dbeta the same bits (the plain
    model of the kernels' order), dx within the plain version's limit
    (``fused_ops_check``); a second call the same bits."""
    R, D = x.shape
    plan = fo.ln_bwd_plan(R, D, fo._sm_count(x.device.index or 0))
    dx, dg, db = fo.layer_norm_bwd(x, gm, mean, rstd, dy)
    dx2, dg2, db2 = fo.layer_norm_bwd(x, gm, mean, rstd, dy)
    _, tdg, tdb = fo.layer_norm_bwd_tiled_plain(x, gm, mean, rstd, dy, plan)
    torch.cuda.synchronize()
    return dict(plan=plan._asdict(), route="rows" if D <= fo.LN_HELD_COLS else "wide",
                tiled_same_bits=torch.equal(dg, tdg) and torch.equal(db, tdb),
                tiled_max_diff=float(max((dg - tdg).abs().max(), (db - tdb).abs().max())),
                repeat_same_bits=all(torch.equal(a, b) for a, b in
                                     ((dx, dx2), (dg, dg2), (db, db2))))


def run_ln_bwd_checks(torch, dev="cuda") -> bool:
    """The LayerNorm backward at the smoke's shapes (bf16 (8192, 1024),
    fp32 (333, 1001), (64, 1024) and (97, 2050), bf16 (300, 1000)), each
    against its plain version (``fused_ops_check``) and its tiled plain
    version (``ln_bwd_tiled_check``); one line each. Returns ok."""
    from deepspeed_tpu_torch.ops import fused_ops as fo

    g = torch.Generator(device=dev).manual_seed(SEED + 34)
    ok = True
    for shape, dtype in (((BERT_B * BERT_S, BERT_E), torch.bfloat16),
                         ((333, 1001), torch.float32), ((64, 1024), torch.float32),
                         ((97, 2050), torch.float32), ((300, 1000), torch.bfloat16)):
        (x, gm, bt), dy = fused_ops_operands(torch, g, "layer_norm", shape, dtype, dev)
        held = fused_ops_check(torch, fo, "layer_norm", (x, gm, bt), dy, {})["layer_norm_bwd"]
        _, mean, rstd = fo.layer_norm_fwd(x, gm, bt, 1e-5)
        tiled = ln_bwd_tiled_check(torch, fo, x, gm, mean, rstd, dy)
        case_ok = held["ok"] and tiled["tiled_same_bits"] and tiled["repeat_same_bits"]
        emit(dict(phase="kernels_ln_bwd", name="layer_norm_bwd",
                  shape=f"{tuple(shape)} {str(dtype)[6:]}", **dict(held, **tiled, ok=case_ok)))
        ok &= case_ok
    return ok


# (shape, dtype, causal, scale): the smoke's bf16 shapes, every held width
# (256-column groups 1-4, 16-byte loads and not), Sq > Sk (rows that keep no
# key), and the wide route in both dtypes
SOFTMAX_FWD_CHECKS = (
    ((BERT_B * BERT_H, BERT_S, BERT_S), "bfloat16", False, 0.125),
    ((BERT_B * BERT_H, BERT_S, BERT_S), "bfloat16", True, 0.125),
    ((BERT_B * BERT_H, 128, BERT_S), "bfloat16", True, 0.125),
    ((7, 100, 300), "bfloat16", True, 0.125), ((5, 77, 1000), "bfloat16", True, 0.125),
    ((3, 77, 130), "float32", True, 0.125), ((3, 77, 513), "float32", False, 1.0),
    ((4, 64, 1024), "float32", False, 0.125), ((4, 8, 5), "float32", True, 1.0),
    ((16, 64, 4096), "bfloat16", True, 0.125), ((2, 33, 2051), "float32", False, 1.0),
)


def run_softmax_fwd_checks(torch, dev="cuda") -> bool:
    """The softmax forward at ``SOFTMAX_FWD_CHECKS``, each against its plain
    version (``fused_ops_check``) and on dirty memory twice
    (``softmax_fwd_dirty_check``); one line each. Returns ok."""
    from deepspeed_tpu_torch.ops import fused_ops as fo

    g = torch.Generator(device=dev).manual_seed(SEED + 35)
    ok = True
    for shape, dt, causal, scale in SOFTMAX_FWD_CHECKS:
        kw = dict(causal=causal, scale=scale)
        (s,), dy = fused_ops_operands(torch, g, "attention_softmax", shape, getattr(torch, dt),
                                      dev)
        held = fused_ops_check(torch, fo, "attention_softmax", (s,), dy, kw)["softmax_fwd"]
        dirty = softmax_fwd_dirty_check(torch, fo, s, causal, scale)
        case_ok = held["ok"] and dirty["dirty_ok"]
        emit(dict(phase="kernels_softmax_fwd", name="softmax_fwd",
                  shape=f"{tuple(shape)} {dt} {kw}", **dict(held, **dirty, ok=case_ok)))
        ok &= case_ok
        del s, dy
    torch.cuda.empty_cache()
    return ok


def run_kernels_fused_ops(torch, F, peaks):
    """The six fused-op kernels on the card: bf16 at ``FUSED_OPS_CASES``
    against their plain versions, each timed with the plain version, the
    library call(s) and the bound; fp32 at ``FUSED_OPS_FP32_CASES`` (checked);
    the mean-1000 LayerNorm (fp32, 8192 x 1024: rows of 1000 and a few 1008s,
    whose squares and partial sums are exact in fp32 in any order, so the
    one-pass variance is the same bits on both sides; the two-pass value is
    printed as a witness, which both miss). Returns ({kernel: row at the
    first shape, others under at_shapes}, ok)."""
    from deepspeed_tpu_torch.ops import fused_ops as fo

    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    # the wide-route softmax cases draw from their own generator, so that
    # the other cases keep the inputs they had before those were added
    g_wide = torch.Generator(device="cuda").manual_seed(SEED + 36)

    def gen(op, shape):
        return g_wide if op == "attention_softmax" and shape[-1] > fo.SOFTMAX_HELD_COLS else g
    rows, ok = {}, True
    for op, shape, kw in FUSED_OPS_CASES:
        args, dy = fused_ops_operands(torch, gen(op, shape), op, shape, torch.bfloat16)
        held = fused_ops_check(torch, fo, op, args, dy, kw)
        iters = 20
        ln_extra, sm_extra = {}, {}
        if op == "layer_norm":
            x, gm, bt = args
            _, mean, rstd = fo.layer_norm_fwd(x, gm, bt, 1e-5)
            ln_extra = ln_bwd_tiled_check(torch, fo, x, gm, mean, rstd, dy)
            split = device_ms_by_name(
                torch, lambda: fo.layer_norm_bwd(x, gm, mean, rstd, dy), iters)[1]
            ln_extra["kernels_ms"] = {k: v for k, v in split.items()
                                      if any(n in k for n in LN_BWD_KERNELS)}
            calls = {"layer_norm_fwd": (lambda: fo.layer_norm_fwd(x, gm, bt, 1e-5),
                                        lambda: fo.layer_norm_fwd_plain(x, gm, bt, 1e-5)),
                     "layer_norm_bwd": (lambda: fo.layer_norm_bwd(x, gm, mean, rstd, dy),
                                        lambda: fo.layer_norm_bwd_plain(x, gm, mean, rstd, dy))}
            lib_in = [x.clone().requires_grad_(), gm.to(x.dtype).requires_grad_(),
                      bt.to(x.dtype).requires_grad_()]

            def lib_f(a=lib_in):
                return F.layer_norm(a[0], (shape[-1],), a[1], a[2], 1e-5)
            lib_name = "F.layer_norm (two-pass variance: printed, not gated)"
            pair = False
        elif op == "bias_gelu":
            x, b = args
            calls = {"bias_gelu_fwd": (lambda: fo.bias_gelu_fwd(x, b),
                                       lambda: fo.bias_gelu_fwd_plain(x, b)),
                     "bias_gelu_bwd": (lambda: fo.bias_gelu_bwd(x, b, dy),
                                       lambda: fo.bias_gelu_bwd_plain(x, b, dy))}
            lib_in = [x.clone().requires_grad_(), b.to(x.dtype).requires_grad_()]

            def lib_f(a=lib_in):
                return F.gelu(a[0] + a[1], approximate="tanh")
            lib_name = "the pair x + b, F.gelu(approximate='tanh')"
            pair = True
        else:
            (s,) = args
            causal, scale = kw["causal"], kw["scale"]
            sm_extra = softmax_fwd_dirty_check(torch, fo, s, causal, scale)
            split = device_ms_by_name(torch, lambda: fo.softmax_fwd(s, causal, scale), iters)[1]
            sm_extra["kernels_ms"] = {k: v for k, v in split.items()
                                      if any(n in k for n in SOFTMAX_FWD_KERNELS)}
            p = fo.softmax_fwd(s, causal, scale)
            calls = {"softmax_fwd": (lambda: fo.softmax_fwd(s, causal, scale),
                                     lambda: fo.softmax_fwd_plain(s, causal, scale)),
                     "softmax_bwd": (lambda: fo.softmax_bwd(p, dy, scale),
                                     lambda: fo.softmax_bwd_plain(p, dy, scale))}
            lib_in = [s.clone().requires_grad_()]
            Sq, Sk = shape[1], shape[2]
            cmask = fo._causal_keep(Sq, Sk, "cuda") if causal else None

            def lib_f(a=lib_in):
                t = a[0] * scale
                if cmask is not None:
                    t = t.masked_fill(~cmask, float("-inf"))
                return torch.softmax(t, -1)
            lib_name = "the scale" + (", masked_fill" if causal else "") + " and torch.softmax"
            pair = True

        def lib_fb():
            return torch.autograd.grad(lib_f(), lib_in, dy)
        lf = device_ms(torch, lib_f, iters)
        lfb = device_ms(torch, lib_fb, iters)
        lb = lfb - lf if lfb and lf else None
        for kname, (kern, plain) in calls.items():
            b_ms, b_by = fused_ops_bound(op, shape, 2, kname, peaks, kw.get("causal", False))
            lib = lf if kname.endswith("_fwd") else lb
            row = dict(phase="kernels_fused_ops", name=kname,
                       shape=f"{op} {tuple(shape)} bfloat16" + (f" {kw}" if kw else ""),
                       **held[kname], limit="per element: 1 ulp of the output dtype + 1e-5 of "
                       "the fp32 addends' magnitudes (parameter sums: of the sum of |terms|)",
                       kernel_ms=device_ms(torch, kern, iters),
                       kernel_event_ms=cuda_ms(torch, kern, iters),
                       plain_ms=device_ms(torch, plain, 3),
                       library_ms=None if pair else lib, library=lib_name
                       + ("" if kname.endswith("_fwd") else ", autograd backward"),
                       bound_ms=b_ms, bound_by=b_by)
            if pair:   # two or more calls, not one: beside, not library_ms
                row["library_pair_ms"] = lib
            row["ok"] = row["ok"] and row["kernel_ms"] is not None
            if kname == "layer_norm_bwd":
                row.update(ln_extra)
                row["ok"] = row["ok"] and ln_extra["tiled_same_bits"] and \
                    ln_extra["repeat_same_bits"]
            if kname == "softmax_fwd":
                row.update(sm_extra)
                row["ok"] = row["ok"] and sm_extra["dirty_ok"]
            emit(row)
            ok &= row["ok"]
            if kname not in rows:
                rows[kname] = dict(row, at_shapes=[])
            else:
                rows[kname]["at_shapes"].append({k: row.get(k) for k in (
                    "shape", "max_err", "err_over_limit", "kernel_ms", "plain_ms", "library_ms",
                    "library_pair_ms", "bound_ms", "bound_by")})
        del args, dy, lib_in, held, ln_extra, sm_extra
        torch.cuda.empty_cache()
    # the fp32 (333, 1001) LayerNorm draws fresh inputs from a generator of
    # its own (its limit counts the statistics' own error); it still
    # draws its earlier ones, unused, so that the later cases keep theirs
    g_ln = torch.Generator(device="cuda").manual_seed(SEED + 37)
    for op, shape, kw in FUSED_OPS_FP32_CASES:
        args, dy = fused_ops_operands(torch, gen(op, shape), op, shape, torch.float32)
        if (op, shape) == ("layer_norm", (333, 1001)):
            args, dy = fused_ops_operands(torch, g_ln, op, shape, torch.float32)
        for kname, h in fused_ops_check(torch, fo, op, args, dy, kw).items():
            if kname == "layer_norm_bwd":   # also its tiled order, bit for bit
                x, gm, bt = args
                _, mean, rstd = fo.layer_norm_fwd(x, gm, bt, 1e-5)
                h = dict(h, **ln_bwd_tiled_check(torch, fo, x, gm, mean, rstd, dy))
                h["ok"] = h["ok"] and h["tiled_same_bits"] and h["repeat_same_bits"]
            if kname == "softmax_fwd":   # also on dirty memory, twice
                h = dict(h, **softmax_fwd_dirty_check(torch, fo, args[0], kw["causal"],
                                                      kw["scale"]))
                h["ok"] = h["ok"] and h["dirty_ok"]
            emit(dict(phase="kernels_fused_ops_fp32", name=kname, shape=f"{op} {tuple(shape)}"
                      + (f" {kw}" if kw else ""), **h))
            ok &= h["ok"]
            if shape == (4, 8, 5) and kname == "softmax_fwd":   # rows 0-2 see no key
                nan_ok = h["outputs"]["p"]["nans"] == 4 * 3 * 5
                emit(dict(phase="kernels_fused_ops_nan_rows", shape=shape, nans=h["outputs"]
                          ["p"]["nans"], expected=4 * 3 * 5, ok=nan_ok))
                ok &= nan_ok
    # the mean-1000 LayerNorm
    R, D = BERT_B * BERT_S, BERT_E
    x = 1000 + 8 * (torch.rand((R, D), generator=g, device="cuda") < 1 / 64).float()
    gm, bt = 1 + 0.1 * torch.randn(D, generator=g, device="cuda"), torch.zeros(D, device="cuda")
    y = fo.layer_norm_fwd(x, gm, bt, 1e-5)[0]
    yp = fo.layer_norm_fwd_plain(x, gm, bt, 1e-5)[0]
    xd = x.double()
    two = ((xd - xd.mean(-1, keepdim=True)) / torch.sqrt(xd.var(-1, unbiased=False, keepdim=True)
                                                        + 1e-5)) * gm.double()
    scale = float(two.abs().max())
    err = float((y - yp).abs().max())
    miss = float((y.double() - two).abs().max())
    m1000_ok = err <= 1e-5 * scale and miss > 1e-3 * scale
    emit(dict(phase="kernels_fused_ops_mean1000", name="layer_norm_fwd", shape=f"({R}, {D}) fp32",
              max_err_vs_one_pass_plain=err, limit=1e-5 * scale,
              max_err_vs_two_pass_fp64=miss, two_pass_must_miss_by_more_than=1e-3 * scale,
              ok=m1000_ok))
    ok &= m1000_ok
    return rows, ok


def run_fused_ops_train(torch):
    """The public ops as a training step calls them, at BERT-large shapes in
    bf16: ``layer_norm`` over (16, 512, 1024) with fp32 gamma, beta;
    ``bias_gelu`` over (16, 512, 4096); ``attention_softmax`` over (16, 16,
    512, 512) at scale 1/8; each forward and ``.backward()`` once (exactly one
    launch of its forward and of its backward kernel), then each once under
    ``torch.no_grad()`` (one more forward launch, no backward). Outputs and
    gradients finite, of their inputs' shapes and the JAX wrappers' dtypes.
    Returns ({path: counts}, ok)."""
    from deepspeed_tpu_torch.ops import fused_ops as fo

    g = torch.Generator(device="cuda").manual_seed(SEED + 33)
    bf = torch.bfloat16

    def r(*s, scale=1.0, dt=bf):
        return (torch.randn(s, generator=g, device="cuda") * scale).to(dt).requires_grad_()
    x = r(BERT_B, BERT_S, BERT_E)
    gm, bt = (1 + r(BERT_E, scale=0.1, dt=torch.float32)).detach().requires_grad_(), r(
        BERT_E, scale=0.1, dt=torch.float32)
    h, hb = r(BERT_B, BERT_S, BERT_F), r(BERT_F, scale=0.02)
    s = r(BERT_B, BERT_H, BERT_S, BERT_S, scale=8.0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    outs = [fo.layer_norm(x, gm, bt), fo.bias_gelu(h, hb),
            fo.attention_softmax(s, causal=False, scale=0.125)]
    for o in outs:
        o.backward(torch.randn(o.shape, generator=g, device="cuda").to(o.dtype))
    with torch.no_grad():
        plain_outs = [fo.layer_norm(x, gm, bt), fo.bias_gelu(h, hb),
                      fo.attention_softmax(s, causal=False, scale=0.125)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    expected = {n: 0 for n in launches}
    expected.update({k: 2 for k in FUSED_OPS_KERNELS if k.endswith("_fwd")})
    expected.update({k: 1 for k in FUSED_OPS_KERNELS if k.endswith("_bwd")})
    grads = {"x": x.grad, "gamma": gm.grad, "beta": bt.grad, "h": h.grad, "bias": hb.grad,
             "scores": s.grad}
    checks = {
        "launch_counts": launches == expected,
        "outputs_finite": all(bool(torch.isfinite(o.float()).all()) for o in outs + plain_outs),
        "no_grad_same_values": all(torch.equal(a.detach(), b) for a, b in zip(outs, plain_outs)),
        "grads_finite": all(v is not None and bool(torch.isfinite(v.float()).all())
                            for v in grads.values()),
        "grad_dtypes": (x.grad.dtype == bf and gm.grad.dtype == torch.float32
                        and bt.grad.dtype == torch.float32 and hb.grad.dtype == bf
                        and s.grad.dtype == bf),
        "grad_shapes": all(v.shape == t.shape for v, t in zip(
            grads.values(), (x, gm, bt, h, hb, s)))}
    emit(dict(phase="fused_ops_train", shapes=dict(layer_norm=[BERT_B, BERT_S, BERT_E],
                                                   bias_gelu=[BERT_B, BERT_S, BERT_F],
                                                   attention_softmax=[BERT_B, BERT_H, BERT_S,
                                                                      BERT_S]),
              wall_ms=wall_ms, launches={n: c for n, c in launches.items() if c},
              expected={n: c for n, c in expected.items() if c}, checks=checks,
              ok=all(checks.values())))
    del x, h, s, outs, plain_outs
    torch.cuda.empty_cache()
    return {"fused_ops_train": launches}, all(checks.values())



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
        global _LOG_PATH
        _LOG_PATH = os.path.join(args.out, "smoke.jsonl")
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
    # the tensor-core decode GEMV (decode-layer kernels, the W8 matmul) and
    # the held softmax forward (no spills), and the fused FFN's Hopper
    # kernels (dw, and the forward's and dx's GEMMs): registers and spills
    mlp_build = []
    for src, match, phase in (("decode_layer", "gemv90", "build_decode_sm90"),
                              ("w8_matmul", "gemv90", "build_w8_matmul"),
                              ("fused_mlp", "sm90_kernel", "build_fused_mlp_sm90"),
                              ("fused_ops", "softmax_fwd_held", "build_softmax_fwd_held")):
        if src in logs:
            built = decode_sm90_build(logs[src], match)
            emit(dict(phase=phase, kernels=built))
            ok &= bool(built)
            if src == "fused_mlp":   # registers and spills reported beside its rows
                mlp_build = built
            else:
                ok &= all(r.get("spill_bytes", 1) == 0 for r in built)

    kernel_results = run_kernels(torch, F, peaks)
    ok &= all(r["ok"] for _, r in kernel_results)
    ok &= run_fp32_shapes(torch)
    ok &= run_decode_split_checks(torch)[1]
    bwd_rows, bwd_ok = run_bwd_kernels(torch, F, peaks)
    ok &= bwd_ok
    adam_err, adam_rows, adam_ok = run_adam8bit_kernel(torch, peaks)
    ok &= adam_ok
    ce_rows, ce_ok = run_fused_ce_kernels(torch, peaks)
    ok &= ce_ok
    w8_rows, w8_ok = run_kernels_w8(torch, peaks)
    ok &= w8_ok
    llama_rows, llama_at, llama_kernels_ok = run_kernels_llama(torch, F, peaks)
    ok &= llama_kernels_ok
    neox_rows, neox_at, neox_kernels_ok = run_kernels_neox(torch, F, peaks)
    ok &= neox_kernels_ok
    ok &= run_kernels_decode_sm90(torch, F, peaks)
    mlp_rows, mlp_kernels_ok = run_kernels_fused_mlp(torch, F, peaks, mlp_build)
    ok &= mlp_kernels_ok
    sparse_rows, sparse_kernels_ok = run_kernels_sparse(torch, F, peaks)
    ok &= sparse_kernels_ok
    fops_rows, fops_kernels_ok = run_kernels_fused_ops(torch, F, peaks)
    ok &= fops_kernels_ok
    ok &= run_ln_bwd_checks(torch)
    ok &= run_softmax_fwd_checks(torch)
    sparse_launches, sparse_api_ok = run_sparse_api(torch)
    ok &= sparse_api_ok
    fops_launches, fops_train_ok = run_fused_ops_train(torch)
    ok &= fops_train_ok
    launches, slice_ok, eng, prompt = run_slice(torch)
    ok &= slice_ok
    run_profile(torch, eng, prompt, args.out)
    del eng
    serve_launches, serve_ok = run_serve(
        torch, lambda lg: 2 * bf16_ulp(float(lg.abs().max())), args.out)
    ok &= serve_ok
    w8_launches, w8_serve_ok = run_serve_w8(torch, args.out)
    ok &= w8_serve_ok
    llama_launches, llama_ok = run_serve_llama(torch, args.out)
    ok &= llama_ok
    neox_launches, neox_ok = run_serve_neox(torch, args.out)
    ok &= neox_ok
    ok &= run_serve_graph_parity(torch)
    mlp_launches, mlp_slice_ok = run_slice_fused_mlp(torch, args.out)
    ok &= mlp_slice_ok
    train_launches, train_peak_gb, train_ok = run_train(torch, peaks, args.out)
    ok &= train_ok
    precision_launches, precision_ok = run_train_flash_precision(torch)
    ok &= precision_ok
    mlp_train_launches, mlp_train_ok = run_train_fused_mlp(torch, peaks, train_peak_gb, args.out)
    ok &= mlp_train_ok
    ce_train_launches, ce_train_ok = run_train_loss_pallas(torch, peaks)
    ok &= ce_train_ok
    big_launches, opt_res, big_ok = run_train_1p5b(torch, peaks, args.out)
    ok &= big_ok
    # each path's counts were zeroed before it and read after it
    by_path = {"generate": launches, **serve_launches, **w8_launches, **llama_launches,
               **neox_launches, **mlp_launches, **train_launches, **precision_launches,
               **ce_train_launches, **mlp_train_launches, **big_launches, **sparse_launches,
               **fops_launches}

    # the kernels' rows at gpt2-760m's heads, which the serve_w8 and
    # generate_w8 paths run
    at_760m = {case["name"]: dict(
        shape=r["shape"], max_abs_err=r["max_err"], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
        library_ms=r["library_ms"], bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"])
        for case, r in kernel_results if case.get("at") == "gpt2-760m"}
    summary = []
    for case, r in kernel_results:
        if not case["main"]:
            continue
        per_path = {p: c.get(case["name"], 0) for p, c in by_path.items()}
        row = dict(
            name=case["name"], route="cuda", source=case["source"], replaces=case["replaces"],
            launches=sum(per_path.values()), launches_by_path=per_path,
            max_abs_err=r["max_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"],
            library_ms=r["library_ms"])
        if case["name"] in bwd_rows:   # the forward: also at the train shape
            row["at_train_shape"] = bwd_rows[case["name"]]
        if case["name"] in at_760m:
            row["at_gpt2_760m"] = at_760m[case["name"]]
        summary.append(row)
    replaces = {"flash_attention_bwd_merged": "deepspeed_tpu/ops/pallas/flash_attention.py:182",
                "flash_attention_bwd_dq": "deepspeed_tpu/ops/pallas/flash_attention.py:93",
                "flash_attention_bwd_dkv": "deepspeed_tpu/ops/pallas/flash_attention.py:133"}
    for kname, where in replaces.items():
        r = bwd_rows.get(kname)
        if r is None:   # the kernels phase failed before timing it (already not ok)
            continue
        per_path = {p: c.get(kname, 0) for p, c in by_path.items()}
        summary.append(dict(
            name=kname, route="cuda", source="deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            replaces=where, launches=sum(per_path.values()), launches_by_path=per_path,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"]))
    ok &= all(k in bwd_rows for k in replaces) and "flash_attention_fwd" in bwd_rows

    def path_counts(kname):
        counts = {p: c.get(kname, 0) for p, c in by_path.items()}
        return dict(launches=sum(counts.values()), launches_by_path=counts)

    # the optimizer at the 1.5B leaf set, as the train_1p5b step runs it
    summary.append(dict(
        name="adam8bit_update", route="cuda", source="deepspeed_tpu_torch/ops/csrc/adam8bit.cu",
        replaces="deepspeed_tpu/ops/pallas/adam8bit_kernel.py:55", **path_counts("adam8bit_update"),
        max_abs_err=adam_err, ms=opt_res["fused_kernel_device_ms"],
        plain_ms=opt_res["plain_event_ms"], bound_ms=opt_res["bound_ms"],
        bound_by=opt_res["bound_by"], library_ms=None,
        shape=f"gpt2-1.5b leaf set: {opt_res['leaves']} leaves, {opt_res['elements']} elements",
        launches_per_step=opt_res["launches_per_step"], at_shapes=adam_rows))
    # the fused CE head: the tensor-core entries at the 1.5B head (the other
    # bf16 shapes under at_shapes), launched on the loss_pallas paths; the
    # CUDA-core entries at the fp32 shape, launched on the fp32 path
    ce_paths = {"fused_ce_fwd_sm90": ("train_loss_pallas", "train_1p5b_pallas"),
                "fused_ce_bwd_sm90": ("train_loss_pallas", "train_1p5b_pallas"),
                "fused_ce_fwd": ("train_loss_pallas_fp32",),
                "fused_ce_dh": ("train_loss_pallas_fp32",),
                "fused_ce_dw": ("train_loss_pallas_fp32",)}
    for kname, paths in ce_paths.items():
        r = ce_rows.get(kname)
        if r is None:   # the kernels phase failed before timing it (already not ok)
            continue
        row = dict(
            name=kname, route="cuda", source="deepspeed_tpu_torch/ops/csrc/fused_ce.cu",
            replaces="deepspeed_tpu/ops/pallas/fused_ce.py" + CE_LINES[kname],
            **path_counts(kname), max_abs_err=r["max_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"])
        if kname == "fused_ce_bwd_sm90":   # dlog, then dh and dw: both TPU kernels' work
            row.update(also_replaces="deepspeed_tpu/ops/pallas/fused_ce.py:101",
                       device_kernels_ms=r["device_kernels_ms"],
                       bound_four_products_ms=r["bound_four_products_ms"])
        if "at_shapes" in r:
            row["at_shapes"] = r["at_shapes"]
        summary.append(row)
        ok &= all(by_path[p][kname] > 0 for p in paths)
    ok &= all(k in ce_rows for k in ce_paths)
    w8_src = {"w8a16_matmul": ("w8_matmul.cu", "deepspeed_tpu/ops/pallas/w8_matmul.py:35"),
              "decode_norm_proj_w8": ("decode_layer.cu",
                                      "deepspeed_tpu/ops/pallas/decode_layer.py:185"),
              "decode_post_attn_w8": ("decode_layer.cu",
                                      "deepspeed_tpu/ops/pallas/decode_layer.py:344")}
    for kname, (src, where) in w8_src.items():
        r = w8_rows.get(kname)
        if r is None:   # the kernels phase failed before timing it (already not ok)
            continue
        row = dict(name=kname, route="cuda", source="deepspeed_tpu_torch/ops/csrc/" + src,
                   replaces=where, **path_counts(kname), max_abs_err=r["max_err"],
                   ms=r["kernel_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_us"] / 1e3,
                   bound_by=r["bound_by"], library_ms=None, shape=r["shape"])
        if "dequant_matmul_pair_ms" in r:   # two calls, not one: beside, not library_ms
            row["dequant_matmul_pair_ms"] = r["dequant_matmul_pair_ms"]
        summary.append(row)
        # each W8 kernel ran on the int8 paths that take it: the w8 matmul on
        # the paged suffix prefill chunks of 2..64 rows x tokens and on the
        # unfused ticks, the W8 decode-layer kernels on every fused tick
        ok &= all(by_path[p][kname] > 0 for p in (
            ("serve_w8_paged", "generate_w8_unfused") if kname == "w8a16_matmul" else
            ("serve_w8_paged", "serve_w8_contiguous", "generate_w8_fused")))
    ok &= all(k in w8_rows for k in w8_src)
    # the LLaMA branches of the decode-layer kernels, each launched on the
    # page-resident serve path and the fused generate path of its dtype
    for kname in LLAMA_KERNELS:
        r = llama_rows.get(kname)
        if r is None:   # the kernels phase failed before timing it (already not ok)
            continue
        summary.append(dict(
            name=kname, route="cuda", source="deepspeed_tpu_torch/ops/csrc/decode_layer.cu",
            replaces="deepspeed_tpu/ops/pallas/decode_layer.py:"
            + ("185" if kname.startswith("norm_proj") else "344"), **path_counts(kname),
            max_abs_err=r["max_err"], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"], library_ms=None,
            shape=r["shape"]))
        w8 = "_w8" if kname.endswith("_w8") else ""
        ok &= all(by_path[p][kname] > 0 for p in (f"serve_llama{w8}_paged",
                                                   f"generate_llama{w8}_fused"))
    ok &= all(k in llama_rows for k in LLAMA_KERNELS)

    # the GPT-NeoX branches of post_attn, each launched on the paths that run it
    neox_paths = {"post_attn_erf_par": ("serve_neox_paged", "generate_neox_fused"),
                  "post_attn_erf_par_w8": ("serve_neox_w8_paged", "generate_neox_w8_fused"),
                  "post_attn_erf": ("generate_neox_seq_fused",),
                  "post_attn_erf_w8": ("generate_neox_seq_w8_fused",)}
    for kname, paths in neox_paths.items():
        r = neox_rows.get(kname)
        if r is None:   # the kernels phase failed before timing it (already not ok)
            continue
        summary.append(dict(
            name=kname, route="cuda", source="deepspeed_tpu_torch/ops/csrc/decode_layer.cu",
            replaces="deepspeed_tpu/ops/pallas/decode_layer.py:344", **path_counts(kname),
            max_abs_err=r["max_err"], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"], library_ms=None,
            shape=r["shape"]))
        ok &= all(by_path[p][kname] > 0 for p in paths)
    ok &= all(k in neox_rows for k in neox_paths)

    # the fused FFN kernels at the flagship micro-batch (the train path), the
    # other shapes under at_shapes; each launched on every path whose rows
    # the row rule gives it (the mma.sync forward: bf16 rows below
    # fused_mlp.SM90_MIN_ROWS, the unfused decode ticks' 8 if any; bf16 dx
    # takes its tensor-core entry at every row count)
    from deepspeed_tpu_torch.ops import fused_mlp as fm
    ticks_sm90 = fm.sm90_route(8, True)
    mlp_paths = {"fused_mlp_fwd_sm90": ("forward_fused_mlp", "generate_fused_mlp",
                                        "generate_fused_mlp_unfused_ticks",
                                        "serve_fused_mlp_paged", "train_fused_mlp",
                                        "train_fused_mlp_remat"),
                 "fused_mlp_bwd_dx_sm90": ("train_fused_mlp", "train_fused_mlp_remat"),
                 "fused_mlp_bwd_dw": ("train_fused_mlp", "train_fused_mlp_remat"),
                 "fused_mlp_fwd": () if ticks_sm90 else ("generate_fused_mlp_unfused_ticks",)}
    for kname, paths in mlp_paths.items():
        r = mlp_rows.get(kname)
        if r is None:   # the kernels phase failed before timing it (already not ok)
            continue
        row = dict(
            name=kname, route="cuda", source="deepspeed_tpu_torch/ops/csrc/fused_mlp.cu",
            replaces="deepspeed_tpu/ops/pallas/fused_mlp.py" + FUSED_MLP_LINES[kname],
            **path_counts(kname), max_abs_err=r["max_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"], at_shapes=r["at_shapes"])
        for extra in ("hi_lo_floor_ms", "registers", "unfused_chain_ms",
                      "plan"):   # the Hopper kernels' and dx's
            if extra in r:
                row[extra] = r[extra]
        summary.append(row)
        ok &= all(by_path[p][kname] > 0 for p in paths)
    ok &= all(k in mlp_rows for k in mlp_paths)

    # block-sparse attention at case a (bf16: the others under at_shapes),
    # each entry launched by the public SparseSelfAttention path of its
    # dtype; the six fused-op kernels at BERT-large's shapes, each launched
    # by the fused_ops_train path
    bert_rows = {kname: (sparse_rows.get(kname), "deepspeed_tpu_torch/ops/csrc/sparse_attention.cu",
                         "deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py:59", path)
                 for kname, path in ((SPARSE_KERNEL, "sparse_attention_api"),
                                     (SPARSE_KERNEL_FP32, "sparse_attention_api_fp32"))}
    for kname in FUSED_OPS_KERNELS:
        bert_rows[kname] = (fops_rows.get(kname), "deepspeed_tpu_torch/ops/csrc/fused_ops.cu",
                            "deepspeed_tpu/ops/pallas/fused_ops.py" + FUSED_OPS_LINES[kname],
                            "fused_ops_train")
    for kname, (r, src, where, path) in bert_rows.items():
        if r is None:   # the kernels phase failed before timing it (already not ok)
            ok = False
            continue
        row = dict(name=kname, route="cuda", source=src, replaces=where, **path_counts(kname),
                   max_abs_err=r["max_err"], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                   bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                   shape=r["shape"], at_shapes=r["at_shapes"])
        for extra in ("library_pair_ms", "dense_sdpa_ms", "hi_lo_floor_ms"):
            if extra in r:
                row[extra] = r[extra]
        summary.append(row)
        ok &= by_path[path][kname] > 0

    # the earlier kernels' rows at llama-1b's shapes (H=32 over KV=4, the
    # four dense panels) and at pythia-1b's (H=KV=8, D=256; qkv N=6144, the
    # four dense panels)
    def at_shape(r):
        return dict(shape=r["shape"], max_abs_err=r["max_err"], ms=r["kernel_ms"],
                    plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                    bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"])
    for row in summary:
        for key, table in (("at_llama_1b", llama_at), ("at_pythia_1b", neox_at)):
            r = table.get(row["name"])
            if r is not None:
                row[key] = [at_shape(x) for x in r] if isinstance(r, list) else at_shape(r)
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
