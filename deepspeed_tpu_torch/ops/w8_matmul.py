"""The W8A16 matmul kernel for decode rows: ``x @ dequant(codes, scale)``.

Port of ``deepspeed_tpu/ops/pallas/w8_matmul.py``: the TPU kernel
``_kernel`` becomes ``csrc/w8_matmul.cu``, the W8 instantiation of the
tensor-core decode GEMV (``csrc/decode_gemv_sm90.cuh``) in its plain matmul
mode (see the .cu's header for the design and the bound): one launch a
call, K split over blocks by :func:`~.decode_layer.gemv_plan`.
:func:`w8a16_matmul_kernel` launches it for CUDA tensors and runs
:func:`w8a16_matmul_plain`, the kernel's arithmetic in plain PyTorch, for
CPU tensors; :func:`~.decode_layer.gemv_tiled_plain` over the pair
``(codes, scale)`` adds the kernel's order of summation. :func:`supported`
is the JAX package's dispatch guard; ``ops/w8.w8a16_matmul`` consults it.
:func:`kernel_launches` gives the C library's own count of the kernel.
"""
from __future__ import annotations

import math

import torch

from . import decode_layer as dl
from ._build import INT, PTR, Kernel, LibraryCounts, check_operands, stream_of

# x, codes, scale, group, out, workspace, tickets, M, K, N, n_tile, k_slice, stream
KERNEL = Kernel("w8_matmul", "w8a16_matmul_fwd",
                [PTR, PTR, PTR, INT, PTR, PTR, PTR] + [INT] * 5 + [PTR])
# the kernel behind the C entry, as the library counts it (``w8_matmul_launched``)
KERNELS = ("gemv_sm90_kernel_w8",)
COUNTS = LibraryCounts("w8_matmul", "w8_matmul_launched", KERNELS)

MAX_ROWS = 64     # decode rows (batched slots fold to M = n_slots)


def supported(x_shape, codes_shape, n_groups: int) -> bool:
    """The JAX guard (``w8_matmul.supported``, one device): 128-aligned K
    and N, a single group or 128-aligned groups that divide K, decode rows."""
    K, N = codes_shape
    M = math.prod(x_shape[:-1])
    g = K // max(n_groups, 1)
    return (K % 128 == 0 and N % 128 == 0 and (n_groups == 1 or g % 128 == 0)
            and K % max(g, 1) == 0 and M <= MAX_ROWS)


def kernel_launches() -> dict:
    """Launches so far of each kernel of :data:`KERNELS`, as the C library
    counts them where it launches them (graph replays included). Loads (and
    builds) the library."""
    return COUNTS.read()


def w8a16_matmul_plain(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor):
    """The kernel's arithmetic: x in bf16, each group's fp32 partial product
    times its scale, summed in group order; fp32 ``(M, N)``."""
    K, N = codes.shape
    G = scale.shape[0]
    g = K // G
    xb = x.to(torch.bfloat16).float()
    acc = torch.zeros((x.shape[0], N), dtype=torch.float32, device=x.device)
    for u in range(G):
        acc = acc + (xb[:, u * g:(u + 1) * g] @ codes[u * g:(u + 1) * g].float()) * scale[u]
    return acc


def w8a16_matmul_kernel(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor):
    """``x (M, K) bf16 @ dequant(codes int8 (K, N), scale fp32 (G, N))`` →
    fp32 ``(M, N)``: the kernel on the card, its plain version on the CPU."""
    M, K = x.shape
    N = codes.shape[1]
    G = scale.shape[0]
    if codes.shape[0] != K or scale.shape[1] != N or K % G:
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)}, codes {tuple(codes.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not x.is_cuda:
        return w8a16_matmul_plain(x, codes, scale)
    if not supported(x.shape, codes.shape, G):
        raise ValueError(f"w8a16_matmul kernel: unsupported shape M={M} K={K} N={N} G={G}")
    x = x.contiguous()
    check_operands(x, codes, scale, dtypes=(torch.bfloat16, torch.int8, torch.float32))
    g = K // G
    n_tile, k_slice = dl.gemv_plan(K, N, 1, g)
    stream = stream_of(x)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(max(dl.gemv_partials(M, K, N, (n_tile, k_slice)), 4), dtype=torch.float32,
                     device=x.device)
    tickets = dl.gemv_tickets(x.device, stream, N // n_tile)
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), g, out.data_ptr(),
                      ws.data_ptr(), tickets.data_ptr(), M, K, N, n_tile, k_slice, stream)
    return out
