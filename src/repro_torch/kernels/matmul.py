"""Tile GEMM kernel (``csrc/matmul.cu``).

Replaces ``repro/kernels/matmul.py::matmul`` (``_matmul_kernel``): the
consumer-side compute tile of TileLink programs, fp32 accumulation, cast at
store.  Two routes, chosen by dtype before the launch (never by a fallback):

  * bfloat16 (the serve dtype): ``wgmma_gemm_kernel`` (``csrc/wgmma_gemm.cu``),
    the grouped GEMM's persistent wgmma kernel with one row tile of M rows
    and one expert (its items: ``grouped_matmul.work_items(1, M, N)``).  Its
    tile is fixed (128 x 128); ``tile`` does not apply.  K and N must be
    multiples of 8 and the bases 16-byte aligned (TMA), else ValueError.
  * float32: ``matmul_kernel``, the ``csrc/tile_gemm.cuh`` FMA loop over
    (bm, bn) block regions (``tile``); exact float32 products.

``matmul.last_launch`` says which route the last launch took, its grid and
its item count.  On the model path the standalone entry computes the LM head
(``lm.logits``).

Under autograd (grad mode on and an operand that requires grad) the
forward is the same launch and the backward two ``torch.matmul`` products
(dx = dy w^T, dw = x^T dy): the JAX package's LM head is an einsum outside
Pallas, so it has no backward kernel to port.

``matmul.launches`` counts host calls that launch the kernel.  A call made
while a CUDA graph captures counts once, and the graph's replays do not
count: the serving engine (``serving/engine.py``) records each graph's
launches at capture and reports the launches of its replays itself
(``ServeEngine.stats["launches"]``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["matmul", "matmul_plain", "DEFAULT_TILE"]

DEFAULT_TILE = (128, 128, 128)  # (bm, bn, bk): the float32 route's bm x bn output region per block


def matmul_plain(x: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: ``x.float() @ w.float()`` cast to the output dtype."""
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    tile: Tuple[int, int, int] = DEFAULT_TILE,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x [M, K] @ w [K, N] -> [M, N]``; the tile need not divide M, N, K.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    of its dtype's route (``build.ROUTES``) or raises.
    """
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Matmul.apply(x, w, tuple(tile), out_dtype)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_plain(x, w, out_dtype)
    build.check_cuda_operands("matmul", x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul: expected [M, K] @ [K, N], got {tuple(x.shape)} @ {tuple(w.shape)}")
    if out_dtype != x.dtype:
        raise ValueError(f"matmul kernel stores in the input dtype {x.dtype}, not {out_dtype}")
    route = build.ROUTES[x.dtype]
    if route == "wgmma":
        build.check_tma_operands("matmul", x, w)
    m, k = x.shape
    n = w.shape[1]
    bm, bn = max(1, min(int(tile[0]), m)), max(1, min(int(tile[1]), n))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    info = (ctypes.c_int * 2)()
    lib = build.library()
    rc = lib.tl_matmul(
        build.dtype_code(x.dtype), x.data_ptr(), w.data_ptr(), out.data_ptr(), ctypes.addressof(info),
        m, n, k, bm, bn, build.stream(x),
    )  # fmt: skip
    build.check(rc, "matmul")
    if route == "wgmma":
        matmul.last_launch = {"route": route, "grid": info[0], "items": info[1]}
    else:
        matmul.last_launch = {"route": route, "grid": -(-m // bm) * -(-n // bn), "items": None}
    matmul.launches += 1
    return out


class _Matmul(torch.autograd.Function):
    """The tile GEMM under autograd: the kernel forward, ``torch.matmul`` backward."""

    @staticmethod
    def forward(ctx, x, w, tile, out_dtype):
        ctx.save_for_backward(x, w)
        return matmul(x, w, tile=tile, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = torch.matmul(dy.to(x.dtype), w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.t(), dy.to(w.dtype)) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


matmul.launches = 0
matmul.last_launch = None
