"""Tile GEMM kernel (``csrc/matmul.cu`` over ``csrc/tile_gemm.cuh``).

Replaces ``repro/kernels/matmul.py::matmul`` (``_matmul_kernel``): the
consumer-side compute tile of TileLink programs, fp32 accumulation, cast at
store.  The same tile loop (``tile_gemm.cuh``) is the body of the fused
``ag_gemm`` and ``gemm_rs`` kernels.  What bounds it on the card and what the
design does about that is noted in ``csrc/tile_gemm.cuh``.

On the model path the standalone entry computes the LM head (``lm.logits``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["matmul", "matmul_plain", "DEFAULT_TILE"]

DEFAULT_TILE = (128, 128, 128)  # (bm, bn, bk): bm x bn output region per block


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
    """``x [M, K] @ w [K, N] -> [M, N]``; the block tile need not divide M, N, K.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises).
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_plain(x, w, out_dtype)
    build.check_cuda_operands("matmul", x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul: expected [M, K] @ [K, N], got {tuple(x.shape)} @ {tuple(w.shape)}")
    if out_dtype != x.dtype:
        raise ValueError(f"matmul kernel stores in the input dtype {x.dtype}, not {out_dtype}")
    m, k = x.shape
    n = w.shape[1]
    bm, bn = max(1, min(int(tile[0]), m)), max(1, min(int(tile[1]), n))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.library()
    rc = lib.tl_matmul(
        build.dtype_code(x.dtype), x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, bm, bn, build.stream(x)
    )
    build.check(rc, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
