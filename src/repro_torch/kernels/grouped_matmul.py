"""Grouped (MoE expert) GEMM kernel (``csrc/grouped_matmul.cu``), table-driven.

Replaces ``repro/kernels/grouped_matmul.py::grouped_matmul``: ``x`` [M, K]
holds expert-sorted, tile-aligned rows, ``w`` [E, K, N] the experts'
weights, and ``tile_expert`` [M / bm] (int32, on the device) names the expert
of each row tile — the paper's dynamic mapping f_R.  The kernel reads the
table on the device, so one launch covers every expert.  The bound and the
design are noted in ``csrc/grouped_matmul.cu``.

:func:`grouped_matmul_plain` is the plain PyTorch version: it gathers the
weights once per row tile (not per row, as the JAX oracle
``ref.grouped_matmul_ref`` does) and multiplies in float32.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.kernels import build

__all__ = ["grouped_matmul", "grouped_matmul_plain", "group_tile_table", "ROW_TILE"]

ROW_TILE = 64  # rows of the kernel's micro-tile (TG_BM): the largest useful row tile


@functools.lru_cache(maxsize=64)
def group_tile_table(num_groups: int, group_rows: int, device: torch.device) -> torch.Tensor:
    """Row tiles of ``num_groups`` consecutive groups of ``group_rows`` rows,
    group g using expert g: the int32 table [num_groups * group_rows / bm]
    with bm the largest divisor of ``group_rows`` that is <= ROW_TILE.  Built
    once per shape, on ``device``."""
    bm = largest_divisor(group_rows, ROW_TILE)
    tiles = torch.arange(num_groups * group_rows // bm, dtype=torch.int64) * bm // group_rows
    return tiles.to(device=device, dtype=torch.int32)


def _check(x: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor):
    if x.dim() != 2 or w.dim() != 3 or tile_expert.dim() != 1 or x.shape[1] != w.shape[1]:
        raise ValueError(
            f"grouped_matmul: expected x [M, K], w [E, K, N], tile_expert [T], got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(tile_expert.shape)}"
        )
    if tile_expert.shape[0] == 0 or x.shape[0] % tile_expert.shape[0]:
        raise ValueError(f"grouped_matmul: {x.shape[0]} rows do not split into {tile_expert.shape[0]} row tiles")


def grouped_matmul_plain(
    x: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Plain version: per row tile, ``x[tile].float() @ w[tile_expert[t]].float()``;
    an entry outside [0, E) gives zero rows, as in the kernel."""
    _check(x, w, tile_expert)
    (m, k), (e, _, n), t = x.shape, w.shape, tile_expert.shape[0]
    te = tile_expert.long()
    valid = ((te >= 0) & (te < e)).float()
    wt = w[te.clamp(0, e - 1)].float()  # [T, K, N]: one weight gather per row tile
    out = torch.matmul(x.float().reshape(t, m // t, k), wt) * valid[:, None, None]
    return out.reshape(m, n).to(out_dtype or x.dtype)


def grouped_matmul(
    x: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor, *, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """``out[rows of tile t] = x[rows of tile t] @ w[tile_expert[t]]`` -> [M, N].

    The row tile is ``M / len(tile_expert)``.  ``out_dtype`` is float32 or the
    input dtype (default).  A CPU tensor runs :func:`grouped_matmul_plain`; a
    CUDA tensor launches the kernel (or raises).
    """
    _check(x, w, tile_expert)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and w.device.type == "cpu":
        return grouped_matmul_plain(x, w, tile_expert, out_dtype)
    build.check_cuda_operands("grouped_matmul", x, w)
    if tile_expert.device != x.device or tile_expert.dtype != torch.int32 or not tile_expert.is_contiguous():
        raise ValueError("grouped_matmul: tile_expert must be a contiguous int32 tensor on the operands' device")
    if out_dtype not in (torch.float32, x.dtype):
        raise ValueError(f"grouped_matmul kernel stores float32 or the input dtype {x.dtype}, not {out_dtype}")
    (m, k), (e, _, n), t = x.shape, w.shape, tile_expert.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = build.library()
    rc = lib.tl_grouped_matmul(
        build.dtype_code(x.dtype), build.dtype_code(out_dtype),
        x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(), out.data_ptr(),
        t, n, k, e, m // t, build.stream(x),
    )  # fmt: skip
    build.check(rc, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
