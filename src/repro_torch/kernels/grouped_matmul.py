"""Grouped (MoE expert) GEMM kernel (``csrc/grouped_matmul.cu``), table-driven.

Replaces ``repro/kernels/grouped_matmul.py::grouped_matmul``: ``x`` [M, K]
holds expert-sorted, tile-aligned rows, ``w`` [E, K, N] the experts'
weights, and ``tile_expert`` [M / bm] (int32, on the device) names the expert
of each row tile — the paper's dynamic mapping f_R.  The kernel reads the
table on the device, so one launch covers every expert.  Two routes, chosen
by dtype before the launch (never by a fallback):

  * bfloat16 (the serve dtype): ``wgmma_gemm_kernel`` (``csrc/wgmma_gemm.cu``),
    a persistent grid of 128 x 128 output tiles (:func:`work_items`) through
    the TMA -> shared-memory ring -> ``wgmma`` body of
    ``csrc/wgmma_tile.cuh``; it stores float32 or bfloat16.  K and N must be
    multiples of 8 and the bases 16-byte aligned (TMA), else ValueError.
  * float32: the ``csrc/tile_gemm.cuh`` FMA loop, exact float32 products.

``grouped_matmul.last_launch`` says which route the last launch took, its
grid and its item count.

:func:`grouped_matmul_plain` is the plain PyTorch version: it gathers the
weights once per row tile (not per row, as the JAX oracle
``ref.grouped_matmul_ref`` does) and multiplies in float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.kernels import build

__all__ = ["grouped_matmul", "grouped_matmul_plain", "group_tile_table", "work_items", "GemmItem", "ROW_TILE"]

ROW_TILE = build.WGMMA_TILE[0]  # the bf16 route's m-tile: the largest row tile one item covers


@functools.lru_cache(maxsize=64)
def group_tile_table(num_groups: int, group_rows: int, device: torch.device) -> torch.Tensor:
    """Row tiles of ``num_groups`` consecutive groups of ``group_rows`` rows,
    group g using expert g: the int32 table [num_groups * group_rows / bm]
    with bm the largest divisor of ``group_rows`` that is <= ROW_TILE.  Built
    once per shape, on ``device``."""
    bm = largest_divisor(group_rows, ROW_TILE)
    tiles = torch.arange(num_groups * group_rows // bm, dtype=torch.int64) * bm // group_rows
    return tiles.to(device=device, dtype=torch.int32)


class GemmItem(NamedTuple):
    """One work item of the bf16 route: rows ``row0 .. row0 + rows`` of row
    tile ``t`` (its sub-tile ``j``) times n-tile ``nt``."""

    index: int
    t: int
    j: int
    nt: int
    row0: int
    rows: int


def work_items(row_tiles: int, bm: int, n: int, tile=build.WGMMA_TILE) -> list:
    """The bf16 route's work items in the order ``wgmma_gemm_kernel`` numbers
    them (``wg_gemm_item``): m-tile fastest, so the blocks that run together
    share a weight strip.  Row tile t (``bm`` rows) splits into
    ceil(bm / BM) m-tiles; the plain GEMM is one row tile of M rows."""
    tm, tn = tile
    sub = -(-bm // tm)
    items = []
    for nt in range(-(-n // tn)):
        for t in range(row_tiles):
            for j in range(sub):
                items.append(GemmItem(len(items), t, j, nt, t * bm + j * tm, min(tm, bm - j * tm)))
    return items


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
    CUDA tensor launches the kernel of its dtype's route (``build.ROUTES``) or
    raises.
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
    route = build.ROUTES[x.dtype]
    if route == "wgmma":
        build.check_tma_operands("grouped_matmul", x, w)
    (m, k), (e, _, n), t = x.shape, w.shape, tile_expert.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    info = (ctypes.c_int * 2)()
    lib = build.library()
    rc = lib.tl_grouped_matmul(
        build.dtype_code(x.dtype), build.dtype_code(out_dtype),
        x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(), out.data_ptr(), ctypes.addressof(info),
        t, n, k, e, m // t, build.stream(x),
    )  # fmt: skip
    build.check(rc, "grouped_matmul")
    if route == "wgmma":
        grouped_matmul.last_launch = {"route": route, "grid": info[0], "items": info[1]}
    else:  # one block per (row tile, 128-column tile)
        grouped_matmul.last_launch = {"route": route, "grid": t * -(-n // 128), "items": None}
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
grouped_matmul.last_launch = None
