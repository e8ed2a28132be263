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

Under autograd (grad mode on and an operand that requires grad) the call
goes through :class:`_GroupedMatmul`: dx is this kernel again, on the
transposed weights with the same table (row tile t of dy times
w[tile_expert[t]]^T; callers that run several GEMMs on the same weights,
as a ring's steps do, share one transposed copy through
:class:`SharedTranspose`), and dw[e] sums x_t^T dy_t over the row tiles t of
expert e in float32, formed by ``torch.bmm`` outside any kernel (the JAX
package leaves that product to XLA's autodiff of its einsum).

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

__all__ = [
    "grouped_matmul", "grouped_matmul_plain", "group_tile_table", "dot_f32", "SharedTranspose", "work_items",
    "GemmItem", "ROW_TILE",
]  # fmt: skip

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
    x: torch.Tensor,
    w: torch.Tensor,
    tile_expert: torch.Tensor,
    *,
    out_dtype: Optional[torch.dtype] = None,
    group_rows: Optional[int] = None,
    shared_wt: Optional["SharedTranspose"] = None,
) -> torch.Tensor:
    """``out[rows of tile t] = x[rows of tile t] @ w[tile_expert[t]]`` -> [M, N].

    The row tile is ``M / len(tile_expert)``.  ``out_dtype`` is float32 or the
    input dtype (default).  A CPU tensor runs :func:`grouped_matmul_plain`; a
    CUDA tensor launches the kernel of its dtype's route (``build.ROUTES``) or
    raises.  ``group_rows`` tells the backward that the table is
    ``group_tile_table(E, group_rows)`` (E consecutive groups, group g on
    expert g), so dw is one batched GEMM over the groups; without it dw sums
    the row tiles' products by the table.  ``shared_wt`` lends the backward
    one w^T copy shared with the other calls on the same weights.
    """
    _check(x, w, tile_expert)
    out_dtype = out_dtype or x.dtype
    if group_rows is not None and x.shape[0] != w.shape[0] * group_rows:
        raise ValueError(f"grouped_matmul: {x.shape[0]} rows are not {w.shape[0]} groups of {group_rows}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, tile_expert, out_dtype, group_rows, shared_wt)
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


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [G, R, K] @ b [G, K, N]`` -> float32 [G, R, N], float32 sums: on
    the card a bf16 / fp16 pair runs one tensor-core ``torch.bmm`` storing
    float32 (the caller keeps reduced-precision reductions off), elsewhere
    the product of float32 copies."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and b.dtype == a.dtype:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class SharedTranspose:
    """The contiguous w^T [E, N, K] that the dx launches of several grouped
    GEMMs on the same weights share (the W steps of a ring on a layer's
    expert weights): each forward that will need dx registers, the first
    backward makes the copy and the last one drops it, so a layer's
    backward copies each weight once, not once per step."""

    def __init__(self):
        self.users, self.key, self.wt = 0, None, None

    def register(self, w: torch.Tensor):
        key = (w.data_ptr(), tuple(w.shape), w.dtype)
        if self.key not in (None, key):
            raise ValueError(f"SharedTranspose: registered for weights {self.key}, given {key}")
        self.key, self.users = key, self.users + 1

    def take(self, w: torch.Tensor) -> torch.Tensor:
        if self.wt is None:
            self.wt = w.transpose(1, 2).contiguous()
        wt, self.users = self.wt, self.users - 1
        if self.users == 0:
            self.wt = None
        return wt


class _GroupedMatmul(torch.autograd.Function):
    """The grouped GEMM under autograd (module docstring).  An entry of the
    table outside [0, E) gives zero rows forward, zero dx rows and nothing
    in dw.  dy reaches dx in the weights' dtype (the bf16 route takes one
    dtype; the gate|up GEMM stores float32).  dw has two forms: with
    ``group_rows`` (the MoE layers' equal groups) one product per group;
    for any other table, as the kernel accepts (a sorted-token dispatch's
    uneven groups, ROADMAP queue 1 item 3 (d)), one product per row tile
    summed into its expert."""

    @staticmethod
    def forward(ctx, x, w, tile_expert, out_dtype, group_rows, shared_wt):
        ctx.save_for_backward(x, w, tile_expert)
        ctx.group_rows, ctx.shared_wt = group_rows, shared_wt
        if shared_wt is not None and ctx.needs_input_grad[0]:
            shared_wt.register(w)
        return grouped_matmul(x, w, tile_expert, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, te = ctx.saved_tensors
        dy = dy.to(w.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.transpose(1, 2).contiguous() if ctx.shared_wt is None else ctx.shared_wt.take(w)
            dx = grouped_matmul(dy, wt, te, out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            k, (e, _, n) = x.shape[1], w.shape
            if ctx.group_rows is not None:  # one product per group: group g is expert g
                dw = dot_f32(x.view(e, -1, k).transpose(1, 2), dy.view(e, -1, n))
            else:  # one product per row tile, summed into its expert by a one-hot contraction
                t = te.shape[0]
                per_tile = dot_f32(x.view(t, -1, k).transpose(1, 2), dy.view(t, -1, n))
                valid = ((te >= 0) & (te < e)).float()
                onehot = torch.nn.functional.one_hot(te.long().clamp(0, e - 1), e).float() * valid[:, None]
                dw = torch.matmul(onehot.t(), per_tile.reshape(t, k * n)).reshape(e, k, n)
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None, None


grouped_matmul.launches = 0
grouped_matmul.last_launch = None
