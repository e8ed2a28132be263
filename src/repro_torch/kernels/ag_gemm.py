"""Fused AllGather + GEMM kernel (``csrc/ag_gemm.cu``), plan-driven.

Replaces ``repro/kernels/ag_gemm.py::ag_gemm_shard`` (``_ag_gemm_kernel``).
All W emulated ranks run in one cooperative launch with grid
(n-tile, channel, rank); the plan's ``src_tables()`` / ``flow_dst_tables()``
are device int32 tables.  The protocol, the bound and the design are noted
in ``csrc/ag_gemm.cu``; the flag primitives in ``csrc/tile_sync.cuh``.

:func:`ag_gemm_plain` is the plain PyTorch version: it replays the same
tables, the same gather slots and the same step order on any device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.core.channels import BlockChannel
from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.core.mapping import effective_channels
from repro_torch.core.plan import TilePlan, build_plan
from repro_torch.kernels import build

__all__ = ["ag_gemm", "ag_gemm_plain", "device_table"]


@functools.lru_cache(maxsize=256)
def device_table(plan: TilePlan, which: str, device: torch.device) -> torch.Tensor:
    """A plan table (``src`` / ``flow_dst`` / ``rs_seg`` / ``rs_dst``) as a flat
    int32 tensor on ``device``, indexed ``(c * W + s) * W + r``; cached per plan."""
    table = getattr(plan, f"{which}_tables")()
    return torch.tensor(table, dtype=torch.int32).reshape(-1).to(device)


def _check(x: torch.Tensor, w: torch.Tensor):
    if x.dim() < 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[-1] != w.shape[1]:
        raise ValueError(
            f"ag_gemm: expected x [W, ..., m_loc, K] and w [W, K, n_loc], got {tuple(x.shape)}, {tuple(w.shape)}"
        )


def _plan(x, w, channel, bn):
    world, m_loc, n_loc = x.shape[0], x.shape[-2], w.shape[-1]
    channel = channel or BlockChannel(axis="model")
    nch = effective_channels(m_loc, channel.num_channels, kind="ag_matmul")
    plan = build_plan("ag_matmul", channel, world, nch)
    return plan, largest_divisor(n_loc, bn or channel.comp.tile[1])


def ag_gemm_plain(x: torch.Tensor, w: torch.Tensor, *, channel: Optional[BlockChannel] = None) -> torch.Tensor:
    """Plain version: the kernel's schedule replayed step by step in PyTorch."""
    _check(x, w)
    plan, _ = _plan(x, w, channel, None)
    world, nch = plan.world, plan.num_channels
    lead, (m_loc, k), n_loc = x.shape[1:-2], x.shape[-2:], w.shape[-1]
    b = math.prod(lead)
    m_sub = m_loc // nch
    xs = x.reshape(world, b, m_loc, k)
    gbuf = torch.zeros((world, world * nch, b * m_sub, k), dtype=x.dtype, device=x.device)
    out = torch.zeros((world, b, world * m_loc, n_loc), dtype=x.dtype, device=x.device)
    src_t, dst_t = plan.src_tables(), plan.flow_dst_tables()
    for s in range(world):
        for c in range(nch):
            for r in range(world):
                o, d = src_t[c][s][r], dst_t[c][s][r]
                if s == 0:
                    tile = xs[r, :, c * m_sub : (c + 1) * m_sub].reshape(b * m_sub, k)
                else:
                    tile = gbuf[r, o * nch + c]
                if s < world - 1:
                    gbuf[d, o * nch + c] = tile  # push into the peer's gather slot
                part = (tile.float() @ w[r].float()).to(plan.accum_dtype).to(x.dtype)
                row = o * m_loc + c * m_sub
                out[r, :, row : row + m_sub] = part.reshape(b, m_sub, n_loc)
    return out.reshape((world,) + tuple(lead) + (world * m_loc, n_loc))


def ag_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    channel: Optional[BlockChannel] = None,
    bn: Optional[int] = None,
) -> torch.Tensor:
    """Fused AG+GEMM over the rank dimension.

    ``x``: [W, *lead, m_loc, K], ``w``: [W, K, n_loc] -> [W, *lead, W*m_loc, n_loc]:
    every rank's all-gathered rows times its own weight shard, rows gathered
    along dim -2 with the leading (batch) dims kept.  The schedule (order,
    channels), the accum dtype and the n tile (``bn``, default the CompSpec
    tn, clamped to a divisor of n_loc) come from ``channel``.  A CPU tensor
    runs :func:`ag_gemm_plain`; a CUDA tensor launches the kernel (or raises).
    """
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ag_gemm_plain(x, w, channel=channel)
    plan, bn = _plan(x, w, channel, bn)
    build.check_cuda_operands("ag_gemm", x, w)
    world, nch = plan.world, plan.num_channels
    lead, (m_loc, k), n_loc = x.shape[1:-2], x.shape[-2:], w.shape[-1]
    b = math.prod(lead)
    m_sub = m_loc // nch
    n_tiles = n_loc // bn
    accum_bf16 = int(plan.accum_dtype == torch.bfloat16)
    if plan.accum_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ag_gemm kernel accumulates in float32 or bfloat16, not {plan.accum_dtype}")
    out = torch.empty((world, b, world * m_loc, n_loc), dtype=x.dtype, device=x.device)
    gbuf = torch.empty((world, world * nch, b * m_sub, k), dtype=x.dtype, device=x.device)
    flags = torch.zeros((world, world, nch), dtype=torch.int32, device=x.device)  # (rank, step, channel)
    src = device_table(plan, "src", x.device)
    dst = device_table(plan, "flow_dst", x.device)
    lib = build.library()
    rc = lib.tl_ag_gemm(
        build.dtype_code(x.dtype), accum_bf16,
        x.data_ptr(), w.data_ptr(), out.data_ptr(), gbuf.data_ptr(), flags.data_ptr(),
        src.data_ptr(), dst.data_ptr(),
        world, nch, n_tiles, b, m_loc, m_sub, k, n_loc, bn, build.stream(x),
    )  # fmt: skip
    build.check(rc, "ag_gemm")
    ag_gemm.launches += 1
    return out.reshape((world,) + tuple(lead) + (world * m_loc, n_loc))


ag_gemm.launches = 0
