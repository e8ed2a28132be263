"""Fused GEMM + ReduceScatter kernel (``csrc/gemm_rs.cu``), plan-driven.

Replaces ``repro/kernels/gemm_rs.py::gemm_rs_shard`` (``_gemm_rs_kernel``).
All W emulated ranks run in one cooperative launch with grid
(n-tile, channel, rank); the plan's ``rs_seg_tables()`` /
``rs_dst_tables()`` are device int32 tables.  The protocol, the bound and the
design are noted in ``csrc/gemm_rs.cu``.

:func:`gemm_rs_plain` is the plain PyTorch version: it replays the same
tables, the same recv slots and the same stage order on any device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.channels import BlockChannel
from repro_torch.core.comp_tiles import largest_divisor
from repro_torch.core.mapping import effective_channels
from repro_torch.core.plan import build_plan
from repro_torch.kernels import build
from repro_torch.kernels.ag_gemm import device_table

__all__ = ["gemm_rs", "gemm_rs_plain"]


def _check(x: torch.Tensor, w: torch.Tensor):
    if x.dim() < 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[-1] != w.shape[1]:
        raise ValueError(
            f"gemm_rs: expected x [W, ..., M, k_loc] and w [W, k_loc, N], got {tuple(x.shape)}, {tuple(w.shape)}"
        )
    if x.shape[-2] % x.shape[0]:
        raise ValueError(f"gemm_rs: {x.shape[-2]} rows do not divide over {x.shape[0]} ranks")


def _plan(x, w, channel, bn):
    world, n = x.shape[0], w.shape[-1]
    channel = channel or BlockChannel(axis="model")
    nch = effective_channels(n, channel.num_channels, kind="matmul_rs")
    plan = build_plan("matmul_rs", channel, world, nch)
    return plan, largest_divisor(n // nch, bn or channel.comp.tile[1])


def gemm_rs_plain(x: torch.Tensor, w: torch.Tensor, *, channel: Optional[BlockChannel] = None) -> torch.Tensor:
    """Plain version: the kernel's schedule replayed stage by stage in PyTorch."""
    _check(x, w)
    plan, _ = _plan(x, w, channel, None)
    world, nch = plan.world, plan.num_channels
    lead, (m_glob, k), n = x.shape[1:-2], x.shape[-2:], w.shape[-1]
    b = math.prod(lead)
    m_loc, n_sub = m_glob // world, n // nch
    xs = x.reshape(world, b, m_glob, k)
    rbuf = torch.zeros((world, world * nch, b * m_loc, n_sub), dtype=plan.accum_dtype, device=x.device)
    out = torch.zeros((world, b, m_loc, n), dtype=x.dtype, device=x.device)
    seg_t, dst_t = plan.rs_seg_tables(), plan.rs_dst_tables()
    for s in range(world):
        for c in range(nch):
            cols = slice(c * n_sub, (c + 1) * n_sub)
            for r in range(world):
                seg, d = seg_t[c][s][r], dst_t[c][s][r]
                rows = xs[r, :, seg * m_loc : (seg + 1) * m_loc].reshape(b * m_loc, k)
                part = rows.float() @ w[r, :, cols].float()
                if s > 0:
                    part = part + rbuf[r, (s - 1) * nch + c].float()  # partial received last stage
                if s < world - 1:
                    rbuf[d, s * nch + c] = part.to(plan.accum_dtype)  # push to the peer's recv slot
                else:
                    out[r, :, :, cols] = part.reshape(b, m_loc, n_sub).to(x.dtype)
    return out.reshape((world,) + tuple(lead) + (m_loc, n))


def gemm_rs(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    channel: Optional[BlockChannel] = None,
    bn: Optional[int] = None,
) -> torch.Tensor:
    """Fused GEMM+RS over the rank dimension.

    ``x``: [W, *lead, M, k_loc], ``w``: [W, k_loc, N] -> [W, *lead, M/W, N]:
    rank r's row segment of ``sum_q x[q] @ w[q]``.  The schedule, the accum
    dtype (also the wire dtype of the identity QuantSpec) and the n tile
    (``bn``, default the CompSpec tn clamped to a divisor of N / C) come from
    ``channel``.  A CPU tensor runs :func:`gemm_rs_plain`; a CUDA tensor
    launches the kernel (or raises).
    """
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gemm_rs_plain(x, w, channel=channel)
    plan, bn = _plan(x, w, channel, bn)
    build.check_cuda_operands("gemm_rs", x, w)
    world, nch = plan.world, plan.num_channels
    lead, (m_glob, k), n = x.shape[1:-2], x.shape[-2:], w.shape[-1]
    b = math.prod(lead)
    m_loc, n_sub = m_glob // world, n // nch
    n_tiles = n_sub // bn
    out = torch.empty((world, b, m_loc, n), dtype=x.dtype, device=x.device)
    rbuf = torch.empty((world, world * nch, b * m_loc, n_sub), dtype=plan.accum_dtype, device=x.device)
    # one flag per (rank, stage, channel, n-tile)
    flags = torch.zeros((world, world, nch, n_tiles), dtype=torch.int32, device=x.device)
    seg = device_table(plan, "rs_seg", x.device)
    dst = device_table(plan, "rs_dst", x.device)
    lib = build.library()
    rc = lib.tl_gemm_rs(
        build.dtype_code(x.dtype), build.dtype_code(plan.accum_dtype),
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rbuf.data_ptr(), flags.data_ptr(),
        seg.data_ptr(), dst.data_ptr(),
        world, nch, n_tiles, b, m_glob, k, n, n_sub, bn, build.stream(x),
    )  # fmt: skip
    build.check(rc, "gemm_rs")
    gemm_rs.launches += 1
    return out.reshape((world,) + tuple(lead) + (m_loc, n))


gemm_rs.launches = 0
