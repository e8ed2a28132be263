"""Eager overlap backend — one generic schedule executor over tile plans.

The port's counterpart of ``repro/core/overlap.py`` for the "ag" and "rs"
flows, and of the JAX package's ``"xla"`` backend.  Every function here
takes rank-stacked operands (``[W, ...]``, see ``backend/mesh.World``); a
permute is an index on the rank dimension, so each step of the plan is
plain PyTorch.  It is the reference the fused Hopper kernels are held
against, and the model path when ``ParallelContext(backend="eager")``.

There is exactly one schedule loop here, :func:`run_plan`; ``ag_matmul``
and ``matmul_rs`` are GEMM callbacks plugged into it.  The non-overlapped
baselines (gather then GEMM; GEMM then reduce-scatter) sit beside them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.backend.mesh import World
from repro_torch.core.channels import BlockChannel
from repro_torch.core.comp_tiles import DEFAULT_TILE, blocked_dot
from repro_torch.core.mapping import effective_channels
from repro_torch.core.plan import TilePlan, build_plan

__all__ = [
    "run_plan",
    "TileContext",
    "ag_matmul",
    "ag_matmul_baseline",
    "matmul_rs",
    "matmul_rs_baseline",
    "plan_for",
    "rank_rows",
]


@dataclasses.dataclass(frozen=True)
class TileContext:
    """What the executor tells a compute callback about the current tile.

    ``src`` holds one int per rank: the origin rank of the held tile for
    "ag" flows, the reduced segment for "rs" flows.
    """

    step: int
    channel: int
    src: Tuple[int, ...]


def run_plan(
    plan: TilePlan,
    world: World,
    tile_fn: Callable,
    *,
    state: Optional[Sequence[torch.Tensor]] = None,
    carry: Any = None,
) -> Any:
    """Execute a tile plan over the world's rank dimension.

    flow "ag": ``state[c]`` is channel c's flowing tile ``[W, ...]``.  Each
    step the executor issues every channel's next-step permute, then calls
    ``tile_fn(ctx, tile, carry) -> carry`` on each held tile.  Returns the
    final carry.

    flow "rs": ``tile_fn(ctx, None, None) -> partial`` computes the partial
    for segment ``ctx.src``; one flowing accumulator per channel
    (``acc = permute(acc) + partial``).  Returns the per-channel home
    segments.
    """
    nch = plan.num_channels
    if plan.flow == "ag":
        state = list(state)
        for s in range(plan.steps):
            nxt = None
            if s < plan.steps - 1:
                nxt = [world.permute(state[c], plan.channels[c].flow_perm(s)) for c in range(nch)]
            for c in range(nch):
                ctx = TileContext(s, c, plan.channels[c].source_table(s))
                carry = tile_fn(ctx, state[c], carry)
            if nxt is not None:
                state = nxt
        return carry
    if plan.flow == "rs":
        accs: List[torch.Tensor] = [None] * nch
        for s in range(plan.steps):
            for c in range(nch):
                sched = plan.channels[c]
                part = tile_fn(TileContext(s, c, sched.rs_segment_table(s)), None, None)
                if s == 0:
                    accs[c] = part
                else:
                    accs[c] = world.permute(accs[c], sched.rs_perm(s - 1)) + part
        return accs
    raise NotImplementedError(f"run_plan: flow {plan.flow!r} is not ported")


def plan_for(kind: str, channel: BlockChannel, world: int, extent: int) -> TilePlan:
    """Resolve the effective channel count against ``extent`` and fetch the plan."""
    nch = effective_channels(extent, channel.num_channels, kind=kind)
    return build_plan(kind, channel, world, nch)


def rank_rows(x: torch.Tensor, starts: Sequence[int], m: int) -> torch.Tensor:
    """Per-rank row slice: ``out[r] = x[r, ..., starts[r]:starts[r]+m, :]``."""
    return torch.stack([x[r, ..., s : s + m, :] for r, s in enumerate(starts)])


def _rank_weight(w: torch.Tensor, lead: int) -> torch.Tensor:
    """[W, k, n] -> [W, 1, ..., 1, k, n] broadcasting over ``lead`` batch dims."""
    return w.reshape((w.shape[0],) + (1,) * lead + tuple(w.shape[1:]))


def _consume_dot(a, w, comp_tile, accum, out_dtype=None):
    """One consumer GEMM tile ``a @ w`` per rank, honoring the CompSpec tile.

    The product is formed in float32 and rounded to ``accum`` (the JAX
    package's ``preferred_element_type``), then to ``out_dtype``.
    """
    wb = _rank_weight(w, a.dim() - 3)
    if tuple(comp_tile) != DEFAULT_TILE:
        out = blocked_dot(a, wb, tuple(comp_tile), accum=torch.float32)
    else:
        out = torch.matmul(a.float(), wb.float())
    out = out.to(accum)
    return out.to(out_dtype) if out_dtype is not None else out


def _check_ranked(x: torch.Tensor, w: torch.Tensor, world: World, what: str):
    if x.dim() < 3 or w.dim() != 3 or x.shape[0] != world.size or w.shape[0] != world.size:
        raise ValueError(
            f"{what}: expected x [W, ..., m, k] and w [W, k, n] with W={world.size}, "
            f"got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    if x.shape[-1] != w.shape[1]:
        raise ValueError(f"{what}: contraction mismatch {tuple(x.shape)} @ {tuple(w.shape)}")


# -----------------------------------------------------------------------------
# AG + GEMM  (column-parallel producer/consumer pair)
# -----------------------------------------------------------------------------


def ag_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    world: World,
    channel: Optional[BlockChannel] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Overlapped AllGather(x) @ w.

    ``x``: [W, *lead, m_loc, K] (sharded along rows), ``w``: [W, K, n_loc].
    Returns [W, *lead, W * m_loc, n_loc].  The local shard splits into
    ``num_channels`` sub-chunks flowing independently per the channel's
    order; each held tile is consumed by a GEMM in the accum dtype.
    """
    _check_ranked(x, w, world, "ag_matmul")
    channel = channel or BlockChannel(axis="model")
    out_dtype = out_dtype or x.dtype
    m_loc, n_loc = x.shape[-2], w.shape[-1]
    plan = plan_for("ag_matmul", channel, world.size, m_loc)
    m_sub = m_loc // plan.num_channels
    chunks = [x[..., c * m_sub : (c + 1) * m_sub, :] for c in range(plan.num_channels)]
    out = torch.zeros(
        x.shape[:-2] + (world.size * m_loc, n_loc), dtype=out_dtype, device=x.device
    )

    def gemm_tile(ctx, tile, out):
        part = _consume_dot(tile, w, channel.comp.tile, plan.accum_dtype, out_dtype)
        for r, src in enumerate(ctx.src):
            row = src * m_loc + ctx.channel * m_sub  # f_S of the held tile
            out[r, ..., row : row + m_sub, :] = part[r]
        return out

    return run_plan(plan, world, gemm_tile, state=chunks, carry=out)


def ag_matmul_baseline(x, w, *, world: World, out_dtype=None, channel=None):
    """Non-overlapping reference: gather the rows, then one GEMM per rank."""
    _check_ranked(x, w, world, "ag_matmul_baseline")
    out_dtype = out_dtype or x.dtype
    xg = world.all_gather(x, dim=x.dim() - 3)
    return torch.matmul(xg.float(), _rank_weight(w, x.dim() - 3).float()).to(out_dtype)


# -----------------------------------------------------------------------------
# GEMM + ReduceScatter  (paper Fig. 4)
# -----------------------------------------------------------------------------


def matmul_rs(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    world: World,
    channel: Optional[BlockChannel] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Overlapped (x @ w) reduce-scattered along rows.

    ``x``: [W, *lead, M, k_loc], ``w``: [W, k_loc, N]; returns
    [W, *lead, M / W, N].  Each step fuses the arriving partial into this
    rank's GEMM tile for the scheduled segment; ``num_channels`` chunks the
    N columns into independent flows, accumulated in the accum dtype.
    """
    _check_ranked(x, w, world, "matmul_rs")
    channel = channel or BlockChannel(axis="model")
    out_dtype = out_dtype or x.dtype
    m_glob, n = x.shape[-2], w.shape[-1]
    if m_glob % world.size:
        raise ValueError(f"matmul_rs: {m_glob} rows do not divide over {world.size} ranks")
    plan = plan_for("matmul_rs", channel, world.size, n)
    m_loc = m_glob // world.size
    n_sub = n // plan.num_channels

    def gemm_tile(ctx, _tile, _carry):
        xs = rank_rows(x, [seg * m_loc for seg in ctx.src], m_loc)
        wc = w[..., ctx.channel * n_sub : (ctx.channel + 1) * n_sub]
        return _consume_dot(xs, wc, channel.comp.tile, plan.accum_dtype)

    accs = run_plan(plan, world, gemm_tile)
    return torch.cat(accs, dim=-1).to(out_dtype)


def matmul_rs_baseline(x, w, *, world: World, out_dtype=None, channel=None):
    """Non-overlapping reference: one GEMM per rank, then reduce-scatter."""
    _check_ranked(x, w, world, "matmul_rs_baseline")
    out_dtype = out_dtype or x.dtype
    part = torch.matmul(x.float(), _rank_weight(w, x.dim() - 3).float())
    return world.reduce_scatter(part, dim=part.dim() - 3).to(out_dtype)
