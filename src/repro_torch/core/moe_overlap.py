"""MoE overlap — the port of ``repro/core/moe_overlap.py``: the
tensor-parallel AG + MoE double ring (paper Fig. 5) and the
expert-parallel dispatch / combine all-to-all.

The paper's hardest case: AllGather + Gather + GroupGEMM + TopkReduce +
ReduceScatter with a *dynamic* tile mapping (token routing known only at run
time).  ``ag_moe`` runs it as an "ag_rs" tile plan on the one schedule
executor (``core/overlap.run_plan``), the double ring of the JAX package:

  * token tiles and their routing tables flow together along the plan's
    per-step permutes, so the mapping tables travel with the data;
  * at every step each rank runs its local experts on the tile it holds
    (:func:`local_expert_ffn`), and the partial joins a reduction that rides
    the same permutes, then one ``align_perm`` hop sends it home.

Every function takes rank-stacked operands (``[W, ...]``): tokens
``x [W, *lead, m, d]`` with ``ids`` / ``wts [W, *lead, m, k]``, and rank r's
experts ``w_gu [W, E_loc, d, 2f]`` (gate|up) and ``w_down [W, E_loc, f, d]``,
rank r hosting experts ``r * E_loc .. (r + 1) * E_loc - 1``.  Over a world
of processes (``World(..., procs=)``) the leading dimension is this
process's ``held`` ranks, the first of them global rank ``world.rank0``;
capacity is sized by the whole world's experts (``world.size``) all the
same, so every process keeps and drops what the one-process world does.
The overlapped forms' permutes then cross the cards and complete lazily
(``core/overlap._permute_start``), so a ring step's expert GEMMs are
issued before the wait for the next step's tile.  The baselines gather
every origin's tokens and tables (an all-gather over the processes) and
return the partials home by a reduce-scatter over the origin axis (the
library's sum over the processes, in its own order); on one process
that return is the rank-order ``psum`` it always was.  Capacity
dispatch is per (rank, leading index, channel chunk) over the token axis, as
the JAX package's ``vmap`` over batch rows gives it; the batch rows are
folded only into the rows of the expert GEMMs.  Those run on the
hand-written grouped GEMM kernel (``kernels/grouped_matmul.py``) when
``grouped=True`` (the "fused" backend), else as one batched GEMM over every
(rank, expert) — float32 products, or on the card a tensor-core
``torch.bmm`` for bf16 / fp16 operands — or the CompSpec-blocked
``blocked_dot`` (the "eager" backend, and ``ag_moe_baseline``).

Expert parallelism (``a2a_moe``) runs the ``a2a_dispatch -> combine_rs``
pair (``core/overlap.run_a2a_seq``): at each step a peer's own token tile
and its routing tables land by a direct exchange, the local experts run on
it, and the weighted partial returns home along the reversed edge.
Capacity is per (landing rank, origin sub-chunk of ``m_loc / C`` tokens,
leading index) on both it and ``a2a_moe_baseline``, so the two keep and
drop the same (token, k) pairs.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.backend.mesh import World
from repro_torch.core.channels import BlockChannel
from repro_torch.core.comp_tiles import DEFAULT_TILE, blocked_dot
from repro_torch.core.mapping import effective_channels
from repro_torch.core.overlap import plan_for, run_a2a_seq, run_plan
from repro_torch.core.plan import build_seq_plan
from repro_torch.kernels.grouped_matmul import SharedTranspose, dot_f32, group_tile_table, grouped_matmul

__all__ = ["moe_router", "local_expert_ffn", "ag_moe", "ag_moe_baseline", "a2a_moe", "a2a_moe_baseline",
           "gather_origins", "return_home"]  # fmt: skip


def moe_router(x, w_router, *, num_experts: int, top_k: int, valid_experts: Optional[int] = None):
    """Top-k softmax router over the token axis of ``x [..., m, d]``.

    Returns (topk_ids int64 [..., m, k], topk_w f32 [..., m, k], aux f32 [...]),
    one Switch-style load-balance loss per leading index.  ``valid_experts``
    gives padding experts -inf logits, so they are never selected.
    """
    logits = torch.matmul(x.float(), w_router.float())
    if valid_experts is not None and valid_experts < num_experts:
        pad = torch.arange(num_experts, device=x.device) >= valid_experts
        logits = logits.masked_fill(pad, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_ids = torch.topk(probs, top_k, dim=-1, sorted=True)  # ties: the lower index first
    topk_w = topk_w / topk_w.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(-2)
    ce = F.one_hot(topk_ids, num_experts).float().sum((-3, -2))
    ce = ce / ce.sum(-1, keepdim=True).clamp_min(1.0)
    aux = (valid_experts or num_experts) * (me * ce).sum(-1)
    return topk_ids, topk_w, aux


def _dispatch_tables(local_ids, valid, e_loc: int, cap: int, dtype):
    """Capacity dispatch [..., m, k, E_loc, cap] from per-(token, k) local expert
    ids: slot = the (token, k)'s position among its expert's earlier entries,
    dropped at or past ``cap``."""
    *lead, m, k = local_ids.shape
    onehot = F.one_hot(local_ids, e_loc).float() * valid[..., None]
    flat = onehot.reshape(*lead, m * k, e_loc)
    pos = torch.cumsum(flat, dim=-2) - flat  # position within expert, per (t, k)
    keep = (pos < cap).float() * flat
    disp = F.one_hot(pos.long().clamp(max=cap - 1), cap).float() * keep[..., None]
    return disp.reshape(*lead, m, k, e_loc, cap).to(dtype)


def _expert_gemm(a, w, out_dtype, tile, grouped: bool, shared_wt=None):
    """``a [W, E, rows, K] @ w [W, E, K, N]`` per (rank, expert), float32 accumulation.

    Eagerly on the card a bf16 / fp16 operand pair runs one tensor-core
    ``torch.bmm`` over every (rank, expert) (``out_dtype=float32`` where the
    output stays float32), not an upcast into a float32 GEMM; as for
    ``core/overlap._baseline_dot`` the caller keeps
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off so the sums stay float32.  Elsewhere (float32, or the CPU) the
    product is formed in float32 and cast.  ``shared_wt`` (grouped only)
    shares the backward's w^T copy with the other steps on these weights."""
    world, e, rows, k = a.shape
    if grouped:
        table = group_tile_table(world * e, rows, a.device)
        a2, w3 = a.reshape(-1, k).contiguous(), w.reshape(world * e, k, -1)
        out = grouped_matmul(a2, w3, table, out_dtype=out_dtype, group_rows=rows, shared_wt=shared_wt)
        return out.reshape(world, e, rows, -1)
    if tile is not None and tuple(tile) != DEFAULT_TILE:
        return blocked_dot(a, w, tuple(tile), accum=torch.float32, out_dtype=out_dtype)
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) and w.dtype == a.dtype:
        a3, w3 = a.reshape(world * e, rows, k), w.reshape(world * e, k, -1)
        return _ExpertBmm.apply(a3, w3, out_dtype).reshape(world, e, rows, -1)
    return torch.matmul(a.float(), w.float()).to(out_dtype)


class _ExpertBmm(torch.autograd.Function):
    """The card's tensor-core expert GEMM, ``a [G, R, K] @ w [G, K, N]``,
    under autograd (``torch.bmm`` with ``out_dtype`` has no derivative):
    dx one bmm of dy with w^T, dw one bmm of a^T with dy, float32 sums
    rounded once; dy in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, w, out_dtype):
        ctx.save_for_backward(a, w)
        return torch.bmm(a, w) if out_dtype == a.dtype else torch.bmm(a, w, out_dtype=torch.float32).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        a, w = ctx.saved_tensors
        dy = dy.to(a.dtype)
        da = torch.bmm(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = dot_f32(a.transpose(1, 2), dy).to(w.dtype) if ctx.needs_input_grad[1] else None
        return da, dw, None


def local_expert_ffn(
    x,
    topk_ids,
    topk_w,
    w_gu,
    w_down,
    *,
    cap: int,
    act: Callable = F.silu,
    tile: Optional[Tuple[int, int, int]] = None,
    grouped: bool = False,
    shared_wt: Tuple[Optional[SharedTranspose], Optional[SharedTranspose]] = (None, None),
    rank0: int = 0,
):
    """Each rank's FFN through its local experts; zeros for tokens routed elsewhere.

    ``x [W, *lead, m, d]``, ``topk_ids`` / ``topk_w [W, *lead, m, k]``,
    ``w_gu [W, E_loc, d, 2f]``, ``w_down [W, E_loc, f, d]``: the leading
    dimension's ranks are global ranks ``rank0, rank0 + 1, ...`` (a world
    over processes passes ``world.rank0``), rank r hosting experts
    ``r * E_loc ..``.  Returns the combined partial ``[W, *lead, m, d]``.  The rows of all leading indices
    meet in one group of ``n_lead * cap`` rows per (rank, expert), so the
    grouped kernel covers every rank and expert in one launch per GEMM.
    ``shared_wt`` holds the w^T copies of ``w_gu`` and ``w_down`` that the
    grouped kernel's dx launches share across a ring's steps.
    """
    world, m, d = x.shape[0], x.shape[-2], x.shape[-1]
    k, e_loc, f = topk_ids.shape[-1], w_gu.shape[1], w_down.shape[2]
    xb = x.reshape(world, -1, m, d)
    nb = xb.shape[1]
    ranks = rank0 + torch.arange(world, device=x.device)
    local = topk_ids.reshape(world, nb, m, k) - (ranks * e_loc).view(world, 1, 1, 1)
    valid = (local >= 0) & (local < e_loc)
    local = torch.where(valid, local, torch.zeros_like(local))

    disp_mkec = _dispatch_tables(local, valid.float(), e_loc, cap, x.dtype)  # [W, nb, m, k, E, c]
    disp = disp_mkec.sum(-3)  # [W, nb, m, E, c]: 0/1, slots unique per (t, k)
    # comb[.., m, e, c] is the one kept weight in that slot (a token's k experts are distinct): scattered
    # by slot, so autograd saves the slot indices for the router's gradient, not the 6-D table
    slots = disp_mkec.flatten(-2)  # [W, nb, m, k, E * c]
    kept_w = topk_w.reshape(world, nb, m, k).to(x.dtype) * slots.sum(-1)  # 0 where dropped
    comb = torch.zeros(slots.shape[:3] + slots.shape[-1:], dtype=x.dtype, device=x.device)
    comb = comb.scatter_add(-1, slots.argmax(-1), kept_w).reshape(disp.shape)
    x_e = torch.einsum("wbmec,wbmd->webcd", disp, xb).reshape(world, e_loc, nb * cap, d)
    h = _expert_gemm(x_e, w_gu, torch.float32, tile, grouped, shared_wt[0])  # gate|up, float32
    h = (act(h[..., :f]) * h[..., f:]).to(x.dtype)
    y_e = _expert_gemm(h, w_down, x.dtype, tile, grouped, shared_wt[1])
    out = torch.einsum("wbmec,webcd->wbmd", comb, y_e.reshape(world, e_loc, nb, cap, d))
    return out.reshape(x.shape)


def ag_moe(
    x,
    topk_ids,
    topk_w,
    w_gu,
    w_down,
    *,
    world: World,
    channel: Optional[BlockChannel] = None,
    capacity_factor: float = 1.25,
    act: Callable = F.silu,
    grouped: bool = False,
):
    """Overlapped AG + MoE + RS double flow (see the module docstring).

    ``x [W, *lead, m_loc, d]`` is each rank's token chunk; returns the
    combined outputs for it, ``[W, *lead, m_loc, d]``.  ``num_channels``
    splits the chunk into independently scheduled flows, each with its own
    capacity; the reduction accumulates in the CompSpec accum dtype.
    """
    channel = channel or BlockChannel(axis="model")
    m_loc, k, e_loc = x.shape[-2], topk_ids.shape[-1], w_gu.shape[1]
    plan = plan_for("ag_moe", channel, world.size, m_loc)
    m_sub = m_loc // plan.num_channels
    cap = _capacity(m_sub, k, e_loc * world.size, capacity_factor)
    tile_fn = _expert_tile(w_gu, w_down, cap, act, channel, grouped, plan.accum_dtype, world.rank0)
    accs = run_plan(plan, world, tile_fn, state=_token_chunks(x, topk_ids, topk_w, plan.num_channels))
    return torch.cat(accs, dim=-2).to(x.dtype)


def _token_chunks(x, topk_ids, topk_w, nch: int) -> list:
    """Channel c's token tile and its routing tables: sub-chunk c of the rows."""
    m_sub = x.shape[-2] // nch
    return [tuple(t[..., c * m_sub : (c + 1) * m_sub, :] for t in (x, topk_ids, topk_w)) for c in range(nch)]


def _expert_tile(w_gu, w_down, cap: int, act, channel: BlockChannel, grouped: bool, accum, rank0: int):
    """The MoE tile callback: each held rank's local experts (global ranks
    from ``rank0``) on the tile it holds, the combined partial in the accum
    dtype.  Every step's grouped dx shares one w^T copy of each weight."""
    shared = (SharedTranspose(), SharedTranspose()) if grouped else (None, None)

    def moe_tile(ctx, tile, _carry):
        xs, ids, wts = tile
        part = local_expert_ffn(xs, ids, wts, w_gu, w_down, cap=cap, act=act, tile=channel.comp.tile, grouped=grouped,
                                shared_wt=shared, rank0=rank0)  # fmt: skip
        return part.to(accum)

    return moe_tile


def ag_moe_baseline(
    x,
    topk_ids,
    topk_w,
    w_gu,
    w_down,
    *,
    world: World,
    channel: Optional[BlockChannel] = None,
    capacity_factor: float = 1.25,
    act: Callable = F.silu,
):
    """Non-overlapping reference: every rank sees every origin's tokens and
    tables (AllGather), runs its experts with per-chunk capacity, and the
    partials are reduce-scattered back to their origin ranks."""
    m_loc, k, e_loc = x.shape[-2], topk_ids.shape[-1], w_gu.shape[1]
    cap = _capacity(m_loc, k, e_loc * world.size, capacity_factor)
    gathered = [gather_origins(world, t) for t in (x, topk_ids, topk_w)]
    part = local_expert_ffn(*gathered, w_gu, w_down, cap=cap, act=act, rank0=world.rank0)  # [W, W_origin, ..]
    return return_home(world, part).to(x.dtype)


def a2a_moe(
    x,
    topk_ids,
    topk_w,
    w_gu,
    w_down,
    *,
    world: World,
    channel: Optional[BlockChannel] = None,
    channel2: Optional[BlockChannel] = None,
    capacity_factor: float = 1.25,
    act: Callable = F.silu,
    grouped: bool = False,
):
    """Overlapped expert-parallel MoE: the fused a2a dispatch -> expert GEMMs
    -> combine pipeline (see the module docstring).

    ``x [W, *lead, m_loc, d]`` is each rank's token chunk, the experts those
    of ``ag_moe``.  The chunk splits into ``C`` sub-chunks (the effective
    channel count); each (landing rank, origin sub-chunk) pair has its own
    capacity, and a dropped token adds a zero partial.  The combine
    accumulates in the CompSpec accum dtype.  Returns ``[W, *lead, m_loc, d]``.
    """
    channel = channel or BlockChannel(axis="model")
    channel2 = channel2 or channel
    m_loc, k, e_loc = x.shape[-2], topk_ids.shape[-1], w_gu.shape[1]
    nch = effective_channels(m_loc, channel.num_channels, kind="a2a_dispatch")
    seq = build_seq_plan(("a2a_dispatch", "combine_rs"), (channel, channel2), world.size, nch)
    cap = _capacity(m_loc // nch, k, e_loc * world.size, capacity_factor)
    tile_fn = _expert_tile(w_gu, w_down, cap, act, channel, grouped, seq.ops[0].accum_dtype, world.rank0)
    accs = run_a2a_seq(seq, world, tile_fn, state=_token_chunks(x, topk_ids, topk_w, nch))
    return torch.cat(accs, dim=-2).to(x.dtype)


def a2a_moe_baseline(
    x,
    topk_ids,
    topk_w,
    w_gu,
    w_down,
    *,
    world: World,
    capacity_factor: float = 1.25,
    act: Callable = F.silu,
    num_channels: int = 1,
):
    """Non-overlapping expert-parallel reference: every rank sees every
    origin's tokens and tables (AllGather), runs its experts, and the
    partials are reduce-scattered home in float32.

    ``num_channels`` must be the overlapped path's *effective* channel
    count: capacity is per ``m_loc / num_channels`` sub-chunk, the
    granularity ``a2a_moe`` drops at, so both keep the same (token, k)
    pairs and differ only in summation order.
    """
    size = world.size
    m_loc, d, k, e_loc = x.shape[-2], x.shape[-1], topk_ids.shape[-1], w_gu.shape[1]
    nch = effective_channels(m_loc, num_channels, kind="a2a_dispatch", warn=False)
    m_sub = m_loc // nch
    cap = _capacity(m_sub, k, e_loc * size, capacity_factor)  # per-sub-chunk capacity

    def gathered(t):  # [W, W_origin, *lead, nch, m_sub, .]: every rank sees every origin's sub-chunks
        return gather_origins(world, t.reshape(t.shape[:-2] + (nch, m_sub, t.shape[-1])))

    part = local_expert_ffn(*(gathered(t) for t in (x, topk_ids, topk_w)), w_gu, w_down, cap=cap, act=act,
                            rank0=world.rank0)  # fmt: skip
    part = part.reshape((x.shape[0], size) + tuple(x.shape[1:])).float()
    return return_home(world, part).to(x.dtype)


def gather_origins(world: World, t):
    """The baselines' all-gather: ``t [W, ...]`` (each origin rank's value)
    -> ``[W, W_origin, ...]``, every origin's value on each rank.  On one
    process a broadcast view; over processes the processes' blocks gathered
    (``World.all_gather``: its adjoint sums each origin's gradient over the
    ranks that read it)."""
    if world.procs is None:
        return t.unsqueeze(0).expand((world.size,) + tuple(t.shape))
    return world.all_gather(t.unsqueeze(1), 0)


def return_home(world: World, part):
    """The baselines' reduce-scatter: ``part [W, W_origin, ...]`` -> origin
    o's sum over the ranks, on rank o, ``[W, ...]``.  On one process the
    rank-order ``psum`` (the replicated sum is the rank-stacked result);
    over processes ``World.reduce_scatter`` over the origin axis (the held
    ranks summed here, then the library's reduce-scatter: within float
    rounding of the rank-order sum, not bitwise)."""
    if world.procs is None:
        return world.psum(part)
    return world.reduce_scatter(part, 0).squeeze(1)


def _capacity(m: int, k: int, e_total: int, factor: float) -> int:
    cap = int(m * k / e_total * factor) + 1
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8
