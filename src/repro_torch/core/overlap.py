"""Eager overlap backend — one generic schedule executor over tile plans.

The port's counterpart of ``repro/core/overlap.py`` and of the JAX
package's ``"xla"`` backend.  Every function
here takes rank-stacked operands (``[W, ...]``, see ``backend/mesh.World``); a
permute is an index on the rank dimension, so each step of the plan is
plain PyTorch.  It is the reference the fused Hopper kernels are held
against, and the model path when ``ParallelContext(backend="eager")``.

There is exactly one schedule loop here, :func:`run_plan`; ``ag_matmul``
and ``matmul_rs`` are GEMM callbacks plugged into it, ``ring_attention``
(AG-KV + online softmax, paper Fig. 6) an attention callback, and so is the
AG+MoE double ring (``core/moe_overlap.ag_moe``).  Two-op plans
(:class:`~repro_torch.core.plan.SeqPlan`) compose it: :func:`run_seq_plan`
runs the RS -> AG layer seam (:func:`matmul_rs_ag`: a down / out
projection's reduce-scatter handing its home segments to the next
projection's all-gather) and :func:`run_a2a_seq` the expert-parallel
dispatch / combine pair (``core/moe_overlap.a2a_moe``).  The non-overlapped
baselines (gather then GEMM; GEMM then reduce-scatter; gather the KV then
one attention) sit beside them.

The wire half of the dtype axis (``plan.quant``, a
:class:`~repro_torch.core.quant.QuantSpec`) behaves as in the JAX package:
flowing tiles ("ag" / "ag_rs" / "a2a" state) are encoded once at entry and
stay encoded across every permute, each consumer decoding its held copy;
flowing reductions ("rs", the "ag_rs" ride-along and its ``align_perm``
hop, the "a2a_rs" returns) are re-encoded at every send edge; a quantized
payload's scales ride the same permute (``_permute_start``).  With the default
spec every edge is the identity, bitwise the pre-split executor.  A
:class:`~repro_torch.core.quant.PackedWeight` ``w`` (weight-only int8 /
int4) goes through ``blocked_dot``, which dequantizes per block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.backend.mesh import World
from repro_torch.core.channels import BlockChannel
from repro_torch.core.comp_tiles import DEFAULT_TILE, blocked_dot, largest_divisor
from repro_torch.core.mapping import effective_channels
from repro_torch.core.plan import SeqPlan, TilePlan, build_plan, build_seq_plan
from repro_torch.core.quant import PackedWeight, WirePayload, decode_tree, encode_tree

__all__ = [
    "run_plan",
    "run_seq_plan",
    "run_a2a_seq",
    "TileContext",
    "ag_matmul",
    "ag_matmul_baseline",
    "matmul_rs",
    "matmul_rs_baseline",
    "matmul_rs_ag",
    "psum_scatter_ring",
    "ring_attention",
    "ag_attention_baseline",
    "plan_for",
    "rank_rows",
]


@dataclasses.dataclass(frozen=True)
class TileContext:
    """What the executor tells a compute callback about the current tile.

    ``src`` holds one int per rank the world holds (``world.ranks``, all of
    them in one process): the origin rank of the held tile for "ag" /
    "ag_rs" flows, the reduced segment for "rs" flows.
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

    flow "ag": ``state[c]`` is channel c's flowing tile ``[W, ...]`` (or a
    tuple of such, permuted together).  Each step the executor issues every
    channel's next-step permute, then calls ``tile_fn(ctx, tile, carry) ->
    carry`` on each held tile.  Returns the final carry.

    flow "ag_rs" (the MoE double ring): tiles flow as in "ag";
    ``tile_fn(ctx, tile, None) -> partial`` feeds a reduction that travels
    the same permutes (``acc = permute(acc, flow_perm(s - 1)) + partial``),
    then one ``align_perm`` hop per channel sends it to its home rank.
    Returns the per-channel reductions.

    flow "rs": ``tile_fn(ctx, None, None) -> partial`` computes the partial
    for segment ``ctx.src``; one flowing accumulator per channel
    (``acc = permute(acc) + partial``).  Returns the per-channel home
    segments.

    The a2a flows run as one pipeline of both ops (:func:`run_a2a_seq`).

    Every permute is issued before the compute that does not need it and
    waited on where its result is first read (:func:`_permute_start`): a
    step's tiles land after that step's callbacks, a flowing reduction's
    hop after the next step's partial.  On one process this is the same
    sequence of index copies; over processes it lets the NCCL transfers
    run under the compute.

    Wire edges (``plan.quant``, module docstring): tiles are encoded once
    here and decoded by each consumer step; a flowing reduction is encoded
    before every permute and decoded after it, the add running in
    ``plan.accum_dtype``.
    """
    nch = plan.num_channels
    spec, adt = plan.quant, plan.accum_dtype

    def hop(acc, pairs):
        return _hop(world, acc, pairs, spec, adt)

    if plan.flow in ("ag", "ag_rs"):
        # tiles are quantized exactly once here; each consumer decodes its held copy
        state = [encode_tree(st, spec, adt) for st in state]
        accs: List[Any] = [None] * nch  # ag_rs: each channel's reduction, in flight to the next step's rank
        for s in range(plan.steps):
            last = s == plan.steps - 1
            nxt = None if last else [_permute_start(world, state[c], plan.channels[c].flow_perm(s)) for c in range(nch)]
            for c in range(nch):
                sched = plan.channels[c]
                ctx = TileContext(s, c, world.local(sched.source_table(s)))
                held = decode_tree(state[c], spec, adt)
                if plan.flow == "ag":
                    carry = tile_fn(ctx, held, carry)
                    continue
                part = tile_fn(ctx, held, None)  # the reduction rides the tile flow
                acc = part if s == 0 else accs[c]() + part
                accs[c] = acc if last else _hop_start(world, acc, sched.flow_perm(s), spec, adt)
            if nxt is not None:
                state = [land() for land in nxt]
        if plan.flow == "ag":
            return carry
        return [hop(accs[c], plan.channels[c].align_perm()) for c in range(nch)]
    if plan.flow == "rs":
        accs: List[Any] = [None] * nch  # each channel's accumulator, in flight to the next step's rank
        for s in range(plan.steps):
            for c in range(nch):
                sched = plan.channels[c]
                part = tile_fn(TileContext(s, c, world.local(sched.rs_segment_table(s))), None, None)
                acc = part if s == 0 else accs[c]() + part
                accs[c] = acc if s == plan.steps - 1 else _hop_start(world, acc, sched.rs_perm(s), spec, adt)
        return accs
    raise ValueError(f"run_plan: flow {plan.flow!r} runs as a SeqPlan (run_seq_plan / run_a2a_seq)")


def run_seq_plan(
    seq: SeqPlan, world: World, rs_tile_fn: Callable, seam_fn: Callable, ag_tile_fn: Callable, *, carry=None
):
    """Run an RS -> AG seam plan: the producer as an "rs" plan, then
    ``seam_fn(accs, carry) -> (seam_out, state, carry)`` on its per-channel
    home segments (rank-local glue, re-chunked into the consumer's step-0
    tiles: the seam-composition invariant puts every segment where the
    consumer seeds it), then the consumer as an "ag" plan.  Returns
    ``(seam_out, carry)``."""
    producer, consumer = seq.ops
    accs = run_plan(producer, world, rs_tile_fn)
    seam_out, state, carry = seam_fn(accs, carry)
    return seam_out, run_plan(consumer, world, ag_tile_fn, state=state, carry=carry)


def run_a2a_seq(seq: SeqPlan, world: World, tile_fn: Callable, *, state: Sequence) -> List[torch.Tensor]:
    """Run an ``a2a_dispatch -> combine_rs`` pair as one pipeline.

    ``state[c]`` is channel c's own tile (a token tile and its routing
    tables, permuted together).  Per step the executor lands step s+1's
    direct exchange of the own tiles, calls ``tile_fn(ctx, landed, None) ->
    partial`` on the tile that landed at step s (step 0: the own tile), and
    returns the partial home along the reversed edge (``combine_perm``),
    where it accumulates.  Returns the per-channel home accumulators
    (channel c: the outputs of own chunk c's tokens).  Wire edges: the own
    tiles are encoded once at entry, each landed tile decoded before its
    callback, each returning partial encoded for its one hop home.
    """
    dispatch, combine = seq.ops
    nch = dispatch.num_channels
    spec, adt = dispatch.quant, dispatch.accum_dtype
    state = [encode_tree(st, spec, adt) for st in state]
    own, landed = list(state), list(state)
    accs: List[torch.Tensor] = [None] * nch
    home: List[Any] = [None] * nch  # each channel's returning partial, in flight; added after the next step's tile
    for s in range(dispatch.steps):
        nxt = None
        if s < dispatch.steps - 1:
            nxt = [_permute_start(world, own[c], dispatch.channels[c].a2a_perm(s + 1)) for c in range(nch)]
        for c in range(nch):
            sched = combine.channels[c]
            ctx = TileContext(s, c, world.local(sched.source_table(s)))
            part = tile_fn(ctx, decode_tree(landed[c], spec, adt), None)
            if home[c] is not None:
                accs[c] = accs[c] + home[c]()
            if s == 0:
                accs[c] = part
            else:
                home[c] = _hop_start(world, part, sched.combine_perm(s), spec, adt)
        if nxt is not None:
            landed = [land() for land in nxt]
    return [acc if ret is None else acc + ret() for acc, ret in zip(accs, home)]


def _hop(world: World, value, pairs, spec, accum):
    """One send edge of a flowing value: encoded for the wire, permuted,
    decoded back to ``accum`` (the identity spec leaves it as it is)."""
    return _hop_start(world, value, pairs, spec, accum)()


def _hop_start(world: World, value, pairs, spec, accum) -> Callable[[], Any]:
    """:func:`_hop` issued: a function that waits for the landing and
    returns the decoded value (see :func:`_permute_start`)."""
    land = _permute_start(world, encode_tree(value, spec, accum), pairs)
    return lambda: decode_tree(land(), spec, accum)


def _permute_start(world: World, tile, pairs) -> Callable[[], Any]:
    """Permute a flowing tile: one tensor, a tuple of tensors (a token tile
    and its routing tables travel together) or a quantized
    :class:`~repro_torch.core.quant.WirePayload` (its scales ride the same
    permute).  Issued and not waited on (``World.permute_start``): returns
    a function that waits for the tile's transfers and returns it.  The
    executors call it where the landed tile is first read, so over
    processes a step's compute is issued before it waits for the next
    step's transfers; on one process the tile has already landed."""
    if isinstance(tile, tuple):
        parts = [_permute_start(world, t, pairs) for t in tile]
        return lambda: tuple(part() for part in parts)
    if isinstance(tile, WirePayload):
        q, scale = world.permute_start(tile.q, pairs), world.permute_start(tile.scale, pairs)
        return lambda: WirePayload(q.wait(), scale.wait())
    return world.permute_start(tile, pairs).wait


def plan_for(kind: str, channel: BlockChannel, world: int, extent: int) -> TilePlan:
    """Resolve the effective channel count against ``extent`` and fetch the plan."""
    nch = effective_channels(extent, channel.num_channels, kind=kind)
    return build_plan(kind, channel, world, nch)


def rank_rows(x: torch.Tensor, starts: Sequence[int], m: int) -> torch.Tensor:
    """Per-rank row slice: ``out[r] = x[r, ..., starts[r]:starts[r]+m, :]``."""
    return torch.stack([x[r, ..., s : s + m, :] for r, s in enumerate(starts)])


def _rank_weight(w, lead: int):
    """[W, k, n] -> [W, 1, ..., 1, k, n] broadcasting over ``lead`` batch dims
    (a :class:`~repro_torch.core.quant.PackedWeight` with its scales)."""
    if isinstance(w, PackedWeight):
        return w.lead(lead)
    return w.reshape((w.shape[0],) + (1,) * lead + tuple(w.shape[1:]))


def _w_cols(w, lo: int, hi: int):
    """Column-slice a weight operand (a PackedWeight slices its scales and zeros too)."""
    if isinstance(w, PackedWeight):
        return w.col_slice(lo, hi)
    return w[..., lo:hi]


class _RankDot(torch.autograd.Function):
    """``torch.matmul(a.float(), w.float())`` per rank, the weight [W, K, n]
    broadcast over a's lead dims, keeping ``a`` and ``w`` as given for the
    backward.  Autograd's own broadcast matmul would save the float32
    weight expanded to every lead index, a contiguous copy per batch row
    (B copies of the weight for every tile of a step), and the float32
    copy of ``a``.  The forward is the same product; the backward forms
    da per lead index as autograd does and dw as one GEMM over every row
    (the fused ops' ``_weight_grad`` form; float32 sums in another order)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.matmul(a.float(), _rank_weight(w, a.dim() - 3).float())

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, _rank_weight(w, a.dim() - 3).float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            rows = a.reshape(a.shape[0], -1, a.shape[-1]).float().transpose(1, 2)
            dw = torch.matmul(rows, g.reshape(g.shape[0], -1, g.shape[-1])).to(w.dtype)
        return da, dw


def _consume_dot(a, w, comp_tile, accum, out_dtype=None):
    """One consumer GEMM tile ``a @ w`` per rank, honoring the CompSpec tile.

    The product is formed in float32 and rounded to ``accum`` (the JAX
    package's ``preferred_element_type``), then to ``out_dtype``; under
    autograd through :class:`_RankDot` (no per-batch copies of the weight
    kept for the backward).  A
    :class:`~repro_torch.core.quant.PackedWeight` ``w`` always goes through
    ``blocked_dot`` (the whole problem as one block under the default tile),
    which dequantizes its codes per block, as the JAX package's executor does.
    """
    wb = _rank_weight(w, a.dim() - 3)
    if isinstance(w, PackedWeight):
        tile = tuple(comp_tile) if tuple(comp_tile) != DEFAULT_TILE else (a.shape[-2], w.shape[-1], a.shape[-1])
        out = blocked_dot(a.float(), wb, tile, accum=torch.float32)
    elif tuple(comp_tile) != DEFAULT_TILE:
        out = blocked_dot(a, wb, tuple(comp_tile), accum=torch.float32)
    elif torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        out = _RankDot.apply(a, w)
    else:
        out = torch.matmul(a.float(), wb.float())
    out = out.to(accum)
    return out.to(out_dtype) if out_dtype is not None else out


def _check_ranked(x: torch.Tensor, w, world: World, what: str):
    if x.dim() < 3 or len(w.shape) != 3 or x.shape[0] != world.held or w.shape[0] != world.held:
        raise ValueError(
            f"{what}: expected x [W, ..., m, k] and w [W, k, n] with W={world.held} held ranks, "
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

    return run_plan(plan, world, _ag_tile(w, m_loc, m_sub, channel, plan.accum_dtype), state=chunks, carry=out)


def _ag_tile(w, m_loc: int, m_sub: int, channel: BlockChannel, accum):
    """The AG consumer's GEMM tile: the held tile times ``w``, stored at the
    rows it covers globally (f_S), in the output buffer's dtype."""

    def gemm_tile(ctx, tile, out):
        part = _consume_dot(tile, w, channel.comp.tile, accum, out.dtype)
        for r, src in enumerate(ctx.src):
            row = src * m_loc + ctx.channel * m_sub
            out[r, ..., row : row + m_sub, :] = part[r]
        return out

    return gemm_tile


def _baseline_dot(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The baselines' GEMM per rank, ``x [W, *lead, m, k] @ w [W, k, n]``:
    operands in their own dtype, float32 accumulation, the product rounded
    once to ``out_dtype`` (the JAX package's ``_dot`` with
    ``preferred_element_type=float32``, ``src/repro/core/overlap.py:349``).

    On the card a bf16 / fp16 operand pair runs one tensor-core GEMM
    (``torch.bmm``, with ``out_dtype=float32`` where the output stays
    float32), not an upcast into a float32 GEMM; the caller keeps
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off so the sums stay float32.  Elsewhere (float32, or the CPU) the
    product is formed in float32 and cast.
    """
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype:
        a = x.reshape(x.shape[0], -1, x.shape[-1])  # leading dims folded into the rows
        out = torch.bmm(a, w) if out_dtype == x.dtype else torch.bmm(a, w, out_dtype=torch.float32).to(out_dtype)
        return out.reshape(x.shape[:-1] + (w.shape[-1],))
    return torch.matmul(x.float(), _rank_weight(w, x.dim() - 3).float()).to(out_dtype)


def ag_matmul_baseline(x, w, *, world: World, out_dtype=None, channel=None):
    """Non-overlapping reference: gather the rows, then one GEMM per rank."""
    _check_ranked(x, w, world, "ag_matmul_baseline")
    out_dtype = out_dtype or x.dtype
    return _baseline_dot(world.all_gather(x, dim=x.dim() - 3), w, out_dtype)


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

    accs = run_plan(plan, world, _rs_tile(x, w, m_loc, n_sub, channel, plan.accum_dtype))
    return torch.cat(accs, dim=-1).to(out_dtype)


def _rs_tile(x, w, m_loc: int, n_sub: int, channel: BlockChannel, accum):
    """The RS producer's GEMM tile: each rank's rows of its scheduled segment
    times channel c's columns of ``w``, in the accum dtype."""

    def gemm_tile(ctx, _tile, _carry):
        xs = rank_rows(x, [seg * m_loc for seg in ctx.src], m_loc)
        wc = _w_cols(w, ctx.channel * n_sub, (ctx.channel + 1) * n_sub)
        return _consume_dot(xs, wc, channel.comp.tile, accum)

    return gemm_tile


def matmul_rs_ag(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    *,
    world: World,
    channel: Optional[BlockChannel] = None,
    channel2: Optional[BlockChannel] = None,
    residual: Optional[torch.Tensor] = None,
    glue: Optional[Callable] = None,
    out_dtype: Optional[torch.dtype] = None,
):
    """Fused layer seam: ``matmul_rs(x, w1)`` flowing into ``ag_matmul(., w2)``.

    ``x``: [W, *lead, M, k_loc] and ``w1`` [W, k_loc, N] are the RS producer
    (a down / out projection), ``w2`` [W, N, n2_loc] the AG consumer (the
    next projection).  On each rank's full home segment [W, *lead, M / W, N]:

        y = residual + matmul_rs(x, w1)    (residual optional)
        h = glue(y)                        (optional, row-preserving: the next block's rms_norm)

    Returns ``(y, ag_matmul(h, w2))``.  The float ops and their order are the
    unfused pair's: the RS output is cast to ``out_dtype`` before the
    residual add, ``glue`` runs on the whole home segment before the AG
    re-chunk, and the AG output is in ``h``'s dtype, so in float32 the
    results equal the unfused pair bitwise.  Both halves must resolve the
    same effective channel count (RS chunks the N columns, AG the M / W
    rows); a mismatch raises ``ValueError`` (the ``compile_overlap`` list
    form checks first and falls back to the unfused pair).
    ``matmul_rs_ag.calls`` counts the seams fused.
    """
    _check_ranked(x, w1, world, "matmul_rs_ag")
    if len(w2.shape) != 3 or w2.shape[0] != world.held or w2.shape[1] != w1.shape[-1]:
        raise ValueError(f"matmul_rs_ag: expected w2 [W={world.held}, {w1.shape[-1]}, n2], got {tuple(w2.shape)}")
    channel = channel or BlockChannel(axis="model")
    channel2 = channel2 or channel
    out_dtype = out_dtype or x.dtype
    m_glob, n_mid, n2_loc = x.shape[-2], w1.shape[-1], w2.shape[-1]
    if m_glob % world.size:
        raise ValueError(f"matmul_rs_ag: {m_glob} rows do not divide over {world.size} ranks")
    m_loc = m_glob // world.size
    nch = effective_channels(n_mid, channel.num_channels, kind="matmul_rs")
    nch_ag = effective_channels(m_loc, channel2.num_channels, kind="ag_matmul")
    if nch != nch_ag:
        raise ValueError(
            f"matmul_rs_ag: seam channel counts diverge - RS extent {n_mid} yields C={nch} but AG extent "
            f"{m_loc} yields C={nch_ag}; use compile_overlap(['matmul_rs', 'ag_matmul']) for the loud "
            "unfused fallback"
        )
    seq = build_seq_plan(("matmul_rs", "ag_matmul"), (channel, channel2), world.size, nch)
    rs_plan, ag_plan = seq.ops
    n_sub, m_sub = n_mid // nch, m_loc // nch

    def seam(accs, _carry):
        rs_out = torch.cat(accs, dim=-1).to(out_dtype)
        y = rs_out if residual is None else residual + rs_out
        # glue needs whole rows (rms_norm over N), so it runs on the home
        # segment before the re-chunk: the unfused pair's ops in its order
        h = y if glue is None else glue(y)
        state = [h[..., c * m_sub : (c + 1) * m_sub, :] for c in range(nch)]
        out = torch.zeros(h.shape[:-2] + (world.size * m_loc, n2_loc), dtype=h.dtype, device=h.device)
        return y, state, out

    matmul_rs_ag.calls += 1
    rs_tile = _rs_tile(x, w1, m_loc, n_sub, channel, rs_plan.accum_dtype)
    return run_seq_plan(seq, world, rs_tile, seam, _ag_tile(w2, m_loc, m_sub, channel2, ag_plan.accum_dtype))


matmul_rs_ag.calls = 0


def matmul_rs_baseline(x, w, *, world: World, out_dtype=None, channel=None):
    """Non-overlapping reference: one GEMM per rank, then reduce-scatter."""
    _check_ranked(x, w, world, "matmul_rs_baseline")
    out_dtype = out_dtype or x.dtype
    part = _baseline_dot(x, w, torch.float32)  # float32 partials into the reduction
    return world.reduce_scatter(part, dim=part.dim() - 3).to(out_dtype)


def psum_scatter_ring(x: torch.Tensor, *, world: World, channel: Optional[BlockChannel] = None) -> torch.Tensor:
    """Ring reduce-scatter of precomputed partials (no fused GEMM): an "rs"
    plan whose tile compute is a row slice, the adds overlapped with the
    permutes, in ``x``'s dtype.

    ``x``: [W, *lead, M, N], rank r's partial -> [W, *lead, M / W, N], rank
    r's row segment of ``sum_q x[q]``; ``num_channels`` chunks the N columns.
    """
    channel = channel or BlockChannel(axis="model")
    m_glob, n = x.shape[-2], x.shape[-1]
    if m_glob % world.size:
        raise ValueError(f"psum_scatter_ring: {m_glob} rows do not divide over {world.size} ranks")
    plan = plan_for("psum_scatter", channel, world.size, n)
    m_loc = m_glob // world.size
    n_sub = n // plan.num_channels

    def slice_tile(ctx, _tile, _carry):
        seg = rank_rows(x, [s * m_loc for s in ctx.src], m_loc)
        return seg[..., ctx.channel * n_sub : (ctx.channel + 1) * n_sub]

    return torch.cat(run_plan(plan, world, slice_tile), dim=-1)


# -----------------------------------------------------------------------------
# AG-KV + self-attention  (paper Fig. 6) — sequence parallel
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _RingGeometry:
    """Per-rank placement of a sequence-parallel attention: query offsets,
    and the KV head group each rank reads (``kv_select``)."""

    q_off: Tuple[int, ...]
    kv_start: Tuple[int, ...]
    kv_need: int
    rep: int


def _check_attention(q, k, v, world: World, what: str):
    if q.dim() != 5 or k.dim() != 5 or k.shape != v.shape or q.shape[0] != world.size:
        raise ValueError(
            f"{what}: expected q [W, B, H, Sq, D] and k/v [W, B, Hkv, s_loc, D] with W={world.size}, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[:2] != q.shape[:2] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")


def _kv_groups(size: int, h: int, hkv: int, kv_select: bool, what: str):
    """(first KV head per rank, heads read, query heads per KV head): with
    ``kv_select`` rank r reads ``max(1, Hkv / W)`` heads from
    ``(r // share) * kv_need`` (``share = max(1, W / Hkv)`` ranks per group),
    else all Hkv."""
    if kv_select:
        kv_need = max(1, hkv // size)
        share = max(1, size // hkv)
        starts = tuple((r // share) * kv_need for r in range(size))
    else:
        kv_need, starts = hkv, (0,) * size
    if h % kv_need:
        raise ValueError(f"{what}: {h} query heads do not group over {kv_need} KV heads")
    return starts, kv_need, h // kv_need


def _ring_geometry(size: int, h: int, hkv: int, sq: int, s_loc: int, kv_select: bool) -> _RingGeometry:
    if sq == s_loc:
        q_off = tuple(r * s_loc for r in range(size))  # queries sharded like the KV: rank offset
    elif sq == size * s_loc:
        q_off = (0,) * size  # gathered queries: the full global range
    else:
        raise ValueError(
            f"ring_attention: query rows {sq} must equal the KV shard rows "
            f"{s_loc} or the gathered extent {size * s_loc}"
        )
    starts, kv_need, rep = _kv_groups(size, h, hkv, kv_select, "ring_attention")
    return _RingGeometry(q_off, starts, kv_need, rep)


def _select_heads(x: torch.Tensor, starts: Sequence[int], need: int) -> torch.Tensor:
    """Per-rank head slice: ``out[r] = x[r, :, starts[r]:starts[r]+need]``."""
    if need == x.shape[2]:
        return x
    return torch.stack([x[r, :, s : s + need] for r, s in enumerate(starts)])


def _online_update(q_blk, qp, kr, vr, kp, carry, causal, window, accum):
    """One online-softmax update of (m, l, o) with the reference's guards:
    -inf masks, fully masked rows kept at m = -inf without a NaN."""
    m_i, l_i, o_i = carry
    scores = torch.matmul(q_blk, kr.float().transpose(-1, -2)).to(accum).float()
    mask = None
    if causal:
        mask = qp[:, :, None] >= kp[:, None, :]
    if window is not None:
        wmask = (qp[:, :, None] - kp[:, None, :]) < window
        mask = wmask if mask is None else mask & wmask
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, float("-inf"))
    m_new = torch.maximum(m_i, scores.amax(-1, keepdim=True))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(torch.where(torch.isfinite(scores), scores - m_safe, float("-inf")))
    alpha = torch.exp(torch.where(torch.isfinite(m_i), m_i - m_safe, float("-inf")))
    l_new = l_i * alpha + p.sum(-1, keepdim=True)
    o_new = o_i * alpha + torch.matmul(p, vr.float())
    return m_new, l_new, o_new


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    world: World,
    causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    channel: Optional[BlockChannel] = None,
    kv_select: bool = False,
    fused: bool = False,
) -> torch.Tensor:
    """Overlapped sequence-parallel attention with online softmax.

    ``k``/``v``: [W, B, Hkv, s_loc, D] (sequence sharded over the ranks);
    ``q``: [W, B, H, s_loc, D] (sharded alongside the KV) or [W, B, H,
    W * s_loc, D] (already gathered: the AG-Q + ring-KV layer form).  KV
    tiles rotate per the plan's order (``num_channels`` splits each shard's
    KV along the sequence into independent flows) while an online softmax
    consumes each arrived tile; its (m, l, o) state is ``run_plan``'s carry.
    ``causal`` and ``window`` mask with global positions.  ``kv_select`` is
    the per-KV-group GQA ring: the tiles carry every KV head, and rank r
    consumes only its group (``max(1, Hkv / W)`` heads from ``(r // share) *
    kv_need``).  Returns [W, B, H, Sq, D] in q's dtype.

    ``fused=False`` (the eager backend, and the oracle): the reference's
    math, f32 scores in the accum dtype, -inf masks with ``isfinite`` guards,
    and a non-default CompSpec tile blocking the update as (block_q,
    block_kv).  ``fused=True``: the same permutes, and flash attention
    (``kernels/flash_attention.flash_attention_ranked``) consumes each held
    tile for all W ranks in one launch per (step, channel), carrying its
    float32 state from launch to launch; the last launch normalises.  The
    kernel keeps its own 64 x 64 blocking.  On CPU tensors the kernel
    wrapper runs its plain version.
    """
    _check_attention(q, k, v, world, "ring_attention")
    channel = channel or BlockChannel(axis="model")
    size, b, h, sq, d = q.shape
    hkv, s_loc = k.shape[2], k.shape[3]
    scale = scale if scale is not None else d**-0.5
    plan = plan_for("ag_attention", channel, size, s_loc)
    geo = _ring_geometry(size, h, hkv, sq, s_loc, kv_select)
    nch = plan.num_channels
    s_sub = s_loc // nch
    chunks = [(k[..., c * s_sub : (c + 1) * s_sub, :], v[..., c * s_sub : (c + 1) * s_sub, :]) for c in range(nch)]

    if fused:
        from repro_torch.kernels.flash_attention import flash_attention_ranked

        chunks = [(kc.contiguous(), vc.contiguous()) for kc, vc in chunks]  # the kernel reads whole tiles

        def kernel_tile(ctx, kv, state):
            kc, vc = kv
            k_off = tuple(src * s_loc + ctx.channel * s_sub for src in ctx.src)
            last = ctx.step == plan.steps - 1 and ctx.channel == nch - 1
            return flash_attention_ranked(
                q, kc, vc, q_off=geo.q_off, k_off=k_off, kv_start=geo.kv_start, kv_need=geo.kv_need,
                causal=causal, window=window, scale=scale, state=state, final=last,
            )  # fmt: skip

        return run_plan(plan, world, kernel_tile, state=chunks, carry=None)

    accum = plan.accum_dtype
    comp_tile = tuple(channel.comp.tile)
    if comp_tile != DEFAULT_TILE:
        # CompSpec tile: (tm, ., tk) -> (block_q, block_kv), clamped to divisors
        bq, bk = largest_divisor(sq, comp_tile[0]), largest_divisor(s_sub, comp_tile[2])
    else:
        bq, bk = sq, s_sub
    q32 = (q * scale).float()
    dev = q.device
    q_pos = torch.tensor(geo.q_off, device=dev)[:, None] + torch.arange(sq, device=dev)  # [W, Sq]
    carry0 = (
        torch.full((size, b, h, sq, 1), float("-inf"), device=dev),
        torch.zeros((size, b, h, sq, 1), device=dev),
        torch.zeros((size, b, h, sq, d), device=dev),
    )

    def softmax_tile(ctx, kv, carry):
        kc, vc = kv
        k0 = torch.tensor([src * s_loc + ctx.channel * s_sub for src in ctx.src], device=dev)
        k_pos = k0[:, None] + torch.arange(s_sub, device=dev)  # [W, s_sub] global key positions
        kc, vc = _select_heads(kc, geo.kv_start, geo.kv_need), _select_heads(vc, geo.kv_start, geo.kv_need)
        kr = kc.repeat_interleave(geo.rep, dim=2) if geo.rep > 1 else kc
        vr = vc.repeat_interleave(geo.rep, dim=2) if geo.rep > 1 else vc
        if bq == sq and bk == s_sub:
            return _online_update(q32, q_pos, kr, vr, k_pos, carry, causal, window, accum)
        # blocked consumer: query blocks update independently; KV blocks fold
        # in order through the same rescaling, so any (bq, bk) gives the same result
        outs = []
        for qi in range(0, sq, bq):
            blk = tuple(t[..., qi : qi + bq, :] for t in carry)
            for ki in range(0, s_sub, bk):
                blk = _online_update(
                    q32[..., qi : qi + bq, :], q_pos[:, qi : qi + bq], kr[..., ki : ki + bk, :],
                    vr[..., ki : ki + bk, :], k_pos[:, ki : ki + bk], blk, causal, window, accum,
                )  # fmt: skip
            outs.append(blk)
        return tuple(torch.cat([o[i] for o in outs], dim=-2) for i in range(3))

    _m, l_f, o_f = run_plan(plan, world, softmax_tile, state=chunks, carry=carry0)
    return (o_f / torch.clamp(l_f, min=1e-30)).to(q.dtype)


def ag_attention_baseline(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    world: World,
    causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    kv_select: bool = False,
    channel: Optional[BlockChannel] = None,
) -> torch.Tensor:
    """Non-overlapping reference: all-gather the KV, then one attention per
    rank over it (queries sharded alongside the KV, or gathered when they
    span the whole sequence; ``kv_select`` as in :func:`ring_attention`).

    On the CPU the attention is the reference's dense form (f32 scores, -inf
    masks, the ``isfinite`` guard).  On the card it is one flash-attention
    launch over the gathered KV (the dense f32 scores of the paper's long
    sequences do not fit: [W, H, S / W, S] floats), as the GEMM baselines
    run tensor-core GEMMs there.
    """
    _check_attention(q, k, v, world, "ag_attention_baseline")
    size, b, h, sq, d = q.shape
    hkv, s_loc = k.shape[2], k.shape[3]
    s_glob = size * s_loc
    kg, vg = world.all_gather(k, dim=2), world.all_gather(v, dim=2)  # [W, B, Hkv, S, D]
    starts, kv_need, rep = _kv_groups(size, h, hkv, kv_select and size > 1, "ag_attention_baseline")
    scale = scale if scale is not None else d**-0.5
    q_off = tuple(0 if sq == s_glob else r * s_loc for r in range(size))
    if q.is_cuda:
        from repro_torch.kernels.flash_attention import flash_attention_ranked

        return flash_attention_ranked(
            q, kg.contiguous(), vg.contiguous(), q_off=q_off, k_off=(0,) * size, kv_start=starts, kv_need=kv_need,
            causal=causal, window=window, scale=scale,
        )  # fmt: skip
    kg, vg = _select_heads(kg, starts, kv_need), _select_heads(vg, starts, kv_need)
    if rep > 1:
        kg, vg = kg.repeat_interleave(rep, dim=2), vg.repeat_interleave(rep, dim=2)
    scores = torch.matmul((q * scale).float(), kg.float().transpose(-1, -2))  # [W, B, H, Sq, S]
    q_pos = torch.tensor(q_off, device=q.device)[:, None] + torch.arange(sq, device=q.device)
    k_pos = torch.arange(s_glob, device=q.device)
    mask = None
    if causal:
        mask = q_pos[:, :, None] >= k_pos[None, None, :]
    if window is not None:
        wmask = (q_pos[:, :, None] - k_pos[None, None, :]) < window
        mask = wmask if mask is None else mask & wmask
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, float("-inf"))
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m)
    out = torch.matmul(p, vg.float()) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.to(q.dtype)
