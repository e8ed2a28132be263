"""Tile-program plans — the IR between ``BlockChannel`` and the executors.

The port's counterpart of ``repro/core/plan.py``.  Flows by kind:
``ag_matmul`` and ``ag_attention`` "ag" (the KV tiles of the ring);
``matmul_rs`` and ``psum_scatter`` "rs"; ``ag_moe`` "ag_rs" (token tiles flow as in "ag" and a
reduction rides the same permutes, then one ``align_perm`` hop sends it
home); ``a2a_dispatch`` "a2a" (expert-parallel dispatch: every step is a
*direct* exchange of the ranks' own token tiles, nothing is forwarded) and
``combine_rs`` "a2a_rs" (each step's partial returns home along the
reversed exchange edge and accumulates there).  ``compile_overlap`` builds a
:class:`TilePlan` from ``(kind, BlockChannel, world)`` and hands it to the
eager schedule executor (``core/overlap.run_plan``) or to the fused Hopper
kernels, which read the same per-(channel, step, rank) tables from device
memory.  A :class:`SeqPlan` chains two plans: the RS -> AG layer seam
(``matmul_rs`` -> ``ag_matmul``) and the expert-parallel pair
(``a2a_dispatch`` -> ``combine_rs``).

  * per channel ``c`` a **source schedule** sigma_c(rank, step) — which
    peer's tile a rank holds/consumes at each step (``schedules.SCHEDULES``;
    channels may run mirrored, direction = -1);
  * the **flow permutations** between consecutive steps, derived from sigma
    by inversion — rank-dimension reindexing in the eager executor, peer
    tile stores in the kernels;
  * the **rs view**: the segment schedule is the time reversal of sigma,
    ending at the home rank (paper Fig. 4).

``build_plan`` / ``build_seq_plan`` are bounded LRU caches, as in the JAX
package, and every miss is verified by the port's own static verifier
(``repro_torch.analysis``: schedule legality, and for ``ag_matmul`` /
``matmul_rs`` the flag protocol of the fused kernels) unless
``REPRO_VERIFY=0``; ``verify_stats`` counts the misses and the plans
verified.  A schedule that is not a per-step permutation raises
:class:`PlanError` (the analysis package's ``PlanVerificationError``) with
its (kind, order, world, channel, step, rank), verified or not.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.analysis.errors import PlanVerificationError
from repro_torch.core import schedules
from repro_torch.core.channels import ORDERS, BlockChannel, QuantSpec

__all__ = [
    "ChannelSchedule",
    "TilePlan",
    "SeqPlan",
    "PlanError",
    "build_plan",
    "build_seq_plan",
    "plan_cache_info",
    "verify_stats",
    "FLOW_OF_KIND",
]

FLOW_OF_KIND = {
    "ag_matmul": "ag",
    "ag_attention": "ag",
    "matmul_rs": "rs",
    "psum_scatter": "rs",
    "ag_moe": "ag_rs",
    "a2a_dispatch": "a2a",
    "combine_rs": "a2a_rs",
}

Table = Tuple[Tuple[Tuple[int, ...], ...], ...]  # [channel][step][rank]


PlanError = PlanVerificationError  # a plan that fails a static check (a ValueError)

# build_plan / build_seq_plan cache misses and the plans verified on them
_VERIFY_STATS = dict.fromkeys(("plan_misses", "plans_verified", "plans_refused", "seq_misses", "seqs_verified",
                               "seqs_refused"), 0)  # fmt: skip


@dataclasses.dataclass(frozen=True)
class ChannelSchedule:
    """One channel's realization of a tile order over ``world`` ranks.

    ``direction=-1`` mirrors the base schedule (rank -> 2*rank - sigma).
    """

    order: str
    world: int
    direction: int = 1

    def __post_init__(self):
        if self.order not in ORDERS:
            raise ValueError(f"unknown tile order {self.order!r}; one of {ORDERS}")

    def source(self, rank: int, step: int) -> int:
        """sigma(rank, step): origin rank of the tile held at ``step``."""
        src = schedules.SCHEDULES[self.order](rank, step, self.world)
        if self.direction < 0 and self.order != "all2all":
            src = (2 * rank - src) % self.world  # mirrored (counter-rotating)
        return src

    def source_table(self, step: int) -> Tuple[int, ...]:
        return tuple(self.source(r, step) for r in range(self.world))

    def flow_perm(self, step: int) -> Tuple[Tuple[int, int], ...]:
        """(src, dst) pairs moving held tiles from ``step`` to ``step + 1``:
        rank j forwards to the rank d with sigma(d, step + 1) == sigma(j, step)."""
        inv = self._inverse(self.source_table(step + 1), step + 1)
        return tuple((j, inv[self.source(j, step)]) for j in range(self.world))

    def a2a_perm(self, step: int) -> Tuple[Tuple[int, int], ...]:
        """(src, dst) pairs of the direct exchange landing ``step``: rank j
        sends its *own* tile to the rank d that consumes it at ``step``
        (sigma(d, step) == j); no held tile is forwarded."""
        inv = self._inverse(self.source_table(step), step)
        return tuple((j, inv[j]) for j in range(self.world))

    def combine_perm(self, step: int) -> Tuple[Tuple[int, int], ...]:
        """(src, dst) pairs returning step ``step``'s partial home: rank j
        holds the expert output for origin sigma(j, step)'s tokens (the
        dispatch edge reversed; ``align_perm`` is ``combine_perm(W - 1)``)."""
        return tuple((j, self.source(j, step)) for j in range(self.world))

    def align_perm(self) -> Tuple[Tuple[int, int], ...]:
        """Final hop of a tile-following reduction ("ag_rs"): rank j holds the
        reduction of the tile it held last, and sends it to that tile's origin."""
        return tuple((j, self.source(j, self.world - 1)) for j in range(self.world))

    def rs_segment(self, rank: int, step: int) -> int:
        """Segment reduced by ``rank`` at ``step``: the time reversal of sigma."""
        return self.source(rank, self.world - 1 - step)

    def rs_segment_table(self, step: int) -> Tuple[int, ...]:
        return tuple(self.rs_segment(r, step) for r in range(self.world))

    def rs_perm(self, step: int) -> Tuple[Tuple[int, int], ...]:
        """(src, dst) pairs moving partials from ``step`` to ``step + 1``."""
        inv = self._inverse(self.rs_segment_table(step + 1), step + 1)
        return tuple((j, inv[self.rs_segment(j, step)]) for j in range(self.world))

    def _inverse(self, row: Tuple[int, ...], step: int) -> dict:
        """value -> rank of a per-step row; raises ``per_step_permutation``
        at the first rank whose value an earlier rank already holds."""
        inv = {}
        for d, v in enumerate(row):
            if v in inv:
                raise PlanError(
                    f"schedule is not a per-step permutation: ranks {inv[v]} and {d} both hold {v}",
                    check="per_step_permutation",
                    order=self.order,
                    world=self.world,
                    step=step,
                    rank=d,
                )
            inv[v] = d
        return inv


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A compiled tile program: what every rank does at every step."""

    kind: str
    axis: str
    world: int
    flow: str  # "ag" | "rs" | "ag_rs"
    num_channels: int  # effective (validated divisor of the extent)
    accum_dtype: torch.dtype  # reduction dtype only
    channels: Tuple[ChannelSchedule, ...]
    quant: QuantSpec = QuantSpec()

    @property
    def steps(self) -> int:
        return self.world

    @property
    def flow_dtype(self) -> str:
        """The wire dtype name, what travels: the QuantSpec's wire dtype, the
        accumulation dtype when it is unset (kernels size their wire buffers
        by it; accumulation reads ``accum_dtype``)."""
        return self.quant.resolve_wire(self.accum_dtype)

    def quant_table_spec(self) -> int:
        """Scale-table slots a quantized wire needs for this plan (0 for a float wire)."""
        return self.quant.scale_slots(self.flow, self.world, self.num_channels, self.steps)

    # ---- flat tables for the fused kernels: [channel][step][rank] ---------
    def src_tables(self) -> Table:
        """AG: origin rank (== gather slot) consumed per (c, step, rank)."""
        return tuple(tuple(ch.source_table(s) for s in range(self.steps)) for ch in self.channels)

    def flow_dst_tables(self) -> Table:
        """AG: rank each rank pushes its held tile to, per (c, step); the last
        step pushes nowhere and its row is the identity (unused)."""
        return self._dst_tables("flow_perm", self.steps - 1)

    def rs_seg_tables(self) -> Table:
        """RS: segment reduced per (c, step, rank)."""
        return tuple(tuple(ch.rs_segment_table(s) for s in range(self.steps)) for ch in self.channels)

    def rs_dst_tables(self) -> Table:
        """RS: rank each rank pushes its partial to, per (c, step)."""
        return self._dst_tables("rs_perm", self.steps - 1)

    def a2a_dst_tables(self) -> Table:
        """A2A: rank each rank sends its *own* tile to, per (c, step); step 0
        is the identity (the own tile).  The combine's return destinations
        are ``src_tables``."""
        return self._dst_tables("a2a_perm", self.steps)

    def _dst_tables(self, perm: str, moves: int) -> Table:
        """Per (c, step) the destinations of ``ChannelSchedule.<perm>(step)``
        for the first ``moves`` steps, identity rows after; a row that is not
        a permutation raises with this plan's kind and the channel."""
        ident = tuple(range(self.world))
        out = []
        for c, ch in enumerate(self.channels):
            try:
                out.append(
                    tuple(
                        tuple(dst for _, dst in getattr(ch, perm)(s)) if s < moves else ident
                        for s in range(self.steps)
                    )
                )
            except PlanError as e:
                raise PlanError(
                    e.raw_message, check=e.check, kind=self.kind, order=e.order, world=e.world, channel=c,
                    step=e.step, rank=e.rank,
                ) from None  # fmt: skip
        return tuple(out)


def _directions(order: str, num_channels: int) -> Tuple[int, ...]:
    """Channel -> ring direction: ring runs every channel at -1 (the paper's
    orientation), bidir_ring mirrors odd channels, all2all is direction-less."""
    if order == "bidir_ring":
        return tuple(1 if c % 2 == 0 else -1 for c in range(num_channels))
    if order == "ring":
        return (-1,) * num_channels
    return (1,) * num_channels


@functools.lru_cache(maxsize=256)
def build_plan(kind: str, channel: BlockChannel, world: int, num_channels: int) -> TilePlan:
    """Build (and cache) the tile plan for ``kind`` over ``world`` ranks.

    ``num_channels`` is the *effective* channel count (callers clamp the
    requested count through ``mapping.effective_channels`` first).  Every
    miss is verified (``analysis.verify_plan``) unless ``REPRO_VERIFY=0``.
    """
    if kind not in FLOW_OF_KIND:
        raise ValueError(f"unknown workload kind {kind!r}; one of {tuple(FLOW_OF_KIND)}")
    order = channel.comm.order
    chans = tuple(
        ChannelSchedule(order=order, world=world, direction=d) for d in _directions(order, num_channels)
    )
    plan = TilePlan(
        kind=kind,
        axis=channel.axis,
        world=world,
        flow=FLOW_OF_KIND[kind],
        num_channels=num_channels,
        accum_dtype=channel.comp.accum_dtype,
        channels=chans,
        quant=channel.quant,
    )
    _VERIFY_STATS["plan_misses"] += 1
    from repro_torch import analysis  # lazy: the analysis passes import back into core

    if analysis.verify.verify_enabled():
        _verified(analysis.verify_plan, plan, "plans")
    else:  # unverified, the tables must still derive (every step a permutation) before a plan ships
        plan.flow_dst_tables()
        plan.rs_dst_tables()
        plan.a2a_dst_tables()
    return plan


@dataclasses.dataclass(frozen=True)
class SeqPlan:
    """Two chained plans: op 0's outbound flow feeds op 1's inbound flow.

    The legal chains are the layer seam ``rs -> ag`` (the RS pass's home
    segments become the AG pass's step-0 tiles in place, over the same
    world and channel split) and the expert-parallel pair ``a2a -> a2a_rs``
    (each landed tile's expert output returns along the reversed exchange
    edge).  Both ops share axis, world and effective channel count.
    """

    ops: Tuple[TilePlan, ...]

    def __post_init__(self):
        if len(self.ops) != 2:
            raise ValueError(f"SeqPlan supports exactly 2 chained ops, got {len(self.ops)}")
        a, b = self.ops
        if (a.flow, b.flow) not in (("rs", "ag"), ("a2a", "a2a_rs")):
            raise ValueError(
                "SeqPlan must chain an rs producer into an ag consumer or an a2a dispatch into an "
                f"a2a_rs combine, got flows {(a.flow, b.flow)}"
            )
        if a.axis != b.axis or a.world != b.world or a.num_channels != b.num_channels:
            raise ValueError(
                f"seam ops must share axis/world/channel count, got axis={(a.axis, b.axis)} "
                f"world={(a.world, b.world)} C={(a.num_channels, b.num_channels)}"
            )

    @property
    def axis(self) -> str:
        return self.ops[0].axis

    @property
    def world(self) -> int:
        return self.ops[0].world

    @property
    def num_channels(self) -> int:
        return self.ops[0].num_channels


@functools.lru_cache(maxsize=256)
def build_seq_plan(
    kinds: Tuple[str, ...], channels: Tuple[BlockChannel, ...], world: int, num_channels: int
) -> SeqPlan:
    """Build (and cache) the chained plan for ``kinds``; ``channels`` may
    differ per op (e.g. tile orders) but agree on the axis, and
    ``num_channels`` is the shared *effective* count, clamped by the caller
    against both extents.  Every miss is verified
    (``analysis.verify_seq_plan``: each half, the seam, and for the RS -> AG
    pair the combined protocol pass) unless ``REPRO_VERIFY=0``."""
    if len(kinds) != len(channels):
        raise ValueError(f"got {len(kinds)} kinds but {len(channels)} channels")
    seq = SeqPlan(ops=tuple(build_plan(k, ch, world, num_channels) for k, ch in zip(kinds, channels)))
    _VERIFY_STATS["seq_misses"] += 1
    from repro_torch import analysis

    if analysis.verify.verify_enabled():
        _verified(analysis.verify_seq_plan, seq, "seqs")
    return seq


def _verified(verify, plan, what: str):
    """Run the verifier on a fresh plan, counting it verified or refused."""
    try:
        verify(plan)
    except PlanVerificationError:
        _VERIFY_STATS[f"{what}_refused"] += 1
        raise
    _VERIFY_STATS[f"{what}_verified"] += 1


def plan_cache_info():
    """Cache statistics for the plan layer (hits == reused compilations)."""
    return build_plan.cache_info()


def verify_stats() -> dict:
    """The misses of ``build_plan`` / ``build_seq_plan`` since the process
    started, and of them the plans the static verifier proved and refused:
    misses == verified + refused unless ``REPRO_VERIFY=0`` skipped some."""
    return dict(_VERIFY_STATS)
