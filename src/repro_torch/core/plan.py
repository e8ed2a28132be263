"""Tile-program plans — the IR between ``BlockChannel`` and the executors.

The port's counterpart of ``repro/core/plan.py`` for the two single-op
kinds of the dense slice, ``ag_matmul`` (flow "ag") and ``matmul_rs`` (flow
"rs").  ``compile_overlap`` builds a :class:`TilePlan` from
``(kind, BlockChannel, world)`` and hands it to the eager schedule executor
(``core/overlap.run_plan``) or to the fused Hopper kernels, which read the
same per-(channel, step, rank) tables from device memory.

  * per channel ``c`` a **source schedule** sigma_c(rank, step) — which
    peer's tile a rank holds/consumes at each step (``schedules.SCHEDULES``;
    channels may run mirrored, direction = -1);
  * the **flow permutations** between consecutive steps, derived from sigma
    by inversion — rank-dimension reindexing in the eager executor, peer
    tile stores in the kernels;
  * the **rs view**: the segment schedule is the time reversal of sigma,
    ending at the home rank (paper Fig. 4).

The JAX package verifies every plan it builds with ``repro.analysis``; the
port imports nothing from that package, so its tests run the same verifier
over every port plan (``PlanTables.from_plan`` is duck-typed on the methods
below).  ``build_plan`` is a bounded LRU cache, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.core import schedules
from repro_torch.core.channels import ORDERS, BlockChannel, QuantSpec

__all__ = ["ChannelSchedule", "TilePlan", "PlanError", "build_plan", "plan_cache_info", "FLOW_OF_KIND"]

FLOW_OF_KIND = {
    "ag_matmul": "ag",
    "matmul_rs": "rs",
}

Table = Tuple[Tuple[Tuple[int, ...], ...], ...]  # [channel][step][rank]


class PlanError(ValueError):
    """A schedule that is not a per-step permutation of the ranks."""


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
        inv = {self.source(d, step + 1): d for d in range(self.world)}
        if len(inv) != self.world:
            raise PlanError(
                f"{self.order} over {self.world} ranks: source schedule is not a "
                f"per-step permutation at step {step + 1}"
            )
        return tuple((j, inv[self.source(j, step)]) for j in range(self.world))

    def align_perm(self) -> Tuple[Tuple[int, int], ...]:
        """Final hop of a tile-following reduction (kept for the table view)."""
        return tuple((j, self.source(j, self.world - 1)) for j in range(self.world))

    def rs_segment(self, rank: int, step: int) -> int:
        """Segment reduced by ``rank`` at ``step``: the time reversal of sigma."""
        return self.source(rank, self.world - 1 - step)

    def rs_segment_table(self, step: int) -> Tuple[int, ...]:
        return tuple(self.rs_segment(r, step) for r in range(self.world))

    def rs_perm(self, step: int) -> Tuple[Tuple[int, int], ...]:
        """(src, dst) pairs moving partials from ``step`` to ``step + 1``."""
        inv = {self.rs_segment(d, step + 1): d for d in range(self.world)}
        if len(inv) != self.world:
            raise PlanError(
                f"{self.order} over {self.world} ranks: segment schedule is not a "
                f"per-step permutation at step {step + 1}"
            )
        return tuple((j, inv[self.rs_segment(j, step)]) for j in range(self.world))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A compiled tile program: what every rank does at every step."""

    kind: str
    axis: str
    world: int
    flow: str  # "ag" | "rs"
    num_channels: int  # effective (validated divisor of the extent)
    accum_dtype: torch.dtype  # reduction dtype only
    channels: Tuple[ChannelSchedule, ...]
    quant: QuantSpec = QuantSpec()

    @property
    def steps(self) -> int:
        return self.world

    @property
    def flow_dtype(self) -> str:
        """The wire dtype name (identity spec: the accumulation dtype)."""
        return self.quant.resolve_wire(self.accum_dtype)

    def quant_table_spec(self) -> int:
        return self.quant.scale_slots(self.flow, self.world, self.num_channels, self.steps)

    # ---- flat tables for the fused kernels: [channel][step][rank] ---------
    def src_tables(self) -> Table:
        """AG: origin rank (== gather slot) consumed per (c, step, rank)."""
        return tuple(tuple(ch.source_table(s) for s in range(self.steps)) for ch in self.channels)

    def flow_dst_tables(self) -> Table:
        """AG: rank each rank pushes its held tile to, per (c, step); the last
        step pushes nowhere and its row is the identity (unused)."""
        ident = tuple(range(self.world))
        return tuple(
            tuple(
                tuple(dst for _, dst in ch.flow_perm(s)) if s < self.steps - 1 else ident
                for s in range(self.steps)
            )
            for ch in self.channels
        )

    def rs_seg_tables(self) -> Table:
        """RS: segment reduced per (c, step, rank)."""
        return tuple(tuple(ch.rs_segment_table(s) for s in range(self.steps)) for ch in self.channels)

    def rs_dst_tables(self) -> Table:
        """RS: rank each rank pushes its partial to, per (c, step)."""
        ident = tuple(range(self.world))
        return tuple(
            tuple(
                tuple(dst for _, dst in ch.rs_perm(s)) if s < self.steps - 1 else ident
                for s in range(self.steps)
            )
            for ch in self.channels
        )


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
    requested count through ``mapping.effective_channels`` first).
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
    # the tables must derive (every step a permutation) before a plan ships
    plan.flow_dst_tables()
    plan.rs_dst_tables()
    return plan


def plan_cache_info():
    """Cache statistics for the plan layer (hits == reused compilations)."""
    return build_plan.cache_info()
