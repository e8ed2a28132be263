"""What the static passes read: a plan's baked tables and a launch's op streams.

The port's counterpart of ``repro/analysis/ir.py``, in two levels:

  * :class:`PlanTables` snapshots the nested int tuples a
    :class:`~repro_torch.core.plan.TilePlan` bakes (``src_tables`` /
    ``flow_dst_tables`` / ``rs_seg_tables`` / ``rs_dst_tables`` /
    ``align_perm`` / ``a2a_dst_tables``) and its quant view, as the JAX
    package's does, so the schedule pass checks what ships.  It is
    duck-typed on the plan (no ``repro_torch.core`` import: ``core/plan.py``
    imports ``analysis.errors``), and it answers the same table methods
    itself, so the kernels' ``work_items`` read a (possibly poked) snapshot
    as they read a plan.
  * :class:`Launch` is one launch of a fused kernel as its blocks run it:
    the work items, each an :class:`Item` whose ``ops`` are the flag waits
    and sets and the slot-tile reads and writes it does in program order,
    and the item numbers each block takes in turn.  The bf16 route's items
    come from the wrappers (``kernels/ag_gemm.work_items`` /
    ``kernels/gemm_rs.work_items``, the single source of what
    ``ag_gemm_wgmma_kernel`` / ``gemm_rs_wgmma_kernel`` run; G persistent
    blocks, block b taking items b, b+G, ...).  The float32 route has no
    item list in its wrapper: :func:`fma_ag_launch` / :func:`fma_rs_launch`
    read its grid, (n-tile, channel, rank), one block per tile walking the
    W stages, from the plan's tables as ``ag_gemm_kernel`` /
    ``gemm_rs_kernel`` do.

Keys: flags are ``("ready", rank, step, c[, mt])`` (AG) and ``("part",
rank, stage, c, mt, nt)`` / ``("part", rank, stage, c, j)`` (RS) as the
kernels index them; the bf16 items' slot tiles keep the wrappers' keys,
``(rank, origin, c, mt)`` (gather) and ``(rank, stage, c, mt, nt)``
(recv); the float32 route's are ``("gather", rank, origin, c)`` and
``("recv", rank, stage, c, j)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

Table = Tuple[Tuple[Tuple[int, ...], ...], ...]  # [channel][step][rank]

__all__ = [
    "PlanTables",
    "Table",
    "Item",
    "Launch",
    "ag_item_ops",
    "rs_item_ops",
    "wgmma_launch",
    "fma_ag_launch",
    "fma_rs_launch",
    "CANON_TILES",
    "canonical_ag_shape",
    "canonical_rs_shape",
]

# the shape-free protocol pass's canonical launch: m-tiles x n-tiles per
# (step, rank, channel), and the float32 route's n-tiles per (channel, rank)
CANON_TILES = (2, 2)


def _dtype_str(dtype) -> Optional[str]:
    return None if dtype is None or isinstance(dtype, str) else str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class PlanTables:
    """Baked schedule tables of one plan, indexed ``[channel][step][rank]``.

    ``flow_dst`` / ``rs_dst`` are ``None`` when the plan could not derive
    them (a source schedule that is not a per-step permutation); the
    schedule pass then names the root cause from ``src``.
    """

    kind: str
    order: str
    flow: str  # "ag" | "rs" | "ag_rs" | "a2a" | "a2a_rs"
    world: int
    num_channels: int
    src: Table  # AG origin rank consumed per (c, step, rank)
    rs_seg: Table  # RS segment reduced per (c, step, rank)
    flow_dst: Optional[Table]  # AG push destination (last row identity, unused)
    rs_dst: Optional[Table]  # RS push destination (last row identity, unused)
    align: Tuple[Tuple[int, ...], ...]  # [channel][rank] ag_rs final-hop dst
    a2a_dst: Optional[Table] = None  # a2a direct-exchange destination (step 0 identity)
    # quant snapshot: all None on a hand-built object without a QuantSpec, and
    # the quant pass then evaluates 0 checks
    accum_dtype: Optional[str] = None  # reduction dtype name
    wire_dtype: Optional[str] = None  # dtype name that travels
    granularity: Optional[str] = None  # scale granularity (per_tile / per_channel)
    scale_slots: Optional[int] = None  # scale-table coverage the plan allocates

    @classmethod
    def from_plan(cls, plan) -> "PlanTables":
        """Snapshot the tables a TilePlan-compatible object emits."""
        try:
            flow_dst = plan.flow_dst_tables()
            rs_dst = plan.rs_dst_tables()
        except ValueError:
            flow_dst = rs_dst = None  # not a per-step permutation: the schedule pass reports it
        a2a_dst = None
        if plan.flow in ("a2a", "a2a_rs") and hasattr(plan, "a2a_dst_tables"):
            try:
                a2a_dst = plan.a2a_dst_tables()
            except ValueError:
                a2a_dst = None
        accum = getattr(plan, "accum_dtype", None)
        quant = getattr(plan, "quant", None)
        wire_dtype = granularity = scale_slots = None
        if quant is not None and accum is not None:
            wire_dtype = quant.resolve_wire(accum)
            granularity = quant.granularity
            scale_slots = plan.quant_table_spec()
        return cls(
            kind=plan.kind,
            order=plan.channels[0].order,
            flow=plan.flow,
            world=plan.world,
            num_channels=plan.num_channels,
            src=plan.src_tables(),
            rs_seg=plan.rs_seg_tables(),
            flow_dst=flow_dst,
            rs_dst=rs_dst,
            align=tuple(tuple(d for _, d in ch.align_perm()) for ch in plan.channels),
            a2a_dst=a2a_dst,
            accum_dtype=_dtype_str(accum) or accum,
            wire_dtype=wire_dtype,
            granularity=granularity,
            scale_slots=scale_slots,
        )

    # ---- the plan's table methods, for the kernels' work_items ------------
    def src_tables(self) -> Table:
        return self.src

    def flow_dst_tables(self) -> Table:
        return self.flow_dst

    def rs_seg_tables(self) -> Table:
        return self.rs_seg

    def rs_dst_tables(self) -> Table:
        return self.rs_dst

    # ---- mutation helpers (the test suite) ---------------------------------
    def poke(self, table: str, channel: int, step: int, rank: int, value: int) -> "PlanTables":
        """A copy with one entry of ``table`` replaced by ``value``."""
        rows = [[list(r) for r in ch] for ch in getattr(self, table)]
        rows[channel][step][rank] = value
        frozen = tuple(tuple(tuple(r) for r in ch) for ch in rows)
        return dataclasses.replace(self, **{table: frozen})

    def poke_align(self, channel: int, rank: int, value: int) -> "PlanTables":
        rows = [list(ch) for ch in self.align]
        rows[channel][rank] = value
        return dataclasses.replace(self, align=tuple(tuple(ch) for ch in rows))


class Item(NamedTuple):
    """One work item as the protocol pass reads it."""

    index: int  # its number: a block takes its items in increasing order
    s: int  # step (AG) or stage (RS)
    r: int  # rank
    c: int  # channel
    ops: Tuple[Tuple[str, tuple], ...]  # ("wait" | "set" | "read" | "write", key), in program order


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of a fused kernel: its items and what each block runs."""

    kernel: str  # "ag_gemm" | "gemm_rs"
    route: str  # "wgmma" | "fma"
    items: Tuple[Item, ...]
    blocks: Tuple[Tuple[int, ...], ...]  # item indices of each block, in the order it runs them
    persistent: bool = True  # blocks take items round robin (wgmma); False: one block per grid tile (fma)
    prologue: Tuple[tuple, ...] = ()  # flags the launch sets before any item (the held ranks' entry words)

    @property
    def grid(self) -> int:
        return len(self.blocks)

    def with_grid(self, grid: int) -> "Launch":
        """The same items on ``grid`` persistent blocks (round robin)."""
        if not self.persistent:
            raise ValueError("the float32 route's grid is fixed by its tiles")
        out = dataclasses.replace(self, blocks=_round_robin(len(self.items), grid))
        out.__dict__.update({k: v for k, v in self.__dict__.items() if k.startswith("_")})  # caches on the items
        return out


def _round_robin(n: int, grid: int) -> Tuple[Tuple[int, ...], ...]:
    """Block b of G takes items b, b+G, ... (the empty blocks of G > n left out)."""
    if grid < 1:
        raise ValueError(f"a launch needs at least one block, got G = {grid}")
    return tuple(tuple(range(b, n, grid)) for b in range(min(grid, n)))


def ag_item_ops(it, packed: bool = False) -> Tuple[Tuple[str, tuple], ...]:
    """The ops of one ``kernels/ag_gemm.AgItem`` in ``ag_gemm_wgmma_kernel``'s order.

    The seed item's consumers first copy the own rows into the own slot and
    publish its ready flag (its first write and first set); the producer
    warp then waits on the item's flag (the seed's own) and loads the held
    slot; a pushing item stores the A boxes, as they land, into the peer's
    slot and then sets the peer's flag.  ``packed``: with a packed weight the
    consumers of a pushing item wait on the flag themselves, copy the held
    rows to the peer and publish before the producer's wait and loads.
    Slot tiles keep the item's keys.
    """
    fill = 1 if it.copy == "seed" else 0
    guard = it.wait if it.wait is not None else (it.sets[0] if fill and it.sets else None)
    ops = [("write", t) for t in it.writes[:fill]] + [("set", f) for f in it.sets[:fill]]
    load = ([("wait", guard)] if guard is not None else []) + [("read", t) for t in it.reads]
    push = [("write", t) for t in it.writes[fill:]] + [("set", f) for f in it.sets[fill:]]
    if push and getattr(it, "entry", None) is not None:  # the receiver's entry word, before the first store
        push = [("wait", it.entry)] + push
    ops += load + push + (load if packed and push else [])
    return tuple(ops)


def rs_item_ops(it) -> Tuple[Tuple[str, tuple], ...]:
    """The ops of one ``kernels/gemm_rs.RsItem`` in ``gemm_rs_wgmma_kernel``'s
    epilogue order: wait on the partial of the stage before, add it from the
    recv slot, store the sum into the peer's recv slot, set the peer's flag."""
    ops = [("wait", it.wait)] if it.wait is not None else []
    ops += [("read", t) for t in it.reads]
    if it.writes and getattr(it, "entry", None) is not None:  # the receiver's entry word, before the stores
        ops.append(("wait", it.entry))
    ops += [("write", t) for t in it.writes]
    ops += [("set", f) for f in it.sets]
    return tuple(ops)


def _is_ag(items) -> bool:
    return bool(items) and hasattr(items[0], "copy")


def prologue_of(items: Sequence, world: Optional[int] = None) -> Tuple[tuple, ...]:
    """The entry words a launch of ``items`` sets before any item: each of
    its ranks' on every rank's region (``kernels/ag_gemm.entry_keys``),
    with the items' epoch; ``world`` defaults to the ranks the items name.
    The one-allocation route (``sys`` 0, every rank in one launch) sets and
    waits on none: with every rank's entry word set before any item, no
    wait on one can block, so a proof of one launch holds with or without
    them; across launches (``check_peer_protocol``) they order the calls."""
    from repro_torch.kernels.ag_gemm import entry_keys

    if not items:
        return ()
    ranks = sorted({it.r for it in items})
    world = world or 1 + max(max(it.r, it.dst) for it in items)
    entry = next((it.entry for it in items if getattr(it, "entry", None) is not None), None)
    epoch = entry[3] if entry is not None and len(entry) > 3 else None
    return entry_keys(world, ranks, epoch)


def wgmma_launch(items: Sequence, grid: int, packed: bool = False, world: Optional[int] = None) -> Launch:
    """The bf16 route's launch of the wrapper's ``items`` on ``grid`` (G)
    persistent blocks: block b runs items b, b+G, ... in order; the launch
    prologue sets its ranks' entry words (:func:`prologue_of`)."""
    ag = _is_ag(items)
    conv = tuple(Item(it.index, it.s, it.r, it.c, ag_item_ops(it, packed) if ag else rs_item_ops(it)) for it in items)
    return Launch("ag_gemm" if ag else "gemm_rs", "wgmma", conv, _round_robin(len(conv), grid),
                  prologue=prologue_of(items, world))  # fmt: skip


def fma_ag_launch(tables, n_tiles: int) -> Launch:
    """``ag_gemm_kernel``'s launch: grid (n-tile j, channel c, rank r), the
    block walking steps s = 0..W-1; for s > 0 it waits on ready(r, s-1, c)
    and reads gather slot (r, src, c) (at s = 0 the own rows of x in place);
    block j == 0 waits on its copy of dst's entry word, pushes the held rows
    into slot (src, c) of rank dst and sets ready(dst, s, c) for s < W-1.  Items are numbered (s, r, c, j)
    stage-major."""
    world, nch = tables.world, tables.num_channels
    src_t, dst_t = tables.src_tables(), tables.flow_dst_tables()
    items, blocks = [], {}
    for s in range(world):
        for r in range(world):
            for c in range(nch):
                o, d = src_t[c][s][r], dst_t[c][s][r]
                for j in range(n_tiles):
                    ops = []
                    if s > 0:
                        ops += [("wait", ("ready", r, s - 1, c)), ("read", ("gather", r, o, c))]
                    if j == 0 and s < world - 1:
                        ops += [("wait", ("entry", r, d)), ("write", ("gather", d, o, c)), ("set", ("ready", d, s, c))]
                    if s > 0:
                        ops.append(("read", ("gather", r, o, c)))  # the GEMM's loads
                    blocks.setdefault((j, c, r), []).append(len(items))
                    items.append(Item(len(items), s, r, c, tuple(ops)))
    return Launch("ag_gemm", "fma", tuple(items), tuple(tuple(b) for b in blocks.values()), persistent=False,
                  prologue=_all_entries(world))  # fmt: skip


def fma_rs_launch(tables, n_tiles: int) -> Launch:
    """``gemm_rs_kernel``'s launch: grid (n-tile j, channel c, rank r), the
    block walking stages s = 0..W-1; for s > 0 it waits on part(r, s-1, c,
    j) and adds recv slot (r, s-1, c, j); for s < W-1 it waits on its copy
    of dst's entry word, stores the sum into recv slot (dst, s, c, j) and
    sets part(dst, s, c, j)."""
    world, nch = tables.world, tables.num_channels
    dst_t = tables.rs_dst_tables()
    items, blocks = [], {}
    for s in range(world):
        for r in range(world):
            for c in range(nch):
                d = dst_t[c][s][r]
                for j in range(n_tiles):
                    ops = []
                    if s > 0:
                        ops += [("wait", ("part", r, s - 1, c, j)), ("read", ("recv", r, s - 1, c, j))]
                    if s < world - 1:
                        ops += [("wait", ("entry", r, d)), ("write", ("recv", d, s, c, j)),
                                ("set", ("part", d, s, c, j))]
                    blocks.setdefault((j, c, r), []).append(len(items))
                    items.append(Item(len(items), s, r, c, tuple(ops)))
    return Launch("gemm_rs", "fma", tuple(items), tuple(tuple(b) for b in blocks.values()), persistent=False,
                  prologue=_all_entries(world))  # fmt: skip


def _all_entries(world: int) -> Tuple[tuple, ...]:
    from repro_torch.kernels.ag_gemm import entry_keys

    return entry_keys(world, range(world))


def canonical_ag_shape(nch: int) -> Tuple[int, int, int, int]:
    """(B, m_loc, K, n_loc) giving the bf16 AG items CANON_TILES m-tiles x
    n-tiles per (step, rank, channel) (the weight's rows a multiple of 16,
    as a packed weight needs)."""
    mt, nt = CANON_TILES
    return (1, nch * 128 * mt, 128, 128 * nt)


def canonical_rs_shape(world: int, nch: int) -> Tuple[int, int, int, int]:
    """(B, M, k_loc, N) giving the bf16 RS items CANON_TILES m-tiles (one
    batch pair, 64-row blocks of the segment) x n-tiles per (stage, rank,
    channel), every channel's first column 16-byte aligned."""
    mt, nt = CANON_TILES
    return (2, world * 64 * mt, 128, nch * 128 * nt)
