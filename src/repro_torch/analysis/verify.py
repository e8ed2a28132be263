"""The port's verifier entry points and ``python -m repro_torch.analysis.verify``.

The port's counterpart of ``repro/analysis/verify.py``.  ``verify_plan``
runs the schedule-legality pass and the quant pass (always) and, for the
kinds that run on a flag-synchronised fused kernel (``ag_matmul``,
``matmul_rs``), the flag-protocol pass over worlds up to
``REPRO_VERIFY_PROTOCOL_MAX_WORLD`` (default 32, the JAX package's
switch).  The other kinds (``ag_attention``, ``ag_moe``, ``a2a_dispatch``,
``combine_rs``) move their tiles by stream-ordered ``World.permute`` in the
port: their reports list the schedule pass only.

``build_plan`` / ``build_seq_plan`` call ``verify_plan`` /
``verify_seq_plan`` on every cache miss unless ``REPRO_VERIFY=0`` (the JAX
package's switch, so one setting governs both packages);
``check_candidate`` and its seam / a2a twins are the cached probes the
tuner filters with; ``verify_launch`` checks one concrete launch of
``ag_gemm`` / ``gemm_rs`` at the grid the card gave it.
``python -m repro_torch.analysis.verify --all`` proves the shipped plan
space (every kind x order x world in {2, 3, 4, 8} x C in {1, 2, 4}, and
both fused pairs) on the CPU, with the JAX package's flags and summary line.

This module imports ``repro_torch.core`` and the kernels lazily, inside
functions, so that ``core/plan.py`` can import the analysis package.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import os
from typing import Optional, Sequence, Tuple

from repro_torch.analysis.errors import PlanVerificationError, VerificationReport
from repro_torch.analysis.ir import PlanTables, fma_ag_launch, fma_rs_launch, wgmma_launch
from repro_torch.analysis.protocol import PROTOCOL_KINDS, check_launches, check_protocol, check_seam_protocol
from repro_torch.analysis.schedule import check_a2a_seam, check_schedule, check_seam

__all__ = [
    "check_quant",
    "verify_plan",
    "verify_tables",
    "verify_seq_plan",
    "verify_seq_tables",
    "verify_launch",
    "check_candidate",
    "check_seq_candidate",
    "check_a2a_candidate",
    "verify_space",
    "verify_seq_space",
    "verify_enabled",
    "main",
]

# the shipped plan space `--all` proves (world 3: the non-power-of-2 all2all rotation)
SPACE_WORLDS = (2, 3, 4, 8)
SPACE_CHANNELS = (1, 2, 4)

# fused two-op pairs selectable from the CLI (--kind) and swept by --all
SEQ_KIND = "seq_rs_ag"
A2A_SEQ_KIND = "seq_a2a_moe"
SEQ_OPS = {
    SEQ_KIND: ("matmul_rs", "ag_matmul"),
    A2A_SEQ_KIND: ("a2a_dispatch", "combine_rs"),
}
KERNEL_KINDS = {"ag_gemm": "ag_matmul", "ag_matmul": "ag_matmul", "gemm_rs": "matmul_rs", "matmul_rs": "matmul_rs"}


def verify_enabled() -> bool:
    """``REPRO_VERIFY`` (default on; "0" / "false" / "off" opt out)."""
    return os.environ.get("REPRO_VERIFY", "1").lower() not in ("0", "false", "off")


def _protocol_max_world() -> int:
    return int(os.environ.get("REPRO_VERIFY_PROTOCOL_MAX_WORLD", "32"))


def check_quant(tables: PlanTables) -> int:
    """Wire-dtype pass: the plan's scale-table spec covers every encoded
    wire edge of its schedule.  0 checks when the tables carry no quant
    snapshot (hand-built tables); an identity wire needs 0 slots."""
    slots = getattr(tables, "scale_slots", None)
    wire = getattr(tables, "wire_dtype", None)
    if slots is None or wire is None:
        return 0
    from repro_torch.core.quant import GRANULARITIES, WIRE_DTYPES, QuantSpec

    where = dict(kind=tables.kind, order=tables.order, world=tables.world)
    if wire not in WIRE_DTYPES:
        raise PlanVerificationError(
            f"wire dtype {wire!r} is not one of {WIRE_DTYPES}", check="quant_wire_dtype", **where
        )
    gran = getattr(tables, "granularity", None)
    if gran not in GRANULARITIES:
        raise PlanVerificationError(
            f"scale granularity {gran!r} is not one of {GRANULARITIES}", check="quant_granularity", **where
        )
    steps = len(tables.src[0]) if tables.src else tables.world
    expected = QuantSpec(wire_dtype=wire, granularity=gran).scale_slots(
        tables.flow, tables.world, tables.num_channels, steps
    )
    if int(slots) != int(expected):
        raise PlanVerificationError(
            f"scale table allocates {slots} slot(s) but the {tables.flow!r} flow quantizes {expected} wire "
            f"edge(s) over {steps} step(s)",
            check="quant_scale_slots",
            **where,
        )
    return 3


def _protocol(protocol: Optional[bool], world: int) -> bool:
    return world <= _protocol_max_world() if protocol is None else protocol


def verify_tables(
    tables: PlanTables, *, protocol: Optional[bool] = None, requested_channels: Optional[int] = None
) -> VerificationReport:
    """Verify baked tables; raises PlanVerificationError, returns a report.
    The verdict depends on the tables alone, so equal tables are proven once
    (``build_plan`` and ``verify_space`` meet the same plans)."""
    report = _verify_tables(tables, _protocol(protocol, tables.world))
    return dataclasses.replace(report, requested_channels=requested_channels)


@functools.lru_cache(maxsize=1024)
def _verify_tables(tables: PlanTables, protocol: bool) -> VerificationReport:
    checks = check_schedule(tables) + check_quant(tables)
    passes, events = ["schedule"], 0
    if tables.kind in PROTOCOL_KINDS and protocol:
        pchecks, events = check_protocol(tables)
        checks += pchecks
        passes.append("protocol")
    return VerificationReport(
        kind=tables.kind,
        order=tables.order,
        world=tables.world,
        flow=tables.flow,
        effective_channels=tables.num_channels,
        passes=tuple(passes),
        checks=checks,
        events=events,
    )


def verify_plan(plan, *, protocol: Optional[bool] = None, requested_channels: Optional[int] = None):
    """Statically verify one :class:`~repro_torch.core.plan.TilePlan`."""
    return verify_tables(PlanTables.from_plan(plan), protocol=protocol, requested_channels=requested_channels)


def verify_seq_tables(
    tables: Sequence[PlanTables], *, protocol: Optional[bool] = None, requested_channels: Optional[int] = None
) -> VerificationReport:
    """Verify a two-op pair: each half's schedule and quant passes (a failure
    tagged with its ``op_index``), the seam composition (``check_seam``, or
    ``check_a2a_seam`` for the MoE pair), then, for the RS -> AG pair, one
    combined protocol pass over both launches (cached as ``verify_tables``)."""
    report = _verify_seq_tables(tuple(tables), _protocol(protocol, tables[0].world))
    return dataclasses.replace(report, requested_channels=requested_channels)


@functools.lru_cache(maxsize=1024)
def _verify_seq_tables(tables, protocol: bool) -> VerificationReport:
    producer, consumer = tables
    is_a2a = producer.flow == "a2a" or consumer.flow == "a2a_rs"
    checks = 0
    for i, t in enumerate(tables):
        try:
            checks += check_schedule(t) + check_quant(t)
        except PlanVerificationError as e:
            raise e.with_op_index(i) from None
    checks += check_a2a_seam(producer, consumer) if is_a2a else check_seam(producer, consumer)
    passes, events = ["schedule", "seam"], 0
    if not is_a2a and protocol:
        pchecks, events = check_seam_protocol(producer, consumer)
        checks += pchecks
        passes.append("protocol")
    return VerificationReport(
        kind=f"{producer.kind}->{consumer.kind}",
        order=producer.order if producer.order == consumer.order else f"{producer.order}->{consumer.order}",
        world=producer.world,
        flow=f"{producer.flow}->{consumer.flow}",
        effective_channels=producer.num_channels,
        passes=tuple(passes),
        checks=checks,
        events=events,
    )


def verify_seq_plan(seq, *, protocol: Optional[bool] = None, requested_channels: Optional[int] = None):
    """Statically verify one :class:`~repro_torch.core.plan.SeqPlan`."""
    return verify_seq_tables(
        [PlanTables.from_plan(op) for op in seq.ops], protocol=protocol, requested_channels=requested_channels
    )


def verify_launch(kind: str, x, w, channel=None, grid=1) -> VerificationReport:
    """Check one launch of the fused kernel of ``kind`` (``ag_gemm`` /
    ``ag_matmul``, ``gemm_rs`` / ``matmul_rs``) on these operands at grid G
    (``grid``: one G, or several, proven over one build of the items).

    The route is ``x``'s dtype's (``kernels.build.ROUTES``).  bf16: the
    wrapper's ``launch_items`` (the packed-weight variant for a
    :class:`~repro_torch.core.quant.PackedWeight`) on G persistent blocks.
    float32: the grid (n-tile, channel, rank), all resident, G a multiple of
    C x W (its n-tiles G / (C x W)).  Only the operands' shapes are read.
    Raises :class:`PlanVerificationError`; returns the report."""
    from repro_torch.core.quant import PackedWeight
    from repro_torch.kernels import build

    grids = (grid,) if isinstance(grid, int) else tuple(grid)
    kind = KERNEL_KINDS[kind]
    # the wrapper module (the kernels package exports its function under the same name)
    mod = importlib.import_module(f"repro_torch.kernels.{PROTOCOL_KINDS[kind]}")
    t = PlanTables.from_plan(mod.launch_plan(x, w, channel)[0])
    route = build.ROUTES[x.dtype]
    world, nch = t.world, t.num_channels
    ctx = dict(kind=kind, order=t.order, world=world)
    checks = events = 0
    if route == "wgmma":
        launch = wgmma_launch(mod.launch_items(x, w, channel), grids[0], isinstance(w, PackedWeight))
        checks, events = check_launches([launch], ctx, grids=grids[1:])
    else:
        for g in grids:
            if g % (nch * world):
                raise PlanVerificationError(
                    f"the float32 route's grid is (n-tile, channel, rank): G = {g} is not a multiple of "
                    f"C x W = {nch * world}",
                    check="grid",
                    **ctx,
                )
            launch = (fma_ag_launch if kind == "ag_matmul" else fma_rs_launch)(t, g // (nch * world))
            c, e = check_launches([launch], ctx)
            checks, events = checks + c, events + e
    return VerificationReport(
        kind=kind,
        order=t.order,
        world=world,
        flow=t.flow,
        effective_channels=nch,
        passes=tuple(f"launch[{route}, G={g}]" for g in grids),
        checks=checks,
        events=events,
    )


def _probe(build) -> Optional[str]:
    try:
        build()
    except PlanVerificationError as e:
        return str(e)
    return None


@functools.lru_cache(maxsize=4096)
def check_candidate(kind: str, order: str, world: int, num_channels: int) -> Optional[str]:
    """Cached legality probe for the tuner: None if legal, else the
    structured diagnosis (the one the executor would raise)."""
    from repro_torch.core.channels import BlockChannel, CommSpec
    from repro_torch.core.plan import build_plan

    ch = BlockChannel(axis="model", comm=CommSpec(order=order), num_channels=num_channels)
    return _probe(lambda: verify_plan(build_plan(kind, ch, world, num_channels)))


def _seq_probe(kinds: Tuple[str, str], order: str, world: int, num_channels: int) -> Optional[str]:
    from repro_torch.core.channels import BlockChannel, CommSpec
    from repro_torch.core.plan import build_seq_plan

    ch = BlockChannel(axis="model", comm=CommSpec(order=order), num_channels=num_channels)
    return _probe(lambda: verify_seq_plan(build_seq_plan(kinds, (ch, ch), world, num_channels)))


@functools.lru_cache(maxsize=4096)
def check_seq_candidate(order: str, world: int, num_channels: int) -> Optional[str]:
    """Cached legality probe for a ``matmul_rs -> ag_matmul`` seam."""
    return _seq_probe(SEQ_OPS[SEQ_KIND], order, world, num_channels)


@functools.lru_cache(maxsize=4096)
def check_a2a_candidate(order: str, world: int, num_channels: int) -> Optional[str]:
    """Cached legality probe for an ``a2a_dispatch -> combine_rs`` pair."""
    return _seq_probe(SEQ_OPS[A2A_SEQ_KIND], order, world, num_channels)


def verify_space(
    *,
    kinds: Optional[Sequence[str]] = None,
    orders: Optional[Sequence[str]] = None,
    worlds: Sequence[int] = SPACE_WORLDS,
    channels: Sequence[int] = SPACE_CHANNELS,
    protocol: Optional[bool] = None,
):
    """Yield a VerificationReport per point of the shipped plan space."""
    from repro_torch.core.channels import ORDERS, BlockChannel, CommSpec
    from repro_torch.core.plan import FLOW_OF_KIND, build_plan

    for kind in kinds if kinds is not None else sorted(FLOW_OF_KIND):
        for order in orders if orders is not None else ORDERS:
            for world in worlds:
                for nch in channels:
                    ch = BlockChannel(axis="model", comm=CommSpec(order=order), num_channels=nch)
                    plan = build_plan(kind, ch, world, nch)
                    yield verify_plan(plan, protocol=protocol, requested_channels=nch)


def verify_seq_space(
    *,
    kinds: Tuple[str, str] = SEQ_OPS[SEQ_KIND],
    orders: Optional[Sequence[str]] = None,
    worlds: Sequence[int] = SPACE_WORLDS,
    channels: Sequence[int] = SPACE_CHANNELS,
    protocol: Optional[bool] = None,
):
    """Yield a VerificationReport per fused pair of ``kinds`` (one shared
    order and channel split on both halves, as the list form builds it)."""
    from repro_torch.core.channels import ORDERS, BlockChannel, CommSpec
    from repro_torch.core.plan import build_seq_plan

    for order in orders if orders is not None else ORDERS:
        for world in worlds:
            for nch in channels:
                ch = BlockChannel(axis="model", comm=CommSpec(order=order), num_channels=nch)
                seq = build_seq_plan(tuple(kinds), (ch, ch), world, nch)
                yield verify_seq_plan(seq, protocol=protocol, requested_channels=nch)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.verify",
        description="Statically verify the port's TilePlan schedules and its fused kernels' flag protocols.",
    )
    p.add_argument("--all", action="store_true", help="verify the full shipped plan space")
    p.add_argument("--kind", action="append", help="workload kind(s) to verify")
    p.add_argument("--order", action="append", help="tile order(s) to verify")
    p.add_argument("--world", type=int, action="append", help="world size(s)")
    p.add_argument("--channels", type=int, action="append", help="channel count(s)")
    p.add_argument("--quiet", action="store_true", help="only print failures + the summary line")
    args = p.parse_args(argv)
    if not (args.all or args.kind or args.order or args.world or args.channels):
        p.error("nothing to verify: pass --all or narrow with --kind/--order/--world/--channels")

    from repro_torch.core.channels import ORDERS
    from repro_torch.core.plan import FLOW_OF_KIND

    # "seq_rs_ag" selects the RS -> AG seam space and "seq_a2a_moe" the
    # dispatch / combine pair; a single-op kind narrows to single-op plans
    kinds = args.kind or sorted(FLOW_OF_KIND) + sorted(SEQ_OPS)
    ok = failed = 0
    for kind in kinds:
        for order in args.order or ORDERS:
            narrow = dict(orders=[order], worlds=args.world or SPACE_WORLDS, channels=args.channels or SPACE_CHANNELS)
            try:
                space = (
                    verify_seq_space(kinds=SEQ_OPS[kind], **narrow)
                    if kind in SEQ_OPS
                    else verify_space(kinds=[kind], **narrow)
                )
                for report in space:
                    ok += 1
                    if not args.quiet:
                        print(f"ok   {report.summary()}")
            except PlanVerificationError as e:
                failed += 1
                print(f"FAIL {e}")
    status = "verified" if not failed else "FAILED"
    print(f"{status}: {ok} plan(s) ok, {failed} failure(s)")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
