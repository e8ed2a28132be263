"""Pass 1 — schedule legality of the baked plan tables (the port's copy of
``repro/analysis/schedule.py``: the same checks, names, coordinates and
``checks`` counts, so both packages give one verdict on every plan).

Checks, per channel (raising :class:`PlanVerificationError` on the first
violation, with the failing (kind, order, world, channel, step, rank)):

  * ``per_step_permutation``  — sigma(., step) is a permutation of ranks;
  * ``seed_identity``         — sigma(r, 0) == r (the flow starts local);
  * ``ag_coverage``           — every rank consumes every origin exactly once;
  * ``flow_composition``      — flow_perm(step) delivers sigma(., step + 1):
                                src[dst(j)] at step+1 == src[j] at step, and
                                each dst row is itself a permutation;
  * ``rs_time_reversal``      — rs_seg(r, s) == sigma(r, world - 1 - s);
  * ``rs_home``               — rs_seg(r, world - 1) == r (reduction lands on
                                its home rank);
  * ``rs_composition``        — rs_dst rows compose with rs_seg the same way;
  * ``align_home``            — align_perm routes the ag_rs tile-following
                                reduction to the origin of the tile held last:
                                align(j) == sigma(j, world - 1);
  * ``slot_partition``        — per rank the (origin, channel) gather slots
                                are hit exactly once (no overlap / no gap in
                                the multi-channel block partition).

For a2a flows (expert-parallel dispatch/combine) three more checks run:

  * ``a2a_exchange_composition`` — the direct exchange delivers each rank's
                                *own* tile to exactly the rank that consumes
                                it: src[dst(j)] at step s == j, and each dst
                                row is itself a permutation (full coverage);
  * ``a2a_seed``              — step 0's exchange is the identity (tokens
                                routed to the local expert shard move nowhere);
  * ``a2a_involution``        — for the all2all order on power-of-two worlds
                                the exchange is the XOR involution
                                dst(j) == sigma(j, s) == j ^ s (each step is a
                                disjoint pairwise swap); non-power-of-2 worlds
                                and other orders fall back to the inverse-
                                permutation law dst == sigma(., s)^-1 already
                                proven by ``a2a_exchange_composition``.

For fused multi-op seam plans (``core/plan.SeqPlan``) ``check_seam`` adds:

  * ``seam_composition``      — the producer's fully reduced RS segment lands
                                on its home rank exactly where the consumer
                                seeds its step-0 local tile:
                                rs_seg(r, world - 1) == r == sigma(r, 0), with
                                matching world and channel counts, so the
                                handoff is rank-local (no resharding hop);

and for the a2a pair ``check_a2a_seam`` requires the combine to return along
the *reversed* edges of the dispatch exchange:

  * ``a2a_seam_composition``  — identical src tables on both halves (the
                                combine's return destination sigma(j, s) is
                                the dispatch edge traversed backwards), with
                                matching world and channel counts.

All checks run off the precomputed O(world^2 * channels) tables, so a full
verification is microseconds even at dry-run world sizes.
"""
from __future__ import annotations

from repro_torch.analysis.errors import PlanVerificationError
from repro_torch.analysis.ir import PlanTables

__all__ = ["check_schedule", "check_channel_partition", "check_seam", "check_a2a_seam"]


def check_channel_partition(extent: int, num_channels: int) -> int:
    """Check C block sub-chunks tile ``[0, extent)`` with no overlap or gap.

    Returns the number of assertions evaluated.  ``extent`` is the chunked
    operand extent (columns for matmul flows, tokens for attention/MoE).
    """
    if num_channels < 1 or extent % num_channels:
        raise PlanVerificationError(
            f"{num_channels} channels do not evenly partition extent {extent}",
            check="channel_partition",
        )
    sub = extent // num_channels
    covered = []
    for c in range(num_channels):
        covered.extend(range(c * sub, (c + 1) * sub))
    if covered != list(range(extent)):
        raise PlanVerificationError(
            f"channel blocks overlap or leave a gap over extent {extent}",
            check="channel_partition",
        )
    return num_channels + 1


def _ctx(t: PlanTables, **kw):
    return dict(kind=t.kind, order=t.order, world=t.world, **kw)


def _check_perm_row(t: PlanTables, row, *, check: str, channel: int, step: int) -> None:
    seen = [0] * t.world
    for r, v in enumerate(row):
        if not (0 <= v < t.world) or seen[v]:
            raise PlanVerificationError(
                f"{'duplicate' if 0 <= v < t.world and seen[v] else 'out-of-range'} "
                f"entry {v} — row is not a permutation of ranks",
                check=check,
                rank=r,
                **_ctx(t, channel=channel, step=step),
            )
        seen[v] = 1


def check_schedule(t: PlanTables) -> int:
    """Run every schedule-legality check; returns assertions evaluated."""
    world, checks = t.world, 0

    for c in range(t.num_channels):
        src_c = t.src[c]
        # per-step permutation + seed identity
        for s in range(world):
            _check_perm_row(t, src_c[s], check="per_step_permutation", channel=c, step=s)
            checks += 1
        for r in range(world):
            if src_c[0][r] != r:
                raise PlanVerificationError(
                    f"sigma(r, 0) == {src_c[0][r]}, expected r — the flow must "
                    "start from the local shard",
                    check="seed_identity",
                    rank=r,
                    **_ctx(t, channel=c, step=0),
                )
            # AG coverage: each rank consumes every origin exactly once
            if sorted(src_c[s][r] for s in range(world)) != list(range(world)):
                raise PlanVerificationError(
                    "rank does not consume every origin exactly once over the pass",
                    check="ag_coverage",
                    rank=r,
                    **_ctx(t, channel=c),
                )
            checks += 2

        # flow composition: dst row is a permutation delivering sigma(., s+1)
        if t.flow_dst is None:
            raise PlanVerificationError(
                "flow destination tables could not be derived (source schedule "
                "is not a per-step permutation)",
                check="flow_composition",
                **_ctx(t, channel=c),
            )
        for s in range(world - 1):
            dst_row = t.flow_dst[c][s]
            _check_perm_row(t, dst_row, check="flow_composition", channel=c, step=s)
            for j in range(world):
                d = dst_row[j]
                if src_c[s + 1][d] != src_c[s][j]:
                    raise PlanVerificationError(
                        f"flow_perm sends rank {j}'s held tile (origin "
                        f"{src_c[s][j]}) to rank {d}, which consumes origin "
                        f"{src_c[s + 1][d]} next",
                        check="flow_composition",
                        rank=j,
                        **_ctx(t, channel=c, step=s),
                    )
                checks += 1

        # RS view: time reversal of sigma, ending at the home rank
        seg_c = t.rs_seg[c]
        for s in range(world):
            for r in range(world):
                if seg_c[s][r] != src_c[world - 1 - s][r]:
                    raise PlanVerificationError(
                        f"rs_segment {seg_c[s][r]} is not the time reversal "
                        f"sigma(r, world-1-s) == {src_c[world - 1 - s][r]}",
                        check="rs_time_reversal",
                        rank=r,
                        **_ctx(t, channel=c, step=s),
                    )
                checks += 1
        for r in range(world):
            if seg_c[world - 1][r] != r:
                raise PlanVerificationError(
                    f"final segment {seg_c[world - 1][r]} is not the home rank",
                    check="rs_home",
                    rank=r,
                    **_ctx(t, channel=c, step=world - 1),
                )
            checks += 1
        if t.rs_dst is None:
            raise PlanVerificationError(
                "rs destination tables could not be derived",
                check="rs_composition",
                **_ctx(t, channel=c),
            )
        for s in range(world - 1):
            dst_row = t.rs_dst[c][s]
            _check_perm_row(t, dst_row, check="rs_composition", channel=c, step=s)
            for j in range(world):
                d = dst_row[j]
                if seg_c[s + 1][d] != seg_c[s][j]:
                    raise PlanVerificationError(
                        f"rs_perm sends rank {j}'s partial (segment "
                        f"{seg_c[s][j]}) to rank {d}, which reduces segment "
                        f"{seg_c[s + 1][d]} next",
                        check="rs_composition",
                        rank=j,
                        **_ctx(t, channel=c, step=s),
                    )
                checks += 1

        # a2a flows: the direct pairwise exchange must deliver each rank's
        # own tile to exactly the rank consuming it this step
        if t.flow in ("a2a", "a2a_rs"):
            if t.a2a_dst is None:
                raise PlanVerificationError(
                    "a2a exchange tables could not be derived (source schedule "
                    "is not a per-step permutation)",
                    check="a2a_exchange_composition",
                    **_ctx(t, channel=c),
                )
            xor_involution = t.order == "all2all" and world & (world - 1) == 0
            for s in range(world):
                dst_row = t.a2a_dst[c][s]
                _check_perm_row(
                    t, dst_row, check="a2a_exchange_composition", channel=c, step=s
                )
                for j in range(world):
                    if src_c[s][dst_row[j]] != j:
                        raise PlanVerificationError(
                            f"a2a exchange sends rank {j}'s own tile to rank "
                            f"{dst_row[j]}, which consumes origin "
                            f"{src_c[s][dst_row[j]]} at this step",
                            check="a2a_exchange_composition",
                            rank=j,
                            **_ctx(t, channel=c, step=s),
                        )
                    if s == 0 and dst_row[j] != j:
                        raise PlanVerificationError(
                            f"step-0 a2a exchange moves rank {j}'s tile to "
                            f"{dst_row[j]}; the seed step must be local",
                            check="a2a_seed",
                            rank=j,
                            **_ctx(t, channel=c, step=0),
                        )
                    if xor_involution and dst_row[j] != src_c[s][j]:
                        raise PlanVerificationError(
                            f"all2all exchange is not the XOR involution: rank "
                            f"{j} sends to {dst_row[j]} but receives from "
                            f"{src_c[s][j]}",
                            check="a2a_involution",
                            rank=j,
                            **_ctx(t, channel=c, step=s),
                        )
                    checks += 2 + int(xor_involution)

        # ag_rs final alignment hop: deliver the reduction for the tile held
        # last (origin sigma(j, world-1)) to that origin rank
        for j in range(world):
            if t.align[c][j] != src_c[world - 1][j]:
                raise PlanVerificationError(
                    f"align_perm sends rank {j}'s reduction to "
                    f"{t.align[c][j]}, but the tile it followed originates at "
                    f"{src_c[world - 1][j]}",
                    check="align_home",
                    rank=j,
                    **_ctx(t, channel=c, step=world - 1),
                )
            checks += 1

    # slot partition across channels: per rank, the (origin, channel) gather
    # slots are each hit exactly once — no overlap, no gap
    for r in range(world):
        slots = sorted(
            t.src[c][s][r] * t.num_channels + c
            for c in range(t.num_channels)
            for s in range(world)
        )
        if slots != list(range(world * t.num_channels)):
            raise PlanVerificationError(
                "gather-buffer slots are not a partition: some (origin, "
                "channel) slot is reused or never consumed",
                check="slot_partition",
                rank=r,
                **_ctx(t),
            )
        checks += 1
    return checks


def check_seam(producer: PlanTables, consumer: PlanTables) -> int:
    """Seam-composition legality for a fused RS -> AG pair.

    The fused executor hands each channel's fully reduced RS segment to the
    consumer *in place* — no resharding hop — which is only sound when the
    producer's last-step segment schedule and the consumer's step-0 source
    schedule are both the identity on every rank, over the same world and
    channel split.  Returns the number of assertions evaluated.
    """
    kind = f"{producer.kind}->{consumer.kind}"
    order = f"{producer.order}->{consumer.order}"
    if producer.flow != "rs" or consumer.flow != "ag":
        raise PlanVerificationError(
            f"seam chains flows {(producer.flow, consumer.flow)}; only an rs "
            "producer feeding an ag consumer composes rank-locally",
            check="seam_composition",
            kind=kind,
            order=order,
            world=producer.world,
        )
    if producer.world != consumer.world:
        raise PlanVerificationError(
            f"producer world {producer.world} != consumer world {consumer.world}",
            check="seam_composition",
            kind=kind,
            order=order,
            world=producer.world,
        )
    if producer.num_channels != consumer.num_channels:
        raise PlanVerificationError(
            f"producer has {producer.num_channels} channels but consumer has "
            f"{consumer.num_channels}; the seam handoff is per-channel",
            check="seam_composition",
            kind=kind,
            order=order,
            world=producer.world,
        )
    world, checks = producer.world, 3
    for c in range(producer.num_channels):
        for r in range(world):
            home = producer.rs_seg[c][world - 1][r]
            seed = consumer.src[c][0][r]
            if home != r or seed != r:
                raise PlanVerificationError(
                    f"rank holds producer segment {home} after the RS pass but "
                    f"the consumer seeds origin {seed}; the seam handoff is "
                    "only rank-local when both are the rank itself",
                    check="seam_composition",
                    kind=kind,
                    order=order,
                    world=world,
                    channel=c,
                    rank=r,
                )
            checks += 1
    return checks


def check_a2a_seam(dispatch: PlanTables, combine: PlanTables) -> int:
    """Composition legality for a fused ``a2a_dispatch -> combine_rs`` pair.

    The combine returns each step's expert partials along the *reversed*
    dispatch edge (rank j sends step s's partial to sigma(j, s), the origin of
    the tokens it just processed) — sound only when both halves realize the
    same exchange: identical src tables, world, and channel count.  Returns
    the number of assertions evaluated.
    """
    kind = f"{dispatch.kind}->{combine.kind}"
    order = f"{dispatch.order}->{combine.order}"
    if dispatch.flow != "a2a" or combine.flow != "a2a_rs":
        raise PlanVerificationError(
            f"a2a seam chains flows {(dispatch.flow, combine.flow)}; only an "
            "a2a dispatch feeding an a2a_rs combine reverses edge-for-edge",
            check="a2a_seam_composition",
            kind=kind,
            order=order,
            world=dispatch.world,
        )
    if dispatch.world != combine.world:
        raise PlanVerificationError(
            f"dispatch world {dispatch.world} != combine world {combine.world}",
            check="a2a_seam_composition",
            kind=kind,
            order=order,
            world=dispatch.world,
        )
    if dispatch.num_channels != combine.num_channels:
        raise PlanVerificationError(
            f"dispatch has {dispatch.num_channels} channels but combine has "
            f"{combine.num_channels}; the return edge is per-channel",
            check="a2a_seam_composition",
            kind=kind,
            order=order,
            world=dispatch.world,
        )
    world, checks = dispatch.world, 3
    for c in range(dispatch.num_channels):
        for s in range(world):
            for r in range(world):
                if combine.src[c][s][r] != dispatch.src[c][s][r]:
                    raise PlanVerificationError(
                        f"combine returns step {s}'s partial to "
                        f"{combine.src[c][s][r]} but the dispatch exchange "
                        f"consumed origin {dispatch.src[c][s][r]}; the return "
                        "must traverse the dispatch edge backwards",
                        check="a2a_seam_composition",
                        kind=kind,
                        order=order,
                        world=world,
                        channel=c,
                        step=s,
                        rank=r,
                    )
                checks += 1
    return checks
