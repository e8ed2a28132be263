"""Tile orders (paper §3.1, Fig. 2b) — the port's copy of ``repro/core/schedules.py``.

A schedule decides, for every rank and every step, which *peer's* tile is
communicated/consumed.  Conventions (match the paper's Fig. 4 pseudo-code):

  ring       : at step s, rank r handles the segment of rank (r + s + 1) % R
               (reduce-scatter direction: partial results flow to rank r-1).
  ring_ag    : all-gather direction — at step s rank r holds the chunk that
               originated at rank (r + s) % R (chunks flow to rank r+1).
  all2all    : full-mesh — step s pairs rank r with (r ^ s) when R is a power of
               two (bandwidth-optimal pairwise exchange), else (r + s) % R.
  bidir_ring : even steps move clockwise, odd steps counter-clockwise.

``SCHEDULES`` (order name -> source schedule) is consumed by the plan layer
(``core/plan.ChannelSchedule``).
"""

from __future__ import annotations

__all__ = [
    "ring_rs_segment",
    "ring_ag_source",
    "all2all_peer",
    "bidir_ring_source",
    "SCHEDULES",
]


def ring_rs_segment(rank: int, step: int, world: int) -> int:
    """Segment handled by ``rank`` at ``step`` of a ring reduce-scatter."""
    return (rank + step + 1) % world


def ring_ag_source(rank: int, step: int, world: int) -> int:
    """Origin rank of the chunk held by ``rank`` after ``step`` ring hops (AG)."""
    return (rank + step) % world


def all2all_peer(rank: int, step: int, world: int) -> int:
    """Full-mesh pairwise peer (XOR schedule when world is a power of two)."""
    if world & (world - 1) == 0:
        return rank ^ step
    return (rank + step) % world


def bidir_ring_source(rank: int, step: int, world: int) -> int:
    """Bidirectional ring: alternate direction per step, covering ±ceil(s/2)."""
    hop = (step + 1) // 2
    if step % 2 == 1:
        return (rank + hop) % world
    return (rank - hop) % world


SCHEDULES = {
    "ring": ring_ag_source,
    "bidir_ring": bidir_ring_source,
    "all2all": all2all_peer,
}
