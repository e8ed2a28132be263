"""The paper's tile-centric primitives (Table 3) — the host half.

The port's counterpart of ``repro/core/primitives.py``.  On the card the
primitives are device functions of ``kernels/csrc/tile_sync.cuh`` (the
release store and acquire spin of a flag, the slot copy), called at every
flag site of the fused kernels ``ag_gemm.cu`` and ``gemm_rs.cu``.  Here
they are the same names over a :class:`FlagBoard`, the host form of those
flags, which the kernels' plain versions (``kernels/ag_gemm.ag_gemm_plain``,
``kernels/gemm_rs.gemm_rs_plain``) call where the kernels do, so a plain
replay checks the protocol it replays:

  paper primitive           device (tile_sync.cuh)              host (here)
  ------------------------  ----------------------------------  --------------------------
  producer_tile_notify      fence, barrier, st.release.gpu      set the flag's key
  consumer_tile_wait        ld.acquire.gpu spin, fence, barrier  raise unless the key is set
  peer_tile_notify / wait   the same, on a ring peer's flag     the same
  tile_push_data            16-byte global stores to the slot   copy a tile into a slot

The device forms ``*_thread`` / ``*_synced`` (one thread of the wgmma
routes' producer warp; the consumer warpgroups' own barrier) differ only
in which threads take part, so the host has one form of each.  A host
replay runs its items in an order that sets every flag before its wait;
a wait on an unset flag is a protocol fault and raises
:class:`ProtocolError` (on the card it would spin forever).

The TPU's ``tile_pull_data`` and ``rank_copy_data`` have no counterpart:
the port's collective kinds other than the two fused kernels move tiles by
``World.permute`` in ``core/overlap``.
"""

from __future__ import annotations

from typing import Dict, Hashable

import torch

__all__ = [
    "FlagBoard",
    "ProtocolError",
    "producer_tile_notify",
    "consumer_tile_wait",
    "peer_tile_notify",
    "peer_tile_wait",
    "tile_push_data",
]


class ProtocolError(RuntimeError):
    """A wait on a flag that no earlier step set."""


class FlagBoard:
    """The host form of a launch's flags: a value per key, 0 until set.
    Keys are the work items' flag tuples (``kernels/ag_gemm.AgItem.sets``,
    ``kernels/gemm_rs.RsItem.sets``)."""

    def __init__(self):
        self._values: Dict[Hashable, int] = {}

    def value(self, key: Hashable) -> int:
        return self._values.get(key, 0)

    def __contains__(self, key: Hashable) -> bool:
        return self.value(key) != 0

    def __len__(self) -> int:
        return sum(v != 0 for v in self._values.values())


def producer_tile_notify(board: FlagBoard, key: Hashable, value: int = 1) -> None:
    """Mark a produced tile done: set ``key`` to ``value`` (the kernels'
    release store, after the tile's stores)."""
    board._values[key] = value


def consumer_tile_wait(board: FlagBoard, key: Hashable, target: int = 1) -> None:
    """Wait until ``key`` reaches ``target`` (the kernels' acquire spin).  A
    host replay never waits: an unset flag raises :class:`ProtocolError`."""
    if board.value(key) < target:
        raise ProtocolError(f"wait on flag {key} (value {board.value(key)}, target {target}): no earlier step set it")


# peers are the same mechanism on a ring peer's flag (the paper's Fig. 4 ring)
peer_tile_notify = producer_tile_notify
peer_tile_wait = consumer_tile_wait


def tile_push_data(dst: torch.Tensor, index, tile: torch.Tensor) -> None:
    """Copy ``tile`` into the slot ``dst[index]`` (the kernels' stores into a
    peer's gather or recv slot), cast to the slot's dtype."""
    dst[index] = tile
