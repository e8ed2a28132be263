"""The ``World`` — tensor-parallel ranks, replacing the ``shard_map`` region.

The JAX package runs per-shard code inside ``shard_map`` over a mesh axis
(``repro/backend/mesh.py``).  The port runs a world of ``size`` ranks
emulated on one device:

  * every per-rank value carries a leading rank dimension ``[W, ...]`` in one
    allocation, and per-rank code is written batched over it;
  * a value replicated over the ranks (decode activations) is stored once,
    without the rank dimension;
  * a permute is an index on dim 0, ``psum`` a sum over dim 0;
  * the fused kernels take rank-stacked operands and run all ranks in one
    launch, a "peer store" being a store into another rank's slice.

The methods below are the transport interface the executors use; a
``torch.distributed`` or real-peer transport would implement the same
methods over per-process tensors.

``World.counting()`` turns on a :class:`CommCounter` for the transport:
every ``permute`` / ``psum`` / ``all_gather`` / ``reduce_scatter`` then
records its payload bytes per rank, by kind, with the group size, and a
permute also by link direction (the sign of dst - src voted over its first
pairs, as ``repro/launch/roofline.parse_collective_bytes`` classifies a
collective-permute).  ``launch/roofline.collective_bytes`` weights them
into per-device link bytes.  The counter reads shapes only (no host sync,
so it may stay on inside a CUDA-graph capture), and with none enabled a
call pays one attribute test.
"""

from __future__ import annotations

import contextlib
import functools
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.backend.target import resolve_device

__all__ = ["World", "CommCounter", "KINDS", "permute_direction"]

KINDS = ("permute", "psum", "all_gather", "reduce_scatter")  # the transport's collectives
VOTES = 8  # pairs a permute's direction is voted over (the JAX package's parser reads the first 8)


def permute_direction(pairs: Sequence[Tuple[int, int]]) -> int:
    """+1 or -1: the link direction of a permute, the sign of dst - src
    voted over its first :data:`VOTES` pairs (ties count as +1)."""
    votes = sum(1 if dst > src else -1 for src, dst in list(pairs)[:VOTES])
    return 1 if votes >= 0 else -1


class CommCounter:
    """Payload bytes per rank that a world's transport moved since the last
    :meth:`reset`.

    ``payload[kind][g]``: the bytes of one rank's payload summed over the
    calls of ``kind`` over a group of ``g`` ranks (a permute's and a psum's
    input, an all-gather's gathered output, a reduce-scatter's scattered
    output: the payloads the JAX package's HLO parser reads);
    ``permute_dirs[+1 | -1]``: the permutes' payload by link direction."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.payload: Dict[str, Dict[int, float]] = {k: defaultdict(float) for k in KINDS}
        self.permute_dirs: Dict[int, float] = defaultdict(float)

    def add(self, kind: str, nbytes: float, group: int, direction: Optional[int] = None):
        self.payload[kind][group] += nbytes
        if direction is not None:
            self.permute_dirs[direction] += nbytes


def _rank_bytes(xs: torch.Tensor, ranks: int) -> int:
    """One rank's share of a rank-stacked value's bytes (shape only)."""
    return xs.numel() // ranks * xs.element_size()


class World:
    """``size`` tensor-parallel ranks emulated on ``device``."""

    def __init__(self, size: int, device: Optional[Union[str, torch.device]] = None):
        if int(size) < 1:
            raise ValueError(f"world size must be >= 1, got {size}")
        self.size = int(size)
        self.device = resolve_device(device)
        self.counter: Optional[CommCounter] = None

    def __repr__(self) -> str:
        return f"World(size={self.size}, device={self.device})"

    @contextlib.contextmanager
    def counting(self, counter: Optional[CommCounter] = None):
        """Record the transport's payloads into ``counter`` (a new
        :class:`CommCounter` by default) inside; yields the counter."""
        counter = CommCounter() if counter is None else counter
        before, self.counter = self.counter, counter
        try:
            yield counter
        finally:
            self.counter = before

    # ---- layout: global <-> rank-stacked --------------------------------
    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Split a global tensor along ``dim`` into ``[W, ...]`` (contiguous)."""
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {self.size} ranks")
        return torch.stack(torch.chunk(x, self.size, dim=dim)).contiguous()

    def unshard(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """Inverse of :meth:`shard`: concatenate the ranks' values along the
        per-rank dimension ``dim``."""
        self._check(xs)
        return torch.cat(list(xs.unbind(0)), dim=dim)

    # ---- collectives -----------------------------------------------------
    def permute(self, xs: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``out[dst] = xs[src]`` for every (src, dst) pair (a ppermute).

        The index tensor is built once per (pairs, device) and cached, so a
        repeated permute issues no host-to-device copy (and a CUDA-graph
        capture may replay one whose index was built before it)."""
        self._check(xs)
        if self.counter is not None:
            self.counter.add("permute", _rank_bytes(xs, self.size), self.size, permute_direction(pairs))
        order = [0] * self.size
        for src, dst in pairs:
            order[dst] = src
        return xs[_perm_index(tuple(order), xs.device)]

    def psum(self, xs: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks; the replicated result is stored once."""
        self._check(xs)
        if self.counter is not None:
            self.counter.add("psum", _rank_bytes(xs, self.size), self.size)
        return xs.sum(0)

    def all_gather(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's view of the concatenation along per-rank ``dim``
        (a broadcast view of one gathered tensor)."""
        g = self.unshard(xs, dim)
        if self.counter is not None:
            self.counter.add("all_gather", g.numel() * g.element_size(), self.size)
        return g.unsqueeze(0).expand((self.size,) + tuple(g.shape))

    def reduce_scatter(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum over the ranks, then each rank keeps its chunk of per-rank ``dim``."""
        self._check(xs)
        if self.counter is not None:
            self.counter.add("reduce_scatter", _rank_bytes(xs, self.size) // self.size, self.size)
        return self.shard(xs.sum(0), dim)

    def _check(self, xs: torch.Tensor):
        if xs.shape[0] != self.size:
            raise ValueError(f"expected a rank-stacked [W={self.size}, ...] value, got {tuple(xs.shape)}")


@functools.lru_cache(maxsize=1024)
def _perm_index(order: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The gather index of a permute, on ``device`` (read-only, shared)."""
    return torch.tensor(order, device=device)
