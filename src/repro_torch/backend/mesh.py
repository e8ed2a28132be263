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
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.backend.target import resolve_device

__all__ = ["World"]


class World:
    """``size`` tensor-parallel ranks emulated on ``device``."""

    def __init__(self, size: int, device: Optional[Union[str, torch.device]] = None):
        if int(size) < 1:
            raise ValueError(f"world size must be >= 1, got {size}")
        self.size = int(size)
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"World(size={self.size}, device={self.device})"

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
        order = [0] * self.size
        for src, dst in pairs:
            order[dst] = src
        return xs[_perm_index(tuple(order), xs.device)]

    def psum(self, xs: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks; the replicated result is stored once."""
        self._check(xs)
        return xs.sum(0)

    def all_gather(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's view of the concatenation along per-rank ``dim``
        (a broadcast view of one gathered tensor)."""
        g = self.unshard(xs, dim)
        return g.unsqueeze(0).expand((self.size,) + tuple(g.shape))

    def reduce_scatter(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum over the ranks, then each rank keeps its chunk of per-rank ``dim``."""
        return self.shard(self.psum(xs), dim)

    def _check(self, xs: torch.Tensor):
        if xs.shape[0] != self.size:
            raise ValueError(f"expected a rank-stacked [W={self.size}, ...] value, got {tuple(xs.shape)}")


@functools.lru_cache(maxsize=1024)
def _perm_index(order: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The gather index of a permute, on ``device`` (read-only, shared)."""
    return torch.tensor(order, device=device)
