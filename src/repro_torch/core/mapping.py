"""Tile-centric mappings (paper §4.1) — the port of ``repro/core/mapping.py``.

TileLink links communication and computation through three mappings:

  f_S : tile_id -> shape range  (which slice of the global tensor a tile covers)
  f_R : tile_id -> rank         (which rank owns / produces the tile)
  f_C : tile_id -> channel      (which flag channel guards the tile)

:class:`StaticTileMapping` is the affine form, decidable from the shapes
(tensor-parallel MLP, sequence-parallel attention), with the paper's
formulas: ``M_per_rank = ceil(M / R)``, ``M_per_channel = ceil(M / (R C))``,
``range = [t Tm, t Tm + Tm)``, ``src_rank = t // (M_per_rank // Tm)``,
``channel = t // (M_per_channel // Tm)``.  :class:`DynamicTileMapping`
holds lookup tables filled at run time (MoE routing:
:func:`build_moe_dynamic_mapping`); the access (an index at the tile id)
is fixed, the values are int32 tensors on an explicit device.

Every mapping has a host-int form and a "traced" ``*_t`` form over int
tensors (the reference's jnp form, used inside jitted code there).  The
port's fused kernels take their tables from the plans (``core/plan``), as
the JAX package's do: nothing on their paths consumes these mappings yet.

``effective_channels`` is the f_C feasibility rule: a channel count that
does not divide the chunked extent falls back to the largest divisor, with
one warning per unique clamp.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch

from repro_torch.core.comp_tiles import largest_divisor

__all__ = ["StaticTileMapping", "DynamicTileMapping", "build_moe_dynamic_mapping", "cdiv", "effective_channels"]


def cdiv(a: int, b: int) -> int:
    """Ceiling division (host-side)."""
    return -(-a // b)


# fallbacks already reported, keyed (kind, extent, requested): one line per
# unique clamp, not one per call
_WARNED_CLAMPS = set()


def effective_channels(extent: int, requested: int, *, kind: str = "", warn: bool = True) -> int:
    """f_C feasibility: largest channel count <= ``requested`` dividing ``extent``.

    Warns once per unique (kind, extent, requested) clamp; ``warn=False`` is
    for feasibility probes that expect clamping.
    """
    req = max(1, int(requested))
    c = largest_divisor(extent, req)
    if c != req and warn:
        key = (kind, int(extent), req)
        if key not in _WARNED_CLAMPS:
            _WARNED_CLAMPS.add(key)
            warnings.warn(
                f"{kind or 'tile plan'}: num_channels={requested} does not divide "
                f"extent {extent}; using largest divisor {c}",
                stacklevel=2,
            )
    return c


@dataclasses.dataclass(frozen=True)
class StaticTileMapping:
    """Affine tile-centric mapping over a 1-D sharded dimension of extent ``dim``:
    ``tile`` the producer tile (the paper's Tm_p), ``world_size`` the ranks R,
    ``num_channels`` the flag channels per rank C."""

    dim: int
    tile: int
    world_size: int
    num_channels: int = 1

    # ---- derived (host ints) -------------------------------------------------
    @property
    def per_rank(self) -> int:
        return cdiv(self.dim, self.world_size)

    @property
    def per_channel(self) -> int:
        return cdiv(self.dim, self.world_size * self.num_channels)

    @property
    def tiles_per_rank(self) -> int:
        return max(1, self.per_rank // self.tile)

    @property
    def tiles_per_channel(self) -> int:
        return max(1, self.per_channel // self.tile)

    @property
    def num_tiles(self) -> int:
        return cdiv(self.dim, self.tile)

    # ---- f_S / f_R / f_C : host ints -----------------------------------------
    def shape_range(self, tile_id: int) -> Tuple[int, int]:
        """f_S: the [lo, hi) slice of the global dimension ``tile_id`` covers."""
        lo = tile_id * self.tile
        return lo, min(lo + self.tile, self.dim)

    def rank(self, tile_id: int) -> int:
        """f_R: the source rank of ``tile_id`` (the paper's src_rank formula)."""
        return tile_id // self.tiles_per_rank

    def channel(self, tile_id: int) -> int:
        """f_C: the global channel of ``tile_id`` (the paper's channel formula)."""
        return tile_id // self.tiles_per_channel

    def channel_in_rank(self, tile_id: int) -> int:
        """The channel local to the owning rank (0 .. C-1)."""
        return self.channel(tile_id) % self.num_channels

    def tiles_of_rank(self, rank: int) -> range:
        """Inverse of f_R: the tile ids ``rank`` produces."""
        return range(rank * self.tiles_per_rank, (rank + 1) * self.tiles_per_rank)

    # ---- f_S / f_R / f_C : over int tensors -----------------------------------
    def shape_range_t(self, tile_id: torch.Tensor):
        lo = tile_id * self.tile
        return lo, torch.clamp(lo + self.tile, max=self.dim)

    def rank_t(self, tile_id: torch.Tensor) -> torch.Tensor:
        return tile_id // self.tiles_per_rank

    def channel_t(self, tile_id: torch.Tensor) -> torch.Tensor:
        return tile_id // self.tiles_per_channel

    def validate(self) -> None:
        """Raise ValueError unless the tile divides the extent and each rank's
        extent, and the channels evenly tile a rank's tiles (the affine f_C)."""
        if self.dim % self.tile:
            raise ValueError(f"tile {self.tile} must divide dim {self.dim}")
        if self.per_rank % self.tile:
            raise ValueError(f"tile {self.tile} must divide per-rank extent {self.per_rank}")
        if self.tiles_per_rank % self.num_channels:
            raise ValueError(
                f"num_channels {self.num_channels} must divide tiles-per-rank {self.tiles_per_rank}"
            )


@dataclasses.dataclass
class DynamicTileMapping:
    """Lookup-table mapping (the paper's dynamic mapping): ``f_S_low``,
    ``f_S_high``, ``f_R``, ``f_C`` are int32 tensors [num_tiles] filled at
    run time (e.g. by MoE routing); tile t covers rows [f_S_low[t],
    f_S_high[t]) of the expert-sorted buffer, owned by rank f_R[t], guarded
    by channel f_C[t]."""

    f_S_low: torch.Tensor
    f_S_high: torch.Tensor
    f_R: torch.Tensor
    f_C: torch.Tensor

    def shape_range_t(self, tile_id):
        return self.f_S_low[tile_id], self.f_S_high[tile_id]

    def rank_t(self, tile_id):
        return self.f_R[tile_id]

    def channel_t(self, tile_id):
        return self.f_C[tile_id]

    @property
    def num_tiles(self) -> int:
        return int(self.f_S_low.shape[0])

    @staticmethod
    def from_group_sizes(group_sizes: torch.Tensor, tile: int, experts_per_rank: int):
        """The table layout from per-expert row counts: offsets = [0,
        cumsum(group_sizes)], tiles laid out per expert up to a static
        maximum.  Not built here, as in the reference: use
        :func:`build_moe_dynamic_mapping` (its capacity-static form)."""
        raise NotImplementedError(
            "Use build_moe_dynamic_mapping (capacity-static version); kept here as documentation of the table layout."
        )


def build_moe_dynamic_mapping(
    group_offsets,
    tiles_per_expert: int,
    tile: int,
    experts_per_rank: int,
    *,
    device: Optional[torch.device] = None,
) -> DynamicTileMapping:
    """Capacity-static MoE dynamic mapping.

    ``group_offsets`` [E + 1]: prefix sums of the (tile-aligned) rows of each
    expert in the expert-sorted buffer; ``tiles_per_expert`` the static
    maximum of tiles an expert may occupy (capacity / tile); ``tile`` the
    row tile; ``experts_per_rank`` the experts each rank hosts (f_R).
    Returns ``E * tiles_per_expert`` tiles as int32 tables on ``device``
    (default: the offsets' device, the CPU for a list): tile t belongs to
    expert t // tiles_per_expert, and a tile past its expert's rows is empty
    (low == high); f_C is the expert (one channel per expert)."""
    offsets = torch.as_tensor(group_offsets, device=device).long()
    num_experts = offsets.shape[0] - 1
    e_ids = torch.arange(num_experts, device=offsets.device).repeat_interleave(tiles_per_expert)
    t_in_e = torch.arange(tiles_per_expert, device=offsets.device).repeat(num_experts)
    end = offsets[e_ids + 1]
    low = torch.minimum(offsets[e_ids] + t_in_e * tile, end)
    high = torch.minimum(low + tile, end)
    return DynamicTileMapping(
        f_S_low=low.to(torch.int32),
        f_S_high=high.to(torch.int32),
        f_R=(e_ids // experts_per_rank).to(torch.int32),
        f_C=e_ids.to(torch.int32),
    )
