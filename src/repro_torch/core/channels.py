"""BlockChannel — the tile-centric mapping context (paper §6), for the port.

The port's counterpart of ``repro/core/channels.py``.  ``compile_overlap`` lowers
``(kind, BlockChannel)`` through ``core/plan.build_plan`` into a
:class:`~repro_torch.core.plan.TilePlan` that both backends execute — the
eager executor (``core/overlap.run_plan``) and the fused Hopper kernels
(``kernels/ag_gemm.py``, ``kernels/gemm_rs.py``):

  ``comm.order``       the per-step peer schedule (ring / bidir_ring / all2all);
  ``num_channels``     C independently scheduled flows per rank (f_C);
  ``comp.accum_dtype`` the reduction dtype, a ``torch.dtype``;
  ``comp.tile``        the (tm, tn, tk) consumer compute tile;
  ``quant``            the wire half of the dtype axis, a
                       :class:`~repro_torch.core.quant.QuantSpec` (defined in
                       ``core/quant.py`` and re-exported here, as the JAX
                       package's ``channels.py`` imports it).

Specs validate at construction, with the same messages as the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.quant import QuantSpec, as_dtype, dtype_name

__all__ = [
    "BlockChannel",
    "CommSpec",
    "CompSpec",
    "QuantSpec",
    "ORDERS",
    "RESOURCES",
    "MODES",
    "dtype_name",
]

ORDERS = ("ring", "bidir_ring", "all2all")
RESOURCES = ("dma", "core")
MODES = ("push", "pull")


def _check(value, allowed, what: str):
    if value not in allowed:
        raise ValueError(f"unsupported {what} {value!r}; supported: {allowed}")


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Communication half of the decoupled design space (paper §3.1)."""

    tile: int = 128
    order: str = "ring"
    resource: str = "dma"
    mode: str = "push"

    def __post_init__(self):
        _check(self.order, ORDERS, "tile order")
        _check(self.resource, RESOURCES, "comm resource")
        _check(self.mode, MODES, "comm mode")
        if self.tile < 1:
            raise ValueError(f"comm tile must be >= 1, got {self.tile}")


@dataclasses.dataclass(frozen=True)
class CompSpec:
    """Computation half: the (tm, tn, tk) consumer tile and the accum dtype.

    The default tile (128, 128, 128) is the "backend-chosen blocking"
    sentinel, as in the JAX package.  ``accum_dtype`` accepts a
    ``torch.dtype`` or its name and is stored as a ``torch.dtype``.
    """

    tile: Tuple[int, int, int] = (128, 128, 128)
    accum_dtype: Union[str, torch.dtype] = torch.float32

    def __post_init__(self):
        if len(self.tile) != 3 or any(t < 1 for t in self.tile):
            raise ValueError(f"comp tile must be 3 positive ints (tm, tn, tk), got {self.tile}")
        dt = as_dtype(self.accum_dtype)
        if not dt.is_floating_point:
            raise ValueError(
                f"accum_dtype must be floating (flow/reduction dtype), got {self.accum_dtype!r}"
            )
        object.__setattr__(self, "accum_dtype", dt)


@dataclasses.dataclass(frozen=True)
class BlockChannel:
    """Tile-centric mapping context shared by producer and consumer."""

    axis: str
    num_channels: int = 1
    comm: CommSpec = CommSpec()
    comp: CompSpec = CompSpec()
    quant: QuantSpec = QuantSpec()
    name: Optional[str] = None

    def __post_init__(self):
        if not self.axis or not isinstance(self.axis, str):
            raise ValueError(f"axis must be a non-empty mesh axis name, got {self.axis!r}")
        if self.num_channels < 1:
            raise ValueError(f"num_channels must be >= 1, got {self.num_channels}")
        if not isinstance(self.comm, CommSpec):
            raise TypeError(f"comm must be a CommSpec, got {type(self.comm)}")
        if not isinstance(self.comp, CompSpec):
            raise TypeError(f"comp must be a CompSpec, got {type(self.comp)}")
        if not isinstance(self.quant, QuantSpec):
            raise TypeError(f"quant must be a QuantSpec, got {type(self.quant)}")

    def with_(self, **kw) -> "BlockChannel":
        return dataclasses.replace(self, **kw)
