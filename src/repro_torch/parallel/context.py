"""ParallelContext — distribution configuration threaded through the model.

The port's counterpart of ``repro/parallel/context.py``.  It carries the
:class:`~repro_torch.backend.mesh.World`, the overlap mode, the
``BlockChannel`` design point and the backend:

  mode="overlap"   TileLink tile plans (compile_overlap -> plan -> executor)
  mode="baseline"  gather-then-GEMM / GEMM-then-reduce-scatter (eager only)

  backend="fused"  the hand-written Hopper kernels: AG+GEMM, GEMM+RS, flash
                   attention and the tile-GEMM LM head; the default when the
                   world lives on a CUDA device (the JAX package pins
                   ``backend="xla"``; the port runs its kernels on the card)
  backend="eager"  the eager executor and the plain attention — the
                   default on the CPU, and the reference on the card

Layers call ``pc.ag_matmul`` / ``pc.matmul_rs`` / ``pc.psum`` on
rank-stacked values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.backend.mesh import World
from repro_torch.core.channels import BlockChannel
from repro_torch.core.compiler import BACKENDS, compile_overlap

__all__ = ["ParallelContext"]


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    world: World
    mode: str = "overlap"  # "overlap" | "baseline"
    channel: Optional[BlockChannel] = None
    backend: Optional[str] = None  # "fused" | "eager"; None -> by device

    def __post_init__(self):
        if self.mode not in ("overlap", "baseline"):
            raise ValueError(f"mode must be 'overlap' or 'baseline', got {self.mode!r}")
        if self.channel is None:
            object.__setattr__(self, "channel", BlockChannel(axis="model"))
        if self.backend is None:
            fused = self.world.device.type == "cuda" and self.mode == "overlap"
            object.__setattr__(self, "backend", "fused" if fused else "eager")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.backend == "fused" and self.mode != "overlap":
            raise ValueError("backend='fused' runs the overlapped kernels; mode='baseline' needs backend='eager'")

    # ---- static topology ------------------------------------------------
    @property
    def tp(self) -> int:
        return self.world.size

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def fused(self) -> bool:
        return self.backend == "fused"

    # ---- per-rank collective ops ----------------------------------------
    def _op(self, kind: str) -> Callable:
        return compile_overlap(
            kind, self.channel, world=self.world, backend=self.backend, overlapped=(self.mode == "overlap")
        )

    def ag_matmul(self, x, w, **kw):
        """[W, *lead, m_loc, K] x [W, K, n_loc] -> [W, *lead, W*m_loc, n_loc]."""
        return self._op("ag_matmul")(x, w, **kw)

    def matmul_rs(self, x, w, **kw):
        """[W, *lead, M, k_loc] x [W, k_loc, N] -> [W, *lead, M/W, N]."""
        return self._op("matmul_rs")(x, w, **kw)

    def psum(self, x):
        return self.world.psum(x)
